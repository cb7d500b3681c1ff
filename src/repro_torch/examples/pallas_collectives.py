"""Run the remote-copy collective kernels over ranks emulated on one
device and validate them against their oracles: B3 ring all-gather with
the pcpy/b2b/bcst/bcst_b2b sync variants and B4 all-to-all (per_round /
b2b) on 8 ranks, and B4's rotation pairing on 6.  Counterpart of
``examples/pallas_collectives.py``, whose Pallas kernels run in TPU
interpret mode on 8 emulated JAX devices; here the CUDA kernels run on the
card (``--device cpu``: their plain versions).

    PYTHONPATH=src python -m repro_torch.examples.pallas_collectives [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.kernels.ring_all_gather import ops as ag_ops
from repro_torch.kernels.ring_all_gather.ref import all_gather_ref
from repro_torch.kernels.ring_all_to_all import ops as aa_ops
from repro_torch.kernels.ring_all_to_all.ref import all_to_all_ref

N = 8
ROTATION_N = 6          # not a power of two: B4 pairs ranks by rotation
SEED = 0


def run(device="cuda") -> dict:
    """{name: (inputs, output)} as numpy arrays: the all-gather inputs are
    the global array [N * 8, 128], the all-to-all inputs [n, n, 4, 128];
    outputs are every rank's result."""
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(N * 8, 128)).astype(np.float32)
    xs = torch.from_numpy(x).reshape(N, 8, 128).to(dev)
    out = {}
    for variant in ag_ops.VARIANTS:
        out[f"all_gather {variant}"] = (x, ag_ops.ring_all_gather(xs, variant).cpu().numpy())
    for n in (N, ROTATION_N):
        xa = rng.normal(size=(n, n, 4, 128)).astype(np.float32)
        for variant in aa_ops.VARIANTS:
            y = aa_ops.all_to_all(torch.from_numpy(xa).to(dev), variant)
            out[f"all_to_all {variant} n={n}"] = (xa, y.cpu().numpy())
    if dev.type == "cuda":
        ag_ops.check()
        aa_ops.check()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bad = []
    for name, (x, y) in run(args.device).items():
        if name == "all_gather pcpy":
            print("== ring all-gather (B3) ==")
        elif name.startswith("all_to_all per_round"):
            print(f"== all-to-all (B4), {x.shape[0]} ranks ==")
        xt = torch.from_numpy(x)
        want = (all_gather_ref(xt.reshape(N, -1, x.shape[-1])) if name.startswith("all_gather")
                else all_to_all_ref(xt)).numpy()
        ok = bool(np.array_equal(y, want))
        print(f"  {name:24s}: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"kernel variants differ from their oracles: {bad}")
    print("all kernel variants validated against oracles")


if __name__ == "__main__":
    main()
