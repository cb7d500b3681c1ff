"""The latte all-gathers against the one-call reference over ranks emulated
on one device: correctness + device time per call, plus the step-count
reduction of each schedule (the structural win that maps to the paper's
command/sync reduction).  Counterpart of ``benchmarks/tpu_collectives.py``,
whose ``shard_map`` over a JAX mesh becomes ``core.collectives.make_ranks``.

On the card, ``ring(b2b)`` launches B3 ``b2b`` and ``bidir(bcst)`` B3
``bcst_b2b``; their times are device microseconds by CUDA events on one
card, where the ranks are slices of one tensor: no interconnect is crossed,
so they are no link figure.  ``--device cpu`` runs the step schedules.

    PYTHONPATH=src python -m repro_torch.benchmarks.tpu_collectives [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import collectives as coll
from .common import ClaimChecker, device_us, time_us

RANKS = 8
SEED = 0


def run(verbose: bool = True, device="cuda"):
    """Each rendering's all-gather of ``[RANKS * 8, 128]`` float32 (from
    ``SEED``) bit-equal to numpy's; returns (ClaimChecker, rows of (name,
    ok, microseconds per call))."""
    n = RANKS
    ranks = coll.make_ranks(n, device)
    x = np.random.default_rng(SEED).normal(size=(n * 8, 128)).astype(np.float32)
    want = np.broadcast_to(x, (n,) + x.shape)          # every rank holds all of x
    xs = torch.from_numpy(x).reshape(n, 8, 128).to(ranks.device)
    impls = {
        "reference": coll.reference_all_gather,
        "ring(b2b)": coll.ring_all_gather,
        "bidir(bcst)": coll.bidir_ring_all_gather,
    }
    on_card = ranks.device.type == "cuda"
    rows = []
    cc = ClaimChecker("tpu_collectives")
    for name, fn in impls.items():
        y = fn(xs, ranks).reshape(n, n * 8, 128).cpu().numpy()
        ok = bool(np.array_equal(y, want))
        us = (device_us(fn, xs, ranks) if on_card     # the CPU's is only a smoke value
              else time_us(fn, xs, ranks, reps=5, warmup=1))
        rows.append((name, ok, us))
        cc.check(f"{name} correct", float(ok), 1, 1, 1)
    if verbose:
        card = torch.cuda.get_device_name(ranks.device) if on_card else None
        where = (f"device us/call, {n} ranks emulated on one {card}, no interconnect figure"
                 if on_card else "wall us/call on the CPU")
        for name, ok, us in rows:
            print(f"  {name:12s} correct={ok} {us:8.1f} us/call ({where})")
        # structural accounting (steps ~ sync rounds on the critical path)
        steps_ring = n - 1
        steps_bidir = (n - 1 + 1) // 2
        if steps_bidir:
            print(f"  ring steps={steps_ring}, bidirectional steps={steps_bidir} "
                  f"({steps_ring/steps_bidir:.1f}x fewer sync rounds — the bcst analogue)")
    return cc, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cc, _ = run(device=args.device)
    return 0 if cc.report() else 1


if __name__ == "__main__":
    raise SystemExit(main())
