"""Collectives entry point: every variant of the ring all-gather (B3) and
all-to-all (B4) kernels over ranks emulated on the card, each checked
against its numpy oracle, then ``CommBackend('latte')`` on the four
collectives with the variant its dispatch table picks.  Counterpart of
``examples/pallas_collectives.py`` and ``benchmarks/tpu_collectives.py``.

    PYTHONPATH=src python -m repro_torch.launch.collectives --ranks 8

Data is made with numpy from ``--seed``.  All-gather and all-to-all must be
bit-equal to their oracles; reduce-scatter and all-reduce (float32) within
atol 1e-4 of numpy's ``sum(axis=0)``.  ``--device cpu`` runs the plain
versions and the CPU step schedules instead of the kernels.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import collectives as coll
from repro_torch.core.backend import COLLECTIVES, CommBackend
from repro_torch.kernels.ring_all_gather import ops as ag_ops
from repro_torch.kernels.ring_all_to_all import ops as aa_ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _equal(got: torch.Tensor, want: np.ndarray) -> bool:
    return np.array_equal(got.float().cpu().numpy(), want)


def run_kernels(ranks: coll.RankGroup, chunk: int, width: int, seed: int) -> dict:
    """Every B3/B4 variant in f32 and bf16 against its oracle; returns
    {name: ok}.  Raises if a kernel's wait ran out of polls."""
    n, rng, results = ranks.n, np.random.default_rng(seed), {}
    for dname, dtype in DTYPES.items():
        x = torch.from_numpy(rng.normal(size=(n, chunk, width)).astype(np.float32)).to(dtype)
        xs = x.to(ranks.device)
        want = np.broadcast_to(x.float().numpy().reshape(1, n * chunk, width),
                               (n, n * chunk, width))
        for variant in ag_ops.VARIANTS:
            results[f"ring_all_gather {variant} {dname}"] = _equal(
                ag_ops.ring_all_gather(xs, variant), want)
        xa = torch.from_numpy(rng.normal(size=(n, n, chunk, width)).astype(np.float32))
        xa = xa.to(dtype)
        want = np.swapaxes(xa.float().numpy(), 0, 1)
        for variant in aa_ops.VARIANTS:
            results[f"all_to_all {variant} {dname}"] = _equal(
                aa_ops.all_to_all(xa.to(ranks.device), variant), want)
    if ranks.device.type == "cuda":
        ag_ops.check()
        aa_ops.check()
    return results


def run_backend(ranks: coll.RankGroup, chunk: int, width: int, seed: int) -> dict:
    """``CommBackend('latte', axis_devices=n)`` on the four collectives (f32):
    {collective: (chosen variant, message bytes, ok)}."""
    n, rng = ranks.n, np.random.default_rng(seed + 1)
    # the bundled tables cover 16 devices; others are derived, not stale
    be = CommBackend("latte", axis_devices=n, allow_stale_tables=True)
    shard = rng.normal(size=(n, chunk, width)).astype(np.float32)
    chunks = rng.normal(size=(n, n, chunk, width)).astype(np.float32)
    total = chunks.sum(axis=0)
    operands = {"all_gather": shard, "all_to_all": chunks, "reduce_scatter": chunks,
                "all_reduce": chunks}
    oracles = {"all_gather": (np.broadcast_to(shard, (n,) + shard.shape), 0.0),
               "all_to_all": (np.swapaxes(chunks, 0, 1), 0.0),
               "reduce_scatter": (total, 1e-4),
               "all_reduce": (np.broadcast_to(total, (n,) + total.shape), 1e-4)}
    out = {}
    for name in COLLECTIVES:
        xs = torch.from_numpy(operands[name]).to(ranks.device)
        size = be.message_bytes(name, xs)
        variant, _ = be.choose(name, size)
        got = getattr(be, name)(xs, ranks).cpu().numpy()
        want, atol = oracles[name]
        ok = np.array_equal(got, want) if atol == 0 else np.allclose(got, want, atol=atol)
        out[name] = (variant, size, bool(ok))
    if ranks.device.type == "cuda":
        ag_ops.check()
        aa_ops.check()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=64, help="rows of each rank's chunk")
    ap.add_argument("--width", type=int, default=1024, help="elements per row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ranks = coll.make_ranks(args.ranks, args.device)
    where = torch.cuda.get_device_name(ranks.device) if ranks.device.type == "cuda" else "cpu"
    print(f"{args.ranks} ranks emulated on {where}; chunk [{args.chunk}, {args.width}]")
    before = (ag_ops.launches, aa_ops.launches)
    kernels = run_kernels(ranks, args.chunk, args.width, args.seed)
    for name, ok in kernels.items():
        print(f"  {name:36s} {'OK' if ok else 'MISMATCH'}")
    backend = run_backend(ranks, args.chunk, args.width, args.seed)
    for name, (variant, size, ok) in backend.items():
        print(f"  CommBackend('latte').{name:15s} {size:>10d} B -> {variant:16s} "
              f"{'OK' if ok else 'MISMATCH'}")
    print(f"  kernel launches: ring_all_gather {ag_ops.launches - before[0]}, "
          f"all_to_all {aa_ops.launches - before[1]}")
    bad = [k for k, ok in kernels.items() if not ok] + \
          [k for k, (_, _, ok) in backend.items() if not ok]
    if bad:
        raise SystemExit(f"mismatch: {bad}")
    print("all collectives validated against their oracles")


if __name__ == "__main__":
    main()
