"""Collectives entry point: every variant of the ring all-gather (B3) and
all-to-all (B4) kernels over ranks emulated on the card, each checked
against its numpy oracle, then ``CommBackend('latte')`` on the four
collectives with the variant its dispatch table picks.  Counterpart of
``examples/pallas_collectives.py`` and ``benchmarks/tpu_collectives.py``.

    PYTHONPATH=src python -m repro_torch.launch.collectives --ranks 8
    PYTHONPATH=src python -m repro_torch.launch.collectives --ranks 8 --procs

``--procs`` spawns ``--ranks`` processes, one rank each
(``core.procgroup.spawn``): every B3 and B4 variant runs per rank (each
process launches its own rank's CTAs and stores into its peers' memory
through CUDA IPC; over gloo on the CPU), bit-equal to its numpy oracle, then
``CommBackend('latte')`` on the four collectives over the processes (the
reductions through the per-rank ring reduce-scatter kernel).

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
from repro_torch.core.backend import COLLECTIVES, CommBackend, tpu_dispatch_tables
from repro_torch.core.procgroup import ProcessRanks, spawn
from repro_torch.kernels.ring_all_gather import ops as ag_ops
from repro_torch.kernels.ring_all_to_all import ops as aa_ops
from repro_torch.kernels.ring_reduce_scatter import ops as rs_ops

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


def run_rank(ranks: ProcessRanks, chunk: int, width: int, seed: int) -> dict:
    """One process of ``--procs``: every B3/B4 variant per rank in f32 and
    bf16 against its numpy oracle, then ``CommBackend('latte')`` on the four
    collectives (f32; the reductions within atol 1e-4 of numpy's sum).
    Every rank makes the same inputs from ``seed`` and keeps its own part.
    Returns {"kernels": {name: ok}, "backend": {collective: (variant, bytes,
    ok)}, "launches": (B3, B4, reduce-scatter)}."""
    n, my, dev = ranks.n, ranks.rank, ranks.device
    rng, kernels = np.random.default_rng(seed), {}
    before = (ag_ops.launches_rank, aa_ops.launches_rank, rs_ops.launches_rank)
    for dname, dtype in DTYPES.items():
        x = torch.from_numpy(rng.normal(size=(n, chunk, width)).astype(np.float32)).to(dtype)
        want = x.float().numpy().reshape(n * chunk, width)
        for variant in ag_ops.VARIANTS:
            kernels[f"ring_all_gather {variant} {dname}"] = _equal(
                ag_ops.ring_all_gather_rank(x[my].to(dev), ranks, variant), want)
        xa = torch.from_numpy(rng.normal(size=(n, n, chunk, width)).astype(np.float32))
        xa = xa.to(dtype)
        want = xa[:, my].float().numpy()
        for variant in aa_ops.VARIANTS:
            kernels[f"all_to_all {variant} {dname}"] = _equal(
                aa_ops.all_to_all_rank(xa[my].to(dev), ranks, variant), want)
    rng = np.random.default_rng(seed + 1)
    be = CommBackend("latte", axis_devices=n, allow_stale_tables=True)
    shard = rng.normal(size=(n, chunk, width)).astype(np.float32)
    chunks = rng.normal(size=(n, n, chunk, width)).astype(np.float32)
    total = chunks.sum(axis=0)
    backend = {}
    for name, x, want, atol in (("all_gather", shard[my], shard, 0.0),
                                ("all_to_all", chunks[my], chunks[:, my], 0.0),
                                ("reduce_scatter", chunks[my], total[my], 1e-4),
                                ("all_reduce", chunks[my], total, 1e-4)):
        xs = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        size = be.message_bytes(name, xs, ranks)
        got = getattr(be, name)(xs, ranks)
        ok = _equal(got, want) if atol == 0 else np.allclose(got.cpu().numpy(), want, atol=atol)
        backend[name] = (be.choose(name, size)[0], size, bool(ok))
    if dev.type == "cuda":
        ag_ops.check_ranks(ranks)
        aa_ops.check_ranks(ranks)
        rs_ops.check_ranks(ranks)
    after = (ag_ops.launches_rank, aa_ops.launches_rank, rs_ops.launches_rank)
    return {"kernels": kernels, "backend": backend,
            "launches": tuple(a - b for a, b in zip(after, before))}


def main_procs(args) -> None:
    """``--procs``: ``--ranks`` processes, one rank each."""
    tpu_dispatch_tables(args.ranks)      # derived once here; the processes read the cache
    outs = spawn(run_rank, args.ranks, device=args.device,
                 args=(args.chunk, args.width, args.seed))
    where = (f"{torch.cuda.get_device_name(0)} (every rank on cuda:r % "
             f"{torch.cuda.device_count()})" if args.device != "cpu" else "cpu, gloo")
    print(f"{args.ranks} ranks, one process each, on {where}; chunk [{args.chunk}, "
          f"{args.width}]")
    bad = []
    for r, out in enumerate(outs):
        for name, ok in out["kernels"].items():
            print(f"  rank {r} {name:36s} {'OK' if ok else 'MISMATCH'}")
            bad += [f"rank {r} {name}"] * (not ok)
        for name, (variant, size, ok) in out["backend"].items():
            print(f"  rank {r} CommBackend('latte').{name:14s} {size:>10d} B -> "
                  f"{variant:16s} {'OK' if ok else 'MISMATCH'}")
            bad += [f"rank {r} {name}"] * (not ok)
    launched = [out["launches"] for out in outs]
    print(f"  per-rank kernel launches (ring_all_gather, all_to_all, ring_reduce_scatter) "
          f"by rank: {launched}")
    if bad:
        raise SystemExit(f"mismatch: {bad}")
    print("all collectives validated against their oracles")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=64, help="rows of each rank's chunk")
    ap.add_argument("--width", type=int, default=1024, help="elements per row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", action="store_true",
                    help="one process per rank (gloo group; CUDA IPC on the card)")
    args = ap.parse_args()
    if args.procs:
        return main_procs(args)
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
