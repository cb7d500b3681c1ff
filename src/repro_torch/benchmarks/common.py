"""Shared helpers for the per-figure benchmarks."""
from __future__ import annotations

import math
import time

KB = 1024
MB = 1024 * 1024
GB = 1024 * 1024 * 1024

SMALL_SIZES = [2 ** i for i in range(10, 26)]   # 1KB..32MB
LARGE_SIZES = [2 ** i for i in range(26, 33)]   # 64MB..4GB
ALL_SIZES = SMALL_SIZES + LARGE_SIZES


def geomean(xs):
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def fmt_size(s: int) -> str:
    if s >= GB:
        return f"{s // GB}G"
    if s >= MB:
        return f"{s // MB}M"
    return f"{s // KB}K"


def time_us(fn, *args, reps: int = 200, warmup: int = 20) -> float:
    """Wall-clock microseconds per call (for CSV reporting)."""
    for _ in range(warmup):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps * 1e6


#: Chunk granularities the ``--optimized`` figure sweeps offer the argmin
#: (DESIGN.md §8.1): the calibrated hardware ceiling (None) plus finer splits.
CHUNK_SWEEP = (None, 2 * MB, 1 * MB)


def optimized_report(cc: "ClaimChecker", topo, collective: str,
                     lat: dict, rccl: dict, verbose: bool) -> None:
    """Shared ``--optimized`` tail for fig13/fig14: baseline-vs-optimized
    curve, chunk-size sensitivity at GB scale, re-derived dispatch with the
    ``opt_`` streams over (variant, chunk) pairs (DESIGN.md §7/§8), and the
    optimized claim bands for ``collective``."""
    from repro_torch.core.dma import derive_dispatch, variant_latency
    from repro_torch.core.dma.claims import optimized_stream_claims

    base_vs = {v for v in lat if not v.startswith("opt_")}
    opt_vs = {v for v in lat if v.startswith("opt_")}
    if verbose:
        print("\nbaseline-vs-optimized (speedup vs RCCL; gain = best-opt/best-base):")
        print(f"{'size':>5} {'best-baseline':>16} {'best-optimized':>16} {'gain':>7}")
        for s in ALL_SIZES:
            b = min(lat[v][s] for v in base_vs)
            o = min(lat[v][s] for v in opt_vs)
            print(f"{fmt_size(s):>5} {rccl[s]/b:16.2f} {rccl[s]/o:16.2f} {b/o:7.2f}")
        chunks = [c for c in (512 * KB, 1 * MB, 2 * MB, 4 * MB)
                  if c <= topo.calib.max_chunk_bytes]
        print("\nchunk-size sensitivity (opt gain = pcpy/opt_pcpy per "
              "max_chunk_bytes, DESIGN.md §8.1):")
        print(f"{'size':>5} " + "".join(f"{fmt_size(c):>10}" for c in chunks))
        for s in (256 * MB, 1 * GB, 4 * GB):
            row = []
            for ch in chunks:
                b = variant_latency(topo, collective, s, "pcpy", ch)
                o = variant_latency(topo, collective, s, "opt_pcpy", ch)
                row.append(b / o)
            print(f"{fmt_size(s):>5} " + "".join(f"{g:10.3f}" for g in row))
        table = derive_dispatch(topo, collective, ALL_SIZES,
                                allow_optimized=True, chunk_sizes=CHUNK_SWEEP)
        print("\nDerived dispatch with optimized streams + chunk sweep "
              "(DESIGN.md §7/§8):")
        for e in table:
            hi = fmt_size(e.hi) if e.hi else "inf"
            ch = "calib" if e.chunk is None else fmt_size(e.chunk)
            print(f"  [{fmt_size(e.lo)}, {hi}) -> {e.variant} (chunk {ch})")
    for c in optimized_stream_claims(topo, collectives=(collective,)):
        cc.check(c.description, c.model_value, c.paper_value, c.lo, c.hi)


def pipelined_report(cc: "ClaimChecker", topo, collective: str,
                     lat: dict, rccl: dict, verbose: bool) -> None:
    """Shared ``--pipelined`` tail for fig13/fig14 (DESIGN.md §9): the
    per-chunk-signaled ring curves on the figure's MI300X topology, the
    chunk-depth sensitivity of ``pipe_b2b`` against its final-chunk-only
    control arm, and the §9 claim bands (pinned on the TPU torus, where the
    ring family is the dispatch winner — see ``claims.pipelined_stream_claims``)."""
    from repro_torch.core.dma import simulate
    from repro_torch.core.dma.claims import (PIPE_DEPTH_SWEEP, pipe_vs_final_chunk_ratio,
                                       pipelined_stream_claims)
    from repro_torch.core.dma.collectives import allgather_schedule, alltoall_schedule

    builder = allgather_schedule if collective == "all_gather" else alltoall_schedule
    pipe_vs = ("pipe_b2b", "pipe_bidir_ring", "opt_pipe_bidir_ring",
               "prelaunch_pipe_bidir_ring") if collective == "all_gather" \
        else ("pipe_b2b", "opt_pipe_b2b")
    if verbose:
        print("\npipelined ring streams (speedup vs RCCL; ring = chained "
              "final-chunk-signaling baseline):")
        print(f"{'size':>5} {'ring':>10} " + "".join(f"{v:>26}" for v in pipe_vs))
        for s in ALL_SIZES:
            ring = simulate(builder(topo, s, "ring"), topo).latency
            row = [f"{fmt_size(s):>5} {rccl[s]/ring:10.2f}"]
            for v in pipe_vs:
                row.append(f"{rccl[s]/simulate(builder(topo, s, v), topo).latency:26.2f}")
            print("".join(row))
        print("\nper-chunk vs final-chunk-only signaling of pipe_b2b "
              "(ratio > 1 = per-chunk wins; saturates at the wire floor, "
              "DESIGN.md §9.1):")
        print(f"{'size':>5} " + "".join(f"{'depth ' + str(d):>9}" for d in PIPE_DEPTH_SWEEP))
        for s in (1 * MB, 4 * MB, 32 * MB):
            row = [f"{fmt_size(s):>5} "]
            for d in PIPE_DEPTH_SWEEP:
                row.append(f"{pipe_vs_final_chunk_ratio(topo, s, d, collective=collective):9.3f}")
            print("".join(row))
    for c in pipelined_stream_claims(collectives=(collective,)):
        cc.check(c.description, c.model_value, c.paper_value, c.lo, c.hi)


class ClaimChecker:
    def __init__(self, name: str):
        self.name = name
        self.rows: list[tuple[str, float, float, float, float, bool]] = []

    def check(self, label: str, value: float, paper: float, lo: float, hi: float):
        ok = lo <= value <= hi
        self.rows.append((label, value, paper, lo, hi, ok))
        return ok

    def report(self) -> bool:
        all_ok = True
        for label, v, p, lo, hi, ok in self.rows:
            mark = "OK  " if ok else "FAIL"
            if not ok:
                all_ok = False
            print(f"  [{mark}] {label}: model={v:.3f} paper={p:.3f} band=[{lo},{hi}]")
        return all_ok


# --------------------------------------------------- the port's addition ----
def device_us(fn, *args, reps: int = 50, warmup: int = 5) -> float:
    """Device microseconds per call of ``fn`` on the current CUDA device:
    CUDA events around ``reps`` calls after ``warmup``, synchronised, so the
    time is the device's and not the host's enqueue."""
    import torch

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3
