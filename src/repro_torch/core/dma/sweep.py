"""Vectorized dispatch-sweep fast path (DESIGN.md §11.3).

``derive_dispatch`` historically evaluated one ``simulate()`` call per
(variant, size, chunk) point, and every call built the *full* schedule —
one command stream per device — only for the symmetric fast path to then
simulate a single representative.  On a 16-device pod the build dominates
the point cost ~12×, and it grows linearly with device count: the 64- and
256-device multislice sweeps (DESIGN.md §11) are unreachable in CI budgets
that way.

This module is the batched replacement the multi-node tables run on:

* :func:`sweep_variant_latencies` evaluates one (variant, chunk) candidate
  over the *whole size grid* using representative-only builds — every
  collective builder accepts ``device=`` and emits just that device's
  queues (O(1) in device count, DESIGN.md §11.3) — and the same
  single-device event loop the symmetric fast path runs (``_Sim(topo,
  rep)``), so the returned latencies are **bit-identical** to the per-point
  ``simulate()`` loop by construction: the identical float operations run
  in the identical order, only the dead per-device rebuild work is gone.
  Candidates whose schedule is not symmetric on this topology return
  ``None`` and the caller falls back to the per-point loop — correctness
  never rests on the fast path applying.
* :func:`argmin_grid` replays the sweep's strict-improvement argmin as a
  numpy pass per candidate over the full size axis instead of a Python
  comparison per point.  Same comparisons, same tie-breaking (earlier
  candidate wins within the 1e-9 tolerance), one vectorized sweep.

An affine closed form over the size grid (latency = a + b·size per
structural regime) was considered and rejected: re-deriving coefficients
and evaluating ``a + b·size`` reassociates float additions, so the result
is only *approximately* equal to the event loop — and approximately-equal
latencies flip argmin winners near crossover points, which is exactly
where dispatch thresholds live.  Bit-identity is the contract
(tests/test_hier.py asserts it on every bundled table entry), so the fast
path keeps the scalar op sequence and deletes only redundant work.
"""
from __future__ import annotations

import numpy as np

from .collectives import (allgather_schedule, allreduce_schedule,
                          alltoall_schedule, fused_ag_gemm_schedule,
                          fused_gemm_rs_schedule, reduce_scatter_schedule)
from .sim import _Sim, _breakdown, _finish_device, _run
from .topology import Topology

_BUILDERS = {
    "all_gather": allgather_schedule,
    "all_to_all": alltoall_schedule,
    "reduce_scatter": reduce_scatter_schedule,
    "all_reduce": allreduce_schedule,
    "fused_gemm_rs": fused_gemm_rs_schedule,
    "fused_ag_gemm": fused_ag_gemm_schedule,
}

#: Representative device of a symmetric schedule — the builders emit devices
#: in ascending order, so ``Schedule.devices[0]`` is always device 0 and the
#: rep-only build can target it directly (matches simulate()'s choice).
_REP = 0


def rep_latency(topo: Topology, collective: str, size: int, variant: str,
                chunk_bytes: int | None = None) -> float | None:
    """One point of the fast path: representative-only build + single-device
    event loop.  Returns ``None`` when the schedule is not symmetric on this
    topology (the caller must use the full ``simulate()`` there)."""
    builder = _BUILDERS[collective]
    sched = builder(topo, size, variant, max_chunk_bytes=chunk_bytes,
                    device=_REP)
    if not sched.symmetric or topo.n_devices < 2:
        return None
    sim = _Sim(topo, _REP)
    key = (0, _REP)
    started = _run(sim, [(key, _REP, sched.queues_for(_REP), 0.0)])
    t0, _, cend, states = started[key]
    return _breakdown(t0, cend, *_finish_device(sim, _REP, cend, states, key)).total


def sweep_variant_latencies(
        topo: Topology, collective: str, sizes: tuple[int, ...], variant: str,
        chunk_bytes: int | None = None) -> list[float] | None:
    """Latency of one (variant, chunk) candidate over the whole size grid.

    Bit-identical to ``[simulate(build(size)).latency for size in sizes]``
    when the variant is symmetric on ``topo`` (asserted in
    tests/test_hier.py); ``None`` when it is not — symmetry is a property
    of (variant, topology), not of the message size, so one probe build
    decides for the whole grid.
    """
    if not sizes:
        return []
    first = rep_latency(topo, collective, sizes[0], variant, chunk_bytes)
    if first is None:
        return None
    out = [first]
    for size in sizes[1:]:
        t = rep_latency(topo, collective, size, variant, chunk_bytes)
        assert t is not None  # symmetry cannot vary across the grid
        out.append(t)
    return out


def argmin_grid(lat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Strict-improvement argmin over a (candidates, sizes) latency matrix.

    Vectorized replay of the per-point sweep loop: candidate ``c`` displaces
    the incumbent at a size only when ``lat[c] < best * (1 - 1e-9)`` —
    earlier candidates win ties within the tolerance, exactly like the
    scalar loop (the calibrated-default chunk is ordered first so chunk-flat
    prelaunched variants don't churn on float noise).  Returns
    ``(winner_index, winner_latency)`` arrays over the size axis.
    """
    lat = np.asarray(lat, dtype=float)
    n_cand, n_sizes = lat.shape
    best_t = np.full(n_sizes, np.inf)
    best_i = np.zeros(n_sizes, dtype=int)
    for c in range(n_cand):
        better = lat[c] < best_t * (1.0 - 1e-9)
        best_i[better] = c
        best_t[better] = lat[c][better]
    return best_i, best_t


def winner_flips(base, alt) -> np.ndarray:
    """Size-grid indices where the argmin winner differs between two
    (candidates, sizes) latency matrices over the *same* candidate axis —
    the dispatch-robustness primitive (DESIGN.md §13.5): a flip means the
    bundled table's winner at that size is fragile under the perturbation
    that produced ``alt``."""
    base_i, _ = argmin_grid(base)
    alt_i, _ = argmin_grid(alt)
    return np.flatnonzero(base_i != alt_i)
