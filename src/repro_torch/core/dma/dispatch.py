"""Size-range dispatch policy — the paper's Tables 2 & 3, plus a derived
policy that re-discovers the thresholds from the timing model (used both to
validate the model against the paper and to re-derive thresholds for the TPU
topology used by the JAX-level latte collectives, DESIGN.md §4/§5).

Optimized command streams (DESIGN.md §7): passing ``allow_optimized=True``
to :func:`candidate_variants` / :func:`derive_dispatch` adds the ``opt_``
variants (batched submission + SDMA queue slots + fused write+signal) to the
argmin, re-deriving the thresholds with the optimization layer available —
the baseline-vs-optimized sweep behind ``benchmarks/fig13*/fig14*
--optimized``.  The default sweeps stay baseline-only so the paper's
Tables 2/3 structure remains reproducible as published.

Chunked command streams (DESIGN.md §8): every schedule is built with the
topology's calibrated ``max_chunk_bytes`` by default, and the sweep can
additionally treat the chunk granularity as a policy dimension —
``derive_dispatch(..., chunk_sizes=...)`` runs the argmin over
(variant, chunk) pairs and records the winning chunk size per range.

Pipelined ring collectives (DESIGN.md §9): ``allow_pipelined=True`` adds the
per-chunk-signaled ``pipe_`` family (``pipe_b2b``, ``pipe_bidir_ring`` and
their ``prelaunch_``/``opt_`` compositions) to the argmin on neighbor-link
topologies — the sweep behind ``benchmarks/fig13*/fig14* --pipelined`` and
the v4 bundled TPU tables.

Reduce collectives (DESIGN.md §10): ``allow_reduce=True`` unlocks the
``reduce_scatter`` / ``all_reduce`` collectives — the ring reduce family
(``ring_rs``, ``bidir_ring_rs``; with ``allow_pipelined`` also the
per-chunk ``pipe_ring_rs`` / ``pipe_bidir_ring_rs``) on every topology (the
ring embedding is the only modeled reduce schedule shape, so unlike the
``pipe_`` all-gather family it is offered on fully-connected fabrics too).
The explicit opt-in keeps pre-§10 sweeps byte-identical and makes an
accidental ``reduce_scatter`` request against an old call site fail loudly
instead of silently sweeping an empty candidate set.

Fused compute-collective overlap (DESIGN.md §15): ``allow_fused=True``
unlocks the ``fused_gemm_rs`` / ``fused_ag_gemm`` pseudo-collectives — the
argmin sweeps overlap depth (``d2/d4/d8``) x reduction placement
(``cu``/``engine``, GEMM+reduce-scatter only) against the sequential
GEMM-then-collective baseline (``seq``).  Like ``allow_reduce`` the opt-in
keeps earlier sweeps byte-identical; the fused builders have no
hierarchical multi-node rendering and raise on ``n_nodes > 1``.

Hierarchical multi-node collectives (DESIGN.md §11): on a multi-node
topology (``topo.n_nodes > 1``) the candidate set is the ``hier_`` family —
intra-node ring tier composed with an inter-node NIC tier, the only modeled
schedule shape that keeps per-device work translation-invariant across the
node boundary.  ``all_to_all`` has no hierarchical rendering and raises.

Simulation results are memoized: :func:`variant_latency` caches every
(topology, collective, size, variant, chunk) point and
:func:`derive_dispatch` caches whole argmin sweeps, so repeated claim
evaluations and dispatch-table derivations in one process pay for each
simulation once.  Sweeps run on the vectorized fast path (DESIGN.md
§11.3): symmetric candidates evaluate over the whole size grid with
representative-only builds (:mod:`repro_torch.core.dma.sweep`), bit-identical to
the per-point ``simulate()`` loop, which is what makes the 64/256-device
multi-node tables derivable inside CI budgets.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np

from .collectives import (FUSED_AG_VARIANTS, FUSED_RS_VARIANTS,
                          allgather_schedule, allreduce_schedule,
                          alltoall_schedule, fused_ag_gemm_schedule,
                          fused_gemm_rs_schedule, reduce_scatter_schedule)
from .engine import simulate
from .faults import straggler_plan
from .sweep import argmin_grid, sweep_variant_latencies
from .topology import Topology

#: Schedule builder per collective name (the dispatch/claims vocabulary).
COLLECTIVE_BUILDERS = {
    "all_gather": allgather_schedule,
    "all_to_all": alltoall_schedule,
    "reduce_scatter": reduce_scatter_schedule,
    "all_reduce": allreduce_schedule,
    "fused_gemm_rs": fused_gemm_rs_schedule,
    "fused_ag_gemm": fused_ag_gemm_schedule,
}

#: The fused pseudo-collectives (DESIGN.md §15) — gated by ``allow_fused``.
FUSED_COLLECTIVES = ("fused_gemm_rs", "fused_ag_gemm")

KB = 1024
MB = 1024 * 1024
GB = 1024 * 1024 * 1024

# Paper Table 2 — best implementation per all-gather size range.
PAPER_AG_DISPATCH: tuple[tuple[int, int | None, str], ...] = (
    (1 * KB, 256 * KB, "prelaunch_b2b"),
    (256 * KB, 1 * MB, "prelaunch_bcst"),
    (1 * MB, 512 * MB, "prelaunch_pcpy"),
    (512 * MB, None, "pcpy"),
)

# Paper Table 3 — best implementation per all-to-all size range.
PAPER_AA_DISPATCH: tuple[tuple[int, int | None, str], ...] = (
    (1 * KB, 64 * KB, "prelaunch_b2b"),
    (64 * KB, 4 * MB, "prelaunch_swap"),
    (4 * MB, 1 * GB, "prelaunch_pcpy"),
    (1 * GB, None, "pcpy"),
)


def paper_dispatch(collective: str, size: int) -> str:
    table = PAPER_AG_DISPATCH if collective == "all_gather" else PAPER_AA_DISPATCH
    for lo, hi, variant in table:
        if size >= lo and (hi is None or size < hi):
            return variant
    return table[0][2] if size < table[0][0] else table[-1][2]


@dataclasses.dataclass(frozen=True)
class DispatchEntry:
    lo: int
    hi: int | None
    variant: str
    # Winning sDMA chunk granularity for the range (DESIGN.md §8.1);
    # None = the topology's calibrated default max_chunk_bytes.
    chunk: int | None = None


def variant_latency(topo: Topology, collective: str, size: int, variant: str,
                    chunk_bytes: int | None = None) -> float:
    """Memoized latency of one (collective, size, variant, chunk) point.

    ``chunk_bytes=None`` uses the topology's calibrated ``max_chunk_bytes``
    (schedules are always chunked, DESIGN.md §8.1); an explicit value
    overrides the chunk granularity and is part of the memo key.  The thin
    wrapper normalizes the default so 4-arg callers (claims) and explicit
    ``chunk_bytes=None`` callers (sweeps) share one cache entry.
    """
    return _variant_latency_cached(topo, collective, size, variant, chunk_bytes)


@functools.lru_cache(maxsize=65536)
def _variant_latency_cached(topo: Topology, collective: str, size: int,
                            variant: str, chunk_bytes: int | None) -> float:
    builder: Callable = COLLECTIVE_BUILDERS[collective]
    return simulate(builder(topo, size, variant, max_chunk_bytes=chunk_bytes),
                    topo).latency


def candidate_variants(
    topo: Topology,
    collective: str,
    *,
    allow_prelaunch: bool = True,
    allow_optimized: bool = False,
    allow_pipelined: bool = False,
    allow_reduce: bool = False,
    allow_fused: bool = False,
) -> list[str]:
    """Variants an argmin sweep should consider on this topology.

    ``allow_optimized`` additionally offers every candidate with the
    optimized command-stream transforms applied (``opt_`` prefix,
    DESIGN.md §7).  ``allow_pipelined`` adds the per-chunk-signaled
    pipelined rings (``pipe_`` family, DESIGN.md §9) on neighbor-link
    topologies — like the chained rings they only make sense where the
    torus embedding is the native route, so fully-connected fabrics skip
    them.  ``allow_reduce`` unlocks the ``reduce_scatter`` / ``all_reduce``
    collectives (ring reduce family, DESIGN.md §10; offered on every
    topology — the ring embedding is the only modeled reduce shape, and
    ``allow_pipelined`` adds the per-chunk ``pipe_*_rs`` renderings).
    Prefixes compose: with all flags set the sweep also offers
    ``prelaunch_pipe_*`` and ``opt_[prelaunch_]pipe_*``.

    Multi-node topologies (``topo.n_nodes > 1``, DESIGN.md §11) sweep the
    hierarchical family instead: ``hier_ring`` (+ ``hier_pipe`` under
    ``allow_pipelined``) for all-gather, ``hier_ring_rs`` (+
    ``hier_pipe_rs``) for the reduce collectives.  The flat variants still
    *build* on multi-node topologies (the claims compare against them) but
    are excluded from the sweep: none are translation invariant across the
    node boundary, so every flat candidate would force the full
    multi-device event loop — unaffordable at 64/256 devices — and their
    NIC traffic scales with total device count instead of node count (the
    flat ring loses outright, ``hier_ag_nic_gain``; the direct fan-outs
    stay competitive at 2 nodes in the model but saturate the NIC at the
    slice counts the tables target).  ``all_to_all`` has no hierarchical
    rendering (every pair exchanges distinct data, so there is no
    intra/inter decomposition that reduces NIC bytes) and raises.

    ``allow_fused`` unlocks the fused compute-collective pseudo-collectives
    (``fused_gemm_rs`` / ``fused_ag_gemm``, DESIGN.md §15): the candidate
    set is the overlap-depth x reduction-placement grid plus the ``seq``
    control arm.  They are ring renderings, so — like the reduce family —
    they are offered on every single-node topology, but have no
    hierarchical multi-node shape and raise on ``n_nodes > 1``.
    """
    if collective in FUSED_COLLECTIVES:
        if not allow_fused:
            raise ValueError(
                f"collective {collective!r} needs allow_fused=True "
                "(DESIGN.md §15)")
        if topo.n_nodes > 1:
            raise ValueError(
                "the fused compute-collective builders have no "
                "hierarchical multi-node rendering (DESIGN.md §15); "
                "derive fused tables on single-node topologies only")
        variants = list(FUSED_RS_VARIANTS if collective == "fused_gemm_rs"
                        else FUSED_AG_VARIANTS)
        if allow_prelaunch:
            variants += [f"prelaunch_{v}" for v in list(variants)]
        if allow_optimized:
            variants += [f"opt_{v}" for v in list(variants)]
        return variants
    if topo.n_nodes > 1:
        if collective == "all_to_all":
            raise ValueError(
                "all_to_all has no hierarchical multi-node rendering "
                "(DESIGN.md §11); derive multi-node tables for "
                "all_gather/reduce_scatter/all_reduce only")
        if collective in ("reduce_scatter", "all_reduce"):
            if not allow_reduce:
                raise ValueError(
                    f"collective {collective!r} needs allow_reduce=True "
                    "(DESIGN.md §10)")
            variants = ["hier_ring_rs"]
            if allow_pipelined:
                variants.append("hier_pipe_rs")
        else:
            variants = ["hier_ring"]
            if allow_pipelined:
                variants.append("hier_pipe")
        if allow_prelaunch:
            variants += [f"prelaunch_{v}" for v in list(variants)]
        if allow_optimized:
            variants += [f"opt_{v}" for v in list(variants)]
        return variants
    if collective in ("reduce_scatter", "all_reduce"):
        if not allow_reduce:
            raise ValueError(
                f"collective {collective!r} needs allow_reduce=True "
                "(DESIGN.md §10)")
        variants = ["ring_rs", "bidir_ring_rs"]
        if allow_pipelined:
            variants += ["pipe_ring_rs", "pipe_bidir_ring_rs"]
    else:
        variants = ["pcpy", "b2b", "bcst" if collective == "all_gather" else "swap"]
        if not topo.fully_connected:
            variants.append("ring")
            if collective == "all_gather":
                variants.append("bidir_ring")
            if allow_pipelined:
                variants.append("pipe_b2b")
                if collective == "all_gather":
                    variants.append("pipe_bidir_ring")
    if allow_prelaunch:
        variants += [f"prelaunch_{v}" for v in list(variants)]
    if allow_optimized:
        variants += [f"opt_{v}" for v in list(variants)]
    return variants


def optimized_variants(topo: Topology, collective: str) -> list[str]:
    """The ``opt_`` candidate set alone (DESIGN.md §7) — what the optimized
    claim bands and the ``--optimized`` benchmark curves sweep over."""
    return [v for v in candidate_variants(topo, collective, allow_optimized=True)
            if v.startswith("opt_")]


def pipelined_variants(topo: Topology, collective: str) -> list[str]:
    """The ``pipe_`` candidate set alone (DESIGN.md §9) — every pipelined
    ring rendering including its ``prelaunch_``/``opt_`` compositions; what
    the pipelined claim bands and ``--pipelined`` benchmark curves sweep."""
    return [v for v in candidate_variants(topo, collective, allow_optimized=True,
                                          allow_pipelined=True,
                                          allow_reduce=True)
            if "pipe_" in v]


def reduce_variants(topo: Topology, collective: str = "reduce_scatter") -> list[str]:
    """The full reduce candidate set (DESIGN.md §10): the ring reduce
    family with every ``prelaunch_``/``opt_``/``pipe_`` composition — what
    the §10 claim bands and ``benchmarks/fig_allreduce.py`` sweep."""
    return candidate_variants(topo, collective, allow_optimized=True,
                              allow_pipelined=True, allow_reduce=True)


def fused_variants(topo: Topology, collective: str = "fused_gemm_rs") -> list[str]:
    """The bare fused candidate set (DESIGN.md §15): overlap depth x
    reduction placement plus the ``seq`` control arm, without the
    ``prelaunch_``/``opt_`` compositions — what the §15 claim bands and
    ``benchmarks/fig_fused_overlap.py`` sweep."""
    return candidate_variants(topo, collective, allow_prelaunch=False,
                              allow_fused=True)


def sweep_candidate_latencies(topo: Topology, collective: str,
                              sizes: tuple[int, ...], variant: str,
                              chunk_bytes: int | None) -> list[float]:
    """One (variant, chunk) candidate's latency over the whole size grid.

    Symmetric candidates take the vectorized fast path (representative-only
    builds + single-device event loop, DESIGN.md §11.3); everything else
    falls back to the memoized per-point ``simulate()`` loop.  Either way
    the values are bit-identical to calling :func:`variant_latency` per
    size — asserted over every bundled table entry in tests/test_hier.py —
    so callers never need to know which path ran.
    """
    fast = sweep_variant_latencies(topo, collective, tuple(sizes), variant,
                                   chunk_bytes)
    if fast is not None:
        return fast
    return [variant_latency(topo, collective, size, variant, chunk_bytes)
            for size in sizes]


@functools.lru_cache(maxsize=256)
def _derive_dispatch_cached(
    topo: Topology,
    collective: str,
    sizes: tuple[int, ...],
    allow_prelaunch: bool,
    allow_optimized: bool,
    chunk_sizes: tuple[int | None, ...],
    allow_pipelined: bool = False,
    allow_reduce: bool = False,
    allow_fused: bool = False,
) -> tuple[DispatchEntry, ...]:
    variants = candidate_variants(topo, collective, allow_prelaunch=allow_prelaunch,
                                  allow_optimized=allow_optimized,
                                  allow_pipelined=allow_pipelined,
                                  allow_reduce=allow_reduce,
                                  allow_fused=allow_fused)

    # Candidate axis in the historical sweep order (variant-major, the
    # calibrated default chunk first) so the vectorized argmin's earlier-
    # candidate tie-breaking reproduces the per-point loop exactly.
    candidates = [(v, ch) for v in variants for ch in chunk_sizes]
    lat = [sweep_candidate_latencies(topo, collective, sizes, v, ch)
           for v, ch in candidates]
    # Strict-improvement-with-tolerance argmin, one numpy pass per
    # candidate over the size axis (DESIGN.md §11.3): prelaunched variants
    # are chunk-flat (the per-chunk host cost is off the critical path), so
    # without the epsilon the chunk winner would be picked on float noise
    # and churn the derived ranges.  Earlier candidates (the calibrated
    # default chunk first) win ties.
    best_i, _ = argmin_grid(lat)
    winners = [(size, *candidates[i]) for size, i in zip(sizes, best_i)]

    entries: list[DispatchEntry] = []
    for size, v, ch in winners:
        if entries and entries[-1].variant == v and entries[-1].chunk == ch:
            entries[-1] = DispatchEntry(entries[-1].lo, None, v, ch)
        else:
            if entries:
                entries[-1] = dataclasses.replace(entries[-1], hi=size)
            entries.append(DispatchEntry(size, None, v, ch))
    return tuple(entries)


def derive_dispatch(
    topo: Topology,
    collective: str,
    sizes: list[int],
    *,
    allow_prelaunch: bool = True,
    allow_optimized: bool = False,
    allow_pipelined: bool = False,
    allow_reduce: bool = False,
    allow_fused: bool = False,
    chunk_sizes=None,
) -> list[DispatchEntry]:
    """Re-derive the best variant per size from the timing model (argmin).

    Adjacent sizes with the same winner are merged into ranges, which should
    approximately reproduce Tables 2/3 on the MI300X topology (validated in
    tests/benchmarks) and gives the policy for the TPU topology.  With
    ``allow_optimized`` the sweep also offers the ``opt_`` command streams
    (DESIGN.md §7); ``allow_pipelined`` adds the per-chunk-signaled
    pipelined rings (DESIGN.md §9) on neighbor-link topologies.
    ``chunk_sizes`` adds the sDMA chunk granularity as a policy dimension
    (DESIGN.md §8.1): the argmin runs over (variant, chunk) pairs and each
    entry records its winning ``chunk`` (``None`` = the topology's
    calibrated default; for ``pipe_`` variants the chunk granularity also
    bounds the pipeline depth).  ``allow_reduce`` unlocks the
    ``reduce_scatter``/``all_reduce`` collectives (DESIGN.md §10) and
    ``allow_fused`` the fused compute-collective pseudo-collectives
    (DESIGN.md §15).  Sweeps are memoized per (topology, collective,
    sizes, allow_prelaunch, allow_optimized, allow_pipelined,
    allow_reduce, allow_fused, chunk_sizes).
    """
    chunks = (None,) if chunk_sizes is None else tuple(chunk_sizes)
    return list(_derive_dispatch_cached(topo, collective, tuple(sizes),
                                        allow_prelaunch, allow_optimized,
                                        chunks, allow_pipelined, allow_reduce,
                                        allow_fused))


def best_variant_for(topo: Topology, collective: str, size: int,
                     variants) -> tuple[str, float]:
    """Argmin over an explicit variant list at one size (memoized points)."""
    best, best_t = None, float("inf")
    for v in variants:
        t = variant_latency(topo, collective, size, v)
        if t < best_t:
            best, best_t = v, t
    return best, best_t


def pick_variant(entries: list[DispatchEntry], size: int) -> str:
    for e in entries:
        if size >= e.lo and (e.hi is None or size < e.hi):
            return e.variant
    return entries[-1].variant if size >= entries[-1].lo else entries[0].variant


# ---------------------------------------------------------------------------
# Dispatch robustness (DESIGN.md §13.5): which bundled-table winners survive
# calibration drift and straggler engines?
# ---------------------------------------------------------------------------

#: Named calibration perturbations (field -> multiplicative scale).  The
#: scales bracket realistic drift: host-side costs vary with CPU load and
#: kernel version (+50%), link efficiency with cable/firmware degradation
#: (-20%), engine bandwidth with thermal throttling (-30%).  All scales keep
#: every Calibration field inside its validated domain.
PERTURB_SCENARIOS: tuple[tuple[str, dict[str, float]], ...] = (
    ("control+50%", {"control": 1.5, "control_batched": 1.5}),
    ("doorbell+50%", {"doorbell": 1.5, "doorbell_batched": 1.5}),
    ("sync+50%", {"sync_engine": 1.5, "fused_sync": 1.5,
                  "sync_obs": 1.5, "sync_obs_batched": 1.5}),
    ("link_eff-20%", {"dma_link_efficiency": 0.8}),
    ("engine_bw-30%", {"engine_bw": 0.7}),
)


def perturbed_topology(topo: Topology, scales: dict[str, float]) -> Topology:
    """``topo`` with each named Calibration field scaled multiplicatively.

    The perturbed topology is a distinct frozen value, so the
    :func:`variant_latency` memo and the sweep fast path treat it as a
    fresh calibration — no cache invalidation needed."""
    calib = dataclasses.replace(
        topo.calib,
        **{f: getattr(topo.calib, f) * s for f, s in scales.items()})
    return dataclasses.replace(topo, calib=calib)


@dataclasses.dataclass(frozen=True)
class FragileEntry:
    """One (size, scenario) point whose dispatch winner flipped.

    ``regret`` is what shipping the base winner costs under the scenario:
    base winner's latency there / the scenario's best latency (>= 1; 1.0
    means the flip is a tie and the table entry is effectively robust)."""

    size: int
    scenario: str
    base_variant: str
    new_variant: str
    regret: float


@dataclasses.dataclass(frozen=True)
class RobustnessReport:
    """Winner-stability audit of one dispatch sweep (DESIGN.md §13.5)."""

    collective: str
    scenarios: tuple[str, ...]
    n_points: int                        # len(sizes) x len(scenarios)
    fragile: tuple[FragileEntry, ...]    # sorted by (size, scenario)

    @property
    def n_fragile(self) -> int:
        return len(self.fragile)

    @property
    def fragile_fraction(self) -> float:
        return self.n_fragile / self.n_points if self.n_points else 0.0

    @property
    def max_regret(self) -> float:
        return max((f.regret for f in self.fragile), default=1.0)


def dispatch_robustness(
    topo: Topology,
    collective: str,
    sizes: list[int],
    *,
    allow_prelaunch: bool = True,
    allow_optimized: bool = False,
    allow_pipelined: bool = False,
    allow_reduce: bool = False,
    chunk_bytes: int | None = None,
    scenarios: tuple[tuple[str, dict[str, float]], ...] = PERTURB_SCENARIOS,
    straggler_slowdown: float | None = 4.0,
    variants: list[str] | None = None,
) -> RobustnessReport:
    """Re-run winner selection under perturbed calibrations and a straggler
    scenario; flag fragile entries whose winners flip (DESIGN.md §13.5).

    The base sweep is the same (variants x sizes) argmin
    :func:`derive_dispatch` runs.  Each named calibration scenario rebuilds
    the latency matrix on a :func:`perturbed_topology` (vectorized fast path
    where symmetric); ``straggler_slowdown`` adds a full-event-loop scenario
    (``straggler_x<s>``) where device 0's engines stream that much slower —
    the one fault the symmetric fast path cannot express, so it costs
    len(variants) x len(sizes) full simulations; pass ``None`` to skip.
    ``variants`` overrides the candidate set (the claims use this to probe a
    deliberately fragile pair).  Deterministic throughout: the matrices
    replay the same argmin, and ``fragile`` is sorted by (size, scenario).
    """
    variants = list(variants) if variants is not None else candidate_variants(
        topo, collective, allow_prelaunch=allow_prelaunch,
        allow_optimized=allow_optimized, allow_pipelined=allow_pipelined,
        allow_reduce=allow_reduce)
    sizes = list(sizes)
    base = [sweep_candidate_latencies(topo, collective, tuple(sizes), v,
                                      chunk_bytes)
            for v in variants]
    base_i, _ = argmin_grid(base)

    named: list[tuple[str, list[list[float]]]] = []
    for name, scales in scenarios:
        ptopo = perturbed_topology(topo, scales)
        named.append((name, [sweep_candidate_latencies(
            ptopo, collective, tuple(sizes), v, chunk_bytes)
            for v in variants]))
    if straggler_slowdown is not None:
        plan = straggler_plan(0, straggler_slowdown)
        builder = COLLECTIVE_BUILDERS[collective]
        named.append((f"straggler_x{straggler_slowdown:g}", [
            [simulate(builder(topo, size, v, max_chunk_bytes=chunk_bytes),
                      topo, faults=plan).latency for size in sizes]
            for v in variants]))

    fragile: list[FragileEntry] = []
    for name, lat in named:
        alt = np.asarray(lat, dtype=float)
        alt_i, alt_t = argmin_grid(alt)
        for j in np.flatnonzero(alt_i != base_i):
            fragile.append(FragileEntry(
                size=sizes[j], scenario=name,
                base_variant=variants[base_i[j]],
                new_variant=variants[alt_i[j]],
                regret=float(alt[base_i[j], j] / alt_t[j])))
    fragile.sort(key=lambda f: (f.size, f.scenario))
    return RobustnessReport(
        collective=collective,
        scenarios=tuple(name for name, _ in named),
        n_points=len(sizes) * len(named),
        fragile=tuple(fragile))
