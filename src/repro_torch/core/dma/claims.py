"""Paper-claim validation: derive every headline number of the paper from the
calibrated model.  Used by tests (assert bands) and benchmarks (report).
"""
from __future__ import annotations

import dataclasses
import math

from . import collectives as C
from .dispatch import (
    best_variant_for,
    candidate_variants,
    optimized_variants,
    paper_dispatch,
    pipelined_variants,
    variant_latency,
)
from .engine import simulate, single_copy_breakdown
from .power import cu_collective_power, dma_collective_power
from .rccl_model import rccl_collective_latency
from .topology import (
    Topology,
    mi300x_cluster,
    mi300x_platform,
    rccl_aa_calibration,
    rccl_ag_calibration,
    tpu_v5e_multislice,
    tpu_v5e_pod,
)

KB = 1024
MB = 1024 * 1024

SMALL_SIZES = [2 ** i for i in range(10, 26)]    # 1KB .. 32MB
LARGE_SIZES = [2 ** i for i in range(26, 33)]    # 64MB .. 4GB
ALL_SIZES = SMALL_SIZES + LARGE_SIZES


def geomean(xs) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def dma_latency(topo: Topology, collective: str, size: int, variant: str) -> float:
    return variant_latency(topo, collective, size, variant)


def rccl_latency(topo: Topology, collective: str, size: int) -> float:
    calib = rccl_ag_calibration() if collective == "all_gather" else rccl_aa_calibration()
    return rccl_collective_latency(topo, size, calib)


def best_variant_latency(topo: Topology, collective: str, size: int) -> tuple[str, float]:
    v = paper_dispatch(collective, size)
    return v, dma_latency(topo, collective, size, v)


def best_optimized_latency(topo: Topology, collective: str, size: int) -> tuple[str, float]:
    """Best ``opt_`` command stream at one size (DESIGN.md §7): the argmin
    over the optimized candidate set — what the paper's Fig. 13/14
    "optimized" curves plot."""
    return best_variant_for(topo, collective, size,
                            optimized_variants(topo, collective))


@dataclasses.dataclass(frozen=True)
class Claim:
    name: str
    paper_value: float
    model_value: float
    lo: float
    hi: float
    description: str

    @property
    def ok(self) -> bool:
        return self.lo <= self.model_value <= self.hi


def evaluate_claims(topo: Topology | None = None) -> list[Claim]:
    topo = topo or mi300x_platform()
    sub1m = [s for s in SMALL_SIZES if s < 1 * MB]
    upto4m = [s for s in SMALL_SIZES if s <= 4 * MB]

    def g_ratio(coll, sizes, num_v, den_v):
        return geomean(
            dma_latency(topo, coll, s, num_v) / dma_latency(topo, coll, s, den_v)
            for s in sizes
        )

    ag_pcpy = geomean(dma_latency(topo, "all_gather", s, "pcpy") / rccl_latency(topo, "all_gather", s) for s in SMALL_SIZES)
    aa_pcpy = geomean(dma_latency(topo, "all_to_all", s, "pcpy") / rccl_latency(topo, "all_to_all", s) for s in SMALL_SIZES)
    ag_best = geomean(best_variant_latency(topo, "all_gather", s)[1] / rccl_latency(topo, "all_gather", s) for s in SMALL_SIZES)
    aa_best = geomean(best_variant_latency(topo, "all_to_all", s)[1] / rccl_latency(topo, "all_to_all", s) for s in SMALL_SIZES)
    ag_large = geomean(rccl_latency(topo, "all_gather", s) / dma_latency(topo, "all_gather", s, "pcpy") for s in LARGE_SIZES)
    aa_large = geomean(rccl_latency(topo, "all_to_all", s) / dma_latency(topo, "all_to_all", s, "pcpy") for s in LARGE_SIZES)
    fig1_max = max(dma_latency(topo, "all_gather", s, "pcpy") / rccl_latency(topo, "all_gather", s) for s in SMALL_SIZES)

    b4k = single_copy_breakdown(4 * KB, topo)
    b2m = single_copy_breakdown(2 * MB, topo)

    # Power: best DMA vs RCCL at a bandwidth-bound size (paper: ~32% less at >=64MB).
    s_bw = 256 * MB
    v, lat_dma = best_variant_latency(topo, "all_gather", s_bw)
    sim = simulate(C.allgather_schedule(topo, s_bw, v), topo)
    p_dma = dma_collective_power(topo, s_bw, sim).total
    p_cu = cu_collective_power(topo, s_bw, rccl_latency(topo, "all_gather", s_bw)).total
    power_saving_bw = 1 - p_dma / p_cu

    claims = [
        Claim("ag_pcpy_gap_small", 4.5, ag_pcpy, 3.4, 5.6,
              "AG pcpy geomean slowdown vs RCCL, sizes <32MB (paper ~4.5x)"),
        Claim("aa_pcpy_gap_small", 2.5, aa_pcpy, 1.9, 3.3,
              "AA pcpy geomean slowdown vs RCCL, sizes <32MB (paper ~2.5x)"),
        Claim("ag_optimized_small", 1.30, ag_best, 1.1, 1.55,
              "AG best-variant geomean vs RCCL <32MB (paper: 30% slower)"),
        Claim("aa_optimized_small", 0.83, aa_best, 0.70, 0.95,
              "AA best-variant geomean vs RCCL <32MB (paper: 20% faster)"),
        Claim("ag_pcpy_speedup_large", 1.14, ag_large, 1.05, 1.30,
              "AG pcpy geomean speedup vs RCCL >32MB (paper 14%)"),
        Claim("aa_pcpy_speedup_large", 1.18, aa_large, 1.05, 1.30,
              "AA pcpy geomean speedup vs RCCL >32MB (paper 18%)"),
        Claim("fig1_max_gap", 7.0, fig1_max, 5.0, 8.5,
              "Max AG pcpy slowdown across latency-bound sizes (paper: up to 7x)"),
        Claim("bcst_vs_pcpy", 1.7, g_ratio("all_gather", upto4m, "pcpy", "bcst"), 1.35, 2.05,
              "bcst speedup over pcpy, AG <=4MB (paper 1.7x geomean)"),
        Claim("swap_vs_pcpy", 1.7, g_ratio("all_to_all", upto4m, "pcpy", "swap"), 1.35, 2.05,
              "swap speedup over pcpy, AA <=4MB (paper 1.7x geomean)"),
        Claim("b2b_vs_pcpy_ag", 2.7, g_ratio("all_gather", sub1m, "pcpy", "b2b"), 2.1, 3.3,
              "b2b speedup over pcpy, AG <1MB (paper 2.7x geomean)"),
        Claim("b2b_vs_pcpy_aa", 2.5, g_ratio("all_to_all", sub1m, "pcpy", "b2b"), 2.0, 3.1,
              "b2b speedup over pcpy, AA <1MB (paper 2.5x geomean)"),
        Claim("b2b_vs_bcst", 1.5, g_ratio("all_gather", sub1m, "bcst", "b2b"), 1.25, 1.85,
              "b2b speedup over bcst, AG <1MB (paper 1.5x geomean)"),
        Claim("prelaunch_pcpy", 1.9, g_ratio("all_gather", ALL_SIZES, "pcpy", "prelaunch_pcpy"), 1.55, 2.25,
              "prelaunch speedup on pcpy across sizes (paper 1.9x)"),
        Claim("prelaunch_bcst", 1.5, g_ratio("all_gather", ALL_SIZES, "bcst", "prelaunch_bcst"), 1.25, 1.8,
              "prelaunch speedup on bcst across sizes (paper 1.5x)"),
        Claim("prelaunch_b2b", 1.2, g_ratio("all_gather", ALL_SIZES, "b2b", "prelaunch_b2b"), 1.08, 1.45,
              "prelaunch speedup on b2b across sizes (paper 1.2x)"),
        Claim("noncopy_fraction_4kb", 0.60, b4k.noncopy_fraction, 0.45, 0.75,
              "Non-copy phases of a 4KB DMA copy (paper: up to ~60%)"),
        Claim("noncopy_fraction_2mb", 0.15, b2m.noncopy_fraction, 0.03, 0.20,
              "Non-copy phases of a >1MB copy (paper: <20%)"),
        Claim("power_saving_bw_bound", 0.32, power_saving_bw, 0.20, 0.45,
              "DMA AG power saving vs RCCL at >=64MB (paper ~32%)"),
    ]
    claims += optimized_stream_claims(topo)
    claims += optimized_power_claims(topo)
    claims += pipelined_stream_claims()
    claims += reduce_stream_claims()
    claims += hierarchical_stream_claims()
    claims += fused_overlap_claims()
    return claims


#: Mid-size band of the pipelined-ring claims (DESIGN.md §9): large enough
#: that the rings' per-step stalls are shard-time-scale (pipelining has
#: something to overlap), small enough that the wire floor has not yet
#: crushed every stream onto the same bandwidth-bound latency.
PIPE_MID_SIZES = [1 * MB, 2 * MB, 4 * MB, 8 * MB, 16 * MB, 32 * MB]

#: Chunk-count sweep of the per-chunk-signaling claim: pipeline depths up to
#: the sweep ceiling ``collectives.PIPE_DEPTH`` (= 4), plus one deeper point
#: that must still beat final-chunk-only signaling even though per-chunk
#: packet/issue costs have passed the optimum (DESIGN.md §9.1).
PIPE_DEPTH_SWEEP = (1, 2, 4, 8)


def pipe_vs_final_chunk_ratio(topo: Topology, size: int, depth: int,
                              variant: str = "pipe_b2b",
                              collective: str = "all_gather") -> float:
    """Latency ratio of final-chunk-only over per-chunk signaling for one
    pipelined schedule shape (DESIGN.md §9.1).  Both arms build the *same*
    queues/chunks; only the wait/signal granularity differs — >1 means
    per-chunk signaling wins.  Depth 1 is structurally ≈1 (one chunk, one
    signal either way)."""
    builder = (C.allgather_schedule if collective == "all_gather"
               else C.alltoall_schedule)
    per_chunk = simulate(builder(topo, size, variant, pipe_depth=depth), topo)
    final_only = simulate(builder(topo, size, variant, pipe_depth=depth,
                                  per_chunk_signaling=False), topo)
    return final_only.latency / per_chunk.latency


def pipelined_stream_claims(
    topo: Topology | None = None,
    collectives: tuple[str, ...] = ("all_gather", "all_to_all"),
) -> list[Claim]:
    """Claim bands for the pipelined ring collectives (DESIGN.md §9).

    Pinned on the TPU v5e torus (16 devices) by default — the neighbor-link
    topology where ring renderings are the dispatch winners, so pipelining
    them moves the end-to-end policy (on the fully-connected MI300X the
    direct variants own the bandwidth-bound range and the ring family is
    only reachable by explicit request).  Three bands:

    * ``pipe_chunk_signaling_gain`` — per-chunk vs final-chunk-only
      signaling of the same ``pipe_b2b`` schedule at the sweep-ceiling
      depth (4 chunks/shard), 1MB: the consumer starts forwarding on the
      first arrived chunk instead of the whole shard (the §9 acceptance
      claim; monotonicity across ``PIPE_DEPTH_SWEEP`` is asserted in
      ``tests/test_sim.py``).
    * ``pipe_midsize_gain`` — best ``pipe_`` stream vs the best
      non-pipelined stream over the *full* candidate set (baseline,
      ``prelaunch_``, ``opt_``) across the mid-size band: pipelining beats
      both the baseline and the §7-optimized streams there (the winner is
      ``opt_prelaunch_pipe_bidir_ring`` — per-chunk signaling composes
      with batching, fusion and prelaunch).
    * ``pipe_aa_parity`` — rotation all-to-all gains almost nothing from
      per-chunk signaling (§9.3: the forwarded payload is the *tail* of the
      previous round's arrivals, so chunk dependencies degenerate toward
      final-chunk waits); the band documents parity rather than a win.
    """
    topo = topo or tpu_v5e_pod(16)

    claims: list[Claim] = []
    if "all_gather" in collectives:
        nonpipe = candidate_variants(topo, "all_gather", allow_optimized=True)
        pipe = pipelined_variants(topo, "all_gather")
        midsize = geomean(
            min(variant_latency(topo, "all_gather", s, v) for v in nonpipe)
            / min(variant_latency(topo, "all_gather", s, v) for v in pipe)
            for s in PIPE_MID_SIZES)
        chunk_gain = pipe_vs_final_chunk_ratio(topo, 1 * MB, depth=4)
        claims += [
            Claim("pipe_chunk_signaling_gain", 1.4, chunk_gain, 1.15, 1.7,
                  "pipe_b2b AG per-chunk vs final-chunk-only signaling, depth 4 "
                  "@1MB, TPU torus (arXiv:2512.10236 direction)"),
            Claim("pipe_midsize_gain", 1.08, midsize, 1.03, 1.25,
                  "best pipe_ stream over best baseline/opt_ stream, AG 1-32MB "
                  "geomean, TPU torus (DESIGN.md §9)"),
        ]
    if "all_to_all" in collectives:
        aa_parity = geomean(
            variant_latency(topo, "all_to_all", s, "ring")
            / variant_latency(topo, "all_to_all", s, "pipe_b2b")
            for s in PIPE_MID_SIZES)
        claims += [
            Claim("pipe_aa_parity", 1.01, aa_parity, 0.97, 1.08,
                  "rotation AA ring over pipe_b2b, 1-32MB geomean — per-chunk "
                  "signaling is ~parity for rotation all-to-all (§9.3)"),
        ]
    return claims


def rs_pipe_vs_final_chunk_ratio(topo: Topology, size: int, depth: int,
                                 variant: str = "pipe_bidir_ring_rs") -> float:
    """Latency ratio of final-chunk-only over per-chunk signaling for one
    pipelined reduce-scatter shape (DESIGN.md §10).  Both arms build the
    SAME queues, chunks and reductions — only the wait/signal granularity
    differs — so >1 means reducing each chunk as it lands wins.  Depth 1
    is structurally ≈1."""
    per_chunk = simulate(
        C.reduce_scatter_schedule(topo, size, variant, pipe_depth=depth), topo)
    final_only = simulate(
        C.reduce_scatter_schedule(topo, size, variant, pipe_depth=depth,
                                  per_chunk_signaling=False), topo)
    return final_only.latency / per_chunk.latency


def allreduce_decomposition_ratio(topo: Topology, size: int,
                                  variant: str = "pipe_bidir_ring_rs") -> float:
    """Sequential RS-then-AG latency over the composed all-reduce
    (DESIGN.md §10): the gather phase of the composed schedule is armed
    ahead of time and chained chunk-by-chunk off the terminal reductions,
    so the ratio is >= 1 — the decomposition never pays for the fusion."""
    ag_variant = C.AR_AG_VARIANT[variant]
    ar = simulate(C.allreduce_schedule(topo, size, variant), topo)
    rs = simulate(C.reduce_scatter_schedule(topo, size, variant), topo)
    ag = simulate(C.allgather_schedule(topo, size, ag_variant), topo)
    return (rs.latency + ag.latency) / ar.latency


def reduce_stream_claims(
    mi300x: Topology | None = None,
    tpu: Topology | None = None,
) -> list[Claim]:
    """Claim bands for the reduce collectives (DESIGN.md §10).

    * ``rs_pipe_chunk_signaling_gain`` — per-chunk vs final-chunk-only
      signaling of the same ``pipe_bidir_ring_rs`` schedule at the
      sweep-ceiling depth (4 chunks/shard), 1MB on the TPU torus: the
      consumer reduces (and forwards) chunk *i* the moment it lands
      instead of waiting for the whole partial — the §10 acceptance claim
      (>1 at >= 2 chunks is property-tested across the mid band).
    * ``allreduce_decomposition`` / ``allreduce_decomposition_mi300x`` —
      sequential RS-then-AG over the composed all-reduce, geomean across
      the mid-size band on BOTH modeled platforms: composing the phases
      (armed gather chained per-chunk off the terminal reductions) is
      never slower than running them back to back, with the gain coming
      from the gather phase's host work and fill leaving the critical
      path.
    """
    mi300x = mi300x or mi300x_platform()
    tpu = tpu or tpu_v5e_pod(16)
    chunk_gain = rs_pipe_vs_final_chunk_ratio(tpu, 1 * MB, depth=4)
    decomp_tpu = geomean(allreduce_decomposition_ratio(tpu, s)
                         for s in PIPE_MID_SIZES)
    decomp_mi = geomean(allreduce_decomposition_ratio(mi300x, s)
                        for s in PIPE_MID_SIZES)
    return [
        Claim("rs_pipe_chunk_signaling_gain", 1.45, chunk_gain, 1.15, 1.75,
              "pipe_bidir_ring_rs per-chunk vs final-chunk-only signaling, "
              "depth 4 @1MB, TPU torus (DESIGN.md §10, arXiv:2512.10236)"),
        Claim("allreduce_decomposition", 1.10, decomp_tpu, 1.0, 1.35,
              "sequential RS+AG over composed all-reduce, "
              "pipe_bidir_ring_rs 1-32MB geomean, TPU torus (§10)"),
        Claim("allreduce_decomposition_mi300x", 1.25, decomp_mi, 1.0, 1.55,
              "sequential RS+AG over composed all-reduce, "
              "pipe_bidir_ring_rs 1-32MB geomean, MI300X (§10)"),
    ]


#: Bandwidth-bound band of the fused-overlap claims (DESIGN.md §15): the
#: GEMM tile stream and the collective pipeline are both deep enough that
#: the steady-state overlap (not the fill/drain edges) sets the ratio.
FUSED_BW_SIZES = [64 * MB, 256 * MB, 1024 * MB]


def fused_overlap_gain(topo: Topology, collective: str, size: int,
                       variant: str) -> float:
    """Sequential GEMM-then-collective over the fused schedule.

    The ``seq`` arm is the control: the *identical* command stream with
    every gate coarsened to the final tile / final arrival (same host
    control cost, only the gating grain differs — the per-chunk idiom of
    §9/§10 applied to the compute boundary), so the ratio isolates what
    fine-grained tile/chunk signaling buys.
    """
    return (variant_latency(topo, collective, size, "seq")
            / variant_latency(topo, collective, size, variant))


def fused_exposed_comm_fraction(topo: Topology, size: int,
                                variant: str = "fused_engine_d4") -> float:
    """Fraction of the collective's standalone time still exposed after
    fusing, ``1 - (t_seq - t_fused) / t_collective_alone``.

    The sequential arm exposes the whole collective (fraction 1.0 by
    construction); the fused arm hides all but the fill/drain edges and
    whatever the CU timeline cannot absorb.  The standalone collective is
    the matching unfused pipeline (``pipe_ring_rs``) so numerator and
    denominator share the chunk/depth structure.
    """
    seq = variant_latency(topo, "fused_gemm_rs", size, "seq")
    fused = variant_latency(topo, "fused_gemm_rs", size, variant)
    alone = variant_latency(topo, "reduce_scatter", size, "pipe_ring_rs")
    return 1.0 - (seq - fused) / alone


def fused_overlap_claims(
    mi300x: Topology | None = None,
    tpu: Topology | None = None,
) -> list[Claim]:
    """Claim bands for fused compute-collective overlap (DESIGN.md §15).

    No direct paper counterpart — DMA-Latte measures standalone
    collectives — so the paper_value column carries the model's design
    point and the bands are empirical envelopes around the calibrated
    simulator (the fused-never-slower floor itself is property-tested
    across the whole swept grid in tests/test_fused.py).

    * ``fused_rs_overlap_gain`` / ``fused_ag_overlap_gain`` — sequential
      GEMM-then-collective over the fused pipeline at bandwidth-bound
      sizes on MI300X: with GEMM_FLOPS_PER_BYTE arithmetic intensity the
      tile stream is compute-bound, so nearly the whole collective hides
      under it (``_tpu`` twins on the v5e torus, where the slower MXU
      stream leaves less slack and the gain is thinner).
    * ``fused_exposed_comm_fraction`` — what is left of the standalone
      reduce-scatter time after fusing, at 256MB on MI300X.
    * ``fused_reduce_placement_cu_small`` — at latency-bound sizes the
      CU-side reduction wins: it skips the per-chunk descriptor dispatch
      (``reduce_setup``) while the CU timeline has slack, à la
      arXiv:2512.10236's fused-epilogue reductions.
    * ``fused_reduce_placement_engine_large`` — at bandwidth-bound sizes
      the engine-side reduction wins: the GEMM is compute-bound, so
      CU-placed accumulates extend the critical CU path while the SDMA
      engines have slack.
    """
    mi300x = mi300x or mi300x_platform()
    tpu = tpu or tpu_v5e_pod(16)
    gains = {
        (name, coll): geomean(
            fused_overlap_gain(topo, f"fused_{coll}", s, variant)
            for s in FUSED_BW_SIZES)
        for name, topo in (("mi300x", mi300x), ("tpu", tpu))
        for coll, variant in (("gemm_rs", "fused_engine_d4"),
                              ("ag_gemm", "fused_d4"))
    }
    exposed = fused_exposed_comm_fraction(mi300x, 256 * MB)
    cu_small = (variant_latency(mi300x, "fused_gemm_rs", 16 * KB,
                                "fused_engine_d4")
                / variant_latency(mi300x, "fused_gemm_rs", 16 * KB,
                                  "fused_cu_d4"))
    eng_large = (variant_latency(mi300x, "fused_gemm_rs", 256 * MB,
                                 "fused_cu_d4")
                 / variant_latency(mi300x, "fused_gemm_rs", 256 * MB,
                                   "fused_engine_d4"))
    return [
        Claim("fused_rs_overlap_gain", 1.55, gains[("mi300x", "gemm_rs")],
              1.30, 1.80, "seq GEMM-then-RS over fused_engine_d4, 64MB-1GB "
              "geomean, MI300X (DESIGN.md §15)"),
        Claim("fused_ag_overlap_gain", 1.55, gains[("mi300x", "ag_gemm")],
              1.30, 1.80, "seq AG-then-GEMM over fused_d4, 64MB-1GB "
              "geomean, MI300X (§15)"),
        Claim("fused_rs_overlap_gain_tpu", 1.12, gains[("tpu", "gemm_rs")],
              1.05, 1.25, "seq GEMM-then-RS over fused_engine_d4, 64MB-1GB "
              "geomean, TPU torus (§15)"),
        Claim("fused_ag_overlap_gain_tpu", 1.12, gains[("tpu", "ag_gemm")],
              1.05, 1.25, "seq AG-then-GEMM over fused_d4, 64MB-1GB "
              "geomean, TPU torus (§15)"),
        Claim("fused_exposed_comm_fraction", 0.05, exposed, 0.0, 0.12,
              "RS time still exposed after fusing @256MB, MI300X (§15)"),
        Claim("fused_reduce_placement_cu_small", 1.04, cu_small,
              1.005, 1.15, "engine- over CU-placed reduce @16KB, MI300X: "
              "CU epilogue skips the per-chunk descriptor dispatch (§15, "
              "arXiv:2512.10236)"),
        Claim("fused_reduce_placement_engine_large", 1.45, eng_large,
              1.20, 1.70, "CU- over engine-placed reduce @256MB, MI300X: "
              "compute-bound tile stream has no slack for accumulates (§15)"),
    ]


#: Bandwidth-bound band of the hierarchical claims (DESIGN.md §11): large
#: enough that per-message NIC latency is amortized and the tiers' wire
#: times dominate — where the intra/inter decomposition pays.
HIER_BW_SIZES = [16 * MB, 32 * MB, 64 * MB, 128 * MB]


def hierarchical_stream_claims(
    cluster: Topology | None = None,
    multislice: Topology | None = None,
) -> list[Claim]:
    """Claim bands for the hierarchical multi-node collectives (DESIGN.md
    §11).  No paper counterpart — DMA-Latte measures a single node — so the
    paper_value column carries the model's own design point and the bands
    are honest empirical envelopes around the calibrated simulator.

    * ``hier_ag_nic_gain`` — hierarchical AG over the *flat* ring AG on a
      2-node MI300X RDMA cluster, bandwidth-bound geomean: the flat ring
      drags every shard across the node boundary ``P`` extra times (its
      NIC bytes scale with total device count), the hier decomposition
      crosses once per remote node.  Deliberately vs the ring rendering:
      the direct fan-out (``pcpy``) still wins on a *2-node* fully
      connected cluster in the model — 7 parallel intra links against the
      ring tier's one — and the sweep docs say so; its NIC bytes scale
      with ``(M-1)·P·shard`` though, so the hier family is what survives
      at slice counts where fan-out saturates the NIC.
    * ``hier_pipe_overlap_gain`` — ``hier_pipe`` over ``hier_ring`` AG on
      a 64-device TPU multislice: gating each intra sub-round on its own
      block's DCN arrival overlaps the local gather with the inter tier
      instead of serializing behind it (§11.2).
    """
    cluster = cluster or mi300x_cluster(2)
    multislice = multislice or tpu_v5e_multislice(64)
    nic_gain = geomean(
        variant_latency(cluster, "all_gather", s, "ring")
        / variant_latency(cluster, "all_gather", s, "hier_ring")
        for s in HIER_BW_SIZES)
    pipe_gain = geomean(
        variant_latency(multislice, "all_gather", s, "hier_ring")
        / variant_latency(multislice, "all_gather", s, "hier_pipe")
        for s in HIER_BW_SIZES)
    return [
        Claim("hier_ag_nic_gain", 1.26, nic_gain, 1.10, 1.45,
              "hier_ring over flat ring AG, 16-128MB geomean, 2-node MI300X "
              "RDMA cluster (DESIGN.md §11; no paper counterpart)"),
        Claim("hier_pipe_overlap_gain", 1.15, pipe_gain, 1.05, 1.30,
              "hier_pipe over hier_ring AG, 16-128MB geomean, 64-device TPU "
              "multislice (DESIGN.md §11.2)"),
    ]


def optimized_power_claims(topo: Topology | None = None) -> list[Claim]:
    """Power saving of the optimized command streams (DESIGN.md §8.4).

    The paper reports a 3-10% *additional* GPU power saving for the §7
    streams on top of the DMA collectives' compute-side savings: batched
    submission collapses host scheduling wakeups and fused write+signal
    skips the engine's atomic round-trip.  Priced by
    :func:`repro_torch.core.dma.power.dma_collective_power` from the simulator's
    event counts, compared baseline-vs-optimized on the same schedule family
    over the latency-bound range (where per-command overhead dominates).
    """
    topo = topo or mi300x_platform()
    # Latency-bound range (Fig. 7: non-copy phases dominate below ~1MB);
    # above it the optimized stream finishes sooner, which *raises* its
    # average power draw even as energy falls, washing out the comparison.
    sizes = [s for s in SMALL_SIZES if 16 * KB <= s <= 1 * MB]
    savings = []
    for s in sizes:
        base = simulate(C.allgather_schedule(topo, s, "pcpy"), topo)
        opt = simulate(C.allgather_schedule(topo, s, "opt_pcpy"), topo)
        p_base = dma_collective_power(topo, s, base).total
        p_opt = dma_collective_power(topo, s, opt).total
        savings.append(1 - p_opt / p_base)
    avg = sum(savings) / len(savings)
    return [
        Claim("opt_power_saving_small", 0.065, avg, 0.03, 0.10,
              "Additional AG power saving of opt_ streams, 16KB-1MB "
              "(paper: 3-10%)"),
    ]


def optimized_stream_claims(
    topo: Topology | None = None,
    collectives: tuple[str, ...] = ("all_gather", "all_to_all"),
) -> list[Claim]:
    """Claim bands for the optimized command streams (DESIGN.md §7).

    The paper's optimized implementations (batched scheduling, SDMA queue
    parallelism, fused write+signal) close the small-size gap to ~30% slower
    (all-gather) / ~20% faster (all-to-all) than RCCL and add ~7% at
    bandwidth-bound sizes.  With chunked command streams (DESIGN.md §8.1)
    the model lands on the large-size gain too: a GB-scale copy is hundreds
    of bounded-size sDMA commands whose per-chunk packet creation §7.1
    batching amortizes, so the large-size band is pinned at the paper's
    value (lower bound 1.05) rather than the pre-chunking conservative ~4%.

    ``collectives`` restricts which sweeps run — benchmarks that report a
    single collective pass just that one to skip the other's simulations.
    """
    topo = topo or mi300x_platform()

    def opt_small(coll):
        return geomean(
            best_optimized_latency(topo, coll, s)[1] / rccl_latency(topo, coll, s)
            for s in SMALL_SIZES)

    def opt_large_gain(coll):
        return geomean(
            dma_latency(topo, coll, s, "pcpy") / dma_latency(topo, coll, s, "opt_pcpy")
            for s in LARGE_SIZES)

    claims: list[Claim] = []
    if "all_gather" in collectives:
        claims += [
            Claim("opt_ag_small", 1.30, opt_small("all_gather"), 1.10, 1.55,
                  "Optimized-stream AG geomean vs RCCL <32MB (paper: 30% slower)"),
            Claim("opt_ag_large_gain", 1.07, opt_large_gain("all_gather"), 1.05, 1.15,
                  "opt_pcpy over pcpy, AG >=64MB (paper: ~7% large-size gain)"),
        ]
    if "all_to_all" in collectives:
        claims += [
            Claim("opt_aa_small", 0.83, opt_small("all_to_all"), 0.70, 0.95,
                  "Optimized-stream AA geomean vs RCCL <32MB (paper: 20% faster)"),
            Claim("opt_aa_large_gain", 1.07, opt_large_gain("all_to_all"), 1.05, 1.15,
                  "opt_pcpy over pcpy, AA >=64MB (paper: ~7% large-size gain)"),
        ]
    return claims


# ----------------------------------------------------------------------- #
# Concurrent-traffic serving claims (DESIGN.md §12)                       #
# ----------------------------------------------------------------------- #

#: Canonical offered-load sweep (requests/s) of ``fig_serving_load``: the
#: low end is unloaded (every TTFT at the Fig. 16 number), the high end is
#: past the host-link saturation knee of the canonical workload below.
SERVING_RATES = (250.0, 500.0, 1000.0, 1500.0, 2000.0, 3000.0)


def serving_workload(rate: float):
    """The canonical contention workload: 100 bursty requests (MMPP,
    burst_factor 10), 4096-token prompts (±25%), 4 output tokens, seed 7 —
    fetch-dominated serving where KV-fetch DMA traffic, not decode compute,
    is the bottleneck (the regime the paper's offload targets)."""
    from repro_torch.serve.workload import synthetic_workload

    return synthetic_workload(100, rate, seed=7, kind="bursty",
                              prompt_tokens=4096, output_tokens=4,
                              burst_factor=10.0, p_enter=0.4, p_exit=0.1)


def serving_report(rate: float, admission: str):
    """One point of the serving sweep: the canonical workload through the
    §12 continuous-batching loop under ``admission`` ("fifo"/"defer")."""
    from repro_torch.serve.engine import ServingConfig, ServingSimulator

    sim = ServingSimulator(ServingConfig(admission=admission))
    return sim.run(serving_workload(rate))


def serving_load_claims(reports=None) -> list[Claim]:
    """Claim bands for serving under concurrent traffic (DESIGN.md §12).

    * ``serving_ttft_knee`` — p99 TTFT under FIFO admission degrades ~8.5x
      between the unloaded low end and the post-knee high end of the
      canonical sweep: composed-schedule contention (host-link queueing of
      concurrent KV fetches + batch-slot head-of-line blocking) produces a
      saturation knee, not graceful linear growth.
    * ``serving_admission_gain`` — the contention-aware admission policy
      (defer a launch when the target host link's fetch queue is at depth)
      recovers ~1.75x goodput over FIFO past the knee by keeping bursts on
      a hot device from pinning batch slots and starving cool links, while
      staying neutral at low load.

    ``reports`` optionally supplies precomputed ``{(rate, admission):
    ServingReport}`` points (the benchmark passes its sweep) so the three
    endpoint runs are not simulated twice.  Values are model-derived (no
    paper counterpart figure — the paper measures one request at a time);
    the bands pin today's behavior against regressions.
    """
    reports = dict(reports or {})
    lo_rate, hi_rate = SERVING_RATES[0], SERVING_RATES[-1]
    for point in ((lo_rate, "fifo"), (hi_rate, "fifo"), (hi_rate, "defer")):
        if point not in reports:
            reports[point] = serving_report(*point)
    knee = (reports[(hi_rate, "fifo")].ttft_p99
            / reports[(lo_rate, "fifo")].ttft_p99)
    gain = (reports[(hi_rate, "defer")].goodput
            / reports[(hi_rate, "fifo")].goodput)
    return [
        Claim("serving_ttft_knee", 8.5, knee, 4.0, 15.0,
              "p99 TTFT degradation, FIFO, 3000 vs 250 req/s (model-derived "
              "saturation knee under composed contention)"),
        Claim("serving_admission_gain", 1.75, gain, 1.2, 2.4,
              "goodput of defer-admission over FIFO at 3000 req/s "
              "(model-derived contention-aware admission win)"),
    ]


# ----------------------------------------------------------------------- #
# Fault-injection & degraded-mode claims (DESIGN.md §13)                  #
# ----------------------------------------------------------------------- #

#: Canonical straggler scenario of the fault claims: device 0's engines
#: stream 4x slower (DESIGN.md §13).
FAULT_SLOWDOWN = 4.0

#: Size band of the graceful-degradation claim — bandwidth-bound pipelined
#: shapes where a straggler's slowdown lands on shard-time-scale stalls.
FAULT_SIZES = (8 * MB, 16 * MB, 32 * MB)

#: Pipeline depth of the fault claims (the sweep ceiling, DESIGN.md §9).
FAULT_DEPTH = 4

#: Drop rate of the bounded-retry-overhead claim: small enough that the
#: watchdog recovers every loss within ``max_attempts``, large enough that
#: an 8MB depth-4 run sees retries at all.
FAULT_DROP_RATE = 0.005


def fault_degradation_arms(topo: Topology | None = None, *,
                           slowdown: float = FAULT_SLOWDOWN,
                           sizes: tuple[int, ...] = FAULT_SIZES,
                           depth: int = FAULT_DEPTH) -> dict[int, dict[str, float]]:
    """Per-size latencies of the graceful-degradation comparison (§13):
    the SAME ``pipe_b2b`` AG queues under per-chunk vs final-chunk-only
    signaling, each run clean and under the canonical straggler.  Returns
    ``{size: {"pipe_clean", "pipe_faulted", "fco_clean", "fco_faulted"}}``
    — the benchmark passes this to :func:`fault_degradation_claims` so the
    eight simulations per size run once."""
    from .faults import straggler_plan

    topo = topo or tpu_v5e_pod(16)
    plan = straggler_plan(0, slowdown)
    arms: dict[int, dict[str, float]] = {}
    for size in sizes:
        per_chunk = C.allgather_schedule(topo, size, "pipe_b2b",
                                         pipe_depth=depth)
        final_only = C.allgather_schedule(topo, size, "pipe_b2b",
                                          pipe_depth=depth,
                                          per_chunk_signaling=False)
        arms[size] = {
            "pipe_clean": simulate(per_chunk, topo).latency,
            "pipe_faulted": simulate(per_chunk, topo, faults=plan).latency,
            "fco_clean": simulate(final_only, topo).latency,
            "fco_faulted": simulate(final_only, topo, faults=plan).latency,
        }
    return arms


def fault_degradation_claims(topo: Topology | None = None,
                             arms: dict | None = None) -> list[Claim]:
    """Claim bands for graceful degradation under a straggler (§13).

    * ``fault_pipe_grace`` — relative degradation of final-chunk-only over
      per-chunk signaling: ``(fco_faulted/fco_clean) /
      (pipe_faulted/pipe_clean)``, geomean over the size band.  >1 means
      per-chunk signaling degrades more gracefully — downstream devices
      keep consuming the straggler's early chunks while it grinds through
      the rest, where final-chunk-only waiters stall for the whole slowed
      shard.
    * ``fault_pipe_gap`` — the absolute faulted-latency gap
      ``fco_faulted / pipe_faulted``: under the straggler the per-chunk
      arm's win widens beyond its clean-run advantage.

    No paper counterpart (the paper measures healthy hardware); the bands
    pin the model's §13 behavior against regressions.
    """
    if arms is None:
        arms = fault_degradation_arms(topo)
    grace = geomean((a["fco_faulted"] / a["fco_clean"])
                    / (a["pipe_faulted"] / a["pipe_clean"])
                    for a in arms.values())
    gap = geomean(a["fco_faulted"] / a["pipe_faulted"] for a in arms.values())
    return [
        Claim("fault_pipe_grace", 1.03, grace, 1.005, 1.08,
              "relative straggler degradation, final-chunk-only over "
              "per-chunk signaling, pipe_b2b AG 8-32MB depth 4, TPU torus "
              "(DESIGN.md §13 — per-chunk degrades more gracefully)"),
        Claim("fault_pipe_gap", 1.08, gap, 1.02, 1.18,
              "faulted-latency gap, final-chunk-only over per-chunk "
              "signaling under a 4x straggler, pipe_b2b AG 8-32MB depth 4"),
    ]


def fault_retry_claims(topo: Topology | None = None, *,
                       size: int = 8 * MB,
                       drop_rate: float = FAULT_DROP_RATE,
                       seed: int = 0) -> list[Claim]:
    """Claim bands for watchdog/retry recovery (§13.2).

    * ``fault_retry_overhead`` — latency of an 8MB depth-4 ``pipe_b2b`` AG
      under a small random signal-drop rate over its clean run: every
      dropped doorbell costs roughly one watchdog expiry plus a re-issued
      command, so at ``drop_rate`` 0.5% the overhead is bounded well under
      the ~2x a 2% rate produces — losses are recovered, not amplified.
    * ``fault_retry_recovery`` — fraction of dropped raises the watchdog
      recovered (re-raise survived its own draw) within ``max_attempts``;
      at small drop rates this is 1.0 (re-drawing the same tag at the next
      attempt index decorrelates the loss).
    """
    from .faults import FaultPlan

    topo = topo or tpu_v5e_pod(16)
    sched = C.allgather_schedule(topo, size, "pipe_b2b",
                                 pipe_depth=FAULT_DEPTH)
    clean = simulate(sched, topo)
    faulted = simulate(sched, topo,
                       faults=FaultPlan(drop_rate=drop_rate, seed=seed))
    rep = faulted.fault_report
    overhead = faulted.latency / clean.latency
    recovery = rep.recovered / len(rep.dropped) if rep.dropped else 1.0
    return [
        Claim("fault_retry_overhead", 1.22, overhead, 1.0, 1.6,
              "latency overhead of 0.5% signal-drop rate on pipe_b2b AG "
              "8MB depth 4, TPU torus (DESIGN.md §13.2 — bounded retry "
              "cost at small drop rates)"),
        Claim("fault_retry_recovery", 1.0, recovery, 0.99, 1.0,
              "fraction of dropped signals recovered by the watchdog "
              "within max_attempts at 0.5% drop rate"),
    ]


#: Offered load of the serving fault claims: the unloaded low end of
#: ``SERVING_RATES``, so tail movement is attributable to the injected
#: fault rather than to the §12 saturation knee.
SERVING_FAULT_RATE = SERVING_RATES[0]


def serving_outage_plan(rate: float = SERVING_FAULT_RATE):
    """The canonical transient-outage scenario of the §13.4 serving claims:
    device 0's h2d host link derated to 5% of nominal for the first quarter
    of the workload's arrival span (window ends computed from the workload,
    not hardcoded — the span scales with ``rate``)."""
    from .faults import FaultPlan, LinkDerate

    reqs = serving_workload(rate)
    span = max(r.arrival for r in reqs)
    return FaultPlan(link_derates=(
        LinkDerate("hostlink:0:h2d", 0.05, 0.0, 0.25 * span),))


def serving_fault_report(rate: float, admission: str, faults=None):
    """One point of the degraded-mode serving comparison: the canonical
    workload through the §12 loop under ``admission``, with ``faults``
    threaded into every composed round (DESIGN.md §13.4)."""
    from repro_torch.serve.engine import ServingConfig, ServingSimulator

    sim = ServingSimulator(ServingConfig(admission=admission), faults=faults)
    return sim.run(serving_workload(rate))


def serving_fault_claims(reports=None) -> list[Claim]:
    """Claim bands for degraded-mode serving (DESIGN.md §13.4).

    * ``serving_fault_tail`` — a permanent 4x straggler on device 0
      inflates unloaded-fleet p99 TTFT modestly (~1.2x): requests homed on
      the straggler fetch slower, everyone else is untouched.  The defer
      policy deliberately does NOT steer around it (KV homes are pinned —
      deferring would starve those requests), so FIFO is the right arm.
    * ``serving_outage_defer_gain`` — under a transient host-link outage
      (5% bandwidth for the first quarter of the trace), fault-aware defer
      admission pushes launches past the window instead of fetching at 5%
      rate, recovering ~1.5x p99 TTFT over FIFO.

    ``reports`` optionally supplies precomputed ``{arm: ServingReport}``
    points keyed by ``("clean"|"straggler"|"outage", admission)`` — the
    benchmark passes its table so the four runs are not simulated twice.
    Model-derived; no paper counterpart.
    """
    from .faults import straggler_plan

    rate = SERVING_FAULT_RATE
    reports = dict(reports or {})
    plans = {"clean": None,
             "straggler": straggler_plan(0, FAULT_SLOWDOWN),
             "outage": serving_outage_plan(rate)}
    for arm in (("clean", "fifo"), ("straggler", "fifo"),
                ("outage", "fifo"), ("outage", "defer")):
        if arm not in reports:
            reports[arm] = serving_fault_report(rate, arm[1], plans[arm[0]])
    tail = (reports[("straggler", "fifo")].ttft_p99
            / reports[("clean", "fifo")].ttft_p99)
    defer_gain = (reports[("outage", "fifo")].ttft_p99
                  / reports[("outage", "defer")].ttft_p99)
    return [
        Claim("serving_fault_tail", 1.18, tail, 1.05, 1.6,
              "p99 TTFT inflation of a 4x straggler on one device, FIFO "
              "admission, 250 req/s (DESIGN.md §13.4)"),
        Claim("serving_outage_defer_gain", 1.49, defer_gain, 1.15, 2.2,
              "p99 TTFT gain of fault-aware defer over FIFO under a "
              "transient host-link outage, 250 req/s (DESIGN.md §13.4)"),
    ]
