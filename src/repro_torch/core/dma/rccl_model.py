"""CU-driven (RCCL) collective latency + kernel-copy model — the baseline.

The paper compares DMA collectives against RCCL (tuned: MSCCL/MSCCL++ and
hipGraphs enabled).  We model RCCL latency as a launch floor plus wire time
at a size-dependent protocol efficiency (LL -> LL128 -> Simple ramp), capped
below the DMA link efficiency because CU protocols carry per-packet metadata
(flags/sequence numbers) — which is exactly why the paper's pcpy beats RCCL
by 14–18% at bandwidth-bound sizes (§5.2.4).
"""
from __future__ import annotations

from .topology import RcclCalibration, Topology


def rccl_efficiency(shard: float, calib: RcclCalibration) -> float:
    return calib.wire_efficiency_max * shard / (shard + calib.half_size)


def rccl_collective_latency(
    topo: Topology,
    size: int,
    calib: RcclCalibration | None = None,
) -> float:
    """Latency of a CU-based all-gather/all-to-all of total ``size`` bytes.

    Both collectives move (n-1)/n of ``size`` in/out of every device over
    n-1 links simultaneously (fully-connected one-shot algorithm).
    """
    calib = calib or RcclCalibration()
    n = topo.n_devices
    shard = size / n
    wire_bytes = shard * (n - 1)
    eff = max(rccl_efficiency(shard, calib), 1e-3)
    wire = wire_bytes / (topo.aggregate_bw * eff)
    return max(calib.min_latency, calib.base_launch + wire)


def kernel_copy_latency(
    topo: Topology,
    total_bytes: int,
    *,
    n_launches: int = 1,
    contention_slowdown: float = 1.0,
    calib: RcclCalibration | None = None,
) -> float:
    """CU (load/store kernel) host<->device copy, e.g. kernel-based KV fetch.

    One kernel gathers all dispersed blocks (one workgroup per block), so a
    single launch; wire time over the host link at CU efficiency.  When the
    fetch overlaps model compute, ``contention_slowdown`` models CU/cache
    contention (§2.4 / §5.3.3) — the reason DMA fetch wins on throughput.
    """
    calib = calib or RcclCalibration()
    eff = 0.80
    wire = total_bytes / (topo.host_link_bw * eff)
    return (calib.base_launch * n_launches + wire) * contention_slowdown
