"""GPU power model for collectives (paper §5.2.9, Fig. 15).

Total GPU power = idle + XCD (compute dies) + IOD (cache/links/DMA) + HBM
+ host (command scheduling/sync wakeups).

* CU (RCCL) collectives keep CUs spinning on packet loops -> high XCD power,
  scaled down at latency-bound sizes where CUs are mostly waiting.
* DMA collectives leave CUs idle (paper: ~3.7x less XCD power) and draw IOD
  power per engaged engine, so fewer engines (b2b) -> lower power, and bcst's
  single source read lowers HBM traffic -> additional HBM power savings.
* Optimized command streams (DESIGN.md §7/§8.4) price lower still: batched
  submission collapses host scheduling events (each a CPU-core wakeup,
  ``host_wakeup_j``) and fused write+signal skips the engine's atomic
  signal round-trip over the fabric (``atomic_j``) — the paper's 3-10%
  *additional* power saving at latency-bound sizes.  Both counts come from
  the event simulator (``SimResult.host_events``/``engine_atomics``), so
  ``dma_collective_power`` prices baseline and ``opt_`` schedules from the
  same formula.
"""
from __future__ import annotations

import dataclasses

from .engine import SimResult
from .topology import PowerCalibration, Topology


@dataclasses.dataclass(frozen=True)
class PowerReport:
    xcd: float
    iod: float
    hbm: float
    idle: float
    host: float = 0.0    # command scheduling + sync observation wakeups (§8.4)

    @property
    def total(self) -> float:
        return self.xcd + self.iod + self.hbm + self.idle + self.host


def _utilization(size: int, knee: float = 8e6) -> float:
    """How busy the mover is vs waiting on launch/sync (ramps with size)."""
    return size / (size + knee)


def dma_collective_power(
    topo: Topology,
    size: int,
    sim: SimResult,
    calib: PowerCalibration | None = None,
) -> PowerReport:
    c = calib or PowerCalibration()
    dev = max(sim.per_device, key=lambda d: sim.per_device[d].total)
    engines = sim.engines_used[dev]
    lat = max(sim.latency, 1e-9)
    # HBM traffic: local reads (tracked) + symmetric incoming writes.
    gbps = 2 * sim.hbm_bytes[dev] / lat / 1e9
    u = _utilization(size)
    # Link/SerDes power tracks the ACTUAL wire-busy intervals recorded by the
    # event simulator, not the nominal message size: an idle link waiting on
    # control/sync draws (almost) nothing.
    link_gbps = sim.link_busy_seconds(dev) / lat * topo.link_bw / 1e9
    # Host scheduling/sync wakeups and engine atomic round-trips (§8.4):
    # energy per event over the collective's duration.  Batched submission
    # (§7.1) collapses scheduling events, fused signals (§7.3) drop the
    # atomics — this term is where the optimized streams' 3-10% additional
    # saving comes from; baseline schedules pay one event per command.
    host_w = c.host_wakeup_j * sim.host_events.get(dev, 0) / lat
    atomic_w = c.atomic_j * sim.engine_atomics.get(dev, 0) / lat
    return PowerReport(
        xcd=c.xcd_dma_collective * (0.5 + 0.5 * u),
        iod=c.iod_per_engine * engines + c.link_per_busy_gbps * link_gbps + atomic_w,
        hbm=c.hbm_static + c.hbm_per_gbps * gbps,
        idle=c.idle,
        host=host_w,
    )


def cu_collective_power(
    topo: Topology,
    size: int,
    latency: float,
    calib: PowerCalibration | None = None,
    *,
    collective: str = "all_gather",
) -> PowerReport:
    c = calib or PowerCalibration()
    n = topo.n_devices
    shard = size / n
    # Per-device HBM payload of the CU packet loop, per collective: the
    # gather-style collectives read each outgoing shard once and write each
    # arrival once (2x per delivery — all_to_all moves n-1 *distinct*
    # per-peer shards but the same total bytes, so it prices identically);
    # the reduce collectives additionally read the local accumulator per
    # arrived chunk (2 reads + 1 write = 3x per delivery), and all_reduce
    # composes reduce-scatter + all-gather (3x + 2x).
    deliveries = n - 1
    if collective in ("all_gather", "all_to_all"):
        payload = 2 * shard * deliveries
    elif collective == "reduce_scatter":
        payload = 3 * shard * deliveries
    elif collective == "all_reduce":
        payload = 5 * shard * deliveries
    else:
        raise ValueError(
            f"unknown collective {collective!r} for the CU power model")
    gbps = c.cu_traffic_multiplier * payload / max(latency, 1e-9) / 1e9
    u = _utilization(size)
    xcd = c.xcd_cu_collective * (c.xcd_latency_scale + (1 - c.xcd_latency_scale) * u)
    return PowerReport(
        xcd=xcd,
        iod=c.iod_cu * (0.6 + 0.4 * u),
        hbm=c.hbm_static + c.hbm_per_gbps * gbps,
        idle=c.idle,
        # One kernel launch + one completion poll: the CU path schedules on
        # the GPU, not per-transfer on the host.
        host=2 * c.host_wakeup_j / max(latency, 1e-9),
    )
