"""Platform topology + calibration constants for the DMA engine model.

Two topologies are modeled:

* ``mi300x_platform()`` — the paper's system (§2.2, Fig. 4): 8 AMD Instinct
  MI300X GPUs, fully connected with xGMI links of 64 GB/s per direction
  (128 GB/s bidirectional), 16 sDMA engines per GPU, PCIe Gen5 host links
  (64 GB/s per direction).

* ``tpu_v5e_pod()`` — the lowering target of the rest of this repo: a 2D ICI
  torus with ~50 GB/s links, used to re-derive the size-dispatch thresholds
  for the TPU-native collectives (DESIGN.md §4).

Routing (DESIGN.md §3): a topology exposes ``route(src, dst)`` returning the
directed links a transfer traverses.  The fully-connected MI300X box routes
everything over the single direct xGMI link; the TPU torus routes
dimension-ordered (rows first, then columns) with wraparound, so non-neighbor
transfers are multi-hop and the simulator charges every link on the path plus
a per-hop router latency (``Calibration.hop_latency``).

Inter-node tier (DESIGN.md §11): multi-node topologies (``n_nodes > 1``)
split the device range into equal nodes.  Intra-node routing is unchanged
(per-node torus or fully-connected box); a cross-node transfer traverses the
*sender's NIC* — one serial injection resource per device
(``nic:{src}``) with its own latency (``Calibration.nic_latency``) and
bandwidth (``Calibration.nic_bytes_per_s``), both far worse than the
intra-node DMA links.  The NIC is deliberately sender-side only: a shared
receiver-side resource would put two devices on one timeline and break the
translation invariance the symmetric fast path (§6) relies on.  The
per-hop view the simulator consumes is :meth:`Topology.wire_path`.

* ``tpu_v5e_multislice()`` / ``mi300x_cluster()`` — the multi-node builders:
  N×(4×4 ICI torus) slices over DCN, and N×8-GPU MI300X boxes over RDMA.

Phase constants live in :class:`Calibration` and are fit once (see
``benchmarks/calibration.py``) so that the model reproduces the paper's
measured figures.
"""
from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-phase latency constants (seconds) of a single DMA offload (Fig. 6/7).

    control  : CPU command-packet creation, per command.
    control_batched: marginal packet-creation cost for the 2nd..Nth command of
               one batched submission event (DESIGN.md §7.1): the descriptor
               template, queue pointers and cache lines are already hot, so
               only the per-command payload fields are written.
    doorbell : CPU MMIO doorbell write, per engine (serialized on the CPU).
    doorbell_batched: marginal doorbell cost for the 2nd..Nth hardware queue
               rung within one batched submission event (§7.1) — the MMIO
               writes are posted back-to-back without an intervening
               scheduling round-trip.
    fetch    : engine wake + command fetch from the system-memory queue.
    copy_setup: per data-command decode + address translation on the engine.
    b2b_issue: incremental issue cost of an overlapped back-to-back copy
               (subsequent loads issued before prior stores complete, §4.4).
    sync_engine: engine-side atomic signal update.
    fused_sync: latency of a *fused* write+signal (DESIGN.md §7.3): the
               signal payload rides the final write packet of the transfer,
               so only the fabric's posted-write completion delay remains
               instead of a full engine scheduling round (``sync_engine``).
    sync_obs : CPU-side completion observation, per signal (serialized).
    sync_obs_batched: marginal observation cost for the 2nd..Nth *fused*
               completion of one device (§7.3): fused signals write adjacent
               slots of a contiguous completion record, so the host's drain
               loop sweeps them in one pass instead of polling scattered
               per-queue signal addresses.
    poll_trigger: latency from the triggering memory write until a polling
               engine observes it (prelaunch, §4.5); also the latency for a
               remote engine to observe a tagged semaphore signal (wait).
    hop_latency: per-router forwarding latency charged for every hop beyond
               the first on a multi-hop route (0 on fully-connected fabrics).
    max_chunk_bytes: largest payload one sDMA command can carry
               (DESIGN.md §8.1).  The runtime splits bigger copies into
               bounded-size chunk commands, each paying its own packet
               creation (host) and issue (engine front end); the MI300X
               value is the sDMA linear-copy packet ceiling (22-bit byte
               count, ~4MB).  ``0`` disables chunking.
    reduce_setup: constant per-chunk reduction launch latency (DESIGN.md
               §10): dispatching the accumulate over an arrived chunk on
               the consumer (descriptor + address setup on MI300X, vector
               loop launch on the TPU scalar core).
    reduce_bytes_per_s: consumer-side reduction throughput (DESIGN.md §10).
               The accumulate streams both operands from local HBM and
               writes the partial back, so it runs at roughly a third of
               HBM bandwidth — far above link bandwidth on both platforms,
               which is why per-chunk reductions hide under the wire once
               the pipeline is primed.
    nic_latency: one-way injection latency of a cross-node message through
               the sender's NIC (DESIGN.md §11) — RDMA/DCN software + fabric
               latency, orders of magnitude above the intra-node hop cost.
               Unused on single-node topologies.
    nic_bytes_per_s: per-device NIC injection bandwidth (one direction).
               The MI300X default models a 400G RDMA NIC (~50 GB/s); the TPU
               multislice builder overrides it with a DCN-class value.  The
               NIC serializes a device's cross-node traffic regardless of
               how many intra-node DMA links it owns.
    cu_tile_setup: per-tile launch overhead on the compute-unit timeline
               (DESIGN.md §15): wavefront dispatch + LDS staging for one
               output tile of a fused compute-collective schedule.
    cu_flops : aggregate per-device matrix throughput (FLOP/s) pricing
               ``compute`` commands on the ``cu:{dev}`` timeline
               (DESIGN.md §15).  The MI300X default is the peak bf16
               roofline; the v5e builder overrides it with the TPU value.
    """

    # Values fit by benchmarks/calibration.py so the model lands on the
    # paper's measured claims.
    control: float = 0.5987e-6
    control_batched: float = 0.1497e-6
    doorbell: float = 2.436e-6
    doorbell_batched: float = 0.406e-6
    fetch: float = 0.5014e-6
    copy_setup: float = 3.146e-6
    b2b_issue: float = 0.2919e-6
    sync_engine: float = 0.9165e-6
    fused_sync: float = 0.1833e-6
    sync_obs: float = 1.596e-6
    sync_obs_batched: float = 1.041e-6
    poll_trigger: float = 0.5838e-6
    hop_latency: float = 0.0
    max_chunk_bytes: int = 4 * 1024 * 1024
    # Per-chunk reduction cost on the consumer (DESIGN.md §10): MI300X
    # accumulates at ~1/3 of HBM3 bandwidth (read chunk + read/write acc).
    reduce_setup: float = 0.45e-6
    reduce_bytes_per_s: float = 1.6e12
    # Inter-node NIC tier (DESIGN.md §11): 400G RDMA-class defaults; only
    # consulted when ``Topology.n_nodes > 1``.
    nic_latency: float = 2.0e-6
    nic_bytes_per_s: float = 50e9
    # Effective per-engine streaming bandwidth (one engine saturates roughly
    # one xGMI link; pcpy engages one engine per link).
    engine_bw: float = 64e9
    # DMA transfers carry less metadata than CU-based protocols -> higher
    # achievable link efficiency (paper §5.2.4: pcpy beats RCCL by 14-18%
    # at bandwidth-bound sizes).
    dma_link_efficiency: float = 0.9616
    # Compute-unit timeline (DESIGN.md §15): one GEMM tile occupies the
    # ``cu:{dev}`` resource for ``cu_tile_setup + flops / cu_flops``.
    # MI300X peak bf16 matrix throughput; tile setup ~= a persistent
    # kernel's workgroup grabbing the next tile off its work queue (NOT a
    # kernel launch — the fused builders stream tiles from one kernel).
    cu_tile_setup: float = 0.2e-6
    cu_flops: float = 1.3e15

    def __post_init__(self) -> None:
        # A mistyped calibration (negative latency, zero bandwidth) times as
        # silent nonsense — instant transfers, negative phases — so reject it
        # at construction.  Latency constants may be 0 (hop_latency is, on
        # fully-connected fabrics); divisors must be strictly positive.
        for f in ("control", "control_batched", "doorbell", "doorbell_batched",
                  "fetch", "copy_setup", "b2b_issue", "sync_engine",
                  "fused_sync", "sync_obs", "sync_obs_batched", "poll_trigger",
                  "hop_latency", "reduce_setup", "nic_latency",
                  "cu_tile_setup"):
            v = getattr(self, f)
            if not v >= 0.0:
                raise ValueError(f"Calibration.{f} must be >= 0, got {v}")
        for f in ("engine_bw", "nic_bytes_per_s", "reduce_bytes_per_s",
                  "cu_flops"):
            v = getattr(self, f)
            if not v > 0.0:
                raise ValueError(f"Calibration.{f} must be > 0, got {v}")
        if not 0.0 < self.dma_link_efficiency <= 1.0:
            raise ValueError(
                "Calibration.dma_link_efficiency must be in (0, 1], got "
                f"{self.dma_link_efficiency}")
        if self.max_chunk_bytes < 0:
            raise ValueError(
                "Calibration.max_chunk_bytes must be >= 0 (0 disables "
                f"chunking), got {self.max_chunk_bytes}")


@dataclasses.dataclass(frozen=True)
class RcclCalibration:
    """CU-driven collective (RCCL) latency model, tuned per paper's baseline.

    latency = base_launch + size-dependent protocol overhead + wire time at
    an efficiency that ramps with message size (LL -> LL128 -> Simple).
    """

    base_launch: float = 4.506e-6      # kernel launch + graph-amortized setup
    wire_efficiency_max: float = 0.7851  # CU protocol metadata caps efficiency
    # Efficiency half-point: eff(size) = max_eff * size/(size + half_size),
    # per destination-shard size.
    half_size: float = 1.038e5
    min_latency: float = 4.771e-6      # floor for tiny collectives


# All-to-all is harder for CU-based libraries (no ring reuse; per-peer
# staging): the paper's RCCL AA baseline sits ~2.1x above its AG baseline at
# latency-bound sizes, which is why pcpy's AA gap (2.5x) is smaller than its
# AG gap (4.5x).
RCCL_AA_SCALE = 2.103


def rccl_ag_calibration() -> "RcclCalibration":
    return RcclCalibration()


def rccl_aa_calibration() -> "RcclCalibration":
    b = RcclCalibration()
    return RcclCalibration(
        base_launch=b.base_launch * RCCL_AA_SCALE,
        wire_efficiency_max=b.wire_efficiency_max,
        half_size=b.half_size,
        min_latency=b.min_latency * RCCL_AA_SCALE,
    )


@dataclasses.dataclass(frozen=True)
class PowerCalibration:
    """Component power (Watts) for the Fig. 15 reproduction.

    MI300X OAM is a ~750W part.  We model GPU power as
    idle + XCD (compute dies) + IOD (infinity cache/links/DMA) + HBM, with
    activity factors depending on who executes the collective.
    """

    idle: float = 140.0
    xcd_cu_collective: float = 300.0   # CUs spinning on copies (BW-bound)
    xcd_dma_collective: float = 80.0   # paper: ~3.7x less XCD power
    xcd_latency_scale: float = 0.35    # CU stress lower at latency-bound sizes
    iod_per_engine: float = 2.5        # per active DMA engine
    iod_cu: float = 55.0
    hbm_per_gbps: float = 0.12         # HBM power tracks streamed traffic
    hbm_static: float = 60.0
    cu_traffic_multiplier: float = 1.6  # CU protocol staging vs pure payload
    link_per_busy_gbps: float = 0.04   # per-link power tracks actual busy traffic
    # Host/sync energy (DESIGN.md §8.4): every host scheduling event (command
    # creation pass, doorbell ring, completion observation) wakes a CPU core
    # for a few microseconds; every standalone engine signal is an atomic
    # round-trip over the fabric.  Batched submission and fused write+signal
    # (§7.1/§7.3) remove most of both — the paper's 3-10% *additional* power
    # saving for optimized streams.
    host_wakeup_j: float = 4.5e-5      # J per host scheduling event
    atomic_j: float = 6.0e-6           # J per engine atomic signal round-trip


# ---------------------------------------------------------------- routing ----

def _torus_axis_hops(a: int, b: int, n: int) -> list[int]:
    """Signed unit steps (+1/-1) to travel a->b on a ring of size n, shortest way."""
    fwd = (b - a) % n
    bwd = (a - b) % n
    if fwd == 0:
        return []
    return [1] * fwd if fwd <= bwd else [-1] * bwd


@functools.lru_cache(maxsize=4096)
def _torus_route(grid: tuple[int, int], src: int, dst: int) -> tuple[tuple[int, int], ...]:
    """Dimension-ordered (row-first) shortest route on a 2D torus."""
    rows, cols = grid
    r, c = divmod(src, cols)
    rd, cd = divmod(dst, cols)
    hops: list[tuple[int, int]] = []
    cur = src
    for step in _torus_axis_hops(c, cd, cols):        # row links first
        nxt_c = (cur % cols + step) % cols
        nxt = (cur // cols) * cols + nxt_c
        hops.append((cur, nxt))
        cur = nxt
    for step in _torus_axis_hops(r, rd, rows):        # then column links
        nxt = ((cur // cols + step) % rows) * cols + cur % cols
        hops.append((cur, nxt))
        cur = nxt
    return tuple(hops)


@functools.lru_cache(maxsize=64)
def _snake_ring(grid: tuple[int, int]) -> tuple[int, ...]:
    """A Hamiltonian ring over the torus: boustrophedon rows; the wraparound
    column link closes last->first (requires an even number of rows, which
    every supported pod shape satisfies)."""
    rows, cols = grid
    order: list[int] = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        order.extend(r * cols + c for c in cs)
    return tuple(order)


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    n_devices: int
    link_bw: float                     # bytes/s, per direction, per link
    links_per_device: int              # simultaneously usable peer links
    n_engines: int                     # DMA engines per device
    host_link_bw: float                # bytes/s per direction (PCIe for MI300X)
    fully_connected: bool
    calib: Calibration = Calibration()
    grid: tuple[int, int] | None = None  # per-node 2D torus (rows, cols) if not FC
    n_nodes: int = 1                     # inter-node tier (DESIGN.md §11)

    def __post_init__(self) -> None:
        if self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {self.n_devices}")
        if not self.link_bw > 0.0:
            raise ValueError(f"link_bw must be > 0, got {self.link_bw}")
        if not self.host_link_bw > 0.0:
            raise ValueError(
                f"host_link_bw must be > 0, got {self.host_link_bw}")
        if self.links_per_device < 1 or self.n_engines < 1:
            raise ValueError(
                f"links_per_device/n_engines must be >= 1, got "
                f"{self.links_per_device}/{self.n_engines}")
        if self.n_nodes < 1 or self.n_devices % self.n_nodes:
            raise ValueError(
                f"n_nodes ({self.n_nodes}) must divide n_devices "
                f"({self.n_devices})")

    def peer_links(self, device: int) -> int:
        return self.links_per_device

    @property
    def aggregate_bw(self) -> float:
        """Total per-device injection bandwidth (bytes/s, one direction)."""
        return self.link_bw * self.links_per_device

    # ---- node structure (DESIGN.md §11) ----
    @property
    def node_devices(self) -> int:
        """Devices per node (the device range splits into equal nodes)."""
        return self.n_devices // self.n_nodes

    def node_of(self, device: int) -> int:
        return device // self.node_devices

    def local_rank(self, device: int) -> int:
        return device % self.node_devices

    def node_base(self, node: int) -> int:
        return node * self.node_devices

    # ---- routing (DESIGN.md §3, §11) ----
    def route(self, src: int, dst: int) -> tuple[tuple[int, int], ...]:
        """Directed links a src->dst transfer traverses, in traversal order.

        A cross-node transfer is one logical hop — the sender's NIC
        (DESIGN.md §11); :meth:`wire_path` maps it onto the ``nic:{src}``
        resource.  Intra-node routing is per-node: the torus runs over
        local ranks, offset back to global device ids.
        """
        if src == dst:
            return ()
        if self.n_nodes > 1 and self.node_of(src) != self.node_of(dst):
            return ((src, dst),)
        if self.fully_connected or self.grid is None:
            return ((src, dst),)
        base = self.node_base(self.node_of(src))
        local = _torus_route(self.grid, src - base, dst - base)
        if base:
            return tuple((a + base, b + base) for a, b in local)
        return local

    def hops(self, src: int, dst: int) -> int:
        return len(self.route(src, dst))

    def wire_path(self, src: int, dst: int) -> tuple[tuple[tuple[str, float], ...], float]:
        """Per-hop ``(timeline key, added latency)`` pairs + path bandwidth.

        The simulator's view of a route (DESIGN.md §11): intra-node hops run
        over directed DMA links (``link:{a}>{b}``) at the effective link
        bandwidth, the first hop adding no latency and each further hop the
        router's ``hop_latency`` (cut-through).  A cross-node transfer is a
        single hop through the sender's NIC (``nic:{src}``) at NIC bandwidth,
        charged ``nic_latency`` up front.
        """
        c = self.calib
        if self.n_nodes > 1 and self.node_of(src) != self.node_of(dst):
            return ((f"nic:{src}", c.nic_latency),), c.nic_bytes_per_s
        hop = c.hop_latency
        path = tuple(
            (f"link:{a}>{b}", 0.0 if h == 0 else hop)
            for h, (a, b) in enumerate(self.route(src, dst)))
        return path, self.link_bw * c.dma_link_efficiency

    def neighbors(self, device: int) -> tuple[int, ...]:
        """Directly linked peers — intra-node only (the NIC is not a link)."""
        if self.fully_connected or self.grid is None:
            base = self.node_base(self.node_of(device))
            return tuple(d for d in range(base, base + self.node_devices)
                         if d != device)
        base = self.node_base(self.node_of(device))
        rows, cols = self.grid
        r, c = divmod(device - base, cols)
        out = []
        for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            n = base + ((r + dr) % rows) * cols + (c + dc) % cols
            if n != device and n not in out:
                out.append(n)
        return tuple(out)

    def is_neighbor(self, a: int, b: int) -> bool:
        if self.n_nodes > 1 and self.node_of(a) != self.node_of(b):
            return False
        return a != b and len(self.route(a, b)) == 1

    def ring_order(self) -> tuple[int, ...]:
        """A device order in which consecutive (and wraparound) devices are
        physically adjacent — the embedding used by ring collectives.  On a
        multi-node topology the order is node-major (each node's local ring
        concatenated), so consecutive devices are adjacent *within* a node;
        the node boundaries are NIC hops and flat rings over them fail the
        builders' adjacency check (they fall back to the full event loop)."""
        if self.fully_connected or self.grid is None:
            return tuple(range(self.n_devices))
        local = _snake_ring(self.grid)
        if self.n_nodes == 1:
            return local
        return tuple(self.node_base(n) + d
                     for n in range(self.n_nodes) for d in local)

    def node_ring_order(self, node: int) -> tuple[int, ...]:
        """The intra-node ring (global device ids) for one node."""
        base = self.node_base(node)
        if self.fully_connected or self.grid is None:
            return tuple(range(base, base + self.node_devices))
        return tuple(base + d for d in _snake_ring(self.grid))


def mi300x_platform(calib: Calibration | None = None) -> Topology:
    return Topology(
        name="mi300x-8",
        n_devices=8,
        link_bw=64e9,
        links_per_device=7,
        n_engines=16,
        host_link_bw=64e9,
        fully_connected=True,
        calib=calib or Calibration(),
    )


def _near_square_grid(n: int) -> tuple[int, int]:
    """Factor n into the most square (rows, cols) with rows even when possible
    (an even row count closes the snake ring over the column wraparound)."""
    best = (1, n)
    for r in range(1, int(n ** 0.5) + 1):
        if n % r == 0:
            best = (r, n // r)
    r, c = best
    if r % 2 and c % 2 == 0:   # prefer the even side as rows
        r, c = c, r
    return (r, c)


def tpu_v5e_pod(n_devices: int = 256, calib: Calibration | None = None) -> Topology:
    """TPU v5e slice: 2D torus, 4 ICI ports/chip, ~50 GB/s per link/direction.

    Used for re-deriving latte dispatch thresholds on the TPU target.  Command
    issue constants are re-interpreted as scalar-core DMA-descriptor issue
    latencies inside a Pallas kernel (DESIGN.md §4); they are much smaller
    than host-driven doorbells.
    """
    c = calib or Calibration(
        control=0.05e-6,
        control_batched=0.0125e-6,  # descriptor template reuse on-chip
        doorbell=0.0,          # no host doorbell: descriptors issue on-chip
        doorbell_batched=0.0,
        fetch=0.10e-6,
        copy_setup=0.80e-6,    # DMA descriptor + route setup
        b2b_issue=0.05e-6,
        sync_engine=0.40e-6,   # semaphore signal
        fused_sync=0.08e-6,    # semaphore rides the final write packet
        sync_obs=0.20e-6,      # semaphore wait observe
        sync_obs_batched=0.05e-6,
        poll_trigger=0.20e-6,
        hop_latency=0.40e-6,   # ICI router forward per extra hop
        reduce_setup=0.12e-6,  # vector accumulate launch on the scalar core
        reduce_bytes_per_s=260e9,   # ~1/3 of the v5e HBM bandwidth (819 GB/s)
        engine_bw=50e9,
        dma_link_efficiency=0.95,
        cu_tile_setup=0.05e-6,  # MXU tile grab from the resident loop
        cu_flops=197e12,        # TPU_V5E_PEAK_BF16_FLOPS
    )
    return Topology(
        name=f"tpu-v5e-{n_devices}",
        n_devices=n_devices,
        link_bw=50e9,
        links_per_device=4,
        n_engines=8,
        host_link_bw=32e9,
        fully_connected=False,
        calib=c,
        grid=_near_square_grid(n_devices),
    )


def tpu_v5e_multislice(n_devices: int = 64, node_devices: int = 16,
                       calib: Calibration | None = None) -> Topology:
    """Multi-node TPU v5e: ``n_devices / node_devices`` ICI-torus slices
    joined over DCN (DESIGN.md §11).

    Each node is a ``node_devices``-chip 2D ICI torus (the same fabric as
    :func:`tpu_v5e_pod`); cross-node traffic serializes through the sender's
    DCN NIC at ~12.5 GB/s with ~5 µs injection latency — a 4× bandwidth and
    ~12× latency step down from an ICI link, which is what makes the
    hierarchical collective builders win (``collectives.py`` ``hier_``).
    """
    if n_devices % node_devices:
        raise ValueError(
            f"n_devices={n_devices} not divisible by node_devices={node_devices}")
    base = tpu_v5e_pod(node_devices)
    c = calib or dataclasses.replace(
        base.calib,
        nic_latency=5.0e-6,        # DCN injection (software + fabric)
        nic_bytes_per_s=12.5e9,    # ~100G DCN per chip
    )
    return Topology(
        name=f"tpu-v5e-{n_devices}x{node_devices}",
        n_devices=n_devices,
        link_bw=base.link_bw,
        links_per_device=base.links_per_device,
        n_engines=base.n_engines,
        host_link_bw=base.host_link_bw,
        fully_connected=False,
        calib=c,
        grid=_near_square_grid(node_devices),
        n_nodes=n_devices // node_devices,
    )


def mi300x_cluster(n_nodes: int = 2, calib: Calibration | None = None) -> Topology:
    """N fully-connected 8-GPU MI300X boxes joined over RDMA (DESIGN.md §11).

    Intra-node routing is the single direct xGMI link exactly as on
    :func:`mi300x_platform`; cross-node transfers serialize through the
    sender's 400G NIC (``Calibration.nic_latency`` / ``nic_bytes_per_s``
    defaults).  ``fully_connected`` is False because the *global* fabric is
    not — same-node pairs still route direct (``grid is None``).
    """
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    return Topology(
        name=f"mi300x-8x{n_nodes}",
        n_devices=8 * n_nodes,
        link_bw=64e9,
        links_per_device=7,
        n_engines=16,
        host_link_bw=64e9,
        fully_connected=False,
        calib=calib or Calibration(),
        grid=None,
        n_nodes=n_nodes,
    )


# TPU v5e roofline constants (system prompt / public spec).
TPU_V5E_PEAK_BF16_FLOPS = 197e12
TPU_V5E_HBM_BW = 819e9
TPU_V5E_ICI_BW_PER_LINK = 50e9
