"""Collective schedule builders — the paper's DMA collective designs (§4).

Each builder turns (topology, collective size, variant) into an explicit
:class:`Schedule` of engine queues, exactly as described in the paper:

* ``pcpy``  — baseline: one engine per peer, one copy+signal each (Fig. 8).
* ``bcst``  — all-gather only: broadcast commands pair up peers, halving
  commands/engines/signals (Fig. 9).
* ``swap``  — all-to-all only: in-place pairwise exchange; each pair's
  transfer is ONE command executed by one of the two devices (Fig. 10).
* ``b2b``   — all copies back-to-back on a single engine, one signal (Fig. 11).
* ``prelaunch_<v>`` — any of the above with queues armed ahead of time behind
  a ``poll`` command (Fig. 12).

Topology awareness (DESIGN.md §3): on a non-fully-connected topology the
direct variants above still build the same queue shapes — the simulator
routes each transfer over the torus (multi-hop, contended links).  Two
additional *neighbor-only* variants render the JAX ``ring``/``bidir_ring``
collectives of :mod:`repro_torch.core.collectives` as explicit schedules with real
cross-device dependencies (``wait`` on the predecessor's tagged signal):

* ``ring``       — unidirectional ring over :meth:`Topology.ring_order`,
  chained on ONE engine; all-gather forwards the received shard each step,
  all-to-all uses the rotation algorithm (step ``r`` forwards the ``n-1-r``
  chunks still in transit).
* ``bidir_ring`` — all-gather only: both directions per step (the step-0
  send is a single-read ``bcst`` feeding both neighbors), halving steps.

Optimized command streams (DESIGN.md §7): any variant may be prefixed with
``opt_`` (``opt_pcpy``, ``opt_prelaunch_b2b``, ``opt_ring``, ...) to run the
same schedule through :func:`repro_torch.core.dma.optimizations.optimize` — batched
submission, SDMA queue-slot parallelism and fused write+signal.  The ring /
bidir-ring / rotation-AA builders benefit chiefly from fused signaling (each
chained step drops its standalone semaphore command) and batching; the
one-shot builders additionally pick up multi-queue dispatch.

Pipelined ring collectives (DESIGN.md §9): the ``pipe_b2b`` /
``pipe_bidir_ring`` variants re-render the chained rings with *per-chunk
semaphore signaling* — every shard is split into ``pipe_depth`` chunk
commands (bounded by the sDMA packet ceiling), each chunk raises its own
fused chunk-indexed tag, each ring step runs on its own engine queue, and
step *k+1* waits per-chunk: it starts forwarding chunk *i* the moment chunk
*i* of step *k* landed, instead of waiting for the whole shard.  Successive
ring steps overlap on distinct engines while the per-link wire floor is
kept saturated; ``per_chunk_signaling=False`` builds the same queue shape
with final-chunk-only waits (the control arm of the §9 claims).

Reduce collectives (DESIGN.md §10): :func:`reduce_scatter_schedule` renders
the ring family with a consumer-side reduction per arrived shard —
``ring_rs`` / ``bidir_ring_rs`` reduce at transfer granularity, the
``pipe_ring_rs`` / ``pipe_bidir_ring_rs`` variants reduce each chunk the
moment it lands and forward the reduced partial while later chunks are
still in flight (the compute/communication overlap model of
arXiv:2512.10236).  :func:`allreduce_schedule` composes a reduce-scatter
with the matching (pipelined) all-gather: each device's terminal reductions
raise result tags that gate the all-gather's source queue chunk by chunk,
so the gather phase starts on the first *reduced* chunk instead of the
whole reduced shard.

Hierarchical multi-node collectives (DESIGN.md §11): on a topology with
``n_nodes > 1`` the ``hier_`` variants split every collective into an
intra-node tier (DMA links) and an inter-node tier (each device's NIC):

* ``hier_ring`` (all-gather) — ring all-gather across the *rank group*
  (same local rank, one device per node, each hop a NIC transfer), then a
  ring all-gather of the gathered node-blocks around each node's local
  ring.  Only ``(n_nodes - 1) / n_nodes`` of the payload ever crosses a
  NIC, vs everything on a flat ring whose node-boundary hops are NICs.
* ``hier_pipe`` (all-gather) — same two tiers, but the intra tier runs one
  sub-round per node-block and sub-round ``j`` is gated only on inter-node
  arrival ``j - 1``, so the local gather of block ``j`` overlaps the NIC
  transfer of block ``j + 1``.
* ``hier_ring_rs`` / ``hier_pipe_rs`` (reduce-scatter / all-reduce) — the
  reverse composition: ring reduce-scatter of node-blocks within the node,
  then ring reduce-scatter of the result shard across the rank group; the
  ``pipe`` rendering slices the inter tier per result shard so NIC sends
  start on the first node-reduced slice.

All ``hier_`` builders are translation invariant (every device runs the
same queue shapes; NICs are sender-owned) so the symmetric fast path (§6)
applies whenever each node's local ring closes on physical neighbors, and
the ``opt_`` / ``prelaunch_`` prefixes compose exactly as for the flat
variants.

Size convention: ``size`` is the collective's *total message size* as in the
paper's figures (1KB–4GB).  Each device's per-peer shard is ``size / n``.

Representative-only builds (DESIGN.md §11.3): every public builder takes
``device=<d>`` to construct only that device's queues — the dispatch sweep
builds just the symmetric representative, which is what makes schedule
construction (the sweep's dominant cost) O(1) in device count.
"""
from __future__ import annotations

import dataclasses

from . import commands as cmd
from .commands import (CmdKind, DATA_KINDS, EngineQueue, Schedule,
                       chunk_schedule, chunk_sizes, chunk_tag, chunked_copies,
                       chunked_reduces)
from .optimizations import OptimizationConfig, optimize, parse_optimized
from .topology import Topology

AG_VARIANTS = ("pcpy", "bcst", "b2b", "ring", "bidir_ring",
               "pipe_b2b", "pipe_bidir_ring")
AA_VARIANTS = ("pcpy", "swap", "b2b", "ring", "pipe_b2b")
RS_VARIANTS = ("ring_rs", "bidir_ring_rs", "pipe_ring_rs", "pipe_bidir_ring_rs")

#: Hierarchical two-tier variants (DESIGN.md §11) — only buildable on
#: topologies with ``n_nodes > 1``; kept out of the flat tuples so existing
#: single-node sweeps/claims are untouched.
HIER_AG_VARIANTS = ("hier_ring", "hier_pipe")
HIER_RS_VARIANTS = ("hier_ring_rs", "hier_pipe_rs")

#: Fused compute-collective variants (DESIGN.md §15).  ``seq`` is the
#: sequential baseline (same GEMM tiles and collective pipeline, but the
#: collective is gated on the *final* tile / the GEMM on the *final*
#: arrival); ``fused_*_d{2,4,8}`` overlap at that pipeline depth, and the
#: GEMM+reduce-scatter axis additionally picks the per-chunk reduction
#: placement (``cu`` vs ``engine``).
FUSED_RS_VARIANTS = ("seq", "fused_cu_d2", "fused_cu_d4", "fused_cu_d8",
                     "fused_engine_d2", "fused_engine_d4", "fused_engine_d8")
FUSED_AG_VARIANTS = ("seq", "fused_d2", "fused_d4", "fused_d8")

#: Default GEMM arithmetic intensity (FLOPs per byte of collective payload)
#: of the fused builders (DESIGN.md §15).  2 * K for a bf16 GEMM whose
#: reduction dimension K = 16384 — a large-model layer where the tile
#: stream is compute-bound on the modeled platforms, so the engine-side
#: reduce placement has CU slack to win at bandwidth-bound sizes.
GEMM_FLOPS_PER_BYTE = 32768

#: Default pipeline depth of the ``pipe_`` variants (DESIGN.md §9): the
#: minimum number of chunk commands a shard is split into.  Deeper splits
#: keep shrinking the per-step fill latency but pay per-chunk packet/issue
#: costs; depth 4 is where the chunk-count sweep stops improving on the
#: modeled platforms (the "sweep ceiling" of the §9 claims).
PIPE_DEPTH = 4


def _maybe_chunk(sched: Schedule, topo: Topology,
                 max_chunk_bytes: int | None) -> Schedule:
    """Split oversized copies into sDMA chunk commands (DESIGN.md §8.1).

    ``None`` uses the topology's calibrated ``Calibration.max_chunk_bytes``
    (the hardware packet ceiling); ``0`` disables chunking (used by tests
    comparing chunked and monolithic timing).  Runs before the optimization
    transforms so batching/slots/fusion operate on the chunked stream.
    """
    mcb = topo.calib.max_chunk_bytes if max_chunk_bytes is None else max_chunk_bytes
    return chunk_schedule(sched, mcb)


def _maybe_prelaunch(queues: list[EngineQueue], prelaunch: bool) -> tuple[EngineQueue, ...]:
    if not prelaunch:
        return tuple(queues)
    out = []
    for q in queues:
        out.append(
            EngineQueue(
                device=q.device,
                engine=q.engine,
                commands=(cmd.poll(),) + q.commands,
                prelaunched=True,
            )
        )
    return tuple(out)


def parse_variant(variant: str) -> tuple[str, bool]:
    if variant.startswith("prelaunch_"):
        return variant[len("prelaunch_"):], True
    return variant, False


def _maybe_optimize(sched: Schedule, optimized: bool,
                    config: OptimizationConfig | None) -> Schedule:
    return optimize(sched, config) if optimized else sched


def _bidir_split(n: int) -> tuple[int, int]:
    """(forward, backward) step split of the ``n - 1`` ring deliveries
    shared by EVERY bidirectional builder (all-gather and reduce-scatter)
    and by the all-reduce result-tag gating — these must stay in lockstep,
    or the gather phase waits on a terminal-reduction tag the reduce phase
    never raises (``ceil``/``floor`` of ``(n-1)/2``)."""
    n_fwd = (n - 1 + 1) // 2
    return n_fwd, (n - 1) - n_fwd


def _ring_neighbors(topo: Topology,
                    device: int | None = None) -> dict[int, tuple[int, int]]:
    """device -> (predecessor, successor) along the topology's ring embedding.

    ``device`` restricts the map to that one device (representative-only
    builds, DESIGN.md §11.3) — neighbors are still resolved on the full
    ring, only the iteration shrinks.
    """
    order = topo.ring_order()
    n = len(order)
    items = ((order[i], (order[(i - 1) % n], order[(i + 1) % n]))
             for i in range(n))
    if device is None:
        return dict(items)
    return {d: ps for d, ps in items if d == device}


def _ring_closes_on_neighbors(topo: Topology) -> bool:
    """True when every consecutive ring_order pair (incl. the wraparound) is a
    single physical link.  On odd-by-odd torus grids the snake ring's
    wraparound is multi-hop, which makes the devices asymmetric — such rings
    must run the full simulation, not the symmetric fast path."""
    order = topo.ring_order()
    n = len(order)
    return all(topo.is_neighbor(order[i], order[(i + 1) % n]) for i in range(n))


def _ring_ag_queues(topo: Topology, shard: int,
                    device: int | None = None) -> list[EngineQueue]:
    """Unidirectional ring all-gather: n-1 chained forward steps per device."""
    n = topo.n_devices
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        cs: list[cmd.Command] = []
        for k in range(n - 1):
            if k > 0:
                cs.append(cmd.wait(("ag", pred, k - 1)))
            cs.append(cmd.copy(d, succ, shard))
            cs.append(cmd.signal(("ag", d, k)))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, 0, tuple(cs)))
    return queues


def _bidir_ring_ag_queues(topo: Topology, shard: int,
                          device: int | None = None) -> list[EngineQueue]:
    """Bidirectional ring all-gather: ceil((n-1)/2) forward + floor((n-1)/2)
    backward deliveries; the step-0 send reads the local shard ONCE for both
    directions (a bcst command), covering forward AND backward distance 1,
    so the backward chain adds ``n_bwd - 1`` further steps (distances
    ``2..n_bwd``) — every device receives exactly ``n - 1`` distinct shards
    (the ``n_bwd``-distance shard arrives from the forward side only)."""
    n = topo.n_devices
    n_fwd, n_bwd = _bidir_split(n)
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        fwd: list[cmd.Command] = []
        if n == 2:
            fwd.append(cmd.copy(d, succ, shard))
        else:
            fwd.append(cmd.bcst(d, succ, pred, shard))
        fwd.append(cmd.signal(("agf", d, 0)))
        if n_bwd > 1 and n > 2:
            fwd.append(cmd.signal(("agb", d, 0)))
        for k in range(1, n_fwd):
            fwd.append(cmd.wait(("agf", pred, k - 1)))
            fwd.append(cmd.copy(d, succ, shard))
            fwd.append(cmd.signal(("agf", d, k)))
        fwd.append(cmd.signal())
        queues.append(EngineQueue(d, 0, tuple(fwd)))

        if n_bwd > 1 and n > 2:
            bwd: list[cmd.Command] = []
            for k in range(1, n_bwd):
                bwd.append(cmd.wait(("agb", succ, k - 1)))
                bwd.append(cmd.copy(d, pred, shard))
                bwd.append(cmd.signal(("agb", d, k)))
            bwd.append(cmd.signal())
            queues.append(EngineQueue(d, 1, tuple(bwd)))
    return queues


def _ring_aa_queues(topo: Topology, shard: int,
                    device: int | None = None) -> list[EngineQueue]:
    """Rotation ring all-to-all: every chunk moves one hop per round until it
    reaches its destination, so round r forwards n-1-r chunks."""
    n = topo.n_devices
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        cs: list[cmd.Command] = []
        for r in range(n - 1):
            if r > 0:
                cs.append(cmd.wait(("aar", pred, r - 1)))
            cs.append(cmd.copy(d, succ, (n - 1 - r) * shard))
            cs.append(cmd.signal(("aar", d, r)))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, 0, tuple(cs)))
    return queues


def _pipe_granularity(payload: int, depth: int, mcb: int) -> int:
    """Chunk granularity of a pipelined transfer (DESIGN.md §9): split
    ``payload`` into at least ``depth`` chunks, never exceeding the sDMA
    packet ceiling ``mcb`` (``mcb <= 0`` = ceiling disabled)."""
    if depth < 1:
        raise ValueError(f"pipe_depth must be >= 1, got {depth}")
    g = max(1, -(-payload // depth))
    return min(g, mcb) if mcb > 0 else g


def _pipe_ring_ag_queues(topo: Topology, shard: int, granularity: int,
                         per_chunk: bool,
                         device: int | None = None) -> list[EngineQueue]:
    """Pipelined unidirectional ring all-gather (``pipe_b2b``, DESIGN.md §9).

    One engine queue per ring step: step ``k`` forwards the shard received
    in step ``k-1`` as chunk commands, each raising a fused chunk-indexed
    tag, and waits on its predecessor *per chunk* — chunk ``i`` of step
    ``k`` issues as soon as chunk ``i`` of step ``k-1`` landed, so
    successive ring steps overlap on distinct engines while every link
    stays back-to-back at the ring's wire floor.  With
    ``per_chunk=False`` each step waits only on the predecessor's final
    chunk (the serialized control arm).  Only the final step notifies the
    host: its completion transitively implies every earlier chained step.
    """
    n = topo.n_devices
    c = len(chunk_sizes(shard, granularity))
    last = c - 1
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        for k in range(n - 1):
            tag = ("pag", d, k) if k < n - 2 else None
            copies = chunked_copies(CmdKind.COPY, d, (succ,), shard,
                                    granularity, tag, per_chunk=per_chunk)
            cs: list[cmd.Command] = []
            for i, cc in enumerate(copies):
                if k > 0 and (per_chunk or i == 0):
                    w = i if per_chunk else last
                    cs.append(cmd.wait(chunk_tag(("pag", pred, k - 1), w)))
                cs.append(cc)
            if k == n - 2:
                cs.append(cmd.signal())
            queues.append(EngineQueue(d, k % topo.n_engines, tuple(cs)))
    return queues


def _pipe_bidir_ag_queues(topo: Topology, shard: int, granularity: int,
                          per_chunk: bool,
                          device: int | None = None) -> list[EngineQueue]:
    """Pipelined bidirectional ring all-gather (``pipe_bidir_ring``, §9).

    The step-0 ``bcst`` feeds both directions reading the local shard once;
    its per-chunk tags unblock the forward AND backward step-1 queues chunk
    by chunk — in the chained bidir ring the backward engine idles until the
    *whole* bcst finished, which is the largest stall per-chunk signaling
    removes (a full shard's wire time at bandwidth-bound sizes).

    When steps outnumber engines, each direction's chain wraps onto its own
    engine subset (forward on the lower half, backward on the upper half).
    Sharing an engine *within* a chain keeps wake times strictly staggered
    (step ``k+E`` only unblocks after step ``k+E-1``), so grant order on the
    shared engine is unambiguous; mixing the two chains on one engine would
    tie their wake times exactly (the directions are mirror-symmetric) and
    leave the interleaving to the event loop's submission-order tie-break,
    which is not translation invariant — the schedule would stop being
    device-symmetric in the full simulation.
    """
    n = topo.n_devices
    n_fwd, n_bwd = _bidir_split(n)
    e_fwd = max(1, (topo.n_engines + 1) // 2)
    e_bwd = max(1, topo.n_engines - e_fwd)
    c = len(chunk_sizes(shard, granularity))
    last = c - 1
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        # step 0: one read feeds both directions (copy when n == 2).
        kind = CmdKind.COPY if n == 2 else CmdKind.BCST
        dsts = (succ,) if n == 2 else (succ, pred)
        tag = ("pg0", d, 0) if n > 2 else None
        cs = list(chunked_copies(kind, d, dsts, shard, granularity, tag,
                                 per_chunk=per_chunk))
        if n_fwd == 1:
            cs.append(cmd.signal())
        queues.append(EngineQueue(d, 0, tuple(cs)))
        # The bcst covers distance 1 BOTH ways, so the backward chain adds
        # n_bwd - 1 steps (distances 2..n_bwd) — n - 1 deliveries total,
        # mirroring _bidir_ring_ag_queues.
        for name_prev, name, peer, steps in (
                ("pg0", "pagf", pred, range(1, n_fwd)),
                ("pg0", "pagb", succ, range(1, n_bwd))):
            n_last = steps.stop - 1
            for k in steps:
                prev = name_prev if k == 1 else name
                tag = (name, d, k) if k < n_last else None
                target = succ if name == "pagf" else pred
                copies = chunked_copies(CmdKind.COPY, d, (target,), shard,
                                        granularity, tag, per_chunk=per_chunk)
                cs = []
                for i, cc in enumerate(copies):
                    if per_chunk or i == 0:
                        w = i if per_chunk else last
                        cs.append(cmd.wait(chunk_tag((prev, peer, k - 1), w)))
                    cs.append(cc)
                if k == n_last:
                    cs.append(cmd.signal())
                if name == "pagf":
                    e = k % e_fwd
                else:
                    # min(): on a 1-engine device both chains share engine 0
                    # (no phantom engine index past n_engines - 1).
                    e = min(e_fwd + ((k - 1) % e_bwd), topo.n_engines - 1)
                queues.append(EngineQueue(d, e, tuple(cs)))
    return queues


def _pipe_aa_queues(topo: Topology, shard: int, depth: int, mcb: int,
                    per_chunk: bool,
                    device: int | None = None) -> list[EngineQueue]:
    """Pipelined rotation ring all-to-all (``pipe_b2b``, DESIGN.md §9).

    Round ``r`` forwards the ``(n-1-r) * shard`` bytes still in transit as
    ``depth`` chunk commands (bounded by the packet ceiling).  Chunk ``i``
    of round ``r`` forwards bytes that arrived *after* the local shard of
    round ``r-1``, so its per-chunk wait resolves to the predecessor chunk
    covering offset ``(i+1)*g_r + shard`` — the dependency lands near the
    END of the previous round's stream (the rotation's forwarded payload is
    the tail of what arrived), which is why rotation all-to-all gains far
    less from per-chunk signaling than the all-gather rings (§9.3).
    """
    n = topo.n_devices
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        for r in range(n - 1):
            payload = (n - 1 - r) * shard
            g_r = _pipe_granularity(payload, depth, mcb)
            tag = ("paa", d, r) if r < n - 2 else None
            copies = chunked_copies(CmdKind.COPY, d, (succ,), payload, g_r,
                                    tag, per_chunk=per_chunk)
            cs: list[cmd.Command] = []
            if r > 0:
                prev_payload = (n - r) * shard
                g_p = _pipe_granularity(prev_payload, depth, mcb)
                c_prev = len(chunk_sizes(prev_payload, g_p))
            for i, cc in enumerate(copies):
                if r > 0 and (per_chunk or i == 0):
                    if per_chunk:
                        need = (i + 1) * g_r + shard
                        dep = min(-(-need // g_p) - 1, c_prev - 1)
                    else:
                        dep = c_prev - 1
                    cs.append(cmd.wait(chunk_tag(("paa", pred, r - 1), dep)))
                cs.append(cc)
            if r == n - 2:
                cs.append(cmd.signal())
            queues.append(EngineQueue(d, r % topo.n_engines, tuple(cs)))
    return queues


def _ring_rs_queues(topo: Topology, shard: int, *,
                    ar: bool = False,
                    device: int | None = None) -> list[EngineQueue]:
    """Unidirectional ring reduce-scatter (DESIGN.md §10): n-1 chained
    send steps per device, each (after step 0) preceded by the reduction of
    the predecessor's arrived partial, plus the terminal reduction that
    folds the last arrival into the device's result shard.  Tags are
    transfer-granular; chunking splits the copies AND the reductions at the
    same grain (``chunk_schedule``).  With ``ar=True`` the terminal
    reduction raises ``("arf", d, 0)`` — the all-reduce chaining hook.
    """
    n = topo.n_devices
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        cs: list[cmd.Command] = []
        for k in range(n - 1):
            if k > 0:
                cs.append(cmd.reduce_tag(("rs", pred, k - 1), shard))
            cs.append(cmd.copy(d, succ, shard))
            cs.append(cmd.signal(("rs", d, k)))
        cs.append(cmd.reduce_tag(("rs", pred, n - 2), shard,
                                 ("arf", d, 0) if ar else None))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, 0, tuple(cs)))
    return queues


def _bidir_ring_rs_queues(topo: Topology, shard: int, *,
                          ar: bool = False,
                          device: int | None = None) -> list[EngineQueue]:
    """Bidirectional ring reduce-scatter (DESIGN.md §10): partials flow in
    both directions — the forward chain accumulates the ``n_fwd``
    predecessors' contributions, the backward chain the ``n_bwd``
    successors' — and each device folds both terminal partials into its
    result shard (its own contribution seeds the accumulator).  Every
    device reduces exactly ``n - 1`` arrived shards, mirroring
    ``_bidir_ring_ag_queues``'s ``n - 1`` deliveries.  Unlike the bidir
    all-gather there is no step-0 ``bcst``: the two directions carry
    *different* partials, so step 0 is one copy per direction.
    """
    n = topo.n_devices
    n_fwd, n_bwd = _bidir_split(n)
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        for name, peer, target, steps, raise_name, engine in (
                ("rsf", pred, succ, n_fwd, "arf", 0),
                ("rsb", succ, pred, n_bwd, "arb",
                 min(1, topo.n_engines - 1))):
            if steps == 0:
                continue
            cs: list[cmd.Command] = []
            cs.append(cmd.copy(d, target, shard))
            cs.append(cmd.signal((name, d, 0)))
            for k in range(1, steps):
                cs.append(cmd.reduce_tag((name, peer, k - 1), shard))
                cs.append(cmd.copy(d, target, shard))
                cs.append(cmd.signal((name, d, k)))
            cs.append(cmd.reduce_tag((name, peer, steps - 1), shard,
                                     (raise_name, d, 0) if ar else None))
            cs.append(cmd.signal())
            queues.append(EngineQueue(d, engine, tuple(cs)))
    return queues


def _pipe_ring_rs_queues(topo: Topology, shard: int, granularity: int,
                         per_chunk: bool, *, ar: bool = False,
                         device: int | None = None) -> list[EngineQueue]:
    """Pipelined unidirectional ring reduce-scatter (``pipe_ring_rs``,
    DESIGN.md §10).

    One engine queue per ring step, like ``_pipe_ring_ag_queues``, but step
    ``k >= 1`` *reduces* each arrived chunk before forwarding the reduced
    partial: chunk ``i``'s reduction blocks on chunk ``i`` of the
    predecessor's step ``k-1`` transfer, so the reduce+forward of chunk
    ``i`` overlaps the wire time of chunk ``i+1`` — the finer-grain
    compute/communication overlap of arXiv:2512.10236.  A terminal
    reduce-only queue folds the last arrival into the result shard and
    notifies the host.  Every send step carries per-chunk tags (its
    consumer reduces every arrival), unlike the all-gather rings where the
    last step's payload is unconsumed.  ``per_chunk=False`` blocks every
    chunk reduction on the predecessor's final chunk (the control arm).
    """
    n = topo.n_devices
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        for k in range(n - 1):
            copies = chunked_copies(CmdKind.COPY, d, (succ,), shard,
                                    granularity, ("prs", d, k),
                                    per_chunk=per_chunk)
            if k == 0:
                cs = list(copies)
            else:
                reduces = chunked_reduces(("prs", pred, k - 1), shard,
                                          granularity, per_chunk=per_chunk)
                cs = []
                for r, cc in zip(reduces, copies):
                    cs.append(r)
                    cs.append(cc)
            queues.append(EngineQueue(d, k % topo.n_engines, tuple(cs)))
        cs = list(chunked_reduces(("prs", pred, n - 2), shard, granularity,
                                  per_chunk=per_chunk,
                                  raise_tag=("arf", d, 0) if ar else None))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, (n - 1) % topo.n_engines, tuple(cs)))
    return queues


def _pipe_bidir_rs_queues(topo: Topology, shard: int, granularity: int,
                          per_chunk: bool, *, ar: bool = False,
                          device: int | None = None) -> list[EngineQueue]:
    """Pipelined bidirectional ring reduce-scatter (``pipe_bidir_ring_rs``,
    DESIGN.md §10): the two partial chains of ``_bidir_ring_rs_queues``
    with per-chunk reductions and per-chunk tags.  As in
    ``_pipe_bidir_ag_queues``, each direction's chain wraps onto its own
    engine subset (chain-local sharing keeps wake times strictly staggered
    and the schedule translation-invariant); the terminal reduce-only
    queues extend their chain's engine rotation.
    """
    n = topo.n_devices
    n_fwd, n_bwd = _bidir_split(n)
    e_fwd = max(1, (topo.n_engines + 1) // 2)
    e_bwd = max(1, topo.n_engines - e_fwd)
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        for name, peer, target, steps, raise_name, fwd in (
                ("prf", pred, succ, n_fwd, "arf", True),
                ("prb", succ, pred, n_bwd, "arb", False)):
            if steps == 0:
                continue

            def engine(k: int) -> int:
                if fwd:
                    return k % e_fwd
                # min(): on a 1-engine device both chains share engine 0.
                return min(e_fwd + (k % e_bwd), topo.n_engines - 1)

            for k in range(steps):
                copies = chunked_copies(CmdKind.COPY, d, (target,), shard,
                                        granularity, (name, d, k),
                                        per_chunk=per_chunk)
                if k == 0:
                    cs = list(copies)
                else:
                    reduces = chunked_reduces((name, peer, k - 1), shard,
                                              granularity, per_chunk=per_chunk)
                    cs = []
                    for r, cc in zip(reduces, copies):
                        cs.append(r)
                        cs.append(cc)
                queues.append(EngineQueue(d, engine(k), tuple(cs)))
            cs = list(chunked_reduces((name, peer, steps - 1), shard,
                                      granularity, per_chunk=per_chunk,
                                      raise_tag=(raise_name, d, 0) if ar else None))
            cs.append(cmd.signal())
            queues.append(EngineQueue(d, engine(steps), tuple(cs)))
    return queues


# ------------------------------------------------ hierarchical (§11) ----

def _require_hier(topo: Topology, variant: str) -> None:
    if topo.n_nodes < 2:
        raise ValueError(
            f"variant {variant!r} needs a multi-node topology "
            f"(n_nodes >= 2), got {topo.name!r} with n_nodes={topo.n_nodes}")
    if topo.node_devices < 2:
        raise ValueError(
            f"variant {variant!r} needs >= 2 devices per node, "
            f"got node_devices={topo.node_devices}")


def _node_ring_neighbors(topo: Topology,
                         device: int | None = None) -> dict[int, tuple[int, int]]:
    """device -> (predecessor, successor) along its *node's* local ring."""
    out: dict[int, tuple[int, int]] = {}
    for node in range(topo.n_nodes):
        order = topo.node_ring_order(node)
        p = len(order)
        for i, d in enumerate(order):
            if device is not None and d != device:
                continue
            out[d] = (order[(i - 1) % p], order[(i + 1) % p])
    return out


def _internode_neighbors(topo: Topology, d: int) -> tuple[int, int]:
    """(predecessor, successor) on ``d``'s rank-group ring — the same local
    rank on the previous/next node (every NIC hop stays inside one rank
    group, so each device's cross-node traffic serializes only on its own
    NIC)."""
    step = topo.node_devices
    return (d - step) % topo.n_devices, (d + step) % topo.n_devices


def _hier_symmetric(topo: Topology) -> bool:
    """True when each node's local ring closes on physical neighbors — the
    per-tier translation-invariance condition of the ``hier_`` builders
    (the rank-group rings are always symmetric: one sender-owned NIC per
    device).  All nodes share one shape, so checking node 0 suffices."""
    order = topo.node_ring_order(0)
    p = len(order)
    if p < 2:
        return False
    return all(topo.is_neighbor(order[i], order[(i + 1) % p]) for i in range(p))


def _build_devices(topo: Topology, device: int | None):
    if device is None:
        return range(topo.n_devices)
    return (device,)


def _hier_ring_ag_queues(topo: Topology, shard: int,
                         device: int | None = None) -> list[EngineQueue]:
    """Two-tier ring all-gather (``hier_ring``, DESIGN.md §11.2).

    Inter tier (engine 0): ring all-gather of ``shard`` across the rank
    group — ``n_nodes - 1`` chained NIC steps.  Intra tier (engine 1):
    once the device's node-block is complete (the rank-group predecessor's
    final inter step landed), ring all-gather of the ``n_nodes * shard``
    block around the node's local ring — ``node_devices - 1`` steps over
    DMA links.  One host signal per device, on the (later-finishing)
    intra queue.
    """
    m = topo.n_nodes
    block = m * shard
    e1 = min(1, topo.n_engines - 1)
    intra = _node_ring_neighbors(topo, device)
    queues = []
    for d in _build_devices(topo, device):
        npred, nsucc = _internode_neighbors(topo, d)
        inter: list[cmd.Command] = []
        for k in range(m - 1):
            if k > 0:
                inter.append(cmd.wait(("hgi", npred, k - 1)))
            inter.append(cmd.copy(d, nsucc, shard))
            inter.append(cmd.signal(("hgi", d, k)))
        queues.append(EngineQueue(d, 0, tuple(inter)))
        ipred, isucc = intra[d]
        cs: list[cmd.Command] = [cmd.wait(("hgi", npred, m - 2))]
        for k in range(topo.node_devices - 1):
            if k > 0:
                cs.append(cmd.wait(("hga", ipred, k - 1)))
            cs.append(cmd.copy(d, isucc, block))
            cs.append(cmd.signal(("hga", d, k)))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, e1, tuple(cs)))
    return queues


def _hier_pipe_ag_queues(topo: Topology, shard: int,
                         device: int | None = None) -> list[EngineQueue]:
    """Tier-pipelined two-tier all-gather (``hier_pipe``, DESIGN.md §11.2).

    Same inter tier as ``hier_ring``, but the intra tier runs one
    *sub-round* per node-block: sub-round ``j`` ring-all-gathers block
    ``j`` (``shard`` bytes per step) around the node and is gated only on
    that block's inter-node arrival (``j = 0``, the local block, starts
    with the doorbell) — the local gather of block ``j`` overlaps the NIC
    transfer of block ``j + 1`` instead of waiting for the whole inter
    phase.  All sub-rounds share ONE intra queue (engine 1): every
    sub-round sends over the same ``d -> isucc`` link, so separate queues
    would buy no wire overlap while their link-bound wake times tie
    exactly — and exact ties leave the grant interleaving to the event
    loop's global submission order, which is not translation invariant.
    Serial engine issue keeps the link FIFO deterministic and the schedule
    symmetric.
    """
    m = topo.n_nodes
    p = topo.node_devices
    e1 = min(1, topo.n_engines - 1)
    intra = _node_ring_neighbors(topo, device)
    queues = []
    for d in _build_devices(topo, device):
        npred, nsucc = _internode_neighbors(topo, d)
        inter: list[cmd.Command] = []
        for k in range(m - 1):
            if k > 0:
                inter.append(cmd.wait(("hgi", npred, k - 1)))
            inter.append(cmd.copy(d, nsucc, shard))
            inter.append(cmd.signal(("hgi", d, k)))
        queues.append(EngineQueue(d, 0, tuple(inter)))
        ipred, isucc = intra[d]
        cs: list[cmd.Command] = []
        for j in range(m):
            if j > 0:
                cs.append(cmd.wait(("hgi", npred, j - 1)))
            for k in range(p - 1):
                if k > 0:
                    cs.append(cmd.wait(("hgp", ipred, j, k - 1)))
                cs.append(cmd.copy(d, isucc, shard))
                cs.append(cmd.signal(("hgp", d, j, k)))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, e1, tuple(cs)))
    return queues


def _hier_ring_rs_queues(topo: Topology, shard: int, *, ar: bool = False,
                         device: int | None = None) -> list[EngineQueue]:
    """Two-tier ring reduce-scatter (``hier_ring_rs``, DESIGN.md §11.2).

    Intra tier (engine 0): ring reduce-scatter of ``n_nodes * shard``
    node-blocks around the local ring — after ``node_devices - 1`` steps
    each device holds its block reduced over the node; the terminal
    reduction raises ``("hrit", d, 0)``.  Inter tier (engine 1): ring
    reduce-scatter of the result ``shard`` across the rank group, gated on
    the intra terminal — ``n_nodes - 1`` NIC steps.  Reduction work per
    device is ``(node_devices - 1) * n_nodes * shard + (n_nodes - 1) *
    shard = (n - 1) * shard`` bytes, exactly the flat rings' conservation
    invariant.  ``ar=True`` makes the inter terminal reduction raise
    ``("arf", d, 0)`` (all-reduce chaining).
    """
    m = topo.n_nodes
    block = m * shard
    e1 = min(1, topo.n_engines - 1)
    intra = _node_ring_neighbors(topo, device)
    queues = []
    for d in _build_devices(topo, device):
        npred, nsucc = _internode_neighbors(topo, d)
        ipred, isucc = intra[d]
        cs: list[cmd.Command] = []
        for k in range(topo.node_devices - 1):
            if k > 0:
                cs.append(cmd.reduce_tag(("hri", ipred, k - 1), block))
            cs.append(cmd.copy(d, isucc, block))
            cs.append(cmd.signal(("hri", d, k)))
        cs.append(cmd.reduce_tag(("hri", ipred, topo.node_devices - 2), block,
                                 ("hrit", d, 0)))
        queues.append(EngineQueue(d, 0, tuple(cs)))
        cs = [cmd.wait(("hrit", d, 0))]
        for k in range(m - 1):
            if k > 0:
                cs.append(cmd.reduce_tag(("hrx", npred, k - 1), shard))
            cs.append(cmd.copy(d, nsucc, shard))
            cs.append(cmd.signal(("hrx", d, k)))
        cs.append(cmd.reduce_tag(("hrx", npred, m - 2), shard,
                                 ("arf", d, 0) if ar else None))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, e1, tuple(cs)))
    return queues


def _hier_pipe_rs_queues(topo: Topology, shard: int,
                         per_chunk: bool = True, *, ar: bool = False,
                         device: int | None = None) -> list[EngineQueue]:
    """Tier-pipelined two-tier reduce-scatter (``hier_pipe_rs``, §11.2).

    The intra tier slices every node-block transfer and reduction at
    ``shard`` granularity with per-chunk tags (``chunked_copies`` /
    ``chunked_reduces``), so the terminal reduction raises one chunk tag
    ``("hrit", d, 0, i)`` per result slice; inter step ``k`` waits on
    slice ``k`` and starts its NIC send the moment that slice is
    node-reduced — the inter tier overlaps the intra tail instead of
    waiting for the whole block.  Slice index ``k`` is each device's
    *local* completion order (per-node slice rotation), which keeps the
    wait tags device-independent — the translation invariance the
    symmetric fast path needs.  ``per_chunk=False`` blocks every intra
    chunk on the predecessor's final chunk (the serialized control arm).
    """
    m = topo.n_nodes
    p = topo.node_devices
    block = m * shard
    e_intra = max(1, topo.n_engines - 1)
    intra = _node_ring_neighbors(topo, device)
    queues = []
    for d in _build_devices(topo, device):
        npred, nsucc = _internode_neighbors(topo, d)
        ipred, isucc = intra[d]
        for k in range(p - 1):
            copies = chunked_copies(CmdKind.COPY, d, (isucc,), block, shard,
                                    ("hri", d, k), per_chunk=per_chunk)
            if k == 0:
                cs = list(copies)
            else:
                reduces = chunked_reduces(("hri", ipred, k - 1), block, shard,
                                          per_chunk=per_chunk)
                cs = []
                for r, cc in zip(reduces, copies):
                    cs.append(r)
                    cs.append(cc)
            queues.append(EngineQueue(d, 1 + (k % e_intra), tuple(cs)))
        term = list(chunked_reduces(("hri", ipred, p - 2), block, shard,
                                    per_chunk=per_chunk,
                                    raise_tag=("hrit", d, 0)))
        queues.append(EngineQueue(d, 1 + ((p - 1) % e_intra), tuple(term)))
        # Inter tier on engine 0: step k consumes node-reduced slice k.
        cs = [cmd.wait(("hrit", d, 0, 0)), cmd.copy(d, nsucc, shard),
              cmd.signal(("hrx", d, 0))]
        for k in range(1, m - 1):
            cs.append(cmd.wait(("hrit", d, 0, k)))
            cs.append(cmd.reduce_tag(("hrx", npred, k - 1), shard))
            cs.append(cmd.copy(d, nsucc, shard))
            cs.append(cmd.signal(("hrx", d, k)))
        cs.append(cmd.wait(("hrit", d, 0, m - 1)))
        cs.append(cmd.reduce_tag(("hrx", npred, m - 2), shard,
                                 ("arf", d, 0) if ar else None))
        cs.append(cmd.signal())
        queues.append(EngineQueue(d, 0, tuple(cs)))
    return queues


def reduce_scatter_schedule(topo: Topology, size: int, variant: str = "ring_rs", *,
                            opt_config: OptimizationConfig | None = None,
                            max_chunk_bytes: int | None = None,
                            pipe_depth: int = PIPE_DEPTH,
                            per_chunk_signaling: bool = True,
                            device: int | None = None) -> Schedule:
    """Reduce-scatter: every device ends with its ``size / n`` result shard
    reduced over all n contributions (DESIGN.md §10).

    Variants are the ring family (``ring_rs``, ``bidir_ring_rs``), its
    per-chunk-pipelined renderings (``pipe_ring_rs``, ``pipe_bidir_ring_rs``)
    and, on multi-node topologies, the hierarchical two-tier family
    (``hier_ring_rs``, ``hier_pipe_rs``, DESIGN.md §11); the ``opt_`` /
    ``prelaunch_`` prefixes compose as for the other collectives.
    ``pipe_depth`` / ``per_chunk_signaling`` parameterize the ``pipe_``
    variants exactly as in :func:`allgather_schedule`; reductions re-slice
    at the same chunk granularity as the copies feeding them, so reduction
    work is conserved at ``(n-1) * shard_chunks`` chunk reductions per
    device whatever the grain.  ``device`` builds only that device's queues
    (representative-only, §11.3).
    """
    requested = variant
    variant, optimized = parse_optimized(variant)
    base, prelaunch = parse_variant(variant)
    if base not in RS_VARIANTS and base not in HIER_RS_VARIANTS:
        raise ValueError(f"unknown reduce-scatter variant {requested!r}")
    n = topo.n_devices
    shard = max(1, size // n)
    symmetric = _ring_closes_on_neighbors(topo)
    if base in HIER_RS_VARIANTS:
        _require_hier(topo, requested)
        symmetric = _hier_symmetric(topo)
        if base == "hier_pipe_rs":
            queues = _hier_pipe_rs_queues(topo, shard, per_chunk_signaling,
                                          device=device)
        else:
            queues = _hier_ring_rs_queues(topo, shard, device=device)
    elif base in ("pipe_ring_rs", "pipe_bidir_ring_rs"):
        mcb = topo.calib.max_chunk_bytes if max_chunk_bytes is None else max_chunk_bytes
        g = _pipe_granularity(shard, pipe_depth, mcb)
        builder = _pipe_ring_rs_queues if base == "pipe_ring_rs" else _pipe_bidir_rs_queues
        queues = builder(topo, shard, g, per_chunk_signaling, device=device)
    else:
        builder = _ring_rs_queues if base == "ring_rs" else _bidir_ring_rs_queues
        queues = builder(topo, shard, device=device)
    name = f"rs_opt_{variant}" if optimized else f"rs_{variant}"
    sched = Schedule(name=name, queues=_maybe_prelaunch(queues, prelaunch),
                     symmetric=symmetric)
    sched = _maybe_chunk(sched, topo, max_chunk_bytes)
    return _maybe_optimize(sched, optimized, opt_config)


def _ar_result_tags(base: str, n: int, device: int) -> list[tuple]:
    """The tags a device's all-reduce result shard completion raises: one
    per terminal reduction (both directions on the bidir variants)."""
    n_bwd = _bidir_split(n)[1]
    tags = [("arf", device, 0)]
    if "bidir" in base and n_bwd:
        tags.append(("arb", device, 0))
    return tags


def _ar_gate_ag_sources(queues: list[EngineQueue], base: str, n: int,
                        chunks: int | None,
                        per_chunk: bool = True) -> list[EngineQueue]:
    """Gate each device's all-gather *source* queue (the one whose first
    command is a data command — every other queue chains off it through
    the ring tags) on the device's reduce-scatter result tags.

    ``chunks=None`` (the non-pipelined variants) prepends one
    transfer-granularity wait per result tag — the terminal reduction's
    fused raise rides its final chunk.  On the pipelined variants the
    result tags are chunk-indexed: with ``per_chunk=True`` the gather
    waits on result chunk ``i`` directly before its ``i``-th data chunk,
    so it starts on the first *reduced* chunk (DESIGN.md §10); with
    ``per_chunk=False`` one wait on the final result chunk gates the whole
    queue (the control arm).
    """
    out = []
    for q in queues:
        if not q.commands or q.commands[0].kind not in DATA_KINDS:
            out.append(q)
            continue
        tags = _ar_result_tags(base, n, q.device)
        cs: list[cmd.Command] = []
        if chunks is None:
            cs.extend(cmd.wait(t) for t in tags)
            cs.extend(q.commands)
        elif not per_chunk:
            cs.extend(cmd.wait(chunk_tag(t, chunks - 1)) for t in tags)
            cs.extend(q.commands)
        else:
            i = 0
            for c in q.commands:
                if c.kind in DATA_KINDS:
                    cs.extend(cmd.wait(chunk_tag(t, i)) for t in tags)
                    i += 1
                cs.append(c)
        out.append(dataclasses.replace(q, commands=tuple(cs)))
    return out


#: All-gather phase paired with each reduce-scatter variant by
#: :func:`allreduce_schedule` (same ring embedding, same chunk grain).
_AR_AG_BUILDERS = {
    "ring_rs": _ring_ag_queues,
    "bidir_ring_rs": _bidir_ring_ag_queues,
    "pipe_ring_rs": _pipe_ring_ag_queues,
    "pipe_bidir_ring_rs": _pipe_bidir_ag_queues,
}

#: The standalone all-gather *variant* each reduce-scatter variant pairs
#: with — what the RS-then-AG sequential baseline of the §10 decomposition
#: claims simulates (claims.py, tests/test_property.py).
AR_AG_VARIANT = {
    "ring_rs": "ring",
    "bidir_ring_rs": "bidir_ring",
    "pipe_ring_rs": "pipe_b2b",
    "pipe_bidir_ring_rs": "pipe_bidir_ring",
    "hier_ring_rs": "hier_ring",
    "hier_pipe_rs": "hier_pipe",
}


def allreduce_schedule(topo: Topology, size: int, variant: str = "ring_rs", *,
                       opt_config: OptimizationConfig | None = None,
                       max_chunk_bytes: int | None = None,
                       pipe_depth: int = PIPE_DEPTH,
                       per_chunk_signaling: bool = True,
                       device: int | None = None) -> Schedule:
    """All-reduce as reduce-scatter + pipelined all-gather (DESIGN.md §10).

    ``variant`` names the reduce-scatter flavor (:data:`RS_VARIANTS` plus
    the usual prefixes); the matching all-gather rendering
    (:data:`_AR_AG_BUILDERS`) gathers the reduced shards over the same ring
    embedding at the same chunk granularity.  The two phases are chained
    through the terminal reductions' result tags: on the ``pipe_`` variants
    the gather's source queue waits *per chunk*, so the all-gather fill
    overlaps the reduce-scatter tail instead of starting after it.

    The gather phase's queues are always *armed ahead of time* (prelaunch,
    §4.5): they cannot make progress before the reduce phase's result tags
    anyway, so a real runtime enqueues their packets while the reduce
    phase streams — leaving them live would serialize the gather phase's
    full control cost on the host *before* the reduce phase's first
    doorbell, delaying the wire start by more than the overlap gains on
    host-heavy platforms.  A ``prelaunch_`` prefix additionally arms the
    reduce phase.  This is why the composed schedule is never slower than
    running the two collectives back to back (asserted in
    ``tests/test_property.py``).
    """
    requested = variant
    variant, optimized = parse_optimized(variant)
    base, prelaunch = parse_variant(variant)
    if base not in RS_VARIANTS and base not in HIER_RS_VARIANTS:
        raise ValueError(f"unknown all-reduce variant {requested!r}")
    n = topo.n_devices
    shard = max(1, size // n)
    symmetric = _ring_closes_on_neighbors(topo)
    if base in HIER_RS_VARIANTS:
        _require_hier(topo, requested)
        symmetric = _hier_symmetric(topo)
        if base == "hier_pipe_rs":
            rs_queues = _hier_pipe_rs_queues(topo, shard, per_chunk_signaling,
                                             ar=True, device=device)
            ag_queues = _hier_pipe_ag_queues(topo, shard, device=device)
        else:
            rs_queues = _hier_ring_rs_queues(topo, shard, ar=True,
                                             device=device)
            ag_queues = _hier_ring_ag_queues(topo, shard, device=device)
        # The hier terminal reduction raises one transfer-granular result
        # tag per device, so the gather gates exactly like the non-pipe
        # flat variants.
        ag_queues = _ar_gate_ag_sources(ag_queues, base, n, None)
    elif base in ("pipe_ring_rs", "pipe_bidir_ring_rs"):
        ag_builder = _AR_AG_BUILDERS[base]
        mcb = topo.calib.max_chunk_bytes if max_chunk_bytes is None else max_chunk_bytes
        g = _pipe_granularity(shard, pipe_depth, mcb)
        rs_builder = _pipe_ring_rs_queues if base == "pipe_ring_rs" else _pipe_bidir_rs_queues
        rs_queues = rs_builder(topo, shard, g, per_chunk_signaling, ar=True,
                               device=device)
        ag_queues = _ar_gate_ag_sources(
            ag_builder(topo, shard, g, per_chunk_signaling, device), base, n,
            len(chunk_sizes(shard, g)), per_chunk_signaling)
    else:
        ag_builder = _AR_AG_BUILDERS[base]
        rs_builder = _ring_rs_queues if base == "ring_rs" else _bidir_ring_rs_queues
        rs_queues = rs_builder(topo, shard, ar=True, device=device)
        ag_queues = _ar_gate_ag_sources(ag_builder(topo, shard, device), base,
                                        n, None)
    name = f"ar_opt_{variant}" if optimized else f"ar_{variant}"
    queues = _maybe_prelaunch(rs_queues, prelaunch) \
        + _maybe_prelaunch(ag_queues, True)
    sched = Schedule(name=name, queues=queues, symmetric=symmetric)
    sched = _maybe_chunk(sched, topo, max_chunk_bytes)
    return _maybe_optimize(sched, optimized, opt_config)


def allgather_schedule(topo: Topology, size: int, variant: str = "pcpy", *,
                       opt_config: OptimizationConfig | None = None,
                       max_chunk_bytes: int | None = None,
                       pipe_depth: int = PIPE_DEPTH,
                       per_chunk_signaling: bool = True,
                       device: int | None = None) -> Schedule:
    """All-gather: every device sends its shard (size/n) to all n-1 peers.

    An ``opt_`` variant prefix applies the optimized command-stream
    transforms (DESIGN.md §7) to the built schedule; ``opt_config``
    customizes them.  Copies above ``max_chunk_bytes`` (default: the
    topology's calibrated sDMA packet ceiling, DESIGN.md §8.1) are split
    into pipelined chunk commands; pass ``0`` to disable chunking.

    The ``pipe_`` variants (DESIGN.md §9) additionally take ``pipe_depth``
    (minimum chunks per shard; an explicit ``max_chunk_bytes`` narrows the
    chunk granularity further, which is how the dispatch chunk sweep drives
    the pipeline depth) and ``per_chunk_signaling`` (``False`` builds the
    final-chunk-only control arm of the §9 claims).
    """
    requested = variant
    variant, optimized = parse_optimized(variant)
    base, prelaunch = parse_variant(variant)
    if base not in AG_VARIANTS and base not in HIER_AG_VARIANTS:
        raise ValueError(f"unknown all-gather variant {requested!r}")
    n = topo.n_devices
    shard = max(1, size // n)
    queues: list[EngineQueue] = []
    symmetric = True
    if base in HIER_AG_VARIANTS:
        _require_hier(topo, requested)
        builder = _hier_ring_ag_queues if base == "hier_ring" else _hier_pipe_ag_queues
        queues = builder(topo, shard, device=device)
        symmetric = _hier_symmetric(topo)
    elif base in ("pipe_b2b", "pipe_bidir_ring"):
        mcb = topo.calib.max_chunk_bytes if max_chunk_bytes is None else max_chunk_bytes
        g = _pipe_granularity(shard, pipe_depth, mcb)
        builder = _pipe_ring_ag_queues if base == "pipe_b2b" else _pipe_bidir_ag_queues
        queues = builder(topo, shard, g, per_chunk_signaling, device)
        symmetric = _ring_closes_on_neighbors(topo)
    elif base == "pcpy":
        for d in _build_devices(topo, device):
            for e, p in enumerate(x for x in range(n) if x != d):
                queues.append(EngineQueue(d, e, (cmd.copy(d, p, shard), cmd.signal())))
        symmetric = topo.fully_connected
    elif base == "bcst":
        for d in _build_devices(topo, device):
            peers = [p for p in range(n) if p != d]
            e = 0
            it = iter(peers)
            for a in it:
                b = next(it, None)
                if b is None:
                    queues.append(EngineQueue(d, e, (cmd.copy(d, a, shard), cmd.signal())))
                else:
                    queues.append(EngineQueue(d, e, (cmd.bcst(d, a, b, shard), cmd.signal())))
                e += 1
        symmetric = topo.fully_connected
    elif base == "b2b":
        for d in _build_devices(topo, device):
            copies = tuple(cmd.copy(d, p, shard) for p in range(n) if p != d)
            queues.append(EngineQueue(d, 0, copies + (cmd.signal(),)))
        symmetric = topo.fully_connected
    elif base == "ring":
        queues = _ring_ag_queues(topo, shard, device)
        symmetric = _ring_closes_on_neighbors(topo)
    else:  # bidir_ring
        queues = _bidir_ring_ag_queues(topo, shard, device)
        symmetric = _ring_closes_on_neighbors(topo)
    name = f"ag_opt_{variant}" if optimized else f"ag_{variant}"
    sched = Schedule(name=name, queues=_maybe_prelaunch(queues, prelaunch),
                     symmetric=symmetric)
    sched = _maybe_chunk(sched, topo, max_chunk_bytes)
    return _maybe_optimize(sched, optimized, opt_config)


def alltoall_schedule(topo: Topology, size: int, variant: str = "pcpy", *,
                      opt_config: OptimizationConfig | None = None,
                      max_chunk_bytes: int | None = None,
                      pipe_depth: int = PIPE_DEPTH,
                      per_chunk_signaling: bool = True,
                      device: int | None = None) -> Schedule:
    """All-to-all: every device exchanges a size/n shard with every peer.

    With ``swap``, pair (i, j) is served by a single in-place swap command
    executed by one of the two devices (balanced round-robin assignment), so
    system-wide command count halves.  An ``opt_`` variant prefix applies the
    optimized command-stream transforms (DESIGN.md §7); ``max_chunk_bytes``
    bounds the per-command payload as in :func:`allgather_schedule`;
    ``pipe_depth``/``per_chunk_signaling`` parameterize the ``pipe_b2b``
    pipelined rotation ring (DESIGN.md §9).
    """
    requested = variant
    variant, optimized = parse_optimized(variant)
    base, prelaunch = parse_variant(variant)
    if base not in AA_VARIANTS:
        raise ValueError(f"unknown all-to-all variant {requested!r}")
    n = topo.n_devices
    shard = max(1, size // n)
    queues: list[EngineQueue] = []
    symmetric = True
    if base == "pipe_b2b":
        mcb = topo.calib.max_chunk_bytes if max_chunk_bytes is None else max_chunk_bytes
        queues = _pipe_aa_queues(topo, shard, pipe_depth, mcb,
                                 per_chunk_signaling, device)
        symmetric = _ring_closes_on_neighbors(topo)
    elif base == "swap":
        # Executor assignment alternates per pair -> devices run different
        # command counts, so this schedule is never symmetric.
        symmetric = False
        per_dev_engine = {d: 0 for d in range(n)}
        for i in range(n):
            for j in range(i + 1, n):
                executor = i if (i + j) % 2 == 1 else j
                partner = j if executor == i else i
                e = per_dev_engine[executor]
                per_dev_engine[executor] += 1
                if device is not None and executor != device:
                    continue
                queues.append(EngineQueue(executor, e, (cmd.swap(executor, partner, shard), cmd.signal())))
    elif base == "ring":
        queues = _ring_aa_queues(topo, shard, device)
        symmetric = _ring_closes_on_neighbors(topo)
    else:
        symmetric = topo.fully_connected
        for d in _build_devices(topo, device):
            peers = [p for p in range(n) if p != d]
            if base == "pcpy":
                for e, p in enumerate(peers):
                    queues.append(EngineQueue(d, e, (cmd.copy(d, p, shard), cmd.signal())))
            else:  # b2b
                copies = tuple(cmd.copy(d, p, shard) for p in peers)
                queues.append(EngineQueue(d, 0, copies + (cmd.signal(),)))
    name = f"aa_opt_{variant}" if optimized else f"aa_{variant}"
    sched = Schedule(name=name, queues=_maybe_prelaunch(queues, prelaunch),
                     symmetric=symmetric)
    sched = _maybe_chunk(sched, topo, max_chunk_bytes)
    return _maybe_optimize(sched, optimized, opt_config)


def kv_fetch_schedule(
    topo: Topology,
    n_blocks: int,
    block_bytes: int,
    variant: str = "pcpy",
    *,
    device: int = 0,
    b2b_fanout_threshold: int = 4 * 1024 * 1024,
    max_chunk_bytes: int | None = None,
) -> Schedule:
    """Host->device fetch of ``n_blocks`` dispersed KV-cache blocks (§5.3).

    * ``pcpy``: baseline vLLM — one ``hipMemcpyAsync`` per block, spread
      round-robin over the device's DMA engines, one signal per copy.
    * ``b2b``: our optimized path — all copies back-to-back on ONE engine
      with a single trailing signal; above the empirical 4MB threshold the
      runtime fans out to multiple engines (one signal each) for parallelism
      (paper §5.3.1).

    An ``opt_`` prefix additionally applies the optimized command-stream
    transforms (DESIGN.md §7) to the built schedule.
    """
    requested = variant
    variant, optimized = parse_optimized(variant)
    base, prelaunch = parse_variant(variant)
    total = n_blocks * block_bytes
    queues: list[EngineQueue] = []
    if base == "pcpy":
        per_engine: dict[int, list] = {}
        for b in range(n_blocks):
            e = b % topo.n_engines
            per_engine.setdefault(e, []).extend([cmd.copy("host", device, block_bytes), cmd.signal()])
        for e, cs in per_engine.items():
            queues.append(EngineQueue(device, e, tuple(cs)))
    elif base == "b2b":
        fanout = 1 if total < b2b_fanout_threshold else min(topo.n_engines, 4)
        for e in range(fanout):
            blocks = range(e, n_blocks, fanout)
            copies = tuple(cmd.copy("host", device, block_bytes) for _ in blocks)
            if copies:
                queues.append(EngineQueue(device, e, copies + (cmd.signal(),)))
    else:
        raise ValueError(f"unknown kv-fetch variant {requested!r}")
    name = f"kvfetch_opt_{variant}" if optimized else f"kvfetch_{variant}"
    sched = Schedule(name=name, queues=_maybe_prelaunch(queues, prelaunch))
    sched = _maybe_chunk(sched, topo, max_chunk_bytes)
    return _maybe_optimize(sched, optimized, None)


# ---------------------------------------------------------------------------
# Fused compute-collective overlap (DESIGN.md §15)
# ---------------------------------------------------------------------------

def _parse_fused_rs(base: str) -> tuple[bool, bool, int]:
    """``FUSED_RS_VARIANTS`` base -> (fused, on_cu, pipe_depth)."""
    if base == "seq":
        return False, False, PIPE_DEPTH
    _, placement, depth = base.split("_")
    return True, placement == "cu", int(depth[1:])


def _parse_fused_ag(base: str) -> tuple[bool, int]:
    """``FUSED_AG_VARIANTS`` base -> (fused, pipe_depth)."""
    if base == "seq":
        return False, PIPE_DEPTH
    _, depth = base.split("_")
    return True, int(depth[1:])


def _fused_gemm_rs_queues(topo: Topology, shard: int, granularity: int, *,
                          fused: bool, on_cu: bool, flops_per_byte: int,
                          device: int | None = None) -> list[EngineQueue]:
    """GEMM + pipelined ring reduce-scatter with tile-grain gating (§15).

    A per-device CU proxy queue (engine index ``topo.n_engines``, past the
    SDMA engines — its only engine-timeline use is the initial descriptor
    fetch) streams one ``compute`` tile per collective chunk, in the order
    the reduce-scatter consumes the local partials: step-0's send shard
    first, then each reduce step's accumulation shard, the result shard
    last.  Tile ``j*c + i`` raises ``("ftl", d, j*c + i)`` on completion.

    The collective itself is ``_pipe_ring_rs_queues`` re-rendered with tile
    gating: in the fused arms, step-0 chunk ``i`` waits on tile ``i`` and
    every chunk reduction at step ``j`` waits on tile ``j*c + i`` before
    consuming its arrival, so sends start the moment their partial exists;
    the ``seq`` arm keeps the identical wait stream but coarsens every
    gate to the *final* tile, serializing the whole GEMM before the
    collective (the status-quo kernel boundary) at the same host control
    cost.  ``on_cu`` selects the §15 reduction placement.
    """
    n = topo.n_devices
    sizes = chunk_sizes(shard, granularity)
    c = len(sizes)
    total = n * c
    e_cu = topo.n_engines
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        tiles = tuple(
            cmd.compute(max(1, flops_per_byte * sz),
                        raise_tag=("ftl", d, j * c + i))
            for j in range(n) for i, sz in enumerate(sizes))
        queues.append(EngineQueue(d, e_cu, tiles))
        for k in range(n - 1):
            copies = chunked_copies(CmdKind.COPY, d, (succ,), shard,
                                    granularity, ("frs", d, k),
                                    per_chunk=True)
            def tile(j: int, *, d=d) -> cmd.Command:
                # seq is the control arm: the SAME wait stream, every
                # gate coarsened to the final tile — identical host
                # control cost, only the gating grain differs (the
                # per_chunk=False idiom of the §9/§10 claims).
                return cmd.wait(("ftl", d, j if fused else total - 1))

            cs: list[cmd.Command] = []
            if k == 0:
                for i, cc in enumerate(copies):
                    cs.append(tile(i))
                    cs.append(cc)
            else:
                reduces = chunked_reduces(("frs", pred, k - 1), shard,
                                          granularity, on_cu=on_cu)
                for i, (r, cc) in enumerate(zip(reduces, copies)):
                    cs.append(tile(k * c + i))
                    cs.append(r)
                    cs.append(cc)
            queues.append(EngineQueue(d, k % topo.n_engines, tuple(cs)))
        term: list[cmd.Command] = []
        for i, r in enumerate(chunked_reduces(("frs", pred, n - 2), shard,
                                              granularity, on_cu=on_cu)):
            term.append(cmd.wait(("ftl", d,
                                  (n - 1) * c + i if fused else total - 1)))
            term.append(r)
        term.append(cmd.signal())
        queues.append(EngineQueue(d, (n - 1) % topo.n_engines, tuple(term)))
    return queues


def _fused_ag_gemm_queues(topo: Topology, shard: int, granularity: int, *,
                          fused: bool, flops_per_byte: int,
                          device: int | None = None) -> list[EngineQueue]:
    """Pipelined ring all-gather + GEMM with shard-grain launch (§15).

    The ring is ``_pipe_ring_ag_queues`` with one difference: EVERY step
    carries per-chunk tags (``("fga", d, k)``) — the last step's payload
    is consumed too, by the GEMM.  The CU proxy queue streams one tile per
    gathered chunk: the local shard's tiles launch unconditionally, and
    the tile for chunk ``i`` of arrival step ``k`` blocks (via the compute
    command's own wait tag) on ``chunk_tag(("fga", pred, k), i)`` — the
    ``seq`` arm coarsens every tile's gate to the final arrival chunk,
    so the whole GEMM trails the finished all-gather.  GEMM completion is
    the collective's completion (the CU queue's last tile end dominates
    ``copy_end``); the ring's own host signal mirrors the plain builder.
    """
    n = topo.n_devices
    sizes = chunk_sizes(shard, granularity)
    c = len(sizes)
    queues = []
    for d, (pred, succ) in _ring_neighbors(topo, device).items():
        for k in range(n - 1):
            copies = chunked_copies(CmdKind.COPY, d, (succ,), shard,
                                    granularity, ("fga", d, k),
                                    per_chunk=True)
            cs: list[cmd.Command] = []
            for i, cc in enumerate(copies):
                if k > 0:
                    cs.append(cmd.wait(chunk_tag(("fga", pred, k - 1), i)))
                cs.append(cc)
            if k == n - 2:
                cs.append(cmd.signal())
            queues.append(EngineQueue(d, k % topo.n_engines, tuple(cs)))
        tiles: list[cmd.Command] = []
        # seq is the control arm: same tile stream, every arrival gate
        # coarsened to the final arrival chunk (the local-shard tiles
        # included) — only the gating grain differs from the fused arms.
        final = chunk_tag(("fga", pred, n - 2), c - 1)
        for i, sz in enumerate(sizes):
            gate = None if fused else final
            tiles.append(cmd.compute(max(1, flops_per_byte * sz), tag=gate))
        for k in range(n - 1):
            for i, sz in enumerate(sizes):
                gate = chunk_tag(("fga", pred, k), i) if fused else final
                tiles.append(cmd.compute(max(1, flops_per_byte * sz),
                                         tag=gate))
        queues.append(EngineQueue(d, topo.n_engines, tuple(tiles)))
    return queues


def fused_gemm_rs_schedule(topo: Topology, size: int,
                           variant: str = "fused_engine_d4", *,
                           opt_config: OptimizationConfig | None = None,
                           max_chunk_bytes: int | None = None,
                           flops_per_byte: int = GEMM_FLOPS_PER_BYTE,
                           device: int | None = None) -> Schedule:
    """Fused GEMM + reduce-scatter (DESIGN.md §15): each device computes a
    ``size``-byte local partial (``flops_per_byte * size`` FLOPs, tiled at
    the collective's chunk grain) and reduce-scatters it over the ring —
    tile ``i``'s partial feeds the chunk pipeline the moment it completes.

    Variants are ``FUSED_RS_VARIANTS``: ``seq`` (GEMM-then-collective
    kernel boundary) and ``fused_{cu,engine}_d{2,4,8}`` — overlap at that
    pipeline depth with the per-chunk reductions placed on the CU or the
    engine timeline.  The ``opt_`` / ``prelaunch_`` prefixes compose as
    for the plain collectives; ``device`` builds one device's queues
    (representative-only, §11.3).
    """
    requested = variant
    variant, optimized = parse_optimized(variant)
    base, prelaunch = parse_variant(variant)
    if base not in FUSED_RS_VARIANTS:
        raise ValueError(
            f"unknown fused GEMM+reduce-scatter variant {requested!r}")
    fused, on_cu, depth = _parse_fused_rs(base)
    n = topo.n_devices
    shard = max(1, size // n)
    mcb = topo.calib.max_chunk_bytes if max_chunk_bytes is None else max_chunk_bytes
    g = _pipe_granularity(shard, depth, mcb)
    queues = _fused_gemm_rs_queues(topo, shard, g, fused=fused, on_cu=on_cu,
                                   flops_per_byte=flops_per_byte,
                                   device=device)
    name = f"gemmrs_opt_{variant}" if optimized else f"gemmrs_{variant}"
    sched = Schedule(name=name, queues=_maybe_prelaunch(queues, prelaunch),
                     symmetric=_ring_closes_on_neighbors(topo))
    sched = _maybe_chunk(sched, topo, max_chunk_bytes)
    return _maybe_optimize(sched, optimized, opt_config)


def fused_ag_gemm_schedule(topo: Topology, size: int,
                           variant: str = "fused_d4", *,
                           opt_config: OptimizationConfig | None = None,
                           max_chunk_bytes: int | None = None,
                           flops_per_byte: int = GEMM_FLOPS_PER_BYTE,
                           device: int | None = None) -> Schedule:
    """Fused all-gather + GEMM (DESIGN.md §15): the ring gathers a
    ``size``-byte operand and each device's GEMM consumes it at
    ``flops_per_byte`` FLOPs per gathered byte — the tile over shard ``k``
    launches the moment that input shard lands, instead of after the
    whole gather (``seq``).

    Variants are ``FUSED_AG_VARIANTS`` (``seq``, ``fused_d{2,4,8}``); the
    ``opt_`` / ``prelaunch_`` prefixes and ``device`` compose as in
    :func:`fused_gemm_rs_schedule`.
    """
    requested = variant
    variant, optimized = parse_optimized(variant)
    base, prelaunch = parse_variant(variant)
    if base not in FUSED_AG_VARIANTS:
        raise ValueError(
            f"unknown fused all-gather+GEMM variant {requested!r}")
    fused, depth = _parse_fused_ag(base)
    n = topo.n_devices
    shard = max(1, size // n)
    mcb = topo.calib.max_chunk_bytes if max_chunk_bytes is None else max_chunk_bytes
    g = _pipe_granularity(shard, depth, mcb)
    queues = _fused_ag_gemm_queues(topo, shard, g, fused=fused,
                                   flops_per_byte=flops_per_byte,
                                   device=device)
    name = f"aggemm_opt_{variant}" if optimized else f"aggemm_{variant}"
    sched = Schedule(name=name, queues=_maybe_prelaunch(queues, prelaunch),
                     symmetric=_ring_closes_on_neighbors(topo))
    sched = _maybe_chunk(sched, topo, max_chunk_bytes)
    return _maybe_optimize(sched, optimized, opt_config)
