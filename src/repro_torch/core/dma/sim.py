"""Event-driven simulator of DMA offload execution (paper §3, Fig. 6/7).

:func:`simulate` executes a :class:`~repro_torch.core.dma.commands.Schedule` on a
:class:`~repro_torch.core.dma.topology.Topology` and returns a :class:`SimResult`.
Unlike the original closed-form per-device model, every shared piece of
hardware is a *contended resource* with an explicit busy timeline
(DESIGN.md §2):

  host CPU     — serial: command-packet creation, doorbell MMIO writes,
                 completion-signal observation.
  engine       — per-(device, engine) streaming capacity: data commands
                 stream through it back-to-back at ``engine_bw``; all SDMA
                 queue slots of an engine share this one resource.
  link         — per *directed* peer link: wire time serializes on each link;
                 transfers on distinct links overlap.  Multi-hop routes
                 (non-fully-connected topologies) occupy every link on the
                 path, staggered by the per-hop router latency (cut-through).
  host link    — the PCIe link, one directed resource per device/direction,
                 shared by all of that device's engines.

Cross-device dependencies: a ``wait`` command blocks its engine until the
named tagged signal was raised by its producer (plus ``poll_trigger`` remote
observation latency), so ring/torus schedules are timed from real signal
arrival rather than assumed overlap.

The four reported phases keep the paper's meaning (``PhaseBreakdown`` is the
stable reporting surface):

  control  — CPU creates + enqueues command packets (serial on the host)
  schedule — doorbell rings (serial on the host) + engine wake/fetch
  copy     — decode, address translation, reads/writes over the fabric
             (wait-for-neighbor time lands here)
  sync     — completion signals (engine atomic + host observation; the host
             drains its signal set serially once the last signal landed)

Back-to-back overlap (§4.4): data commands queued on a single engine pipeline
their issue (``b2b_issue`` per extra command) and their wire time overlaps
across distinct links, bounded by the engine's streaming bandwidth.

Prelaunch (§4.5): queues that begin with a ``poll`` are armed ahead of time;
control+schedule leave the critical path and are replaced by the poll-trigger
observation latency.

Optimized command streams (DESIGN.md §7): queues built by
:mod:`repro_torch.core.dma.optimizations` may carry a host submission batch size
(``EngineQueue.batch`` — packet creation and doorbells amortize inside one
scheduling event, §7.1), occupy extra SDMA queue slots of one engine
(``EngineQueue.slot`` — decode/issue overlaps across slots; fetch and
streaming bandwidth still contend on the engine, §7.2), and fuse completion
signals into the final write packet of a
data command (``Command.fused_tag``/``fused_signal`` — the engine scheduling
round-trip ``sync_engine`` is replaced by the posted-write delay
``fused_sync``; the host-side observation cost is unchanged, §7.3).  Baseline
schedules set none of these and time identically to the unoptimized model.

Chunked transfers and the simulator hot path (DESIGN.md §8): GB-scale copies
arrive split into bounded-size chunk commands
(:func:`repro_torch.core.dma.commands.chunk_schedule`), multiplying event counts by
10-100x.  Three data structures keep the event loop fast:

  * the worklist is a **heap-based event queue** ordered by each queue's
    ready time, and a queue blocked on a tagged signal parks on a
    tag -> waiters map and is re-queued exactly when the producer raises the
    tag — no repeated scans over blocked queues (§8.2);
  * busy timelines are **append-only** and coalesce adjacent intervals, so a
    thousand back-to-back chunks cost one interval, not a thousand (§8.2);
  * a run of identical chunk commands (they share one ``Command`` instance)
    is scheduled in **closed form** — per-chunk issue still overlaps the
    previous chunk's streaming, but the whole run commits with O(1) timeline
    updates instead of one event per chunk (§8.3).  Runs whose issue rate or
    engine bandwidth would leave wire gaps fall back to the per-chunk loop.

Per-chunk signaling (DESIGN.md §9): pipelined schedules tag each chunk of a
transfer with its own semaphore (``fused_tag`` carrying a chunk index,
:func:`repro_torch.core.dma.commands.chunked_copies`) and ``wait`` at chunk
granularity, so a consumer starts on the first *arrived* chunk instead of
the whole transfer.  The tag -> waiters map handles chunk tags like any
other tag — a queue parked on chunk *i* wakes exactly when chunk *i*'s
fused semaphore is raised — and a run of equivalent-modulo-tag chunk
commands still schedules in closed form (§9.2): the run commits with O(1)
timeline updates while each chunk's tag is raised at its closed-form
completion time.

Per-chunk reduction (DESIGN.md §10): reduce-scatter schedules interleave
``reduce_tag`` commands with their forwarded copies — a ``reduce_tag``
blocks like a ``wait`` on the named chunk tag, then charges
``Calibration.reduce_setup + size / reduce_bytes_per_s`` on the consumer's
engine timeline (the engine reads the arrived chunk and the local
accumulator and writes the partial back) before the queue may forward the
reduced result.  Reduction time lands in the copy phase, exactly like
wait-for-neighbor time; an optional ``fused_tag`` on the reduce raises a
semaphore at reduction completion (all-reduce chaining).  The §9.2
closed-form chunk run is unaffected — reductions sit on the *consumer*,
so a producer's chunk run still commits closed-form and each chunk's
semaphore wakes its parked reduction exactly as the per-chunk loop would.

Compute-collective overlap (DESIGN.md §15): each device additionally owns a
*CU timeline* (``cu:{dev}``) modeling its compute units as one aggregate
serial resource.  A ``compute`` command occupies it for one GEMM tile
(``Calibration.cu_tile_setup + size / cu_flops``, ``size`` in FLOPs),
optionally blocking on a tagged chunk first (all-gather+GEMM: tile *k*
launches when shard *k* lands) and optionally raising a semaphore at tile
completion (GEMM+reduce-scatter: tile *i*'s partial releases the RS chunk
pipeline).  A ``reduce_tag`` with ``on_cu=True`` charges its §10 reduction
on the CU timeline instead of the consumer's engine — the reduce-placement
axis.  Schedules without compute/on_cu commands never create a CU timeline
and time bit-identically to the pre-§15 simulator.

Symmetric fast path (DESIGN.md §6): schedules whose builder marked them
``symmetric`` simulate ONE representative device — waits on a neighbor's
tagged signal resolve, by translation invariance, to the representative's own
signal of the same (name, step) — and replicate the breakdown.  This is
bit-identical to the full simulation because symmetric schedules never put
two devices on the same directed link.

Worked example — two devices, one copy each way, chained by a tagged signal::

    from repro_torch.core.dma import commands as cmd, mi300x_platform, simulate
    from repro_torch.core.dma.commands import EngineQueue, Schedule

    topo = mi300x_platform()
    MB = 1 << 20
    q0 = EngineQueue(device=0, engine=0, commands=(
        cmd.copy(0, 1, 4 * MB),          # dev0 pushes 4MB to dev1
        cmd.signal(("done", 0, 0)),      # engine-scope semaphore, step 0
        cmd.signal(),                    # host-observed completion
    ))
    q1 = EngineQueue(device=1, engine=0, commands=(
        cmd.wait(("done", 0, 0)),        # block until dev0's data arrived
        cmd.copy(1, 0, 4 * MB),          # then push 4MB back
        cmd.signal(),
    ))
    res = simulate(Schedule(name="pingpong", queues=(q0, q1)), topo)
    res.latency                  # end-to-end seconds (max over devices)
    res.per_device[1].copy       # dev1's copy phase INCLUDES its wait time
    res.breakdown.as_dict()      # critical-path device's 4-phase split
    res.utilization("link:0>1")  # busy fraction of the 0->1 wire

Device 1's queue makes no progress until device 0's tagged signal is raised;
:func:`_run` parks it on the ``("done", 0, 0)`` waiter list and re-queues it
the moment device 0's signal lands (a drained heap with parked waiters left
over raises ``RuntimeError`` naming the blocked tags).

Multi-schedule composition (DESIGN.md §12): :func:`run_composed` executes K
independent schedules in ONE resource world — every host, engine, link and
NIC timeline is shared, so concurrent collectives contend exactly as they
would on real hardware.  Each schedule is released at its arrival time
(host control may not begin earlier), its tags are namespaced by schedule
index so streams never satisfy each other's waits, and the per-schedule
``ScheduleOutcome`` reports release/start/finish plus a phase breakdown
relative to the release.  Composed runs always take the full event loop:
the symmetric fast path reasons about ONE schedule's translation symmetry
and is meaningless under cross-schedule contention.

Fault injection and timeout/retry (DESIGN.md §13): ``simulate(...,
faults=FaultPlan(...))`` threads a seeded, deterministic fault plan
(:mod:`repro_torch.core.dma.faults`) through the event loop — straggler engines
stream slower, derated/flapping wires grant slower or later, and tagged
raises may land late or be *dropped*.  A queue parked on a dropped tag is
recovered by watchdog/retry: once the heap drains with waiters left, the
producing command is re-issued from the watchdog deadline with exponential
backoff, its costs charged on the real host/engine/link timelines, up to
``max_attempts`` total attempts.  Exhaustion — and any fault-free deadlock
— raises :class:`~repro_torch.core.dma.faults.SimFault`, a ``RuntimeError``
subclass carrying a deterministic sorted diagnosis of every parked waiter
(device, blocked tag, producing command, nearest raised sibling tag) plus
the retry history.  An *empty* plan is normalized to ``None`` so the
fault-free path runs untouched and bit-identical.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

from .commands import DATA_KINDS, CmdKind, EngineQueue, Schedule, tag_chunk
from .faults import (BlockedWaiter, FaultPlan, FaultReport, RetryRecord,
                     SimFault)
from .topology import Topology
from .trace import SimTrace, TraceRecorder


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    """One device's latency split into the paper's four phases (Fig. 6/7).

    The fields are durations in seconds and partition the device's total:
    ``control`` (host packet creation), ``schedule`` (doorbells + engine
    wake), ``copy`` (data movement, including time spent waiting on a
    neighbor's signal) and ``sync`` (completion signaling + host
    observation).  ``total`` is their sum; ``noncopy_fraction`` is the
    paper's headline "how much of a small transfer is overhead" metric.
    """

    control: float
    schedule: float
    copy: float
    sync: float

    @property
    def total(self) -> float:
        """End-to-end seconds for this device (sum of the four phases)."""
        return self.control + self.schedule + self.copy + self.sync

    @property
    def noncopy_fraction(self) -> float:
        """Fraction of ``total`` spent outside the copy phase (Fig. 7)."""
        t = self.total
        return 0.0 if t == 0 else (t - self.copy) / t

    def as_dict(self) -> dict[str, float]:
        return {
            "control": self.control,
            "schedule": self.schedule,
            "copy": self.copy,
            "sync": self.sync,
            "total": self.total,
        }


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Everything :func:`simulate` learned about one schedule execution.

    ``latency`` is the collective's completion time (max over devices);
    ``per_device`` maps device id to its :class:`PhaseBreakdown`;
    ``timelines``/``busy`` expose the per-resource busy intervals recorded by
    the event loop (resource keys are ``host:<dev>``, ``engine:<dev>.<e>``,
    ``link:<a>><b>`` and ``hostlink:<dev>:<dir>``), which the power model and
    the utilization reports consume.  ``host_events`` counts each device's
    host scheduling events (command-creation passes, full-cost doorbells,
    completion observations) and ``engine_atomics`` its standalone engine
    signal round-trips — the quantities the power model prices for the
    optimized-stream saving (DESIGN.md §8.4).
    """

    latency: float                       # collective completion (max over devices)
    per_device: dict[int, PhaseBreakdown]
    engines_used: dict[int, int]
    hbm_bytes: dict[int, int]            # local HBM traffic per device (power model)
    # Per-resource busy timelines: resource name -> ((start, end), ...).
    # In symmetric mode only the representative device's resources appear.
    timelines: dict[str, tuple] = dataclasses.field(default_factory=dict)
    busy: dict[str, float] = dataclasses.field(default_factory=dict)
    host_events: dict[int, int] = dataclasses.field(default_factory=dict)
    engine_atomics: dict[int, int] = dataclasses.field(default_factory=dict)
    # Chunk reductions executed per device (DESIGN.md §10) — the event-loop
    # side of the reduction-work conservation invariant.
    reduce_chunks: dict[int, int] = dataclasses.field(default_factory=dict)
    representative: int | None = None    # set when the symmetric fast path ran
    # What the fault layer did (DESIGN.md §13) — None on fault-free runs
    # (an empty FaultPlan is normalized away before the event loop).
    fault_report: FaultReport | None = None
    # Per-command span record (DESIGN.md §14) — None unless the run was
    # started with record_trace=True; render with trace.chrome_trace().
    trace: SimTrace | None = None

    @property
    def breakdown(self) -> PhaseBreakdown:
        """Breakdown of the critical-path device."""
        return max(self.per_device.values(), key=lambda b: b.total)

    def utilization(self, resource: str) -> float:
        """Busy fraction of one resource over the collective's latency."""
        if self.latency <= 0:
            return 0.0
        return min(1.0, self.busy.get(resource, 0.0) / self.latency)

    def link_busy_seconds(self, device: int) -> float:
        """Total wire-busy seconds on links sourced at ``device`` (falls back
        to the representative device under the symmetric fast path)."""
        dev = device
        if self.representative is not None and not any(
                k.startswith(f"link:{device}>") or k.startswith(f"hostlink:{device}:")
                for k in self.busy):
            dev = self.representative
        pfx_l, pfx_h = f"link:{dev}>", f"hostlink:{dev}:"
        return sum(v for k, v in self.busy.items()
                   if k.startswith(pfx_l) or k.startswith(pfx_h))


class _Timeline:
    """A serial resource: requests are granted FIFO at max(request, free).

    Intervals are append-only and adjacent back-to-back grants coalesce into
    one interval (DESIGN.md §8.2) — a chunked GB transfer records one busy
    span, not hundreds.
    """

    __slots__ = ("free", "busy", "intervals")

    def __init__(self) -> None:
        self.free = 0.0
        self.busy = 0.0
        self.intervals: list[tuple[float, float]] = []

    def _record(self, start: float, end: float) -> None:
        iv = self.intervals
        if iv and iv[-1][1] == start:
            iv[-1] = (iv[-1][0], end)
        else:
            iv.append((start, end))

    def acquire(self, t: float, dur: float) -> tuple[float, float]:
        start = t if t > self.free else self.free
        end = start + dur
        self.free = end
        if dur > 0.0:
            self.busy += dur
            self._record(start, end)
        return start, end

    def occupy(self, start: float, end: float) -> None:
        """Commit a contiguous busy run computed in closed form (§8.3).

        Callers guarantee ``start >= free``; kept separate from ``acquire``
        so the run's exact closed-form ``end`` lands in ``free`` (re-adding
        the duration would reassociate the floats).
        """
        self.free = end
        if end > start:
            self.busy += end - start
            self._record(start, end)


class _QueueState:
    __slots__ = ("q", "idx", "issue", "seen_data", "last_end", "copy_end",
                 "start", "engine_tl", "blocked", "key")

    def __init__(self, q: EngineQueue, start: float, engine_tl: _Timeline,
                 key: tuple) -> None:
        self.q = q
        self.idx = 0
        self.start = start
        self.issue = start          # engine front-end clock
        self.seen_data = False
        self.last_end = start       # completion of the latest data command
        self.copy_end = start       # max data completion (device copy phase)
        self.engine_tl = engine_tl  # the engine's streaming timeline (cached)
        self.blocked = None         # resolved tag this queue is parked on
        self.key = key              # (schedule index, device) stats key (§12)


class _DroppedSignal:
    """Watchdog state of a tag whose raise was dropped (DESIGN.md §13.2).

    ``time`` is the would-have-raised time of the latest lost attempt;
    ``attempts`` counts total raise attempts so far (the original drop is
    attempt 1); ``deadline`` is lazily set to the watchdog expiry once a
    waiter is known to be parked on the tag (the watchdog arms from the
    later of the drop and the earliest parked wait)."""

    __slots__ = ("time", "device", "engine", "cmd", "attempts", "deadline")

    def __init__(self, time: float, device: int, engine: int, cmd) -> None:
        self.time = time
        self.device = device
        self.engine = engine
        self.cmd = cmd
        self.attempts = 1
        self.deadline: float | None = None


class _Sim:
    def __init__(self, topo: Topology, rep: int | None,
                 faults: FaultPlan | None = None,
                 trace: TraceRecorder | None = None) -> None:
        self.topo = topo
        self.calib = topo.calib
        self.rep = rep                      # symmetric-mode representative
        self.faults = faults                # FaultPlan or None (§13)
        self.trace = trace                  # TraceRecorder or None (§14)
        self.dropped: dict[tuple, _DroppedSignal] = {}
        self.drop_log: list[tuple] = []
        self.delay_log: list[tuple] = []
        self.retry_log: list[RetryRecord] = []
        self.retry_seconds = 0.0
        self.timelines: dict[str, _Timeline] = {}
        self.tags: dict[tuple, float] = {}  # tagged signal -> raise time
        self.raised: list[tuple] = []       # tags raised since last drain (§8.2)
        # Signal/event stats are keyed by (schedule index, device) so
        # composed runs (§12) keep per-schedule provenance; a plain
        # simulate() uses schedule index 0 throughout.
        self.host_signals: dict[tuple, list[float]] = defaultdict(list)
        # Fused completions (§7.3) write adjacent slots of one completion
        # record per device: the host drains them in a single sweep, paying
        # sync_obs once and sync_obs_batched for each further entry.
        self.fused_signals: dict[tuple, list[float]] = defaultdict(list)
        self.host_events: dict[tuple, int] = defaultdict(int)
        self.engine_atomics: dict[int, int] = defaultdict(int)
        self.reduce_chunks: dict[int, int] = defaultdict(int)
        # (src, dst) -> ((timeline, added latency) per hop, wire bandwidth);
        # resolving the route and the timeline dict once per endpoint pair
        # keeps the per-command cost flat under chunking.
        self._routes: dict[tuple, tuple[tuple[tuple[_Timeline, float], ...], float]] = {}

    def timeline(self, key: str) -> _Timeline:
        tl = self.timelines.get(key)
        if tl is None:
            tl = self.timelines[key] = _Timeline()
        return tl

    def resolve(self, tag: tuple) -> tuple:
        if self.rep is not None and len(tag) >= 2:
            return (tag[0], self.rep) + tuple(tag[2:])
        return tag

    # ------------------------------------------------------------ wire ----
    def route_tls(self, src, dst) -> tuple[tuple[tuple[_Timeline, float, str], ...], float]:
        """Per-hop (timeline, added latency, resource key) along src->dst +
        wire bandwidth.

        The hop structure comes from ``Topology.wire_path`` (DESIGN.md §11):
        intra-node hops are directed DMA links (first hop latency 0, further
        hops ``hop_latency``); a cross-node transfer is one hop through the
        sender's NIC at NIC bandwidth with ``nic_latency`` up front.  The
        resource key rides along so the fault layer (§13) can target derate
        windows and NIC flaps at specific wires.
        """
        key = (src, dst)
        ent = self._routes.get(key)
        if ent is None:
            if src == "host" or dst == "host":
                dev = dst if src == "host" else src
                dirn = "h2d" if src == "host" else "d2h"
                hkey = f"hostlink:{dev}:{dirn}"
                tls = ((self.timeline(hkey), 0.0, hkey),)
                bw = self.topo.host_link_bw * self.calib.dma_link_efficiency
            else:
                hops, bw = self.topo.wire_path(src, dst)
                tls = tuple((self.timeline(k), lat, k) for k, lat in hops)
            ent = self._routes[key] = (tls, bw)
        return ent

    def transfer(self, src, dst, size: int, start: float) -> float:
        """Occupy every hop on the src->dst route; returns completion time."""
        tls, bw = self.route_tls(src, dst)
        wire = size / bw
        t = start
        end = start
        fp = self.faults
        tr = self.trace
        if fp is None and tr is None:       # hot path: no per-hop branches
            for tl, lat, key in tls:
                s, end = tl.acquire(t + lat, wire)
                t = s                # cut-through: next hop staggers off start
        elif fp is None:
            for tl, lat, key in tls:
                s, end = tl.acquire(t + lat, wire)
                tr.wire(key, s, end)
                t = s
        else:
            for tl, lat, key in tls:
                # A flapping NIC holds the request until the outage clears;
                # a derate window stretches the wire occupancy (§13).
                req = fp.outage_release(key, t + lat)
                s, end = tl.acquire(req, wire / fp.derate_factor(key, req))
                if tr is not None:
                    tr.wire(key, s, end)
                t = s
        return end

    # ------------------------------------------------- chunk runs (§8.3) ----
    def _chunk_run(self, st: _QueueState, cmd, m: int, ts: float,
                   tagged: tuple | None = None) -> bool:
        """Closed-form schedule of ``m`` identical chunk commands.

        The per-chunk recurrence (issue clock advances ``b2b_issue``, the
        engine streams chunks FIFO, each wire grants FIFO) telescopes when
        every chunk streams back-to-back on the engine AND lands back-to-back
        on each wire; both conditions reduce to endpoint checks, so the whole
        run commits with one ``occupy`` per resource.  Returns False (no
        state touched) when the run is issue-bound, engine-bound relative to
        a wire, multi-hop, or carries fused flags — the caller then executes
        it per-chunk, which is always correct.

        ``tagged`` extends the closed form to *per-chunk-signaled* runs
        (DESIGN.md §9.2): ``m`` commands equivalent modulo their
        ``fused_tag`` (chunk-indexed semaphores, ``commands.chunked_copies``).
        The timeline commits are identical to the untagged run — a fused tag
        never gates the engine front end — and each chunk's semaphore is
        raised at its closed-form completion time, waking chunk-granularity
        waiters exactly as the per-chunk loop would.
        """
        if self.faults is not None or self.trace is not None:
            # Fault runs take the per-chunk loop (always correct): stragglers,
            # derate windows, flaps and per-tag signal draws all break the
            # back-to-back affine structure the closed form relies on (§13).
            # Traced runs do too: the closed form commits O(1) timeline
            # updates and would skip the per-chunk spans (§14) — the loop
            # reproduces its latency bit-for-bit, and its timelines to the
            # same ulp tolerance the §8.3/§9.2 equivalence tests pin.
            return False
        if tagged is None and (cmd.fused_tag is not None or cmd.fused_signal):
            return False
        size = cmd.size
        wires: list[tuple[_Timeline, float, float]] = []
        for dst in cmd.dsts:
            tls, bw = self.route_tls(cmd.src, dst)
            if len(tls) != 1:
                return False
            wires.append((tls[0][0], size / bw, tls[0][1]))
        if cmd.kind is CmdKind.SWAP:
            tls, bw = self.route_tls(cmd.dsts[0], cmd.src)
            if len(tls) != 1:
                return False
            wires.append((tls[0][0], size / bw, tls[0][1]))
        b = self.calib.b2b_issue
        engine = st.engine_tl
        issue0 = st.issue
        s1 = issue0 + b
        if engine.free > s1:
            s1 = engine.free
        sm = s1 + (m - 1) * ts
        tail = issue0 + m * b
        if tail > sm:                       # issue-bound: chunks gap on the engine
            return False
        end = sm + ts
        commits: list[tuple[_Timeline, float, float]] = []
        for tl, tw, lat in wires:
            # Each chunk's wire request lags its engine stream start by the
            # hop latency (0 intra-node, nic_latency across nodes).
            req1 = s1 + lat
            w1 = req1 if req1 > tl.free else tl.free
            wm = w1 + (m - 1) * tw
            if sm + lat > wm:               # engine-bound: chunks gap on this wire
                return False
            commits.append((tl, w1, wm + tw))
            if wm + tw > end:
                end = wm + tw
        engine.occupy(s1, sm + ts)
        for tl, a, z in commits:
            tl.occupy(a, z)
        if tagged is not None:
            # Raise each chunk's semaphore at its completion time (§9.2):
            # engine-stream end and every wire's landing end are affine in
            # the chunk index under the back-to-back conditions above.
            w1s = [(w1, tw) for (tl, tw, _), (_, w1, _) in zip(wires, commits)]
            fs = self.calib.fused_sync
            tags = self.tags
            for i, tc in enumerate(tagged):
                e_i = s1 + (i + 1) * ts
                for w1, tw in w1s:
                    we = w1 + (i + 1) * tw
                    if we > e_i:
                        e_i = we
                rt = self.resolve(tc.fused_tag)
                tags[rt] = e_i + fs
                self.raised.append(rt)
        st.issue = tail
        if end > st.last_end:
            st.last_end = end
        if end > st.copy_end:
            st.copy_end = end
        return True

    # --------------------------------------------------------- queue run ----
    def advance(self, st: _QueueState) -> bool:
        """Run one queue until finished (True) or blocked on a wait (False)."""
        c = self.calib
        q = st.q
        cmds = q.commands
        n = len(cmds)
        tags = self.tags
        idx = st.idx
        fp = self.faults
        tr = self.trace
        while idx < n:
            cmd = cmds[idx]
            kind = cmd.kind
            if kind in DATA_KINDS:
                st.issue += c.b2b_issue if st.seen_data else c.copy_setup
                st.seen_data = True
                # Identical chunk commands share one object (chunk_command):
                # detect the run by identity and try the closed form (§8.3).
                j = idx + 1
                while j < n and cmds[j] is cmd:
                    j += 1
                size = cmd.size
                tagged = None
                if j == idx + 1 and cmd.fused_tag is not None \
                        and not cmd.fused_signal:
                    # Per-chunk-signaled chunks (chunked_copies) are distinct
                    # instances equivalent modulo their chunk tag: detect the
                    # run by field equality and try the tagged closed form
                    # (§9.2).
                    while j < n:
                        c2 = cmds[j]
                        if (c2.kind is kind and c2.src == cmd.src
                                and c2.dsts == cmd.dsts and c2.size == size
                                and c2.fused_tag is not None
                                and not c2.fused_signal):
                            j += 1
                        else:
                            break
                    if j > idx + 1:
                        tagged = cmds[idx + 1:j]
                stream_bytes = size if kind is CmdKind.COPY else 2 * size
                ts = stream_bytes / c.engine_bw
                if fp is not None:
                    ts *= fp.engine_slowdown(q.device, q.engine)
                engine = st.engine_tl
                start = st.issue if st.issue > engine.free else engine.free
                _, end = engine.acquire(start, ts)
                if tr is not None:
                    span_tag = cmd.fused_tag if cmd.fused_tag is not None \
                        else cmd.tag
                    ch = None if span_tag is None else tag_chunk(span_tag)
                    tr.set_ctx(q.device, st.key[0], size, ch, False)
                    tr.span(f"engine:{q.device}.{q.engine}", q.device,
                            st.key[0], kind.name.lower(), start, end,
                            tag=span_tag, size=size, chunk=ch,
                            args={"src": cmd.src, "dsts": list(cmd.dsts)})
                for dst in cmd.dsts:
                    e = self.transfer(cmd.src, dst, size, start)
                    if e > end:
                        end = e
                if kind is CmdKind.SWAP:    # reverse direction, concurrently
                    e = self.transfer(cmd.dsts[0], cmd.src, size, start)
                    if e > end:
                        end = e
                if end > st.last_end:
                    st.last_end = end
                if end > st.copy_end:
                    st.copy_end = end
                # Fused write+signal (§7.3): the signal payload rides the
                # final write packet — no engine scheduling round-trip, so
                # the queue front end (st.issue) is NOT gated.
                if cmd.fused_tag is not None:
                    rt = self.resolve(cmd.fused_tag)
                    if fp is None:
                        tags[rt] = end + c.fused_sync
                        self.raised.append(rt)
                        if tr is not None:
                            tr.raise_tag(rt, end + c.fused_sync,
                                         f"engine:{q.device}.{q.engine}")
                    else:
                        self._faulty_raise(rt, end + c.fused_sync, q, cmd)
                if cmd.fused_signal:
                    self.fused_signals[st.key].append(end + c.fused_sync)
                idx += 1
                m = j - idx
                if m > 0 and self._chunk_run(st, cmd, m, ts, tagged):
                    idx = j
            elif kind is CmdKind.WAIT:
                rt = self.resolve(cmd.tag)
                t = tags.get(rt)
                if t is None:
                    st.idx = idx
                    st.blocked = rt
                    return False
                arrival = t + c.poll_trigger
                if tr is not None:
                    # Wait span: engine reached the wait (st.issue — parking
                    # does not advance it) until signal arrival; an
                    # already-arrived tag yields an instant event (§14).
                    tr.wait(f"engine:{q.device}.{q.engine}", q.device,
                            st.key[0], st.issue,
                            arrival if arrival > st.issue else st.issue, rt)
                if arrival > st.issue:
                    st.issue = arrival
                idx += 1
            elif kind is CmdKind.REDUCE:
                # Per-chunk reduction (DESIGN.md §10): block like a wait,
                # then stream the accumulate through the consumer's engine.
                rt = self.resolve(cmd.tag)
                t = tags.get(rt)
                if t is None:
                    st.idx = idx
                    st.blocked = rt
                    return False
                arrival = t + c.poll_trigger
                start = st.issue if st.issue > arrival else arrival
                # Placement axis (§15): an on_cu reduction contends with
                # GEMM tiles on the CU timeline instead of with the
                # engine's forwarding copies, and skips the per-chunk
                # descriptor dispatch (reduce_setup) — the accumulate rides
                # the resident kernel's epilogue.
                if cmd.on_cu:
                    dur = cmd.size / c.reduce_bytes_per_s
                    red_tl = self.timeline(f"cu:{q.device}")
                else:
                    dur = c.reduce_setup + cmd.size / c.reduce_bytes_per_s
                    red_tl = st.engine_tl
                if fp is not None:
                    dur *= fp.engine_slowdown(q.device, q.engine)
                rstart, end = red_tl.acquire(start, dur)
                if tr is not None:
                    res = f"cu:{q.device}" if cmd.on_cu \
                        else f"engine:{q.device}.{q.engine}"
                    tr.wait(res, q.device, st.key[0], st.issue,
                            arrival if arrival > st.issue else st.issue, rt)
                    tr.span(res, q.device, st.key[0], "reduce", rstart, end,
                            tag=rt, size=cmd.size, chunk=tag_chunk(rt))
                st.issue = end
                if end > st.last_end:
                    st.last_end = end
                if end > st.copy_end:
                    st.copy_end = end
                self.reduce_chunks[q.device] += 1
                if cmd.fused_tag is not None:
                    rt2 = self.resolve(cmd.fused_tag)
                    if fp is None:
                        tags[rt2] = end + c.fused_sync
                        self.raised.append(rt2)
                        if tr is not None:
                            tr.raise_tag(rt2, end + c.fused_sync,
                                         f"engine:{q.device}.{q.engine}")
                    else:
                        self._faulty_raise(rt2, end + c.fused_sync, q, cmd)
                idx += 1
            elif kind is CmdKind.COMPUTE:
                # GEMM tile on the CU timeline (DESIGN.md §15): block like
                # a wait when the tile's input chunk is tagged, then occupy
                # the device's compute units for setup + FLOPs/throughput.
                start = st.issue
                rt = None
                if cmd.tag is not None:
                    rt = self.resolve(cmd.tag)
                    t = tags.get(rt)
                    if t is None:
                        st.idx = idx
                        st.blocked = rt
                        return False
                    arrival = t + c.poll_trigger
                    if arrival > start:
                        start = arrival
                dur = c.cu_tile_setup + cmd.size / c.cu_flops
                if fp is not None:
                    dur *= fp.engine_slowdown(q.device, q.engine)
                res = f"cu:{q.device}"
                cstart, end = self.timeline(res).acquire(start, dur)
                if tr is not None:
                    if rt is not None:
                        tr.wait(res, q.device, st.key[0], st.issue,
                                start if start > st.issue else st.issue, rt)
                    tr.span(res, q.device, st.key[0], "compute", cstart, end,
                            tag=rt, size=cmd.size,
                            chunk=None if rt is None else tag_chunk(rt))
                st.issue = end
                if end > st.last_end:
                    st.last_end = end
                if end > st.copy_end:
                    st.copy_end = end
                if cmd.fused_tag is not None:
                    rt2 = self.resolve(cmd.fused_tag)
                    if fp is None:
                        tags[rt2] = end + c.fused_sync
                        self.raised.append(rt2)
                        if tr is not None:
                            tr.raise_tag(rt2, end + c.fused_sync, res)
                    else:
                        self._faulty_raise(rt2, end + c.fused_sync, q, cmd)
                idx += 1
            elif kind is CmdKind.SIGNAL:
                t = (st.issue if st.issue > st.last_end else st.last_end) + c.sync_engine
                self.engine_atomics[q.device] += 1
                if tr is not None:
                    tr.span(f"engine:{q.device}.{q.engine}", q.device,
                            st.key[0], "signal", t - c.sync_engine, t,
                            tag=cmd.tag)
                if cmd.tag is not None:
                    # Semaphore update gates the engine's next command.
                    st.issue = t
                    rt = self.resolve(cmd.tag)
                    if fp is None:
                        tags[rt] = t
                        self.raised.append(rt)
                        if tr is not None:
                            tr.raise_tag(rt, t,
                                         f"engine:{q.device}.{q.engine}")
                    else:
                        # The engine-side update happened (the queue front end
                        # is gated either way); what a drop loses is the
                        # raise's visibility to waiters (§13.2).
                        self._faulty_raise(rt, t, q, cmd)
                else:
                    # Completion signals post asynchronously (fire-and-forget):
                    # later copies in the queue are not delayed.
                    self.host_signals[st.key].append(t)
                idx += 1
            else:                           # POLL: arming handled via queue start
                idx += 1
        st.idx = idx
        return True

    # ------------------------------------------- fault layer (§13) ----------
    def _faulty_raise(self, rt: tuple, t: float, q: EngineQueue, cmd) -> None:
        """Raise ``rt`` at ``t`` through the fault plan's signal draws:
        dropped raises park in ``self.dropped`` for the watchdog, delayed
        raises land ``delay_s`` late, the rest raise normally."""
        fp = self.faults
        tr = self.trace
        res = f"engine:{q.device}.{q.engine}"
        if fp.drops_signal(rt, 0):
            self.dropped[rt] = _DroppedSignal(t, q.device, q.engine, cmd)
            self.drop_log.append(rt)
            if tr is not None:
                tr.instant(res, q.device, 0, "drop", t, tag=rt,
                           args={"fault": "signal dropped", "attempt": 0})
            return
        if fp.delays_signal(rt, 0):
            t += fp.delay_s
            self.delay_log.append(rt)
            if tr is not None:
                tr.instant(res, q.device, 0, "delay", t, tag=rt,
                           args={"fault": "signal delayed",
                                 "delay_s": fp.delay_s})
        self.tags[rt] = t
        self.raised.append(rt)
        if tr is not None:
            tr.raise_tag(rt, t, res)

    def retry_dropped(self, waiting: dict) -> bool:
        """Watchdog/retry step (§13.2), called when the heap drains with
        parked waiters left.  Re-issues the producer of the dropped tag with
        the earliest watchdog deadline (ties broken by tag repr —
        deterministic), charging host control+doorbell, engine fetch and the
        command's execution on the real contended timelines.  The re-raise
        runs the per-attempt fault draws again; a re-drop re-arms the
        watchdog with exponential backoff.  Returns False when no dropped,
        waited-on tag has attempts left — the caller then raises SimFault.
        """
        fp = self.faults
        cands = []
        for rt, rec in self.dropped.items():
            ws = waiting.get(rt)
            if not ws:
                continue                    # nobody waits: drop is harmless
            if rec.deadline is None:
                # The watchdog arms from the later of the lost raise and the
                # earliest parked wait (a waiter can't time out a signal it
                # hasn't started waiting for).
                park = min(w.issue for w in ws)
                base = rec.time if rec.time > park else park
                rec.deadline = base + fp.watchdog_s
            if rec.attempts < fp.max_attempts:
                cands.append((rec.deadline, repr(rt), rt))
        if not cands:
            return False
        deadline, _, rt = min(cands)
        rec = self.dropped[rt]
        cmd = rec.cmd
        c = self.calib
        tr = self.trace
        ekey = f"engine:{rec.device}.{rec.engine}"
        # Host re-creates the command packet and rings the doorbell; the
        # engine re-fetches and re-executes.  All on live contended timelines
        # so retry cost is real, not an additive constant.
        hs, t = self.timeline(f"host:{rec.device}").acquire(
            deadline, c.control + c.doorbell)
        engine = self.timeline(ekey)
        fs, t = engine.acquire(t, c.fetch)
        if tr is not None:
            tr.span(f"host:{rec.device}", rec.device, 0, "control", hs,
                    hs + c.control + c.doorbell, tag=rt, retry=True)
            tr.span(ekey, rec.device, 0, "fetch", fs, t, tag=rt, retry=True)
            tr.set_ctx(rec.device, 0, cmd.size, tag_chunk(rt), True)
        if cmd.kind in DATA_KINDS:
            stream = cmd.size if cmd.kind is CmdKind.COPY else 2 * cmd.size
            ts = (stream / c.engine_bw) * fp.engine_slowdown(rec.device, rec.engine)
            s0, end = engine.acquire(t + c.copy_setup, ts)
            if tr is not None:
                tr.span(ekey, rec.device, 0, cmd.kind.name.lower(), s0, end,
                        tag=rt, size=cmd.size, chunk=tag_chunk(rt),
                        retry=True,
                        args={"src": cmd.src, "dsts": list(cmd.dsts)})
            for dst in cmd.dsts:
                e = self.transfer(cmd.src, dst, cmd.size, s0)
                if e > end:
                    end = e
            if cmd.kind is CmdKind.SWAP:
                e = self.transfer(cmd.dsts[0], cmd.src, cmd.size, s0)
                if e > end:
                    end = e
            raise_t = end + c.fused_sync
        elif cmd.kind is CmdKind.REDUCE:
            setup = 0.0 if cmd.on_cu else c.reduce_setup
            dur = (setup + cmd.size / c.reduce_bytes_per_s) \
                * fp.engine_slowdown(rec.device, rec.engine)
            red_tl = self.timeline(f"cu:{rec.device}") if cmd.on_cu else engine
            rkey = f"cu:{rec.device}" if cmd.on_cu else ekey
            rs, end = red_tl.acquire(t, dur)
            if tr is not None:
                tr.span(rkey, rec.device, 0, "reduce", rs, end, tag=rt,
                        size=cmd.size, chunk=tag_chunk(rt), retry=True)
            raise_t = end + c.fused_sync
        elif cmd.kind is CmdKind.COMPUTE:
            dur = (c.cu_tile_setup + cmd.size / c.cu_flops) \
                * fp.engine_slowdown(rec.device, rec.engine)
            ckey = f"cu:{rec.device}"
            cs, end = self.timeline(ckey).acquire(t, dur)
            if tr is not None:
                tr.span(ckey, rec.device, 0, "compute", cs, end, tag=rt,
                        size=cmd.size, chunk=tag_chunk(rt), retry=True)
            raise_t = end + c.fused_sync
        else:                               # SIGNAL: engine atomic round-trip
            ss, raise_t = engine.acquire(t, c.sync_engine)
            self.engine_atomics[rec.device] += 1
            if tr is not None:
                tr.span(ekey, rec.device, 0, "signal", ss, raise_t, tag=rt,
                        retry=True)
        self.retry_seconds += raise_t - deadline
        attempt = rec.attempts              # draw-stream index of this re-raise
        dropped_again = fp.drops_signal(rt, attempt)
        self.retry_log.append(RetryRecord(
            tag=rt, attempt=attempt, issued_at=deadline,
            completed_at=raise_t, raised=not dropped_again))
        rec.attempts += 1
        if dropped_again:
            self.drop_log.append(rt)
            rec.time = raise_t
            rec.deadline = raise_t + fp.watchdog_s * fp.backoff ** attempt
            if tr is not None:
                tr.instant(ekey, rec.device, 0, "drop", raise_t, tag=rt,
                           args={"fault": "signal dropped",
                                 "attempt": attempt})
        else:
            del self.dropped[rt]
            if fp.delays_signal(rt, attempt):
                raise_t += fp.delay_s
                self.delay_log.append(rt)
            self.tags[rt] = raise_t
            self.raised.append(rt)
            if tr is not None:
                tr.raise_tag(rt, raise_t, ekey)
        return True

    def fault_report(self) -> FaultReport:
        return FaultReport(
            dropped=tuple(sorted(self.drop_log, key=repr)),
            delayed=tuple(sorted(self.delay_log, key=repr)),
            retries=tuple(self.retry_log),
            retry_seconds=self.retry_seconds,
        )


def _control_cost(live: list[EngineQueue], c) -> tuple[float, int]:
    """Host packet-creation (seconds, scheduling events) for one device.

    Baseline (``batch=1``): ``control`` per command, one scheduling event
    each.  Batched submission (§7.1): commands are created in groups of up to
    ``batch`` per host scheduling event — the first command of each event
    pays the full ``control``, the rest the amortized ``control_batched``.
    Events span queue boundaries: consecutively submitted batched queues fill
    the same scheduling event (the host builds all their packets in one
    pass).  The event count feeds the host-wakeup power term (§8.4).
    """
    t = 0.0
    events = 0
    room = 0                       # remaining commands in the current event
    for q in live:
        if q.batch <= 1:
            t += len(q.commands) * c.control
            events += len(q.commands)
            room = 0               # an unbatched submission breaks the event
            continue
        for _ in q.commands:
            if room == 0:
                t += c.control
                events += 1
                room = q.batch - 1
            else:
                t += c.control_batched
                room -= 1
    return t, events


def _start_device(sim: _Sim, dev: int, queues: list[EngineQueue],
                  t0: float, key: tuple) -> tuple[float, float, list[_QueueState]]:
    """Host control + doorbells; returns (cstart, cend, queue states).

    ``t0`` is the schedule's release time (DESIGN.md §12): host
    packet-creation may not begin earlier, and prelaunched queues arm
    relative to it.  ``cstart``/``cend`` are the absolute control-phase
    grant/end on the (possibly contended) host timeline; a plain
    simulate() passes ``t0=0`` on fresh timelines, where
    ``cend - t0 == t_control`` exactly.

    Doorbells are serial MMIO writes on the host.  Batched queues
    (``batch > 1``) submitted consecutively ring back-to-back: the first
    rings at the full ``doorbell`` cost, subsequent ones at
    ``doorbell_batched`` (§7.1).  This is deliberately coarser than the
    command-level event accounting of :func:`_control_cost` (which may
    start a new event mid-queue when ``batch`` commands fill up): doorbells
    are per *queue*, so only an intervening unbatched queue resets the
    amortization.  Unbatched queues always pay ``doorbell``.
    """
    c = sim.topo.calib
    tr = sim.trace
    live = [q for q in queues if not q.prelaunched]
    pre = [q for q in queues if q.prelaunched]
    host = sim.timeline(f"host:{dev}")

    t_control, events = _control_cost(live, c)
    if live:
        cstart, cend = host.acquire(t0, t_control)
        if tr is not None:
            # args["events"] = command-creation scheduling events only; the
            # trace-count reconciliation adds full-cost doorbells and the
            # completion drain to rebuild host_events (§14).
            tr.span(f"host:{dev}", dev, key[0], "control", cstart, cend,
                    args={"events": events,
                          "commands": sum(len(q.commands) for q in live)})
    else:
        cstart = cend = t0

    states: list[_QueueState] = []
    batched_seen = False
    for q in live:
        if q.batch > 1 and batched_seen:
            bell_cost = c.doorbell_batched
            full_ring = False
        else:
            bell_cost = c.doorbell
            full_ring = True
            events += 1            # a full-cost ring is its own host event
        # An intervening unbatched submission resets the amortization:
        # the next batched queue rings at full cost again.
        batched_seen = q.batch > 1
        bs, bell = host.acquire(host.free, bell_cost)
        engine_tl = sim.timeline(f"engine:{dev}.{q.engine}")
        engine_tl.acquire(bell, c.fetch)
        if tr is not None:
            tr.span(f"host:{dev}", dev, key[0], "doorbell", bs, bell,
                    args={"engine": q.engine, "full": full_ring})
            tr.span(f"engine:{dev}.{q.engine}", dev, key[0], "fetch",
                    bell, bell + c.fetch)
        states.append(_QueueState(q, bell + c.fetch, engine_tl, key))
    for q in pre:
        if tr is not None:
            tr.instant(f"engine:{dev}.{q.engine}", dev, key[0], "armed",
                       t0 + c.poll_trigger)
        states.append(_QueueState(q, t0 + c.poll_trigger,
                                  sim.timeline(f"engine:{dev}.{q.engine}"), key))
    sim.host_events[key] += events
    return cstart, cend, states


def _finish_device(sim: _Sim, dev: int, cend: float,
                   states: list[_QueueState], key: tuple) -> tuple[float, float, float]:
    """Drain this job's completion signals; returns absolute
    (sched_end, copy_end, total)."""
    c = sim.topo.calib
    sched_end = max((st.start for st in states), default=cend)
    copy_end = max((st.copy_end for st in states), default=sched_end)
    sigs = sim.host_signals.get(key, [])
    fused = sim.fused_signals.get(key, [])
    # The host drains its completion-signal set serially once the last
    # engine signal has landed: one observation per scattered per-queue
    # signal; fused completions (§7.3) share one contiguous completion
    # record, so the sweep pays sync_obs once plus sync_obs_batched per
    # further entry.
    t_obs = len(sigs) * c.sync_obs
    if fused:
        t_obs += c.sync_obs + (len(fused) - 1) * c.sync_obs_batched
    # One host wakeup drains the whole completion set (scattered signals
    # still cost a serial sync_obs read each — time, not an extra wakeup).
    if sigs or fused:
        sim.host_events[key] += 1
    signal_done = max([copy_end] + sigs + fused)
    ds, total = sim.timeline(f"host:{dev}").acquire(signal_done, t_obs)
    if sim.trace is not None and (sigs or fused):
        sim.trace.span(f"host:{dev}", dev, key[0], "sync", ds, total,
                       args={"signals": len(sigs), "fused": len(fused)})
    return sched_end, copy_end, total


def _breakdown(t0: float, cend: float, sched_end: float, copy_end: float,
               total: float) -> PhaseBreakdown:
    """Phase split of one job's absolute milestones relative to ``t0``."""
    return PhaseBreakdown(
        control=cend - t0,
        schedule=max(0.0, sched_end - cend),
        copy=max(0.0, copy_end - sched_end),
        sync=max(0.0, total - copy_end),
    )


def _run(sim: _Sim, jobs: list[tuple[tuple, int, list[EngineQueue], float]]
         ) -> dict[tuple, tuple[float, float, float, list[_QueueState]]]:
    """Heap-based event loop (DESIGN.md §8.2).

    ``jobs`` is a list of (key, device, queues, release) in submission
    order — host control/doorbells are booked eagerly per job in that
    order, so composed callers (§12) must pre-sort by release time.
    Returns key -> (release, cstart, cend, states); phase accounting
    happens in :func:`_finish_device` once the loop drains.

    Each queue enters a heap keyed by its ready time (doorbell + fetch, or
    the poll trigger for prelaunched queues) and runs until it finishes or
    blocks on an unraised tag; blocked queues park on a tag -> waiters map
    and re-enter the heap at the producer's raise time.  Grant order on
    shared timelines is therefore deterministic: ready time, then submission
    order.  A drained heap with parked waiters left is a deadlock, reported
    with the blocked tags.
    """
    started: dict[tuple, tuple[float, float, float, list[_QueueState]]] = {}
    for key, dev, queues, t0 in jobs:
        cstart, cend, states = _start_device(sim, dev, queues, t0, key)
        started[key] = (t0, cstart, cend, states)
    heap: list[tuple[float, int, _QueueState]] = []
    seq = 0
    for _, _, _, states in started.values():
        for st in states:
            heap.append((st.start, seq, st))
            seq += 1
    heapq.heapify(heap)
    waiting: dict[tuple, list[_QueueState]] = {}
    n_waiting = 0

    def wake() -> None:
        nonlocal n_waiting, seq
        for rt in sim.raised:
            ws = waiting.pop(rt, None)
            if ws:
                t = sim.tags[rt]
                for w in ws:
                    heapq.heappush(heap, (t, seq, w))
                    seq += 1
                n_waiting -= len(ws)
        sim.raised.clear()

    while True:
        while heap:
            _, _, st = heapq.heappop(heap)
            if not sim.advance(st):
                waiting.setdefault(st.blocked, []).append(st)
                n_waiting += 1
            if sim.raised:
                wake()
        if not n_waiting:
            break
        # Drained heap with parked waiters: under a FaultPlan, the watchdog
        # re-issues the producer of a dropped tag (§13.2) and the loop
        # continues; otherwise — or once retries are exhausted — this is a
        # deadlock, reported with the full blocked-dependency diagnosis.
        if sim.faults is None or not sim.retry_dropped(waiting):
            raise _deadlock_fault(sim, started, waiting)
        if sim.raised:
            wake()
    return started


def _producers(sim: _Sim, started) -> dict[tuple, str]:
    """Resolved tag -> human description of the command that produces it."""
    out: dict[tuple, str] = {}
    for _, _, _, states in started.values():
        for st in states:
            q = st.q
            for i, c in enumerate(q.commands):
                if c.kind is CmdKind.SIGNAL and c.tag is not None:
                    out.setdefault(
                        sim.resolve(c.tag),
                        f"signal (cmd {i}) on device {q.device} engine {q.engine}")
                if c.fused_tag is not None:
                    out.setdefault(
                        sim.resolve(c.fused_tag),
                        f"fused {c.kind.name.lower()} (cmd {i}) "
                        f"on device {q.device} engine {q.engine}")
    return out


def _nearest_tag(tag: tuple, raised) -> tuple | None:
    """The raised tag most similar to ``tag``: same name, smallest summed
    distance over trailing elements (numeric difference where both are
    numbers, a large constant otherwise).  Ties break on repr — the
    diagnosis stays deterministic.  The usual hit is an off-by-one step or
    chunk index: the breadcrumb that turns a deadlock report into a fix."""
    best = None
    best_key = None
    for cand in raised:
        if not cand or not tag or cand[0] != tag[0] or cand == tag:
            continue
        d = 1000.0 * abs(len(cand) - len(tag))
        for a, b in zip(tag[1:], cand[1:]):
            if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                d += abs(a - b)
            elif a != b:
                d += 1000.0
        k = (d, repr(cand))
        if best_key is None or k < best_key:
            best, best_key = cand, k
    return best


def _deadlock_fault(sim: _Sim, started, waiting: dict) -> SimFault:
    """Build the structured deadlock/fault report (DESIGN.md §13.3): one
    sorted :class:`BlockedWaiter` row per parked queue — device, engine,
    blocked tag, producing command, nearest raised sibling tag — plus the
    watchdog retry history when a FaultPlan was active."""
    producers = _producers(sim, started)
    raised = list(sim.tags)
    rows = []
    for rt, ws in waiting.items():
        for st in ws:
            rows.append(BlockedWaiter(
                device=st.q.device, engine=st.q.engine, tag=rt,
                producer=producers.get(rt),
                nearest=_nearest_tag(rt, raised)))
    rows.sort(key=lambda w: (repr(w.tag), w.device, w.engine))
    lines = [f"deadlocked schedule: {len(rows)} queue(s) parked on "
             f"unsignaled tags"]
    for w in rows:
        line = f"  device {w.device} engine {w.engine} waits on {w.tag!r}"
        if w.producer is not None:
            line += f" [producer: {w.producer}]"
        if w.nearest is not None:
            line += f"; nearest raised: {w.nearest!r}"
        lines.append(line)
    retries = tuple(sim.retry_log)
    if retries:
        lines.append(f"  retry history ({len(retries)} attempt(s)):")
        for r in retries:
            lines.append(
                f"    {r.tag!r} attempt {r.attempt} issued {r.issued_at:.6g}s"
                f" -> {'raised' if r.raised else 'dropped'} {r.completed_at:.6g}s")
    return SimFault("\n".join(lines), waiters=tuple(rows), retries=retries)


def _device_hbm_bytes(queues: list[EngineQueue]) -> int:
    """Local-HBM traffic generated by this device's outbound commands.

    Incoming writes are attributed by the collective-level wrapper (the
    schedule is symmetric so local accounting suffices for relative power).
    Every data kind reads ``size`` bytes locally and a reduction reads both
    operands (``Command.local_read_bytes``), inlined here because chunking
    makes this walk O(chunks).
    """
    total = 0
    for q in queues:
        for c in q.commands:
            if c.kind in DATA_KINDS:
                total += c.size
            elif c.kind is CmdKind.REDUCE:
                total += 2 * c.size
    return total


def simulate(schedule: Schedule, topo: Topology, *,
             symmetric: bool | None = None,
             faults: FaultPlan | None = None,
             record_trace: bool = False) -> SimResult:
    """Execute ``schedule`` on ``topo`` and return a :class:`SimResult`.

    ``symmetric=None`` (default) honors the builder's ``Schedule.symmetric``
    marking: marked schedules run the one-representative-device fast path
    (DESIGN.md §6), everything else runs the full multi-device event loop.
    Pass ``True``/``False`` to override — forcing ``True`` on a schedule that
    is not actually device-symmetric produces wrong (optimistic) timings and
    is only useful for testing the fast path itself.

    ``faults`` injects a seeded :class:`~repro_torch.core.dma.faults.FaultPlan`
    (DESIGN.md §13).  An *empty* plan is normalized to ``None`` — the
    fault-free path runs untouched, bit-identical to passing no plan.  A
    non-empty plan forces the full event loop (faults break the translation
    symmetry the fast path relies on) and fills ``SimResult.fault_report``.

    Raises :class:`~repro_torch.core.dma.faults.SimFault` (a ``RuntimeError``) if
    the schedule deadlocks — a ``wait`` on a tag no remaining queue can
    raise, or a dropped signal whose watchdog retries are exhausted; the
    message carries the sorted per-waiter diagnosis (§13.3).

    ``record_trace=True`` attaches a :class:`~repro_torch.core.dma.trace.SimTrace`
    to ``SimResult.trace`` (DESIGN.md §14).  Recording forces the full event
    loop — the symmetric (§6) and closed-form chunk (§8.3/§9.2) fast paths
    commit aggregate timeline updates and would skip per-command spans — but
    ``latency`` (and every per-device phase) stays bit-identical to the
    unrecorded run; coalesced busy intervals agree to the same ulp tolerance
    the fast-path equivalence tests pin (closed forms multiply where the
    loop accumulates).
    """
    if faults is not None and faults.is_empty():
        faults = None
    sym = schedule.symmetric if symmetric is None else symmetric
    if faults is not None or record_trace:
        sym = False
    trace = TraceRecorder() if record_trace else None
    devices = schedule.devices

    def run_full(run_devices: list[int]) -> dict[int, PhaseBreakdown]:
        started = _run(sim, [((0, d), d, schedule.queues_for(d), 0.0)
                             for d in run_devices])
        return {d: _breakdown(t0, cend, *_finish_device(sim, d, cend, states, key))
                for key, (t0, cstart, cend, states) in started.items()
                for d in (key[1],)}

    if sym and len(devices) > 1:
        rep = devices[0]
        sim = _Sim(topo, rep)
        rep_queues = schedule.queues_for(rep)
        breakdown = run_full([rep])[rep]
        per_device = {d: breakdown for d in devices}
        engines = {d: len({q.engine for q in rep_queues}) for d in devices}
        hbm = {d: _device_hbm_bytes(rep_queues) for d in devices}
        events = {d: sim.host_events.get((0, rep), 0) for d in devices}
        atomics = {d: sim.engine_atomics.get(rep, 0) for d in devices}
        reduces = {d: sim.reduce_chunks.get(rep, 0) for d in devices}
    else:
        sim = _Sim(topo, None, faults, trace)
        per_device = run_full(devices)
        engines = {d: schedule.engines_used(d) for d in devices}
        hbm = {d: _device_hbm_bytes(schedule.queues_for(d)) for d in devices}
        events = {d: sim.host_events.get((0, d), 0) for d in devices}
        atomics = {d: sim.engine_atomics.get(d, 0) for d in devices}
        reduces = {d: sim.reduce_chunks.get(d, 0) for d in devices}
        rep = None

    latency = max(b.total for b in per_device.values())
    return SimResult(
        latency=latency,
        per_device=per_device,
        engines_used=engines,
        hbm_bytes=hbm,
        timelines={k: tuple(tl.intervals) for k, tl in sim.timelines.items()},
        busy={k: tl.busy for k, tl in sim.timelines.items()},
        host_events=events,
        engine_atomics=atomics,
        reduce_chunks=reduces,
        representative=rep,
        fault_report=sim.fault_report() if faults is not None else None,
        trace=_finish_trace(trace, faults),
    )


def _finish_trace(trace: TraceRecorder | None,
                  faults: FaultPlan | None) -> SimTrace | None:
    """Freeze the recorder (plus fault windows, §14) into a SimTrace."""
    if trace is None:
        return None
    if faults is not None:
        trace.fault_windows(faults)
    return trace.finish()


@dataclasses.dataclass(frozen=True)
class ScheduleOutcome:
    """One schedule's timing inside a composed run (DESIGN.md §12).

    ``release`` is the arrival time passed to :func:`run_composed`;
    ``start`` is when the shared host first granted its control phase
    (``start - release`` is pure queueing delay); ``latency`` is the
    request-observed completion measured from ``release`` — the max over
    the schedule's per-device phase sums, the *same arithmetic*
    ``simulate()`` uses for ``SimResult.latency``, so under zero contention
    (or K=1) the two are bit-identical.  ``finish`` is the absolute
    completion, ``release + latency``.
    """

    index: int
    name: str
    release: float
    start: float
    latency: float
    per_device: dict[int, PhaseBreakdown]

    @property
    def finish(self) -> float:
        """Absolute completion time of the schedule's last device."""
        return self.release + self.latency


@dataclasses.dataclass(frozen=True)
class ComposedResult:
    """K schedules executed in one resource world (:func:`run_composed`).

    ``outcomes[k]`` times schedule k against its own release;``result`` is
    the composed world's :class:`SimResult` — ``latency`` is the makespan
    (time origin 0), ``timelines``/``busy`` cover every shared resource,
    per-device counters aggregate across schedules, and ``per_device``
    holds the breakdown of the last-finishing schedule on each device
    measured from 0 (so ``latency == max(total)`` still holds).
    """

    outcomes: tuple[ScheduleOutcome, ...]
    result: SimResult

    @property
    def makespan(self) -> float:
        return self.result.latency


def _namespace_schedule(schedule: Schedule, k: int) -> Schedule:
    """Prefix every tag/fused_tag with the schedule index (DESIGN.md §12).

    Streams composed into one world must never satisfy each other's waits:
    schedule k's tag ``(name, dev, step, ...)`` becomes
    ``(k, name, dev, step, ...)``.  The rewrite is memoized by command
    *identity* so a run of identical chunk commands (one shared instance,
    §8.3) maps to one shared rewritten instance — the closed-form chunk-run
    detection survives composition.  Tagless commands pass through
    unchanged.
    """
    memo: dict[int, object] = {}

    def rewrite(c):
        nc = memo.get(id(c))
        if nc is None:
            if c.tag is None and c.fused_tag is None:
                nc = c
            else:
                nc = dataclasses.replace(
                    c,
                    tag=None if c.tag is None else (k,) + tuple(c.tag),
                    fused_tag=(None if c.fused_tag is None
                               else (k,) + tuple(c.fused_tag)))
            memo[id(c)] = nc
        return nc

    queues = tuple(
        dataclasses.replace(q, commands=tuple(rewrite(c) for c in q.commands))
        for q in schedule.queues)
    return dataclasses.replace(schedule, queues=queues, symmetric=False)


def run_composed(schedules, topo: Topology,
                 release_times=None,
                 faults: FaultPlan | None = None,
                 record_trace: bool = False) -> ComposedResult:
    """Execute K independent schedules in ONE resource world (§12).

    ``schedules`` is a sequence of :class:`Schedule`; ``release_times``
    (default all 0) gives each stream's arrival time — its host control may
    not start earlier.  All host/engine/link/NIC timelines are shared, so
    concurrent streams contend exactly like concurrent collectives on real
    hardware; tags are namespaced per schedule so streams stay causally
    independent.  Host control/doorbells are granted in release order (ties:
    argument order), matching a driver that submits work as it arrives.

    Composed runs always execute the full event loop: the symmetric fast
    path (§6) models ONE schedule's translation symmetry and bails out here
    by construction.  With K=1 and release 0 the composed result is
    bit-identical to ``simulate(schedule, topo, symmetric=False)`` — and
    hence, for symmetric schedules, to ``simulate(schedule, topo)``.

    ``faults`` threads a :class:`~repro_torch.core.dma.faults.FaultPlan` through
    the composed world (DESIGN.md §13) — fault windows are in the composed
    run's time frame (0 = the first release).  An empty plan is normalized
    to ``None`` (bit-identical to no plan).

    ``record_trace=True`` attaches a :class:`~repro_torch.core.dma.trace.SimTrace`
    to ``ComposedResult.result.trace`` (§14); composed spans carry their
    schedule index so per-stream tracks render per-device/per-resource with
    the namespace in the slice label.  Recording never changes timing: the
    composed path already runs the full event loop.
    """
    schedules = list(schedules)
    if faults is not None and faults.is_empty():
        faults = None
    if not schedules:
        raise ValueError("run_composed needs at least one schedule")
    if release_times is None:
        release_times = [0.0] * len(schedules)
    release_times = [float(t) for t in release_times]
    if len(release_times) != len(schedules):
        raise ValueError(
            f"{len(schedules)} schedules but {len(release_times)} release times")
    if any(t < 0.0 for t in release_times):
        raise ValueError("release times must be >= 0")

    trace = TraceRecorder() if record_trace else None
    sim = _Sim(topo, None, faults, trace)
    namespaced = [_namespace_schedule(s, k) for k, s in enumerate(schedules)]
    jobs = []
    for k, (ns, t0) in enumerate(zip(namespaced, release_times)):
        for d in ns.devices:
            jobs.append(((k, d), d, ns.queues_for(d), t0))
    jobs.sort(key=lambda j: j[3])       # stable: ties keep submission order
    started = _run(sim, jobs)

    # Per-job milestones, finished in submission order (the host drains
    # completion sets serially; order is the same deterministic ready-time/
    # submission order the event loop used).
    raw: dict[tuple, tuple[float, float, float, float, float, float]] = {}
    for key, (t0, cstart, cend, states) in started.items():
        sched_end, copy_end, total = _finish_device(sim, key[1], cend, states, key)
        raw[key] = (t0, cstart, cend, sched_end, copy_end, total)

    outcomes = []
    for k, (s, ns, t0) in enumerate(zip(schedules, namespaced, release_times)):
        devs = ns.devices
        per_device = {}
        for d in devs:
            _, _, cend, sched_end, copy_end, total = raw[(k, d)]
            per_device[d] = _breakdown(t0, cend, sched_end, copy_end, total)
        outcomes.append(ScheduleOutcome(
            index=k,
            name=s.name,
            release=t0,
            start=min(raw[(k, d)][1] for d in devs),
            latency=max(b.total for b in per_device.values()),
            per_device=per_device,
        ))

    # Composed world view: on each device, report the breakdown of the
    # last-finishing schedule measured from time 0, so the SimResult keeps
    # its `latency == max(per_device total)` invariant (= the makespan).
    all_devices = sorted({d for ns in namespaced for d in ns.devices})
    per_device = {}
    engines: dict[int, int] = {}
    hbm: dict[int, int] = {}
    events: dict[int, int] = {}
    for d in all_devices:
        keys = [(k, d) for k, ns in enumerate(namespaced) if d in ns.devices]
        last = max(keys, key=lambda key: raw[key][5])
        _, _, cend, sched_end, copy_end, total = raw[last]
        per_device[d] = _breakdown(0.0, cend, sched_end, copy_end, total)
        engines[d] = len({q.engine for ns in namespaced for q in ns.queues_for(d)})
        hbm[d] = sum(_device_hbm_bytes(ns.queues_for(d)) for ns in namespaced)
        events[d] = sum(sim.host_events.get(key, 0) for key in keys)

    # max-of-totals rather than max(outcome.finish): bitwise the same
    # arithmetic simulate() uses (sum of phases), so K=1 stays bit-identical.
    result = SimResult(
        latency=max(b.total for b in per_device.values()),
        per_device=per_device,
        engines_used=engines,
        hbm_bytes=hbm,
        timelines={k2: tuple(tl.intervals) for k2, tl in sim.timelines.items()},
        busy={k2: tl.busy for k2, tl in sim.timelines.items()},
        host_events=events,
        engine_atomics={d: sim.engine_atomics.get(d, 0) for d in all_devices},
        reduce_chunks={d: sim.reduce_chunks.get(d, 0) for d in all_devices},
        representative=None,
        fault_report=sim.fault_report() if faults is not None else None,
        trace=_finish_trace(trace, faults),
    )
    return ComposedResult(outcomes=tuple(outcomes), result=result)


def single_copy_breakdown(size: int, topo: Topology, *, prelaunch: bool = False) -> PhaseBreakdown:
    """Fig. 7: phase breakdown of one GPU-to-GPU copy of ``size`` bytes."""
    from . import commands as cmd

    cmds = (cmd.copy(0, 1, size), cmd.signal())
    if prelaunch:
        cmds = (cmd.poll(),) + cmds
    q = EngineQueue(device=0, engine=0, commands=cmds, prelaunched=prelaunch)
    res = simulate(Schedule(name="single_copy", queues=(q,)), topo)
    return res.per_device[0]
