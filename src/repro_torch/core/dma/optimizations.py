"""Optimized DMA command streams — composable schedule transforms (paper §6).

The paper's baseline DMA collectives lose the latency-bound range to command
scheduling and synchronization overheads (Fig. 7): every command costs a host
scheduling event, every engine runs one queue, and every transfer trails a
standalone signal command.  This module models the paper's three
optimizations as *pure transforms* over a built
:class:`~repro_torch.core.dma.commands.Schedule` — each one rewrites the command
stream to relieve a specific contended resource of the event simulator, and
they compose (DESIGN.md §7):

* :func:`batch_commands` — batched doorbell/command scheduling (§7.1):
  relieves the **host CPU** timeline.
* :func:`split_queues` — SDMA queue-level parallelism (§7.2): relieves the
  **engine front end** (issue/decode) while streaming bandwidth stays
  contended.
* :func:`fuse_signals` — fused write+signal (§7.3): relieves the **engine
  scheduling round-trip** (one fewer command packet per step, ``sync_engine``
  becomes the posted-write delay ``fused_sync``).

:func:`optimize` applies all three in the canonical order (split, then fuse,
then batch).  The collective builders expose the result as ``opt_``-prefixed
variants (``opt_pcpy``, ``opt_prelaunch_b2b``, ...) so dispatch sweeps and
claims can compare baseline and optimized streams point-by-point.  Builders
chunk oversized copies (DESIGN.md §8.1) *before* these transforms run, so
batching amortizes per-chunk packet creation and fusion lands on the final
chunk — this is where the paper's large-size ~7% gain comes from.

Per-chunk signaling interaction (DESIGN.md §9): fusion operates at chunk
granularity.  A stream that signals after *every* chunk (``copy, signal(t0),
copy, signal(t1), ...``) fuses each semaphore onto its own chunk — exactly
the per-chunk-tagged commands the pipelined ring builders emit directly
(:func:`repro_torch.core.dma.commands.chunked_copies`), which is asserted
bit-identical in ``tests/test_sim.py``.  On an already per-chunk-fused
``pipe_`` schedule the transforms compose conservatively: queues carrying
fused chunk tags or waits are never split across SDMA slots (the chunk
order *is* the dependency order), fusion only absorbs the trailing host
completion, and batching amortizes the per-chunk packet creation — the
``opt_pipe_*`` variants owe most of their mid-size win to §7.1 batching of
the per-chunk/per-wait control stream.  Reduce-scatter streams (DESIGN.md
§10) follow the same rule: a queue interleaving ``reduce_tag`` commands
with its forwarded copies is never slot-split (the reduction of chunk
``i`` must precede the copy that forwards it), fusion leaves reductions
alone (their raise tags are set by the builders), and batching amortizes
the reduce/copy packet stream like any other.

Transforms never change *what* is transferred: byte counts, sources and
destinations are preserved exactly (asserted in ``tests/test_sim.py``), only
the scheduling/synchronization envelope changes.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from . import commands as cmd
from .commands import CmdKind, Command, DATA_KINDS, EngineQueue, Schedule

#: Variant-name prefix that requests :func:`optimize` on top of a base
#: variant, e.g. ``"opt_pcpy"`` or ``"opt_prelaunch_b2b"``.
OPT_PREFIX = "opt_"


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Knobs of the optimized command stream (DESIGN.md §7).

    ``batch``: commands created/submitted per host scheduling event (§7.1).
    ``queues_per_engine``: SDMA queue slots a single engine's command stream
    may be spread over (§7.2).  ``split_min_commands``: queues shorter than
    this are not split — per-slot decode overlap only beats the extra
    doorbells and completion fences when the front end is the bottleneck,
    i.e. for long issue-bound command streams (the empirical-threshold shape
    of the §5.3.1 KV-fetch fanout, but on command count: payload streaming
    hides the front end for big commands regardless of how many slots run).
    ``split_max_bytes`` is the payload side of the same gate: a queue whose
    data commands exceed it streams for far longer than a command decodes,
    so the front end is already hidden and splitting would only multiply
    doorbells and completion fences — chunked GB-scale streams (DESIGN.md
    §8.1, 1-4MB per command) therefore stay on one slot.
    ``fuse``: fuse trailing signals into their data command (§7.3).
    """

    batch: int = 8
    queues_per_engine: int = 4
    split_min_commands: int = 8
    split_max_bytes: int = 256 * 1024
    fuse: bool = True

    def __post_init__(self) -> None:
        if self.batch < 1:
            raise ValueError("batch must be >= 1")
        if self.queues_per_engine < 1:
            raise ValueError("queues_per_engine must be >= 1")


DEFAULT_CONFIG = OptimizationConfig()


def parse_optimized(variant: str) -> tuple[str, bool]:
    """Split an ``opt_``-prefixed variant name (DESIGN.md §7).

    ``"opt_prelaunch_b2b"`` -> ``("prelaunch_b2b", True)``;
    ``"pcpy"`` -> ``("pcpy", False)``.
    """
    if variant.startswith(OPT_PREFIX):
        return variant[len(OPT_PREFIX):], True
    return variant, False


# ------------------------------------------------------------------ §7.1 ----

def batch_commands(schedule: Schedule, batch: int = DEFAULT_CONFIG.batch) -> Schedule:
    """Batched doorbell/command scheduling (DESIGN.md §7.1).

    The host creates and submits ``batch`` commands per scheduling event
    instead of one: the first command of each event pays the full
    ``Calibration.control``, the rest the amortized ``control_batched``, and
    the doorbells of consecutively submitted queues ring back-to-back
    (``doorbell_batched``).  This relieves the serial host-CPU timeline — the
    dominant cost of latency-bound collectives (Fig. 7).

    Prelaunched queues are left untouched: their control/schedule work is
    already off the critical path (§4.5), so there is nothing to amortize.
    """
    if batch < 1:
        raise ValueError("batch must be >= 1")
    queues = tuple(
        q if q.prelaunched or q.batch == batch
        else dataclasses.replace(q, batch=batch)
        for q in schedule.queues)
    return dataclasses.replace(schedule, queues=queues)


# ------------------------------------------------------------------ §7.2 ----

def _splittable(q: EngineQueue, min_commands: int, max_bytes: int) -> bool:
    """A queue is eligible for multi-queue dispatch when it is an independent
    run of data commands (+ trailing untagged completion signals): no
    cross-device ordering (``wait``/tagged ``signal``), not poll-gated,
    long enough for per-slot decode overlap to pay for the extra doorbells
    and completion fences, and issue-bound (small payloads — large commands
    stream long enough to hide the front end on one slot)."""
    if q.prelaunched or q.slot != 0:
        return False
    data = q.data_commands
    if len(data) < max(2, min_commands):
        return False
    if any(c.size > max_bytes for c in data):
        return False
    seen_signal = False
    for c in q.commands:
        if c.kind in (CmdKind.WAIT, CmdKind.POLL, CmdKind.REDUCE,
                      CmdKind.COMPUTE):
            # Reductions order-depend on their interleaved copies: the
            # reduced partial must be forwarded by the NEXT data command,
            # so a reduce stream never slot-splits across the chunk
            # boundary (DESIGN.md §10).  Compute tiles occupy the CU, not
            # an SDMA slot — slot-splitting them is meaningless (§15).
            return False
        if c.kind is CmdKind.SIGNAL:
            if c.tag is not None:
                return False
            seen_signal = True
        elif seen_signal:      # interleaved copy/signal stream: keep as-is
            return False
        if c.fused_tag is not None or c.fused_signal:
            # Already-fused queues are left alone: splitting would add a
            # standalone completion per slot ON TOP of the fused one,
            # inflating the sync phase.  Canonical order is split -> fuse.
            return False
    return True


def split_queues(
    schedule: Schedule,
    queues_per_engine: int = DEFAULT_CONFIG.queues_per_engine,
    *,
    min_commands: int = DEFAULT_CONFIG.split_min_commands,
    max_bytes: int = DEFAULT_CONFIG.split_max_bytes,
) -> Schedule:
    """SDMA queue-level parallelism (DESIGN.md §7.2).

    Spread an engine's data commands round-robin over up to
    ``queues_per_engine`` queue *slots* of the **same** engine.  Each slot
    has its own front end — doorbell, fetch, per-command decode
    (``copy_setup``) — so issue overlaps across slots, while every slot
    still streams through the one shared ``engine:<dev>.<e>`` resource: the
    engine's aggregate bandwidth is never exceeded (asserted in
    ``tests/test_sim.py``).

    Each resulting slot completes independently, so each carries its own
    trailing completion signal when the original queue signaled the host —
    multi-queue dispatch *multiplies* completion signals and doorbells, a
    real cost the dispatch argmin weighs against the front-end overlap (and
    why ``min_commands``/``max_bytes`` gate the transform).  Queues with
    cross-device ordering (``wait``/tagged signals), poll-gated queues,
    queues shorter than ``min_commands`` data commands, and queues carrying
    commands above ``max_bytes`` (stream-bound: the front end is already
    hidden, DESIGN.md §8.1) are left untouched.
    """
    if queues_per_engine < 1:
        raise ValueError("queues_per_engine must be >= 1")
    if queues_per_engine == 1:
        return schedule
    by_hw: dict[tuple, int] = defaultdict(int)
    for q in schedule.queues:
        by_hw[(q.device, q.engine)] += 1

    out: list[EngineQueue] = []
    for q in schedule.queues:
        if by_hw[(q.device, q.engine)] != 1 or not _splittable(q, min_commands, max_bytes):
            out.append(q)
            continue
        data = q.data_commands
        signaled = q.n_signals > 0
        n_slots = min(queues_per_engine, len(data))
        for s in range(n_slots):
            slot_cmds: tuple[Command, ...] = tuple(data[s::n_slots])
            if signaled:
                slot_cmds = slot_cmds + (cmd.signal(),)
            out.append(dataclasses.replace(q, commands=slot_cmds, slot=s))
    return dataclasses.replace(schedule, queues=tuple(out))


# ------------------------------------------------------------------ §7.3 ----

def _fuse_queue(q: EngineQueue) -> EngineQueue:
    fused: list[Command] = []
    for c in q.commands:
        prev = fused[-1] if fused else None
        if c.kind is CmdKind.SIGNAL and prev is not None and prev.kind in DATA_KINDS:
            if c.tag is not None and prev.fused_tag is None:
                fused[-1] = dataclasses.replace(prev, fused_tag=c.tag)
                continue
            if c.tag is None and not prev.fused_signal:
                fused[-1] = dataclasses.replace(prev, fused_signal=True)
                continue
        fused.append(c)
    return dataclasses.replace(q, commands=tuple(fused))


def fuse_signals(schedule: Schedule) -> Schedule:
    """Fused write+signal (DESIGN.md §7.3).

    Collapse every ``signal`` that directly trails a data command into that
    command: the signal payload rides the transfer's final write packet.
    This removes one host scheduling event (one command packet) per step and
    replaces the engine's ``sync_engine`` scheduling round-trip with the
    posted-write delay ``fused_sync``.  Fused *tagged* signals raise their
    semaphore at write completion — ring steps chain without an extra engine
    round.  Fused *untagged* (host-observed) signals still cost the host one
    ``sync_obs`` each; only the engine side gets cheaper.

    Fusion is chunk-granular (DESIGN.md §9): in a chunked stream each
    signal fuses onto the chunk command directly before it, so a
    per-chunk-signaled stream (``copy, signal(tag+chunk), ...``) fuses into
    exactly the per-chunk-tagged commands the pipelined ring builders emit.
    A data command that already carries a fused tag keeps it — a following
    *tagged* signal then stays standalone; a following untagged completion
    still fuses (the two ride different fields of the final write packet).

    Signals that do not directly follow a data command (e.g. the standalone
    completion signal of a wait-only queue) are kept as-is.  The transform is
    idempotent.
    """
    return dataclasses.replace(
        schedule, queues=tuple(_fuse_queue(q) for q in schedule.queues))


# ------------------------------------------------------------- composition ----

def optimize(schedule: Schedule, config: OptimizationConfig | None = None) -> Schedule:
    """Apply the full optimized command stream (DESIGN.md §7).

    Canonical composition order: :func:`split_queues` first (slots must exist
    before their trailing signals can fuse), then :func:`fuse_signals`, then
    :func:`batch_commands`.  The result keeps the schedule's name and its
    ``symmetric`` marking — all three transforms rewrite every device
    identically and never move traffic onto a different directed link, so a
    symmetric schedule stays symmetric (asserted bit-identical in
    ``tests/test_sim.py``).
    """
    cfg = config or DEFAULT_CONFIG
    out = split_queues(schedule, cfg.queues_per_engine,
                       min_commands=cfg.split_min_commands,
                       max_bytes=cfg.split_max_bytes)
    if cfg.fuse:
        out = fuse_signals(out)
    return batch_commands(out, cfg.batch)
