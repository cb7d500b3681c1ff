"""DMA command set modeled after AMD Instinct MI300X sDMA engines (paper §2.2, §4).

A DMA *queue* is an ordered list of commands executed by one engine. The host
(CPU) creates commands (control phase), rings the engine's doorbell (schedule
phase), the engine executes copies (copy phase) and raises completion signals
(sync phase). The novel commands — ``bcst`` (one source, two destinations),
``swap`` (in-place exchange) and ``poll`` (pre-launch trigger) — are the
hitherto-untapped features the paper exploits (Table 1).

Cross-device dependencies (DESIGN.md §2): a ``signal`` may carry a *tag*
``(name, device, step)``; a ``wait`` command blocks its engine until the
tagged signal has been raised (plus the remote-observation latency).  Tagged
signals are engine-to-engine semaphores and are NOT observed by the host;
untagged signals are the host-observed completion signals of the original
model.  Ring/torus schedules are built from these so that step *k* is timed
from the real arrival of step *k-1*'s data rather than assumed overlap.

Optimized command streams (DESIGN.md §7): a data command may carry a *fused*
signal (``fused_signal``/``fused_tag``, §7.3) that rides the transfer's final
write packet instead of occupying a standalone ``signal`` slot, and an
:class:`EngineQueue` records the host submission batch size (``batch``, §7.1)
and its SDMA queue slot on the engine (``slot``, §7.2).  The transforms in
:mod:`repro_torch.core.dma.optimizations` produce these; baseline builders never
set them, so default schedules time identically to the unoptimized model.

Chunking (DESIGN.md §8.1): one sDMA command carries at most
``Calibration.max_chunk_bytes`` of payload, so the runtime splits GB-scale
copies into pipelined chunk commands — :func:`chunk_command` /
:func:`chunk_schedule` model exactly that.  Chunks of one transfer share a
single :class:`Command` instance (the simulator detects such runs by object
identity and executes them closed-form); a fused signal rides only the
*final* chunk.

Per-chunk signaling (DESIGN.md §9): a tag may carry a fourth element — the
*chunk index* — so each chunk of a split transfer raises its own semaphore
(:func:`chunk_tag` / :func:`chunked_copies`) and a consumer can ``wait`` on
chunk *i* instead of the whole transfer.  This is what the pipelined ring
builders in :mod:`repro_torch.core.dma.collectives` use to start forwarding a
shard's first arrived chunk while the rest is still in flight (the
finer-grain overlap direction of arXiv:2512.10236).  Per-chunk tags are
always *fused* (they ride each chunk's final write packet): a standalone
``signal`` per chunk would double the command count and serialize the
engine front end on ``sync_engine`` round-trips.

Per-chunk reduction (DESIGN.md §10): a ``reduce_tag`` command models the
consumer side of a reduce-scatter step — it blocks like a ``wait`` on the
named (chunk) tag, then charges the reduction of ``size`` arrived bytes
(``Calibration.reduce_setup + size / reduce_bytes_per_s``) on the
consumer's engine timeline before the queue may forward the reduced
partial.  An optional ``fused_tag`` raises a semaphore at reduction
completion, which is how the all-reduce builder chains its all-gather
phase off the final reduce chunk by chunk.  :func:`chunk_command` /
:func:`chunk_schedule` split oversized reductions exactly like oversized
copies, and :func:`reduce_work` exposes the schedule-level conservation
invariant (every device of an n-device reduce-scatter performs exactly
``(n-1) * shard_chunks`` chunk reductions).

Compute tiles (DESIGN.md §15): a ``compute`` command occupies the device's
*CU timeline* (``cu:{dev}``) for one GEMM tile —
``Calibration.cu_tile_setup + size / cu_flops`` with ``size`` carrying the
tile's FLOP count.  An optional ``tag`` blocks the tile like a ``wait``
(the all-gather+GEMM fusion: tile *k* launches when shard *k* lands); an
optional ``fused_tag`` raises a semaphore at tile completion (the
GEMM+reduce-scatter fusion: tile *i*'s partial releases the RS chunk
pipeline).  A ``reduce_tag`` may set ``on_cu=True`` to charge its §10
reduction on the CU timeline instead of the consumer's engine — the
reduce-placement axis of arXiv:2512.10236.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

# A signal/wait tag: (name, producer device, step[, chunk]). Waits name the
# exact producer; the symmetric fast path rewrites the producer to the
# representative device (DESIGN.md §6).  The optional fourth element is the
# chunk index of a per-chunk-signaled transfer (DESIGN.md §9).
Tag = tuple


class CmdKind(enum.Enum):
    COPY = "copy"          # one src -> one dst
    BCST = "bcst"          # one src -> two dsts (single source read)
    SWAP = "swap"          # exchange contents of two buffers (in-place)
    POLL = "poll"          # wait until *location* satisfies a condition (prelaunch)
    SIGNAL = "signal"      # atomic inc/dec of a 64b completion signal
    WAIT = "wait"          # block engine until a tagged signal was raised
    REDUCE = "reduce_tag"  # wait on a tagged chunk, then reduce it locally (§10)
    COMPUTE = "compute"    # occupy the CU timeline for one GEMM tile (§15)


@dataclasses.dataclass(frozen=True)
class Command:
    """A single DMA engine command.

    ``src``/``dsts`` are device ids (or "host").  ``size`` is bytes moved per
    destination.  A ``swap`` moves ``size`` bytes in each direction between
    ``src`` and ``dsts[0]``.  ``poll``/``signal``/``wait`` carry no payload.
    ``tag`` names the semaphore a ``signal`` raises / a ``wait`` or
    ``reduce_tag`` blocks on; a tagged signal is engine-scope (not
    host-observed).

    Per-chunk reduction (DESIGN.md §10): a ``reduce_tag`` command carries the
    tag of the arrived chunk it consumes and ``size`` = the bytes it reduces
    on the consumer's engine timeline; an optional ``fused_tag`` raises a
    semaphore at reduction completion (the all-reduce chaining hook).

    Fused signaling (DESIGN.md §7.3): a *data* command may additionally carry
    ``fused_signal=True`` (a host-observed completion rides the final write
    packet — the host still pays one observation per fused completion) and/or
    ``fused_tag`` (an engine-scope semaphore is raised at write completion
    plus ``Calibration.fused_sync`` instead of via a standalone ``signal``
    command costing a ``sync_engine`` scheduling round-trip).
    """

    kind: CmdKind
    src: int | str | None = None
    dsts: tuple[int | str, ...] = ()
    size: int = 0
    tag: Tag | None = None
    fused_tag: Tag | None = None
    fused_signal: bool = False
    on_cu: bool = False     # REDUCE only: run the reduction on the CU (§15)

    def __post_init__(self) -> None:
        if self.kind is CmdKind.COPY and len(self.dsts) != 1:
            raise ValueError("copy needs exactly one destination")
        if self.kind is CmdKind.BCST and len(self.dsts) != 2:
            raise ValueError("bcst needs exactly two destinations")
        if self.kind is CmdKind.SWAP and len(self.dsts) != 1:
            raise ValueError("swap needs exactly one partner")
        if self.kind in (CmdKind.WAIT, CmdKind.REDUCE) and self.tag is None:
            raise ValueError(f"{self.kind.value} needs a tag to block on")
        if self.size < 0:
            raise ValueError(f"negative size {self.size}")
        if self.size == 0 and (self.kind in DATA_KINDS
                               or self.kind is CmdKind.REDUCE
                               or self.kind is CmdKind.COMPUTE):
            raise ValueError(
                f"{self.kind.value} needs a positive size — a zero-byte "
                "transfer would time as a silent no-op")
        if self.fused_signal and self.kind not in DATA_KINDS:
            raise ValueError("only data commands can carry a fused signal")
        if self.fused_tag is not None and self.kind not in DATA_KINDS \
                and self.kind not in (CmdKind.REDUCE, CmdKind.COMPUTE):
            raise ValueError(
                "only data/reduce/compute commands can carry a fused tag")
        if self.on_cu and self.kind is not CmdKind.REDUCE:
            raise ValueError("on_cu selects the REDUCE placement only — "
                             "compute commands always run on the CU")

    # ---- traffic accounting (used by the engine model & power model) ----
    @property
    def n_copies(self) -> int:
        """Equivalent number of vanilla copy operations this command expresses."""
        if self.kind is CmdKind.COPY:
            return 1
        if self.kind is CmdKind.BCST:
            return 2
        if self.kind is CmdKind.SWAP:
            return 2          # one copy each direction
        return 0

    @property
    def local_read_bytes(self) -> int:
        """Bytes read from the issuing device's HBM.

        ``bcst`` reads the source ONCE for both destinations (paper §4.2) —
        this is where its memory-traffic/power saving comes from.  ``swap``
        reads locally and writes locally (in place), plus symmetric remote
        traffic.  A ``reduce_tag`` reads both operands (the arrived chunk
        and the local accumulator) from local HBM (DESIGN.md §10).
        """
        if self.kind in (CmdKind.COPY, CmdKind.BCST, CmdKind.SWAP):
            return self.size
        if self.kind is CmdKind.REDUCE:
            return 2 * self.size
        return 0

    @property
    def remote_write_bytes(self) -> int:
        if self.kind is CmdKind.COPY:
            return self.size
        if self.kind is CmdKind.BCST:
            return 2 * self.size
        if self.kind is CmdKind.SWAP:
            return self.size  # each direction carries `size`; per-link duplex
        return 0


def copy(src, dst, size) -> Command:
    return Command(CmdKind.COPY, src, (dst,), size)


def bcst(src, dst_a, dst_b, size) -> Command:
    return Command(CmdKind.BCST, src, (dst_a, dst_b), size)


def swap(a, b, size) -> Command:
    return Command(CmdKind.SWAP, a, (b,), size)


def poll() -> Command:
    return Command(CmdKind.POLL)


def signal(tag: Tag | None = None) -> Command:
    """Untagged: host-observed completion signal. Tagged: engine semaphore."""
    return Command(CmdKind.SIGNAL, tag=tag)


def wait(tag: Tag) -> Command:
    """Block the engine until the tagged signal has been raised."""
    return Command(CmdKind.WAIT, tag=tag)


def reduce_tag(tag: Tag, size: int, raise_tag: Tag | None = None, *,
               on_cu: bool = False) -> Command:
    """Per-chunk reduction (DESIGN.md §10): block on ``tag`` like a
    ``wait``, then reduce the ``size`` arrived bytes into the local
    accumulator on the consumer's engine timeline.  ``raise_tag`` raises a
    semaphore at reduction completion (how the all-reduce builder releases
    its all-gather phase chunk by chunk).  ``on_cu=True`` moves the
    reduction onto the device's CU timeline (§15's placement axis): same
    accumulate cost, but it contends with GEMM tiles instead of with the
    engine's forwarding copies."""
    return Command(CmdKind.REDUCE, size=size, tag=tag, fused_tag=raise_tag,
                   on_cu=on_cu)


def compute(flops: int, tag: Tag | None = None,
            raise_tag: Tag | None = None) -> Command:
    """One GEMM tile on the device's CU timeline (DESIGN.md §15):
    ``Calibration.cu_tile_setup + flops / cu_flops`` of CU occupancy.
    ``tag`` (optional) blocks the tile like a ``wait`` until the named
    chunk lands; ``raise_tag`` raises a semaphore at tile completion."""
    return Command(CmdKind.COMPUTE, size=flops, tag=tag, fused_tag=raise_tag)


DATA_KINDS = (CmdKind.COPY, CmdKind.BCST, CmdKind.SWAP)

#: Kinds that carry a per-command payload bounded by the sDMA packet ceiling
#: (DESIGN.md §8.1/§10): data commands AND consumer-side reductions — a
#: reduction is re-sliced at the same granularity as the copies feeding it,
#: which is what keeps reduction-work conservation chunk-invariant.
CHUNKABLE_KINDS = DATA_KINDS + (CmdKind.REDUCE,)


def chunk_command(c: Command, max_bytes: int) -> tuple[Command, ...]:
    """Split one data/reduce command into bounded-size chunk commands
    (DESIGN.md §8.1/§10).

    A copy/bcst/swap/reduce of more than ``max_bytes`` becomes ``ceil(size /
    max_bytes)`` commands of the same kind/source/destinations: full-size
    chunks followed by one remainder chunk.  The full-size chunks all share
    ONE ``Command`` instance — the simulator recognizes such identical runs
    by object identity and schedules them in closed form.  Any fused signal
    of the original command rides only the final chunk (the semaphore /
    completion may not be raised before the last byte landed / the last
    chunk was reduced).  A split ``reduce_tag`` keeps its wait tag on every
    chunk: transfer-granularity producers raise one tag for the whole
    transfer, so each chunk reduction blocks on the same semaphore.
    ``compute`` commands are never split — a GEMM tile is the unit the
    fused builders already sized to the chunk grain (DESIGN.md §15).

    Other commands and commands already within ``max_bytes`` are returned
    unchanged; ``max_bytes <= 0`` disables chunking.
    """
    if c.kind not in CHUNKABLE_KINDS or max_bytes <= 0 or c.size <= max_bytes:
        return (c,)
    n_full, rem = divmod(c.size, max_bytes)
    body = Command(c.kind, c.src, c.dsts, max_bytes, tag=c.tag)
    chunks: list[Command] = [body] * n_full
    if rem:
        chunks.append(Command(c.kind, c.src, c.dsts, rem, tag=c.tag))
    if c.fused_tag is not None or c.fused_signal:
        chunks[-1] = dataclasses.replace(
            chunks[-1], fused_tag=c.fused_tag, fused_signal=c.fused_signal)
    return tuple(chunks)


def chunk_tag(tag: Tag, chunk: int) -> Tag:
    """The chunk-granularity tag of chunk ``chunk`` of transfer ``tag``
    (DESIGN.md §9): the transfer tag with the chunk index appended."""
    return tuple(tag) + (chunk,)


def tag_name(tag: Tag) -> object:
    """The semantic name of a (possibly composition-namespaced) tag: the
    first string element — composed runs prefix the schedule index
    (DESIGN.md §12), so the name is not always element 0."""
    for e in tag:
        if isinstance(e, str):
            return e
    return tag[0] if tag else None


def tag_chunk(tag: Tag) -> int | None:
    """The chunk index of a chunk-granularity tag, or ``None``.

    Inverse of :func:`chunk_tag` under the tag convention
    ``(name, producer_device, step[, chunk])`` with an optional leading
    schedule-namespace prefix (§12): the element three past the name, when
    present and integral, is the chunk index."""
    for i, e in enumerate(tag):
        if isinstance(e, str):
            j = i + 3
            if len(tag) > j and isinstance(tag[j], int):
                return tag[j]
            return None
    return None


def chunk_sizes(size: int, granularity: int) -> tuple[int, ...]:
    """Byte sizes of the chunks a ``size``-byte transfer splits into:
    full ``granularity`` chunks followed by one remainder chunk.
    ``granularity <= 0`` (chunking disabled) yields the whole transfer."""
    if granularity <= 0 or size <= granularity:
        return (size,)
    n_full, rem = divmod(size, granularity)
    return (granularity,) * n_full + ((rem,) if rem else ())


def chunked_copies(kind: CmdKind, src, dsts, size: int, granularity: int,
                   tag: Tag | None = None, *,
                   per_chunk: bool = True) -> tuple[Command, ...]:
    """Chunk commands of one data transfer with chunk-granularity signaling
    (DESIGN.md §9).

    Splits a ``size``-byte transfer of ``kind`` into
    :func:`chunk_sizes`-many commands.  With ``per_chunk=True`` chunk ``i``
    carries ``fused_tag=chunk_tag(tag, i)`` — its semaphore rides the
    chunk's final write packet, so a consumer waiting on
    ``chunk_tag(tag, i)`` starts as soon as *that chunk* landed.  With
    ``per_chunk=False`` only the final chunk raises its (chunk-indexed)
    tag — the final-chunk-only signaling of :func:`chunk_command`, kept as
    the control arm of the pipelined-vs-serial claims.  ``tag=None`` emits
    untagged chunks.

    Per-chunk-tagged chunks are distinct ``Command`` instances (their tags
    differ); the simulator recognizes such *equivalent-modulo-tag* runs and
    still schedules them in closed form (DESIGN.md §9.2).  Untagged chunks
    of one size share a single instance, exactly like
    :func:`chunk_command`, so the final-chunk-only control arm keeps the
    §8.3 identity-run fast path.
    """
    if kind not in DATA_KINDS:
        raise ValueError("chunked_copies needs a data command kind")
    sizes = chunk_sizes(size, granularity)
    last = len(sizes) - 1
    out = []
    untagged: dict[int, Command] = {}
    for i, sz in enumerate(sizes):
        if tag is not None and (per_chunk or i == last):
            out.append(Command(kind, src, tuple(dsts), sz,
                               fused_tag=chunk_tag(tag, i)))
            continue
        c = untagged.get(sz)
        if c is None:
            c = untagged[sz] = Command(kind, src, tuple(dsts), sz)
        out.append(c)
    return tuple(out)


def chunked_reduces(src_tag: Tag, size: int, granularity: int, *,
                    per_chunk: bool = True,
                    raise_tag: Tag | None = None,
                    on_cu: bool = False) -> tuple[Command, ...]:
    """Per-chunk reductions consuming one chunk-tagged transfer (DESIGN.md
    §10).

    Emits one ``reduce_tag`` command per :func:`chunk_sizes` chunk of a
    ``size``-byte transfer.  With ``per_chunk=True`` chunk ``i``'s
    reduction blocks on ``chunk_tag(src_tag, i)`` — it starts the moment
    that chunk lands; with ``per_chunk=False`` every chunk reduction blocks
    on the producer's *final* chunk tag (the serialized control arm of the
    §10 claims).  Either arm performs the same reduction work — one
    reduce command per chunk — so reduction-work conservation is
    signaling-grain-invariant.  ``raise_tag`` tags each chunk's reduction
    completion with ``chunk_tag(raise_tag, i)`` (all-reduce chaining);
    ``on_cu`` selects the §15 CU placement for every chunk reduction.
    """
    sizes = chunk_sizes(size, granularity)
    last = len(sizes) - 1
    out = []
    for i, sz in enumerate(sizes):
        w = i if per_chunk else last
        rt = chunk_tag(raise_tag, i) if raise_tag is not None else None
        out.append(reduce_tag(chunk_tag(src_tag, w), sz, rt, on_cu=on_cu))
    return tuple(out)


def reduce_work(schedule: "Schedule") -> dict[int, tuple[int, int]]:
    """device -> (chunk reductions, total reduced bytes).

    The reduction-work conservation invariant (DESIGN.md §10): in an
    n-device reduce-scatter every device reduces exactly ``n - 1`` shards
    — ``(n - 1) * shard_chunks`` chunk reductions — whatever the variant,
    chunk granularity, pipeline depth or signaling grain.
    """
    out: dict[int, tuple[int, int]] = {}
    for q in schedule.queues:
        for c in q.commands:
            if c.kind is CmdKind.REDUCE:
                n, b = out.get(q.device, (0, 0))
                out[q.device] = (n + 1, b + c.size)
    return out


def chunk_schedule(schedule: "Schedule", max_chunk_bytes: int) -> "Schedule":
    """Chunk every oversized data/reduce command of a schedule (DESIGN.md
    §8.1/§10).

    Applied by the collective builders with the topology's calibrated
    ``max_chunk_bytes`` before the optimization transforms, so §7.1 batching
    amortizes the per-chunk packet creation, §7.2 slots overlap the chunks'
    front-end decode, and §7.3 fuses the trailing signal onto the final
    chunk.  Preserves the traffic multiset, command order, queue attributes
    and the ``symmetric`` marking (every device is rewritten identically).
    """
    if max_chunk_bytes <= 0:
        return schedule
    queues = []
    changed = False
    for q in schedule.queues:
        if all(c.size <= max_chunk_bytes for c in q.commands
               if c.kind in CHUNKABLE_KINDS):
            queues.append(q)
            continue
        cs: list[Command] = []
        for c in q.commands:
            cs.extend(chunk_command(c, max_chunk_bytes))
        queues.append(dataclasses.replace(q, commands=tuple(cs)))
        changed = True
    if not changed:
        return schedule
    return dataclasses.replace(schedule, queues=tuple(queues))


@dataclasses.dataclass(frozen=True)
class EngineQueue:
    """Ordered commands bound to one SDMA queue of one device.

    ``(engine, slot)`` identifies the hardware queue: every engine exposes
    several independent queue slots (DESIGN.md §7.2) that each keep their own
    doorbell and command decode/issue stage, while sharing the engine's
    queue-read port (fetches serialize on the engine) and its streaming
    bandwidth.  Baseline builders leave ``slot=0`` (one queue per engine);
    the multi-queue transform spreads a queue's data commands over
    additional slots of the *same* engine.

    ``batch`` is the host submission batch size (§7.1): the host creates this
    queue's command packets in groups of ``batch`` per scheduling event,
    paying the full per-command ``control`` cost once per group and the
    amortized ``control_batched`` cost for the rest.  ``batch=1`` is the
    baseline one-event-per-command behavior.
    """

    device: int
    engine: int
    commands: tuple[Command, ...]
    prelaunched: bool = False   # queue was enqueued ahead of time, gated by a poll
    slot: int = 0               # SDMA queue slot on the engine (§7.2)
    batch: int = 1              # host submission batch size (§7.1)

    def __post_init__(self) -> None:
        if self.prelaunched and (not self.commands or self.commands[0].kind is not CmdKind.POLL):
            raise ValueError("a prelaunched queue must start with a poll command")
        if self.batch < 1:
            raise ValueError("batch size must be >= 1")
        if self.slot < 0:
            raise ValueError("negative queue slot")

    @property
    def data_commands(self) -> tuple[Command, ...]:
        return tuple(c for c in self.commands if c.kind in DATA_KINDS)

    @property
    def n_signals(self) -> int:
        """Host-observed completion signals (tagged signals are engine-scope;
        fused completion signals count — they still notify the host)."""
        return sum(1 for c in self.commands
                   if (c.kind is CmdKind.SIGNAL and c.tag is None) or c.fused_signal)


def link_traffic(schedule: "Schedule") -> dict[tuple, int]:
    """(src, dst) -> total payload bytes over all data commands.

    The schedule-level traffic invariant: chunking (§8.1), per-chunk
    signaling and pipeline depth (§9) only re-slice commands, so this map
    is identical across granularities of one variant.  ``swap`` moves
    ``size`` bytes in each direction, so it contributes to both ordered
    pairs; ``bcst`` contributes ``size`` to each destination.
    """
    out: dict[tuple, int] = {}
    for q in schedule.queues:
        for c in q.data_commands:
            for dst in c.dsts:
                out[(c.src, dst)] = out.get((c.src, dst), 0) + c.size
            if c.kind is CmdKind.SWAP:
                key = (c.dsts[0], c.src)
                out[key] = out.get(key, 0) + c.size
    return out


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A full offload schedule: every engine queue across all devices.

    ``symmetric`` is the builder's promise that every device runs the same
    program modulo device relabeling AND that no two devices contend for the
    same directed link — which lets the simulator run one representative
    device and replicate the result (DESIGN.md §6).
    """

    name: str
    queues: tuple[EngineQueue, ...]
    symmetric: bool = False

    def queues_for(self, device: int) -> list[EngineQueue]:
        return [q for q in self.queues if q.device == device]

    @property
    def devices(self) -> list[int]:
        return sorted({q.device for q in self.queues})

    def total_commands(self, device: int | None = None) -> int:
        qs = self.queues if device is None else self.queues_for(device)
        return sum(len(q.commands) for q in qs)

    def engines_used(self, device: int) -> int:
        return len({q.engine for q in self.queues_for(device)})
