"""Deterministic fault injection for the DMA simulator (DESIGN.md §13).

The fault-free simulator models a world where every doorbell rings, every
semaphore raises and every link runs at nominal bandwidth.  Production
collective libraries must survive straggler engines, delayed signals and
degraded links — this module is the seeded, reproducible model of that
world, threaded through the event loop by ``simulate(..., faults=...)`` /
``run_composed(..., faults=...)``:

* :class:`Straggler` — a device (optionally one engine of it) whose data
  commands stream ``slowdown``× slower (a thermally-throttled or
  firmware-degraded sDMA engine).
* :class:`LinkDerate` — a windowed bandwidth derate of one wire resource
  (``link:{a}>{b}``, ``hostlink:{dev}:{dirn}`` or ``nic:{dev}``): transfers
  granted inside ``[start, end)`` run at ``factor`` of nominal bandwidth.
* :class:`NicFlap` — an outage window of one device's NIC: cross-node
  transfers requesting the NIC inside ``[start, end)`` are held until the
  flap clears (link-level retransmit, invisible to the command layer).
* Signal faults — every *tagged* raise (engine-scope semaphores: tagged
  ``signal`` commands and fused per-chunk tags) draws from a seeded,
  order-independent hash stream: with probability ``drop_rate`` the raise
  is lost (the doorbell that never rang), with ``delay_rate`` it lands
  ``delay_s`` late.  ``drop_tags`` names tag *names* whose first raise is
  always dropped — the deterministic handle the retry tests use.

Determinism (§13.1): every stochastic decision is a pure function of
``(seed, kind, tag, attempt)`` — a blake2b draw, independent of event-loop
iteration order and process hashing — so a fault run is reproducible from
the plan alone, and two plans differing only in ``seed`` decorrelate.  An
empty plan is *normalized away* by the simulator entry points: the
fault-free code path runs untouched and the results are bit-identical to
``simulate()`` with no plan at all (property-tested in
``tests/test_faults.py``).

Watchdog/retry semantics (§13.2) live in the event loop (``sim.py``): a
queue parked on a tag whose raise was dropped is recovered by re-issuing
the producing command after a watchdog timeout with exponential backoff
(``watchdog_s``, ``backoff``), costs charged on the real host/engine/link
timelines, at most ``max_attempts`` total attempts per tag; exhaustion
raises :class:`SimFault` carrying the full blocked-dependency diagnosis
(:class:`BlockedWaiter` rows + :class:`RetryRecord` history).
"""
from __future__ import annotations

import dataclasses
import hashlib

from .commands import tag_name

_INF = float("inf")

#: Wire-resource prefixes a :class:`LinkDerate` may target (the simulator's
#: timeline vocabulary, DESIGN.md §2/§11).
_WIRE_PREFIXES = ("link:", "hostlink:", "nic:")


def _tag_name(tag: tuple) -> object:
    """The semantic name of a (possibly composition-namespaced) tag: the
    first string element — composed runs prefix the schedule index (§12).
    Shared with the trace layer via :func:`repro_torch.core.dma.commands.tag_name`."""
    return tag_name(tag)


def resource_device(key: str) -> int | None:
    """Device owning a wire resource key (the *sender* for links and NICs),
    or ``None`` for keys that name no device (e.g. ``host:{d}`` is not a
    wire).  Used to map live fault state onto admission decisions
    (DESIGN.md §13.4)."""
    if key.startswith("link:"):
        return int(key[5:].split(">", 1)[0])
    if key.startswith("hostlink:"):
        return int(key.split(":")[1])
    if key.startswith("nic:"):
        return int(key.split(":")[1])
    return None


@dataclasses.dataclass(frozen=True)
class Straggler:
    """One device's engines stream ``slowdown``× slower (``engine=None``
    covers every engine of the device)."""

    device: int
    engine: int | None = None
    slowdown: float = 4.0

    def __post_init__(self) -> None:
        if not self.slowdown >= 1.0:
            raise ValueError(
                f"straggler slowdown must be >= 1, got {self.slowdown}")


@dataclasses.dataclass(frozen=True)
class LinkDerate:
    """Bandwidth derate window of one wire resource: transfers granted in
    ``[start, end)`` run at ``factor`` (0 < factor <= 1) of nominal."""

    resource: str
    factor: float
    start: float = 0.0
    end: float = _INF

    def __post_init__(self) -> None:
        if not any(self.resource.startswith(p) for p in _WIRE_PREFIXES):
            raise ValueError(
                f"derate resource must be a wire key ({'/'.join(_WIRE_PREFIXES)}"
                f"...), got {self.resource!r}")
        if not 0.0 < self.factor <= 1.0:
            raise ValueError(f"derate factor must be in (0, 1], got {self.factor}")
        if self.end < self.start:
            raise ValueError(f"derate window end {self.end} < start {self.start}")


@dataclasses.dataclass(frozen=True)
class NicFlap:
    """Outage window of one device's NIC: transfers requesting ``nic:{device}``
    inside ``[start, end)`` are held until ``end``."""

    device: int
    start: float
    end: float

    def __post_init__(self) -> None:
        if self.end < self.start:
            raise ValueError(f"flap window end {self.end} < start {self.start}")


@dataclasses.dataclass(frozen=True)
class RetryRecord:
    """One watchdog-driven re-issue of a dropped signal's producer (§13.2).

    ``attempt`` counts from 1 (the original, dropped raise is attempt 0);
    ``issued_at`` is the watchdog expiry the retry was charged from,
    ``completed_at`` the re-issued command's completion, and ``raised``
    whether the re-raise survived its own fault draw."""

    tag: tuple
    attempt: int
    issued_at: float
    completed_at: float
    raised: bool


@dataclasses.dataclass(frozen=True)
class FaultReport:
    """What the fault layer did to one run (``SimResult.fault_report``).

    ``dropped``/``delayed`` list the tags whose raise was lost/delayed
    (sorted, deterministic); ``retries`` is the chronological watchdog
    retry history; ``retry_seconds`` the total wall charged to retries
    (watchdog expiry -> re-raise) across the run."""

    dropped: tuple[tuple, ...] = ()
    delayed: tuple[tuple, ...] = ()
    retries: tuple[RetryRecord, ...] = ()
    retry_seconds: float = 0.0

    @property
    def recovered(self) -> int:
        """Dropped tags eventually re-raised by a successful retry."""
        return sum(1 for r in self.retries if r.raised)


@dataclasses.dataclass(frozen=True)
class BlockedWaiter:
    """One parked queue in a :class:`SimFault` diagnosis: who waits, on
    what, who should have produced it, and the nearest tag that *was*
    raised with the same name (the off-by-one breadcrumb)."""

    device: int
    engine: int
    tag: tuple
    producer: str | None
    nearest: tuple | None


class SimFault(RuntimeError):
    """Structured deadlock/fault report (DESIGN.md §13.3).

    Raised when the event loop drains with parked waiters left and no
    retryable dropped signal remains — either a genuine schedule deadlock
    (fault-free path included) or retry exhaustion under a
    :class:`FaultPlan`.  Subclasses ``RuntimeError`` and keeps
    ``"deadlock"`` in the message so historical handlers keep working;
    ``waiters`` (sorted :class:`BlockedWaiter` rows) and ``retries`` (the
    watchdog history) carry the machine-readable diagnosis."""

    def __init__(self, message: str,
                 waiters: tuple[BlockedWaiter, ...] = (),
                 retries: tuple[RetryRecord, ...] = ()) -> None:
        super().__init__(message)
        self.waiters = waiters
        self.retries = retries


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic set of faults to inject into one run.

    ``drop_rate``/``delay_rate`` apply per tagged raise (independent draws
    from the ``seed``-keyed hash stream); ``drop_tags`` names tag *names*
    whose first raise is always dropped.  ``watchdog_s`` is the base wait
    before a parked queue's producer is re-issued, growing by ``backoff``×
    per failed attempt, up to ``max_attempts`` total attempts (the original
    raise included) before :class:`SimFault`.  An empty plan (``is_empty``)
    is normalized to ``None`` by the simulator entry points, making the
    no-fault identity structural rather than numerical.
    """

    stragglers: tuple[Straggler, ...] = ()
    link_derates: tuple[LinkDerate, ...] = ()
    nic_flaps: tuple[NicFlap, ...] = ()
    drop_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 20e-6
    drop_tags: tuple[str, ...] = ()
    seed: int = 0
    watchdog_s: float = 50e-6
    max_attempts: int = 3
    backoff: float = 2.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.drop_rate <= 1.0:
            raise ValueError(f"drop_rate must be in [0, 1], got {self.drop_rate}")
        if not 0.0 <= self.delay_rate <= 1.0:
            raise ValueError(f"delay_rate must be in [0, 1], got {self.delay_rate}")
        if self.delay_s < 0.0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        if self.watchdog_s <= 0.0:
            raise ValueError(f"watchdog_s must be > 0, got {self.watchdog_s}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        # Precomputed lookup maps (not fields: eq/hash stay value-based).
        slow: dict[tuple[int, int | None], float] = {}
        for s in self.stragglers:
            k = (s.device, s.engine)
            slow[k] = max(slow.get(k, 1.0), s.slowdown)
        derates: dict[str, list[LinkDerate]] = {}
        for d in self.link_derates:
            derates.setdefault(d.resource, []).append(d)
        flaps: dict[str, list[NicFlap]] = {}
        for f in self.nic_flaps:
            flaps.setdefault(f"nic:{f.device}", []).append(f)
        object.__setattr__(self, "_slow", slow)
        object.__setattr__(self, "_derates", derates)
        object.__setattr__(self, "_flaps", flaps)

    # ------------------------------------------------------------ queries ----
    def is_empty(self) -> bool:
        """True when this plan injects nothing — the simulator then runs the
        untouched fault-free path (the §13.1 no-fault identity)."""
        return (not self.stragglers and not self.link_derates
                and not self.nic_flaps and self.drop_rate == 0.0
                and self.delay_rate == 0.0 and not self.drop_tags)

    def engine_slowdown(self, device: int, engine: int) -> float:
        """Streaming slowdown factor of one engine (>= 1)."""
        s = self._slow
        if not s:
            return 1.0
        f = s.get((device, engine), 1.0)
        g = s.get((device, None), 1.0)
        return f if f > g else g

    def derate_factor(self, resource: str, t: float) -> float:
        """Available bandwidth fraction of a wire at time ``t`` (<= 1)."""
        ds = self._derates.get(resource)
        if not ds:
            return 1.0
        f = 1.0
        for d in ds:
            if d.start <= t < d.end and d.factor < f:
                f = d.factor
        return f

    def outage_release(self, resource: str, t: float) -> float:
        """Earliest time a transfer requesting ``resource`` at ``t`` may
        start (NIC flaps hold requests until the window clears)."""
        fs = self._flaps.get(resource)
        if not fs:
            return t
        moved = True
        while moved:            # windows may chain back-to-back
            moved = False
            for f in fs:
                if f.start <= t < f.end:
                    t = f.end
                    moved = True
        return t

    def shifted(self, dt: float) -> "FaultPlan":
        """This plan expressed in a time frame whose origin is ``dt`` later:
        every derate/flap window moves earlier by ``dt``.  The serving loop
        (DESIGN.md §13.4) uses it to map workload-absolute fault windows
        into each composed round's local frame (round release times are
        offsets from the round start).  Stragglers and the signal draws are
        time-invariant and pass through; returns ``self`` when nothing is
        windowed."""
        if dt == 0.0 or (not self.link_derates and not self.nic_flaps):
            return self
        return dataclasses.replace(
            self,
            link_derates=tuple(
                dataclasses.replace(d, start=d.start - dt, end=d.end - dt)
                for d in self.link_derates),
            nic_flaps=tuple(
                dataclasses.replace(f, start=f.start - dt, end=f.end - dt)
                for f in self.nic_flaps))

    def waitable_degraded(self, t: float = 0.0) -> frozenset[int]:
        """Devices whose degradation at ``t`` is an outage window that will
        *clear* — a finite-end derate or a NIC flap.  This is the set the
        ``defer`` admission policy steers around (DESIGN.md §13.4): pushing
        a launch past a transient outage trades a bounded wait for full-rate
        service.  Permanent degradation (stragglers, unbounded derates) is
        deliberately excluded — a request's KV home is pinned, so deferring
        it would starve the request without ever finding healthier hardware;
        riding through at degraded rate strictly dominates."""
        out = set()
        for key, ds in self._derates.items():
            if any(d.start <= t < d.end and d.end < _INF for d in ds):
                dev = resource_device(key)
                if dev is not None:
                    out.add(dev)
        for key, fs in self._flaps.items():
            if any(f.start <= t < f.end for f in fs):
                out.add(resource_device(key))
        return frozenset(out)

    def degraded_devices(self, t: float = 0.0) -> frozenset[int]:
        """Devices with live fault state at time ``t``: straggler devices
        (time-invariant) plus owners of a derated wire or flapping NIC whose
        window contains ``t``.  The ``defer`` admission policy consults this
        (DESIGN.md §13.4)."""
        out = {d for d, _ in self._slow}
        for key, ds in self._derates.items():
            if any(d.start <= t < d.end for d in ds):
                dev = resource_device(key)
                if dev is not None:
                    out.add(dev)
        for key, fs in self._flaps.items():
            if any(f.start <= t < f.end for f in fs):
                out.add(resource_device(key))
        return frozenset(out)

    # -------------------------------------------------------- signal draws ----
    def _draw(self, kind: str, tag: tuple, attempt: int) -> float:
        """Uniform [0, 1) draw, a pure function of (seed, kind, tag, attempt)
        — order-independent and stable across processes (blake2b, not
        ``hash()``), so fault runs replay from the seed alone (§13.1)."""
        payload = repr((self.seed, kind, tag, attempt)).encode()
        h = hashlib.blake2b(payload, digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def drops_signal(self, tag: tuple, attempt: int) -> bool:
        """Whether this raise of ``tag`` (attempt 0 = the original) is lost."""
        if attempt == 0 and self.drop_tags \
                and _tag_name(tag) in self.drop_tags:
            return True
        return (self.drop_rate > 0.0
                and self._draw("drop", tag, attempt) < self.drop_rate)

    def delays_signal(self, tag: tuple, attempt: int) -> bool:
        """Whether this raise of ``tag`` lands ``delay_s`` late."""
        return (self.delay_rate > 0.0
                and self._draw("delay", tag, attempt) < self.delay_rate)


def straggler_plan(device: int = 0, slowdown: float = 4.0,
                   engine: int | None = None, **kwargs) -> FaultPlan:
    """The canonical one-straggler scenario (claims/benchmarks)."""
    return FaultPlan(stragglers=(Straggler(device, engine, slowdown),), **kwargs)
