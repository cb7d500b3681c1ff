"""Span recording and Chrome trace-event export (DESIGN.md §14).

The event loop in :mod:`repro_torch.core.dma.sim` computes every command's grant
and completion on every contended resource, then collapses them into
coalesced busy intervals.  This module keeps the per-command view: an
opt-in :class:`TraceRecorder` (``simulate(..., record_trace=True)`` /
``run_composed(..., record_trace=True)``) captures one span per command
execution — device, resource track, kind, tag, size, chunk index,
schedule namespace, fault/retry annotations — plus a flow arrow from each
tagged raise to every wait it wakes, and :func:`chrome_trace` renders the
result as Chrome ``trace_event`` JSON (the format ``ui.perfetto.dev`` and
``chrome://tracing`` load):

  * one *process* per device, one *thread* per resource
    (``host:{d}``, ``engine:{d}.{e}``, ``hostlink:{d}:{dir}``,
    ``link:{a}>{b}``, ``nic:{d}`` — links/NICs belong to the sender);
  * ``ph:"X"`` complete slices for every positive-duration command span;
  * zero-duration events (a wait whose tag already arrived, a
    zero-cost grant) are deliberately synthesized as ``ph:"i"`` instant
    events — never dropped — so span counts reconcile with the
    ``host_events``/``engine_atomics`` counters (property-tested);
  * ``ph:"s"``/``ph:"f"`` flow arrows from a raise to the waits it wakes;
  * fault windows (link derates, NIC flaps, stragglers) and
    dropped/delayed signals as instant events.

Recording forces the full event loop: the symmetric fast path (§6) and
the closed-form chunk runs (§8.3/§9.2) commit O(1) timeline updates and
would skip per-command spans, so a traced run disables them — timing is
bit-identical to the unrecorded run by the same invariants that license
those fast paths (asserted in ``tests/test_trace.py`` and by the
``benchmarks/trace_export.py`` exporter).  ``record_trace=False`` leaves
the hot path structurally untouched (``sim_perf --check`` guards the
wall-clock ratio).
"""
from __future__ import annotations

import dataclasses
import json

from .commands import tag_chunk, tag_name
from .faults import FaultPlan, resource_device


@dataclasses.dataclass(frozen=True)
class TraceSpan:
    """One command execution on one resource track (positive duration)."""

    resource: str               # timeline key, e.g. "engine:0.1", "link:0>1"
    device: int                 # owning device (sender for wires)
    schedule: int               # composition namespace index (0 for simulate)
    kind: str                   # control|doorbell|fetch|copy|bcst|swap|wire|
                                # wait|reduce|signal|sync
    start: float
    end: float
    tag: tuple | None = None
    size: int | None = None
    chunk: int | None = None
    retry: bool = False         # charged by the watchdog re-issue (§13.2)
    args: dict | None = None

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class TraceInstant:
    """A zero-duration occurrence: zero-cost command spans (synthesized,
    never dropped), prelaunch arming, dropped/delayed signals, fault
    windows."""

    resource: str
    device: int
    schedule: int
    kind: str
    time: float
    tag: tuple | None = None
    args: dict | None = None


@dataclasses.dataclass(frozen=True)
class TraceFlow:
    """One raise-to-wait dependency edge (rendered as a flow arrow)."""

    id: int
    tag: tuple
    src_resource: str
    src_time: float             # the raise (visibility time, delays included)
    dst_resource: str
    dst_time: float             # the woken wait's end (signal arrival)


@dataclasses.dataclass(frozen=True)
class SimTrace:
    """Everything one recorded run captured (``SimResult.trace``)."""

    spans: tuple[TraceSpan, ...]
    instants: tuple[TraceInstant, ...]
    flows: tuple[TraceFlow, ...]


class TraceRecorder:
    """Collects spans/instants/flows from one event-loop run.

    The simulator calls these hooks only when tracing was requested
    (``if tr is not None`` at every site), so the unrecorded path stays
    structurally untouched.  ``_ctx`` carries the issuing command's
    metadata into :meth:`wire`, which fires per route hop inside
    ``_Sim.transfer`` where the command is out of scope.
    """

    __slots__ = ("spans", "instants", "flows", "_raises", "_fid", "_ctx")

    def __init__(self) -> None:
        self.spans: list[TraceSpan] = []
        self.instants: list[TraceInstant] = []
        self.flows: list[TraceFlow] = []
        self._raises: dict[tuple, tuple[float, str]] = {}
        self._fid = 0
        self._ctx: tuple = (0, 0, None, None, False)

    # ------------------------------------------------------------ record ----
    def span(self, resource: str, device: int, schedule: int, kind: str,
             start: float, end: float, *, tag: tuple | None = None,
             size: int | None = None, chunk: int | None = None,
             retry: bool = False, args: dict | None = None) -> None:
        """Record one command execution; zero-duration spans become
        instant events (the §14 zero-duration policy)."""
        if end > start:
            self.spans.append(TraceSpan(resource, device, schedule, kind,
                                        start, end, tag=tag, size=size,
                                        chunk=chunk, retry=retry, args=args))
        else:
            self.instants.append(TraceInstant(resource, device, schedule,
                                              kind, start, tag=tag, args=args))

    def instant(self, resource: str, device: int, schedule: int, kind: str,
                time: float, *, tag: tuple | None = None,
                args: dict | None = None) -> None:
        self.instants.append(TraceInstant(resource, device, schedule, kind,
                                          time, tag=tag, args=args))

    def set_ctx(self, device: int, schedule: int, size: int | None,
                chunk: int | None, retry: bool) -> None:
        """Stash the issuing command's metadata for the wire hops its
        transfers will occupy."""
        self._ctx = (device, schedule, size, chunk, retry)

    def wire(self, resource: str, start: float, end: float) -> None:
        """One route hop's wire occupancy (called from ``_Sim.transfer``)."""
        device, schedule, size, chunk, retry = self._ctx
        self.span(resource, device, schedule, "wire", start, end,
                  size=size, chunk=chunk, retry=retry)

    def raise_tag(self, tag: tuple, time: float, resource: str) -> None:
        """A tagged semaphore became visible to waiters at ``time``."""
        self._raises[tag] = (time, resource)

    def wait(self, resource: str, device: int, schedule: int,
             start: float, end: float, tag: tuple) -> None:
        """A satisfied wait/reduce-block on ``tag`` (span from the engine
        reaching the wait to signal arrival) plus its flow edge."""
        self.span(resource, device, schedule, "wait", start, end,
                  tag=tag, chunk=tag_chunk(tag))
        src = self._raises.get(tag)
        if src is not None:
            t0, res0 = src
            self.flows.append(TraceFlow(self._fid, tag, res0, t0,
                                        resource, end))
            self._fid += 1

    def fault_windows(self, plan: FaultPlan) -> None:
        """Materialize the plan's declared fault state as instant events:
        a window start/end pair per derate and flap, one marker per
        straggler (§13 → §14)."""
        for d in plan.link_derates:
            dev = resource_device(d.resource) or 0
            self.instant(d.resource, dev, 0, "fault", d.start,
                         args={"fault": "derate", "factor": d.factor,
                               "start": d.start, "end": d.end})
            if d.end != float("inf"):
                self.instant(d.resource, dev, 0, "fault", d.end,
                             args={"fault": "derate_end", "factor": d.factor})
        for f in plan.nic_flaps:
            res = f"nic:{f.device}"
            self.instant(res, f.device, 0, "fault", f.start,
                         args={"fault": "flap", "start": f.start,
                               "end": f.end})
            self.instant(res, f.device, 0, "fault", f.end,
                         args={"fault": "flap_end"})
        for s in plan.stragglers:
            e = 0 if s.engine is None else s.engine
            self.instant(f"engine:{s.device}.{e}", s.device, 0, "fault", 0.0,
                         args={"fault": "straggler", "slowdown": s.slowdown,
                               "all_engines": s.engine is None})

    def finish(self) -> SimTrace:
        return SimTrace(spans=tuple(self.spans),
                        instants=tuple(self.instants),
                        flows=tuple(self.flows))


# ------------------------------------------------------------------------- #
# Chrome trace-event rendering                                              #
# ------------------------------------------------------------------------- #

_US = 1e6                        # simulator seconds -> trace microseconds


def _track_device(resource: str) -> int:
    """Owning device of a resource key (sender for wires)."""
    head, _, rest = resource.partition(":")
    if head == "host":
        return int(rest)
    if head == "engine":
        return int(rest.split(".", 1)[0])
    if head == "cu":
        return int(rest)
    dev = resource_device(resource)
    return 0 if dev is None else dev


def _track_rank(resource: str) -> tuple:
    """Stable thread ordering inside a device: host, engines, CUs, host
    links, DMA links, NIC."""
    order = {"host": 0, "engine": 1, "cu": 2, "hostlink": 3, "link": 4,
             "nic": 5}
    return (order.get(resource.split(":", 1)[0], 6), resource)


def _span_label(s: TraceSpan) -> str:
    if s.kind == "wait":
        return f"wait {tag_name(s.tag)}" if s.tag else "wait"
    if s.retry:
        return f"retry {s.kind}"
    return s.kind


def _span_args(s: TraceSpan) -> dict:
    args = {"schedule": s.schedule}
    if s.tag is not None:
        args["tag"] = repr(s.tag)
    if s.size is not None:
        args["size"] = s.size
    if s.chunk is not None:
        args["chunk"] = s.chunk
    if s.retry:
        args["retry"] = True
    if s.args:
        args.update(s.args)
    return args


def _extract(obj) -> SimTrace:
    trace = obj
    result = getattr(obj, "result", None)      # ComposedResult
    if result is not None:
        trace = result
    trace = getattr(trace, "trace", trace)     # SimResult
    if not isinstance(trace, SimTrace):
        raise ValueError(
            "no recorded trace: run simulate()/run_composed() with "
            "record_trace=True (got "
            f"{type(obj).__name__})")
    return trace


def chrome_trace(obj, *, label: str | None = None) -> dict:
    """Render a recorded run as a Chrome ``trace_event`` JSON object.

    ``obj`` is a :class:`SimTrace`, or a ``SimResult``/``ComposedResult``
    whose run recorded one.  One process per device, one thread per
    resource; load the dump in ``ui.perfetto.dev`` or ``chrome://tracing``.
    """
    trace = _extract(obj)
    resources = {s.resource for s in trace.spans}
    resources.update(i.resource for i in trace.instants)
    for f in trace.flows:
        resources.add(f.src_resource)
        resources.add(f.dst_resource)

    tids: dict[str, tuple[int, int]] = {}      # resource -> (pid, tid)
    by_dev: dict[int, list[str]] = {}
    for r in resources:
        by_dev.setdefault(_track_device(r), []).append(r)

    events: list[dict] = []
    for dev in sorted(by_dev):
        events.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": dev, "tid": 0,
                       "args": {"name": f"device {dev}"}})
        events.append({"name": "process_sort_index", "ph": "M", "ts": 0,
                       "pid": dev, "tid": 0, "args": {"sort_index": dev}})
        for tid, r in enumerate(sorted(by_dev[dev], key=_track_rank)):
            tids[r] = (dev, tid)
            events.append({"name": "thread_name", "ph": "M", "ts": 0,
                           "pid": dev, "tid": tid, "args": {"name": r}})
            events.append({"name": "thread_sort_index", "ph": "M", "ts": 0,
                           "pid": dev, "tid": tid,
                           "args": {"sort_index": tid}})

    for s in trace.spans:
        pid, tid = tids[s.resource]
        events.append({"name": _span_label(s), "cat": s.kind, "ph": "X",
                       "ts": s.start * _US, "dur": s.dur * _US,
                       "pid": pid, "tid": tid, "args": _span_args(s)})
    for i in trace.instants:
        pid, tid = tids[i.resource]
        args = {"schedule": i.schedule}
        if i.tag is not None:
            args["tag"] = repr(i.tag)
        if i.args:
            args.update(i.args)
        events.append({"name": i.kind, "cat": i.kind, "ph": "i", "s": "t",
                       "ts": i.time * _US, "pid": pid, "tid": tid,
                       "args": args})
    for f in trace.flows:
        name = str(tag_name(f.tag))
        spid, stid = tids[f.src_resource]
        dpid, dtid = tids[f.dst_resource]
        events.append({"name": name, "cat": "signal", "ph": "s",
                       "id": f.id, "ts": f.src_time * _US,
                       "pid": spid, "tid": stid})
        events.append({"name": name, "cat": "signal", "ph": "f", "bp": "e",
                       "id": f.id, "ts": f.dst_time * _US,
                       "pid": dpid, "tid": dtid})

    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if label is not None:
        out["otherData"] = {"label": label}
    return out


def write_chrome_trace(obj, path: str, *, label: str | None = None) -> str:
    """Dump :func:`chrome_trace` JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(obj, label=label), f, indent=None,
                  separators=(",", ":"), sort_keys=True)
        f.write("\n")
    return path
