"""Reads a ``torch.profiler`` trace of whole batches: the device's intervals,
the host's ops, and the harness's own ``bench.batch`` spans.

All times are the trace's nanoseconds.  ``busy_ns`` is the union of every
device interval (kernels, copies, sets) inside a span; an idle gap is a
stretch of a traced batch with none, named after the innermost host op that
covers its middle (the host's work that kept the card waiting).
"""
from __future__ import annotations

import bisect
import dataclasses

BATCH_SPAN = "bench.batch"
NAME_CHARS = 100            # a breakdown names an op by the start of its name
H2D_PINNED = "Memcpy HtoD (Pinned -> Device)"


@dataclasses.dataclass
class Trace:
    device: list[tuple[int, int, str]]      # (start, end, name), sorted by start
    host: list[tuple[int, int, str]]        # host ops, sorted by start
    batches: list[tuple[int, int]]          # the bench.batch spans, in order

    @property
    def span(self) -> tuple[int, int]:
        return self.batches[0][0], self.batches[-1][1]


def from_profiler(prof) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host, batches = [], [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        name = ev.name()
        on_device = ev.device_type() == DeviceType.CUDA
        if name == BATCH_SPAN:
            if not on_device:       # the span's device-side twin is no device work
                batches.append((start, end))
        elif on_device:
            device.append((start, end, name))
        elif end > start:
            host.append((start, end, name))
    device.sort()
    host.sort()
    batches.sort()
    return Trace(device, host, batches)


def merged(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint pairs."""
    out: list[list[int]] = []
    for start, end, *_ in intervals:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_ns(trace: Trace, lo: int, hi: int) -> int:
    return sum(b - a for a, b in merged(trace.device, lo, hi))


def device_ops(trace: Trace, top: int = 10) -> list[list]:
    """The device operations that took most time in all: [name, seconds]."""
    total: dict[str, int] = {}
    for start, end, name in trace.device:
        total[name] = total.get(name, 0) + end - start
    return _top(total, top)


def _top(total: dict[str, int], top: int) -> list[list]:
    return [[name[:NAME_CHARS], ns / 1e9]
            for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def _host_op_at(trace: Trace, starts: list[int], t: int) -> str:
    """The innermost host op running at ``t`` (the latest started that has
    not ended), else the batch span itself."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 20000), -1):
        start, end, name = trace.host[j]
        if end >= t:
            return name
    return BATCH_SPAN


def idle_gaps(trace: Trace, top: int = 10, min_ns: int = 20_000) -> list[list]:
    """Idle time inside the traced batches, summed by the host op that ran
    during each gap of at least ``min_ns``: [name, seconds], longest first."""
    starts = [h[0] for h in trace.host]
    total: dict[str, int] = {}
    for lo, hi in trace.batches:
        busy = merged(trace.device, lo, hi)
        edges = [lo] + [x for pair in busy for x in pair] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b - a >= min_ns:
                name = _host_op_at(trace, starts, (a + b) // 2)
                total[name] = total.get(name, 0) + b - a
    return _top(total, top)


def in_span(intervals, lo: int, hi: int, name: str) -> int:
    """Device ns of the events called ``name`` that start inside [lo, hi)."""
    return sum(end - start for start, end, n in intervals if n == name and lo <= start < hi)
