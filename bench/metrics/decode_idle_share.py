"""Share of the decode loops in which no kernel, copy or set ran on the card:
1 - the union of device intervals inside the traced batches' ``serve.decode``
spans over their summed length, in %."""
from bench.harness import trace as tr


def read(run):
    try:
        from repro_torch.spans import DECODE
    except ImportError:             # a program without spans
        return None
    if run.trace is None or not run.trace.device:
        return None
    loops = [(s, e) for s, e, n in run.trace.host if n == DECODE
             and any(lo <= s < hi for lo, hi in run.trace.batches)]
    if not loops:
        return None
    busy = sum(tr.busy_ns(run.trace, s, e) for s, e in loops)
    return 100.0 * (1 - busy / sum(e - s for s, e in loops))
