"""Share of the traced batches' span in which no kernel, copy or set ran on
the card (1 - the union of device intervals over the span)."""
from bench.harness import trace as tr


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    lo, hi = run.trace.span
    return 100.0 * (1 - tr.busy_ns(run.trace, lo, hi) / (hi - lo))
