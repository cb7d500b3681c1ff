"""Device ms of the KV fetch's host-to-device copies (pinned host memory to
HBM, the profiler's memcpy events) in a traced hit batch, mean per batch."""
from bench.harness import trace as tr


def read(run):
    if run.trace is None or not run.mix.hit:
        return None
    per = [tr.in_span(run.trace.device, lo, hi, tr.H2D_PINNED) for lo, hi in run.trace.batches]
    if not any(per):
        return None
    return sum(per) / len(per) / 1e6
