"""Host ms the first token waits for the card: the ``serve.sync`` spans inside
``serve.first_token`` (on a hit the copy's tail, the rebuild and the first
step, still queued when the host is done), summed per traced batch, mean over
batches."""
import bisect


def _inside(spans):
    """A test of whether a time lies inside one of ``spans`` (disjoint, sorted)."""
    starts = [s for s, _ in spans]

    def test(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < spans[i][1]
    return test


def read(run):
    try:
        from repro_torch.spans import FIRST_TOKEN, SYNC
    except ImportError:             # a program without spans
        return None
    if run.trace is None:
        return None
    host = run.trace.host
    in_first = _inside([(s, e) for s, e, n in host if n == FIRST_TOKEN])
    per = [sum(e - s for s, e, n in host if n == SYNC and lo <= s < hi and in_first(s))
           for lo, hi in run.trace.batches]
    if not any(per):
        return None
    return sum(per) / len(per) / 1e6
