"""Host ms the program takes to enqueue one decode step: the mean length of
the ``model.decode_step`` spans inside the decode loops (``serve.decode``) of
the traced batches; the first token's step is left out."""
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
        from repro_torch.spans import DECODE, DECODE_STEP
    except ImportError:             # a program without spans
        return None
    if run.trace is None:
        return None
    host = run.trace.host
    in_loop = _inside([(s, e) for s, e, n in host if n == DECODE
                       and any(lo <= s < hi for lo, hi in run.trace.batches)])
    steps = [e - s for s, e, n in host if n == DECODE_STEP and in_loop(s)]
    if not steps:
        return None
    return sum(steps) / len(steps) / 1e6
