"""Launches the program makes a decode step: host runtime calls that enqueue
work on the card (``cudaLaunch*``, ``cuLaunch*``, ``cudaMemcpyAsync``,
``cudaMemsetAsync``) that start inside the ``model.decode_step`` spans of the
traced batches' decode loops (``serve.decode``), over the number of those
spans; the first token's step is left out."""
import bisect

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
LAUNCH_NAMES = ("cudaMemcpyAsync", "cudaMemsetAsync")


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
    steps = [(s, e) for s, e, n in host if n == DECODE_STEP and in_loop(s)]
    in_step = _inside(steps)
    launches = sum(1 for s, _, n in host
                   if (n.startswith(LAUNCH_PREFIXES) or n in LAUNCH_NAMES) and in_step(s))
    if not launches:
        return None
    return launches / len(steps)
