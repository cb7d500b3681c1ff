"""Share of a decode step's launches (as ``decode_launches_per_step`` counts
them) that the feed-forward makes: those that start inside the program's
``model.ffn`` spans, in %; for the MoE model its router and expert dispatch."""
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
        from repro_torch.spans import DECODE, DECODE_STEP, FFN
    except ImportError:             # a program without spans
        return None
    if run.trace is None:
        return None
    host = run.trace.host
    in_loop = _inside([(s, e) for s, e, n in host if n == DECODE
                       and any(lo <= s < hi for lo, hi in run.trace.batches)])
    in_step = _inside([(s, e) for s, e, n in host if n == DECODE_STEP and in_loop(s)])
    in_ffn = _inside([(s, e) for s, e, n in host if n == FFN])
    launches = [s for s, _, n in host
                if (n.startswith(LAUNCH_PREFIXES) or n in LAUNCH_NAMES) and in_step(s)]
    if not launches:
        return None
    return 100.0 * sum(1 for s in launches if in_ffn(s)) / len(launches)
