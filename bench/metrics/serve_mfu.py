"""The whole serving loop as a share of the card's bf16 peak: the FLOPs that
every untraced batch's first token and decode steps need, over the host-clock
time of those batches."""
from bench.harness import flops


def read(run):
    recs = run.timed
    if not recs:
        return None
    work = sum(sum(run.flops(r)) for r in recs)
    return 100.0 * work / sum(r.end - r.start for r in recs) / flops.PEAK_BF16_FLOPS
