"""The miss path's prefill as a share of the card's bf16 peak: the FLOPs the
prompts need (every layer at every position, causal attention, the head at
the last position) over the misses' time to first token, summed over the
untraced miss batches."""
from bench.harness import flops


def read(run):
    recs = [r for r in run.timed if not any(r.hits)]
    if not recs:
        return None
    work = sum(run.flops(r)[0] for r in recs)
    return 100.0 * work / sum(r.ttft_s for r in recs) / flops.PEAK_BF16_FLOPS
