"""The hit path's time to first token (fetch, rebuild, one decode step): the
nearest-rank p90 over the untraced hit requests, each at its batch's time."""
from bench.harness.serve import p90


def read(run):
    hit = [r.ttft_s * 1e3 for r in run.timed for h in r.hits if h]
    return p90(hit) if hit else None
