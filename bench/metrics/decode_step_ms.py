"""Host-clock ms of one batched decode step after the first token: the sum of
the engine's decode wall time over the sum of its steps, untraced batches."""


def read(run):
    recs = run.timed
    steps = sum(run.mix.new_tokens - 1 for _ in recs)
    if not steps:
        return None
    return 1e3 * sum(r.decode_s for r in recs) / steps
