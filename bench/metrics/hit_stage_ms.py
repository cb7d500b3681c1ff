"""Host ms of the hit path's staging copy: the host store's ``torch.cat`` of
each context's K and V blocks into the pinned staging buffer (the program's
``host_store.stage`` spans), summed per traced batch, mean over batches."""


def read(run):
    try:
        from repro_torch.spans import STAGE
    except ImportError:             # a program without spans
        return None
    if run.trace is None:
        return None
    per = [sum(e - s for s, e, n in run.trace.host if n == STAGE and lo <= s < hi)
           for lo, hi in run.trace.batches]
    if not any(per):
        return None
    return sum(per) / len(per) / 1e6
