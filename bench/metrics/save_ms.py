"""Host ms of the miss path's save: the batch's contexts cut into blocks and
copied to the host store's new pinned blocks (the program's ``serve.save``
span), summed per traced batch, mean over batches."""


def read(run):
    try:
        from repro_torch.spans import SAVE
    except ImportError:             # a program without spans
        return None
    if run.trace is None:
        return None
    per = [sum(e - s for s, e, n in run.trace.host if n == SAVE and lo <= s < hi)
           for lo, hi in run.trace.batches]
    if not any(per):
        return None
    return sum(per) / len(per) / 1e6
