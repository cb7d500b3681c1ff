"""Device ms of the miss path's attention: the events of the flash-attention
prefill kernel (by its symbol) in a traced batch, summed per batch, mean over
the batches in which the program opened its ``attn.prefill_kernel`` span.
None where the kernel did not run (a program without it, or the dense path)."""


def read(run):
    try:
        from repro_torch.kernels.prefill_attention.ops import KERNEL_SYMBOL
        from repro_torch.spans import PREFILL_ATTN
    except ImportError:             # a program without the kernel
        return None
    if run.trace is None:
        return None
    per = []
    for lo, hi in run.trace.batches:
        if any(n == PREFILL_ATTN and lo <= s < hi for s, _, n in run.trace.host):
            per.append(sum(e - s for s, e, n in run.trace.device
                           if KERNEL_SYMBOL in n and lo <= s < hi))
    if not any(per):
        return None
    return sum(per) / len(per) / 1e6
