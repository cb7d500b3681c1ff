"""The KV fetch's share of the host link's peak: the bytes a hit batch fetches
(whole 16-token blocks of K and V, every layer) over the device time of its
host-to-device copies, against PCIe Gen5 x16's 64 GB/s a direction."""
from bench.harness import flops
from bench.harness import trace as tr


def read(run):
    if run.trace is None or not run.mix.hit:
        return None
    ns = sum(tr.in_span(run.trace.device, lo, hi, tr.H2D_PINNED) for lo, hi in run.trace.batches)
    if not ns:
        return None
    fetched = (len(run.trace.batches) * run.mix.batch
               * flops.stored_kv_bytes(run.config, run.mix.prompt_tokens))
    return 100.0 * fetched / (ns / 1e9) / flops.PCIE_GEN5_X16_BYTES_S
