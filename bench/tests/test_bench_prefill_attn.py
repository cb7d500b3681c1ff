"""The reader of the miss path's attention kernel (``bench/metrics/prefill_attn_ms.py``)
on hand-built traces: the kernel's device time per batch, and None wherever the
kernel did not run or the program lacks it."""
import sys

import pytest

from bench.tests.test_bench_spans import US, _read, _trace
from repro_torch import spans

# Two miss batches: the prefill's attention spans on the host and the kernel's
# events on the device under the symbol the profiler records for it.
PREFILL_KERNEL = ("void (anonymous namespace)::prefill_flash_attention_fwd<__nv_bfloat16, 128>"
                  "((anonymous namespace)::Args)")
PREFILL_HOST = [(10, 500, spans.FIRST_TOKEN), (20, 25, spans.PREFILL_ATTN),
                (60, 64, spans.PREFILL_ATTN), (300, 450, spans.SAVE),
                (1010, 1500, spans.FIRST_TOKEN), (1020, 1024, spans.PREFILL_ATTN)]
PREFILL_DEVICE = [(30, 90, PREFILL_KERNEL), (95, 135, PREFILL_KERNEL), (140, 200, "nvjet_tst_gemm"),
                  (1030, 1130, PREFILL_KERNEL), (1140, 1300, "softmax_warp_forward")]
BATCHES = ((0, 1000), (1000, 2000))


def test_prefill_attn_ms_sums_the_kernels_events():
    got = _read("prefill_attn_ms", _trace(PREFILL_HOST, PREFILL_DEVICE, batches=BATCHES))
    assert got == pytest.approx((60 + 40 + 100) / 2 * US / 1e6, rel=1e-12)


@pytest.mark.parametrize("case", ["dense_path", "no_span", "no_trace", "no_kernel_module",
                                  "no_spans_module"])
def test_prefill_attn_ms_is_none_without_the_kernel(case, monkeypatch):
    """The dense path (no kernel event, no span), a trace without the span, no
    trace, or a program without the kernel or the spans: None, never 0."""
    host, device = PREFILL_HOST, PREFILL_DEVICE
    if case == "dense_path":
        host = [h for h in host if h[2] != spans.PREFILL_ATTN]
        device = [d for d in device if d[2] != PREFILL_KERNEL]
    if case == "no_span":
        host = [h for h in host if h[2] != spans.PREFILL_ATTN]
    if case == "no_kernel_module":
        monkeypatch.setitem(sys.modules, "repro_torch.kernels.prefill_attention.ops", None)
    if case == "no_spans_module":
        monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    trace = None if case == "no_trace" else _trace(host, device, batches=BATCHES)
    assert _read("prefill_attn_ms", trace) is None
