"""The readers of the program's spans (``bench/metrics``) on hand-built traces:
each value, None where the trace holds nothing of a reader's kind, the first
token's decode step left out of the decode metrics, and idle gaps named by
the spans."""
import sys
import types

import pytest

from bench.harness import registry
from bench.harness import trace as tr
from repro_torch import spans

US = 1000                   # the trace's nanoseconds a microsecond
READERS = ("hit_stage_ms", "hit_wait_ms", "save_ms", "decode_host_ms",
           "decode_launches_per_step", "decode_ffn_launch_share", "decode_idle_share")


def _trace(host, device=(), batches=((0, 1000),)) -> tr.Trace:
    return tr.Trace(sorted((s * US, e * US, n) for s, e, n in device),
                    sorted((s * US, e * US, n) for s, e, n in host),
                    [(lo * US, hi * US) for lo, hi in batches])


def _launch(t, name="cudaLaunchKernel"):
    return (t, t + 2, name)


# One hit batch of two keys and two decode steps, in microseconds.
HIT_HOST = [
    (10, 300, spans.FIRST_TOKEN),
    (12, 14, spans.SYNC),                           # the first token's clock at its start
    (20, 60, spans.STAGE), (70, 100, spans.STAGE),
    (150, 200, spans.DECODE_STEP),                  # the first token's step: left out
    (170, 190, spans.FFN), _launch(155), _launch(175),
    (250, 290, spans.SYNC),
    (300, 305, spans.SYNC),                         # generate's clock, after the first token
    (310, 800, spans.DECODE),
    (320, 500, spans.DECODE_STEP),
    _launch(330), _launch(340, "cudaMemcpyAsync"),
    (400, 480, spans.FFN), (405, 470, "aten::mm"),
    _launch(410, "cuLaunchKernel"), _launch(420, "cudaMemsetAsync"),
    _launch(430, "cudaLaunchKernelExC"), (440, 445, "cudaStreamSynchronize"),
    _launch(510),                                   # the loop's argmax, outside the steps
    (520, 700, spans.DECODE_STEP), _launch(530),
    (600, 690, spans.FFN), _launch(610),
    (720, 800, spans.SYNC),
]
HIT_DEVICE = [(160, 240, "k0"), (330, 380, "k1"), (420, 450, "k2"), (700, 760, "k3")]

EXPECTED = {
    "hit_stage_ms": (40 + 30) * US / 1e6,
    "hit_wait_ms": (2 + 40) * US / 1e6,
    "decode_host_ms": 180 * US / 1e6,
    "decode_launches_per_step": 7 / 2,
    "decode_ffn_launch_share": 100 * 4 / 7,
    "decode_idle_share": 100 * (1 - (50 + 30 + 60) / 490),
}


def _read(name, trace):
    return registry.metric_reader(name)(types.SimpleNamespace(trace=trace))


@pytest.mark.parametrize("name", READERS)
def test_reader_values(name):
    got = _read(name, _trace(HIT_HOST, HIT_DEVICE))
    if name == "save_ms":
        assert got is None                          # a hit saves nothing
    else:
        assert got == pytest.approx(EXPECTED[name], rel=1e-12)


def test_save_is_a_mean_over_batches():
    host = [(10, 500, spans.FIRST_TOKEN), (300, 450, spans.SAVE),
            (1010, 1500, spans.FIRST_TOKEN), (1100, 1300, spans.SAVE)]
    got = _read("save_ms", _trace(host, batches=((0, 1000), (1000, 2000))))
    assert got == pytest.approx((150 + 200) / 2 * US / 1e6, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(name):
    """A program without spans (the trace's aten ops, launches and kernels
    alone), no trace, or a program without the spans module: None, never 0."""
    bare = [h for h in HIT_HOST if h[2] not in spans.NAMES]
    assert _read(name, _trace(bare, HIT_DEVICE)) is None
    assert _read(name, None) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_spans_module(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert _read(name, _trace(HIT_HOST, HIT_DEVICE)) is None


@pytest.mark.parametrize("name", ("hit_wait_ms", "decode_launches_per_step",
                                  "decode_ffn_launch_share", "decode_idle_share"))
def test_none_on_a_cpu_trace(name):
    """On the CPU the trace has spans but no synchronize, no launch and no
    device event."""
    cpu = [h for h in HIT_HOST if h[2] != spans.SYNC and not h[2].startswith("cu")]
    assert _read(name, _trace(cpu)) is None


@pytest.mark.parametrize("name", ("decode_host_ms", "decode_launches_per_step",
                                  "decode_ffn_launch_share"))
def test_first_tokens_step_is_left_out(name):
    """Launches and time moved into the first token's step change nothing."""
    more = HIT_HOST + [_launch(t) for t in (157, 160, 172, 180, 185)]
    more = [(s, e + 40 if n == spans.DECODE_STEP and s == 150 else e, n) for s, e, n in more]
    assert _read(name, _trace(more, HIT_DEVICE)) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_idle_gaps_are_named_by_spans():
    """A gap inside ``model.ffn`` that no op covers is named ``model.ffn``; a
    gap an op covers keeps the op's name."""
    host = [(100, 900, spans.DECODE_STEP), (200, 240, "aten::index"), (300, 700, spans.FFN)]
    device = [(0, 100, "k0"), (340, 360, "k1"), (700, 1000, "k2")]
    gaps = tr.idle_gaps(_trace(host, device))
    assert gaps == [[spans.FFN, 340 * US / 1e9], ["aten::index", 240 * US / 1e9]]
