"""The served path's spans (``repro_torch.spans``) under ``torch.profiler`` on
the CPU: each name where it belongs and nested as the benchmark's readers
assume, host ranges that are no user annotations (so the profiler gives them
no twin on the device timeline), no change to the tokens, and every name read
by a metric of ``bench/metrics``."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

METRICS = Path(__file__).resolve().parents[1] / "bench" / "metrics"
ARCHS = ("qwen2-0.5b", "olmoe-1b-7b")
KINDS = ("miss", "hit")
B, S, NEW = 2, 40, 4


def _events(prof) -> list[tuple[str, int, int, bool]]:
    """(name, start, end, is a user annotation) of every span the program
    recorded, in the trace's nanoseconds."""
    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.is_user_annotation())
            for ev in prof.profiler.kineto_results.events() if ev.name() in spans.NAMES]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """A miss batch, then a hit batch of the same contexts, each served by a
    fresh engine without a profiler and by another under one."""
    cfg = dataclasses.replace(get_config(request.param).reduced(), compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(11))
    prompts = np.random.default_rng(12).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    keys = [f"ctx{b}" for b in range(B)]
    plain, traced = ServeEngine(model, params, device="cpu"), ServeEngine(model, params,
                                                                          device="cpu")
    out = {}
    for kind in KINDS:
        res = plain.generate(prompts, keys, NEW)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced_res = traced.generate(prompts, keys, NEW)
        assert res.request_stats[0].cache_hit == traced_res.request_stats[0].cache_hit \
            == (kind == "hit")
        out[kind] = (res.tokens, traced_res.tokens, _events(prof))
    return cfg, out


def _named(events, name):
    return [(s, e) for n, s, e, _ in events if n == name]


def _inside(child, parents) -> bool:
    return any(s <= child[0] and child[1] <= e for s, e in parents)


@pytest.mark.parametrize("kind", KINDS)
def test_span_tree(served, kind):
    cfg, out = served
    events = out[kind][2]
    first, = _named(events, spans.FIRST_TOKEN)
    loop, = _named(events, spans.DECODE)
    assert first[1] <= loop[0]
    steps = _named(events, spans.DECODE_STEP)
    in_loop = [st for st in steps if _inside(st, [loop])]
    assert len(in_loop) == NEW - 1
    stage, save = _named(events, spans.STAGE), _named(events, spans.SAVE)
    if kind == "hit":
        # one fetch a key, staged inside the first token; its one decode step
        # lies outside the loop
        assert len(stage) == B and all(_inside(st, [first]) for st in stage)
        assert not save
        assert len(steps) == NEW and [st for st in steps if _inside(st, [first])] \
            == [st for st in steps if st not in in_loop]
    else:
        assert not stage
        assert len(save) == 1 and _inside(save[0], [first])
        assert steps == in_loop
    ffn = _named(events, spans.FFN)
    # one feed-forward a layer a step, in decode steps alone (none in prefill)
    assert len(ffn) == cfg.n_layers * len(steps)
    for st in steps:
        assert sum(_inside(f, [st]) for f in ffn) == cfg.n_layers
    assert not _named(events, spans.SYNC)          # no card: _clock synchronizes nothing
    # the spans a batch: first token, loop, steps, feed-forwards, stages or the
    # save (on a card four more: _clock's synchronize at the first token's
    # start and end, and at the loop's start and end)
    assert len(events) == 2 + len(steps) * (1 + cfg.n_layers) + (B if kind == "hit" else 1)


@pytest.mark.parametrize("kind", KINDS)
def test_spans_are_no_user_annotations(served, kind):
    events = served[1][kind][2]
    assert events and not any(user for *_, user in events)


@pytest.mark.parametrize("kind", KINDS)
def test_tokens_equal_with_and_without_a_profiler(served, kind):
    plain, traced, _ = served[1][kind]
    np.testing.assert_array_equal(traced, plain)


def test_clock_spans_the_cards_synchronize(monkeypatch):
    """On a card ``_clock`` records its ``synchronize`` as ``serve.sync``."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))

    class _Clock(ServeEngine):      # the clock alone, without a model
        def __init__(self):
            self.device = torch.device("cuda")

    eng = _Clock()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng._clock()
    events = _events(prof)
    assert calls == [eng.device]
    assert [n for n, *_ in events] == [spans.SYNC] and not events[0][3]


def _span_names_read(path: Path) -> set[str]:
    """The names a reader imports from ``repro_torch.spans``."""
    return {alias.name for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) and node.module == "repro_torch.spans"
            for alias in node.names}


@pytest.mark.parametrize("name", spans.NAMES)
def test_every_span_is_read_by_a_metric(name):
    constant = next(k for k, v in vars(spans).items() if v == name and k.isupper())
    readers = [p.name for p in sorted(METRICS.glob("*.py")) if constant in _span_names_read(p)]
    assert readers, f"no reader of bench/metrics reads {name}"
