"""The one traffic generator is deterministic by seed and gives every seed
the same sizes."""
import json

import numpy as np
import pytest

from bench.harness import registry, traffic

MIXES = sorted(p.stem for p in (registry.BENCH / "traffic").glob("*.json"))
SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)


def mix(name, seed, vocab=50304):
    return traffic.Mix(json.loads(registry.traffic_file(name).read_text()), vocab, seed)


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_batches(name, seed):
    a, b = mix(name, seed), mix(name, seed)
    for i in (0, 1, 17):
        x, y = a.batch_at(i), b.batch_at(i)
        assert x.keys == y.keys and np.array_equal(x.prompts, y.prompts) and x.docs == y.docs
    window = [a.batch_at(i) for i in range(9)]
    pa, pb = a.check_plan(window), b.check_plan(window)
    assert [c.requests for c in pa] == [c.requests for c in pb]
    assert all(np.array_equal(x.prompts, y.prompts) for x, y in zip(pa, pb))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_change_tokens_not_sizes(name):
    a, b = mix(name, 1), mix(name, 2)
    x, y = a.batch_at(3), b.batch_at(3)
    assert x.prompts.shape == y.prompts.shape == (a.batch, a.prompt_tokens)
    assert not np.array_equal(x.prompts, y.prompts)
    assert x.prompts.min() >= 0 and x.prompts.max() < 50304


@pytest.mark.parametrize("name", [m for m in MIXES if m.startswith("revisit")])
def test_revisit_asks_distinct_pool_documents(name):
    m = mix(name, 11)
    fill = list(m.fill())
    assert sum(len(keys) for keys, _ in fill) == m.pool
    assert all(len(keys) <= m.fill_per_prefill for keys, _ in fill)
    saved = {k for keys, _ in fill for k in keys}
    for i in range(20):
        b = m.batch_at(i)
        assert len(set(b.docs)) == m.batch and set(b.keys) <= saved
        assert np.array_equal(b.prompts, m.pool_prompts()[list(b.docs)])
    window = [m.batch_at(i) for i in range(6)]
    plan = m.check_plan(window)
    groups = m.fill_groups()
    assert sum(len(c.requests) for c in plan) >= min(m.check_requests, m.pool)
    for c in plan:          # a whole fill call, one window request a document asked
        docs = next(g for g in groups if np.array_equal(m.pool_prompts()[g], c.prompts))
        for g, bi, row in c.requests:
            assert window[bi].docs[row] == docs[g]


@pytest.mark.parametrize("name", [m for m in MIXES if m.startswith("fresh")])
def test_fresh_checks_whole_batches(name):
    m = mix(name, 9)
    window = [m.batch_at(i) for i in range(7)]
    plan = m.check_plan(window)
    assert sum(len(c.requests) for c in plan) >= m.check_requests
    for c in plan:
        bi = c.requests[0][1]
        assert np.array_equal(c.prompts, window[bi].prompts)
        assert c.requests == [(g, bi, g) for g in range(m.batch)]


@pytest.mark.parametrize("name", [m for m in MIXES if m.startswith("fresh")])
def test_fresh_keys_never_repeat(name):
    m = mix(name, 5)
    keys = [k for i in range(30) for k in m.batch_at(i).keys]
    keys += [k for i in range(2) for k in m.batch_at(i, "warm").keys]
    assert len(keys) == len(set(keys))
