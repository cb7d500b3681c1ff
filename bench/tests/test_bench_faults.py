"""A run with the timed path broken underneath comes out not correct, once for
each fault a serving cell can have (one card: no exchange between chips)."""
import torch
import pytest

from bench.harness import serve
from bench.tests import tiny
from repro_torch.models import attention
from repro_torch.serve import engine, host_store

from bench.tests.test_bench_run import TINY_LIMITS


def altered_token(monkeypatch):
    real = engine.ServeEngine._greedy
    monkeypatch.setattr(engine.ServeEngine, "_greedy",
                        lambda self, logits: (real(self, logits) + 1) % logits.shape[-1])


def decode_state_unchanged(monkeypatch):
    """A decode step that hands back its cache as it found it."""
    real = attention.attention_decode

    def step(cfg, p, x, cache, pos, **kw):
        out, _ = real(cfg, p, x, {k: v.clone() for k, v in cache.items()}, pos, **kw)
        return out, cache
    monkeypatch.setattr(attention, "attention_decode", step)


def fetch_stale(monkeypatch):
    """The fetch returns blocks that were never written (zeros)."""
    real = host_store.HostKVStore.fetch

    def fetch(self, key, backend="b2b"):
        res = real(self, key, backend)
        res.k_blocks, res.v_blocks = torch.zeros_like(res.k_blocks), torch.zeros_like(res.v_blocks)
        return res
    monkeypatch.setattr(host_store.HostKVStore, "fetch", fetch)


def half_batch_left_out(monkeypatch):
    """Only the first half of a batch is served; the second half's rows get
    the first half's tokens."""
    real = engine.ServeEngine.generate

    def generate(self, prompts, keys, n_new, **kw):
        res = real(self, prompts, keys, n_new, **kw)
        half = len(keys) // 2
        res.tokens[half:2 * half] = res.tokens[:half]
        return res
    monkeypatch.setattr(engine.ServeEngine, "generate", generate)


def save_dropped(monkeypatch):
    """The save to the host store does nothing."""
    monkeypatch.setattr(host_store.HostKVStore, "save", lambda self, *a, **kw: None)


def save_truncated(monkeypatch):
    """The save keeps the first half of a context's blocks."""
    real = host_store.HostKVStore.save

    def save(self, key, k_blocks, v_blocks, n_tokens):
        half = k_blocks.shape[0] // 2
        real(self, key, k_blocks[:half], v_blocks[:half], n_tokens)
    monkeypatch.setattr(host_store.HostKVStore, "save", save)


# fault -> (plant, {kind: the check it fails})
FAULTS = {"altered_token": (altered_token, {"revisit": "mean_logit_gap",
                                            "fresh": "mean_logit_gap"}),
          "decode_state_unchanged": (decode_state_unchanged, {"revisit": "mean_logit_gap",
                                                              "fresh": "mean_logit_gap"}),
          "fetch_stale": (fetch_stale, {"revisit": "mean_logit_gap"}),
          "half_batch_left_out": (half_batch_left_out, {"revisit": "mean_logit_gap",
                                                        "fresh": "mean_logit_gap"}),
          # a revisit mix's fill saves nothing, so its window serves misses
          "save_dropped": (save_dropped, {"revisit": "wrong_cache_kind",
                                          "fresh": "saved_kv_rel_err"}),
          "save_truncated": (save_truncated, {"fresh": "saved_kv_rel_err"})}
CASES = [(f, c, k) for f, (_, kinds) in FAULTS.items()
         for c in ("olmoe-1b-7b", "qwen2-vl-72b-8l") for k in kinds]


@pytest.mark.parametrize("fault,config,kind", CASES)
def test_fault_is_not_correct(monkeypatch, fault, config, kind):
    plant, fails = FAULTS[fault]
    plant(monkeypatch)
    res = serve.run_cell(tiny.cell(config, kind), 2**31 + 21, 0.2, False, device="cpu",
                         limits=TINY_LIMITS)
    assert res["correct"] is False
    check = res["checks"][fails[kind]]
    assert check["value"] > check["limit"], res["checks"]
