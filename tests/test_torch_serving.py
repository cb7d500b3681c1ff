"""The port's serving slice against the JAX reference: block layout, host
store fetch backends, fetch plan and the engine's greedy tokens.

Engine parity runs in float32 on bridged weights, where the two packages
differ only in summation order, and requires equal tokens and the
reference's modeled fetch latency bit for bit.  The MoE engines run at the
default capacity factor: a hit routes the first token in a decode step (B
tokens) where the miss routed it in prefill (B x S tokens), so hit and miss
tokens may differ from each other, but each path must give the reference's
tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.backend import MB, CommBackend as JaxCommBackend  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import kvcache as jax_kvcache  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.host_store import HostKVStore as JaxHostKVStore  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backend import CommBackend  # noqa: E402
from repro_torch.kernels.paged_kv_gather import ops as gather_ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import kvcache  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.host_store import BACKENDS, HostKVStore  # noqa: E402


# ------------------------------------------------------------- kvcache ----
@pytest.mark.parametrize("S,bt", [(70, 16), (64, 16), (5, 8)])
def test_kv_blocks_round_trip_matches_reference(S, bt):
    rng = np.random.default_rng(S)
    k = rng.normal(size=(3, 1, S, 2, 8)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    jkb, jvb = jax_kvcache.kv_to_blocks(k, v, bt)
    tkb, tvb = kvcache.kv_to_blocks(torch.from_numpy(k), torch.from_numpy(v), bt)
    np.testing.assert_array_equal(tkb.numpy(), jkb)
    np.testing.assert_array_equal(tvb.numpy(), jvb)
    jk, jv = jax_kvcache.blocks_to_kv(jkb, jvb, S)
    tk, tv = kvcache.blocks_to_kv(tkb, tvb, S)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tk.numpy(), k)


def test_blocks_for_tokens_and_allocator_match_reference():
    for n in (0, 1, 15, 16, 17, 1024):
        assert kvcache.blocks_for_tokens(n) == jax_kvcache.blocks_for_tokens(n)
    a, b = kvcache.BlockAllocator(8), jax_kvcache.BlockAllocator(8)
    assert a.alloc(3) == b.alloc(3)
    a.release([1])
    b.release([1])
    assert a.alloc(2) == b.alloc(2) and a.n_free == b.n_free
    with pytest.raises(MemoryError):
        a.alloc(9)


# ---------------------------------------------------------- host store ----
def test_fetch_backends_bitwise_equal(monkeypatch):
    """The inputs of tests/test_serving.py::test_fetch_backends_bitwise_equal:
    every backend returns the reference's blocks bit for bit, and the
    transfer counts are ordered as in the reference."""
    monkeypatch.setattr(gather_ops, "launches", 0)
    rng = np.random.default_rng(0)
    kb = rng.normal(size=(5, 16, 2, 2, 16)).astype(np.float32)
    vb = rng.normal(size=(5, 16, 2, 2, 16)).astype(np.float32)
    ref_store, store = JaxHostKVStore(), HostKVStore(device="cpu")
    ref_store.save("k", kb, vb, 70)
    store.save("k", torch.from_numpy(kb), torch.from_numpy(vb), 70)
    assert store.blocks_for("k") == ref_store.blocks_for("k")
    assert store.tokens_for("k") == 70
    ref = {b: ref_store.fetch("k", b) for b in BACKENDS}
    res = {b: store.fetch("k", b) for b in BACKENDS}
    for b in BACKENDS:
        np.testing.assert_array_equal(res[b].k_blocks.numpy(), ref[b].k_blocks)
        np.testing.assert_array_equal(res[b].v_blocks.numpy(), ref[b].v_blocks)
        assert res[b].n_transfers == ref[b].n_transfers
    assert res["b2b"].n_transfers < res["pcpy"].n_transfers
    assert gather_ops.launches == 0          # CPU tensors take the plain gather


def test_fetch_does_not_alias_the_store():
    store = HostKVStore(device="cpu")
    kb = torch.ones(3, 4, 2, 1, 8)
    store.save("c", kb, kb * 2, 10)
    for b in BACKENDS:
        res = store.fetch("c", b)
        res.k_blocks.zero_()
        res.v_blocks.zero_()
    saved_k, saved_v = store.host_blocks("c")
    assert torch.equal(saved_k, kb) and torch.equal(saved_v, kb * 2)
    with pytest.raises(ValueError):
        store.fetch("c", "warp")


@pytest.mark.parametrize("kind", ["latte", "reference"])
def test_kv_fetch_plan_matches_reference(kind):
    ref, port = JaxCommBackend(kind), CommBackend(kind)
    for n_blocks in (1, 4, 16, 17, 64, 256, 1024):
        for block_bytes in (1024, 64 * 1024, 3 * MB // 16, MB):
            assert port.kv_fetch_plan(n_blocks, block_bytes) == \
                ref.kv_fetch_plan(n_blocks, block_bytes), (n_blocks, block_bytes)


def test_engine_follows_kv_fetch_plan():
    store = HostKVStore(device="cpu")
    rng = np.random.default_rng(3)
    kb = torch.from_numpy(rng.normal(size=(4, 16, 2, 2, 16)).astype(np.float32))
    store.save("ctx", kb, kb, 60)

    class _Probe(ServeEngine):      # plan resolution without model weights
        def __init__(self, comm, st):
            self.comm, self.store = comm, st

    assert _Probe(CommBackend("latte"), store)._planned_backend(["ctx"]) == "opt_b2b"
    assert _Probe(CommBackend("reference"), store)._planned_backend(["ctx"]) == "pcpy"


# -------------------------------------------------------------- engine ----
@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, on the same float32 weights."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return JaxServeEngine(jm, jp), ServeEngine(build_model(tcfg), tp, device="cpu"), tcfg


@pytest.fixture(scope="module")
def served(engines):
    """Greedy tokens of both engines: the miss path, then a hit per backend."""
    jeng, teng, cfg = engines
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    keys = ["a", "b"]
    out = {}
    for backend in (None,) + BACKENDS:
        out[backend] = (jeng.generate(prompts, keys, 6, fetch_backend=backend),
                        teng.generate(prompts, keys, 6, fetch_backend=backend))
    return out


@pytest.mark.parametrize("backend", (None,) + BACKENDS)
def test_engine_tokens_match_reference(served, backend):
    """None is the miss path (prefill + save); the rest are hits."""
    jres, tres = served[backend]
    assert tres.tokens.shape == (2, 6)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    st = tres.request_stats[0]
    assert st.cache_hit == (backend is not None) and st.prompt_tokens == 40
    assert st.n_transfers == jres.request_stats[0].n_transfers
    assert st.fetch_modeled_s == jres.request_stats[0].fetch_modeled_s
    assert (st.fetch_modeled_s > 0) == (backend is not None)
    if backend is not None:
        np.testing.assert_array_equal(tres.tokens, served[None][1].tokens)


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "mixtral-8x7b"])
def moe_served(request):
    """The MoE engines of both packages on the same float32 weights, at the
    default capacity factor: the miss path, then a hit per backend."""
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jeng, teng = JaxServeEngine(jm, jp), ServeEngine(build_model(tcfg), tp, device="cpu")
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab, (3, 40)).astype(np.int32)
    keys = ["m0", "m1", "m2"]
    return {b: (jeng.generate(prompts, keys, 5, fetch_backend=b),
                teng.generate(prompts, keys, 5, fetch_backend=b)) for b in (None,) + BACKENDS}


@pytest.mark.parametrize("backend", (None,) + BACKENDS)
def test_moe_engine_tokens_match_reference(moe_served, backend):
    """None is the miss path (prefill routes all 3 x 40 tokens at once)."""
    jres, tres = moe_served[backend]
    assert tres.tokens.shape == (3, 5)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    for st, jst in zip(tres.request_stats, jres.request_stats):
        assert st.cache_hit == jst.cache_hit == (backend is not None)
        assert (st.n_transfers, st.fetch_modeled_s) == (jst.n_transfers, jst.fetch_modeled_s)


def test_engine_default_backend_follows_plan(engines, served):
    _, teng, cfg = engines
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    res = teng.generate(prompts, ["a", "b"], 3)
    assert res.request_stats[0].cache_hit
    np.testing.assert_array_equal(res.tokens, served["opt_b2b"][1].tokens[:, :3])


def test_engine_rejects_non_decoder_family():
    cfg = get_config("rwkv6-1.6b").reduced()

    class _Model:
        pass

    m = _Model()
    m.cfg = cfg
    with pytest.raises(ValueError):
        ServeEngine(m, None, device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(cfg)


def test_engine_defaults_to_cuda(monkeypatch):
    """Without ``device=`` the engine runs on the card, and raises where
    there is none (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(build_model(cfg), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HostKVStore()


def test_moe_hit_tokens_equal_miss_tokens_without_drops():
    """At capacity factor n_experts / top_k no choice is dropped, so a hit
    (first token routed in a decode step) gives the miss path's tokens on
    every backend, in float32."""
    base = get_config("olmoe-1b-7b").reduced()
    moe = dataclasses.replace(base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k)
    cfg = dataclasses.replace(base, compute_dtype="float32", moe=moe)
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(torch.Generator().manual_seed(5)), device="cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    miss = eng.generate(prompts, ["x", "y"], 6)
    assert not miss.request_stats[0].cache_hit
    for backend in BACKENDS:
        hit = eng.generate(prompts, ["x", "y"], 6, fetch_backend=backend)
        assert hit.request_stats[0].cache_hit
        np.testing.assert_array_equal(hit.tokens, miss.tokens, err_msg=backend)
