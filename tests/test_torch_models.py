"""The port's dense and MoE models against the JAX reference on bridged weights.

The reference's params (``model.init``) go through ``jax.tree.map(np.asarray)``
and ``repro_torch.bridge.params_from_numpy``; inputs are made with numpy from
a seed.  Parity is checked in float32 (``compute_dtype="float32"`` in both
packages), where the two differ only in summation order: tolerance 1e-4 on
logits of magnitude ~1 (measured differences are ~2e-6).  A bf16 check
follows at atol 0.05, about six bf16 steps at that magnitude, since the two
frameworks round intermediate results at different places.  The MoE
configs' reduced widths (4 experts, top-2, capacity factor 1.25) drop
tokens, so the parity checks cover the drop rule too; the aux loss is
checked at 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

DENSE = ("qwen2-0.5b", "gemma2-27b", "deepseek-7b", "stablelm-12b")
MOE = ("olmoe-1b-7b", "mixtral-8x7b")
DECODERS = DENSE + MOE
F32_TOL = 1e-4
AUX_TOL = 1e-6
BF16_ATOL = 5e-2


def _cfgs(arch, dtype="float32", **changes):
    """The same reduced config in both packages."""
    jc = dataclasses.replace(jax_get_config(arch).reduced(), compute_dtype=dtype, **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype, **changes)
    return jc, tc


def _models(arch, dtype="float32", seed=0, **changes):
    jc, tc = _cfgs(arch, dtype, **changes)
    jm = jax_build_model(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(tc), tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# --------------------------------------------------------------- layers ----
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "stablelm-12b"])   # rmsnorm, layernorm
def test_apply_norm(arch):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, jc.d_model)).astype(np.float32)
    p = {"scale": rng.normal(size=jc.d_model).astype(np.float32),
         "bias": rng.normal(size=jc.d_model).astype(np.float32)}
    want = jax_layers.apply_norm(jc, p, jnp.asarray(x))
    got = layers.apply_norm(tc, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(got, want, 1e-5)


def test_rope_and_rotary():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    jcos, jsin = jax_layers.rope_angles(jnp.asarray(pos), 64, 1_000_000.0)
    tcos, tsin = layers.rope_angles(torch.from_numpy(pos), 64, 1_000_000.0)
    assert tcos.dtype == torch.float32 and tcos.shape == (2, 7, 32)
    _close(tcos, jcos, 1e-5)
    _close(tsin, jsin, 1e-5)
    want = jax_layers.apply_rotary(jnp.asarray(x), jcos, jsin)
    _close(layers.apply_rotary(torch.from_numpy(x), tcos, tsin), want, 1e-5)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b"])     # silu, gelu
def test_apply_mlp(arch):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
         (("wg", (jc.d_model, jc.d_ff)), ("wu", (jc.d_model, jc.d_ff)),
          ("wd", (jc.d_ff, jc.d_model)), ("bu", (jc.d_ff,)), ("bd", (jc.d_model,)))}
    x = rng.normal(size=(2, 3, jc.d_model)).astype(np.float32)
    want = jax_layers.apply_mlp(jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = layers.apply_mlp(tc, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b"])     # gemma2: scale + final softcap
def test_embed_and_unembed(arch):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(jc.vocab, jc.d_model)).astype(np.float32)
    toks = rng.integers(0, jc.vocab, (2, 6)).astype(np.int32)
    je = jax_layers.embed_tokens(jc, jnp.asarray(table), jnp.asarray(toks))
    te = layers.embed_tokens(tc, torch.from_numpy(table), torch.from_numpy(toks))
    _close(te, je, 1e-6)
    want = jax_layers.unembed(jc, jnp.asarray(table).T, je)
    got = layers.unembed(tc, torch.from_numpy(table).T, te)
    _close(got, want)
    if jc.final_softcap:
        assert float(got.abs().max()) <= jc.final_softcap + 1e-3


# ------------------------------------------------------------ attention ----
def _attn_params(cfg, rng):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd), "wo": (H * hd, D),
              "bq": (H * hd,), "bk": (KV * hd,), "bv": (KV * hd,)}
    return {k: rng.normal(size=s).astype(np.float32) / np.sqrt(s[0]) for k, s in shapes.items()}


@pytest.mark.parametrize("window,chunked", [(None, False), (5, False), (None, True), (5, True)])
def test_attention_ctx(window, chunked, monkeypatch):
    """Full-context attention with rope, a sliding window and the
    query-chunked branch (thresholds lowered in both packages)."""
    if chunked:
        monkeypatch.setattr(jax_attn, "CHUNK_THRESHOLD", 8)
        monkeypatch.setattr(attn, "CHUNK_THRESHOLD", 8)
    jc, tc = _cfgs("qwen2-0.5b")
    rng = np.random.default_rng(4)
    p = _attn_params(jc, rng)
    x = rng.normal(size=(2, 32, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    jrope = jax_layers.rope_angles(jnp.asarray(pos), jc.head_dim, jc.rope_theta)
    trope = layers.rope_angles(torch.from_numpy(pos.copy()), tc.head_dim, tc.rope_theta)
    jout, (jk, jv) = jax_attn.attention_ctx(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rope=jrope,
        window=window, q_chunk=8, return_kv=True)
    tout, (tk, tv) = attn.attention_ctx(
        tc, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), rope=trope,
        window=window, q_chunk=8, return_kv=True)
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("S,capacity", [(10, 16), (20, 8)])     # padded, rolling window
def test_prefill_cache(S, capacity):
    jc, tc = _cfgs("qwen2-0.5b")
    rng = np.random.default_rng(5)
    k = rng.normal(size=(2, S, jc.n_kv_heads, jc.head_dim)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    want = jax_attn.prefill_cache(jc, jnp.asarray(k), jnp.asarray(v), capacity)
    got = attn.prefill_cache(tc, torch.from_numpy(k), torch.from_numpy(v), capacity)
    for name in ("k", "v", "kpos"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


# ---------------------------------------------------------- whole model ----
@pytest.mark.parametrize("arch", DECODERS)
def test_forward_logits_match_reference(arch):
    jm, jp, tm, tp = _models(arch)
    toks = np.random.default_rng(6).integers(0, jm.cfg.vocab, (2, 24)).astype(np.int32)
    jl, jaux, jkvs = jm.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False,
                                want_cache=True)
    tl, taux, (tk, tv) = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, want_cache=True)
    assert tl.shape == (2, 24, tm.cfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    _close(taux, jaux, AUX_TOL)
    assert (float(taux) > 0) == (arch in MOE)
    # reference: tuple(per_unit) of (k, v) [trip, ...]; layer u*per_unit+i is jkvs[i][.][u]
    pu, n_layers = len(jkvs), tm.cfg.n_layers
    assert tk.shape == (n_layers, 2, 24, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    for j, got in enumerate((tk, tv)):
        _close(got, np.stack([_np(jkvs[i % pu][j][i // pu]) for i in range(n_layers)]))


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_logits_match_reference(arch):
    """Token-by-token decode from empty caches, against the reference's."""
    jm, jp, tm, tp = _models(arch)
    B, S = 2, 10
    toks = np.random.default_rng(7).integers(0, jm.cfg.vocab, (B, S)).astype(np.int32)
    jcache = jm.init_caches(B, S + 2)
    tcache = tm.init_caches(B, S + 2, "cpu")
    for t in range(S):
        jl, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                         "pos": jnp.int32(t)}, jcache)
        tl, tcache = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                         "pos": t}, tcache)
        _close(tl, jl)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward_within_port(arch):
    """Teacher forcing: decoding from empty caches reproduces the full
    forward's logits at every position (float32, summation order only).
    MoE configs run at capacity factor n_experts / top_k, where no choice
    is dropped: the forward routes 12 tokens at once, a decode step one."""
    changes = {}
    if arch in MOE:
        m = get_config(arch).reduced().moe
        changes["moe"] = dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)
    _, _, tm, tp = _models(arch, **changes)
    B, S = 1, 12
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, tm.cfg.vocab, (B, S)))
    full, _, _ = tm.forward(tp, {"tokens": toks})
    caches = tm.init_caches(B, S + 2, "cpu")
    for t in range(S):
        dl, caches = tm.decode_step(tp, {"tokens": toks[:, t:t + 1], "pos": t}, caches)
        _close(dl[:, 0], full[:, t])


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_bf16(arch):
    jm, jp, tm, tp = _models(arch, dtype="bfloat16")
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab, (2, 24)).astype(np.int32)
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    tl, _, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), _np(jl), atol=BF16_ATOL, rtol=0)


# A routing margin (K-th minus (K+1)-th router probability) below which
# bf16 rounding of the hidden state may pick other experts.
NEAR_TIE = 1e-2


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_logits_bf16(arch, monkeypatch):
    """bf16 forward at atol 5e-2, with the routing of both frameworks
    recorded.  Routing is discontinuous: a token whose K-th and (K+1)-th
    router probabilities are nearly tied may go to other experts when the
    two frameworks round its hidden state differently, which changes its
    output by O(1) and, through attention, the later positions of its
    sequence.  So: every token routed differently must be a near tie
    (margin < NEAR_TIE), and every sequence routed identically at every
    layer must agree at 5e-2."""
    K = get_config(arch).reduced().moe.top_k
    port_routes, ref_routes = [], []
    route = moe_mod.route

    def recording_route(cfg, router, xf):
        probs = torch.softmax(xf.float() @ router.float(), -1).numpy()
        port_routes.append(probs)
        return route(cfg, router, xf)

    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        ref_routes.append(np.asarray(x))
        return top_k(x, k)

    monkeypatch.setattr(moe_mod, "route", recording_route)
    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    jm, jp, tm, tp = _models(arch, dtype="bfloat16")
    B, S = 2, 24
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab, (B, S)).astype(np.int32)
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False, unroll=True)
    tl, _, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert len(port_routes) == len(ref_routes) == tm.cfg.n_layers
    same_seq = np.ones(B, bool)
    for pp, rp in zip(port_routes, ref_routes):
        pick = lambda p: np.sort(np.argsort(-p, -1, kind="stable")[:, :K], -1)  # noqa: E731
        differ = (pick(pp) != pick(rp)).any(-1)
        srt = np.sort(rp, -1)
        assert (srt[differ, -K] - srt[differ, -K - 1] < NEAR_TIE).all()
        same_seq &= ~differ.reshape(B, S).any(-1)
    assert same_seq.any(), same_seq
    np.testing.assert_allclose(_np(tl)[same_seq], _np(jl)[same_seq], atol=BF16_ATOL, rtol=0)


def test_init_is_seeded_and_typed():
    cfg = get_config("qwen2-0.5b").reduced()
    m = build_model(cfg)
    a = m.init(torch.Generator().manual_seed(0))
    b = m.init(torch.Generator().manual_seed(0))
    assert len(a["blocks"]) == cfg.n_layers
    assert a["embed"].dtype == torch.bfloat16 and a["final_norm"]["scale"].dtype == torch.float32
    assert a["blocks"][0]["attn"]["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert a["blocks"][0]["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(a["blocks"][1]["mlp"]["wd"], b["blocks"][1]["mlp"]["wd"])


@pytest.mark.parametrize("arch", MOE)
def test_moe_router_stays_float32(arch):
    """Init and the bridge keep the router in float32 (the reference routes
    in float32 from its float32 params); the experts take the compute dtype."""
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    a = m.init(torch.Generator().manual_seed(0))
    b = m.init(torch.Generator().manual_seed(0))
    moe = a["blocks"][0]["moe"]
    assert "mlp" not in a["blocks"][0]
    assert moe["router"].dtype == torch.float32
    assert moe["router"].shape == (cfg.d_model, cfg.moe.n_experts)
    assert moe["wg"].dtype == moe["wd"].dtype == torch.bfloat16
    assert moe["wd"].shape == (cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model)
    assert torch.equal(a["blocks"][1]["moe"]["wu"], b["blocks"][1]["moe"]["wu"])
    _, jp, _, tp = _models(arch, dtype="bfloat16")
    assert tp["blocks"][1]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tp["blocks"][1]["moe"]["router"].numpy(),
                                  np.asarray(jp["blocks"][0]["moe"]["router"][1]))
    assert tp["blocks"][1]["moe"]["wg"].dtype == torch.bfloat16


def test_full_moe_configs_build():
    for arch in MOE:
        cfg = get_config(arch)
        model = build_model(cfg)
        assert model.cfg.family == "moe" and model.cfg.moe.n_experts in (8, 64)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).family not in ("dense", "moe")])
def test_later_families_not_ported_yet(arch):
    with pytest.raises(NotImplementedError, match="slice"):
        build_model(get_config(arch).reduced())
