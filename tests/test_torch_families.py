"""The port's vlm, ssm, hybrid and audio families against the JAX reference.

Qwen2-VL (M-RoPE), RWKV6, Zamba2 (Mamba2 + one shared attention block) and
Whisper (encoder-decoder with cross-attention), at the reference's
``reduced()`` sizes, on weights bridged from the reference's params
(``jax.tree.map(np.asarray)`` and ``repro_torch.bridge``); inputs are made
with numpy from a seed.  Tolerances are ``test_torch_models.py``'s and
``test_torch_train.py``'s: in float32 (``compute_dtype="float32"`` in both
packages, which then differ only in summation order) 1e-4 on logits and
layer outputs of magnitude ~1, the loss at 1e-5 and each gradient leaf at
1e-4 of that leaf's largest element; in bf16, atol ``BF16_ATOL`` 0.05 on
logits (about six bf16 steps at that magnitude; the frameworks round
intermediate results at different places) and 1e-2 on a loss.  Params
after an Adam step are compared in units of the learning rate, as in
``test_torch_train.py``.  Whisper's K biases have a gradient that is zero
in exact arithmetic (softmax is invariant to a constant added to every
key's score, and Whisper has no rotary embedding), so both frameworks give
rounding noise there: a leaf's scale is floored at ``ZERO_GRAD_FLOOR`` of
the largest element of the whole tree.  No Pallas kernel lies on these
families.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.bridge import (params_from_numpy, params_to_numpy,  # noqa: E402
                                train_state_from_numpy, train_state_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import mamba2, rwkv6  # noqa: E402
from repro_torch.models.transformer import keeps_float32, to_compute_dtype  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.host_store import BACKENDS  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

F32_TOL = 1e-4
BF16_ATOL = 5e-2
LOSS_TOL = 1e-5
BF16_LOSS_TOL = 1e-2
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6
PARAM_OFF_SHARE = 1e-3
ZERO_GRAD_FLOOR = 1e-3
FAMILIES = ("qwen2-vl-72b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny")
TRAINED = ("rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny")    # the reference's smoke train step
RECURRENT = ("rwkv6-1.6b", "zamba2-2.7b")


def _cfgs(arch, dtype="float32", **changes):
    """The same reduced config in both packages."""
    jc = dataclasses.replace(jax_get_config(arch).reduced(), compute_dtype=dtype, **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype, **changes)
    return jc, tc


def _models(arch, dtype="float32", seed=0):
    jc, tc = _cfgs(arch, dtype)
    jm = jax_build_model(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(tc), tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _batches(cfg, seed, B=2, S=12):
    """The same batch for both packages: tokens, plus Whisper's encoder
    features."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["encoder_feats"] = rng.normal(size=(B, cfg.encdec.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)


def _j(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype=np.float32)), tree)


# --------------------------------------------------------------- layers ----
@pytest.mark.parametrize("streams", ["text", "distinct"])
def test_mrope_angles(streams):
    jc, tc = _cfgs("qwen2-vl-72b")
    rng = np.random.default_rng(0)
    if streams == "text":
        pos = np.broadcast_to(rng.integers(0, 5000, (1, 2, 7)), (3, 2, 7)).astype(np.int32)
    else:
        pos = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
    for sections, hd, theta in ((jc.mrope_sections, jc.head_dim, jc.rope_theta),
                                ((16, 24, 24), 128, 1_000_000.0)):
        jcos, jsin = jax_layers.mrope_angles(jnp.asarray(pos), hd, theta, sections)
        tcos, tsin = layers.mrope_angles(torch.from_numpy(pos.copy()), hd, theta, sections)
        assert tcos.dtype == torch.float32 and tcos.shape == (2, 7, hd // 2)
        _close(tcos, jcos, 1e-5)
        _close(tsin, jsin, 1e-5)
        if streams == "text":     # equal streams: plain RoPE
            rcos, rsin = layers.rope_angles(torch.from_numpy(pos[0].copy()), hd, theta)
            assert torch.equal(rcos, tcos) and torch.equal(rsin, tsin)


@pytest.mark.parametrize("seq,d", [(1500, 384), (32, 256), (7, 10)])
def test_sinusoidal_embedding(seq, d):
    got = layers.sinusoidal_embedding(seq, d)
    want = np.asarray(jax_layers.sinusoidal_embedding(seq, d))
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_array_equal(got.numpy(), want)


def _attn_params(cfg, rng):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd), "wo": (H * hd, D),
              "bq": (H * hd,), "bk": (KV * hd,), "bv": (KV * hd,)}
    return {k: rng.normal(size=s).astype(np.float32) / np.sqrt(s[0]) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_ATOL)])
def test_cross_attention_ctx(dtype, tol):
    """``attention_ctx(kv_x=...)``: K/V from the encoder output, not causal."""
    jc, tc = _cfgs("whisper-tiny", dtype)
    rng = np.random.default_rng(1)
    p = _attn_params(jc, rng)
    x = rng.normal(size=(2, 9, jc.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 20, jc.d_model)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jout, (jk, jv) = jax_attn.attention_ctx(
        jc, _j(p), jnp.asarray(x).astype(jd), rope=None, causal=False,
        kv_x=jnp.asarray(enc).astype(jd), return_kv=True)
    tout, (tk, tv) = attn.attention_ctx(
        tc, _t(p), torch.from_numpy(x).to(td), rope=None, causal=False,
        kv_x=torch.from_numpy(enc).to(td), return_kv=True)
    assert tk.shape == (2, 20, tc.n_kv_heads, tc.head_dim) and tout.dtype == td
    for g, w in ((tout, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=0 if tol == BF16_ATOL else tol)


def test_wkv_step():
    rng = np.random.default_rng(2)
    B, nh, hs = 2, 3, 8
    S, r, k, v = (rng.normal(size=s).astype(np.float32) for s in
                  ((B, nh, hs, hs), (B, nh, hs), (B, nh, hs), (B, nh, hs)))
    w = rng.uniform(0.5, 1.0, (B, nh, hs)).astype(np.float32)
    u = rng.normal(size=(nh, hs)).astype(np.float32)
    jS, jy = jax_rwkv6._wkv_step(*_j((S, r, k, v, w, u)))
    tS, ty = rwkv6._wkv_step(*_t((S, r, k, v, w, u)))
    _close(tS, jS, 1e-5)
    _close(ty, jy, 1e-5)


def _block_params(init_fn, cfg, seed):
    """Reference block params with their constant leaves randomized too."""
    p = jax.tree.map(np.asarray, init_fn(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32), p)


def _rwkv_state(cfg, rng, B):
    D, hs = cfg.d_model, cfg.ssm.head_size
    return {"S": rng.normal(size=(B, D // hs, hs, hs)).astype(np.float32),
            "x_tm": rng.normal(size=(B, 1, D)).astype(np.float32),
            "x_cm": rng.normal(size=(B, 1, D)).astype(np.float32)}


@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_and_channel_mix(carried):
    jc, tc = _cfgs("rwkv6-1.6b")
    p = _block_params(jax_rwkv6.init_rwkv_block, jc, 3)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, jc.d_model)).astype(np.float32)
    st = _rwkv_state(jc, rng, 2) if carried else None
    jy, jst = jax_rwkv6.time_mix(jc, _j(p["tm"]), jnp.asarray(x), _j(st) if carried else None)
    ty, tst = rwkv6.time_mix(tc, _t(p["tm"]), torch.from_numpy(x), _t(st) if carried else None)
    _close(ty, jy)
    _close(tst["S"], jst["S"])
    _close(tst["x_tm"], jst["x_tm"], 0)
    jc_y, jlast = jax_rwkv6.channel_mix(jc, _j(p["cm"]), jnp.asarray(x),
                                        _j(st) if carried else None)
    tc_y, tlast = rwkv6.channel_mix(tc, _t(p["cm"]), torch.from_numpy(x),
                                    _t(st) if carried else None)
    _close(tc_y, jc_y)
    _close(tlast, jlast, 0)


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv(carried):
    jc, tc = _cfgs("zamba2-2.7b")
    p = _block_params(jax_mamba2.init_mamba_block, jc, 4)
    rng = np.random.default_rng(4)
    C = p["conv_w"].shape[1]
    xbc = rng.normal(size=(2, 7, C)).astype(np.float32)
    st = rng.normal(size=(2, p["conv_w"].shape[0] - 1, C)).astype(np.float32) if carried else None
    jo, jst = jax_mamba2._causal_conv(_j(p), jnp.asarray(xbc), _j(st) if carried else None)
    to, tst = mamba2._causal_conv(_t(p), torch.from_numpy(xbc), _t(st) if carried else None)
    _close(to, jo, 1e-5)
    _close(tst, jst, 0)


@pytest.mark.parametrize("carried", [False, True])
def test_apply_mamba_block(carried):
    jc, tc = _cfgs("zamba2-2.7b")
    p = _block_params(jax_mamba2.init_mamba_block, jc, 5)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, jc.d_model)).astype(np.float32)
    st = None
    if carried:
        d_in, hs, nh, N = jax_mamba2.dims(jc)
        st = {"h": rng.normal(size=(2, nh, hs, N)).astype(np.float32),
              "conv": rng.normal(size=(2, jc.ssm.conv_kernel - 1, d_in + 2 * N))
              .astype(np.float32)}
    jy, jst = jax_mamba2.apply_mamba_block(jc, _j(p), jnp.asarray(x), _j(st) if carried else None)
    ty, tst = mamba2.apply_mamba_block(tc, _t(p), torch.from_numpy(x), _t(st) if carried else None)
    _close(ty, jy)
    _close(tst["h"], jst["h"])
    _close(tst["conv"], jst["conv"])


def test_chunked_time_scan_equals_flat_loop():
    """T = 512 (two chunks of TIME_CHUNK under checkpoint): values and
    gradients bit-equal to the flat loop's, values as the reference's."""
    assert mamba2.TIME_CHUNK == 256 == jax_mamba2.TIME_CHUNK
    rng = np.random.default_rng(6)
    T, B, n = 512, 2, 4
    a = rng.uniform(0.9, 1.0, (T, B, n)).astype(np.float32)
    b = rng.normal(size=(T, B, n)).astype(np.float32)
    c0 = rng.normal(size=(B, n)).astype(np.float32)

    def body(c, inp):
        a_t, b_t = inp
        c = a_t * c + torch.tanh(b_t)
        return c, c * b_t

    def run(chunked):
        ta, tb, tc0 = (torch.from_numpy(v).requires_grad_() for v in (a, b, c0))
        fn = mamba2.chunked_time_scan if chunked else mamba2._scan
        c, ys = fn(body, tc0, (ta, tb))
        loss = (ys ** 2).sum() + c.sum()
        return c, ys, torch.autograd.grad(loss, (ta, tb, tc0))

    c1, y1, g1 = run(True)
    c0_, y0, g0 = run(False)
    assert torch.equal(c1, c0_) and torch.equal(y1, y0)
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))

    def jbody(c, inp):
        a_t, b_t = inp
        c = a_t * c + jnp.tanh(b_t)
        return c, c * b_t

    jc_, jys = jax_mamba2.chunked_time_scan(jbody, jnp.asarray(c0), (jnp.asarray(a), jnp.asarray(b)))
    _close(c1, jc_, 1e-5)
    _close(y1, jys, 1e-5)


# ---------------------------------------------------------- whole model ----
def _port_caches_from_ref(arch, ref):
    """The reference's forward caches in the port's per-layer form."""
    if arch == "qwen2-vl-72b":
        (k, v), = ref
        return np.asarray(k), np.asarray(v)
    if arch == "rwkv6-1.6b":
        return [{n: np.asarray(ref[n][i]) for n in ("S", "x_tm", "x_cm")}
                for i in range(ref["S"].shape[0])]
    if arch == "zamba2-2.7b":
        mstack, (k, v) = ref
        trip, every = mstack["h"].shape[:2]
        return {"mamba": [{n: np.asarray(mstack[n][u, i]) for n in ("h", "conv")}
                          for u in range(trip) for i in range(every)],
                "kv": [(np.asarray(k[u]), np.asarray(v[u])) for u in range(trip)]}
    (k, v), (ck, cv) = ref
    return {"self": [(np.asarray(k[i]), np.asarray(v[i])) for i in range(k.shape[0])],
            "cross": [{"k": np.asarray(ck[i]), "v": np.asarray(cv[i])}
                      for i in range(ck.shape[0])]}


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_caches_match_reference(arch):
    jm, jp, tm, tp = _models(arch)
    jb, tb = _batches(jm.cfg, 7)
    jl, jaux, jcache = jm.forward(jp, jb, remat=False, want_cache=True)
    tl, taux, tcache = tm.forward(tp, tb, want_cache=True)
    assert tl.shape == (2, 12, tm.cfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    assert float(taux) == 0.0 == float(jaux)
    want = _port_caches_from_ref(arch, jcache)
    got = tree_map(lambda t: t, tcache)
    if arch == "qwen2-vl-72b":
        got = (got[0], got[1])
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def _ref_cross(jm, jp, jb):
    """The reference's cross K/V from its forward, as its decode caches take
    them (``init_caches`` fills zeros; the caller fills them)."""
    _, _, ((_, _), (ck, cv)) = jm.forward(jp, jb, remat=False, want_cache=True)
    return {"k": ck, "v": cv}


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_reference(arch):
    """Token-by-token decode from the same caches in both packages (Whisper's
    cross K/V filled from the forward's), logits at every step."""
    jm, jp, tm, tp = _models(arch)
    jb, tb = _batches(jm.cfg, 8, S=6)
    B, S = 2, 6
    jcache = jm.init_caches(B, S + 2)
    tcache = tm.init_caches(B, S + 2, "cpu")
    if arch == "whisper-tiny":
        jcache["cross"] = _ref_cross(jm, jp, jb)
        tcache["cross"] = [{n: torch.from_numpy(np.array(jcache["cross"][n][i]))
                            for n in ("k", "v")} for i in range(tm.cfg.n_layers)]
    toks = np.array(jb["tokens"])
    for t in range(S):
        jl, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                         "pos": jnp.int32(t)}, jcache)
        tl, tcache = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                         "pos": t}, tcache)
        assert tl.shape == (B, 1, tm.cfg.vocab)
        _close(tl, jl)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward_within_port(arch):
    """Teacher forcing in float32: the decode stream from empty caches (the
    reference's ``test_ssm_state_streaming_equivalence`` for rwkv6 and
    zamba2, at a float32 tolerance) reproduces the full forward's logits."""
    _, _, tm, tp = _models(arch)
    _, tb = _batches(tm.cfg, 9, B=1, S=16)
    full, _, cache_out = tm.forward(tp, tb, want_cache=arch == "whisper-tiny")
    caches = tm.init_caches(1, 18, "cpu")
    if arch == "whisper-tiny":
        caches["cross"] = cache_out["cross"]
    for t in range(16):
        dl, caches = tm.decode_step(tp, {"tokens": tb["tokens"][:, t:t + 1], "pos": t}, caches)
        _close(dl[:, 0], full[:, t])


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_states_continue_the_sequence(arch):
    """Decoding from the states ``forward(want_cache=True)`` returns gives
    the logits of the longer sequence's forward."""
    _, _, tm, tp = _models(arch)
    _, tb = _batches(tm.cfg, 10, B=2, S=14)
    full, _, _ = tm.forward(tp, tb)
    _, _, cache = tm.forward(tp, {"tokens": tb["tokens"][:, :10]}, want_cache=True)
    if arch == "zamba2-2.7b":
        cache = {"mamba": cache["mamba"],
                 "attn": [attn.prefill_cache(tm.cfg, k, v, 16) for k, v in cache["kv"]]}
    for t in range(10, 14):
        dl, cache = tm.decode_step(tp, {"tokens": tb["tokens"][:, t:t + 1], "pos": t}, cache)
        _close(dl[:, 0], full[:, t])


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_bf16_through_to_compute_dtype(arch):
    """Serving's bf16 params (``to_compute_dtype`` keeps float32 exactly the
    leaves the reference reads through ``.astype(float32)``) against the
    reference's bf16 forward from its float32 params."""
    jm, jp, tm, tp = _models(arch, dtype="bfloat16")
    jb, tb = _batches(jm.cfg, 11)
    jl, _, _ = jm.forward(jp, jb, remat=False)
    tl, _, _ = tm.forward(tp, tb)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), _np(jl), atol=BF16_ATOL, rtol=0)


# Every float32 leaf of serving's params, by family (leaf path suffixes).
SERVING_F32 = {
    "qwen2-vl-72b": {"final_norm.scale", "ln1.scale", "ln2.scale"},
    "rwkv6-1.6b": {"final_norm.scale", "ln_in.scale", "ln_in.bias", "ln1.scale", "ln1.bias",
                   "ln2.scale", "ln2.bias", "final_norm.bias", "tm.w0", "tm.u",
                   "tm.ln_scale"},
    "zamba2-2.7b": {"final_norm.scale", "ln.scale", "ln1.scale", "ln2.scale", "body.A_log",
                    "body.dt_bias", "body.D_skip", "body.norm_scale"},
    "whisper-tiny": {"enc_norm.scale", "enc_norm.bias", "dec_norm.scale", "dec_norm.bias",
                     "ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias", "ln_x.scale",
                     "ln_x.bias"},
}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _paths(t, prefix)]
    return [(prefix, tree)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_to_compute_dtype_float32_leaves(arch):
    tc = get_config(arch).reduced()
    params = build_model(tc).init(torch.Generator().manual_seed(0))
    f32 = {".".join(p.split(".")[-2:]) for p, t in _paths(params) if t.dtype == torch.float32}
    assert f32 == SERVING_F32[arch]
    assert not any(t.dtype not in (torch.float32, torch.bfloat16) for _, t in _paths(params))
    assert keeps_float32("w0") and keeps_float32("ln_scale") and not keeps_float32("wA")
    if arch == "rwkv6-1.6b":     # bf16 would round the decay's w0 = -6 + x
        assert params["blocks"][0]["body"]["tm"]["w0"].dtype == torch.float32
    again = to_compute_dtype(tc, params)
    assert all(a.dtype == b.dtype for (_, a), (_, b) in zip(_paths(again), _paths(params)))


# --------------------------------------------------------------- training ----
def _states(arch, dtype="float32", seed=0):
    jc, tc = _cfgs(arch, dtype)
    jm = jax_build_model(jc)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(seed))
    ts = train_state_from_numpy(tc, jax.tree.map(np.asarray, js), device="cpu")
    return jm, js, build_model(tc), ts


def _named(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _close_leaves(got, want, rtol):
    """Each leaf of ``got`` within ``rtol`` of the largest element of the
    matching leaf of ``want``, floored at ``ZERO_GRAD_FLOOR`` of the tree's
    largest element."""
    got_l = jax.tree.leaves(got)
    named = _named(want)
    assert len(got_l) == len(named)
    floor = ZERO_GRAD_FLOOR * max(float(np.abs(w).max()) for _, w in named)
    for (name, w), g in zip(named, got_l):
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), floor, 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (name, err, scale)


def _vlm_batch(cfg, seed, B=2, S=12):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return ({"embeds": jnp.asarray(emb), "labels": jnp.asarray(labels)},
            {"embeds": torch.from_numpy(emb), "labels": torch.from_numpy(labels)})


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference_f32(arch):
    jm, js, tm, ts = _states(arch)
    jb, tb = _vlm_batch(jm.cfg, 12) if arch == "qwen2-vl-72b" else _batches(jm.cfg, 12)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb)))(js["params"])
    leaves = tree_map(lambda p: p.detach().requires_grad_(), ts["params"])
    tloss = tm.loss(leaves, tb)
    grads = torch.autograd.grad(tloss, tree_leaves(leaves), allow_unused=True,
                                materialize_grads=True)   # vlm: embed unused
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_TOL
    _close_leaves(params_to_numpy(tm.cfg, tree_unflatten(leaves, grads)), jgrads, GRAD_RTOL)


@pytest.fixture
def deterministic():
    """torch's CPU embedding backward accumulates repeated tokens in an order
    that may vary between runs; the deterministic mode fixes it."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", TRAINED)
def test_remat_gives_the_same_gradients(arch, deterministic):
    """Per-layer (per-super-block) recomputation, with the time scan's own
    chunk checkpoints nested inside at T = 512, changes no gradient."""
    _, _, tm, ts = _states(arch, seed=2)
    S = 512 if arch != "whisper-tiny" else 24
    _, tb = _batches(tm.cfg, 13, B=1, S=S)

    def grads(remat):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), ts["params"])
        loss = tm.loss(leaves, tb, remat=remat)
        return loss, torch.autograd.grad(loss, tree_leaves(leaves))

    l1, g1 = grads(True)
    l0, g0 = grads(False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("arch", TRAINED)
def test_train_step_matches_reference_f32(arch):
    """One ``make_train_step`` step (the reference's ``test_smoke_train_step``
    families) from the same state on the same batch."""
    jm, js, tm, ts = _states(arch, seed=3)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jb, tb = _batches(jm.cfg, 14)
    js, jmet = jax.jit(jax_loop.make_train_step(jm, jax_opt.AdamWConfig(**kw),
                                                cast_params=False))(js, jb)
    ts, tmet = loop.make_train_step(tm, opt.AdamWConfig(**kw), cast_params=False)(ts, tb)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_TOL
    assert abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"]) - 1) <= 1e-5
    got = train_state_to_numpy(tm.cfg, ts)
    assert int(got["opt"]["step"]) == 1
    for key in ("m", "v"):
        _close_leaves(got["opt"][key], js["opt"][key], GRAD_RTOL)
    lr = float(jmet["lr"])
    off = total = 0
    for (name, w), g in zip(_named(js["params"]), jax.tree.leaves(got["params"])):
        err = np.abs(g - w)
        assert float(err.max()) <= 2 * lr, (name, float(err.max()))
        off += int((err > PARAM_ATOL).sum())
        total += err.size
    assert off <= PARAM_OFF_SHARE * total, (off, total)


def _port_dtypes(cfg, params):
    """Dtype names of the port's params in the reference's leaf order (the
    bridge restacks stand-ins: float16 for bf16, which numpy lacks)."""
    marks = tree_map(lambda t: torch.zeros(1, dtype=torch.float32 if t.dtype == torch.float32
                                           else torch.float16), params)
    return [{"float16": "bfloat16"}.get(str(a.dtype), str(a.dtype))
            for a in jax.tree.leaves(params_to_numpy(cfg, marks))]


@pytest.mark.parametrize("arch", FAMILIES)
def test_cast_params_for_compute_rule(arch):
    """The reference's rule, ndim >= 2 in its stacked layout, on each
    family's stacked keys: every leaf of ``blocks`` / ``supers`` /
    ``enc_blocks`` / ``dec_blocks`` to bf16 (Mamba2's and RWKV6's 1-D
    leaves too), unstacked 1-D leaves (norms, the shared attention's norms)
    float32, Whisper's 2-D ``dec_pos`` bf16."""
    _, js, tm, ts = _states(arch)
    cast = loop.cast_params_for_compute(ts["params"])
    want = jax_loop.cast_params_for_compute(js["params"])
    assert [str(w.dtype) for _, w in _named(want)] == _port_dtypes(tm.cfg, cast)
    if arch == "zamba2-2.7b":
        assert cast["supers"][0]["body"]["A_log"].dtype == torch.bfloat16
        assert cast["shared_attn"]["ln1"]["scale"].dtype == torch.float32
        assert cast["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    if arch == "whisper-tiny":
        assert cast["dec_pos"].dtype == torch.bfloat16
        assert cast["dec_norm"]["bias"].dtype == torch.float32


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_bf16_through_compute_cast(arch):
    jm, js, tm, ts = _states(arch, dtype="bfloat16", seed=1)
    jb, tb = _batches(jm.cfg, 15)
    want = jm.loss(jax_loop.cast_params_for_compute(js["params"]), jb)
    with torch.no_grad():
        got = tm.loss(loop.cast_params_for_compute(ts["params"]), tb)
    assert abs(float(got) - float(want)) <= BF16_LOSS_TOL


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("arch", TRAINED)
def test_checkpoint_across_packages(arch, direction, tmp_path):
    jm, js, tm, ts = _states(arch, seed=4)
    jb, _ = _batches(jm.cfg, 16)
    js, _ = jax.jit(jax_loop.make_train_step(
        jm, jax_opt.AdamWConfig(lr=1e-3, warmup_steps=1), cast_params=False))(js, jb)
    ts = train_state_from_numpy(tm.cfg, jax.tree.map(np.asarray, js), device="cpu")
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        jax_ckpt.save_checkpoint(path, js, step=1)
        tree = ckpt.restore_checkpoint(path, train_state_to_numpy(tm.cfg, ts))
        got = train_state_from_numpy(tm.cfg, tree, device="cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(ts)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        ckpt.save_checkpoint(path, train_state_to_numpy(tm.cfg, ts), step=1)
        got = jax_ckpt.restore_checkpoint(path, js)
        for (name, w), g in zip(_named(js), jax.tree.leaves(got)):
            g = np.asarray(g)
            assert g.dtype == w.dtype and np.array_equal(g, w), name
    with np.load(path) as f:
        manifest = json.loads(str(f["__manifest__"]))
    assert manifest["n_leaves"] == len(jax.tree.leaves(js)) and manifest["step"] == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_round_trip_through_bridge(arch):
    """Reference params -> port -> reference layout: bit-equal, in
    ``jax.tree_util`` order."""
    _, js, tm, ts = _states(arch, seed=5)
    back = params_to_numpy(tm.cfg, ts["params"])
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, js["params"]))
    for (name, w), g in zip(_named(js["params"]), jax.tree.leaves(back)):
        assert np.array_equal(g, w), name


# ------------------------------------------------------------------- vlm ----
def test_qwen2vl_mrope_text_equals_rope_shape():
    """2-D text positions and the same positions broadcast to [3, B, S] give
    the same logits bit for bit, and equal the reference's from embeddings."""
    jm, jp, tm, tp = _models("qwen2-vl-72b")
    jb, tb = _vlm_batch(jm.cfg, 17, S=8)
    pos2 = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    pos3 = np.broadcast_to(pos2, (3, 2, 8)).copy()
    l2, _, _ = tm.forward(tp, dict(tb, positions=torch.from_numpy(pos2)))
    l3, _, _ = tm.forward(tp, dict(tb, positions=torch.from_numpy(pos3)))
    assert l3.shape == (2, 8, tm.cfg.vocab) and torch.equal(l2, l3)
    jl, _, _ = jm.forward(jp, dict(jb, positions=jnp.asarray(pos3)), remat=False)
    _close(l3, jl)


def test_vlm_serving_hit_equals_miss():
    """The engine serves qwen2-vl as it serves dense, through every fetch
    backend; in float32 every hit gives the miss path's tokens, which are
    the reference engine's."""
    jm, jp, tm, tp = _models("qwen2-vl-72b")
    eng = ServeEngine(tm, tp, device="cpu")
    prompts = np.random.default_rng(18).integers(0, tm.cfg.vocab, (2, 33)).astype(np.int32)
    miss = eng.generate(prompts, ["a", "b"], 5)
    assert not miss.request_stats[0].cache_hit
    for backend in BACKENDS:
        hit = eng.generate(prompts, ["a", "b"], 5, fetch_backend=backend)
        assert hit.request_stats[0].cache_hit
        np.testing.assert_array_equal(hit.tokens, miss.tokens, err_msg=backend)
    ref = JaxServeEngine(jm, jp).generate(prompts, ["a", "b"], 5)
    np.testing.assert_array_equal(miss.tokens, np.asarray(ref.tokens))


# ------------------------------------------------------------- launchers ----
@pytest.mark.parametrize("arch", TRAINED)
def test_train_launcher_trains_new_family(arch, tmp_path):
    """The reduced config trains on the CPU (the launcher asserts the loss
    falls) and writes a checkpoint the reference restores."""
    path = str(tmp_path / "run.npz")
    launch_train.main(["--device", "cpu", "--arch", arch, "--steps", "8", "--seq", "32",
                       "--batch", "2", "--lr", "3e-3", "--checkpoint", path])
    jc = jax_get_config(arch).reduced()
    like = jax_loop.init_train_state(jax_build_model(jc), jax.random.PRNGKey(0))
    got = jax_ckpt.restore_checkpoint(path, like)
    assert int(got["opt"]["step"]) == 8 and os.path.getsize(path) > 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny"])
def test_serve_launcher_refuses_non_decoder_families(arch):
    with pytest.raises(SystemExit, match="not servable by this engine"):
        launch_serve.main(["--device", "cpu", "--arch", arch, "--ctx", "16", "--new", "2"])


def test_serve_launcher_serves_vlm(capsys):
    launch_serve.main(["--device", "cpu", "--arch", "qwen2-vl-72b", "--batch", "2",
                       "--ctx", "24", "--new", "3"])
    out = capsys.readouterr().out
    assert out.count("tokens_match=True") == len(BACKENDS)
