"""The causal flash-attention prefill kernel and the rule that sends
``attention_ctx`` to it.

The rule (``prefill_kernel_applies``) and the wiring run here on the CPU:
every input the rule sends to the dense and chunked paths, the benchmark
configurations' case that it sends to the kernel, and, with the rule forced,
the wrapper's plain version against the dense path.  The kernel itself has
no CPU mode: the tests marked ``gpu`` compare it on the card with a float32
causal attention and with the dense path, and skip without a card.  This file
imports neither JAX nor the JAX package.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_prefill_attention.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.prefill_attention import ops  # noqa: E402
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

# The benchmark configurations' prefill: bf16 causal inference on the card.
KERNEL_CASE = dict(device_type="cuda", dtype=torch.bfloat16, plain=True, needs_grad=False,
                   cross=False, causal=True, cap=None, window=None, head_dim=128, costing=False)
FALLBACKS = {
    "grad_on": dict(needs_grad=True),
    "float32": dict(dtype=torch.float32),
    "cpu": dict(device_type="cpu"),
    "meta": dict(device_type="meta"),
    "fake_or_dtensor": dict(plain=False),
    "kv_x": dict(cross=True),
    "not_causal": dict(causal=False),
    "softcap": dict(cap=50.0),
    "window": dict(window=4096),
    "head_dim_96": dict(head_dim=96),
    "costing": dict(costing=True),
}
# (B, S, KV, G, hd): qwen2-vl's GQA group, olmoe's MHA at a length that is no
# multiple of a tile, one token, an odd length, and head_dim 64 at G 7.
SHAPES = {"qwen2vl_gqa": (2, 2048, 8, 8, 128), "olmoe_mha": (2, 4080, 16, 1, 128),
          "s1": (3, 1, 2, 4, 128), "s333": (2, 333, 2, 3, 128), "hd64": (2, 300, 2, 7, 64)}
CPU_SHAPES = {"gqa": (2, 70, 2, 4, 128), "mha": (1, 130, 3, 1, 128), "s1": (2, 1, 2, 4, 128),
              "odd": (1, 67, 1, 3, 64), "hd64": (2, 33, 2, 7, 64)}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_rule_falls_back(name):
    assert attn.prefill_kernel_applies(**KERNEL_CASE)
    assert not attn.prefill_kernel_applies(**{**KERNEL_CASE, **FALLBACKS[name]})


@pytest.mark.parametrize("arch,layers", [("qwen2-vl-72b", 8), ("olmoe-1b-7b", None)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rule_takes_the_benchmark_configurations(arch, layers, dtype):
    """Every layer of both benchmark configurations, bf16 (or fp16) on the
    card without grad, takes the kernel."""
    from repro_torch.models.transformer import layer_windows
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    for window in layer_windows(cfg):
        assert attn.prefill_kernel_applies(**{**KERNEL_CASE, "dtype": dtype, "window": window,
                                              "cap": cfg.attn_softcap,
                                              "head_dim": cfg.head_dim})


def _qkv(B, S, KV, G, hd, dtype=torch.bfloat16, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, S, KV, G, hd), generator=g, device=device)
    k = torch.randn((B, S, KV, hd), generator=g, device=device)
    v = torch.randn((B, S, KV, hd), generator=g, device=device)
    # one channel of V rises with the key's position: leaving out any tile of
    # keys moves it well past the tolerance
    v[..., 0] = 4.0 * torch.arange(S, device=device)[None, :, None] / S
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("case", ["cpu_bf16", "meta", "grad", "float32", "costing"])
def test_operands_choose_the_dense_path(case):
    """What the operands show: CPU, meta, grad-requiring and float32 tensors,
    and any tensor inside ``dense_attention_for_costing``, are not the
    kernel's."""
    q, k, v = _qkv(1, 8, 1, 2, 128)
    if case == "meta":
        q, k, v = (t.to("meta") for t in (q, k, v))
    if case == "grad":
        q.requires_grad_(True)
    if case == "float32":
        q, k, v = (t.float() for t in (q, k, v))
    kw = dict(kv_x=None, causal=True, window=None, cap=None)
    if case == "costing":
        with attn.dense_attention_for_costing():
            assert attn._costing == 1
            assert not attn._prefill_kernel_applies(q, k, v, **kw)
        assert attn._costing == 0
    else:
        assert not attn._prefill_kernel_applies(q, k, v, **kw)


def test_cpu_attention_ctx_never_calls_the_kernel(monkeypatch):
    """On the CPU ``attention_ctx`` keeps its dense and chunked paths."""
    def refuse(*a, **kw):
        raise AssertionError("the prefill kernel was called on the CPU")
    monkeypatch.setattr(attn.prefill_ops, "prefill_attention", refuse)
    cfg = dataclasses.replace(get_config("qwen2-vl-72b").reduced(), compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = attn.init_attention(cfg, gen)
    x = torch.randn((2, 16, cfg.d_model), generator=gen).bfloat16()
    with torch.no_grad():
        attn.attention_ctx(cfg, p, x, rope=None)


@pytest.mark.parametrize("name", sorted(CPU_SHAPES))
def test_forced_rule_runs_the_wrapper_like_the_dense_path(name, monkeypatch):
    """With the rule forced, ``attention_ctx`` calls the wrapper inside the
    ``attn.prefill_kernel`` span; on the CPU the wrapper's plain version
    agrees with the dense path to bf16 rounding."""
    B, S, KV, G, hd = CPU_SHAPES[name]
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_heads=KV * G,
                              n_kv_heads=KV, head_dim=hd, d_model=64, attn_softcap=None)
    gen = torch.Generator().manual_seed(1)
    p = {k: v.bfloat16() for k, v in attn.init_attention(cfg, gen).items()}
    x = torch.randn((B, S, cfg.d_model), generator=gen).bfloat16()
    dense = attn.attention_ctx(cfg, p, x, rope=None)
    calls = []
    real = attn.prefill_ops.prefill_attention
    monkeypatch.setattr(attn, "_prefill_kernel_applies", lambda *a, **kw: True)
    monkeypatch.setattr(attn.prefill_ops, "prefill_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    got = attn.attention_ctx(cfg, p, x, rope=None)
    assert calls == [(B, S, KV, G, hd)]
    torch.testing.assert_close(got.float(), dense.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", sorted(CPU_SHAPES))
def test_plain_version_against_float32(name):
    """``prefill_attention_ref`` (the kernel's arithmetic) against a float32
    causal attention and against the dense block."""
    q, k, v = _qkv(*CPU_SHAPES[name])
    got = ops.prefill_attention(q, k, v)
    want = _f32_attention(q, k, v)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    pos = torch.arange(q.shape[1], dtype=torch.int32)
    dense = attn._attn_scores_block(q, k, v, pos, pos, head_dim=q.shape[-1], causal=True,
                                    window=None, cap=None)
    torch.testing.assert_close(got.float(), dense.float(), atol=2e-2, rtol=2e-2)


def _f32_attention(q, k, v):
    """Plain float32 causal attention, [B,S,KV,G,hd] in float32."""
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v.float())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _qkv(1, 4, 1, 2, 64)
    with pytest.raises(TypeError):
        ops.prefill_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        ops.prefill_attention(q, k[:, :3], v[:, :3])
    with pytest.raises(ValueError):
        ops.prefill_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ------------------------------------------------------------------ card ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_against_float32_and_dense(cuda, name, dtype):
    """The kernel against a float32 causal attention and the port's dense
    path; the launch counted, no fault at synchronize, and its events in a
    profiler trace under ``KERNEL_SYMBOL`` (the name the benchmark reads)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _qkv(*SHAPES[name], dtype=dtype, device=cuda)
    before = ops.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ops.prefill_attention(q, k, v)
        torch.cuda.synchronize()
    assert ops.launches == before + 1
    names = [ev.name for ev in prof.events() if ops.KERNEL_SYMBOL in ev.name]
    assert len(names) == 1, [ev.name for ev in prof.events()]
    want = _f32_attention(q, k, v)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    pos = torch.arange(q.shape[1], dtype=torch.int32, device=cuda)
    dense = attn._attn_scores_block(q, k, v, pos, pos, head_dim=q.shape[-1], causal=True,
                                    window=None, cap=None)
    torch.testing.assert_close(got.float(), dense.float(), atol=2e-2, rtol=2e-2)
    # no further from float32 than the dense path is
    assert (got.float() - want).abs().max() <= (dense.float() - want).abs().max() + 2e-3


@pytest.mark.gpu
def test_kernel_reads_strided_operands(cuda):
    """q, k and v as views with gaps between rows (the wrapper copies
    nothing): the same result as contiguous operands, bit for bit."""
    B, S, KV, G, hd = 2, 200, 2, 4, 128
    q, k, v = _qkv(B, S, KV, G, hd, device=cuda)
    wide_q = torch.zeros((B, S, KV, G + 1, hd), dtype=q.dtype, device=cuda)
    wide_q[:, :, :, :G] = q
    kv = torch.stack((k, v), dim=3)                  # [B, S, KV, 2, hd]
    got = ops.prefill_attention(wide_q[:, :, :, :G], kv[:, :, :, 0], kv[:, :, :, 1])
    torch.cuda.synchronize()
    assert torch.equal(got, ops.prefill_attention(q, k, v))


@pytest.mark.gpu
def test_attention_ctx_takes_the_kernel_on_the_card(cuda):
    """bf16 inference through ``attention_ctx`` launches the kernel once a
    call; with grad on it keeps the dense path."""
    cfg = dataclasses.replace(get_config("qwen2-vl-72b").reduced(), compute_dtype="bfloat16",
                              n_heads=8, n_kv_heads=2, head_dim=128, d_model=256)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {k: v.bfloat16() for k, v in attn.init_attention(cfg, gen).items()}
    x = torch.randn((2, 96, cfg.d_model), generator=gen, device=cuda).bfloat16()
    before = ops.launches
    with torch.no_grad():
        got = attn.attention_ctx(cfg, p, x, rope=None)
    assert ops.launches == before + 1
    x.requires_grad_(True)
    dense = attn.attention_ctx(cfg, p, x, rope=None)
    assert ops.launches == before + 1
    torch.testing.assert_close(got.float(), dense.detach().float(), atol=3e-2, rtol=3e-2)
