"""The port's CUDA kernels and serving path on the card.

Every test here is marked ``gpu`` and skips where no card is present (the
CUDA kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref  # noqa: E402
from repro_torch.kernels.paged_kv_gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.paged_kv_gather.ref import paged_kv_gather_ref  # noqa: E402
from repro_torch.kernels.ring_all_gather import ops as ag_ops  # noqa: E402
from repro_torch.kernels.ring_all_gather.ref import all_gather_ref  # noqa: E402
from repro_torch.kernels.ring_all_to_all import ops as aa_ops  # noqa: E402
from repro_torch.kernels.ring_all_to_all.ref import all_to_all_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.host_store import BACKENDS  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_pool,bt,dkv,n", [(64, 16, 3072, 80), (8, 8, 12, 5), (5, 3, 7, 9)])
def test_gather_kernel_bit_equal(cuda, dtype, n_pool, bt, dkv, n):
    """Vector path (16-byte rows) and the scalar paths, with repeats."""
    g = torch.Generator(device=cuda).manual_seed(0)
    pool = torch.randn((n_pool, bt, dkv), generator=g, device=cuda).to(dtype)
    tbl = torch.randint(0, n_pool, (n,), generator=g, device=cuda, dtype=torch.int32)
    before = gather_ops.launches
    out = gather_ops.gather_blocks(pool, tbl)
    torch.cuda.synchronize()
    assert gather_ops.launches == before + 1
    assert torch.equal(out, paged_kv_gather_ref(pool, tbl))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("B,KV,G,hd,bt,mb", [(4, 2, 7, 64, 16, 66), (4, 4, 2, 256, 8, 3),
                                             (1, 1, 8, 128, 16, 2),
                                             # rows of 72/144, 68/136 and 66/132
                                             # bytes: 8-, 4- and 2-byte copies
                                             (2, 2, 3, 36, 16, 4), (2, 2, 3, 34, 16, 4),
                                             (2, 2, 3, 33, 8, 5),
                                             # f32 blocks too large for two stages
                                             # in shared memory: half-block tiles
                                             (2, 1, 4, 256, 64, 3)])
def test_decode_attention_kernel(cuda, dtype, tol, softcap, B, KV, G, hd, bt, mb):
    g = torch.Generator(device=cuda).manual_seed(B * 31 + mb)
    n_pool = B * mb + 2
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda).to(dtype)
    kp = torch.randn((n_pool, bt, KV, hd), generator=g, device=cuda).to(dtype)
    vp = torch.randn((n_pool, bt, KV, hd), generator=g, device=cuda).to(dtype)
    tables = torch.randint(0, n_pool, (B, mb), generator=g, device=cuda, dtype=torch.int32)
    lengths = torch.randint(1, mb * bt, (B,), generator=g, device=cuda, dtype=torch.int32)
    before = da_ops.launches
    out = da_ops.decode_attention(q, kp, vp, tables, lengths, softcap=softcap)
    ref = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("G,hd", [(7, 64), (2, 256)])
def test_decode_attention_kernel_split_edges(cuda, dtype, tol, softcap, G, hd):
    """Lengths 0 and 1 and bt + 1 (most splits empty), and contexts of 4096
    and 4095 tokens in a table of 257 blocks: the kernel matches its plain
    version, and a sequence of length 0 gives exactly 0."""
    B, KV, bt, mb = 6, 2, 16, 257
    lengths_l = [0, 1, bt + 1, 4096, 4095, 0]
    g = torch.Generator(device=cuda).manual_seed(G * hd)
    n_pool = B * mb + 2
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda).to(dtype)
    kp = torch.randn((n_pool, bt, KV, hd), generator=g, device=cuda).to(dtype)
    vp = torch.randn((n_pool, bt, KV, hd), generator=g, device=cuda).to(dtype)
    tables = torch.randperm(n_pool, generator=g, device=cuda)[:B * mb].reshape(B, mb)
    tables = tables.to(torch.int32).contiguous()
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=cuda)
    before = da_ops.launches
    out = da_ops.decode_attention(q, kp, vp, tables, lengths, softcap=softcap)
    ref = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[0]) == 0 and torch.count_nonzero(out[5]) == 0


def test_engine_hit_equals_miss_float32(cuda, monkeypatch):
    """Reduced qwen2-0.5b in float32 (TF32 off): every hit backend gives the
    miss path's tokens, and the kernel backend goes through the kernel."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), compute_dtype="float32")
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(torch.Generator(device=cuda).manual_seed(0)))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    miss = eng.generate(prompts, ["a", "b"], 6)
    for backend in BACKENDS:
        before = gather_ops.launches
        hit = eng.generate(prompts, ["a", "b"], 6, fetch_backend=backend)
        assert gather_ops.launches - before == (4 if backend == "kernel" else 0)
        np.testing.assert_array_equal(hit.tokens, miss.tokens)


# Shapes: 16-byte words at one and several CTAs per rank, a forced split of a
# small chunk over 3 CTAs, and chunks of 12/6 and 60/30 bytes (f32/bf16: 4-
# and 2-byte words); n = 1 has no ring step.
GATHER_CASES = [(8, 4, 128, None), (8, 512, 1024, None), (8, 4, 128, 3), (6, 3, 1, None),
                (3, 5, 3, 2), (2, 1, 16, None), (1, 7, 8, None)]


@pytest.mark.parametrize("variant", sorted(ag_ops.VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,chunk,f,parts", GATHER_CASES)
def test_ring_all_gather_kernel_bit_equal(cuda, variant, dtype, n, chunk, f, parts):
    g = torch.Generator(device=cuda).manual_seed(n * 100 + chunk)
    xs = torch.randn((n, chunk, f), generator=g, device=cuda).to(dtype)
    before = ag_ops.launches
    out = ag_ops.ring_all_gather(xs, variant, parts=parts)
    ag_ops.check()
    assert ag_ops.launches == before + 1
    assert torch.equal(out, all_gather_ref(xs))


@pytest.mark.parametrize("variant", sorted(aa_ops.VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,chunk,f,parts", GATHER_CASES)
def test_all_to_all_kernel_bit_equal(cuda, variant, dtype, n, chunk, f, parts):
    """n = 8 and 2 pair by XOR, n = 6 and 3 by rotation."""
    g = torch.Generator(device=cuda).manual_seed(n * 100 + chunk + 1)
    xs = torch.randn((n, n, chunk, f), generator=g, device=cuda).to(dtype)
    before = aa_ops.launches
    out = aa_ops.all_to_all(xs, variant, parts=parts)
    aa_ops.check()
    assert aa_ops.launches == before + 1
    assert torch.equal(out, all_to_all_ref(xs))


def test_rank_kernels_refuse_too_many_ctas(cuda):
    """Every CTA must have an SM of its own; more is refused, not launched."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    xs = torch.zeros((8, 4, 128), device=cuda)
    before = ag_ops.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ag_ops.ring_all_gather(xs, parts=sms // 8 + 1)
    assert ag_ops.launches == before


@pytest.mark.parametrize("n", [8, 6])
def test_collectives_on_card_launch_the_kernels(cuda, n):
    """Each data-moving collective is one kernel launch and bit-equal to
    the CPU step schedule; reductions agree at atol 1e-5."""
    from repro_torch.core import collectives as coll
    rng = np.random.default_rng(n)
    shard = torch.from_numpy(rng.normal(size=(n, 3, 40)).astype(np.float32))
    chunks = torch.from_numpy(rng.normal(size=(n, n, 2, 24)).astype(np.float32))
    cpu, card = coll.make_ranks(n, "cpu"), coll.make_ranks(n, cuda)
    for fn, x, launched in ((coll.ring_all_gather, shard, (1, 0)),
                            (coll.bidir_ring_all_gather, shard, (1, 0)),
                            (coll.pairwise_all_to_all, chunks, (0, 1)),
                            (coll.ring_all_reduce, chunks, (1, 0))):
        before = (ag_ops.launches, aa_ops.launches)
        got = fn(x.to(cuda), card)
        ag_ops.check()
        assert (ag_ops.launches - before[0], aa_ops.launches - before[1]) == launched
        want = fn(x, cpu)
        if fn is coll.ring_all_reduce:
            torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
        else:
            assert torch.equal(got.cpu(), want)


def test_latte_moe_on_card_matches_cpu(cuda, monkeypatch):
    """Reduced olmoe, float32 (TF32 off): two B4 launches per forward, and
    the output of the CPU run (same params and tokens) at atol 1e-5."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.latte_moe import make_latte_moe
    from repro_torch.models.moe import init_moe
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    base = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(base, d_model=128, moe=dataclasses.replace(
        base.moe, n_experts=16, top_k=4, d_ff_expert=64))
    p = init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 32, 128)).astype(np.float32))
    want, want_aux = make_latte_moe(cfg, coll.make_ranks(8, "cpu"))(p, x)
    before = aa_ops.launches
    got, aux = make_latte_moe(cfg, coll.make_ranks(8, cuda))(
        {k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    aa_ops.check()
    assert aa_ops.launches - before == 2
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("variant", sorted(ag_ops.VARIANTS))
@pytest.mark.parametrize("shape", [(8, 7, 143), (8, 13, 100), (6, 5, 31)])
def test_ring_all_gather_forced_parts(cuda, variant, shape):
    """1, 3 and the most CTAs per rank, over chunks whose words do not divide
    evenly among them: 4-, 16- and 2-byte words, ragged shares."""
    n = shape[0]
    most = torch.cuda.get_device_properties(cuda).multi_processor_count // n
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.randn(shape, generator=g, device=cuda).to(dtype)
        for parts in (1, 3, most):
            out = ag_ops.ring_all_gather(xs, variant, parts=parts)
            ag_ops.check()
            assert torch.equal(out, all_gather_ref(xs)), (dtype, parts)


@pytest.mark.parametrize("kernel", ["ring_all_gather", "all_to_all"])
def test_rank_kernels_back_to_back(cuda, kernel):
    """200 calls with no synchronisation in between, every variant in turn
    and two sizes (two flag buffers): each call waits on its own epoch, so
    every result is bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    if kernel == "ring_all_gather":
        fn, ref, variants = ag_ops.ring_all_gather, all_gather_ref, sorted(ag_ops.VARIANTS)
        inputs = [torch.randn((8, c, 256), generator=g, device=cuda) for c in (4, 96)]
    else:
        fn, ref, variants = aa_ops.all_to_all, all_to_all_ref, sorted(aa_ops.VARIANTS)
        inputs = [torch.randn((8, 8, c, 64), generator=g, device=cuda) for c in (2, 96)]
    outs = []
    for i in range(200):
        xs = inputs[i % 2]
        outs.append((xs, fn(xs, variants[i % len(variants)])))
    (ag_ops if kernel == "ring_all_gather" else aa_ops).check()
    for i, (xs, out) in enumerate(outs):
        assert torch.equal(out, ref(xs)), i


def test_rank_kernels_refused_launch_then_good_call(cuda):
    """A refused launch leaves no flag buffer behind it in a bad state: the
    next calls, with the default and with the refused size, are right."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    xs = torch.randn((8, 4, 128), device=cuda)
    for _ in range(2):
        before = ag_ops.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            ag_ops.ring_all_gather(xs, "b2b", parts=sms // 8 + 1)
        assert ag_ops.launches == before
        assert torch.equal(ag_ops.ring_all_gather(xs, "b2b"), all_gather_ref(xs))
        assert torch.equal(ag_ops.ring_all_gather(xs, "b2b", parts=sms // 8),
                           all_gather_ref(xs))
        ag_ops.check()
