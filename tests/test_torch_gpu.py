"""The port's CUDA kernels, serving and training paths, and the dry-run's memory, on the card.

Every test here is marked ``gpu`` and skips where no card is present (the
CUDA kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, data_iterator, synth_batch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref  # noqa: E402
from repro_torch.kernels.paged_kv_gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.paged_kv_gather.ref import paged_kv_gather_ref  # noqa: E402
from repro_torch.kernels.ring_all_gather import ops as ag_ops  # noqa: E402
from repro_torch.kernels.ring_all_gather.ref import all_gather_ref  # noqa: E402
from repro_torch.kernels.ring_all_to_all import ops as aa_ops  # noqa: E402
from repro_torch.kernels.ring_all_to_all.ref import all_to_all_ref  # noqa: E402
from repro_torch.kernels.ring_reduce_scatter import ops as rs_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.train import with_encoder_feats  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.host_store import BACKENDS  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.train.loop import init_train_state, make_train_step, train_loop  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map  # noqa: E402

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_kernel_out_of_range_entries(cuda, dtype):
    """Entries -1, n_pool and far past it: the kernel and the plain version
    both give zero blocks there, bit-equal everywhere (ROADMAP C-port3)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    pool = torch.randn((4, 16, 96), generator=g, device=cuda).to(dtype)
    tbl = torch.tensor([2, -1, 4, 0, 1000, 3], dtype=torch.int32, device=cuda)
    out = gather_ops.gather_blocks(pool, tbl)
    ref = paged_kv_gather_ref(pool, tbl)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.count_nonzero(out[[1, 2, 4]]) == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pad", [4, -1, 1000])
def test_decode_attention_kernel_out_of_range_entries(cuda, dtype, tol, pad):
    """Tables padded past each length with an entry outside [0, n_pool): the
    kernel and the plain version agree, at the present tolerances."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((2, 2, 4, 64), generator=g, device=cuda).to(dtype)
    kp = torch.randn((4, 8, 2, 64), generator=g, device=cuda).to(dtype)
    vp = torch.randn((4, 8, 2, 64), generator=g, device=cuda).to(dtype)
    tables = torch.tensor([[0, 1, pad, pad], [2, 3, pad, pad]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([10, 12], dtype=torch.int32, device=cuda)
    out = da_ops.decode_attention(q, kp, vp, tables, lengths)
    ref = paged_decode_attention_ref(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


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


def test_moe_forward_on_card_matches_cpu(cuda, monkeypatch):
    """Reduced olmoe in float32 (TF32 off), the same params and tokens on
    the card and on the CPU: forward logits and decode-step logits at 1e-4,
    the aux loss at 1e-6."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), compute_dtype="float32")
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(3))

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(cuda)

    card_params = to_card(cpu_params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 24)))
    want, want_aux, _ = model.forward(cpu_params, {"tokens": toks})
    got, aux, _ = model.forward(card_params, {"tokens": toks.to(cuda)})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=0)
    caches = {"cpu": model.init_caches(2, 8, "cpu"), "cuda": model.init_caches(2, 8, cuda)}
    for t in range(6):
        want, caches["cpu"] = model.decode_step(cpu_params, {"tokens": toks[:, t:t + 1],
                                                             "pos": t}, caches["cpu"])
        got, caches["cuda"] = model.decode_step(card_params, {"tokens": toks[:, t:t + 1].to(cuda),
                                                              "pos": t}, caches["cuda"])
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_moe_engine_on_card_hit_tokens_agree(cuda):
    """Reduced olmoe in bf16 at the default capacity factor: every hit
    backend gives the same tokens, the kernel backend launches B1 twice per
    context, and each hit carries a positive modeled fetch latency."""
    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(torch.Generator(device=cuda).manual_seed(4)))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    keys = ["m0", "m1", "m2"]
    miss = eng.generate(prompts, keys, 6)
    assert not miss.request_stats[0].cache_hit and miss.request_stats[0].fetch_modeled_s == 0
    hits = {}
    for backend in BACKENDS:
        before = gather_ops.launches
        hits[backend] = eng.generate(prompts, keys, 6, fetch_backend=backend)
        assert gather_ops.launches - before == (6 if backend == "kernel" else 0)
        assert hits[backend].request_stats[0].fetch_modeled_s > 0
        np.testing.assert_array_equal(hits[backend].tokens, hits["pcpy"].tokens)


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


@pytest.mark.parametrize("variant", sorted(aa_ops.VARIANTS))
@pytest.mark.parametrize("n", [8, 6, 16])
@pytest.mark.parametrize("per_rank", [64 << 10, 1 << 20])
def test_all_to_all_latency_bound_sizes(cuda, variant, n, per_rank):
    """About 64 KiB and 1 MiB per rank (the sizes the partner-first plan was
    built for), XOR (8, 16) and rotation (6) pairing, f32 and bf16, with the
    chosen CTAs per rank and forced to 1, 3 and the most (1 and 3 < n: a
    CTA takes several whole rounds)."""
    most = torch.cuda.get_device_properties(cuda).multi_processor_count // n
    g = torch.Generator(device=cuda).manual_seed(n + per_rank)
    for dtype in (torch.float32, torch.bfloat16):
        rows = per_rank // (n * 128 * torch.finfo(dtype).bits // 8)
        xs = torch.randn((n, n, rows, 128), generator=g, device=cuda).to(dtype)
        want = all_to_all_ref(xs)
        for parts in (None, 1, 3, most):
            before = aa_ops.launches
            out = aa_ops.all_to_all(xs, variant, parts=parts)
            aa_ops.check()
            assert aa_ops.launches == before + 1
            assert torch.equal(out, want), (dtype, parts)


def test_rank_kernels_refuse_too_many_ctas(cuda):
    """Every CTA must have an SM of its own; more is refused, not launched."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    xs = torch.zeros((8, 4, 128), device=cuda)
    before = ag_ops.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ag_ops.ring_all_gather(xs, parts=sms // 8 + 1)
    assert ag_ops.launches == before
    xa = torch.zeros((8, 8, 4, 128), device=cuda)
    before = aa_ops.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        aa_ops.all_to_all(xa, parts=sms // 8 + 1)
    assert aa_ops.launches == before


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


# ------------------------------------------- one rank per process (B3/B4) ----
def _no_fallback(monkeypatch_like):
    """Make every path a per-rank call on a CUDA tensor must not take raise:
    the plain versions, the gloo schedules and the emulated launches."""
    def refuse(*a, **k):
        raise AssertionError("a per-rank call on the card left the per-rank kernel")
    for mod, names in ((ag_ops, ("all_gather_ref", "all_gather_gloo", "ring_all_gather")),
                       (aa_ops, ("all_to_all_ref", "all_to_all_gloo", "all_to_all")),
                       (rs_ops, ("reduce_scatter_gloo",))):
        for name in names:
            monkeypatch_like(mod, name, refuse)


def procs_bit_equal(ranks, seed):
    """One process: every B3 / B4 variant per rank in f32 and bf16 (with
    every other path refusing), then the emulated launch on the same
    inputs; a refused per-rank launch raises and counts nothing."""
    saved = {}

    def patch(mod, name, fn):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)
    _no_fallback(patch)
    n, my, dev = ranks.n, ranks.rank, ranks.device
    g = torch.Generator(device=dev).manual_seed(seed)
    got, inputs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.randn((n, 5, 96), generator=g, device=dev).to(dtype)
        xa = torch.randn((n, n, 3, 40), generator=g, device=dev).to(dtype)
        inputs[dtype] = (xs, xa)
        for v in ag_ops.VARIANTS:
            got[("ag", v, dtype)] = ag_ops.ring_all_gather_rank(xs[my], ranks, v)
        for v in aa_ops.VARIANTS:
            got[("aa", v, dtype)] = aa_ops.all_to_all_rank(xa[my], ranks, v)
    ag_ops.check_ranks(ranks)
    aa_ops.check_ranks(ranks)
    launched = (ag_ops.launches_rank, aa_ops.launches_rank)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    refused = []
    for fn, x in ((ag_ops.ring_all_gather_rank, xs[my]), (aa_ops.all_to_all_rank, xa[my])):
        try:
            fn(x, ranks, "b2b", parts=sms // n + 1)
        except RuntimeError as e:
            refused.append(str(e))
    for (mod, name), fn in saved.items():
        setattr(mod, name, fn)
    bad = []
    for (kind, v, dtype), out in got.items():
        xs, xa = inputs[dtype]
        want = (ag_ops.ring_all_gather(xs, v) if kind == "ag" else aa_ops.all_to_all(xa, v))[my]
        if not torch.equal(out, want):
            bad.append((kind, v, str(dtype)))
    return {"bad": bad, "launched": launched, "refused": refused,
            "after_refused": (ag_ops.launches_rank, aa_ops.launches_rank)}


@pytest.mark.parametrize("n", [2, 4])
def test_procs_bit_equal_to_emulated(cuda, n):
    """n processes on the card, one rank each, through CUDA IPC: every
    variant bit-equal to the emulated launch, with no other path taken."""
    from repro_torch.core.procgroup import spawn
    res = spawn(procs_bit_equal, n, device="cuda", args=(n,), timeout_s=300)
    nv = (2 * len(ag_ops.VARIANTS), 2 * len(aa_ops.VARIANTS))
    for r, out in enumerate(res):
        assert out["bad"] == [], r
        assert out["launched"] == nv, r
        assert len(out["refused"]) == 2 and all("launch failed" in e for e in out["refused"])
        assert out["after_refused"] == nv, r


def procs_lost_flag(ranks):
    """After a good call (which makes the buffers), rank 1 skips one: rank
    0's wait runs out; the collective check raises on both; the next call
    is right on both (fresh buffers)."""
    xs = torch.arange(ranks.n * 4 * 8, dtype=torch.float32, device=ranks.device)
    xs = xs.reshape(ranks.n, 4, 8)
    ag_ops.ring_all_gather_rank(xs[ranks.rank], ranks, "b2b")
    ag_ops.check_ranks(ranks)
    if ranks.rank != 1:
        ag_ops.ring_all_gather_rank(xs[ranks.rank], ranks, "b2b")
    try:
        ag_ops.check_ranks(ranks)
        first = "no error"
    except RuntimeError as e:
        first = str(e)
    again = ag_ops.ring_all_gather_rank(xs[ranks.rank], ranks, "b2b")
    ag_ops.check_ranks(ranks)
    return {"first": first, "again": torch.equal(again, xs.reshape(-1, 8))}


def test_procs_lost_flag_raises_on_its_rank(cuda):
    from repro_torch.core.procgroup import spawn
    res = spawn(procs_lost_flag, 2, device="cuda", timeout_s=300)
    assert "rank 0 gave up waiting" in res[0]["first"], res[0]
    assert "rank(s) [0]" in res[1]["first"], res[1]
    assert res[0]["again"] and res[1]["again"]


def _moe_case(dtype):
    """Reduced olmoe (d_model 128, 16 experts, top-4, d_ff 64): params and
    32 tokens for each of up to 4 ranks, from a seed."""
    from repro_torch.models.moe import init_moe
    base = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(base, d_model=128, compute_dtype=str(dtype)[6:],
                              moe=dataclasses.replace(base.moe, n_experts=16, top_k=4,
                                                      d_ff_expert=64))
    p = {k: v.to(dtype) for k, v in init_moe(cfg, torch.Generator().manual_seed(0)).items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32, 128)).astype(np.float32))
    return cfg, p, x.to(dtype)


def procs_reductions_and_moe(ranks, seed):
    """One process: the ring reduce-scatter and all-reduce and both one-shots
    per rank in f32 and bf16 (every other path refusing), 24 reduce-scatters
    back to back with different data in two shapes, and the latte MoE layer
    per rank in f32 (TF32 off) and bf16; then the emulated renderings on the
    same inputs."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.latte_moe import make_latte_moe
    saved = {}

    def patch(mod, name, fn):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)
    _no_fallback(patch)
    torch.backends.cuda.matmul.allow_tf32 = False
    n, my, dev = ranks.n, ranks.rank, ranks.device
    g = torch.Generator(device=dev).manual_seed(seed)
    fns = {"ring_reduce_scatter": coll.ring_reduce_scatter,
           "ring_all_reduce": coll.ring_all_reduce,
           "reference_reduce_scatter": coll.reference_reduce_scatter,
           "reference_all_reduce": coll.reference_all_reduce}
    got, inputs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        # 16-byte words, and a chunk of 7 x 3 elements (4- and 2-byte words)
        for shape in ((5, 96), (7, 3)):
            xc = torch.randn((n, n, *shape), generator=g, device=dev).to(dtype)
            inputs[(dtype, shape)] = xc
            for name, fn in fns.items():
                got[(name, dtype, shape)] = fn(xc[my], ranks)
    launched = rs_ops.launches_rank
    b2b_in = [torch.randn((n, n, 3 + 37 * (i % 2), 64), generator=g, device=dev)
              for i in range(24)]
    b2b = [coll.ring_reduce_scatter(x[my], ranks) for x in b2b_in]
    moe = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg, p, x = _moe_case(dtype)
        p, x = {k: v.to(dev) for k, v in p.items()}, x[:n].to(dev)
        before = aa_ops.launches_rank
        out, aux = make_latte_moe(cfg, ranks)(p, x[my:my + 1])
        moe[dtype] = (out[0], aux, aa_ops.launches_rank - before, cfg, p, x)
    rs_ops.check_ranks(ranks)
    ag_ops.check_ranks(ranks)
    aa_ops.check_ranks(ranks)
    for (mod, name), fn in saved.items():
        setattr(mod, name, fn)
    emulated = coll.make_ranks(n, dev)
    bad, err = [], {}
    for (name, dtype, shape), out in got.items():
        xc = inputs[(dtype, shape)]
        want = fns[name](xc, emulated)[my]
        if name.startswith("ring"):
            if not torch.equal(out, want):
                bad.append((name, str(dtype), shape))
        else:       # the same sums added in another order: relative to the largest
            err[(name, str(dtype), shape)] = ((out.float() - want.float()).abs().max()
                                              / want.float().abs().max()).item()
    for i, (x, out) in enumerate(zip(b2b_in, b2b)):
        if not torch.equal(out, coll.ring_reduce_scatter(x, emulated)[my]):
            bad.append(("back to back", i))
    for dtype, (out, aux, a2a, cfg, p, x) in moe.items():
        want, want_aux = make_latte_moe(cfg, emulated)(p, x)
        err[("moe", str(dtype))] = ((out.float() - want[my].float()).abs().max().item(),
                                    torch.equal(out, want[my]), torch.equal(aux, want_aux), a2a)
    return {"bad": bad, "err": err, "launched": launched,
            "after": rs_ops.launches_rank, "moe_a2a": [moe[d][2] for d in moe]}


@pytest.mark.parametrize("n", [2, 4])
def test_procs_reductions_and_moe_bit_equal_to_emulated(cuda, n):
    """n processes on the card, one rank each: the rings bit-equal to the
    emulated renderings (also 24 calls back to back with different data),
    the one-shots (B4 ``per_round`` / B3 ``pcpy`` per rank, then a sum) within
    an ulp-scale tolerance of the emulated sums, and the latte MoE layer per
    rank (two B4 launches a forward) bit-equal to the emulated layer.  The
    one-shots' tolerance, relative to the largest sum: 1e-6 in f32, one bf16
    ulp (2^-7) in bf16, since the sums add in another order."""
    from repro_torch.core.procgroup import spawn
    res = spawn(procs_reductions_and_moe, n, device="cuda", args=(n,), timeout_s=300)
    for r, out in enumerate(res):
        assert out["bad"] == [], (r, out["bad"])
        # one launch per ring reduce-scatter or all-reduce: 2 x 2 shapes x 2 dtypes
        assert out["launched"] == 8 and out["after"] == 8 + 24, r
        assert out["moe_a2a"] == [2, 2], r
        for key, e in out["err"].items():
            if key[0] == "moe":
                assert e[1] and e[2], (r, key, e)
            else:
                assert e <= (1e-6 if key[1] == "torch.float32" else 2 ** -7), (r, key, e)


def procs_rs_lost_flag(ranks):
    """As procs_lost_flag, for the ring reduce-scatter: rank 1 skips a call,
    so rank 0's barrier wait runs out; the collective check raises on both;
    the next call is right on both (fresh buffers)."""
    from repro_torch.core import collectives as coll
    n = ranks.n
    xc = torch.arange(n * n * 4 * 8, dtype=torch.float32, device=ranks.device)
    xc = xc.reshape(n, n, 4, 8)
    coll.ring_reduce_scatter(xc[ranks.rank], ranks)
    rs_ops.check_ranks(ranks)
    if ranks.rank != 1:
        coll.ring_reduce_scatter(xc[ranks.rank], ranks)
    try:
        rs_ops.check_ranks(ranks)
        first = "no error"
    except RuntimeError as e:
        first = str(e)
    again = coll.ring_reduce_scatter(xc[ranks.rank], ranks)
    rs_ops.check_ranks(ranks)
    return {"first": first, "again": torch.equal(again, xc[:, ranks.rank].sum(0))}


def test_procs_rs_lost_flag_raises_on_its_rank(cuda):
    from repro_torch.core.procgroup import spawn
    res = spawn(procs_rs_lost_flag, 2, device="cuda", timeout_s=300)
    assert "ring_reduce_scatter: rank 0 gave up waiting for its barrier" in res[0]["first"], res
    assert "rank(s) [0]" in res[1]["first"], res[1]
    assert res[0]["again"] and res[1]["again"]


# ------------------------------------------------------------- training ----
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_train_step_on_card_matches_cpu(cuda, monkeypatch, arch):
    """One float32 step (TF32 off, no compute cast) from the same state on
    the card and on the CPU: loss and grad norm at 1e-5 relative, Adam
    moments at 1e-4 of each leaf's largest element, params within 2 x lr
    (Adam's first step is about lr * sign(g): where |g| is near eps the two
    devices' rounding may move an element differently) and within 1e-6 for
    all but 1e-3 of the elements."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    lr = 1e-3
    step = make_train_step(model, AdamWConfig(lr=lr, warmup_steps=1, total_steps=10),
                           cast_params=False)
    toks = synth_batch(DataConfig(vocab=cfg.vocab, seq_len=32, batch=2, seed=1), 0)["tokens"]
    want_state, want = step(state, {"tokens": toks})
    got_state, got = step(tree_map(lambda t: t.to(cuda), state), {"tokens": toks.to(cuda)})
    for k in ("loss", "grad_norm"):
        assert abs(got[k].item() / want[k].item() - 1) <= 1e-5, k
    for k in ("m", "v"):
        for g, w in zip(tree_leaves(got_state["opt"][k]), tree_leaves(want_state["opt"][k])):
            assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()
    off = total = 0
    for g, w in zip(tree_leaves(got_state["params"]), tree_leaves(want_state["params"])):
        err = (g.cpu() - w).abs()
        assert err.max() <= 2 * lr
        off += int((err > 1e-6).sum())
        total += err.numel()
    assert off <= 1e-3 * total
    assert got_state["opt"]["step"].device.type == "cuda" and int(got_state["opt"]["step"]) == 1


def test_checkpoint_from_card_restores_bit_equal(cuda, tmp_path):
    """A train state on the card, after one step, through the reference's
    .npz layout and back onto the card, bit for bit."""
    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(device=cuda).manual_seed(1))
    toks = synth_batch(DataConfig(vocab=cfg.vocab, seq_len=32, batch=2, seed=2), 0)["tokens"]
    state, _ = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))(
        state, {"tokens": toks.to(cuda)})
    path = str(tmp_path / "state.npz")
    tree = train_state_to_numpy(cfg, state)
    save_checkpoint(path, tree, step=1)
    restored = train_state_from_numpy(cfg, restore_checkpoint(path, tree), device=cuda)
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


def test_training_on_card_lowers_loss(cuda):
    """Ten steps of reduced qwen2-0.5b (bf16 compute on float32 masters)."""
    cfg = get_config("qwen2-0.5b").reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, batch=4, seed=0)
    _, hist = train_loop(build_model(cfg), data_iterator(dc), steps=10,
                         opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                         gen=torch.Generator(device=cuda).manual_seed(0), log_every=1,
                         device=cuda)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]


# -------------------------------------------------------- the new families ----
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _family_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.family == "audio":
        batch["encoder_feats"] = torch.from_numpy(
            rng.normal(size=(B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny"])
def test_new_family_on_card_matches_cpu(cuda, monkeypatch, arch):
    """Reduced config in float32 (TF32 off), the same params and inputs on
    the card and on the CPU: forward logits at 1e-4, then decode steps from
    empty caches (Whisper's cross K/V from the forward) at 1e-4."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(4))
    card_params = _to(cpu_params, cuda)
    batch = _family_batch(cfg, 2, 16, 4)
    want, _, want_c = model.forward(cpu_params, batch, want_cache=True)
    got, _, got_c = model.forward(card_params, _to(batch, cuda), want_cache=True)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    caches = {"cpu": model.init_caches(2, 8, "cpu"), "cuda": model.init_caches(2, 8, cuda)}
    if arch == "whisper-tiny":
        caches["cpu"]["cross"], caches["cuda"]["cross"] = want_c["cross"], got_c["cross"]
    toks = batch["tokens"]
    for t in range(6):
        want, caches["cpu"] = model.decode_step(cpu_params, {"tokens": toks[:, t:t + 1],
                                                             "pos": t}, caches["cpu"])
        got, caches["cuda"] = model.decode_step(card_params, {"tokens": toks[:, t:t + 1].to(cuda),
                                                              "pos": t}, caches["cuda"])
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny"])
def test_new_family_trains_on_card(cuda, arch):
    """Five steps of the reduced config (bf16 compute on float32 masters):
    every loss finite, the last below the first."""
    cfg = get_config(arch).reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, batch=2, seed=0)
    it = with_encoder_feats(cfg, data_iterator(dc), 2, 0, cuda)
    _, hist = train_loop(build_model(cfg), it, steps=5,
                         opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=5),
                         gen=torch.Generator(device=cuda).manual_seed(0), log_every=1,
                         device=cuda)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_vlm_engine_on_card_hit_equals_miss(cuda, monkeypatch):
    """Reduced qwen2-vl in float32 (TF32 off): every hit backend gives the
    miss path's tokens, and the kernel backend launches B1 twice per
    context."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("qwen2-vl-72b").reduced(), compute_dtype="float32")
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(torch.Generator(device=cuda).manual_seed(0)))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    miss = eng.generate(prompts, ["a", "b"], 6)
    for backend in BACKENDS:
        before = gather_ops.launches
        hit = eng.generate(prompts, ["a", "b"], 6, fetch_backend=backend)
        assert gather_ops.launches - before == (4 if backend == "kernel" else 0)
        np.testing.assert_array_equal(hit.tokens, miss.tokens)


def test_train_lm_example_learns_on_card(cuda):
    """The twin of ``examples/train_lm.py`` at its default 300 steps: the
    loss falls by more than 0.5 and the checkpoint round-trips bit for bit
    (both raise inside ``main``)."""
    from repro_torch.examples import train_lm
    hist = train_lm.main(["--device", "cuda"])
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5


@pytest.mark.parametrize("arch,layers,mode", [("qwen2-0.5b", None, "train"),
                                              ("qwen2-0.5b", None, "prefill"),
                                              ("olmoe-1b-7b", 2, "train")])
def test_dryrun_memory_matches_the_card(cuda, arch, layers, mode):
    """One step at 4 x 1024 tokens on the card: ``max_memory_allocated``
    within 10% of the eager peak the dry-run traces on a fake (1, 1) mesh
    (arguments + the peak of all else live), the arguments within 1%."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = ShapeConfig(f"{mode}_step", 1024, 4, mode)
    mem = dryrun.predict_step_memory(cfg, shape, device=cuda)
    got = dryrun.measure_step_memory(cfg, shape, device=cuda)
    assert got["argument_bytes"] == pytest.approx(mem.argument_bytes, rel=0.01)
    assert got["peak_bytes"] == pytest.approx(mem.live_peak_bytes, rel=0.10)
