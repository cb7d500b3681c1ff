"""The port's kernels against the JAX Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in interpret mode, as tests/test_kernels.py runs them.  Inputs
are made with numpy from a seed and handed to both.  bf16 inputs are made
in f32 and rounded by each framework (both round to nearest even, so both
see the same values).  The CUDA kernels themselves are checked against the
plain versions by tests/test_torch_gpu.py, which skips without a card, and
by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention  # noqa: E402
from repro.kernels.paged_kv_gather.ops import gather_blocks as jax_gather_blocks  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.paged_kv_gather import ops as gather_ops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# Attention tolerances of tests/test_kernels.py::TestDecodeAttention: f32
# differs only in summation order; bf16 rounds the output to 8 bits.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture
def zero_launches(monkeypatch):
    monkeypatch.setattr(gather_ops, "launches", 0)
    monkeypatch.setattr(da_ops, "launches", 0)


# ------------------------------------------------------------------- B1 ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_pool,bt,dkv,n_blocks", [
    (32, 16, 128, 8),
    (64, 16, 256, 17),
    (8, 8, 512, 8),
    (128, 32, 128, 1),
])
def test_gather_matches_pallas(dtype, n_pool, bt, dkv, n_blocks, zero_launches):
    """Bit-equal to the Pallas kernel on every case of TestPagedKVGather."""
    rng = np.random.default_rng(n_pool + n_blocks)
    pool_j, pool_t = _both(rng.normal(size=(n_pool, bt, dkv)).astype(np.float32), dtype)
    tbl = rng.permutation(n_pool)[:n_blocks].astype(np.int32)
    want = jax_gather_blocks(pool_j, jnp.asarray(tbl), interpret=True)
    got = gather_ops.gather_blocks(pool_t, torch.from_numpy(tbl))
    assert got.dtype == pool_t.dtype and got.shape == (n_blocks, bt, dkv)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert gather_ops.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_repeated_blocks(dtype, zero_launches):
    pool = np.arange(16 * 8 * 128, dtype=np.float32).reshape(16, 8, 128) / 7.0
    pool_j, pool_t = _both(pool, dtype)
    tbl = np.array([3, 3, 0, 15, 3], np.int32)
    want = jax_gather_blocks(pool_j, jnp.asarray(tbl), interpret=True)
    got = gather_ops.gather_blocks(pool_t, torch.from_numpy(tbl))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got[0]), _np(got[1]))
    np.testing.assert_array_equal(_np(got[3]), _np(pool_t[15]))
    assert gather_ops.launches == 0


@pytest.mark.parametrize("bad", [
    dict(pool=torch.zeros(4, 16), tbl=torch.zeros(2, dtype=torch.int32)),
    dict(pool=torch.zeros(4, 2, 16), tbl=torch.zeros(2, dtype=torch.int64)),
    dict(pool=torch.zeros(4, 2, 16, dtype=torch.float64), tbl=torch.zeros(2, dtype=torch.int32)),
])
def test_gather_rejects_bad_operands(bad):
    with pytest.raises((ValueError, TypeError)):
        gather_ops.gather_blocks(bad["pool"], bad["tbl"])


# ------------------------------------------------------------------- B2 ----
def _attn_case(seed, B, KV, G, hd, bt, mb, lengths=None, npool=None):
    rng = np.random.default_rng(seed)
    npool = npool or mb * B + 2
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, bt, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, bt, KV, hd)).astype(np.float32)
    tables = rng.integers(0, npool, (B, mb)).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, mb * bt, B)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _run_both(case, dtype, softcap=None):
    q, kp, vp, tables, lengths = case
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, kp, vp))
    want = jax_decode_attention(qj, kj, vj, jnp.asarray(tables), jnp.asarray(lengths),
                                softcap=softcap, interpret=True)
    got = da_ops.decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                  torch.from_numpy(lengths), softcap=softcap)
    assert got.dtype == qt.dtype and got.shape == q.shape
    return _np(got), _np(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,hd,bt,mb", [
    (2, 2, 4, 128, 16, 4),
    (1, 1, 8, 128, 16, 2),
    (4, 4, 2, 256, 8, 3),
    (4, 2, 7, 64, 16, 5),      # the qwen2-0.5b group: G = 7, hd = 64
])
def test_decode_attention_matches_pallas(dtype, B, KV, G, hd, bt, mb, zero_launches):
    got, want = _run_both(_attn_case(B * 31 + mb, B, KV, G, hd, bt, mb), dtype)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    assert da_ops.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,hd", [(4, 128), (7, 64)])
def test_decode_attention_softcap(dtype, G, hd):
    case = _attn_case(9, 2, 2, G, hd, 16, 4, lengths=[60, 33], npool=8)
    got, want = _run_both(case, dtype, softcap=30.0)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("G,hd", [(4, 128), (7, 64)])
def test_decode_attention_poisoned_tail(G, hd):
    """K/V past `length` never change the output (plain version and Pallas)."""
    q, kp, vp, _, _ = _attn_case(3, 1, 1, G, hd, 16, 4, npool=4)
    tables = np.array([[0, 1, 2, 3]], np.int32)
    lengths = np.array([20], np.int32)
    clean, want = _run_both((q, kp, vp, tables, lengths), "float32")
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[2:] = 999.0
    vp2[2:] = -999.0
    poisoned, want2 = _run_both((q, kp2, vp2, tables, lengths), "float32")
    np.testing.assert_allclose(poisoned, clean, atol=1e-6)
    np.testing.assert_allclose(poisoned, want2, atol=TOL["float32"], rtol=TOL["float32"])


def test_decode_attention_rejects_bad_operands():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _attn_case(0, 2, 2, 4, 64, 16, 2))
    with pytest.raises(ValueError):      # int64 lengths
        da_ops.decode_attention(q, kp, vp, tables, lengths.long())
    with pytest.raises(TypeError):       # mixed dtypes
        da_ops.decode_attention(q, kp.bfloat16(), vp, tables, lengths)
    with pytest.raises(ValueError):      # pool head_dim != q's
        da_ops.decode_attention(q, kp[..., :32], vp[..., :32], tables, lengths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [[0, 20], [0, 0]])
def test_decode_attention_zero_length(dtype, lengths, zero_launches):
    """A sequence of length 0 gives 0, as the Pallas kernel does (its
    normalizer stays 0 and is floored at 1e-30); the others are unchanged."""
    case = _attn_case(5, 2, 2, 4, 64, 16, 3, lengths=lengths, npool=8)
    got, want = _run_both(case, dtype)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    for b, length in enumerate(lengths):
        if length == 0:
            assert not np.any(want[b]) and not np.any(got[b])
    assert da_ops.launches == 0


# ---------------------------------------------------- B2 split plan ----
@pytest.mark.parametrize("seed", range(6))
def test_decode_attention_split_plan(seed):
    """Every valid block of every sequence falls in exactly one split, no
    split covers a block at or after ceil(length / bt) (or past the table),
    and the grid stays within WAVES * SMs + B * KV - 1 CTAs."""
    rng = np.random.default_rng(seed)
    B, KV = int(rng.integers(1, 9)), int(rng.choice([1, 2, 4, 8]))
    bt, mb = int(rng.choice([8, 16, 32])), int(rng.integers(1, 300))
    sms = int(rng.choice([1, 16, 132]))
    lengths = rng.integers(-3, mb * bt + 40, B)
    lengths[0] = 0
    tables = rng.integers(0, 4 * mb, (B, mb))
    S = da_ops.num_splits(B * KV, mb, sms)
    assert 1 <= S <= mb
    assert B * KV * S <= max(B * KV, da_ops.WAVES * sms + B * KV - 1)
    ranges = da_ops.split_ranges(torch.from_numpy(lengths.astype(np.int32)), bt, mb, S).numpy()
    assert ranges.shape == (B, S, 2)
    for b in range(B):
        n_valid = min(max(-(-int(lengths[b]) // bt), 0), mb)
        covered = np.zeros(mb, int)
        for lo, hi in ranges[b]:
            assert 0 <= lo <= hi <= n_valid
            covered[lo:hi] += 1
        np.testing.assert_array_equal(covered, (np.arange(mb) < n_valid).astype(int))
        # the table entries the splits read are those of the valid blocks
        read = np.concatenate([tables[b, lo:hi] for lo, hi in ranges[b]])
        np.testing.assert_array_equal(read, tables[b, :n_valid])


def test_decode_attention_split_count_at_the_path_shape():
    """qwen2-0.5b decode (B 4, KV 2, 65 blocks) on 132 SMs: 33 splits of 2 blocks."""
    S = da_ops.num_splits(4 * 2, 66, 132)
    assert S == 33
    ranges = da_ops.split_ranges(torch.tensor([1037], dtype=torch.int32), 16, 66, S)[0]
    assert int((ranges[:, 1] - ranges[:, 0]).max()) == 2


# ------------------------------------------------ B3/B4 flag buffers ----
def test_flag_buffers_epochs():
    """One zeroed buffer per (device, stream, n, parts, layout); each call on
    it takes the next epoch; a buffer not given back (a refused or failed
    launch) is dropped and the next call starts a zeroed one at epoch 1; a
    buffer is replaced before epoch * 2 * parts could pass INT32_MAX."""
    from repro_torch.kernels._rank_sync import INT32_MAX, FlagBuffers
    sizes = []
    flags = FlagBuffers(lambda n, parts: sizes.append((n, parts)) or n * parts + 3)
    cpu = torch.device("cpu")
    key, buf, epoch = flags.take(cpu, 7, 8, 2, 0)
    assert epoch == 1 and buf.dtype == torch.int32 and buf.numel() == 19
    assert not torch.any(buf)
    flags.give_back(key, buf, epoch)
    key2, buf2, epoch2 = flags.take(cpu, 7, 8, 2, 0)
    assert buf2 is buf and epoch2 == 2
    flags.give_back(key2, buf2, epoch2)
    # other stream, other parts, other layout: buffers of their own
    for args in ((cpu, 8, 8, 2, 0), (cpu, 7, 8, 3, 0), (cpu, 7, 8, 2, 1)):
        k, b, e = flags.take(*args)
        assert e == 1 and b is not buf
        flags.give_back(k, b, e)
    assert len(flags) == 4
    # a launch that is refused never gives its buffer back
    key3, buf3, epoch3 = flags.take(cpu, 7, 8, 2, 0)
    assert epoch3 == 3
    key4, buf4, epoch4 = flags.take(cpu, 7, 8, 2, 0)
    assert buf4 is not buf3 and epoch4 == 1
    flags.give_back(key4, buf4, epoch4)
    # int32 wrap: the epoch whose targets would pass INT32_MAX gets a new buffer
    parts = 16
    k, b, _ = flags.take(cpu, 7, 8, parts, 0)
    last = INT32_MAX // (2 * parts)
    b.fill_(5)
    flags.give_back(k, b, last - 1)
    k, b2, e = flags.take(cpu, 7, 8, parts, 0)
    assert b2 is b and e == last and e * 2 * parts <= INT32_MAX
    flags.give_back(k, b2, e)
    k, b3, e = flags.take(cpu, 7, 8, parts, 0)
    assert b3 is not b and e == 1 and not torch.any(b3)
    flags.clear()
    assert len(flags) == 0
