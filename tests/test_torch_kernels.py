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
