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
                                             (1, 1, 8, 128, 16, 2)])
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
