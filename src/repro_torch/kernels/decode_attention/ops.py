"""Wrapper of the paged flash-decode kernel (``csrc/decode_attention.cu``).

``decode_attention(q, k_pool, v_pool, block_tables, lengths, softcap=None)``:
CUDA tensors go to the hand-written kernel, CPU tensors to the plain version
in ``ref.py``.  ``launches`` counts kernel launches (CPU calls do not count).
The kernel never reads a block that starts at or past a sequence's length.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import paged_decode_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.cache
def _kernel():
    fn = _build.load("decode_attention").paged_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     block_tables: torch.Tensor, lengths: torch.Tensor, *,
                     softcap: float | None = None) -> torch.Tensor:
    """q [B, KV, G, hd]; k_pool/v_pool [n_pool, bt, KV, hd] (same dtype as q,
    f32 or bf16); block_tables [B, max_blocks] int32; lengths [B] int32.
    Returns [B, KV, G, hd] in q's dtype."""
    global launches
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q [B,KV,G,hd] and equal pools [n,bt,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, KV, G, hd = q.shape
    n_pool, bt, kv_p, hd_p = k_pool.shape
    if (kv_p, hd_p) != (KV, hd):
        raise ValueError(f"pool heads/head_dim {(kv_p, hd_p)} != q's {(KV, hd)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"want block_tables [B, max_blocks] and lengths [B] with B={B}, got "
                         f"{tuple(block_tables.shape)}, {tuple(lengths.shape)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q/k_pool/v_pool must share one dtype of {tuple(DTYPES)}, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one device")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                          softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _kernel()(DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                    B, KV, G, hd, bt, block_tables.shape[1], n_pool,
                    1.0 / (hd ** 0.5), float(softcap or 0.0), q.device.index or 0,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {err}")
    launches += 1
    return out
