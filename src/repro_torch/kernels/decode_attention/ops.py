"""Wrapper of the split-KV paged flash-decode kernel (``csrc/decode_attention.cu``).

``decode_attention(q, k_pool, v_pool, block_tables, lengths, softcap=None)``:
CUDA tensors go to the hand-written kernel, CPU tensors to the plain version
in ``ref.py``.  ``launches`` counts kernel calls (CPU calls do not count); a
call is two launches on the card, the split pass and the combine pass, and
counts once.  The kernel never reads a block that starts at or past a
sequence's length.

The split plan lives here: ``num_splits`` picks S, the splits of each
sequence's blocks, and ``split_ranges`` is the block range that each split's
CTA computes on the device from ``lengths`` (the kernel repeats its formula).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import paged_decode_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WAVES = 2                 # the grid fills about this many waves of the SMs

launches = 0


@functools.cache
def _kernel():
    fn = _build.load("decode_attention").paged_decode_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(batch_heads: int, max_blocks: int, sm_count: int) -> int:
    """S = clamp(ceil(WAVES * sm_count / batch_heads), 1, max_blocks): about
    WAVES CTAs per SM, and never more splits than table entries.  The grid
    ``batch_heads * S`` is therefore at most WAVES * sm_count + batch_heads - 1."""
    want = -(-WAVES * sm_count // max(batch_heads, 1))
    return max(1, min(max_blocks, want))


def split_ranges(lengths: torch.Tensor, block_tokens: int, max_blocks: int,
                 n_splits: int) -> torch.Tensor:
    """[B, S, 2] block range [lo, hi) of each split, as each CTA computes it:
    n = min(ceil(length / bt), max_blocks) valid blocks, per = ceil(n / S),
    split s takes [min(s * per, n), min(s * per + per, n)).  Empty where the
    sequence is short; never a block at or after ceil(length / bt)."""
    n = ((lengths.long() + block_tokens - 1) // block_tokens).clamp(0, max_blocks)
    per = (n + n_splits - 1) // n_splits
    s = torch.arange(n_splits, device=lengths.device)
    lo = torch.minimum(s[None, :] * per[:, None], n[:, None])
    hi = torch.minimum(lo + per[:, None], n[:, None])
    return torch.stack((lo, hi), dim=-1)


def decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     block_tables: torch.Tensor, lengths: torch.Tensor, *,
                     softcap: float | None = None) -> torch.Tensor:
    """q [B, KV, G, hd]; k_pool/v_pool [n_pool, bt, KV, hd] (same dtype as q,
    f32 or bf16); block_tables [B, max_blocks] int32; lengths [B] int32.
    Returns [B, KV, G, hd] in q's dtype; 0 for a sequence of length <= 0."""
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
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    max_blocks = block_tables.shape[1]
    S = num_splits(B * KV, max_blocks, _sm_count(dev))
    workspace = torch.empty(B * KV * S * G * (hd + 2), dtype=torch.float32, device=q.device)
    err = _kernel()(DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                    workspace.data_ptr(), B, KV, G, hd, bt, max_blocks, n_pool, S,
                    1.0 / (hd ** 0.5), float(softcap or 0.0), dev,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {err}")
    launches += 1
    return out
