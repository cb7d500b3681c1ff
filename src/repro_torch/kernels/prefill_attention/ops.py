"""Wrapper of the causal flash-attention prefill kernel (``csrc/prefill_attention.cu``).

``prefill_attention(q, k, v)``: q [B,S,KV,G,hd], k/v [B,S,KV,hd] (the
layout ``models.attention`` projects and rotates them into), causal, scaled
by 1/sqrt(hd); returns [B,S,KV,G,hd].  CUDA tensors go to the hand-written
kernel, CPU tensors to the plain version in ``ref.py``.  The kernel reads the
operands through their strides: no copy is made.  ``launches`` counts kernel
calls (CPU calls do not count).

The kernel's symbol, ``KERNEL_SYMBOL``, names its events in a profiler trace
(``bench/metrics/prefill_attn_ms.py`` reads them).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import prefill_attention_ref

DTYPES = {torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128)
KERNEL_SYMBOL = "prefill_flash_attention_fwd"

launches = 0


@functools.cache
def _kernel():
    fn = _build.load("prefill_attention").prefill_flash_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 14 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _rows_aligned(t: torch.Tensor) -> bool:
    """Last dim contiguous, every row 16-byte aligned (the kernel's loads)."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in t.stride()[:-1]))


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,KV,G,hd] and equal k/v [B,S,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, KV, G, hd = q.shape
    if tuple(k.shape) != (B, S, KV, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {tuple(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all operands must lie on one device")
    if q.device.type == "cpu":
        return prefill_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not all(_rows_aligned(t) for t in (q, k, v)):
        raise ValueError("every operand needs a contiguous last dim and 16-byte aligned rows")
    out = torch.empty((B, S, KV, G, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    err = _kernel()(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, KV, G, hd, *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:4], 1.0 / hd ** 0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"prefill_flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
