"""Wrapper of the paged KV gather kernel (``csrc/paged_kv_gather.cu``).

``gather_blocks(pool, block_table)`` returns ``pool[block_table]``: CUDA
tensors go to the hand-written kernel, CPU tensors to the plain version in
``ref.py``.  ``launches`` counts kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import paged_kv_gather_ref

DTYPES = (torch.float32, torch.bfloat16)

launches = 0


@functools.cache
def _kernel():
    fn = _build.load("paged_kv_gather").paged_kv_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_blocks(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pool [n_pool, block_tokens, d_kv] f32/bf16, block_table [n] int32
    (repeats allowed) -> [n, block_tokens, d_kv]; an entry outside
    [0, n_pool) gives a zero block."""
    global launches
    if pool.dim() != 3:
        raise ValueError(f"pool must be [n_pool, block_tokens, d_kv], got {tuple(pool.shape)}")
    if block_table.dim() != 1 or block_table.dtype != torch.int32:
        raise ValueError("block_table must be a 1-D int32 tensor, got "
                         f"{tuple(block_table.shape)} {block_table.dtype}")
    if pool.dtype not in DTYPES:
        raise TypeError(f"pool dtype {pool.dtype} not supported; use one of {DTYPES}")
    if pool.device != block_table.device:
        raise ValueError(f"pool on {pool.device} but block_table on {block_table.device}")
    if pool.device.type == "cpu":
        return paged_kv_gather_ref(pool, block_table)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    if not (pool.is_contiguous() and block_table.is_contiguous()):
        raise ValueError("pool and block_table must be contiguous")
    n_pool, bt, dkv = pool.shape
    n = block_table.shape[0]
    out = torch.empty((n, bt, dkv), dtype=pool.dtype, device=pool.device)
    if n == 0 or out.numel() == 0:
        return out
    err = _kernel()(pool.data_ptr(), block_table.data_ptr(), out.data_ptr(), n, n_pool,
                    bt * dkv * pool.element_size(), pool.device.index or 0,
                    torch.cuda.current_stream(pool.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_kv_gather launch failed: CUDA error {err}")
    launches += 1
    return out
