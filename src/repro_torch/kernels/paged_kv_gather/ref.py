"""Plain PyTorch version of the paged KV gather: take along the pool axis."""
from __future__ import annotations

import torch


def paged_kv_gather_ref(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """``pool[block_table]``; a table entry outside [0, n_pool) reads nothing
    and gives a zero block, as the CUDA kernel does.  (The entry is clamped
    before the take and the block then masked, which needs no host sync.)"""
    n_pool = pool.shape[0]
    if n_pool == 0:
        return pool.new_zeros((block_table.shape[0],) + tuple(pool.shape[1:]))
    valid = (block_table >= 0) & (block_table < n_pool)
    out = pool[block_table.long().clamp(0, n_pool - 1)]
    return torch.where(valid[:, None, None], out, out.new_zeros(()))
