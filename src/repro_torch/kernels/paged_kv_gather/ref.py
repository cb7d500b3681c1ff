"""Plain PyTorch version of the paged KV gather: take along the pool axis."""
from __future__ import annotations

import torch


def paged_kv_gather_ref(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    return pool[block_table.long()]
