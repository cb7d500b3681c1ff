"""Paged KV cache layout (PagedAttention, vLLM-style), on tensors.

Counterpart of ``repro.serve.kvcache``.  KV is kept in fixed-size blocks of
16 tokens (the vLLM default the paper cites), all model layers of one
logical block stored contiguously, so one host<->device transfer moves a
full layer-stack block: ``[n_blocks, block_tokens, L, KV, hd]``.
"""
from __future__ import annotations

import torch

BLOCK_TOKENS = 16


class BlockAllocator:
    """Free-list allocator over pool slots."""

    def __init__(self, n_blocks: int):
        self.free = list(range(n_blocks - 1, -1, -1))
        self.n_blocks = n_blocks

    def alloc(self, n: int) -> list[int]:
        if n > len(self.free):
            raise MemoryError(f"paged pool exhausted: want {n}, have {len(self.free)}")
        return [self.free.pop() for _ in range(n)]

    def release(self, blocks: list[int]) -> None:
        self.free.extend(blocks)

    @property
    def n_free(self) -> int:
        return len(self.free)


def blocks_for_tokens(n_tokens: int, block_tokens: int = BLOCK_TOKENS) -> int:
    return (n_tokens + block_tokens - 1) // block_tokens


def kv_to_blocks(k: torch.Tensor, v: torch.Tensor, block_tokens: int = BLOCK_TOKENS):
    """Layer-stacked prefill KV [L, B=1, S, KV, hd] -> per-block tensors
    [n_blocks, block_tokens, L, KV, hd] (zero-padded tail)."""
    L, B, S, KV, hd = k.shape
    if B != 1:
        raise ValueError(f"kv_to_blocks takes one sequence (B == 1), got B={B}")
    nb = blocks_for_tokens(S, block_tokens)
    pad = nb * block_tokens - S

    def conv(a):
        a = a[:, 0].movedim(0, 1)                     # [S, L, KV, hd]
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a.reshape(nb, block_tokens, L, KV, hd)

    return conv(k), conv(v)


def blocks_to_kv(kb: torch.Tensor, vb: torch.Tensor, n_tokens: int):
    """Inverse of kv_to_blocks -> [L, 1, S, KV, hd]."""
    def conv(a):
        nb, bt, L, KV, hd = a.shape
        a = a.reshape(nb * bt, L, KV, hd)[:n_tokens]
        return a.movedim(1, 0)[:, None]

    return conv(kb), conv(vb)
