"""Plain PyTorch version of the ring all-gather kernel (the oracle of
``repro.kernels.ring_all_gather.ref``): after the collective, every rank
holds the global array."""
from __future__ import annotations

import torch


def all_gather_ref(xs: torch.Tensor) -> torch.Tensor:
    """xs [n, chunk, F] (rank r's shard is xs[r]) -> [n, n * chunk, F], one
    copy of the global array per rank."""
    n, chunk, f = xs.shape
    return xs.reshape(1, n * chunk, f).expand(n, n * chunk, f).contiguous()
