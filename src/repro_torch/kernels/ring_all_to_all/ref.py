"""Plain PyTorch version of the all-to-all kernel (the oracle of
``repro.kernels.ring_all_to_all.ref``): ``out[i, j] = xs[j, i]``."""
from __future__ import annotations

import torch


def all_to_all_ref(xs: torch.Tensor) -> torch.Tensor:
    """xs [n, n, chunk, F] (rank j's chunk for rank i is xs[j, i]) -> the
    chunk transpose, [n, n, chunk, F]."""
    return xs.transpose(0, 1).contiguous()
