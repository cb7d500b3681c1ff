"""Plain PyTorch versions of the all-to-all kernel (the oracle of
``repro.kernels.ring_all_to_all.ref``): ``out[i, j] = xs[j, i]``.
``all_to_all_ref`` over emulated ranks; ``all_to_all_gloo`` with one rank
per process, the kernel's pairing run round by round over gloo."""
from __future__ import annotations

import torch


def all_to_all_ref(xs: torch.Tensor) -> torch.Tensor:
    """xs [n, n, chunk, F] (rank j's chunk for rank i is xs[j, i]) -> the
    chunk transpose, [n, n, chunk, F]."""
    return xs.transpose(0, 1).contiguous()


def all_to_all_gloo(x: torch.Tensor, ranks) -> torch.Tensor:
    """This rank's chunks x [n, chunk, F] (x[i] for rank i) -> [n, chunk, F]
    (rank j's chunk for this rank at [j]), over ``ranks.ppermute`` (a
    ``core.procgroup.ProcessRanks`` on the CPU): round r sends x[my ^ r] to
    rank my ^ r when n is a power of two, else x[my + r] to rank my + r
    (rotation), as the kernel pairs; round 0 is the own chunk."""
    n, my = ranks.n, ranks.rank
    xor = n & (n - 1) == 0
    out = torch.zeros_like(x)
    out[my] = x[my]
    for r in range(1, n):
        if xor:
            perm, to, frm = [(i, i ^ r) for i in range(n)], my ^ r, my ^ r
        else:
            perm, to, frm = [(i, (i + r) % n) for i in range(n)], (my + r) % n, (my - r) % n
        out[frm] = ranks.ppermute(x[to], perm)
    return out
