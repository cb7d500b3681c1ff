"""Plain PyTorch version of the per-rank ring reduce-scatter kernel: the
reference's ``ppermute`` ring (``repro.core.collectives.ring_reduce_scatter``)
run step by step over gloo, with one rank per process."""
from __future__ import annotations

import torch


def reduce_scatter_gloo(x: torch.Tensor, ranks) -> torch.Tensor:
    """This rank's addends x [n, *chunk] (x[i] for rank i) -> sum_e x_e[my]
    [*chunk], over ``ranks.ppermute`` (a ``core.procgroup.ProcessRanks`` on
    the CPU): the partial for rank o starts at o + 1 and travels n - 1 hops
    rightward, each rank adding its own addend, in the reference's order."""
    n, my = ranks.n, ranks.rank
    right = [(i, (i + 1) % n) for i in range(n)]
    acc = x[(my - 1) % n].clone()
    for r in range(n - 1):
        acc = ranks.ppermute(acc, right) + x[(my - r - 2) % n]
    return acc
