"""Wrapper of the per-rank ring reduce-scatter kernel
(``csrc/ring_reduce_scatter.cu``), with one rank per process.

``reduce_scatter_rank(x, ranks)`` takes this rank's addends ``x [n, chunk,
F]`` (``x[i]`` for rank i; ``ranks`` a ``core.procgroup.ProcessRanks``) and
returns ``sum_e x_e[my]`` ``[chunk, F]``, as the reference's
``ring_reduce_scatter`` does inside ``shard_map``.  CUDA tensors go to the
kernel: this rank's CTAs, storing each hop's partial into the right
neighbour's symmetric buffer through CUDA IPC and adding in float32 rounded
to the operand's type, bit-equal to the emulated rendering.  CPU tensors go
to the same ring step by step over gloo (``ref.reduce_scatter_gloo``).
Nothing falls back.  ``launches_rank`` counts the kernel's launches;
``check_ranks(ranks)`` is the collective error check.

The reference has no Pallas kernel for the reduce-scatter, so the kernel has
no emulated-ranks entry: over ranks emulated on one card the reduce-scatter
stays tensor code (``core.collectives.ring_reduce_scatter``).
"""
from __future__ import annotations

import functools

import torch

from .._rank_sync import MAX_RANKS, RankKernel, ring_parts, sm_count, too_many_ctas
from .ref import reduce_scatter_gloo

NAME = "ring_reduce_scatter"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # dtype -> the kernel's bf16 flag

launches_rank = 0


@functools.cache
def _kernel() -> RankKernel:
    """The library, its symmetric buffers and its error word.  Every flag
    is raised once per call; one slot per set (the kernel's neighbour
    barrier orders the reuse)."""
    return RankKernel(NAME, n_variant_flags=1, raises=lambda n, parts: 1)


def check_ranks(ranks) -> None:
    """Collective: synchronise this rank, raise on every rank if a wait of
    any rank's launch ran out (its buffers are dropped on all)."""
    _kernel().check_ranks(ranks)


def reduce_scatter_rank(x: torch.Tensor, ranks) -> torch.Tensor:
    """This rank's addends x [n, chunk, F] f32/bf16 -> [chunk, F], the sum
    over ranks of their addends for this rank; every rank of ``ranks`` makes
    the same call."""
    global launches_rank
    n = ranks.n
    if x.dim() != 3 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, chunk, F], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported; use one of {tuple(DTYPES)}")
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{n} ranks; the kernel takes 1..{MAX_RANKS}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    ranks.check(x)
    if x.device.type == "cpu":
        return reduce_scatter_gloo(x, ranks)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    kernel = _kernel()
    kernel.check_error()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    chunk_bytes = out.numel() * x.element_size()
    chosen = ring_parts(n, chunk_bytes, sm_count(x.device.index))
    if chosen == 0:
        raise too_many_ctas(NAME, n, None)
    # the symmetric output: this rank's result, then a receive slot per step
    kernel.launch_rank(x, ranks, out, chunk_bytes, chosen, (DTYPES[x.dtype],), layout=0,
                       sym_bytes=n * chunk_bytes)
    launches_rank += 1
    return out
