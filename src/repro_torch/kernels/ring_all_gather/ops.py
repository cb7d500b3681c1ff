"""Wrappers of the ring all-gather kernel (``csrc/ring_all_gather.cu``), over
ranks emulated on one device and over ranks with one process each.

``ring_all_gather(xs, variant)`` takes the rank-stacked shards ``xs [n,
chunk, F]`` (the global view of ``shard_map(in_specs=P(axis, None))`` in the
reference) and returns every rank's gathered copy ``[n, n * chunk, F]``.
CUDA tensors go to the hand-written kernel, one launch for all ranks; CPU
tensors to the plain version in ``ref.py``.  ``launches`` counts kernel
launches (CPU calls do not count).  ``check()`` synchronises and raises if a
wait of any earlier launch ran out of polls (a lost flag); every launch also
raises first if an earlier one is known to have failed.  The kernel's flags live in
persistent buffers with a call epoch (``_rank_sync.FlagBuffers``): no call
zeroes anything.

``ring_all_gather_rank(x, ranks, variant)`` is the same collective with one
rank per process (``core.procgroup.ProcessRanks``): ``x [chunk, F]`` is this
rank's shard and the result ``[n * chunk, F]`` this rank's gathered copy.
CUDA tensors go to the per-rank kernel (this rank's CTAs, storing into its
neighbours' outputs through CUDA IPC); CPU tensors to the same ring step by
step over gloo (``ref.all_gather_gloo``).  ``launches_rank`` counts the
per-rank launches; ``check_ranks(ranks)`` is the collective check.
"""
from __future__ import annotations

import functools

import torch

from .._rank_sync import MAX_RANKS, RankKernel, ring_parts, sm_count, too_many_ctas
from .ref import all_gather_gloo, all_gather_ref

NAME = "ring_all_gather"
DTYPES = (torch.float32, torch.bfloat16)
# variant -> (defer_send_sync, bidirectional), as in the reference's ops.py
VARIANTS = {"pcpy": (0, 0), "b2b": (1, 0), "bcst": (0, 1), "bcst_b2b": (1, 1)}

launches = 0
launches_rank = 0


@functools.cache
def _kernel() -> RankKernel:
    """The library, its flag buffers and its error word."""
    return RankKernel(NAME, n_variant_flags=2)


def ctas_per_rank(n: int, chunk_bytes: int, requested: int = 0, device: int = 0) -> int:
    """CTAs per rank a launch uses (0: it cannot launch)."""
    return ring_parts(n, chunk_bytes, sm_count(device), requested)


def check() -> None:
    torch.cuda.synchronize()
    _kernel().check_error()


def check_ranks(ranks) -> None:
    """Collective: synchronise this rank, raise on every rank if a wait of
    any rank's per-rank launch ran out (its buffers are dropped on all)."""
    _kernel().check_ranks(ranks)


def _validate(x: torch.Tensor, variant: str, n: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; use one of {sorted(VARIANTS)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported; use one of {DTYPES}")
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{n} ranks; the kernel takes 1..{MAX_RANKS}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def ring_all_gather(xs: torch.Tensor, variant: str = "b2b", *,
                    parts: int | None = None) -> torch.Tensor:
    """xs [n, chunk, F] f32/bf16 -> [n, n * chunk, F]; ``variant`` is one of
    ``pcpy|b2b|bcst|bcst_b2b``; ``parts`` forces the CTAs per rank."""
    global launches
    if xs.dim() != 3:
        raise ValueError(f"xs must be [n, chunk, F], got {tuple(xs.shape)}")
    n, chunk, f = xs.shape
    _validate(xs, variant, n)
    if xs.device.type == "cpu":
        return all_gather_ref(xs)
    if not xs.is_contiguous():
        raise ValueError("xs must be contiguous")
    kernel = _kernel()
    kernel.check_error()
    out = torch.empty((n, n * chunk, f), dtype=xs.dtype, device=xs.device)
    if out.numel() == 0:
        return out
    chunk_bytes = chunk * f * xs.element_size()
    chosen = ring_parts(n, chunk_bytes, sm_count(xs.device.index), parts or 0)
    if chosen == 0:
        raise too_many_ctas(NAME, n, parts)
    defer, bidir = VARIANTS[variant]
    # the bidirectional variants raise the leftward flags too: a buffer of their own
    kernel.launch(xs, out, chunk_bytes, chosen, (defer, bidir), layout=bidir)
    launches += 1
    return out


def ring_all_gather_rank(x: torch.Tensor, ranks, variant: str = "b2b", *,
                         parts: int | None = None) -> torch.Tensor:
    """This rank's shard x [chunk, F] f32/bf16 -> its gathered copy
    [n * chunk, F] (rank j's shard at rows [j * chunk, (j + 1) * chunk));
    every rank of ``ranks`` makes the same call.  ``variant`` and ``parts``
    as for ``ring_all_gather``."""
    global launches_rank
    if x.dim() != 2:
        raise ValueError(f"x must be [chunk, F], got {tuple(x.shape)}")
    n = ranks.n
    _validate(x, variant, n)
    ranks.check(x)
    chunk, f = x.shape
    defer, bidir = VARIANTS[variant]
    if x.device.type == "cpu":
        return all_gather_gloo(x, ranks, bidir=bool(bidir))
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    kernel = _kernel()
    kernel.check_error()
    out = torch.empty((n * chunk, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    chunk_bytes = chunk * f * x.element_size()
    chosen = ring_parts(n, chunk_bytes, sm_count(x.device.index), parts or 0)
    if chosen == 0:
        raise too_many_ctas(NAME, n, parts)
    kernel.launch_rank(x, ranks, out, chunk_bytes, chosen, (defer, bidir), layout=bidir)
    launches_rank += 1
    return out
