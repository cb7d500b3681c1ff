"""Wrapper of the all-to-all kernel (``csrc/ring_all_to_all.cu``) over ranks
emulated on one device.

``all_to_all(xs, variant)`` takes ``xs [n, n, chunk, F]``, where ``xs[j, i]``
is rank j's chunk for rank i (the global view of ``shard_map(in_specs=P(axis,
None, None, None))`` in the reference), and returns ``out[i, j] = xs[j, i]``.
CUDA tensors go to the hand-written kernel, one launch for all ranks; CPU
tensors to the plain version in ``ref.py``.  ``launches`` counts kernel
launches (CPU calls do not count); ``check()`` synchronises and raises if a
wait of an earlier launch ran out of polls.  The CTAs per rank and their
division over partners and shares come from ``_rank_sync.a2a_plan``, cached
per call shape.  The kernel's flags live in persistent buffers with a call
epoch (``_rank_sync.FlagBuffers``): no call zeroes anything.
"""
from __future__ import annotations

import functools

import torch

from .._rank_sync import MAX_RANKS, RankKernel, a2a_plan, sm_count, too_many_ctas
from .ref import all_to_all_ref

NAME = "ring_all_to_all"
DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = {"per_round": 0, "b2b": 1}     # variant -> b2b flag of the kernel

launches = 0


@functools.cache
def _kernel() -> RankKernel:
    """The library, its flag buffers (one set per variant: b2b raises the
    arrival counters, per_round the per-round flags) and its error word.  A
    flag is raised at most max(parts, n) times per call."""
    return RankKernel(NAME, n_variant_flags=1, raises=lambda n, parts: max(parts, n))


def ctas_per_rank(n: int, chunk_bytes: int, requested: int = 0, device: int = 0,
                  variant: str = "b2b") -> int:
    """CTAs per rank a launch uses (0: it cannot launch)."""
    plan = a2a_plan(n, chunk_bytes, sm_count(device), requested, bool(VARIANTS[variant]))
    return plan.parts if plan else 0


def check() -> None:
    torch.cuda.synchronize()
    _kernel().check_error()


def all_to_all(xs: torch.Tensor, variant: str = "b2b", *,
               parts: int | None = None) -> torch.Tensor:
    """xs [n, n, chunk, F] f32/bf16 -> [n, n, chunk, F]; ``variant`` is
    ``per_round`` or ``b2b``; ``parts`` forces the CTAs per rank."""
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; use one of {sorted(VARIANTS)}")
    if xs.dim() != 4 or xs.shape[0] != xs.shape[1]:
        raise ValueError(f"xs must be [n, n, chunk, F], got {tuple(xs.shape)}")
    if xs.dtype not in DTYPES:
        raise TypeError(f"xs dtype {xs.dtype} not supported; use one of {DTYPES}")
    n = xs.shape[0]
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{n} ranks; the kernel takes 1..{MAX_RANKS}")
    if xs.device.type == "cpu":
        return all_to_all_ref(xs)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    if not xs.is_contiguous():
        raise ValueError("xs must be contiguous")
    kernel = _kernel()
    kernel.check_error()
    out = torch.empty_like(xs)
    if out.numel() == 0:
        return out
    chunk_bytes = xs.numel() // (n * n) * xs.element_size()
    b2b = VARIANTS[variant]
    plan = a2a_plan(n, chunk_bytes, sm_count(xs.device.index), parts or 0, bool(b2b))
    if plan is None:
        raise too_many_ctas(NAME, n, parts)
    kernel.launch(xs, out, chunk_bytes, plan.parts, (b2b,), layout=b2b)
    launches += 1
    return out
