"""Wrappers of the all-to-all kernel (``csrc/ring_all_to_all.cu``), over
ranks emulated on one device and over ranks with one process each.

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

``all_to_all_rank(x, ranks, variant)`` is the same collective with one rank
per process (``core.procgroup.ProcessRanks``): ``x [n, chunk, F]`` holds
this rank's chunk for each rank, and the result ``[n, chunk, F]`` rank j's
chunk for this rank at [j].  CUDA tensors go to the per-rank kernel (this
rank's CTAs, storing into its partners' outputs through CUDA IPC, two
alternating buffer slots); CPU tensors to the same pairing round by round
over gloo (``ref.all_to_all_gloo``).  ``launches_rank`` counts the per-rank
launches; ``check_ranks(ranks)`` is the collective check.
"""
from __future__ import annotations

import functools

import torch

from .._rank_sync import MAX_RANKS, RankKernel, a2a_plan, sm_count, too_many_ctas
from .ref import all_to_all_gloo, all_to_all_ref

NAME = "ring_all_to_all"
DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = {"per_round": 0, "b2b": 1}     # variant -> b2b flag of the kernel

launches = 0
launches_rank = 0


@functools.cache
def _kernel() -> RankKernel:
    """The library, its flag buffers (one set per variant: b2b raises the
    arrival counters, per_round the per-round flags) and its error word.  A
    flag is raised at most max(parts, n) times per call.  The per-rank path
    alternates two slots of symmetric buffers (the kernel's header says
    why)."""
    return RankKernel(NAME, n_variant_flags=1, raises=lambda n, parts: max(parts, n), slots=2)


def ctas_per_rank(n: int, chunk_bytes: int, requested: int = 0, device: int = 0,
                  variant: str = "b2b") -> int:
    """CTAs per rank a launch uses (0: it cannot launch)."""
    plan = a2a_plan(n, chunk_bytes, sm_count(device), requested, bool(VARIANTS[variant]))
    return plan.parts if plan else 0


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


def all_to_all(xs: torch.Tensor, variant: str = "b2b", *,
               parts: int | None = None) -> torch.Tensor:
    """xs [n, n, chunk, F] f32/bf16 -> [n, n, chunk, F]; ``variant`` is
    ``per_round`` or ``b2b``; ``parts`` forces the CTAs per rank."""
    global launches
    if xs.dim() != 4 or xs.shape[0] != xs.shape[1]:
        raise ValueError(f"xs must be [n, n, chunk, F], got {tuple(xs.shape)}")
    n = xs.shape[0]
    _validate(xs, variant, n)
    if xs.device.type == "cpu":
        return all_to_all_ref(xs)
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


def all_to_all_rank(x: torch.Tensor, ranks, variant: str = "b2b", *,
                    parts: int | None = None) -> torch.Tensor:
    """This rank's chunks x [n, chunk, F] f32/bf16 (x[i] for rank i) -> the
    chunks for it [n, chunk, F] (rank j's at [j]); every rank of ``ranks``
    makes the same call.  ``variant`` and ``parts`` as for ``all_to_all``."""
    global launches_rank
    n = ranks.n
    if x.dim() != 3 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, chunk, F], got {tuple(x.shape)}")
    _validate(x, variant, n)
    ranks.check(x)
    if x.device.type == "cpu":
        return all_to_all_gloo(x, ranks)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    kernel = _kernel()
    kernel.check_error()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    chunk_bytes = x.numel() // n * x.element_size()
    b2b = VARIANTS[variant]
    plan = a2a_plan(n, chunk_bytes, sm_count(x.device.index), parts or 0, bool(b2b))
    if plan is None:
        raise too_many_ctas(NAME, n, parts)
    kernel.launch_rank(x, ranks, out, chunk_bytes, plan.parts, (b2b,), layout=b2b)
    launches_rank += 1
    return out
