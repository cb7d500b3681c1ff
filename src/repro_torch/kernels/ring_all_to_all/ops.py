"""Wrapper of the all-to-all kernel (``csrc/ring_all_to_all.cu``) over ranks
emulated on one device.

``all_to_all(xs, variant)`` takes ``xs [n, n, chunk, F]``, where ``xs[j, i]``
is rank j's chunk for rank i (the global view of ``shard_map(in_specs=P(axis,
None, None, None))`` in the reference), and returns ``out[i, j] = xs[j, i]``.
CUDA tensors go to the hand-written kernel, one launch for all ranks; CPU
tensors to the plain version in ``ref.py``.  ``launches`` counts kernel
launches (CPU calls do not count); ``check()`` synchronises and raises if a
wait of an earlier launch ran out of polls.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from .._rank_sync import MAX_RANKS, check_error, declare, rank_pointers
from .ref import all_to_all_ref

NAME = "ring_all_to_all"
DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = {"per_round": 0, "b2b": 1}     # variant -> b2b flag of the kernel

launches = 0


@functools.cache
def _lib():
    lib = _build.load(NAME)
    declare(lib, NAME, n_variant_flags=1)
    return lib


def flags_per_rank(n: int) -> int:
    """Barrier + send/recv flags, one per round."""
    return 1 + 2 * max(n - 1, 1)


def ctas_per_rank(n: int, chunk_bytes: int, requested: int = 0, device: int = 0) -> int:
    """CTAs per rank a launch uses (0: it cannot launch)."""
    return _lib().ring_all_to_all_parts(n, chunk_bytes, requested, device)


def check() -> None:
    torch.cuda.synchronize()
    check_error(_lib(), NAME)


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
    lib = _lib()
    check_error(lib, NAME)
    out = torch.empty_like(xs)
    if out.numel() == 0:
        return out
    flags = torch.zeros(n * flags_per_rank(n), dtype=torch.int32, device=xs.device)
    err = lib.ring_all_to_all(rank_pointers(xs), rank_pointers(out), n,
                              xs[0, 0].numel() * xs.element_size(), parts or 0,
                              VARIANTS[variant], flags.data_ptr(), xs.device.index or 0,
                              torch.cuda.current_stream(xs.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    launches += 1
    return out
