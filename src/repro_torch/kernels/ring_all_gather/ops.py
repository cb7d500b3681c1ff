"""Wrapper of the ring all-gather kernel (``csrc/ring_all_gather.cu``) over
ranks emulated on one device.

``ring_all_gather(xs, variant)`` takes the rank-stacked shards ``xs [n,
chunk, F]`` (the global view of ``shard_map(in_specs=P(axis, None))`` in the
reference) and returns every rank's gathered copy ``[n, n * chunk, F]``.
CUDA tensors go to the hand-written kernel, one launch for all ranks; CPU
tensors to the plain version in ``ref.py``.  ``launches`` counts kernel
launches (CPU calls do not count).  ``check()`` synchronises and raises if a
wait of any earlier launch ran out of polls (a lost flag); every launch also
raises first if an earlier one is known to have failed.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from .._rank_sync import MAX_RANKS, check_error, declare, rank_pointers
from .ref import all_gather_ref

NAME = "ring_all_gather"
DTYPES = (torch.float32, torch.bfloat16)
# variant -> (defer_send_sync, bidirectional), as in the reference's ops.py
VARIANTS = {"pcpy": (0, 0), "b2b": (1, 0), "bcst": (0, 1), "bcst_b2b": (1, 1)}

launches = 0


@functools.cache
def _lib():
    lib = _build.load(NAME)
    declare(lib, NAME, n_variant_flags=2)
    return lib


def flags_per_rank(n: int) -> int:
    """Barrier + send/recv flags of both streams, one per step."""
    return 1 + 4 * max(n - 1, 1)


def ctas_per_rank(n: int, chunk_bytes: int, requested: int = 0, device: int = 0) -> int:
    """CTAs per rank a launch uses (0: it cannot launch)."""
    return _lib().ring_all_gather_parts(n, chunk_bytes, requested, device)


def check() -> None:
    torch.cuda.synchronize()
    check_error(_lib(), NAME)


def ring_all_gather(xs: torch.Tensor, variant: str = "b2b", *,
                    parts: int | None = None) -> torch.Tensor:
    """xs [n, chunk, F] f32/bf16 -> [n, n * chunk, F]; ``variant`` is one of
    ``pcpy|b2b|bcst|bcst_b2b``; ``parts`` forces the CTAs per rank."""
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; use one of {sorted(VARIANTS)}")
    if xs.dim() != 3:
        raise ValueError(f"xs must be [n, chunk, F], got {tuple(xs.shape)}")
    if xs.dtype not in DTYPES:
        raise TypeError(f"xs dtype {xs.dtype} not supported; use one of {DTYPES}")
    n, chunk, f = xs.shape
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{n} ranks; the kernel takes 1..{MAX_RANKS}")
    if xs.device.type == "cpu":
        return all_gather_ref(xs)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    if not xs.is_contiguous():
        raise ValueError("xs must be contiguous")
    lib = _lib()
    check_error(lib, NAME)
    out = torch.empty((n, n * chunk, f), dtype=xs.dtype, device=xs.device)
    if out.numel() == 0:
        return out
    defer, bidir = VARIANTS[variant]
    flags = torch.zeros(n * flags_per_rank(n), dtype=torch.int32, device=xs.device)
    err = lib.ring_all_gather(rank_pointers(xs), rank_pointers(out), n,
                              chunk * f * xs.element_size(), parts or 0, defer, bidir,
                              flags.data_ptr(), xs.device.index or 0,
                              torch.cuda.current_stream(xs.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    launches += 1
    return out
