"""Host side of the emulated-rank collective kernels (``csrc/rank_sync.cuh``).

A collective kernel takes a rank-stacked tensor (dim 0 is the rank) and a
table of per-rank base pointers; its flags are one int32 tensor per call,
zeroed by the wrapper, and a wait that runs out of polls leaves a code in
the library's error word (pinned host memory, read without synchronising).
"""
from __future__ import annotations

import ctypes

import torch

MAX_RANKS = 64                                   # rank_sync::kMaxRanks
_WAITS = {1: "barrier", 2: "send", 3: "recv"}    # rank_sync::WaitKind


def rank_pointers(x: torch.Tensor):
    """ctypes array of the base address of each x[r]."""
    step = x.stride(0) * x.element_size()
    base = x.data_ptr()
    return (ctypes.c_ulonglong * x.shape[0])(*(base + r * step for r in range(x.shape[0])))


def describe(name: str, code: int) -> str:
    kind = _WAITS.get((code >> 24) & 0xF, "?")
    stream = "leftward" if (code >> 20) & 0xF else "rightward"
    rank, step = (code >> 10) & 0x3FF, code & 0x3FF
    return (f"{name}: rank {rank} gave up waiting for its {kind} flag at step {step} "
            f"({stream} stream); the collective's output is not valid")


def check_error(lib, name: str) -> None:
    """Raise if a wait of an earlier launch of ``lib`` ran out of polls.  No
    synchronisation: a failure shows once its kernel has ended."""
    code = getattr(lib, f"{name}_error")()
    if code:
        getattr(lib, f"{name}_clear_error")()
        raise RuntimeError(describe(name, code))


def declare(lib, name: str, n_variant_flags: int) -> None:
    """Set the ctypes signatures of ``name`` (in_ptrs, out_ptrs, n,
    chunk_bytes, parts, variant flags..., flags, device, stream) and of its
    error and parts functions."""
    ptrs = ctypes.POINTER(ctypes.c_ulonglong)
    fn = getattr(lib, name)
    fn.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   *[ctypes.c_int] * n_variant_flags,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    getattr(lib, f"{name}_error").restype = ctypes.c_int
    getattr(lib, f"{name}_error").argtypes = []
    getattr(lib, f"{name}_clear_error").argtypes = []
    getattr(lib, f"{name}_clear_error").restype = None
    getattr(lib, f"{name}_parts").argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int]
    getattr(lib, f"{name}_parts").restype = ctypes.c_int
