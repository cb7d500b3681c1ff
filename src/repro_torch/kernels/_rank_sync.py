"""Host side of the emulated-rank collective kernels (``csrc/rank_sync.cuh``).

A collective kernel takes a rank-stacked tensor (dim 0 is the rank) and a
table of per-rank base pointers.  Its flags live in a persistent buffer per
(device, stream, n, parts, layout) that ``FlagBuffers`` keeps: zeroed once, then
passed with a call epoch (1, 2, ...) against which the kernel compares, so no
call zeroes anything.  A wait that runs out of polls leaves a code in the
library's error word (pinned host memory, read without synchronising).
"""
from __future__ import annotations

import ctypes

import torch

MAX_RANKS = 64                                   # rank_sync::kMaxRanks
_WAITS = {1: "barrier", 2: "send", 3: "recv"}    # rank_sync::WaitKind
INT32_MAX = 2**31 - 1


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


class FlagBuffers:
    """The flag buffers of one collective library, one per (device, stream,
    n, parts, layout), each with the epoch of its last call.  ``layout``
    names the set of flags a call raises: a flag must be raised in every
    call on its buffer, or it falls behind the epoch (ring_all_gather's
    bidirectional variants raise the leftward flags, the others do not).

    ``take`` hands out a buffer and the epoch of the next call; ``give_back``
    returns it after a launch that was accepted.  A buffer that is not given
    back (the launch was refused or failed) is dropped, and the next call
    starts a zeroed one at epoch 1, so a refused launch never advances an
    epoch.  A flag is raised at most 2 * parts times per call, so a buffer is
    replaced by a zeroed one before epoch * 2 * parts could pass INT32_MAX.
    Buffers are keyed by stream: two streams never share one, and the calls
    on one stream run in order, so one call never sees another's raises."""

    def __init__(self, flag_ints):
        self._flag_ints = flag_ints          # (n, parts) -> ints of a buffer
        self._bufs: dict[tuple, tuple[torch.Tensor, int]] = {}

    def take(self, device: torch.device, stream: int, n: int, parts: int, layout: int):
        key = (device, stream, n, parts, layout)
        buf, epoch = self._bufs.pop(key, (None, 0))
        if buf is None or (epoch + 1) * 2 * parts > INT32_MAX:
            buf = torch.zeros(self._flag_ints(n, parts), dtype=torch.int32, device=device)
            epoch = 0
        return key, buf, epoch + 1

    def give_back(self, key: tuple, buf: torch.Tensor, epoch: int) -> None:
        self._bufs[key] = (buf, epoch)

    def clear(self) -> None:
        self._bufs.clear()

    def __len__(self) -> int:
        return len(self._bufs)


def check_error(lib, name: str, flags: FlagBuffers) -> None:
    """Raise if a wait of an earlier launch of ``lib`` ran out of polls, after
    dropping every flag buffer of the library (a failed wait leaves its
    buffer's counts unknown).  No synchronisation: a failure shows once its
    kernel has ended."""
    code = getattr(lib, f"{name}_error")()
    if code:
        getattr(lib, f"{name}_clear_error")()
        flags.clear()
        raise RuntimeError(describe(name, code))


def declare(lib, name: str, n_variant_flags: int) -> None:
    """Set the ctypes signatures of ``name`` (in_ptrs, out_ptrs, n,
    chunk_bytes, parts, variant flags..., flags, epoch, device, stream) and of
    its error, parts and flag_ints functions."""
    ptrs = ctypes.POINTER(ctypes.c_ulonglong)
    fn = getattr(lib, name)
    fn.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   *[ctypes.c_int] * n_variant_flags,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    getattr(lib, f"{name}_error").restype = ctypes.c_int
    getattr(lib, f"{name}_error").argtypes = []
    getattr(lib, f"{name}_clear_error").argtypes = []
    getattr(lib, f"{name}_clear_error").restype = None
    getattr(lib, f"{name}_parts").argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int]
    getattr(lib, f"{name}_parts").restype = ctypes.c_int
    getattr(lib, f"{name}_flag_ints").argtypes = [ctypes.c_int, ctypes.c_int]
    getattr(lib, f"{name}_flag_ints").restype = ctypes.c_longlong


def launch(lib, name: str, flags: FlagBuffers, xs: torch.Tensor, out: torch.Tensor,
           chunk_bytes: int, parts: int | None, variant_flags: tuple[int, ...],
           layout: int) -> None:
    """One launch of collective ``name`` of ``lib`` over the ranks of ``xs``
    (dim 0) into ``out`` on the current stream, with the persistent flag
    buffer of ``layout`` and its next epoch.  Raises if the launch is refused."""
    n = xs.shape[0]
    dev = xs.device.index if xs.device.index is not None else torch.cuda.current_device()
    chosen = getattr(lib, f"{name}_parts")(n, chunk_bytes, parts or 0, dev)
    if chosen == 0:
        raise RuntimeError(f"{name} launch failed: {n} ranks x {parts or 'auto'} CTAs "
                           f"cannot all be resident (cooperative launch too large)")
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    key, buf, epoch = flags.take(torch.device("cuda", dev), stream, n, chosen, layout)
    err = getattr(lib, name)(rank_pointers(xs), rank_pointers(out), n, chunk_bytes, chosen,
                             *variant_flags, buf.data_ptr(), epoch, dev, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    flags.give_back(key, buf, epoch)
