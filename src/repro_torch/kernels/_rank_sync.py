"""Host side of the emulated-rank collective kernels (``csrc/rank_sync.cuh``).

A collective kernel takes a rank-stacked contiguous tensor (dim 0 is the
rank) by its base pointer, and the CTAs per rank that the host chose for the
call's shape: ``ring_parts`` for the ring all-gather, ``A2APlan`` for the
all-to-all, each computed once per (n, chunk bytes, SM count) and cached, so
a call neither queries the device nor repeats the choice.  Its flags live in
a persistent buffer per (device, stream, n, parts, layout) that
``FlagBuffers`` keeps: zeroed once, then passed with a call epoch (1, 2, ...)
against which the kernel compares, so no call zeroes anything.  A wait that
runs out of polls leaves a code in the library's error word (pinned host
memory, read here without synchronising or calling into the library).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

MAX_RANKS = 64                                   # rank_sync::kMaxRanks
_WAITS = {1: "barrier", 2: "send", 3: "recv", 4: "arrival"}    # rank_sync::WaitKind
INT32_MAX = 2**31 - 1
RING_BYTES_PER_PART = 32 * 1024     # ring all-gather: a CTA per 32 KiB of chunk
A2A_SHARE_BYTES = 4 * 1024          # all-to-all b2b: at least 4 KiB of chunk per share
A2A_ROUND_BYTES_PER_CTA = 32 * 1024  # all-to-all per_round: a CTA per 32 KiB of a rank


@functools.cache
def sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def ring_parts(n: int, chunk_bytes: int, sms: int, requested: int = 0) -> int:
    """CTAs per rank of the ring all-gather: one per 32 KiB of chunk, at most
    sms // n so every CTA of the grid has an SM of its own (they wait on each
    other, so all must be resident).  ``requested`` > 0 overrides the
    choice.  0: the call cannot launch."""
    most = sms // n
    if most < 1 or requested > most:
        return 0
    if requested > 0:
        return requested
    return max(1, min(most, -(-chunk_bytes // RING_BYTES_PER_PART)))


@dataclasses.dataclass(frozen=True)
class A2APlan:
    """The all-to-all's division of work (twin of ``work_of`` and the
    per_round path in ``csrc/ring_all_to_all.cu``).  Rank ``my`` has
    ``parts`` CTAs and n rounds: round 0 is its own chunk, round r sends
    chunk ``partner(my, r)``.  b2b divides the CTAs over the rounds first
    and over shares of a chunk second; per_round gives CTA c share c of
    every round (its rounds run one after another)."""
    n: int
    parts: int

    @property
    def grid(self) -> int:
        return self.n * self.parts

    @property
    def arrivals(self) -> int:
        """Raises of a rank's arrival counter per b2b call: the CTAs that
        store into it (the drain's target per epoch)."""
        return max(self.parts, self.n)

    def partner(self, my: int, r: int) -> int:
        n = self.n
        return my ^ r if n & (n - 1) == 0 else (my + r) % n

    def shares(self, r: int, b2b: bool = True) -> int:
        """CTAs of a rank that store round r's chunk (per_round's flag
        target per epoch)."""
        n, parts = self.n, self.parts
        if not b2b:
            return parts
        return parts // n + (r < parts % n) if parts >= n else 1

    def work_of(self, c: int, b2b: bool = True) -> tuple[list[int], int, int]:
        """CTA c's rounds and its share of each: (rounds, share, shares)."""
        n, parts = self.n, self.parts
        if not b2b:
            return list(range(n)), c, parts
        if parts >= n:
            base, extra = divmod(parts, n)
            wide = extra * (base + 1)
            r = c // (base + 1) if c < wide else extra + (c - wide) // base
            q = c % (base + 1) if c < wide else (c - wide) % base
            return [r], q, self.shares(r)
        return list(range(c, n, parts)), 0, 1


@functools.lru_cache(maxsize=1024)
def a2a_plan(n: int, chunk_bytes: int, sms: int, requested: int = 0,
             b2b: bool = True) -> A2APlan | None:
    """CTAs per rank of the all-to-all, at most sms // n (all resident, as
    above).  b2b: as many, but no more than one per 4 KiB share of each of
    the n chunks and at least one per round where the SMs allow.
    per_round: one per 32 KiB of the rank's n chunks (its rounds are a
    chain of flag round trips, and at 64 KiB a rank 2 CTAs beat 16: PERF.md
    §6).  ``requested`` > 0 overrides the choice.  None: the call cannot
    launch."""
    most = sms // n
    if most < 1 or requested > most:
        return None
    if requested > 0:
        return A2APlan(n, requested)
    if not b2b:
        return A2APlan(n, max(1, min(most, -(-n * chunk_bytes // A2A_ROUND_BYTES_PER_CTA))))
    return A2APlan(n, min(most, n * -(-chunk_bytes // A2A_SHARE_BYTES)))


def describe(name: str, code: int) -> str:
    kind = _WAITS.get((code >> 24) & 0xF, "?")
    stream = "leftward" if (code >> 20) & 0xF else "rightward"
    rank, step = (code >> 10) & 0x3FF, code & 0x3FF
    return (f"{name}: rank {rank} gave up waiting for its {kind} flag at step {step} "
            f"({stream} stream); the collective's output is not valid")


def two_per_part(n: int, parts: int) -> int:
    return 2 * parts


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
    epoch.  A flag is raised at most ``raises(n, parts)`` times per call (2 *
    parts unless the library says otherwise), so a buffer is replaced by a
    zeroed one before epoch * raises could pass INT32_MAX.  Buffers are keyed
    by stream: two streams never share one, and the calls on one stream run
    in order, so one call never sees another's raises."""

    def __init__(self, flag_ints, raises=two_per_part):
        self._flag_ints = flag_ints          # (n, parts) -> ints of a buffer
        self._raises = raises                # (n, parts) -> most raises of a flag per call
        self._bufs: dict[tuple, tuple[torch.Tensor, int]] = {}

    def take(self, device, stream: int, n: int, parts: int, layout: int):
        key = (device, stream, n, parts, layout)
        buf, epoch = self._bufs.pop(key, (None, 0))
        if buf is None or (epoch + 1) * self._raises(n, parts) > INT32_MAX:
            buf = torch.zeros(self._flag_ints(n, parts), dtype=torch.int32, device=device)
            epoch = 0
        return key, buf, epoch + 1

    def give_back(self, key: tuple, buf: torch.Tensor, epoch: int) -> None:
        self._bufs[key] = (buf, epoch)

    def clear(self) -> None:
        self._bufs.clear()

    def __len__(self) -> int:
        return len(self._bufs)


class RankKernel:
    """One collective library (``csrc/<name>.cu``), built at first use: its C
    entry ``name(in, out, n, chunk_bytes, parts, variant flags..., flags,
    epoch, device, stream)``, its flag buffers and its error word."""

    def __init__(self, name: str, n_variant_flags: int, raises=two_per_part):
        lib = _build.load(name)
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.name = name
        self._fn = getattr(lib, name)
        self._fn.argtypes = [vp, vp, i, ctypes.c_longlong, i, *[i] * n_variant_flags,
                             vp, i, i, vp]
        self._fn.restype = i
        flag_ints = getattr(lib, f"{name}_flag_ints")
        flag_ints.argtypes, flag_ints.restype = [i, i], ctypes.c_longlong
        self.flags = FlagBuffers(flag_ints, raises)
        word = getattr(lib, f"{name}_error_word")
        word.argtypes, word.restype = [], vp
        addr = word()
        if not addr:
            raise RuntimeError(f"{name}: cannot map its error word into the device")
        self._error = ctypes.c_int.from_address(addr)

    def check_error(self) -> None:
        """Raise if a wait of an earlier launch ran out of polls, after
        dropping every flag buffer of the library (a failed wait leaves its
        buffer's counts unknown).  No synchronisation: a failure shows once
        its kernel has ended."""
        code = self._error.value
        if code:
            self._error.value = 0
            self.flags.clear()
            raise RuntimeError(describe(self.name, code))

    def launch(self, xs: torch.Tensor, out: torch.Tensor, chunk_bytes: int, parts: int,
               variant_flags: tuple[int, ...], layout: int) -> None:
        """One launch over the ranks of ``xs`` (dim 0; contiguous, as is
        ``out``) on the current stream with ``parts`` CTAs per rank, the
        persistent flag buffer of ``layout`` and its next epoch.  Raises if
        the launch is refused."""
        n = xs.shape[0]
        dev = xs.device.index
        # the raw handle of torch.cuda.current_stream(dev), without building
        # a Stream object (5 us a call on the host, PERF.md §6)
        stream = torch._C._cuda_getCurrentRawStream(dev)
        key, buf, epoch = self.flags.take(dev, stream, n, parts, layout)
        err = self._fn(xs.data_ptr(), out.data_ptr(), n, chunk_bytes, parts, *variant_flags,
                       buf.data_ptr(), epoch, dev, stream)
        if err:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.flags.give_back(key, buf, epoch)


def too_many_ctas(name: str, n: int, parts: int | None) -> RuntimeError:
    return RuntimeError(f"{name} launch failed: {n} ranks x {parts or 'auto'} CTAs "
                        f"cannot all be resident (cooperative launch too large)")
