"""Host side of the rank collective kernels (``csrc/rank_sync.cuh``).

Emulated ranks: a collective kernel takes a rank-stacked contiguous tensor
(dim 0 is the rank) by its base pointer, and the CTAs per rank that the
host chose for the call's shape: ``ring_parts`` for the ring all-gather, ``A2APlan`` for the
all-to-all, each computed once per (n, chunk bytes, SM count) and cached, so
a call neither queries the device nor repeats the choice.  Its flags live in
a persistent buffer per (device, stream, n, parts, layout) that
``FlagBuffers`` keeps: zeroed once, then passed with a call epoch (1, 2, ...)
against which the kernel compares, so no call zeroes anything.  A wait that
runs out of polls leaves a code in the library's error word (pinned host
memory, read here without synchronising or calling into the library).

One rank per process (``core.procgroup.ProcessRanks``): ``launch_rank``
launches this rank's CTAs only.  Its outputs and flags live in symmetric
buffers (``SymmetricBuffers``): each rank allocates its own once per (n,
chunk bytes, parts, layout) with ``csrc/rank_ipc.cu``, the ranks exchange
their CUDA IPC handles over the gloo group, and each opens its peers' once.
Epochs count calls as above; the all-to-all alternates two slots (its
kernel's header says why).  A call copies its result out of the symmetric
output into a fresh tensor.  The error word stays per process:
``check_error`` raises on the rank whose wait failed, and ``check_ranks``
(collective) drops every rank's symmetric buffers after a failure anywhere.
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


class IPC:
    """``csrc/rank_ipc.cu``: device memory shared between processes."""

    def __init__(self):
        lib = _build.load("rank_ipc")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pp = ctypes.POINTER(ctypes.c_void_p)
        for fn, args in (("alloc", [ll, i, pp]), ("free", [vp, i]), ("handle", [vp, i, vp]),
                         ("open", [vp, i, pp]), ("close", [vp, i]),
                         ("copy", [vp, vp, ll, i, vp]), ("handle_bytes", [])):
            f = getattr(lib, f"rank_ipc_{fn}")
            f.argtypes, f.restype = args, i
            setattr(self, f"_{fn}", f)
        self.handle_bytes = self._handle_bytes()

    @staticmethod
    def _ok(what: str, err: int) -> None:
        if err:
            raise RuntimeError(f"rank_ipc {what} failed: CUDA error {err}")

    def alloc(self, nbytes: int, device: int) -> int:
        ptr = ctypes.c_void_p()
        self._ok("alloc", self._alloc(nbytes, device, ctypes.byref(ptr)))
        return ptr.value

    def free(self, ptr: int, device: int) -> None:
        self._ok("free", self._free(ptr, device))

    def handle(self, ptr: int, device: int) -> bytes:
        buf = ctypes.create_string_buffer(self.handle_bytes)
        self._ok("handle", self._handle(ptr, device, buf))
        return buf.raw

    def open(self, handle: bytes, device: int) -> int:
        ptr = ctypes.c_void_p()
        self._ok("open", self._open(handle, device, ctypes.byref(ptr)))
        return ptr.value

    def close(self, ptr: int, device: int) -> None:
        self._ok("close", self._close(ptr, device))

    def copy(self, dst: int, src: int, nbytes: int, device: int, stream: int) -> None:
        self._ok("copy", self._copy(dst, src, nbytes, device, stream))


@functools.cache
def ipc() -> IPC:
    return IPC()


ALIGN = 256                      # bytes: every region of a symmetric buffer starts on it


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


@dataclasses.dataclass
class Symmetric:
    """One symmetric buffer set: every rank's allocation of ``slots`` x
    (flags, output), as pointers in this process (peers' IPC-mapped), and
    the calls made on it."""
    own: int
    bases: tuple[int, ...]       # every rank's allocation here (own at my)
    opened: tuple[int, ...]      # the peers' mappings, to close
    flag_bytes: int
    out_bytes: int
    stream: int
    calls: int = 0

    def slot(self, s: int) -> tuple[list[int], list[int]]:
        """(flags, outputs) of every rank in slot s."""
        at = s * (self.flag_bytes + self.out_bytes)
        flags = [b + at for b in self.bases]
        return flags, [f + self.flag_bytes for f in flags]


class SymmetricBuffers:
    """The per-rank symmetric buffers of one library, keyed by (n, output
    bytes, parts, layout).  Making one is collective: every rank of the
    group makes the same calls in the same order, so every rank takes the
    same keys in the same order and every call's epoch agrees.  Calls on one
    buffer set run on one stream (the ordering of its reuse rests on it)."""

    def __init__(self, flag_ints, raises, slots: int):
        self._flag_ints = flag_ints          # (n, parts) -> ints of one rank's region
        self._raises = raises
        self.slots = slots
        self._bufs: dict[tuple, Symmetric] = {}

    def take(self, ranks, out_bytes: int, parts: int, layout: int, stream: int):
        """(buffer set, slot, epoch) of the next call; makes the set on
        first use, and anew when an epoch would pass INT32_MAX."""
        n = ranks.n
        key = (n, out_bytes, parts, layout)
        sym = self._bufs.get(key)
        if sym is not None and (sym.calls // self.slots + 2) * self._raises(n, parts) > INT32_MAX:
            self._release(ranks, self._bufs.pop(key))
            sym = None
        if sym is None:
            flag_bytes = _aligned(4 * self._flag_ints(n, parts))
            sym = self._bufs[key] = _make_symmetric(
                ranks, flag_bytes, _aligned(out_bytes), self.slots, stream)
        if sym.stream != stream:
            raise RuntimeError("a per-rank collective's buffers are used on one stream; "
                               "this call runs on another")
        slot, epoch = sym.calls % self.slots, sym.calls // self.slots + 1
        sym.calls += 1
        return sym, slot, epoch

    def release(self, ranks) -> None:
        """Free every set (collective)."""
        for key in list(self._bufs):
            self._release(ranks, self._bufs.pop(key))

    @staticmethod
    def _release(ranks, sym: Symmetric) -> None:
        # no peer may still run a kernel that stores into this rank's
        # allocation, and none may hold it open when it is freed
        torch.cuda.synchronize(ranks.device)
        ranks.barrier()
        io, dev = ipc(), ranks.device.index
        for ptr in sym.opened:
            io.close(ptr, dev)
        ranks.barrier()
        io.free(sym.own, dev)


def _make_symmetric(ranks, flag_bytes: int, out_bytes: int, slots: int,
                    stream: int) -> Symmetric:
    io, dev = ipc(), ranks.device.index
    own = io.alloc(slots * (flag_bytes + out_bytes), dev)      # zeroed, synchronised
    handles = ranks.all_gather_object(io.handle(own, dev))
    bases = [own if r == ranks.rank else io.open(h, dev) for r, h in enumerate(handles)]
    opened = tuple(b for r, b in enumerate(bases) if r != ranks.rank)
    # no rank raises a peer's flag before every rank has mapped every buffer
    ranks.barrier()
    return Symmetric(own, tuple(bases), opened, flag_bytes, out_bytes, stream)


_SYMMETRIC: dict[str, SymmetricBuffers] = {}


def release_symmetric(ranks) -> None:
    """Free every library's per-rank buffers (collective: every rank calls
    it, after its last collective)."""
    for name in sorted(_SYMMETRIC):
        _SYMMETRIC[name].release(ranks)


class RankKernel:
    """One collective library (``csrc/<name>.cu``), built at first use: its C
    entries ``name(in, out, n, chunk_bytes, parts, variant flags..., flags,
    epoch, device, stream)`` (emulated ranks, where the library has them)
    and ``name_rank(my, n, in, outs, flags,
    chunk_bytes, parts, variant flags..., epoch, device, stream)`` (one rank
    per process), its flag buffers, its symmetric buffers (``slots`` per set)
    and its error word."""

    def __init__(self, name: str, n_variant_flags: int, raises=two_per_part, slots: int = 1):
        lib = _build.load(name)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.name = name
        self._fn_rank = getattr(lib, f"{name}_rank")
        self._fn_rank.argtypes = [i, i, vp, vp, vp, ll, i, *[i] * n_variant_flags, i, i, vp]
        self._fn_rank.restype = i
        self.flags = None
        if hasattr(lib, name):
            self._fn = getattr(lib, name)
            self._fn.argtypes = [vp, vp, i, ll, i, *[i] * n_variant_flags, vp, i, i, vp]
            self._fn.restype = i
            flag_ints = getattr(lib, f"{name}_flag_ints")
            flag_ints.argtypes, flag_ints.restype = [i, i], ll
            self.flags = FlagBuffers(flag_ints, raises)
        rank_flag_ints = getattr(lib, f"{name}_rank_flag_ints")
        rank_flag_ints.argtypes, rank_flag_ints.restype = [i, i], ll
        self.symmetric = _SYMMETRIC[name] = SymmetricBuffers(rank_flag_ints, raises, slots)
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
            if self.flags is not None:
                self.flags.clear()
            raise RuntimeError(describe(self.name, code))

    def check_ranks(self, ranks) -> None:
        """Collective check of the per-rank path: synchronise, and if a wait
        of any rank ran out, drop every rank's symmetric buffers of this
        library and raise on every rank (the rank whose wait failed says
        which wait)."""
        torch.cuda.synchronize(ranks.device)
        code = self._error.value
        codes = ranks.all_gather_object(code)
        if not any(codes):
            return
        self._error.value = 0
        self.symmetric.release(ranks)
        if code:
            raise RuntimeError(describe(self.name, code))
        failed = [r for r, c in enumerate(codes) if c]
        raise RuntimeError(f"{self.name}: a wait of rank(s) {failed} failed; the "
                           f"collective's output is not valid")

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

    def launch_rank(self, x: torch.Tensor, ranks, out: torch.Tensor, chunk_bytes: int,
                    parts: int, variant_flags: tuple[int, ...], layout: int,
                    sym_bytes: int | None = None) -> None:
        """This rank's launch (``parts`` CTAs, the same on every rank) on the
        current stream into its slot of the symmetric output, then the copy
        of that output's first bytes into ``out`` (contiguous, as is ``x``),
        on the same stream.  The symmetric output holds ``sym_bytes`` (``out``'s
        bytes unless more are asked for: the kernel's scratch past them).
        Every rank of ``ranks`` must make the same call.  Raises if the launch
        is refused."""
        n, dev = ranks.n, x.device.index
        stream = torch._C._cuda_getCurrentRawStream(dev)
        out_bytes = out.numel() * out.element_size()
        sym, slot, epoch = self.symmetric.take(ranks, sym_bytes or out_bytes, parts, layout,
                                               stream)
        flags, outs = sym.slot(slot)
        table = ctypes.c_void_p * n
        err = self._fn_rank(ranks.rank, n, x.data_ptr(), table(*outs), table(*flags),
                            chunk_bytes, parts, *variant_flags, epoch, dev, stream)
        if err:
            sym.calls -= 1          # refused on every rank alike: no epoch was used
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        ipc().copy(out.data_ptr(), outs[ranks.rank], out_bytes, dev, stream)


def too_many_ctas(name: str, n: int, parts: int | None) -> RuntimeError:
    return RuntimeError(f"{name} launch failed: {n} ranks x {parts or 'auto'} CTAs "
                        f"cannot all be resident (cooperative launch too large)")
