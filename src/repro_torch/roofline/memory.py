"""Per-device memory of a traced step.

Counterpart of XLA's ``compiled.memory_analysis()`` (what the reference's
dry-run reads to answer "fits?"), as ``wire`` is of ``hlo_parse``.  The
step is traced by the dry-run (``launch.dryrun.trace_step``) on fake
tensors, so nothing is allocated; ``LiveMemoryMode``, a
``TorchDispatchMode`` beside ``costing.LocalCostMode``, sees every local
aten op of the trace and keeps the bytes a device would hold:

* each op's output storage (``Tensor.untyped_storage()``) is recorded once,
  when it first appears, at its ``nbytes``; a view or an in-place op
  returns a storage already recorded and allocates nothing;
* a storage is freed when a weak reference to it expires, which is when
  its last tensor dies: a Python temporary, a tensor autograd saved and
  frees with its graph, a checkpoint's recomputed tensor;
* a storage marked ``keep`` (a redistribution the dry-run keeps for reuse,
  one collective per operand and layout as XLA's CSE leaves it) is freed
  just after the last op that reads it, as XLA frees a buffer after its
  last use, however long the memo that keeps it lives;
* only LOCAL storages count: the mode returns ``NotImplemented`` for an op
  on DTensors, so DTensor runs it and the mode sees the ops on this rank's
  shards (torch's ``MemTracker`` sizes a DTensor at its global shape), and
  DTensor's runs of an op on global-shaped tensors for its sharding
  propagation are skipped, as are tensors on the ``meta`` device (the
  global-shaped metadata DTensor makes for a layout; they hold no data
  anywhere).  A collective's output is sized as its own tensor: a fake
  implementation may return a view of a larger buffer (DTensor's
  all-to-all returns one rank's chunk of the whole gathered tensor).

The result, per device and in XLA's order (``MemoryAnalysis``):

* argument: the bytes of the local shards of the step's inputs;
* output: the bytes of the local shards of what the step returns, each
  output counted whole, as XLA gives each its own buffer;
* alias: the bytes of outputs that ARE argument buffers (an input updated
  in place and returned, as decode's KV cache); XLA aliases only donated
  buffers, and the reference donates none, so its alias is 0;
* temp: XLA's ``temp_size_in_bytes``, the peak over the step of the live
  bytes of storages that are neither arguments nor outputs.

A device running the step eagerly holds at most argument + output - alias
+ temp bytes at once (outputs counted from their first byte on).

``mark`` / ``roll_back`` drop what a refused attempt of the dry-run's
``_Reshard`` allocated and read: it never runs on a device.  An op output whose
storage cannot be sized (a sparse or nested tensor) raises: no partial
peak is reported.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .costing import in_sharding_propagation
from .wire import on_dtensors, tensor_bytes


@dataclasses.dataclass
class MemoryAnalysis:
    """Per-device bytes of one step, as XLA's ``CompiledMemoryStats``."""
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0
    live_peak_bytes: int = 0     # arguments + the peak of all else live

    @property
    def total_bytes(self) -> int:
        """What the device holds at most: arguments, outputs not aliasing
        an argument, and the temp peak."""
        return self.argument_bytes + self.output_bytes - self.alias_bytes + self.temp_bytes

    def __str__(self) -> str:
        return (f"argument_size_in_bytes={self.argument_bytes}, "
                f"output_size_in_bytes={self.output_bytes}, "
                f"alias_size_in_bytes={self.alias_bytes}, "
                f"temp_size_in_bytes={self.temp_bytes}")


# a collective writes a buffer of its output's shape; a fake implementation
# may return a view of a larger one (DTensor's all-to-all: a chunk of the
# whole gathered tensor)
_COLLECTIVES = ("_c10d_functional", "_dtensor", "c10d")


def local_tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, a DTensor by its local shard."""
    from torch.distributed.tensor import DTensor
    return [x._local_tensor if isinstance(x, DTensor) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class LiveMemoryMode(TorchDispatchMode):
    """Live bytes of the local storages of a traced step (module
    docstring).  Call ``hold_arguments`` with the step's inputs before it
    runs and ``analysis`` with its outputs after."""

    def __init__(self):
        super().__init__()
        self._serial = 0
        self._serial_of: dict[int, int] = {}     # id(storage) -> serial, while alive
        self._alive: dict[int, int] = {}         # serial -> bytes, counted storages
        self._sizes: dict[int, int] = {}         # serial -> the storage's nbytes
        self._refs: dict[int, weakref.ref] = {}  # serial -> weak ref to its storage
        self._order: list[int] = []              # serials, in the order recorded
        self.events: list[tuple[int, int]] = []  # (serial, +bytes allocated / -bytes freed)
        self._arguments: set[int] = set()
        self._argument_bytes = 0
        self._kept: dict[int, int] = {}          # id(storage) -> serial, kept and alive
        self._last_read: dict[int, int] = {}     # kept serial -> len(events) after its last reader
        self._reads: list[tuple[int, int]] = []  # (serial, the last read it replaced), to roll back

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not in_sharding_propagation():
            own = func.namespace in _COLLECTIVES
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.device.type != "meta":
                    self._record(t, func, tensor_bytes(t) if own else None)
            if self._kept:
                self._read((args, kwargs))
        return out

    def keep(self, t: torch.Tensor, since: int) -> None:
        """Free ``t``'s storage just after its last reader, not when it
        dies, if it was recorded after serial ``since`` (``mark()[1]``): a
        buffer made for a result kept for reuse, not a view of an older one."""
        key = id(t.untyped_storage())
        serial = self._serial_of.get(key)
        if serial is not None and serial > since and serial in self._alive:
            self._kept[key] = serial
            self._reads.append((serial, self._last_read.get(serial, -1)))
            self._last_read[serial] = len(self.events)

    def _read(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                serial = self._kept.get(id(t.untyped_storage()))
                if serial is not None:
                    self._reads.append((serial, self._last_read[serial]))
                    self._last_read[serial] = len(self.events)

    def _record(self, t: torch.Tensor, func=None, nbytes: int | None = None) -> int:
        """The serial of ``t``'s storage, recorded now at its ``nbytes``
        (or ``nbytes``) if it is new.  A storage resized in place raises:
        its first size would be a partial count."""
        try:
            st = t.untyped_storage()
            size = st.nbytes()
        except (RuntimeError, NotImplementedError) as e:
            raise RuntimeError(f"memory: cannot size the output of {func} "
                               f"({type(t).__name__}, layout {t.layout})") from e
        key = id(st)
        serial = self._serial_of.get(key)
        if serial is not None:
            if serial in self._alive and self._sizes[serial] != size:
                raise RuntimeError(f"memory: {func} resized a storage in place "
                                   f"({self._sizes[serial]} -> {size} B)")
            return serial
        nbytes = size if nbytes is None else nbytes
        self._serial += 1
        serial = self._serial
        self._serial_of[key] = serial
        self._alive[serial] = nbytes
        self._sizes[serial] = size
        self._refs[serial] = weakref.ref(st, functools.partial(self._freed, key, serial))
        self._order.append(serial)
        self.events.append((serial, nbytes))
        return serial

    def _freed(self, key: int, serial: int, _ref) -> None:
        self._refs.pop(serial, None)
        self._sizes.pop(serial, None)
        if self._serial_of.get(key) == serial:
            del self._serial_of[key]
        if self._kept.get(key) == serial:
            del self._kept[key]
        nbytes = self._alive.pop(serial, None)
        if nbytes is not None:
            self.events.append((serial, -nbytes))

    def mark(self) -> tuple[int, int, int]:
        return len(self.events), self._serial, len(self._reads)

    def roll_back(self, mark: tuple[int, int, int]) -> None:
        """Forget what was allocated and read since ``mark``, as if it never
        was: its events go and its storages, while they live, count for
        nothing (a later op that returns one records it anew); a kept
        storage's last reader is the one before ``mark`` again.  Frees since
        ``mark`` of storages recorded before it stay."""
        n, serial, reads = mark
        for s, before in reversed(self._reads[reads:]):
            if before < 0:
                self._last_read.pop(s, None)
            else:
                self._last_read[s] = before
        del self._reads[reads:]
        kept = [e for e in self.events[n:] if e[0] <= serial]
        del self.events[n:]
        self.events.extend(kept)
        while self._order and self._order[-1] > serial:
            s = self._order.pop()
            self._alive.pop(s, None)
            ref = self._refs.get(s)
            st = ref() if ref is not None else None
            if st is not None and self._serial_of.get(id(st)) == s:
                del self._serial_of[id(st)]
            if st is not None and self._kept.get(id(st)) == s:
                del self._kept[id(st)]

    def hold_arguments(self, tree) -> None:
        """Record the storages of the step's inputs as its arguments."""
        tensors = local_tensors(tree)
        self._arguments |= {self._record(t) for t in tensors}
        self._argument_bytes += sum(tensor_bytes(t) for t in tensors)

    def analysis(self, outputs) -> MemoryAnalysis:
        """The step's ``MemoryAnalysis``, given what it returned (its local
        tensors must still be alive)."""
        outs = local_tensors(outputs)
        serials = [self._record(t) for t in outs]
        events = self.timeline()
        return MemoryAnalysis(
            self._argument_bytes, sum(tensor_bytes(t) for t in outs),
            sum(tensor_bytes(t) for t, s in zip(outs, serials) if s in self._arguments),
            _peak(events, set(serials) | self._arguments),
            self._argument_bytes + _peak(events, self._arguments))

    def timeline(self) -> list[tuple[int, int]]:
        """``events`` with each kept storage's free moved to just after its
        last reader (a kept storage still alive is freed there too)."""
        if not self._last_read:
            return self.events
        frees: dict[int, list[int]] = {}
        for s, n in self._last_read.items():
            frees.setdefault(n, []).append(s)
        out, size = [], {}
        for i, (serial, delta) in enumerate(self.events):
            out.extend((s, -size.pop(s)) for s in frees.get(i, ()) if s in size)
            if serial not in self._last_read:
                out.append((serial, delta))
            elif delta > 0:
                size[serial] = delta
                out.append((serial, delta))
        out.extend((s, -size.pop(s)) for s in frees.get(len(self.events), ()) if s in size)
        return out


def _peak(events: list[tuple[int, int]], exclude: set[int]) -> int:
    """The peak over ``events`` of the live bytes of the storages not in
    ``exclude``."""
    live = peak = 0
    for serial, delta in events:
        if serial not in exclude:
            live += delta
            peak = max(peak, live)
    return peak
