"""Collective traffic of a traced step, per device.

Counterpart of ``repro.roofline.hlo_parse``.  Torch emits no HLO text, so
instead of parsing the partitioned module this module records, as a
``TorchDispatchMode``, every functional collective that DTensor issues on
its local shards while a step runs.  Shapes of local shards are per-device,
so the byte counts are per device too.  Kinds and wire bytes per op are the
reference's (ring-algorithm accounting):

  all-gather        : out - in            (receives (n-1)/n of the result)
  reduce-scatter    : in - out
  all-reduce        : 2 * out             (ring RS + AG, upper bound)
  all-to-all        : out * (n-1)/n ~ out
  collective-permute: out

The recorder returns ``NotImplemented`` for an op on DTensors, so DTensor
handles it and the recorder sees the local ops (collectives included) that
DTensor runs for it.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# torch's functional collectives -> the reference's kind names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # DTensor's Shard(i) -> Shard(j)
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    out_bytes: int
    in_bytes: int

    @property
    def wire_bytes(self) -> float:
        if self.kind == "all-gather":
            return max(self.out_bytes - self.in_bytes, 0)
        if self.kind == "reduce-scatter":
            return max(self.in_bytes - self.out_bytes, 0)
        if self.kind == "all-reduce":
            return 2.0 * self.out_bytes
        if self.kind == "all-to-all":
            return float(self.out_bytes)
        return float(self.out_bytes)   # collective-permute


def tensor_bytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or a list or tuple of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


def on_dtensors(types) -> bool:
    return any(issubclass(t, DTensor) for t in types)


class CollectiveRecorder(TorchDispatchMode):
    """Records each functional collective run on local tensors as a
    ``CollectiveOp`` (``self.ops``), with its per-device output and input
    bytes."""

    def __init__(self):
        super().__init__()
        self.ops: list[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                self.ops.append(CollectiveOp(kind, tensor_bytes(out), tensor_bytes(args[0])))
        return out


def wire_bytes_by_kind(ops: list[CollectiveOp]) -> dict[str, float]:
    acc: dict[str, float] = {}
    for op in ops:
        acc[op.kind] = acc.get(op.kind, 0.0) + op.wire_bytes
    return acc


def total_wire_bytes(ops: list[CollectiveOp]) -> float:
    return sum(wire_bytes_by_kind(ops).values())


def collective_counts(ops: list[CollectiveOp]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for op in ops:
        counts[op.kind] = counts.get(op.kind, 0) + 1
    return counts
