"""Multi-pod dry-run: prove the distribution config is coherent.

Counterpart of ``repro.launch.dryrun``.  For an (architecture x input shape)
on a production mesh (single-pod 16x16 = 256 ranks; multi-pod 2x16x16 =
512), the step (train step / prefill / decode step) runs once on fake
tensors under ``FakeTensorMode``: params, optimizer state, batch and caches
are DTensors laid out by ``sharding.rules`` over a mesh of torch's
``"fake"`` process group, and the models' ``ac`` hook redistributes
activations where the reference constrains them.  Nothing is allocated and
no collective moves data.  The result records per-device FLOPs and bytes
(``roofline.costing.LocalCostMode``), the collectives DTensor issued, by the
reference's kind names (``roofline.wire``), and the per-device memory
(``roofline.memory.LiveMemoryMode``): the bytes of the arguments' and the
outputs' local shards, the outputs that alias an argument, and the temp
peak (``peak_bytes_per_device``, XLA's ``temp_size_in_bytes``), with
whether argument + output - alias + temp fit one H100's 80 GB.

DTensor is not GSPMD: it lays out each op on its own, eagerly.  Where the
two differ most, the dry-run does what GSPMD does, so that its counts can
be held against the reference's (``tests/test_torch_roofline.py``, on a
(2, 4) mesh: train and prefill FLOPs within 3%, wire bytes within 4x, no
op run replicated):

* ``_Reshard`` reshards where DTensor refuses an op as laid out or plans
  it unlike GSPMD.  A reshape to 3-D (a bmm's operand) that merges dims
  sharded over different mesh dims, or one that splits a sharded dim, is
  relabelled where the local shard can stay as it is
  (``_relabelled_view``) rather than gathered; one that would split a
  sharded dim unevenly, or merge into a 2-D strided shard, gathers the
  blocking mesh dims.  A gather, a
  logsumexp and a softmax along a sharded dim (the loss over a vocab split
  over 'model', decode's scores over a cache split on its capacity) pick
  and reduce per shard and all-reduce the small result, where DTensor
  gathers the input.  The MoE dispatch's advanced indexing (``_index``,
  ``_index_put``: the capacity buffer's scatter, the combine's gather, their
  gradients) is partitioned as GSPMD partitions gathers and scatters, and
  ``searchsorted`` reads the sorted sequence gathered, as GSPMD's sort
  leaves it.  A row picked from a sharded dim (``_select_row``: decode's
  ``cache[:, slot] = row``) stays on the shard that holds it, as XLA's
  DynamicUpdateSlice does.  A matmul whose plan leaves a Partial sum
  GSPMD avoids gathers the keys, or reduce-scatters the Partial operand
  (``_Reshard._matmul``).
  Where torch 2.11's and 2.13's DTensor plan an op differently (C-port8,
  found op by op with ``tools/dryrun_plans.py``), the op is decided here,
  the same way on both: an embedding lookup by sharded tokens moves the
  table's vocab split onto its width first (``_lookup``); a copy of a
  Partial sum (the reshape before the output projection) reduce-scatters
  it (``_copy_layout``); a pointwise op with a Partial input, or with
  two inputs split apart, takes one rule (``_pointwise_layout``: a
  product of two Partial sums keeps the larger one's, the MoE combine's
  outputs by their mask; ``_per_tensor`` for the optimizer's
  ``_foreach_*`` ops); softmax, its backward and logsumexp
  all-reduce their max and sums; top-k's backward scatters per shard
  (``_scatter``); ``_foreach_norm`` (the card's gradient norm) reduces
  each leaf as the CPU's per-leaf sum is traced (``_norms``).  A strided
  input of a pointwise op keeps DTensor's plan, a Partial one
  reduce-scattered where DTensor all-reduces it (``_scatter_targets``).
  Any other op DTensor cannot shard runs on replicated inputs, counted in
  ``replicated_ops``.  What a refused attempt recorded is dropped.
* ``_rows_kept_matmuls``: a matmul of x [B, S, D] by w with the sequence
  of x split over mesh dims that w is not split over keeps the rows where
  they are (XLA's dot_general), where torch's fold into 2-D gathers them:
  qwen2-0.5b's 14 heads do not divide 'model', its projections are not
  split over it, and its attention splits over the query positions, as
  GSPMD's does.  It patches the spellings ``@``, ``matmul`` and
  ``F.linear``; an ``einsum`` would go around it.
* ``_ReusedRedistributions``: one collective per operand and layout, as
  XLA's common-subexpression elimination leaves it.
* ``_all_to_all_on_cpu_meshes``: a CPU mesh traces the all-to-all a CUDA
  mesh would, not the whole-dim gather gloo makes do with.
* ``_ShardedGather``: the gradient of a gather along a split dim (the
  loss's pick of the label's logit) is scattered per shard into zeros of
  the input's own shard, where autograd's backward makes the zeros at the
  input's global shape on every rank.
* Attention runs in query chunks as the model runs it
  (``_own_query_chunks``), with the plan of one unchunked block: queries
  split over the sequence are chunked by each rank on its own, and
  otherwise the chunks are concatenated in one block's memory layout, so
  a Partial sum of the output (8 KV heads on a 'model' of 16) is
  reduce-scattered before the output projection as one block's is.  One
  trace gives the costs, the collectives and the memory
  (``trace_dryrun``; ``tests/test_torch_query_chunks.py`` holds it
  against the reference on (1, 16) and against unchunked on 16x16).

Memory (``trace_memory``): a redistribution kept for reuse is freed
just after the last op that reads it, as XLA frees the one buffer its CSE
leaves after its last use (the memo keeps it as long as its source
lives); what a refused attempt allocated or read is forgotten; a time
scan cut to n steps is traced at two lengths and its temp extrapolated
to every step.
Eager ops allocate what XLA would fuse (the float32 casts of the loss), so
the temp is an upper bound on a fused program's.

Known gaps (PERF.md): the two partitioners still pick different
collectives (DTensor reduce-scatters and all-to-alls where GSPMD
all-reduces and gathers), so counts differ while wire bytes agree within
4x.  The embedding lookup keeps torch 2.13's plan, not GSPMD's (which
moves no table but takes decode's wire out of that band, ``_lookup``).
Torch 2.11 and 2.13 give the same plan op by op for the pairs
``tools/dryrun_plans.py`` records; an op those pairs do not run may still
take DTensor's plan of its torch.

The rwkv6 / zamba2 time loops launch ~7 ops per step and layer; the dry-run
traces their first ``time_steps`` steps (``traced_time_steps``, recorded in
``time_steps_traced``) and zeros stand in for the rest; the memory's two
lengths are three and four scan chunks (``memory_time_steps``).

Usage (on the card unless ``--device cpu``; fake tensors of that device's
type either way):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import itertools
import json
import math
import os
import time
import traceback
import weakref
from unittest import mock

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_map_only

from repro_torch.compat import resolve_device
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import attention, build_model, mamba2, rwkv6
from repro_torch.models.transformer import identity_ac
from repro_torch.roofline.costing import LocalCostMode, _marking_sharding_propagation
from repro_torch.roofline.memory import LiveMemoryMode, MemoryAnalysis
from repro_torch.roofline.wire import (CollectiveRecorder, collective_counts, on_dtensors,
                                       tensor_bytes, wire_bytes_by_kind)
from repro_torch.sharding.rules import (PerfOptions, ShardingRules, batch_specs, cache_specs,
                                        infer_param_specs, make_activation_constrainer,
                                        to_placements)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.tree import tree_leaves, tree_map
from .input_specs import input_specs, skip_reason
from .mesh import (dp_axes, fake_world, make_mesh, make_production_mesh, mesh_name,
                   production_mesh_shape)


@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    status: str                      # ok | skipped | failed
    reason: str = ""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_counts: dict | None = None
    memory_analysis: str = ""
    peak_bytes_per_device: float | None = None
    argument_bytes_per_device: float | None = None
    compile_seconds: float = 0.0     # the trace's wall seconds
    time_steps_traced: int | None = None
    replicated_ops: dict | None = None
    wire_bytes_per_device: dict | None = None    # by collective kind

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Traced:
    """What one traced step measured (per device)."""
    skip_reason: str | None = None
    flops: float = 0.0
    bytes: float = 0.0
    wire: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    n_ops: int = 0
    time_steps_traced: int | None = None
    replicated_ops: dict = dataclasses.field(default_factory=dict)
    memory: MemoryAnalysis = dataclasses.field(default_factory=MemoryAnalysis)


def _local_shape(shape, placements, mesh) -> tuple:
    """Rank 0's shard shape (torch.chunk's first chunk on each split)."""
    out = list(shape)
    for n, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            out[p.dim] = math.ceil(out[p.dim] / n)
    return tuple(out)


def _distribute(t: torch.Tensor, spec: tuple, mesh) -> DTensor:
    placements = to_placements(spec, mesh)
    local = t.new_empty(_local_shape(t.shape, placements, mesh))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _replicated(x: DTensor) -> DTensor:
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _rows_of(size: int, placements, mesh, dim: int) -> tuple[int, int]:
    """(start, length) of the rows of a tensor dim of ``size`` on this rank,
    sharded by ``placements`` (torch.chunk's split on each mesh dim)."""
    start, n = 0, size
    for i, (p, c) in enumerate(zip(placements, mesh.get_coordinate())):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = math.ceil(n / mesh.size(i))
            start, n = start + c * chunk, max(0, min(chunk, n - c * chunk))
    return start, n


def _sharding_failure(e: Exception) -> bool:
    msg = str(e)
    return ("Sharding propagation failed" in msg or "sharding strategy" in msg
            or "unevenly sharded" in msg)


def _strided(x) -> bool:
    """Whether DTensor laid ``x`` out with a strided shard (a reshape merged
    a sharded dim into an outer one), which most ops cannot take."""
    return isinstance(x, DTensor) and any(type(p).__name__ == "_StridedShard"
                                          for p in x.placements)


_VIEWS = ("view", "_unsafe_view", "reshape")


def _n_sharded(x: DTensor) -> int:
    return sum(isinstance(p, Shard) and x.device_mesh.size(i) > 1
               for i, p in enumerate(x.placements))


def _view_groups(src, dst) -> list[tuple[list[int], list[int]]] | None:
    """The dims of a view from ``src`` to ``dst``, in groups whose sizes
    multiply to the same number: ([src dims], [dst dims]) each."""
    groups, j = [], 0
    i = 0
    while i < len(src):
        ins, outs, pa, pb = [i], [], src[i], 1
        i += 1
        while pb != pa or (not outs and j < len(dst) and dst[j] == 1 and pa == 1):
            if pb < pa and j < len(dst):
                outs.append(j)
                pb *= dst[j]
                j += 1
            elif pb > pa and i < len(src):
                ins.append(i)
                pa *= src[i]
                i += 1
            else:
                return None
        groups.append((ins, outs))
    if groups:
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def _dense(mesh, shape, placements, local: torch.Tensor) -> DTensor:
    """A DTensor of global ``shape`` whose local shard is ``local``, its
    dims in the order of ``local``'s strides (contiguous where ``local``
    is; an elementwise op's output keeps its inputs' memory order, and a
    view of it must too)."""
    order = sorted(range(local.ndim), key=lambda d: (-local.stride(d), d))
    stride, step = [0] * local.ndim, 1
    for d in reversed(order):
        stride[d], step = step, step * shape[d]
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def _relabelled_view(x: DTensor, shape) -> DTensor | None:
    """``x`` viewed as ``shape`` with each shard moved to the dim of the
    view that its dim becomes, so the local shard stays the same, its rows
    in another order and no per-device size changing: a split keeps the
    shard on the outermost dim of the split (not the tensor's last) whose
    share holds the same rows; a merge into a 3-D view (a bmm's operand)
    shards the merged dim over the mesh dims that sharded its parts.  XLA's
    dot_general keeps several batch dims (batch x heads) and splits
    [batch * kv, groups * queries] back into (groups, queries) with the
    queries still sharded; DTensor merges or splits, then gathers (or lays
    out a strided shard most ops cannot take).  None where no such layout
    exists, or for a merge into fewer or more than 3 dims (a matmul's 2-D
    fold: ``_rows_kept_matmul``)."""
    mesh, shape = x.device_mesh, tuple(int(s) for s in shape)
    groups = _view_groups(tuple(x.shape), shape)
    if groups is None or math.prod(shape) != x.numel():
        return None
    options = []
    for i, p in enumerate(x.placements):
        if not isinstance(p, Shard) or mesh.size(i) == 1:
            options.append([Replicate() if isinstance(p, Shard) else p])
            continue
        ins, outs = next(g for g in groups if p.dim in g[0])
        if len(ins) == 1 and len(outs) >= 2:            # a split
            options.append([Shard(d) for d in outs if d != len(shape) - 1 and shape[d] > 1])
        elif len(outs) == 1 and len(shape) == 3:         # a merge into a bmm operand
            options.append([Shard(outs[0])])
        elif len(ins) == 1 and len(outs) == 1:
            options.append([Shard(outs[0])])
        else:
            return None
    local = tuple(x.to_local().shape)
    for placements in itertools.product(*options):
        got = _local_shape(shape, placements, mesh)
        if all(math.prod(local[d] for d in ins) == math.prod(got[d] for d in outs)
               for ins, outs in groups):
            return _dense(mesh, shape, placements, x.to_local().reshape(got))
    return None


def _made_anywhere_op(func) -> bool:
    """Whether ``func`` keeps a tensor made anywhere so (``_MadeAnywhere``):
    an elementwise op, a cast or a concatenation (a view shares its
    input's storage, so it is made anywhere too)."""
    return (torch.Tag.pointwise in func.tags
            or func in (torch.ops.aten._to_copy.default, torch.ops.aten.cat.default))


class _MadeAnywhere:
    """The local storages of the rotary tables: tensors made from the
    positions the model makes itself (an iota, laid out by ``ac(positions,
    "positions")``) and from tensors every rank holds alike (plain ones),
    by elementwise ops, casts and concatenations (``_made_anywhere_op``),
    and their views.  XLA fuses such a chain into each reader (the
    reference's HLO makes its cosines once per reader, each in that
    reader's layout), so where a reader wants another layout the tensor is
    made there: ``_ReusedRedistributions`` gives a buffer of the target's
    local shape and records no collective.  Torch would gather it (the
    backward's product of a gradient split otherwise than the table)."""

    def __init__(self):
        self._refs: dict[int, weakref.ref] = {}     # id(storage) -> weak ref to it

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)

        def dead(ref, key=key):
            if self._refs.get(key) is ref:
                del self._refs[key]

        self._refs[key] = weakref.ref(st, dead)

    def __contains__(self, t: torch.Tensor) -> bool:
        st = t.untyped_storage()
        ref = self._refs.get(id(st))
        return ref is not None and ref() is st

    def __bool__(self) -> bool:
        return bool(self._refs)


def _positions_laid_out(ac, mesh):
    """``ac``, for the duration of a trace (an active ``_Reshard``), laying
    out the rotary positions the model makes (a plain tensor given to
    ``ac(positions, "positions")``) as a replica on every rank, which
    ``ac`` cuts to each rank's shard, and adding them to the trace's
    ``_MadeAnywhere``.  Positions given in the batch are data, laid out
    as they are."""
    def laid_out(x, kind):
        reshard = None
        if kind == "positions" and not isinstance(x, DTensor):
            reshard = next((m for m in _get_current_dispatch_mode_stack()
                            if isinstance(m, _Reshard)), None)
        if reshard is None:
            return ac(x, kind)
        out = ac(DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False), kind)
        reshard.anywhere.add(out.to_local())
        return out
    return laid_out


class _ReusedRedistributions:
    """For the duration, DTensor redistributes a local tensor from one
    layout to another once and reuses the result: eager DTensor
    redistributes an input again at each consumer (a pending reduction of a
    gradient, the gather of an activation three projections read), where
    XLA's common-subexpression elimination keeps one collective per operand
    and layout (an operand written in place since is another operand).
    A result is kept while its source lives (no later call can name a dead
    source), but XLA frees a buffer after its last use: the trace's memory
    (``mem``, which ``_Reshard`` sets to its own) frees a result's buffer
    just after the last op that reads it, a hit's reader included
    (``LiveMemoryMode.keep``).  A redistribution that moves nothing (a mesh
    dim of one rank) returns its input and is not kept; one of a tensor
    made anywhere (``anywhere``, ``_Reshard``'s) is made in the target's
    layout, moving nothing.  ``mark`` / ``roll_back`` drop what a refused
    attempt added."""

    _MODULES = ("_dispatch", "_redistribute", "_api")

    def __init__(self):
        self.mem = LiveMemoryMode()
        self.anywhere = _MadeAnywhere()
        self.memo: dict = {}
        self.added: list = []       # (memo key, source placements, target placements)

    def mark(self) -> int:
        return len(self.added)

    def _dead(self, key, ref) -> None:
        if self.memo.get(key, (None,))[0] is ref:
            del self.memo[key]

    def roll_back(self, mark: int) -> None:
        for key, _, _ in self.added[mark:]:
            self.memo.pop(key, None)
        del self.added[mark:]

    def all_reduced(self, local: torch.Tensor, mark: int) -> bool:
        """Whether the local shard ``local`` (alive since ``mark``) was
        redistributed from a Partial sum to a replica on some mesh dim since
        ``mark``: an all-reduce of that very tensor."""
        return any(key[0] == id(local) and any(p.is_partial() and q.is_replicate()
                                               for p, q in zip(src, dst))
                   for key, src, dst in self.added[mark:])

    @contextlib.contextmanager
    def patched(self):
        modules = []
        for name in self._MODULES:
            with contextlib.suppress(ImportError):
                modules.append(importlib.import_module(f"torch.distributed.tensor.{name}"))
        original = importlib.import_module(
            "torch.distributed.tensor._redistribute").redistribute_local_tensor

        def reused(local_tensor, current_spec, target_spec, *args, **kwargs):
            key = (id(local_tensor), local_tensor._version, tuple(current_spec.shape),
                   str(current_spec.placements), str(target_spec.placements))
            hit = self.memo.get(key)
            if hit is not None and hit[0]() is local_tensor:
                return hit[1]
            since = self.mem.mark()[1]
            if local_tensor in self.anywhere:   # made where it is read, moving nothing
                out = local_tensor.new_empty(_local_shape(target_spec.shape,
                                                          target_spec.placements,
                                                          target_spec.mesh))
                self.anywhere.add(out)
            else:
                out = original(local_tensor, current_spec, target_spec, *args, **kwargs)
            if out is local_tensor:     # nothing moved (a mesh dim of size 1)
                return out
            self.mem.keep(out, since)
            # the entry goes with its source, which no later call can name
            self.memo[key] = (weakref.ref(local_tensor, functools.partial(self._dead, key)), out)
            self.added.append((key, tuple(current_spec.placements),
                               tuple(target_spec.placements)))
            return out

        with contextlib.ExitStack() as stack:
            for m in modules:
                if getattr(m, "redistribute_local_tensor", None) is original:
                    stack.enter_context(mock.patch.object(m, "redistribute_local_tensor", reused))
            yield self


def _split_dims(x: DTensor) -> set[int]:
    """The tensor dims of ``x`` split over a mesh dim of more than one rank."""
    return {p.dim for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and x.device_mesh.size(i) > 1}


def _reduces_sharded(x, dims) -> bool:
    """Whether a reduction of DTensor ``x`` over ``dims`` reduces a split dim."""
    dims = {d % x.ndim for d in ([dims] if isinstance(dims, int) else dims)}
    return isinstance(x, DTensor) and bool(dims & _split_dims(x))


def _all_reduced(x: DTensor) -> DTensor:
    """``x`` with each Partial sum (or max) all-reduced, the rest as it is."""
    return _to(x, [Replicate() if p.is_partial() else p for p in x.placements])


def _logsumexp(x: DTensor, dims, keepdim: bool = False) -> DTensor:
    """logsumexp over a sharded dim, as GSPMD partitions it: a max and a
    sum of exponentials per shard, each all-reduced (DTensor's own strategy
    gathers the whole input first; torch 2.13's reduce-scatters the sum)."""
    m = _all_reduced(x.amax(dims, keepdim=True))
    out = _all_reduced((x - m).exp().sum(dims, keepdim=True)).log() + m
    if not keepdim:     # one dim at a time: torch 2.11's DTensor has no squeeze.dims
        for d in sorted((d % x.ndim for d in dims), reverse=True):
            out = out.squeeze(d)
    return out


def _softmax(x: DTensor, dim: int, half_to_float: bool = False) -> DTensor:
    """softmax over a sharded dim, as GSPMD partitions it: the max and the
    sum of exponentials all-reduced, the output sharded as ``x`` (DTensor
    gathers the input first)."""
    e = (x - _all_reduced(x.amax(dim, keepdim=True))).exp()
    return e / _all_reduced(e.sum(dim, keepdim=True))


def _softmax_backward(grad: DTensor, out: DTensor, dim: int, input_dtype) -> DTensor:
    """softmax's backward, ``out * (grad - sum(grad * out, dim))``, on the
    shards of the gradient's layout (the softmax output moved to it; a
    Partial gradient all-reduced), the sum over a split ``dim`` a Partial
    sum all-reduced.  Torch 2.11's DTensor gathers the scores of attention
    split over its queries, and 2.11 and 2.13 move different operands."""
    mesh, dim = grad.device_mesh, dim % grad.ndim
    target = [Replicate() if p.is_partial() else p for p in grad.placements]
    g, o = _to(grad, target).to_local(), _to(_as_dtensor(out, mesh), target).to_local()
    summed = _dense(mesh, grad.shape[:dim] + (1,) + grad.shape[dim + 1:],
                    [Partial() if isinstance(p, Shard) and p.dim == dim else p for p in target],
                    (g * o).sum(dim, keepdim=True))
    return _dense(mesh, grad.shape, target,
                           (o * (g - _all_reduced(summed).to_local())).to(input_dtype))


def _scatter(func, x, dim: int, index, src=None, **kwargs) -> DTensor | None:
    """``x.scatter(dim, index, src)`` with ``index`` (and a tensor ``src``)
    split only along other dims than ``dim``, and ``x`` replicated or a
    local tensor (the zeros of top-k's backward), as GSPMD partitions the
    scatter: ``x`` cut to the index's shards, each scattered on its own.
    Torch 2.11 takes ``x`` as a local tensor and gathers the index and the
    source.  None for any other layout."""
    if not isinstance(index, DTensor):
        return None
    mesh, placements = index.device_mesh, list(index.placements)
    dim %= index.ndim
    x = _as_dtensor(x, mesh)
    tensors = [index] + ([src] if isinstance(src, torch.Tensor) else [])
    if any(p.is_partial() or isinstance(p, Shard) and p.dim == dim for p in placements) or \
            not all(p.is_replicate() for p in x.placements) or any(
                not isinstance(t, DTensor) or list(t.placements) != placements
                or t.shape[p.dim] != x.shape[p.dim]
                for t in tensors for p in placements if isinstance(p, Shard)):
        return None
    local = func(_to(x, placements).to_local(), dim, index.to_local(),
                 src.to_local() if isinstance(src, DTensor) else src, **kwargs)
    return _dense(mesh, x.shape, placements, local)


def _select_row(x: DTensor, dim: int, index: int) -> DTensor:
    """``x.select(dim, index)`` along a sharded dim, as XLA's DynamicSlice
    and DynamicUpdateSlice run it: the shard holding the row gives a view
    of it, the others zeros, and the row is a Partial sum over the mesh
    dims sharding ``dim``, so a read of it all-reduces one row and a write
    (decode's cache update, ``cache[:, slot] = row``) lands in the owner's
    shard and moves nothing (``_Reshard`` copies a written value into it
    whole).  DTensor gathers the whole dim first."""
    mesh = x.device_mesh
    index %= x.shape[dim]
    start, n = _rows_of(x.shape[dim], x.placements, mesh, dim)
    local = x.to_local()
    row = (local.select(dim, index - start) if start <= index < start + n
           else local.new_zeros(local.shape[:dim] + local.shape[dim + 1:]))
    placements = [Partial() if isinstance(p, Shard) and p.dim == dim else
                  Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) else p
                  for p in x.placements]
    return _dense(mesh, x.shape[:dim] + x.shape[dim + 1:], placements, row)


def _as_dtensor(t, mesh) -> DTensor:
    return t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _redistribute(x: DTensor, placements) -> DTensor:
    """``x.redistribute`` on the local shard, outside autograd: these
    handlers run below it, and torch 2.11's ``Redistribute`` function
    detaches its output in place where grad is off (a backward pass), which
    DTensor has no strategy for."""
    from torch.distributed.tensor import _redistribute as redistribution
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    target = DTensorSpec(x.device_mesh, tuple(placements), tensor_meta=x._spec.tensor_meta)
    local = redistribution.redistribute_local_tensor(x._local_tensor, x._spec, target)
    return DTensor.from_local(local, x.device_mesh, list(placements), run_check=False,
                              shape=x.shape, stride=x.stride())


def _to(x: DTensor, placements) -> DTensor:
    """``x.redistribute``, which also turns Replicate into a Partial sum
    (the value on the mesh dim's first rank, zeros on the others)."""
    placements, mesh = list(placements), x.device_mesh
    if list(x.placements) == placements:
        return x
    partial = [m for m, (p, q) in enumerate(zip(x.placements, placements))
               if p.is_replicate() and isinstance(q, Partial)]
    first = [Replicate() if m in partial else q for m, q in enumerate(placements)]
    y = x if list(x.placements) == first else _redistribute(x, first)
    if not partial:
        return y
    local = y.to_local()
    if any(mesh.get_coordinate()[m] != 0 for m in partial):
        local = torch.zeros_like(local)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=x.shape,
                              stride=x.stride())




def _index_layout(x: DTensor, indices) -> tuple | None:
    """The integer index tensors of an advanced index over the leading dims
    of ``x`` as DTensors of one shape and layout (a mesh dim they do not
    all share, or a Partial one, replicates), with that layout; None for
    any other kind of index."""
    if not indices or any(i is None for i in indices):
        return None
    mesh = x.device_mesh
    idx = [_as_dtensor(i, mesh) for i in indices]
    if idx[0].is_floating_point() or idx[0].dtype == torch.bool or \
            len({(tuple(i.shape), i.dtype) for i in idx}) != 1:
        return None
    layout = []
    for m in range(mesh.ndim):
        ps = {i.placements[m] for i in idx}
        p = ps.pop() if len(ps) == 1 else Replicate()
        layout.append(Replicate() if isinstance(p, Partial) else p)
    return [_to(i, layout) for i in idx], layout


def _local_rows(x: DTensor, idx: list) -> tuple[list, torch.Tensor | None]:
    """This rank's rows for each index (offset into its shard of an indexed
    dim split over the mesh, clamped) and where they fall in its shard
    (None where no indexed dim is split)."""
    rows, inside = [], None
    for d, i in enumerate(idx):
        r = i.to_local()
        if d in _split_dims(x):
            start, n = _rows_of(x.shape[d], x.placements, x.device_mesh, d)
            r = r - start
            here = (r >= 0) & (r < n)
            inside = here if inside is None else inside & here
            r = r.clamp(0, max(n - 1, 0))
        rows.append(r)
    return rows, inside


def _index(x: DTensor, indices) -> DTensor | None:
    """``x[i0, i1, ...]`` over the leading dims, as GSPMD partitions a
    gather: a dim split over a mesh dim is picked from per shard (zeros
    outside its rows) and the result is a Partial sum there; a trailing
    dim's shard carries over; an index's shard splits the result.  Where
    both are sharded over one mesh dim, the index is gathered."""
    got = _index_layout(x, indices)
    if got is None:
        return None
    idx, ipl = got
    k, nd = len(idx), idx[0].ndim
    out = []
    for m, p in enumerate(x.placements):
        if isinstance(p, (Shard, Partial)) and x.device_mesh.size(m) > 1:
            ipl[m] = Replicate()
            out.append(Partial() if isinstance(p, Shard) and p.dim < k else
                       Shard(p.dim - k + nd) if isinstance(p, Shard) else p)
        else:
            out.append(ipl[m])
    idx = [_to(i, ipl) for i in idx]
    rows, inside = _local_rows(x, idx)
    picked = x.to_local()[tuple(rows)]
    if inside is not None:
        inside = inside.reshape(inside.shape + (1,) * (picked.ndim - nd))
        picked = torch.where(inside, picked, torch.zeros_like(picked))
    return _dense(x.device_mesh, tuple(idx[0].shape) + tuple(x.shape[k:]), out, picked)


def _lookup(x: DTensor, indices) -> DTensor:
    """``x[i0, ...]`` by sharded indices (an embedding lookup of a table
    split over its vocab): each mesh dim splitting a looked-up dim moves
    that split onto the table's last dim (an all-to-all of the table's
    shard), then ``_index`` picks the rows, the indices gathered over the
    mesh dims that split the table's last dim.  This is torch 2.13's
    DTensor plan of the lookup, taken on every torch.  GSPMD's own plan
    (the reference's HLO on (2, 4): the tokens all-gathered over 'data',
    the picked rows all-reduced over 'model') moves no table, but traced
    here it takes decode's wire bytes out of the 4x band around the
    reference's (``tests/test_torch_roofline.py``), whose logits'
    all-reduce in float32 is most of its wire."""
    k = len(indices)
    if k >= x.ndim:         # no dim to move the split onto: partitioned as it is
        return _index(x, indices)
    moved = [Shard(x.ndim - 1) if isinstance(p, Shard) and p.dim < k and
             x.device_mesh.size(m) > 1 else p for m, p in enumerate(x.placements)]
    return _index(_to(x, moved), indices)


def _index_put(x: DTensor, indices, values, accumulate: bool = False,
               inplace: bool = False) -> DTensor | None:
    """``x[i0, i1, ...] = values`` (``+=`` with ``accumulate``) as GSPMD
    partitions a scatter: into a dim split over a mesh dim, each shard
    writes the rows that fall in it (accumulate only; a set there returns
    None); along a trailing dim, operand and values keep their shard, and a
    replicated operand takes the values' (a local cut); a sum of sharded
    or Partial values into a replicated operand is a Partial sum; a set of
    them is gathered first.  In place, ``x`` takes the write's layout, as
    GSPMD's scatter returns a buffer laid out as its operands."""
    got = _index_layout(x, indices)
    if got is None:
        return None
    mesh = x.device_mesh
    idx, ipl = got
    k, nd = len(idx), idx[0].ndim
    values = _as_dtensor(values, mesh)
    if values.ndim != nd + x.ndim - k:
        return None
    xpl, vpl = list(x.placements), list(values.placements)
    for m in range(mesh.ndim):
        p, q, v = xpl[m], ipl[m], vpl[m]
        if mesh.size(m) == 1:
            continue
        if isinstance(p, Partial) and not accumulate:
            p = xpl[m] = Replicate()
        if isinstance(p, Shard) and p.dim < k:
            if not accumulate:
                return None
            ipl[m], vpl[m] = Replicate(), Replicate()
        elif isinstance(p, Shard):
            ipl[m], vpl[m] = Replicate(), Shard(p.dim - k + nd)
        elif isinstance(v, Shard) and v.dim >= nd and (q.is_replicate() or not accumulate):
            ipl[m], xpl[m] = Replicate(), Shard(v.dim - nd + k)
        elif accumulate and isinstance(p, Partial) and not isinstance(v, Shard):
            ipl[m] = Replicate()
            vpl[m] = Partial()
        elif accumulate and ((isinstance(v, Shard) and v.dim < nd) or
                             (isinstance(q, Shard) and not isinstance(v, Partial))):
            xpl[m] = Partial()
            ipl[m] = vpl[m] = v if isinstance(v, Shard) and v.dim < nd else q
        else:
            ipl[m], vpl[m] = Replicate(), Replicate()
    target = _to(x, xpl)
    idx, values = [_to(i, ipl) for i in idx], _to(values, vpl)
    rows, inside = _local_rows(target, idx)
    v = values.to_local()
    if inside is not None:
        v = v * inside.reshape(inside.shape + (1,) * (v.ndim - nd)).to(v.dtype)
    local = target.to_local()
    if not inplace:
        return _dense(mesh, x.shape, xpl, local.index_put(tuple(rows), v, accumulate))
    if target is x:
        local.index_put_(tuple(rows), v, accumulate)
        return x
    x._local_tensor = local.index_put_(tuple(rows), v, accumulate)
    x._spec = target._spec
    return x


def _copy_layout(x: DTensor) -> list:
    """The layout of a copy of ``x`` (``clone``: the reshape before the
    output projection copies a strided attention output): each mesh dim
    holding a Partial sum reduce-scatters it onto the outermost dim whose
    local size it divides and that no later mesh dim splits (the layout
    torch 2.13's DTensor gives one attention block's output), or
    all-reduces it where no dim qualifies."""
    mesh, placements = x.device_mesh, list(x.placements)
    local = list(x.to_local().shape)
    for m, p in enumerate(placements):
        if not p.is_partial() or mesh.size(m) == 1:
            continue
        later = {q.dim for q in placements[m + 1:] if isinstance(q, Shard)}
        d = next((d for d, n in enumerate(local) if d not in later and n >= mesh.size(m)
                  and n % mesh.size(m) == 0), None)
        placements[m] = Replicate() if d is None else Shard(d)
        if d is not None:
            local[d] //= mesh.size(m)
    return placements


# pointwise ops linear in a Partial sum: the sums where every tensor input
# is a Partial sum or replicated on that mesh dim, the products in their
# largest Partial input (not a divisor) where the others are broadcasts of
# it, the rest always
_LINEAR_SUMS = {"add", "add_", "sub", "sub_"}
_LINEAR_PRODUCTS = {"mul", "mul_", "div", "div_"}
_LINEAR_UNARY = {"neg", "neg_", "positive"}


def _kept_partials(name: str, args, partials: list, mesh_dim: int) -> set | None:
    """The inputs of a pointwise op ``name`` that keep their Partial sums
    on ``mesh_dim`` (positions; the others there are replicated), where the
    op stays a Partial sum in them; None where it does not.  A product of
    two Partial sums keeps the larger (the MoE combine's outputs by their
    kept-slot mask: the mask is all-reduced)."""
    ops = {args[i].placements[mesh_dim].reduce_op for i in partials}
    if len(ops) > 1 or not ops <= {"sum", "avg"}:
        return None
    if name in _LINEAR_UNARY:
        return set(partials)
    if name in _LINEAR_SUMS:
        tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        linear = tensors == list(range(len(args))) and all(
            not isinstance(args[i], DTensor) or args[i].placements[mesh_dim].is_partial()
            or args[i].placements[mesh_dim].is_replicate() for i in tensors)
        return set(partials) if linear else None
    if name in _LINEAR_PRODUCTS:
        big = max(partials, key=lambda i: args[i].numel())
        if (big == 0 or name.startswith("mul")) and all(
                args[i].numel() < args[big].numel() for i in partials if i != big):
            return {big}
    return None


def _pointwise_layout(name: str, args, out_shape) -> tuple[dict, list] | None:
    """The layout of a pointwise op with a Partial sum among its DTensor
    inputs, or two inputs split apart, decided here as one rule on every
    torch (2.11's and 2.13's DTensor differ: 2.11 all-reduces a Partial
    scaled by a replicated scalar, reduce-scatters one multiplied by a
    replicated tensor, moves the other of two inputs split apart, ...):
    (placements of each input, placements of the output).  On each mesh
    dim holding a Partial input: where the op is linear in it
    (``_kept_partials``) and every input split there is smaller (a
    broadcast operand, gathered), it stays a Partial sum; else it is
    reduce-scattered into the largest split
    input's shard, or onto the output's largest free dim, or all-reduced.
    On any other mesh dim the output is split as its largest split input
    (of two alike, the one split along the outer dim, as torch 2.13's
    DTensor picks).  An in-place op keeps its output's layout unless that
    is a Partial sum the op is not linear in.  None where an input is
    strided."""
    dts = {i: a for i, a in enumerate(args) if isinstance(a, DTensor)}
    if any(_strided(a) for a in dts.values()):
        return None
    mesh = next(iter(dts.values())).device_mesh
    inplace = name.endswith("_")
    nd = len(out_shape)

    def out_dim(a, d):          # the output dim of input dim d, None where broadcast
        od = d + nd - a.ndim
        return od if a.shape[d] == out_shape[od] else None

    def in_dim(a, od):          # the input dim of output dim od, None where broadcast
        d = od - nd + a.ndim
        return d if d >= 0 and a.shape[d] == out_shape[od] else None

    out, kept = [], {}
    for m in range(mesh.ndim):
        n = mesh.size(m)
        partial = [i for i, a in dts.items() if a.placements[m].is_partial()]
        split = sorted(((i, out_dim(a, a.placements[m].dim)) for i, a in dts.items()
                        if isinstance(a.placements[m], Shard)
                        and out_dim(a, a.placements[m].dim) is not None),
                       key=lambda t: (-dts[t[0]].numel(), t[1]))
        split = [(i, od) for i, od in split
                 if all(in_dim(dts[j], od) is not None for j in partial)]
        if inplace and not args[0].placements[m].is_partial():
            p = args[0].placements[m]
            out.append(Shard(out_dim(args[0], p.dim)) if isinstance(p, Shard) else p)
            continue
        if not partial:
            out.append(Shard(split[0][1]) if split else Replicate())
            continue
        if n == 1:
            out.append(Replicate())
            continue
        keep = _kept_partials(name, args, partial, m)
        if keep is not None and all(dts[i].numel() < min(dts[j].numel() for j in keep)
                                    for i, _ in split):
            out.append(dts[min(keep)].placements[m])
            kept[m] = keep
            continue
        if split:
            out.append(Shard(split[0][1]))
            continue
        taken = {p.dim for p in out if isinstance(p, Shard)} | {
            out_dim(a, q.dim) for a in dts.values() for q in a.placements
            if isinstance(q, Shard)}
        free = [od for od in range(nd) if od not in taken and out_shape[od] >= n
                and all(in_dim(dts[j], od) is not None for j in partial)]
        out.append(Shard(max(free, key=lambda od: out_shape[od])) if free else Replicate())

    def layout(i, a):
        target = []
        for m, p in enumerate(out):
            if isinstance(p, Partial):
                target.append(p if i in kept[m] or name in _LINEAR_SUMS else Replicate())
            elif isinstance(p, Shard):
                d = in_dim(a, p.dim)
                target.append(Replicate() if d is None else Shard(d))
            else:
                target.append(Replicate())
        return target

    return {i: layout(i, a) for i, a in dts.items()}, out


def _split_apart(args) -> bool:
    """Whether two DTensor inputs of a pointwise op are split over one mesh
    dim along different dims of the output (one of them is moved)."""
    dts = [a for a in args if isinstance(a, DTensor)]
    nd = max(a.ndim for a in dts)
    return any(len({p.dim + nd - a.ndim for a in dts for p in [a.placements[m]]
                    if isinstance(p, Shard) and a.shape[p.dim] > 1}) > 1
               for m in range(dts[0].device_mesh.ndim))


def _pointwise(func, args, kwargs) -> DTensor | None:
    """A pointwise op with a Partial sum among its DTensor inputs, or with
    two inputs split apart (``_split_apart``), laid out by
    ``_pointwise_layout`` and run on the local shards; None for any other,
    whose layout is left to DTensor."""
    if not any(isinstance(a, DTensor) and any(p.is_partial() for p in a.placements)
               for a in args) and not _split_apart(args):
        return None
    name = func._overloadpacket.__name__
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    # a local tensor of more than one element takes part as a replicated one
    args = [_as_dtensor(a, mesh) if isinstance(a, torch.Tensor) and a.ndim else a
            for a in args]
    shapes = [a.shape for a in args if isinstance(a, torch.Tensor)]
    out_shape = tuple(args[0].shape) if name.endswith("_") else \
        tuple(torch.broadcast_shapes(*shapes))
    got = _pointwise_layout(name, args, out_shape)
    if got is None:
        return None
    targets, placements = got
    moved = [_to(a, targets[i]) if i in targets else a for i, a in enumerate(args)]
    local = func(*[a.to_local() if isinstance(a, DTensor) else a for a in moved], **kwargs)
    if not name.endswith("_"):
        return _dense(mesh, out_shape, placements, local)
    x = args[0]
    x._local_tensor, x._spec = moved[0]._local_tensor, moved[0]._spec
    return x


def _per_tensor(func, args) -> tuple | None:
    """The single-tensor op of a ``_foreach_*`` op and each tensor's
    arguments, or None."""
    name = func._overloadpacket.__name__
    if not name.startswith("_foreach_") or name == "_foreach_norm":
        return None
    base = getattr(torch.ops.aten, name[len("_foreach_"):], None)
    op = getattr(base, {"List": "Tensor", "ScalarList": "Scalar", "Tensor": "Tensor",
                        "Scalar": "Scalar", "default": "default"}.get(func._overloadname, ""),
                 None)
    if op is None:
        return None
    n = len(next(a for a in args if isinstance(a, (list, tuple))))
    return op, [[a[k] if isinstance(a, (list, tuple)) else a for a in args] for k in range(n)]


def _searchsorted(seq, values, **kwargs) -> DTensor:
    """``torch.searchsorted`` with the sorted sequence gathered (GSPMD's
    sort has gathered it already) and the result laid out as ``values``."""
    mesh = (seq if isinstance(seq, DTensor) else values).device_mesh
    seq, values = _as_dtensor(seq, mesh), _as_dtensor(values, mesh)
    seq = _to(seq, [Replicate()] * mesh.ndim)
    values = _to(values, [Replicate() if isinstance(p, Partial) else p
                          for p in values.placements])
    out = torch.searchsorted(seq.to_local(), values.to_local(), **kwargs)
    return _dense(mesh, values.shape, values.placements, out)


class _Reshard(TorchDispatchMode):
    """Reshards where DTensor refuses an op as laid out (module docstring);
    ``replicated_ops`` counts the ops that ran on replicated inputs.  What
    ``rec`` and ``cost`` recorded for a refused attempt is rolled back."""

    def __init__(self, rec: CollectiveRecorder, cost: LocalCostMode,
                 reuse: _ReusedRedistributions, mem: LiveMemoryMode | None = None):
        super().__init__()
        self.rec, self.cost, self.reuse = rec, cost, reuse
        self.mem = mem if mem is not None else LiveMemoryMode()
        self.anywhere = _MadeAnywhere()     # the rotary tables (``_positions_laid_out``)
        reuse.mem, reuse.anywhere = self.mem, self.anywhere
        self.replicated_ops: dict[str, int] = {}
        self.rows = weakref.WeakValueDictionary()   # id -> row of a sharded dim

    def _mark(self) -> tuple:
        return (len(self.rec.ops), self.cost.flops, self.cost.bytes, self.cost.n_ops,
                self.reuse.mark(), self.mem.mark())

    def _roll_back(self, mark: tuple) -> None:
        del self.rec.ops[mark[0]:]
        self.cost.flops, self.cost.bytes, self.cost.n_ops = mark[1:4]
        self.reuse.roll_back(mark[4])
        self.mem.roll_back(mark[5])

    def _view(self, func, args, kwargs):
        """A reshape whose result DTensor cannot lay out (an uneven split),
        lays out strided, or gathers: relabelled where the local shard can
        stay as it is (``_relabelled_view``), else the input's mesh dims are
        gathered one by one, the one sharding the innermost tensor dim
        first, until it can."""
        x = args[0]
        order = sorted((i for i, p in enumerate(x.placements) if not p.is_replicate()),
                       key=lambda i: -getattr(x.placements[i], "dim", x.ndim))
        placements = list(x.placements)
        for i in [None] + order:
            before = self._mark()
            if i is not None:
                placements[i] = Replicate()
            y = x.redistribute(x.device_mesh, placements) if i is not None else x
            mark = self._mark()
            try:
                out = func(y, *args[1:], **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                # DTensor refused, or laid out a shard its local view cannot
                # take (a dim split into more shards than it has rows)
                if not (_sharding_failure(e) or "is invalid for input of size" in str(e)):
                    raise
                out = None
            if out is not None and not _strided(out) and _n_sharded(out) >= _n_sharded(y):
                return out
            # DTensor's view is refused, strided or gathers: drop it (its
            # records and its buffers) before the relabelled one is made
            usable, out = out is not None and not _strided(out), None
            self._roll_back(mark)
            relabelled = _relabelled_view(y, args[1])
            if relabelled is not None:
                return relabelled
            if usable:
                return func(y, *args[1:], **kwargs)
            self._roll_back(before)
        raise RuntimeError(f"{func} does not lay out even on replicated inputs")

    def _scatter_targets(self, args, mark) -> dict | None:
        """Where DTensor all-reduced a Partial input of a pointwise op since
        ``mark`` (the ops ``_pointwise`` leaves to DTensor: a strided
        input): {arg index: placements} with each Partial of that arg
        reduce-scattered onto its largest free dim instead, as GSPMD keeps
        it split; None where nothing was."""
        targets = {}
        for i, a in enumerate(args):
            if not (isinstance(a, DTensor) and any(p.is_partial() for p in a.placements)
                    and self.reuse.all_reduced(a._local_tensor, mark[4])):
                continue
            placements, taken = list(a.placements), _split_dims(a)
            for m, p in enumerate(placements):
                free = [d for d in range(a.ndim)
                        if d not in taken and a.shape[d] >= a.device_mesh.size(m)]
                if p.is_partial() and free:
                    d = max(free, key=lambda d: a.shape[d])
                    placements[m] = Shard(d)
                    taken.add(d)
            targets[i] = placements
        return targets or None

    @staticmethod
    def _norms(tensors) -> list:
        """``torch._foreach_norm`` of DTensors (the card's global gradient
        norm), as the CPU's sum of squares per leaf is traced: each Partial
        leaf laid out as ``leaf * leaf`` lays it out (``_pointwise_layout``),
        squared and summed on its shard, that sum all-reduced and its root
        taken.  Torch 2.11's DTensor all-reduces every Partial leaf whole."""
        out = []
        for t in tensors:
            if any(p.is_partial() for p in t.placements):
                layout = _pointwise_layout("mul", [t, t], tuple(t.shape))
                if layout is not None:
                    t = _to(t, layout[0][0])
            local = t.to_local()
            total = _dense(t.device_mesh, (), [Partial() if isinstance(p, (Shard, Partial))
                                                else p for p in t.placements],
                           torch.sum(local * local))
            out.append(_all_reduced(total).sqrt())
        return out

    @staticmethod
    def _scattered(args, targets: dict) -> list:
        """The args with ``_scatter_targets``' Partials reduce-scattered."""
        return [_to(a, targets[i]) if i in targets else a for i, a in enumerate(args)]

    def _matmul(self, func, a: DTensor, b: DTensor):
        """A (batched) matmul as GSPMD partitions it where DTensor's output
        is a Partial sum that GSPMD avoids: where DTensor shards a
        contraction neither operand was sharded on, with ``a``'s rows split
        over a mesh dim ``b`` is gathered there (attention's keys over a
        split sequence), and with ``b``'s columns split, ``a`` is; where it
        multiplies a Partial operand by a replicated one on every rank (torch
        2.11's plan of an expert FFN's gradient), the Partial one is
        reduce-scattered onto the contraction."""
        mark = self._mark()
        out = func(a, b)
        fix_a, fix_b = list(a.placements), list(b.placements)
        for m, p in enumerate(out.placements):
            pa, pb = a.placements[m], b.placements[m]
            if not isinstance(p, Partial) or a.device_mesh.size(m) == 1:
                continue
            if isinstance(pa, Partial) and pb.is_replicate() or \
                    isinstance(pb, Partial) and pa.is_replicate():
                # a Partial operand times a replicated one, computed whole on
                # every rank: reduce-scatter it onto the contraction instead
                fix_a[m], fix_b[m] = Shard(a.ndim - 1), Shard(b.ndim - 2)
            elif isinstance(pa, Partial) or isinstance(pb, Partial):
                continue
            elif pa == Shard(a.ndim - 2):
                fix_b[m] = Replicate()
            elif pb == Shard(b.ndim - 1):
                fix_a[m] = Replicate()
        if fix_a == list(a.placements) and fix_b == list(b.placements):
            return out
        self._roll_back(mark)
        return func(_to(a, fix_a), _to(b, fix_b))

    def _index(self, func, x: DTensor, indices):
        """An advanced index by integer tensors over the leading dims,
        decided here whatever plan DTensor has for it (torch 2.11's gathers
        a vocab-split table, 2.13's moves its shard): replicated indices
        (the MoE dispatch's, from a sort) are partitioned as GSPMD
        partitions a gather (``_index``); sharded ones (an embedding's
        tokens) look up a table whose looked-up dims are split by moving
        those splits onto its last dim first (``_lookup``).  Other indices
        take DTensor's plan."""
        got = _index_layout(x, indices)
        if got is None:
            return func(x, indices)
        if all(p.is_replicate() for p in got[1]):
            return _index(x, indices)
        return _lookup(x, indices)

    def _gather(self, func, x: DTensor, dim: int, index, **kwargs):
        """A gather along a sharded dim, as GSPMD partitions it: each shard
        picks the indices that fall in its rows (zeros elsewhere) and the
        picks are summed over the mesh dims sharding that dim (a Partial
        result).  Where the index is not laid out for that, the dim is
        gathered first."""
        dim %= x.ndim
        mesh = x.device_mesh
        if not isinstance(index, DTensor):
            index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim, run_check=False)
        out_placements = []
        for p, q in zip(x.placements, index.placements):
            if isinstance(p, Shard) and p.dim == dim and q.is_replicate():
                out_placements.append(Partial())
            elif p == q and not isinstance(p, Partial):
                out_placements.append(p)
            else:
                out_placements = None
                break
        if out_placements is None or dim not in _split_dims(x):
            keep = [p if isinstance(p, Shard) and p.dim != dim else Replicate()
                    for p in x.placements]
            return func(x.redistribute(mesh, keep), dim, index, **kwargs)
        start, n = _rows_of(x.shape[dim], x.placements, mesh, dim)
        rows = index.to_local() - start
        inside = (rows >= 0) & (rows < n)
        picked = func(x.to_local(), dim, rows.clamp(0, max(n - 1, 0)), **kwargs)
        return DTensor.from_local(torch.where(inside, picked, torch.zeros_like(picked)), mesh,
                                  out_placements, run_check=False, shape=index.shape,
                                  stride=index.stride())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not on_dtensors(types):
            return func(*args, **kwargs)
        out = self._dispatch(func, args, kwargs)
        anywhere = self.anywhere
        if anywhere and _made_anywhere_op(func):
            inputs = [a for a in tree_leaves([args, kwargs]) if isinstance(a, DTensor)]
            if inputs and all(a._local_tensor in anywhere for a in inputs):
                for t in tree_leaves(out):
                    if isinstance(t, DTensor):
                        anywhere.add(t._local_tensor)
        return out

    def _dispatch(self, func, args, kwargs):
        """An op on DTensors, laid out as GSPMD would where DTensor would not."""
        if func._overloadpacket.__name__ in _VIEWS and isinstance(args[0], DTensor):
            return self._view(func, args, kwargs)
        if func is torch.ops.aten.gather.default and isinstance(args[0], DTensor):
            return self._gather(func, *args, **kwargs)
        if func is torch.ops.aten.logsumexp.default and _reduces_sharded(args[0], args[1]):
            return _logsumexp(*args)
        if func is torch.ops.aten._softmax.default and _reduces_sharded(args[0], args[1]):
            return _softmax(*args)
        if func is torch.ops.aten.select.int and _reduces_sharded(args[0], args[1]):
            row = _select_row(*args)
            self.rows[id(row)] = row
            return row
        if func is torch.ops.aten.copy_.default and self.rows.get(id(args[0])) is args[0]:
            dst, src = args[0], _as_dtensor(args[1], args[0].device_mesh)
            src = _to(src, [Replicate() if isinstance(p, Partial) else p
                            for p in dst.placements])
            dst.to_local().copy_(src.to_local())
            return dst
        name = func._overloadpacket.__name__
        if name == "searchsorted" and func is torch.ops.aten.searchsorted.Tensor:
            return _searchsorted(*args, **kwargs)
        if name in ("index_put", "index_put_") and isinstance(args[0], DTensor):
            out = _index_put(*args, **kwargs, inplace=name == "index_put_")
            if out is not None:
                return out
        if func is torch.ops.aten.index.Tensor and isinstance(args[0], DTensor):
            return self._index(func, *args)
        if func is torch.ops.aten._softmax_backward_data.default and _split_dims(args[1]):
            return _softmax_backward(*args)
        if func in (torch.ops.aten.scatter.src, torch.ops.aten.scatter.value):
            out = _scatter(func, *args, **kwargs)
            if out is not None:
                return out
        if func in (torch.ops.aten.bmm.default, torch.ops.aten.mm.default) and \
                all(isinstance(a, DTensor) for a in args):
            return self._matmul(func, *args)
        if func is torch.ops.aten.clone.default and isinstance(args[0], DTensor) and \
                any(p.is_partial() for p in args[0].placements):
            return func(_to(args[0], _copy_layout(args[0])), *args[1:], **kwargs)
        if func is torch.ops.aten._foreach_norm.Scalar and args[1:] in ((), (2,)) and \
                not kwargs and all(isinstance(t, DTensor) for t in args[0]):
            return self._norms(args[0])
        if torch.Tag.pointwise in func.tags:
            out = _pointwise(func, args, kwargs)
            if out is not None:
                return out
        per_tensor = _per_tensor(func, args)
        if per_tensor is not None and any(
                isinstance(t, DTensor) and any(p.is_partial() for p in t.placements)
                for t in tree_leaves(args)):
            op, each = per_tensor
            outs = []
            for a in each:
                out = _pointwise(op, a, kwargs)
                outs.append(op(*a, **kwargs) if out is None else out)
            return outs if func._schema.returns else None
        mark = self._mark()
        try:
            out = func(*args, **kwargs)
            if torch.Tag.pointwise not in func.tags:
                return out
            targets = self._scatter_targets(args, mark)
            if targets is None:
                return out
            # DTensor's all-reduce is dropped; the reduce-scatters that
            # replace it are made (and recorded) after the roll back
            out = None
            self._roll_back(mark)
            return func(*self._scattered(args, targets), **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if not _sharding_failure(e):
                raise
        self._roll_back(mark)
        # no strategy fits: run the op on replicated inputs, as local tensors
        name = str(func)
        self.replicated_ops[name] = self.replicated_ops.get(name, 0) + 1
        mesh = next(a for a in tree_leaves([args, kwargs]) if isinstance(a, DTensor)).device_mesh
        args, kwargs = tree_map_only(DTensor, lambda a: _replicated(a).to_local(), (args, kwargs))
        out = func(*args, **kwargs)
        return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False), out)


def _gather_layout(x, dim: int, index) -> list | None:
    """The layout ``index`` of ``torch.gather(x, dim, index)`` takes where
    ``_Reshard._gather`` picks per shard of a DTensor ``x`` split along
    ``dim`` (x's placements, with Replicate where x is split along
    ``dim``); None where it does not (``dim`` not split, a Partial ``x``,
    or an index laid out otherwise)."""
    if not isinstance(x, DTensor) or dim % x.ndim not in _split_dims(x) or \
            any(isinstance(p, Partial) for p in x.placements):
        return None
    dim %= x.ndim
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements]
    have = index.placements if isinstance(index, DTensor) else [Replicate()] * x.device_mesh.ndim
    return want if list(have) == want else None


class _ShardedGather(torch.autograd.Function):
    """``torch.gather`` of a DTensor along a split dim (the loss's pick of
    the label's logit from logits split over the vocab), whose gradient is
    laid out as its input, as GSPMD partitions the scatter of a gather's
    backward: each shard adds the gradients of the indices in its rows into
    zeros of its own shard.  Autograd's ``gather_backward`` makes the zeros
    with ``new_zeros`` at the input's global shape, which DTensor lays out
    replicated: a whole float32 [batch, sequence, vocab] on every rank."""

    @staticmethod
    def forward(ctx, x, dim, index):
        ctx.dim, ctx.layout = dim % x.ndim, (x.shape, list(x.placements), x.device_mesh)
        ctx.save_for_backward(index)
        return _torch_gather(x, dim, index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        (shape, placements, mesh), dim = ctx.layout, ctx.dim
        grad = _to(_as_dtensor(grad, mesh), _as_dtensor(index, mesh).placements)
        start, n = _rows_of(shape[dim], placements, mesh, dim)
        rows = _as_dtensor(index, mesh).to_local() - start
        g = grad.to_local()
        local = g.new_zeros(_local_shape(shape, placements, mesh))
        local.scatter_add_(dim, rows.clamp(0, max(n - 1, 0)),
                           torch.where((rows >= 0) & (rows < n), g, torch.zeros_like(g)))
        return _dense(mesh, shape, placements, local), None, None


_torch_gather = torch.gather


@contextlib.contextmanager
def _sharded_gathers():
    """For the duration, ``torch.gather`` and ``Tensor.gather`` go through
    ``_ShardedGather`` where ``_gather_layout`` applies (patched, not
    caught by a mode: the gradient's layout is autograd's)."""
    def gather(x, dim, index, **kwargs):
        if kwargs or _gather_layout(x, dim, index) is None:
            return _torch_gather(x, dim, index, **kwargs)
        return _ShardedGather.apply(x, dim, index)

    with mock.patch.object(torch, "gather", gather), \
            mock.patch.object(torch.Tensor, "gather", gather):
        yield


class _ShardedMean(torch.autograd.Function):
    """``x.mean()`` of a DTensor split over the mesh (the loss's mean over
    its batch and sequence), whose gradient is laid out as its input, as
    GSPMD lays out the broadcast of the mean's backward: each rank divides
    the gradient over its own shard (replicated where the input is a
    Partial sum).  Autograd's ``mean_backward`` expands the gradient to the
    input's global shape, which DTensor lays out replicated: a whole
    float32 [batch, sequence] on every rank."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.shape, [Replicate() if p.is_partial() else p for p in x.placements],
                      x.device_mesh, x.numel(), tuple(x.to_local().shape))
        return _torch_mean(x)

    @staticmethod
    def backward(ctx, grad):
        shape, placements, mesh, n, local_shape = ctx.layout
        if not isinstance(grad, DTensor) or not all(p.is_replicate() for p in grad.placements):
            return grad.expand(shape) / n
        return _dense(mesh, shape, placements, grad.to_local().expand(local_shape) / n)


_torch_mean = torch.mean


@contextlib.contextmanager
def _sharded_means():
    """For the duration, ``torch.mean`` and ``Tensor.mean`` of a whole
    DTensor split over the mesh, with its gradient wanted, go through
    ``_ShardedMean`` (patched, not caught by a mode: the gradient's layout
    is autograd's)."""
    def mean(x, *args, **kwargs):
        if args or kwargs or not (isinstance(x, DTensor) and x.requires_grad and _split_dims(x)
                                  and torch.is_grad_enabled()):
            return _torch_mean(x, *args, **kwargs)
        return _ShardedMean.apply(x)

    with mock.patch.object(torch, "mean", mean), mock.patch.object(torch.Tensor, "mean", mean):
        yield


def _keeps_rows(x, w) -> bool:
    """Whether ``_rows_kept_matmul`` applies to ``x @ w``: x [B, S, D]
    (B > 1, no Partial sum) has its sequence split over mesh dims that the
    2-D ``w`` is not split over (a test on ``w``'s placements, so ``w.T``
    gives the same answer)."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor) and x.ndim == 3
            and w.ndim == 2 and x.device_mesh == w.device_mesh):
        return False
    mesh = x.device_mesh
    seq = [i for i, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim == 1 and mesh.size(i) > 1]
    return (bool(seq) and x.shape[0] != 1 and not any(p.is_partial() for p in x.placements)
            and not any(isinstance(w.placements[i], Shard) for i in seq))


def _rows_kept_matmul(x, w):
    """``x @ w`` for x [B, S, D] whose sequence dim is sharded over mesh dims
    that ``w`` [D, N] is not sharded over, as XLA's dot_general runs it: the
    rows stay where they are and the output is laid out as ``x`` is.
    torch folds x into [B * S, D] for ``mm``, a strided shard that DTensor
    gathers.  Here the fold is relabelled (the same local rows, in another
    order, as ``_relabelled_view`` does) and DTensor lays out the ``mm`` from
    there.  None where this does not apply."""
    if not _keeps_rows(x, w):
        return None
    mesh = x.device_mesh
    B, S, D = x.shape
    rows = [Shard(0) if isinstance(p, Shard) and p.dim < 2 else
            Shard(1) if isinstance(p, Shard) else p for p in x.placements]
    local = x.to_local()
    if _local_shape((B * S, D), rows, mesh) != (local.shape[0] * local.shape[1], local.shape[2]):
        return None
    x2 = _dense(mesh, (B * S, D), rows, local.reshape(-1, local.shape[2]))
    y2 = torch.mm(x2, w)
    N = y2.shape[1]
    back = [x.placements[i] if isinstance(p, Shard) and p.dim == 0 else
            Shard(2) if isinstance(p, Shard) else p for i, p in enumerate(y2.placements)]
    shape = _local_shape((B, S, N), back, mesh)
    y_local = y2.to_local()
    if any(isinstance(p, Shard) and p.dim == 0 and not isinstance(q, Shard)
           for p, q in zip(y2.placements, x.placements)) or \
            math.prod(shape) != y_local.numel():
        return y2.view(B, S, N)
    return _dense(mesh, (B, S, N), back, y_local.reshape(shape))


@contextlib.contextmanager
def _rows_kept_matmuls():
    """For the duration, a matmul of a 3-D tensor by a 2-D one goes through
    ``_rows_kept_matmul`` where it applies, whichever way it is spelled:
    ``x @ w``, ``x.matmul(w)``, ``torch.matmul(x, w)`` or
    ``F.linear(x, w.T, b)``.  These are patched, not caught by a function
    mode: the recomputation of a checkpointed layer in the backward runs
    without the function modes of the forward.  An ``einsum`` goes around
    them (the models' projections use none)."""
    def rows_kept(original):
        def matmul(x, w):
            out = _rows_kept_matmul(x, w)
            return original(x, w) if out is None else out
        return matmul

    linear = F.linear

    def rows_kept_linear(x, weight, bias=None):
        if not _keeps_rows(x, weight):
            return linear(x, weight, bias)
        out = _rows_kept_matmul(x, weight.t())
        if out is None:
            return linear(x, weight, bias)
        return out if bias is None else out + bias

    with mock.patch.object(torch.Tensor, "__matmul__", rows_kept(torch.Tensor.__matmul__)), \
            mock.patch.object(torch.Tensor, "matmul", rows_kept(torch.Tensor.matmul)), \
            mock.patch.object(torch, "matmul", rows_kept(torch.matmul)), \
            mock.patch.object(F, "linear", rows_kept_linear):
        yield


@contextlib.contextmanager
def _all_to_all_on_cpu_meshes():
    """For the duration, DTensor moves a shard from one tensor dim to
    another with its all-to-all op on a CPU mesh too, as it does on a CUDA
    one: on CPU it otherwise gathers the whole dim and keeps its part (gloo has
    no all-to-all), which is not what the card would run."""
    from torch.distributed import tensor as dt
    original = getattr(dt._collective_utils, "shard_dim_alltoall", None)

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        # the group by its name, which the op takes on every torch this runs on
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     mesh.get_group(mesh_dim).group_name)

    with contextlib.ExitStack() as stack:
        for m in (dt._collective_utils, dt.placement_types):
            if original is not None and getattr(m, "shard_dim_alltoall", None) is original:
                stack.enter_context(mock.patch.object(m, "shard_dim_alltoall", all_to_all))
        yield


def _own_query_chunks(q, k, v, q_pos, k_pos, q_chunk: int, **kw):
    """``attention.query_chunks`` as the dry-run traces it, so that the
    chunks keep the plan of one unchunked block.

    Queries not split over the sequence: chunks of ``q_chunk`` along S,
    concatenated in the memory layout of one block's output
    (``_cat_as_one_block``).  The model's reshape before the output
    projection then copies them as it copies one block's strided output,
    and DTensor lays out that copy as it lays out one block's.  Where the
    output is a Partial sum (8 KV heads on a 'model' of 16: the keys split
    over the sequence, the queries replicated), torch 2.13's copy
    reduce-scatters it, and the projection and its gradients run on a
    shard.  A plain ``torch.cat`` is contiguous, so the reshape is a view,
    and the Partial reaches the projection, which then runs on the whole
    [B x S, H x hd] on every rank.

    Queries split over the sequence: each rank runs its own queries in
    chunks.  Where a rank holds at most one chunk, its queries run as one
    block, as unchunked; else chunk i of the trace is every rank's i-th
    local chunk, a DTensor laid out as ``q``, with its positions laid out
    alike (so the causal mask is [chunk, S] per rank) and the keys and
    values gathered once for all chunks.  Slicing global chunks would
    gather the sequence, where each rank's share is already one chunk or a
    few."""
    seq = [m for m, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 1
           and q.device_mesh.size(m) > 1] if isinstance(q, DTensor) else []
    if not seq:
        return _cat_as_one_block([
            attention._attn_scores_block(q[:, c:c + q_chunk], k, v, q_pos[c:c + q_chunk],
                                         k_pos, **kw)
            for c in range(0, q.shape[1], q_chunk)], dim=1)
    mesh, local = q.device_mesh, q.to_local()
    n_shards = math.prod(mesh.size(m) for m in seq)
    S_local = local.shape[1]
    if S_local <= q_chunk:
        return attention._attn_scores_block(q, k, v, q_pos, k_pos, **kw)
    if S_local * n_shards != q.shape[1]:
        raise RuntimeError(f"query chunks: {q.shape[1]} queries do not split evenly "
                           f"over {n_shards} ranks")
    start, _ = _rows_of(q.shape[1], q.placements, mesh, 1)
    pos = q_pos.to_local() if isinstance(q_pos, DTensor) else q_pos
    pos = pos[start:start + S_local]
    pos_placements = [Shard(0) if m in seq else Replicate() for m in range(mesh.ndim)]
    # the keys and values gathered over the sequence's mesh dims once, as
    # the unchunked product gathers them, not again for each chunk
    def gathered(t):
        return t if not isinstance(t, DTensor) else t.redistribute(mesh, [
            Replicate() if m in seq and p == Shard(1) else p for m, p in enumerate(t.placements)])

    k, v = gathered(k), gathered(v)
    outs = []
    for c in range(0, S_local, q_chunk):
        n = min(q_chunk, S_local - c)
        qc = _dense(mesh, (q.shape[0], n * n_shards) + tuple(q.shape[2:]), q.placements,
                    local[:, c:c + n])
        pc = _dense(mesh, (n * n_shards,), pos_placements, pos[c:c + n])
        outs.append(attention._attn_scores_block(qc, k, v, pc, k_pos, **kw))
    placements = outs[0].placements
    if any(o.placements != placements for o in outs) or \
            any(not (isinstance(placements[m], Shard) and placements[m].dim == 1) for m in seq):
        return torch.cat(outs, dim=1)
    return _dense(mesh, (q.shape[0], q.shape[1]) + tuple(outs[0].shape[2:]), placements,
                  torch.cat([o.to_local() for o in outs], dim=1))


def _cat_as_one_block(outs: list, dim: int):
    """``torch.cat(outs, dim)`` with the strides one block's output has:
    the chunks' dims put in the order of their strides, concatenated there
    and permuted back."""
    order = sorted(range(outs[0].ndim), key=lambda d: -outs[0].stride(d))
    back = sorted(range(len(order)), key=order.__getitem__)
    return torch.cat([o.permute(order) for o in outs], dim=order.index(dim)).permute(back)


@contextlib.contextmanager
def traced_time_steps(n: int):
    """For the duration, the rwkv6 / mamba2 time scans run their first ``n``
    steps only and give zeros for the other steps' outputs, so a step over a
    long sequence traces in bounded time.  The model's values are wrong
    while it holds; only the trace's costs are wanted.  The reference traces
    its scan body once and its costing adds the other steps analytically;
    the port's costing does the same with ``n = 1``."""
    scan = mamba2.chunked_time_scan

    def first_steps(step_body, carry0, seq):
        T = seq[0].shape[0]
        if n >= T:
            return scan(step_body, carry0, seq)
        carry, ys = scan(step_body, carry0, tuple(a[:n] for a in seq))
        return carry, torch.cat([ys, ys.new_zeros((T - n,) + ys.shape[1:])])

    with mock.patch.object(mamba2, "chunked_time_scan", first_steps), \
            mock.patch.object(rwkv6, "chunked_time_scan", first_steps):
        yield


@contextlib.contextmanager
def tracing(time_steps: int | None = None):
    """For the duration (inside ``FakeTensorMode`` and
    ``implicit_replication``, on DTensors over a fake process group), DTensor
    code is traced as the dry-run traces a step: yields ``(rec, cost,
    reshard)``, the collectives recorded, the per-device costs and the
    ``_Reshard`` mode (its ``replicated_ops``; its ``mem``, the
    ``LiveMemoryMode`` of the trace).  ``time_steps`` cuts the time scans
    (``traced_time_steps``)."""
    rec, cost, reuse, mem = (CollectiveRecorder(), LocalCostMode(), _ReusedRedistributions(),
                             LiveMemoryMode())
    reshard = _Reshard(rec, cost, reuse, mem)
    with contextlib.ExitStack() as stack:
        if time_steps is not None:
            stack.enter_context(traced_time_steps(time_steps))
        stack.enter_context(reuse.patched())
        stack.enter_context(_all_to_all_on_cpu_meshes())
        stack.enter_context(_marking_sharding_propagation())
        stack.enter_context(_rows_kept_matmuls())
        stack.enter_context(_sharded_gathers())
        stack.enter_context(_sharded_means())
        stack.enter_context(mock.patch.object(attention, "query_chunks", _own_query_chunks))
        for mode in (rec, cost, mem, reshard):
            stack.enter_context(mode)
        yield rec, cost, reshard


def build_step(arch_id: str, shape_id: str, mesh, *, cfg: ArchConfig | None = None,
               shape: ShapeConfig | None = None, perf: PerfOptions | None = None,
               device="cuda"):
    """Under an active ``FakeTensorMode``: returns ``((fn, args), None)``,
    ``fn(*args)`` running the step on DTensor inputs laid out by the rules,
    or ``(None, reason)`` for a documented skip.

    ``cfg`` and ``shape`` override the registered ones (the costing pass
    traces depth-cut variants; ``chip_smoke.py`` costs its own shapes).
    The rotary positions the step makes are laid out while ``tracing``
    (``_positions_laid_out``).
    """
    cfg = cfg or get_config(arch_id)
    shape = shape or get_shape(shape_id)
    reason = skip_reason(cfg, shape)
    if reason:
        return None, reason
    dev = resolve_device(device)
    model = build_model(cfg)
    perf = perf or PerfOptions()
    rules = ShardingRules(mesh=mesh, dp=dp_axes(mesh))
    ac = _positions_laid_out(make_activation_constrainer(cfg, shape, rules, perf), mesh)

    def dist(tree, specs):
        return tree_map(lambda t, s: _distribute(t, s, mesh), tree, specs)

    params = model.init(torch.Generator(device=dev).manual_seed(0), masters=True)
    param_specs = infer_param_specs(params, cfg, rules)
    params = dist(params, param_specs)
    specs = input_specs(cfg, shape, model, device=dev)
    batch = dist(specs["batch"], batch_specs(specs["batch"], cfg, shape, rules))

    caches = None
    if shape.mode == "decode":
        caches = dist(specs["caches"], cache_specs(specs["caches"], cfg, shape, rules))
    opt = None
    if shape.mode == "train":
        opt = init_opt_state(params)
        opt["step"] = _distribute(opt["step"], (), mesh)
    return _step(model, shape, perf, ac, params, batch, opt, caches), None


def _step(model, shape: ShapeConfig, perf: PerfOptions, ac, params, batch, opt, caches):
    """``(fn, args)`` of the step of ``shape.mode`` on these inputs."""
    if shape.mode == "train":
        step = make_train_step(model, AdamWConfig(), cast_params=perf.cast_params_bf16, ac=ac)
        return step, ({"params": params, "opt": opt}, batch)

    if shape.mode == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                logits, _, caches = model.forward(params, batch, want_cache=True,
                                                  remat=False, ac=ac)
            return logits, caches

        return prefill, (params, batch)

    # decode: ONE new token against the full-capacity cache, written at the
    # last slot (the port's decode step takes the position as an int)
    def decode(params, batch, caches):
        with torch.no_grad():
            return model.decode_step(params, dict(batch, pos=shape.seq_len - 1), caches, ac=ac)

    return decode, (params, batch, caches)


def measure_step_memory(cfg: ArchConfig, shape: ShapeConfig, device="cuda") -> dict:
    """ONE train or prefill step of ``cfg`` at ``shape`` run on the card, as
    ``build_step`` builds it but on plain tensors (no mesh): params from
    seed 0, tokens drawn from the vocab.  Returns the bytes the caching
    allocator held for it: ``argument_bytes`` (state and batch) and
    ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over the step),
    each above what was allocated before.  Needs a card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or shape.mode == "decode":
        raise ValueError(f"measures a train or prefill step on a card, not {shape.mode} "
                         f"on {dev}")
    model, perf = build_model(cfg), PerfOptions()
    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, masters=True)
    batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen, dtype=v.dtype, device=dev)
                 if k in ("tokens", "labels") else torch.zeros(v.shape, dtype=v.dtype,
                                                              device=dev))
             for k, v in input_specs(cfg, shape, model)["batch"].items()}
    opt = init_opt_state(params) if shape.mode == "train" else None
    fn, args = _step(model, shape, perf, identity_ac, params, batch, opt, None)
    del params, batch, opt
    torch.cuda.synchronize(dev)
    arguments = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    del out, args, fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"argument_bytes": arguments, "peak_bytes": peak}


def predict_step_memory(cfg: ArchConfig, shape: ShapeConfig, device="cuda") -> MemoryAnalysis:
    """``trace_memory`` of the step ``measure_step_memory`` runs: fake
    tensors of ``device``'s type on a fake (1, 1) mesh."""
    dev = resolve_device(device)
    with fake_world(1):
        mem, _ = trace_memory(cfg.name, shape.name, make_mesh((1, 1), ("data", "model"), dev),
                              cfg=cfg, shape=shape, device=dev)
    return mem


def trace_step(arch_id: str, shape_id: str, mesh, *, cfg: ArchConfig | None = None,
               shape: ShapeConfig | None = None, perf: PerfOptions | None = None,
               device="cuda", time_steps: int = mamba2.TIME_CHUNK) -> Traced:
    """Build and run one step on fake tensors over ``mesh`` (whose fake
    process group must be active), counting its per-device costs,
    collectives and memory.  Attention runs in query chunks as the model
    runs it, with the plan of one unchunked block (``_own_query_chunks``);
    the roofline's costing traces it unchunked under
    ``dense_attention_for_costing``, as the reference's costing does."""
    cfg = cfg or get_config(arch_id)
    shape = shape or get_shape(shape_id)
    loop = cfg.family in ("ssm", "hybrid")      # a time scan (decode: one step)
    steps = (None if not loop else 1 if shape.mode == "decode"
             else min(shape.seq_len, time_steps))
    with FakeTensorMode(), implicit_replication():
        built, reason = build_step(arch_id, shape_id, mesh, cfg=cfg, shape=shape, perf=perf,
                                   device=device)
        if built is None:
            return Traced(skip_reason=reason)
        fn, args = built
        with tracing(time_steps if loop else None) as (rec, cost, reshard):
            reshard.mem.hold_arguments(args)
            memory = reshard.mem.analysis(fn(*args))
    return Traced(flops=cost.flops, bytes=cost.bytes, wire=wire_bytes_by_kind(rec.ops),
                  collective_counts=collective_counts(rec.ops),
                  argument_bytes=memory.argument_bytes, n_ops=cost.n_ops,
                  time_steps_traced=steps, replicated_ops=reshard.replicated_ops, memory=memory)


def memory_time_steps(cfg: ArchConfig, shape: ShapeConfig) -> tuple[int, int] | None:
    """The two time-scan lengths whose traces the dry-run's temp peak is
    extrapolated from, or None where it traces every step (no time loop,
    decode's one step, or a sequence of at most four scan chunks).  Where
    the full scan checkpoints per chunk of ``mamba2.TIME_CHUNK``, both are
    whole chunks, three and four (a cut of one or two chunks peaks where
    the zeros standing in for the rest are made); otherwise both are cut
    one step short of that, so the cut scan runs flat as the full one
    does."""
    T, C = shape.seq_len, mamba2.TIME_CHUNK
    if cfg.family not in ("ssm", "hybrid") or shape.mode == "decode" or T <= 4 * C:
        return None
    return (3 * C, 4 * C) if T % C == 0 else (3 * C - 1, 4 * C - 1)


def trace_memory(arch_id: str, shape_id: str, mesh, *, cfg: ArchConfig | None = None,
                 shape: ShapeConfig | None = None,
                 device="cuda") -> tuple[MemoryAnalysis, str]:
    """The step's per-device memory over every time step, traced as the
    step runs (attention in query chunks).  Where the time scans are cut
    (``memory_time_steps``), the step is traced at two lengths n1 < n2 and
    the temp peak extrapolated to T steps as temp(n2) + (T - n2) x
    (temp(n2) - temp(n1)) / (n2 - n1), as the costing adds the steps it
    does not trace: exact where the peak grows by the same bytes a step
    from n1 to T (the scan's saved state sets it) or not at all.  Returns
    the memory and how its peak was found."""
    cfg = cfg or get_config(arch_id)
    shape = shape or get_shape(shape_id)
    lengths = memory_time_steps(cfg, shape)
    T = shape.seq_len
    if lengths is None:
        tr = trace_step(arch_id, shape_id, mesh, cfg=cfg, shape=shape, device=device,
                        time_steps=T)
        return tr.memory, ("every time step traced" if tr.time_steps_traced else "")
    (n1, n2), (t1, t2) = lengths, [
        trace_step(arch_id, shape_id, mesh, cfg=cfg, shape=shape, device=device,
                   time_steps=n).memory for n in lengths]
    return (dataclasses.replace(t2, temp_bytes=t2.temp_bytes + (T - n2) * (
                t2.temp_bytes - t1.temp_bytes) // (n2 - n1)),
            f"temp of {T} time steps extrapolated from traces of {n1} and {n2} steps "
            f"({t1.temp_bytes} and {t2.temp_bytes} B)")


def trace_dryrun(arch_id: str, shape_id: str, mesh, *, cfg: ArchConfig | None = None,
                 device="cuda") -> tuple[Traced, str]:
    """The dry-run's trace of a step, the time scans cut to
    ``mamba2.TIME_CHUNK`` steps, with attention in query chunks as the
    step runs it: one trace gives the costs, the collectives and the
    memory, since a chunked trace keeps the unchunked one's plan
    (``_own_query_chunks``).  Where the time scans are cut, the memory over
    every time step comes from ``trace_memory``.  Returns the trace and how
    its memory was found."""
    cfg = cfg or get_config(arch_id)
    shape = get_shape(shape_id)
    tr = trace_step(arch_id, shape_id, mesh, cfg=cfg, device=device)
    if tr.skip_reason:
        return tr, ""
    if tr.time_steps_traced not in (None, 1, shape.seq_len):
        tr.memory, method = trace_memory(arch_id, shape_id, mesh, cfg=cfg, device=device)
        return tr, method
    return tr, ("every time step traced" if tr.time_steps_traced else "")


# one H100's memory (80 GB HBM3), the "fits?" line of the memory analysis
DEVICE_BYTES = 80 * 10**9


def run_one(arch_id: str, shape_id: str, *, multi_pod: bool = False, device="cuda",
            verbose: bool = True, cfg: ArchConfig | None = None) -> DryrunResult:
    """One dry-run on the production mesh, inside a fake process group of
    its size; ``cfg`` overrides the registered config (a depth cut)."""
    dev = resolve_device(device)
    dims, _ = production_mesh_shape(multi_pod)
    t0 = time.perf_counter()
    with fake_world(math.prod(dims)):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        name = mesh_name(mesh)
        try:
            tr, method = trace_dryrun(arch_id, shape_id, mesh, cfg=cfg, device=dev)
        except Exception as e:   # a failed pair is a result, as in the reference
            if verbose:
                traceback.print_exc()
            return DryrunResult(arch_id, shape_id, name, "failed",
                                reason=f"{type(e).__name__}: {e}",
                                compile_seconds=time.perf_counter() - t0)
    if tr.skip_reason:
        return DryrunResult(arch_id, shape_id, name, "skipped", reason=tr.skip_reason)
    mem = tr.memory
    fits = "fits" if mem.total_bytes <= DEVICE_BYTES else "does not fit"
    res = DryrunResult(
        arch_id, shape_id, name, "ok",
        flops=tr.flops, bytes_accessed=tr.bytes, collective_counts=tr.collective_counts,
        memory_analysis=(f"per device: {mem}; argument + output - alias + temp = "
                         f"{mem.total_bytes} B, {fits} in {DEVICE_BYTES} B; "
                         f"{tr.n_ops} local aten ops traced"
                         + (f"; {method}" if method else "")),
        peak_bytes_per_device=float(mem.temp_bytes),
        argument_bytes_per_device=float(mem.argument_bytes),
        compile_seconds=time.perf_counter() - t0, time_steps_traced=tr.time_steps_traced,
        replicated_ops=tr.replicated_ops, wire_bytes_per_device=tr.wire)
    if verbose:
        print(f"[ok] {arch_id} x {shape_id} x {name}: flops={res.flops:.3e} "
              f"bytes={res.bytes_accessed:.3e} collectives={res.collective_counts} "
              f"wire={sum(tr.wire.values()):.3e} peak={mem.temp_bytes:.4e} "
              f"arguments={mem.argument_bytes:.4e} ({fits}) "
              f"trace={res.compile_seconds:.1f}s replicated_ops={res.replicated_ops}")
        print(f"     memory_analysis: {res.memory_analysis}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pairs = ([(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
             if args.all else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for mp in meshes:
        for a, s in pairs:
            if a is None or s is None:
                raise SystemExit("need --arch and --shape (or --all)")
            results.append(run_one(a, s, multi_pod=mp, device=device))
    n_fail = sum(r.status == "failed" for r in results)
    n_skip = sum(r.status == "skipped" for r in results)
    print(f"\n== dry-run summary: {len(results)} runs, {n_fail} failed, {n_skip} skipped ==")
    for r in results:
        if r.status != "ok":
            print(f"  [{r.status}] {r.arch} x {r.shape} x {r.mesh}: {r.reason}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=1)
        print(f"wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
