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
reference's kind names (``roofline.wire``), and the exact bytes of the
arguments' local shards.

DTensor is not GSPMD: it lays out each op on its own, eagerly.  Where the
two differ most, the dry-run does what GSPMD does, so that its counts can
be held against the reference's (``tests/test_torch_roofline.py``, on a
(2, 4) mesh: FLOPs within 3% where the heads divide the model axis):

* ``_Reshard`` reshards where DTensor refuses an op as laid out.  A reshape
  to 3-D (a bmm's operand) that merges dims sharded over different mesh
  dims into its batch dim is relabelled (``_merged_shard``) rather than
  gathered; one that would split a sharded dim unevenly, or merge into a
  2-D strided shard, gathers the blocking mesh dims.  A gather and a logsumexp along a sharded dim
  (the loss over a vocab split over 'model') pick and reduce per shard and
  all-reduce the small result, where DTensor gathers the logits.  Any
  other op DTensor cannot shard runs on replicated inputs, counted in
  ``replicated_ops``.  What a refused attempt recorded is dropped.
* ``_ReusedRedistributions``: one collective per operand and layout, as
  XLA's common-subexpression elimination leaves it.
* ``_all_to_all_on_cpu_meshes``: a CPU mesh traces the all-to-all a CUDA
  mesh would, not the whole-dim gather gloo makes do with.

Known gaps (PERF.md): heads that do not divide the model axis (qwen2-0.5b's
14) make attention run replicated over it, where GSPMD splits it; decode
gathers a cache sharded on its capacity to write one row.

The rwkv6 / zamba2 time loops launch ~7 ops per step and layer; the dry-run
traces their first ``time_steps`` steps (``traced_time_steps``, recorded in
``time_steps_traced``) and zeros stand in for the rest.

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
import importlib
import json
import math
import os
import time
import traceback
import weakref
from unittest import mock

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

from repro_torch.compat import resolve_device
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.models import mamba2, rwkv6
from repro_torch.roofline.costing import LocalCostMode, _marking_sharding_propagation
from repro_torch.roofline.wire import (CollectiveRecorder, collective_counts, on_dtensors,
                                       tensor_bytes, wire_bytes_by_kind)
from repro_torch.sharding.rules import (PerfOptions, ShardingRules, batch_specs, cache_specs,
                                        infer_param_specs, make_activation_constrainer,
                                        to_placements)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.tree import tree_leaves, tree_map
from .input_specs import input_specs, skip_reason
from .mesh import dp_axes, fake_world, make_production_mesh, mesh_name, production_mesh_shape


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


# MemTracker (torch.distributed._tools) sizes DTensors by their global
# shapes: a 2 MiB local shard and two temporaries of its size peak at
# 24 MiB, not 6, so it gives no per-device peak here
_PEAK_NOT_MEASURED = "not measured (MemTracker counts DTensors at global size)"


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


def _merged_shard(x: DTensor) -> DTensor | None:
    """``x``, laid out strided by a reshape that merged dims sharded over
    different mesh dims, relabelled as the merged dim sharded over those mesh
    dims in mesh order: the same local shard, its rows in another order.  No
    per-device size changes, so no cost does.  XLA's dot_general keeps
    several batch dims (batch x heads), where torch's bmm merges them into
    one; without this the merged dim would be gathered.  None where the
    relabelled layout would not give the same local shape."""
    placements = [Shard(p.dim) if type(p).__name__ == "_StridedShard" else p
                  for p in x.placements]
    local = x.to_local()
    if _local_shape(x.shape, placements, x.device_mesh) != tuple(local.shape):
        return None
    return DTensor.from_local(local, x.device_mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


class _ReusedRedistributions:
    """For the duration, DTensor redistributes a local tensor from one
    layout to another once and reuses the result: eager DTensor
    redistributes an input again at each consumer (a pending reduction of a
    gradient, the gather of an activation three projections read), where
    XLA's common-subexpression elimination keeps one collective per operand
    and layout (an operand written in place since is another operand).
    ``mark`` / ``roll_back`` drop what a refused attempt added."""

    _MODULES = ("_dispatch", "_redistribute", "_api")

    def __init__(self):
        self.memo: dict = {}
        self.added: list = []

    def mark(self) -> int:
        return len(self.added)

    def roll_back(self, mark: int) -> None:
        for key in self.added[mark:]:
            self.memo.pop(key, None)
        del self.added[mark:]

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
            out = original(local_tensor, current_spec, target_spec, *args, **kwargs)
            self.memo[key] = (weakref.ref(local_tensor), out)
            self.added.append(key)
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


def _logsumexp(x: DTensor, dims, keepdim: bool = False) -> DTensor:
    """logsumexp over a sharded dim, as GSPMD partitions it: a max and a
    sum of exponentials per shard, each all-reduced (DTensor's own strategy
    gathers the whole input first)."""
    m = x.amax(dims, keepdim=True)
    out = (x - m).exp().sum(dims, keepdim=True).log() + m
    if not keepdim:     # one dim at a time: torch 2.11's DTensor has no squeeze.dims
        for d in sorted((d % x.ndim for d in dims), reverse=True):
            out = out.squeeze(d)
    return out


class _Reshard(TorchDispatchMode):
    """Reshards where DTensor refuses an op as laid out (module docstring);
    ``replicated_ops`` counts the ops that ran on replicated inputs.  What
    ``rec`` and ``cost`` recorded for a refused attempt is rolled back."""

    def __init__(self, rec: CollectiveRecorder, cost: LocalCostMode,
                 reuse: _ReusedRedistributions):
        super().__init__()
        self.rec, self.cost, self.reuse = rec, cost, reuse
        self.replicated_ops: dict[str, int] = {}

    def _mark(self) -> tuple:
        return (len(self.rec.ops), self.cost.flops, self.cost.bytes, self.cost.n_ops,
                self.reuse.mark())

    def _roll_back(self, mark: tuple) -> None:
        del self.rec.ops[mark[0]:]
        self.cost.flops, self.cost.bytes, self.cost.n_ops = mark[1:4]
        self.reuse.roll_back(mark[4])

    def _view(self, func, args, kwargs):
        """A reshape whose result DTensor cannot lay out (an uneven split)
        or lays out strided (relabelled where 3-D, ``_merged_shard``):
        gather the input's mesh dims one by one, the one sharding the
        innermost tensor dim first, until it can."""
        x = args[0]
        order = sorted((i for i, p in enumerate(x.placements) if not p.is_replicate()),
                       key=lambda i: -getattr(x.placements[i], "dim", x.ndim))
        placements = list(x.placements)
        for i in [None] + order:
            mark = self._mark()
            if i is not None:
                placements[i] = Replicate()
            y = x.redistribute(x.device_mesh, placements) if i is not None else x
            try:
                out = func(y, *args[1:], **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                # DTensor refused, or laid out a shard its local view cannot
                # take (a dim split into more shards than it has rows)
                if not (_sharding_failure(e) or "is invalid for input of size" in str(e)):
                    raise
                self._roll_back(mark)
                continue
            if not _strided(out):
                return out
            merged = _merged_shard(out) if out.ndim == 3 else None
            if merged is not None:
                return merged
            self._roll_back(mark)
        raise RuntimeError(f"{func} does not lay out even on replicated inputs")

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
        if func._overloadpacket.__name__ in _VIEWS and isinstance(args[0], DTensor):
            return self._view(func, args, kwargs)
        if func is torch.ops.aten.gather.default and isinstance(args[0], DTensor):
            return self._gather(func, *args, **kwargs)
        if func is torch.ops.aten.logsumexp.default and _reduces_sharded(args[0], args[1]):
            return _logsumexp(*args)
        mark = self._mark()
        try:
            return func(*args, **kwargs)
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
        from torch.distributed._functional_collectives import (_group_or_group_name,
                                                                _resolve_group)
        group = _group_or_group_name(_resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    with contextlib.ExitStack() as stack:
        for m in (dt._collective_utils, dt.placement_types):
            if original is not None and getattr(m, "shard_dim_alltoall", None) is original:
                stack.enter_context(mock.patch.object(m, "shard_dim_alltoall", all_to_all))
        yield


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


def build_step(arch_id: str, shape_id: str, mesh, *, cfg: ArchConfig | None = None,
               shape: ShapeConfig | None = None, perf: PerfOptions | None = None,
               device="cuda"):
    """Under an active ``FakeTensorMode``: returns ``((fn, args), None)``,
    ``fn(*args)`` running the step on DTensor inputs laid out by the rules,
    or ``(None, reason)`` for a documented skip.

    ``cfg`` and ``shape`` override the registered ones (the costing pass
    traces depth-cut variants; ``chip_smoke.py`` costs its own shapes).
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
    ac = make_activation_constrainer(cfg, shape, rules, perf)

    def dist(tree, specs):
        return tree_map(lambda t, s: _distribute(t, s, mesh), tree, specs)

    params = model.init(torch.Generator(device=dev).manual_seed(0), masters=True)
    param_specs = infer_param_specs(params, cfg, rules)
    params = dist(params, param_specs)
    specs = input_specs(cfg, shape, model, device=dev)
    batch = dist(specs["batch"], batch_specs(specs["batch"], cfg, shape, rules))

    if shape.mode == "train":
        opt = init_opt_state(params)
        opt["step"] = _distribute(opt["step"], (), mesh)
        step = make_train_step(model, AdamWConfig(), cast_params=perf.cast_params_bf16, ac=ac)
        return (step, ({"params": params, "opt": opt}, batch)), None

    if shape.mode == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                logits, _, caches = model.forward(params, batch, want_cache=True,
                                                  remat=False, ac=ac)
            return logits, caches

        return (prefill, (params, batch)), None

    # decode: ONE new token against the full-capacity cache, written at the
    # last slot (the port's decode step takes the position as an int)
    caches = dist(specs["caches"], cache_specs(specs["caches"], cfg, shape, rules))

    def decode(params, batch, caches):
        with torch.no_grad():
            return model.decode_step(params, dict(batch, pos=shape.seq_len - 1), caches, ac=ac)

    return (decode, (params, batch, caches)), None


def trace_step(arch_id: str, shape_id: str, mesh, *, cfg: ArchConfig | None = None,
               shape: ShapeConfig | None = None, perf: PerfOptions | None = None,
               device="cuda", time_steps: int = mamba2.TIME_CHUNK) -> Traced:
    """Build and run one step on fake tensors over ``mesh`` (whose fake
    process group must be active), counting its per-device costs."""
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
        arg_bytes = sum(tensor_bytes(x.to_local()) for x in
                        tree_leaves(args) if isinstance(x, DTensor))
        rec, cost, reuse = CollectiveRecorder(), LocalCostMode(), _ReusedRedistributions()
        reshard = _Reshard(rec, cost, reuse)
        with contextlib.ExitStack() as stack:
            if loop:
                stack.enter_context(traced_time_steps(time_steps))
            stack.enter_context(reuse.patched())
            stack.enter_context(_all_to_all_on_cpu_meshes())
            stack.enter_context(_marking_sharding_propagation())
            for mode in (rec, cost, reshard):
                stack.enter_context(mode)
            fn(*args)
    return Traced(flops=cost.flops, bytes=cost.bytes, wire=wire_bytes_by_kind(rec.ops),
                  collective_counts=collective_counts(rec.ops), argument_bytes=arg_bytes,
                  n_ops=cost.n_ops, time_steps_traced=steps,
                  replicated_ops=reshard.replicated_ops)


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
            tr = trace_step(arch_id, shape_id, mesh, cfg=cfg, device=dev)
        except Exception as e:   # a failed pair is a result, as in the reference
            if verbose:
                traceback.print_exc()
            return DryrunResult(arch_id, shape_id, name, "failed",
                                reason=f"{type(e).__name__}: {e}",
                                compile_seconds=time.perf_counter() - t0)
    if tr.skip_reason:
        return DryrunResult(arch_id, shape_id, name, "skipped", reason=tr.skip_reason)
    res = DryrunResult(
        arch_id, shape_id, name, "ok",
        flops=tr.flops, bytes_accessed=tr.bytes, collective_counts=tr.collective_counts,
        memory_analysis=(f"per device: arguments {tr.argument_bytes} B; {tr.n_ops} local "
                         f"aten ops traced; peak {_PEAK_NOT_MEASURED}"),
        argument_bytes_per_device=float(tr.argument_bytes),
        compile_seconds=time.perf_counter() - t0, time_steps_traced=tr.time_steps_traced,
        replicated_ops=tr.replicated_ops, wire_bytes_per_device=tr.wire)
    if verbose:
        print(f"[ok] {arch_id} x {shape_id} x {name}: flops={res.flops:.3e} "
              f"bytes={res.bytes_accessed:.3e} collectives={res.collective_counts} "
              f"wire={sum(tr.wire.values()):.3e} "
              f"trace={res.compile_seconds:.1f}s replicated_ops={res.replicated_ops}")
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
