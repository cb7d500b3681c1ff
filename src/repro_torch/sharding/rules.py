"""Logical sharding rules: param / activation / cache / batch specs per mesh.

Counterpart of ``repro.sharding.rules``, with the same strategy:

* FSDP: the non-TP dimension of every large matrix is sharded over the
  data-parallel axes (('pod','data') on the multi-pod mesh), ZeRO-style;
* TP:   head/ffn/vocab output dims shard over 'model';
* every rule is divisibility-guarded: a dim that doesn't divide the axis
  size falls back to replicated on that axis (e.g. qwen2-0.5b's 14 heads);
* activations: hidden states are sharded batch-over-DP and sequence-over-
  'model' between blocks (``make_activation_constrainer``);
* batch==1 decode (long_500k): KV-cache capacity is sharded over the DP
  axes instead (context parallelism).

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (major to minor).
``to_placements`` turns one into DTensor placements.

Layout contract: the port holds each stack of layers as a list of
per-layer dicts (``bridge.stacked_keys``), where the reference stacks them
on leading scan axes.  The spec of a port leaf is the reference's spec of
the corresponding stacked leaf with the stacked dims dropped: the rules run
on the stacked shape (the per-layer shape behind the stack's trip counts)
and the leading entries are cut off.  The reference never shards a stacked
param dim; its cache rules could pick a stacked dim as the batch dim when a
trip count equals the batch, and the port drops that entry as well.

This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.train.tree import tree_map_with_path

Spec = tuple


def axis_sizes(mesh) -> dict:
    """Axis name -> size for a ``DeviceMesh`` or a duck-typed mesh whose
    ``.shape`` is that dict already."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


@dataclasses.dataclass(frozen=True)
class PerfOptions:
    """Beyond-baseline performance knobs, as the reference's.

    Defaults are the optimized configuration; ``PerfOptions.baseline()`` is
    the recorded baseline.
    """

    expert_sharding: bool = True      # shard MoE capacity buffers over DP
    cast_params_bf16: bool = True     # gather bf16 weights, fp32 master copy
    light_resharding: bool = True     # one seq-reshard point per block, not two

    @classmethod
    def baseline(cls) -> "PerfOptions":
        return cls(expert_sharding=False, cast_params_bf16=False,
                   light_resharding=False)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any
    dp: Any          # data-parallel axes: ('pod','data') or 'data'
    tp: Any = "model"

    def _ok(self, dim: int, axes) -> Any:
        return axes if axes is not None and dim % _axsize(self.mesh, axes) == 0 else None

    def matrix(self, shape: tuple, tp_dim: int, *, stacked: int = 0) -> Spec:
        """Spec for a (possibly layer-stacked) weight matrix: FSDP on the
        first non-stacked non-TP dim, TP on ``tp_dim``."""
        spec: list = [None] * len(shape)
        spec[tp_dim] = self._ok(shape[tp_dim], self.tp)
        for i in range(stacked, len(shape)):
            if i != tp_dim:
                spec[i] = self._ok(shape[i], self.dp)
                break
        return tuple(spec)

    def replicated(self, shape) -> Spec:
        return (None,) * len(shape)


_STACKS = ("blocks", "supers", "enc_blocks", "dec_blocks")


def _param_spec(names: list, shape: tuple, cfg: ArchConfig, rules: ShardingRules) -> Spec:
    """The reference's rule for one leaf, on its STACKED shape."""
    nd = len(shape)
    joined = "/".join(str(n) for n in names)
    stacked = 1 if any(n in _STACKS for n in names) else 0
    if nd - stacked == 0:
        return rules.replicated(shape)
    last = names[-1]
    if last in ("embed", "dec_pos"):               # [V, D]
        return (rules._ok(shape[0], rules.tp), rules._ok(shape[1], rules.dp))
    if last == "unembed":                          # [D, V]
        return (rules._ok(shape[0], rules.dp), rules._ok(shape[1], rules.tp))
    if last == "router":                           # [.., D, E]
        spec = [None] * nd
        spec[-2] = rules._ok(shape[-2], rules.dp)
        return tuple(spec)
    if last in ("wg", "wu", "wd") and "moe" in joined:  # [.., E, D|F, F|D]
        # expert-parallel when E divides the TP axis; otherwise TP the
        # expert-FFN hidden dim
        spec = [None] * nd
        e = nd - 3
        d_dim = nd - 2 if last in ("wg", "wu") else nd - 1   # d_model dim
        f_dim = nd - 1 if last in ("wg", "wu") else nd - 2   # expert-FFN dim
        if shape[e] % _axsize(rules.mesh, rules.tp) == 0:
            spec[e] = rules.tp
        else:
            spec[f_dim] = rules._ok(shape[f_dim], rules.tp)
        spec[d_dim] = rules._ok(shape[d_dim], rules.dp)
        return tuple(spec)
    in_dim_names = {"wo", "wd", "w_out", "wB"}
    out_dim_names = {"wq", "wk", "wv", "wg", "wu", "wA", "w_in", "wr"}
    is_attn = "attn" in joined        # attn, self_attn, cross_attn, shared_attn
    if "cm" in names and last == "wv":              # rwkv channel-mix [F, D]
        return _in_dim_tp(rules, shape)
    if last in ("wq", "wk", "wv") and is_attn:
        # TP on the head axis only when WHOLE heads divide the axis
        if not heads_split(cfg.n_heads if last == "wq" else cfg.n_kv_heads, rules):
            spec = [None] * nd
            spec[nd - 2] = rules._ok(shape[nd - 2], rules.dp)
            return tuple(spec)
        return rules.matrix(shape, nd - 1, stacked=stacked)
    if last == "wo" and is_attn:
        if not heads_split(cfg.n_heads, rules):
            spec = [None] * nd
            spec[nd - 1] = rules._ok(shape[nd - 1], rules.dp)
            return tuple(spec)
        return _in_dim_tp(rules, shape)
    if nd >= 2 and last in out_dim_names:
        return rules.matrix(shape, nd - 1, stacked=stacked)  # out-dim TP
    if nd >= 2 and last in in_dim_names:
        return _in_dim_tp(rules, shape)
    if nd >= 2 and last == "conv_w":
        spec = [None] * nd
        spec[-1] = rules._ok(shape[-1], rules.tp)
        return tuple(spec)
    return rules.replicated(shape)


def heads_split(heads: int, rules: ShardingRules) -> bool:
    """Whether an attention projection of ``heads`` heads is split over
    its heads on the TP axis: only when whole heads divide it.  Where the
    queries' heads do not, their projection keeps the hidden's layout and
    the queries stay split over the sequence."""
    return heads % _axsize(rules.mesh, rules.tp) == 0


def _in_dim_tp(rules: ShardingRules, shape) -> Spec:
    """TP on the input (second-to-last) dim, FSDP on the output dim."""
    nd = len(shape)
    spec: list = [None] * nd
    spec[nd - 2] = rules._ok(shape[nd - 2], rules.tp)
    spec[nd - 1] = rules._ok(shape[nd - 1], rules.dp)
    return tuple(spec)


def _stack_trips(cfg: ArchConfig) -> dict:
    """Top-level param key -> the reference's scan trip count of that stack."""
    if cfg.family in ("dense", "moe", "vlm"):
        return {"blocks": cfg.n_layers // len(cfg.layer_pattern or ("layer",))}
    if cfg.family == "ssm":
        return {"blocks": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"supers": cfg.n_layers // cfg.hybrid.attn_every}
    if cfg.family == "audio":
        return {"enc_blocks": cfg.encdec.n_encoder_layers, "dec_blocks": cfg.n_layers}
    raise ValueError(f"unknown family {cfg.family!r}")


def infer_param_specs(params: Any, cfg: ArchConfig, rules: ShardingRules) -> Any:
    """A spec per leaf of the port's param tree (leaves need ``.shape``)."""
    trips = _stack_trips(cfg)

    def spec_for(path: tuple, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if path[0] in trips:
            return _param_spec(list(path), (trips[path[0]],) + shape, cfg, rules)[1:]
        return _param_spec(list(path), shape, cfg, rules)

    return tree_map_with_path(spec_for, params)


def make_activation_constrainer(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules,
                                perf: "PerfOptions | None" = None):
    """Returns ``ac(x, kind)``: for a DTensor ``x``, ``x.redistribute`` to
    the kind's placements (the counterpart of ``with_sharding_constraint``);
    the identity for any other tensor, so the models stay mesh-agnostic."""
    perf = perf or PerfOptions()
    mesh = rules.mesh
    batch_shardable = shape.global_batch % _axsize(mesh, rules.dp) == 0
    tp_size = _axsize(mesh, rules.tp)

    def constrain(x, spec):
        if not hasattr(x, "redistribute"):
            return x
        return x.redistribute(mesh, to_placements(spec, mesh))

    queries_on_sequence = not heads_split(cfg.n_heads, rules)

    def ac(x, kind):
        if kind == "hidden_mid" and perf.light_resharding:
            return x    # one reshard point per block suffices
        if kind in ("hidden", "hidden_mid", "partial"):
            # "partial": a sub-layer output whose TP contraction just
            # finished; constraining it (rather than the residual sum)
            # turns the pending all-reduce into a reduce-scatter
            if x.ndim != 3:
                return x
            b, s, d = x.shape
            bspec = rules.dp if batch_shardable else None
            sspec = rules.tp if (s % tp_size == 0 and s > 1) else None
            return constrain(x, (bspec, sspec, None))
        if kind == "logits":
            b, s, v = x.shape
            bspec = rules.dp if batch_shardable else None
            vspec = rules.tp if v % tp_size == 0 else None
            return constrain(x, (bspec, None, vspec))
        if kind == "positions":
            # rotary positions [B, S] (M-RoPE's [3, B, S]): laid out as the
            # rotated queries' batch and sequence, so each rank makes only
            # its own cos / sin rows, as GSPMD propagates their layout back
            # from the rotated q / k
            s = x.shape[-1]
            bspec = rules.dp if batch_shardable else None
            sspec = rules.tp if (queries_on_sequence and s % tp_size == 0 and s > 1) else None
            return constrain(x, (None,) * (x.ndim - 2) + (bspec, sspec))
        if kind == "expert":
            # DISABLED in the reference after measurement: every forced
            # sharding of the MoE capacity buffer regressed 3-12x under
            # GSPMD (the global-argsort scatter hides locality)
            return x
        return x

    return ac


def _cache_prefix(cfg: ArchConfig, path: tuple) -> tuple:
    """The reference's stacked dims in front of a per-layer cache leaf."""
    if cfg.family in ("dense", "moe", "vlm"):
        return (cfg.n_layers // len(cfg.layer_pattern or ("layer",)),)
    if cfg.family == "ssm":
        return (cfg.n_layers,)
    if cfg.family == "hybrid":
        trip = cfg.n_layers // cfg.hybrid.attn_every
        return (trip, cfg.hybrid.attn_every) if path[0] == "mamba" else (trip,)
    if cfg.family == "audio":
        return (cfg.n_layers,)
    raise ValueError(f"unknown family {cfg.family!r}")


def _cache_spec(last: str, shape_: tuple, shape: ShapeConfig, rules: ShardingRules) -> Spec:
    """The reference's rule for one cache leaf, on its STACKED shape."""
    mesh = rules.mesh
    batch_ok = shape.global_batch % _axsize(mesh, rules.dp) == 0
    nd = len(shape_)
    if last == "kpos" or nd <= 2:
        return (None,) * nd
    spec: list = [None] * nd
    # the batch dim: first dim equal to global_batch among the first three
    bdim = None
    for i, s in enumerate(shape_):
        if s == shape.global_batch and i <= 2:
            bdim = i
            break
    if bdim is not None and batch_ok and shape.global_batch > 1:
        spec[bdim] = rules.dp
    elif last in ("k", "v") and nd >= 3:
        # batch==1: context parallelism, capacity over the DP axes
        cap_dim = (bdim + 1) if bdim is not None else nd - 3
        if shape_[cap_dim] % _axsize(mesh, rules.dp) == 0:
            spec[cap_dim] = rules.dp
    if last in ("k", "v"):
        kv_dim = nd - 2
        cap_dim = nd - 3
        if shape_[kv_dim] % _axsize(mesh, rules.tp) == 0:
            spec[kv_dim] = rules.tp
        elif spec[cap_dim] is None and shape_[cap_dim] % _axsize(mesh, rules.tp) == 0:
            # KV heads can't shard the TP axis: shard capacity over TP
            spec[cap_dim] = rules.tp
    if last in ("h", "S") and nd >= 2:   # mamba [.., B, nh, hs, N], rwkv [.., B, nh, hs, hs]
        if shape_[nd - 3] % _axsize(mesh, rules.tp) == 0:
            spec[nd - 3] = rules.tp
    return tuple(spec)


def cache_specs(caches: Any, cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules) -> Any:
    """A spec per leaf of the port's decode caches (``Model.init_caches``)."""
    def spec_for(path: tuple, leaf) -> Spec:
        prefix = _cache_prefix(cfg, path)
        return _cache_spec(path[-1], prefix + tuple(leaf.shape), shape, rules)[len(prefix):]

    return tree_map_with_path(spec_for, caches)


def batch_specs(batch: Any, cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules) -> Any:
    """A spec per leaf of an input batch (leaves need ``.shape``)."""
    mesh = rules.mesh
    batch_ok = shape.global_batch % _axsize(mesh, rules.dp) == 0 and shape.global_batch > 1

    def spec_for(path: tuple, leaf) -> Spec:
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        spec: list = [None] * nd
        # positions for mrope are [3, B, S]
        bdim = 1 if (nd >= 2 and leaf.shape[0] == 3 and cfg.rope_kind == "mrope"
                     and leaf.shape[1] == shape.global_batch) else 0
        if batch_ok and leaf.shape[bdim] == shape.global_batch:
            spec[bdim] = rules.dp
        return tuple(spec)

    return tree_map_with_path(spec_for, batch)


def to_placements(spec: Spec, mesh) -> list:
    """A spec -> DTensor placements, one per mesh dim: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.  A
    tuple of axes on one dim must follow the mesh's order, which is then the
    reference's major-to-minor order."""
    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return placements
