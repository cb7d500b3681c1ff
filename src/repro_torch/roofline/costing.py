"""Per-device cost accounting of a traced step.

Counterpart of ``repro.roofline.costing``.  The step is traced by the
dry-run (``launch.dryrun.build_step``) on fake tensors under
``FakeTensorMode``, its inputs DTensors laid out by the sharding rules, so
nothing is allocated and nothing runs on a device.  ``LocalCostMode``
counts, for every aten op that runs on a local shard:

* FLOPs, by ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` applies; matmuls, convolutions and attention only);
* bytes: the op's input plus output bytes.  Eager torch runs every op
  unfused, so this is an upper bound on HBM traffic and not XLA's fused
  "bytes accessed"; views, factories and collectives add none;
* wire bytes per collective kind, by ``wire.CollectiveRecorder``.

All three are PER-DEVICE.  ``FlopCounterMode`` entered around DTensor code
counts GLOBAL figures: it sees each op on the DTensors (global shapes).  The
port's modes instead return ``NotImplemented`` for an op on DTensors, so
DTensor runs it and the modes count the local ops DTensor runs on this
rank's shards, after any redistribution.  DTensor also runs each op once on
global-shaped fake tensors to infer output metadata (sharding propagation);
``LocalCostMode`` skips those.  On a (1, 1) mesh per-device equals global.

Depth differencing is kept from the reference: depth-cut variants of each
model (1 scan unit and 2 per stack) are traced and

    C(k units) = C_base + k * C_body    =>    C_body = C(2) - C(1)
    Total      = C_base + trip * C_body (per stack)

XLA counts a scan body once, which is why the reference needs it.  Eager
torch counts every layer, so the port could trace full depth; it differences
anyway, so a costing's time stays bounded whatever the depth and its terms
compare with the reference's one by one.  Attention is traced unchunked
(``dense_attention_for_costing``) and the rwkv / mamba time scans run ONE
step (``launch.dryrun.traced_time_steps(1)``), as the reference's scan body; the
other T - 1 steps are added analytically (``_ssm_correction``), with the
reference's arithmetic.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from .wire import on_dtensors, tensor_bytes


@dataclasses.dataclass
class CostVector:
    flops: float = 0.0
    bytes: float = 0.0
    wire: dict | None = None

    def __post_init__(self):
        self.wire = dict(self.wire or {})

    @property
    def wire_total(self) -> float:
        return sum(self.wire.values())

    def __sub__(self, o: "CostVector") -> "CostVector":
        keys = set(self.wire) | set(o.wire)
        return CostVector(self.flops - o.flops, self.bytes - o.bytes,
                          {k: self.wire.get(k, 0) - o.wire.get(k, 0) for k in keys})

    def __add__(self, o: "CostVector") -> "CostVector":
        keys = set(self.wire) | set(o.wire)
        return CostVector(self.flops + o.flops, self.bytes + o.bytes,
                          {k: self.wire.get(k, 0) + o.wire.get(k, 0) for k in keys})

    def scaled(self, f: float) -> "CostVector":
        return CostVector(self.flops * f, self.bytes * f,
                          {k: v * f for k, v in self.wire.items()})

    def clamped(self) -> "CostVector":
        return CostVector(max(self.flops, 0.0), max(self.bytes, 0.0),
                          {k: max(v, 0.0) for k, v in self.wire.items()})


_in_propagation = threading.local()


@contextlib.contextmanager
def _marking_sharding_propagation():
    """Flag, for the duration, DTensor's runs of an op on global-shaped fake
    tensors (the metadata inference of its sharding propagation)."""
    name = "_propagate_tensor_meta_non_cached"
    original = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        _in_propagation.on = True
        try:
            return original(self, *args, **kwargs)
        finally:
            _in_propagation.on = False

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)


def in_sharding_propagation() -> bool:
    """Whether DTensor is running an op on global-shaped fake tensors now
    (under ``_marking_sharding_propagation``)."""
    return getattr(_in_propagation, "on", False)


def _moves_no_bytes(func) -> bool:
    return (func.is_view or func.namespace in ("_c10d_functional", "_dtensor", "c10d", "prim")
            or func._overloadpacket.__name__.startswith(("empty", "new_empty"))
            or func._overloadpacket.__name__ in ("detach", "lift_fresh", "alias"))


class LocalCostMode(TorchDispatchMode):
    """FLOPs, bytes and op count of the local ops of a traced step (see the
    module docstring); enter it inside ``_marking_sharding_propagation``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if in_sharding_propagation():
            return out
        self.n_ops += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not _moves_no_bytes(func):
            self.bytes += (sum(tensor_bytes(a) for a in args)
                           + sum(tensor_bytes(v) for v in kwargs.values()) + tensor_bytes(out))
        return out


def _scan_axes(cfg: ArchConfig) -> list[tuple[str, int, Callable[[ArchConfig, int], ArchConfig]]]:
    """(name, full_trip, cfg_builder(k_units)) for every scan stack."""
    axes = []
    per_unit = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    if cfg.hybrid:
        per_unit = cfg.hybrid.attn_every
    trip = cfg.n_layers // per_unit

    def set_layers(c: ArchConfig, k: int) -> ArchConfig:
        return dataclasses.replace(c, n_layers=k * per_unit)

    axes.append(("layers", trip, set_layers))
    if cfg.encdec:
        def set_enc(c: ArchConfig, k: int) -> ArchConfig:
            return dataclasses.replace(
                c, encdec=dataclasses.replace(c.encdec, n_encoder_layers=k))
        axes.append(("enc", cfg.encdec.n_encoder_layers, set_enc))
    return axes


def _measure(arch_id: str, shape_id: str, mesh, cfg: ArchConfig, perf=None, *,
             shape: ShapeConfig | None = None, device="cuda") -> CostVector:
    """Per-device cost of one traced step of ``cfg`` (dense attention, one
    time-scan step) on ``mesh``, which needs its fake process group."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models.attention import dense_attention_for_costing

    with dense_attention_for_costing():
        traced = trace_step(arch_id, shape_id, mesh, cfg=cfg, shape=shape, perf=perf,
                            device=device, time_steps=1)
    if traced.skip_reason:
        raise RuntimeError(f"skipped: {traced.skip_reason}")
    return CostVector(traced.flops, traced.bytes, traced.wire)


def _ssm_correction(cfg: ArchConfig, shape, dp_size: int) -> CostVector:
    """Analytic correction for the T - 1 time-scan steps not traced (per
    device)."""
    if shape.mode == "decode" or not cfg.ssm:
        return CostVector()
    T = shape.seq_len
    b_loc = max(shape.global_batch // dp_size, 1)
    if cfg.ssm.kind == "rwkv6":
        hs = cfg.ssm.head_size
        step_flops = 6.0 * b_loc * cfg.d_model * hs
        state_bytes = 4.0 * b_loc * cfg.d_model * hs      # f32 S matrix
        n_scans = cfg.n_layers
    else:  # mamba2
        d_in = cfg.ssm.expand * cfg.d_model
        N = cfg.ssm.state_size
        step_flops = 7.0 * b_loc * d_in * N
        state_bytes = 4.0 * b_loc * d_in * N
        n_scans = cfg.n_layers
    per_layer = CostVector(step_flops, 3.0 * state_bytes, {})
    return per_layer.scaled((T - 1) * n_scans)


def total_cost(arch_id: str, shape_id: str, mesh, *, dp_size: int, perf=None,
               cfg: ArchConfig | None = None, shape: ShapeConfig | None = None,
               device="cuda") -> dict:
    """Per-device totals with every layer scaled from the depth-cut traces.
    Returns a dict with CostVector 'total' plus the measured points.
    ``cfg`` and ``shape`` override the registered ones (a step's own)."""
    cfg = cfg or get_config(arch_id)
    shape = shape or get_shape(shape_id)
    axes = _scan_axes(cfg)

    def measure(c):
        return _measure(arch_id, shape_id, mesh, c, perf, shape=shape, device=device)

    base_cfg = cfg
    for name, trip, build in axes:
        base_cfg = build(base_cfg, 1)
    c0 = measure(base_cfg)

    total = c0
    bodies = {}
    for i, (name, trip, build) in enumerate(axes):
        cfg_i = base_cfg
        for j, (n2, t2, b2) in enumerate(axes):
            cfg_i = b2(cfg_i, 2 if j == i else 1)
        ci = measure(cfg_i)
        body = (ci - c0).clamped()
        bodies[name] = body
        total = total + body.scaled(trip - 1)

    corr = _ssm_correction(cfg, shape, dp_size)
    total = total + corr
    return {
        "total": total,
        "base": c0,
        "bodies": bodies,
        "ssm_correction": corr,
        "trips": {name: trip for name, trip, _ in axes},
    }
