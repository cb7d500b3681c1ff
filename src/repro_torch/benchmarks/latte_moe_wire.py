"""Per-layer collective wire bytes of GSPMD-transparent MoE dispatch vs the
hierarchical latte dispatch (local pack + explicit expert all-to-all) on
the production 16x16 mesh, olmoe-1b-7b geometry, forward and backward of
one MoE layer.  Counterpart of ``benchmarks/latte_moe_wire.py``.

Both sides are counted on fake tensors of ``--device``'s type; nothing
moves and no time is taken:

* GSPMD-transparent: ``models.moe.apply_moe`` on DTensors laid out as the
  reference's ``p_sh`` / ``x_sh`` over a fake process group of the mesh's
  size, traced by the dry-run (``launch.dryrun.tracing``: DTensor's plan,
  resharded where GSPMD's differs, collectives recorded per device).
* latte: ``core.latte_moe.latte_moe_local`` on one 'model' group of ranks
  (every group does the same), its all-to-alls counted from the shapes its
  ``all_to_all`` hook sees by ``roofline.wire``'s all-to-all rule, forward
  and backward; plus the all-reduces that the reference's ``shard_map``
  transpose adds for the gradients of weights it replicates (the router
  over the whole mesh, the experts over 'data').

    PYTHONPATH=src python -m repro_torch.benchmarks.latte_moe_wire [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import collectives as coll
from repro_torch.core.latte_moe import latte_moe_local, shard_experts
from repro_torch.launch.dryrun import _distribute, tracing
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.roofline.wire import CollectiveOp, wire_bytes_by_kind

ARCH = "olmoe-1b-7b"
MESH, BATCH, SEQ = (16, 16), 256, 4096       # the reference's shapes
# the reference's p_sh / x_sh
P_SPECS = {"router": (None, None), "wg": ("model", "data", None),
           "wu": ("model", "data", None), "wd": ("model", None, "data")}
X_SPEC = ("data", "model", None)


def gspmd_wire(cfg, mesh_shape, batch: int, seq: int, device) -> tuple[dict, dict]:
    """(wire bytes per device by kind, ops run replicated) of ``apply_moe``'s
    forward and backward, the loss ``sum(out) + aux``."""
    dev = resolve_device(device)
    with fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
        rec, replicated = _traced_moe(cfg, mesh, batch, seq, dev)
    return wire_bytes_by_kind(rec.ops), replicated


def _traced_moe(cfg, mesh, batch: int, seq: int, dev):
    with FakeTensorMode(), implicit_replication():
        p = moe_mod.init_moe(cfg, torch.Generator(device=dev).manual_seed(0))
        p = {k: _distribute(v, P_SPECS[k], mesh).requires_grad_() for k, v in p.items()}
        x = torch.empty(batch, seq, cfg.d_model, dtype=torch.bfloat16, device=dev)
        x = _distribute(x, X_SPEC, mesh).requires_grad_()
        with tracing() as (rec, _, reshard):
            out, aux = moe_mod.apply_moe(cfg, p, x)
            loss = out.float().sum() + aux
            torch.autograd.grad(loss, [*p.values(), x])
    return rec, reshard.replicated_ops


class _CountedAllToAll(torch.autograd.Function):
    """The all-to-all of rank-stacked ``xs`` [n, n, ...] (``out[i, j] =
    xs[j, i]``), its per-rank bytes appended to ``ops``; its gradient is the
    same all-to-all, counted too."""

    @staticmethod
    def forward(ctx, xs, ops):
        ctx.ops = ops
        return _all_to_all(xs, ops)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.ops), None


def _all_to_all(xs: torch.Tensor, ops: list) -> torch.Tensor:
    per_rank = xs[0].numel() * xs.element_size()
    ops.append(CollectiveOp("all-to-all", per_rank, per_rank))
    return xs.transpose(0, 1).contiguous()


def latte_wire(cfg, mesh_shape, batch: int, seq: int, device) -> dict:
    """Wire bytes per device by kind of ``latte_moe_local``'s forward and
    backward on one 'model' group, with the reference's weight-gradient
    all-reduces."""
    dp, tp = mesh_shape
    dev = resolve_device(device)
    ops: list[CollectiveOp] = []
    with FakeTensorMode():
        ranks = coll.make_ranks(tp, dev)
        p = moe_mod.init_moe(cfg, torch.Generator(device=dev).manual_seed(0))
        p = {k: v.requires_grad_() for k, v in p.items()}
        xs = torch.empty(tp, (batch // dp) * (seq // tp), cfg.d_model, dtype=torch.bfloat16,
                         device=dev, requires_grad=True)
        out, aux = latte_moe_local(cfg, shard_experts(p, tp), xs, ranks,
                                   all_to_all=lambda t, _: _CountedAllToAll.apply(t, ops))
        loss = out.float().sum() + aux.mean()
        torch.autograd.grad(loss, [*p.values(), xs])
        for k, v in p.items():
            # the router is replicated on every device, the experts over 'data'
            replicas = dp * tp if k == "router" else dp
            local = v.numel() * v.element_size() // (1 if k == "router" else tp)
            if replicas > 1:
                ops.append(CollectiveOp("all-reduce", local, local))
    return wire_bytes_by_kind(ops)


def measure(mesh_shape=MESH, batch: int = BATCH, seq: int = SEQ, device="cuda") -> dict:
    cfg = get_config(ARCH)
    gspmd, replicated = gspmd_wire(cfg, mesh_shape, batch, seq, device)
    if replicated:
        raise AssertionError(f"ops ran replicated in the GSPMD-transparent trace: {replicated}")
    latte = latte_wire(cfg, mesh_shape, batch, seq, device)
    return {"gspmd": gspmd, "latte": latte,
            "ratio": sum(gspmd.values()) / max(sum(latte.values()), 1e-9)}


def run(verbose: bool = True, device="cuda"):
    res = measure(device=device)
    wb_gspmd, wb_latte, ratio = (sum(res["gspmd"].values()), sum(res["latte"].values()),
                                 res["ratio"])
    if verbose:
        print(f"GSPMD dispatch: {wb_gspmd/1e9:7.1f} GB/device  {res['gspmd']}")
        print(f"latte dispatch: {wb_latte/1e9:7.1f} GB/device  {res['latte']}")
        print(f"wire reduction: {ratio:.1f}x")
    if not ratio > 10:
        raise AssertionError(f"expected >10x reduction, got {ratio:.1f}x")
    return ratio


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
