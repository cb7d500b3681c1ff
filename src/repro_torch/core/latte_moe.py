"""Hierarchical (latte) MoE dispatch over ranks emulated on one device, with
an explicit expert all-to-all.  Counterpart of ``repro.core.latte_moe``.

The reference runs under ``shard_map`` over the expert-parallel axis:

  1. tokens arrive sharded on the batch;
  2. LOCAL top-k + LOCAL capacity pack (the sort never crosses devices);
  3. expert all-to-all (``pairwise_all_to_all`` unless another is given);
  4. local expert FFNs on the experts each device owns;
  5. all-to-all back + local weighted combine; aux loss ``pmean``-ed.

The port keeps the same steps over a :class:`~repro_torch.core.collectives.RankGroup`:
the route and pack of step 2 and the combine of step 5 run as a loop over
ranks, each on its own tokens; each all-to-all is ONE call over all ranks
(one launch of B4 on the card); the local expert FFNs of all ranks run as
one batched product, since rank r's experts are the global experts
``[r * e_local, (r + 1) * e_local)``.  Requires ``n_experts % n == 0``.

With one rank per process (a ``core.procgroup.ProcessRanks``),
:func:`latte_moe_rank` is the reference's per-shard body itself: this
rank's tokens and experts, its two all-to-alls per rank (B4 ``b2b`` on the
card, gloo on the CPU), and the aux loss averaged over ranks as the mean of
the one-shot all-gather of every rank's scalar (bit-equal to the emulated
layer's ``aux.mean()``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_mod
from . import collectives as coll
from .procgroup import ProcessRanks


def local_capacity(cfg: ArchConfig, t_local: int) -> int:
    """Capacity per expert for one rank's tokens (floor 4, no rounding, unlike
    ``moe.capacity_for``)."""
    m = cfg.moe
    return max(4, int(math.ceil(t_local * m.top_k / m.n_experts * m.capacity_factor)))


def shard_experts(p: dict, n: int) -> dict:
    """Full MoE params -> the router (replicated) and rank-stacked expert
    weights [n, e_local, ...]: rank r owns experts [r * e_local, (r+1) * e_local)."""
    return {"router": p["router"],
            **{k: p[k].reshape(n, p[k].shape[0] // n, *p[k].shape[1:])
               for k in ("wg", "wu", "wd")}}


def expert_slice(p: dict, ranks: ProcessRanks) -> dict:
    """Full MoE params -> this rank's: the router (replicated) and its
    experts [r * e_local, (r + 1) * e_local) (rank r's row of
    :func:`shard_experts`)."""
    e_local = p["wg"].shape[0] // ranks.n
    lo = ranks.rank * e_local
    return {"router": p["router"], **{k: p[k][lo:lo + e_local] for k in ("wg", "wu", "wd")}}


def latte_moe_rank(cfg: ArchConfig, p: dict, xf: torch.Tensor, ranks: ProcessRanks,
                   *, all_to_all=None):
    """One rank's body (the reference's ``latte_moe_local`` inside
    ``shard_map``).  xf [T_local, D]: this rank's tokens; ``p`` from
    :func:`expert_slice`.  Returns ([T_local, D], this rank's aux)."""
    a2a = all_to_all or coll.pairwise_all_to_all
    E = cfg.moe.n_experts
    T, D = xf.shape
    ranks.check(xf)
    C = local_capacity(cfg, T)
    n = ranks.n
    e_local = E // n

    topk_p, topk_e, aux = moe_mod.route(cfg, p["router"], xf)   # LOCAL route + pack
    slots = moe_mod.assign_slots(topk_e, E, C)
    send = moe_mod.dispatch(xf, slots, E, C).reshape(n, e_local, C, D)
    recv = a2a(send, ranks)                    # [src, e_local, C, D]
    buf = recv.transpose(0, 1).reshape(e_local, n * C, D)
    y = moe_mod.expert_ffn(buf, p["wg"], p["wu"], p["wd"])
    back = y.reshape(e_local, n, C, D).transpose(0, 1).contiguous()
    mine = a2a(back, ranks).reshape(E, C, D)  # this rank's tokens' outputs
    return moe_mod.combine(mine, slots, topk_p), aux


def latte_moe_local(cfg: ArchConfig, p: dict, xs: torch.Tensor, ranks: coll.RankGroup,
                    *, all_to_all=None):
    """Every rank's body at once.  xs [n, T_local, D]: rank r's tokens;
    ``p`` from :func:`shard_experts`.  Returns ([n, T_local, D], aux [n])."""
    a2a = all_to_all or coll.pairwise_all_to_all
    m = cfg.moe
    E = m.n_experts
    n, T, D = xs.shape
    ranks.check(xs)
    C = local_capacity(cfg, T)
    e_local = E // n

    routes, sends, aux = [], [], []
    for r in range(n):                         # LOCAL route + pack, rank by rank
        topk_p, topk_e, a = moe_mod.route(cfg, p["router"], xs[r])
        slots = moe_mod.assign_slots(topk_e, E, C)
        sends.append(moe_mod.dispatch(xs[r], slots, E, C))
        routes.append((topk_p, slots))
        aux.append(a)

    # expert all-to-all: send[src, dst] is src's buffer of dst's experts
    send = torch.stack(sends).reshape(n, n, e_local, C, D)
    recv = a2a(send, ranks)                    # [owner, src, e_local, C, D]

    # every rank's local expert FFNs, batched: expert (owner, l) is global
    # expert owner * e_local + l, and its rows are (src, slot)
    buf = recv.transpose(1, 2).reshape(E, n * C, D)
    y = moe_mod.expert_ffn(buf, p["wg"].reshape(E, D, -1), p["wu"].reshape(E, D, -1),
                           p["wd"].reshape(E, -1, D))

    # return trip: back[owner, dst] holds dst's tokens' outputs of owner's experts
    back = y.reshape(n, e_local, n, C, D).transpose(1, 2).contiguous()
    mine = a2a(back, ranks).reshape(n, E, C, D)
    out = torch.stack([moe_mod.combine(mine[r], slots, topk_p)
                       for r, (topk_p, slots) in enumerate(routes)])
    return out, torch.stack(aux)


def make_latte_moe(cfg: ArchConfig, ranks: coll.RankGroup | ProcessRanks, *, all_to_all=None):
    """Returns fn(params, x [B, S, D]) -> (out [B, S, D], aux) running the
    hierarchical dispatch over ``ranks``: tokens sharded on the batch,
    expert weights on the expert dim.  ``params`` are the full MoE params
    (``init_moe`` or the bridge); ``all_to_all(xs, ranks)`` replaces the
    pairwise all-to-all.  Over processes (``ProcessRanks``): fn(params,
    x_local [b, S, D]) -> (out_local [b, S, D], aux), x_local this rank's
    tokens, aux the mean over ranks (the reference's ``pmean``)."""
    assert cfg.moe and cfg.moe.n_experts % ranks.n == 0

    if isinstance(ranks, ProcessRanks):
        def fn_rank(p, x):
            b, S, D = x.shape
            out, aux = latte_moe_rank(cfg, expert_slice(p, ranks), x.reshape(b * S, D), ranks,
                                      all_to_all=all_to_all)
            return out.reshape(b, S, D), coll.reference_all_gather(aux, ranks).mean()

        return fn_rank

    def fn(p, x):
        B, S, D = x.shape
        if B % ranks.n:
            raise ValueError(f"batch {B} does not split over {ranks.n} ranks")
        xs = x.reshape(ranks.n, (B // ranks.n) * S, D)
        out, aux = latte_moe_local(cfg, shard_experts(p, ranks.n), xs, ranks,
                                   all_to_all=all_to_all)
        return out.reshape(B, S, D), aux.mean()    # pmean of the aux loss

    return fn
