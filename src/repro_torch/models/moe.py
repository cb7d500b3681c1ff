"""Mixture-of-Experts with sort-based capacity dispatch.  Counterpart of
``repro.models.moe`` (``init_moe``, ``capacity_for``, ``apply_moe``).

Dispatch is gather/scatter-based: the K expert choices of every token are
sorted by expert (a STABLE sort, as ``jnp.argsort`` is), each keeps its
position within its expert's group, and positions at or past the capacity C
are dropped.  Expert FFNs run as one batched product over the [E, C, D]
capacity buffer, so the FLOPs are the active experts'.  ``expert_sharding``
(the reference's hook, a function of a tensor) constrains the capacity
buffer, the gated hidden and the expert outputs, where the reference does;
the dry-run passes its ``"expert"`` activation kind, which is the identity
as in the reference.

The route / pack / combine steps are shared with ``core/latte_moe.py``.
Traps of the translation, each handled where it arises:

* ``jnp.argsort`` is stable: ``torch.argsort(..., stable=True)``.
* ``.at[sorted_e, pos_c].set(..., mode="drop")`` sends dropped choices to
  the out-of-range slot C.  The port scatters into an [E, C+1, D] buffer and
  cuts slot C off, so a dropped token never overwrites slot C-1.
* ``y[sorted_e, pos_c]`` clamps the out-of-range slot C to C-1 in JAX; the
  port clamps too, and the mask ``keep`` zeroes those rows in both.
* ``.at[token_of].add`` sums each token's K contributions.  ``index_add_``
  would compute it, but on the card it adds with atomics in an order that
  changes from run to run; the port scatters the contributions back to
  their (token, k) slot through the permutation ``order`` and sums over k,
  which is deterministic on every device.
* JAX's ``lax.top_k`` and ``torch.topk`` may order tied probabilities
  differently.  Router probabilities from random floats are tied with
  negligible probability, so the tests compare at float32 tolerances.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from .layers import normal


def init_moe(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """router [D, E], wg/wu [E, D, F], wd [E, F, D] in the param dtype, with
    the reference's scales (1/sqrt(D) in, 1/sqrt(F) out)."""
    assert cfg.moe is not None
    D, E, Fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    pd = torch_dtype(cfg.param_dtype)
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fe)
    return {"router": normal(gen, (D, E), s_in).to(pd),
            "wg": normal(gen, (E, D, Fe), s_in).to(pd),
            "wu": normal(gen, (E, D, Fe), s_in).to(pd),
            "wd": normal(gen, (E, Fe, D), s_out).to(pd)}


def capacity_for(cfg: ArchConfig, n_tokens: int) -> int:
    m = cfg.moe
    cap = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    # large capacities round to 128 (the reference shards the capacity axis)
    mult = 128 if cap >= 128 else 8
    return max(8, int(math.ceil(cap / mult)) * mult)


def route(cfg: ArchConfig, router: torch.Tensor, xf: torch.Tensor):
    """Top-k routing of tokens xf [T, D] -> (weights [T, K] f32, renormalised
    over the K choices; experts [T, K]; Switch-style aux loss)."""
    m = cfg.moe
    E, K, T = m.n_experts, m.top_k, xf.shape[0]
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    topk_p, topk_e = torch.topk(probs, K, dim=-1)
    topk_p = topk_p / topk_p.sum(-1, keepdim=True)
    # the reference's scatter-add of ones (exact integer counts in float32);
    # bincount's output size depends on the data, which a fake tensor lacks
    flat = topk_e.reshape(-1)
    assign = probs.new_zeros(E).scatter_add(0, flat, torch.ones_like(flat, dtype=probs.dtype))
    aux = E * torch.sum(probs.mean(0) * (assign / (T * K))) * m.router_aux_weight
    return topk_p, topk_e, aux


def assign_slots(topk_e: torch.Tensor, n_experts: int, capacity: int) -> dict:
    """Each (token, k) choice's place in its expert's capacity buffer."""
    T, K = topk_e.shape
    flat_e = topk_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype, device=sorted_e.device))
    pos = torch.arange(T * K, device=flat_e.device) - group_start[sorted_e]
    keep = pos < capacity
    return {"order": order, "sorted_e": sorted_e, "keep": keep,
            "pos_c": torch.where(keep, pos, capacity),      # capacity == the drop slot
            "token_of": order // K}


def dispatch(xf: torch.Tensor, slots: dict, n_experts: int, capacity: int) -> torch.Tensor:
    """Tokens xf [T, D] -> capacity buffer [E, C, D] (unfilled slots zero)."""
    buf = xf.new_zeros((n_experts, capacity + 1, xf.shape[1]))
    buf[slots["sorted_e"], slots["pos_c"]] = xf[slots["token_of"]]
    return buf[:, :capacity]


def _unconstrained(t: torch.Tensor) -> torch.Tensor:
    return t


def expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, expert_sharding=_unconstrained) -> torch.Tensor:
    """SiLU-gated FFN of each expert over its buffer rows: [E, C, D] -> [E, C, D]."""
    cd = buf.dtype
    h = torch.bmm(buf, wg.to(cd))
    u = torch.bmm(buf, wu.to(cd))
    return expert_sharding(torch.bmm(expert_sharding(F.silu(h) * u), wd.to(cd)))


def combine(y: torch.Tensor, slots: dict, topk_p: torch.Tensor) -> torch.Tensor:
    """Expert outputs y [E, C, D] -> tokens [T, D]: each token's K outputs,
    weighted by its routing weights and summed (dropped choices add 0)."""
    T, K = topk_p.shape
    cd = y.dtype
    pos = slots["pos_c"].clamp(max=y.shape[1] - 1)
    contrib = y[slots["sorted_e"], pos] * slots["keep"][:, None].to(cd)
    weights = topk_p.reshape(-1)[slots["order"]].to(cd)
    per_choice = torch.empty_like(contrib)
    per_choice[slots["order"]] = contrib * weights[:, None]      # back to (token, k) order
    return per_choice.view(T, K, -1).sum(1)


def apply_moe(cfg: ArchConfig, p: dict, x: torch.Tensor, expert_sharding=_unconstrained):
    """x [B, S, D] -> (output [B, S, D], router aux loss scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    C = capacity_for(cfg, B * S)
    xf = x.reshape(B * S, D)
    topk_p, topk_e, aux = route(cfg, p["router"], xf)
    slots = assign_slots(topk_e, m.n_experts, C)
    buf = expert_sharding(dispatch(xf, slots, m.n_experts, C))
    y = expert_ffn(buf, p["wg"], p["wu"], p["wd"], expert_sharding)
    return combine(y, slots, topk_p).reshape(B, S, D), aux
