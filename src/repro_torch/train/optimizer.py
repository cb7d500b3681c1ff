"""Hand-rolled AdamW (+ global-norm clipping, cosine LR schedule).
Counterpart of ``repro.train.optimizer``, over the port's param trees.

The optimizer state is a plain tree ``{"m", "v", "step"}``: ``m`` and ``v``
float32 like the master params, ``step`` a 0-d int32 tensor, which is the
reference's layout and so the checkpoint's.  ``torch.optim.AdamW`` is not
used: its state is per parameter with a float step, and it decays the
weights before the Adam step.  The update runs as ``torch._foreach_*`` ops,
a few launches over all leaves instead of ~10 per leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio * lr`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps) /
            max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Any) -> dict:
    device = tree_leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  On the card one
    ``_foreach_norm`` launch; on the CPU a sum per leaf, because the CPU's
    ``vector_norm`` (which ``_foreach_norm`` calls there) accumulates float32
    serially, 1e-5 off at a million elements."""
    leaves = [leaf.float() for leaf in tree_leaves(tree)]
    if leaves[0].is_cuda:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))
    return torch.sqrt(sum(torch.sum(leaf * leaf) for leaf in leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, opt_state: dict):
    """Returns (new_params, new_opt_state, metrics), as the reference does:
    gradients clipped by ``min(1, clip / (norm + 1e-9))`` with the unclipped
    norm reported; bias corrections and the LR at the incremented step;
    decoupled decay ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)`` on
    every leaf, 1-D ones included."""
    step = opt_state["step"] + 1
    p = tree_leaves(params)
    g = tree_leaves(grads)
    gnorm = global_norm(g)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    g = torch._foreach_mul(g, scale)

    b1, b2 = cfg.beta1, cfg.beta2
    m = torch._foreach_mul(tree_leaves(opt_state["m"]), b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    v = torch._foreach_mul(tree_leaves(opt_state["v"]), b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
    del g
    sf = step.float()
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf
    lr = lr_at(cfg, step)

    upd = torch._foreach_div(m, c1)                 # mhat
    denom = torch._foreach_div(v, c2)               # vhat
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_div_(upd, denom)
    del denom
    torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    new_p = torch._foreach_sub(p, upd)
    opt = {"m": tree_unflatten(opt_state["m"], m), "v": tree_unflatten(opt_state["v"], v),
           "step": step}
    return tree_unflatten(params, new_p), opt, {"grad_norm": gnorm, "lr": lr}
