"""Training step + loop.  Counterpart of ``repro.train.loop``:
``make_train_step`` builds the step function (loss, gradients on the float32
masters, AdamW) and ``train_loop`` drives it from a data iterator, on the
card unless ``device="cpu"``."""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.compat import resolve_device
from repro_torch.models.transformer import Model, identity_ac
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .tree import tree_leaves, tree_map, tree_unflatten


def init_train_state(model: Model, gen: torch.Generator) -> dict:
    """float32 master params from ``gen`` (on its device) and zero moments."""
    params = model.init(gen, masters=True)
    return {"params": params, "opt": init_opt_state(params)}


def cast_params_for_compute(params, dtype=torch.bfloat16):
    """The reference's compute cast: every float32 leaf with ``ndim >= 2`` to
    ``dtype``, counted in the reference's layout, where each leaf of a stack
    of layers carries the stacked layer axis.  The port holds every such
    stack (``blocks``; Zamba2's ``supers``; Whisper's ``enc_blocks`` and
    ``dec_blocks``) as a top-level list of per-layer dicts, so every float32
    leaf under a top-level list is cast (matmul weights, the MoE router,
    norm scales, biases, Mamba2's and RWKV6's 1-D leaves too), and of the
    others those with ``ndim >= 2`` (embeddings, the unembedding, Whisper's
    ``dec_pos``, the shared attention's matmuls); the unstacked norms and
    biases stay float32.  This differs from serving's ``to_compute_dtype``,
    which keeps the leaves the reference reads in float32.  ``.to`` is
    differentiable, so gradients land on the float32 leaves."""
    def cast(p, min_ndim):
        return p.to(dtype) if p.dtype == torch.float32 and p.ndim >= min_ndim else p
    return {k: tree_map(lambda p: cast(p, 1 if isinstance(v, list) else 2), v)
            for k, v in params.items()}


def make_train_step(model: Model, opt_cfg: AdamWConfig, cast_params: bool = True,
                    ac=identity_ac):
    """-> ``train_step(state, batch) -> (new_state, metrics)`` with metrics
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors.  The batch's tensors
    must be on the params' device.  ``ac`` is the models' activation-sharding
    hook (the dry-run's)."""
    def train_step(state: dict, batch: dict):
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        p = cast_params_for_compute(params) if cast_params else params
        loss = model.loss(p, batch, ac=ac)
        # a leaf the loss does not use (a vlm's token embedding, when the
        # batch gives ``embeds``) gets a zero gradient, as under JAX's ``grad``
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                    materialize_grads=True)
        new_params, opt, metrics = adamw_update(opt_cfg, state["params"],
                                                tree_unflatten(params, grads), state["opt"])
        metrics = dict(metrics, loss=loss.detach())
        return {"params": new_params, "opt": opt}, metrics

    return train_step


def train_loop(model: Model, data_iter, *, steps: int, opt_cfg: AdamWConfig | None = None,
               gen: torch.Generator | None = None, log_every: int = 10,
               callback: Callable[[int, dict], None] | None = None,
               device="cuda") -> tuple[dict, list]:
    """Init from ``gen`` (a generator on ``device``; seed 0 by default) and
    train ``steps`` steps.  History entries (every ``log_every`` steps and
    the last) hold the metrics as floats plus ``step`` and ``wall_s``."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig()
    gen = gen if gen is not None else torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(model, gen)
    step_fn = make_train_step(model, opt_cfg)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = {k: v.to(dev) for k, v in next(data_iter).items()}
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(i, m)
    return state, history
