"""Weight bridge: the reference's params (numpy) -> the port's params.

The input is ``jax.tree.map(np.asarray, params)`` of the JAX model: a nested
dict whose ``blocks`` is a tuple of ``per_unit`` dicts (one per entry of the
config's layer pattern), each leaf stacked on a leading axis of
``n_layers // per_unit`` scan steps.  Layer ``u * per_unit + i`` of the
model is scan step ``u`` of unit ``i``.

No weight is transposed: the port keeps the reference's ``x @ w`` layout,
``[in, out]``:

* ``embed``             [V, D]          (tied: the unembedding is ``embed.T``)
* ``unembed``           [D, V]          (untied configs only)
* ``attn.wq``           [D, H * hd]
* ``attn.wk``/``wv``    [D, KV * hd]
* ``attn.wo``           [H * hd, D]
* ``attn.bq``/``bk``/``bv``  [H * hd] / [KV * hd]
* ``mlp.wg``/``wu``     [D, F],  ``mlp.wd`` [F, D]
* ``ln1``/``ln2``/``final_norm``  ``scale`` [D] (+ ``bias`` for layernorm)
* ``moe.router`` [D, E], ``moe.wg``/``wu`` [E, D, F], ``moe.wd`` [E, F, D]
  (moe family, in place of ``mlp``)

MoE layer params (``moe_params_from_numpy``, the dict of ``init_moe``):

* ``router``            [D, E]
* ``wg``/``wu``         [E, D, F],  ``wd`` [E, F, D]

held as they are; ``core.latte_moe.shard_experts`` gives rank r the experts
``[r * e_local, (r + 1) * e_local)``, as ``P(axis, None, None)`` does in
the reference.

The only reshaping is unstacking the layer axis into the port's per-layer
list.  Matmul weights go to the compute dtype, norm params and the router to
float32 (``transformer.to_compute_dtype``).  This module imports neither JAX nor the
JAX package; the caller does the ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import to_compute_dtype


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _layer(tree, step: int, device):
    if isinstance(tree, dict):
        return {k: _layer(v, step, device) for k, v in tree.items()}
    return _tensor(tree[step], device)


def params_from_numpy(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """Reference params (nested dict of numpy arrays) -> port params on
    ``device`` for the dense and MoE decoder families."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"weight bridge covers the dense and moe families, got {cfg.family!r}")
    dev = resolve_device(device)
    units = tree["blocks"]
    per_unit = len(units)
    trip = cfg.n_layers // per_unit
    blocks = [_layer(units[i], u, dev) for u in range(trip) for i in range(per_unit)]
    params = {"embed": _tensor(tree["embed"], dev), "blocks": blocks,
              "final_norm": {k: _tensor(v, dev) for k, v in tree["final_norm"].items()}}
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], dev)
    return to_compute_dtype(cfg, params)


def moe_params_from_numpy(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """Reference MoE layer params (``repro.models.moe.init_moe``, as numpy)
    -> port params on ``device``, float32, no transpose."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE layer")
    dev = resolve_device(device)
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    want = {"router": (D, E), "wg": (E, D, F), "wu": (E, D, F), "wd": (E, F, D)}
    out = {k: _tensor(tree[k], dev) for k in want}
    for k, shape in want.items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"{k}: expected {shape}, got {tuple(out[k].shape)}")
    return out
