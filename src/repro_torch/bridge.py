"""Weight bridge between the reference's params (numpy) and the port's.

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
list.  ``params_from_numpy`` (serving) casts matmul weights to the compute
dtype, norm params and the router to float32
(``transformer.to_compute_dtype``).  The train state
(``train_state_from_numpy``: ``{"params", "opt": {"m", "v", "step"}}``)
keeps every leaf float32, with no compute cast.  ``params_to_numpy`` and
``train_state_to_numpy`` restack the per-layer list into the reference's
per-unit stacked layout, so the result has the reference's leaves, shapes
and ``jax.tree_util`` order (``blocks`` a tuple).  This module imports
neither JAX nor the JAX package; the caller does the ``np.asarray``.
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


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"weight bridge covers the dense and moe families, got {cfg.family!r}")


def _unstack(cfg: ArchConfig, tree: dict, dev: torch.device) -> dict:
    """Reference params -> port params, every leaf float32."""
    units = tree["blocks"]
    per_unit = len(units)
    trip = cfg.n_layers // per_unit
    blocks = [_layer(units[i], u, dev) for u in range(trip) for i in range(per_unit)]
    params = {"embed": _tensor(tree["embed"], dev), "blocks": blocks,
              "final_norm": {k: _tensor(v, dev) for k, v in tree["final_norm"].items()}}
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], dev)
    return params


def params_from_numpy(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """Reference params (nested dict of numpy arrays) -> port params on
    ``device`` for the dense and MoE decoder families, in the compute dtype."""
    _check_family(cfg)
    return to_compute_dtype(cfg, _unstack(cfg, tree, resolve_device(device)))


def train_state_from_numpy(cfg: ArchConfig, state: dict, device="cuda") -> dict:
    """Reference train state ``{"params", "opt": {"m", "v", "step"}}`` as
    numpy -> the port's on ``device``: float32 masters and moments, ``step``
    a 0-d int32 tensor."""
    _check_family(cfg)
    dev = resolve_device(device)
    opt = state["opt"]
    return {"params": _unstack(cfg, state["params"], dev),
            "opt": {"m": _unstack(cfg, opt["m"], dev), "v": _unstack(cfg, opt["v"], dev),
                    "step": torch.tensor(int(opt["step"]), dtype=torch.int32, device=dev)}}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack([_numpy(t) for t in layers])


def params_to_numpy(cfg: ArchConfig, params: dict) -> dict:
    """Port params (or a tree of their shape, such as gradients or Adam
    moments) -> the reference's layout as numpy: ``blocks`` a tuple of
    ``per_unit`` dicts, each leaf stacked over the ``n_layers // per_unit``
    scan steps (layer ``u * per_unit + i`` -> unit ``i``, step ``u``)."""
    _check_family(cfg)
    per_unit = len(cfg.layer_pattern or ("layer",))
    blocks = params["blocks"]
    out = {k: ({n: _numpy(t) for n, t in v.items()} if isinstance(v, dict) else _numpy(v))
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = tuple(_stack(blocks[i::per_unit]) for i in range(per_unit))
    return out


def train_state_to_numpy(cfg: ArchConfig, state: dict) -> dict:
    """The port's train state -> the reference's, as numpy (``step`` a 0-d
    int32 array)."""
    opt = state["opt"]
    return {"params": params_to_numpy(cfg, state["params"]),
            "opt": {"m": params_to_numpy(cfg, opt["m"]), "v": params_to_numpy(cfg, opt["v"]),
                    "step": np.asarray(int(opt["step"]), dtype=np.int32)}}


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
