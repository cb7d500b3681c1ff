"""Weight bridge between the reference's params (numpy) and the port's.

The input is JAX's ``tree.map(np.asarray, params)`` of the JAX model: a nested
dict whose stacks of layers carry a leading scan axis.  The reference lays
them out by family:

* decoder LMs (dense / moe / vlm): ``blocks`` is a tuple of ``per_unit``
  dicts (one per entry of the config's layer pattern), each stacked over
  ``n_layers // per_unit`` scan steps; layer ``u * per_unit + i`` is scan
  step ``u`` of unit ``i``;
* rwkv (ssm): ``blocks`` is one dict stacked over the layers;
* zamba (hybrid): ``supers`` is a tuple of ``attn_every`` dicts, each
  stacked over the super-blocks (mamba layer ``u * attn_every + i`` is
  step ``u`` of unit ``i``); ``shared_attn`` is one unstacked block;
* whisper (audio): ``enc_blocks`` and ``dec_blocks``, each one dict stacked
  over its layers.

The port holds each such stack as a flat list of per-layer dicts, in layer
order.  No weight is transposed: the port keeps the reference's ``x @ w``
layout, ``[in, out]``:

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
* the rwkv, mamba2 and whisper leaves as ``models.rwkv6``,
  ``models.mamba2`` and ``models.transformer`` make them.

MoE layer params (``moe_params_from_numpy``, the dict of ``init_moe``):

* ``router``            [D, E]
* ``wg``/``wu``         [E, D, F],  ``wd`` [E, F, D]

held as they are; ``core.latte_moe.shard_experts`` gives rank r the experts
``[r * e_local, (r + 1) * e_local)``, as ``P(axis, None, None)`` does in
the reference.

The only reshaping is unstacking the layer axis into the port's per-layer
lists.  ``params_from_numpy`` (serving) casts to the compute dtype all but
the leaves the reference reads in float32 (``transformer.to_compute_dtype``).  The train state
(``train_state_from_numpy``: ``{"params", "opt": {"m", "v", "step"}}``)
keeps every leaf float32, with no compute cast.  ``params_to_numpy`` and
``train_state_to_numpy`` restack the per-layer list into the reference's
stacked layout, so the result has the reference's leaves, shapes and
JAX ``tree_util`` order.  This module imports
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


def _whole(tree, device):
    if isinstance(tree, dict):
        return {k: _whole(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def stacked_keys(cfg: ArchConfig) -> dict:
    """The reference's stacks of layers: key -> the number of units per scan
    step (a tuple of that many dicts) or None (one dict stacked over the
    layers)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return {"blocks": len(cfg.layer_pattern or ("layer",))}
    if cfg.family == "ssm":
        return {"blocks": None}
    if cfg.family == "hybrid":
        return {"supers": cfg.hybrid.attn_every}
    if cfg.family == "audio":
        return {"enc_blocks": None, "dec_blocks": None}
    raise ValueError(f"unknown family {cfg.family!r}")


def _first_leaf(tree):
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


def _unstack(cfg: ArchConfig, tree: dict, dev: torch.device) -> dict:
    """Reference params -> port params, every leaf float32."""
    stacks = stacked_keys(cfg)
    params = {}
    for key, value in tree.items():
        if key not in stacks:
            params[key] = _whole(value, dev)
        elif stacks[key] is None:
            n = np.shape(_first_leaf(value))[0]
            params[key] = [_layer(value, i, dev) for i in range(n)]
        else:
            n_units = len(value)
            trip = np.shape(_first_leaf(value[0]))[0]
            params[key] = [_layer(value[i], u, dev) for u in range(trip) for i in range(n_units)]
    return params


def params_from_numpy(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """Reference params (nested dict of numpy arrays) -> port params on
    ``device``, in the compute dtype but for the float32 leaves."""
    return to_compute_dtype(cfg, _unstack(cfg, tree, resolve_device(device)))


def train_state_from_numpy(cfg: ArchConfig, state: dict, device="cuda") -> dict:
    """Reference train state ``{"params", "opt": {"m", "v", "step"}}`` as
    numpy -> the port's on ``device``: float32 masters and moments, ``step``
    a 0-d int32 tensor."""
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
    moments) -> the reference's layout as numpy: each per-layer list
    restacked as ``stacked_keys`` gives it (for a key of n units, layer
    ``u * n + i`` -> unit ``i``, step ``u``)."""
    stacks = stacked_keys(cfg)

    def whole(t):
        return {k: whole(v) for k, v in t.items()} if isinstance(t, dict) else _numpy(t)

    out = {}
    for key, value in params.items():
        if key not in stacks:
            out[key] = whole(value)
        elif stacks[key] is None:
            out[key] = _stack(value)
        else:
            n = stacks[key]
            out[key] = tuple(_stack(value[i::n]) for i in range(n))
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
