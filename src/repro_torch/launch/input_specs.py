"""Abstract inputs for the dry-run: tensors with every model input's shape
and dtype that hold no memory.

Counterpart of ``repro.launch.input_specs``.  Called under a
``FakeTensorMode`` it returns fake tensors on ``device``; otherwise meta
tensors.

* train / prefill: token batch (plus stubbed frontend embeddings for the
  VLM / audio carve-out archs).
* decode: ONE new token per sequence + the full KV cache / SSM state at
  ``seq_len`` capacity (``Model.init_caches``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.transformer import Model


def skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    """Documented (arch, shape) skips (the reference's DESIGN.md §6)."""
    if shape.name == "long_500k" and shape.mode == "decode":
        if not cfg.supports_long_decode:
            return ("full-attention KV at 524288 tokens is quadratic-cost to fill and "
                    "O(ctx) per step; arch has no sliding-window/SSM path")
    return None


def _under_fake_mode() -> bool:
    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


def input_specs(cfg: ArchConfig, shape: ShapeConfig, model: Model | None = None,
                device="cuda") -> dict[str, Any]:
    """Returns ``{"batch": dict of tensors, "caches": tree or None}``."""
    dev = torch.device(device) if _under_fake_mode() else torch.device("meta")
    B, S = shape.global_batch, shape.seq_len
    cd = torch_dtype(cfg.compute_dtype)

    def empty(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=dev)

    if shape.mode in ("train", "prefill"):
        batch: dict[str, Any] = {}
        if cfg.family == "vlm":
            # stub ViT frontend: precomputed patch+text embeddings
            batch["embeds"] = empty((B, S, cfg.d_model), cd)
            batch["labels"] = empty((B, S), torch.int32)
            batch["positions"] = empty((3, B, S), torch.int32)   # M-RoPE t/h/w
        else:
            batch["tokens"] = empty((B, S), torch.int32)
        if cfg.family == "audio":
            # stub mel+conv frontend: precomputed frame embeddings
            batch["encoder_feats"] = empty((B, cfg.encdec.encoder_seq, cfg.d_model), cd)
        return {"batch": batch, "caches": None}

    # decode: one token, cache at seq_len capacity
    batch = {"tokens": empty((B, 1), torch.int32), "pos": empty((), torch.int32)}
    caches = model.init_caches(B, S, dev) if model is not None else None
    return {"batch": batch, "caches": caches}
