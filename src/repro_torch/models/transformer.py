"""Model assembly for the dense decoder-only family.

Counterpart of ``repro.models.transformer._build_decoder_lm`` for
``family == "dense"``.  Params are a nested dict of tensors; ``blocks`` is a
list with one dict per layer, and a Python loop over it takes the place of
the reference's ``lax.scan`` over stacked layers.  Matmul weights are held
in the compute dtype (the reference casts them to it before every product)
and norm params in float32.

* ``forward(params, batch, want_cache=False)`` -> (logits, aux, caches);
  with ``want_cache`` the caches are (k, v), each [L, B, S, KV, hd].
* ``decode_step(params, batch, caches)`` -> (logits, caches): ONE new token
  (``batch = {"tokens": [B, 1], "pos": int}``) against per-layer caches,
  updated in place.
* ``init_caches(batch_size, capacity, device)`` -> list of per-layer caches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from . import attention as attn
from . import layers as L

# The families of later slices of the port.
_LATER = {
    "moe": "the MoE-family slice (models.moe layers inside the decoder stack)",
    "vlm": "the VLM slice (M-RoPE, stubbed patch embeddings)",
    "ssm": "the remaining-families slice (RWKV6)",
    "hybrid": "the remaining-families slice (Zamba2 / Mamba2)",
    "audio": "the remaining-families slice (Whisper)",
}


def apply_tf_block(cfg, p, x, *, rope, window, want_kv=False):
    h = L.apply_norm(cfg, p["ln1"], x)
    out, kv = attn.attention_ctx(cfg, p["attn"], h, rope=rope, causal=True, window=window,
                                 return_kv=True)
    x = x + out
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h), (kv if want_kv else None)


def apply_tf_block_decode(cfg, p, x, cache, pos, *, rope_fn, window):
    h = L.apply_norm(cfg, p["ln1"], x)
    out, cache = attn.attention_decode(cfg, p["attn"], h, cache, pos, rope_fn=rope_fn,
                                       window=window)
    x = x + out
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h), cache


def make_rope(cfg: ArchConfig, positions: torch.Tensor):
    """positions [B, S] -> (cos, sin), or None without rotary embeddings."""
    if cfg.rope_kind == "rope":
        return L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.rope_kind == "none":
        return None
    raise NotImplementedError(f"rope_kind {cfg.rope_kind!r} comes with {_LATER['vlm']}")


def make_rope_fn(cfg: ArchConfig):
    if cfg.rope_kind == "rope":
        return lambda pos_b: make_rope(cfg, pos_b)
    return None


def layer_windows(cfg: ArchConfig) -> list[int | None]:
    """Attention window of each layer (gemma2 alternates local/global)."""
    pattern = cfg.layer_pattern or ("layer",)
    per_unit = [cfg.sliding_window if kind in ("layer", "local") else None for kind in pattern]
    return [per_unit[i % len(per_unit)] for i in range(cfg.n_layers)]


def to_compute_dtype(cfg: ArchConfig, params: dict) -> dict:
    """Matmul weights, biases and the embedding to the compute dtype; norm
    params (``ln*``, ``final_norm``) stay float32."""
    cd = torch_dtype(cfg.compute_dtype)

    def conv(tree, in_norm):
        if isinstance(tree, dict):
            return {k: conv(v, in_norm or k.startswith("ln") or k == "final_norm")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, in_norm) for v in tree]
        return tree.float() if in_norm else tree.to(cd)

    return conv(params, False)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[[torch.Generator], Any]
    forward: Callable[..., Any]          # (params, batch, want_cache=False)
    decode_step: Callable[..., Any]      # (params, batch, caches)
    init_caches: Callable[..., Any]      # (batch_size, capacity, device)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "dense":
        return _build_decoder_lm(cfg)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER[cfg.family]}")
    raise ValueError(cfg.family)


def _build_decoder_lm(cfg: ArchConfig) -> Model:
    windows = layer_windows(cfg)
    rope_fn = make_rope_fn(cfg)

    def init(gen: torch.Generator) -> dict:
        """Random weights from ``gen`` (on the device the params go to), with
        the reference's distributions."""
        dev = gen.device

        def block():
            return {"ln1": L.init_norm(cfg, cfg.d_model, dev),
                    "attn": attn.init_attention(cfg, gen),
                    "ln2": L.init_norm(cfg, cfg.d_model, dev),
                    "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff)}

        p = {"embed": L.init_embedding(cfg, gen),
             "blocks": [to_compute_dtype(cfg, block()) for _ in range(cfg.n_layers)],
             "final_norm": L.init_norm(cfg, cfg.d_model, dev)}
        if not cfg.tie_embeddings:
            p["unembed"] = L.normal(gen, (cfg.d_model, cfg.vocab), 0.02)
        return to_compute_dtype(cfg, p)

    def _unembed_out(params, x):
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return L.unembed(cfg, w, x)

    def forward(params, batch, want_cache=False):
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
        B, S, _ = x.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        rope = make_rope(cfg, positions)
        ks, vs = [], []
        for p, window in zip(params["blocks"], windows):
            x, kv = apply_tf_block(cfg, p, x, rope=rope, window=window, want_kv=want_cache)
            if want_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = _unembed_out(params, x)
        caches = (torch.stack(ks), torch.stack(vs)) if want_cache else None
        return logits, torch.zeros((), device=x.device), caches

    def init_caches(batch_size, capacity, device):
        return [attn.init_attn_cache(cfg, batch_size, min(w, capacity) if w else capacity,
                                     device) for w in windows]

    def decode_step(params, batch, caches):
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])   # [B, 1, D]
        pos = int(batch["pos"])
        for i, (p, window) in enumerate(zip(params["blocks"], windows)):
            x, caches[i] = apply_tf_block_decode(cfg, p, x, caches[i], pos,
                                                 rope_fn=rope_fn, window=window)
        x = L.apply_norm(cfg, params["final_norm"], x)
        return _unembed_out(params, x), caches

    return Model(cfg, init, forward, decode_step, init_caches)
