"""Model assembly for the dense and MoE decoder-only families.

Counterpart of ``repro.models.transformer._build_decoder_lm`` for
``family in ("dense", "moe")``.  Params are a nested dict of tensors;
``blocks`` is a list with one dict per layer, and a Python loop over it takes
the place of the reference's ``lax.scan`` over stacked layers.  A block of an
MoE config holds ``"moe"`` (``models.moe.init_moe``) in place of ``"mlp"``.
Matmul weights are held in the compute dtype (the reference casts them to it
before every product); norm params and the MoE router stay float32, as the
reference routes in float32 from its float32 params.

* ``forward(params, batch, want_cache=False)`` -> (logits, aux, caches);
  ``aux`` is the router aux loss summed over layers and divided by the
  number of scan steps, as the reference returns it (0 for dense configs);
  with ``want_cache`` the caches are (k, v), each [L, B, S, KV, hd].
* ``decode_step(params, batch, caches)`` -> (logits, caches): ONE new token
  (``batch = {"tokens": [B, 1], "pos": int}``) against per-layer caches,
  updated in place; the aux loss is discarded, as in the reference.
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
from . import moe as moe_mod

# The families of later slices of the port.
_LATER = {
    "vlm": "the VLM slice (M-RoPE, stubbed patch embeddings)",
    "ssm": "the remaining-families slice (RWKV6)",
    "hybrid": "the remaining-families slice (Zamba2 / Mamba2)",
    "audio": "the remaining-families slice (Whisper)",
}


def _ffn(cfg, p, h):
    """The block's feed-forward: (output, router aux loss or None)."""
    if cfg.moe:
        return moe_mod.apply_moe(cfg, p["moe"], h)
    return L.apply_mlp(cfg, p["mlp"], h), None


def apply_tf_block(cfg, p, x, *, rope, window, want_kv=False):
    """-> (x, aux or None, kv or None)."""
    h = L.apply_norm(cfg, p["ln1"], x)
    out, kv = attn.attention_ctx(cfg, p["attn"], h, rope=rope, causal=True, window=window,
                                 return_kv=True)
    x = x + out
    y, aux = _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x))
    return x + y, aux, (kv if want_kv else None)


def apply_tf_block_decode(cfg, p, x, cache, pos, *, rope_fn, window):
    h = L.apply_norm(cfg, p["ln1"], x)
    out, cache = attn.attention_decode(cfg, p["attn"], h, cache, pos, rope_fn=rope_fn,
                                       window=window)
    x = x + out
    y, _ = _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x))
    return x + y, cache


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
    params (``ln*``, ``final_norm``) and the MoE ``router`` stay float32, so
    routing does not round the router before choosing experts."""
    cd = torch_dtype(cfg.compute_dtype)

    def conv(tree, keep_f32):
        if isinstance(tree, dict):
            return {k: conv(v, keep_f32 or k.startswith("ln") or k in ("final_norm", "router"))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, keep_f32) for v in tree]
        return tree.float() if keep_f32 else tree.to(cd)

    return conv(params, False)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[[torch.Generator], Any]
    forward: Callable[..., Any]          # (params, batch, want_cache=False)
    decode_step: Callable[..., Any]      # (params, batch, caches)
    init_caches: Callable[..., Any]      # (batch_size, capacity, device)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe"):
        return _build_decoder_lm(cfg)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER[cfg.family]}")
    raise ValueError(cfg.family)


def _build_decoder_lm(cfg: ArchConfig) -> Model:
    windows = layer_windows(cfg)
    trip = cfg.n_layers // len(cfg.layer_pattern or ("layer",))   # the reference's scan steps
    rope_fn = make_rope_fn(cfg)

    def init(gen: torch.Generator) -> dict:
        """Random weights from ``gen`` (on the device the params go to), with
        the reference's distributions."""
        dev = gen.device

        def block():
            p = {"ln1": L.init_norm(cfg, cfg.d_model, dev),
                 "attn": attn.init_attention(cfg, gen),
                 "ln2": L.init_norm(cfg, cfg.d_model, dev)}
            if cfg.moe:
                p["moe"] = moe_mod.init_moe(cfg, gen)
            else:
                p["mlp"] = L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff)
            return p

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
        aux = torch.zeros((), device=x.device)
        for p, window in zip(params["blocks"], windows):
            x, a, kv = apply_tf_block(cfg, p, x, rope=rope, window=window, want_kv=want_cache)
            if a is not None:
                aux = aux + a
            if want_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = _unembed_out(params, x)
        caches = (torch.stack(ks), torch.stack(vs)) if want_cache else None
        return logits, aux / trip, caches

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
