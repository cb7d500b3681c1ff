"""Model assembly for every family of the configs: the decoder-only LMs
(dense / moe / vlm), RWKV6 (ssm), Zamba2 (hybrid) and Whisper (audio).

Counterpart of ``repro.models.transformer``.  Params are a nested dict of
tensors.  Each stack of layers that the reference scans over (``blocks``,
Zamba2's ``supers``, Whisper's ``enc_blocks`` and ``dec_blocks``) is a list
with one dict per layer, and a Python loop over it takes the place of the
reference's ``lax.scan``.  A block of an MoE config holds ``"moe"``
(``models.moe.init_moe``) in place of ``"mlp"``.  For serving, matmul
weights are held in the compute dtype (the reference casts them to it before
every product); the leaves the reference reads through
``.astype(float32)`` stay float32 (``to_compute_dtype``).

* ``init(gen, masters=False)``: random weights with the reference's
  distributions.  Serving's default casts each block to the compute dtype
  as it is made (``to_compute_dtype``), so the peak holds one float32
  block; ``masters=True`` keeps every leaf float32 (training's master
  weights, cast per step by ``train.loop.cast_params_for_compute``).
* ``forward(params, batch, want_cache=False, remat=True)`` -> (logits, aux,
  caches); ``aux`` is the router aux loss summed over layers and divided by
  the number of scan steps, as the reference returns it (0 for the other
  families).  With grad enabled, ``remat`` and no cache, each layer (each
  Zamba2 super-block) runs under ``torch.utils.checkpoint`` (recomputed in
  the backward, as the reference's JAX ``checkpoint`` does); values do not
  change.  ``batch`` holds ``tokens`` [B, S] (or a vlm's ``embeds`` [B, S,
  D]), optionally ``positions`` ([B, S], or [3, B, S] for M-RoPE) and
  ``labels``, and for Whisper ``encoder_feats`` [B, encoder_seq, D].
  With ``want_cache`` the caches are, by family:

  - decoder LMs: (k, v), each [L, B, S, KV, hd];
  - rwkv: the decode states, one dict per layer (``init_caches``' form);
  - zamba: ``{"mamba": [state per layer], "kv": [(k, v) per super-block]}``;
  - whisper: ``{"self": [(k, v) per layer], "cross": [{"k", "v"} per layer]}``,
    the cross entries being ``init_caches``' ``"cross"`` form.
* ``loss(params, batch, remat=True)``: next-token cross entropy in float32
  plus ``aux``, as the reference's ``Model.loss``.
* ``decode_step(params, batch, caches)`` -> (logits, caches): ONE new token
  (``batch = {"tokens": [B, 1], "pos": int}``) against per-layer caches or
  states, updated in place; the aux loss is discarded, as in the reference.
* ``init_caches(batch_size, capacity, device)``: decoder LMs, a list of
  per-layer KV caches; rwkv, a list of per-layer zero states (``capacity``
  unused); zamba, ``{"mamba": [state per layer], "attn": [KV cache per
  super-block]}``; whisper, ``{"self": [KV cache per layer], "cross":
  [{"k", "v"} per layer]}``, the cross K/V zeros [B, encoder_seq, KV, hd]
  that ``decode_step`` reads as given and never writes (the caller fills
  them from the forward's cross K/V, as in the reference).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.spans import FFN, span
from . import attention as attn
from . import layers as L
from . import mamba2
from . import moe as moe_mod
from . import rwkv6

# Leaves the reference reads through ``.astype(float32)``: norm params (every
# key starting with "ln", and these norms), the MoE router, Mamba2's A_log,
# dt_bias, D_skip and norm_scale and RWKV6's w0 and u.  Serving keeps them
# float32 (``to_compute_dtype``).
F32_LEAVES = ("final_norm", "enc_norm", "dec_norm", "router", "A_log", "dt_bias", "D_skip",
              "norm_scale", "w0", "u")


def identity_ac(x, kind):
    """The default activation-sharding hook: no constraint."""
    return x


def _ffn(cfg, p, h, ac):
    """The block's feed-forward: (output, router aux loss or None).  The MoE
    layer gets ``ac``'s ``"expert"`` kind as its ``expert_sharding`` hook."""
    if cfg.moe:
        return moe_mod.apply_moe(cfg, p["moe"], h, expert_sharding=lambda t: ac(t, "expert"))
    return L.apply_mlp(cfg, p["mlp"], h), None


def apply_tf_block(cfg, p, x, *, rope, window, want_kv=False, ac=identity_ac):
    """-> (x, aux or None, kv or None).  ``ac`` constrains where the
    reference's train block (``want_kv`` false) or prefill block does."""
    h = L.apply_norm(cfg, p["ln1"], x)
    out, kv = attn.attention_ctx(cfg, p["attn"], h, rope=rope, causal=True, window=window,
                                 return_kv=True)
    x = ac(x + (out if want_kv else ac(out, "partial")), "hidden_mid")
    y, aux = _ffn(cfg, p, L.apply_norm(cfg, p["ln2"], x), ac)
    x = ac(x + (y if want_kv else ac(y, "partial")), "hidden")
    return x, aux, (kv if want_kv else None)


def apply_tf_block_decode(cfg, p, x, cache, pos, *, rope_fn, window, ac=identity_ac):
    h = L.apply_norm(cfg, p["ln1"], x)
    out, cache = attn.attention_decode(cfg, p["attn"], h, cache, pos, rope_fn=rope_fn,
                                       window=window)
    x = x + out
    h = L.apply_norm(cfg, p["ln2"], x)
    with span(FFN):
        y, _ = _ffn(cfg, p, h, ac)
    return x + y, cache


def make_rope(cfg: ArchConfig, positions: torch.Tensor):
    """positions [B, S] (rope) or [3, B, S] (mrope; 2-D text positions are
    broadcast to t = h = w) -> (cos, sin), or None without rotary
    embeddings."""
    if cfg.rope_kind == "rope":
        return L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:
            positions = positions.expand(3, *positions.shape)
        return L.mrope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    return None


def make_rope_fn(cfg: ArchConfig):
    if cfg.rope_kind in ("rope", "mrope"):
        return lambda pos_b: make_rope(cfg, pos_b)
    return None


def layer_windows(cfg: ArchConfig) -> list[int | None]:
    """Attention window of each layer (gemma2 alternates local/global)."""
    pattern = cfg.layer_pattern or ("layer",)
    per_unit = [cfg.sliding_window if kind in ("layer", "local") else None for kind in pattern]
    return [per_unit[i % len(per_unit)] for i in range(cfg.n_layers)]


def keeps_float32(key: str) -> bool:
    """Whether serving keeps the leaves under ``key`` float32."""
    return key.startswith("ln") or key in F32_LEAVES


def to_compute_dtype(cfg: ArchConfig, params: dict) -> dict:
    """Matmul weights, biases, the embeddings and the other leaves the
    reference casts before use to the compute dtype; the leaves it reads in
    float32 (``keeps_float32``) stay float32, so routing does not round the
    router and RWKV6's decay ``exp(-exp(w0 + lora))`` does not round ``w0``."""
    cd = torch_dtype(cfg.compute_dtype)

    def conv(tree, keep_f32):
        if isinstance(tree, dict):
            return {k: conv(v, keep_f32 or keeps_float32(k)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, keep_f32) for v in tree]
        return tree.float() if keep_f32 else tree.to(cd)

    return conv(params, False)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]             # (gen, masters=False)
    forward: Callable[..., Any]          # (params, batch, want_cache=False, remat=True, ac=)
    decode_step: Callable[..., Any]      # (params, batch, caches, ac=)
    init_caches: Callable[..., Any]      # (batch_size, capacity, device)

    def loss(self, params, batch, remat=True, ac=identity_ac):
        """Mean next-token cross entropy over B x (S - 1) in float32, plus
        the router aux loss.  Labels are ``tokens[:, 1:]`` unless
        ``batch["labels"]`` is given."""
        logits, aux, _ = self.forward(params, batch, remat=remat, ac=ac)
        labels = batch.get("labels")
        if labels is None:
            labels = batch["tokens"][:, 1:]
            logits = logits[:, :-1]
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        return (lse - ll).mean() + aux


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return _build_decoder_lm(cfg)
    if cfg.family == "ssm":
        return _build_rwkv(cfg)
    if cfg.family == "hybrid":
        return _build_zamba(cfg)
    if cfg.family == "audio":
        return _build_whisper(cfg)
    raise ValueError(cfg.family)


def _caster(cfg: ArchConfig, masters: bool):
    return (lambda tree: tree) if masters else (lambda tree: to_compute_dtype(cfg, tree))


def _run(fn, recompute: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``recompute``."""
    if recompute:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _build_decoder_lm(cfg: ArchConfig) -> Model:
    windows = layer_windows(cfg)
    trip = cfg.n_layers // len(cfg.layer_pattern or ("layer",))   # the reference's scan steps
    rope_fn = make_rope_fn(cfg)

    def init(gen: torch.Generator, masters: bool = False) -> dict:
        """Random weights from ``gen`` (on the device the params go to), with
        the reference's distributions: float32 with ``masters``, else cast
        to the compute dtype one block at a time."""
        dev = gen.device
        cast = _caster(cfg, masters)

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
             "blocks": [cast(block()) for _ in range(cfg.n_layers)],
             "final_norm": L.init_norm(cfg, cfg.d_model, dev)}
        if not cfg.tie_embeddings:
            p["unembed"] = L.normal(gen, (cfg.d_model, cfg.vocab), 0.02)
        return cast(p)

    def _unembed_out(params, x):
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return L.unembed(cfg, w, x)

    def _embed_in(params, batch):
        if "embeds" in batch:
            return batch["embeds"].to(torch_dtype(cfg.compute_dtype))
        return L.embed_tokens(cfg, params["embed"], batch["tokens"])

    def forward(params, batch, want_cache=False, remat=True, ac=identity_ac):
        x = ac(_embed_in(params, batch), "hidden")
        B, S, _ = x.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        rope = make_rope(cfg, ac(positions, "positions"))
        ks, vs = [], []
        aux = torch.zeros((), device=x.device)
        recompute = remat and not want_cache and torch.is_grad_enabled()
        for p, window in zip(params["blocks"], windows):
            if recompute:
                x, a, kv = checkpoint(apply_tf_block, cfg, p, x, rope=rope, window=window,
                                      ac=ac, use_reentrant=False)
            else:
                x, a, kv = apply_tf_block(cfg, p, x, rope=rope, window=window,
                                          want_kv=want_cache, ac=ac)
            if a is not None:
                aux = aux + a
            if want_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = ac(_unembed_out(params, x), "logits")
        caches = (torch.stack(ks), torch.stack(vs)) if want_cache else None
        return logits, aux / trip, caches

    def init_caches(batch_size, capacity, device):
        return [attn.init_attn_cache(cfg, batch_size, min(w, capacity) if w else capacity,
                                     device) for w in windows]

    def decode_step(params, batch, caches, ac=identity_ac):
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])   # [B, 1, D]
        pos = int(batch["pos"])
        for i, (p, window) in enumerate(zip(params["blocks"], windows)):
            x, caches[i] = apply_tf_block_decode(cfg, p, x, caches[i], pos,
                                                 rope_fn=rope_fn, window=window, ac=ac)
        x = L.apply_norm(cfg, params["final_norm"], x)
        return ac(_unembed_out(params, x), "logits"), caches

    return Model(cfg, init, forward, decode_step, init_caches)


# ======================================================================
# RWKV6 (attention-free SSM)
# ======================================================================
def _build_rwkv(cfg: ArchConfig) -> Model:

    def init(gen: torch.Generator, masters: bool = False) -> dict:
        dev = gen.device
        cast = _caster(cfg, masters)

        def block():
            return {"ln1": L.init_norm(cfg, cfg.d_model, dev),
                    "ln2": L.init_norm(cfg, cfg.d_model, dev),
                    "body": rwkv6.init_rwkv_block(cfg, gen)}

        return cast({"embed": L.init_embedding(cfg, gen),
                     "ln_in": L.init_norm(cfg, cfg.d_model, dev),
                     "blocks": [cast(block()) for _ in range(cfg.n_layers)],
                     "final_norm": L.init_norm(cfg, cfg.d_model, dev),
                     "unembed": L.normal(gen, (cfg.d_model, cfg.vocab), 0.02)})

    def block(x, bp, state, ac):
        x, state = rwkv6.apply_rwkv_block(cfg, bp["body"], x, norms=(bp["ln1"], bp["ln2"]),
                                          apply_norm=lambda p, h: L.apply_norm(cfg, p, h),
                                          state=state)
        return ac(x, "hidden"), state

    def _head(params, x):
        x = L.apply_norm(cfg, params["final_norm"], x)
        return x @ params["unembed"].to(x.dtype)

    def forward(params, batch, want_cache=False, remat=True, ac=identity_ac):
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
        x = ac(L.apply_norm(cfg, params["ln_in"], x), "hidden")
        recompute = remat and not want_cache and torch.is_grad_enabled()
        states = []
        for bp in params["blocks"]:
            x, st = _run(block, recompute, x, bp, None, ac)
            states.append(st)
        return ac(_head(params, x), "logits"), x.new_zeros((), dtype=torch.float32), \
            (states if want_cache else None)

    def init_caches(batch_size, capacity, device):
        return [rwkv6.rwkv_state_init(cfg, batch_size, device) for _ in range(cfg.n_layers)]

    def decode_step(params, batch, states, ac=identity_ac):
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
        x = L.apply_norm(cfg, params["ln_in"], x)
        for i, bp in enumerate(params["blocks"]):
            x, states[i] = block(x, bp, states[i], ac)
        return _head(params, x), states

    return Model(cfg, init, forward, decode_step, init_caches)


# ======================================================================
# Zamba2 hybrid: mamba2 backbone + ONE weight-shared attention block
# ======================================================================
def _build_zamba(cfg: ArchConfig) -> Model:
    every = cfg.hybrid.attn_every
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {every}")
    trip = cfg.n_layers // every     # super-blocks: `every` mamba layers + the shared attention
    rope_fn = make_rope_fn(cfg)

    def init(gen: torch.Generator, masters: bool = False) -> dict:
        """``supers`` holds the n_layers mamba layers; super-block u is
        ``supers[u * every:(u + 1) * every]``."""
        dev = gen.device
        cast = _caster(cfg, masters)

        def layer():
            return {"ln": L.init_norm(cfg, cfg.d_model, dev),
                    "body": mamba2.init_mamba_block(cfg, gen)}

        return cast({"embed": L.init_embedding(cfg, gen),
                     "supers": [cast(layer()) for _ in range(cfg.n_layers)],
                     "shared_attn": {"ln1": L.init_norm(cfg, cfg.d_model, dev),
                                     "attn": attn.init_attention(cfg, gen),
                                     "ln2": L.init_norm(cfg, cfg.d_model, dev),
                                     "mlp": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff)},
                     "final_norm": L.init_norm(cfg, cfg.d_model, dev),
                     "unembed": L.normal(gen, (cfg.d_model, cfg.vocab), 0.02)})

    def _shared_tail(shared, x):
        h = L.apply_norm(cfg, shared["ln2"], x)
        return x + L.apply_mlp(cfg, shared["mlp"], h)

    def super_fwd(x, layers, shared, rope, want_cache, ac):
        """-> (x, mamba states or None, shared attention's (k, v) or None)."""
        states = []
        for lp in layers:
            y, st = mamba2.apply_mamba_block(cfg, lp["body"], L.apply_norm(cfg, lp["ln"], x))
            x = ac(x + y, "hidden")
            states.append(st)
        h = L.apply_norm(cfg, shared["ln1"], x)
        out, kv = attn.attention_ctx(cfg, shared["attn"], h, rope=rope, causal=True,
                                     return_kv=True)
        x = ac(_shared_tail(shared, ac(x + out, "hidden")), "hidden")
        return (x, states, kv) if want_cache else (x, None, None)

    def _head(params, x):
        x = L.apply_norm(cfg, params["final_norm"], x)
        return x @ params["unembed"].to(x.dtype)

    def forward(params, batch, want_cache=False, remat=True, ac=identity_ac):
        x = ac(L.embed_tokens(cfg, params["embed"], batch["tokens"]), "hidden")
        B, S, _ = x.shape
        rope = make_rope(cfg, ac(torch.arange(S, dtype=torch.int32, device=x.device)
                                 .expand(B, S), "positions"))
        recompute = remat and not want_cache and torch.is_grad_enabled()
        mamba, kvs = [], []
        for u in range(trip):
            x, st, kv = _run(super_fwd, recompute, x, params["supers"][u * every:(u + 1) * every],
                             params["shared_attn"], rope, want_cache, ac)
            if want_cache:
                mamba.extend(st)
                kvs.append(kv)
        caches = {"mamba": mamba, "kv": kvs} if want_cache else None
        return ac(_head(params, x), "logits"), x.new_zeros((), dtype=torch.float32), caches

    def init_caches(batch_size, capacity, device):
        return {"mamba": [mamba2.mamba_state_init(cfg, batch_size, device)
                          for _ in range(cfg.n_layers)],
                "attn": [attn.init_attn_cache(cfg, batch_size, capacity, device)
                         for _ in range(trip)]}

    def decode_step(params, batch, caches, ac=identity_ac):
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
        pos = int(batch["pos"])
        shared = params["shared_attn"]
        mamba, attn_c = caches["mamba"], caches["attn"]
        for u in range(trip):
            for i in range(u * every, (u + 1) * every):
                lp = params["supers"][i]
                y, mamba[i] = mamba2.apply_mamba_block(
                    cfg, lp["body"], L.apply_norm(cfg, lp["ln"], x), mamba[i])
                x = x + y
            h = L.apply_norm(cfg, shared["ln1"], x)
            out, attn_c[u] = attn.attention_decode(cfg, shared["attn"], h, attn_c[u], pos,
                                                   rope_fn=rope_fn)
            x = _shared_tail(shared, x + out)
        return _head(params, x), caches

    return Model(cfg, init, forward, decode_step, init_caches)


# ======================================================================
# Whisper (audio encoder-decoder, stubbed conv frontend)
# ======================================================================
# Learned decoder positions.  Whisper's real decoder caps at 448; the table
# covers the reference's input shapes, up to 32k (its DESIGN.md §6).
MAX_DEC_POS = 32768


@functools.cache
def _sinusoidal_table(seq: int, d: int):
    return L.sinusoidal_table(seq, d)


def _sinusoidal(seq: int, d: int) -> torch.Tensor:
    """The encoder's positions; the cache holds the numpy table, so a tensor
    made under one fake-tensor mode (the dry-run) is never handed out again."""
    return torch.from_numpy(_sinusoidal_table(seq, d))


def _cross_decode(cfg: ArchConfig, p: dict, h: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """One query token against the encoder's K/V [B, S_enc, KV, hd], as the
    reference's decode step writes it: the scores in the compute dtype,
    divided by sqrt(hd) in float32 (the reference divides by a numpy
    scalar, which promotes them), softmax in float32, no mask."""
    B = h.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = h.dtype
    q = h @ p["wq"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
    q = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bckgd,bskd->bkgcs", q, k).float() / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bkgcs,bskd->bckgd", w, v)
    return out.reshape(B, 1, H * hd) @ p["wo"].to(cd)


def _build_whisper(cfg: ArchConfig) -> Model:
    cd = torch_dtype(cfg.compute_dtype)

    def init(gen: torch.Generator, masters: bool = False) -> dict:
        dev = gen.device
        cast = _caster(cfg, masters)
        D = cfg.d_model

        def enc_block():
            return {"ln1": L.init_norm(cfg, D, dev), "attn": attn.init_attention(cfg, gen),
                    "ln2": L.init_norm(cfg, D, dev), "mlp": L.init_mlp(cfg, gen, D, cfg.d_ff)}

        def dec_block():
            return {"ln1": L.init_norm(cfg, D, dev),
                    "self_attn": attn.init_attention(cfg, gen),
                    "ln_x": L.init_norm(cfg, D, dev),
                    "cross_attn": attn.init_attention(cfg, gen, cross=True),
                    "ln2": L.init_norm(cfg, D, dev), "mlp": L.init_mlp(cfg, gen, D, cfg.d_ff)}

        return cast({"enc_blocks": [cast(enc_block())
                                    for _ in range(cfg.encdec.n_encoder_layers)],
                     "enc_norm": L.init_norm(cfg, D, dev),
                     "embed": L.init_embedding(cfg, gen),
                     "dec_pos": L.normal(gen, (MAX_DEC_POS, D), 0.01),
                     "dec_blocks": [cast(dec_block()) for _ in range(cfg.n_layers)],
                     "dec_norm": L.init_norm(cfg, D, dev)})

    def encode(params, feats, ac):
        x = feats.to(cd)
        x = ac(x + _sinusoidal(x.shape[1], cfg.d_model).to(device=x.device, dtype=cd), "hidden")
        for bp in params["enc_blocks"]:
            h = L.apply_norm(cfg, bp["ln1"], x)
            x = x + attn.attention_ctx(cfg, bp["attn"], h, rope=None, causal=False)
            h = L.apply_norm(cfg, bp["ln2"], x)
            x = ac(x + L.apply_mlp(cfg, bp["mlp"], h), "hidden")
        return L.apply_norm(cfg, params["enc_norm"], x)

    def dec_block(x, bp, enc_out, want_cache, ac):
        """-> (x, (self (k, v), cross (k, v)) or None)."""
        h = L.apply_norm(cfg, bp["ln1"], x)
        out, kv = attn.attention_ctx(cfg, bp["self_attn"], h, rope=None, causal=True,
                                     return_kv=True)
        x = x + out
        h = L.apply_norm(cfg, bp["ln_x"], x)
        out, cross_kv = attn.attention_ctx(cfg, bp["cross_attn"], h, rope=None, causal=False,
                                           kv_x=enc_out, return_kv=True)
        x = ac(x + out, "hidden")
        h = L.apply_norm(cfg, bp["ln2"], x)
        x = ac(x + L.apply_mlp(cfg, bp["mlp"], h), "hidden")
        return x, ((kv, cross_kv) if want_cache else None)

    def _head(params, x):
        x = L.apply_norm(cfg, params["dec_norm"], x)
        return x @ params["embed"].T.to(x.dtype)

    def forward(params, batch, want_cache=False, remat=True, ac=identity_ac):
        enc_out = encode(params, batch["encoder_feats"], ac)
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = L.embed_tokens(cfg, params["embed"], tokens)
        x = ac(x + params["dec_pos"][:S].to(x.dtype), "hidden")
        recompute = remat and not want_cache and torch.is_grad_enabled()
        selfs, crosses = [], []
        for bp in params["dec_blocks"]:
            x, kvs = _run(dec_block, recompute, x, bp, enc_out, want_cache, ac)
            if want_cache:
                selfs.append(kvs[0])
                crosses.append({"k": kvs[1][0], "v": kvs[1][1]})
        caches = {"self": selfs, "cross": crosses} if want_cache else None
        return ac(_head(params, x), "logits"), x.new_zeros((), dtype=torch.float32), caches

    def init_caches(batch_size, capacity, device):
        shape = (batch_size, cfg.encdec.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"self": [attn.init_attn_cache(cfg, batch_size, capacity, device)
                         for _ in range(cfg.n_layers)],
                "cross": [{"k": torch.zeros(shape, dtype=cd, device=device),
                           "v": torch.zeros(shape, dtype=cd, device=device)}
                          for _ in range(cfg.n_layers)]}

    def decode_step(params, batch, caches, ac=identity_ac):
        pos = int(batch["pos"])
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
        x = x + params["dec_pos"][min(pos, MAX_DEC_POS - 1)].to(x.dtype)
        selfs = caches["self"]
        for i, (bp, cross) in enumerate(zip(params["dec_blocks"], caches["cross"])):
            h = L.apply_norm(cfg, bp["ln1"], x)
            out, selfs[i] = attn.attention_decode(cfg, bp["self_attn"], h, selfs[i], pos)
            x = x + out
            h = L.apply_norm(cfg, bp["ln_x"], x)
            x = x + _cross_decode(cfg, bp["cross_attn"], h, cross["k"], cross["v"])
            h = L.apply_norm(cfg, bp["ln2"], x)
            x = x + L.apply_mlp(cfg, bp["mlp"], h)
        return _head(params, x), caches

    return Model(cfg, init, forward, decode_step, init_caches)
