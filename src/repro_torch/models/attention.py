"""GQA attention: full-context (train / prefill, query-chunked for long
sequences) and decode (one token against a rolling KV cache).

Counterpart of the dense parts of ``repro.models.attention``.  The paged
decode kernel in ``repro_torch/kernels/decode_attention`` computes the same
math over paged pools and is a standalone op: the reference does not call it
from ``attention_decode`` either.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from .layers import apply_rotary, normal, softcap

# Sequences longer than this use the query-chunked path (bounds the
# materialized [*, chunk, S] score block instead of [*, S, S]).
CHUNK_THRESHOLD = 2048
Q_CHUNK = 512
NEG_INF = -1e30


def init_attention(cfg: ArchConfig, gen: torch.Generator) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    s = 1.0 / math.sqrt(D)
    p = {
        "wq": normal(gen, (D, H * hd), s),
        "wk": normal(gen, (D, KV * hd), s),
        "wv": normal(gen, (D, KV * hd), s),
        "wo": normal(gen, (H * hd, D), 1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd, device=dev)
        p["bk"] = torch.zeros(KV * hd, device=dev)
        p["bv"] = torch.zeros(KV * hd, device=dev)
    return p


def _project_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = x.dtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q.reshape(B, S, KV, H // KV, hd), k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)


def _scores(q: torch.Tensor, k: torch.Tensor, head_dim: int, cap: float | None):
    """[B,C,KV,G,hd] x [B,S,KV,hd] -> [B,KV,G,C,S] scores.  The product is in
    the compute dtype; dividing by sqrt(hd) promotes to float32 (the
    reference divides by a numpy float64 scalar, which JAX promotes to
    float32), and the softcap follows in float32."""
    scores = torch.einsum("bckgd,bskd->bkgcs", q, k).float() / math.sqrt(head_dim)
    return softcap(scores, cap)


def _attn_scores_block(q, k, v, q_pos, k_pos, *, head_dim, causal, window, cap):
    """Dense attention of one query block against the full K/V. [B,C,KV,G,hd]."""
    scores = _scores(q, k, head_dim, cap)
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgcs,bskd->bckgd", w, v)


def attention_ctx(cfg: ArchConfig, p: dict, x: torch.Tensor, *, rope, causal: bool = True,
                  window: int | None = None, q_chunk: int = Q_CHUNK,
                  return_kv: bool = False):
    """Full-context attention (train / prefill).  Sequences longer than
    ``CHUNK_THRESHOLD`` run in query chunks of ``q_chunk`` (a loop takes the
    place of the reference's ``lax.scan``)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x)
    if rope is not None:
        cos, sin = rope
        q = apply_rotary(q.reshape(B, S, H, hd), cos, sin).reshape(B, S, KV, H // KV, hd)
        k = apply_rotary(k, cos, sin)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    kw = dict(head_dim=hd, causal=causal, window=window, cap=cfg.attn_softcap)

    if S <= CHUNK_THRESHOLD or S % q_chunk != 0:
        out = _attn_scores_block(q, k, v, pos, pos, **kw)
    else:
        out = torch.cat([_attn_scores_block(q[:, c:c + q_chunk], k, v, pos[c:c + q_chunk],
                                            pos, **kw)
                         for c in range(0, S, q_chunk)], dim=1)

    out = out.reshape(B, S, H * hd) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


# ------------------------------------------------------------- KV cache ----
def init_attn_cache(cfg: ArchConfig, batch: int, capacity: int, device) -> dict:
    cd = torch_dtype(cfg.compute_dtype)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, capacity, KV, hd), dtype=cd, device=device),
        "v": torch.zeros((batch, capacity, KV, hd), dtype=cd, device=device),
        "kpos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
    }


def prefill_cache(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor, capacity: int) -> dict:
    """Build a cache from prefill K/V [B, S, KV, hd] (S <= capacity; for a
    sliding-window cache, capacity = window and the tail of the sequence is
    kept, in the slots pos % capacity)."""
    B, S = k.shape[:2]
    dev = k.device
    if S > capacity:
        kpos = torch.arange(S - capacity, S, dtype=torch.int32, device=dev)
        order = torch.argsort(kpos % capacity)
        return {"k": k[:, S - capacity:][:, order], "v": v[:, S - capacity:][:, order],
                "kpos": kpos[order]}
    pad = capacity - S
    zeros = k.new_zeros((B, pad) + tuple(k.shape[2:]))
    kpos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                      torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    return {"k": torch.cat([k, zeros], dim=1), "v": torch.cat([v, zeros], dim=1), "kpos": kpos}


def attention_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict, pos: int, *,
                     rope_fn=None, window: int | None = None):
    """Single-token decode against a (rolling) KV cache.  x [B, 1, D]; ``pos``
    is the new token's absolute position.  The cache is updated in place
    (slot ``pos % capacity``) and returned."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(cfg, p, x)
    if rope_fn is not None:
        pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        cos_q, sin_q = rope_fn(pos_b)
        q = apply_rotary(q.reshape(B, 1, H, hd), cos_q, sin_q).reshape(B, 1, KV, H // KV, hd)
        k_new = apply_rotary(k_new, cos_q, sin_q)

    slot = pos % cap
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["kpos"][slot] = pos
    kpos = cache["kpos"]

    scores = _scores(q, cache["k"], hd, cfg.attn_softcap)
    valid = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        valid = valid & (pos - kpos < window)
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgcs,bskd->bckgd", w, cache["v"])
    out = out.reshape(B, 1, H * hd) @ p["wo"].to(x.dtype)
    return out, cache
