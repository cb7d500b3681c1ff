"""GQA attention: full-context (train / prefill / encoder, query-chunked for
long sequences), decode (one token against a rolling KV cache) and
cross-attention (whisper: K/V from the encoder output).

Counterpart of ``repro.models.attention``.  The paged
decode kernel in ``repro_torch/kernels/decode_attention`` computes the same
math over paged pools and is a standalone op: the reference does not call it
from ``attention_decode`` either.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import spans
from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.prefill_attention import ops as prefill_ops
from .layers import apply_rotary, normal, softcap

# Sequences longer than this use the query-chunked path (bounds the
# materialized [*, chunk, S] score block instead of [*, S, S]).
CHUNK_THRESHOLD = 2048
Q_CHUNK = 512
NEG_INF = -1e30
_costing = 0                # depth of open dense_attention_for_costing blocks


class dense_attention_for_costing:
    """Context manager: disable query chunking and the prefill kernel, as the
    reference's costing pass does, so the port's costing traces the same
    attention (one [*, S, S] score block) and compares with the reference
    term by term."""

    def __enter__(self):
        global CHUNK_THRESHOLD, _costing
        self._old = CHUNK_THRESHOLD
        CHUNK_THRESHOLD = 1 << 62
        _costing += 1
        return self

    def __exit__(self, *exc):
        global CHUNK_THRESHOLD, _costing
        CHUNK_THRESHOLD = self._old
        _costing -= 1
        return False


def prefill_kernel_applies(*, device_type: str, dtype: torch.dtype, plain: bool,
                           needs_grad: bool, cross: bool, causal: bool, cap: float | None,
                           window: int | None, head_dim: int, costing: bool) -> bool:
    """Whether full-context attention runs the flash-attention prefill kernel
    (``kernels/prefill_attention``) instead of the dense or query-chunked
    path: plain CUDA tensors (no fake, meta or DTensor, no dispatch mode) of
    bf16 or fp16, nothing to differentiate (the kernel is forward only),
    causal self-attention without softcap or window, a head_dim the kernel
    has, outside ``dense_attention_for_costing``."""
    return (device_type == "cuda" and plain and dtype in prefill_ops.DTYPES
            and not needs_grad and not cross and causal and cap is None
            and window is None and head_dim in prefill_ops.HEAD_DIMS and not costing)


def _prefill_kernel_applies(q, k, v, *, kv_x, causal, window, cap) -> bool:
    """``prefill_kernel_applies`` on what the operands show."""
    ops = (q, k, v)
    return prefill_kernel_applies(
        device_type=q.device.type, dtype=q.dtype,
        plain=all(type(t) is torch.Tensor for t in ops) and _get_current_dispatch_mode() is None,
        needs_grad=torch.is_grad_enabled() and any(t.requires_grad for t in ops),
        cross=kv_x is not None, causal=causal, cap=cap, window=window,
        head_dim=q.shape[-1], costing=_costing > 0)


def init_attention(cfg: ArchConfig, gen: torch.Generator, *, cross: bool = False) -> dict:
    """Projection weights; a cross-attention block (``cross=True``) has the
    same params as a self-attention one, as in the reference."""
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


def _project_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, kv_x: torch.Tensor | None = None):
    """Q from ``x``; K and V from ``kv_x`` (cross-attention) or ``x``."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = x.dtype
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = x @ p["wq"].to(cd)
    k = src @ p["wk"].to(cd)
    v = src @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return (q.reshape(B, S, KV, H // KV, hd), k.reshape(B, Skv, KV, hd),
            v.reshape(B, Skv, KV, hd))


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
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        near = q_pos[:, None] - k_pos[None, :] < window
        mask = near if mask is None else mask & near
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgcs,bskd->bckgd", w, v)


def query_chunks(q, k, v, q_pos, k_pos, q_chunk: int, **kw):
    """Dense attention of the queries ``q`` [B,S,KV,G,hd] in chunks of
    ``q_chunk`` along S, each against the full K/V (the dry-run patches
    this to chunk each rank's own queries)."""
    return torch.cat([_attn_scores_block(q[:, c:c + q_chunk], k, v, q_pos[c:c + q_chunk],
                                         k_pos, **kw)
                      for c in range(0, q.shape[1], q_chunk)], dim=1)


def attention_ctx(cfg: ArchConfig, p: dict, x: torch.Tensor, *, rope, causal: bool = True,
                  window: int | None = None, kv_x: torch.Tensor | None = None,
                  q_chunk: int = Q_CHUNK, return_kv: bool = False):
    """Full-context attention (train / prefill / encoder / cross).  With
    ``kv_x`` (cross-attention) K and V come from it.  Where
    ``prefill_kernel_applies`` (causal inference on the card) the
    flash-attention kernel computes it; otherwise sequences longer than
    ``CHUNK_THRESHOLD`` run in query chunks of ``q_chunk`` (a loop takes the
    place of the reference's ``lax.scan``) and shorter ones in one block."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if rope is not None:
        cos, sin = rope
        q = apply_rotary(q.reshape(B, S, H, hd), cos, sin).reshape(B, S, KV, H // KV, hd)
        k = apply_rotary(k, cos, sin)
    q_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    kw = dict(head_dim=hd, causal=causal, window=window, cap=cfg.attn_softcap)

    if _prefill_kernel_applies(q, k, v, kv_x=kv_x, causal=causal, window=window,
                               cap=cfg.attn_softcap):
        with spans.span(spans.PREFILL_ATTN):
            out = prefill_ops.prefill_attention(q, k, v)
    elif S <= CHUNK_THRESHOLD or S % q_chunk != 0:
        out = _attn_scores_block(q, k, v, q_pos, k_pos, **kw)
    else:
        out = query_chunks(q, k, v, q_pos, k_pos, q_chunk, **kw)

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
