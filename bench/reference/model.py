"""Plain PyTorch reference of the decoder LMs the benchmark serves.

It follows the configuration file (``bench/configs/*.json``) and the
published description, and imports nothing but torch: every product in
float32 with TF32 off, no kernel of the program.  It reads the benchmark's
weights (``harness/model.py`` makes them from the seed) and upcasts each
leaf where it is used.

Serving runs in two stages, as the served calls do.  ``prefill`` runs a
group of prompts as one call and keeps their keys and values; ``extend``
runs more tokens of some of those sequences against them.  The MoE's
capacity rule makes a token's output depend on every token routed in the
same call, so the group has to be the served call's: the batch of a fresh
prefill, or the set of documents the pool's fill prefilled together.

* RMSNorm with the file's eps; rotary embeddings on the first and second
  half of each head (theta from the file).  Qwen2-VL's M-RoPE splits the
  frequency bands into t/h/w sections, each rotated by its own position
  stream; text tokens give the three streams the same position, so every
  band rotates by the token's position.
* Causal grouped-query attention (query head h reads KV head h // (H / KV)),
  scores scaled by 1/sqrt(head_dim), softmax in float32.
* A SiLU-gated MLP, or OLMoE's MoE: a float32 softmax router, the top-k
  experts, their weights renormalised to sum to 1 (``norm_topk_prob``), and
  the capacity rule the file states: an expert takes at most
  C = ceil(T * k / E * capacity_factor) (at least 8, rounded up to a
  multiple of 8, or of 128 from 128 on) of a call's T tokens, in the call's
  token order (sequence by sequence), and drops the rest.  ``prefill``
  applies it over the group; ``extend`` routes without a capacity, as a
  decode call of B <= 8 tokens never reaches one (C >= 8).

``precision`` rounds the operands of every product; ``fp8`` is the control:
each operand scaled by its absolute maximum to float8 e4m3 and back, the
step below the bf16 that the configurations state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Q_CHUNK = 1024
ROW_CHUNK = 4096


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(torch.float8_e4m3fn).max
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


PRECISIONS = {"fp32": exact, "fp8": fp8}


def _w(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _w(scale)


def rotary_angles(cfg: dict, positions: torch.Tensor):
    """cos, sin [T, head_dim / 2] for text positions [T]."""
    half = cfg["head_dim"] // 2
    inv = 1.0 / (float(cfg["rope_theta"]) ** (torch.arange(half, dtype=torch.float64,
                                                           device=positions.device) / half))
    rope = cfg.get("rope_scaling") or {}
    streams = torch.stack([positions] * 3).double()              # t, h, w: equal for text
    if rope.get("type") == "mrope":
        band = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                       torch.tensor(rope["mrope_section"],
                                                    device=positions.device))
        pos = streams[band].T                                    # [T, half]
    else:
        pos = streams[0][:, None].expand(-1, half)
    ang = pos * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, heads, hd]; the first half pairs with the second."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(cfg: dict, p: dict, h: torch.Tensor, cos, sin, past, q_):
    """h [G, T, D] at positions P..P+T-1 after ``past`` = (k, v) [G, P, KV, hd]
    (or None) -> (output [G, T, D], this call's (k, v) [G, T, KV, hd])."""
    G, T, D = h.shape
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    x = q_(h.reshape(G * T, D))
    q, k, v = (x @ q_(_w(p[n])) for n in ("wq", "wk", "wv"))
    if cfg["attention_bias"]:
        q, k, v = q + _w(p["bq"]), k + _w(p["bk"]), v + _w(p["bv"])
    q = rotate(q.view(G, T, H, hd), cos, sin)
    k = rotate(k.view(G, T, KV, hd), cos, sin)
    v = v.view(G, T, KV, hd)
    keys, vals = (k, v) if past is None else (torch.cat([past[0], k], 1), torch.cat([past[1], v], 1))
    P = keys.shape[1] - T
    out = torch.empty(G, T, H, hd, device=h.device)
    for g in range(G):
        kg = q_(keys[g].repeat_interleave(H // KV, dim=1))
        vg = q_(vals[g].repeat_interleave(H // KV, dim=1))
        qg = q_(q[g])
        for lo in range(0, T, Q_CHUNK):
            hi = min(lo + Q_CHUNK, T)
            scores = torch.einsum("qhd,khd->hqk", qg[lo:hi], kg[:P + hi]) / math.sqrt(hd)
            causal = (torch.arange(P + lo, P + hi, device=h.device)[:, None]
                      >= torch.arange(P + hi, device=h.device)[None, :])
            w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            out[g, lo:hi] = torch.einsum("hqk,khd->qhd", q_(w), vg[:P + hi])
    y = q_(out.reshape(G * T, H * hd)) @ q_(_w(p["wo"]))
    return y.view(G, T, D), (k, v)


def mlp(p: dict, h: torch.Tensor, q_) -> torch.Tensor:
    wg, wu, wd = (q_(_w(p[n])) for n in ("wg", "wu", "wd"))
    x = q_(h)
    out = torch.empty_like(h)
    for lo in range(0, h.shape[0], ROW_CHUNK):
        xs = x[lo:lo + ROW_CHUNK]
        out[lo:lo + ROW_CHUNK] = q_(F.silu(xs @ wg) * (xs @ wu)) @ wd
    return out


def capacity(cfg: dict, n_tokens: int) -> int:
    cap = math.ceil(n_tokens * cfg["num_experts_per_tok"] / cfg["num_experts"]
                    * cfg["capacity_factor"])
    mult = 128 if cap >= 128 else 8
    return max(8, math.ceil(cap / mult) * mult)


def moe(cfg: dict, p: dict, h: torch.Tensor, q_, cap: int | None, drops: list) -> torch.Tensor:
    """OLMoE's expert layer over one call's tokens h [T, D], in token order;
    ``cap`` None routes without a capacity."""
    E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ _w(p["router"]), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    if cfg["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    out = torch.zeros_like(h)
    x = q_(h)
    for e in range(E):
        idx = (flat_e == e).nonzero().squeeze(1)             # (token, k) in token order
        if cap is not None:
            drops.append(max(0, idx.numel() - cap))
            idx = idx[:cap]
        if idx.numel() == 0:
            continue
        tok = idx // K
        xe = x[tok]
        g = F.silu(xe @ q_(_w(p["wg"][e]))) * (xe @ q_(_w(p["wu"][e])))
        out.index_add_(0, tok, (q_(g) @ q_(_w(p["wd"][e]))) * flat_p[idx, None])
    return out


def _layers(cfg: dict, weights: dict, tokens: torch.Tensor, start: int, past, cap, q_,
            drops: list):
    """tokens [G, T] at positions start.. -> (final hidden [G, T, D], [(k, v)] a layer)."""
    G, T = tokens.shape
    eps = cfg["rms_norm_eps"]
    x = _w(weights["embed"][tokens])
    cos, sin = rotary_angles(cfg, torch.arange(start, start + T, device=tokens.device))
    kv = []
    for i, p in enumerate(weights["blocks"]):
        y, kv_i = attention(cfg, p["attn"], rms_norm(x, p["ln1"]["scale"], eps), cos, sin,
                            None if past is None else past(i), q_)
        x = x + y
        kv.append(kv_i)
        h = rms_norm(x, p["ln2"]["scale"], eps).reshape(G * T, -1)
        f = moe(cfg, p["moe"], h, q_, cap, drops) if "moe" in p else mlp(p["mlp"], h, q_)
        x = x + f.view(G, T, -1)
    return rms_norm(x, weights["final_norm"]["scale"], eps), kv


def _head(cfg: dict, weights: dict, h: torch.Tensor, q_) -> torch.Tensor:
    head = weights["embed"].T if cfg["tie_word_embeddings"] else weights["unembed"]
    return q_(h) @ q_(_w(head))


class _Precision:
    def __init__(self, precision: str):
        self.q_ = PRECISIONS[precision]

    def __enter__(self):
        self.tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        return self.q_

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.tf32
        return False


@torch.no_grad()
def prefill(cfg: dict, weights: dict, prompts: torch.Tensor, precision: str = "fp32",
            drops: list | None = None):
    """One served prefill call over prompts [G, S]: (last-position logits
    [G, vocab], [(k, v)] a layer, each [G, S, KV, hd]); the MoE capacity is
    the call's, over its G * S tokens."""
    with _Precision(precision) as q_:
        G, S = prompts.shape
        cap = capacity(cfg, G * S) if cfg["family"] == "moe" else None
        h, kv = _layers(cfg, weights, prompts, 0, None, cap, q_, [] if drops is None else drops)
        return _head(cfg, weights, h[:, -1], q_), kv


@torch.no_grad()
def extend(cfg: dict, weights: dict, kv, rows: list[int], keep: int, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """Logits [R, T, vocab] of tokens [R, T] at positions keep..keep+T-1 of
    the prefilled sequences ``rows``, each against its first ``keep`` keys
    and values; routed without a capacity (decode calls)."""
    with _Precision(precision) as q_:
        index = torch.as_tensor(rows, device=tokens.device)
        past = lambda i: (kv[i][0][index, :keep], kv[i][1][index, :keep])  # noqa: E731
        h, _ = _layers(cfg, weights, tokens, keep, past, None, q_, [])
        return _head(cfg, weights, h, q_)
