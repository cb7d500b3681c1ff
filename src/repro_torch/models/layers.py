"""Shared neural-net layers: norms, rotary embeddings (RoPE / M-RoPE /
sinusoidal), gated MLPs, embeddings.

Counterpart of ``repro.models.layers``: params are nested dicts of tensors
and every function is a plain function on tensors.  Matmul weights may be
held in the compute dtype already (the reference casts them to it before
every product, so the result is the same); norm params stay float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig


# ---------------------------------------------------------------- norms ----
def init_norm(cfg: ArchConfig, d: int, device: torch.device) -> dict:
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float()
        out = out + p["bias"].float()
    return out.to(x.dtype)


# ------------------------------------------------------------- rotaries ----
def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, head_dim/2] (float32)."""
    ang = positions.float()[..., None] * _inv_freq(head_dim // 2, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, ...]):
    """M-RoPE (Qwen2-VL): positions [3, B, S] (t/h/w) -> cos/sin [B, S,
    head_dim/2] (float32).  The frequency bands are split into ``sections``
    (sum = head_dim/2), each rotated by its own position stream; for text
    tokens the three streams coincide and this is plain RoPE."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim/2 = {half}")
    pos = positions.float()                                          # [3, B, S]
    pos_per_freq = torch.cat([pos[i, ..., None].expand(*pos.shape[1:], s)
                              for i, s in enumerate(sections)], dim=-1)   # [B, S, half]
    ang = pos_per_freq * _inv_freq(half, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [B, S, hd/2] (broadcast over heads), cast to
    x's dtype before the products, as the reference does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_table(seq: int, d: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal positional embedding [seq, d], made in
    float64 with numpy and rounded to float32, as the reference makes it."""
    half = d // 2
    inv = np.exp(-np.log(10000.0) / (half - 1) * np.arange(half))
    ang = np.arange(seq)[:, None] * inv[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return emb.astype(np.float32)


def sinusoidal_embedding(seq: int, d: int) -> torch.Tensor:
    """``sinusoidal_table`` as a float32 tensor on the CPU."""
    return torch.from_numpy(sinusoidal_table(seq, d))


# ----------------------------------------------------------------- MLPs ----
def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """float32 N(0, scale^2) from ``gen``, on ``gen``'s device."""
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def init_mlp(cfg: ArchConfig, gen: torch.Generator, d: int, f: int) -> dict:
    scale_in, scale_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if cfg.act == "silu":
        return {"wg": normal(gen, (d, f), scale_in), "wu": normal(gen, (d, f), scale_in),
                "wd": normal(gen, (f, d), scale_out)}
    return {"wu": normal(gen, (d, f), scale_in), "bu": torch.zeros(f, device=gen.device),
            "wd": normal(gen, (f, d), scale_out), "bd": torch.zeros(d, device=gen.device)}


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    cd = x.dtype
    if cfg.act == "silu":
        g = x @ p["wg"].to(cd)
        u = x @ p["wu"].to(cd)
        return (F.silu(g) * u) @ p["wd"].to(cd)
    h = F.gelu(x @ p["wu"].to(cd) + p["bu"].to(cd), approximate="tanh")
    return h @ p["wd"].to(cd) + p["bd"].to(cd)


# ----------------------------------------------------------- embeddings ----
def init_embedding(cfg: ArchConfig, gen: torch.Generator) -> torch.Tensor:
    return normal(gen, (cfg.vocab, cfg.d_model), 0.02)


def embed_tokens(cfg: ArchConfig, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    x = table[tokens.long()].to(torch_dtype(cfg.compute_dtype))
    if cfg.family == "dense" and cfg.tie_embeddings and cfg.name.startswith("gemma2"):
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32).to(x.dtype)
    return x


def unembed(cfg: ArchConfig, table_or_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab; applies gemma2 final logit soft-capping."""
    logits = x @ table_or_w.to(x.dtype)
    return softcap(logits, cfg.final_softcap)


def softcap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap * tanh(scores / cap) in the scores' dtype (the configs' caps, 30
    and 50, are exact in bf16, so a Python scalar matches the reference's
    cap cast to that dtype)."""
    if not cap:
        return scores
    return cap * torch.tanh(scores / cap)
