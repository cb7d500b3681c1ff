"""RWKV-6 "Finch" block: data-dependent-decay linear attention (time-mix)
plus channel-mix, per arXiv:2404.05892.

Counterpart of ``repro.models.rwkv6``, with its simplifications: the decay
is ``w = exp(-exp(w0 + lora(x)))`` with a per-head bonus ``u`` and a
squared-ReLU channel-mix, and the token shift uses static interpolation
weights (no ddlerp LoRA on the shift mix).

State per layer: S [B, n_heads, head, head] in float32 plus the last input
of each mix, O(1) in sequence length.  The recurrence is
``mamba2.chunked_time_scan``, a Python loop over time steps.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from .layers import normal
from .mamba2 import chunked_time_scan

LORA_RANK = 64


def init_rwkv_block(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """float32 params with the reference's distributions."""
    dev = gen.device
    D, F_ = cfg.d_model, cfg.d_ff
    hs = cfg.ssm.head_size
    nh = D // hs
    s = 1.0 / math.sqrt(D)
    return {
        "tm": {  # time-mix
            "mu": torch.full((5, D), 0.5, device=dev),  # r, k, v, g, w shift mixes
            "w0": torch.full((D,), -6.0, device=dev),
            "wA": normal(gen, (D, LORA_RANK), s),
            "wB": normal(gen, (LORA_RANK, D), 1.0 / math.sqrt(LORA_RANK)),
            "wr": normal(gen, (D, D), s),
            "wk": normal(gen, (D, D), s),
            "wv": normal(gen, (D, D), s),
            "wg": normal(gen, (D, D), s),
            "wo": normal(gen, (D, D), s),
            "u": torch.zeros((nh, hs), device=dev),
            "ln_scale": torch.ones(D, device=dev),
        },
        "cm": {  # channel-mix
            "mu": torch.full((2, D), 0.5, device=dev),  # k, r
            "wk": normal(gen, (D, F_), s),
            "wv": normal(gen, (F_, D), 1.0 / math.sqrt(F_)),
            "wr": normal(gen, (D, D), s),
        },
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x[t-1] (zeros, or the carried input, at t = 0).  x [B, T, D]."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    D = cfg.d_model
    hs = cfg.ssm.head_size
    cd = torch_dtype(cfg.compute_dtype)
    return {"S": torch.zeros((batch, D // hs, hs, hs), device=device),
            "x_tm": torch.zeros((batch, 1, D), dtype=cd, device=device),
            "x_cm": torch.zeros((batch, 1, D), dtype=cd, device=device)}


def _wkv_step(S, r_t, k_t, v_t, w_t, u):
    """One recurrence step.  S [B, nh, hs, hs]; r/k/v/w [B, nh, hs]; u [nh, hs].

    y_t = r · (S + u ⊙ kᵀv);  S' = diag(w) S + kᵀ v
    """
    kv = k_t[..., :, None] * v_t[..., None, :]           # [B, nh, hs, hs]
    y = torch.einsum("bhi,bhij->bhj", r_t, S + u[..., :, None] * kv)
    S = w_t[..., :, None] * S + kv
    return S, y


def time_mix(cfg: ArchConfig, p: dict, x: torch.Tensor, state: dict | None = None):
    """x [B, T, D] -> (y [B, T, D], new state); ``state=None`` starts from
    zeros (training, prefill)."""
    B, T, D = x.shape
    hs = cfg.ssm.head_size
    nh = D // hs
    cd = x.dtype
    xs = _shift(x, None if state is None else state["x_tm"])
    mu = p["mu"].to(cd)
    xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))
    r = (xr @ p["wr"].to(cd)).reshape(B, T, nh, hs)
    k = (xk @ p["wk"].to(cd)).reshape(B, T, nh, hs)
    v = (xv @ p["wv"].to(cd)).reshape(B, T, nh, hs)
    g = F.silu(xg @ p["wg"].to(cd))
    # data-dependent decay (the Finch contribution)
    lora = torch.tanh(xw @ p["wA"].to(cd)) @ p["wB"].to(cd)
    w = torch.exp(-torch.exp(p["w0"].float() + lora.float())).reshape(B, T, nh, hs)

    S0 = x.new_zeros((B, nh, hs, hs), dtype=torch.float32) if state is None else state["S"]
    u = p["u"].float()

    def body(S, inp):
        return _wkv_step(S, *inp, u)

    # the reference casts r, k and v to float32 inside each step; casting the
    # whole sequence first gives the same values with one launch, not T
    S, ys = chunked_time_scan(body, S0, tuple(a.float().movedim(1, 0) for a in (r, k, v, w)))
    y = ys.movedim(0, 1).to(cd)                          # [B, T, nh, hs]

    # per-head group norm (population variance, as jnp.var)
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = ((yf - mean) * torch.rsqrt(var + 1e-5)).reshape(B, T, D)
    yn = (yn * p["ln_scale"].float()).to(cd)
    out = (yn * g) @ p["wo"].to(cd)
    return out, {"S": S, "x_tm": x[:, -1:], "x_cm": None}


def channel_mix(cfg: ArchConfig, p: dict, x: torch.Tensor, state: dict | None = None):
    """-> (y, the last input, carried to the next call)."""
    cd = x.dtype
    xs = _shift(x, None if state is None else state["x_cm"])
    mu = p["mu"].to(cd)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(F.relu(xk @ p["wk"].to(cd)))
    r = torch.sigmoid(xr @ p["wr"].to(cd))
    return r * (k @ p["wv"].to(cd)), x[:, -1:]


def apply_rwkv_block(cfg: ArchConfig, p: dict, x: torch.Tensor, norms: tuple, apply_norm,
                     state: dict | None = None):
    """Pre-norm residual block: time-mix + channel-mix -> (x, new state)."""
    n1, n2 = norms
    tm_out, new_state = time_mix(cfg, p["tm"], apply_norm(n1, x), state)
    x = x + tm_out
    cm_out, x_cm_last = channel_mix(cfg, p["cm"], apply_norm(n2, x), state)
    new_state["x_cm"] = x_cm_last
    return x + cm_out, new_state
