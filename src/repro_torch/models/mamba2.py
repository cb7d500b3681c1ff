"""Mamba2 (SSD) block per arXiv:2405.21060, as used by Zamba2's backbone.

Counterpart of ``repro.models.mamba2``.  Multi-head selective state space:
per head h of size P = head_size with shared state dimension N = state_size
(ngroups = 1):

    h_t = exp(dt_t · A_h) · h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = h_t · C_t + D_h · x_t

with data-dependent (dt, B, C) projected from the input and a causal
depthwise conv on the x/B/C stream.  The time recurrence is a Python loop
over time steps (the reference's ``lax.scan``), so a forward launches a few
kernels per step and layer: on the card it is bound by the host's launches.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ArchConfig
from .layers import normal

TIME_CHUNK = 256


def _scan(step_body: Callable, carry, seq: tuple):
    """``carry, y_t = step_body(carry, (a[t] for a in seq))`` for every t;
    -> (carry, ys stacked on a leading time axis).  The steps' inputs are
    taken with one ``unbind`` per tensor: its backward stacks the steps'
    gradients in one op, where a select per step would add a zero-filled
    tensor of the whole sequence per step."""
    ys = []
    for inp in zip(*(a.unbind(0) for a in seq)):
        carry, y = step_body(carry, inp)
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_time_scan(step_body: Callable, carry0, seq: tuple):
    """Time scan over the time-major tensors of ``seq`` ([T, ...] each).

    With grad enabled and ``T`` a multiple of ``TIME_CHUNK`` greater than
    it, each chunk of ``TIME_CHUNK`` steps runs under
    ``torch.utils.checkpoint``, as the reference's JAX ``checkpoint`` per
    chunk: the backward keeps one carry per chunk and recomputes the steps
    inside it, instead of keeping the float32 state of every step.  Values
    and gradients are those of the flat loop.
    """
    T = seq[0].shape[0]
    if not torch.is_grad_enabled() or T % TIME_CHUNK != 0 or T <= TIME_CHUNK:
        return _scan(step_body, carry0, seq)
    carry, ys = carry0, []
    for c in range(0, T, TIME_CHUNK):
        carry, y = checkpoint(_scan, step_body, carry,
                              tuple(a[c:c + TIME_CHUNK] for a in seq), use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


def dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """(d_inner, head_size, n_heads, state_size)."""
    d_in = cfg.ssm.expand * cfg.d_model
    hs = cfg.ssm.head_size
    return d_in, hs, d_in // hs, cfg.ssm.state_size


def init_mamba_block(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """float32 params with the reference's distributions."""
    dev = gen.device
    D = cfg.d_model
    d_in, hs, nh, N = dims(cfg)
    K = cfg.ssm.conv_kernel
    conv_dim = d_in + 2 * N
    return {
        # z (gate), x, B, C, dt
        "w_in": normal(gen, (D, 2 * d_in + 2 * N + nh), 1.0 / math.sqrt(D)),
        "conv_w": normal(gen, (K, conv_dim), 0.1),
        "conv_b": torch.zeros(conv_dim, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D_skip": torch.ones(nh, device=dev),
        "dt_bias": torch.full((nh,), -4.0, device=dev),
        "norm_scale": torch.ones(d_in, device=dev),
        "w_out": normal(gen, (d_in, D), 1.0 / math.sqrt(d_in)),
    }


def mamba_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    """Zero decode state: the SSM state ``h`` (float32) and the conv's last
    K - 1 inputs (compute dtype)."""
    d_in, hs, nh, N = dims(cfg)
    K = cfg.ssm.conv_kernel
    return {"h": torch.zeros((batch, nh, hs, N), device=device),
            "conv": torch.zeros((batch, K - 1, d_in + 2 * N),
                                dtype=torch_dtype(cfg.compute_dtype), device=device)}


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    """-> (z, xbc, dt) of the input projection."""
    d_in, hs, nh, N = dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * N, nh], dim=-1)


def _causal_conv(p: dict, xbc: torch.Tensor, conv_state: torch.Tensor | None):
    """Depthwise causal conv over time, xbc [B, T, C], continuing from
    ``conv_state`` (the previous K - 1 inputs; zeros when None).
    -> (silu(conv + bias), the last K - 1 inputs)."""
    K = p["conv_w"].shape[0]
    if conv_state is None:
        conv_state = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[-1]))
    padded = torch.cat([conv_state, xbc], dim=1)
    w = p["conv_w"].to(xbc.dtype)                        # [K, C]
    T = xbc.shape[1]
    out = sum(padded[:, i:i + T] * w[i] for i in range(K))
    out = F.silu(out + p["conv_b"].to(xbc.dtype))
    return out, (padded[:, -(K - 1):] if K > 1 else conv_state)


def _ssm_step(h, inp):
    """One step; every input float32: x [B,nh,hs], B/C [B,N], dt/a [B,nh]."""
    x_t, B_t, C_t, dt_t, a_t = inp
    xb = (dt_t[..., None] * x_t)[..., None] * B_t[:, None, None, :]
    h = a_t[..., None, None] * h + xb                    # [B, nh, hs, N]
    y = torch.einsum("bhpn,bn->bhp", h, C_t)
    return h, y


def apply_mamba_block(cfg: ArchConfig, p: dict, x: torch.Tensor, state: dict | None = None):
    """x [B, T, D] -> (y [B, T, D], new state); ``state=None`` starts from
    zeros (training, prefill)."""
    B, T, D = x.shape
    d_in, hs, nh, N = dims(cfg)
    cd = x.dtype
    proj = x @ p["w_in"].to(cd)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(p, xbc, None if state is None else state["conv"])
    xs, Bmat, Cmat = torch.split(xbc, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, T, nh, hs)
    dt = F.softplus(dt.float() + p["dt_bias"].float())   # [B, T, nh]
    A = -torch.exp(p["A_log"].float())                    # [nh]
    decay = torch.exp(dt * A)                             # [B, T, nh]

    h0 = x.new_zeros((B, nh, hs, N), dtype=torch.float32) if state is None else state["h"]
    # the reference casts x, B and C to float32 inside each step; casting the
    # whole sequence first gives the same values with one launch, not T
    seq = tuple(a.float().movedim(1, 0) for a in (xs, Bmat, Cmat, dt, decay))
    h, ys = chunked_time_scan(_ssm_step, h0, seq)
    y = ys.movedim(0, 1)                                  # [B, T, nh, hs] f32
    y = y + p["D_skip"].float()[None, None, :, None] * xs.float()
    y = y.reshape(B, T, d_in).to(cd)

    # gated RMS norm + out projection
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    out = yf.to(cd) @ p["w_out"].to(cd)
    return out, {"h": h, "conv": conv_state}
