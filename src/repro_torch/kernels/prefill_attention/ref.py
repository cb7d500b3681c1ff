"""Plain PyTorch version of the causal flash-attention prefill."""
from __future__ import annotations

import torch


def prefill_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,S,KV,G,hd]; k/v [B,S,KV,hd]; causal (query s sees keys 0..s).

    The kernel's arithmetic: scores and softmax in float32, scaled by
    1/sqrt(hd); the unnormalized probabilities exp(s - max) rounded to q's
    dtype before the product with V, which accumulates in float32; the sum
    over the float32 probabilities divides at the end.  [B,S,KV,G,hd] in
    q's dtype."""
    S, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) / hd ** 0.5
    pos = torch.arange(S, device=q.device)
    scores = scores.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).float(), v.float())
    return (out / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]).to(q.dtype)
