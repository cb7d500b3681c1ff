"""Plain PyTorch version of paged flash-decode attention."""
from __future__ import annotations

import torch


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *, softcap=None):
    """q [B,KV,G,hd]; pools [n,bt,KV,hd]; tables [B,max_blocks]; lengths [B].

    As in the Pallas kernel, positions at or past a sequence's length weigh
    exactly 0 and the normalizer is floored at 1e-30, so a sequence of length
    <= 0 gives 0."""
    B, KV, G, hd = q.shape
    _, bt, _, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    scale = 1.0 / (hd ** 0.5)
    pos = torch.arange(max_blocks * bt, device=q.device)
    outs = []
    for b in range(B):
        tbl = block_tables[b].long()
        k = k_pool[tbl].reshape(max_blocks * bt, KV, hd).float()
        v = v_pool[tbl].reshape(max_blocks * bt, KV, hd).float()
        s = torch.einsum("kgd,skd->kgs", q[b].float(), k) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        valid = pos[None, None, :] < lengths[b]
        s = torch.where(valid, s, -1e30)
        w = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
        l = w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        outs.append(torch.einsum("kgs,skd->kgd", w, v) / l)
    return torch.stack(outs).to(q.dtype)
