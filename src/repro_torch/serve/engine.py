"""Batched LLM serving engine with host-memory context caching (paper §5.3).

Counterpart of ``repro.serve.engine.ServeEngine``:

1. A request arrives with a context key.  On a HOST CACHE MISS the engine
   runs prefill on the device, emits the first token and SAVES the paged KV
   to the pinned host store.  On a HIT it FETCHES the KV blocks back,
   rebuilds the device cache and emits the first token with one decode step
   (no prefill compute).  The fetch backend defaults to the CommBackend's
   ``kv_fetch_plan`` (latte: ``opt_b2b``; reference: per-block ``pcpy``); an
   explicit ``fetch_backend`` overrides the plan.
2. Decode proceeds in batched steps over all active sequences.

TTFT is therefore fetch + rebuild + one decode step on hits, and prefill on
misses.  Wall times synchronize the device before reading the clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.backend import CommBackend
from repro_torch.models import attention as attn_mod
from repro_torch.models.transformer import Model
from .host_store import HostKVStore
from .kvcache import BLOCK_TOKENS, blocks_to_kv, kv_to_blocks


@dataclasses.dataclass
class RequestStats:
    key: str
    cache_hit: bool
    ttft_wall_s: float
    n_transfers: int
    prompt_tokens: int


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, n_new]
    request_stats: list[RequestStats]
    decode_wall_s: float
    tokens_per_s_wall: float


class ServeEngine:
    def __init__(self, model: Model, params, *, host_store: HostKVStore | None = None,
                 comm: CommBackend | None = None, block_tokens: int = BLOCK_TOKENS,
                 device="cuda"):
        cfg = model.cfg
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"serving engine supports decoder-LM families, got {cfg.family}")
        if cfg.layer_pattern:
            raise ValueError("serving engine requires per_unit==1 layer stacking")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.store = host_store or HostKVStore(self.device)
        self.comm = comm or CommBackend("latte")
        self.block_tokens = block_tokens

    # ----------------------------------------------------------- helpers ----
    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _build_cache(self, k: torch.Tensor, v: torch.Tensor, capacity: int) -> list[dict]:
        """k/v [L, B, S, KV, hd] -> per-layer decode caches at ``capacity``."""
        cfg = self.model.cfg
        return [attn_mod.prefill_cache(cfg, k[i], v[i], capacity) for i in range(k.shape[0])]

    def _planned_backend(self, keys: Sequence[str]) -> str:
        """Fetch backend from the CommBackend's plan for these contexts
        (latte requests the optimized command stream -> ``opt_b2b``)."""
        n_blocks, block_bytes = self.store.blocks_for(keys[0])
        plan = self.comm.kv_fetch_plan(n_blocks * len(keys), block_bytes)
        mode = plan["mode"]
        return f"opt_{mode}" if plan.get("optimized") else mode

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1], dim=-1)

    # ------------------------------------------------------------ public ----
    def first_token(self, prompts, keys: Sequence[str], *, fetch_backend: str | None = None,
                    capacity: int | None = None):
        """TTFT path for a batch sharing prompt length.  Returns
        (first_tokens [B] on the device, cache, stats).  ``fetch_backend=None``
        follows the CommBackend's ``kv_fetch_plan``."""
        prompts = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        B, S = prompts.shape
        capacity = capacity or S + 64
        stats = []
        t0 = self._clock()
        if all(k in self.store for k in keys):
            if fetch_backend is None:
                fetch_backend = self._planned_backend(keys)
            ks, vs, n_tr = [], [], 0
            for key in keys:
                res = self.store.fetch(key, fetch_backend)
                kk, vv = blocks_to_kv(res.k_blocks, res.v_blocks, self.store.tokens_for(key))
                ks.append(kk)
                vs.append(vv)
                n_tr += res.n_transfers
            cache = self._build_cache(torch.cat(ks, dim=1), torch.cat(vs, dim=1), capacity)
            logits, cache = self.model.decode_step(
                self.params, {"tokens": prompts[:, -1:], "pos": S - 1}, cache)
            first = self._greedy(logits)
            wall = self._clock() - t0
            stats = [RequestStats(key, True, wall / B, n_tr, S) for key in keys]
        else:
            logits, _, (k, v) = self.model.forward(self.params, {"tokens": prompts},
                                                   want_cache=True)
            first = self._greedy(logits)
            wall = self._clock() - t0
            for b, key in enumerate(keys):
                kb, vb = kv_to_blocks(k[:, b:b + 1], v[:, b:b + 1], self.block_tokens)
                self.store.save(key, kb, vb, S)
                stats.append(RequestStats(key, False, wall / B, 0, S))
            cache = self._build_cache(k, v, capacity)
        return first, cache, stats

    def generate(self, prompts, keys: Sequence[str], n_new: int, *,
                 fetch_backend: str | None = None) -> GenerationResult:
        B, S = prompts.shape
        capacity = S + n_new + 1
        first, cache, stats = self.first_token(prompts, keys, fetch_backend=fetch_backend,
                                               capacity=capacity)
        toks = [first]
        t0 = self._clock()
        for i in range(n_new - 1):
            logits, cache = self.model.decode_step(
                self.params, {"tokens": toks[-1][:, None], "pos": S + i}, cache)
            toks.append(self._greedy(logits))
        dt = self._clock() - t0
        tokens = torch.stack(toks, dim=1).cpu().numpy()
        return GenerationResult(tokens, stats, dt, B * (n_new - 1) / max(dt, 1e-9))
