"""Host-memory KV store for context caching (paper §5.3), on pinned memory.

Counterpart of ``repro.serve.host_store``.  KV of finished/parked contexts
is SAVED to pinned host memory (the "CPU DRAM tier") in paged blocks and
FETCHED back to the device on a cache hit instead of re-running prefill.
The fetch backends are the paper's comparison, copy engine vs SM kernel:

* ``pcpy``    - one ``non_blocking`` host-to-device copy per block, for K
                and V (the baseline: one copy-engine transfer per dispersed
                block), so ``2 * n_blocks`` transfers.
* ``b2b``     - the blocks are chained into ONE pinned staging buffer and
                moved with one host-to-device copy (the batched transfer).
* ``opt_b2b`` - the same bytes and the same copy as ``b2b``; the two differ
                only in their modeled command stream (batched submission +
                fused write+signal).
* ``kernel``  - each pool moves to the device once as
                ``[n_blocks, block_tokens, L * KV * hd]``, then the SM gather
                kernel (``kernels/paged_kv_gather``) reassembles the blocks
                with the table ``arange(n_blocks)``: two launches per context.

Each fetch also returns ``modeled_seconds``, the MODELED latency of the
same fetch on the reference's platform: the MI300X-calibrated DMA engine
model (``core.dma``) for the copy backends, the CU-kernel copy model for
``kernel``, computed exactly as the reference computes it.  It is not a
measurement on the card.  It depends only on (backend, n_blocks,
block_bytes), so each store computes it once per key.

The fetched blocks stay on the device.  On a store built for the CPU
(``device="cpu"``) the host memory is not pinned and the "transfers" are
host copies, so the same code paths run in the CPU tests.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compat import resolve_device
from repro_torch.core.dma import kv_fetch_schedule, mi300x_platform, simulate
from repro_torch.core.dma.rccl_model import kernel_copy_latency
from repro_torch.kernels.paged_kv_gather.ops import gather_blocks
from repro_torch.spans import STAGE, span

BACKENDS = ("pcpy", "b2b", "opt_b2b", "kernel")


@dataclasses.dataclass
class FetchResult:
    k_blocks: torch.Tensor      # [n_blocks, bt, L, KV, hd] on the device
    v_blocks: torch.Tensor
    n_transfers: int
    modeled_seconds: float      # MI300X engine/kernel model latency, not measured


# fetch backend -> the modeled command stream of its copies
_MODELED_VARIANT = {"pcpy": "pcpy", "b2b": "prelaunch_b2b", "opt_b2b": "opt_prelaunch_b2b"}


class HostKVStore:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self._store: dict[str, tuple[torch.Tensor, torch.Tensor, int]] = {}
        self.topo = mi300x_platform()
        self._modeled: dict[tuple[str, int, int], float] = {}

    def _host(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self._pin)

    # ------------------------------------------------------------- save ----
    def save(self, key: str, k_blocks: torch.Tensor, v_blocks: torch.Tensor,
             n_tokens: int) -> None:
        """Copy the blocks [n_blocks, bt, L, KV, hd] (any device) to host memory."""
        kb = self._host(k_blocks.shape, k_blocks.dtype)
        vb = self._host(v_blocks.shape, v_blocks.dtype)
        kb.copy_(k_blocks)
        vb.copy_(v_blocks)
        self._store[key] = (kb, vb, n_tokens)

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def tokens_for(self, key: str) -> int:
        return self._store[key][2]

    def host_blocks(self, key: str) -> tuple[torch.Tensor, torch.Tensor]:
        """The stored (k_blocks, v_blocks) host tensors of a context."""
        kb, vb, _ = self._store[key]
        return kb, vb

    def blocks_for(self, key: str) -> tuple[int, int]:
        """(n_blocks, bytes per K+V block) of a stored context: the inputs
        ``CommBackend.kv_fetch_plan`` needs to plan the fetch."""
        kb, vb, _ = self._store[key]
        return kb.shape[0], (kb[0].numel() * kb.element_size()
                             + vb[0].numel() * vb.element_size())

    def modeled_seconds(self, backend: str, n_blocks: int, block_bytes: int) -> float:
        """Modeled latency of fetching ``n_blocks`` K+V blocks of
        ``block_bytes`` through ``backend``, memoized per argument triple."""
        key = (backend, n_blocks, block_bytes)
        if key not in self._modeled:
            if backend == "kernel":
                lat = kernel_copy_latency(self.topo, n_blocks * block_bytes, n_launches=1)
            else:
                sched = kv_fetch_schedule(self.topo, n_blocks, block_bytes,
                                          _MODELED_VARIANT[backend])
                lat = simulate(sched, self.topo).latency
            self._modeled[key] = lat
        return self._modeled[key]

    # ------------------------------------------------------------ fetch ----
    def fetch(self, key: str, backend: str = "b2b") -> FetchResult:
        kb, vb, _ = self._store[key]
        n_blocks, block_bytes = self.blocks_for(key)
        dev = self.device

        if backend == "pcpy":
            k_out = torch.empty(kb.shape, dtype=kb.dtype, device=dev)
            v_out = torch.empty(vb.shape, dtype=vb.dtype, device=dev)
            for i in range(n_blocks):
                k_out[i].copy_(kb[i], non_blocking=True)
            for i in range(n_blocks):
                v_out[i].copy_(vb[i], non_blocking=True)
            n_transfers = 2 * n_blocks
        elif backend in ("b2b", "opt_b2b"):
            ksz = kb[0].numel()
            staged = self._host((n_blocks, ksz + vb[0].numel()), kb.dtype)
            with span(STAGE):
                torch.cat([kb.reshape(n_blocks, -1), vb.reshape(n_blocks, -1)], dim=1,
                          out=staged)
            moved = torch.empty(staged.shape, dtype=staged.dtype, device=dev)
            moved.copy_(staged, non_blocking=True)
            k_out, v_out = moved[:, :ksz].reshape(kb.shape), moved[:, ksz:].reshape(vb.shape)
            n_transfers = 1
        elif backend == "kernel":
            tbl = torch.arange(n_blocks, dtype=torch.int32, device=dev)
            outs = []
            for blocks in (kb, vb):
                pool = torch.empty((n_blocks, blocks.shape[1], blocks[0, 0].numel()),
                                   dtype=blocks.dtype, device=dev)
                pool.copy_(blocks.reshape(pool.shape), non_blocking=True)
                outs.append(gather_blocks(pool, tbl).reshape(blocks.shape))
            k_out, v_out = outs
            n_transfers = 1
        else:
            raise ValueError(f"unknown fetch backend {backend!r}; known: {BACKENDS}")
        return FetchResult(k_out, v_out, n_transfers,
                           self.modeled_seconds(backend, n_blocks, block_bytes))
