"""Workload-level (LLM inference) performance composition for §5.3.

TTFT at 100% CPU-cache hit = KV fetch (host->device over PCIe, via the
calibrated DMA engine model) + one decode step (HBM-bound on MI300X) +
framework overhead.  Throughput overlaps fetch with model execution for the
optimized DMA path (free CUs) but serializes under CU contention for the
kernel path — the paper's §2.4 argument.

LLM specs are the public models the paper evaluates (Qwen2.5, Llama 3.x,
DeepSeek-R1-Distill-32B).
"""
from __future__ import annotations

import dataclasses

from .dma import kv_fetch_schedule, mi300x_platform, simulate
from .dma.rccl_model import kernel_copy_latency

MI300X_HBM_BW = 5.3e12          # bytes/s
BLOCK_TOKENS = 16
FRAMEWORK_OVERHEAD = 1.6e-3     # python/vLLM scheduler, per request
API_CALL_COST = 3.0e-6          # one hipMemcpyAsync call on the CPU
BATCH_API_COST = 100.0e-6        # one hipMemcpyBatchAsync call (setup+teardown)
N_BATCH_CALLS = 6               # b2b path issues a few batch calls per fetch
KERNEL_LAUNCH = 10.0e-6
KERNEL_WIRE_EFF = 0.90          # CU gather kernel PCIe efficiency
KERNEL_CONTENTION = 1.35        # CU fetch slows overlapped model compute (§2.4)


@dataclasses.dataclass(frozen=True)
class LLMSpec:
    name: str
    params_b: float          # billions
    n_layers: int
    n_kv_heads: int
    head_dim: int

    @property
    def kv_bytes_per_token(self) -> int:
        return self.n_layers * self.n_kv_heads * self.head_dim * 2 * 2  # K+V bf16


PAPER_LLMS = (
    LLMSpec("qwen2.5-0.5b", 0.5, 24, 2, 64),
    LLMSpec("llama3.2-1b", 1.2, 16, 8, 64),
    LLMSpec("qwen2.5-7b", 7.6, 28, 4, 128),
    LLMSpec("llama3.1-8b", 8.0, 32, 8, 128),
    LLMSpec("r1-distill-qwen-32b", 32.8, 64, 8, 128),
)


def fetch_time(spec: LLMSpec, prompt: int, backend: str) -> float:
    """Host->device KV fetch for `prompt` cached tokens.

    ``opt_b2b`` is the batched path with the optimized command stream
    (DESIGN.md §7/§8) — what the serving engine's ``kv_fetch_plan`` requests
    for the latte backend.
    """
    topo = mi300x_platform()
    n_blocks = (prompt + BLOCK_TOKENS - 1) // BLOCK_TOKENS
    block_bytes = spec.kv_bytes_per_token * BLOCK_TOKENS
    if backend == "kernel":
        wire = n_blocks * block_bytes / (topo.host_link_bw * KERNEL_WIRE_EFF)
        return KERNEL_LAUNCH + wire
    if backend == "pcpy":
        sched = kv_fetch_schedule(topo, n_blocks, block_bytes, "pcpy")
        # one hipMemcpyAsync per block, serialized on the host
        return simulate(sched, topo).latency + n_blocks * API_CALL_COST
    variant = "opt_prelaunch_b2b" if backend == "opt_b2b" else "prelaunch_b2b"
    sched = kv_fetch_schedule(topo, n_blocks, block_bytes, variant)
    return simulate(sched, topo).latency + N_BATCH_CALLS * BATCH_API_COST


def decode_step_time(spec: LLMSpec, batch: int = 1) -> float:
    """One decode step: weight-read bound (bf16 params over HBM)."""
    weight = spec.params_b * 1e9 * 2 / MI300X_HBM_BW
    return weight * max(1.0, 0.15 * batch)   # mild batch scaling


def ttft(spec: LLMSpec, prompt: int, backend: str) -> dict:
    """Returns gpu-side and total TTFT at 100% KV cache hit."""
    f = fetch_time(spec, prompt, backend)
    d = decode_step_time(spec)
    gpu = f + d
    total = gpu + FRAMEWORK_OVERHEAD
    return {"fetch": f, "decode": d, "gpu": gpu, "total": total}


def throughput(spec: LLMSpec, prompt: int, backend: str, *,
               hit_rate: float = 1.0, requests: int = 2000) -> float:
    """Steady-state tokens/s with many concurrent requests.

    Optimized DMA fetch overlaps with model execution (free CUs) ->
    pipeline is max(fetch, compute).  Baseline pcpy serializes most of its
    launch/sync overhead with execution; kernel fetch overlaps but slows
    compute via CU/cache contention.
    """
    f = fetch_time(spec, prompt, backend)
    batch = 32
    step = decode_step_time(spec, batch)
    exec_per_req = step * 24 / batch            # amortized decode of ~24 tokens
    miss_prefill = 2 * spec.params_b * 1e9 * prompt / 1.3e15 * (1 - hit_rate)
    if backend in ("b2b", "opt_b2b"):
        per_req = max(f, exec_per_req) + miss_prefill
    elif backend == "kernel":
        per_req = max(f, exec_per_req * KERNEL_CONTENTION) + miss_prefill
    else:  # pcpy: launch/sync storms serialize with execution
        per_req = 0.70 * f + exec_per_req + miss_prefill
    return 24.0 / per_req
