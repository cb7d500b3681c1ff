#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. Card: name and power limit from nvidia-smi.
2. Build: compile every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``.
3. Kernels vs their plain PyTorch versions at the serving shapes: B1
   ``paged_kv_gather`` bit-equal (bf16, f32) at the pool shapes of both
   served models; B2 ``paged_decode_attention``
   at atol/rtol 1e-5 (f32) and 2e-2 (bf16), with and without softcap, also
   for zero-length sequences (exactly 0), lengths 1 and bt + 1 (most of the
   S splits empty) and a 4096-token context, and unchanged when K/V past
   each length are poisoned; B1 also at qwen2-vl-72b's pool shape.  Times
   by CUDA events (median of 50 after warm-up) beside each kernel's bound.
   Tables padded past each length with -1, n_pool and 1000: B1 bit-equal
   to its plain version (zero blocks there), B2 within its tolerances.
3b. The causal flash-attention prefill kernel (``csrc/prefill_attention.cu``)
   at qwen2-vl-72b's served prefill (bf16, B 8, KV 8, G 8, S 2048, hd 128)
   and olmoe-1b-7b's fill (B 8, KV 16, G 1, S 4080): against a float32
   causal attention (atol/rtol 1e-2: the output's bf16 rounding) and the
   port's dense path; device ms beside the tensor-core bound (the causal
   FLOPs at 989 TFLOP/s) and the share of it reached, the dense path's ms
   and ``scaled_dot_product_attention``'s (the library yardstick only).
4. Serving qwen2-0.5b at full width (24 layers, bf16, random weights from a
   seed): batch 4, context 1024, 16 new tokens; one miss pass, then a hit
   through each fetch backend.  Fetched blocks must be bit-equal to the
   saved ones, hit tokens identical across backends, the ``kernel``
   pass must launch B1 exactly 2 x batch times, and every hit must carry a
   modeled (MI300X simulator) fetch latency > 0, a miss none.  The prefill's
   call ms carries the port's roofline of the same prefill (``roofline``:
   compute and memory ms, the dominant term, the costing's FLOPs and
   useful ratio, from ``roofline.costing`` on a (1, 1) mesh).
5. Exactness: the same widths at 2 layers in float32 (TF32 off): every hit
   backend's tokens must equal the miss path's.
6. Collective kernels vs their plain versions over 8 ranks emulated on the
   card (and 6 for B4's rotation pairing), in bf16 and f32, at 64 KiB, 1 MiB,
   16 MiB and 256 MiB gathered per rank: every B3 ``ring_all_gather`` and B4
   ``all_to_all`` variant bit-equal; bf16 times beside the bytes bound
   (input + output bytes at 3.35 TB/s), the plain version and the one-call library
   yardstick (device and call ms); at 64 KiB and 1 MiB the host µs per
   call of every variant and of the library call (300 calls behind a sleep
   kernel); at 64 KiB the time per ring step, whole (time / steps) and
   marginal (8 ranks against 2, same chunks).
7. The collectives path (counts zeroed just before, read just after):
   ``CommBackend('latte', axis_devices=8)`` runs all-gather, all-to-all,
   reduce-scatter and all-reduce (f32) on the card, then one latte MoE layer
   of olmoe-1b-7b at full width (d_model 2048, 64 experts, top-8, d_ff 1024,
   capacity factor 1.25, bf16, 8 ranks x 512 tokens), then the same layer
   at decode size (8 ranks x 4 tokens, capacity 4: B4 at [8, 8, 32, 2048],
   1 MiB a rank).  Checks: collectives against numpy (AG/AA bit-equal,
   RS/AR atol 1e-4), B3 and B4 launched, each MoE forward launching B4
   exactly twice and bit-equal to the same layer with B4's plain version;
   B4's device, call and host times at the decode shape beside
   ``transpose(0, 1).contiguous()``'s and the decode forward's call ms; a
   float32 run at the same widths with no drops against a dense oracle.
7b. The collectives with one rank per process (``collectives_procs``):
   ``core.procgroup.spawn`` starts 4 processes on the card (every rank on
   cuda:0: their kernels take turns by time slice), each launching only its
   own rank of B3 (``b2b``, ``bcst_b2b``) and B4 (``b2b``, ``per_round``)
   and storing into its peers' memory through CUDA IPC with system-scope
   flags, at 64 KiB, 1 MiB and 64 MiB a rank in bf16 and f32; then 8
   processes at 1 MiB (the paper's node size), and 6 for B4's rotation
   pairing.  Every rank's result must be bit-equal to the numpy oracle and
   to the emulated single launch on the same inputs; a failure on any rank
   fails the run.  ``[procs]`` lines give each rank's call ms (bf16, median
   of 5, all ranks released together by a gloo barrier): processes
   time-sliced on one card, not an interconnect figure and not a speed
   result.  At 4 processes also the ring reduce-scatter per rank
   (``csrc/ring_reduce_scatter.cu``) and the ring all-reduce (it, then B3
   ``b2b`` per rank) at 64 KiB and 1 MiB a rank, bf16 and f32, bit-equal
   to the emulated rendering and within numpy's sum (f32 atol 1e-4; bf16
   one ulp, 2^-7, of sum_e |x_e| per add); and olmoe-1b-7b's latte MoE
   layer per rank at full width (``make_latte_moe`` with a
   ``ProcessRanks``: d_model 2048, 64 experts, top-8, d_ff 1024, capacity
   factor 1.25, bf16) at prefill size (512 tokens a rank) and decode size
   (4), bit-equal to the emulated layer on the same tokens and weights,
   each forward launching B4 per rank exactly twice; a ``[procs-moe]`` line
   holds the expert products at batch E against batch E / n on the same
   rows.  At 8 processes the ring reduce-scatter at 1 MiB too.  The
   per-rank launches are counted in each process (set to 0 just before)
   and summed as ``launches_by_path["procs"]``; the reduce-scatter kernel's
   row of the kernels line takes its per-rank call ms at 4 processes and 1
   MiB, beside the emulated rendering's and ``sum(0)``'s device ms on the
   same global input.
8. Serving olmoe-1b-7b at full width (16 layers, d_model 2048, 16 heads,
   64 experts, top-8, d_ff_expert 1024, capacity factor 1.25, vocab 50,304,
   bf16, random weights from a seed) with phase 4's batch, context, checks
   and times; then its exactness pass as phase 5, at capacity factor 8
   (= experts / top-k, no drops: a hit routes its first token among 4
   tokens, the miss among 4 x 1024).
9. The variants ``CommBackend('latte', axis_devices=n)`` picks for n = 4, 8
   and 16, from modeled TPU-pod tables of the port's own DMA simulator.
10. Training qwen2-0.5b at full width through ``train.loop.train_loop``
    (bf16 compute on float32 masters, AdamW lr 1e-3, warm-up 5, 30 steps
    of 4 x 1024 tokens from the port's data pipeline, weights from a seed):
    every loss and grad norm finite, the last loss below the first by more
    than 0.5 (the reference's ``test_training_reduces_loss``).  Logged: the
    step's call ms (median after warm-up), card busy ms and launches per
    step from ``profile_step``, tokens/s, peak memory and the step's
    compute bound 8·N·T (6·N·T plus the recomputed forward's 2·N·T);
    beside them ``model_flops`` (``roofline.analysis``, the reference's
    6·N·T), ``mfu`` (model_flops / (step s x 989 TF/s)) and the port's
    ``roofline`` of the step at its own shape, as phase 4's.
11. Training exactness: qwen2-0.5b's widths at 2 layers in float32 (TF32
    off), one ``make_train_step(cast_params=False)`` step on the card
    against the same step on the CPU from the same state, 2 x 256 tokens:
    loss and grad norm within 1e-5 relative, Adam moments within 1e-4 of
    each leaf's largest element, params within 2 x lr everywhere and
    within 1e-6 for all but 1e-3 of the elements (Adam's first step is
    about lr * sign(g), so where |g| is near eps the two devices' rounding
    moves an element by up to 2 x lr).  Then the train state goes through
    ``save_checkpoint`` / ``restore_checkpoint`` (the reference's .npz
    layout, in a temporary directory removed afterwards) bit-equal, and one
    more step from the restored state equals the step from the state in
    memory under the same comparison.
12. Training the MoE family at olmoe-1b-7b's widths cut to 2 of 16 layers
    (float32 masters, m and v of all 16 layers would not fit the card): 10
    steps as phase 10's, every loss and router aux loss finite, aux > 0,
    with phase 10's log lines.
13. Serving qwen2-vl-72b at its published widths cut to 8 of 80 layers
    (72.7 B params do not fit the card), M-RoPE, with phase 4's batch,
    context, checks and times, and logits of 2-D text positions equal to
    those of the same positions as [3, B, S] bit for bit; then its float32
    exactness pass at 2 layers.
14-16. rwkv6-1.6b, zamba2-2.7b and whisper-tiny at full width
    (``FAMILY_RUNS``): a bf16 prefill through ``forward(want_cache=True)``
    and 8 decode steps from its states, with call ms, busy ms, launches,
    busy share and peak memory; then training through ``train_loop`` with
    phase 10's log lines (rwkv6 cut to 12 of its 24 layers, zamba2 to 2 of
    its 9 super-blocks; whisper 30 steps, the loss falling by more than
    0.5).
17. Each of the three at its widths cut to 2 layers in float32 (TF32 off):
    the card's forward within 1e-5 of the CPU's (of the largest logit),
    and the token-by-token decode stream within 1e-4 of the forward.
18. The dry-run (``launch.dryrun.run_one``, no kernel runs) on fake
    tensors of the card's type: qwen2-0.5b x train_4k (multi-pod 2x16x16,
    512 fake ranks), prefill_32k, decode_32k and long_500k (16x16, 256;
    long_500k is the reference's documented skip), olmoe-1b-7b x train_4k
    (multi-pod): one ``[dryrun]`` JSON line each, ``ok`` or that skip, no
    op run replicated, and a per-device temp peak (``peak_bytes_per_device``;
    ``memory_analysis`` gives argument / output / alias / temp bytes and
    whether they fit 80 GB); a ``[dryrun-summary]`` line gives qwen2's
    train FLOPs per device with its useful ratio, olmoe's wire bytes and
    every pair's peak.  Then the query chunks' check
    (``[dryrun-query-chunks]`` lines): stablelm-12b, mixtral-8x7b and
    qwen2-vl-72b train_4k and prefill_32k at 1 layer on 16x16, traced with
    attention in query chunks and unchunked, FLOPs and wire bytes within
    3%.  Every trace of the phase whose figures ``tools/dryrun_plans.py``
    recorded on the CPU (``tools/dryrun_plans.json``: the five dry-run
    pairs, the twelve query-chunk traces, and qwen2-0.5b decode_32k at 2
    layers on 16x16, traced for it) has FLOPs, wire bytes and temp per
    device within 1% of them on this torch (``[dryrun-torch-versions]``
    lines; C-port8).  Then the memory check (``[memory-check]`` lines):
    qwen2-0.5b train and prefill and olmoe-1b-7b train at 2 layers, 4 x
    1024 tokens, each traced on a fake (1, 1) mesh and run once on the
    card; ``max_memory_allocated`` must lie within 10% of the predicted
    eager peak (arguments + the peak of all else live).
19. The twins of the benchmarks and examples that need JAX in the
    reference (``repro_torch.benchmarks``, ``repro_torch.examples``), in
    this process on the card, each raising on failure: the benchmark
    harness (dispatch tables, multi-node tables, the all-gathers on 8
    emulated ranks by B3, trace export: every claim holds), the
    simulator's hot-path benchmark (its >= 5x floor), the roofline table
    for phase 18's pairs on 16x16, the MoE wire comparison at olmoe-1b-7b's
    production shape (GSPMD-transparent over latte > 10x), the quickstart,
    every B3/B4 variant against its oracle, ``train_lm`` (300 steps, the
    loss falling by more than 0.5, checkpoint bit-equal) and
    ``serve_kv_cache`` (B1 on its ``kernel`` hits).  ``[twins]`` lines give
    the ratio and the phase's B1/B3/B4 launches, in all and by twin (the
    counts set to 0 before each).
20. One JSON line naming every ported kernel with its launches on its path
    (phases 4, 8 and 13 for B1/B2, phases 7 and 7b for B3/B4, and phase
    19's, also given alone as ``launches_in_twins``; B3/B4 also by path in
    ``launches_by_path``, with the per-rank launches as ``procs``), and the
    ring reduce-scatter (no TPU kernel: the reference's ``ppermute`` ring)
    with its per-rank launches of phase 7b; no kernel lies on the training,
    recurrent or dry-run paths.
21. Last line: ``{"ok": true, "device": {...}}``.  A ``[phase] name s``
    line follows each phase with its wall seconds.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
B, CTX, NEW = 4, 1024, 16                    # serving batch, context, new tokens
BT = 16                                      # tokens per KV block
ARCH = "qwen2-0.5b"
SOURCES = {"paged_kv_gather": "src/repro_torch/kernels/csrc/paged_kv_gather.cu",
           "paged_decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "ring_all_gather": "src/repro_torch/kernels/csrc/ring_all_gather.cu",
           "all_to_all": "src/repro_torch/kernels/csrc/ring_all_to_all.cu",
           "ring_reduce_scatter": "src/repro_torch/kernels/csrc/ring_reduce_scatter.cu",
           "prefill_flash_attention": "src/repro_torch/kernels/csrc/prefill_attention.cu"}
# the prefill attention kernel's shapes (B, S, KV, G, hd): qwen2-vl-72b-8l's
# fresh-2k prefill and olmoe-1b-7b's revisit-4k fill
PREFILL_SHAPES = {"qwen2-vl-72b": (8, 2048, 8, 8, 128), "olmoe-1b-7b": (8, 4080, 16, 1, 128)}
RANKS = 8                                    # emulated ranks of the collectives
ROW = 1024                                   # elements per row of a rank's chunk
GATHERED = {"64KiB": 64 << 10, "1MiB": 1 << 20, "16MiB": 16 << 20, "256MiB": 256 << 20}
L2_BYTES = 50e6                              # H100 L2 cache
MOE_ARCH, MOE_TOKENS = "olmoe-1b-7b", 512    # latte MoE: tokens per rank
MOE_DECODE_TOKENS = 4                        # ... and at decode
# one rank per process: processes, sizes a rank of B3 / B4, their variants,
# sizes a rank of the ring reduce-scatter, whether the ring all-reduce runs
# too, and whether the latte MoE layer runs
PROCS_RUNS = (dict(n=4, sizes=("64KiB", "1MiB", "64MiB"), ag=("b2b", "bcst_b2b"),
                   aa=("b2b", "per_round"), rs=("64KiB", "1MiB"), ar=True, moe=True),
              dict(n=8, sizes=("1MiB",), ag=("b2b", "bcst_b2b"), aa=("b2b", "per_round"),
                   rs=("1MiB",), ar=False, moe=False),
              dict(n=6, sizes=("1MiB",), ag=(), aa=("b2b", "per_round"), rs=(), ar=False,
                   moe=False))
PROCS_RS_ROW = (4, "1MiB")          # the reduce-scatter's row of the kernels line
PROCS_BYTES = {"64KiB": 64 << 10, "1MiB": 1 << 20, "64MiB": 64 << 20}
PROCS_REPS = 5
TRAIN_B, TRAIN_S = 4, 1024                   # training: batch x sequence (4,096 tokens)
EXACT_B, EXACT_S = 2, 256                    # the float32 card-vs-CPU step
VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 8      # 8 of 80 layers: 72.7 B params do not fit
# family -> (batch, sequence, train steps, train layers (None: all), seed)
FAMILY_RUNS = {"rwkv6-1.6b": (2, 512, 3, 12, 20),        # training: 12 of 24 layers
               "zamba2-2.7b": (2, 512, 3, 12, 30),      # training: 2 of 9 super-blocks
               "whisper-tiny": (4, 448, 30, None, 40)}


def log(msg: str) -> None:
    print(msg, flush=True)


def _events(fn, reps: int, warmup: int, sleep_cycles: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call of ``fn`` in ms.  A sleep kernel
    (5M cycles, about 2.7 ms at H100 clocks) is queued before each start
    event, so the card is still busy while the host enqueues the events and
    ``fn``'s launches: the events time the device work, not the host's
    launch cost.  Only for an ``fn`` of a few launches: a call of hundreds
    would fill the launch queue and wait for the sleep to end."""
    return _events(fn, reps, warmup, sleep_cycles=5_000_000)


def call_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median time of one call of ``fn`` in ms as a caller sees it: CUDA
    events around the call on an idle card, so the host's work (argument
    checks, launch, host-side copies) counts too."""
    return _events(fn, reps, warmup, sleep_cycles=0)


def host_us(fn, calls: int = 300) -> float:
    """Mean host µs of one call of ``fn`` over ``calls`` calls queued behind
    a sleep kernel (about 0.2 s), so the card stays busy and no call waits
    for it: the host's own cost of a call (checks, allocation, launch)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return t / calls / 1e3


# Kernel name fragments -> the kind of work, for the busy-time breakdown.
KINDS = (("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
         ("optimizer foreach", ("multi_tensor_apply",)),
         ("indexing", ("index", "scatter", "gather")),
         ("reduce/softmax", ("reduce", "softmax", "norm")),
         ("copy/cast/fill", ("Memcpy", "Memset", "copy", "fill")),
         ("elementwise", ("elementwise",)))


def _kind(name: str) -> str:
    low = name.lower()
    return next((kind for kind, keys in KINDS if any(k.lower() in low for k in keys)), "other")


def profile_step(fn, reps: int = 3, cuda_only: bool = False) -> dict:
    """Kernel (and copy) time per call of ``fn`` from ``torch.profiler``, with
    the five largest entries and the sums by kind of work; ``busy_ms`` is
    None when the profiler records no device activity.  ``cuda_only`` is for
    steps of 10^5 launches that have run before: it records device activity
    alone (host events would cost the profiler more than the step) and
    skips the warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not cuda_only:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU,
                                                            ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    by_kind: dict[str, float] = {}
    for name, ms in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
    return {"busy_ms": busy if by_name else None,
            "device_launches": sum(1 for ev in prof.events()
                                   if ev.device_type == DeviceType.CUDA) // reps,
            "top_ms": [[name[:60], ms] for name, ms in top],
            "busy_ms_by_kind": by_kind}


def peak_flops(dtype) -> float:
    """The card's peak rate for ``dtype`` (the port's ``roofline.hw``)."""
    from repro_torch.roofline import hw
    return {torch.bfloat16: hw.PEAK_BF16_FLOPS, torch.float32: hw.PEAK_FP32_FLOPS}[dtype]


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    from repro_torch.roofline import hw
    t_bytes = n_bytes / hw.HBM_BW * 1e3
    t_ops = n_ops / peak_flops(dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline(dev, cfg, shape) -> dict:
    """The port's H100 roofline of one step of ``cfg`` at ``shape`` (a
    ``ShapeConfig``), from its costing on a (1, 1) mesh: fake tensors on the
    card's device type, depth-differenced at 1 and 2 layers, nothing run."""
    from repro_torch.launch.mesh import fake_world, make_local_mesh
    from repro_torch.roofline.analysis import make_row
    from repro_torch.roofline.costing import total_cost
    t0 = time.perf_counter()
    with fake_world(1):
        mesh = make_local_mesh(device=dev)
        total = total_cost(cfg.name, shape.name, mesh, dp_size=1, cfg=cfg, shape=shape,
                           device=dev)["total"]
    row = make_row(cfg.name, shape.name, "1x1", 1, total, cfg=cfg, shape=shape)
    return {"compute_ms": row.compute_s * 1e3, "memory_ms": row.memory_s * 1e3,
            "dominant": row.dominant, "hlo_flops": row.hlo_flops_global,
            "hlo_bytes": total.bytes, "useful_ratio": row.useful_ratio,
            "costing_s": time.perf_counter() - t0}


def _randn(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


# ------------------------------------------------------------------ 1, 2 ----
def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    log(out[0])
    return out[0]


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"[build] {json.dumps({k: round(v, 3) for k, v in seconds.items()})} "
        f"total {time.perf_counter() - t0:.3f}s")
    for name in _build.SOURCES:
        log_path = _build.BUILD_DIR / f"{name}.log"
        for line in log_path.read_text().splitlines() if log_path.exists() else []:
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# --------------------------------------------------------------------- 3 ----
def check_gather(dev, cfg) -> dict:
    """B1 at the pool shape the ``kernel`` fetch gives it when serving
    ``cfg``: one context's blocks, [CTX / BT, BT, layers x KV heads x hd]."""
    from repro_torch.kernels.paged_kv_gather import ops
    from repro_torch.kernels.paged_kv_gather.ref import paged_kv_gather_ref
    arch = cfg.name
    n, dkv = CTX // BT, cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(1)
    tbl = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    tbl[::9] = tbl[1]                                  # repeated blocks
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.randn((n, BT, dkv), generator=g, device=dev).to(dtype)
        out = ops.gather_blocks(pool, tbl)
        ref = paged_kv_gather_ref(pool, tbl)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"paged_kv_gather {dtype} differs from the plain version")
        err = (out.float() - ref.float()).abs().max().item()
        nbytes = 2 * n * BT * dkv * pool.element_size()
        bound, by = bound_ms(nbytes, 0, dtype)
        row = dict(kernel_ms=device_ms(lambda: ops.gather_blocks(pool, tbl)),
                   plain_ms=device_ms(lambda: paged_kv_gather_ref(pool, tbl)),
                   library_ms=device_ms(lambda: pool.index_select(0, tbl)),
                   call_ms=call_ms(lambda: ops.gather_blocks(pool, tbl)),
                   bound_ms=bound, bound_by=by, max_abs_err=err)
        log(f"[kernel] paged_kv_gather ({arch}) {str(dtype)[6:]} [{n},{BT},{dkv}] table {n} "
            f"(repeats): "
            f"bit-equal; device ms: kernel={row['kernel_ms']} plain={row['plain_ms']} "
            f"library(index_select)={row['library_ms']}; bound={row['bound_ms'] * 1e3} us "
            f"({by}); kernel call incl. host={row['call_ms']} ms; max_abs_err={err}")
        result[dtype] = row
    del pool, out, ref
    torch.cuda.empty_cache()
    return result[torch.bfloat16]


def _sdpa(q, k_pool, v_pool, tables, lengths):
    """Library yardstick for B2: gather the paged K/V, then one SDPA call."""
    Bq, KV, G, hd = q.shape
    mb, bt = tables.shape[1], k_pool.shape[1]
    k = k_pool[tables.long()].reshape(Bq, mb * bt, KV, hd).transpose(1, 2)
    v = v_pool[tables.long()].reshape(Bq, mb * bt, KV, hd).transpose(1, 2)
    mask = (torch.arange(mb * bt, device=q.device)[None, :] < lengths[:, None])[:, None, None]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(Bq, KV * G, 1, hd), k, v, attn_mask=mask, enable_gqa=True)
    return out.reshape(Bq, KV, G, hd)


def _decode_case(dev, g, dtype, lengths_l, KV, G, hd):
    """Random q, pools and a table of distinct blocks for ``lengths_l``, one
    entry more than the longest sequence needs."""
    Bq = len(lengths_l)
    mb = max(math.ceil(max(x, 1) / BT) for x in lengths_l) + 1
    n_pool = Bq * mb + 8
    tables = torch.randperm(n_pool, generator=g, device=dev)[:Bq * mb].reshape(Bq, mb)
    return (_randn(g, (Bq, KV, G, hd), dtype, dev), _randn(g, (n_pool, BT, KV, hd), dtype, dev),
            _randn(g, (n_pool, BT, KV, hd), dtype, dev), tables.to(torch.int32).contiguous(),
            torch.tensor(lengths_l, dtype=torch.int32, device=dev))


def check_decode_attention(dev) -> dict:
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    KV, G, hd = 2, 7, 64                               # the qwen2-0.5b group
    lengths_l = [1024, 1000, 1037, 960]
    g = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # Edge cases besides the path shape: a zero-length sequence, lengths 1 and
    # bt + 1 (most splits empty), and a 4096-token context.
    edges = {"zero_one_bt+1": [0, 1, BT + 1, 0], "ctx4096": [4096, 4095, 1, 0]}
    result = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, kp, vp, tables, lengths = _decode_case(dev, g, dtype, lengths_l, KV, G, hd)
        mb = tables.shape[1]
        for softcap in (None, 30.0):
            out = ops.decode_attention(q, kp, vp, tables, lengths, softcap=softcap)
            ref = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
            err = (out.float() - ref.float()).abs().max().item()
            log(f"[kernel] paged_decode_attention {str(dtype)[6:]} softcap={softcap}: "
                f"max_abs_err={err} (tol {tol})")
            for name, edge_l in edges.items():
                case = _decode_case(dev, g, dtype, edge_l, KV, G, hd)
                e_out = ops.decode_attention(*case, softcap=softcap)
                e_ref = paged_decode_attention_ref(*case, softcap=softcap)
                torch.cuda.synchronize()
                torch.testing.assert_close(e_out.float(), e_ref.float(), atol=tol, rtol=tol)
                zero = [b for b, x in enumerate(edge_l) if x == 0]
                if torch.count_nonzero(e_out[zero]) != 0:
                    raise AssertionError(f"paged_decode_attention {name}: a zero-length "
                                         "sequence gave a nonzero output")
                log(f"[kernel] paged_decode_attention {str(dtype)[6:]} softcap={softcap} "
                    f"lengths={edge_l} (S={ops.num_splits(len(edge_l) * KV, case[3].shape[1], sms)}"
                    f"): max_abs_err={(e_out.float() - e_ref.float()).abs().max().item()} "
                    f"(tol {tol}); zero-length rows exactly 0")
        # poison every K/V position at or past each length: output must not change
        kp2, vp2 = kp.clone(), vp.clone()
        for b, length in enumerate(lengths_l):
            for j in range(mb):
                lo = max(length - j * BT, 0)
                if lo < BT:
                    kp2[tables[b, j], lo:] = 999.0
                    vp2[tables[b, j], lo:] = -999.0
        poisoned = ops.decode_attention(q, kp2, vp2, tables, lengths)
        clean = ops.decode_attention(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        if not torch.equal(poisoned, clean):
            raise AssertionError(f"paged_decode_attention {dtype}: K/V past length changed "
                                 "the output")
        lib = _sdpa(q, kp, vp, tables, lengths)
        ref = paged_decode_attention_ref(q, kp, vp, tables, lengths)
        torch.testing.assert_close(lib.float(), ref.float(), atol=2e-2, rtol=2e-2)
        tokens = sum(lengths_l)
        nbytes = (2 * tokens * KV * hd + 2 * q.numel()) * q.element_size() \
            + 4 * (B + sum(math.ceil(x / BT) for x in lengths_l))
        bound, by = bound_ms(nbytes, 4 * tokens * KV * G * hd, dtype)
        row = dict(
            kernel_ms=device_ms(lambda: ops.decode_attention(q, kp, vp, tables, lengths)),
            plain_ms=device_ms(lambda: paged_decode_attention_ref(q, kp, vp, tables, lengths)),
            library_ms=device_ms(lambda: _sdpa(q, kp, vp, tables, lengths)),
            call_ms=call_ms(lambda: ops.decode_attention(q, kp, vp, tables, lengths)),
            bound_ms=bound, bound_by=by, splits=ops.num_splits(B * KV, mb, sms),
            max_abs_err=(clean.float() - ref.float()).abs().max().item())
        log(f"[kernel] paged_decode_attention {str(dtype)[6:]} B={B} KV={KV} G={G} hd={hd} "
            f"bt={BT} lengths={lengths_l} S={row['splits']} (grid {B * KV * row['splits']}): "
            f"poisoned tail unchanged; device ms: "
            f"kernel={row['kernel_ms']} plain={row['plain_ms']} "
            f"library(gather+sdpa)={row['library_ms']}; bound={row['bound_ms'] * 1e3} us "
            f"({by}); kernel call incl. host={row['call_ms']} ms; "
            f"max_abs_err={row['max_abs_err']}")
        result[dtype] = row
    return result[torch.bfloat16]


def _sdpa_causal(q, k, v):
    """Library yardstick for the prefill kernel: one causal SDPA call."""
    Bq, S, KV, G, hd = q.shape
    out = torch.nn.functional.scaled_dot_product_attention(
        q.permute(0, 2, 3, 1, 4).reshape(Bq, KV * G, S, hd), k.transpose(1, 2),
        v.transpose(1, 2), is_causal=True, enable_gqa=True)
    return out.reshape(Bq, KV, G, S, hd).permute(0, 3, 1, 2, 4)


def check_prefill_attention(dev) -> dict:
    from repro_torch.kernels.prefill_attention import ops
    from repro_torch.models.attention import _attn_scores_block
    result = {}
    for arch, (Bq, S, KV, G, hd) in PREFILL_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(3)
        q = _randn(g, (Bq, S, KV, G, hd), torch.bfloat16, dev)
        k = _randn(g, (Bq, S, KV, hd), torch.bfloat16, dev)
        v = _randn(g, (Bq, S, KV, hd), torch.bfloat16, dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev)

        def dense():
            return _attn_scores_block(q, k, v, pos, pos, head_dim=hd, causal=True,
                                      window=None, cap=None)
        out = ops.prefill_attention(q, k, v)
        torch.cuda.synchronize()
        want = torch.empty((Bq, S, KV, G, hd), dtype=torch.float32, device=dev)
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        for b in range(Bq):                            # float32, a sequence at a time
            sc = torch.einsum("qkgd,skd->kgqs", q[b].float(), k[b].float()) / hd ** 0.5
            w = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
            want[b] = torch.einsum("kgqs,skd->qkgd", w, v[b].float())
            del sc, w
        err = (out.float() - want).abs().max().item()
        dense_err = (dense().float() - want).abs().max().item()
        torch.testing.assert_close(out.float(), want, atol=1e-2, rtol=1e-2)
        del want
        flops = 4.0 * Bq * KV * G * hd * S * (S + 1) / 2
        bound, by = bound_ms(4 * q.numel() * 2 // G, flops, torch.bfloat16)
        before = ops.launches
        kernel = device_ms(lambda: ops.prefill_attention(q, k, v), reps=20)
        per_call = (ops.launches - before) / 25        # 5 warm-up + 20 timed calls
        row = dict(kernel_ms=kernel, plain_ms=device_ms(dense, reps=5, warmup=1),
                   library_ms=device_ms(lambda: _sdpa_causal(q, k, v), reps=20),
                   call_ms=call_ms(lambda: ops.prefill_attention(q, k, v), reps=20),
                   bound_ms=bound, bound_by=by, tflop=flops / 1e12,
                   tensor_core_share=100.0 * bound / kernel,
                   launches_per_call=per_call, max_abs_err=err,
                   dense_max_abs_err=dense_err)
        log(f"[kernel] prefill_flash_attention ({arch}) bf16 B={Bq} S={S} KV={KV} G={G} "
            f"hd={hd} causal: {row['tflop']} TFLOP; device ms: kernel={kernel} "
            f"plain(dense)={row['plain_ms']} library(sdpa)={row['library_ms']}; "
            f"bound={bound} ms ({by}); {row['tensor_core_share']}% of it; "
            f"{flops / kernel / 1e9} TFLOP/s; call incl. host={row['call_ms']} ms; "
            f"launches a call {row['launches_per_call']}; max_abs_err vs float32 {err} "
            f"(dense path {dense_err})")
        result[arch] = row
        del q, k, v, out
        torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------------ 4, 5 ----
def _engine(cfg, dev, seed=0):
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    return ServeEngine(model, params, device=dev)


def phase_serving(dev, cfg, seed: int) -> dict:
    """One serving path at full width: warm-up, then the main path with the
    kernels' counts zeroed just before and read just after, its checks, and
    its times.  Returns the path's launch counts."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.paged_kv_gather import ops as gather_ops
    from repro_torch.kernels.prefill_attention import ops as pa_ops
    from repro_torch.serve.host_store import BACKENDS
    arch = cfg.name
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = _engine(cfg, dev, seed)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, CTX)).astype(np.int32)
    keys = [f"ctx-{i}" for i in range(B)]

    # Warm-up at the served shape on other contexts: cuBLAS handles, the
    # kernels' first load, the pinned host buffers' first allocation and the
    # modeled fetch latencies (memoized per shape).
    warm = [f"warm-{i}" for i in range(B)]
    for backend in (None,) + BACKENDS:
        eng.generate(prompts, warm, 2, fetch_backend=backend)

    gather_ops.launches = 0
    da_ops.launches = 0
    pa_ops.launches = 0
    miss = eng.generate(prompts, keys, NEW)
    hits, delta = {}, {}
    for backend in BACKENDS:
        before = gather_ops.launches
        hits[backend] = eng.generate(prompts, keys, NEW, fetch_backend=backend)
        delta[backend] = gather_ops.launches - before
    launches = {"paged_kv_gather": gather_ops.launches,
                "paged_decode_attention": da_ops.launches,
                "prefill_flash_attention": pa_ops.launches}
    if pa_ops.launches != cfg.n_layers:
        raise AssertionError(f"{arch}: the miss pass launched prefill_flash_attention "
                             f"{pa_ops.launches} times, want one a layer ({cfg.n_layers})")

    if miss.request_stats[0].cache_hit or not all(h.request_stats[0].cache_hit
                                                   for h in hits.values()):
        raise AssertionError(f"{arch}: expected one miss pass, then hits")
    for backend, d in delta.items():
        want = 2 * B if backend == "kernel" else 0
        if d != want:
            raise AssertionError(f"{arch}: {backend} pass launched paged_kv_gather {d} times, "
                                 f"want {want}")
    if launches["paged_kv_gather"] == 0:
        raise AssertionError(f"{arch}: the main path never launched paged_kv_gather")
    for res in (miss, *hits.values()):
        if res.tokens.shape != (B, NEW) or res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab:
            raise AssertionError(f"{arch}: bad tokens {res.tokens.shape}")
    for backend in BACKENDS:
        if not np.array_equal(hits[backend].tokens, hits["pcpy"].tokens):
            raise AssertionError(f"{arch}: hit tokens of {backend} differ from pcpy's")
    if any(st.fetch_modeled_s != 0.0 for st in miss.request_stats):
        raise AssertionError(f"{arch}: a miss carries a modeled fetch latency")
    for backend, res in hits.items():
        if not all(st.fetch_modeled_s > 0.0 for st in res.request_stats):
            raise AssertionError(f"{arch}: a {backend} hit has no modeled fetch latency")

    for key in keys:                                   # fetched == saved, bit for bit
        kb, vb = eng.store.host_blocks(key)
        for backend in BACKENDS:
            res = eng.store.fetch(key, backend)
            if not (torch.equal(res.k_blocks.cpu(), kb) and torch.equal(res.v_blocks.cpu(), vb)):
                raise AssertionError(f"{arch}: {backend} fetched blocks differ from the saved ones")
    probe = torch.as_tensor(prompts[:1, :64], device=dev)
    logits, aux, _ = eng.model.forward(eng.params, {"tokens": probe})
    if logits.shape != (1, 64, cfg.vocab) or not torch.isfinite(logits).all() \
            or not math.isfinite(aux.item()):
        raise AssertionError(f"{arch}: non-finite or misshapen logits")
    if cfg.rope_kind == "mrope":     # text positions: 2-D == broadcast to [3, B, S]
        pos2 = torch.arange(64, dtype=torch.int32, device=dev)[None]
        l2, _, _ = eng.model.forward(eng.params, {"tokens": probe, "positions": pos2})
        l3, _, _ = eng.model.forward(eng.params, {"tokens": probe,
                                                  "positions": pos2.expand(3, 1, 64)})
        if not (torch.equal(l2, l3) and torch.equal(l2, logits)):
            raise AssertionError(f"{arch}: M-RoPE logits of 2-D text positions differ from "
                                 "those of the same positions as [3, B, S]")
        log(f"[serve] {arch}: M-RoPE logits from 2-D text positions == from [3, B, S], "
            "bit for bit")

    # Two more passes of each path for the time medians (the main path's
    # pass is the first sample); a miss needs contexts not yet stored.
    rows = {"miss": [miss], **{b: [hits[b]] for b in BACKENDS}}
    for rep in range(2):
        rows["miss"].append(eng.generate(prompts, [f"rep{rep}-{i}" for i in range(B)], NEW))
        for backend in BACKENDS:
            rows[backend].append(eng.generate(prompts, keys, NEW, fetch_backend=backend))
    ttft = {k: [r.request_stats[0].ttft_wall_s * B * 1e3 for r in rs] for k, rs in rows.items()}
    tok_s = {k: [r.tokens_per_s_wall for r in rs] for k, rs in rows.items()}
    fetch_ms = {b: call_ms(lambda b=b: [eng.store.fetch(k, b) for k in keys], reps=20, warmup=3)
                for b in BACKENDS}
    # Where a step's time goes: its call time on an idle card against the
    # kernel time the profiler records for it (busy share of the card).
    prompts_t = torch.as_tensor(prompts, device=dev)
    caches = eng.model.init_caches(B, CTX + NEW + 1, dev)
    last = prompts_t[:, -1:]
    steps = {"prefill": lambda: eng.model.forward(eng.params, {"tokens": prompts_t},
                                                  want_cache=True),
             "decode_step": lambda: eng.model.decode_step(eng.params,
                                                          {"tokens": last, "pos": CTX}, caches),
             "hit_first_token_kernel": lambda: eng.first_token(prompts, keys,
                                                               fetch_backend="kernel",
                                                               capacity=CTX + NEW + 1)}
    step_ms = {}
    for name, fn in steps.items():
        row = {"call_ms": call_ms(fn, reps=5, warmup=1), **profile_step(fn)}
        row["busy_share"] = row["busy_ms"] / row["call_ms"] if row["busy_ms"] else None
        step_ms[name] = row
    # the port's roofline of the prefill beside its call time
    step_ms["prefill"]["roofline"] = roofline(dev, cfg, ShapeConfig("serve_prefill", CTX, B,
                                                                    "prefill"))
    n_blocks, block_bytes = eng.store.blocks_for(keys[0])
    out = {"arch": arch, "n_layers": cfg.n_layers, "dtype": cfg.compute_dtype,
           "batch": B, "ctx": CTX, "new": NEW,
           "params": sum(t.numel() for t in _leaves(eng.params)),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "phase_s": time.perf_counter() - t_phase,
           "kv_blocks_per_ctx": n_blocks, "kv_bytes_per_ctx": n_blocks * block_bytes,
           "ttft_batch_ms_median": {k: statistics.median(v) for k, v in ttft.items()},
           "ttft_batch_ms_samples": ttft,
           "decode_tok_per_s_median": {k: statistics.median(v) for k, v in tok_s.items()},
           "fetch_ms_batch_median": fetch_ms,
           "step_ms_median": step_ms,
           "n_transfers": {k: rs[0].request_stats[0].n_transfers for k, rs in rows.items()},
           "hit_tokens_equal_miss_share": {b: float((hits[b].tokens == miss.tokens).mean())
                                           for b in BACKENDS},
           "launches": launches}
    log(f"[serve] {json.dumps({'serving': out})}")
    modeled = {b: hits[b].request_stats[0].fetch_modeled_s * B * 1e3 for b in BACKENDS}
    log(f"[serve] {arch} modeled (MI300X simulator, not measured on this card) fetch latency "
        f"of the batch's KV, ms: {json.dumps(modeled)}")
    del eng, caches, steps, rows, hits, miss
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_exactness(dev, arch: str, seed: int) -> None:
    """The same widths at 2 layers in float32 (TF32 off), so hit and miss
    differ only in summation order, as on the CPU; an MoE config runs at
    capacity factor n_experts / top_k, where no choice is dropped (a hit
    routes its first token among B tokens, the miss among B x CTX)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.host_store import BACKENDS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), n_layers=2, compute_dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    eng = _engine(cfg, dev, seed=seed)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (B, CTX)).astype(np.int32)
    keys = [f"exact-{i}" for i in range(B)]
    miss = eng.generate(prompts, keys, NEW)
    for backend in BACKENDS:
        hit = eng.generate(prompts, keys, NEW, fetch_backend=backend)
        if not np.array_equal(hit.tokens, miss.tokens):
            raise AssertionError(f"{arch}: float32 hit tokens via {backend} differ from the "
                                 "miss path's")
    extra = f", capacity factor {cfg.moe.capacity_factor}" if cfg.moe else ""
    log(f"[exact] {cfg.name} n_layers=2 float32 (TF32 off){extra}: hit tokens == miss tokens "
        f"for {list(BACKENDS)}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- 6 ----
def check_rank_kernels(dev) -> None:
    """Every B3/B4 variant bit-equal to its plain version at the four sizes,
    in bf16 and f32; bf16 times, one log line per size."""
    from repro_torch.kernels.ring_all_gather import ops as ag
    from repro_torch.kernels.ring_all_gather.ref import all_gather_ref
    from repro_torch.kernels.ring_all_to_all import ops as aa
    from repro_torch.kernels.ring_all_to_all.ref import all_to_all_ref
    g = torch.Generator(device=dev).manual_seed(3)
    n = RANKS
    for label, gathered in GATHERED.items():
        chunk_bytes = gathered // n
        for dtype in (torch.bfloat16, torch.float32):
            rows = chunk_bytes // (ROW * torch.finfo(dtype).bits // 8)
            xs = _randn(g, (n, rows, ROW), dtype, dev)
            want = all_gather_ref(xs)
            for v in ag.VARIANTS:
                if not torch.equal(ag.ring_all_gather(xs, v), want):
                    raise AssertionError(f"ring_all_gather {v} {dtype} {label} differs")
            ag.check()
            xa = {m: _randn(g, (m, m, rows, ROW), dtype, dev) for m in (n, 6)}
            for m, x in xa.items():
                want_a = all_to_all_ref(x)
                for v in aa.VARIANTS:
                    if not torch.equal(aa.all_to_all(x, v), want_a):
                        raise AssertionError(f"all_to_all {v} n={m} {dtype} {label} differs")
            aa.check()
            if dtype != torch.bfloat16:
                continue
            reps = 20
            # bytes the function must move: AG reads the n shards once and
            # writes n copies of them; AA reads and writes n x n chunks
            ag_bytes, aa_bytes = (1 + n) * gathered, 2 * n * gathered
            row = {"size": label, "per_rank_gathered_bytes": gathered, "dtype": "bfloat16",
                   "ctas_per_rank": ag.ctas_per_rank(n, chunk_bytes),
                   "aa_ctas_per_rank": {v: aa.ctas_per_rank(n, chunk_bytes, variant=v)
                                        for v in aa.VARIANTS},
                   "ag_bound_ms": bound_ms(ag_bytes, 0, dtype)[0],
                   "aa_bound_ms": bound_ms(aa_bytes, 0, dtype)[0], "bound_by": "bytes",
                   "ag_l2_resident": ag_bytes <= L2_BYTES, "aa_l2_resident": aa_bytes <= L2_BYTES}
            row["ag_ms"] = {v: device_ms(lambda v=v: ag.ring_all_gather(xs, v), reps=reps)
                            for v in ag.VARIANTS}
            row["ag_call_ms"] = {v: call_ms(lambda v=v: ag.ring_all_gather(xs, v), reps=reps)
                                 for v in ag.VARIANTS}
            row["ag_plain_ms"] = device_ms(lambda: all_gather_ref(xs), reps=reps)
            x8 = xa[n]

            def ag_library():
                return xs.reshape(1, -1, ROW).expand(n, -1, -1).contiguous()

            def aa_library():
                return x8.transpose(0, 1).contiguous()

            row["ag_library_ms"] = device_ms(ag_library, reps=reps)
            row["ag_library_call_ms"] = call_ms(ag_library, reps=reps)
            row["aa_ms"] = {v: device_ms(lambda v=v: aa.all_to_all(x8, v), reps=reps)
                            for v in aa.VARIANTS}
            row["aa_call_ms"] = {v: call_ms(lambda v=v: aa.all_to_all(x8, v), reps=reps)
                                 for v in aa.VARIANTS}
            row["aa_n6_ms"] = {v: device_ms(lambda v=v: aa.all_to_all(xa[6], v), reps=reps)
                               for v in aa.VARIANTS}
            row["aa_plain_ms"] = device_ms(lambda: all_to_all_ref(x8), reps=reps)
            row["aa_library_ms"] = device_ms(aa_library, reps=reps)
            row["aa_library_call_ms"] = call_ms(aa_library, reps=reps)
            if gathered <= 1 << 20:      # the latency-bound sizes: the host's share
                row["ag_host_us"] = {v: host_us(lambda v=v: ag.ring_all_gather(xs, v))
                                     for v in ag.VARIANTS}
                row["aa_host_us"] = {v: host_us(lambda v=v: aa.all_to_all(x8, v))
                                     for v in aa.VARIANTS}
                row["ag_library_host_us"] = host_us(ag_library)
                row["aa_library_host_us"] = host_us(aa_library)
            if label == "64KiB":
                row["ag_ms_per_step"] = {v: ms / (n // 2 if v.startswith("bcst") else n - 1)
                                         for v, ms in row["ag_ms"].items()}
                # the cost a ring step adds: the same chunks over 2 ranks (1
                # step) against n ranks (n - 1 steps), without the fixed part
                xs2 = xs[:2].contiguous()
                row["ag_ms_n2"] = {v: device_ms(lambda v=v: ag.ring_all_gather(xs2, v),
                                                reps=reps) for v in ("pcpy", "b2b")}
                row["ag_ms_per_step_marginal"] = {
                    v: (row["ag_ms"][v] - row["ag_ms_n2"][v]) / (n - 2) for v in row["ag_ms_n2"]}
                row["aa_ms_per_round"] = {v: ms / (n - 1) for v, ms in row["aa_ms"].items()}
            ag.check()
            aa.check()
            log(f"[collective] {json.dumps(row)}")
        del xs, xa, want, want_a
        torch.cuda.empty_cache()
    log(f"[collective] B3 (4 variants) and B4 (2 variants, n=8 and n=6) bit-equal to their "
        f"plain versions in bf16 and f32 at {list(GATHERED)} gathered per rank; sizes whose "
        f"input and output bytes fit in the 50 MB L2 run from cache (*_l2_resident)")


# --------------------------------------------------------------------- 7 ----
def _numpy_oracles(operands: dict, n: int) -> dict:
    shard, chunks = operands["all_gather"], operands["all_to_all"]
    total = chunks.sum(axis=0)
    return {"all_gather": (np.broadcast_to(shard, (n,) + shard.shape), 0.0),
            "all_to_all": (np.swapaxes(chunks, 0, 1), 0.0),
            "reduce_scatter": (total, 1e-4),
            "all_reduce": (np.broadcast_to(total, (n,) + total.shape), 1e-4)}


def _moe_setup(dev, dtype, capacity_factor, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, compute_dtype=str(dtype)[6:], moe=dataclasses.replace(
        base.moe, capacity_factor=capacity_factor))
    g = torch.Generator(device=dev).manual_seed(seed)
    params = {k: v.to(dtype) for k, v in init_moe(cfg, g).items()}
    x = _randn(g, (RANKS, MOE_TOKENS, cfg.d_model), dtype, dev)
    return cfg, params, x


def _dense_oracle(cfg, p, x):
    """No-drop dense MoE: every token's top-k experts' outputs, weighted
    (tests/test_latte_moe.py's oracle)."""
    D, K = cfg.d_model, cfg.moe.top_k
    xf = x.reshape(-1, D)
    # routed rank by rank, as the layer does, so both see the same products
    probs = torch.cat([torch.softmax(xr @ p["router"], -1) for xr in x])
    tp, te = torch.topk(probs, K, -1)
    tp = tp / tp.sum(-1, keepdim=True)
    w = torch.zeros_like(probs).scatter_(1, te, tp)
    out = torch.zeros_like(xf)
    for e in range(cfg.moe.n_experts):          # expert by expert, to bound memory
        h = xf @ p["wg"][e]
        y = (torch.nn.functional.silu(h) * (xf @ p["wu"][e])) @ p["wd"][e]
        out += w[:, e:e + 1] * y
    return out.reshape(x.shape)


def phase_collectives_path(dev) -> dict:
    """Phase 7: the collectives path with its launch counts, then its checks
    and the B3/B4 times at the path's shapes."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.backend import COLLECTIVES, CommBackend
    from repro_torch.core.latte_moe import local_capacity, make_latte_moe
    from repro_torch.kernels.ring_all_gather import ops as ag
    from repro_torch.kernels.ring_all_gather.ref import all_gather_ref
    from repro_torch.kernels.ring_all_to_all import ops as aa
    from repro_torch.kernels.ring_all_to_all.ref import all_to_all_ref
    n = RANKS
    ranks = coll.make_ranks(n, dev)
    # the bundled tables cover 16 devices; others are derived, not stale
    be = CommBackend("latte", axis_devices=n, allow_stale_tables=True)
    rng = np.random.default_rng(7)
    # f32 operands: a 2 MiB shard per rank (16 MiB gathered), and 8 chunks
    # of 256 KiB per rank for the all-to-all and the reductions
    operands = {"all_gather": rng.normal(size=(n, 512, ROW)).astype(np.float32)}
    operands["all_to_all"] = rng.normal(size=(n, n, 64, ROW)).astype(np.float32)
    operands["reduce_scatter"] = operands["all_reduce"] = operands["all_to_all"]
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in operands.items()}
    cfg, params, x = _moe_setup(dev, torch.bfloat16, 1.25)
    # decode: 4 tokens a rank, so the capacity is local_capacity's floor of 4
    x_dec = _randn(torch.Generator(device=dev).manual_seed(11),
                   (RANKS, MOE_DECODE_TOKENS, cfg.d_model), torch.bfloat16, dev)
    moe = make_latte_moe(cfg, ranks)
    for name in COLLECTIVES:                      # warm-up: libraries, cuBLAS
        getattr(be, name)(on_card[name], ranks)
    moe(params, x)
    moe(params, x_dec)
    torch.cuda.synchronize()

    # ---- the path: counts zeroed just before, read just after ----
    ag.launches = aa.launches = 0
    results = {name: getattr(be, name)(on_card[name], ranks) for name in COLLECTIVES}
    coll_launches = {"ring_all_gather": ag.launches, "all_to_all": aa.launches}
    out, aux = moe(params, x)
    prefill_a2a = aa.launches - coll_launches["all_to_all"]
    out_dec, aux_dec = moe(params, x_dec)
    torch.cuda.synchronize()
    launches = {"ring_all_gather": ag.launches, "all_to_all": aa.launches}
    ag.check()
    aa.check()

    decode_a2a = launches["all_to_all"] - coll_launches["all_to_all"] - prefill_a2a
    if (prefill_a2a, decode_a2a) != (2, 2):
        raise AssertionError(f"the latte MoE forwards launched all_to_all {prefill_a2a} "
                             f"(prefill) and {decode_a2a} (decode) times, want 2 each")
    if coll_launches["ring_all_gather"] == 0 or coll_launches["all_to_all"] == 0:
        raise AssertionError(f"CommBackend did not launch both kernels: {coll_launches}")
    chosen = {}
    for name, (want, atol) in _numpy_oracles(operands, n).items():
        got = results[name].cpu().numpy()
        ok = np.array_equal(got, want) if atol == 0 else np.allclose(got, want, atol=atol)
        if not ok:
            raise AssertionError(f"CommBackend('latte').{name} differs from numpy")
        size = be.message_bytes(name, on_card[name])
        chosen[name] = {"bytes": size, "variant": be.choose(name, size)[0],
                        "max_abs_err": float(np.abs(got - want).max())}
    log(f"[path] CommBackend('latte', axis_devices={n}) on the card: {json.dumps(chosen)}; "
        f"launches ring_all_gather={coll_launches['ring_all_gather']} "
        f"all_to_all={coll_launches['all_to_all']}")

    # ---- latte MoE checks ----
    if out.shape != x.shape or not torch.isfinite(out).all() or not math.isfinite(aux.item()):
        raise AssertionError("latte MoE output is misshapen or not finite")
    plain = make_latte_moe(cfg, ranks, all_to_all=lambda xs, rk: all_to_all_ref(xs))
    out_plain, aux_plain = plain(params, x)
    if not (torch.equal(out, out_plain) and torch.equal(aux, aux_plain)):
        raise AssertionError("latte MoE with B4 differs from the same layer with its plain version")
    C = local_capacity(cfg, MOE_TOKENS)
    send_shape = (n, n, cfg.moe.n_experts // n * C, cfg.d_model)
    fwd = {"call_ms": call_ms(lambda: moe(params, x), reps=10, warmup=2),
           **profile_step(lambda: moe(params, x))}
    fwd["busy_share"] = fwd["busy_ms"] / fwd["call_ms"] if fwd["busy_ms"] else None
    log(f"[path] latte MoE {MOE_ARCH} full width, bf16, {n} ranks x {MOE_TOKENS} tokens, "
        f"capacity {C}: B4 launched 2 times in the forward; bit-equal to the plain-a2a "
        f"layer; all-to-all operand {list(send_shape)}; forward {json.dumps(fwd)}")

    # ---- the same layer at decode size: B4 at 1 MiB a rank ----
    if (out_dec.shape != x_dec.shape or not torch.isfinite(out_dec).all()
            or not math.isfinite(aux_dec.item())):
        raise AssertionError("decode-size latte MoE output is misshapen or not finite")
    out_dec_plain, aux_dec_plain = plain(params, x_dec)
    if not (torch.equal(out_dec, out_dec_plain) and torch.equal(aux_dec, aux_dec_plain)):
        raise AssertionError("decode-size latte MoE with B4 differs from the plain-a2a layer")
    C_dec = local_capacity(cfg, MOE_DECODE_TOKENS)
    dec_shape = (n, n, cfg.moe.n_experts // n * C_dec, cfg.d_model)
    xs_dec = torch.randn(dec_shape, device=dev).to(torch.bfloat16)
    if not torch.equal(aa.all_to_all(xs_dec, "b2b"), all_to_all_ref(xs_dec)):
        raise AssertionError(f"all_to_all b2b differs at {list(dec_shape)}")
    dec = {"per_rank_bytes": xs_dec[0].numel() * 2,
           "kernel_ms": device_ms(lambda: aa.all_to_all(xs_dec, "b2b")),
           "kernel_call_ms": call_ms(lambda: aa.all_to_all(xs_dec, "b2b")),
           "kernel_host_us": host_us(lambda: aa.all_to_all(xs_dec, "b2b")),
           "library_ms": device_ms(lambda: xs_dec.transpose(0, 1).contiguous()),
           "library_call_ms": call_ms(lambda: xs_dec.transpose(0, 1).contiguous()),
           "bound_ms": bound_ms(2 * xs_dec.numel() * 2, 0, torch.bfloat16)[0],
           "forward_call_ms": call_ms(lambda: moe(params, x_dec), reps=20, warmup=2),
           "forward_plain_a2a_call_ms": call_ms(lambda: plain(params, x_dec), reps=20,
                                                warmup=2)}
    aa.check()
    log(f"[path] latte MoE {MOE_ARCH} full width at decode, bf16, {n} ranks x "
        f"{MOE_DECODE_TOKENS} tokens, capacity {C_dec}: B4 launched 2 times in the forward; "
        f"bit-equal to the plain-a2a layer; all-to-all operand {list(dec_shape)}: "
        f"{json.dumps(dec)}")

    # ---- B3 / B4 times at the path's shapes ----
    xs_ag = on_card["all_gather"].reshape(n, 512, ROW)
    ag_bound = bound_ms((1 + n) * xs_ag.numel() * 4, 0, torch.float32)
    b3 = dict(kernel_ms=device_ms(lambda: ag.ring_all_gather(xs_ag, "bcst_b2b")),
              plain_ms=device_ms(lambda: all_gather_ref(xs_ag)),
              library_ms=device_ms(lambda: xs_ag.reshape(1, -1, ROW).expand(n, -1, -1)
                                   .contiguous()),
              call_ms=call_ms(lambda: ag.ring_all_gather(xs_ag, "bcst_b2b")),
              bound_ms=ag_bound[0], bound_by=ag_bound[1],
              max_abs_err=(ag.ring_all_gather(xs_ag, "bcst_b2b") - all_gather_ref(xs_ag))
              .abs().max().item())
    xs_aa = torch.randn(send_shape, device=dev).to(torch.bfloat16)
    aa_bound = bound_ms(2 * xs_aa.numel() * 2, 0, torch.bfloat16)
    b4 = dict(kernel_ms=device_ms(lambda: aa.all_to_all(xs_aa, "b2b")),
              plain_ms=device_ms(lambda: all_to_all_ref(xs_aa)),
              library_ms=device_ms(lambda: xs_aa.transpose(0, 1).contiguous()),
              call_ms=call_ms(lambda: aa.all_to_all(xs_aa, "b2b")),
              bound_ms=aa_bound[0], bound_by=aa_bound[1],
              max_abs_err=(aa.all_to_all(xs_aa, "b2b").float() - all_to_all_ref(xs_aa).float())
              .abs().max().item())
    ag.check()
    aa.check()
    log(f"[kernel] ring_all_gather bcst_b2b f32 [{n},512,{ROW}] (the path's all-gather): "
        f"{json.dumps(b3)}")
    log(f"[kernel] all_to_all b2b bf16 {list(send_shape)} (the MoE's all-to-all): "
        f"{json.dumps(b4)}")
    del params, x, out, out_plain, on_card, results, x_dec, out_dec, out_dec_plain, xs_dec
    torch.cuda.empty_cache()
    return {"launches": launches, "ring_all_gather": b3, "all_to_all": b4}


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a bf16 / f32 tensor, on the host (the numpy oracle's
    terms: bit-equal in either dtype)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).cpu().numpy()


def _rank_call_ms(ranks, fn, reps: int) -> float:
    """Median ms of one call of ``fn`` on this rank, every rank released
    together by a gloo barrier, host clock to the end of a synchronise."""
    times = []
    for _ in range(reps):
        ranks.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _sum_oracle(xc: torch.Tensor, rows) -> tuple[np.ndarray, np.ndarray]:
    """numpy's sum over ranks (float64) of the addends xc [n (from), n (for),
    ...] for the ``rows`` kept, and its tolerance: f32 atol 1e-4; bf16 one
    ulp (2^-7) of sum_e |x_e| for each of the n - 1 adds."""
    x = xc.double().cpu().numpy()[:, rows]
    n = xc.shape[0]
    atol = 1e-4 if xc.dtype == torch.float32 else 2.0 ** -7 * (n - 1) * np.abs(x).sum(0)
    return x.sum(0), atol


def procs_reductions(ranks, labels, all_reduce, g, bad, call, err) -> int:
    """Phase 7b's reductions on this rank: the ring reduce-scatter per rank
    (and the ring all-reduce) at each size, bf16 and f32, bit-equal to the
    emulated rendering (``err``: the largest difference, bf16) and within
    numpy's sum; bf16 call ms.  Returns the results checked."""
    from repro_torch.core import collectives as coll
    n, my, dev = ranks.n, ranks.rank, ranks.device
    emulated, checked = coll.make_ranks(n, dev), 0
    for label in labels:
        for dtype in (torch.bfloat16, torch.float32):
            rows = PROCS_BYTES[label] // n // (ROW * torch.finfo(dtype).bits // 8)
            xc = _randn(g, (n, n, rows, ROW), dtype, dev)    # rank j's addends: xc[j]
            cases = [("ring_reduce_scatter", coll.ring_reduce_scatter, my)]
            if all_reduce:
                cases.append(("ring_all_reduce", coll.ring_all_reduce, slice(None)))
            for name, fn, rows_kept in cases:
                got = fn(xc[my], ranks)
                want, atol = _sum_oracle(xc, rows_kept)
                if not (np.abs(got.double().cpu().numpy() - want) <= atol).all():
                    bad.append(f"rank {my}: {name} {label} {dtype} differs from numpy's sum")
                plain = fn(xc, emulated)[my]
                if not torch.equal(got, plain):
                    bad.append(f"rank {my}: {name} {label} {dtype} differs from the emulated "
                               f"rendering")
                checked += 1
                if dtype == torch.bfloat16:
                    err[f"{name} {label}"] = (got.float() - plain.float()).abs().max().item()
                    call[f"{name} {label}"] = _rank_call_ms(ranks, lambda: fn(xc[my], ranks),
                                                            PROCS_REPS)
            del xc
            torch.cuda.empty_cache()
    return checked


def procs_moe(ranks, g, bad, call) -> dict:
    """Phase 7b's latte MoE layer on this rank: olmoe-1b-7b at full width,
    bf16, at prefill and decode size, bit-equal to the emulated layer on the
    same tokens and weights, each forward launching B4 per rank twice; bf16
    call ms."""
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.core.latte_moe import make_latte_moe
    from repro_torch.kernels.ring_all_to_all import ops as aa
    from repro_torch.models.moe import init_moe
    n, my, dev = ranks.n, ranks.rank, ranks.device
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, compute_dtype="bfloat16", moe=dataclasses.replace(
        base.moe, capacity_factor=1.25))
    params = {k: v.to(torch.bfloat16) for k, v in init_moe(cfg, g).items()}
    moe, emulated = make_latte_moe(cfg, ranks), make_latte_moe(cfg, coll.make_ranks(n, dev))
    out = {"checked": 0, "a2a_per_forward": {}}
    for label, tokens in (("prefill", MOE_TOKENS), ("decode", MOE_DECODE_TOKENS)):
        x = _randn(g, (n, tokens, cfg.d_model), torch.bfloat16, dev)   # rank j's: x[j]
        before = aa.launches_rank
        got, aux = moe(params, x[my:my + 1])
        out["a2a_per_forward"][label] = aa.launches_rank - before
        want, want_aux = emulated(params, x)
        if not (torch.equal(got[0], want[my]) and torch.equal(aux, want_aux)):
            err = (got[0].float() - want[my].float()).abs().max().item()
            bad.append(f"rank {my}: latte MoE {label} differs from the emulated layer by {err}")
        if not torch.isfinite(got).all():
            bad.append(f"rank {my}: latte MoE {label} is not finite")
        out["checked"] += 1
        call[f"latte_moe {label}"] = _rank_call_ms(ranks, lambda: moe(params, x[my:my + 1]),
                                                   PROCS_REPS)
        del x, got, want
    del params
    torch.cuda.empty_cache()
    return out


def procs_rank(ranks, run, seed) -> dict:
    """One process of phase 7b: its rank of every B3 / B4 variant at each
    size, in bf16 and f32, against the numpy oracle and the emulated single
    launch on the same inputs (every rank makes the global inputs from
    ``seed`` on its card); then the reductions and the latte MoE layer as
    ``run`` asks; bf16 call ms."""
    from repro_torch.kernels.ring_all_gather import ops as ag
    from repro_torch.kernels.ring_all_to_all import ops as aa
    from repro_torch.kernels.ring_reduce_scatter import ops as rs
    n, my, dev = ranks.n, ranks.rank, ranks.device
    sizes, ag_variants, aa_variants = run["sizes"], run["ag"], run["aa"]
    g = torch.Generator(device=dev).manual_seed(seed)
    bad, call, err, checked = [], {}, {}, 0
    ag.launches_rank = aa.launches_rank = rs.launches_rank = 0
    for label in sizes:
        for dtype in (torch.bfloat16, torch.float32):
            rows = PROCS_BYTES[label] // n // (ROW * torch.finfo(dtype).bits // 8)
            xs = _randn(g, (n, rows, ROW), dtype, dev)          # rank j's shard: xs[j]
            xa = _randn(g, (n, n, rows, ROW), dtype, dev)       # rank j's chunks: xa[j]
            oracles = {"ring_all_gather": _bits(xs).reshape(n * rows, ROW),
                       "all_to_all": _bits(xa[:, my])}
            cases = [("ring_all_gather", v, lambda v=v: ag.ring_all_gather_rank(xs[my], ranks, v),
                      lambda v=v: ag.ring_all_gather(xs, v)[my]) for v in ag_variants]
            cases += [("all_to_all", v, lambda v=v: aa.all_to_all_rank(xa[my], ranks, v),
                       lambda v=v: aa.all_to_all(xa, v)[my]) for v in aa_variants]
            for name, v, per_rank, emulated in cases:
                got = per_rank()
                if not np.array_equal(_bits(got), oracles[name]):
                    bad.append(f"rank {my}: {name} {v} {label} {dtype} differs from numpy")
                if not torch.equal(got, emulated()):
                    bad.append(f"rank {my}: {name} {v} {label} {dtype} differs from the "
                               f"emulated launch")
                checked += 1
                if dtype == torch.bfloat16:
                    call[f"{name} {v} {label}"] = _rank_call_ms(ranks, per_rank, PROCS_REPS)
            del xs, xa, oracles, cases
            torch.cuda.empty_cache()
    checked += procs_reductions(ranks, run["rs"], run["ar"], g, bad, call, err)
    moe = procs_moe(ranks, g, bad, call) if run["moe"] else None
    ag.check_ranks(ranks)
    aa.check_ranks(ranks)
    rs.check_ranks(ranks)
    ag.check()
    aa.check()
    return {"bad": bad, "call_ms": call, "err": err, "checked": checked, "moe": moe,
            "launches": {"ring_all_gather": ag.launches_rank, "all_to_all": aa.launches_rank,
                         "ring_reduce_scatter": rs.launches_rank}}


def _rs_row(dev, res: list) -> dict:
    """The reduce-scatter kernel's row of the kernels line at ``PROCS_RS_ROW``
    from the ranks' results ``res``: its per-rank call ms (median over
    ranks) and largest difference from the emulated rendering; the emulated
    rendering's and ``sum(0)``'s device ms on a global input of the same
    shape; the bound of the whole function: the n x n addends read once and
    the n results written once, n - 1 float32 adds per result element."""
    from repro_torch.core import collectives as coll
    n, label = PROCS_RS_ROW
    rows = PROCS_BYTES[label] // n // (ROW * 2)
    xc = _randn(torch.Generator(device=dev).manual_seed(9), (n, n, rows, ROW), torch.bfloat16,
                dev)
    emulated = coll.make_ranks(n, dev)
    n_bytes = (xc.numel() + xc[0].numel()) * xc.element_size()
    bound = bound_ms(n_bytes, xc[0].numel() * (n - 1), torch.float32)
    key = f"ring_reduce_scatter {label}"
    return {"kernel_ms": statistics.median(r["call_ms"][key] for r in res),
            "plain_ms": device_ms(lambda: coll.ring_reduce_scatter(xc, emulated)),
            "library_ms": device_ms(lambda: xc.sum(0)),
            "bound_ms": bound[0], "bound_by": bound[1],
            "max_abs_err": max(r["err"][key] for r in res),
            "shape": f"{n} processes x [{n},{rows},{ROW}] bf16 ({label} a rank)"}


def phase_collectives_procs(dev) -> dict:
    """Phase 7b: B3, B4, the ring reduce-scatter and all-reduce and the
    latte MoE layer with one rank per process (``PROCS_RUNS``)."""
    from repro_torch.core.procgroup import spawn
    launches = {"ring_all_gather": 0, "all_to_all": 0, "ring_reduce_scatter": 0}
    rs_row = None
    for run in PROCS_RUNS:
        n = run["n"]
        t0 = time.perf_counter()
        res = spawn(procs_rank, n, device=dev.type, args=(run, 20 + n), timeout_s=600)
        bad = [b for r in res for b in r["bad"]]
        if bad:
            raise AssertionError(f"{n} processes: {bad[:8]}")
        for r in res:
            for name in launches:
                launches[name] += r["launches"][name]
        for name, variants in (("ring_all_gather", run["ag"]), ("all_to_all", run["aa"]),
                               ("ring_reduce_scatter", run["rs"])):
            if variants and any(r["launches"][name] == 0 for r in res):
                raise AssertionError(f"{n} processes: a rank never launched {name} per rank")
        by_rank = {key: [r["call_ms"][key] for r in res] for key in res[0]["call_ms"]}
        log(f"[procs] {n} processes on one card, one rank each (CUDA IPC, system-scope flags): "
            f"{sum(r['checked'] for r in res)} results bit-equal to the emulated launch or "
            f"rendering and to numpy (sums within its tolerance); "
            f"{time.perf_counter() - t0:.3f}s; per-rank launches {[r['launches'] for r in res]}")
        log(f"[procs] {n} processes, bf16 call ms by rank (processes time-sliced on one card: "
            f"not an interconnect figure and not a speed result): {json.dumps(by_rank)}")
        if run["moe"]:
            moe = [r["moe"] for r in res]
            if any(m["a2a_per_forward"] != {"prefill": 2, "decode": 2} for m in moe):
                raise AssertionError(f"a latte MoE forward per rank did not launch B4 per rank "
                                     f"twice: {[m['a2a_per_forward'] for m in moe]}")
            log(f"[procs-moe] {MOE_ARCH} latte MoE per rank, full width, bf16, {n} processes x "
                f"{MOE_TOKENS} (prefill) and {MOE_DECODE_TOKENS} (decode) tokens: "
                f"{sum(m['checked'] for m in moe)} forwards bit-equal to the emulated layer, B4 "
                f"per rank {moe[0]['a2a_per_forward']} a forward")
        if (n, PROCS_RS_ROW[1]) == PROCS_RS_ROW:
            rs_row = _rs_row(dev, res)
            log(f"[kernel] ring_reduce_scatter per rank (per-rank call ms, processes "
                f"time-sliced on one card; plain and library: device ms on one process): "
                f"{json.dumps(rs_row)}")
    return {"launches": launches, "ring_reduce_scatter": rs_row}


def phase_moe_exactness(dev) -> None:
    """float32 (TF32 off) latte MoE at full width with no drops against the
    dense oracle.  Capacity factor 8 = n_experts / top_k makes the local
    capacity equal the 512 tokens of a rank, the most one expert can get."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.latte_moe import local_capacity, make_latte_moe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, x = _moe_setup(dev, torch.float32, 8.0, seed=1)
    assert local_capacity(cfg, MOE_TOKENS) == MOE_TOKENS
    out, _ = make_latte_moe(cfg, coll.make_ranks(RANKS, dev))(params, x)
    want = _dense_oracle(cfg, params, x)
    err = (out - want).abs().max().item()
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"float32 latte MoE differs from the dense oracle by {err} > {tol}")
    log(f"[exact] latte MoE {MOE_ARCH} float32 (TF32 off), no drops: max |latte - dense| = "
        f"{err} <= {tol}, out max |y| = {want.abs().max().item()}")
    del params, x, out, want
    torch.cuda.empty_cache()


def log_dispatch_tables() -> None:
    """The variant ``CommBackend('latte', axis_devices=n)`` picks at 64 KiB
    and 16 MiB for each collective, from tables the port's own simulator
    derives (or its bundled copy of the reference's, keyed by the same
    fingerprint): modeled TPU v5e pod tables, not H100 ones."""
    from repro_torch.core import backend
    from repro_torch.core.dma.topology import tpu_v5e_pod
    rows = {}
    for n in (4, 8, 16):
        t0 = time.perf_counter()
        be = backend.CommBackend("latte", axis_devices=n, allow_stale_tables=True)
        rows[n] = {name: {size: be.choose(name, b)[0]
                          for size, b in (("64KiB", 64 << 10), ("16MiB", 16 << 20))}
                   for name in backend.COLLECTIVES}
        rows[n]["source"] = ("bundled" if backend._bundled_current(
            tpu_v5e_pod(n), tuple(backend._SWEEP_SIZES)) else "derived")
        rows[n]["host_s"] = time.perf_counter() - t0
    log(f"[dispatch] modeled TPU-pod tables (the port's DMA simulator, not measured): "
        f"CommBackend('latte', axis_devices=n) picks {json.dumps(rows)}")


# ---------------------------------------------------------------- 10-12 ----
def _leaves(tree):
    from repro_torch.train.tree import tree_leaves
    return tree_leaves(tree)


def _matmul_params(cfg, params) -> float:
    """N of 6·N·T: the weights a token's matmuls use, i.e. every leaf of the
    decoder's stack of layers, with an MoE block's experts counted at top_k
    / n_experts and Zamba2's shared attention block once per super-block,
    plus the unembedding product (vocab x d_model, tied or not).  Whisper's
    encoder runs on other tokens (``_encoder_matmul_params``)."""
    stack = {"ssm": "blocks", "hybrid": "supers", "audio": "dec_blocks"}.get(cfg.family, "blocks")
    n = float(sum(t.numel() for t in _leaves(params[stack])))
    if cfg.moe:
        experts = sum(b["moe"][k].numel() for b in params["blocks"] for k in ("wg", "wu", "wd"))
        n -= experts * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    if cfg.family == "hybrid":
        n += cfg.n_layers // cfg.hybrid.attn_every * sum(
            t.numel() for t in _leaves(params["shared_attn"]))
    return n + cfg.vocab * cfg.d_model


def _encoder_matmul_params(cfg, params) -> float:
    return float(sum(t.numel() for t in _leaves(params["enc_blocks"]))) \
        if cfg.family == "audio" else 0.0




def phase_train(dev, cfg, steps: int, seed: int, card: str, batch_size: int = TRAIN_B,
                seq: int = TRAIN_S, cuda_only: bool = False) -> dict:
    """Train ``cfg`` through ``train_loop`` (bf16 compute on float32
    masters) on ``batch_size`` x ``seq`` tokens a step (and Whisper's stub
    features); the router aux loss of every step is recorded by wrapping the
    model's forward.  Checks finiteness; returns the history and times."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, data_iterator, synth_batch
    from repro_torch.launch.train import with_encoder_feats
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.train.loop import cast_params_for_compute, make_train_step, train_loop
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    model = build_model(cfg)
    auxes = []
    forward = model.forward

    def recording_forward(params, batch, **kw):
        out = forward(params, batch, **kw)
        auxes.append(out[1].detach())
        return out

    model = dataclasses.replace(model, forward=recording_forward)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch_size, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = train_loop(model, with_encoder_feats(cfg, data_iterator(dc), batch_size, seed,
                                                       dev),
                             steps=steps, opt_cfg=opt_cfg,
                             gen=torch.Generator(device=dev).manual_seed(seed), log_every=1,
                             device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    aux = [a.item() for a in auxes]
    if len(hist) != steps or len(aux) != steps:
        raise AssertionError(f"{cfg.name}: {len(hist)} history entries, {len(aux)} forwards "
                             f"for {steps} steps")
    if not all(math.isfinite(x) for x in losses + gnorms + aux):
        raise AssertionError(f"{cfg.name}: a non-finite loss, grad norm or aux loss: "
                             f"{losses} {gnorms} {aux}")

    # The step's time: the loop's per-step wall clock (each step ends in a
    # host read of its metrics), median after two warm-up steps; busy time
    # and launches from the profiler over two more steps from the trained
    # state (outside the loop, so the launches count one whole step).
    walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"] for a, b in zip(hist, hist[1:])]
    step_ms = statistics.median(walls[2:]) * 1e3
    step_fn = make_train_step(model, opt_cfg)
    batch = next(with_encoder_feats(cfg, iter([synth_batch(dc, steps)]), batch_size, seed, dev))
    batch = {k: v.to(dev) for k, v in batch.items()}
    reps = 1 if cuda_only else 2
    prof = profile_step(lambda: step_fn(state, batch), reps=reps, cuda_only=cuda_only)
    # the step's parts: the forward and loss alone, and AdamW alone (the
    # moments stand in for gradients: the same ops on the same shapes);
    # recomputation and backward are the rest
    with torch.no_grad():
        fwd = profile_step(lambda: model.loss(cast_params_for_compute(state["params"]), batch,
                                              remat=False), reps=reps, cuda_only=cuda_only)
    adamw = profile_step(lambda: adamw_update(opt_cfg, state["params"], state["opt"]["m"],
                                              state["opt"]), reps=reps, cuda_only=cuda_only)
    parts = {name: {"busy_ms": p["busy_ms"], "device_launches": p["device_launches"]}
             for name, p in (("forward_and_loss", fwd), ("adamw", adamw))}
    parts["recompute_and_backward"] = {
        k: prof[k] - fwd[k] - adamw[k] for k in ("busy_ms", "device_launches")}
    tokens = batch_size * seq
    n_mm = _matmul_params(cfg, state["params"])
    enc_tokens = batch_size * cfg.encdec.encoder_seq if cfg.encdec else 0
    bound = 8 * (n_mm * tokens + _encoder_matmul_params(cfg, state["params"]) * enc_tokens) \
        / peak_flops(torch.bfloat16) * 1e3
    # the port's roofline of the same step: model FLOPs (the reference's
    # 6·N·T formula), and the costing's per-device terms on a (1, 1) mesh
    shape = ShapeConfig("train_step", seq, batch_size, "train")
    mf = model_flops(cfg, shape)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "params": sum(t.numel() for t in _leaves(state["params"])),
           "batch": batch_size, "seq": seq, "steps": steps, "lr": opt_cfg.lr,
           "loss": losses, "grad_norm": gnorms, "aux": aux,
           "step_call_ms_median": step_ms, "step_ms_samples": [w * 1e3 for w in walls],
           "busy_ms": prof["busy_ms"],
           "busy_share": prof["busy_ms"] / step_ms if prof["busy_ms"] else None,
           "device_launches_per_step": prof["device_launches"], "top_ms": prof["top_ms"],
           "busy_ms_by_kind": prof["busy_ms_by_kind"], "parts": parts,
           "tokens_per_s": tokens / (step_ms / 1e3), "phase_s": time.perf_counter() - t0,
           "max_memory_allocated_bytes": peak, "loop_wall_s": wall,
           "matmul_params_N": n_mm, "compute_bound_ms_8NT_bf16": bound,
           "bound_share": bound / step_ms, "model_flops": mf,
           "mfu": mf / (step_ms / 1e3 * peak_flops(torch.bfloat16)),
           "roofline": roofline(dev, cfg, shape), "card": card}
    log(f"[train] {json.dumps(out)}")
    del state, step_fn, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _compare_steps(name, got, want, lr: float) -> dict:
    """Two (state, metrics) results of one train step: loss and grad norm
    within 1e-5 relative; m and v within 1e-4 of each leaf's largest
    element (the gradients' tolerance); params within 2 x lr everywhere (Adam's first steps move an
    element by about lr * sign(g), and where |g| is near eps the two sides'
    rounding may move it differently) and within 1e-6 for all but 1e-3 of
    the elements.  Returns the differences."""
    (gs, gm), (ws, wm) = got, want
    res = {}
    for k in ("loss", "grad_norm"):
        g, w = gm[k].item(), wm[k].item()
        res[f"{k}_rel_err"] = abs(g - w) / abs(w)
        if not res[f"{k}_rel_err"] <= 1e-5:
            raise AssertionError(f"{name}: {k} {g} vs {w}")
    moment_err = 0.0
    for k in ("m", "v"):
        for g, w in zip(_leaves(gs["opt"][k]), _leaves(ws["opt"][k])):
            w = w.to(g.device)
            err = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            moment_err = max(moment_err, err)
    res["moments_err_of_leaf_max"] = moment_err
    if not moment_err <= 1e-4:
        raise AssertionError(f"{name}: Adam moments differ by {moment_err} of a leaf's max")
    max_err, off, total = 0.0, 0, 0
    for g, w in zip(_leaves(gs["params"]), _leaves(ws["params"])):
        err = (g - w.to(g.device)).abs()
        max_err = max(max_err, err.max().item())
        off += int((err > 1e-6).sum().item())
        total += err.numel()
    res.update(param_max_abs_err=max_err, param_max_err_over_lr=max_err / lr,
               params_off_by_more_than_1e_6=off, params=total,
               bit_equal=all(torch.equal(g, w.to(g.device)) for g, w in
                             zip(_leaves(gs), _leaves(ws))))
    if not (max_err <= 2 * lr and off <= 1e-3 * total):
        raise AssertionError(f"{name}: params differ: {res}")
    return res


def phase_train_exactness(dev, seed: int) -> dict:
    from repro_torch.bridge import train_state_from_numpy, train_state_to_numpy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamWConfig, lr_at
    from repro_torch.train.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, compute_dtype="float32")
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30)
    step = make_train_step(model, opt_cfg, cast_params=False)
    dc = DataConfig(vocab=cfg.vocab, seq_len=EXACT_S, batch=EXACT_B, seed=seed)
    batches = [synth_batch(dc, i) for i in range(2)]
    cpu_state = init_train_state(model, torch.Generator().manual_seed(seed))
    state = tree_map(lambda t: t.to(dev), cpu_state)
    t0 = time.perf_counter()
    want = step(cpu_state, batches[0])
    cpu_s = time.perf_counter() - t0
    got = step(state, {k: v.to(dev) for k, v in batches[0].items()})
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "n_layers": 2, "batch": EXACT_B, "seq": EXACT_S,
           "cpu_step_s": cpu_s,
           "card_vs_cpu": _compare_steps("card vs CPU step", got, want,
                                         lr_at(opt_cfg, 1).item())}
    del cpu_state, want
    gc.collect()

    state1 = got[0]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        tree = train_state_to_numpy(cfg, state1)
        t0 = time.perf_counter()
        save_checkpoint(path, tree, step=1)
        out["checkpoint_save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = train_state_from_numpy(cfg, restore_checkpoint(path, tree), device=dev)
        out["checkpoint_restore_s"] = time.perf_counter() - t0
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(_leaves(restored), _leaves(state1))):
        raise AssertionError("the restored train state differs from the saved one")
    batch = {k: v.to(dev) for k, v in batches[1].items()}
    out["resume_vs_memory"] = _compare_steps("step from the restored state",
                                             step(restored, batch), step(state1, batch),
                                             lr_at(opt_cfg, 2).item())
    log(f"[train-exact] {json.dumps(out)}")
    del state, state1, restored, got, tree
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- 3 ----
def check_out_of_range_tables(dev) -> None:
    """ROADMAP C-port3: tables padded past each length with -1, n_pool and
    1000.  B1 bit-equal to its plain version (zero blocks there), B2 within
    its tolerances of its plain version, f32 and bf16."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.paged_kv_gather import ops as gather_ops
    from repro_torch.kernels.paged_kv_gather.ref import paged_kv_gather_ref
    g = torch.Generator(device=dev).manual_seed(8)
    n_pool = 4
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        pool = _randn(g, (n_pool, BT, 2048), dtype, dev)
        tbl = torch.tensor([2, -1, n_pool, 0, 1000, 3], dtype=torch.int32, device=dev)
        out, ref = gather_ops.gather_blocks(pool, tbl), paged_kv_gather_ref(pool, tbl)
        torch.cuda.synchronize()
        if not torch.equal(out, ref) or torch.count_nonzero(out[[1, 2, 4]]) != 0:
            raise AssertionError(f"paged_kv_gather {dtype}: out-of-range entries are not "
                                 "zero blocks equal to the plain version's")
        q = _randn(g, (2, 2, 7, 64), dtype, dev)
        kp, vp = (_randn(g, (n_pool, BT, 2, 64), dtype, dev) for _ in range(2))
        lengths = torch.tensor([20, 24], dtype=torch.int32, device=dev)
        for pad in (-1, n_pool, 1000):
            tables = torch.tensor([[0, 1, pad, pad], [2, 3, pad, pad]], dtype=torch.int32,
                                  device=dev)
            o = da_ops.decode_attention(q, kp, vp, tables, lengths)
            r = paged_decode_attention_ref(q, kp, vp, tables, lengths)
            torch.cuda.synchronize()
            if not torch.isfinite(o.float()).all():
                raise AssertionError(f"paged_decode_attention {dtype} pad {pad}: not finite")
            torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol)
            errs[f"{str(dtype)[6:]} pad {pad}"] = (o.float() - r.float()).abs().max().item()
    log(f"[kernel] C-port3: tables padded with -1, n_pool, 1000: paged_kv_gather bit-equal "
        f"(zero blocks), paged_decode_attention max_abs_err {json.dumps(errs)}")


# ---------------------------------------------------------------- 13-17 ----
def _family_batch(cfg, batch_size: int, seq: int, seed: int, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (batch_size, seq), generator=g, device=dev,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["encoder_feats"] = torch.randn((batch_size, cfg.encdec.encoder_seq, cfg.d_model),
                                             generator=g, device=dev)
    return batch


def _decode_caches(model, cache_out, capacity: int):
    """The decode caches of the states ``forward(want_cache=True)`` returns:
    rwkv's are its states; zamba's attention K/V and whisper's self K/V go
    into caches of ``capacity``; whisper's cross K/V are taken as they are."""
    from repro_torch.models.attention import prefill_cache
    cfg = model.cfg
    if cfg.family == "ssm":
        return cache_out
    if cfg.family == "hybrid":
        return {"mamba": cache_out["mamba"],
                "attn": [prefill_cache(cfg, k, v, capacity) for k, v in cache_out["kv"]]}
    return {"self": [prefill_cache(cfg, k, v, capacity) for k, v in cache_out["self"]],
            "cross": cache_out["cross"]}


def phase_family(dev, cfg, seed: int, batch_size: int, seq: int, n_decode: int = 8) -> dict:
    """A family at full width: a bf16 prefill of ``batch_size`` x ``seq``
    through ``forward(want_cache=True)``, then ``n_decode`` greedy decode
    steps from the returned states.  Checks shapes and finiteness; logs call
    ms, busy ms, launches and busy share of the prefill and of one decode
    step, and the peak memory."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(t.numel() for t in _leaves(params))
    batch = _family_batch(cfg, batch_size, seq, seed, dev)
    with torch.no_grad():
        logits, _, cache_out = model.forward(params, batch, want_cache=True)
        caches = _decode_caches(model, cache_out, seq + n_decode + 1)
        tok = logits[:, -1:].argmax(-1)
        tokens = [tok]
        for i in range(n_decode):
            step_logits, caches = model.decode_step(params, {"tokens": tok, "pos": seq + i},
                                                    caches)
            if step_logits.shape != (batch_size, 1, cfg.vocab) \
                    or not torch.isfinite(step_logits.float()).all():
                raise AssertionError(f"{cfg.name}: decode step {i}: misshapen or non-finite")
            tok = step_logits.argmax(-1)
            tokens.append(tok)
    if logits.shape != (batch_size, seq, cfg.vocab) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{cfg.name}: prefill logits misshapen or non-finite")
    path_s = time.perf_counter() - t0
    with torch.no_grad():
        steps = {"prefill": lambda: model.forward(params, batch, want_cache=True),
                 "decode_step": lambda: model.decode_step(
                     params, {"tokens": tok, "pos": seq + n_decode}, caches)}
        times = {}
        for name, fn in steps.items():
            # the prefill has run once already (the path above)
            row = {"call_ms": call_ms(fn, reps=2, warmup=0) if name == "prefill"
                   else call_ms(fn, reps=10, warmup=1), **profile_step(fn, reps=1, cuda_only=True)}
            row["busy_share"] = row["busy_ms"] / row["call_ms"] if row["busy_ms"] else None
            times[name] = row
    out = {"arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params, "dtype": cfg.compute_dtype,
           "batch": batch_size, "seq": seq, "decode_steps": n_decode,
           "tokens": torch.cat(tokens, 1)[0].tolist(), "path_s": path_s,
           "step_ms": times, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "phase_s": time.perf_counter() - t0}
    log(f"[family] {json.dumps(out)}")
    del model, params, batch, logits, cache_out, caches, steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_family_exactness(dev, cfg, seed: int) -> dict:
    """``cfg``'s widths at 2 layers in float32 (TF32 off): the card's forward
    against the CPU's on the same params and inputs within 1e-5 of the
    largest logit, and on the card the token-by-token decode stream from
    empty caches (Whisper's cross K/V from the forward) against the full
    forward within 1e-4 (the reference's
    ``test_ssm_state_streaming_equivalence``, at a float32 tolerance)."""
    from repro_torch.models import build_model
    from repro_torch.train.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    changes = {"n_layers": 2, "compute_dtype": "float32"}
    if cfg.hybrid:
        changes["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=1)
    cfg = dataclasses.replace(cfg, **changes)
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(seed))
    params = tree_map(lambda t: t.to(dev), cpu_params)
    B, S = 1, 32
    cpu_batch = _family_batch(cfg, B, S, seed, torch.device("cpu"))
    batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    with torch.no_grad():
        want, _, _ = model.forward(cpu_params, cpu_batch)
        full, _, cache_out = model.forward(params, batch, want_cache=True)
        scale = want.abs().max().item()
        card_vs_cpu = (full.cpu() - want).abs().max().item() / scale
        if not card_vs_cpu <= 1e-5:
            raise AssertionError(f"{cfg.name}: card forward differs from the CPU's by "
                                 f"{card_vs_cpu} of the largest logit")
        caches = model.init_caches(B, S + 2, dev)
        if cfg.family == "audio":
            caches["cross"] = cache_out["cross"]
        stream = []
        for t in range(S):
            dl, caches = model.decode_step(params, {"tokens": batch["tokens"][:, t:t + 1],
                                                    "pos": t}, caches)
            stream.append(dl)
        stream_err = (torch.cat(stream, 1) - full).abs().max().item()
    if not stream_err <= 1e-4:
        raise AssertionError(f"{cfg.name}: the decode stream differs from the forward by "
                             f"{stream_err}")
    out = {"arch": cfg.name, "n_layers": 2, "attn_every": cfg.hybrid.attn_every if cfg.hybrid
           else None, "tokens": B * S, "card_vs_cpu_rel": card_vs_cpu,
           "stream_vs_forward_abs": stream_err, "max_abs_logit": scale}
    log(f"[family-exact] {json.dumps(out)}")
    del model, cpu_params, params, caches, cache_out
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (arch, shape, multi-pod) pairs of the dry-run phase
DRYRUN_PAIRS = (("qwen2-0.5b", "train_4k", True), ("qwen2-0.5b", "prefill_32k", False),
                ("qwen2-0.5b", "decode_32k", False), ("qwen2-0.5b", "long_500k", False),
                (MOE_ARCH, "train_4k", True))


# the dry-run's plan must not depend on the torch version (C-port8): each
# traced pair's per-device FLOPs, wire bytes and temp within PLAN_RTOL of the
# figures tools/dryrun_plans.py recorded on the CPU (tools/dryrun_plans.json)
PLAN_RTOL = 0.01


def _plans():
    """``tools/dryrun_plans.py`` as a module, and its recorded figures."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import dryrun_plans
    with open(dryrun_plans.JSON_PATH) as f:
        return dryrun_plans, json.load(f)


def check_recorded_plan(name: str, got: dict, want: dict, recorded: dict) -> dict:
    """One ``[dryrun-torch-versions]`` line: a trace's FLOPs, wire bytes and
    temp per device on this torch against the figures recorded on
    ``recorded['torch']``; raises where one is off by more than
    ``PLAN_RTOL``."""
    row = {"trace": name, "torch": torch.__version__, "recorded_torch": recorded["torch"]}
    for k in ("flops", "wire", "temp"):
        row[k], row["recorded_" + k] = got[k], want[k]
        row[k + "_ratio"] = got[k] / want[k] if want[k] else None
    log(f"[dryrun-torch-versions] {json.dumps(row)}")
    for k in ("flops", "wire", "temp"):
        if abs(got[k] - want[k]) > PLAN_RTOL * abs(want[k]):
            raise AssertionError(f"{name}: {k} {got[k]} on torch {torch.__version__}, "
                                 f"{want[k]} recorded on {recorded['torch']}")
    return row


def phase_dryrun(dev) -> list:
    """The port's dry-run (``launch.dryrun.run_one``) on fake tensors of the
    card's device type over a fake process group of 256 ranks (512 on the
    multi-pod mesh): one ``[dryrun]`` line per pair; each must be ``ok`` or
    the reference's documented skip, and an ``ok`` pair's FLOPs, wire bytes
    and temp the recorded ones (``check_recorded_plan``)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.input_specs import skip_reason
    from repro_torch.roofline.analysis import model_flops
    plans, recorded = _plans()
    results = []
    for arch, shape_id, multi_pod in DRYRUN_PAIRS:
        res = run_one(arch, shape_id, multi_pod=multi_pod, device=dev, verbose=False)
        row = res.to_json()
        log(f"[dryrun] {json.dumps(row)}")
        skip = skip_reason(get_config(arch), get_shape(shape_id))
        if not (res.status == "ok" or (res.status == "skipped" and res.reason == skip)):
            raise AssertionError(f"dry-run {arch} x {shape_id}: {res.status} {res.reason}")
        if res.status == "ok":
            name = plans.key(arch, shape_id, res.mesh, None, "chunked")
            check_recorded_plan(name, {"flops": res.flops,
                                       "wire": sum(res.wire_bytes_per_device.values()),
                                       "temp": res.peak_bytes_per_device},
                                recorded["dryrun"][name], recorded)
        if res.status == "ok" and not (res.flops > 0 and res.collective_counts):
            raise AssertionError(f"dry-run {arch} x {shape_id}: no FLOPs or no collectives")
        if res.status == "ok" and res.replicated_ops:
            raise AssertionError(f"dry-run {arch} x {shape_id}: ops ran replicated: "
                                 f"{res.replicated_ops}")
        if res.status == "ok" and not res.peak_bytes_per_device:
            raise AssertionError(f"dry-run {arch} x {shape_id}: no per-device peak")
        results.append(row)
    by_pair = {(r["arch"], r["shape"]): r for r in results}
    qwen2, olmoe = by_pair[ARCH, "train_4k"], by_pair[MOE_ARCH, "train_4k"]
    chips = 2 * 16 * 16
    useful = model_flops(get_config(ARCH), get_shape("train_4k")) / (qwen2["flops"] * chips)
    peaks = {f"{r['arch']} {r['shape']} {r['mesh']}": r["peak_bytes_per_device"]
             for r in results if r["status"] == "ok"}
    log(f"[dryrun-summary] {ARCH} train_4k on {qwen2['mesh']}: {qwen2['flops']} FLOPs per "
        f"device, useful ratio {useful}; {MOE_ARCH} train_4k on {olmoe['mesh']}: "
        f"{sum(olmoe['wire_bytes_per_device'].values())} wire B per device "
        f"{json.dumps(olmoe['wire_bytes_per_device'])}; temp peak B per device "
        f"{json.dumps(peaks)}")
    return results


# archs whose 8 KV heads a 'model' of 16 does not divide, traced at 1 layer
# on 16x16 with attention chunked and unchunked (C-port7)
QUERY_CHUNK_PAIRS = [(a, s) for a in ("stablelm-12b", "mixtral-8x7b", "qwen2-vl-72b")
                     for s in ("train_4k", "prefill_32k")]
QUERY_CHUNK_RTOL = 0.03
# the recorded pair whose plan no other trace of phase 18 covers
DECODE_PLAN_PAIR = ("qwen2-0.5b", "decode_32k", "16x16", 2)


def check_query_chunks(dev) -> list:
    """Phase 18's check of the dry-run's query chunks on this torch: each
    pair of ``QUERY_CHUNK_PAIRS`` at full width cut to 1 layer, traced on
    16x16 as the dry-run traces it (attention in query chunks) and with
    attention unchunked (``dense_attention_for_costing``).  Per-device
    FLOPs and wire bytes must agree within ``QUERY_CHUNK_RTOL``: the
    chunks keep one block's plan.  Each trace's FLOPs, wire bytes and temp
    must be the recorded ones (``check_recorded_plan``), and so must those
    of qwen2-0.5b decode_32k at 2 layers on 16x16, traced last."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models.attention import dense_attention_for_costing
    plans, recorded = _plans()
    rows = []
    for arch, shape_id in QUERY_CHUNK_PAIRS:
        cfg = dataclasses.replace(get_config(arch), n_layers=1)
        row = {"arch": arch, "shape": shape_id, "mesh": "16x16", "n_layers": 1,
               "torch": torch.__version__}
        with fake_world(256):
            mesh = make_production_mesh(device=dev)
            for name, attention in (("chunked", contextlib.nullcontext),
                                    ("unchunked", dense_attention_for_costing)):
                t0 = time.perf_counter()
                with attention():
                    tr = trace_step(arch, shape_id, mesh, cfg=cfg, device=dev)
                row[name] = {"flops": tr.flops, "wire": sum(tr.wire.values()),
                             "temp": tr.memory.temp_bytes, "counts": tr.collective_counts,
                             "replicated_ops": tr.replicated_ops,
                             "seconds": time.perf_counter() - t0}
                trace_name = plans.key(arch, shape_id, "16x16", 1, name)
                check_recorded_plan(trace_name, row[name], recorded["traces"][trace_name],
                                    recorded)
        c, u = row["chunked"], row["unchunked"]
        row["flops_ratio"], row["wire_ratio"] = c["flops"] / u["flops"], c["wire"] / u["wire"]
        log(f"[dryrun-query-chunks] {json.dumps(row)}")
        if any(abs(row[k] - 1) > QUERY_CHUNK_RTOL for k in ("flops_ratio", "wire_ratio")):
            raise AssertionError(f"{arch} {shape_id} on 16x16: query chunks give "
                                 f"{row['flops_ratio']} x the FLOPs and {row['wire_ratio']} x "
                                 f"the wire of one block")
        rows.append(row)
    arch, shape_id, mesh_name, layers = DECODE_PLAN_PAIR
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    with fake_world(256):
        tr = trace_step(arch, shape_id, make_production_mesh(device=dev), cfg=cfg, device=dev)
    name = plans.key(arch, shape_id, mesh_name, layers, "chunked")
    rows.append(check_recorded_plan(name, {"flops": tr.flops, "wire": sum(tr.wire.values()),
                                           "temp": tr.memory.temp_bytes},
                                    recorded["traces"][name], recorded))
    return rows


# (arch, layers (None: all), mode) of the dry-run's memory against the card,
# at training's batch x sequence; the measured peak within MEMORY_RTOL
MEMORY_CHECKS = ((ARCH, None, "train"), (ARCH, None, "prefill"), (MOE_ARCH, 2, "train"))
MEMORY_RTOL = 0.10


def check_step_memory(dev, card: str) -> list:
    """Phase 18's card check of the dry-run's memory: each step of
    ``MEMORY_CHECKS`` traced on a fake (1, 1) mesh (``predict_step_memory``)
    and run ONCE on the card (``measure_step_memory``).  The card's peak
    (``max_memory_allocated`` above what was allocated before) must lie
    within ``MEMORY_RTOL`` of the eager peak the trace predicts: the
    arguments plus the peak of all else live.  XLA's argument + output +
    temp, which counts the outputs from the step's start, is logged beside
    it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import measure_step_memory, predict_step_memory
    rows = []
    for arch, layers, mode in MEMORY_CHECKS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        shape = ShapeConfig(f"{mode}_step", TRAIN_S, TRAIN_B, mode)
        t0 = time.perf_counter()
        mem = predict_step_memory(cfg, shape, device=dev)
        trace_s = time.perf_counter() - t0
        got = measure_step_memory(cfg, shape, device=dev)
        row = {"arch": arch, "n_layers": cfg.n_layers, "mode": mode, "batch": TRAIN_B,
               "seq": TRAIN_S, "argument_bytes": mem.argument_bytes,
               "output_bytes": mem.output_bytes, "alias_bytes": mem.alias_bytes,
               "temp_bytes": mem.temp_bytes, "predicted_peak_bytes": mem.live_peak_bytes,
               "argument_output_temp_bytes": mem.total_bytes,
               "measured_argument_bytes": got["argument_bytes"],
               "max_memory_allocated_bytes": got["peak_bytes"],
               "ratio": got["peak_bytes"] / mem.live_peak_bytes,
               "ratio_to_argument_output_temp": got["peak_bytes"] / mem.total_bytes,
               "trace_s": trace_s, "card": card}
        log(f"[memory-check] {json.dumps(row)}")
        if abs(row["ratio"] - 1) > MEMORY_RTOL:
            raise AssertionError(f"{arch} {mode}: the card peaked at {got['peak_bytes']} B, "
                                 f"the dry-run predicts {mem.live_peak_bytes} B")
        rows.append(row)
    return rows


ROOFLINE_PAIRS = [(a, s) for a, s, _ in DRYRUN_PAIRS]


def phase_twins(dev) -> dict:
    """Phase 19: the twins of the JAX package's benchmarks and examples
    (``repro_torch.benchmarks``, ``repro_torch.examples``), in this process
    on the card, each raising on failure: the benchmark harness (dispatch
    tables, multi-node tables, the all-gathers on emulated ranks, trace
    export; every claim must hold), the simulator's hot-path benchmark
    (default run, its >= 5x floor; not ``--check``, whose wall budget
    depends on the host), the roofline table for phase 18's pairs on 16x16,
    the MoE wire comparison at the production shape (> 10x), and the four
    examples (``train_lm`` at 300 steps).  Returns the B1/B3/B4 launches
    the phase made; the ``[twins]`` line gives them by twin (the harness's
    include ``tpu_collectives``' timing calls)."""
    from repro_torch.benchmarks import latte_moe_wire, roofline_table, sim_perf
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import pallas_collectives, quickstart, serve_kv_cache, train_lm
    from repro_torch.kernels.paged_kv_gather import ops as b1
    from repro_torch.kernels.ring_all_gather import ops as ag
    from repro_torch.kernels.ring_all_to_all import ops as aa
    counters = {"paged_kv_gather": b1, "ring_all_gather": ag, "all_to_all": aa}
    by_twin = {}

    def counted(name, fn, *args, **kw):
        for m in counters.values():
            m.launches = 0
        out = fn(*args, **kw)
        by_twin[name] = {k: m.launches for k, m in counters.items() if m.launches}
        return out

    argv = ["--device", str(dev)]
    if counted("benchmarks.run", bench_run.main, argv) != 0:
        raise AssertionError("repro_torch.benchmarks.run: a claim is out of band")
    report = counted("sim_perf", sim_perf.run)
    if not report["speedup"] >= sim_perf.MIN_SPEEDUP:
        raise AssertionError(f"sim_perf: {report['speedup']}x < {sim_perf.MIN_SPEEDUP}x")
    rows, failures = counted("roofline_table", roofline_table.run, ROOFLINE_PAIRS, device=dev)
    if failures or len(rows) != len(ROOFLINE_PAIRS) - 1:      # long_500k is skipped
        raise AssertionError(f"roofline_table: {len(rows)} rows, failures {failures}")
    log(f"[twins] latte_moe_wire ratio {counted('latte_moe_wire', latte_moe_wire.run, device=dev)}")
    counted("quickstart", quickstart.main, argv)
    counted("pallas_collectives", pallas_collectives.main, argv)
    counted("train_lm", train_lm.main, ["--steps", "300"] + argv)
    counted("serve_kv_cache", serve_kv_cache.main, argv)
    launches = {k: sum(n.get(k, 0) for n in by_twin.values()) for k in counters}
    log(f"[twins] launches {json.dumps(launches)} by twin {json.dumps(by_twin)}")
    if not all(launches.values()):
        raise AssertionError(f"the twins did not launch every kernel: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    import repro_torch  # noqa: F401  (fails in a directory without the port)
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    phase_s = {}

    def run(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        log(f"[phase] {name} {phase_s[name]:.3f}s")
        return out

    card = run("card", phase_card)
    run("build", phase_build)
    vlm_cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    b1 = run("gather", check_gather, dev, get_config(ARCH))
    b1_moe = run("gather_moe", check_gather, dev, get_config(MOE_ARCH))
    b1_vlm = run("gather_vlm", check_gather, dev, vlm_cfg)
    b2 = run("decode_attention", check_decode_attention, dev)
    prefill = run("prefill_attention", check_prefill_attention, dev)
    run("out_of_range_tables", check_out_of_range_tables, dev)
    launches = run("serve_" + ARCH, phase_serving, dev, get_config(ARCH), seed=0)
    run("exact_" + ARCH, phase_exactness, dev, ARCH, seed=1)
    run("rank_kernels", check_rank_kernels, dev)
    path = run("collectives_path", phase_collectives_path, dev)
    procs_out = run("collectives_procs", phase_collectives_procs, dev)
    procs = procs_out["launches"]
    run("moe_exact", phase_moe_exactness, dev)
    launches.update(path["launches"])
    moe_launches = run("serve_" + MOE_ARCH, phase_serving, dev, get_config(MOE_ARCH), seed=2)
    run("exact_" + MOE_ARCH, phase_exactness, dev, MOE_ARCH, seed=3)
    run("dispatch", log_dispatch_tables)
    for name, n in moe_launches.items():
        launches[name] += n

    train = run("train_" + ARCH, phase_train, dev, get_config(ARCH), steps=30, seed=4, card=card)
    if not train["loss"][-1] < train["loss"][0] - 0.5:
        raise AssertionError(f"{ARCH}: the loss fell from {train['loss'][0]} to "
                             f"{train['loss'][-1]}, by no more than 0.5")
    run("train_exact", phase_train_exactness, dev, seed=5)
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=2)
    moe_train = run("train_" + MOE_ARCH, phase_train, dev, moe_cfg, steps=10, seed=6, card=card)
    if not all(a > 0 for a in moe_train["aux"]):
        raise AssertionError(f"{MOE_ARCH}: a router aux loss is not positive: {moe_train['aux']}")

    # 13: vlm serving at full width, depth cut to VLM_LAYERS
    vlm_launches = run("serve_" + VLM_ARCH, phase_serving, dev, vlm_cfg, seed=7)
    run("exact_" + VLM_ARCH, phase_exactness, dev, VLM_ARCH, seed=8)
    for name, n in vlm_launches.items():
        launches[name] += n
    # 14-16: the recurrent and encoder-decoder families
    for arch, (b, sq, n_train, train_layers, seed) in FAMILY_RUNS.items():
        cfg = get_config(arch)
        run("family_" + arch, phase_family, dev, cfg, seed=seed, batch_size=b, seq=sq)
        if train_layers:
            cfg = dataclasses.replace(cfg, n_layers=train_layers)
        hist = run("train_" + arch, phase_train, dev, cfg, steps=n_train, seed=seed + 1,
                   card=card, batch_size=b, seq=sq, cuda_only=cfg.family != "audio")
        if cfg.family == "audio" and not hist["loss"][-1] < hist["loss"][0] - 0.5:
            raise AssertionError(f"{arch}: the loss fell from {hist['loss'][0]} to "
                                 f"{hist['loss'][-1]}, by no more than 0.5")
    # 17: float32 exactness of the new families at 2 layers
    for arch, (_, _, _, _, seed) in FAMILY_RUNS.items():
        run("family_exact_" + arch, phase_family_exactness, dev, get_config(arch), seed + 2)
    # 18: the dry-run on the production meshes, and its memory against the card
    run("dryrun", phase_dryrun, dev)
    run("dryrun_query_chunks", check_query_chunks, dev)
    run("dryrun_memory", check_step_memory, dev, card)
    phase_18 = ("dryrun", "dryrun_query_chunks", "dryrun_memory")
    log(f"[phase] 18_total {sum(phase_s[k] for k in phase_18):.3f}s")
    # 19: the twins of the benchmarks and examples
    twins = run("twins", phase_twins, dev)
    for name, n in twins.items():
        launches[name] += n

    kernels = []
    for name, row, replaces in (
            ("paged_kv_gather", b1, "src/repro/kernels/paged_kv_gather/paged_kv_gather.py:26"),
            ("paged_decode_attention", b2,
             "src/repro/kernels/decode_attention/decode_attention.py:79"),
            ("ring_all_gather", path["ring_all_gather"],
             "src/repro/kernels/ring_all_gather/ring_all_gather.py:144"),
            ("all_to_all", path["all_to_all"],
             "src/repro/kernels/ring_all_to_all/ring_all_to_all.py:87"),
            # no TPU kernel: the port's rendering of the reference's ppermute ring
            ("ring_reduce_scatter", procs_out["ring_reduce_scatter"],
             "src/repro/core/collectives.py:97"),
            # no TPU kernel: XLA's einsum and softmax in the reference's attention
            ("prefill_flash_attention", prefill["qwen2-vl-72b"],
             "src/repro/models/attention.py:104")):
        if name != "paged_decode_attention" and launches.get(name, 0) + procs.get(name, 0) == 0:
            raise AssertionError(f"the main path never launched {name}")
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": replaces, "launches": launches.get(name, 0),
                 "launches_in_twins": twins.get(name, 0),
                 "on_main_path": name != "paged_decode_attention",
                 "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        if name in procs:
            entry["launches_by_path"] = {"collectives_path": path["launches"].get(name, 0),
                                         "twins": twins.get(name, 0), "procs": procs[name]}
            entry["launches"] += procs[name]
        if name == "prefill_flash_attention":
            entry["at_olmoe-1b-7b"] = prefill["olmoe-1b-7b"]
            entry["tensor_core_share"] = row["tensor_core_share"]
        if name == "paged_kv_gather":
            entry["launches_by_path"] = {
                ARCH: launches[name] - moe_launches[name] - vlm_launches[name],
                MOE_ARCH: moe_launches[name], VLM_ARCH: vlm_launches[name]}
            for arch, b1_row in ((MOE_ARCH, b1_moe), (VLM_ARCH, b1_vlm)):
                entry["at_" + arch] = {k: b1_row[k] for k in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
        kernels.append(entry)
    log(f"[done] {time.perf_counter() - t0:.1f}s on {card}; phases (s): "
        f"{json.dumps({k: round(v, 3) for k, v in phase_s.items()})}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
