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
   each length are poisoned.  Times by CUDA events
   (median of 50 after warm-up) beside each kernel's bound.
4. Serving qwen2-0.5b at full width (24 layers, bf16, random weights from a
   seed): batch 4, context 1024, 16 new tokens; one miss pass, then a hit
   through each fetch backend.  Fetched blocks must be bit-equal to the
   saved ones, hit tokens identical across backends, the ``kernel``
   pass must launch B1 exactly 2 x batch times, and every hit must carry a
   modeled (MI300X simulator) fetch latency > 0, a miss none.
5. Exactness: the same widths at 2 layers in float32 (TF32 off): every hit
   backend's tokens must equal the miss path's.
6. Collective kernels vs their plain versions over 8 ranks emulated on the
   card (and 6 for B4's rotation pairing), in bf16 and f32, at 64 KiB, 1 MiB,
   16 MiB and 256 MiB gathered per rank: every B3 ``ring_all_gather`` and B4
   ``all_to_all`` variant bit-equal; bf16 times beside the bytes bound
   (input + output bytes at 3.35 TB/s), the plain version and the one-call library
   yardstick; at 64 KiB the time per ring step, whole (time / steps) and
   marginal (8 ranks against 2, same chunks).
7. The collectives path (counts zeroed just before, read just after):
   ``CommBackend('latte', axis_devices=8)`` runs all-gather, all-to-all,
   reduce-scatter and all-reduce (f32) on the card, then one latte MoE layer
   of olmoe-1b-7b at full width (d_model 2048, 64 experts, top-8, d_ff 1024,
   capacity factor 1.25, bf16, 8 ranks x 512 tokens).  Checks: collectives
   against numpy (AG/AA bit-equal, RS/AR atol 1e-4), B3 and B4 launched, the
   MoE forward launching B4 exactly twice and bit-equal to the same layer
   with B4's plain version; a float32 run at the same widths with no drops
   against a dense oracle.
8. Serving olmoe-1b-7b at full width (16 layers, d_model 2048, 16 heads,
   64 experts, top-8, d_ff_expert 1024, capacity factor 1.25, vocab 50,304,
   bf16, random weights from a seed) with phase 4's batch, context, checks
   and times; then its exactness pass as phase 5, at capacity factor 8
   (= experts / top-k, no drops: a hit routes its first token among 4
   tokens, the miss among 4 x 1024).
9. The variants ``CommBackend('latte', axis_devices=n)`` picks for n = 4, 8
   and 16, from modeled TPU-pod tables of the port's own DMA simulator.
10. One JSON line naming every ported kernel with its launches on its path
    (phases 4 and 8 for B1/B2, phase 7 for B3/B4).
11. Last line: ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,        # dense tensor-core bf16
              torch.float32: 67e12}          # f32 outside the tensor cores
B, CTX, NEW = 4, 1024, 16                    # serving batch, context, new tokens
BT = 16                                      # tokens per KV block
ARCH = "qwen2-0.5b"
SOURCES = {"paged_kv_gather": "src/repro_torch/kernels/csrc/paged_kv_gather.cu",
           "paged_decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "ring_all_gather": "src/repro_torch/kernels/csrc/ring_all_gather.cu",
           "all_to_all": "src/repro_torch/kernels/csrc/ring_all_to_all.cu"}
RANKS = 8                                    # emulated ranks of the collectives
ROW = 1024                                   # elements per row of a rank's chunk
GATHERED = {"64KiB": 64 << 10, "1MiB": 1 << 20, "16MiB": 16 << 20, "256MiB": 256 << 20}
L2_BYTES = 50e6                              # H100 L2 cache
MOE_ARCH, MOE_TOKENS = "olmoe-1b-7b", 512    # latte MoE: tokens per rank


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


def profile_step(fn, reps: int = 3) -> dict:
    """Kernel (and copy) time per call of ``fn`` from ``torch.profiler``, with
    the five largest entries; ``busy_ms`` is None when the profiler records
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_ms": busy if by_name else None,
            "device_launches": sum(1 for ev in prof.events()
                                   if ev.device_type == DeviceType.CUDA) // reps,
            "top_ms": [[name[:60], ms] for name, ms in top]}


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
def check_gather(dev, arch: str) -> dict:
    """B1 at the pool shape the ``kernel`` fetch gives it when serving
    ``arch``: one context's blocks, [CTX / BT, BT, layers x KV heads x hd]."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_kv_gather import ops
    from repro_torch.kernels.paged_kv_gather.ref import paged_kv_gather_ref
    cfg = get_config(arch)
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


# ------------------------------------------------------------------ 4, 5 ----
def _engine(cfg, dev, seed=0):
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    return ServeEngine(model, params, device=dev)


def phase_serving(dev, arch: str, seed: int) -> dict:
    """One serving path at full width: warm-up, then the main path with the
    kernels' counts zeroed just before and read just after, its checks, and
    its times.  Returns the path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.paged_kv_gather import ops as gather_ops
    from repro_torch.serve.host_store import BACKENDS
    cfg = get_config(arch)
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
    miss = eng.generate(prompts, keys, NEW)
    hits, delta = {}, {}
    for backend in BACKENDS:
        before = gather_ops.launches
        hits[backend] = eng.generate(prompts, keys, NEW, fetch_backend=backend)
        delta[backend] = gather_ops.launches - before
    launches = {"paged_kv_gather": gather_ops.launches,
                "paged_decode_attention": da_ops.launches}

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
    n_blocks, block_bytes = eng.store.blocks_for(keys[0])
    out = {"arch": arch, "dtype": cfg.compute_dtype, "batch": B, "ctx": CTX, "new": NEW,
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
                   "ag_bound_ms": bound_ms(ag_bytes, 0, dtype)[0],
                   "aa_bound_ms": bound_ms(aa_bytes, 0, dtype)[0], "bound_by": "bytes",
                   "ag_l2_resident": ag_bytes <= L2_BYTES, "aa_l2_resident": aa_bytes <= L2_BYTES}
            row["ag_ms"] = {v: device_ms(lambda v=v: ag.ring_all_gather(xs, v), reps=reps)
                            for v in ag.VARIANTS}
            row["ag_call_ms"] = {v: call_ms(lambda v=v: ag.ring_all_gather(xs, v), reps=reps)
                                 for v in ag.VARIANTS}
            row["ag_plain_ms"] = device_ms(lambda: all_gather_ref(xs), reps=reps)
            row["ag_library_ms"] = device_ms(
                lambda: xs.reshape(1, -1, ROW).expand(n, -1, -1).contiguous(), reps=reps)
            x8 = xa[n]
            row["aa_ms"] = {v: device_ms(lambda v=v: aa.all_to_all(x8, v), reps=reps)
                            for v in aa.VARIANTS}
            row["aa_call_ms"] = {v: call_ms(lambda v=v: aa.all_to_all(x8, v), reps=reps)
                                 for v in aa.VARIANTS}
            row["aa_n6_ms"] = {v: device_ms(lambda v=v: aa.all_to_all(xa[6], v), reps=reps)
                               for v in aa.VARIANTS}
            row["aa_plain_ms"] = device_ms(lambda: all_to_all_ref(x8), reps=reps)
            row["aa_library_ms"] = device_ms(lambda: x8.transpose(0, 1).contiguous(), reps=reps)
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
    moe = make_latte_moe(cfg, ranks)
    for name in COLLECTIVES:                      # warm-up: libraries, cuBLAS
        getattr(be, name)(on_card[name], ranks)
    moe(params, x)
    torch.cuda.synchronize()

    # ---- the path: counts zeroed just before, read just after ----
    ag.launches = aa.launches = 0
    results = {name: getattr(be, name)(on_card[name], ranks) for name in COLLECTIVES}
    coll_launches = {"ring_all_gather": ag.launches, "all_to_all": aa.launches}
    out, aux = moe(params, x)
    torch.cuda.synchronize()
    launches = {"ring_all_gather": ag.launches, "all_to_all": aa.launches}
    ag.check()
    aa.check()

    moe_a2a = launches["all_to_all"] - coll_launches["all_to_all"]
    if moe_a2a != 2:
        raise AssertionError(f"the latte MoE forward launched all_to_all {moe_a2a} times, want 2")
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
    del params, x, out, out_plain, on_card, results
    torch.cuda.empty_cache()
    return {"launches": launches, "ring_all_gather": b3, "all_to_all": b4}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    import repro_torch  # noqa: F401  (fails in a directory without the port)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = phase_card()
    phase_build()
    b1 = check_gather(dev, ARCH)
    b1_moe = check_gather(dev, MOE_ARCH)
    b2 = check_decode_attention(dev)
    launches = phase_serving(dev, ARCH, seed=0)
    phase_exactness(dev, ARCH, seed=1)
    check_rank_kernels(dev)
    path = phase_collectives_path(dev)
    phase_moe_exactness(dev)
    launches.update(path["launches"])
    moe_launches = phase_serving(dev, MOE_ARCH, seed=2)
    phase_exactness(dev, MOE_ARCH, seed=3)
    log_dispatch_tables()
    for name, n in moe_launches.items():
        launches[name] += n
    kernels = []
    for name, row, replaces in (
            ("paged_kv_gather", b1, "src/repro/kernels/paged_kv_gather/paged_kv_gather.py:26"),
            ("paged_decode_attention", b2,
             "src/repro/kernels/decode_attention/decode_attention.py:79"),
            ("ring_all_gather", path["ring_all_gather"],
             "src/repro/kernels/ring_all_gather/ring_all_gather.py:144"),
            ("all_to_all", path["all_to_all"],
             "src/repro/kernels/ring_all_to_all/ring_all_to_all.py:87")):
        if name != "paged_decode_attention" and launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": replaces, "launches": launches[name],
                 "on_main_path": name != "paged_decode_attention",
                 "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        if name == "paged_kv_gather":
            entry["launches_by_path"] = {ARCH: launches[name] - moe_launches[name],
                                         MOE_ARCH: moe_launches[name]}
            entry["at_" + MOE_ARCH] = {k: b1_moe[k] for k in (
                "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
        kernels.append(entry)
    log(f"[done] {time.perf_counter() - t0:.1f}s on {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
