#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. Card: name and power limit from nvidia-smi.
2. Build: compile every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``.
3. Kernels vs their plain PyTorch versions at the serving shapes: B1
   ``paged_kv_gather`` bit-equal (bf16, f32); B2 ``paged_decode_attention``
   at atol/rtol 1e-5 (f32) and 2e-2 (bf16), with and without softcap, and
   unchanged when K/V past each length are poisoned.  Times by CUDA events
   (median of 50 after warm-up) beside each kernel's bound.
4. Serving qwen2-0.5b at full width (24 layers, bf16, random weights from a
   seed): batch 4, context 1024, 16 new tokens; one miss pass, then a hit
   through each fetch backend.  Fetched blocks must be bit-equal to the
   saved ones, hit tokens identical across backends, and the ``kernel``
   pass must launch B1 exactly 2 x batch times.
5. Exactness: the same widths at 2 layers in float32 (TF32 off): every hit
   backend's tokens must equal the miss path's.
6. One JSON line naming every ported kernel with its launches in phase 4.
7. Last line: ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
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
           "paged_decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu"}


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
def check_gather(dev) -> dict:
    from repro_torch.kernels.paged_kv_gather import ops
    from repro_torch.kernels.paged_kv_gather.ref import paged_kv_gather_ref
    cfg_layers, kv, hd = 24, 2, 64
    n, dkv = CTX // BT, cfg_layers * kv * hd           # 64 blocks of [16, 3072]
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
        log(f"[kernel] paged_kv_gather {str(dtype)[6:]} [{n},{BT},{dkv}] table {n} (repeats): "
            f"bit-equal; device ms: kernel={row['kernel_ms']} plain={row['plain_ms']} "
            f"library(index_select)={row['library_ms']}; bound={row['bound_ms'] * 1e3} us "
            f"({by}); kernel call incl. host={row['call_ms']} ms; max_abs_err={err}")
        result[dtype] = row
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


def check_decode_attention(dev) -> dict:
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    KV, G, hd = 2, 7, 64                               # the qwen2-0.5b group
    lengths_l = [1024, 1000, 1037, 960]
    mb = max(math.ceil(x / BT) for x in lengths_l) + 1
    n_pool = B * mb + 8
    g = torch.Generator(device=dev).manual_seed(2)
    tables = torch.randperm(n_pool, generator=g, device=dev)[:B * mb].reshape(B, mb)
    tables = tables.to(torch.int32).contiguous()
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    result = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((B, KV, G, hd), generator=g, device=dev).to(dtype)
        kp = torch.randn((n_pool, BT, KV, hd), generator=g, device=dev).to(dtype)
        vp = torch.randn((n_pool, BT, KV, hd), generator=g, device=dev).to(dtype)
        for softcap in (None, 30.0):
            out = ops.decode_attention(q, kp, vp, tables, lengths, softcap=softcap)
            ref = paged_decode_attention_ref(q, kp, vp, tables, lengths, softcap=softcap)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
            err = (out.float() - ref.float()).abs().max().item()
            log(f"[kernel] paged_decode_attention {str(dtype)[6:]} softcap={softcap}: "
                f"max_abs_err={err} (tol {tol})")
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
            bound_ms=bound, bound_by=by,
            max_abs_err=(clean.float() - ref.float()).abs().max().item())
        log(f"[kernel] paged_decode_attention {str(dtype)[6:]} B={B} KV={KV} G={G} hd={hd} "
            f"bt={BT} lengths={lengths_l}: poisoned tail unchanged; device ms: "
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


def phase_serving(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.paged_kv_gather import ops as gather_ops
    from repro_torch.serve.host_store import BACKENDS
    cfg = get_config(ARCH)
    eng = _engine(cfg, dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, CTX)).astype(np.int32)
    keys = [f"ctx-{i}" for i in range(B)]

    # Warm-up at the served shape on other contexts: cuBLAS handles, the
    # kernels' first load and the pinned host buffers' first allocation.
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
        raise AssertionError("expected one miss pass, then hits")
    for backend, d in delta.items():
        want = 2 * B if backend == "kernel" else 0
        if d != want:
            raise AssertionError(f"{backend} pass launched paged_kv_gather {d} times, want {want}")
    if launches["paged_kv_gather"] == 0:
        raise AssertionError("the main path never launched paged_kv_gather")
    for res in (miss, *hits.values()):
        if res.tokens.shape != (B, NEW) or res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab:
            raise AssertionError(f"bad tokens {res.tokens.shape}")
    for backend in BACKENDS:
        if not np.array_equal(hits[backend].tokens, hits["pcpy"].tokens):
            raise AssertionError(f"hit tokens of {backend} differ from pcpy's")

    for key in keys:                                   # fetched == saved, bit for bit
        kb, vb = eng.store.host_blocks(key)
        for backend in BACKENDS:
            res = eng.store.fetch(key, backend)
            if not (torch.equal(res.k_blocks.cpu(), kb) and torch.equal(res.v_blocks.cpu(), vb)):
                raise AssertionError(f"{backend} fetched blocks differ from the saved ones")
    probe = torch.as_tensor(prompts[:1, :64], device=dev)
    logits, _, _ = eng.model.forward(eng.params, {"tokens": probe})
    if logits.shape != (1, 64, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError("non-finite or misshapen logits")

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
    step_ms = {name: {"call_ms": call_ms(fn, reps=5, warmup=1), **profile_step(fn)}
               for name, fn in steps.items()}
    n_blocks, block_bytes = eng.store.blocks_for(keys[0])
    out = {"arch": ARCH, "dtype": cfg.compute_dtype, "batch": B, "ctx": CTX, "new": NEW,
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
    return launches


def phase_exactness(dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.serve.host_store import BACKENDS
    # float32 products in full precision, so hit and miss differ only in
    # summation order, as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, compute_dtype="float32")
    eng = _engine(cfg, dev, seed=1)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, CTX)).astype(np.int32)
    keys = [f"exact-{i}" for i in range(B)]
    miss = eng.generate(prompts, keys, NEW)
    for backend in BACKENDS:
        hit = eng.generate(prompts, keys, NEW, fetch_backend=backend)
        if not np.array_equal(hit.tokens, miss.tokens):
            raise AssertionError(f"float32 hit tokens via {backend} differ from the miss path's")
    log(f"[exact] {cfg.name} n_layers=2 float32 (TF32 off): hit tokens == miss tokens "
        f"for {list(BACKENDS)}")


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
    b1 = check_gather(dev)
    b2 = check_decode_attention(dev)
    launches = phase_serving(dev)
    phase_exactness(dev)
    kernels = []
    for name, row, replaces in (
            ("paged_kv_gather", b1, "src/repro/kernels/paged_kv_gather/paged_kv_gather.py:26"),
            ("paged_decode_attention", b2,
             "src/repro/kernels/decode_attention/decode_attention.py:79")):
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": replaces, "launches": launches[name],
                        "on_main_path": name == "paged_kv_gather",
                        "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    log(f"[done] {time.perf_counter() - t0:.1f}s on {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
