#!/usr/bin/env python3
"""Split the time of the all-to-all kernel (B4) at its latency-bound sizes,
64 KiB and 1 MiB per rank over 8 ranks emulated on one NVIDIA card.

    python3 tools/b4_split.py [--src DIR] [--label NAME] [--times | --sweep]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (default:
this checkout's), so the same script splits an older tree unpacked beside it.

Device: the probe kernels of ``tools/b4_probe.cu`` (built with nvcc against
that tree's ``csrc/rank_sync.cuh``) with the kernel's grid: an empty
cooperative launch, the neighbour barrier alone, the copies without flags
(the round-serial schedule, plan 0, and the partner-first plan, plan 1), barrier
plus copies; then the kernel itself through ``ops.all_to_all``.  Each is the
median device time of 50 calls, each queued behind a sleep kernel
(``chip_smoke.device_ms``).  The kernel's time less barrier plus copies is
its per-round raises and drain.

Host: ``time.perf_counter_ns`` around each step of one ``ops.all_to_all``
call (the steps of that tree's wrapper, written out here), the mean over 300
calls queued behind a sleep kernel so the card stays busy and no step waits
for it; and the host cost of the launch's pieces alone (attribute queries,
``cudaSetDevice``, an empty kernel launched cooperatively and not).

Prints one JSON line per size and writes them all to
``build/b4_split_<label>.json``.  ``--times`` prints only the device
times of every B3/B4 variant at 64 KiB to 256 MiB per rank and at the
collectives path's shapes, and host µs per b2b call (run it on two trees in
turns, parent, change, change, parent, in one call on the card);
``--sweep`` prints B4's device times with 1 to 16 CTAs per rank forced.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import device_ms, host_us  # noqa: E402  (the smoke run's timers)

RANKS = 8
SIZES = {"64KiB": 64 << 10, "1MiB": 1 << 20}     # per rank: n chunks
CALLS = 300


def build_probe(csrc: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out_dir = os.path.join(REPO, "build", "b4_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libb4_probe_{os.getpid()}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib,
           os.path.join(REPO, "tools", "b4_probe.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"probe build failed:\n{done.stdout}{done.stderr}")
    probe = ctypes.CDLL(lib)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    probe.b4_probe.argtypes = [vp, vp, i, ll, i, i, i, vp, i, i, vp]
    probe.b4_probe_empty.argtypes = [i, i, i, vp]
    probe.b4_probe_attrs.argtypes = [i]
    probe.b4_probe_set_device.argtypes = [i]
    for f in (probe.b4_probe, probe.b4_probe_empty, probe.b4_probe_attrs,
              probe.b4_probe_set_device, probe.b4_probe_get_device, probe.b4_probe_error):
        f.restype = ctypes.c_int
    return probe


class Probe:
    """One probe configuration with its own zeroed flags and call epoch."""

    def __init__(self, lib, xs, out, parts, mode, plan, coop=1):
        self.lib, self.xs, self.out = lib, xs, out
        self.n = xs.shape[0]
        self.words = xs[0, 0].numel() * xs.element_size() // 16
        self.parts, self.mode, self.plan, self.coop = parts, mode, plan, coop
        self.flags = torch.zeros(self.n, dtype=torch.int32, device=xs.device)
        self.epoch = 0
        self.stream = torch.cuda.current_stream().cuda_stream

    def __call__(self):
        self.epoch += 1
        err = self.lib.b4_probe(self.xs.data_ptr(), self.out.data_ptr(), self.n, self.words,
                                self.parts, self.mode, self.plan, self.flags.data_ptr(),
                                self.epoch, self.coop, self.stream)
        if err:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")


def host_steps(aa, rs, xs) -> dict:
    """Mean host µs of each step of ``aa.all_to_all(xs, "b2b")`` as the
    measured tree's wrapper runs it, over CALLS calls behind a sleep kernel."""
    n = xs.shape[0]
    steps: dict[str, int] = {}

    def tick(name, t):
        now = time.perf_counter_ns()
        steps[name] = steps.get(name, 0) + now - t
        return now

    def table_call():           # a wrapper that passes two tables of rank pointers
        t = time.perf_counter_ns()
        if "b2b" not in aa.VARIANTS or xs.dim() != 4 or xs.shape[0] != xs.shape[1] \
                or xs.dtype not in aa.DTYPES or not 1 <= n <= rs.MAX_RANKS \
                or xs.device.type != "cuda" or not xs.is_contiguous():
            raise ValueError("bad operand")
        t = tick("checks", t)
        lib = aa._lib()
        rs.check_error(lib, aa.NAME, aa._flags())
        t = tick("error word (ctypes call)", t)
        out = torch.empty_like(xs)
        out.numel()
        t = tick("torch.empty_like", t)
        chunk_bytes = xs[0, 0].numel() * xs.element_size()
        t = tick("chunk bytes (xs[0, 0] view)", t)
        dev = xs.device.index if xs.device.index is not None else torch.cuda.current_device()
        chosen = lib.ring_all_to_all_parts(n, chunk_bytes, 0, dev)
        t = tick("parts (ctypes, 2 attribute queries)", t)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        t = tick("current stream", t)
        key, buf, epoch = aa._flags().take(torch.device("cuda", dev), stream, n, chosen, 0)
        t = tick("torch.device + flag buffer", t)
        pin, pout = rs.rank_pointers(xs), rs.rank_pointers(out)
        t = tick("two pointer tables", t)
        err = lib.ring_all_to_all(pin, pout, n, chunk_bytes, chosen, aa.VARIANTS["b2b"],
                                  buf.data_ptr(), epoch, dev, stream)
        t = tick("C entry (set device, parts, launch)", t)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        aa._flags().give_back(key, buf, epoch)
        aa.launches += 1
        tick("give back, count", t)
        return out

    def plan_call():            # a wrapper with a cached plan and base pointers
        t = time.perf_counter_ns()
        if "b2b" not in aa.VARIANTS or xs.dim() != 4 or xs.shape[0] != xs.shape[1] \
                or xs.dtype not in aa.DTYPES or not 1 <= n <= rs.MAX_RANKS \
                or xs.device.type != "cuda" or not xs.is_contiguous():
            raise ValueError("bad operand")
        t = tick("checks", t)
        kernel = aa._kernel()
        kernel.check_error()
        t = tick("error word (pinned int)", t)
        out = torch.empty_like(xs)
        out.numel()
        t = tick("torch.empty_like", t)
        chunk_bytes = xs.numel() // (n * n) * xs.element_size()
        plan = rs.a2a_plan(n, chunk_bytes, rs.sm_count(xs.device.index), 0)
        t = tick("chunk bytes + cached plan", t)
        dev = xs.device.index
        stream = torch._C._cuda_getCurrentRawStream(dev)
        t = tick("current stream (raw handle)", t)
        b2b = aa.VARIANTS["b2b"]
        key, buf, epoch = kernel.flags.take(dev, stream, n, plan.parts, b2b)
        t = tick("flag buffer", t)
        err = kernel._fn(xs.data_ptr(), out.data_ptr(), n, chunk_bytes, plan.parts, b2b,
                         buf.data_ptr(), epoch, dev, stream)
        t = tick("C entry (get device, launch)", t)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        kernel.flags.give_back(key, buf, epoch)
        aa.launches += 1
        tick("give back, count", t)
        return out

    call = table_call if hasattr(rs, "rank_pointers") else plan_call
    want = xs.transpose(0, 1).contiguous()
    call()
    torch.cuda.synchronize()
    steps.clear()
    torch.cuda._sleep(400_000_000)
    # no output is kept: holding them would make the allocator map new
    # memory, which a real caller's steady state does not
    for _ in range(CALLS):
        call()
    torch.cuda.synchronize()
    split = {k: v / CALLS / 1e3 for k, v in steps.items()}
    out = call()
    aa.check()
    if not torch.equal(out, want):
        raise AssertionError("split call differs from transpose(0, 1)")
    return split


def times(label: str) -> int:
    """Device ms of every B3 and B4 variant at 64 KiB to 256 MiB per rank
    (bf16, 8 ranks), at the collectives path's shapes (B3 bcst_b2b f32 8 x
    [512, 1024]; B4 b2b bf16 [8, 8, 640, 2048] and [8, 8, 32, 2048]), and
    host µs per b2b call at 64 KiB: one JSON line, for comparing two trees
    in one call (parent, change, change, parent)."""
    from repro_torch.kernels.ring_all_gather import ops as ag
    from repro_torch.kernels.ring_all_to_all import ops as aa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    n, row = RANKS, {"label": label}
    sizes = {"64KiB": 64 << 10, "1MiB": 1 << 20, "16MiB": 16 << 20, "256MiB": 256 << 20}
    for size, gathered in sizes.items():
        rows = gathered // n // 2048
        xs = torch.randn((n, rows, 1024), generator=g, device=dev).to(torch.bfloat16)
        xa = torch.randn((n, n, rows, 1024), generator=g, device=dev).to(torch.bfloat16)
        for v in ag.VARIANTS:
            row[f"ag {v} {size}"] = device_ms(lambda v=v: ag.ring_all_gather(xs, v), reps=20)
        for v in aa.VARIANTS:
            row[f"aa {v} {size}"] = device_ms(lambda v=v: aa.all_to_all(xa, v), reps=20)
        if size == "64KiB":
            row["ag b2b host_us 64KiB"] = host_us(lambda: ag.ring_all_gather(xs, "b2b"))
            row["aa b2b host_us 64KiB"] = host_us(lambda: aa.all_to_all(xa, "b2b"))
        del xs, xa
        torch.cuda.empty_cache()
    xs = torch.randn((n, 512, 1024), generator=g, device=dev)
    row["ag bcst_b2b path f32 [8,512,1024]"] = device_ms(
        lambda: ag.ring_all_gather(xs, "bcst_b2b"))
    for shape in ((n, n, 640, 2048), (n, n, 32, 2048)):
        xa = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        row[f"aa b2b path {list(shape)}"] = device_ms(lambda: aa.all_to_all(xa, "b2b"))
    ag.check()
    aa.check()
    print(json.dumps(row), flush=True)
    return 0


def sweep(label: str) -> int:
    """Device ms of each B4 variant at 64 KiB and 1 MiB per rank (bf16, 8
    ranks) with 1, 2, 4, 8 and 16 CTAs per rank forced: one JSON line."""
    from repro_torch.kernels.ring_all_to_all import ops as aa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    row = {"label": label}
    for size, per_rank in SIZES.items():
        xa = torch.randn((RANKS, RANKS, per_rank // RANKS // 2048, 1024), generator=g,
                         device=dev).to(torch.bfloat16)
        for v in aa.VARIANTS:
            for parts in (1, 2, 4, 8, 16):
                row[f"{v} {size} parts={parts}"] = device_ms(
                    lambda v=v, p=parts: aa.all_to_all(xa, v, parts=p))
    aa.check()
    print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--times", action="store_true",
                    help="only the B3/B4 device and host times at every size")
    ap.add_argument("--sweep", action="store_true",
                    help="only B4's device times over forced CTAs per rank")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b4_split: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    if args.times:
        return times(args.label)
    if args.sweep:
        return sweep(args.label)
    from repro_torch.kernels import _rank_sync as rs
    from repro_torch.kernels.ring_all_to_all import ops as aa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    csrc = os.path.join(os.path.abspath(args.src), "repro_torch", "kernels", "csrc")
    probe = build_probe(csrc)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    n = RANKS
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, per_rank in SIZES.items():
        chunk = per_rank // n
        xs = torch.randn((n, n, chunk // 2048, 1024), generator=g, device=dev).to(torch.bfloat16)
        out = torch.empty_like(xs)
        want = xs.transpose(0, 1).contiguous()
        old_parts = max(1, min(sms // n, -(-chunk // (32 << 10))))   # a CTA per 32 KiB
        new_parts = sms // n
        row = {"size": label, "per_rank_bytes": per_rank, "n": n, "card": card,
               "plan0_parts": old_parts, "plan1_parts": new_parts}
        dev_ms = {}
        for name, parts, mode, plan, coop in (
                ("empty coop, plan0 grid", old_parts, 0, 0, 1),
                ("barrier", old_parts, 1, 0, 1),
                ("copies, plan0", old_parts, 2, 0, 1),
                ("barrier + copies, plan0", old_parts, 3, 0, 1),
                ("empty coop, plan1 grid", new_parts, 0, 1, 1),
                ("empty <<<>>>, plan1 grid", new_parts, 0, 1, 0),
                ("copies, plan1", new_parts, 2, 1, 1),
                ("copies <<<>>>, plan1", new_parts, 2, 1, 0)):
            p = Probe(probe, xs, out, parts, mode, plan, coop)
            dev_ms[name] = device_ms(p)
            torch.cuda.synchronize()
            if probe.b4_probe_error():
                raise RuntimeError(f"probe {name}: a wait ran out of polls")
            if mode & 2 and not torch.equal(out, want):
                raise AssertionError(f"probe {name} differs from transpose(0, 1)")
            out.zero_()
        for v in aa.VARIANTS:
            dev_ms[f"kernel {v}"] = device_ms(lambda v=v: aa.all_to_all(xs, v))
            if not torch.equal(aa.all_to_all(xs, v), want):
                raise AssertionError(f"all_to_all {v} differs")
        aa.check()
        dev_ms["transpose(0, 1).contiguous()"] = device_ms(
            lambda: xs.transpose(0, 1).contiguous())
        row["device_ms"] = dev_ms
        row["host_us_per_call"] = {v: host_us(lambda v=v: aa.all_to_all(xs, v))
                                   for v in aa.VARIANTS}
        row["host_us_transpose"] = host_us(lambda: xs.transpose(0, 1).contiguous())
        row["host_us_steps_b2b"] = host_steps(aa, rs, xs)
        rows.append(row)
        print(json.dumps(row), flush=True)
    pieces = {"attribute queries x2": host_us(lambda: probe.b4_probe_attrs(0), calls=1000),
              "cudaSetDevice": host_us(lambda: probe.b4_probe_set_device(0), calls=1000),
              "cudaGetDevice": host_us(lambda: probe.b4_probe_get_device(), calls=1000),
              "empty launch <<<>>>": host_us(lambda: probe.b4_probe_empty(1, 1, 0, stream)),
              "empty launch cooperative": host_us(
                  lambda: probe.b4_probe_empty(1, 1, 1, stream)),
              "torch.empty_like 1 MiB": host_us(lambda: torch.empty_like(xs)),
              "torch.cuda.current_stream(dev)": host_us(
                  lambda: torch.cuda.current_stream(dev).cuda_stream, calls=1000),
              "torch._C._cuda_getCurrentRawStream": host_us(
                  lambda: torch._C._cuda_getCurrentRawStream(0), calls=1000)}
    empty_ms = {f"{ctas}x{threads} {'coop' if coop else '<<<>>>'}": device_ms(
        lambda c=ctas, t=threads, k=coop: probe.b4_probe_empty(c, t, k, stream))
        for ctas, threads, coop in ((1, 1, 0), (1, 1, 1), (8, 512, 1), (128, 128, 1),
                                    (128, 512, 0), (128, 512, 1))}
    print(json.dumps({"host_us_pieces": pieces, "empty_kernel_device_ms": empty_ms,
                      "card": card}), flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", f"b4_split_{args.label}.json"), "w") as f:
        json.dump({"card": card, "rows": rows, "host_us_pieces": pieces,
                   "empty_kernel_device_ms": empty_ms}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
