"""Cross-process flag round trip on one card, for the per-rank collectives.

    python3 tools/flag_probe.py [--procs 2 4 8] [--laps 50]

Needs a CUDA card and nvcc.  Builds ``tools/flag_probe.cu`` (against
``src/repro_torch/kernels/csrc/rank_sync.cuh``), then for each world size
spawns that many processes (``core.procgroup.spawn``), each with one flag
in its own memory (``csrc/rank_ipc.cu``), IPC-mapped by its left
neighbour.  A token goes round the ring ``--laps`` times: each rank polls
its flag with system-scope acquire loads and raises its right neighbour's
with a system-scope release add, as the per-rank kernels do.  Rank 0 times
each lap with the global timer.  For contrast, the same two-rank ring runs
in one process on two streams (one context, so the two kernels run at once).

Prints the card (name, power limit, compute mode) and one JSON line per
world size: lap ns (median, min, max), hop ns (lap / n), the polls of rank
0's waits, and ns per poll.  Writes ``build/flag_probe.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
LIMIT_NS = 20_000_000_000            # a wait of the probe gives up after 20 s
POLLS_TIMED = 1_000_000


def build_probe() -> str:
    from repro_torch.kernels import _build
    out_dir = os.path.join(REPO, "build", "flag_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libflag_probe_{os.getpid()}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib,
           os.path.join(REPO, "tools", "flag_probe.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"probe build failed:\n{done.stdout}{done.stderr}")
    return lib


def load(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    vp, i, ll, ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    lib.flag_probe_ring.argtypes = [vp, vp, i, i, ull, vp, vp, vp]
    lib.flag_probe_poll_rate.argtypes = [vp, ll, vp, vp]
    lib.flag_probe_ring.restype = lib.flag_probe_poll_rate.restype = i
    return lib


def _ok(err: int) -> None:
    if err:
        raise RuntimeError(f"probe launch failed: CUDA error {err}")


def probe_rank(ranks, lib_path: str, laps: int) -> dict:
    """One rank of the ring (runs in a spawned process)."""
    from repro_torch.kernels._rank_sync import ipc
    lib, io, dev = load(lib_path), ipc(), ranks.device.index
    n, my = ranks.n, ranks.rank
    own = io.alloc(256, dev)
    handles = ranks.all_gather_object(io.handle(own, dev))
    nxt = own if n == 1 else io.open(handles[(my + 1) % n], dev)
    lap_ns = torch.zeros(laps, dtype=torch.int64, device=ranks.device)
    polls = torch.zeros(laps, dtype=torch.int64, device=ranks.device)
    stream = torch.cuda.current_stream().cuda_stream
    ranks.barrier()
    _ok(lib.flag_probe_ring(own, nxt, int(my == 0), laps, LIMIT_NS, lap_ns.data_ptr(),
                            polls.data_ptr(), stream))
    torch.cuda.synchronize()
    out = {"lap_ns": lap_ns.tolist(), "polls": polls.tolist()}
    ranks.barrier()
    if my == 0:              # alone on the card now: the rate of local polls
        ns = torch.zeros(1, dtype=torch.int64, device=ranks.device)
        _ok(lib.flag_probe_poll_rate(own, POLLS_TIMED, ns.data_ptr(), stream))
        torch.cuda.synchronize()
        out["ns_per_poll"] = ns.item() / POLLS_TIMED
    ranks.barrier()
    if nxt != own:
        io.close(nxt, dev)
    ranks.barrier()
    io.free(own, dev)
    return out


def in_one_process(lib_path: str, laps: int) -> dict:
    """The two-rank ring in one process, a stream per rank."""
    lib = load(lib_path)
    flags = torch.zeros(2, 64, dtype=torch.int32, device="cuda")
    lap_ns = torch.zeros(2, laps, dtype=torch.int64, device="cuda")
    polls = torch.zeros(2, laps, dtype=torch.int64, device="cuda")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for r in (1, 0):         # the waiter first
        _ok(lib.flag_probe_ring(flags[r].data_ptr(), flags[1 - r].data_ptr(), int(r == 0), laps,
                                LIMIT_NS, lap_ns[r].data_ptr(), polls[r].data_ptr(),
                                streams[r].cuda_stream))
    torch.cuda.synchronize()
    return {"lap_ns": lap_ns[0].tolist(), "polls": polls[0].tolist()}


def summary(n: int, res: dict) -> dict:
    laps = res["lap_ns"]
    ok = [t for t in laps if t >= 0]
    return {"procs": n, "laps": len(laps), "lost": len(laps) - len(ok),
            "lap_ns_median": statistics.median(ok) if ok else None,
            "lap_ns_min": min(ok) if ok else None, "lap_ns_max": max(ok) if ok else None,
            "hop_ns_median": statistics.median(ok) / n if ok else None,
            "polls_median": statistics.median(res["polls"]), "polls_max": max(res["polls"]),
            "ns_per_poll": res.get("ns_per_poll"), "lap_ns": laps}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--laps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flag_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core.procgroup import spawn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    lib = build_probe()
    rows = [dict(summary(2, in_one_process(lib, args.laps)), where="one process, two streams")]
    print(json.dumps({k: v for k, v in rows[-1].items() if k != "lap_ns"}), flush=True)
    for n in args.procs:
        res = spawn(probe_rank, n, device="cuda", args=(lib, args.laps), timeout_s=600)
        rows.append(dict(summary(n, res[0]), where=f"{n} processes, one card",
                         polls_max_any_rank=max(max(r["polls"]) for r in res)))
        print(json.dumps({k: v for k, v in rows[-1].items() if k != "lap_ns"}), flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "flag_probe.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
