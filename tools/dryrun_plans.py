#!/usr/bin/env python3
"""The dry-run's plan, op by op, on this torch: what to hold two torch
versions' traces of one pair against each other with.

    # one JSON line per aten op of each pair's trace, into a directory
    PYTHONPATH=src python3 tools/dryrun_plans.py --dump build/plans --device cpu
    # the ops whose placements, FLOPs or collectives differ between two dumps
    PYTHONPATH=src python3 tools/dryrun_plans.py --diff build/plans_a build/plans_b
    # the figures tests/test_torch_dryrun_plans.py and chip_smoke.py hold a
    # trace to (run on the CPU, on the torch the plan was checked on)
    PYTHONPATH=src python3 tools/dryrun_plans.py --write --device cpu

``--dump`` traces each pair of ``PAIRS`` (or ``--pairs``) as
``repro_torch.launch.dryrun.trace_step`` traces it (attention in query
chunks), in a process of its own (``--jobs`` at a time) over a fake process
group of the mesh's size, on fake tensors of ``--device``'s type (the card
by default), and writes ``<arch>_<shape>_<mesh>_<layers>.jsonl``: a header
line (torch version, the trace's per-device FLOPs, wire bytes, temp and
collective counts), then one line per aten op that reached the dry-run's
modes from the step: the op, its inputs' and outputs' placements and local
shapes, the local FLOPs and the collectives (kind, input and output bytes
per device) it issued, and the innermost line of the port that called it
("backward" for an op of the autograd engine).

``--diff A B`` sums each dump by (op, input layout, output layout) and
lists the keys whose count, FLOPs or collectives differ, largest first,
and the first op at which the two plans part; given two files that
``--write`` wrote, it lists each trace's figures side by side.

``--write`` records, in ``tools/dryrun_plans.json`` (or ``--out``), the per-device
FLOPs, wire bytes and temp of the traces that the test and ``chip_smoke.py``
phase 18 hold a trace to: the pairs of ``PAIRS`` at the layers given there,
the query-chunk pairs of phase 18 chunked and unchunked at 1 layer on
16x16, and the five pairs of phase 18's dry-run at full depth
(``run_one``).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import glob
import json
import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
import os
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models.attention import dense_attention_for_costing  # noqa: E402

JSON_PATH = os.path.join(ROOT, "tools", "dryrun_plans.json")
MESHES = {"1x16": ((1, 16), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (arch, shape, mesh, layers): the 8-KV-head archs at 1 layer, qwen2-0.5b's
# decode at 2 layers, olmoe-1b-7b's experts at 1 layer on two pods
PAIRS = (("stablelm-12b", "train_4k", "16x16", 1), ("mixtral-8x7b", "train_4k", "16x16", 1),
         ("qwen2-vl-72b", "train_4k", "16x16", 1), ("qwen2-0.5b", "decode_32k", "16x16", 2),
         ("olmoe-1b-7b", "train_4k", "2x16x16", 1))
# chip_smoke.py phase 18's query-chunk pairs (1 layer, 16x16, chunked and
# unchunked) and its dry-run pairs (full depth; True: two pods)
QUERY_CHUNK_PAIRS = tuple((a, s) for a in ("stablelm-12b", "mixtral-8x7b", "qwen2-vl-72b")
                          for s in ("train_4k", "prefill_32k"))
DRYRUN_PAIRS = (("qwen2-0.5b", "train_4k", True), ("qwen2-0.5b", "prefill_32k", False),
                ("qwen2-0.5b", "decode_32k", False), ("qwen2-0.5b", "long_500k", False),
                ("olmoe-1b-7b", "train_4k", True))


def _placement(p) -> str:
    if type(p).__name__ == "_StridedShard":
        return f"_S{p.dim}/{p.split_factor}"
    if isinstance(p, Shard):
        return f"S{p.dim}"
    if isinstance(p, Partial):
        return f"P{p.reduce_op}"
    return "R" if isinstance(p, Replicate) else str(p)


def _layout(x) -> list:
    """[placements, local shape, dtype] of each tensor in ``x``."""
    out = []
    for t in tree_leaves(x):
        if isinstance(t, DTensor):
            out.append(["/".join(map(_placement, t.placements)),
                        list(t._local_tensor.shape), str(t.dtype)[6:]])
        elif isinstance(t, torch.Tensor):
            out.append(["local", list(t.shape), str(t.dtype)[6:]])
    return out


def _caller() -> str:
    """The innermost line of the port below this op (outside the dry-run's
    own modules), or "backward" where the autograd engine called it."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and "launch/dryrun" not in name \
                and "roofline" not in name:
            return f"{name.split('repro_torch/')[-1]}:{f.f_lineno}"
        f = f.f_back
    return "backward"


class PlanRecorder(TorchDispatchMode):
    """Entered above the dry-run's modes: one row per op that reaches them
    from the step, with what the modes below counted for it."""

    def __init__(self, rec, cost):
        super().__init__()
        self.rec, self.cost, self.rows = rec, cost, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n_ops, flops = len(self.rec.ops), self.cost.flops
        out = func(*args, **kwargs)
        self.rows.append({
            "op": str(func), "in": _layout([args, kwargs]), "out": _layout(out),
            "flops": self.cost.flops - flops,
            "coll": [[op.kind, op.in_bytes, op.out_bytes] for op in self.rec.ops[n_ops:]],
            "where": _caller()})
        return out


@contextlib.contextmanager
def recording():
    """For the duration, ``dryrun.trace_step`` traces under a
    ``PlanRecorder``; yields the list the recorders are appended to."""
    recorders, original = [], dryrun.tracing

    @contextlib.contextmanager
    def tracing(*args, **kwargs):
        with original(*args, **kwargs) as (rec, cost, reshard):
            plan = PlanRecorder(rec, cost)
            recorders.append(plan)
            with plan:
                yield rec, cost, reshard

    with mock.patch.object(dryrun, "tracing", tracing):
        yield recorders


def cut(arch: str, layers: int | None):
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def figures(tr) -> dict:
    """A trace's per-device FLOPs, wire bytes, temp and collective counts."""
    return {"flops": tr.flops, "wire": sum(tr.wire.values()), "temp": tr.memory.temp_bytes,
            "counts": tr.collective_counts, "replicated_ops": tr.replicated_ops}


def trace(arch: str, shape: str, mesh_name: str, layers: int | None, device: str, *,
          unchunked: bool = False, plan: bool = False) -> tuple[dict, list]:
    """One pair traced as the dry-run traces it (``unchunked``: attention
    as one block): its figures and, with ``plan``, its rows."""
    dims, names = MESHES[mesh_name]
    t0 = time.perf_counter()
    with fake_world(math.prod(dims)):
        mesh = make_mesh(dims, names, device=device)
        with (recording() if plan else contextlib.nullcontext([])) as recorders, \
                (dense_attention_for_costing() if unchunked else contextlib.nullcontext()):
            tr = dryrun.trace_step(arch, shape, mesh, cfg=cut(arch, layers), device=device)
    if tr.skip_reason:
        raise RuntimeError(f"{arch} {shape}: skipped: {tr.skip_reason}")
    head = dict(figures(tr), arch=arch, shape=shape, mesh=mesh_name, layers=layers,
                attention="unchunked" if unchunked else "chunked", torch=torch.__version__,
                seconds=time.perf_counter() - t0)
    return head, [row for r in recorders for row in r.rows]


def dump_name(arch, shape, mesh_name, layers) -> str:
    return f"{arch}_{shape}_{mesh_name}_{layers}.jsonl"


def _dump(job) -> dict:
    (arch, shape, mesh_name, layers), out_dir, device = job
    head, rows = trace(arch, shape, mesh_name, layers, device, plan=True)
    with open(os.path.join(out_dir, dump_name(arch, shape, mesh_name, layers)), "w") as f:
        for line in [head] + rows:
            f.write(json.dumps(line) + "\n")
    return dict(head, n_rows=len(rows), plan_flops=sum(r["flops"] for r in rows))


# ops that make a tensor of a given value: what one torch's autograd makes
# with them on a DTensor, another's makes as a local tensor
_FACTORIES = {"new_zeros", "new_empty", "new_ones", "new_full", "zeros_like", "empty_like",
              "ones_like", "full_like"}


def _as_planned(row: dict) -> dict:
    """``row`` with each local tensor of an op on DTensors taken as the
    replicated tensor DTensor takes it for."""
    laid = [lay[0] for lay in row["in"] + row["out"] if lay[0] != "local"]
    if not laid:
        return row
    replicated = "/".join("R" for _ in laid[0].split("/"))
    return dict(row, **{k: [[replicated] + lay[1:] if lay[0] == "local" else lay
                             for lay in row[k]] for k in ("in", "out")})


def read_dump(path: str) -> tuple[dict, list]:
    """A dump's header and its rows of the plan: the ops on a DTensor, and
    those with FLOPs or collectives, a local tensor among DTensors taken
    as replicated.  Left out: the free local ops (a slice) that one torch's
    redistribution makes and another's does not, and factories of no cost
    (top-k's backward makes its zeros by ``new_zeros`` on a DTensor on
    torch 2.13, as a local tensor on 2.11)."""
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return lines[0], [_as_planned(r) for r in lines[1:] if (r["flops"] or r["coll"] or any(
        layout[0] != "local" for layout in r["in"] + r["out"])) and not (
            r["op"].split(".")[1] in _FACTORIES and not r["flops"] and not r["coll"])]


def _summed(rows) -> dict:
    """{(op, inputs, outputs): [count, FLOPs, Counter of collectives, wheres]}."""
    acc = {}
    for r in rows:
        key = (r["op"], json.dumps(r["in"]), json.dumps(r["out"]))
        a = acc.setdefault(key, [0, 0.0, collections.Counter(), collections.Counter()])
        a[0] += 1
        a[1] += r["flops"]
        a[2].update(tuple(c) for c in r["coll"])
        a[3][r["where"]] += 1
    return acc


def _wire(colls: collections.Counter) -> float:
    from repro_torch.roofline.wire import CollectiveOp
    return sum(n * CollectiveOp(k, o, i).wire_bytes for (k, i, o), n in colls.items())


def diff(rows_a, rows_b) -> list[dict]:
    """The (op, layout) keys whose count, FLOPs or collectives differ
    between two plans, the largest FLOPs or wire difference first."""
    a, b = _summed(rows_a), _summed(rows_b)
    empty = [0, 0.0, collections.Counter(), collections.Counter()]
    out = []
    for key in set(a) | set(b):
        x, y = a.get(key, empty), b.get(key, empty)
        if x[0] == y[0] and x[1] == y[1] and x[2] == y[2]:
            continue
        out.append({"op": key[0], "in": json.loads(key[1]), "out": json.loads(key[2]),
                    "count": [x[0], y[0]], "flops": [x[1], y[1]],
                    "wire": [_wire(x[2]), _wire(y[2])],
                    "coll": [sorted(map(list, x[2].elements())), sorted(map(list, y[2].elements()))],
                    "where": sorted(set(x[3]) | set(y[3]))})
    out.sort(key=lambda d: -(abs(d["flops"][0] - d["flops"][1]) / 1e9
                             + abs(d["wire"][0] - d["wire"][1]) / 1e6 + 1e-3 * max(d["count"])))
    return out


def first_divergence(rows_a, rows_b) -> int | None:
    """The index of the first op at which two plans part (op, layouts,
    FLOPs or collectives), or None where they are the same."""
    fields = ("op", "in", "out", "flops", "coll")
    for i, (x, y) in enumerate(zip(rows_a, rows_b)):
        if any(x[f] != y[f] for f in fields):
            return i
    return None if len(rows_a) == len(rows_b) else min(len(rows_a), len(rows_b))


def _diff_figures(path_a: str, path_b: str) -> int:
    """Each recorded trace's FLOPs, wire bytes and temp in two files that
    ``--write`` wrote, side by side with their ratio (B / A); the number of
    traces whose figures differ by more than 1%."""
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    print(f"torch {a['torch']} ({a['device']}) / {b['torch']} ({b['device']})")
    n_off = 0
    for group in ("traces", "dryrun"):
        for name in sorted(set(a[group]) | set(b[group])):
            x, y = a[group].get(name), b[group].get(name)
            if x is None or y is None:
                print(f"{name}: only in {'B' if x is None else 'A'}")
                n_off += 1
                continue
            ratios = {k: y[k] / x[k] if x[k] else float(y[k] == 0) for k in ("flops", "wire", "temp")}
            off = any(abs(r - 1) > 0.01 for r in ratios.values())
            n_off += off
            print(f"{name}: " + ", ".join(f"{k} {x[k]:.6g} / {y[k]:.6g} ({ratios[k]:.6f})"
                                          for k in ratios) + (" OFF" if off else ""))
    return n_off


def _diff_dirs(dir_a: str, dir_b: str, top: int) -> int:
    n_diff = 0
    for path in sorted(glob.glob(os.path.join(dir_a, "*.jsonl"))):
        other = os.path.join(dir_b, os.path.basename(path))
        if not os.path.exists(other):
            print(f"== {os.path.basename(path)}: not in {dir_b}")
            continue
        (ha, ra), (hb, rb) = read_dump(path), read_dump(other)
        d = diff(ra, rb)
        n_diff += bool(d)
        print(f"== {os.path.basename(path)}: torch {ha['torch']} / {hb['torch']}; "
              f"FLOPs {ha['flops']:.5e} / {hb['flops']:.5e}; wire {ha['wire']:.5e} / "
              f"{hb['wire']:.5e}; temp {ha['temp']} / {hb['temp']}; ops {len(ra)} / {len(rb)}; "
              f"{len(d)} (op, layout) keys differ")
        for row in d[:top]:
            print("  " + json.dumps(row))
        i = first_divergence(ra, rb)
        if i is not None:
            print(f"  first op that differs: #{i}")
            for rows in (ra, rb):
                print("    " + json.dumps(rows[i] if i < len(rows) else None))
    return n_diff


def write(device: str, jobs: int) -> dict:
    """The figures of every recorded trace, by ``key``."""
    traces = [(a, s, m, n, False) for a, s, m, n in PAIRS] + [
        (a, s, "16x16", 1, u) for a, s in QUERY_CHUNK_PAIRS for u in (False, True)]
    traces = list(dict.fromkeys(traces))
    with _pool(jobs) as pool:
        heads = list(pool.map(_figures_job, [(t, device) for t in traces]))
        runs = list(pool.map(_run_one_job, [(p, device) for p in DRYRUN_PAIRS]))
    out = {"torch": torch.__version__, "device": device, "traces": {}, "dryrun": {}}
    for h in heads:
        out["traces"][key(h["arch"], h["shape"], h["mesh"], h["layers"], h["attention"])] = {
            k: h[k] for k in ("flops", "wire", "temp", "counts")}
    for r in (r for r in runs if r["status"] == "ok"):    # long_500k: a documented skip
        out["dryrun"][key(r["arch"], r["shape"], r["mesh"], None, "chunked")] = {
            "flops": r["flops"], "wire": sum(r["wire_bytes_per_device"].values()),
            "temp": r["peak_bytes_per_device"], "counts": r["collective_counts"]}
    return out


def _pool(jobs: int) -> ProcessPoolExecutor:
    """Fresh processes, one a trace (a process holds one fake process group
    at a time); a process that dies raises here rather than hanging."""
    return ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn"),
                               max_tasks_per_child=1)


def key(arch, shape, mesh_name, layers, attention) -> str:
    """The name of a recorded trace in ``dryrun_plans.json``."""
    return f"{arch} {shape} {mesh_name} {'all' if layers is None else layers} {attention}"


def _figures_job(job) -> dict:
    (arch, shape, mesh_name, layers, unchunked), device = job
    head, _ = trace(arch, shape, mesh_name, layers, device, unchunked=unchunked)
    print(json.dumps(head), flush=True)
    return head


def _run_one_job(job) -> dict:
    (arch, shape, multi_pod), device = job
    res = dryrun.run_one(arch, shape, multi_pod=multi_pod, device=device, verbose=False)
    if res.status == "failed":
        raise RuntimeError(f"{arch} {shape}: {res.reason}")
    print(json.dumps({"arch": arch, "shape": shape, "mesh": res.mesh,
                      "seconds": res.compile_seconds}), flush=True)
    return res.to_json()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--dump", metavar="DIR", help="write each pair's plan into DIR")
    mode.add_argument("--diff", nargs=2, metavar=("A", "B"),
                      help="two dump directories, or two files --write wrote")
    mode.add_argument("--write", action="store_true", help="record the figures (--out)")
    ap.add_argument("--out", default=JSON_PATH, help="the file --write writes")
    ap.add_argument("--pairs", nargs="*", help="arch:shape:mesh:layers (default: PAIRS)")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--top", type=int, default=20, help="keys listed per pair (--diff)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.diff:
        if all(os.path.isfile(p) for p in args.diff):
            return 1 if _diff_figures(*args.diff) else 0
        return 1 if _diff_dirs(*args.diff, args.top) else 0
    if args.write:
        out = write(args.device, args.jobs)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
        return 0
    pairs = ([(a, s, m, int(n)) for a, s, m, n in (p.split(":") for p in args.pairs)]
             if args.pairs else PAIRS)
    os.makedirs(args.dump, exist_ok=True)
    with _pool(args.jobs) as pool:
        for head in pool.map(_dump, [(p, args.dump, args.device) for p in pairs]):
            print(json.dumps(head), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
