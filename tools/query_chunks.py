#!/usr/bin/env python3
"""The dry-run's trace with attention in query chunks against the same step
traced with attention unchunked (one [S, S] block), pair by pair: per-device
FLOPs, wire bytes, collective counts and temp peak of each, and their ratios.

    PYTHONPATH=src python3 tools/query_chunks.py --mesh 16x16 --layers 1 --device cpu
    PYTHONPATH=src python3 tools/query_chunks.py --pairs stablelm-12b:train_4k \\
        --mesh 1x16 --device cpu

The chunked trace is ``repro_torch.launch.dryrun.trace_step`` as
``trace_dryrun`` runs it; the unchunked one is the same under
``dense_attention_for_costing``.  Each pair is traced in a process of its
own (``--jobs`` at a time) over a fake process group of the mesh's size, on
fake tensors of ``--device``'s type (the card by default).  One JSON line
per pair; a documented skip prints its reason.  By default every
train_4k and prefill_32k pair.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import multiprocessing
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models.attention import dense_attention_for_costing  # noqa: E402
from repro_torch.roofline.costing import _scan_axes  # noqa: E402

SHAPES = ("train_4k", "prefill_32k")


def compare(arch_id: str, shape_id: str, mesh_shape: tuple, layers: int, device: str) -> dict:
    """One pair traced chunked and unchunked on a fake mesh of ``mesh_shape``
    (axes ``data``, ``model``), each stack of layers cut to ``layers`` units
    (zamba2's unit is a super-block of six layers)."""
    cfg = get_config(arch_id)
    for _, _, cut in _scan_axes(cfg):
        cfg = cut(cfg, layers)
    row = {"arch": arch_id, "shape": shape_id, "mesh": "x".join(map(str, mesh_shape)),
           "layers": layers}
    with fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, ("data", "model"), device=device)
        for name, attention in (("chunked", contextlib.nullcontext),
                                ("unchunked", dense_attention_for_costing)):
            t0 = time.perf_counter()
            with attention():
                tr = dryrun.trace_step(arch_id, shape_id, mesh, cfg=cfg, device=device)
            if tr.skip_reason:
                return dict(row, skipped=tr.skip_reason)
            row[name] = {"flops": tr.flops, "wire": sum(tr.wire.values()),
                         "counts": tr.collective_counts, "temp": tr.memory.temp_bytes,
                         "replicated_ops": tr.replicated_ops,
                         "seconds": time.perf_counter() - t0}
    c, u = row["chunked"], row["unchunked"]
    row["flops_ratio"] = c["flops"] / u["flops"]
    row["wire_ratio"] = c["wire"] / u["wire"] if u["wire"] else None
    return row


def _run(job):
    return compare(*job)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="*", help="arch:shape (default: every train_4k and "
                    "prefill_32k pair)")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--layers", type=int, default=1, help="units of each layer stack")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pairs = ([tuple(p.split(":")) for p in args.pairs] if args.pairs
             else [(a, s) for a in ARCH_IDS for s in SHAPES])
    mesh_shape = tuple(int(n) for n in args.mesh.split("x"))
    jobs = [(a, s, mesh_shape, args.layers, args.device) for a, s in pairs]
    with multiprocessing.get_context("spawn").Pool(args.jobs, maxtasksperchild=1) as pool:
        for row in pool.imap(_run, jobs):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
