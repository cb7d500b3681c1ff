"""Roofline baseline table: per (arch x shape) on the single-pod mesh,
derive the three roofline terms (at H100 rates) from the port's
depth-differenced costing.  Counterpart of ``benchmarks/roofline_table.py``:
the mesh is a fake 16x16 process group (``launch.mesh.fake_world``) and the
steps are traced on fake tensors of ``--device``'s type, so nothing runs on
a device and no time in the table is measured.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table [--arch A --shape S] \\
        [--out f.json] [--baseline] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.compat import resolve_device
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro_torch.launch.input_specs import skip_reason
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.roofline.analysis import format_table, make_row
from repro_torch.roofline.costing import total_cost
from repro_torch.sharding.rules import PerfOptions

CHIPS = 256


def run(pairs, out=None, baseline=False, device="cuda"):
    perf = PerfOptions.baseline() if baseline else PerfOptions()
    dev = resolve_device(device)
    rows, failures = [], []
    with fake_world(CHIPS):
        mesh = make_production_mesh(multi_pod=False, device=dev)
        for arch_id, shape_id in pairs:
            if skip_reason(get_config(arch_id), get_shape(shape_id)):
                continue
            try:
                res = total_cost(arch_id, shape_id, mesh, dp_size=16, perf=perf, device=dev)
                row = make_row(arch_id, shape_id, "16x16", CHIPS, res["total"])
                rows.append(row)
                print(f"[ok] {arch_id} x {shape_id}: comp={row.compute_s*1e3:.3f}ms "
                      f"mem={row.memory_s*1e3:.3f}ms coll={row.collective_s*1e3:.3f}ms "
                      f"dom={row.dominant} useful={row.useful_ratio:.2f}")
            except Exception as e:   # a failed pair is a result, as in the reference
                traceback.print_exc()
                failures.append((arch_id, shape_id, str(e)))
    print()
    print(format_table(rows))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump([r.to_json() for r in rows], f, indent=1)
        print(f"wrote {out}")
    return rows, failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline", action="store_true",
                    help="use pre-hillclimb PerfOptions")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    _, failures = run(pairs, args.out, baseline=args.baseline, device=args.device)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
