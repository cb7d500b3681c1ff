"""Readings that set a cell's limits: the program's logit gaps and saved
contexts' errors on many seeds, and the control's (the reference in float8,
at the same positions of the same prompts and served tokens) on some of
them, all in one process.  Each seed is judged by the cell's committed limits
(``bench/limits``): ``correct`` is the program's, ``control.correct`` the
control's, which has to come out false.

    python3 bench/control.py --workload <name> --seconds <s> --seeds 1 2 3 ... \
        --control-seeds 1 2 3

Each seed is a whole run of the cell (set-up, a window of ``--seconds``, the
check); one JSON line a seed.  The benchmark's own runs never run the
control.  Needs the cell's CUDA cards, as ``run.py`` does.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds, control_seeds, seconds: float, device: str,
             limits: dict | None = None):
    """One dict a seed: the program's numbers beside the limits
    (``limits``, default the cell's committed ones) and, for the control
    seeds, the float8 reference's (``run.control``)."""
    from bench.harness import serve
    for seed in seeds:
        res = serve.run_cell(cell, seed, seconds, False, device=device,
                             control=seed in control_seeds, limits=limits)
        yield {"seed": seed, "correct": res["correct"], "checks": res["checks"],
               "control": res["run"].pop("control", None), "run": res["run"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "memory_peak_bytes": res["device"]["memory_peak_bytes"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench.harness import registry
    cell = registry.cell(args.workload)
    if (torch.cuda.device_count() if torch.cuda.is_available() else 0) < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    for row in readings(cell, args.seeds, set(args.control_seeds), args.seconds, "cuda:0"):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
