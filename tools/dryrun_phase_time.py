#!/usr/bin/env python3
"""Wall seconds of ``chip_smoke.py``'s dry-run phase (phase 18's
``phase_dryrun``, and ``check_query_chunks`` where the tree has it), each
tree's in a fresh process, in the order given: name a tree twice to time it
twice, as in parent, change, change, parent.

    python3 tools/dryrun_phase_time.py build/parent . . build/parent
    python3 tools/dryrun_phase_time.py . --device cpu

Each tree is a checkout of this repo (an unpacked ``git archive``); its own
``src`` is imported.  One JSON line per run: the tree, the torch version and
the seconds of each step; the ``[dryrun]`` lines of the phase go to
standard error.  Exits with the first failed run's code.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import json, sys, time, torch
sys.path[:0] = [{src!r}, {tree!r}]
import chip_smoke
chip_smoke.log = lambda msg: print(msg, file=sys.stderr, flush=True)
dev = torch.device({device!r})
out = {{"tree": {tree!r}, "torch": torch.__version__}}
t = time.perf_counter()
chip_smoke.phase_dryrun(dev)
out["phase_dryrun_s"] = time.perf_counter() - t
if hasattr(chip_smoke, "check_query_chunks"):
    t = time.perf_counter()
    chip_smoke.check_query_chunks(dev)
    out["check_query_chunks_s"] = time.perf_counter() - t
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for tree in args.trees:
        tree = os.path.abspath(tree)
        code = _RUN.format(src=os.path.join(tree, "src"), tree=tree, device=args.device)
        r = subprocess.run([sys.executable, "-c", code], cwd=tree)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
