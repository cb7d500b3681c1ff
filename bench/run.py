"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cell's CUDA cards.
The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``bench/configs``) and a traffic mix (``bench/traffic``); ``--trace 0``
prints its end-to-end metrics, ``--trace 1`` its per-layer ones
(``bench/metrics``).  The last line of standard output is the result as one
JSON object; the numbers compared with their limits are the last lines of
standard error.  Without the cards the cell asks for, the run fails and
prints no result; so it does when a module of JAX or of the JAX package
(``repro``) is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
CACHE = ROOT / "build" / "bench-cache"


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def _card_facts() -> str:
    query = "name,power.limit,pcie.link.gen.max,pcie.link.gen.current,pcie.link.width.current"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi failed: {exc}"
    try:
        mem = next(line for line in Path("/proc/meminfo").read_text().splitlines()
                   if line.startswith("MemTotal"))
    except (OSError, StopIteration):
        mem = "MemTotal unknown"
    return f"{query}: {out}; host {mem}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed place in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench.harness import registry, serve

    cell = registry.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    serve.log(f"imports {time.perf_counter() - T0:.3f} s")
    result = serve.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                            t0=T0)
    # after the window, so that its time stays out of set-up
    serve.log(f"{_card_facts()}; torch {torch.__version__}, {torch.get_num_threads()} threads")
    bad = loaded_forbidden()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
