"""Benchmark harness for the benchmarks that need the port: the registry
entries of ``benchmarks/run.py`` that import JAX there (``tables_dispatch``,
``tables_multinode``, ``tpu_collectives``, ``trace_export``).  The other
entries are framework-neutral and run from ``benchmarks/`` without JAX
(``python -m benchmarks.fig13_allgather``).

Prints a ``name,us_per_call,derived`` CSV row per benchmark (us_per_call is
the wall time of one ``run``; ``derived`` is the benchmark's headline
derived quantity; ``tpu_collectives`` also prints its time per call on the
device), then the claim-check report; exits 0 only if every claim holds.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from . import tables_dispatch, tables_multinode, tpu_collectives, trace_export

BENCHES = (("tables_dispatch", tables_dispatch.run),
           ("tables_multinode", tables_multinode.run),
           ("tpu_collectives", tpu_collectives.run),
           ("trace_export", trace_export.run))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    results = []
    for name, run in BENCHES:
        # the one benchmark that runs on the device: its per-call times are printed
        kw = ({"verbose": True, "device": args.device} if name == "tpu_collectives"
              else {"verbose": False})
        t0 = time.perf_counter()
        cc, _ = run(**kw)
        us = (time.perf_counter() - t0) * 1e6
        n_ok = sum(1 for r in cc.rows if r[5])
        derived = f"{n_ok}/{len(cc.rows)}_claims_ok"
        print(f"{name},{us:.1f},{derived}")
        results.append((name, cc))

    print("\n== claim checks ==")
    all_ok = True
    for name, cc in results:
        print(f"[{name}]")
        if not cc.report():
            all_ok = False
    print("\nALL BENCHMARK CLAIMS OK" if all_ok else "\nSOME CLAIMS OUT OF BAND")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
