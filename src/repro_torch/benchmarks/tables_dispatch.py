"""Tables 2 & 3: the paper's size-range dispatch vs the dispatch re-derived
from the calibrated timing model (MI300X) and re-derived for the TPU v5e
topology (what the latte CommBackend actually uses).

``tpu_devices`` parameterizes the TPU slice size (any count
``tpu_dispatch_tables`` accepts); the multi-node hierarchical sweeps
(tpu64/tpu256/mi300x-2node, DESIGN.md §11) live in
``repro_torch/benchmarks/tables_multinode.py``."""
from __future__ import annotations

import argparse

from repro_torch.core.backend import tpu_dispatch_tables
from repro_torch.core.dma import (PAPER_AA_DISPATCH, PAPER_AG_DISPATCH, derive_dispatch,
                            mi300x_platform, paper_dispatch)
from .common import ALL_SIZES, ClaimChecker, fmt_size


def run(verbose: bool = True, tpu_devices: int = 16):
    topo = mi300x_platform()
    cc = ClaimChecker("tables")
    for coll, paper_table in (("all_gather", PAPER_AG_DISPATCH),
                              ("all_to_all", PAPER_AA_DISPATCH)):
        derived = derive_dispatch(topo, coll, ALL_SIZES)
        if verbose:
            print(f"== {coll} ==")
            print("  paper table:")
            for lo, hi, v in paper_table:
                print(f"    [{fmt_size(lo)}, {fmt_size(hi) if hi else 'inf'}) -> {v}")
            print("  derived from model (MI300X):")
            for e in derived:
                print(f"    [{fmt_size(e.lo)}, {fmt_size(e.hi) if e.hi else 'inf'}) -> {e.variant}")
        # agreement on a probe grid (base variant; prelaunch composes with all)
        def strip(v: str) -> str:
            return v.replace("prelaunch_", "")

        agree = 0
        probes = ALL_SIZES
        for s in probes:
            model_v = next(e.variant for e in derived
                           if s >= e.lo and (e.hi is None or s < e.hi))
            if strip(model_v) == strip(paper_dispatch(coll, s)):
                agree += 1
        frac = agree / len(probes)
        cc.check(f"{coll}: derived dispatch agrees with paper table", frac, 1.0, 0.6, 1.0)
    ag, aa, rs, ar = tpu_dispatch_tables(tpu_devices)
    if verbose:
        print(f"== TPU v5e ({tpu_devices} devices) re-derived thresholds "
              "(used by CommBackend('latte')) ==")
        for name, t in (("all_gather", ag), ("all_to_all", aa),
                        ("reduce_scatter", rs), ("all_reduce", ar)):
            for e in t:
                print(f"  {name}: [{fmt_size(e.lo)}, {fmt_size(e.hi) if e.hi else 'inf'}) "
                      f"-> {e.variant}")
    # The v7 tables sweep the full single-node variant space, so the
    # latency-bound winners are optimized command streams (opt_ batching/
    # fused signals dominate where per-command overhead does) rather than
    # the baseline b2b of the baseline-only v6 sweep.
    cc.check("TPU tables open with an optimized stream at the smallest sizes",
             float(ag[0].variant.startswith("opt_")
                   and aa[0].variant.startswith("opt_")), 1, 1, 1)
    cc.check("TPU AG tables carry a pipelined winner at the top (DESIGN.md §9)",
             float("pipe_" in ag[-1].variant), 1, 1, 1)
    cc.check("TPU reduce tables carry a pipelined winner (DESIGN.md §10)",
             float(any("pipe_" in e.variant for e in rs)
                   and any("pipe_" in e.variant for e in ar)), 1, 1, 1)
    return cc, None


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tpu-devices", type=int, default=16,
                   help="TPU slice size for the re-derived tables "
                        "(default 16, the paper-scale pod)")
    args = p.parse_args()
    cc, _ = run(tpu_devices=args.tpu_devices)
    return 0 if cc.report() else 1


if __name__ == "__main__":
    raise SystemExit(main())
