"""Multi-node hierarchical dispatch tables (DESIGN.md §11): the v6 bundled
sweeps for the 64/256-device TPU multislices and the 2-node MI300X RDMA
cluster — ``(ag, rs, ar)`` per topology, hier candidates only (all_to_all
has no hierarchical rendering and is deliberately absent).

There is no paper counterpart to agree with (DMA-Latte measures a single
node), so the checks pin the *structure* the model predicts: every winner
is a hierarchical stream, and the pipelined rendering owns the
bandwidth-bound top of each table (the inter-tier overlap claim,
``hier_pipe_overlap_gain``).
"""
from __future__ import annotations

import argparse

from repro_torch.core.backend import MULTINODE_TOPOS, multinode_dispatch_tables
from .common import ClaimChecker, fmt_size

MB = 1024 * 1024


def run(verbose: bool = True, specs: tuple[str, ...] = tuple(MULTINODE_TOPOS)):
    cc = ClaimChecker("tables_multinode")
    for spec in specs:
        ag, rs, ar = multinode_dispatch_tables(spec)
        if verbose:
            print(f"== {spec} hierarchical thresholds (DESIGN.md §11) ==")
            for name, t in (("all_gather", ag), ("reduce_scatter", rs),
                            ("all_reduce", ar)):
                for e in t:
                    print(f"  {name}: [{fmt_size(e.lo)}, "
                          f"{fmt_size(e.hi) if e.hi else 'inf'}) "
                          f"-> {e.variant}"
                          + (f" (chunk {fmt_size(e.chunk)})" if e.chunk else ""))
        all_hier = all("hier_" in e.variant
                       for t in (ag, rs, ar) for e in t)
        cc.check(f"{spec}: every winner is a hierarchical stream",
                 float(all_hier), 1, 1, 1)
        top_pipe = all("hier_pipe" in t[-1].variant for t in (ag, rs, ar))
        cc.check(f"{spec}: pipelined hier stream owns the bandwidth-bound top",
                 float(top_pipe), 1, 1, 1)
    return cc, None


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spec", choices=sorted(MULTINODE_TOPOS), default=None,
                   help="restrict to one multi-node topology spec")
    args = p.parse_args()
    specs = (args.spec,) if args.spec else tuple(MULTINODE_TOPOS)
    cc, _ = run(specs=specs)
    return 0 if cc.report() else 1


if __name__ == "__main__":
    raise SystemExit(main())
