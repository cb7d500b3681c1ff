"""Quickstart: the paper's DMA collective model + dispatch in 60 seconds.

Runs the calibrated MI300X engine model over the size spectrum, shows the
phase breakdown of a single DMA copy (Fig. 7) and the best-variant dispatch
(Tables 2/3), all modeled by the port's copy of the simulator; then runs a
latte ring all-gather over ranks emulated on one device (B3 ``b2b`` on the
card) against the input.  Counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import collectives as coll
from repro_torch.core.dma import (
    allgather_schedule, mi300x_platform, paper_dispatch, rccl_ag_calibration, simulate,
    single_copy_breakdown,
)
from repro_torch.core.dma.rccl_model import rccl_collective_latency

KB, MB = 1024, 1024 * 1024
RANKS = 8


def simulator_lines() -> list[str]:
    """The modeled (MI300X simulator) sections, one line each."""
    topo = mi300x_platform()
    lines = ["== Fig.7: phases of a single DMA copy (modeled, MI300X) =="]
    for size in (4 * KB, 64 * KB, 1 * MB, 2 * MB):
        b = single_copy_breakdown(size, topo)
        lines.append(f"  {size >> 10:5d}KB total={b.total*1e6:6.1f}us "
                     f"copy={b.copy*1e6:5.1f}us non-copy={b.noncopy_fraction:5.1%}")
    lines.append("\n== DMA all-gather vs RCCL across sizes (paper Fig. 13; modeled, MI300X) ==")
    for size in (4 * KB, 256 * KB, 4 * MB, 256 * MB):
        variant = paper_dispatch("all_gather", size)
        dma = simulate(allgather_schedule(topo, size, variant), topo).latency
        rccl = rccl_collective_latency(topo, size, rccl_ag_calibration())
        lines.append(f"  {size >> 10:7d}KB best={variant:15s} dma={dma*1e6:9.1f}us "
                     f"rccl={rccl*1e6:9.1f}us speedup={rccl/dma:5.2f}x")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for line in simulator_lines():
        print(line)

    ranks = coll.make_ranks(RANKS, args.device)
    print(f"\n== latte ring all-gather == input, {RANKS} ranks emulated on {ranks.device} ==")
    x = np.random.default_rng(0).normal(size=(RANKS * 4, 32)).astype(np.float32)
    xs = torch.from_numpy(x).reshape(RANKS, 4, 32).to(ranks.device)
    out = coll.ring_all_gather(xs, ranks).reshape(RANKS, RANKS * 4, 32).cpu().numpy()
    ok = bool(np.array_equal(out, np.broadcast_to(x, out.shape)))
    print(f"  ring all-gather matches reference: {ok}")
    if not ok:
        raise AssertionError("ring all-gather differs from its input")


if __name__ == "__main__":
    main()
