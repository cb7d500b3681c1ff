#!/usr/bin/env python3
"""What the dry-run's temp peak is made of: the storages live at the peak of
one traced step, grouped by the op that made them, largest first.

    PYTHONPATH=src python3 tools/memory_peak.py --arch qwen2-0.5b --shape train_4k \\
        --layers 2 --mesh 2x16x16 --device cpu

The step is traced as ``repro_torch.launch.dryrun.trace_step`` traces it
(attention in query chunks; time scans cut to ``--time-steps``), on fake
tensors of ``--device``'s type (the card by default) over a fake process
group of the mesh's size.  Prints the step's memory analysis and, for the
``--top`` largest groups at the temp peak (arguments and outputs left
out), their bytes, count, op, shape, dtype and the innermost lines of the
port that made them.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import os
import sys
import traceback
from unittest import mock

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.roofline.memory import LiveMemoryMode, local_tensors  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "1x16": ((1, 16), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class DescribedMemory(LiveMemoryMode):
    """The tracker, keeping for each storage the op, shape, dtype and port
    lines that made it, and the step's outputs."""

    def __init__(self):
        super().__init__()
        self.made: dict[int, tuple] = {}
        self.outputs: set[int] = set()

    def _record(self, t, func=None, nbytes=None):
        new = self._serial + 1
        serial = super()._record(t, func, nbytes)
        if serial == new:
            where = [f"{f.name}:{f.lineno}" for f in traceback.extract_stack()
                     if "repro_torch" in f.filename and not f.filename.endswith("memory.py")]
            self.made[serial] = (str(func), tuple(t.shape), str(t.dtype), tuple(where[-3:]))
        return serial

    def analysis(self, outputs):
        self.outputs = {self._record(t) for t in local_tensors(outputs)}
        return super().analysis(outputs)


def live_at_peak(mem: DescribedMemory) -> dict[int, int]:
    """{serial: bytes} live at the temp peak (a kept redistribution freed
    after its last reader, as the temp counts it: ``mem.timeline()``)."""
    skip = mem.outputs | mem._arguments
    live, now, peak, at = {}, 0, -1, {}
    for serial, delta in mem.timeline():
        if serial in skip:
            continue
        now += delta
        live[serial] = live.get(serial, 0) + delta
        if not live[serial]:
            del live[serial]
        if now > peak:
            peak, at = now, dict(live)
    return at


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--mesh", choices=list(MESHES), default="16x16")
    ap.add_argument("--time-steps", type=int, default=dryrun.mamba2.TIME_CHUNK)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape, names = MESHES[args.mesh]
    made = []

    def described():
        made.append(DescribedMemory())
        return made[-1]

    with fake_world(math.prod(shape)), mock.patch.object(dryrun, "LiveMemoryMode", described):
        tr = dryrun.trace_step(args.arch, args.shape, make_mesh(shape, names, args.device),
                               cfg=cfg, device=args.device, time_steps=args.time_steps)
    if tr.skip_reason:
        print(f"skipped: {tr.skip_reason}")
        return 0
    mem = made[-1]
    print(f"{args.arch} x {args.shape} at {cfg.n_layers} layers on {args.mesh}: {tr.memory}")
    groups, counts = collections.Counter(), collections.Counter()
    for serial, n in live_at_peak(mem).items():
        key = mem.made.get(serial, ("?",))
        groups[key] += n
        counts[key] += 1
    for key, n in groups.most_common(args.top):
        print(f"  {n:>15} B  x{counts[key]:<4} {' '.join(map(str, key))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
