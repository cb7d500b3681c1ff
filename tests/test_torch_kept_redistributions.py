"""The dry-run's memory of kept redistributions and rotary tables (C-port9
in ROADMAP), on the CPU.

* A redistribution the dry-run keeps for reuse (one collective per operand
  and layout, as XLA's CSE leaves it) is freed just after its last reader,
  as XLA frees a buffer after its last use, not when its source dies:
  toy steps on a fake (2, 4) mesh whose long-lived source is gathered for
  two readers, with hand-counted temps and one collective each.
* A kept buffer's reader in an attempt ``_Reshard`` refuses is forgotten
  with the attempt.
* qwen2-0.5b train_4k at 1 layer on (2, 4): each rank makes its own rows
  of the rotary tables, float32 [128, 1024, 32], the shape of every cosine
  and sine in the reference's HLO compiled for 8 host devices; no storage
  live at the temp peak holds the global batch's 256 rows; the temp is no
  higher than before (400,984,059,652 B, the eager loss's float32 logits
  buffers are most of it) and within [0.5, 4] of the reference's.
"""
import dataclasses
import json
import os
import sys
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402

from conftest import run_subprocess  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.roofline.memory import LiveMemoryMode  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import memory_peak  # noqa: E402

KIB = 1024
WHOLE = [Replicate(), Replicate()]


def _traced(program):
    """``program(mesh, x)`` traced as the dry-run traces a step on a fake
    (2, 4) mesh, x a float32 [64, 64] DTensor split on its rows over
    'model' (a 4 KiB shard, gathered 16 KiB): its MemoryAnalysis and the
    collectives [(kind, in bytes, out bytes)]."""
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with FakeTensorMode(), implicit_replication():
            x = DTensor.from_local(torch.empty(16, 64), mesh, [Replicate(), Shard(0)],
                                   run_check=False)
            with dryrun.tracing() as (rec, _, reshard):
                reshard.mem.hold_arguments(x)
                got = reshard.mem.analysis(program(mesh, x))
    return got, [(op.kind, op.in_bytes, op.out_bytes) for op in rec.ops]


def test_kept_gather_freed_after_its_last_reader():
    """x, an argument that lives all step, is gathered for two early
    readers (the second takes the kept gather: one all-gather), then a 64
    KiB temporary is made.  The gather is freed after its second reader,
    so the temp is that 64 KiB alone; kept while x lives it was 16 KiB
    more."""
    def step(mesh, x):
        a = (x.redistribute(mesh, WHOLE) * 2).sum()
        b = (x.redistribute(mesh, WHOLE) * 3).sum()
        late = x.to_local().new_empty(64, 256)
        return a, b, late.sum()

    got, ops = _traced(step)
    assert ops == [("all-gather", 4 * KIB, 16 * KIB)]
    assert (got.argument_bytes, got.output_bytes) == (4 * KIB, 3 * 4)
    assert got.temp_bytes == 64 * KIB


def test_kept_gather_spans_from_first_to_last_use():
    """Every reader of the gather is gone when a 64 KiB temporary is made;
    a later redistribution of x takes the kept gather (one all-gather) and
    reads it.  The one buffer lives from its first use to its last, across
    the gap: 16 + 64 KiB at the temporary."""
    def step(mesh, x):
        a = (x.redistribute(mesh, WHOLE) * 2).sum()
        gap = x.to_local().new_empty(64, 256)
        g = gap.sum()
        del gap
        b = (x.redistribute(mesh, WHOLE) * 3).sum()
        return a, b, g

    got, ops = _traced(step)
    assert ops == [("all-gather", 4 * KIB, 16 * KIB)]
    assert got.temp_bytes == (16 + 64) * KIB


def test_roll_back_forgets_a_kept_buffers_reader():
    """A kept 16 KiB buffer read once, then read again in an attempt that
    is rolled back after a 64 KiB temporary was made: the buffer is freed
    after its first reader, so the temp is 16 + 16 KiB there and 64 KiB at
    the temporary; the refused reader would have kept it beside it."""
    with FakeTensorMode():
        x = torch.empty(64, 64)
        mem = LiveMemoryMode()
        with mem:
            mem.hold_arguments(x)
            since = mem.mark()[1]
            kept = x * 2
            mem.keep(kept, since)
            y = (kept + 1).sum()
            late = torch.empty(64, 256)
            mark = mem.mark()
            refused = kept + 1
            mem.roll_back(mark)
            del refused
            got = mem.analysis((y, late.sum()))
    assert got.temp_bytes == 64 * KIB


# --------------------------------------- qwen2-0.5b train_4k on (2, 4) ----
PARENT_TEMP = 400_984_059_652      # the same trace before the fix, B per device

_REFERENCE = """
import dataclasses, json, re
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.dryrun import build_step
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=1)
(fn, args, in_sh, out_sh), _ = build_step("qwen2-0.5b", "train_4k", mesh, cfg=cfg)
with mesh:
    c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
tables = sorted({m.group(1) for m in re.finditer(
    r"= (f32\\[[0-9,]+\\])\\S* (?:cosine|sine)\\(", c.as_text())})
print("RESULT " + json.dumps({"temp": c.memory_analysis().temp_size_in_bytes,
                              "tables": tables}))
"""


@pytest.fixture(scope="module")
def qwen2_on_2x4():
    """(the port's trace, its DescribedMemory, the reference's temp and the
    shapes of its cosines and sines) for qwen2-0.5b train_4k at 1 layer."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=1)
    made = []

    def described():
        made.append(memory_peak.DescribedMemory())
        return made[-1]

    with fake_world(8), mock.patch.object(dryrun, "LiveMemoryMode", described):
        tr = dryrun.trace_step("qwen2-0.5b", "train_4k",
                               make_mesh((2, 4), ("data", "model"), device="cpu"),
                               cfg=cfg, device="cpu")
    out = run_subprocess(_REFERENCE)
    ref = json.loads(next(x for x in out.splitlines() if x.startswith("RESULT "))[7:])
    return tr, made[-1], ref


def test_rotary_tables_split_as_the_reference_splits_them(qwen2_on_2x4):
    _, mem, ref = qwen2_on_2x4
    tables = {(op, shape, dtype) for op, shape, dtype, _ in mem.made.values()
              if op in ("aten.cos.default", "aten.sin.default") and len(shape) == 3}
    print(f"port's rotary tables {sorted(tables)}; reference's {ref['tables']}")
    assert ref["tables"] == ["f32[128,1024,32]"]
    assert tables == {("aten.cos.default", (128, 1024, 32), "torch.float32"),
                      ("aten.sin.default", (128, 1024, 32), "torch.float32")}


def test_no_global_batch_at_the_temp_peak(qwen2_on_2x4):
    tr, mem, ref = qwen2_on_2x4
    live = memory_peak.live_at_peak(mem)
    whole = [mem.made[s] for s in live if s in mem.made and mem.made[s][1][:1] == (256,)]
    temp = tr.memory.temp_bytes
    print(f"temp {temp} B (before {PARENT_TEMP}), reference {ref['temp']}: "
          f"{temp / ref['temp']:.4f}; {len(live)} storages live at the peak, "
          f"{sum(live.values())} B")
    assert sum(live.values()) == temp
    assert whole == []
    assert temp <= PARENT_TEMP
    assert 0.5 <= temp / ref["temp"] <= 4
