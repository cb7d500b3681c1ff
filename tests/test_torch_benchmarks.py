"""The port's twins of the benchmarks that need JAX in the reference
(``repro_torch.benchmarks``) against ``benchmarks/``, on the CPU.

The host-only ones (dispatch tables, multi-node tables, trace export, the
simulator's hot-path benchmark) are the reference's text with the package
renamed, and their claims, tables and latencies equal the reference's bit
for bit.  ``tpu_collectives`` runs its all-gathers over 8 emulated ranks
against numpy; ``roofline_table`` gives the reference's ``model_flops`` and
row fields; ``latte_moe_wire`` at a reduced size on a (2, 4) mesh is held
against the reference's ``measure`` (compiled for 8 emulated host devices in
a subprocess, its two wire counts captured) within a factor of 4 per side.
"""
import dataclasses
import json
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro_torch.benchmarks import (latte_moe_wire, roofline_table, run,  # noqa: E402
                                    sim_perf, tables_dispatch, tables_multinode,
                                    tpu_collectives, trace_export)
from repro_torch.configs import get_shape  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:            # the reference's benchmarks/ package
    sys.path.insert(0, REPO)

from benchmarks import sim_perf as ref_sim_perf  # noqa: E402
from benchmarks import tables_dispatch as ref_tables_dispatch  # noqa: E402
from benchmarks import tables_multinode as ref_tables_multinode  # noqa: E402
from benchmarks import trace_export as ref_trace_export  # noqa: E402

WIRE_FACTOR = 4.0
COPIED = ["common.py", "tables_dispatch.py", "tables_multinode.py", "trace_export.py",
          "sim_perf.py"]


def twin_text(ref: str) -> str:
    """The reference's text with the package renamed: ``repro.core`` /
    ``repro.serve`` -> ``repro_torch.*`` and the benchmark modules' own
    paths -> ``repro_torch.benchmarks``."""
    s = re.sub(r"\brepro\.(core|serve)\b", r"repro_torch.\1", ref)
    s = re.sub(r"(?<![\w/.])benchmarks\.(?=\w)", "repro_torch.benchmarks.", s)
    return re.sub(r"(?<![\w/.])benchmarks/", "repro_torch/benchmarks/", s)


@pytest.mark.parametrize("name", COPIED)
def test_copy_is_the_reference_verbatim(name):
    """Each copied module is the reference's text renamed; ``common.py``
    adds ``device_us`` after it and nothing else."""
    ref = open(os.path.join(REPO, "benchmarks", name)).read()
    port = open(os.path.join(REPO, "src/repro_torch/benchmarks", name)).read()
    want = twin_text(ref)
    if name == "common.py":
        assert port.startswith(want)
        tail = port[len(want):]
        assert re.findall(r"^def (\w+)", tail, re.M) == ["device_us"]
        assert not re.findall(r"^(?:import|from|class) ", tail, re.M)
    else:
        assert port == want


def _rows(cc):
    return [tuple(r) for r in cc.rows]


@pytest.mark.parametrize("port,ref", [(tables_dispatch, ref_tables_dispatch),
                                      (tables_multinode, ref_tables_multinode)])
def test_tables_equal_reference(port, ref):
    cc, _ = port.run(verbose=False)
    ref_cc, _ = ref.run(verbose=False)
    assert _rows(cc) == _rows(ref_cc) and all(r[5] for r in cc.rows)


def test_trace_export_equals_reference():
    cc, got = trace_export.run(verbose=False)
    ref_cc, want = ref_trace_export.run(verbose=False)
    assert _rows(cc) == _rows(ref_cc) and all(r[5] for r in cc.rows)
    assert got["hier"].latency == want["hier"].latency
    assert got["fault"].latency == want["fault"].latency
    assert got["serving"].result.latency == want["serving"].result.latency
    assert len(got["hier"].trace.spans) == len(want["hier"].trace.spans)


def test_sim_perf_latencies_equal_reference():
    """The default run (the legacy simulator against the overhauled one on
    chunked GB-scale all-to-alls): commands and latencies bit-equal to the
    reference's.  Wall times and the speedup depend on the host and are
    checked on the card (chip_smoke.py)."""
    got, want = sim_perf.run(verbose=False), ref_sim_perf.run(verbose=False)
    keys = ("size", "variant", "commands", "latency_s")
    assert [{k: s[k] for k in keys} for s in got["scenarios"]] == \
        [{k: s[k] for k in keys} for s in want["scenarios"]]
    assert got["min_speedup"] == want["min_speedup"] == sim_perf.MIN_SPEEDUP


def test_tpu_collectives_bit_equal_on_emulated_ranks():
    cc, rows = tpu_collectives.run(verbose=False, device="cpu")
    assert [name for name, _, _ in rows] == ["reference", "ring(b2b)", "bidir(bcst)"]
    assert all(ok for _, ok, _ in rows) and all(r[5] for r in cc.rows)
    assert all(us > 0 for _, _, us in rows)


def test_harness_runs_every_entry():
    assert [name for name, _ in run.BENCHES] == ["tables_dispatch", "tables_multinode",
                                                 "tpu_collectives", "trace_export"]
    assert run.main(["--device", "cpu"]) == 0


def test_roofline_table_rows_as_reference(tmp_path):
    out = tmp_path / "rows.json"
    rows, failures = roofline_table.run([("qwen2-0.5b", "decode_32k"),
                                         ("qwen2-0.5b", "long_500k")], out=str(out),
                                        device="cpu")
    assert failures == [] and len(rows) == 1          # long_500k is the documented skip
    row = rows[0]
    assert row.model_flops == jax_analysis.model_flops(jax_get_config("qwen2-0.5b"),
                                                       get_shape("decode_32k"))
    assert [f.name for f in dataclasses.fields(row)] == \
        [f.name for f in dataclasses.fields(jax_analysis.RooflineRow)]
    assert (row.mesh, row.chips) == ("16x16", 256) and row.useful_ratio > 0
    assert json.loads(out.read_text())[0]["model_flops"] == row.model_flops
    assert isinstance(row, analysis.RooflineRow)


_REFERENCE_LATTE = """
import json
import jax
import benchmarks.latte_moe_wire as lm
lm.make_production_mesh = lambda: jax.make_mesh((2, 4), ("data", "model"))
sds = jax.ShapeDtypeStruct
lm.jax.ShapeDtypeStruct = lambda shape, dtype, *a, **k: sds(
    (B, S) + tuple(shape[2:]) if tuple(shape[:2]) == (256, 4096) else shape, dtype, *a, **k)
got = []
wire = lm.wire_bytes_by_kind
lm.wire_bytes_by_kind = lambda text: got.append(wire(text)) or got[-1]
try:
    lm.run(verbose=False)
except AssertionError:      # the > 10x claim is the production mesh's
    pass
print("RESULT " + json.dumps({"gspmd": got[0], "latte": got[1]}))
"""


def test_latte_moe_wire_against_reference_on_2x4():
    """olmoe-1b-7b's MoE layer, batch 32 x 512 on (2, 4): each side's wire
    bytes per device within a factor of 4 of the reference's (its latte
    all-to-alls are collective-permutes there, the port counts all-to-alls),
    and no op of the GSPMD-transparent side ran replicated."""
    B, S = 32, 512
    out = run_subprocess(f"B, S = {B}, {S}\n" + _REFERENCE_LATTE)
    want = json.loads(next(x for x in out.splitlines() if x.startswith("RESULT "))[7:])
    got = latte_moe_wire.measure((2, 4), B, S, device="cpu")
    for side in ("gspmd", "latte"):
        g, w = sum(got[side].values()), sum(want[side].values())
        print(f"{side}: port {g:.4e} reference {w:.4e} ({got[side]} / {want[side]})")
        assert w / WIRE_FACTOR <= g <= w * WIRE_FACTOR
    assert got["latte"]["all-to-all"] > 0 and got["ratio"] > 1
