"""The dry-run's trace with attention in query chunks (C-port7 in ROADMAP),
on the CPU.

stablelm-12b, mixtral-8x7b and qwen2-vl-72b have 8 KV heads, which a
16-wide 'model' axis does not divide: the queries reach attention
replicated over 'model', each score block's output is a Partial sum there,
and the dry-run's chunks of it are concatenated in the unchunked block's
memory layout (``dryrun._cat_as_one_block``), so the model's reshape before
the output projection resolves the Partial as it does for one block.  A (2,
4) mesh cannot show this: 8 KV heads divide its 'model' of 4.

* Against the reference on (1, 16), each at full width cut to 1 layer,
  train_4k: the chunked trace, as ``trace_dryrun`` runs it, has FLOPs
  within 3% of XLA's cost analysis of the reference compiled for 16 host
  devices with dense attention, wire bytes within 4x, no op run
  replicated, and a temp at most 4x the reference's chunked
  ``memory_analysis()``.  Both traced again with float32 compute: the
  port's temp within [0.8, 1.25] of the reference's.  XLA's CPU backend
  holds most of a bf16 program's buffers in 32 bits (mixtral-8x7b's
  reference temp is 488.8 GB in bf16, 455.2 GB in float32), where the
  port holds bf16, so the bf16 ratio (printed) is no measure of the
  lifetimes; in float32 neither side has anything to widen.
* On 16x16 at 1 layer, eight pairs in which a rank runs more than one
  query chunk (``CHUNKED_PAIRS``): chunked and unchunked FLOPs and wire
  bytes within 3%.
* ``trace_dryrun`` traces each of those pairs once.
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402
from test_torch_roofline import COSTING_RTOL, WIRE_FACTOR  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models.attention import dense_attention_for_costing  # noqa: E402

KV8_ARCHS = ["stablelm-12b", "mixtral-8x7b", "qwen2-vl-72b"]
# the pairs in which a rank runs more than one query chunk, at 1 layer on
# 16x16: queries replicated over 'model' (the 8-KV-head archs), split over
# the sequence (qwen2-0.5b prefill_32k), split over the heads (olmoe)
CHUNKED_PAIRS = [(a, s) for a in KV8_ARCHS for s in ("train_4k", "prefill_32k")] + [
    ("qwen2-0.5b", "prefill_32k"), ("olmoe-1b-7b", "train_4k")]
MEMORY_BAND = (0.5, 4)
F32_MEMORY_BAND = (0.8, 1.25)

_REFERENCE_MESH116 = """
import dataclasses, json
import jax
from jax.sharding import AxisType
from repro.compat import cost_analysis_dict
from repro.configs import get_config
from repro.launch.dryrun import build_step
from repro.models import attention
from repro.roofline import hlo_parse
mesh = jax.make_mesh((1, 16), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for arch in ARCHS:
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    with attention.dense_attention_for_costing():
        (fn, args, in_sh, out_sh), _ = build_step(arch, "train_4k", mesh, cfg=cfg, unroll=True)
        with mesh:
            compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
    text = compiled.as_text()
    temp = {}
    for name, c in (("temp", cfg), ("temp_f32", f32)):
        (fn, args, in_sh, out_sh), _ = build_step(arch, "train_4k", mesh, cfg=c)
        with mesh:
            temp[name] = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh) \\
                .lower(*args).compile().memory_analysis().temp_size_in_bytes
    out[arch] = {"flops": float(cost_analysis_dict(compiled).get("flops", 0.0)),
                 "wire": hlo_parse.total_wire_bytes(text), **temp}
print("RESULT " + json.dumps(out))
"""


def _dryrun_traces(arch_id, shape_id, mesh):
    """The ``Traced`` of each ``trace_step`` call that ``trace_dryrun`` of
    the pair at 1 layer on ``mesh`` (under its fake process group) made,
    the first being its trace with attention in query chunks."""
    calls = []
    trace_step = dryrun.trace_step

    def recorded(*args, **kwargs):
        calls.append(trace_step(*args, **kwargs))
        return calls[-1]

    cfg = dataclasses.replace(get_config(arch_id), n_layers=1)
    with mock.patch.object(dryrun, "trace_step", recorded):
        dryrun.trace_dryrun(arch_id, shape_id, mesh, cfg=cfg, device="cpu")
    return calls


@pytest.fixture(scope="module")
def mesh116():
    """{arch: (chunked trace, its temp with float32 compute, reference)}
    on (1, 16); the reference's subprocess runs while the port traces."""
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_subprocess, f"ARCHS = {KV8_ARCHS!r}\n" + _REFERENCE_MESH116,
                          n_devices=16)
        port = {}
        for arch_id in KV8_ARCHS:
            cfg = dataclasses.replace(get_config(arch_id), n_layers=1)
            with fake_world(16):
                mesh = make_mesh((1, 16), ("data", "model"), device="cpu")
                chunked = _dryrun_traces(arch_id, "train_4k", mesh)[0]
                f32 = dryrun.trace_step(arch_id, "train_4k", mesh, device="cpu",
                                        cfg=dataclasses.replace(cfg, compute_dtype="float32"))
            port[arch_id] = chunked, f32.memory.temp_bytes
        line = next(x for x in ref.result().splitlines() if x.startswith("RESULT "))
    want = json.loads(line[len("RESULT "):])
    return {a: port[a] + (want[a],) for a in KV8_ARCHS}


@pytest.mark.parametrize("arch_id", KV8_ARCHS)
def test_chunked_trace_on_1x16_against_reference(mesh116, arch_id):
    got, f32, want = mesh116[arch_id]
    wire = sum(got.wire.values())
    print(f"{arch_id} x train_4k at 1 layer on (1, 16), chunked: FLOPs port/reference "
          f"{got.flops / want['flops']:.4f} ({got.flops:.4e} / {want['flops']:.4e}); wire "
          f"{wire / want['wire']:.4f} ({wire:.4e} / {want['wire']:.4e}); temp "
          f"{got.memory.temp_bytes / want['temp']:.4f} ({got.memory.temp_bytes} / "
          f"{want['temp']}), {f32 / want['temp_f32']:.4f} with float32 compute "
          f"({f32} / {want['temp_f32']})")
    assert got.flops == pytest.approx(want["flops"], rel=COSTING_RTOL)
    assert want["wire"] / WIRE_FACTOR <= wire <= want["wire"] * WIRE_FACTOR
    assert got.replicated_ops == {}
    assert got.memory.temp_bytes / want["temp"] <= MEMORY_BAND[1]
    assert F32_MEMORY_BAND[0] <= f32 / want["temp_f32"] <= F32_MEMORY_BAND[1]


@pytest.fixture(scope="module")
def mesh16x16():
    """{pair: (trace_step calls of trace_dryrun, unchunked trace)} on 16x16
    at 1 layer."""
    out = {}
    for arch_id, shape_id in CHUNKED_PAIRS:
        cfg = dataclasses.replace(get_config(arch_id), n_layers=1)
        with fake_world(256):
            mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
            calls = _dryrun_traces(arch_id, shape_id, mesh)
            with dense_attention_for_costing():
                dense = dryrun.trace_step(arch_id, shape_id, mesh, cfg=cfg, device="cpu")
        out[arch_id, shape_id] = calls, dense
    return out


@pytest.mark.parametrize("arch_id,shape_id", CHUNKED_PAIRS)
def test_chunked_equals_unchunked_on_16x16(mesh16x16, arch_id, shape_id):
    calls, dense = mesh16x16[arch_id, shape_id]
    got = calls[0]
    wire, want_wire = sum(got.wire.values()), sum(dense.wire.values())
    print(f"{arch_id} x {shape_id} at 1 layer on 16x16: FLOPs chunked/unchunked "
          f"{got.flops / dense.flops:.4f} ({got.flops:.4e}); wire {wire / want_wire:.4f} "
          f"({wire:.4e}); collectives chunked {got.collective_counts} unchunked "
          f"{dense.collective_counts}")
    assert got.flops == pytest.approx(dense.flops, rel=COSTING_RTOL)
    assert wire == pytest.approx(want_wire, rel=COSTING_RTOL)
    assert got.replicated_ops == {}


@pytest.mark.parametrize("arch_id,shape_id", CHUNKED_PAIRS)
def test_trace_dryrun_traces_once(mesh16x16, arch_id, shape_id):
    """One trace gives costs, wire and memory: no second trace with
    attention unchunked."""
    calls, _ = mesh16x16[arch_id, shape_id]
    assert len(calls) == 1
