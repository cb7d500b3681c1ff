"""The port's roofline (``repro_torch.roofline``) against the reference's, on
the CPU.

``model_flops`` equals the reference's as a float for every arch x input
shape; the scan trip counts, the analytic SSM correction and the wire-byte
rules equal the reference's.  ``wire.CollectiveRecorder`` sees the
functional collectives of DTensor redistributions on a fake 16x16 process
group, with per-device bytes.  The costing's FLOPs are per device: on a
(1, 1) mesh they equal ``FlopCounterMode``'s global count, on 16x16 they
are the local shard's.  The costing pass of qwen2-0.5b at full width cut to
1 and 2 layers, train_4k on a (1, 1) mesh, is within 3% of the reference's
XLA cost analysis on a (1, 1) mesh of Auto axes (measured: 0.6% and 0.9%
under); decode_32k's ratio, where XLA also counts the softmax's elementwise
FLOPs, is printed and not gated.
"""
import contextlib
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from conftest import run_subprocess  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro.roofline import costing as jax_costing  # noqa: E402
from repro.roofline import hlo_parse as jax_hlo  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (fake_world, make_local_mesh, make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.attention import dense_attention_for_costing  # noqa: E402
from repro_torch.roofline import analysis, costing, hw, wire  # noqa: E402

PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
COSTING_RTOL = 0.03


@pytest.mark.parametrize("arch_id,shape_id", PAIRS)
def test_model_flops_equal_reference(arch_id, shape_id):
    shape = get_shape(shape_id)
    got = analysis.model_flops(get_config(arch_id), shape)
    want = jax_analysis.model_flops(jax_get_config(arch_id), shape)
    assert got == want and isinstance(got, float)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_scan_axes_and_ssm_correction_equal_reference(arch_id):
    cfg, jcfg = get_config(arch_id), jax_get_config(arch_id)
    got, want = costing._scan_axes(cfg), jax_costing._scan_axes(jcfg)
    assert [(n, t) for n, t, _ in got] == [(n, t) for n, t, _ in want]
    for (_, _, build), (_, _, jbuild) in zip(got, want):
        for k in (1, 2):
            c, jc = build(cfg, k), jbuild(jcfg, k)
            assert c.n_layers == jc.n_layers
            assert (c.encdec and c.encdec.n_encoder_layers) == \
                (jc.encdec and jc.encdec.n_encoder_layers)
    for shape_id in INPUT_SHAPES:
        for dp in (1, 16, 32):
            shape = get_shape(shape_id)
            c = costing._ssm_correction(cfg, shape, dp)
            jc = jax_costing._ssm_correction(jcfg, shape, dp)
            assert (c.flops, c.bytes, c.wire) == (jc.flops, jc.bytes, jc.wire)


TRIPLES = [(kind, out, inp) for kind in ("all-gather", "reduce-scatter", "all-reduce",
                                         "all-to-all", "collective-permute")
           for out, inp in ((4096, 256), (256, 4096), (1024, 1024), (0, 8))]


@pytest.mark.parametrize("kind,out,inp", TRIPLES)
def test_wire_bytes_equal_reference(kind, out, inp):
    assert (wire.CollectiveOp(kind, out, inp).wire_bytes
            == jax_hlo.CollectiveOp(kind, out, inp).wire_bytes)


def test_hw_is_the_h100():
    assert (hw.PEAK_BF16_FLOPS, hw.PEAK_FP32_FLOPS, hw.HBM_BW) == (989e12, 67e12, 3.35e12)
    assert (hw.NVLINK_BW, hw.INTER_NODE_BW, hw.LINK_BW) == (450e9, 50e9, 50e9)
    row = analysis.make_row("qwen2-0.5b", "train_4k", "1x1", 1,
                            costing.CostVector(989e12, 3.35e12, {"all-gather": 50e9}))
    assert (row.compute_s, row.memory_s, row.collective_s) == (1.0, 1.0, 1.0)
    assert "MXU" not in str(analysis._SUGGESTIONS) and "ICI" not in str(analysis._SUGGESTIONS)


@pytest.fixture
def mesh16():
    """The fake 16x16 mesh, its process group torn down after each test (the
    costing tests below build their own (1, 1) groups)."""
    with fake_world(256):
        yield make_production_mesh(device="cpu")


def test_recorder_sees_redistributions(mesh16):
    """Shard -> Replicate over 'model' is an all-gather, Partial -> Replicate
    an all-reduce, Partial -> Shard a reduce-scatter; bytes per device."""
    with FakeTensorMode():
        local = torch.empty(64, 128)                      # 32 KiB per device
        x = DTensor.from_local(local, mesh16, [Replicate(), Shard(0)], run_check=False)
        p = DTensor.from_local(local, mesh16, [Replicate(), Partial()], run_check=False)
        rec = wire.CollectiveRecorder()
        with rec:
            x.redistribute(mesh16, [Replicate(), Replicate()])
            p.redistribute(mesh16, [Replicate(), Replicate()])
            p.redistribute(mesh16, [Replicate(), Shard(0)])
    got = [(op.kind, op.out_bytes, op.in_bytes) for op in rec.ops]
    kib = 64 * 128 * 4
    assert got == [("all-gather", 16 * kib, kib), ("all-reduce", kib, kib),
                   ("reduce-scatter", kib // 16, kib)]
    assert wire.wire_bytes_by_kind(rec.ops) == {"all-gather": 15 * kib,
                                                "all-reduce": 2.0 * kib,
                                                "reduce-scatter": 15 * kib // 16}
    assert wire.collective_counts(rec.ops) == {"all-gather": 1, "all-reduce": 1,
                                               "reduce-scatter": 1}


def _matmul_flops(mesh, placements):
    """(FlopCounterMode's, LocalCostMode's) FLOPs of x @ w, x [4096, 896]
    laid out by ``placements``, w [896, 4864] replicated."""
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4096 // mesh.size(), 896), mesh, placements,
                               run_check=False)
        w = DTensor.from_local(torch.empty(896, 4864), mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
        counter, local = FlopCounterMode(display=False), costing.LocalCostMode()
        with counter:
            x @ w
        with costing._marking_sharding_propagation(), local:
            x @ w
    return counter.get_total_flops(), local.flops


def test_costing_is_per_device(mesh16):
    """FlopCounterMode around DTensor code counts the GLOBAL product; the
    costing counts this rank's shard: 1/256 of it on 16x16, where the rows
    are split over both axes."""
    full = 2 * 4096 * 896 * 4864
    glob, per_device = _matmul_flops(mesh16, [Shard(0), Shard(0)])
    assert glob == full and per_device == full / 256


def test_costing_per_device_equals_global_on_1x1():
    with fake_world(1):
        glob, per_device = _matmul_flops(make_local_mesh(device="cpu"), [Shard(0), Shard(0)])
    assert glob == per_device == 2 * 4096 * 896 * 4864


def _reference_measure(shape_id, n_layers):
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = dataclasses.replace(jax_get_config("qwen2-0.5b"), n_layers=n_layers)
    return jax_costing._measure("qwen2-0.5b", shape_id, mesh, cfg)


def _port_measure(shape_id, n_layers):
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=n_layers)
    with fake_world(1):
        return costing._measure("qwen2-0.5b", shape_id, make_local_mesh(device="cpu"), cfg,
                                device="cpu")


@pytest.mark.parametrize("n_layers", [1, 2])
def test_costing_flops_match_reference_train_4k(n_layers):
    got, want = _port_measure("train_4k", n_layers), _reference_measure("train_4k", n_layers)
    print(f"qwen2-0.5b x train_4k at {n_layers} layers: port/reference FLOPs "
          f"{got.flops / want.flops:.4f}, bytes {got.bytes / want.bytes:.4f}")
    assert got.flops == pytest.approx(want.flops, rel=COSTING_RTOL)
    assert got.wire == {} and want.wire == {}


def test_costing_decode_ratio_is_reported():
    """decode_32k: printed, not gated (XLA counts the softmax's elementwise
    FLOPs, which torch's flop counter does not)."""
    got, want = _port_measure("decode_32k", 1), _reference_measure("decode_32k", 1)
    print(f"qwen2-0.5b x decode_32k at 1 layer: port/reference FLOPs "
          f"{got.flops / want.flops:.4f}")
    assert got.flops > 0 and want.flops > 0


# ---------------------------------------------- against GSPMD on a (2, 4) mesh ----
# Full width cut to 1 layer, each traced as the costing traces it (dense
# attention): the reference compiled by XLA for 8 emulated host devices on a
# (2, 4) mesh of Auto axes (in a subprocess), the port on fake tensors over a
# fake (2, 4) process group.  Per-device FLOPs of train and prefill agree
# within 3%, qwen2-0.5b's 14 heads included (its attention splits over the
# query positions, as GSPMD's does), and no op runs replicated (the MoE
# dispatch included).  The two partitioners pick different collectives
# (DTensor reduce-scatters and all-to-alls where GSPMD all-reduces and
# gathers), so the counts are printed side by side and the wire bytes held
# within a factor of 4.  Decode's FLOPs are printed only: XLA also counts the
# softmax's elementwise FLOPs.
MESH24_PAIRS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
                ("qwen2-0.5b", "decode_32k"), ("deepseek-7b", "train_4k"),
                ("deepseek-7b", "prefill_32k"), ("olmoe-1b-7b", "train_4k")]
WIRE_FACTOR = 4.0

_REFERENCE_MESH24 = """
import dataclasses, json
import jax
from jax.sharding import AxisType
from repro.compat import cost_analysis_dict
from repro.configs import get_config
from repro.launch.dryrun import build_step
from repro.models import attention
from repro.roofline import hlo_parse
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for arch, shape_id in PAIRS:
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    with attention.dense_attention_for_costing():
        (fn, args, in_sh, out_sh), _ = build_step(arch, shape_id, mesh, cfg=cfg, unroll=True)
        with mesh:
            compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
    text = compiled.as_text()
    counts = {}
    for op in hlo_parse.parse_collectives(text):
        counts[op.kind] = counts.get(op.kind, 0) + 1
    out[arch + ":" + shape_id] = {"flops": float(cost_analysis_dict(compiled).get("flops", 0.0)),
                                  "wire": hlo_parse.total_wire_bytes(text), "counts": counts}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh24_costs():
    """{(arch, shape): (port's trace, reference's costs)}; the reference's
    subprocess runs while the port traces."""
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_subprocess, f"PAIRS = {MESH24_PAIRS!r}\n" + _REFERENCE_MESH24)
        port = {}
        for arch_id, shape_id in MESH24_PAIRS:
            cfg = dataclasses.replace(get_config(arch_id), n_layers=1)
            with fake_world(8), dense_attention_for_costing():
                mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
                port[arch_id, shape_id] = dryrun.trace_step(arch_id, shape_id, mesh, cfg=cfg,
                                                            device="cpu", time_steps=1)
        line = next(x for x in ref.result().splitlines() if x.startswith("RESULT "))
    want = json.loads(line[len("RESULT "):])
    return {k: (port[k], want[f"{k[0]}:{k[1]}"]) for k in MESH24_PAIRS}


@pytest.mark.parametrize("arch_id,shape_id", MESH24_PAIRS)
def test_costs_on_a_2x4_mesh_against_reference(mesh24_costs, arch_id, shape_id):
    got, want = mesh24_costs[arch_id, shape_id]
    wire = sum(got.wire.values())
    print(f"{arch_id} x {shape_id} on (2, 4): FLOPs port/reference "
          f"{got.flops / want['flops']:.4f}; wire bytes {wire:.4e} / {want['wire']:.4e}; "
          f"collectives port {got.collective_counts} reference {want['counts']}")
    assert set(got.collective_counts) <= {"all-gather", "reduce-scatter", "all-reduce",
                                          "all-to-all"}
    assert got.replicated_ops == {}
    if get_shape(shape_id).mode == "decode":
        assert got.flops > 0 and want["flops"] > 0
    else:
        assert got.flops == pytest.approx(want["flops"], rel=COSTING_RTOL)
    assert want["wire"] / WIRE_FACTOR <= wire <= want["wire"] * WIRE_FACTOR


def test_decode_cache_write_gathers_no_cache(mesh24_costs):
    """qwen2-0.5b decode_32k on (2, 4): the cache is sharded on its capacity
    over 'model', and writing the new token's row moves nothing: every
    all-gather of the step together moves less than one K cache gathered
    over 'model' would."""
    got, _ = mesh24_costs["qwen2-0.5b", "decode_32k"]
    cfg, shape = get_config("qwen2-0.5b"), get_shape("decode_32k")
    one_cache = (shape.global_batch // 2) * shape.seq_len * cfg.n_kv_heads * cfg.head_dim * 2
    assert 0 < got.wire.get("all-gather", 0) < one_cache * 3 / 4


@pytest.mark.parametrize("slot", [2, 9])
def test_row_write_on_a_sharded_dim_stays_local(slot):
    """``cache[:, slot] = row`` on a cache split on dim 1 over 'model':
    rank 0 (rows 0-3 of 16) writes the row when it holds it and is untouched
    otherwise, and nothing is gathered."""
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        cache = DTensor.from_local(torch.zeros(2, 4, 3), mesh, [Replicate(), Shard(1)],
                                   run_check=False)
        row = DTensor.from_local(torch.ones(2, 3), mesh, [Replicate(), Replicate()],
                                 run_check=False)
        rec, cost = wire.CollectiveRecorder(), costing.LocalCostMode()
        reuse = dryrun._ReusedRedistributions()
        with reuse.patched(), costing._marking_sharding_propagation(), rec, cost, \
                dryrun._Reshard(rec, cost, reuse):
            cache[:, slot] = row
    local = cache.to_local()
    assert rec.ops == [] and tuple(cache.shape) == (2, 16, 3)
    assert local.sum().item() == (6.0 if slot < 4 else 0.0)
    if slot < 4:
        assert (local[:, slot] == 1).all()


def test_only_the_all_reduced_partial_is_scattered():
    """Of two Partial operands of one size, only the one DTensor all-reduced
    since the mark is reduce-scattered instead; the other stays as it is
    (a match on sizes alone would take both)."""
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        a, b = (DTensor.from_local(torch.ones(8, 6), mesh, [Replicate(), Partial()],
                                   run_check=False) for _ in range(2))
        rec, cost = wire.CollectiveRecorder(), costing.LocalCostMode()
        reuse = dryrun._ReusedRedistributions()
        reshard = dryrun._Reshard(rec, cost, reuse)
        with reuse.patched(), costing._marking_sharding_propagation(), rec, cost:
            mark = reshard._mark()
            b.redistribute(mesh, [Replicate(), Replicate()])      # DTensor's all-reduce of b
            got = reshard._scattered((a, b), reshard._scatter_targets((a, b), mark))
    assert got[0] is a
    assert list(got[1].placements) == [Replicate(), Shard(0)]
    assert [op.kind for op in rec.ops] == ["all-reduce", "reduce-scatter"]


def test_reduce_scatter_of_a_partial_is_counted():
    """A pointwise op on a Partial operand under the dry-run's tracing: the
    reduce-scatter that replaces DTensor's all-reduce is recorded, and no
    all-reduce."""
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with FakeTensorMode(), implicit_replication():
            a = DTensor.from_local(torch.empty(8, 6), mesh, [Replicate(), Partial()],
                                   run_check=False)
            with dryrun.tracing() as (rec, _, _):
                y = a * a
    assert list(y.placements) == [Replicate(), Shard(0)]
    assert [(op.kind, op.out_bytes, op.in_bytes) for op in rec.ops] == \
        [("reduce-scatter", 2 * 6 * 4, 8 * 6 * 4)]


MATMUL_SPELLINGS = {"at": lambda x, w: x @ w, "method": lambda x, w: x.matmul(w),
                    "function": lambda x, w: torch.matmul(x, w),
                    "linear": lambda x, w: torch.nn.functional.linear(x, w.t())}


@pytest.mark.parametrize("spelling", sorted(MATMUL_SPELLINGS))
def test_matmul_keeps_sequence_rows_however_spelled(spelling):
    """x [4, 8, 6] split over batch ('data') and sequence ('model') times a
    replicated w: each spelling of the matmul keeps the rows where they are
    and moves nothing under the dry-run's tracing, where the fold into 2-D
    gathers the sequence without the patch of the spellings."""
    matmul = MATMUL_SPELLINGS[spelling]
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with FakeTensorMode(), implicit_replication():
            x = DTensor.from_local(torch.empty(2, 2, 6), mesh, [Shard(0), Shard(1)],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(6, 10), mesh, [Replicate(), Replicate()],
                                   run_check=False)
            with mock.patch.object(dryrun, "_rows_kept_matmuls", contextlib.nullcontext), \
                    dryrun.tracing() as (plain, _, _):
                matmul(x, w)
            with dryrun.tracing() as (rec, _, _):
                y = matmul(x, w)
    assert plain.ops
    assert rec.ops == []
    assert tuple(y.shape) == (4, 8, 10) and list(y.placements) == [Shard(0), Shard(1)]


def test_refused_reshape_attempts_leave_no_collectives():
    """A reshape DTensor refuses as laid out is retried on gathered inputs;
    the recorder and the cost counters keep the collectives of the attempt
    that ran, not of those refused on the way."""
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with FakeTensorMode():
            # [4, 64] sharded 8 ways on its columns; splitting them into
            # (2, 32) is uneven on 8 shards and on the 4 'model' shards alone
            x = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(1), Shard(1)],
                                   run_check=False)
            direct = wire.CollectiveRecorder()
            with direct:
                x.redistribute(mesh, [Replicate(), Replicate()])
            rec, cost = wire.CollectiveRecorder(), costing.LocalCostMode()
            reuse = dryrun._ReusedRedistributions()
            reshard = dryrun._Reshard(rec, cost, reuse)
            with reuse.patched(), costing._marking_sharding_propagation(), rec, cost, reshard:
                y = x.view(4, 2, 32)
    assert tuple(y.shape) == (4, 2, 32) and all(p.is_replicate() for p in y.placements)
    assert [(o.kind, o.out_bytes, o.in_bytes) for o in rec.ops] == \
        [(o.kind, o.out_bytes, o.in_bytes) for o in direct.ops]
