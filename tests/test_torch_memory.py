"""The dry-run's per-device memory (``repro_torch.roofline.memory``) on the
CPU, against hand counts and against the reference's XLA memory analysis.

* Hand-counted programs on fake tensors: a matmul chain, a view that keeps
  a deleted tensor's storage alive, in-place ops, and a three-block MLP's
  forward and backward with and without a checkpoint per block; the
  tracker's temp peak equals the count written down in each test.
* qwen2-0.5b at full width on a (1, 1) mesh against the reference's
  ``compiled.memory_analysis()`` on a (1, 1) mesh of Auto axes (train_4k at
  2 layers, decode_32k and prefill_32k at 1): argument and output bytes
  within 1%, temp port / reference within [0.5, 4], the port traced as
  XLA's CPU backend runs a bf16 dot (``XlaCpuDots``: float32 copies of the
  operands, a float32 product converted back).  A bf16 matmul on a card or
  a TPU writes none of these, but they are most of the reference's temp
  on the CPU: prefill's float32 [B x S, vocab] logits (637 GB), decode's
  float32 copies of the KV cache.  The plain ratios are printed beside.
* The time-loop extrapolation of rwkv6 and zamba2 (reduced configs, scan
  chunks of 4 steps) equals a trace of every step.
* Sharding lowers the per-device peak: qwen2-0.5b train on (2, 4) under
  (1, 1); on (2, 4) the temp of qwen2-0.5b and olmoe-1b-7b train is within
  [0.5, 4] of the reference's, compiled for 8 host devices.
* A refused attempt's buffers are forgotten, an output with no storage
  raises, and ``run_one`` reports the four sizes.
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from conftest import run_subprocess  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.dryrun import build_step as jax_build_step  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.roofline import costing, wire  # noqa: E402
from repro_torch.roofline.memory import LiveMemoryMode  # noqa: E402

KIB = 1024


def _traced(fn, *args):
    """(MemoryAnalysis, mode) of ``fn(*args)`` on fake tensors."""
    mem = LiveMemoryMode()
    with mem:
        mem.hold_arguments(args)
        got = mem.analysis(fn(*args))
    return got, mem


# ------------------------------------------------------------ hand counts ----
# float32 throughout: a [64, 64] tensor is 16 KiB, a [64, 256] one 64 KiB.

def test_matmul_chain():
    """(x @ w) @ w: the first product is the one temporary."""
    with FakeTensorMode():
        got, _ = _traced(lambda x, w: (x @ w) @ w, torch.empty(64, 64), torch.empty(64, 64))
    assert (got.argument_bytes, got.output_bytes, got.alias_bytes, got.temp_bytes) == \
        (32 * KIB, 16 * KIB, 0, 16 * KIB)


def test_view_keeps_a_deleted_tensor_alive():
    """``a`` is deleted while a view of it lives, so its 16 KiB stay live
    beside ``b``'s: 32 KiB, not 16."""
    def program(x):
        a = x * 2
        v = a[0]
        del a
        b = x + 1
        return v + b[0]

    with FakeTensorMode():
        got, _ = _traced(program, torch.empty(64, 64))
    assert (got.temp_bytes, got.output_bytes) == (32 * KIB, 64 * 4)


def test_in_place_ops_allocate_nothing():
    """Two in-place ops on ``a`` add nothing to its 16 KiB; an input
    returned as it was updated in place is an alias of its argument."""
    def program(x):
        a = x * 2
        a.add_(1).mul_(3)
        return a.sum()

    def update(x):
        return x.mul_(2)

    with FakeTensorMode():
        got, _ = _traced(program, torch.empty(64, 64))
        updated, _ = _traced(update, torch.empty(64, 64))
    assert (got.temp_bytes, got.output_bytes) == (16 * KIB, 4)
    assert (updated.output_bytes, updated.alias_bytes, updated.temp_bytes) == \
        (16 * KIB, 16 * KIB, 0)
    assert updated.total_bytes == 16 * KIB


def _mlp(x, w1, w2, remat: bool):
    """Three blocks relu(h @ w1) @ w2 (x [64, 64], w1 [64, 256], w2
    [256, 64]), the gradient of the sum with respect to x."""
    x = x.detach().requires_grad_()

    def block(h):
        return torch.relu(h @ w1) @ w2

    h = x
    for _ in range(3):
        h = checkpoint(block, h, use_reentrant=False) if remat else block(h)
    loss = h.sum()
    del h
    return torch.autograd.grad(loss, [x])


@pytest.mark.parametrize("remat,want", [
    # Without checkpoints each block's relu keeps its 64 KiB result for the
    # backward.  The peak is in the last block's relu backward: the three
    # kept results, the gradients of its relu's output and input (64 KiB
    # each), the 4-byte loss and autograd's 4-byte seed of ones.
    (False, 5 * 64 * KIB + 4 + 4),
    # With a checkpoint per block only each block's 16 KiB input is kept
    # (blocks 2 and 3: the outputs of blocks 1 and 2).  The peak is in the
    # last block's backward: those two inputs, its recomputed relu result
    # and the two 64 KiB gradients, the loss and the seed.
    (True, 2 * 16 * KIB + 3 * 64 * KIB + 4 + 4),
])
def test_mlp_forward_and_backward(remat, want):
    with FakeTensorMode():
        got, _ = _traced(lambda *a: _mlp(*a, remat), torch.empty(64, 64),
                         torch.empty(64, 256), torch.empty(256, 64))
    assert (got.argument_bytes, got.output_bytes) == ((16 + 64 + 64) * KIB, 16 * KIB)
    assert got.temp_bytes == want


def test_roll_back_forgets_what_was_allocated():
    """What was allocated after the mark counts for nothing, while it
    lives and when it dies; what was freed after it stays freed."""
    with FakeTensorMode():
        mem = LiveMemoryMode()
        with mem:
            kept, freed = torch.empty(64, 64), torch.empty(64, 64)
            mark = mem.mark()
            refused = torch.empty(64, 256)
            del freed
            mem.roll_back(mark)
            after = torch.empty(16, 64)
            del refused
            got = mem.analysis((kept, after))
    assert (got.temp_bytes, got.output_bytes) == (16 * KIB, 16 * KIB + 4 * KIB)


def test_unsized_output_raises():
    """A sparse tensor has no storage to size: no partial peak."""
    with LiveMemoryMode(), pytest.raises(RuntimeError, match="cannot size the output"):
        torch.eye(4).to_sparse()


def test_refused_reshape_attempts_leave_no_buffers():
    """The dry-run's reshape of a [4, 64] DTensor split 8 ways on its
    columns is refused as laid out and retried gathered: the memory keeps
    the buffers of the attempt that ran, as a direct gather and view
    would make them."""
    def run(fn):
        rec, cost, mem = wire.CollectiveRecorder(), costing.LocalCostMode(), LiveMemoryMode()
        reuse = dryrun._ReusedRedistributions()
        reshard = dryrun._Reshard(rec, cost, reuse, mem)
        with reuse.patched(), costing._marking_sharding_propagation(), rec, cost, mem, reshard:
            mem.hold_arguments(x)
            return mem.analysis(fn())

    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(1), Shard(1)],
                                   run_check=False)
            got = run(lambda: x.view(4, 2, 32))
            want = run(lambda: x.redistribute(mesh, [Replicate(), Replicate()]).view(4, 2, 32))
    assert got.output_bytes == want.output_bytes == 4 * 64 * 4
    assert got.temp_bytes == want.temp_bytes


# ------------------------------------------------ against XLA on (1, 1) ----
A = torch.ops.aten
_DOTS = {A.mm.default, A.bmm.default, A.addmm.default, A.baddbmm.default}


class XlaCpuDots(LiveMemoryMode):
    """The tracker, with every bf16 matmul held as XLA's CPU backend runs
    it: float32 copies of the bf16 operands, a float32 product, and that
    product converted to bf16."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _DOTS or wire.on_dtensors(types) or not any(
                isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 for a in args):
            return super().__torch_dispatch__(func, types, args, kwargs)
        up = [a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a
              for a in args]
        for a in up:
            if isinstance(a, torch.Tensor):
                self._record(a, func)
        out = func(*up, **(kwargs or {}))
        self._record(out, func)
        del up
        low = out.to(torch.bfloat16)
        self._record(low, func)
        return low


QWEN_CASES = [("train_4k", 2), ("decode_32k", 1), ("prefill_32k", 1)]


def _reference_memory(shape_id, n_layers):
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = dataclasses.replace(jax_get_config("qwen2-0.5b"), n_layers=n_layers)
    (fn, args, in_sh, out_sh), _ = jax_build_step("qwen2-0.5b", shape_id, mesh, cfg=cfg)
    with mesh:
        m = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile() \
            .memory_analysis()
    return m.argument_size_in_bytes, m.output_size_in_bytes, m.temp_size_in_bytes


def _port_memory(shape_id, n_layers, mode=LiveMemoryMode):
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=n_layers)
    with fake_world(1), mock.patch.object(dryrun, "LiveMemoryMode", mode):
        mem, _ = dryrun.trace_memory("qwen2-0.5b", shape_id,
                                     make_mesh((1, 1), ("data", "model"), device="cpu"),
                                     cfg=cfg, device="cpu")
    return mem


@pytest.mark.parametrize("shape_id,n_layers", QWEN_CASES)
def test_against_reference_memory_analysis(shape_id, n_layers):
    args, outs, temp = _reference_memory(shape_id, n_layers)
    got = _port_memory(shape_id, n_layers)
    xla_cpu = _port_memory(shape_id, n_layers, XlaCpuDots)
    print(f"qwen2-0.5b x {shape_id} at {n_layers} layers on (1, 1): temp port / reference "
          f"{xla_cpu.temp_bytes / temp:.4f} with bf16 dots as XLA's CPU backend runs them "
          f"({xla_cpu.temp_bytes} / {temp}), {got.temp_bytes / temp:.4f} plain "
          f"({got.temp_bytes}); arguments {got.argument_bytes} / {args}, outputs "
          f"{got.output_bytes} / {outs}")
    for mem in (got, xla_cpu):
        assert mem.argument_bytes == pytest.approx(args, rel=0.01)
        assert mem.output_bytes == pytest.approx(outs, rel=0.01)
    assert 0.5 <= xla_cpu.temp_bytes / temp <= 4


# ------------------------------------------------------------- time loops ----
@pytest.mark.parametrize("arch_id", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_time_loop_extrapolation_equals_every_step(arch_id):
    """Scan chunks of 4 steps, 24 steps a sequence, batch 64, 1 layer: the
    temp extrapolated from traces of 12 and 16 steps equals the trace of
    all 24, and exceeds the 16-step trace's (the scan's saved carries set
    the peak)."""
    cfg = dataclasses.replace(get_config(arch_id).reduced(), n_layers=1)
    shape = ShapeConfig("small_train", 24, 64, "train")
    with mock.patch.object(mamba2, "TIME_CHUNK", 4), fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        assert dryrun.memory_time_steps(cfg, shape) == (12, 16)
        got, how = dryrun.trace_memory(arch_id, shape.name, mesh, cfg=cfg, shape=shape,
                                       device="cpu")
        every = dryrun.trace_step(arch_id, shape.name, mesh, cfg=cfg, shape=shape,
                                  device="cpu", time_steps=24).memory.temp_bytes
    print(f"{arch_id}: {how}; extrapolated {got.temp_bytes}, every step {every}")
    at_16 = int(how.split(" and ")[-1].split(" B)")[0])
    assert "extrapolated from traces of 12 and 16 steps" in how
    assert got.temp_bytes == every > at_16


# ----------------------------------------------------------- on (2, 4) ----
MESH24 = [("qwen2-0.5b", "train_4k"), ("olmoe-1b-7b", "train_4k")]

_REFERENCE_MESH24 = """
import dataclasses, json
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.dryrun import build_step
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for arch, shape_id in PAIRS:
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    (fn, args, in_sh, out_sh), _ = build_step(arch, shape_id, mesh, cfg=cfg)
    with mesh:
        m = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile() \\
            .memory_analysis()
    out[arch + ":" + shape_id] = m.temp_size_in_bytes
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh24_memory():
    """{(arch, shape): (port's temp on (2, 4), reference's)} at 1 layer."""
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_subprocess, f"PAIRS = {MESH24!r}\n" + _REFERENCE_MESH24)
        port = {}
        for arch_id, shape_id in MESH24:
            cfg = dataclasses.replace(get_config(arch_id), n_layers=1)
            with fake_world(8):
                port[arch_id, shape_id], _ = dryrun.trace_memory(
                    arch_id, shape_id, make_mesh((2, 4), ("data", "model"), device="cpu"),
                    cfg=cfg, device="cpu")
        line = next(x for x in ref.result().splitlines() if x.startswith("RESULT "))
    want = json.loads(line[len("RESULT "):])
    return {k: (port[k], want[f"{k[0]}:{k[1]}"]) for k in MESH24}


@pytest.mark.parametrize("arch_id,shape_id", MESH24)
def test_temp_on_a_2x4_mesh_against_reference(mesh24_memory, arch_id, shape_id):
    got, want = mesh24_memory[arch_id, shape_id]
    print(f"{arch_id} x {shape_id} at 1 layer on (2, 4): temp per device port / reference "
          f"{got.temp_bytes / want:.4f} ({got.temp_bytes} / {want})")
    assert 0.5 <= got.temp_bytes / want <= 4


def test_sharding_lowers_the_peak(mesh24_memory):
    """qwen2-0.5b train_4k at 1 layer: every size per device is smaller on
    (2, 4) than on (1, 1)."""
    small, _ = mesh24_memory["qwen2-0.5b", "train_4k"]
    whole = _port_memory("train_4k", 1)
    print(f"qwen2-0.5b train_4k at 1 layer: temp per device (2, 4) {small.temp_bytes}, "
          f"(1, 1) {whole.temp_bytes}")
    assert small.temp_bytes < whole.temp_bytes
    assert small.argument_bytes < whole.argument_bytes
    assert small.output_bytes < whole.output_bytes


# --------------------------------------------------------------- run_one ----
def test_run_one_reports_the_memory_analysis(capsys):
    """decode_32k on 16x16 (2 of qwen2-0.5b's 24 layers): the peak is the
    temp, the analysis names XLA's four sizes and the 80 GB verdict, and
    the ``[ok]`` line prints peak and arguments."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    res = dryrun.run_one("qwen2-0.5b", "decode_32k", device="cpu", cfg=cfg)
    out = capsys.readouterr().out
    assert res.status == "ok" and res.peak_bytes_per_device > 0
    sizes = dict(kv.split("=") for kv in res.memory_analysis.split(": ", 1)[1]
                 .split(";")[0].split(", "))
    assert list(sizes) == ["argument_size_in_bytes", "output_size_in_bytes",
                           "alias_size_in_bytes", "temp_size_in_bytes"]
    assert float(sizes["temp_size_in_bytes"]) == res.peak_bytes_per_device
    assert float(sizes["argument_size_in_bytes"]) == res.argument_bytes_per_device
    assert 0 < int(sizes["alias_size_in_bytes"]) <= int(sizes["output_size_in_bytes"])
    assert "fits in 80000000000 B" in res.memory_analysis
    assert f"peak={res.peak_bytes_per_device:.4e}" in out and "arguments=" in out
    assert "not measured" not in res.memory_analysis
