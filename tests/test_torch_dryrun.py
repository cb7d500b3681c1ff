"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

qwen2-0.5b at full width runs train_4k (cut to 2 of its 24 layers, which
keeps the file's time down; ``chip_smoke.py`` runs all 24 on the card's
machine) and decode_32k (all 24 layers) on fake tensors over the fake 16x16
process group (``ok``) and skips long_500k with the reference's reason.
Each run's argument bytes per device equal the sum of the local shard bytes
of the reference's own specs of its inputs (params, AdamW moments and step,
batch, caches).  Every family's reduced config runs
train, prefill and decode at a small shape on a fake (2, 4) mesh; the time
scans of rwkv6 and zamba2 trace as many steps as asked.  The CLI exits 0
with ``--device cpu`` and, without a card, refuses its default ``cuda``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import input_specs as jax_input_specs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_init_opt_state  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402


class FakeMesh:
    """Duck-typed mesh exposing only .shape (axis sizes)."""

    def __init__(self, shape: dict):
        self.shape = shape


MESH16 = FakeMesh({"data": 16, "model": 16})
RULES16 = jax_rules.ShardingRules(mesh=MESH16, dp="data")
LAYERS = {"train_4k": 2, "decode_32k": 24, "long_500k": 24}   # qwen2-0.5b has 24


@pytest.fixture(scope="module")
def qwen2_runs():
    cfg = get_config("qwen2-0.5b")
    return {s: dryrun.run_one("qwen2-0.5b", s, device="cpu", verbose=False,
                              cfg=dataclasses.replace(cfg, n_layers=n))
            for s, n in LAYERS.items()}


def test_qwen2_full_width_ok(qwen2_runs):
    for shape_id in ("train_4k", "decode_32k"):
        res = qwen2_runs[shape_id]
        assert res.status == "ok", res.reason
        assert res.mesh == "16x16"
        assert res.flops > 0 and res.bytes_accessed > 0
        assert res.collective_counts.get("all-gather", 0) > 0
        assert set(res.wire_bytes_per_device) == set(res.collective_counts)
        assert sum(res.wire_bytes_per_device.values()) > 0
        assert res.time_steps_traced is None
    # the train step's gradient reductions over 'data'
    assert qwen2_runs["train_4k"].collective_counts.get("reduce-scatter", 0) > 0


def test_qwen2_long_500k_skipped_with_reference_reason(qwen2_runs):
    res = qwen2_runs["long_500k"]
    want = jax_input_specs.skip_reason(jax_get_config("qwen2-0.5b"), get_shape("long_500k"))
    assert res.status == "skipped" and res.reason == want and want


def _local_bytes(tree_shapes, tree_specs) -> int:
    """Sum over leaves of the local shard's bytes on MESH16."""
    leaves = jax.tree.leaves(tree_shapes)
    specs = jax.tree.leaves(tree_specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(specs)
    total = 0
    for leaf, spec in zip(leaves, specs):
        dims = [d // jax_rules._axsize(MESH16, axes) for d, axes in
                zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec)))]
        total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


def _reference_argument_bytes(shape_id) -> int:
    cfg = dataclasses.replace(jax_get_config("qwen2-0.5b"), n_layers=LAYERS[shape_id])
    shape = get_shape(shape_id)
    model = jax_build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pspecs = jax_rules.infer_param_specs(params, cfg, RULES16)
    specs = jax_input_specs.input_specs(cfg, shape, model)
    n = _local_bytes(params, pspecs)
    n += _local_bytes(specs["batch"], jax_rules.batch_specs(specs["batch"], cfg, shape, RULES16))
    if shape.mode == "train":
        opt = jax.eval_shape(jax_init_opt_state, params)
        n += _local_bytes(opt, {"m": pspecs, "v": pspecs, "step": P()})
    if specs["caches"] is not None:
        n += _local_bytes(specs["caches"],
                          jax_rules.cache_specs(specs["caches"], cfg, shape, RULES16))
    return n


@pytest.mark.parametrize("shape_id", ["train_4k", "decode_32k"])
def test_argument_bytes_match_reference_specs(qwen2_runs, shape_id):
    assert qwen2_runs[shape_id].argument_bytes_per_device == _reference_argument_bytes(shape_id)


FAMILIES = ("qwen2-0.5b", "olmoe-1b-7b", "qwen2-vl-72b", "rwkv6-1.6b", "zamba2-2.7b",
            "whisper-tiny")


def _trace_small(arch_id, shape, **kw):
    """``trace_step`` of the reduced config on a fake (2, 4) mesh."""
    cfg = get_config(arch_id).reduced()
    if cfg.encdec:   # whisper: 8 encoder frames, not the reduced config's 32
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(cfg.encdec, encoder_seq=8))
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        return cfg, dryrun.trace_step(arch_id, shape.name, mesh, cfg=cfg, shape=shape,
                                      device="cpu", **kw)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch_id", FAMILIES)
def test_every_family_reduced_ok(arch_id, mode):
    cfg, tr = _trace_small(arch_id, ShapeConfig(f"small_{mode}", 4, 4, mode))
    assert tr.skip_reason is None
    assert tr.flops > 0 and tr.argument_bytes > 0 and tr.collective_counts
    if cfg.family in ("ssm", "hybrid"):    # every step of 4 (decode: its one step)
        assert tr.time_steps_traced == (1 if mode == "decode" else 4)
    else:
        assert tr.time_steps_traced is None


@pytest.mark.parametrize("arch_id", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_time_scan_traces_the_steps_asked(arch_id):
    """Fewer traced time steps, fewer FLOPs (each step's state product is a
    matmul); the outputs keep their shapes."""
    shape = ShapeConfig("small_prefill", 8, 4, "prefill")
    runs = {n: _trace_small(arch_id, shape, time_steps=n)[1] for n in (2, 8)}
    assert runs[2].time_steps_traced == 2 and runs[8].time_steps_traced == 8
    assert runs[2].flops < runs[8].flops


def test_cli_on_the_cpu(capsys):
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--device", "cpu"]) == 0
    assert "[ok] qwen2-0.5b x decode_32k x 16x16" in capsys.readouterr().out


def test_cli_needs_a_card_by_default(monkeypatch):
    """No card (as here, or made so): the default ``cuda`` raises; there is
    no silent fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k"])
