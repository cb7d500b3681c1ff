"""The port imports neither JAX nor anything of the JAX package ``repro``.

A fresh interpreter imports every module of ``repro_torch`` (so nothing a
test imported earlier can hide a stray import) and lists what got loaded.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.engine" in out["imported"]
    assert "repro_torch.kernels.decode_attention.ops" in out["imported"]
    for name in ("kernels.ring_all_gather.ops", "kernels.ring_all_to_all.ops",
                 "core.collectives", "core.procgroup", "core.backend", "core.latte_moe",
                 "models.moe",
                 "launch.collectives", "core.dma", "core.dma.claims", "core.dma.sim",
                 "core.dma.dispatch", "core.serving_model", "serve.workload",
                 "models.transformer", "data.pipeline", "train.tree", "train.optimizer",
                 "train.loop", "train.checkpoint", "launch.train", "bridge",
                 "models.mamba2", "models.rwkv6", "launch.serve", "benchmarks.common",
                 "benchmarks.run", "benchmarks.tables_dispatch", "benchmarks.tables_multinode",
                 "benchmarks.trace_export", "benchmarks.sim_perf",
                 "benchmarks.tpu_collectives", "benchmarks.roofline_table",
                 "benchmarks.latte_moe_wire", "examples.quickstart",
                 "examples.pallas_collectives", "examples.train_lm",
                 "examples.serve_kv_cache"):
        assert f"repro_torch.{name}" in out["imported"]
    loaded = out["loaded"]
    assert not [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))]
    assert not [m for m in loaded if m == "repro" or m.startswith("repro.")]


NEW_FAMILIES = ("qwen2-vl-72b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny")


def test_new_family_entry_points_need_a_card_or_cpu(monkeypatch):
    """Without a card the entry points of the new families raise, unless the
    caller asks for the CPU by name; there is no silent fallback."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, data_iterator
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.train.loop import train_loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in NEW_FAMILIES[1:]:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--arch", arch, "--steps", "1"])
        cfg = get_config(arch).reduced()
        it = data_iterator(DataConfig(vocab=cfg.vocab, seq_len=8, batch=1))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_loop(build_model(cfg), it, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "qwen2-vl-72b"])
    _, hist = train_loop(build_model(get_config("rwkv6-1.6b").reduced()),
                         data_iterator(DataConfig(vocab=512, seq_len=8, batch=1)), steps=1,
                         device="cpu")
    assert len(hist) == 1
