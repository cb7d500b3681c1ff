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
                 "core.collectives", "core.backend", "core.latte_moe", "models.moe",
                 "launch.collectives", "core.dma", "core.dma.claims", "core.dma.sim",
                 "core.dma.dispatch", "core.serving_model", "serve.workload",
                 "models.transformer", "data.pipeline", "train.tree", "train.optimizer",
                 "train.loop", "train.checkpoint", "launch.train", "bridge"):
        assert f"repro_torch.{name}" in out["imported"]
    loaded = out["loaded"]
    assert not [m for m in loaded if m == "jax" or m.startswith(("jax.", "jaxlib"))]
    assert not [m for m in loaded if m == "repro" or m.startswith("repro.")]
