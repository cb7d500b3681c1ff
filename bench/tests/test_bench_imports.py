"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
compared by whole top-level names; the reference loads nothing of the port."""
import subprocess
import sys

from bench.harness import registry

FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'repro'}"


def run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=registry.ROOT,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_rehearsal_loads_no_jax_nor_the_jax_package():
    out = run(f"""
import sys
sys.path[:0] = ['src', '.']
from bench.harness import serve
from bench.tests import tiny
from bench import run
for c in ('olmoe-1b-7b', 'qwen2-vl-72b-8l'):
    for k in ('revisit', 'fresh'):
        serve.run_cell(tiny.cell(c, k), 5, 0.1, k == 'revisit', device='cpu',
                       limits={{'mean_logit_gap': 1.0, 'saved_kv_rel_err': 1.0}})
assert 'repro_torch' in sys.modules
print(sorted({{m.split('.')[0] for m in sys.modules}} & {FORBIDDEN}), run.loaded_forbidden())
""")
    assert out.strip() == "[] []"


def test_reference_loads_nothing_of_the_port():
    out = run("""
import sys, json, torch
sys.path[:0] = ['.']
from bench.reference import model as ref
from bench.tests import tiny
import bench.harness.model as hm
cfg = tiny.config('olmoe-1b-7b')
w = hm.make_weights(cfg, 3, torch.device('cpu'))
first, kv = ref.prefill(cfg, w, torch.arange(40).view(2, 20))
ref.extend(cfg, w, kv, [1], 20, torch.arange(3).view(1, 3))
print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro', 'jax', 'jaxlib'}))
""")
    assert out.strip() == "[]"
