"""The port's twins of ``examples/`` (``repro_torch.examples``) on the CPU.

The quickstart's simulator lines equal the reference's; every B3/B4
variant's output (their plain versions here) equals the reference's
``ref.py`` oracles bit for bit; ``train_lm`` trains 3 steps and round-trips
its checkpoint bit for bit (the 300-step fall of the loss is checked on
the card: ``chip_smoke.py`` and ``tests/test_torch_gpu.py``);
``serve_kv_cache`` gives the miss path's tokens on every hit backend, as
the reference asserts (at a smaller batch and context here).
"""
import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ring_all_gather.ref import all_gather_ref as jax_all_gather_ref  # noqa: E402
from repro.kernels.ring_all_to_all.ref import all_to_all_ref as jax_all_to_all_ref  # noqa: E402
from repro_torch.benchmarks import (latte_moe_wire, roofline_table,  # noqa: E402
                                    tpu_collectives)
from repro_torch.examples import (pallas_collectives, quickstart,  # noqa: E402
                                  serve_kv_cache, train_lm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data_lines(text: str) -> list[str]:
    return [line for line in text.splitlines() if line.startswith("  ") and "KB" in line]


def test_quickstart_simulator_lines_equal_reference(capsys):
    _reference_example("quickstart").main()
    want = _data_lines(capsys.readouterr().out)
    assert len(want) == 8
    assert _data_lines("\n".join(quickstart.simulator_lines())) == want
    quickstart.main(["--device", "cpu"])
    assert "ring all-gather matches reference: True" in capsys.readouterr().out


def test_pallas_collectives_equal_reference_oracles(capsys):
    results = pallas_collectives.run("cpu")
    assert sorted(results) == sorted(
        [f"all_gather {v}" for v in ("pcpy", "b2b", "bcst", "bcst_b2b")]
        + [f"all_to_all {v} n={n}" for v in ("per_round", "b2b") for n in (8, 6)])
    for name, (x, y) in results.items():
        if name.startswith("all_gather"):
            n = pallas_collectives.N
            want = np.asarray(jax_all_gather_ref(jnp.asarray(x), n))
            want = np.broadcast_to(want, (n,) + want.shape)
        else:
            want = np.asarray(jax_all_to_all_ref(jnp.asarray(x)))
        assert np.array_equal(y, want), name
    pallas_collectives.main(["--device", "cpu"])
    assert "all kernel variants validated against oracles" in capsys.readouterr().out


def test_train_lm_steps_and_checkpoint_round_trip():
    hist, same = train_lm.run(3, device="cpu", log=lambda _: None)
    assert same
    assert [h["step"] for h in hist] == [0, 2]
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist)


def test_serve_kv_cache_hits_give_miss_tokens(monkeypatch):
    """At batch 2 x context 32, 4 new tokens (the card runs the reference's
    4 x 192, 24: chip_smoke.py)."""
    monkeypatch.setattr(serve_kv_cache, "B", 2)
    monkeypatch.setattr(serve_kv_cache, "CTX", 32)
    monkeypatch.setattr(serve_kv_cache, "NEW", 4)
    results = serve_kv_cache.run("cpu")
    miss = results["miss"]
    assert miss.request_stats[0].fetch_modeled_s == 0.0
    for backend in serve_kv_cache.BACKENDS:
        res = results[backend]
        assert (res.tokens == miss.tokens).all()
        assert res.request_stats[0].fetch_modeled_s > 0
    assert results["b2b"].request_stats[0].fetch_modeled_s < \
        results["pcpy"].request_stats[0].fetch_modeled_s


def test_twins_run_on_the_card_unless_asked(monkeypatch):
    """Without a card every twin's entry point raises unless the caller
    passes ``--device cpu``; there is no silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (quickstart.main, pallas_collectives.main, serve_kv_cache.main,
                 tpu_collectives.main, latte_moe_wire.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        roofline_table.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k"])
