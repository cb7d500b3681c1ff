"""The harness against its reference at tiny sizes on the CPU, for a hit and
a miss of both configurations, and the result line's schema."""
import json
import subprocess
import sys

import pytest

from bench.harness import registry, serve
from bench.tests import tiny

CASES = [(c, k) for c in ("olmoe-1b-7b", "qwen2-vl-72b-8l") for k in ("revisit", "fresh")]
# The limits at tiny widths.  Mean logit gap: the bf16 program reads at most
# 0.00015 on this file's seed, the faults of test_bench_faults.py at least
# 0.0047.  Saved context's error: the program reads 0.010-0.012 (qwen2-vl) and
# up to 0.19 (olmoe, whose routing near ties move a token's whole expert at
# 40 tokens a prompt), a dropped save 1.0 and a halved one 0.7.  The cells'
# limits come from full-width readings on the card (PERF.md)
TINY_LIMIT = 0.002
TINY_LIMITS = {"mean_logit_gap": TINY_LIMIT, "saved_kv_rel_err": 0.5}


def check_line(res: dict, trace: bool, cell) -> None:
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert json.loads(json.dumps(res)) == res
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(res["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
        assert got <= want      # on the CPU the trace holds no device time
    else:
        assert got == want
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("config,kind", CASES)
@pytest.mark.parametrize("trace", (False, True))
def test_tiny_run_is_correct(config, kind, trace):
    cell = tiny.cell(config, kind)
    res = serve.run_cell(cell, 2**31 + 9, 0.3, trace, device="cpu", limits=TINY_LIMITS)
    check_line(res, trace, cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] <= TINY_LIMIT
    assert len(res["run"]["saved_errors_by_layer"]) == cell.config["num_hidden_layers"]
    if kind == "revisit":
        assert res["run"]["host_store_bytes"] == 6 * 48 * 2 * 2 * cell.config["num_hidden_layers"] \
            * cell.config["num_key_value_heads"] * cell.config["head_dim"]


def test_a_required_number_without_a_limit_is_not_correct():
    res = serve.run_cell(tiny.cell("qwen2-vl-72b-8l", "fresh"), 2**31 + 9, 0.1, False,
                         device="cpu", limits={"mean_logit_gap": TINY_LIMIT})
    assert res["correct"] is False and "saved_kv_rel_err" not in res["checks"]


def test_percentile_is_nearest_rank():
    assert serve.p90(list(range(1, 11))) == 9
    assert serve.p90([5.0] * 8 + [9.0] * 2) == 9.0
    assert serve.p90(list(range(1, 41))) == 36


def test_run_fails_without_a_card():
    out = subprocess.run([sys.executable, str(registry.BENCH / "run.py"), "--workload",
                          "olmoe-1b-7b.revisit-4k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=registry.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
