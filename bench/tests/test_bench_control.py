"""The control (the reference in float8, in the program's place) reads far
above the bf16 program at tiny sizes too, and the harness's own comparison
judges it not correct: on every seed its mean logit gap is at least three
times the program's and above the tiny limit, and its saved contexts' error
above the program's.  At full width on the card the same
readings set each cell's limits, and the control came out not correct there
under them (PERF.md)."""
import pytest

from bench import control
from bench.tests import tiny
from bench.tests.test_bench_run import TINY_LIMIT, TINY_LIMITS

SEEDS = (101, 2**31 + 102, 103)


@pytest.mark.parametrize("config", ("olmoe-1b-7b", "qwen2-vl-72b-8l"))
@pytest.mark.parametrize("kind", ("revisit", "fresh"))
def test_control_is_not_correct(config, kind):
    rows = list(control.readings(tiny.cell(config, kind), SEEDS, set(SEEDS), 0.2, "cpu",
                                 TINY_LIMITS))
    assert [r["seed"] for r in rows] == list(SEEDS)
    for r in rows:
        ctl, run = r["control"], r["run"]
        assert ctl["correct"] is False, r
        assert ctl["gaps"]["mean"] >= 3 * run["gaps"]["mean"], r
        assert ctl["checks"]["mean_logit_gap"]["value"] > TINY_LIMIT, r
        assert max(ctl["saved_errors_by_layer"]) >= 1.2 * max(run["saved_errors_by_layer"]), r
        assert ctl["saved_errors_by_layer"][0] >= 3 * run["saved_errors_by_layer"][0], r
