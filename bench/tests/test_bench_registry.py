"""Every piece of a cell is found by its name, an added file is picked up
with no edit, and BENCHMARK.json keeps to the benchmark's contract."""
import json
import re
import shutil

import pytest

from bench.harness import registry, serve, traffic

SPEC = registry.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# what ``reduced`` may cut: depth, never a width or the model's mathematics
DEPTH = {"num_hidden_layers"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((registry.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and len(cfg["why"]) <= 200
    assert cfg["file"] == f"bench/configs/{cfg['name']}.json"
    body = json.loads((registry.ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] and set(cfg["reduced"]) <= set(body)
    assert set(cfg["reduced"]) <= DEPTH
    # what the port fixes in code is stated beside the published value, not cut
    departures = body.get("port_departures", {})
    assert set(departures) <= set(body) - DEPTH and "port_departures" in body.get("assumed", {}) \
        or not departures


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and wl["chips"] == 1 and len(wl["why"]) <= 200
    cell = registry.cell(wl["name"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert all(m["moves"] in names for m in cell.per_layer)
    mix = traffic.Mix(cell.traffic, cell.config["vocab_size"], 1)
    assert mix.prompt_tokens + mix.new_tokens <= cell.config["max_position_embeddings"]
    limits = serve.limits_for(wl["name"])
    assert set(limits) <= set(serve.NUMBERS) | {"readings"}
    assert all(set(group) & set(limits) for group in serve.REQUIRED)
    # a mix names the public source of its lengths and lists what it cut from them
    assert cell.traffic["source"] and {"batch", "new_tokens"} <= set(cell.traffic["cuts"])


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert {w["config"] for w in SPEC["workloads"]} == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entry(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m["workloads"]) <= cells
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
    layers = {x["layer"] for x in SPEC["per_layer"]}
    assert m["layer"] in layers and "\n" not in m["layer"]
    # a reader that finds nothing to read returns nothing
    empty = serve.Run(registry.load_config(registry.config_file("olmoe-1b-7b")),
                      traffic.Mix(json.loads(registry.traffic_file("fresh-1k").read_text()),
                                  50304, 1), [], None)
    assert registry.metric_reader(m["name"])(empty) is None


def test_added_files_are_picked_up_without_an_edit(tmp_path):
    """A later PR adds a configuration, a mix, a metric and a cell as new
    files and entries; the harness finds them by name."""
    bench = tmp_path / "bench"
    shutil.copytree(registry.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads(registry.config_file("olmoe-1b-7b").read_text())
    cfg["name"] = "olmoe-1b-7b-copy"
    (bench / "configs" / "olmoe-1b-7b-copy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fresh-3k.json").write_text(json.dumps(
        {"kind": "fresh", "batch": 2, "prompt_tokens": 3000, "new_tokens": 8,
         "check_requests": 4}))
    (bench / "metrics" / "batches_read.py").write_text(
        "def read(run):\n    return float(len(run.records)) if run.records else None\n")
    spec["configs"].append({"name": "olmoe-1b-7b-copy", "source": cfg["source"],
                            "file": "bench/configs/olmoe-1b-7b-copy.json",
                            "reduced": cfg["reduced"], "why": "a copy"})
    spec["workloads"].append({"name": "olmoe-1b-7b-copy.fresh-3k", "config": "olmoe-1b-7b-copy",
                              "traffic": "fresh-3k", "chips": 1, "why": "added"})
    spec["per_layer"].append({"name": "batches_read", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "output_tok_s",
                              "workloads": ["olmoe-1b-7b-copy.fresh-3k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.cell("olmoe-1b-7b-copy.fresh-3k", bench=bench)
    assert cell.config["name"] == "olmoe-1b-7b-copy" and cell.traffic["prompt_tokens"] == 3000
    assert [m["name"] for m in cell.per_layer] == ["batches_read"]
    read = registry.metric_reader("batches_read", bench=bench)
    assert read(serve.Run(cell.config, None, [1, 2, 3], None)) == 3.0
    with pytest.raises(KeyError):
        registry.cell("no-such-cell", bench=bench)
