"""Finds every piece of a cell by its name in ``BENCHMARK.json``.

A configuration is ``bench/configs/<config>.json`` (``load_config``), a traffic mix
``bench/traffic/<traffic>.json`` and a per-layer metric the reader
``bench/metrics/<metric>.py`` (a function ``read(run)`` that returns the
value, or None where the run holds nothing to read).  A later cell or metric
is added by adding files and entries, with no edit here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple[dict, ...]     # the BENCHMARK.json entries this cell reports
    per_layer: tuple[dict, ...]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config_file(name: str, bench: Path = BENCH) -> Path:
    return bench / "configs" / f"{name}.json"


def traffic_file(name: str, bench: Path = BENCH) -> Path:
    return bench / "traffic" / f"{name}.json"


def metric_file(name: str, bench: Path = BENCH) -> Path:
    return bench / "metrics" / f"{name}.py"


def load_config(path: Path) -> dict:
    """A configuration file as it is run: its published values, with the
    values of its ``port_departures`` group (what the port fixes in code) in
    their place."""
    cfg = json.loads(path.read_text())
    return {**cfg, **cfg.get("port_departures", {})}


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, spec: dict | None = None, bench: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``spec`` (default: the repo's BENCHMARK.json)."""
    spec = spec or load_spec(bench.parent)
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{[w['name'] for w in spec['workloads']]}")
    w = found[0]
    e2e = tuple(m for m in spec["end_to_end"] if _reports(m, workload))
    names = {m["name"] for m in e2e}
    layer = tuple(m for m in spec["per_layer"] if _reports(m, workload) and m["moves"] in names)
    return Cell(name=workload,
                config=load_config(config_file(w["config"], bench)),
                traffic=json.loads(traffic_file(w["traffic"], bench).read_text()),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, bench: Path = BENCH):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = metric_file(name, bench)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
