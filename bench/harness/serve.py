"""One run of a serving cell: set-up, the measured window, the trace, the check.

Set-up builds the port's ``ServeEngine`` over the benchmark's weights, fills
the host store where the mix revisits, and warms up the cell's shapes with
``WARM_BATCHES`` whole batches.  The window is a closed loop of whole
``ServeEngine.generate`` batches until ``seconds`` have passed.  With
``trace`` the profiler records ``TRACE_BATCHES`` whole batches after the
first ``TRACE_SKIP`` (three batches hold the fetch, the rebuild and 48 decode
steps, and keep the run's trace to some 10^5 events); the host-clock
per-layer metrics then read the window's other batches, which ran untraced.
After the window the engine is freed, but for the host store's blocks of the
checked requests' contexts, and the reference checks a sample of the served
requests and those contexts (``check.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import sys
import time

import numpy as np
import torch

from bench.harness import check, flops, model, registry, traffic
from bench.harness import trace as tr
from bench.reference.model import capacity

WARM_BATCHES = 2
TRACE_SKIP = 2
TRACE_BATCHES = 3


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@dataclasses.dataclass
class Record:
    batch: traffic.Batch
    tokens: np.ndarray          # [batch, new_tokens] as served
    hits: list[bool]
    ttft_s: float               # the batch's time to first token: every request's
    decode_s: float             # the other new_tokens - 1 steps
    start: float
    end: float
    traced: bool


@dataclasses.dataclass
class Run:
    """What a per-layer reader (``bench/metrics/*.py``) reads."""
    config: dict
    mix: traffic.Mix
    records: list[Record]
    trace: tr.Trace | None

    @property
    def timed(self) -> list[Record]:
        """The window's batches that ran without the profiler."""
        return [r for r in self.records if not r.traced]

    def flops(self, rec: Record) -> tuple[float, float]:
        return flops.generate_flops(self.config, len(rec.hits), self.mix.prompt_tokens,
                                    self.mix.new_tokens, all(rec.hits))


def p90(values: list[float]) -> float:
    """The nearest-rank 90th percentile."""
    ordered = sorted(values)
    return ordered[math.ceil(0.9 * len(ordered)) - 1]


# the numbers a cell's limits file may compare, each read from the check's
# (served tokens' logit gaps, saved contexts' errors [request][layer]); a
# cell compares at least one number of each group of REQUIRED
NUMBERS = {"mean_logit_gap": lambda gaps, errs: sum(gaps) / len(gaps),
           "max_logit_gap": lambda gaps, errs: max(gaps),
           "saved_kv_rel_err": lambda gaps, errs: max(max(e) for e in errs),
           "saved_kv_rel_err_first": lambda gaps, errs: max(e[0] for e in errs)}
REQUIRED = (("mean_logit_gap",), ("saved_kv_rel_err", "saved_kv_rel_err_first"))


def compare(gaps: list[float], errs: list[list[float]], limits: dict) -> tuple[dict, bool]:
    """Each number ``limits`` names beside its limit, and whether all hold
    (and each group of ``REQUIRED`` has a number with a limit)."""
    compared = {n: {"value": NUMBERS[n](gaps, errs), "limit": limits[n]}
                for n in NUMBERS if n in limits}
    ok = all(any(n in compared for n in group) for group in REQUIRED) and all(
        c["value"] <= c["limit"] for c in compared.values())
    return compared, ok


def by_layer(errs: list[list[float]]) -> list[float]:
    """The saved contexts' worst error at each layer."""
    return [max(col) for col in zip(*errs)]


def limits_for(workload: str) -> dict:
    """``bench/limits/<workload>.json``: the limit of each number compared."""
    path = registry.BENCH / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def _profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    return profile(activities=acts)


def end_to_end(run: Run, setup_s: float) -> dict:
    """The end-to-end metrics a cell can report, over the whole window."""
    recs = run.records
    miss = [r.ttft_s * 1e3 for r in recs for h in r.hits if not h]
    out = {"setup_s": setup_s,
           "output_tok_s": sum(r.tokens.size for r in recs) / (recs[-1].end - recs[0].start)}
    if miss:
        out["ttft_miss_ms_p90"] = p90(miss)
    return out


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: float | None = None, control: bool = False,
             limits: dict | None = None) -> dict:
    """Runs ``cell`` and returns the result line (as a dict).  ``t0`` is when
    set-up began (default: now); ``limits`` replaces
    ``bench/limits/<cell>.json``'s; ``control`` also reads the float8
    reference on the same sample and judges it by the same limits
    (``run["control"]``)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = cell.config
    mix = traffic.Mix(cell.traffic, cfg["vocab_size"], seed)
    if mix.prompt_tokens + mix.new_tokens > cfg["max_position_embeddings"]:
        raise ValueError(f"{cell.name}: {mix.prompt_tokens} + {mix.new_tokens} tokens exceed "
                         f"{cfg['name']}'s {cfg['max_position_embeddings']} positions")
    if cfg["family"] == "moe" and capacity(cfg, mix.batch) < mix.batch:
        raise ValueError(f"{cell.name}: a decode call of {mix.batch} tokens can drop "
                         "expert choices; the reference routes decode steps without a capacity")
    if cuda:
        torch.empty(1, device=dev)
        log(f"CUDA context {_clock(dev) - t0:.3f} s")
    weights = model.make_weights(cfg, seed, dev)
    log(f"weights {_clock(dev) - t0:.3f} s")
    engine = ServeEngine(build_model(model.arch_config(cfg)), weights, device=dev)
    log(f"engine {time.perf_counter() - t0:.3f} s")
    if mix.hit:
        for keys, prompts in mix.fill():
            engine.first_token(prompts, keys)
        log(f"pool of {mix.pool} saved {time.perf_counter() - t0:.3f} s")
    for i in range(WARM_BATCHES):
        b = mix.batch_at(i, "warm")
        engine.generate(b.prompts, b.keys, mix.new_tokens)
    start = _clock(dev)
    setup_s = start - t0
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    to_trace = range(TRACE_SKIP, TRACE_SKIP + TRACE_BATCHES) if trace else range(0)
    records, prof = [], None
    i = 0
    while True:
        b = mix.batch_at(i)
        if i in to_trace and prof is None:
            prof = _profiler(dev)
            prof.__enter__()
        span = (torch.profiler.record_function(tr.BATCH_SPAN) if i in to_trace
                else contextlib.nullcontext())
        t_a = _clock(dev)
        with span:
            res = engine.generate(b.prompts, b.keys, mix.new_tokens)
        t_b = _clock(dev)
        records.append(Record(b, res.tokens, [s.cache_hit for s in res.request_stats],
                              res.request_stats[0].ttft_wall_s * len(b.keys),
                              res.decode_wall_s, t_a, t_b, i in to_trace))
        if to_trace and i == to_trace[-1]:
            prof.__exit__(None, None, None)
        i += 1
        if t_b - start >= seconds and (not to_trace or i > to_trace[-1]):
            break
    window_s = records[-1].end - start
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    plan = mix.check_plan([r.batch for r in records])
    held = [[_held(engine.store, records[bi].batch.keys[row]) for _, bi, row in chk.requests]
            for chk in plan]
    del engine, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"window {window_s:.3f} s, {len(records)} batches")

    run = Run(cfg, mix, records, tr.from_profiler(prof) if prof is not None else None)
    t_check = time.perf_counter()
    gaps, errs, control_gaps, control_errs, ref_drops = [], [], [], [], 0
    for chk, ctxs in zip(plan, held):
        got = check.call_gaps(cfg, weights, mix, chk,
                              [records[bi].tokens[row] for _, bi, row in chk.requests],
                              [check.saved_context(c, dev) for c in ctxs], dev, control)
        gaps.extend(got["gaps"].tolist())
        errs.extend(got["saved_errors"])
        control_gaps.extend(got.get("control_gaps", np.zeros(0)).tolist())
        control_errs.extend(got.get("control_saved_errors", []))
        ref_drops += got["ref_drops"]
    check_s = time.perf_counter() - t_check
    wrong_kind = sum(h != mix.hit for r in records for h in r.hits)
    out_of_vocab = sum(int(((r.tokens < 0) | (r.tokens >= cfg["vocab_size"])).sum())
                       for r in records)
    limits = limits_for(cell.name) if limits is None else limits
    compared, held_ok = compare(gaps, errs, limits)
    correct = held_ok and wrong_kind == 0 and out_of_vocab == 0

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(run, setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": sum(len(r.hits) for r in records),
              "failed": int(wrong_kind), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if run.trace is not None:
        lo, hi = run.trace.span
        result["device"]["busy_s"] = tr.busy_ns(run.trace, lo, hi) / 1e9
        result["device"]["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = {"device_ops": tr.device_ops(run.trace),
                               "idle_gaps": tr.idle_gaps(run.trace)}
    ttft = sorted(r.ttft_s for r in records)
    spans = sorted(r.end - r.start for r in records)
    result["run"] = {"seed": seed, "batches": len(records), "window_s": window_s,
                     "batch_ttft_s": [ttft[0], ttft[len(ttft) // 2], ttft[-1]],
                     "batch_s": [spans[0], spans[len(spans) // 2], spans[-1]],
                     "host_store_bytes": host_store_bytes(cfg, mix, len(records)),
                     "check_s": check_s, "checked_tokens": len(gaps),
                     "prefill_expert_drops": ref_drops, "gaps": gap_stats(gaps),
                     "saved_errors_by_layer": by_layer(errs)}
    if control:
        ctl_compared, ctl_ok = compare(control_gaps, control_errs, limits)
        result["run"]["control"] = {"correct": ctl_ok, "checks": ctl_compared,
                                    "gaps": gap_stats(control_gaps),
                                    "saved_errors_by_layer": by_layer(control_errs)}
    result["checks"] = {**compared,
                        "wrong_cache_kind": {"value": wrong_kind, "limit": 0},
                        "tokens_out_of_vocab": {"value": out_of_vocab, "limit": 0}}
    return result


def _held(store, key: str):
    """The host store's blocks of ``key``, held past the engine, or None."""
    return store.host_blocks(key) if key in store else None


def gap_stats(gaps: list[float]) -> dict:
    """The widest gap, the mean, and the share of tokens off the reference's argmax."""
    return {"widest": max(gaps), "mean": sum(gaps) / len(gaps),
            "off_argmax_share": sum(g > 0 for g in gaps) / len(gaps)}


def host_store_bytes(cfg: dict, mix: traffic.Mix, window_batches: int) -> int:
    """Pinned bytes the host store holds at the window's end: the pool, or
    every saved context (the store never evicts)."""
    per = flops.stored_kv_bytes(cfg, mix.prompt_tokens)
    if mix.hit:
        return mix.pool * per
    return (WARM_BATCHES + window_batches) * mix.batch * per
