"""Simulator hot-path microbenchmark (DESIGN.md §8.2/§8.3) + CI perf guard.

Chunking (§8.1) multiplies event counts 10-100x: a 4GB all-to-all on the
8-GPU MI300X box is ~7000 commands instead of ~60.  This benchmark times the
overhauled simulator (heap-based event queue, append-only coalescing
timelines, closed-form chunk runs) against the **pre-overhaul simulator**
(vendored below: per-command execution, non-coalescing timelines, scan-based
worklist — the PR-2 core) on the same chunked schedules, and asserts a >=5x
speedup on the reference chunked 8-device GB-scale all-to-all sweep.

``--check`` (CI) additionally enforces a wall-clock budget on the new
simulator's sweep and writes a JSON report next to the dispatch-sweep cache
(``$REPRO_DISPATCH_CACHE``, falling back to the untracked ``artifacts/``
directory) so the perf numbers ride the same artifact.

``--sweep`` times the other perf-guarded layer (DESIGN.md §11.3): the
vectorized dispatch-sweep fast path (representative-only builds) against
the historical per-point loop (full schedule build + ``simulate()`` per
(variant, size, chunk) point) on the 64-device TPU multislice all-gather
sweep — the derivation the v6 multi-node tables depend on.  Latencies are
asserted bit-identical point by point; ``--sweep --check`` enforces the
>=5x throughput floor and a wall budget on the fast path.

``--composed`` guards the §12 multi-schedule composition path: K
staggered chunked GB-scale streams through ``run_composed`` must cost no
more than a small constant factor over the sum of K isolated full-loop
``simulate()`` runs.  Tag namespacing memoizes per command *object*, so a
regression that breaks §8.3 identity-run sharing (every chunk becoming its
own event) blows the ratio up by orders of magnitude — this floor is the
tripwire.  K=1 is asserted bit-identical to ``simulate`` while at it.

Both simulators produce the same latencies (asserted per scenario): the
overhaul changes data structures, not semantics.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

from repro_torch.core.backend import _SWEEP_CHUNKS, _SWEEP_SIZES
from repro_torch.core.dma import (alltoall_schedule, mi300x_platform,
                            run_composed, simulate)
from repro_torch.core.dma.collectives import allgather_schedule
from repro_torch.core.dma.commands import DATA_KINDS, CmdKind
from repro_torch.core.dma.dispatch import candidate_variants
from repro_torch.core.dma.faults import FaultPlan
from repro_torch.core.dma.sweep import sweep_variant_latencies
from repro_torch.core.dma.topology import tpu_v5e_multislice

GB = 1024 * 1024 * 1024

#: Reference scenario for the perf guard: chunked 8-device GB-scale
#: all-to-all, baseline and optimized streams, full (non-symmetric) sim.
SCENARIOS = tuple(
    (size, variant)
    for size in (1 * GB, 2 * GB, 4 * GB)
    for variant in ("pcpy", "opt_pcpy"))

MIN_SPEEDUP = 5.0        # acceptance floor; the overhaul lands far above
BUDGET_S = 2.5           # --check: new-sim wall budget for the whole sweep

#: --sweep acceptance floor (DESIGN.md §11.3): the vectorized fast path
#: must beat the per-point loop >=5x on the tpu64 all-gather sweep (it
#: lands far above — the per-device build work it deletes grows linearly
#: with device count), inside a wall budget that keeps CI honest.
SWEEP_MIN_SPEEDUP = 5.0
SWEEP_BUDGET_S = 2.0

#: --composed acceptance: run_composed over K concurrent chunked GB-scale
#: streams vs the sum of K isolated simulate() walls.  Composition adds
#: work (one shared world serializes more events than K private ones), so
#: the guard is an overhead *ceiling*, not a speedup floor.
COMPOSED_MAX_OVERHEAD = 2.5
COMPOSED_BUDGET_S = 3.0

#: Fault-hook acceptance (DESIGN.md §13.1): an *empty* FaultPlan is
#: normalized to the untouched fault-free path, so passing one must be
#: bit-identical AND essentially free — the guard caps the wall-clock
#: ratio of the empty-plan run over the plain run on the reference
#: scenario.  A regression here means fault threading leaked work into
#: the fault-free event loop.
FAULT_MAX_OVERHEAD = 1.05

#: Trace-hook acceptance (DESIGN.md §14): ``record_trace=False`` (the
#: default) must leave the hot path structurally untouched — every hook is
#: an ``if tr is not None`` branch off a local.  The guard caps the
#: wall-clock ratio of an explicit ``record_trace=False`` run over the
#: plain call on the reference scenario.  A regression here means trace
#: threading leaked work into the unrecorded event loop.
TRACE_MAX_OVERHEAD = 1.02

#: CU-resource acceptance (DESIGN.md §15): the compute-collective overlap
#: work adds a ``cu:{dev}`` timeline and a COMPUTE branch to the event
#: loop, but an *unfused* schedule must not pay for it.  The guard pairs
#: the reference chunked scenario against the same schedule carrying one
#: prelaunched 1-FLOP COMPUTE probe (which instantiates the CU timeline
#: and exercises the branch without perturbing the latency — asserted
#: bit-identical) and caps the wall-clock ratio.  A regression here means
#: CU plumbing leaked work into the per-command hot path.
CU_MAX_OVERHEAD = 1.02


# --------------------------------------------------------------------------
# Pre-overhaul simulator (vendored PR-2 core, trimmed): per-command event
# loop, non-coalescing interval timelines, scan-based blocked-queue worklist.
# Kept verbatim-in-spirit so the speedup is measured against the real thing.
# --------------------------------------------------------------------------

class _LegacyTimeline:
    __slots__ = ("free", "busy", "intervals")

    def __init__(self):
        self.free = 0.0
        self.busy = 0.0
        self.intervals = []

    def acquire(self, t, dur):
        start = t if t > self.free else self.free
        end = start + dur
        self.free = end
        if dur > 0.0:
            self.busy += dur
            self.intervals.append((start, end))
        return start, end


class _LegacyQueueState:
    __slots__ = ("q", "idx", "issue", "seen_data", "last_end", "copy_end", "start")

    def __init__(self, q, start):
        self.q = q
        self.idx = 0
        self.start = start
        self.issue = start
        self.seen_data = False
        self.last_end = start
        self.copy_end = start


class _LegacySim:
    def __init__(self, topo):
        self.topo = topo
        self.calib = topo.calib
        self.timelines = {}
        self.tags = {}
        self.host_signals = defaultdict(list)
        self.fused_signals = defaultdict(list)

    def timeline(self, key):
        tl = self.timelines.get(key)
        if tl is None:
            tl = self.timelines[key] = _LegacyTimeline()
        return tl

    def transfer(self, src, dst, size, start):
        c = self.calib
        eff = c.dma_link_efficiency
        if src == "host" or dst == "host":
            dev = dst if src == "host" else src
            dirn = "h2d" if src == "host" else "d2h"
            tl = self.timeline(f"hostlink:{dev}:{dirn}")
            _, end = tl.acquire(start, size / (self.topo.host_link_bw * eff))
            return end
        wire = size / (self.topo.link_bw * eff)
        t = start
        end = start
        for h, (a, b) in enumerate(self.topo.route(src, dst)):
            req = t if h == 0 else t + c.hop_latency
            s, end = self.timeline(f"link:{a}>{b}").acquire(req, wire)
            t = s
        return end

    def advance(self, st):
        c = self.calib
        cmds = st.q.commands
        while st.idx < len(cmds):
            cmd = cmds[st.idx]
            kind = cmd.kind
            if kind is CmdKind.WAIT:
                t = self.tags.get(cmd.tag)
                if t is None:
                    return False
                arrival = t + c.poll_trigger
                if arrival > st.issue:
                    st.issue = arrival
            elif kind is CmdKind.POLL:
                pass
            elif kind is CmdKind.SIGNAL:
                t = max(st.issue, st.last_end) + c.sync_engine
                if cmd.tag is not None:
                    st.issue = t
                    self.tags[cmd.tag] = t
                else:
                    self.host_signals[st.q.device].append(t)
            elif kind in DATA_KINDS:
                st.issue += c.b2b_issue if st.seen_data else c.copy_setup
                st.seen_data = True
                if kind is CmdKind.SWAP:
                    stream_bytes = 2 * cmd.size
                else:
                    stream_bytes = max(cmd.local_read_bytes, cmd.remote_write_bytes)
                engine = self.timeline(f"engine:{st.q.device}.{st.q.engine}")
                start = max(st.issue, engine.free)
                _, end = engine.acquire(start, stream_bytes / c.engine_bw)
                for dst in cmd.dsts:
                    end = max(end, self.transfer(cmd.src, dst, cmd.size, start))
                if kind is CmdKind.SWAP:
                    end = max(end, self.transfer(cmd.dsts[0], cmd.src, cmd.size, start))
                st.last_end = max(st.last_end, end)
                st.copy_end = max(st.copy_end, end)
                if cmd.fused_tag is not None:
                    self.tags[cmd.fused_tag] = end + c.fused_sync
                if cmd.fused_signal:
                    self.fused_signals[st.q.device].append(end + c.fused_sync)
            st.idx += 1
        return True


def _legacy_control_cost(live, c):
    t = 0.0
    room = 0
    for q in live:
        if q.batch <= 1:
            t += len(q.commands) * c.control
            room = 0
            continue
        for _ in q.commands:
            if room == 0:
                t += c.control
                room = q.batch - 1
            else:
                t += c.control_batched
                room -= 1
    return t


def _legacy_start_device(sim, dev, queues):
    c = sim.topo.calib
    live = [q for q in queues if not q.prelaunched]
    pre = [q for q in queues if q.prelaunched]
    host = sim.timeline(f"host:{dev}")
    t_control = _legacy_control_cost(live, c)
    host.acquire(0.0, t_control)
    states = []
    batched_seen = False
    for q in live:
        bell_cost = c.doorbell_batched if q.batch > 1 and batched_seen else c.doorbell
        batched_seen = q.batch > 1
        _, bell = host.acquire(host.free, bell_cost)
        sim.timeline(f"engine:{dev}.{q.engine}").acquire(bell, c.fetch)
        states.append(_LegacyQueueState(q, bell + c.fetch))
    for q in pre:
        states.append(_LegacyQueueState(q, c.poll_trigger))
    return t_control, states


def _legacy_finish_device(sim, dev, t_control, states):
    c = sim.topo.calib
    sched_end = max((st.start for st in states), default=t_control)
    copy_end = max((st.copy_end for st in states), default=sched_end)
    sigs = sim.host_signals.get(dev, [])
    fused = sim.fused_signals.get(dev, [])
    t_obs = len(sigs) * c.sync_obs
    if fused:
        t_obs += c.sync_obs + (len(fused) - 1) * c.sync_obs_batched
    signal_done = max([copy_end] + sigs + fused)
    _, total = sim.timeline(f"host:{dev}").acquire(signal_done, t_obs)
    return total


def legacy_simulate(schedule, topo):
    """Pre-overhaul full simulation; returns end-to-end latency (seconds)."""
    sim = _LegacySim(topo)
    devices = schedule.devices
    started = {d: _legacy_start_device(sim, d, schedule.queues_for(d))
               for d in devices}
    pending = [st for _, states in started.values() for st in states]
    while pending:                      # scan-based worklist: O(passes x queues)
        progressed = False
        still = []
        for st in pending:
            before = st.idx
            if not sim.advance(st):
                still.append(st)
            progressed = progressed or st.idx != before or st not in still
        if not progressed:
            raise RuntimeError("deadlocked schedule")
        pending = still
    return max(_legacy_finish_device(sim, d, t, states)
               for d, (t, states) in started.items())


# --------------------------------------------------------------------------


def _wall(fn, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _paired_overheads(base, variants, reps=9, inner=3):
    """Wall-clock ratio of each variant over ``base``, noise-robust.

    Each rep times base and variants back-to-back (``inner`` calls per
    sample so one sample outlasts scheduler jitter) and forms per-rep
    ratios; the *minimum* ratio across reps is reported.  A genuine
    structural overhead inflates every pair, so the min still catches it;
    a load spike inflates only the pairs it lands on, so the min discards
    it — unlike min-of-walls taken in separate phases, where a spike
    during one phase skews the ratio permanently."""
    best = [float("inf")] * len(variants)
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            base()
        t_base = time.perf_counter() - t0
        for i, fn in enumerate(variants):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            ratio = (time.perf_counter() - t0) / t_base
            if ratio < best[i]:
                best[i] = ratio
    return best


def run(verbose: bool = True) -> dict:
    topo = mi300x_platform()
    scenarios = []
    new_total = legacy_total = 0.0
    for size, variant in SCENARIOS:
        sched = alltoall_schedule(topo, size, variant)
        n_cmds = sched.total_commands()
        lat_new = simulate(sched, topo, symmetric=False).latency
        lat_old = legacy_simulate(sched, topo)
        if abs(lat_new - lat_old) > 1e-9 + 1e-6 * lat_old:
            raise AssertionError(
                f"overhauled sim diverged from pre-overhaul reference on "
                f"{variant}@{size}: {lat_new} vs {lat_old}")
        t_new = _wall(lambda: simulate(sched, topo, symmetric=False))
        t_old = _wall(lambda: legacy_simulate(sched, topo))
        new_total += t_new
        legacy_total += t_old
        scenarios.append({
            "size": size, "variant": variant, "commands": n_cmds,
            "latency_s": lat_new, "wall_new_s": t_new, "wall_legacy_s": t_old,
            "speedup": t_old / t_new,
        })
        if verbose:
            print(f"  {variant:>9} @{size // GB}GB: {n_cmds:5d} cmds  "
                  f"new {t_new * 1e3:7.2f}ms  legacy {t_old * 1e3:7.2f}ms  "
                  f"{t_old / t_new:6.1f}x")
    speedup = legacy_total / new_total

    # Fault-hook overhead (§13.1): empty plan must be bit-identical and free.
    sched = alltoall_schedule(topo, SCENARIOS[0][0], SCENARIOS[0][1])
    plain = simulate(sched, topo, symmetric=False)
    empty = simulate(sched, topo, symmetric=False, faults=FaultPlan())
    if plain.latency != empty.latency or empty.fault_report is not None:
        raise AssertionError(
            "empty FaultPlan diverged from the fault-free run: "
            f"{empty.latency} vs {plain.latency}")
    # Trace-hook overhead (§14): record_trace=False must be free (and is
    # trivially bit-identical — it takes the same code path).
    untraced = simulate(sched, topo, symmetric=False, record_trace=False)
    if plain.latency != untraced.latency or untraced.trace is not None:
        raise AssertionError(
            "record_trace=False diverged from the plain run: "
            f"{untraced.latency} vs {plain.latency}")
    # CU-resource overhead (§15): a prelaunched 1-FLOP COMPUTE probe
    # instantiates the cu:{dev} timeline and runs the COMPUTE branch once;
    # the GB-scale transfer latency must be untouched by it.
    import dataclasses as _dc

    from repro_torch.core.dma.commands import EngineQueue
    from repro_torch.core.dma import commands as _cmd
    probe = EngineQueue(sched.queues[0].device, topo.n_engines,
                        (_cmd.poll(), _cmd.compute(1)), prelaunched=True)
    cu_sched = _dc.replace(sched, queues=sched.queues + (probe,))
    cu_probe = simulate(cu_sched, topo, symmetric=False)
    if plain.latency != cu_probe.latency:
        raise AssertionError(
            "the CU compute probe perturbed the unfused latency: "
            f"{cu_probe.latency} vs {plain.latency}")
    fault_overhead, trace_overhead, cu_overhead = _paired_overheads(
        lambda: simulate(sched, topo, symmetric=False),
        [lambda: simulate(sched, topo, symmetric=False, faults=FaultPlan()),
         lambda: simulate(sched, topo, symmetric=False, record_trace=False),
         lambda: simulate(cu_sched, topo, symmetric=False)])

    report = {
        "scenarios": scenarios,
        "wall_new_s": new_total,
        "wall_legacy_s": legacy_total,
        "speedup": speedup,
        "min_speedup": MIN_SPEEDUP,
        "budget_s": BUDGET_S,
        "fault_overhead": fault_overhead,
        "fault_max_overhead": FAULT_MAX_OVERHEAD,
        "trace_overhead": trace_overhead,
        "trace_max_overhead": TRACE_MAX_OVERHEAD,
        "cu_overhead": cu_overhead,
        "cu_max_overhead": CU_MAX_OVERHEAD,
    }
    if verbose:
        print(f"chunked 8-device GB-scale all-to-all sweep: "
              f"{speedup:.1f}x speedup (floor {MIN_SPEEDUP}x), "
              f"new-sim wall {new_total:.3f}s (budget {BUDGET_S}s)")
        print(f"empty-FaultPlan overhead on the fault-free path: "
              f"{fault_overhead:.3f}x (ceiling {FAULT_MAX_OVERHEAD}x, "
              f"bit-identical asserted)")
        print(f"record_trace=False overhead on the unrecorded path: "
              f"{trace_overhead:.3f}x (ceiling {TRACE_MAX_OVERHEAD}x, "
              f"bit-identical asserted)")
        print(f"CU-resource overhead on the unfused path: "
              f"{cu_overhead:.3f}x (ceiling {CU_MAX_OVERHEAD}x, "
              f"bit-identical asserted)")
    return report


def run_sweep(verbose: bool = True) -> dict:
    """Time the vectorized dispatch sweep against the per-point loop
    (DESIGN.md §11.3) on the tpu64 all-gather derivation, asserting
    bit-identity point by point."""
    topo = tpu_v5e_multislice(64)
    sizes = tuple(_SWEEP_SIZES)
    variants = candidate_variants(topo, "all_gather", allow_pipelined=True,
                                  allow_optimized=True)
    candidates = [(v, ch) for v in variants for ch in _SWEEP_CHUNKS]

    t0 = time.perf_counter()
    fast = {}
    for v, ch in candidates:
        lats = sweep_variant_latencies(topo, "all_gather", sizes, v, ch)
        assert lats is not None, f"{v} lost the symmetric fast path on tpu64"
        fast[(v, ch)] = lats
    t_fast = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref = {}
    for v, ch in candidates:
        ref[(v, ch)] = [
            simulate(allgather_schedule(topo, s, v, max_chunk_bytes=ch),
                     topo).latency
            for s in sizes]
    t_ref = time.perf_counter() - t0

    for key in candidates:
        if fast[key] != ref[key]:
            raise AssertionError(
                f"vectorized sweep diverged from per-point loop on {key}")

    n_points = len(candidates) * len(sizes)
    speedup = t_ref / t_fast
    report = {
        "topology": topo.name,
        "collective": "all_gather",
        "points": n_points,
        "wall_fast_s": t_fast,
        "wall_per_point_s": t_ref,
        "speedup": speedup,
        "min_speedup": SWEEP_MIN_SPEEDUP,
        "budget_s": SWEEP_BUDGET_S,
    }
    if verbose:
        print(f"tpu64 all-gather dispatch sweep ({n_points} points): "
              f"fast {t_fast:.3f}s  per-point {t_ref:.3f}s  "
              f"{speedup:.1f}x speedup (floor {SWEEP_MIN_SPEEDUP}x, "
              f"fast-path budget {SWEEP_BUDGET_S}s)")
    return report


def run_composed_bench(verbose: bool = True) -> dict:
    """Time the §12 composition path: K staggered GB-scale chunked streams
    in one world vs K isolated full-loop runs, plus the K=1 identity."""
    topo = mi300x_platform()
    streams = [alltoall_schedule(topo, 1 * GB, v)
               for v in ("pcpy", "opt_pcpy", "pcpy", "opt_pcpy", "pcpy",
                         "opt_pcpy")]
    releases = [k * 1e-4 for k in range(len(streams))]

    one = simulate(streams[0], topo, symmetric=False)
    k1 = run_composed([streams[0]], topo)
    if (k1.result.latency != one.latency
            or k1.result.per_device != one.per_device):
        raise AssertionError("run_composed K=1 diverged from simulate()")

    t_iso = sum(_wall(lambda s=s: simulate(s, topo, symmetric=False))
                for s in streams)
    t_comp = _wall(lambda: run_composed(streams, topo, releases))
    comp = run_composed(streams, topo, releases)
    overhead = t_comp / t_iso
    report = {
        "streams": len(streams),
        "wall_isolated_sum_s": t_iso,
        "wall_composed_s": t_comp,
        "overhead": overhead,
        "makespan_s": comp.makespan,
        "max_overhead": COMPOSED_MAX_OVERHEAD,
        "budget_s": COMPOSED_BUDGET_S,
    }
    if verbose:
        print(f"composed {len(streams)}-stream GB-scale all-to-all: "
              f"composed {t_comp * 1e3:.1f}ms vs isolated-sum "
              f"{t_iso * 1e3:.1f}ms -> {overhead:.2f}x overhead "
              f"(ceiling {COMPOSED_MAX_OVERHEAD}x, budget {COMPOSED_BUDGET_S}s)")
    return report


def _json_path(name: str = "sim_perf.json") -> str:
    """Report destination: the dispatch-sweep cache dir when set, else the
    untracked ``artifacts/`` directory — never the repo root, where a stale
    report reads like a committed result (tools/check_docs.py guards that
    no benchmark artifact ever becomes tracked)."""
    cache_dir = os.environ.get("REPRO_DISPATCH_CACHE") or "artifacts"
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--check", action="store_true",
                   help="CI perf guard: fail when the speedup floor or the "
                        "wall-clock budget is violated; write the JSON "
                        "report next to the dispatch-sweep cache")
    p.add_argument("--json", default=None,
                   help="explicit JSON report path (default: "
                        "$REPRO_DISPATCH_CACHE/sim_perf.json, falling back "
                        "to artifacts/sim_perf.json; sim_perf_sweep.json "
                        "with --sweep)")
    p.add_argument("--composed", action="store_true",
                   help="benchmark the multi-schedule composition path "
                        "(run_composed, DESIGN.md §12) against the sum of "
                        "isolated simulate() runs and enforce the overhead "
                        "ceiling with --check")
    p.add_argument("--sweep", action="store_true",
                   help="benchmark the vectorized dispatch-sweep fast path "
                        "against the per-point loop on tpu64 (DESIGN.md "
                        "§11.3) instead of the simulator hot path")
    args = p.parse_args(argv)
    if args.composed:
        report = run_composed_bench()
        if args.check or args.json:
            path = args.json or _json_path("sim_perf_composed.json")
            with open(path, "w") as f:
                json.dump(report, f, indent=1)
            print(f"wrote {path}")
        if not args.check:
            return 0
        ok = True
        if report["overhead"] > COMPOSED_MAX_OVERHEAD:
            print(f"FAIL: composed overhead {report['overhead']:.2f}x exceeds "
                  f"{COMPOSED_MAX_OVERHEAD}x ceiling")
            ok = False
        if report["wall_composed_s"] > COMPOSED_BUDGET_S:
            print(f"FAIL: composed wall {report['wall_composed_s']:.3f}s "
                  f"exceeds {COMPOSED_BUDGET_S}s budget")
            ok = False
        return 0 if ok else 1
    if args.sweep:
        report = run_sweep()
        if args.check or args.json:
            path = args.json or _json_path("sim_perf_sweep.json")
            with open(path, "w") as f:
                json.dump(report, f, indent=1)
            print(f"wrote {path}")
        if not args.check:
            return 0
        ok = True
        if report["speedup"] < SWEEP_MIN_SPEEDUP:
            print(f"FAIL: sweep speedup {report['speedup']:.1f}x < "
                  f"{SWEEP_MIN_SPEEDUP}x floor")
            ok = False
        if report["wall_fast_s"] > SWEEP_BUDGET_S:
            print(f"FAIL: fast-path wall {report['wall_fast_s']:.3f}s "
                  f"exceeds {SWEEP_BUDGET_S}s budget")
            ok = False
        return 0 if ok else 1
    report = run()
    if args.check or args.json:
        path = args.json or _json_path()
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {path}")
    if not args.check:
        return 0
    ok = True
    if report["speedup"] < MIN_SPEEDUP:
        print(f"FAIL: speedup {report['speedup']:.1f}x < {MIN_SPEEDUP}x floor")
        ok = False
    if report["wall_new_s"] > BUDGET_S:
        print(f"FAIL: new-sim wall {report['wall_new_s']:.3f}s exceeds "
              f"{BUDGET_S}s budget")
        ok = False
    if report["fault_overhead"] > FAULT_MAX_OVERHEAD:
        print(f"FAIL: empty-FaultPlan overhead "
              f"{report['fault_overhead']:.3f}x exceeds "
              f"{FAULT_MAX_OVERHEAD}x ceiling")
        ok = False
    if report["trace_overhead"] > TRACE_MAX_OVERHEAD:
        print(f"FAIL: record_trace=False overhead "
              f"{report['trace_overhead']:.3f}x exceeds "
              f"{TRACE_MAX_OVERHEAD}x ceiling")
        ok = False
    if report["cu_overhead"] > CU_MAX_OVERHEAD:
        print(f"FAIL: CU-resource overhead {report['cu_overhead']:.3f}x "
              f"exceeds {CU_MAX_OVERHEAD}x ceiling")
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
