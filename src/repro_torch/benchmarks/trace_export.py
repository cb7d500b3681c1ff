"""Chrome-trace export of recorded simulator runs (DESIGN.md §14).

Renders any schedule the simulator can run — baseline/``opt_``/``pipe_``
streams, hierarchical multi-node collectives, fault-injected runs with
watchdog retries, or a composed serving round — as Chrome ``trace_event``
JSON: one process per device, one thread per resource, flow arrows from
each tag raise to the waits it wakes.  Load the dump in ``ui.perfetto.dev``
or ``chrome://tracing``.

    PYTHONPATH=src python -m repro_torch.benchmarks.trace_export \
        --collective all_gather --variant hier_pipe --topo mi300x-2node \
        --size 4MB --out trace.json

``--faults`` injects a deterministic dropped signal (plus a straggler
engine) so the dump shows watchdog retry slices; ``--serving`` records one
composed round of the §12 serving loop instead of a single schedule.  The
``run()`` entry (repro_torch.benchmarks.run registry) checks the §14 contract: recorded
and unrecorded runs are latency-bit-identical, fault runs carry retry
slices, and ``record_trace=False`` attaches no trace.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.dma import simulate
from repro_torch.core.dma.commands import tag_name
from repro_torch.core.dma.dispatch import COLLECTIVE_BUILDERS
from repro_torch.core.dma.faults import FaultPlan, Straggler
from repro_torch.core.dma.topology import (mi300x_cluster, mi300x_platform,
                                     tpu_v5e_multislice, tpu_v5e_pod)
from repro_torch.core.dma.trace import chrome_trace, write_chrome_trace
from repro_torch.serve.engine import ServingSimulator
from repro_torch.serve.workload import Request

from .common import MB, ClaimChecker, fmt_size

TOPOLOGIES = {
    "mi300x": mi300x_platform,
    "tpu16": lambda: tpu_v5e_pod(16),
    "mi300x-2node": lambda: mi300x_cluster(2),
    "tpu64": lambda: tpu_v5e_multislice(64),
}


def first_tag_name(schedule) -> str | None:
    """First tagged signal name in the schedule — a deterministic handle
    for ``FaultPlan.drop_tags`` (§13.2)."""
    for q in schedule.queues:
        for c in q.commands:
            for t in (c.tag, c.fused_tag):
                if t is not None:
                    name = tag_name(t)
                    if isinstance(name, str):
                        return name
    return None


def fault_plan_for(schedule) -> FaultPlan:
    """Deterministic plan that guarantees retry slices in the trace: drop
    the first raise of the schedule's first tag name, and slow one engine
    so the retry window is visible."""
    name = first_tag_name(schedule)
    drops = () if name is None else (name,)
    dev = schedule.devices[0]
    return FaultPlan(drop_tags=drops,
                     stragglers=(Straggler(device=dev, engine=None,
                                           slowdown=1.5),))


def export_schedule(collective: str, variant: str, size: int, topo_name: str,
                    *, faults: bool = False):
    """Build, trace, and return ``(SimResult, unrecorded SimResult,
    FaultPlan | None)`` for one collective schedule."""
    topo = TOPOLOGIES[topo_name]()
    sched = COLLECTIVE_BUILDERS[collective](topo, size, variant)
    plan = fault_plan_for(sched) if faults else None
    plain = simulate(sched, topo, faults=plan)
    recorded = simulate(sched, topo, faults=plan, record_trace=True)
    return recorded, plain, plan


def serving_round(n_requests: int = 6, record_round: int = 0):
    """One composed serving round (§12) with its trace recorded."""
    sim = ServingSimulator()
    reqs = [Request(rid=i, arrival=i * 1e-4, prompt_tokens=512,
                    output_tokens=8) for i in range(n_requests)]
    plain = ServingSimulator().run(reqs)
    report = sim.run(reqs, record_round=record_round)
    return sim.last_recorded, plain, report


def run(verbose: bool = True):
    """Claim-check the §14 trace contract over the three acceptance
    scenarios (hier-pipelined AG, fault-injected retry run, composed
    serving round)."""
    cc = ClaimChecker("trace_export")

    # (a) pipelined hierarchical all-gather -------------------------------
    recorded, plain, _ = export_schedule("all_gather", "hier_pipe", 4 * MB,
                                         "mi300x-2node")
    cc.check("hier_pipe AG recorded/unrecorded latency ratio",
             recorded.latency / plain.latency, 1.0, 1.0, 1.0)
    cc.check("record_trace=False attaches no trace",
             1.0 if plain.trace is None else 0.0, 1.0, 1.0, 1.0)
    n_ev = len(chrome_trace(recorded)["traceEvents"])
    if verbose:
        print(f"hier_pipe AG 4MB mi300x-2node: {len(recorded.trace.spans)} "
              f"spans, {len(recorded.trace.flows)} flows, {n_ev} events")
    cc.check("hier trace renders events", float(n_ev > 0), 1.0, 1.0, 1.0)

    # (b) fault-injected run with watchdog retries ------------------------
    frec, fplain, plan = export_schedule("all_gather", "pipe_b2b", 8 * MB,
                                         "tpu16", faults=True)
    cc.check("fault run recorded/unrecorded latency ratio",
             frec.latency / fplain.latency, 1.0, 1.0, 1.0)
    retries = sum(1 for s in frec.trace.spans if s.retry)
    if verbose:
        print(f"fault pipe_b2b AG 8MB tpu16: dropped {plan.drop_tags}, "
              f"{retries} retry slices")
    cc.check("fault trace carries retry slices", float(retries > 0), 1.0,
             1.0, 1.0)

    # (c) composed serving round ------------------------------------------
    comp, plain_report, report = serving_round()
    cc.check("serving recorded/unrecorded makespan ratio",
             report.makespan / plain_report.makespan, 1.0, 1.0, 1.0)
    n_sev = len(chrome_trace(comp)["traceEvents"])
    if verbose:
        print(f"serving round 0: {len(comp.result.trace.spans)} spans, "
              f"{n_sev} events")
    cc.check("serving trace renders events", float(n_sev > 0), 1.0, 1.0, 1.0)

    return cc, {"hier": recorded, "fault": frec, "serving": comp}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--collective", default="all_gather",
                   choices=sorted(COLLECTIVE_BUILDERS))
    p.add_argument("--variant", default="hier_pipe")
    p.add_argument("--size", default="4MB",
                   help="message size, e.g. 512KB / 4MB / 1048576")
    p.add_argument("--topo", default="mi300x-2node",
                   choices=sorted(TOPOLOGIES))
    p.add_argument("--faults", action="store_true",
                   help="inject a deterministic dropped signal + straggler "
                        "so the dump shows watchdog retry slices")
    p.add_argument("--serving", action="store_true",
                   help="export one composed serving round (§12) instead "
                        "of a single schedule")
    p.add_argument("--round", type=int, default=0,
                   help="which serving round to record (with --serving)")
    p.add_argument("--out", default="trace.json",
                   help="output path for the Chrome trace-event JSON")
    p.add_argument("--check", action="store_true",
                   help="CI guard: run the §14 contract claims instead of "
                        "exporting")
    args = p.parse_args(argv)

    if args.check:
        cc, _ = run(verbose=False)
        return 0 if cc.report() else 1

    if args.serving:
        comp, plain_report, report = serving_round(record_round=args.round)
        if comp is None:
            print(f"serving run finished before round {args.round}")
            return 1
        label = f"serving round {args.round}"
        obj = comp
    else:
        size = parse_size(args.size)
        obj, plain, plan = export_schedule(args.collective, args.variant,
                                           size, args.topo,
                                           faults=args.faults)
        assert obj.latency == plain.latency      # §14: recording is free
        label = (f"{args.collective} {args.variant} {fmt_size(size)} "
                 f"{args.topo}" + (" +faults" if plan is not None else ""))
    path = write_chrome_trace(obj, args.out, label=label)
    n = len(chrome_trace(obj)["traceEvents"])
    print(f"wrote {n} trace events to {path} ({label}); "
          f"load it in ui.perfetto.dev or chrome://tracing")
    return 0


def parse_size(text: str) -> int:
    t = text.strip().upper()
    for suffix, mult in (("KB", 1024), ("MB", MB), ("B", 1)):
        if t.endswith(suffix):
            return int(float(t[:-len(suffix)]) * mult)
    return int(t)


if __name__ == "__main__":
    raise SystemExit(main())
