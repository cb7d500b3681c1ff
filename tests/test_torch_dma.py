"""The port's copy of the DMA simulator, serving model, workload generator,
``ServingSimulator`` and modeled fetch latency against the JAX package's.

All of it is host-side numpy, so the two packages must agree bit for bit on
the same inputs.  Their dataclasses and enums are different classes, so
results are compared field by field after ``_plain`` turns them into plain
dicts, lists, names and floats; floats are compared with ``==``.
"""
import dataclasses
import enum
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dma as ref_dma  # noqa: E402
from repro.core import serving_model as ref_sm  # noqa: E402
from repro.core.dma import claims as ref_claims  # noqa: E402
from repro.core.dma import dispatch as ref_dispatch  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import workload as ref_wl  # noqa: E402
from repro.serve.host_store import HostKVStore as RefHostKVStore  # noqa: E402
from repro_torch.core import dma  # noqa: E402
from repro_torch.core import serving_model as sm  # noqa: E402
from repro_torch.core.dma import claims  # noqa: E402
from repro_torch.core.dma import dispatch  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve import workload as wl  # noqa: E402
from repro_torch.serve.host_store import BACKENDS, HostKVStore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KB, MB = 1024, 1024 * 1024
BUILDERS = {"all_gather": "allgather_schedule", "all_to_all": "alltoall_schedule",
            "reduce_scatter": "reduce_scatter_schedule", "all_reduce": "allreduce_schedule"}


def _plain(x):
    """Dataclasses -> {class name, fields}, enums -> names, containers ->
    lists/dicts of the same, recursively; scalars as they are."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__class__": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, enum.Enum):
        return f"{type(x).__name__}.{x.name}"
    if isinstance(x, dict):
        return {_plain(k) if not isinstance(k, str) else k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _same(got, want):
    assert _plain(got) == _plain(want)


# ------------------------------------------------------------- the copy ----
COPIED = sorted(f for f in os.listdir(os.path.join(REPO, "src/repro/core/dma"))
                if f.endswith((".py", ".json"))) + ["../serving_model.py"]


@pytest.mark.parametrize("name", COPIED)
def test_copy_is_the_reference_verbatim(name):
    """Each copied module is the reference's text with the package renamed
    (``repro.core``/``repro.serve`` -> ``repro_torch.*``) and nothing else."""
    ref = open(os.path.join(REPO, "src/repro/core/dma", name)).read()
    port = open(os.path.join(REPO, "src/repro_torch/core/dma", name)).read()
    assert port == re.sub(r"\brepro\.(core|serve)\b", r"repro_torch.\1", ref)


def test_serving_simulator_is_the_reference_copy():
    """engine.py's modeled half is the reference's, from its section header on."""
    marker = "# Modeled continuous-batching serving"
    ref = open(os.path.join(REPO, "src/repro/serve/engine.py")).read()
    port = open(os.path.join(REPO, "src/repro_torch/serve/engine.py")).read()
    ref_tail = re.sub(r"\brepro\.(core|serve)\b", r"repro_torch.\1", ref[ref.index(marker):])
    strip = lambda s: re.sub(r"\s+", " ", s)    # noqa: E731  (import alignment)
    assert strip(port[port.index(marker):]) == strip(ref_tail)


# ---------------------------------------------------------------- claims ----
@pytest.mark.parametrize("fn", ["evaluate_claims", "serving_load_claims",
                                "serving_fault_claims", "fault_degradation_claims",
                                "fault_retry_claims"])
def test_claims_match_reference(fn):
    got, want = getattr(claims, fn)(), getattr(ref_claims, fn)()
    assert [c.name for c in got] == [c.name for c in want]
    for g, w in zip(got, want):
        assert (g.model_value, g.paper_value, g.lo, g.hi, g.ok) == \
            (w.model_value, w.paper_value, w.lo, w.hi, w.ok), g.name
    if fn == "evaluate_claims":
        assert len(got) == 38 and all(c.ok for c in got)


# ------------------------------------------------------------- simulate ----
@pytest.mark.parametrize("topo_name", ["mi300x", "tpu8"])
@pytest.mark.parametrize("collective", sorted(BUILDERS))
def test_simulate_every_variant_matches_reference(topo_name, collective):
    """Latency, phase breakdown and every other SimResult field of each
    candidate variant at 4 KiB, 1 MiB and 64 MiB."""
    def topo(pkg):
        return pkg.mi300x_platform() if topo_name == "mi300x" else pkg.tpu_v5e_pod(8)

    t, rt = topo(dma), topo(ref_dma)
    if collective in ("reduce_scatter", "all_reduce"):
        variants = dispatch.reduce_variants(t, collective)
        assert variants == ref_dispatch.reduce_variants(rt, collective)
    else:
        variants = dispatch.candidate_variants(t, collective, allow_optimized=True,
                                               allow_pipelined=True)
        assert variants == ref_dispatch.candidate_variants(
            rt, collective, allow_optimized=True, allow_pipelined=True)
    build, ref_build = getattr(dma, BUILDERS[collective]), getattr(ref_dma, BUILDERS[collective])
    for size in (4 * KB, 1 * MB, 64 * MB):
        for v in variants:
            got = dma.simulate(build(t, size, v), t)
            want = ref_dma.simulate(ref_build(rt, size, v), rt)
            assert got.latency == want.latency, (size, v)
            assert _plain(got) == _plain(want), (size, v)


@pytest.mark.parametrize("collective,flags", [
    ("all_gather", {}), ("all_to_all", {}),
    ("all_gather", {"allow_optimized": True, "allow_pipelined": True}),
    ("reduce_scatter", {"allow_reduce": True}),
    ("all_reduce", {"allow_reduce": True, "allow_optimized": True, "allow_pipelined": True})])
def test_derive_dispatch_matches_reference(collective, flags):
    """The paper's MI300X tables (default flags) and the deployment sweeps."""
    sizes = claims.ALL_SIZES
    got = dispatch.derive_dispatch(dma.mi300x_platform(), collective, sizes, **flags)
    want = ref_dispatch.derive_dispatch(ref_dma.mi300x_platform(), collective, sizes, **flags)
    _same(got, want)


def _fault_runs(pkg):
    topo = pkg.mi300x_platform()
    sched = pkg.allgather_schedule(topo, 1 * MB, "pipe_bidir_ring")
    names = sorted({pkg.tag_name(t) for q in sched.queues for c in q.commands
                    for t in (c.tag, c.fused_tag) if t is not None})
    out = []
    for plan in (pkg.straggler_plan(device=2, slowdown=3.0),
                 pkg.FaultPlan(drop_tags=(names[0],), seed=5)):
        res = pkg.simulate(sched, topo, faults=plan)
        out.append((res.latency, _plain(res.fault_report)))
    return out


def test_fault_reports_match_reference():
    """A straggler plan and a dropped-signal plan (watchdog retry)."""
    got = _fault_runs(dma)
    assert got == _fault_runs(ref_dma)
    assert got[0][1] is not None and got[1][1]["retries"]


def test_chrome_trace_matches_reference_and_golden():
    """The case pinned by tests/golden/trace_ag_ring2.json."""
    rendered = []
    for pkg in (dma, ref_dma):
        topo = pkg.tpu_v5e_pod(2)
        rec = pkg.simulate(pkg.allgather_schedule(topo, 64 * KB, "ring"), topo,
                           record_trace=True)
        rendered.append(json.loads(json.dumps(pkg.chrome_trace(rec), sort_keys=True)))
    with open(os.path.join(REPO, "tests/golden/trace_ag_ring2.json")) as f:
        golden = json.load(f)
    assert rendered[0] == rendered[1] == golden


# --------------------------------------------------------- serving model ----
def test_serving_model_matches_reference():
    for spec, ref_spec in zip(sm.PAPER_LLMS, ref_sm.PAPER_LLMS):
        assert _plain(spec) == _plain(ref_spec)
        for prompt in (512, 2048, 8192):
            for backend in ("pcpy", "b2b", "opt_b2b", "kernel"):
                args = (prompt, backend)
                assert sm.fetch_time(spec, *args) == ref_sm.fetch_time(ref_spec, *args)
                assert sm.ttft(spec, *args) == ref_sm.ttft(ref_spec, *args)
                assert sm.throughput(spec, *args, hit_rate=0.8) == \
                    ref_sm.throughput(ref_spec, *args, hit_rate=0.8)


# -------------------------------------------------------------- workload ----
@pytest.mark.parametrize("seed", [0, 1, 7, 11])
def test_arrivals_and_workloads_match_reference(seed):
    assert wl.poisson_arrivals(300.0, 64, seed) == ref_wl.poisson_arrivals(300.0, 64, seed)
    assert wl.bursty_arrivals(200.0, 64, seed) == ref_wl.bursty_arrivals(200.0, 64, seed)
    kw = dict(burst_factor=10.0, p_enter=0.4, p_exit=0.1)
    assert wl.bursty_arrivals(1800.0, 64, seed, **kw) == \
        ref_wl.bursty_arrivals(1800.0, 64, seed, **kw)
    for kind, extra in (("poisson", {}), ("bursty", kw)):
        got = wl.synthetic_workload(32, 500.0, seed, kind=kind, moe_fraction=0.3, **extra)
        want = ref_wl.synthetic_workload(32, 500.0, seed, kind=kind, moe_fraction=0.3, **extra)
        _same(got, want)


def test_bursty_under_rate_is_the_reference_s():
    """The copy keeps the reference's under-rate (ROADMAP C-ref2): 200 req/s
    asked, about 140 given, identical in both packages."""
    got = wl.bursty_arrivals(200.0, 4000, seed=0)
    assert got == ref_wl.bursty_arrivals(200.0, 4000, seed=0)
    rate = len(got) / got[-1]
    assert 130.0 < rate < 150.0


# ------------------------------------------------------ ServingSimulator ----
def _report(pkg_engine, pkg_wl, case):
    if case == "golden":
        w = pkg_wl.synthetic_workload(6, 1800.0, seed=11, kind="bursty", prompt_tokens=2048,
                                      output_tokens=2, burst_factor=10.0, p_enter=0.4,
                                      p_exit=0.1)
        return [pkg_engine.ServingSimulator(pkg_engine.ServingConfig()).run(w)]
    if case == "unloaded":
        sim = pkg_engine.ServingSimulator(pkg_engine.ServingConfig())
        return [sim.run([pkg_wl.Request(rid=0, arrival=a, prompt_tokens=p, output_tokens=o)])
                for p, a, o in ((2048, 0.0, 1), (4096, 0.0, 1), (2048, 1.5, 4),
                                (8192, 0.37, 8))]
    w = pkg_wl.synthetic_workload(24, 900.0, seed=3, kind="poisson", prompt_tokens=4096,
                                  output_tokens=4, moe_fraction=0.5)
    cfg = pkg_engine.ServingConfig(admission="defer", max_batch=8)
    return [pkg_engine.ServingSimulator(cfg).run(w)]


@pytest.mark.parametrize("case", ["golden", "unloaded", "defer_moe"])
def test_serving_simulator_matches_reference(case):
    """The inputs of test_compose.py::test_golden_serving_trace and
    test_serving.py::test_serving_simulator_unloaded_matches_fig16_exactly,
    and a contended run with the defer policy and MoE traffic."""
    got, want = _report(engine, wl, case), _report(ref_engine, ref_wl, case)
    for g, w in zip(got, want):
        assert _plain(g) == _plain(w)
        assert (g.ttft_p99, g.goodput, g.throughput) == (w.ttft_p99, w.goodput, w.throughput)
    if case == "unloaded":
        prompts = (2048, 4096, 2048, 8192)
        for rep, prompt in zip(got, prompts):
            assert rep.timings[0].ttft == sm.ttft(sm.PAPER_LLMS[2], prompt, "opt_b2b")["total"]


# ------------------------------------------------- modeled fetch latency ----
@pytest.fixture(scope="module")
def fetched():
    """The inputs of tests/test_serving.py::test_fetch_backends_bitwise_equal
    (float32), and the same blocks in bf16, through both host stores."""
    rng = np.random.default_rng(0)
    kb = rng.normal(size=(5, 16, 2, 2, 16)).astype(np.float32)
    vb = rng.normal(size=(5, 16, 2, 2, 16)).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        ref_store, store = RefHostKVStore(), HostKVStore(device="cpu")
        ref_store.save("k", np.asarray(jnp.asarray(kb).astype(dtype)),
                       np.asarray(jnp.asarray(vb).astype(dtype)), 70)
        store.save("k", torch.from_numpy(kb).to(getattr(torch, dtype)),
                   torch.from_numpy(vb).to(getattr(torch, dtype)), 70)
        for b in BACKENDS:
            out[dtype, b] = (store.fetch("k", b), ref_store.fetch("k", b))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_modeled_fetch_seconds_match_reference(fetched, dtype, backend):
    got, want = fetched[dtype, backend]
    assert got.modeled_seconds == want.modeled_seconds
    assert got.modeled_seconds > 0.0


def test_modeled_seconds_are_memoized(monkeypatch):
    """One simulation per (backend, n_blocks, block_bytes), so only the first
    fetch of a shape pays the model's host time."""
    from repro_torch.serve import host_store
    calls = []
    real = host_store.simulate
    monkeypatch.setattr(host_store, "simulate", lambda *a, **k: calls.append(1) or real(*a, **k))
    store = HostKVStore(device="cpu")
    blocks = torch.zeros(4, 16, 2, 2, 8)
    store.save("a", blocks, blocks, 60)
    store.save("b", blocks, blocks, 60)
    first = [store.fetch(k, "opt_b2b").modeled_seconds for k in ("a", "b", "a")]
    assert len(calls) == 1 and first[0] == first[1] == first[2]
    store.fetch("a", "pcpy")
    assert len(calls) == 2
