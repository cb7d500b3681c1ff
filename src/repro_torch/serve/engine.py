"""Batched LLM serving engine with host-memory context caching (paper §5.3).

Counterpart of ``repro.serve.engine.ServeEngine``:

1. A request arrives with a context key.  On a HOST CACHE MISS the engine
   runs prefill on the device, emits the first token and SAVES the paged KV
   to the pinned host store.  On a HIT it FETCHES the KV blocks back,
   rebuilds the device cache and emits the first token with one decode step
   (no prefill compute).  The fetch backend defaults to the CommBackend's
   ``kv_fetch_plan`` (latte: ``opt_b2b``; reference: per-block ``pcpy``); an
   explicit ``fetch_backend`` overrides the plan.
2. Decode proceeds in batched steps over all active sequences.

TTFT is therefore fetch + rebuild + one decode step on hits, and prefill on
misses.  Wall times synchronize the device before reading the clock.  Beside
the measured TTFT, a hit reports ``fetch_modeled_s``: the host store's
MODELED fetch latency on the reference's MI300X platform (DMA engine model),
not a measurement on the card.

:class:`ServingSimulator` is the reference's modeled continuous-batching
loop under concurrent traffic, copied unchanged: pure numpy over the port's
copy of the DMA simulator (``core.dma``), run on the host, measuring nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.backend import CommBackend
from repro_torch.models import attention as attn_mod
from repro_torch.models.transformer import Model
from .host_store import HostKVStore
from .kvcache import BLOCK_TOKENS, blocks_to_kv, kv_to_blocks


@dataclasses.dataclass
class RequestStats:
    key: str
    cache_hit: bool
    ttft_wall_s: float
    fetch_modeled_s: float      # 0 on miss; modeled, not measured
    n_transfers: int
    prompt_tokens: int


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, n_new]
    request_stats: list[RequestStats]
    decode_wall_s: float
    tokens_per_s_wall: float


class ServeEngine:
    def __init__(self, model: Model, params, *, host_store: HostKVStore | None = None,
                 comm: CommBackend | None = None, block_tokens: int = BLOCK_TOKENS,
                 device="cuda"):
        cfg = model.cfg
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"serving engine supports decoder-LM families, got {cfg.family}")
        if cfg.layer_pattern:
            raise ValueError("serving engine requires per_unit==1 layer stacking")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.store = host_store or HostKVStore(self.device)
        self.comm = comm or CommBackend("latte")
        self.block_tokens = block_tokens

    # ----------------------------------------------------------- helpers ----
    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _build_cache(self, k: torch.Tensor, v: torch.Tensor, capacity: int) -> list[dict]:
        """k/v [L, B, S, KV, hd] -> per-layer decode caches at ``capacity``."""
        cfg = self.model.cfg
        return [attn_mod.prefill_cache(cfg, k[i], v[i], capacity) for i in range(k.shape[0])]

    def _planned_backend(self, keys: Sequence[str]) -> str:
        """Fetch backend from the CommBackend's plan for these contexts
        (latte requests the optimized command stream -> ``opt_b2b``)."""
        n_blocks, block_bytes = self.store.blocks_for(keys[0])
        plan = self.comm.kv_fetch_plan(n_blocks * len(keys), block_bytes)
        mode = plan["mode"]
        return f"opt_{mode}" if plan.get("optimized") else mode

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1], dim=-1)

    # ------------------------------------------------------------ public ----
    def first_token(self, prompts, keys: Sequence[str], *, fetch_backend: str | None = None,
                    capacity: int | None = None):
        """TTFT path for a batch sharing prompt length.  Returns
        (first_tokens [B] on the device, cache, stats).  ``fetch_backend=None``
        follows the CommBackend's ``kv_fetch_plan``."""
        prompts = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        B, S = prompts.shape
        capacity = capacity or S + 64
        stats = []
        t0 = self._clock()
        if all(k in self.store for k in keys):
            if fetch_backend is None:
                fetch_backend = self._planned_backend(keys)
            ks, vs, modeled_total, n_tr = [], [], 0.0, 0
            for key in keys:
                res = self.store.fetch(key, fetch_backend)
                kk, vv = blocks_to_kv(res.k_blocks, res.v_blocks, self.store.tokens_for(key))
                ks.append(kk)
                vs.append(vv)
                modeled_total += res.modeled_seconds
                n_tr += res.n_transfers
            cache = self._build_cache(torch.cat(ks, dim=1), torch.cat(vs, dim=1), capacity)
            logits, cache = self.model.decode_step(
                self.params, {"tokens": prompts[:, -1:], "pos": S - 1}, cache)
            first = self._greedy(logits)
            wall = self._clock() - t0
            stats = [RequestStats(key, True, wall / B, modeled_total / B, n_tr, S)
                     for key in keys]
        else:
            logits, _, (k, v) = self.model.forward(self.params, {"tokens": prompts},
                                                   want_cache=True)
            first = self._greedy(logits)
            wall = self._clock() - t0
            for b, key in enumerate(keys):
                kb, vb = kv_to_blocks(k[:, b:b + 1], v[:, b:b + 1], self.block_tokens)
                self.store.save(key, kb, vb, S)
                stats.append(RequestStats(key, False, wall / B, 0.0, 0, S))
            cache = self._build_cache(k, v, capacity)
        return first, cache, stats

    def generate(self, prompts, keys: Sequence[str], n_new: int, *,
                 fetch_backend: str | None = None) -> GenerationResult:
        B, S = prompts.shape
        capacity = S + n_new + 1
        first, cache, stats = self.first_token(prompts, keys, fetch_backend=fetch_backend,
                                               capacity=capacity)
        toks = [first]
        t0 = self._clock()
        for i in range(n_new - 1):
            logits, cache = self.model.decode_step(
                self.params, {"tokens": toks[-1][:, None], "pos": S + i}, cache)
            toks.append(self._greedy(logits))
        dt = self._clock() - t0
        tokens = torch.stack(toks, dim=1).cpu().numpy()
        return GenerationResult(tokens, stats, dt, B * (n_new - 1) / max(dt, 1e-9))


# ===================================================================== #
# Modeled continuous-batching serving under concurrent traffic (§12)    #
# ===================================================================== #

from repro_torch.core.dma import (allgather_schedule, alltoall_schedule,  # noqa: E402
                                  kv_fetch_schedule, mi300x_platform,
                                  paper_dispatch, run_composed, simulate)
from repro_torch.core.serving_model import (BATCH_API_COST, BLOCK_TOKENS,  # noqa: E402
                                            FRAMEWORK_OVERHEAD, N_BATCH_CALLS,
                                            PAPER_LLMS, LLMSpec, decode_step_time)
from .workload import Request  # noqa: E402


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the modeled continuous-batching loop.

    ``admission`` picks the launch policy: ``"fifo"`` admits every waiting
    request up to the free batch slots; ``"defer"`` additionally defers a
    request whose target host link (its home device's PCIe queue) already
    has ``fetch_depth_limit`` fetches in flight — the §12 contention-aware
    policy that protects the decode batch's engines from fetch storms.

    ``ag_bytes_per_token`` is the per-layer tensor-parallel all-gather
    payload one active request contributes per decode step (hidden-dim
    activations, bf16); ``moe_bytes_per_token`` the per-layer all-to-all
    payload of a MoE request.  A decode round aggregates the whole batch's
    per-layer collectives into one schedule of the round's total bytes,
    dispatched via the paper's tables at that size (the layers stream
    back-to-back on the same ring, so the aggregate keeps the contention
    surface while bounding schedule count).

    ``slo_scale`` sets SLOs as multiples of the unloaded numbers: a request
    meets SLO when TTFT <= slo_scale x its isolated TTFT and TPOT <=
    slo_scale x the compute-bound full-batch decode step.  Goodput counts
    only SLO-meeting requests' tokens.
    """

    spec: LLMSpec = PAPER_LLMS[2]         # qwen2.5-7b
    max_batch: int = 16
    admission: str = "fifo"               # "fifo" | "defer"
    fetch_depth_limit: int = 1
    ag_bytes_per_token: int = 7168        # hidden 3584 x bf16
    moe_bytes_per_token: int = 28672
    slo_scale: float = 4.0


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Per-request outcome of a :class:`ServingSimulator` run (seconds)."""

    rid: int
    arrival: float
    ttft: float                 # first token latency, arrival -> token
    tpot: float                 # mean inter-token time after the first
    completion: float           # absolute time the last token was emitted
    output_tokens: int
    slo_ttft: float
    slo_tpot: float

    @property
    def meets_slo(self) -> bool:
        return self.ttft <= self.slo_ttft and self.tpot <= self.slo_tpot


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """Aggregate of one workload run: tail latencies and goodput."""

    timings: tuple[RequestTiming, ...]
    makespan: float
    rounds: int
    deferred: int               # admission decisions that pushed a launch back

    def _pct(self, values, q: float) -> float:
        return float(np.percentile(np.asarray(values, dtype=float), q))

    @property
    def ttft_p50(self) -> float:
        return self._pct([t.ttft for t in self.timings], 50)

    @property
    def ttft_p99(self) -> float:
        return self._pct([t.ttft for t in self.timings], 99)

    @property
    def tpot_p50(self) -> float:
        return self._pct([t.tpot for t in self.timings if t.output_tokens > 1], 50)

    @property
    def tpot_p99(self) -> float:
        return self._pct([t.tpot for t in self.timings if t.output_tokens > 1], 99)

    @property
    def throughput(self) -> float:
        """Output tokens per second, SLO-blind."""
        total = sum(t.output_tokens for t in self.timings)
        return total / self.makespan if self.makespan > 0 else 0.0

    @property
    def goodput(self) -> float:
        """Output tokens per second from requests that met both SLOs."""
        good = sum(t.output_tokens for t in self.timings if t.meets_slo)
        return good / self.makespan if self.makespan > 0 else 0.0


class _Fetch:
    """An in-flight KV fetch: the blocks its remainder schedule still owes."""

    __slots__ = ("req", "remaining")

    def __init__(self, req: Request, n_blocks: int) -> None:
        self.req = req
        self.remaining = n_blocks


class _Active:
    __slots__ = ("req", "remaining", "first_token", "ttft", "slo_ttft")

    def __init__(self, req: Request, first_token: float, ttft: float,
                 slo_ttft: float) -> None:
        self.req = req
        self.remaining = req.output_tokens - 1
        self.first_token = first_token
        self.ttft = ttft
        self.slo_ttft = slo_ttft


class ServingSimulator:
    """Round-based continuous batching over the composed DMA simulator.

    Each scheduling round composes, in ONE resource world released at the
    round's start time (DESIGN.md §12):

      * one KV-fetch schedule per newly admitted request, released at the
        request's arrival offset, targeting its home device's host link
        (the dispatch plan's ``opt_prelaunch_b2b`` stream for latte);
      * the decode batch's aggregated per-layer all-gather (plus the MoE
        requests' all-to-all), released at 0 — variants picked from the
        paper's dispatch tables at the round's byte sizes.

    A fetch that outlives its round is *carried over*: the next round
    re-presents it to the composed world as a remainder schedule holding its
    unserved KV blocks (fluid progress, block-granular), so cross-round link
    and engine contention is never lost — a storm of in-flight fetches keeps
    slowing the decode stream and each other until it drains.  The round
    advances wall time by max(modeled comm makespan of the decode stream,
    the batch's compute-bound decode step) — or, with no active batch, to
    the first fetch completion; every active request emits one token per
    round (TPOT is round-granular, like real continuous batching).  A
    request's first token rides its fetch completion plus one decode step —
    at load -> 0 this is exactly the Fig. 16 single-request TTFT, because
    K=1 composition is bit-identical to ``simulate``.

    Degraded-mode serving (DESIGN.md §13.4): ``faults`` threads a
    :class:`~repro_torch.core.dma.faults.FaultPlan` through every composed round.
    Fault windows are expressed in workload-absolute time — each round
    passes ``faults.shifted(now)`` to the composed run so a window means
    the same wall-clock interval in every round.  The ``defer`` admission
    policy additionally consults the plan's live fault state: a request
    whose home device sits in an outage window that will *clear*
    (``FaultPlan.waitable_degraded`` — NIC flap, finite derate window) is
    deferred past the outage instead of fetching at degraded rate.
    Permanent degradation (stragglers) never defers — the KV home is
    pinned, so waiting cannot find healthier hardware and would only starve
    the request.  A starvation guard admits the queue head anyway when
    nothing at all is in flight.  SLO baselines (``unloaded_ttft``) stay
    fault-free: SLOs measure against healthy hardware, so fault runs show
    up as violations, not as a lowered bar.
    """

    def __init__(self, config: ServingConfig | None = None, *,
                 topo=None, comm: CommBackend | None = None,
                 faults=None):
        self.cfg = config or ServingConfig()
        if self.cfg.admission not in ("fifo", "defer"):
            raise ValueError(f"unknown admission policy {self.cfg.admission!r}")
        self.topo = topo or mi300x_platform()
        self.comm = comm or CommBackend("latte")
        # Empty plans normalize away (same contract as simulate(), §13.1).
        self.faults = None if faults is None or faults.is_empty() else faults
        self._fetch_cache: dict = {}
        self._decode_cache: dict = {}
        self._iso_cache: dict = {}
        self.last_recorded = None   # ComposedResult of the record_round round

    # ------------------------------------------------------- schedules ----
    def _home_device(self, req: Request) -> int:
        # Context placement: the device whose host link serves this request's
        # KV blocks.  A paged KV store places contexts by key hash, so
        # collisions are real — a multiplicative hash (not round-robin)
        # reproduces the skew that makes admission policy matter.
        return ((req.rid * 0x9E3779B1) >> 7) % self.topo.n_devices

    def _fetch_shape(self, req: Request) -> tuple[int, int]:
        n_blocks = (req.prompt_tokens + BLOCK_TOKENS - 1) // BLOCK_TOKENS
        block_bytes = self.cfg.spec.kv_bytes_per_token * BLOCK_TOKENS
        return n_blocks, block_bytes

    def _fetch_variant(self, n_blocks: int, block_bytes: int) -> str:
        plan = self.comm.kv_fetch_plan(n_blocks, block_bytes)
        mode = f"prelaunch_{plan['mode']}" if plan["mode"] == "b2b" else plan["mode"]
        return f"opt_{mode}" if plan.get("optimized") else mode

    def _fetch_schedule(self, req: Request):
        n_blocks, block_bytes = self._fetch_shape(req)
        dev = self._home_device(req)
        key = (n_blocks, block_bytes, dev)
        sched = self._fetch_cache.get(key)
        if sched is None:
            variant = self._fetch_variant(n_blocks, block_bytes)
            sched = kv_fetch_schedule(self.topo, n_blocks, block_bytes,
                                      variant, device=dev)
            self._fetch_cache[key] = sched
        return sched

    def _remainder_schedule(self, f: _Fetch):
        """Schedule for a carried-over fetch's unserved blocks."""
        _, block_bytes = self._fetch_shape(f.req)
        dev = self._home_device(f.req)
        key = (f.remaining, block_bytes, dev)
        sched = self._fetch_cache.get(key)
        if sched is None:
            variant = self._fetch_variant(f.remaining, block_bytes)
            sched = kv_fetch_schedule(self.topo, f.remaining, block_bytes,
                                      variant, device=dev)
            self._fetch_cache[key] = sched
        return sched

    def isolated_fetch_seconds(self, req: Request) -> float:
        """Modeled seconds of this request's KV fetch with the PCIe link,
        engines and host to itself — the Fig. 16 fetch component plus the
        batch-API call cost (``serving_model.fetch_time`` equivalent)."""
        n_blocks, block_bytes = self._fetch_shape(req)
        key = (n_blocks, block_bytes, self._home_device(req))
        lat = self._iso_cache.get(key)
        if lat is None:
            lat = simulate(self._fetch_schedule(req), self.topo).latency
            self._iso_cache[key] = lat
        return lat + N_BATCH_CALLS * BATCH_API_COST

    def unloaded_ttft(self, req: Request) -> float:
        """Single-request TTFT (= ``serving_model.ttft(...)["total"]``)."""
        return (self.isolated_fetch_seconds(req)
                + decode_step_time(self.cfg.spec)
                + FRAMEWORK_OVERHEAD)

    def _decode_schedules(self, batch: int, n_moe: int) -> list:
        """The round's decode-comm streams: aggregated per-layer AG (+ AA)."""
        key = (batch, n_moe)
        scheds = self._decode_cache.get(key)
        if scheds is None:
            cfg = self.cfg
            scheds = []
            ag_bytes = cfg.spec.n_layers * batch * cfg.ag_bytes_per_token
            scheds.append(allgather_schedule(
                self.topo, ag_bytes, paper_dispatch("all_gather", ag_bytes)))
            if n_moe:
                aa_bytes = cfg.spec.n_layers * n_moe * cfg.moe_bytes_per_token
                scheds.append(alltoall_schedule(
                    self.topo, aa_bytes, paper_dispatch("all_to_all", aa_bytes)))
            self._decode_cache[key] = scheds
        return scheds

    # -------------------------------------------------------- admission ----
    def _admit(self, waiting: list, slots: int, depth: dict,
               degraded: frozenset = frozenset(),
               starving: bool = False) -> tuple[list, list, int]:
        """Pick this round's launches; returns (admitted, still_waiting,
        n_deferred).  ``depth`` counts in-flight fetches per home device;
        ``degraded`` names devices with live fault state (DESIGN.md §13.4)
        — under ``defer`` a request homed there is pushed back like one
        behind a full fetch queue.  ``starving`` (nothing in flight at all)
        arms the guard that admits the queue head even when every waiter
        would be deferred — a permanently degraded device must degrade
        service, not halt it."""
        if slots <= 0:
            return [], waiting, 0
        admitted, still, deferred = [], [], 0
        depth = dict(depth)
        for req in waiting:
            if len(admitted) >= slots:
                still.append(req)
                continue
            dev = self._home_device(req)
            if (self.cfg.admission == "defer"
                    and (depth.get(dev, 0) >= self.cfg.fetch_depth_limit
                         or dev in degraded)):
                still.append(req)
                deferred += 1
                continue
            depth[dev] = depth.get(dev, 0) + 1
            admitted.append(req)
        if starving and not admitted and still:
            admitted.append(still.pop(0))
            deferred = max(0, deferred - 1)
        return admitted, still, deferred

    # -------------------------------------------------------------- run ----
    def run(self, requests, *, record_round: int | None = None) -> ServingReport:
        """Simulate ``requests`` to completion.

        ``record_round`` records the Nth composed round (0-based) with
        ``record_trace=True`` and keeps its :class:`ComposedResult` on
        ``self.last_recorded`` for Chrome-trace export (DESIGN.md §14);
        timing is unaffected (composed runs always take the full event
        loop).  ``None`` (default) never records.
        """
        cfg = self.cfg
        self.last_recorded = None
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        n = len(reqs)
        if n == 0:
            raise ValueError("empty workload")
        slo_tpot = cfg.slo_scale * decode_step_time(cfg.spec, cfg.max_batch)
        api = N_BATCH_CALLS * BATCH_API_COST

        i = 0
        now = 0.0
        waiting: list[Request] = []
        fetching: list[_Fetch] = []          # launch order == service order
        active: list[_Active] = []
        done: list[RequestTiming] = []
        span_est: float | None = None
        rounds = 0
        deferred = 0

        def finish(req: Request, first_token: float, ttft: float,
                   completion: float, slo_ttft: float) -> None:
            out = req.output_tokens
            tpot = ((completion - first_token) / (out - 1)) if out > 1 else 0.0
            done.append(RequestTiming(
                rid=req.rid, arrival=req.arrival, ttft=ttft, tpot=tpot,
                completion=completion, output_tokens=out,
                slo_ttft=slo_ttft, slo_tpot=slo_tpot))

        def land(req: Request, t_f: float) -> None:
            """Fetch fully served at round-relative time ``t_f``.  The delay
            is accumulated as (queue wait) + (service) rather than through
            absolute timestamps, so at load -> 0 (now == arrival) the TTFT
            is bitwise ``serving_model.ttft(...)['total']``."""
            delay = (now - req.arrival) + t_f
            ttft = (delay + api
                    + decode_step_time(cfg.spec) + FRAMEWORK_OVERHEAD)
            slo = cfg.slo_scale * self.unloaded_ttft(req)
            first = req.arrival + ttft
            if req.output_tokens <= 1:
                finish(req, first, ttft, first, slo)
            else:
                active.append(_Active(req, first, ttft, slo))

        while i < n or waiting or fetching or active:
            if not active and not fetching and not waiting:
                now = max(now, reqs[i].arrival)      # idle: jump to arrival
            while i < n and reqs[i].arrival <= now:
                waiting.append(reqs[i])
                i += 1
            # Admission window: arrivals landing before the round would end
            # become candidates, released mid-round at their arrival offset.
            if span_est is None:
                span_est = (self.isolated_fetch_seconds(waiting[0])
                            if waiting else decode_step_time(cfg.spec, cfg.max_batch))
            while i < n and reqs[i].arrival < now + span_est:
                waiting.append(reqs[i])
                i += 1
            depth: dict[int, int] = {}
            for f in fetching:
                d = self._home_device(f.req)
                depth[d] = depth.get(d, 0) + 1
            slots = cfg.max_batch - len(active) - len(fetching)
            degraded = (self.faults.waitable_degraded(now)
                        if self.faults is not None else frozenset())
            starving = not fetching and not active
            admitted, waiting, ndef = self._admit(waiting, slots, depth,
                                                  degraded, starving)
            deferred += ndef

            # One composed world for the round: carried-over fetch remainders
            # (release 0, launch order), the new launches (released at their
            # arrival offsets), then the decode batch's streams.
            schedules, releases = [], []
            for f in fetching:
                schedules.append(self._remainder_schedule(f))
                releases.append(0.0)
            for req in admitted:
                fetching.append(_Fetch(req, self._fetch_shape(req)[0]))
                schedules.append(self._fetch_schedule(req))
                releases.append(max(0.0, req.arrival - now))
            n_fetch = len(fetching)
            batch = len(active)
            n_moe = sum(1 for a in active if a.req.moe)
            if batch:
                for sched in self._decode_schedules(batch, n_moe):
                    schedules.append(sched)
                    releases.append(0.0)
            if not schedules:
                raise AssertionError("round composed nothing")  # unreachable
            comp = run_composed(
                schedules, self.topo, releases,
                faults=self.faults.shifted(now) if self.faults is not None
                else None,
                record_trace=record_round is not None and rounds == record_round)
            if record_round is not None and rounds == record_round:
                self.last_recorded = comp
            rounds += 1

            fin = [comp.outcomes[k].finish for k in range(n_fetch)]
            if batch:
                comm_finish = max(o.finish for o in comp.outcomes[n_fetch:])
                span = max(comm_finish, decode_step_time(cfg.spec, batch))
            else:
                span = min(fin)          # run to the first fetch completion
            end = now + span

            still: list[_Fetch] = []
            for k, f in enumerate(fetching):
                if fin[k] <= span:
                    land(f.req, fin[k])
                else:
                    # Fluid progress over the stream's in-round service
                    # window [release, span); block-granular, so the
                    # remainder is a real (smaller) schedule next round.
                    window = max(0.0, span - releases[k])
                    served = max(0.0, fin[k] - releases[k])
                    done_blocks = int(f.remaining * window / served) if served else 0
                    f.remaining = max(1, f.remaining - done_blocks)
                    still.append(f)
            fetching = still

            if batch:
                remaining = []
                for a in active:
                    a.remaining -= 1
                    if a.remaining == 0:
                        finish(a.req, a.first_token, a.ttft, end, a.slo_ttft)
                    else:
                        remaining.append(a)
                active = remaining
            span_est = span
            now = end

        makespan = max(t.completion for t in done)
        return ServingReport(timings=tuple(sorted(done, key=lambda t: t.rid)),
                             makespan=makespan, rounds=rounds, deferred=deferred)
