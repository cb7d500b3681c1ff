"""Seeded request-arrival workloads for the concurrent-traffic serving sim.

The paper's serving figures (16/17) time ONE request's KV fetch in
isolation; predicting behavior under load needs *arrival processes*.  Two
generators cover the standard serving regimes:

* :func:`poisson_arrivals` — memoryless open-loop traffic at a fixed
  offered rate (the M/G/k baseline every serving paper sweeps).
* :func:`bursty_arrivals` — a 2-state Markov-modulated Poisson process
  (MMPP): a quiet state and a burst state whose rate is ``burst_factor``
  higher, with geometric dwell times.  The mixture is normalized so the
  *mean* rate equals ``rate`` — a bursty trace stresses tail latency at the
  same offered load.

Everything is driven by ``numpy.random.default_rng`` (PCG64), so a fixed
seed reproduces the exact same trace across processes and platforms —
`tests/test_compose.py` pins this plus a golden end-to-end trace.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: arrival time plus its traffic shape.

    ``prompt_tokens`` sizes the KV fetch (the context is assumed cached on
    the host, the paper's 100%-hit regime); ``output_tokens`` is the decode
    length; ``moe`` marks requests whose decode steps add MoE all-to-all
    traffic on top of the per-layer all-gathers.
    """

    rid: int
    arrival: float              # seconds since workload start
    prompt_tokens: int
    output_tokens: int
    moe: bool = False


def poisson_arrivals(rate: float, n: int, seed: int) -> tuple[float, ...]:
    """``n`` Poisson arrival times at ``rate`` requests/second."""
    if rate <= 0.0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return tuple(float(t) for t in np.cumsum(gaps))


def bursty_arrivals(rate: float, n: int, seed: int, *,
                    burst_factor: float = 4.0,
                    p_enter: float = 0.15,
                    p_exit: float = 0.35) -> tuple[float, ...]:
    """``n`` MMPP arrival times with mean rate ``rate``.

    After each arrival the modulating chain flips quiet->burst with
    probability ``p_enter`` and burst->quiet with ``p_exit`` (geometric
    dwell in units of arrivals).  The quiet-state rate is solved so the
    stationary mixture's mean rate equals ``rate``: with burst fraction
    ``pi = p_enter / (p_enter + p_exit)``, quiet rate
    ``rate / (1 - pi + pi * burst_factor)``.

    That normalization weighs the states by their share of ARRIVALS, while
    the mean rate is arrivals over time, and a burst's arrivals take less
    time: the trace's mean rate is ``1 / ((1 - pi) / quiet + pi / (quiet *
    burst_factor))``, below ``rate`` (about 136 req/s for ``rate=200`` at
    the defaults; 139.8 for ``bursty_arrivals(200.0, 4000, seed=0)``).  The
    reference generator has the same under-rate; this copy keeps it, so both
    packages give the same traces, and a bursty-load figure made with it
    carries the under-rate.
    """
    if rate <= 0.0:
        raise ValueError("rate must be > 0")
    if burst_factor < 1.0:
        raise ValueError("burst_factor must be >= 1")
    pi = p_enter / (p_enter + p_exit)
    quiet = rate / ((1.0 - pi) + pi * burst_factor)
    rng = np.random.default_rng(seed)
    t = 0.0
    burst = False
    out = []
    for _ in range(n):
        r = quiet * (burst_factor if burst else 1.0)
        t += float(rng.exponential(1.0 / r))
        out.append(t)
        u = float(rng.random())
        burst = (u < p_enter) if not burst else (u >= p_exit)
    return tuple(out)


def synthetic_workload(n: int, rate: float, seed: int, *,
                       kind: str = "poisson",
                       prompt_tokens: int = 2048,
                       output_tokens: int = 8,
                       prompt_jitter: float = 0.25,
                       moe_fraction: float = 0.0,
                       **kwargs) -> tuple[Request, ...]:
    """``n`` seeded requests with ``kind`` arrivals ("poisson"/"bursty").

    Prompt lengths jitter uniformly within ``±prompt_jitter`` of
    ``prompt_tokens`` (KV fetches of varied size contend differently than a
    uniform fleet); a ``moe_fraction`` of requests carry MoE all-to-all
    decode traffic.  Request shapes draw from an rng stream separate from
    the arrival process (seed sequence ``[seed, 1]``), so the same trace
    shape can be replayed against either arrival generator.
    """
    if kind == "poisson":
        arrivals = poisson_arrivals(rate, n, seed)
    elif kind == "bursty":
        arrivals = bursty_arrivals(rate, n, seed, **kwargs)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    rng = np.random.default_rng([seed, 1])
    lo = max(1, int(prompt_tokens * (1.0 - prompt_jitter)))
    hi = max(lo + 1, int(prompt_tokens * (1.0 + prompt_jitter)) + 1)
    prompts = rng.integers(lo, hi, size=n)
    moe_draw = rng.random(size=n)
    return tuple(
        Request(rid=i, arrival=arrivals[i], prompt_tokens=int(prompts[i]),
                output_tokens=output_tokens, moe=bool(moe_draw[i] < moe_fraction))
        for i in range(n))
