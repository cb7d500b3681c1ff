"""Compatibility façade over the event-driven simulator core.

The timing model used to live here as a closed-form per-device formula; it is
now the discrete-event simulator in :mod:`repro_torch.core.dma.sim` (contended
links/engines/host, multi-hop routing, cross-device waits, symmetric fast
path — see DESIGN.md §2).  This module keeps the historical import surface:

    from repro_torch.core.dma.engine import PhaseBreakdown, SimResult, simulate
"""
from __future__ import annotations

from .faults import FaultPlan, FaultReport, SimFault
from .sim import (
    ComposedResult,
    PhaseBreakdown,
    ScheduleOutcome,
    SimResult,
    run_composed,
    simulate,
    single_copy_breakdown,
)

__all__ = ["ComposedResult", "FaultPlan", "FaultReport", "PhaseBreakdown",
           "ScheduleOutcome", "SimFault", "SimResult",
           "run_composed", "simulate", "single_copy_breakdown"]
