"""DMA-Latte core: command set, event-driven engine simulator, collective
schedules, optimized command-stream transforms, dispatch policy, RCCL
baseline and power models (the paper's contribution)."""
from . import commands
from .commands import (
    CmdKind,
    Command,
    EngineQueue,
    Schedule,
    chunk_command,
    chunk_schedule,
    chunk_sizes,
    chunk_tag,
    chunked_copies,
    chunked_reduces,
    link_traffic,
    reduce_work,
    tag_chunk,
    tag_name,
)
from .collectives import (
    PIPE_DEPTH,
    RS_VARIANTS,
    allgather_schedule,
    allreduce_schedule,
    alltoall_schedule,
    kv_fetch_schedule,
    reduce_scatter_schedule,
)
from .dispatch import (
    COLLECTIVE_BUILDERS,
    PAPER_AA_DISPATCH,
    PAPER_AG_DISPATCH,
    PERTURB_SCENARIOS,
    FragileEntry,
    RobustnessReport,
    best_variant_for,
    candidate_variants,
    derive_dispatch,
    dispatch_robustness,
    optimized_variants,
    paper_dispatch,
    perturbed_topology,
    pick_variant,
    pipelined_variants,
    reduce_variants,
    variant_latency,
)
from .faults import (
    BlockedWaiter,
    FaultPlan,
    FaultReport,
    LinkDerate,
    NicFlap,
    RetryRecord,
    SimFault,
    Straggler,
    straggler_plan,
)
from .engine import (
    ComposedResult,
    PhaseBreakdown,
    ScheduleOutcome,
    SimResult,
    run_composed,
    simulate,
    single_copy_breakdown,
)
from .optimizations import (
    OptimizationConfig,
    batch_commands,
    fuse_signals,
    optimize,
    parse_optimized,
    split_queues,
)
from .power import cu_collective_power, dma_collective_power
from .trace import (
    SimTrace,
    TraceFlow,
    TraceInstant,
    TraceRecorder,
    TraceSpan,
    chrome_trace,
    write_chrome_trace,
)
from .rccl_model import kernel_copy_latency, rccl_collective_latency
from .topology import (
    Calibration,
    PowerCalibration,
    RcclCalibration,
    Topology,
    mi300x_platform,
    rccl_aa_calibration,
    rccl_ag_calibration,
    tpu_v5e_pod,
)

__all__ = [
    "commands", "CmdKind", "Command", "EngineQueue", "Schedule",
    "chunk_command", "chunk_schedule", "chunk_sizes", "chunk_tag",
    "chunked_copies", "chunked_reduces", "link_traffic", "reduce_work",
    "tag_chunk", "tag_name",
    "PIPE_DEPTH", "RS_VARIANTS", "allgather_schedule", "allreduce_schedule",
    "alltoall_schedule", "kv_fetch_schedule", "reduce_scatter_schedule",
    "COLLECTIVE_BUILDERS", "PAPER_AA_DISPATCH", "PAPER_AG_DISPATCH",
    "PERTURB_SCENARIOS", "FragileEntry", "RobustnessReport",
    "best_variant_for",
    "candidate_variants", "derive_dispatch", "dispatch_robustness",
    "optimized_variants",
    "paper_dispatch", "perturbed_topology", "pick_variant",
    "pipelined_variants",
    "reduce_variants", "variant_latency",
    "BlockedWaiter", "FaultPlan", "FaultReport", "LinkDerate", "NicFlap",
    "RetryRecord", "SimFault", "Straggler", "straggler_plan",
    "ComposedResult", "PhaseBreakdown", "ScheduleOutcome", "SimResult",
    "run_composed", "simulate", "single_copy_breakdown",
    "OptimizationConfig", "batch_commands", "fuse_signals", "optimize",
    "parse_optimized", "split_queues",
    "cu_collective_power", "dma_collective_power",
    "SimTrace", "TraceFlow", "TraceInstant", "TraceRecorder", "TraceSpan",
    "chrome_trace", "write_chrome_trace",
    "kernel_copy_latency", "rccl_collective_latency",
    "Calibration", "PowerCalibration", "RcclCalibration", "Topology",
    "mi300x_platform", "tpu_v5e_pod", "rccl_ag_calibration", "rccl_aa_calibration",
]
