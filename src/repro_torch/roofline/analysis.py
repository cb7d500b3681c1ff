"""Three-term roofline per (arch x shape x mesh) from the costing pass, on
the H100 (``hw``).  Counterpart of ``repro.roofline.analysis``:

    compute    = per-device FLOPs / 989 TF/s (bf16 tensor cores)
    memory     = per-device bytes / 3.35 TB/s (HBM3)
    collective = per-device wire bytes / 50 GB/s (the inter-node link)

The terms come from ``costing.total_cost`` (per device, every layer
counted).  MODEL_FLOPS uses 6*N*D for training (2*N*D prefill;
2*N_active*B + KV-read term for decode); the ratio MODEL / (per-device FLOPs
x chips) catches recompute and redundancy waste.  ``model_flops`` is the
reference's arithmetic, float for float.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from . import hw
from .costing import CostVector


def _flops_params(cfg: ArchConfig) -> float:
    """Active parameters per token for FLOP purposes.  Zamba2's ONE shared
    attention block is stored once but EXECUTES n_layers/attn_every times."""
    n = cfg.n_active_params
    if cfg.hybrid:
        shared = (4 * cfg.d_model * cfg.n_heads * cfg.head_dim
                  + 3 * cfg.d_model * cfg.d_ff)
        n += (cfg.n_layers // cfg.hybrid.attn_every - 1) * shared
    return n


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs for this step (6ND train / 2ND prefill / decode)."""
    tokens = shape.global_batch * shape.seq_len
    n = _flops_params(cfg)
    if shape.mode == "train":
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence + KV-cache read math
    b = shape.global_batch
    flops = 2.0 * n * b
    if cfg.n_heads:
        ctx = shape.seq_len
        per_unit = len(cfg.layer_pattern) if cfg.layer_pattern else 1
        windows = ([cfg.sliding_window if k == "local" else None
                    for k in cfg.layer_pattern] if cfg.layer_pattern
                   else [cfg.sliding_window])
        n_attn_layers = (cfg.n_layers // cfg.hybrid.attn_every if cfg.hybrid
                         else cfg.n_layers)
        qk_dim = cfg.n_heads * cfg.head_dim
        per_layer = 0.0
        for w in windows:
            eff = min(w, ctx) if w else ctx
            per_layer += 4.0 * b * qk_dim * eff
        flops += n_attn_layers / len(windows) * per_layer
    if cfg.ssm:
        d_state = (cfg.d_model * cfg.ssm.head_size if cfg.ssm.kind == "rwkv6"
                   else cfg.ssm.expand * cfg.d_model * cfg.ssm.state_size)
        flops += 6.0 * b * d_state * cfg.n_layers
    return flops


_SUGGESTIONS = {
    "compute": ("compute-bound: raise MFU with tensor-core-friendly tiles "
                "(matmul dims in multiples of 64 for bf16 wgmma), fewer "
                "recompute passes (remat policy), or fp8 matmuls"),
    "memory": ("HBM-bound: fuse elementwise chains into the matmuls or one "
               "kernel, keep activations in bf16, avoid materialized "
               "score/logit temporaries (flash attention), raise arithmetic "
               "intensity per byte"),
    "collective": ("NVLink/IB-bound: reshard to cut gather volume (keep TP "
                   "inside the 8-GPU NVLink node), overlap collectives with "
                   "compute (latte issue-ahead), or move traffic off the "
                   "inter-node links"),
}


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    wire_by_kind: dict
    suggestion: str

    def to_json(self):
        return dataclasses.asdict(self)


def make_row(arch_id: str, shape_id: str, mesh_name: str, chips: int,
             total: CostVector, *, cfg: ArchConfig | None = None,
             shape: ShapeConfig | None = None) -> RooflineRow:
    """``cfg`` and ``shape`` override the registered ones (a depth-cut
    config, or a step's own shape)."""
    cfg = cfg or get_config(arch_id)
    shape = shape or get_shape(shape_id)
    compute_s = total.flops / hw.PEAK_BF16_FLOPS
    memory_s = total.bytes / hw.HBM_BW
    collective_s = total.wire_total / hw.LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = total.flops * chips
    return RooflineRow(
        arch=arch_id, shape=shape_id, mesh=mesh_name, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        wire_by_kind=dict(total.wire),
        suggestion=_SUGGESTIONS[dominant],
    )


def format_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
           "dominant | MODEL/HLO | note |\n|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.compute_s*1e3:.3f} | "
            f"{r.memory_s*1e3:.3f} | {r.collective_s*1e3:.3f} | "
            f"**{r.dominant}** | {r.useful_ratio:.2f} | {r.suggestion.split(':')[0]} |")
    return "\n".join(lines)
