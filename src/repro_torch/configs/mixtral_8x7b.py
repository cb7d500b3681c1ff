"""Mixtral-8x7B: 32L d_model=4096 32H (GQA kv=8) expert d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    norm="rmsnorm",
    act="silu",
    rope_kind="rope",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
)
