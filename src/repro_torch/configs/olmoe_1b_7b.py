"""OLMoE-1B-7B: 16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060]"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    norm="rmsnorm",
    act="silu",
    rope_kind="rope",
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
)
