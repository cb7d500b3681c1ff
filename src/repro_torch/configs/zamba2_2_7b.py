"""Zamba2-2.7B: 54 Mamba2 layers d_model=2560, shared attention block
(32H, GQA kv=32) every 6 layers, d_ff=10240, vocab=32000, ssm_state=64.
[arXiv:2411.15242]"""
from .base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    norm="rmsnorm",
    act="silu",
    rope_kind="rope",
    ssm=SSMConfig(kind="mamba2", state_size=64, head_size=64, expand=2),
    hybrid=HybridConfig(attn_every=6, shared_attn=True),
)
