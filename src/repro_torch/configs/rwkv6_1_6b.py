"""RWKV-6 (Finch) 1.6B: 24L d_model=2048, attention-free (data-dependent
decay linear attention), channel-mix d_ff=7168, vocab=65536, head_size=64.
[arXiv:2404.05892]"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab=65536,
    norm="layernorm",
    act="silu",
    rope_kind="none",
    ssm=SSMConfig(kind="rwkv6", state_size=64, head_size=64),
)
