"""Qwen2-0.5B: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings.  [arXiv:2407.10671]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    rope_kind="rope",
    rope_theta=1_000_000.0,
)
