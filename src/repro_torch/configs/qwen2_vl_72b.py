"""Qwen2-VL-72B language backbone: 80L d_model=8192 64H (GQA kv=8)
d_ff=29568 vocab=152064, M-RoPE (t/h/w sections), dynamic-resolution vision
encoder is a STUB (input_specs provides patch embeddings).
[arXiv:2409.12191]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t,h,w split of head_dim/2=64
    stub_frontend=True,
)
