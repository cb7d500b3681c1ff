"""StableLM-2-12B: 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352,
LayerNorm (stablelm-2 family).  [hf:stabilityai/stablelm-2-1_6b]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    qkv_bias=False,
    norm="layernorm",
    act="silu",
    rope_kind="rope",
)
