"""Gemma2-27B: 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000,
alternating local (sliding window 4096) + global attention, attention logit
softcap 50, final logit softcap 30, head_dim=128.  [arXiv:2408.00118]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    norm="rmsnorm",
    act="gelu",
    rope_kind="rope",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern=("local", "global"),
    tie_embeddings=True,
)
