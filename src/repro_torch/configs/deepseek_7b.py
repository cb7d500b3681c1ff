"""DeepSeek-7B (base): llama-arch, 30L d_model=4096 32H (GQA kv=32)
d_ff=11008 vocab=102400.  [arXiv:2401.02954]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    source="arXiv:2401.02954",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    norm="rmsnorm",
    act="silu",
    rope_kind="rope",
)
