"""Whisper-tiny: encoder-decoder, 4L each, d_model=384 6H d_ff=1536
vocab=51865.  The mel-spectrogram + conv frontend is a STUB — input_specs
provides precomputed frame embeddings (1500 frames).  [arXiv:2212.04356]"""
from .base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    rope_kind="sinusoidal",
    encdec=EncDecConfig(n_encoder_layers=4, encoder_seq=1500),
    stub_frontend=True,
)
