"""Causal flash-attention prefill kernel (``csrc/prefill_attention.cu``)."""
