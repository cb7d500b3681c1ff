"""PyTorch/CUDA port of the DMA-Latte reproduction, for NVIDIA Hopper.

Mirrors the module layout of the JAX package ``repro`` (the reference it is
tested against) and imports nothing of it, nor of JAX.
"""
