"""NVIDIA H100 SXM constants for the roofline (one GPU; the port states no
figure taken for a TPU).

Compute, HBM and NVLink are the H100 SXM datasheet's.  The inter-node rate
is one 400 Gb/s NDR InfiniBand NIC per GPU, a DGX H100's layout.  The
roofline's collective term divides by ``LINK_BW``, the inter-node rate: the
production mesh's 16-wide ``model`` axis spans two 8-GPU nodes, so its ring
crosses a node boundary and runs at the slower link's rate.
"""

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, per GPU
PEAK_FP32_FLOPS = 67e12         # float32 outside the tensor cores, per GPU
HBM_BW = 3.35e12                # bytes/s per GPU (HBM3)
NVLINK_BW = 450e9               # bytes/s per GPU per direction, within a node of 8
INTER_NODE_BW = 50e9            # bytes/s per GPU per direction (400 Gb/s NDR)
LINK_BW = INTER_NODE_BW         # the collective term's rate (see above)
