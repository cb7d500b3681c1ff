"""Device and dtype selection for the PyTorch port.

The port's entry points run on the card.  They run on the CPU only when the
caller asks for it by name (``device="cpu"``, as the CPU tests do); there is
no silent fallback from CUDA to the CPU.
"""
from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for (the
    default) and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> ``torch.dtype``."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None
