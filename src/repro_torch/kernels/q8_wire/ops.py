"""The block-int8 wire: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor; anything else raises (no fallback)."""
from __future__ import annotations

import torch

from .q8_wire import q8_roundtrip_cuda
from .ref import q8_roundtrip_ref


def q8_roundtrip(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """What the wire does to a message: quantize, then dequantize."""
    if x.device.type == "cuda":
        return q8_roundtrip_cuda(x, block)
    if x.device.type == "cpu":
        return q8_roundtrip_ref(x, block)
    raise ValueError(f"q8_roundtrip: unsupported device {x.device}")
