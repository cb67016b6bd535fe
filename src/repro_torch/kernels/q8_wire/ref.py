"""Plain PyTorch version of the block-int8 wire (``csrc/q8_wire.cu``): the
composition of :func:`~repro_torch.core.compression.compress` and
:func:`~repro_torch.core.compression.decompress`, the reference's own order
of operations, on any device."""
from __future__ import annotations

import torch

from ...core.compression import compress, decompress


def q8_roundtrip_ref(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """What the wire does to a message: quantize, then dequantize (a new
    tensor of ``x``'s shape and dtype)."""
    return decompress(compress(x, block), tuple(x.shape), x.dtype)
