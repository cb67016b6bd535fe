"""Model-layout SSD chunked scan: the CUDA kernel on the card, the plain
version on the CPU (the port of ``repro/kernels/ssd_scan/ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from .ref import ssd_chunked
from .ssd_scan import ssd_scan_cuda


def ssd_chunked_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x [b, S, H, P], dt [b, S, H], A [H], B/C [b, S, G, N]
    → (y [b, S, H, P], h_final [b, H, N, P] fp32), a drop-in for
    ``ssd_chunked`` started from a zero state.

    A CUDA tensor launches the kernel on the operands in place, at the
    kernel's own chunk length (``ssd_scan.CHUNK``: ``chunk`` is not used
    there); a CPU tensor runs the plain version with ``chunk``; anything
    else raises.
    """
    if x.device.type == "cuda":
        return ssd_scan_cuda(x, dt, A, B, C)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_chunked_scan: unsupported device {x.device}")
    return ssd_chunked(x, dt, A, B, C, chunk=chunk)
