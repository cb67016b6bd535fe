"""Plain PyTorch version of the grouped-matmul kernel (K6).

The reference's oracle (``repro/kernels/grouped_matmul/ref.py``): the
per-expert products in fp32, rounded to x's dtype.  On the card only
``chip_smoke.py`` and the card tests call it, to hold the kernel against it.
"""
from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, D] @ w: [E, D, F] → [E, C, F] in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)
