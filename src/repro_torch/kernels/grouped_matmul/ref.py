"""Plain PyTorch version of the grouped-matmul kernel (K6).

The reference's oracle (``repro/kernels/grouped_matmul/ref.py``): the
per-expert products in fp32, rounded to x's dtype.  On the card only
``chip_smoke.py`` and the card tests call it, to hold the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [E, C, D] @ w: [E, D, F] → [E, C, F] in x's dtype; with
    ``counts`` [E], the rows of expert e at or past ``counts[e]`` are zeros
    (whatever x holds there)."""
    out = torch.einsum("ecd,edf->ecf", x.to(torch.float32),
                       w.to(torch.float32)).to(x.dtype)
    if counts is None:
        return out
    rows = torch.arange(x.shape[1], device=x.device)
    return torch.where(rows[None, :, None] < counts.to(x.device)[:, None, None], out, 0)
