"""Mandelbrot strip ops: the plain version on the CPU, the kernel on the card."""
from __future__ import annotations

import torch

from ..._device import DeviceLike
from .mandelbrot import mandelbrot_rows_cuda
from .ref import mandelbrot_rows_ref


def mandelbrot_rows(rows: torch.Tensor, width: int, total_height: int,
                    max_iter: int) -> torch.Tensor:
    """Counts for global row ids ``rows``: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor; anything else raises."""
    if rows.device.type == "cuda":
        return mandelbrot_rows_cuda(rows, width, total_height, max_iter)
    if rows.device.type == "cpu":
        return mandelbrot_rows_ref(rows, width, total_height, max_iter)
    raise ValueError(f"mandelbrot_rows: unsupported device {rows.device}")


def mandelbrot_strip(height: int, width: int, *, max_iter: int = 100,
                     row_offset: int = 0, total_height: int = 0,
                     device: DeviceLike) -> torch.Tensor:
    """Rows ``row_offset … row_offset+height`` of a ``total_height`` image
    (the whole image when 0) — the counterpart of ``repro``'s
    ``mandelbrot_strip``."""
    rows = torch.arange(row_offset, row_offset + height, dtype=torch.int32,
                        device=device)
    return mandelbrot_rows(rows, width, total_height or height, max_iter)
