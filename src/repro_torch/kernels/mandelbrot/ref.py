"""Plain PyTorch version of the mandelbrot strip kernel.

The same fp32 operations, in the same order, as the JAX table kernel
``mandel_strip(rows)`` of ``benchmarks/bots_mandelbrot.py``: every pixel runs
all ``max_iter`` iterations under an "alive" mask.  It runs on any device;
the tests use it on the CPU and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import torch

XMIN, XMAX, YMIN, YMAX = -2.0, 0.6, -1.3, 1.3


def mandelbrot_rows_ref(rows: torch.Tensor, width: int, total_height: int,
                        max_iter: int, *, xmin: float = XMIN, xmax: float = XMAX,
                        ymin: float = YMIN, ymax: float = YMAX) -> torch.Tensor:
    """Escape-time counts int32 [len(rows), width] for global row ids ``rows``
    of a ``total_height`` x ``width`` image of [xmin,xmax]×[ymin,ymax]."""
    dev = rows.device
    cols = torch.arange(width, device=dev)[None, :]
    # a Python-float step times an fp32 index computes in fp32, as JAX's
    # weakly typed scalar does
    cx = xmin + cols.to(torch.float32) * ((xmax - xmin) / (width - 1))
    cy = ymin + rows[:, None].to(torch.float32) * ((ymax - ymin) / (total_height - 1))
    shape = (rows.shape[0], width)
    zx = torch.zeros(shape, dtype=torch.float32, device=dev)
    zy = torch.zeros(shape, dtype=torch.float32, device=dev)
    count = torch.zeros(shape, dtype=torch.int32, device=dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        zx2, zy2 = zx * zx, zy * zy
        alive = alive & (zx2 + zy2 <= 4.0)
        nzx = zx2 - zy2 + cx
        nzy = 2.0 * zx * zy + cy
        zx = torch.where(alive, nzx, zx)
        zy = torch.where(alive, nzy, zy)
        count = count + alive.to(torch.int32)
    return count
