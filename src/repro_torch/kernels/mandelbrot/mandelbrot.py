"""Launcher of the CUDA mandelbrot kernel (``csrc/mandelbrot.cu``).

Replaces ``repro/kernels/mandelbrot/mandelbrot.py::_mandel_kernel``.  The
kernel takes a device tensor of global row ids, so one build serves every
strip; see the source for its bound and design.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._build import LaunchCounter, check, library
from .ref import XMAX, XMIN, YMAX, YMIN

#: launches of the CUDA kernel (a count kept by this wrapper only)
launches = LaunchCounter()

_MAX_GRID_Y = 65535
_BLOCK_ROWS = 8


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("mandelbrot").mandelbrot_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mandelbrot_rows_cuda(rows: torch.Tensor, width: int, total_height: int,
                         max_iter: int, *, xmin: float = XMIN, xmax: float = XMAX,
                         ymin: float = YMIN, ymax: float = YMAX) -> torch.Tensor:
    """int32 [len(rows), width] escape-time counts, on ``rows``' card and the
    current stream."""
    if rows.device.type != "cuda":
        raise ValueError(f"mandelbrot_rows_cuda needs a CUDA tensor, got {rows.device}")
    if rows.dtype != torch.int32 or rows.dim() != 1 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous 1-D int32 tensor, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    height = rows.shape[0]
    if width < 2 or total_height < 2 or max_iter < 0:
        raise ValueError(f"bad image: width={width} total_height={total_height} "
                         f"max_iter={max_iter}")
    if (height + _BLOCK_ROWS - 1) // _BLOCK_ROWS > _MAX_GRID_Y:
        raise ValueError(f"{height} rows exceed one launch's grid")
    out = torch.empty((height, width), dtype=torch.int32, device=rows.device)
    if height == 0:
        return out
    # fp32 step and bounds, rounded from the double quotient as the reference
    # rounds its weakly typed Python scalars
    f32 = lambda x: float(np.float32(x))
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    code = _fn()(rows.data_ptr(), out.data_ptr(), height, width,
                 f32(xmin), f32((xmax - xmin) / (width - 1)),
                 f32(ymin), f32((ymax - ymin) / (total_height - 1)),
                 max_iter, stream)
    check(code, "mandelbrot_rows")
    launches.add()
    return out
