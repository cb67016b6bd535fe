"""Launcher of the CUDA grouped-matmul kernel (``csrc/grouped_matmul.cu``).

Replaces ``repro/kernels/grouped_matmul/grouped_matmul.py::_gmm_kernel``:
``out[e] = x[e] @ w[e]`` for every expert, fp32 accumulation, the result in
x's dtype; see the source for its bound and design.  The kernel stages rows
with 16-byte loads where every row of x and w starts on 16 bytes, and one
element at a time otherwise (a ragged D or F); this launcher checks which.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import LaunchCounter, check, library

#: launches of the CUDA kernel (a count kept by this wrapper only)
launches = LaunchCounter()

_ENTRY = {torch.float32: "grouped_matmul_f32", torch.bfloat16: "grouped_matmul_bf16"}
MAX_GRID = 65535        # the grid's y (C / 64) and z (E) limits


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(library("grouped_matmul"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows_aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Every row of the contiguous x [E, C, D] and w [E, D, F] starts on 16
    bytes, so the kernel may stage them with 16-byte loads."""
    es = x.element_size()
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and x.shape[2] * es % 16 == 0 and w.shape[2] * es % 16 == 0)


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] → [E, C, F] on the card, on the current
    stream."""
    if x.device != w.device or x.device.type != "cuda":
        raise ValueError("grouped_matmul_cuda needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise ValueError("grouped_matmul_cuda takes float32 or bfloat16 x and w of "
                         f"one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul_cuda takes contiguous x [E, C, D] and "
                         "w [E, D, F]")
    E, C, D = x.shape
    F = w.shape[2]
    if tuple(w.shape[:2]) != (E, D):
        raise ValueError(f"grouped matmul shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if E > MAX_GRID or (C + 63) // 64 > MAX_GRID:
        raise ValueError(f"grouped_matmul_cuda: E = {E} or C = {C} exceeds the grid")
    out = torch.empty(E, C, F, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(x.dtype)(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
                        int(_rows_aligned(x, w)), stream)
    check(code, "grouped_matmul")
    launches.add()
    return out
