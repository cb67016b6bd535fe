"""Launcher of the CUDA grouped-matmul kernels (``csrc/grouped_matmul.cu``).

Replaces ``repro/kernels/grouped_matmul/grouped_matmul.py::_gmm_kernel``:
``out[e] = x[e] @ w[e]`` for every expert, fp32 accumulation, the result in
x's dtype; see the source for its bound and design.

Three paths, picked up front by :func:`gmm_path` from dtype, shape and
strides: ``"wgmma"`` (the tensor-core kernel, bf16 prefill), ``"small_c"``
(bf16 decode: C <= 16, empty experts skipped on the device) and
``"cuda_core"`` (fp32, or rows that do not start on 16 bytes, such as a
ragged D or F).  A path that fails to launch raises; nothing falls back to
another.

With ``counts`` (int32 [E] on the card: the rows of x[e] that hold tokens,
the dropless MoE's), no path computes, loads or stores a row of expert e at
or past ``counts[e]``: a CTA whose row tile starts past it exits at once,
so an empty expert reads no weight.  Those rows of the output are left
unwritten.  Nothing is read back to the host, so the call can be captured.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .._build import LaunchCounter, check, library

PATHS = ("wgmma", "small_c", "cuda_core")
_ENTRY = {("cuda_core", torch.float32): "grouped_matmul_f32",
          ("cuda_core", torch.bfloat16): "grouped_matmul_bf16",
          ("wgmma", torch.bfloat16): "grouped_matmul_bf16_wgmma",
          ("small_c", torch.bfloat16): "grouped_matmul_bf16_small_c"}
MAX_GRID = 65535        # the grid's y (C / 64) and z (E) limits
SMALL_C = 16            # the small-C path's largest C ...
SMALL_C_X_BYTES = 96 * 1024   # ... and largest x[e] (it sits in shared memory)

#: the rows a counted expert's computed rows round up to, by path: the
#: tensor-core path's 64-row warpgroup, each small-C row, a CUDA-core
#: thread's 4 rows
ROW_TILE = {"wgmma": 64, "small_c": 1, "cuda_core": 4}

#: launches of any kernel, and of each path (counts kept by this wrapper only)
launches = LaunchCounter()
path_launches = {p: LaunchCounter() for p in PATHS}


def _rows_aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Every row of the contiguous x [E, C, D] and w [E, D, F] starts on 16
    bytes, so the kernels may stage them with 16-byte loads or TMA boxes."""
    es = x.element_size()
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and x.shape[2] * es % 16 == 0 and w.shape[2] * es % 16 == 0)


def gmm_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel that takes x [E, C, D] @ w [E, D, F]: ``"wgmma"``,
    ``"small_c"`` or ``"cuda_core"``, from dtype, shape and strides alone
    (any device); raises ``ValueError`` on what none takes."""
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError("grouped_matmul_cuda takes float32 or bfloat16 x and w of "
                         f"one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul_cuda takes contiguous x [E, C, D] and "
                         "w [E, D, F]")
    E, C, D = x.shape
    if tuple(w.shape[:2]) != (E, D):
        raise ValueError(f"grouped matmul shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if E > MAX_GRID or (C + 63) // 64 > MAX_GRID:
        raise ValueError(f"grouped_matmul_cuda: E = {E} or C = {C} exceeds the grid")
    return path_of(x.dtype, C, D, w.shape[2], _rows_aligned(x, w))


def path_of(dtype: torch.dtype, C: int, D: int, F: int, aligned: bool = True) -> str:
    """:func:`gmm_path` from the shapes alone; ``aligned``: the bases start
    on 16 bytes (any tensor the allocator made)."""
    es = torch.tensor([], dtype=dtype).element_size()
    if dtype != torch.bfloat16 or not aligned or D * es % 16 or F * es % 16:
        return "cuda_core"
    if C <= SMALL_C and C * D * es <= SMALL_C_X_BYTES:
        return "small_c"
    return "wgmma"


@functools.lru_cache(maxsize=None)
def _fn(path: str, dtype: torch.dtype):
    fn = getattr(library("grouped_matmul"), _ENTRY[path, dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                        counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] → [E, C, F] on the card, on the current
    stream, by the kernel :func:`gmm_path` picks; with ``counts`` (int32
    [E] on x's device) only rows below ``counts[e]`` of expert e."""
    if x.device != w.device or x.device.type != "cuda":
        raise ValueError("grouped_matmul_cuda needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if counts is not None and (counts.device != x.device or counts.dtype != torch.int32
                               or tuple(counts.shape) != (x.shape[0],)
                               or not counts.is_contiguous()):
        raise ValueError("grouped_matmul_cuda takes counts as contiguous int32 [E] on "
                         f"x's device, got {counts.dtype} {tuple(counts.shape)} on "
                         f"{counts.device}")
    path = gmm_path(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty(E, C, F, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(path, x.dtype)(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
                              None if counts is None else counts.data_ptr(), stream)
    check(code, f"grouped_matmul ({path})")
    launches.add()
    path_launches[path].add()
    return out
