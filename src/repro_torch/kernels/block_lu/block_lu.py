"""Launcher of the CUDA bmod kernel (``csrc/block_lu.cu``).

Replaces ``repro/kernels/block_lu/block_lu.py::_bmod_kernel``: A − L·U with
an fp32 accumulator, written in A's dtype; see the source for its bound and
design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import LaunchCounter, check, library

#: launches of the CUDA kernel (a count kept by this wrapper only)
launches = LaunchCounter()

_ENTRY = {torch.float32: "bmod_f32", torch.bfloat16: "bmod_bf16"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(library("block_lu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bmod_cuda(a: torch.Tensor, l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """a [M,N] − l [M,K] @ u [K,N] on the card, on the current stream."""
    ts = (a, l, u)
    if any(t.device != a.device for t in ts) or a.device.type != "cuda":
        raise ValueError("bmod_cuda needs a, l, u on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if a.dtype not in _ENTRY or any(t.dtype != a.dtype for t in ts):
        raise ValueError("bmod_cuda takes float32 or bfloat16 operands of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if any(t.dim() != 2 or not t.is_contiguous() for t in ts):
        raise ValueError("bmod_cuda takes contiguous 2-D operands")
    M, N = a.shape
    K = l.shape[1]
    if tuple(l.shape) != (M, K) or tuple(u.shape) != (K, N):
        raise ValueError(f"bmod shapes: a {tuple(a.shape)}, l {tuple(l.shape)}, "
                         f"u {tuple(u.shape)}")
    out = torch.empty_like(a)
    if M == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = _fn(a.dtype)(a.data_ptr(), l.data_ptr(), u.data_ptr(), out.data_ptr(),
                        M, N, K, stream)
    check(code, "bmod")
    launches.add()
    return out
