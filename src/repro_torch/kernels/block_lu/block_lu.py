"""Launcher of the CUDA bmod kernel (``csrc/block_lu.cu``).

Replaces ``repro/kernels/block_lu/block_lu.py::_bmod_kernel``: A − L·U with
an fp32 accumulator, written in A's dtype; see the source for its bound and
design.

One kernel, two ways of filling its shared-memory ring, named by
:func:`bmod_path`: ``"cp_async"`` (16-byte asynchronous copies: L and U
16-byte aligned, their rows a multiple of 16 bytes — every sparselu block)
and ``"elementwise"`` (plain loads, any other shape).  Both sum each output
in the same order, so they give the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import LaunchCounter, check, library

PATHS = ("cp_async", "elementwise")
TILE = 32           # each CTA's output tile is TILE x TILE (BM = BN in the source)

#: launches of the CUDA kernel, and of each path (counts kept by this wrapper only)
launches = LaunchCounter()
path_launches = {p: LaunchCounter() for p in PATHS}

_ENTRY = {torch.float32: "bmod_f32", torch.bfloat16: "bmod_bf16"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(library("block_lu"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bmod_path(l: torch.Tensor, u: torch.Tensor) -> str:
    """How the kernel stages l [M, K] and u [K, N] (contiguous, any device):
    ``"cp_async"`` when both start on 16 bytes and their rows are whole
    16-byte chunks, else ``"elementwise"``."""
    return ("cp_async" if all(t.data_ptr() % 16 == 0
                              and (t.shape[-1] * t.element_size()) % 16 == 0
                              for t in (l, u)) else "elementwise")


def bmod_cuda(a: torch.Tensor, l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """a [M,N] − l [M,K] @ u [K,N] on the card, on the current stream, on
    the path :func:`bmod_path` names."""
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
    path = bmod_path(l, u)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = _fn(a.dtype)(a.data_ptr(), l.data_ptr(), u.data_ptr(), out.data_ptr(),
                        M, N, K, int(path == "cp_async"), stream)
    check(code, f"bmod ({path})")
    launches.add()
    path_launches[path].add()
    return out
