"""Launcher of the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel``: the Mamba2
SSD scan of every (sequence, head), chunk by chunk, with the running [N, P]
state carried in fp32; see the source for its bound and design.  The kernel
reads the model's layout in place (x [b, S, H, P], B and C [b, S, G, N] with
any strides and a contiguous last dim), so the in-projection's slices are
not copied and the groups are not repeated per head.  It runs its own chunk
length, :data:`CHUNK`: the scan is exact under any chunking, so only the
rounding order differs from the model's chunk.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .._build import LaunchCounter, check, library

#: launches of the CUDA kernel (a count kept by this wrapper only)
launches = LaunchCounter()

CHUNK = 64                                  # Q in the source
SHAPES = ((64, 64), (64, 128), (16, 16))    # the (P, N) the kernel is built for
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(library("ssd_scan"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, S, H, P]; dt [b, S, H] fp32; A [H] fp32; B, C [b, S, G, N] in
    x's dtype → (y [b, S, H, P] in x's dtype, h_final [b, H, N, P] fp32),
    both contiguous, on the card, on the current stream.  The state starts
    from zero."""
    ts = (x, dt, A, B, C)
    if any(t.device != x.device for t in ts) or x.device.type != "cuda":
        raise ValueError("ssd_scan_cuda needs every operand on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if x.dtype not in _ENTRY or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError("ssd_scan_cuda takes float32 or bfloat16 x, B, C of one "
                         f"dtype, got {[x.dtype, B.dtype, C.dtype]}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan_cuda takes float32 dt and A")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 or C.dim() != 4:
        raise ValueError("ssd_scan_cuda takes x [b, S, H, P], dt [b, S, H], A [H], "
                         "B and C [b, S, G, N]")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,)
            or tuple(B.shape) != (b, S, G, N) or C.shape != B.shape):
        raise ValueError(f"ssd scan shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan_cuda: {H} heads over {G} groups")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan_cuda: head dim P = {P} and state N = {N} "
                         f"not among {SHAPES}")
    if any(t.stride(-1) != 1 for t in (x, B, C)) or not A.is_contiguous():
        raise ValueError("ssd_scan_cuda takes x, B, C with a contiguous last dim "
                         "and a contiguous A")
    y = torch.empty(b, S, H, P, dtype=x.dtype, device=x.device)
    h = torch.empty(b, H, N, P, dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return y, h
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                                       *C.stride()[:3])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(x.dtype)(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                        C.data_ptr(), y.data_ptr(), h.data_ptr(), strides, b, S, H, G, P, N, stream)
    check(code, "ssd_scan")
    launches.add()
    return y, h
