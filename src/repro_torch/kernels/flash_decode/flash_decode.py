"""Launcher of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Replaces ``repro/kernels/flash_decode/flash_decode.py::_decode_kernel``:
one-token GQA attention of each kv head's r query heads over the first
``kv_len[b]`` cache rows, online softmax in fp32; see the source for its
bound and design.  The kernel reads the model's cache layout [B, S, K, d]
in place (any strides with a contiguous last dim), so decode copies no cache.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import LaunchCounter, check, library
from ..flash_attention.flash_attention import HEAD_DIMS, rows_aligned

#: launches of the CUDA kernel (a count kept by this wrapper only)
launches = LaunchCounter()

MAX_GROUP = 16      # largest H / K the kernel takes (RMAX in the source)
_ENTRY = {torch.float32: "flash_decode_f32", torch.bfloat16: "flash_decode_bf16"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(library("flash_decode"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      kv_len: torch.Tensor) -> torch.Tensor:
    """q [B, H, d] (contiguous); caches [B, S, K, d]; kv_len [B] int32 →
    [B, H, d], on the card, on the current stream."""
    if q.dim() == 0 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_decode_cuda: head dim {tuple(q.shape)[-1:]} "
                         f"not in {HEAD_DIMS}")
    ts = (q, k_cache, v_cache, kv_len)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError("flash_decode_cuda needs q, caches and kv_len on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if q.dtype not in _ENTRY or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("flash_decode_cuda takes float32 or bfloat16 q and caches "
                         f"of one dtype, got {[t.dtype for t in ts[:3]]}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError("flash_decode_cuda takes a contiguous q [B, H, d]")
    if any(t.dim() != 4 or t.stride(3) != 1 or not rows_aligned(t)
           for t in (k_cache, v_cache)):
        raise ValueError("flash_decode_cuda takes caches [B, S, K, d] with a "
                         "contiguous last dim and 16-byte aligned rows")
    B, H, d = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (B, S, K, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"flash_decode_cuda: {H} query heads over {K} kv heads "
                         f"(groups of at most {MAX_GROUP})")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,) \
            or not kv_len.is_contiguous():
        raise ValueError("flash_decode_cuda takes a contiguous int32 kv_len [B]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 6)(*k_cache.stride()[:3], *v_cache.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _fn(q.dtype)(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        kv_len.data_ptr(), out.data_ptr(), strides, B, S, H, K, d,
                        stream)
    check(code, "flash_decode")
    launches.add()
    return out
