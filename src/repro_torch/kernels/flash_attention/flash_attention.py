"""Launcher of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/flash_attention.py::_flash_kernel``:
causal / sliding-window GQA attention forward with an online softmax in
fp32; see the source for its bound and design.  The kernels read the model's
layout directly (q [B, Sq, H, d], k/v [B, Skv, K, d], any strides with a
contiguous last dim and 16-byte aligned rows), so no transpose is copied.

Two paths, picked up front by :func:`attention_path` from dtype, shape and
strides: ``"wgmma"`` (the tensor-core kernel: bf16 at d = 64, 80, 128) and
``"cuda_core"`` (fp32 at every d, bf16 at d = 256).  A path that fails to
launch raises; nothing falls back to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import LaunchCounter, check, library

HEAD_DIMS = (64, 80, 128, 256)   # 80: zamba2-2.7b's shared attention block
WGMMA_HEAD_DIMS = (64, 80, 128)  # bf16 on the tensor cores
PATHS = ("wgmma", "cuda_core")
_ENTRY = {("cuda_core", torch.float32): "flash_attention_f32",
          ("cuda_core", torch.bfloat16): "flash_attention_bf16",
          ("wgmma", torch.bfloat16): "flash_attention_bf16_wgmma"}

#: launches of either kernel, and of each path (counts kept by this wrapper only)
launches = LaunchCounter()
path_launches = {p: LaunchCounter() for p in PATHS}


def rows_aligned(t: torch.Tensor) -> bool:
    """Every [.., d] row of ``t`` starts on 16 bytes (the kernels stage rows
    with 16-byte loads or TMA boxes); strides of size-1 dims never move a
    row."""
    return t.data_ptr() % 16 == 0 and all(
        (s * t.element_size()) % 16 == 0
        for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def attention_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes q [B, Sq, H, d], k, v [B, Skv, K, d]:
    ``"wgmma"`` or ``"cuda_core"``, from dtype, shape and strides alone (any
    device); raises ``ValueError`` on what neither takes."""
    if q.dim() == 0 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {tuple(q.shape)[-1:]} "
                         f"not in {HEAD_DIMS}")
    ts = (q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in ts):
        raise ValueError("flash_attention_cuda takes float32 or bfloat16 operands "
                         f"of one dtype, got {[t.dtype for t in ts]}")
    if any(t.dim() != 4 or t.stride(3) != 1 or not rows_aligned(t) for t in ts):
        raise ValueError("flash_attention_cuda takes 4-D operands with a "
                         "contiguous last dim and 16-byte aligned rows")
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, K, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention_cuda: {H} query heads over {K} kv heads")
    if q.dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


@functools.lru_cache(maxsize=None)
def _fn(path: str, dtype: torch.dtype):
    fn = getattr(library("flash_attention"), _ENTRY[path, dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, Sq, H, d]; k, v [B, Skv, K, d] → [B, Sq, H, d] (contiguous), on
    the card, on the current stream, by the kernel :func:`attention_path`
    picks."""
    path = attention_path(q, k, v)
    ts = (q, k, v)
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    B, Sq, H, d = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty(B, Sq, H, d, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _fn(path, q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              strides, B, Sq, Skv, H, K, d, int(causal), int(window),
                              stream)
    check(code, f"flash_attention ({path})")
    launches.add()
    path_launches[path].add()
    return out
