"""Launcher of the CUDA flash-decode kernels (``csrc/flash_decode.cu``).

Replaces ``repro/kernels/flash_decode/flash_decode.py::_decode_kernel``:
one-token GQA attention of each kv head's r query heads over the first
``kv_len[b]`` cache rows, online softmax in fp32; see the source for its
bound and design.  The kernel reads the model's cache layout [B, S, K, d]
in place (any strides with a contiguous last dim), so decode copies no cache.

The cache axis is cut into ``n_split`` splits of whole 64-row units that run
side by side, and a combine kernel folds their softmax states in split
order.  :func:`split_plan` picks the split from the shapes and the card's SM
count alone, never from ``kv_len``'s values, so a call reads nothing back
from the card and replays from a CUDA graph with ``kv_len`` changed in
place.  Two paths, named by :func:`decode_path`: ``"split"`` (n_split > 1:
split kernel, then combine) and ``"single"`` (one split: the split kernel
writes the output itself).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .._build import LaunchCounter, check, library
from ..flash_attention.flash_attention import HEAD_DIMS, rows_aligned

MAX_GROUP = 16      # largest H / K the kernel takes
SPLIT_UNIT = 64     # a split is a whole number of these cache rows (as in the source)
CTAS_PER_SM = 4     # split until about this many CTAs per SM are in flight,
MAX_SPLIT_UNITS = 2  # and until no split is longer than this many units
H100_SMS = 132      # the SM count assumed for a tensor that is not on a card
PATHS = ("split", "single")
_ENTRY = {torch.float32: "flash_decode_f32", torch.bfloat16: "flash_decode_bf16"}

#: launches of the kernel (split and combine count as one), and of each path
#: (counts kept by this wrapper only)
launches = LaunchCounter()
path_launches = {p: LaunchCounter() for p in PATHS}


def split_plan(bk: int, S: int, n_sm: int,
               n_split: Optional[int] = None) -> Tuple[int, int]:
    """``(n_split, rows_per_split)`` for ``bk`` (sequence, kv head) pairs over
    an S-row cache on a card of ``n_sm`` SMs.

    By default enough splits for about ``CTAS_PER_SM`` CTAs per SM and for
    no split longer than ``MAX_SPLIT_UNITS`` units, each a whole number of
    ``SPLIT_UNIT`` rows and none past the cache; ``n_split`` asks for another
    count, which is cut the same way.  (On an H100 the kernel is bound by
    latency: at every serve shape these counts beat two CTAs per SM.)
    """
    if n_split is not None and (not isinstance(n_split, int) or n_split < 1):
        raise ValueError(f"n_split must be a positive int, got {n_split!r}")
    units = max(1, -(-S // SPLIT_UNIT))
    want = n_split if n_split is not None else max(-(-CTAS_PER_SM * n_sm // max(bk, 1)),
                                                   -(-units // MAX_SPLIT_UNITS))
    per = -(-units // max(1, min(want, units)))
    return -(-units // per), per * SPLIT_UNIT


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return _card_sms(device.index if device.index is not None
                     else torch.cuda.current_device())


def decode_path(q: torch.Tensor, k_cache: torch.Tensor, *,
                n_split: Optional[int] = None) -> str:
    """The path a call on q [B, H, d] and a cache [B, S, K, d] takes:
    ``"split"`` or ``"single"``, from the shapes and the SM count alone
    (any device: a tensor not on a card is planned for an H100)."""
    B, S, K = q.shape[0], k_cache.shape[1], k_cache.shape[2]
    n, _ = split_plan(B * K, S, _sm_count(q.device), n_split)
    return "split" if n > 1 else "single"


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(library("flash_decode"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      kv_len: torch.Tensor, *, n_split: Optional[int] = None) -> torch.Tensor:
    """q [B, H, d] (contiguous); caches [B, S, K, d]; kv_len [B] int32 →
    [B, H, d], on the card, on the current stream, split as
    :func:`split_plan` says (``n_split`` asks for another split count)."""
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
    if q.dim() != 3 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("flash_decode_cuda takes a contiguous q [B, H, d] starting "
                         "on 16 bytes")
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
    n, rows = split_plan(B * K, S, _sm_count(q.device), n_split)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # the splits' fp32 states (o, m, l), from the caching allocator on the
    # current stream: nothing outlives the call or is shared between streams
    ws = torch.empty(B * H, n, d + 2, dtype=torch.float32, device=q.device) if n > 1 else None
    strides = (ctypes.c_longlong * 6)(*k_cache.stride()[:3], *v_cache.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _fn(q.dtype)(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        kv_len.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), strides, B, S, H, K, d,
                        rows, n, stream)
    path = "split" if n > 1 else "single"
    check(code, f"flash_decode ({path})")
    launches.add()
    path_launches[path].add()
    return out
