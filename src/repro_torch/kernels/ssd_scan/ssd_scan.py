"""Launcher of the CUDA SSD chunked-scan kernels (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel``: the Mamba2
SSD scan of every (sequence, head), chunk by chunk, with the running [N, P]
state carried in fp32; see the source for its bound and design.  The kernels
read the model's layout in place (x [b, S, H, P], B and C [b, S, G, N] with
any strides, a contiguous last dim and 16-byte aligned rows), so the
in-projection's slices are not copied and the groups are not repeated per
head.  They run their own chunk length, :data:`CHUNK`: the scan is exact
under any chunking, so only the rounding order differs from the model's
chunk.

Each (sequence, head) is one thread-block cluster of up to
:data:`MAX_CLUSTER` CTAs, each taking a run of whole chunks
(:func:`ssd_plan`: about :data:`CHUNKS_PER_CTA` each); the runs' states are
folded in cluster order through distributed shared memory.  Two paths,
picked up front by :func:`ssd_path` from dtype and shape: ``"wgmma"`` (bf16
at P = 64, N = 64 or 128: the products on the tensor cores) and ``"fma"``
(fp32, and the P = N = 16 smoke shape: CUDA-core FMAs).  A path that fails to launch raises; nothing falls
back to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .._build import LaunchCounter, check, library
from ..flash_attention.flash_attention import rows_aligned

CHUNK = 64                                  # Q in the source
MAX_CLUSTER = 8                             # CTAs per (sequence, head), the portable limit
# chunks a CTA takes by default: on an H100 (700 W) runs of four beat runs of
# one at both served prefill shapes (zamba2-2.7b 0.0748 against 0.0832 ms,
# mamba2-130m 0.0444 against 0.0538): fewer CTAs and fold hops, each CTA's
# load latency hidden behind the other CTAs on its SM
CHUNKS_PER_CTA = 4
SHAPES = ((64, 64), (64, 128), (16, 16))    # the (P, N) the kernels are built for
WGMMA_SHAPES = ((64, 64), (64, 128))        # bf16 on the tensor cores
PATHS = ("wgmma", "fma")
_ENTRY = {("fma", torch.float32): "ssd_scan_f32", ("fma", torch.bfloat16): "ssd_scan_bf16",
          ("wgmma", torch.bfloat16): "ssd_scan_bf16_wgmma"}

#: launches of either kernel, and of each path (counts kept by this wrapper only)
launches = LaunchCounter()
path_launches = {p: LaunchCounter() for p in PATHS}


def ssd_plan(S: int, cluster: Optional[int] = None) -> Tuple[int, int]:
    """``(cluster, chunks_per_cta)`` for one (sequence, head) of S rows.

    The ``ceil(S / CHUNK)`` chunks go to ``cluster`` CTAs (by default enough
    for about :data:`CHUNKS_PER_CTA` chunks each, at most
    :data:`MAX_CLUSTER`), each a run of the same number of whole chunks but
    the last, and no CTA without one: S = 512 is 2 CTAs of four chunks, 300
    is 2 of three (the second two), 2048 is 8 of four, 4096 is 8 of eight;
    asked for 8, S = 512 is 8 CTAs of one.  S = 0 is one CTA.
    """
    if cluster is not None and (not isinstance(cluster, int)
                                or not 1 <= cluster <= MAX_CLUSTER):
        raise ValueError(f"cluster must be an int in 1..{MAX_CLUSTER}, got {cluster!r}")
    chunks = max(1, -(-S // CHUNK))
    if cluster is None:
        cluster = min(MAX_CLUSTER, -(-chunks // CHUNKS_PER_CTA))
    per = -(-chunks // min(cluster, chunks))
    return -(-chunks // per), per


def ssd_path(x: torch.Tensor, B: torch.Tensor) -> str:
    """The kernel that takes x [b, S, H, P] and B (or C) [b, S, G, N]:
    ``"wgmma"`` or ``"fma"``, from dtype, shape and strides alone (any
    device); raises ``ValueError`` on what neither takes."""
    if x.dtype not in (torch.float32, torch.bfloat16) or B.dtype != x.dtype:
        raise ValueError("ssd_scan_cuda takes float32 or bfloat16 x, B, C of one "
                         f"dtype, got {[x.dtype, B.dtype]}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError("ssd_scan_cuda takes x [b, S, H, P] and B, C [b, S, G, N]")
    P, N = x.shape[3], B.shape[3]
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan_cuda: head dim P = {P} and state N = {N} "
                         f"not among {SHAPES}")
    if any(t.stride(-1) != 1 or not rows_aligned(t) for t in (x, B)):
        raise ValueError("ssd_scan_cuda takes x, B, C with a contiguous last dim "
                         "and 16-byte aligned rows")
    return "wgmma" if x.dtype == torch.bfloat16 and (P, N) in WGMMA_SHAPES else "fma"


@functools.lru_cache(maxsize=None)
def _fn(path: str, dtype: torch.dtype):
    fn = getattr(library("ssd_scan"), _ENTRY[path, dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, cluster: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, S, H, P]; dt [b, S, H] fp32; A [H] fp32; B, C [b, S, G, N] in
    x's dtype → (y [b, S, H, P] in x's dtype, h_final [b, H, N, P] fp32),
    both contiguous, on the card, on the current stream.  The state starts
    from zero.  ``cluster`` asks :func:`ssd_plan` for another number of CTAs
    per (sequence, head)."""
    ts = (x, dt, A, B, C)
    if any(t.device != x.device for t in ts) or x.device.type != "cuda":
        raise ValueError("ssd_scan_cuda needs every operand on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if C.dtype != B.dtype:
        raise ValueError(f"ssd_scan_cuda takes B and C of one dtype, got {[B.dtype, C.dtype]}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan_cuda takes float32 dt and A")
    path = ssd_path(x, B)
    ssd_path(x, C)
    if dt.dim() != 3 or A.dim() != 1:
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
    if not A.is_contiguous():
        raise ValueError("ssd_scan_cuda takes a contiguous A")
    n_cta, per = ssd_plan(S, cluster)
    y = torch.empty(b, S, H, P, dtype=x.dtype, device=x.device)
    h = torch.empty(b, H, N, P, dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return y, h
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                                       *C.stride()[:3])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(path, x.dtype)(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                              C.data_ptr(), y.data_ptr(), h.data_ptr(), strides, b, S, H,
                              G, P, N, n_cta, per, stream)
    check(code, f"ssd_scan ({path})")
    launches.add()
    path_launches[path].add()
    return y, h
