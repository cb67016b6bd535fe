"""Launcher of the CUDA busy-loop kernel (``csrc/busy_loop.cu``).

The BOTS fib leaf on the card: fib(n), the busy loop of
``(2 fib(n) - 1) * 600`` dependent fp32 steps on 128 lanes, and the fold of
its result into the output, in one launch of one block.  It ports the
compiled ``fori_loop`` of ``benchmarks/bots_fib.py`` (no TPU kernel: XLA
compiles that loop), which eager PyTorch would run as millions of launches.
The kernel reads ``n`` on the card, so a leaf never waits for the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .._build import LaunchCounter, check, library
from .ref import LANES

#: launches of the CUDA kernel (a count kept by this wrapper only)
launches = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("busy_loop").fib_subtree
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def fib_subtree_cuda(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """n (an int32 scalar on the card) -> (fib(n) fp32 with the busy
    result folded in, the busy accumulator [LANES]), on the current stream."""
    if n.device.type != "cuda":
        raise ValueError(f"fib_subtree_cuda needs a CUDA tensor, got {n.device}")
    if n.dtype != torch.int32 or n.numel() != 1:
        raise ValueError(f"n must be one int32, got {n.dtype} {tuple(n.shape)}")
    n = n.contiguous()
    out = torch.empty((), dtype=torch.float32, device=n.device)
    acc = torch.empty(LANES, dtype=torch.float32, device=n.device)
    stream = torch.cuda.current_stream(n.device).cuda_stream
    code = _fn()(n.data_ptr(), out.data_ptr(), acc.data_ptr(), stream)
    check(code, "fib_subtree")
    launches.add()
    return out, acc
