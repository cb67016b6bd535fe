"""Launcher of the CUDA block-int8 wire kernel (``csrc/q8_wire.cu``).

A port-only kernel: the reference's wire round trip
(``src/repro/core/compression.py:34-48``, quantize then dequantize) is one
XLA fusion, which eager PyTorch would run as about eight launches.  One
launch computes it here, over an fp32 buffer of any length, with the
reference's block of 256 values per scale; see the source for its bound.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import LaunchCounter, check, library

BLOCK = 256             # values per scale: the kernel's warp covers one block

#: launches of the CUDA kernel (a count kept by this wrapper only)
launches = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _fn():
    fn = library("q8_wire").q8_wire
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def q8_roundtrip_cuda(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """decompress(compress(x)) in one launch, into a new tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"q8_wire needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"q8_wire takes fp32, got {x.dtype}")
    if block != BLOCK:
        raise ValueError(f"q8_wire's kernel has block {BLOCK}, got {block}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        check(_fn()(x.data_ptr(), out.data_ptr(), x.numel(), stream), "q8_wire")
        launches.add()
    return out
