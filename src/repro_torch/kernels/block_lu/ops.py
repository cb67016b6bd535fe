"""Sparselu block ops: ``bmod`` dispatches to the CUDA kernel on the card and
to the plain version on the CPU; the solves are plain PyTorch everywhere."""
from __future__ import annotations

import torch

from .block_lu import bmod_cuda
from .ref import bdiv_ref, bmod_ref, fwd_ref, lu0_ref


def bmod_op(a: torch.Tensor, l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A − L·U: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; anything else raises."""
    if a.device.type == "cuda":
        return bmod_cuda(a, l, u)
    if a.device.type == "cpu":
        return bmod_ref(a, l, u)
    raise ValueError(f"bmod_op: unsupported device {a.device}")


lu0_op = lu0_ref
fwd_op = fwd_ref
bdiv_op = bdiv_ref
