"""The BOTS fib leaf: the kernel on the card, the plain version on the CPU."""
from __future__ import annotations

from typing import Tuple

import torch

from .busy_loop import fib_subtree_cuda
from .ref import fib_subtree_ref


def fib_subtree(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fib(n) with the busy loop's result folded in, the busy accumulator):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor;
    anything else raises."""
    if n.device.type == "cuda":
        return fib_subtree_cuda(n)
    if n.device.type == "cpu":
        return fib_subtree_ref(n)
    raise ValueError(f"fib_subtree: unsupported device {n.device}")
