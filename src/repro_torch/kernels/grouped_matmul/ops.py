"""Expert-FFN matmul: the CUDA kernel on the card, the plain version on the
CPU (the port of ``repro/kernels/grouped_matmul/ops.py``)."""
from __future__ import annotations

import torch

from .. import refuse_grad
from .grouped_matmul import grouped_matmul_cuda
from .ref import grouped_matmul_ref


def expert_ffn_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] → [E, C, F], fp32 accumulation, in x's
    dtype: the kernel for CUDA tensors, the plain version for CPU tensors;
    anything else raises.  Under grad mode, an input that requires grad raises
    on either device (``kernels.refuse_grad``): the kernel has no backward."""
    refuse_grad("grouped_matmul", x, w)
    if x.device.type == "cuda":
        return grouped_matmul_cuda(x, w)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    raise ValueError(f"expert_ffn_matmul: unsupported device {x.device}")
