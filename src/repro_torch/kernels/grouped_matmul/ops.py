"""Expert-FFN matmul: the CUDA kernel on the card, the plain version on the
CPU (the port of ``repro/kernels/grouped_matmul/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import refuse_grad
from .grouped_matmul import grouped_matmul_cuda
from .ref import grouped_matmul_ref


def expert_ffn_matmul(x: torch.Tensor, w: torch.Tensor,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] → [E, C, F], fp32 accumulation, in x's
    dtype: the kernel for CUDA tensors, the plain version for CPU tensors;
    anything else raises.  ``counts`` (int32 [E], on x's device): only the
    rows of expert e below ``counts[e]`` are computed; the rest of the
    output is unspecified (the kernel leaves it unwritten, the plain version
    writes zeros).  Under grad mode, an input that requires grad raises
    on either device (``kernels.refuse_grad``): the kernel has no backward."""
    refuse_grad("grouped_matmul", x, w)
    if x.device.type == "cuda":
        return grouped_matmul_cuda(x, w, counts)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, counts)
    raise ValueError(f"expert_ffn_matmul: unsupported device {x.device}")
