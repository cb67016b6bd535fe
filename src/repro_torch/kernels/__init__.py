"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel.

Layout as in ``repro.kernels``: ``<name>/<name>.py`` is the launcher of the
CUDA kernel in ``../csrc/<name>.cu``, ``<name>/ref.py`` the plain PyTorch
version, ``<name>/ops.py`` the wrapper that dispatches on the tensor's
device — the plain version for a CPU tensor, the kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise when a gradient is asked of a kernel route.

    The CUDA kernels launch through ``ctypes`` on raw pointers, so their
    outputs carry no ``grad_fn``: a loss taken through one would quietly
    lose the gradient of every kernel input.  The reference's kernels have
    no backward either, and it trains on its plain route.  The check is made
    on both devices, so that the CPU shows what the card would do."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() and t.requires_grad:
            raise RuntimeError(
                f"{kernel}: the hand-written kernel has no backward; a "
                "gradient through it would be lost.  Train with "
                "use_kernels=False")
