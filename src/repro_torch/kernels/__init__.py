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


def launch_report() -> dict:
    """Each kernel wrapper this process has imported: its launches and its
    launches per path, by library name (``{"block_lu": {"launches": n,
    "paths": {...}}, ...}``).  A bench run as a child process writes it
    (``--launches PATH``) so that its parent can count the child's kernels."""
    import sys
    from ._build import SOURCES
    out = {}
    for name in SOURCES:
        mod = sys.modules.get(f"{__name__}.{name}.{name}")
        if mod is not None:
            out[name] = {"launches": mod.launches.count,
                         "paths": {p: c.count for p, c in
                                   getattr(mod, "path_launches", {}).items()}}
    return out


def write_launch_report(path) -> None:
    """:func:`launch_report` as JSON at ``path`` (nothing when ``path`` is
    None)."""
    if path is None:
        return
    import json
    import os
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(launch_report(), f, indent=1, sort_keys=True)
