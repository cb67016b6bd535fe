"""Carry inputs between the JAX reference and the port, through numpy.

A parity test builds every input once with numpy from a seed and feeds the
same arrays to both packages: ``jnp.asarray`` on the reference side,
:func:`from_numpy_tree` on this side; :func:`to_numpy_tree` brings the port's
results back for comparison.  Containers (dict, list, tuple, None) keep their
structure.

bfloat16 crosses bit for bit: ``np.asarray`` of a JAX bfloat16 array has the
``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` refuses, so its bits
travel as uint16 and are reinterpreted on this side.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import DeviceLike, resolve_device


def _leaf_from_numpy(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_numpy_tree(tree: Any, device: DeviceLike) -> Any:
    """numpy arrays (and numpy/Python scalars) → tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return _leaf_from_numpy(np.asarray(tree)).to(device)


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """The reference's parameter pytree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), → the port's parameter tree: the same keys, the
    same stacked ``[n_layers, ...]`` leaves and the same dtypes, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return from_numpy_tree(tree, resolve_device(device))


def to_numpy_tree(tree: Any) -> Any:
    """Tensors → numpy arrays on the host; bfloat16 widens to float32
    (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree
