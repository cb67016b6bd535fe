"""Block-int8 gradient compression with error feedback, in PyTorch.

Port of ``repro.core.compression`` (its own copy: the port imports nothing
of the reference).  Symmetric int8 quantization with one fp32 scale per
``block`` values, and *error feedback* — the residual of each round is added
back before the next — for the slow host/peer hop.

The order of operations is the reference's, so payloads and scales agree
bit for bit with it: ``max|x| / 127.0``, then ``scale == 0 → 1``, then
``round(blocks / scale)`` half to even, clipped to ±127, as int8.  Every
step is an IEEE fp32 operation (division, rounding, one multiply on the way
back), so the CPU and the card give the same bits too.

A division by a Python number is written as a division by a 0-dim tensor
on the operand's device (:func:`true_div`): on a CUDA tensor PyTorch turns
``x / 127.0`` into ``x * (1 / 127.0)``, which can differ from the IEEE
quotient by an ulp.

These are plain tensor functions on any device.  The wire's round trip
(:func:`decompress` of :func:`compress`) on a CUDA buffer is one launch of
the hand-written ``csrc/q8_wire.cu`` (``kernels/q8_wire``), which the
transport's quantize step uses.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from . import _tree


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 payload [blocks, block]
    scale: torch.Tensor    # fp32 per-block scales [blocks]


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as the IEEE quotient on every device (see the module
    docstring: a Python divisor would be a reciprocal multiply on CUDA)."""
    return x / x.new_full((), s)


def _pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def compress(x: torch.Tensor, block: int = 256) -> Compressed:
    """Symmetric int8 quantization with one scale per ``block`` values."""
    flat, _ = _pad_to(x.to(torch.float32), block)
    blocks = flat.reshape(-1, block)
    scale = true_div(blocks.abs().amax(dim=1, keepdim=True), 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale[:, 0])


def decompress(c: Compressed, shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (c.q.to(torch.float32) * c.scale[:, None]).reshape(-1)
    n = math.prod(shape)
    return flat[:n].reshape(shape).to(dtype)


def compressed_nbytes(c: Compressed) -> int:
    return c.q.numel() * 1 + c.scale.numel() * 4


def int8_wire_nbytes(n_elements: int, block: int = 256) -> int:
    """Wire size of an ``n_elements`` message under :func:`compress`,
    without materializing it: the padded int8 payload plus one fp32 scale
    per block — ``compressed_nbytes(compress(x, block))``.  Pure layout
    arithmetic, so cost models can price the compressed wire for messages
    that exist only as byte counts."""
    blocks = -(-max(int(n_elements), 1) // block)
    return blocks * block * 1 + blocks * 4


def ef_compress(x: torch.Tensor, residual: torch.Tensor, block: int = 256
                ) -> Tuple[Compressed, torch.Tensor]:
    """Error-feedback step: compress (x + residual), return new residual."""
    corrected = x.to(torch.float32) + residual
    c = compress(corrected, block)
    recon = decompress(c, tuple(x.shape))
    return c, corrected - recon


def ef_init(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def tree_ef_compress(grads: Any, residuals: Any, block: int = 256):
    """Error-feedback compression over a gradient pytree."""
    flat, treedef = _tree.flatten(grads)
    res_flat = _tree.leaves(residuals)
    out_c, out_r = [], []
    for g, r in zip(flat, res_flat):
        c, nr = ef_compress(g, r, block)
        out_c.append(c)
        out_r.append(nr)
    return _tree.unflatten(treedef, out_c), _tree.unflatten(treedef, out_r)


def tree_decompress(comp: Any, template: Any,
                    dtype: torch.dtype = torch.float32):
    # a Compressed is a NamedTuple, which the pytree keeps as a leaf
    c_flat, treedef = _tree.flatten(comp)
    t_flat = _tree.leaves(template)
    out = [decompress(c, tuple(t.shape), dtype) for c, t in zip(c_flat, t_flat)]
    return _tree.unflatten(treedef, out)
