"""Model-layout GQA attention: the CUDA kernel on the card, the plain version
on the CPU (the port of ``repro/kernels/flash_attention/ops.py``)."""
from __future__ import annotations

import torch

from .. import refuse_grad
from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        block_kv: int = 128) -> torch.Tensor:
    """Model layout: q [B, S, H, d]; k, v [B, S, K, d] → [B, S, H, d].

    A CUDA tensor launches the kernel (which reads this layout in place; its
    key tile is fixed at 64); a CPU tensor runs the plain version in the
    kernel's (batch·kv_heads, group) layout with key blocks of ``block_kv``;
    anything else raises.  Under grad mode, an input that requires grad raises
    on either device (``kernels.refuse_grad``): the kernel has no backward.
    """
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"gqa_flash_attention: unsupported device {q.device}")
    B, Sq, H, d = q.shape
    K = k.shape[2]
    r = H // K
    qk = q.reshape(B, Sq, K, r, d).permute(0, 2, 3, 1, 4).reshape(B * K, r, Sq, d)
    kk = k.permute(0, 2, 1, 3).reshape(B * K, -1, d)
    vk = v.permute(0, 2, 1, 3).reshape(B * K, -1, d)
    o = flash_attention_ref(qk, kk, vk, causal=causal, window=window,
                            block_kv=block_kv)
    return o.reshape(B, K, r, Sq, d).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, d)
