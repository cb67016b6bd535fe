"""Model-layout GQA decode attention: the CUDA kernel on the card, the plain
version on the CPU (the port of ``repro/kernels/flash_decode/ops.py``)."""
from __future__ import annotations

from typing import Union

import torch

from .. import refuse_grad
from .flash_decode import flash_decode_cuda
from .ref import flash_decode_ref


def gqa_flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: Union[int, torch.Tensor], *,
                     block_kv: int = 512) -> torch.Tensor:
    """Model layout: q [B, 1, H, d]; caches [B, S, K, d]; kv_len a scalar or
    [B] → [B, 1, H, d], a drop-in for ``models.attention.decode_attention``.

    ``kv_len`` is broadcast to one length per sequence (the kernel's
    ``[B·K]`` lengths, one per kv head of a sequence, are all that
    sequence's).  A CUDA tensor launches the kernel on the cache in place; a
    CPU tensor runs the plain version in the kernel's (batch·kv_heads)
    layout with cache blocks of ``block_kv``; anything else raises.  Under grad mode, an input that requires grad raises
    on either device (``kernels.refuse_grad``): the kernel has no backward.
    """
    refuse_grad("flash_decode", q, k_cache, v_cache)
    B, _, H, d = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    r = H // K
    if isinstance(kv_len, torch.Tensor):
        lens = kv_len.to(q.device, torch.int32).reshape(-1).expand(B).contiguous()
    else:   # filled on the device: a host-to-device copy would synchronize
        lens = torch.full((B,), int(kv_len), dtype=torch.int32, device=q.device)
    if q.device.type == "cuda":
        return flash_decode_cuda(q.reshape(B, H, d), k_cache, v_cache,
                                 lens).reshape(B, 1, H, d)
    if q.device.type != "cpu":
        raise ValueError(f"gqa_flash_decode: unsupported device {q.device}")
    qk = q.reshape(B * K, r, d)
    kk = k_cache.permute(0, 2, 1, 3).reshape(B * K, S, d)
    vk = v_cache.permute(0, 2, 1, 3).reshape(B * K, S, d)
    o = flash_decode_ref(qk, kk, vk, lens[:, None].expand(B, K).reshape(B * K),
                         block_kv=block_kv)
    return o.reshape(B, 1, H, d)
