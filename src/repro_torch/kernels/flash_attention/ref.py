"""Plain PyTorch version of the flash-attention kernel (K4).

Step by step the arithmetic of the reference's Pallas kernel
(``repro/kernels/flash_attention/flash_attention.py::_flash_kernel``): fp32
scores times 1/sqrt(d), the finite -1e30 for masked scores, an online
softmax over key blocks of ``block_kv`` (halved until it divides Skv, as the
Pallas wrapper does), p rounded to v's dtype before the PV product, fp32
accumulators, and ``acc / max(l, 1e-30)`` in q's dtype.  Every query row is
independent, so the rows go all at once.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def kv_block(seq: int, block: int) -> int:
    """The Pallas wrapper's block rule: ``min(block, seq)``, halved until it
    divides ``seq``."""
    block = min(block, seq)
    while seq % block:
        block //= 2
    return block


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        block_kv: int = 128) -> torch.Tensor:
    """q: [BK, r, Sq, d]; k, v: [BK, Skv, d] → [BK, r, Sq, d] in q's dtype."""
    BK, r, Sq, d = q.shape
    Skv = k.shape[1]
    bk = kv_block(Skv, block_kv)
    scale = 1.0 / np.sqrt(d)
    q32 = q.to(torch.float32)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    acc = torch.zeros(BK, r, Sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((BK, r, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(BK, r, Sq, dtype=torch.float32, device=q.device)
    for k0 in range(0, Skv, bk):
        kj = k[:, k0:k0 + bk].to(torch.float32)
        vj = v[:, k0:k0 + bk]
        s = torch.einsum("brqd,bsd->brqs", q32, kj) * scale
        k_pos = k0 + torch.arange(bk, device=q.device)[None, :]
        mask = k_pos < Skv
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & (q_pos - k_pos < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("brqs,bsd->brqd", p.to(v.dtype).to(torch.float32),
                          vj.to(torch.float32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
