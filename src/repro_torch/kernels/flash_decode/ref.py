"""Plain PyTorch version of the flash-decode kernel (K3).

Step by step the arithmetic of the reference's Pallas kernel
(``repro/kernels/flash_decode/flash_decode.py::_decode_kernel``): fp32 scores
times 1/sqrt(d), cache rows at or past ``kv_len[b]`` scored the finite
-1e30, an online softmax over cache blocks of ``block_kv`` (halved until it
divides S), p rounded to v's dtype before the PV product, fp32 accumulators,
and ``acc / max(l, 1e-30)`` in q's dtype.  With ``kv_len = 0`` every score
is -1e30 and the output is the mean of all S value rows, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..flash_attention.ref import NEG_INF, kv_block


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: torch.Tensor, *, block_kv: int = 512) -> torch.Tensor:
    """q [BK, r, d]; caches [BK, S, d]; kv_len [BK] int32 → [BK, r, d]."""
    BK, r, d = q.shape
    S = k_cache.shape[1]
    bk = kv_block(S, block_kv)
    scale = 1.0 / np.sqrt(d)
    q32 = q.to(torch.float32)
    lens = kv_len.reshape(BK, 1, 1).to(q.device)
    acc = torch.zeros(BK, r, d, dtype=torch.float32, device=q.device)
    m = torch.full((BK, r), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(BK, r, dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bk):
        kj = k_cache[:, k0:k0 + bk].to(torch.float32)
        vj = v_cache[:, k0:k0 + bk]
        s = torch.einsum("brd,bsd->brs", q32, kj) * scale
        pos = k0 + torch.arange(bk, device=q.device)[None, None, :]
        s = torch.where(pos < lens, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("brs,bsd->brd", p.to(v_cache.dtype).to(torch.float32),
                          vj.to(torch.float32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
