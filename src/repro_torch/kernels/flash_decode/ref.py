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


def flash_decode_split_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           kv_len: torch.Tensor, *, n_split: int,
                           tile: int = 64) -> torch.Tensor:
    """The CUDA kernel's split-and-combine rule, step by step (tests only).

    q [BK, r, d]; caches [BK, S, d]; kv_len [BK] int32 → [BK, r, d].  The
    cache is cut into splits of whole ``tile``-row units (as
    ``flash_decode.split_plan`` cuts it, asked for ``n_split``); each split
    runs the online softmax over its rows in blocks of ``tile``, scoring rows
    at or past ``kv_len`` -1e30.  A split whose rows all lie at or past
    ``kv_len`` (for ``kv_len > 0``) leaves the empty state m = -inf, l = 0,
    o = 0.  The states are folded in split order: m = max mᵢ, wᵢ =
    exp(mᵢ − m) (0 for an empty split), out = Σ oᵢwᵢ / max(Σ lᵢwᵢ, 1e-30).
    """
    BK, r, d = q.shape
    S = k_cache.shape[1]
    units = max(1, -(-S // tile))
    per = -(-units // max(1, min(n_split, units)))
    rows = per * tile
    scale = 1.0 / np.sqrt(d)
    q32 = q.to(torch.float32)
    lens = kv_len.reshape(BK).to(device=q.device, dtype=torch.int64)
    live = torch.where(lens > 0, lens.clamp(max=S), torch.full_like(lens, S))
    states = []
    for r0 in range(0, units * tile, rows):
        m = torch.full((BK, r), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(BK, r, dtype=torch.float32, device=q.device)
        acc = torch.zeros(BK, r, d, dtype=torch.float32, device=q.device)
        for k0 in range(r0, min(r0 + rows, S), tile):
            kj = k_cache[:, k0:k0 + tile].to(torch.float32)
            vj = v_cache[:, k0:k0 + tile]
            s = torch.einsum("brd,bsd->brs", q32, kj) * scale
            pos = k0 + torch.arange(kj.shape[1], device=q.device)[None, None, :]
            s = torch.where(pos < lens[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("brs,bsd->brd", p.to(v_cache.dtype).to(torch.float32),
                              vj.to(torch.float32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        empty = (live <= r0)[:, None]
        states.append((torch.where(empty, -torch.inf, m), torch.where(empty, 0.0, l),
                       torch.where(empty[..., None], 0.0, acc)))
    m = torch.stack([s[0] for s in states]).amax(dim=0)
    l = torch.zeros_like(m)
    o = torch.zeros(BK, r, d, dtype=torch.float32, device=q.device)
    for mi, li, oi in states:
        w = torch.where(mi == -torch.inf, 0.0, torch.exp(mi - m))
        l = l + li * w
        o = o + oi * w[..., None]
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
