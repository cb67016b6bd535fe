"""Attention: GQA with blockwise (flash-style) prefill and cached decode.

The port of ``repro/models/attention.py``.  The blockwise path never
materializes the [Sq, Skv] score matrix: a loop over query blocks, and
inside it a loop over KV blocks carrying the online-softmax state (o, m, l).
GQA is computed in grouped form (q reshaped to [B, S, K, H/K, Dh]) so KV
heads are never repeated in memory.

With ``cfg.use_kernels`` the hand-written kernels take the self-attention
paths the reference's gate admits for its Pallas kernels: flash attention
(K4) for unpadded causal prefill, flash decode (K3) for unpadded decode of a
global layer.  The reference refuses a window that is a traced value; the
port runs a Python loop over layers, so its windows are always static ints
and that clause has no counterpart.  Everything else (left-pad-masked
prefill and decode, cross-attention, sliding-window decode) is the torch
port of the reference's jnp functions.

Decode writes the new token's K/V into the cache tensors in place (the
reference's ``dynamic_update_slice`` returns a new array); the returned
cache is the same tensors.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .layers import Params, apply_rope, dtype_of, normal_init

NEG_INF = -1e30

Pos = Union[int, torch.Tensor]


def _pick_block(seq: int, block: int) -> int:
    """Largest divisor of ``seq`` that is ≤ ``block``."""
    b = min(block, seq)
    while seq % b:
        b -= 1
    return b


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int, kv_len: Optional[Pos],
          k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[*,Sq,Sk] boolean validity mask from position vectors.

    ``q_pos`` may be [Sq] (shared positions) or [B,Sq] (per-sequence
    positions); ``k_valid`` [B,Sk] marks pad slots (False) that are never
    attended.  The result broadcasts to [Sq,Sk] or [B,Sq,Sk].
    """
    q = q_pos[..., :, None]                       # [*,Sq,1]
    k = k_pos[None, :]                            # [1,Sk]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (q >= k)
    if window > 0:                                # window <= 0 disables
        m = m & (q - k < window)
    if kv_len is not None:
        m = m & (k < kv_len)
    if k_valid is not None:
        m = m & k_valid[..., None, :]             # [B,1,Sk] against [*,Sq,Sk]
    return m


def _positions(q_offset: Pos, n: int, device: torch.device) -> torch.Tensor:
    return q_offset + torch.arange(n, dtype=torch.int32, device=device)


def row_positions(pos: Pos, rows: int, device: torch.device) -> torch.Tensor:
    """A cache fill count as [rows] int32 on ``device``: an int by a fill
    on the device (no host-to-device copy), a 0-dim or [rows] tensor
    broadcast on the device (no host read)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device, torch.int32).reshape(-1).expand(rows)
    return torch.full((rows,), pos, dtype=torch.int32, device=device)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: Pos = 0,
                    kv_len: Optional[Pos] = None,
                    k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Materialized-score reference path. q:[B,Sq,H,Dh] k,v:[B,Sk,K,Dh].

    ``q_offset`` may be a scalar or [B,1]; ``k_valid`` an optional [B,Sk]
    key mask (False = never attend).
    """
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    r = H // K
    qg = q.reshape(B, Sq, K, r, Dh)
    scale = 1.0 / np.sqrt(Dh)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    q_pos = _positions(q_offset, Sq, q.device)
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    m = _mask(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len,
              k_valid=k_valid)
    m = m[None, None, None] if m.dim() == 2 else m[:, None, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bskd->bqkrd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, Dh)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, q_offset: Pos = 0,
                        kv_len: Optional[Pos] = None,
                        k_valid: Optional[torch.Tensor] = None,
                        block_q: int = 512, block_kv: int = 1024) -> torch.Tensor:
    """Flash-style attention by nested loops; O(block_q·block_kv) memory."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    r = H // K
    bq, bk = _pick_block(Sq, block_q), _pick_block(Sk, block_kv)
    scale = 1.0 / np.sqrt(Dh)
    qg = q.reshape(B, Sq // bq, bq, K, r, Dh)
    dev = q.device
    blocks = []
    for iq in range(Sq // bq):
        # q·scale in fp32 (the reference multiplies by a float64 scalar,
        # which promotes q to fp32)
        qi = qg[:, iq].to(torch.float32) * scale           # [B,bq,K,r,Dh]
        q_pos = _positions(q_offset, bq, dev) + iq * bq
        o = torch.zeros(B, K, r, bq, Dh, dtype=torch.float32, device=dev)
        m = torch.full((B, K, r, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros(B, K, r, bq, dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, bk):
            kj, vj = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
            k_pos = torch.arange(k0, k0 + bk, dtype=torch.int32, device=dev)
            s = torch.einsum("bqkrd,bskd->bkrqs", qi, kj.to(torch.float32))
            valid = _mask(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len,
                          k_valid=None if k_valid is None else k_valid[:, k0:k0 + bk])
            valid = valid[None, None, None] if valid.dim() == 2 else valid[:, None, None]
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkrqs,bskd->bkrqd", p.to(vj.dtype).to(torch.float32),
                              vj.to(torch.float32))
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(o.permute(0, 3, 1, 2, 4))              # [B,bq,K,r,Dh]
    return torch.cat(blocks, dim=1).reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     kv_len: Pos, window: int = 0,
                     k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention against a cache. q:[B,1,H,Dh] cache:[B,S,K,Dh].

    ``kv_len`` is a scalar (shared cache fill) or [B,1] (per-sequence fill,
    continuous batching); ``k_valid`` an optional [B,S] key mask whose False
    entries (left-pad slots) are never attended.
    """
    B, _, H, Dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    r = H // K
    qg = q.reshape(B, K, r, Dh)
    scale = 1.0 / np.sqrt(Dh)
    s = torch.einsum("bkrd,bskd->bkrs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    k_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    valid = k_pos < kv_len                                   # [1,S] or [B,S]
    if window > 0:
        valid = valid & (k_pos >= kv_len - window)
    if k_valid is not None:
        valid = valid & k_valid
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrs,bskd->bkrd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, Dh)


# ---------------------------------------------------------------------------
# Attention layer (projection + rope + cache plumbing)
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ModelConfig, n_layers: Optional[int] = None,
              dtype: Optional[torch.dtype] = None) -> Params:
    dtype = dtype or dtype_of(cfg.param_dtype)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    lead = () if n_layers is None else (n_layers,)
    p = {
        "wq": normal_init(gen, (*lead, d, h * dh), dtype),
        "wk": normal_init(gen, (*lead, d, kv * dh), dtype),
        "wv": normal_init(gen, (*lead, d, kv * dh), dtype),
        "wo": normal_init(gen, (*lead, h * dh, d), dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=gen.device)
    return p


def _project(p: Params, x: torch.Tensor, w: str, b: str, heads: int,
             dh: int) -> torch.Tensor:
    y = x @ p[w]
    if b in p:
        y = y + p[b]
    return y.reshape(x.shape[0], x.shape[1], heads, dh)


def attn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, window: int = 0,
               memory: Optional[torch.Tensor] = None,
               cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               cache_pos: Optional[Pos] = None,
               causal: bool = True, is_cross: bool = False,
               k_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One attention sublayer.

    * prefill self-attn: ``cache=None`` — blockwise/dense over x, or K4.
    * decode self-attn: ``cache=(k,v)`` [B,S,K,Dh] + ``cache_pos`` (an int
      or a 0-dim tensor, one fill for every row, or [B], per-row fills;
      taken as [B] on the device) — insert the token's K/V at
      ``cache_pos`` in place, attend over the cache (K3 or the plain path).
    * cross-attn (``is_cross``): keys/values come from ``memory`` when given,
      else from a cache of the *projected* memory (:func:`project_memory`).
    * ``k_valid`` [B,Sk]: per-sequence key mask — False marks left-pad slots.
    """
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    window = int(window)

    q = _project(p, x, "wq", "bq", h, dh)
    if not is_cross:
        q = apply_rope(q, positions, cfg.rope_theta)

    new_cache = None
    if is_cross and cache is not None and memory is None:
        # decode-time cross-attn: cached projected memory, full valid length
        ck, cv = cache
        o = decode_attention(q, ck, cv, kv_len=ck.shape[1])
        new_cache = cache
    else:
        kv_src = memory if is_cross else x
        k = _project(p, kv_src, "wk", "bk", kv, dh)
        v = _project(p, kv_src, "wv", "bv", kv, dh)
        if not is_cross:
            k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:
            ck, cv = cache
            cache_pos = row_positions(cache_pos, B, x.device)
            _cache_insert(ck, k, cache_pos)
            _cache_insert(cv, v, cache_pos)
            new_cache = (ck, cv)
            kvl = cache_pos + 1
            if cfg.use_kernels and not is_cross and window <= 0 and k_valid is None:
                from ..kernels.flash_decode.ops import gqa_flash_decode
                o = gqa_flash_decode(q, ck, cv, kvl)
            else:
                o = decode_attention(q, ck, cv, kv_len=kvl[:, None], window=window,
                                     k_valid=k_valid)
        elif cfg.use_kernels and not is_cross and causal and k_valid is None:
            from ..kernels.flash_attention.ops import gqa_flash_attention
            o = gqa_flash_attention(q, k, v, causal=True, window=window,
                                    block_kv=min(cfg.attn_block_kv, 128))
        elif cfg.attn_impl == "blockwise":
            o = blockwise_attention(q, k, v, causal=causal and not is_cross,
                                    window=window, k_valid=k_valid,
                                    block_q=cfg.attn_block_q,
                                    block_kv=cfg.attn_block_kv)
        else:
            o = dense_attention(q, k, v, causal=causal and not is_cross,
                                window=window, k_valid=k_valid)

    out = o.reshape(B, S, h * dh) @ p["wo"]
    return out, new_cache


def project_memory(p: Params, memory: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute cross-attention K/V of the encoder memory (once per request)."""
    return (_project(p, memory, "wk", "bk", cfg.n_kv, cfg.head_dim),
            _project(p, memory, "wv", "bv", cfg.n_kv, cfg.head_dim))


def _cache_insert(cache: torch.Tensor, kv_new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write kv_new [B,1,K,Dh] into cache [B,S,K,Dh] in place, each row at
    its own fill level ``pos`` [B] on the device.  Like
    ``dynamic_update_slice``, a start past the end is clamped to S-1.
    """
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long().clamp(0, S - 1)] = kv_new[:, 0].to(cache.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                  *, device: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype = dtype or dtype_of(cfg.compute_dtype)
    lead = () if n_layers is None else (n_layers,)
    shape = (*lead, batch, max_len, cfg.n_kv, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
