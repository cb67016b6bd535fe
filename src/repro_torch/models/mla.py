"""Multi-head latent attention (DeepSeek-V2/V3's MLA) over a latent cache.

A port-only module: the reference has no MLA.  Parameters of one layer
(``cfg.mla`` = m, H heads, no query low-rank):

* ``wq`` [d, H·(nope + rope)]: each head's query, a ``qk_nope_head_dim``
  part and a ``qk_rope_head_dim`` rotary part;
* ``wkv_a`` [d, kv_lora_rank + rope]: the token's latent c and its one
  rotary key, shared by every head; ``kv_norm`` [kv_lora_rank] norms c;
* ``wkv_b`` [kv_lora_rank, H·(nope + v)]: each head's key and value from
  the normed latent;
* ``wo`` [H·v_head_dim, d].

The cache holds, a token and layer, the normed latent and the roped shared
key: ``kv_lora_rank + qk_rope_head_dim`` values (576 for DeepSeek-V3's
widths), where a K/V cache of the same heads would hold H·(192 + 128).

* **Prefill, unabsorbed** (:func:`mla_prefill`): the latent is expanded to
  per-head keys [nope | rope] and values, and causal attention runs at q/k
  width nope + rope and v width v_head_dim, by PyTorch's
  ``scaled_dot_product_attention`` (the hand-written K4 takes no such
  widths).  On the card it is held to the memory-efficient backend, whose
  kernels are built ahead of time: left to choose, PyTorch takes cuDNN's,
  which builds a plan for each new prompt length on the host (~0.1 s, in
  the serving window).
* **Decode, absorbed** (:func:`mla_decode`): each head's no-rope query is
  folded through its key up-projection into the latent's width, so the
  scores are one product of [latent | rope] queries with the cache; the
  weighted latent goes out through each head's value up-projection.  Every
  row attends to its own fill, masked on the device with no host read, so
  the step can be captured as a CUDA graph; the products run in the
  activation dtype with the softmax in fp32, as DeepSeek-V3's own absorbed
  decode does.

Rotary positions use the port's two-halves rotation (``layers.apply_rope``)
where DeepSeek-V3's code rotates interleaved pairs, and every norm is the
port's RMSNorm scaled by ``1 + scale``; the latent's norm keeps DeepSeek-V3's
epsilon of 1e-6, whatever ``rms_eps`` the layer norms take.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from .config import ModelConfig
from .layers import Params, apply_rope, dtype_of, normal_init, rms_norm

KV_NORM_EPS = 1e-6      # DeepSeek-V3's kv_a_layernorm: RMSNorm's default epsilon
NEG_INF = -1e30


def mla_init(gen: torch.Generator, cfg: ModelConfig, n_layers: Optional[int] = None,
             dtype: Optional[torch.dtype] = None) -> Params:
    dtype = dtype or dtype_of(cfg.param_dtype)
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    lead = () if n_layers is None else (n_layers,)
    return {
        "wq": normal_init(gen, (*lead, d, h * m.qk_head_dim), dtype),
        "wkv_a": normal_init(gen, (*lead, d, m.cache_width), dtype),
        "kv_norm": torch.zeros((*lead, m.kv_lora_rank), dtype=dtype, device=gen.device),
        "wkv_b": normal_init(gen, (*lead, m.kv_lora_rank,
                                   h * (m.qk_nope_head_dim + m.v_head_dim)), dtype),
        "wo": normal_init(gen, (*lead, h * m.v_head_dim, d), dtype),
    }


def init_latent_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                      *, device) -> torch.Tensor:
    """Zeros [L, B, S, kv_lora_rank + rope] in the compute dtype."""
    return torch.zeros(n_layers, batch, max_len, cfg.mla.cache_width,
                       dtype=dtype_of(cfg.compute_dtype), device=device)


def _queries(p: Params, x: torch.Tensor, cfg: ModelConfig, positions) -> torch.Tensor:
    """[B, S, H, nope + rope], the rotary part roped."""
    m = cfg.mla
    B, S, _ = x.shape
    q = (x @ p["wq"]).view(B, S, cfg.n_heads, m.qk_head_dim)
    q_pe = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return torch.cat([q[..., :m.qk_nope_head_dim], q_pe], dim=-1)


def latent(p: Params, x: torch.Tensor, cfg: ModelConfig, positions) -> torch.Tensor:
    """What the cache holds for x [B, S, d]: [B, S, kv_lora_rank + rope],
    the normed latent and the roped shared key."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c = rms_norm(kv[..., :m.kv_lora_rank], p["kv_norm"], KV_NORM_EPS)
    k_pe = apply_rope(kv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)
    return torch.cat([c, k_pe[..., 0, :]], dim=-1)


def _up(p: Params, cfg: ModelConfig) -> torch.Tensor:
    """``wkv_b`` as [kv_lora_rank, H, nope + v]."""
    m = cfg.mla
    return p["wkv_b"].view(m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)


def mla_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions,
                k_valid: Optional[torch.Tensor] = None):
    """Causal latent attention over x [B, S, d], unabsorbed → (out [B, S,
    d], the latent [B, S, kv_lora_rank + rope] for the cache).  ``k_valid``
    [B, S] masks left-pad keys out."""
    m = cfg.mla
    B, S, _ = x.shape
    H, nope = cfg.n_heads, m.qk_nope_head_dim
    q = _queries(p, x, cfg, positions)
    lat = latent(p, x, cfg, positions)
    kv = (lat[..., :m.kv_lora_rank] @ p["wkv_b"]).view(B, S, H, nope + m.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   lat[..., None, m.kv_lora_rank:].expand(B, S, H, m.qk_rope_head_dim)], -1)
    v = kv[..., nope:]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))          # [B, H, S, *]
    scale = 1.0 / math.sqrt(m.qk_head_dim)
    keep = None
    if k_valid is not None:
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        keep = keep[None] & k_valid[:, None, :]                 # [B, Sq, Sk]
        # a query on a pad row sees no key: let it see itself (its output
        # is never used, and a row of -inf would give NaN)
        keep = (keep | torch.eye(S, dtype=torch.bool, device=x.device)[None])[:, None]
    with _prefill_backend(x.device):
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep, is_causal=keep is None,
                                           scale=scale)
    o = o.transpose(1, 2).reshape(B, S, H * m.v_head_dim)
    return o @ p["wo"], lat


def _prefill_backend(device: torch.device):
    """The memory-efficient attention backend on the card (see the module's
    docstring); PyTorch's own choice elsewhere."""
    if device.type == "cuda":
        return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])
    return contextlib.nullcontext()


def mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: torch.Tensor, *,
               positions: torch.Tensor, cache_pos: torch.Tensor,
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token a row, x [B, 1, d], absorbed, against ``cache`` [B, S, kv_lora_rank
    + rope], into which the token's latent is written at ``cache_pos`` [B]
    (in place; a fill past the end is clamped to S - 1) → out [B, 1, d].
    Row b attends to cache slots 0 .. cache_pos[b]; ``k_valid`` [B, S] masks
    left-pad slots out; ``positions`` [B, 1] are the rotary positions."""
    m = cfg.mla
    B = x.shape[0]
    S, r = cache.shape[1], m.kv_lora_rank
    H, nope = cfg.n_heads, m.qk_nope_head_dim
    q = _queries(p, x, cfg, positions)[:, 0]                   # [B, H, nope + rope]
    rows = torch.arange(B, device=x.device)
    cache[rows, cache_pos.long().clamp(0, S - 1)] = latent(p, x, cfg, positions)[:, 0].to(
        cache.dtype)
    up = _up(p, cfg)                                           # [r, H, nope + v]
    # each head's query in the latent's width: q_nope @ w_uk^T, [H, B, r]
    q_lat = torch.bmm(q[..., :nope].transpose(0, 1), up[..., :nope].permute(1, 2, 0))
    qc = torch.cat([q_lat.transpose(0, 1), q[..., nope:]], dim=-1).to(cache.dtype)
    s = torch.bmm(qc, cache.transpose(1, 2)).float() * (1.0 / math.sqrt(m.qk_head_dim))
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    valid = k_pos[None, :] <= cache_pos[:, None]               # [B, S]
    if k_valid is not None:
        valid = valid & k_valid
    s = torch.where(valid[:, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(cache.dtype)               # [B, H, S]
    o_lat = torch.bmm(w, cache[..., :r])                       # [B, H, r]
    o = torch.bmm(o_lat.transpose(0, 1), up[..., nope:].transpose(0, 1))   # [H, B, v]
    return (o.transpose(0, 1).reshape(B, 1, H * m.v_head_dim)) @ p["wo"]
