"""Zamba2-style hybrid: Mamba2 backbone with a weight-SHARED attention block.

The port of ``repro/models/hybrid.py``.  The backbone is ``n_layers`` Mamba2
blocks; after every ``hybrid_group`` blocks one shared transformer block
(attention + MLP, one set of weights reused at every invocation) runs on the
residual stream.  The mamba parameters are stacked [G, k, ...] (G =
n_layers / hybrid_group groups of k), as in the reference; its nested
``lax.scan`` over groups and layers is a Python loop here.

Decode caches: per-layer SSM/conv states stacked [G, k, B, ...] plus one KV
cache per shared-block invocation, stacked [G, B, S, K, Dh].  With
``cfg.use_kernels`` on the card, prefill runs the SSD-scan kernel K5 in every
Mamba2 layer and flash attention K4 in every shared block; decode runs flash
decode K3 in every shared block.  Decode updates the cache in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import (Pos, _project, attn_apply, attn_init, init_kv_cache,
                        row_positions)
from .config import ModelConfig
from .layers import (Params, apply_rope, dtype_of, embed_apply, embed_init,
                     mlp_apply, mlp_init, rms_norm, unembed_apply)
from .ssm import init_ssm_cache, mamba2_apply, mamba2_init


def _shape(cfg: ModelConfig) -> Tuple[int, int]:
    k = cfg.hybrid_group
    if not (k > 0 and cfg.n_layers % k == 0):
        raise ValueError(f"hybrid: {cfg.n_layers} layers in groups of {k}")
    return cfg.n_layers // k, k             # (G groups, k per group)


def hybrid_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    G, k = _shape(cfg)
    dtype = dtype_of(cfg.param_dtype)
    dev = gen.device
    # mamba params stacked [G, k, ...]: drawn at [G*k, ...], then reshaped
    flat = mamba2_init(gen, cfg, n_layers=G * k)
    mamba = {name: a.reshape(G, k, *a.shape[1:]) for name, a in flat.items()}
    shared = {
        "attn": attn_init(gen, cfg),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
        "norm1": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
        "norm2": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
    }
    return {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "mamba": mamba,
        "mamba_norm": torch.zeros(G, k, cfg.d_model, dtype=dtype, device=dev),
        "shared": shared,
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
    }


def _mamba_layer(params: Params, g: int, i: int) -> Params:
    return {name: a[g, i] for name, a in params["mamba"].items()}


def _shared_block(shared: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, cache=None, cache_pos: Optional[Pos] = None):
    h, new_cache = attn_apply(shared["attn"], rms_norm(x, shared["norm1"], cfg.rms_eps),
                              cfg, positions=positions, cache=cache, cache_pos=cache_pos)
    x = x + h
    x = x + mlp_apply(shared["mlp"], rms_norm(x, shared["norm2"], cfg.rms_eps), cfg.act)
    return x, new_cache


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed_apply(params["embed"], tokens).to(dtype_of(cfg.compute_dtype))


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed_apply(params["embed"], x, cfg.logit_softcap)


def hybrid_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Full-sequence forward → (logits [B,S,V], aux = 0)."""
    G, k = _shape(cfg)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for g in range(G):
        for i in range(k):
            h, _ = mamba2_apply(_mamba_layer(params, g, i),
                                rms_norm(x, params["mamba_norm"][g, i], cfg.rms_eps), cfg)
            x = x + h
        x, _ = _shared_block(params["shared"], x, cfg, positions=positions)
    return (_logits(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


#: the batch axis of each leaf of :func:`hybrid_make_cache`'s cache
CACHE_BATCH_AXES = {"conv": 2, "ssm": 2, "attn_k": 1, "attn_v": 1}


def hybrid_make_cache(params: Params, cfg: ModelConfig, batch: int, max_len: int):
    """{"conv": [G,k,B,d_conv-1,conv_ch], "ssm": [G,k,B,H,N,P] fp32,
    "attn_k"/"attn_v": [G,B,max_len,K,Dh]}, zeros on the parameters'
    device."""
    G, k = _shape(cfg)
    device = params["final_norm"].device
    conv, ssm = init_ssm_cache(cfg, batch, n_layers=G * k, device=device)
    ck, cv = init_kv_cache(cfg, batch, max_len, G, device=device)
    return {"conv": conv.reshape(G, k, *conv.shape[1:]),
            "ssm": ssm.reshape(G, k, *ssm.shape[1:]), "attn_k": ck, "attn_v": cv}


def hybrid_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache_len: Optional[int] = None):
    """Prompt pass building all decode state (SSM states + shared-attn KV)
    → (last logits, cache, pos).  Each shared block's prompt K/V are
    recomputed from its normed input (the math inside ``attn_apply``) and
    written at 0; the block itself then runs without a cache (K4 under
    ``use_kernels``)."""
    G, k = _shape(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    shared = params["shared"]
    cache = hybrid_make_cache(params, cfg, B, cache_len or S)
    for g in range(G):
        for i in range(k):
            h, (conv_s, ssm_s) = mamba2_apply(
                _mamba_layer(params, g, i),
                rms_norm(x, params["mamba_norm"][g, i], cfg.rms_eps), cfg,
                return_state=True)
            cache["conv"][g, i] = conv_s
            cache["ssm"][g, i] = ssm_s
            x = x + h
        normed = rms_norm(x, shared["norm1"], cfg.rms_eps)
        kproj = apply_rope(_project(shared["attn"], normed, "wk", "bk", cfg.n_kv,
                                    cfg.head_dim), positions, cfg.rope_theta)
        vproj = _project(shared["attn"], normed, "wv", "bv", cfg.n_kv, cfg.head_dim)
        cache["attn_k"][g, :, :S] = kproj
        cache["attn_v"][g, :, :S] = vproj
        x, _ = _shared_block(shared, x, cfg, positions=positions)
    return _logits(params, cfg, x[:, -1:]), cache, S


def hybrid_decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                       cache, pos: Pos):
    """One token step.  ``pos`` is an int (one fill for every row) or a
    device tensor, 0-dim or [B] (each slot's shared-attention KV cache
    filled to its own level), broadcast to [B] on the device as
    ``transformer.decode_step`` does; the three forms give the same bits.
    The cache is updated in place and returned."""
    G, k = _shape(cfg)
    x = _embed(params, cfg, token)
    pos = row_positions(pos, x.shape[0], x.device)         # [B]
    positions = pos[:, None]
    for g in range(G):
        for i in range(k):
            h, (conv_n, ssm_n) = mamba2_apply(
                _mamba_layer(params, g, i),
                rms_norm(x, params["mamba_norm"][g, i], cfg.rms_eps), cfg,
                conv_state=cache["conv"][g, i], ssm_state=cache["ssm"][g, i])
            cache["conv"][g, i] = conv_n
            cache["ssm"][g, i] = ssm_n
            x = x + h
        x, _ = _shared_block(params["shared"], x, cfg, positions=positions,
                             cache=(cache["attn_k"][g], cache["attn_v"][g]),
                             cache_pos=pos)
    return _logits(params, cfg, x), cache
