"""Decoder-only and encoder-decoder transformer assembly.

The port of ``repro/models/transformer.py``.  Layer parameters are *stacked*
(every leaf has a leading ``n_layers`` dim) as in the reference, which runs
them with ``lax.scan``; here a Python loop walks the stacked leaves, so every
layer's window is a static int (gemma3's 5:1 local:global schedule included)
and the attention kernels can engage on every layer their gate admits.  The
reference's ``logical_constraint`` sharding hints and remat have no meaning
on one card and are left out.  The moe family's FFN is ``moe.moe_apply``
(its expert GEMMs on the grouped-matmul kernel K6 under ``use_kernels``);
``forward`` returns the sum of its per-layer aux losses, as the reference's.

Port-only, off by default: with ``cfg.first_dense_layers`` = n the first n
layers of a moe model take a dense MLP, stacked apart under
``params["dense_layers"]`` (``params["layers"]`` holds the MoE layers);
with ``cfg.mla`` every layer's attention is latent (``models/mla.py``) and
the decode cache is one [L, B, S, kv_lora_rank + rope] latent leaf, its
structure ``((latent,), None)`` where GQA's is ``((k, v), cross)``.
Serving may pass ``moe_counts`` [MoE layers, E] int32 on the device to
:func:`prefill` and :func:`decode_step`: the j-th MoE layer writes its
tokens per expert to row j (``moe.moe_apply``'s ``counts_out``); and
``live`` [B] bool to :func:`decode_step`, the rows a dropless MoE routes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .attention import (Pos, _project, attn_apply, attn_init, init_kv_cache,
                        project_memory, row_positions)
from .config import ModelConfig
from .layers import (Params, apply_rope, cross_entropy_loss, dtype_of, embed_apply,
                     embed_init, mlp_apply, mlp_init, normal_init, rms_norm, span,
                     unembed_apply)
from .mla import init_latent_cache, mla_decode, mla_init, mla_prefill
from .moe import moe_apply, moe_init


def window_schedule(cfg: ModelConfig, n_layers: Optional[int] = None) -> np.ndarray:
    """Per-layer sliding window (0 = global attention)."""
    L = n_layers if n_layers is not None else cfg.n_layers
    if cfg.global_every and cfg.global_every > 0:
        w = np.full(L, cfg.local_window, np.int32)
        w[cfg.global_every - 1::cfg.global_every] = 0   # every k-th layer global
        return w
    return np.zeros(L, np.int32)


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters: index every stacked leaf (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def decoder_layer(params: Params, cfg: ModelConfig, i: int) -> Params:
    """Decoder layer ``i``'s parameters, a leading dense layer's or a
    stacked layer's."""
    n = cfg.first_dense_layers
    if i < n:
        return layer_params(params["dense_layers"], i)
    return layer_params(params["layers"], i - n)


def moe_layer_count(cfg: ModelConfig) -> int:
    """Decoder layers that take the MoE FFN."""
    return cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" else 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
                cross: bool, dense: bool = False) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    p: Params = {
        "attn": (mla_init if cfg.mla is not None else attn_init)(gen, cfg, n_layers),
        "norm1": torch.zeros(n_layers, cfg.d_model, dtype=dtype, device=gen.device),
        "norm2": torch.zeros(n_layers, cfg.d_model, dtype=dtype, device=gen.device),
    }
    if cfg.family == "moe" and not dense:
        p["moe"] = moe_init(gen, cfg, n_layers)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, n_layers)
    if cross:
        p["cross"] = attn_init(gen, cfg, n_layers)
        p["norm_cross"] = torch.zeros(n_layers, cfg.d_model, dtype=dtype,
                                      device=gen.device)
    return p


def decoder_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    n_dense = cfg.first_dense_layers
    p: Params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype)}
    if n_dense:
        p["dense_layers"] = _layer_init(gen, cfg, n_dense, cross=cfg.is_encdec, dense=True)
    p["layers"] = _layer_init(gen, cfg, cfg.n_layers - n_dense, cross=cfg.is_encdec)
    p["final_norm"] = torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": normal_init(gen, (cfg.vocab, cfg.d_model), dtype)}
    if cfg.is_encdec:
        p["enc_layers"] = _layer_init(gen, cfg, cfg.encoder_layers, cross=False)
        p["enc_final_norm"] = torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
         moe_counts: Optional[torch.Tensor] = None, live: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN sublayer → (y, the MoE aux loss; None for a dense MLP, whose
    aux is zero: no zero tensor is made per layer)."""
    if "moe" in p:
        return moe_apply(p["moe"], x, cfg, moe_counts, live)
    return mlp_apply(p["mlp"], x, cfg.act), None


def _mla(p: Params, h: torch.Tensor, cfg: ModelConfig, *, positions, cache,
         cache_pos, k_valid, latent_out):
    """Latent self-attention: prefill (``cache`` None; the latent written
    to ``latent_out`` [B, S_cache, *] where given) or decode against
    ``cache`` ((latent,), None) → (out, new_self)."""
    with span("model.mla"):
        if cache is None:
            out, lat = mla_prefill(p, h, cfg, positions=positions, k_valid=k_valid)
            if latent_out is not None:
                latent_out[:, :h.shape[1]] = lat.to(latent_out.dtype)
            return out, None
        pos = row_positions(cache_pos, h.shape[0], h.device)
        return mla_decode(p, h, cfg, cache[0], positions=positions, cache_pos=pos,
                          k_valid=k_valid), cache


def _block(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions, window: int,
           memory=None, cache=None, cache_pos: Optional[Pos] = None, causal=True,
           k_valid=None, moe_counts: Optional[torch.Tensor] = None,
           latent_out: Optional[torch.Tensor] = None, live: Optional[torch.Tensor] = None):
    """Pre-norm transformer block; returns (x, aux, new_cache).

    ``k_valid`` [B,Sk] masks left-pad key slots out of *self*-attention
    (cross-attention memory carries no pads).  ``moe_counts`` [E]: where an
    MoE FFN writes its tokens per expert; ``latent_out``: where a latent
    prefill writes the layer's cache; ``live`` [B]: the rows a dropless MoE
    FFN routes."""
    normed = rms_norm(x, p["norm1"], cfg.rms_eps)
    self_cache = None if cache is None else cache[0]
    if cfg.mla is not None:
        h, new_self = _mla(p["attn"], normed, cfg, positions=positions, cache=self_cache,
                           cache_pos=cache_pos, k_valid=k_valid, latent_out=latent_out)
    else:
        h, new_self = attn_apply(p["attn"], normed, cfg, positions=positions,
                                 window=window, cache=self_cache, cache_pos=cache_pos,
                                 causal=causal, k_valid=k_valid)
    x = x + h
    new_cross = None
    if "cross" in p:
        h, new_cross = attn_apply(
            p["cross"], rms_norm(x, p["norm_cross"], cfg.rms_eps), cfg,
            positions=positions, memory=memory, is_cross=True,
            cache=None if cache is None else cache[1])
        x = x + h
    h, aux = _ffn(p, rms_norm(x, p["norm2"], cfg.rms_eps), cfg, moe_counts, live)
    x = x + h
    return x, aux, None if cache is None else (new_self, new_cross)


def _run_blocks(layer, x: torch.Tensor, cfg: ModelConfig, *,
                windows: np.ndarray, positions, memory=None,
                causal=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass (forward / encoder) over the layers, ``layer(i)``
    giving layer i's parameters → (x, the layers' aux losses summed in
    fp32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, window in enumerate(windows):
        x, a, _ = _block(layer(i), x, cfg, positions=positions,
                         window=int(window), memory=memory, causal=causal)
        if a is not None:
            aux = aux + a.to(torch.float32)
    return x, aux


# ---------------------------------------------------------------------------
# full model passes
# ---------------------------------------------------------------------------
def _input_embeds(params: Params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings, optionally with frontend-stub embeddings prepended."""
    dtype = dtype_of(cfg.compute_dtype)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(dtype))
    if tokens is not None:
        parts.append(embed_apply(params["embed"], tokens).to(dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def encode(params: Params, cfg: ModelConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over frontend embeddings (enc-dec archs)."""
    x = enc_embeds.to(dtype_of(cfg.compute_dtype))
    S = x.shape[1]
    x, _ = _run_blocks(lambda i: layer_params(params["enc_layers"], i), x, cfg,
                       windows=np.zeros(cfg.encoder_layers, np.int32),
                       positions=torch.arange(S, dtype=torch.int32, device=x.device),
                       causal=False)
    return rms_norm(x, params["enc_final_norm"], cfg.rms_eps)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    table = params.get("unembed", params["embed"])
    return unembed_apply(table, x, cfg.logit_softcap)


def forward(params: Params, cfg: ModelConfig, *, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits [B,S,V], moe_aux)."""
    memory = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError("enc-dec arch needs encoder inputs")
        memory = encode(params, cfg, enc_embeds)
    x = _input_embeds(params, cfg, tokens, embeds)
    S = x.shape[1]
    x, aux = _run_blocks(lambda i: decoder_layer(params, cfg, i), x, cfg,
                         windows=window_schedule(cfg),
                         positions=torch.arange(S, dtype=torch.int32, device=x.device),
                         memory=memory)
    return _logits(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch
            ) -> Tuple[torch.Tensor, dict]:
    """Next-token CE (+ 0.01 x the MoE aux). batch: tokens/labels
    (+embeds/enc_embeds, mask).  A frontend prefix is trimmed off the
    logits so that they line up with the text labels."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          enc_embeds=batch.get("enc_embeds"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:      # frontend prefix: trim to text
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = cross_entropy_loss(logits, labels, batch.get("mask"))
    return ce + 0.01 * aux, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def _cross_cache(params: Params, cfg: ModelConfig, memory: torch.Tensor):
    """Per-layer projected encoder memory, stacked on L: (k, v) [L,B,Sm,K,Dh]."""
    proj = [project_memory(layer_params(params["layers"]["cross"], i), memory, cfg)
            for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in proj]), torch.stack([v for _, v in proj]))


def _self_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    if cfg.mla is not None:
        return (init_latent_cache(cfg, batch, max_len, cfg.n_layers, device=device),)
    return init_kv_cache(cfg, batch, max_len, cfg.n_layers, device=device)


def make_cache(params: Params, cfg: ModelConfig, batch: int, max_len: int,
               memory: Optional[torch.Tensor] = None):
    """Cache: (self (k, v) [L,B,S,K,Dh] or (latent,) [L,B,S,kv_lora_rank +
    rope], cross (k, v) or None), stacked on L."""
    device = params["final_norm"].device
    self_kv = _self_cache(cfg, batch, max_len, device)
    if not cfg.is_encdec:
        return (self_kv, None)
    if memory is None:
        raise ValueError("enc-dec cache needs the encoder memory")
    return (self_kv, _cross_cache(params, cfg, memory))


def cache_batch_axes(cfg: ModelConfig):
    """The batch axis of each leaf of :func:`make_cache`'s cache, in its
    structure: axis 1 throughout."""
    return ((1,) if cfg.mla is not None else (1, 1), (1, 1) if cfg.is_encdec else None)


def prefill(params: Params, cfg: ModelConfig, *, tokens=None, embeds=None,
            enc_embeds=None, cache_len: Optional[int] = None,
            pad_width: Optional[torch.Tensor] = None,
            moe_counts: Optional[torch.Tensor] = None):
    """Run the full prompt, build the KV cache, return (last_logits, cache, pos).

    Each layer's prompt K/V are recomputed from the layer's normed input
    (the same math as inside ``attn_apply``) and written into the cache.

    ``pad_width`` [B] int32 marks per-sequence left-pad runs at physical
    indices [prefix, prefix + pad_width[b]) (after any frontend prefix).
    They are excluded from every attention and the real tokens' rope
    positions shift down by the pad width, so a left-padded prompt is
    bit-exact with its unpadded reference.
    """
    memory = encode(params, cfg, enc_embeds) if cfg.is_encdec else None
    x = _input_embeds(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    dev = x.device
    max_len = cache_len or S
    base = torch.arange(S, dtype=torch.int32, device=dev)
    k_valid = None
    if pad_width is None:
        positions = base
    else:
        pw = torch.as_tensor(pad_width, dtype=torch.int32, device=dev)   # [B]
        prefix = 0 if embeds is None else embeds.shape[1]
        in_pad = (base[None, :] >= prefix) & (base[None, :] < prefix + pw[:, None])
        k_valid = ~in_pad                                   # [B,S] key mask
        positions = torch.where(base[None, :] >= prefix,
                                base[None, :] - pw[:, None], base[None, :])
    windows = window_schedule(cfg)
    counts = _moe_rows(cfg, moe_counts)
    if cfg.mla is not None:
        (cache_lat,) = self_kv = _self_cache(cfg, B, max_len, dev)
        for i, window in enumerate(windows):
            x, _, _ = _block(decoder_layer(params, cfg, i), x, cfg, positions=positions,
                             window=int(window), k_valid=k_valid, moe_counts=counts[i],
                             latent_out=cache_lat[i])
        return _logits(params, cfg, x[:, -1:]), (self_kv, None), S
    cache_k, cache_v = init_kv_cache(cfg, B, max_len, cfg.n_layers, device=dev)
    for i, window in enumerate(windows):
        lp = decoder_layer(params, cfg, i)
        normed = rms_norm(x, lp["norm1"], cfg.rms_eps)
        kproj = apply_rope(_project(lp["attn"], normed, "wk", "bk", cfg.n_kv,
                                    cfg.head_dim), positions, cfg.rope_theta)
        vproj = _project(lp["attn"], normed, "wv", "bv", cfg.n_kv, cfg.head_dim)
        cache_k[i, :, :S] = kproj.to(cache_k.dtype)
        cache_v[i, :, :S] = vproj.to(cache_v.dtype)
        x, _, _ = _block(lp, x, cfg, positions=positions, window=int(window),
                         memory=memory, k_valid=k_valid, moe_counts=counts[i])
    logits = _logits(params, cfg, x[:, -1:])
    cross = _cross_cache(params, cfg, memory) if cfg.is_encdec else None
    return logits, ((cache_k, cache_v), cross), S


def _moe_rows(cfg: ModelConfig, moe_counts: Optional[torch.Tensor]) -> list:
    """Each decoder layer's row of ``moe_counts`` (None for a dense layer,
    or without it)."""
    n = cfg.n_layers - moe_layer_count(cfg)
    if moe_counts is None:
        return [None] * cfg.n_layers
    return [None] * n + [moe_counts[j] for j in range(cfg.n_layers - n)]


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor, cache,
                pos: Pos, *, pad_width: Optional[torch.Tensor] = None,
                pad_offset: int = 0, moe_counts: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None):
    """One token step. token [B,1] int32; ``pos`` is the cache fill count:
    an int (one fill for every row), or a device tensor, 0-dim or [B]
    (per-row fills), which is broadcast to [B] and never read on the host,
    so the step can be captured in a CUDA graph.  The three forms give the
    same bits.

    ``pad_width`` [B] + ``pad_offset`` describe left-pad runs written into
    the cache at prefill ([pad_offset, pad_offset + pad_width[b])): those key
    slots are masked out and rope positions shift down by the pad width.
    ``live`` [B] bool on the device: the rows a dropless MoE routes (a free
    serving slot's row gets no routed output).  The cache is updated in
    place and returned.
    """
    x = embed_apply(params["embed"], token).to(dtype_of(cfg.compute_dtype))
    dev = x.device
    self_cache, cross = cache
    pos = row_positions(pos, x.shape[0], dev)               # [B]
    k_valid = None
    logical = pos
    if pad_width is not None:
        pw = torch.as_tensor(pad_width, dtype=torch.int32, device=dev)   # [B]
        logical = pos - pw                                  # [B]
        base = torch.arange(self_cache[0].shape[2], dtype=torch.int32, device=dev)
        k_valid = ~((base[None, :] >= pad_offset)
                    & (base[None, :] < pad_offset + pw[:, None]))
    positions = logical[:, None]                            # [B,1]
    counts = _moe_rows(cfg, moe_counts)
    for i, window in enumerate(window_schedule(cfg)):
        layer_cache = (tuple(leaf[i] for leaf in self_cache),
                       None if cross is None else (cross[0][i], cross[1][i]))
        x, _, _ = _block(decoder_layer(params, cfg, i), x, cfg,
                         positions=positions, window=int(window), cache=layer_cache,
                         cache_pos=pos, k_valid=k_valid, moe_counts=counts[i], live=live)
    return _logits(params, cfg, x), cache
