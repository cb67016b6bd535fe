"""Pure Mamba2 LM (mamba2-130m): attention-free SSD stack.

The port of ``repro/models/mamba_lm.py``.  The layer ``lax.scan`` is a
Python loop over the stacked leaves (as in ``transformer.py``); the
reference's sharding hints and remat have no meaning on one card.  Decode
writes the conv and SSM states into the cache tensors in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .config import ModelConfig
from .layers import Params, dtype_of, embed_apply, embed_init, rms_norm, unembed_apply
from .ssm import init_ssm_cache, mamba2_apply, mamba2_init
from .transformer import layer_params


def mamba_lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    return {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "mamba": mamba2_init(gen, cfg, n_layers=cfg.n_layers),
        "norms": torch.zeros(cfg.n_layers, cfg.d_model, dtype=dtype, device=gen.device),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
    }


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed_apply(params["embed"], tokens).to(dtype_of(cfg.compute_dtype))


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed_apply(params["embed"], x, cfg.logit_softcap)


def mamba_lm_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Full-sequence forward → (logits [B,S,V], aux = 0)."""
    x = _embed(params, cfg, tokens)
    for i in range(cfg.n_layers):
        h, _ = mamba2_apply(layer_params(params["mamba"], i),
                            rms_norm(x, params["norms"][i], cfg.rms_eps), cfg)
        x = x + h
    return (_logits(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def mamba_lm_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                     cache_len: Optional[int] = None):
    """Prompt pass → (last logits, cache, pos); the cache (conv + SSM
    states) is O(1) in sequence length, so ``cache_len`` is not used."""
    x = _embed(params, cfg, tokens)
    cache = mamba_lm_make_cache(params, cfg, tokens.shape[0])
    for i in range(cfg.n_layers):
        h, (conv_s, ssm_s) = mamba2_apply(layer_params(params["mamba"], i),
                                          rms_norm(x, params["norms"][i], cfg.rms_eps),
                                          cfg, return_state=True)
        cache["conv"][i] = conv_s
        cache["ssm"][i] = ssm_s
        x = x + h
    return _logits(params, cfg, x[:, -1:]), cache, tokens.shape[1]


def mamba_lm_decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                         cache, pos: Any = None):
    """One token step; ``pos`` is not used (the state has no positions).
    The cache is updated in place and returned."""
    x = _embed(params, cfg, token)
    for i in range(cfg.n_layers):
        h, (conv_n, ssm_n) = mamba2_apply(
            layer_params(params["mamba"], i),
            rms_norm(x, params["norms"][i], cfg.rms_eps), cfg,
            conv_state=cache["conv"][i], ssm_state=cache["ssm"][i])
        cache["conv"][i] = conv_n
        cache["ssm"][i] = ssm_n
        x = x + h
    return _logits(params, cfg, x), cache


#: the batch axis of each leaf of :func:`mamba_lm_make_cache`'s cache
CACHE_BATCH_AXES = {"conv": 1, "ssm": 1}


def mamba_lm_make_cache(params: Params, cfg: ModelConfig, batch: int):
    """{"conv": [L,B,d_conv-1,conv_ch], "ssm": [L,B,H,N,P] fp32}, zeros on
    the parameters' device."""
    conv, ssm = init_ssm_cache(cfg, batch, n_layers=cfg.n_layers,
                               device=params["final_norm"].device)
    return {"conv": conv, "ssm": ssm}
