"""The yardstick's arithmetic: peaks, and the operations and bytes a step
or a kernel call needs.

A frozen copy of the port's analytic step model
(``launch/analytic_cost.py``: ``forward_flops`` and ``port_step_cost``'s
decode, formula for formula, on the attributes of a ``ModelConfig``), for
the family the cells run: dense, with global attention.  Another family's
counts go in a new module under ``pb/``, which that cell's own new readers
import; this one is not edited for them.  Later changes to the program do
not move these numbers; the tests hold them equal to the program's at a
few shapes as of the day they were frozen.  Conventions: matmul FLOPs only
(2·M·N·K), causal attention counts the attended half; bytes count each
input read once and each output written once.
"""
from __future__ import annotations

import functools
import math
from typing import Iterable, Sequence

# one NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core FLOP/s, HBM3 B/s
PEAK_FLOPS_BF16 = 989e12
PEAK_HBM_BPS = 3.35e12
P_BYTES = 2


def roof_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / PEAK_HBM_BPS, flops / PEAK_FLOPS_BF16)


def head_dim(cfg) -> int:
    return cfg.d_head if cfg.d_head is not None else cfg.d_model // cfg.n_heads


# -- parameters ---------------------------------------------------------------
def _dense(cfg) -> None:
    if cfg.family != "dense" or getattr(cfg, "global_every", 0):
        raise ValueError(f"the frozen counts cover the dense family with global "
                         f"attention; {cfg.name!r} is {cfg.family!r}")


def _attn_params(cfg) -> int:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, head_dim(cfg)
    n = d * h * dh + 2 * d * kv * dh + h * dh * d
    if cfg.qkv_bias:
        n += h * dh + 2 * kv * dh
    return n


def _mlp_params(cfg) -> int:
    gates = 2 if cfg.act in ("swiglu", "geglu") else 1
    return gates * cfg.d_model * cfg.d_ff + cfg.d_ff * cfg.d_model


def param_count(cfg) -> int:
    """Total backbone parameters (the port's ``param_count``'s first)."""
    _dense(cfg)
    d = cfg.d_model
    total = cfg.vocab * d + (0 if cfg.tie_embeddings else cfg.vocab * d) + d
    return total + cfg.n_layers * (_attn_params(cfg) + _mlp_params(cfg) + 2 * d)


# -- FLOPs --------------------------------------------------------------------
def _attn_flops(cfg, B: int, Sq: int, Skv_att: float) -> float:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, head_dim(cfg)
    proj = 2 * B * Sq * d * (H * dh) + 2 * 2 * B * Sq * d * (K * dh) \
        + 2 * B * Sq * (H * dh) * d
    return proj + 2 * 2 * B * H * Sq * Skv_att * dh


def _mlp_flops(cfg, B: int, S: int) -> float:
    gates = 3 if cfg.act in ("swiglu", "geglu") else 2
    return gates * 2 * B * S * cfg.d_model * cfg.d_ff


def forward_flops(cfg, B: int, S: int, *, decode: bool = False,
                  cache_len: int = 0) -> float:
    """Forward FLOPs of one step over S tokens a sequence (decode: 1); a
    causal prefill attends (S + 1) / 2 keys a query on average."""
    _dense(cfg)
    Sq = 1 if decode else S
    att = _attn_flops(cfg, B, Sq, float(cache_len) if decode else (S + 1) / 2)
    return 2 * B * Sq * cfg.d_model * cfg.vocab + cfg.n_layers * (att + _mlp_flops(cfg, B, Sq))


# -- decode bytes -------------------------------------------------------------
def decode_step_cost(cfg, kv_lens: Iterable[int]):
    """(bytes, flops) a decode step needs for live rows of these cache
    fills (each counting the new token): the weights read once, each row's
    activations and cache rows.  Rows of one fill B give the port's
    ``port_step_cost(cfg, "decode", fill, B)``."""
    nbytes, flops = float(param_count(cfg) * P_BYTES), 0.0
    for kv in kv_lens:
        b, f = _decode_row(cfg, int(kv))
        nbytes, flops = nbytes + b, flops + f
    return nbytes, flops


@functools.lru_cache(maxsize=1 << 16)
def _decode_row(cfg, kv: int):
    kv_row = cfg.n_kv * head_dim(cfg) * P_BYTES
    act = cfg.n_layers * (12 * cfg.d_model * P_BYTES + 2 * kv_row) + cfg.vocab * 4
    cache = cfg.n_layers * 2 * kv * kv_row
    return act + cache, forward_flops(cfg, 1, 1, decode=True, cache_len=kv)


def prefill_flops(cfg, prompt_lens: Sequence[int]) -> float:
    """FLOPs of the real prompt tokens: each prompt alone, unpadded."""
    return sum(forward_flops(cfg, 1, int(L)) for L in prompt_lens)


def share_pct(need_s: float, took_s: float):
    """need over took in percent; None when nothing was timed."""
    if took_s <= 0 or not math.isfinite(took_s):
        return None
    return 100.0 * need_s / took_s
