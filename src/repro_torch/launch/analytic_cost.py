"""Analytic FLOP / HBM-byte model of one train, prefill or decode step.

The port's copy of ``repro/launch/analytic_cost.py``, formula for formula:
pure Python arithmetic on the port's :class:`~..models.config.ModelConfig`
fields, so every result equals the reference's float for float.

Why a model and not a count: the port's counterpart of XLA's cost analysis
is ``torch.utils.flop_counter.FlopCounterMode`` (``core/calibrate.py``
uses it), which counts matmul-class operations only and needs the step to
run.  The step's bound on one card (``launch.hlo_analysis.analyze_step``)
comes from this model instead; the CPU tests hold its forward FLOPs to
``FlopCounterMode`` on small one-layer configs, within the reference's
bands.  :func:`port_step_cost` is the same model with two terms as the
port runs the step (no recompute; only the experts a batch routes to).

Accounting conventions (the reference's):
* flops — matmul-only (2·M·N·K per GEMM); elementwise/softmax/norm omitted
  (< 2% for these shapes).  Causal attention counts the attended half.
* train multiplier — forward 1× + backward 2× (+1× recompute when
  cfg.remat == "full"), applied to in-graph matmuls; the optimizer adds
  ~20 flops/param.
* HBM bytes — weight traffic (each step: fwd read, bwd read, remat read,
  fp32 grad write+read, moment read+write ×2, param write) + activation
  traffic (residual-stream tensors r/w per layer, attention K/V streamed
  once per query block as in the flash schedule, logits in f32) + decode
  KV/state cache read per token.  MoE weight traffic counts ALL experts
  (they are resident and touched by the dispatch GEMMs); MoE flops count
  the CAPACITY buffer actually multiplied (C = ceil(T·k/E·cf)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..models.config import ModelConfig, _mlp_params, param_count
from ..models.transformer import window_schedule

P_BYTES = 2          # bf16 params/activations
G_BYTES = 4          # fp32 grads / moments-default


def _attended(S: int, causal: bool, window: int) -> float:
    """Average attended KV length per query."""
    full = (S + 1) / 2 if causal else S
    if window and window > 0:
        return min(window, full)
    return full


def _attn_flops(cfg: ModelConfig, B: int, Sq: int, Skv_att: float) -> float:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    proj = 2 * B * Sq * d * (H * dh) + 2 * 2 * B * Sq * d * (K * dh) \
        + 2 * B * Sq * (H * dh) * d
    scores = 2 * 2 * B * H * Sq * Skv_att * dh          # QKᵀ + PV
    return proj + scores


def _cross_attn_flops(cfg: ModelConfig, B: int, Sq: int, Smem: int) -> float:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    proj = 2 * B * Sq * d * (H * dh) + 2 * B * Sq * (H * dh) * d \
        + 2 * 2 * B * Smem * d * (K * dh)
    scores = 2 * 2 * B * H * Sq * Smem * dh
    return proj + scores


def _mlp_flops(cfg: ModelConfig, B: int, S: int, d_ff: Optional[int] = None
               ) -> float:
    F = cfg.d_ff if d_ff is None else d_ff
    gates = 3 if cfg.act in ("swiglu", "geglu") else 2
    return gates * 2 * B * S * cfg.d_model * F


def _moe_flops(cfg: ModelConfig, B: int, S: int) -> float:
    m = cfg.moe
    T = B * S
    C = int(np.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    gates = 3 if cfg.act in ("swiglu", "geglu") else 2
    expert = gates * 2 * m.n_experts * C * cfg.d_model * m.d_ff_expert
    router = 2 * T * cfg.d_model * m.n_experts
    shared = (gates * 2 * T * cfg.d_model *
              m.d_ff_expert * m.n_shared_experts)
    return expert + router + shared


def _ssd_flops(cfg: ModelConfig, B: int, S: int, decode: bool = False) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H, N, P = s.n_heads(d), s.d_state, s.head_dim
    proj_out = 2 * di + 2 * s.n_groups * N + H
    conv_ch = di + 2 * s.n_groups * N
    io = 2 * B * S * d * proj_out + 2 * B * S * di * d \
        + 2 * B * S * conv_ch * s.d_conv
    if decode:
        core = 6 * B * S * H * N * P
    else:
        Q = min(s.chunk, S)
        core = (2 * B * S * Q * H * N          # C·Bᵀ scores per chunk
                + 2 * B * S * Q * H * P        # (scores∘L)·xdt
                + 2 * B * S * H * N * P        # chunk states
                + 2 * B * S * H * N * P)       # inter-chunk output
    return io + core


def _layer_flops(cfg: ModelConfig, B: int, Sq: int, *, window: int,
                 causal: bool = True, Skv: Optional[float] = None) -> float:
    att = _attn_flops(cfg, B, Sq,
                      Skv if Skv is not None else _attended(Sq, causal, window))
    if cfg.family == "moe":
        return att + _moe_flops(cfg, B, Sq)
    return att + _mlp_flops(cfg, B, Sq)


def forward_flops(cfg: ModelConfig, B: int, S: int, *, decode: bool = False,
                  cache_len: int = 0) -> float:
    """Forward flops for one step over S tokens/seq (decode: S=1/seq)."""
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    Sq = 1 if decode else S
    total = 2 * B * Sq * d * V                      # unembed
    if cfg.family == "ssm":
        total += L * _ssd_flops(cfg, B, Sq, decode=decode)
        return total
    if cfg.family == "hybrid":
        total += L * _ssd_flops(cfg, B, Sq, decode=decode)
        G = L // max(cfg.hybrid_group, 1)
        Skv = float(cache_len) if decode else None
        total += G * (_attn_flops(cfg, B, Sq,
                                  Skv if Skv else _attended(Sq, True, 0))
                      + _mlp_flops(cfg, B, Sq))
        return total
    if cfg.is_encdec:
        S_enc = S // 2 if not decode else cache_len // 2
        S_dec = Sq if decode else S // 2
        if not decode:                              # encoder runs at prefill
            total += cfg.encoder_layers * (
                _attn_flops(cfg, B, S_enc, _attended(S_enc, False, 0))
                + _mlp_flops(cfg, B, S_enc))
        dec_kv = float(cache_len) if decode else None
        total += L * (_attn_flops(cfg, B, S_dec,
                                  dec_kv if dec_kv else _attended(S_dec, True, 0))
                      + _cross_attn_flops(cfg, B, S_dec, S_enc)
                      + _mlp_flops(cfg, B, S_dec))
        return total
    # dense / vlm / moe decoders, incl. gemma3 local:global pattern
    for w in window_schedule(cfg):
        if decode:
            kv = float(min(int(w), cache_len)) if int(w) > 0 else float(cache_len)
            total += _layer_flops(cfg, B, 1, window=int(w), Skv=kv)
        else:
            total += _layer_flops(cfg, B, S, window=int(w))
    return total


# ---------------------------------------------------------------------------
# HBM traffic
# ---------------------------------------------------------------------------
def _weight_traffic(cfg: ModelConfig, kind: str, opt_bytes: int = G_BYTES
                    ) -> float:
    n_total, n_active = param_count(cfg)
    n_touched = n_total            # MoE dispatch GEMMs touch every expert
    if kind == "train":
        remat = 1 if cfg.remat == "full" else 0
        reads = (2 + remat) * n_touched * P_BYTES
        grads = 2 * n_total * G_BYTES
        opt = n_total * (2 * opt_bytes * 2 + P_BYTES)   # m,v r/w + param write
        return reads + grads + opt
    return n_touched * P_BYTES


def _act_traffic(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    """Residual-stream + attention-streaming activation bytes."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    stream = 12 * B * S * d * P_BYTES                # r/w per layer ≈ 12 tensors
    # attention K/V streamed once per query block (flash IO), q blocks of 512
    if cfg.family not in ("ssm",):
        nq = max(S // 512, 1)
        kv_stream = 2 * B * S * cfg.n_kv * cfg.head_dim * P_BYTES * nq
    else:
        kv_stream = 0
    per_layer = stream + kv_stream
    mult = {"train": 3, "prefill": 1, "decode": 1}[kind]
    total = L * per_layer * mult
    total += B * S * V * G_BYTES * (2 if kind == "train" else 1)   # logits f32
    return total


def _cache_bytes(cfg: ModelConfig, B: int, cache_len: int) -> float:
    """Decode-step cache read volume (the decode memory wall)."""
    if cfg.family == "ssm":
        s = cfg.ssm
        per = (s.n_heads(cfg.d_model) * s.d_state * s.head_dim * 4
               + (s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state)
               * (s.d_conv - 1) * P_BYTES)
        return cfg.n_layers * B * per * 2            # read + write
    if cfg.family == "hybrid":
        s = cfg.ssm
        per = (s.n_heads(cfg.d_model) * s.d_state * s.head_dim * 4
               + (s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state)
               * (s.d_conv - 1) * P_BYTES)
        ssm = cfg.n_layers * B * per * 2
        G = cfg.n_layers // max(cfg.hybrid_group, 1)
        kv = G * 2 * B * cache_len * cfg.n_kv * cfg.head_dim * P_BYTES
        return ssm + kv
    total = 0.0
    for w in window_schedule(cfg):
        eff = min(int(w), cache_len) if int(w) > 0 else cache_len
        total += 2 * B * eff * cfg.n_kv * cfg.head_dim * P_BYTES
    if cfg.is_encdec:
        total += cfg.n_layers * 2 * B * (cache_len // 2) \
            * cfg.n_kv * cfg.head_dim * P_BYTES      # cross K/V
    return total


@dataclass(frozen=True)
class StepCost:
    flops: float
    hbm_bytes: float


def step_cost(cfg: ModelConfig, kind: str, seq: int, batch: int,
              opt_bytes: int = G_BYTES) -> StepCost:
    """Global per-step cost of one (arch × shape) cell."""
    n_total, _ = param_count(cfg)
    if kind == "train":
        fwd = forward_flops(cfg, batch, seq)
        mult = 3 + (1 if cfg.remat == "full" else 0)
        flops = fwd * mult + 20 * n_total
        nbytes = (_weight_traffic(cfg, "train", opt_bytes)
                  + _act_traffic(cfg, batch, seq, "train"))
        return StepCost(flops, nbytes)
    if kind == "prefill":
        flops = forward_flops(cfg, batch, seq)
        nbytes = (_weight_traffic(cfg, "prefill")
                  + _act_traffic(cfg, batch, seq, "prefill"))
        return StepCost(flops, nbytes)
    if kind == "decode":
        flops = forward_flops(cfg, batch, 1, decode=True, cache_len=seq)
        nbytes = (_weight_traffic(cfg, "decode")
                  + _act_traffic(cfg, batch, 1, "decode")
                  + _cache_bytes(cfg, batch, seq))
        return StepCost(flops, nbytes)
    raise ValueError(kind)


def port_step_cost(cfg: ModelConfig, kind: str, seq: int, batch: int,
                   opt_bytes: int = G_BYTES) -> StepCost:
    """:func:`step_cost` of the step as the port runs it, the divisor of a
    roofline share measured on the card.  Two terms differ:

    * no recompute: the port's trainer keeps its activations for the
      backward (``cfg.remat`` has no meaning on one card), so a train step
      is forward 1x + backward 2x and reads the weights twice;
    * MoE: a step of T tokens routes to at most T·top_k experts, so
      ``min(E, T·top_k)`` experts' weights are read and multiplied (the
      reference counts all E, resident for its dispatch GEMMs; the port's
      decode path skips empty experts on the device).  A batch-4 top-6
      decode of a 64-expert model touches 24.
    """
    cfg = cfg.replace(remat="none")
    cost = step_cost(cfg, kind, seq, batch, opt_bytes)
    if cfg.family != "moe":
        return cost
    m = cfg.moe
    T = batch * (1 if kind == "decode" else seq)
    idle = m.n_experts - min(m.n_experts, T * m.top_k)
    if not idle:
        return cost
    C = int(np.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    gates = 3 if cfg.act in ("swiglu", "geglu") else 2
    idle_flops = cfg.n_layers * gates * 2 * idle * C * cfg.d_model * m.d_ff_expert
    idle_bytes = cfg.n_layers * idle * _mlp_params(cfg.d_model, m.d_ff_expert,
                                                   cfg.act) * P_BYTES
    fwd_passes, weight_reads = (3, 2) if kind == "train" else (1, 1)
    return StepCost(cost.flops - fwd_passes * idle_flops,
                    cost.hbm_bytes - weight_reads * idle_bytes)
