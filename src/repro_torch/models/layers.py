"""Shared neural-net layers (functional, dict-of-tensor params).

The port of ``repro/models/layers.py``.  Initialisers draw from an explicit
``torch.Generator`` (on the device the parameters are made on); the same
seed does not give JAX's numbers, so parity tests carry the reference's
parameters across with :func:`repro_torch.interop.params_from_numpy`.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
_DRAW_VALUES = 1 << 27      # fp32 values drawn at once, unless one slice is larger


def normal_init(gen: torch.Generator, shape, dtype: torch.dtype,
                std: float = 0.02) -> torch.Tensor:
    """N(0, std²) drawn in fp32 and rounded to ``dtype``, filled into the
    leaf a run of leading-dim slices at a time (one slice, or as many as
    hold 2^27 values): the fp32 draw never holds more than one such run.
    Drawn whole, a stacked MoE leaf ([48, 64, 2048, 1408]: 35 GB of fp32)
    would not fit on the card beside the weights."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    step = max(1, _DRAW_VALUES // out[0].numel())
    for i in range(0, out.shape[0], step):
        part = out[i:i + step]
        part.copy_(torch.randn(part.shape, generator=gen, device=gen.device,
                               dtype=torch.float32).mul_(std))
    return out


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32, scaled by ``1 + scale``, in x's dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(z)), silu taken in fp32 and
    rounded to x's dtype before the product, as the reference does."""
    x32 = (x * F.silu(z.to(torch.float32)).to(x.dtype)).to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))).to(x.dtype)


def activate(gate: torch.Tensor, up: Optional[torch.Tensor], act: str) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if act == "gelu":
        return F.gelu(gate, approximate="tanh")
    if act == "relu2":                      # squared ReLU (nemotron/minitron)
        r = F.relu(gate)
        return r * r
    raise ValueError(act)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype, n_layers: Optional[int] = None) -> Params:
    lead = () if n_layers is None else (n_layers,)
    p = {"w_in": normal_init(gen, (*lead, d_model, d_ff), dtype),
         "w_out": normal_init(gen, (*lead, d_ff, d_model), dtype)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal_init(gen, (*lead, d_model, d_ff), dtype)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_in"]
    gate = x @ p["w_gate"] if "w_gate" in p else up
    h = activate(gate, up if "w_gate" in p else None, act)
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # a Python-scalar base: no host-to-device copy (which would synchronize)
    return 1.0 / torch.pow(float(np.float32(theta)), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S].  fp32, with
    the head dim split in halves (not interleaved pairs), as the reference."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)                     # [Dh/2]
    angles = positions[..., :, None].to(torch.float32) * freqs        # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]                             # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype: torch.dtype) -> Params:
    return {"table": normal_init(gen, (vocab, d_model), dtype,
                                 std=1.0 / np.sqrt(d_model))}


def embed_apply(p: Params, tokens: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """Rows of the table; scaled by sqrt(d_model) rounded to the table's
    dtype first (55.5 in bf16 for d = 3072), as the reference does."""
    x = p["table"][tokens.long()]
    if scale:
        x = x * _embed_scale(x.shape[-1], x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def _embed_scale(d: int, dtype: torch.dtype) -> float:
    """sqrt(d) rounded to ``dtype`` on the host: no host-to-device copy, and
    once per (d, dtype), so a decode step after the prefill reads no
    tensor's value."""
    return float(torch.tensor(np.sqrt(d), dtype=dtype))


def unembed_apply(p: Params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = x @ p["table"].T
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
