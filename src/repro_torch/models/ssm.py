"""Mamba2 blocks via SSD (state-space duality), arXiv:2405.21060.

The port of ``repro/models/ssm.py``.  The SSD recurrence per head (scalar A
per head, as in Mamba2):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)        h ∈ R^{N×P}
    y_t = C_t · h_t + D * x_t

Prefill runs the *chunked* SSD algorithm: with ``cfg.use_kernels`` the
hand-written SSD-scan kernel K5 on the card (``kernels.ssd_scan``), else the
plain ``ssd_chunked`` (the reference's jnp oracle, which the reference's
models run; its Pallas kernel is never called from them).  The causal
depthwise conv and the O(1) decode recurrence are plain torch, as in the
reference, which has no kernel for them.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ref import ssd_chunked
from .config import ModelConfig
from .layers import Params, dtype_of, normal_init, rms_norm_gated


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` takes it (``logaddexp(x, 0)``):
    ``F.softplus`` turns linear above 20."""
    return torch.logaddexp(x, x.new_zeros(()))


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) single-token recurrence.

    h: [b,H,N,P] fp32; x: [b,H,P]; dt: [b,H]; B,C: [b,G,N].
    Returns (y [b,H,P] in C's dtype, h_new fp32).
    """
    H = x.shape[1]
    rep = H // B.shape[1]
    f32 = torch.float32
    Bh = B.repeat_interleave(rep, dim=1)                     # [b,H,N]
    Ch = C.repeat_interleave(rep, dim=1)
    a = torch.exp(dt * A)                                    # [b,H]
    xdt = x.to(f32) * dt[..., None]
    h_new = h * a[..., None, None] + Bh.to(f32)[..., :, None] * xdt[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(f32), h_new.to(Ch.dtype).to(f32))
    return y.to(Ch.dtype), h_new


# ---------------------------------------------------------------------------
# Mamba2 block (projections + causal conv + SSD + gated norm)
# ---------------------------------------------------------------------------
def mamba2_init(gen: torch.Generator, cfg: ModelConfig, n_layers: Optional[int] = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    dtype = dtype or dtype_of(cfg.param_dtype)
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + nh
    lead = () if n_layers is None else (n_layers,)
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": normal_init(gen, (*lead, d, proj_out), dtype),
        "conv_w": normal_init(gen, (*lead, s.d_conv, conv_ch), dtype, std=0.1),
        "conv_b": torch.zeros(*lead, conv_ch, dtype=dtype, device=dev),
        "A_log": torch.zeros(*lead, nh, dtype=f32, device=dev),   # A = -exp(A_log)
        "D": torch.ones(*lead, nh, dtype=f32, device=dev),
        "dt_bias": torch.zeros(*lead, nh, dtype=f32, device=dev),
        "norm_scale": torch.zeros(*lead, di, dtype=dtype, device=dev),
        "out_proj": normal_init(gen, (*lead, di, d), dtype),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gN = s.n_groups * s.d_state
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * gN, nh], dim=-1)
    return z, xbc, dt_raw, di, nh, gN


def mamba2_apply(p: Params, x_in: torch.Tensor, cfg: ModelConfig, *,
                 conv_state: Optional[torch.Tensor] = None,
                 ssm_state: Optional[torch.Tensor] = None,
                 return_state: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Mamba2 mixer. Prefill: states None. Decode: x_in [B,1,D] + states.

    conv_state: [B, d_conv-1, conv_ch]; ssm_state: [B, H, N, P].
    ``return_state=True`` (prefill) also returns the exact post-sequence
    states so decode continues where the prompt left off.
    Returns (out [B,S,D], new states or None).
    """
    s = cfg.ssm
    f32 = torch.float32
    B_, S, _ = x_in.shape
    proj = x_in @ p["in_proj"]
    z, xbc, dt_raw, di, nh, gN = _split_proj(proj, cfg)
    dt = softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    w = p["conv_w"].to(f32)                                  # [d_conv, C]

    decode = conv_state is not None
    if decode:
        # causal depthwise conv via the state buffer
        window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        conv_out = torch.einsum("bwc,wc->bc", window.to(f32), w)
        xbc = F.silu(conv_out + p["conv_b"].to(f32))[:, None]
        new_conv_state = window[:, 1:]
    else:
        xbc_raw = xbc
        pad = xbc.new_zeros(B_, s.d_conv - 1, xbc.shape[-1])
        seq = torch.cat([pad, xbc], dim=1).to(f32)
        # depthwise causal conv: output[t] = sum_w w[w] * seq[t + w]
        conv_out = seq[:, 0:S] * w[0]
        for i in range(1, s.d_conv):
            conv_out = conv_out + seq[:, i:i + S] * w[i]
        xbc = F.silu(conv_out + p["conv_b"].to(f32))
        # exact conv state for decode handoff: the last d_conv-1 raw inputs
        new_conv_state = xbc_raw[:, S - (s.d_conv - 1):] if return_state else None

    xbc = xbc.to(x_in.dtype)
    xs, Bmat, Cmat = torch.split(xbc, [di, gN, gN], dim=-1)
    P_ = s.head_dim
    xh = xs.reshape(B_, -1, nh, P_)
    Bh = Bmat.reshape(B_, -1, s.n_groups, s.d_state)
    Ch = Cmat.reshape(B_, -1, s.n_groups, s.d_state)

    if decode:
        y, h_new = ssd_decode_step(ssm_state, xh[:, 0], dt[:, 0], A, Bh[:, 0], Ch[:, 0])
        y = y[:, None]                                       # [B,1,H,P]
        new_states = (new_conv_state, h_new)
    else:
        if cfg.use_kernels:
            from ..kernels.ssd_scan.ops import ssd_chunked_scan
            y, h_last = ssd_chunked_scan(xh, dt, A, Bh, Ch, chunk=min(s.chunk, S))
        else:
            y, h_last = ssd_chunked(xh, dt, A, Bh, Ch, chunk=min(s.chunk, S))
        new_states = (new_conv_state, h_last) if return_state else None

    y = y + xh[:, :y.shape[1]] * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B_, -1, di)
    y = rms_norm_gated(y, z[:, :y.shape[1]], p["norm_scale"], cfg.rms_eps)
    out = y @ p["out_proj"]
    return out, new_states


def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: Optional[int] = None,
                   dtype: torch.dtype = torch.float32, *, device: Any
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(conv state [*, B, d_conv-1, conv_ch] in the compute dtype, SSM state
    [*, B, H, N, P] in ``dtype``), zeros on ``device``."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    lead = () if n_layers is None else (n_layers,)
    conv_state = torch.zeros(*lead, batch, s.d_conv - 1, conv_ch,
                             dtype=dtype_of(cfg.compute_dtype), device=device)
    ssm_state = torch.zeros(*lead, batch, nh, s.d_state, s.head_dim, dtype=dtype,
                            device=device)
    return conv_state, ssm_state
