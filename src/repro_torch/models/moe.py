"""Mixture-of-Experts FFN: token-choice top-k with sort-based dispatch.

The port of ``repro/models/moe.py``.  Tokens are ranked within their expert
by a stable argsort of expert ids, gathered into an [E, C, D] buffer
(assignments past an expert's capacity C drop, empty slots stay zero),
pushed through the stacked expert GEMMs and scattered back with the router's
combine weights.  With ``cfg.use_kernels`` the three expert GEMMs run the
grouped-matmul kernel K6 (``kernels/grouped_matmul``; the plain version on
CPU tensors); without it they are einsums in the activation dtype, as the
reference's oracle.  The reference never reaches its own Pallas K6: its MoE
always takes that oracle.

Nothing here reads a value back to the host, so a decode step never waits
for the card: counts are a ``scatter_add_`` (``bincount`` reads its maximum
back), a dropped assignment writes a spare last row of the dispatch buffer
(in place of the reference's out-of-bounds ``mode="drop"`` scatter) that is
then cut off, and no boolean mask indexes a tensor.  The combine adds each
token's k contributions in assignment order in the activation dtype, as the
reference's ``.at[token_of].add`` does on the CPU, with no atomics.

The reference's ``logical_constraint`` sharding hints (expert-parallel
layouts, the all-gather of ``moe_combine_replicated``) have no meaning on one
card and are left out; both G > 1 branches stay, and compute the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.grouped_matmul.ops import expert_ffn_matmul
from .config import ModelConfig
from .layers import Params, activate, dtype_of, normal_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, n_layers: Optional[int] = None,
             dtype: Optional[torch.dtype] = None) -> Params:
    dtype = dtype or dtype_of(cfg.param_dtype)
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    lead = () if n_layers is None else (n_layers,)
    p = {
        "router": normal_init(gen, (*lead, d, E), dtype, std=0.02),
        "w_gate": normal_init(gen, (*lead, E, d, f), dtype),
        "w_in": normal_init(gen, (*lead, E, d, f), dtype),
        "w_out": normal_init(gen, (*lead, E, f, d), dtype),
    }
    if m.n_shared_experts:
        fs = m.d_ff_expert * m.n_shared_experts
        p["shared_gate"] = normal_init(gen, (*lead, d, fs), dtype)
        p["shared_in"] = normal_init(gen, (*lead, d, fs), dtype)
        p["shared_out"] = normal_init(gen, (*lead, fs, d), dtype)
    return p


def router_topk(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-then-topk router. logits [T,E] -> (weights [T,k], idx [T,k])."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)      # renormalize
    return w, idx


def _dispatch(p: Params, xt: torch.Tensor, idx: torch.Tensor, C: int,
              cfg: ModelConfig):
    """Sort-based dispatch → expert GEMMs for ONE token group.
    xt [T, D]; idx [T, k]; returns (ye [E·C, D], dest [T·k], keep [T·k])."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.n_experts, m.top_k
    dev = xt.device

    flat_e = idx.reshape(-1)                                   # [T*k]
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)                 # assignments by expert
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))                    # tokens per expert
    starts = torch.cumsum(counts, 0) - counts                  # first rank per expert
    ranks = torch.empty_like(flat_e).scatter_(
        0, order, torch.arange(n, dtype=flat_e.dtype, device=dev))   # sorted rank
    slot = ranks - starts[flat_e]                              # rank within expert
    keep = slot < C                                            # capacity overflow drops
    dest = torch.where(keep, flat_e * C + slot, E * C)         # spare row E*C: dropped

    # gather tokens into [E*C, D] (duplicated per assignment); the dropped
    # assignments all land on the spare last row, which is cut off
    token_of = torch.arange(n, device=dev) // k
    buf = torch.zeros(E * C + 1, D, dtype=xt.dtype, device=dev)
    buf.index_copy_(0, dest, xt[token_of])
    xe = buf[:E * C].view(E, C, D)

    # ---- expert GEMMs (grouped matmul K6 under use_kernels) ---------------
    mm = expert_ffn_matmul if cfg.use_kernels else (
        lambda a, w: torch.einsum("ecd,edf->ecf", a, w))
    gate = mm(xe, p["w_gate"])
    up = mm(xe, p["w_in"])
    h = activate(gate, up, cfg.act if cfg.act != "gelu" else "swiglu")
    ye = mm(h, p["w_out"]).reshape(E * C, D)
    return ye, dest, keep


def _combine(ye: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
             weights: torch.Tensor, T: int, dtype: torch.dtype) -> torch.Tensor:
    """Weighted gather-back of expert outputs. ye [E·C, D] → y [T, D]."""
    k = weights.shape[-1]
    gathered = ye[torch.clamp(dest, 0, ye.shape[0] - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)        # dropped -> 0
    contrib = gathered * weights.reshape(-1)[:, None].to(gathered.dtype)
    contrib = contrib.to(dtype).view(T, k, ye.shape[1])
    y = contrib[:, 0]
    for j in range(1, k):             # assignment order, rounded to dtype each add
        y = y + contrib[:, j]
    return y


def _dispatch_combine(p: Params, xt: torch.Tensor, weights: torch.Tensor,
                      idx: torch.Tensor, C: int, cfg: ModelConfig) -> torch.Tensor:
    ye, dest, keep = _dispatch(p, xt, idx, C, cfg)
    return _combine(ye, dest, keep, weights, xt.shape[0], xt.dtype)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar fp32).

    With ``cfg.moe_dispatch_groups = G > 1`` the token axis is split into G
    independent dispatch groups: the argsort/scatter never crosses a group
    and capacity is enforced per group (C/G each).  G=1 is the global
    dispatch.  The router matmul runs in ``router_dtype`` (fp32): it must not
    drop to TF32 on the card, or routing flips (PyTorch's default keeps fp32
    matmuls in full fp32).
    """
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    G = max(cfg.moe_dispatch_groups, 1)
    if T % G:
        G = 1                                     # smoke shapes: stay global
    Tg = T // G
    Cg = int(np.ceil(Tg * k / E * m.capacity_factor))
    xt = x.reshape(T, D)

    rd = dtype_of(m.router_dtype)
    logits = xt.to(rd) @ p["router"].to(rd)                   # [T,E]
    weights, idx = router_topk(logits, k)                      # [T,k]

    # load-balancing auxiliary loss (Switch-style), always global
    probs_mean = torch.softmax(logits.to(torch.float32), dim=-1).mean(0)   # [E]
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=flat.dtype, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    frac = counts.to(torch.float32) / (T * k)
    aux = E * torch.sum(frac * probs_mean)

    if G == 1:
        y = _dispatch_combine(p, xt, weights, idx, Cg, cfg)
    else:
        xg = xt.reshape(G, Tg, D)
        wg = weights.reshape(G, Tg, k)
        ig = idx.reshape(G, Tg, k)
        if cfg.moe_combine_replicated:
            # the reference all-gathers ye over the expert axis before a
            # shard-local combine; on one card ye is whole already
            parts = [_dispatch(p, xg[g], ig[g], Cg, cfg) for g in range(G)]
            y = torch.cat([_combine(ye, de, ke, wg[g], Tg, xt.dtype)
                           for g, (ye, de, ke) in enumerate(parts)])
        else:
            y = torch.cat([_dispatch_combine(p, xg[g], wg[g], ig[g], Cg, cfg)
                           for g in range(G)])

    if m.n_shared_experts:
        sg = xt @ p["shared_gate"]
        su = xt @ p["shared_in"]
        y = y + (activate(sg, su, "swiglu") @ p["shared_out"])

    return y.reshape(B, S, D), aux
