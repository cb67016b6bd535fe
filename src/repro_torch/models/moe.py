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

Port-only, off by default (``DeepSeekMoEConfig``): DeepSeek-V3's router (sigmoid
scores, a per-expert bias added for selection only, the bare scores as
weights over their sum, times ``routed_scale``; it has no auxiliary
loss) and dropless dispatch.  Dropless, every expert's buffer has a row for
every token (C = T), so no assignment drops, and the expert GEMMs get each
expert's count: K6 computes no row past it (the plain einsum computes every
row).  The rows past a count are never written or read back.  A caller may
pass ``counts_out`` [E] int32 on the device: the layer's tokens per expert
are written there (nothing is read back; see :func:`expert_counters`).  A
dropless layer may also get ``live`` [B] bool on the device, the rows that
carry a sequence (a serving batch's free slots do not): the other rows are
routed to no expert, so their assignments are neither counted nor computed,
and their routed output is zero.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.grouped_matmul.ops import expert_ffn_matmul
from .config import ModelConfig
from .layers import Params, activate, dtype_of, normal_init, span


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
    if m.selection_bias:
        p["bias"] = normal_init(gen, (*lead, E), dtype, std=0.02)
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


def select_experts(logits: torch.Tensor, bias: Optional[torch.Tensor], m
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router (sigmoid or softmax scores; the top k of score
    + ``bias`` when given; weighted by the bare scores over their sum, times
    ``m.routed_scale``), in fp32.  logits [T, E] → (weights [T, k], idx
    [T, k])."""
    logits = logits.to(torch.float32)
    scores = torch.sigmoid(logits) if m.scoring == "sigmoid" else torch.softmax(logits, -1)
    choice = scores if bias is None else scores + bias.to(torch.float32)
    idx = torch.topk(choice, m.top_k, dim=-1, sorted=True).indices
    w = scores.gather(1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * m.routed_scale, idx


def _deepseek_router(m) -> bool:
    return m.scoring != "softmax" or m.selection_bias or m.routed_scale != 1.0


def buffer_rows(cfg: ModelConfig, tokens: int) -> int:
    """C, the rows of each expert's dispatch buffer for a layer over
    ``tokens`` tokens (one dispatch group): every token when dropless."""
    m = cfg.moe
    if m.dropless:
        return tokens
    return int(np.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor))


def _dispatch(p: Params, xt: torch.Tensor, idx: torch.Tensor, C: int,
              cfg: ModelConfig, counts: Optional[torch.Tensor] = None,
              live: Optional[torch.Tensor] = None):
    """Sort-based dispatch → expert GEMMs for ONE token group.
    xt [T, D]; idx [T, k]; ``counts`` [E], the group's tokens per expert
    where the caller has them (of the ``live`` tokens only, where given);
    ``live`` [T] bool (dropless only): the tokens routed at all; returns
    (ye [E·C, D], dest [T·k], keep [T·k], None when dropless and every
    token is live)."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.n_experts, m.top_k
    dev = xt.device

    flat_e = idx.reshape(-1)                                   # [T*k]
    n = flat_e.numel()
    token_of = torch.arange(n, device=dev) // k
    keep = None if live is None else live[token_of]            # [T*k] routed at all
    # a dead token's assignments sort after every live one (key E)
    key = flat_e if keep is None else torch.where(keep, flat_e, E)
    order = torch.argsort(key, stable=True)                    # assignments by expert
    if counts is None:
        counts = torch.zeros(E + 1, dtype=flat_e.dtype, device=dev).scatter_add_(
            0, key, torch.ones_like(flat_e))[:E]               # tokens per expert
    starts = torch.cumsum(counts, 0) - counts                  # first rank per expert
    ranks = torch.empty_like(flat_e).scatter_(
        0, order, torch.arange(n, dtype=flat_e.dtype, device=dev))   # sorted rank
    slot = ranks - starts[flat_e]                              # rank within expert
    if m.dropless:
        # every live assignment has its row; rows past an expert's count
        # stay unwritten, and K6 computes none of them; a dead token's
        # assignments write the spare last row, which is cut off
        dest = flat_e * C + slot
        spare = 0 if keep is None else 1
        if keep is not None:
            dest = torch.where(keep, dest, E * C)
        buf = torch.empty(E * C + spare, D, dtype=xt.dtype, device=dev)
        buf.index_copy_(0, dest, xt[token_of])
        xe = buf[:E * C].view(E, C, D)
    else:
        keep = slot < C                                        # capacity overflow drops
        dest = torch.where(keep, flat_e * C + slot, E * C)     # spare row E*C: dropped

        # gather tokens into [E*C, D] (duplicated per assignment); the dropped
        # assignments all land on the spare last row, which is cut off
        buf = torch.zeros(E * C + 1, D, dtype=xt.dtype, device=dev)
        buf.index_copy_(0, dest, xt[token_of])
        xe = buf[:E * C].view(E, C, D)

    # ---- expert GEMMs (grouped matmul K6 under use_kernels) ---------------
    if cfg.use_kernels and m.dropless:
        rows = counts.to(torch.int32)

        def mm(a, w):
            return expert_ffn_matmul(a, w, counts=rows)
    elif cfg.use_kernels:
        mm = expert_ffn_matmul
    else:
        def mm(a, w):
            return torch.einsum("ecd,edf->ecf", a, w)
    gate = mm(xe, p["w_gate"])
    up = mm(xe, p["w_in"])
    h = activate(gate, up, cfg.act if cfg.act != "gelu" else "swiglu")
    ye = mm(h, p["w_out"]).reshape(E * C, D)
    return ye, dest, keep


def _combine(ye: torch.Tensor, dest: torch.Tensor, keep: Optional[torch.Tensor],
             weights: torch.Tensor, T: int, dtype: torch.dtype) -> torch.Tensor:
    """Weighted gather-back of expert outputs. ye [E·C, D] → y [T, D];
    ``keep`` None: no assignment dropped."""
    k = weights.shape[-1]
    if keep is None:
        gathered = ye[dest]
    else:
        gathered = ye[torch.clamp(dest, 0, ye.shape[0] - 1)]
        gathered = torch.where(keep[:, None], gathered, 0.0)    # dropped -> 0
    contrib = gathered * weights.reshape(-1)[:, None].to(gathered.dtype)
    contrib = contrib.to(dtype).view(T, k, ye.shape[1])
    y = contrib[:, 0]
    for j in range(1, k):             # assignment order, rounded to dtype each add
        y = y + contrib[:, j]
    return y


def _dispatch_combine(p: Params, xt: torch.Tensor, weights: torch.Tensor,
                      idx: torch.Tensor, C: int, cfg: ModelConfig,
                      counts: Optional[torch.Tensor] = None,
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    ye, dest, keep = _dispatch(p, xt, idx, C, cfg, counts, live)
    return _combine(ye, dest, keep, weights, xt.shape[0], xt.dtype)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              counts_out: Optional[torch.Tensor] = None,
              live: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar fp32; None for the
    sigmoid router, which has none).

    With ``cfg.moe_dispatch_groups = G > 1`` the token axis is split into G
    independent dispatch groups: the argsort/scatter never crosses a group
    and capacity is enforced per group (C/G each).  G=1 is the global
    dispatch.  The router matmul runs in ``router_dtype`` (fp32): it must not
    drop to TF32 on the card, or routing flips (PyTorch's default keeps fp32
    matmuls in full fp32).  ``counts_out`` [E] int32: where the layer's
    tokens per expert (all groups) are written.  ``live`` [B] bool, dropless
    only: the rows routed at all (the others get no routed output).
    """
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    G = max(cfg.moe_dispatch_groups, 1)
    if T % G:
        G = 1                                     # smoke shapes: stay global
    Tg = T // G
    Cg = buffer_rows(cfg, Tg)
    xt = x.reshape(T, D)
    if live is not None:
        if not m.dropless:
            raise ValueError("live rows are routed apart only by a dropless MoE")
        live = live.to(torch.bool)[:, None].expand(B, S).reshape(T)

    with span("model.moe.route"):
        rd = dtype_of(m.router_dtype)
        logits = xt.to(rd) @ p["router"].to(rd)               # [T,E]
        if _deepseek_router(m):
            weights, idx = select_experts(logits, p.get("bias"), m)
        else:
            weights, idx = router_topk(logits, k)              # [T,k]
        flat = idx.reshape(-1)
        if counts_out is None:
            counts = torch.zeros(E, dtype=flat.dtype, device=x.device)
        else:
            counts = counts_out.zero_()
        ones = (torch.ones_like(flat, dtype=counts.dtype) if live is None
                else live[:, None].expand(T, k).reshape(-1).to(counts.dtype))
        counts.scatter_add_(0, flat, ones)

    aux = None
    if m.scoring == "softmax":
        # load-balancing auxiliary loss (Switch-style), always global
        probs_mean = torch.softmax(logits.to(torch.float32), dim=-1).mean(0)   # [E]
        frac = counts.to(torch.float32) / (T * k)
        aux = E * torch.sum(frac * probs_mean)

    with span("model.moe.experts"):
        y = _experts(p, xt, weights, idx, Cg, cfg, G, counts, live)
    if m.n_shared_experts:
        sg = xt @ p["shared_gate"]
        su = xt @ p["shared_in"]
        y = y + (activate(sg, su, "swiglu") @ p["shared_out"])

    return y.reshape(B, S, D), aux


def _experts(p: Params, xt: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor,
             Cg: int, cfg: ModelConfig, G: int, counts: torch.Tensor,
             live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts' combined output [T, D], over G dispatch groups."""
    T, D = xt.shape
    Tg, k = T // G, cfg.moe.top_k
    if G == 1:
        y = _dispatch_combine(p, xt, weights, idx, Cg, cfg, counts, live)
    else:
        xg = xt.reshape(G, Tg, D)
        wg = weights.reshape(G, Tg, k)
        ig = idx.reshape(G, Tg, k)
        lg = [None] * G if live is None else live.reshape(G, Tg)
        if cfg.moe_combine_replicated:
            # the reference all-gathers ye over the expert axis before a
            # shard-local combine; on one card ye is whole already
            parts = [_dispatch(p, xg[g], ig[g], Cg, cfg, live=lg[g]) for g in range(G)]
            y = torch.cat([_combine(ye, de, ke, wg[g], Tg, xt.dtype)
                           for g, (ye, de, ke) in enumerate(parts)])
        else:
            y = torch.cat([_dispatch_combine(p, xg[g], wg[g], ig[g], Cg, cfg, live=lg[g])
                           for g in range(G)])
    return y


class MoECounts(NamedTuple):
    """What a step's MoE layers did: layer launches, experts that held a
    token (summed over launches), real expert rows (assignments computed)
    and rows the expert GEMMs computed (K6's row tiles, or every row of the
    plain einsum)."""
    launches: int = 0
    experts: int = 0
    rows: int = 0
    computed: int = 0

    def __add__(self, other: "MoECounts") -> "MoECounts":
        return MoECounts(*(a + b for a, b in zip(self, other)))


def _row_tile(cfg: ModelConfig, C: int, device: torch.device) -> Optional[int]:
    """The rows K6 computes per counted expert rounds to (dropless on the
    card's kernels), or None where every row of the buffer is computed."""
    if not (cfg.moe.dropless and cfg.use_kernels and device.type == "cuda"):
        return None
    from ..kernels.grouped_matmul.grouped_matmul import ROW_TILE, path_of
    return ROW_TILE[path_of(dtype_of(cfg.compute_dtype), C, cfg.d_model, cfg.moe.d_ff_expert)]


def expert_counters(counts: np.ndarray, tokens: int, cfg: ModelConfig,
                    device: torch.device) -> MoECounts:
    """``counts`` [launches, E], each MoE layer launch's tokens per expert
    (``counts_out``, read back), over ``tokens`` tokens a launch (one
    dispatch group) → :class:`MoECounts`."""
    counts = np.asarray(counts, np.int64).reshape(-1, cfg.moe.n_experts)
    C = buffer_rows(cfg, tokens)
    real = np.minimum(counts, C)
    tile = _row_tile(cfg, C, device)
    if tile is None:
        computed = real.size * C
    else:
        computed = int((-(-real // tile) * tile).sum())
    return MoECounts(counts.shape[0], int((counts > 0).sum()), int(real.sum()), int(computed))
