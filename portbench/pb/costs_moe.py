"""The yardstick's arithmetic for a decoder of latent attention (MLA) and
routed experts (moonlight-16b-a3b): the operations and bytes a decode step
and the expert GEMMs (K6) need, from the attributes of a ``ModelConfig``
and the engine's own step counters.  Frozen here, as :mod:`pb.costs` is for
the dense family: later changes to the program do not move these numbers.

Conventions as :mod:`pb.costs`: matmul FLOPs only (2·M·N·K), each input
read once and each output written once, H100 roofs.  A decode step reads
every weight but the routed experts' and the input embedding's (of which
it reads its rows), the experts that hold a token that step (the engine's
counters: a dropless MoE routes the live rows only, and a free slot's row
pulls in no expert), each live row's latent cache up to its fill, and each
row's activations.
"""
from __future__ import annotations

import bisect
import functools
from typing import Iterable, List, Optional

from .costs import P_BYTES, roof_s

#: the names of K6's kernels in a device trace (``csrc/grouped_matmul.cu``)
K6_KERNELS = ("gmm_wgmma_kernel", "gmm_small_c_kernel", "grouped_matmul_kernel")


def _moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers


def expert_params(cfg) -> int:
    """One routed expert's SwiGLU: gate, up and down."""
    return 3 * cfg.d_model * cfg.moe.d_ff_expert


def _mla_params(cfg) -> int:
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return (d * h * qk + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) + h * m.v_head_dim * d)


def resident_params(cfg) -> int:
    """The weights a decode step reads whole: attention, norms, the dense
    layers' MLPs, each MoE layer's router, bias and shared experts, and the
    output head (not the routed experts, not the input embedding)."""
    d, m = cfg.d_model, cfg.moe
    per_moe = (d * m.n_experts + (m.n_experts if m.selection_bias else 0)
               + m.n_shared_experts * expert_params(cfg))
    return (cfg.n_layers * (_mla_params(cfg) + 2 * d)
            + cfg.first_dense_layers * 3 * d * cfg.d_ff
            + _moe_layers(cfg) * per_moe + d + cfg.vocab * d)


def cache_width(cfg) -> int:
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


@functools.lru_cache(maxsize=1 << 16)
def _decode_row(cfg, fill: int):
    """(bytes, flops) of one live row at cache fill ``fill`` (the new token
    counted), beside the weights."""
    m, d, L = cfg.mla, cfg.d_model, cfg.n_layers
    row_cache = cache_width(cfg) * P_BYTES
    act = d * P_BYTES + L * (12 * d * P_BYTES + row_cache) + cfg.vocab * 4
    cache = L * fill * row_cache
    attn = L * cfg.n_heads * 2 * fill * (cache_width(cfg) + m.kv_lora_rank)
    mm = 2 * (resident_params(cfg) + _moe_layers(cfg) * cfg.moe.top_k * expert_params(cfg))
    return act + cache, mm + attn


def decode_step_need(cfg, fills: Iterable[int], experts: int):
    """(bytes, flops) a decode step needs: live rows at these fills, and
    ``experts`` routed experts holding a token, summed over the MoE layers."""
    nbytes = float((resident_params(cfg) + experts * expert_params(cfg)) * P_BYTES)
    flops = 0.0
    for f in fills:
        b, fl = _decode_row(cfg, int(f))
        nbytes, flops = nbytes + b, flops + fl
    return nbytes, flops


def gmm_need(cfg, experts: int, rows: int):
    """(bytes, flops) of the expert GEMMs of MoE layer launches in which
    ``experts`` experts held ``rows`` real rows in all: each such expert's
    three weights read once, each real row in and out of each GEMM."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    nbytes = experts * expert_params(cfg) * P_BYTES + rows * 3 * (d + f) * P_BYTES
    return float(nbytes), float(2 * rows * expert_params(cfg))


def gmm_roof_s(cfg, counts) -> float:
    """The least time of one step phase's expert GEMMs (a ``MoECounts``)."""
    if counts is None or not counts.launches:
        return 0.0
    return roof_s(*gmm_need(cfg, counts.experts, counts.rows))


def k6_seconds(trace) -> float:
    """K6's device seconds in a traced window, by its kernels' names."""
    return sum(t for name, (t, _) in trace.kernels.items()
               if any(k in name for k in K6_KERNELS))


def step_records(ctx) -> Optional[List]:
    """The engine's step record of each of the harness's steps (aligned
    with ``ctx.tl.step_ends``; None where none was found), or None where
    the program keeps no step records."""
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None
    ends = ctx.tl.step_ends
    out: List = [None] * len(ends)
    if not ends:
        return out
    t_open = ctx.tl.window[0]
    for rec in TELEMETRY.step_log:
        # a step ends on the host after the engine's record of it, and
        # before the next step starts
        if rec.t0 >= t_open and rec.t1 <= ends[-1]:
            k = bisect.bisect_left(ends, rec.t1)
            if k == 0 or ends[k - 1] < rec.t0:
                out[k] = rec
    return out
