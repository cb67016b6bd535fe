"""The plain reference of moonlight-16b-a3b: Moonlight-16B-A3B's decoder
(DeepSeek-V3's architecture) in plain PyTorch, float32, one sequence at a
time, with no cache and no batching.

Each layer adds MLA(norm1(x)) and then FFN(norm2(x)) to x; the FFN is a
dense SwiGLU in the first ``first_dense_layers`` layers and the MoE in the
rest (both, and ``mla``, under the configuration's ``moe`` object).  Then the final norm and the untied output head.

* MLA, unabsorbed, as the equations read: per head q = [q_nope | rope(q_pe)]
  from ``wq``; the token's latent c and shared key k_pe from ``wkv_a``, c
  normed; per head [k_nope | v] = norm(c) ``wkv_b``; the key is [k_nope |
  rope(k_pe)]; causal softmax(q k^T / sqrt(nope + rope)) v, queries in
  blocks; out through ``wo``.
* MoE, dropless and per token: sigmoid scores s = sigmoid(h W_router) in
  float32 (the configuration's router dtype, as the program's router); each
  token takes the ``top_k`` experts of largest s + bias and weighs each by
  s / (sum of its k scores), times ``routed_scale``; every token's every
  chosen expert is computed (a SwiGLU of ``d_ff_expert``), and the shared
  experts' SwiGLU of ``n_shared_experts`` x ``d_ff_expert`` is added.  The
  configuration's ``moe`` object decides scoring, bias, scale and
  dropping, so the tests can hold the port against variants.

Departures from the published model, each the port's own (the
configuration file lists them under ``assumed``): rotary positions in two
halves where DeepSeek-V3's code rotates interleaved pairs (published
weights would need their rope columns permuted); RMSNorm scaled by ``1 +
scale``; the embedding scaled by sqrt(d_model) rounded to bfloat16; random
weights drawn from the run's seed.  Group-limited routing (``n_group``,
``topk_group``) is left out: at the published 1 and 1 it selects every
group.  The latent's norm takes DeepSeek-V3's epsilon 1e-6.

Every matrix product but the float32 router's goes through ``prec.mm``,
so the float8 control (``pb.reference.FP8``) runs unchanged.  Imports
nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pb import reference as R

KV_NORM_EPS = 1e-6      # DeepSeek-V3's kv_a_layernorm: RMSNorm's default epsilon
ATTN_BLOCK = 512


def _layer(params, conf, i):
    n = conf["moe"].get("first_dense_layers", 0)
    stacked, j = (params["dense_layers"], i) if i < n else (params["layers"], i - n)
    return R._layer(stacked, j)


def mla(p, h, conf, prec):
    """Causal latent attention of one sequence h [L, d], unabsorbed."""
    L, H, m = h.shape[0], conf["n_heads"], conf["moe"]["mla"]
    nope, rope, r, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["kv_lora_rank"],
                         m["v_head_dim"])
    theta = conf["rope_theta"]
    pos = torch.arange(L, device=h.device)
    q = prec.mm(h, p["wq"]).view(L, H, nope + rope)
    q = torch.cat([q[..., :nope], R.rope(q[..., nope:], pos, theta)], -1)
    kv = prec.mm(h, p["wkv_a"])                                 # [L, r + rope]
    c = R.rms_norm(kv[:, :r], p["kv_norm"], KV_NORM_EPS)
    k_pe = R.rope(kv[:, None, r:], pos, theta)                  # [L, 1, rope]
    kvb = prec.mm(c, p["wkv_b"]).view(L, H, nope + dv)
    k = torch.cat([kvb[..., :nope], k_pe.expand(L, H, rope)], -1)
    v = kvb[..., nope:]
    scale = 1.0 / math.sqrt(nope + rope)
    out = torch.empty(L, H, dv, dtype=torch.float32, device=h.device)
    for q0 in range(0, L, ATTN_BLOCK):
        q1 = min(L, q0 + ATTN_BLOCK)
        keep = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        for hd in range(H):
            s = prec.mm(q[q0:q1, hd], k[:q1, hd].T) * scale
            w = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
            out[q0:q1, hd] = prec.mm(w, v[:q1, hd])
    return prec.mm(out.reshape(L, H * dv), p["wo"])


def swiglu(h, w_gate, w_in, w_out, prec):
    return prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_in), w_out)


def moe(p, h, m, prec):
    """The routed experts, token by token, and the shared experts."""
    L, E, k = h.shape[0], m["n_experts"], m["top_k"]
    logits = h @ p["router"].float()                           # the router in float32
    sigmoid = m.get("scoring", "softmax") == "sigmoid"
    scores = torch.sigmoid(logits) if sigmoid else torch.softmax(logits, -1)
    choice = scores + p["bias"].float() if m.get("selection_bias") else scores
    idx = torch.topk(choice, k, dim=-1).indices                # [L, k]
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * m.get("routed_scale", 1.0)
    cap = None if m.get("dropless") else math.ceil(L * k / E * m["capacity_factor"])
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)          # in token order
        if cap is not None:
            tok, slot = tok[:cap], slot[:cap]                  # an expert keeps its first C
        if tok.numel():
            out = swiglu(h[tok], p["w_gate"][e], p["w_in"][e], p["w_out"][e], prec)
            y.index_add_(0, tok, out * w[tok, slot, None])
    if m.get("n_shared_experts", 0):
        y = y + swiglu(h, p["shared_gate"], p["shared_in"], p["shared_out"], prec)
    return y


def logits(params, conf, tokens, rows, prec=R.FP32):
    """Logits [len(rows), V] at positions ``rows`` of the sequence ``tokens``."""
    eps = conf["rms_eps"]
    x = R._embed(params, conf, tokens)
    for i in range(conf["n_layers"]):
        lp = _layer(params, conf, i)
        x = x + mla(lp["attn"], R.rms_norm(x, lp["norm1"], eps), conf, prec)
        h = R.rms_norm(x, lp["norm2"], eps)
        x = x + (moe(lp["moe"], h, conf["moe"], prec) if "moe" in lp
                 else R.mlp(lp["mlp"], h, conf["act"], prec))
    return R._logits(params, conf, x[rows], prec)
