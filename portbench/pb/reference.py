"""The plain reference: the served models' forward pass in plain PyTorch,
one sequence at a time, in float32 with TF32 off.

It follows the models as the configuration files state them (the port's
equations, whose departures from the published models each file lists
under ``assumed``): pre-norm RMSNorm scaled by ``1 + scale``, the
embedding scaled by sqrt(d) rounded to the served dtype, rotary positions
on the full head in two halves, grouped-query causal attention, squared
ReLU or tanh-GELU-gated MLPs.  It takes the benchmark's weights as they
are served (bfloat16) and widens each where it is used; it reads nothing
the program made and imports nothing of the program.

``Precision`` rounds the inputs of every matrix product.  ``FP32`` rounds
nothing; ``FP8`` rounds weights (per output channel) and activations (per
token) to float8 e4m3 with an absmax scale: the control, the nearest
precision below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]
ATTN_BLOCK = 512


class Precision:
    name = "fp32"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.float32)

    def a(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.a(x) @ self.w(w)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    t = t.to(torch.float32)
    scale = (t.abs().amax(dim=dim, keepdim=True) / 448.0).clamp(min=1e-30)
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class FP8(Precision):
    name = "fp8_e4m3"

    def w(self, t: torch.Tensor) -> torch.Tensor:      # [in, out]: per column
        return _fp8(t, 0)

    def a(self, t: torch.Tensor) -> torch.Tensor:      # [..., in]: per row
        return _fp8(t, -1)


FP32 = Precision()


def _head_dim(conf) -> int:
    return conf.get("d_head") or conf["d_model"] // conf["n_heads"]


def _served_dtype(conf) -> torch.dtype:
    return getattr(torch, conf.get("param_dtype", "bfloat16"))


def embed_scale(conf) -> float:
    return float(torch.tensor(math.sqrt(conf["d_model"]), dtype=_served_dtype(conf)))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [L, heads, dh]; the head dim in two halves."""
    dh = x.shape[-1]
    freqs = 1.0 / torch.pow(float(np.float32(theta)),
                            torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = pos.float()[:, None] * freqs                     # [L, dh/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: Params, h: torch.Tensor, conf, prec: Precision) -> torch.Tensor:
    """Causal GQA self-attention of one sequence h [L, d]."""
    L = h.shape[0]
    H, K, dh = conf["n_heads"], conf["n_kv"], _head_dim(conf)
    r = H // K
    pos = torch.arange(L, device=h.device)
    q = rope(prec.mm(h, p["wq"]).view(L, H, dh), pos, conf["rope_theta"])
    k = rope(prec.mm(h, p["wk"]).view(L, K, dh), pos, conf["rope_theta"])
    v = prec.mm(h, p["wv"]).view(L, K, dh)
    qg = q.view(L, K, r, dh) / math.sqrt(dh)
    out = torch.empty(L, K, r, dh, dtype=torch.float32, device=h.device)
    for q0 in range(0, L, ATTN_BLOCK):
        q1 = min(L, q0 + ATTN_BLOCK)
        s = torch.einsum("qkrd,skd->krqs", qg[q0:q1], k[:q1])
        keep = torch.arange(q1, device=h.device)[None, :] <= torch.arange(
            q0, q1, device=h.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        out[q0:q1] = torch.einsum("krqs,skd->qkrd", torch.softmax(s, -1), v[:q1])
    return prec.mm(out.reshape(L, H * dh), p["wo"])


def mlp(p: Params, h: torch.Tensor, act: str, prec: Precision) -> torch.Tensor:
    up = prec.mm(h, p["w_in"])
    if act == "relu2":
        g = F.relu(up).square()
    elif act == "geglu":
        g = F.gelu(prec.mm(h, p["w_gate"]), approximate="tanh") * up
    elif act == "swiglu":
        g = F.silu(prec.mm(h, p["w_gate"])) * up
    else:
        raise ValueError(f"no reference for activation {act!r}")
    return prec.mm(g, p["w_out"])


def _layer(stacked: Params, i) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def _embed(params: Params, conf, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens].float() * embed_scale(conf)


def _logits(params: Params, conf, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], conf["rms_eps"])
    table = params.get("unembed", params["embed"])["table"]      # [V, d]
    return prec.a(x) @ (_fp8(table, -1) if isinstance(prec, FP8) else table.float()).T


def logits(params: Params, conf, tokens: torch.Tensor, rows: torch.Tensor,
           prec: Precision = FP32) -> torch.Tensor:
    """Logits [len(rows), V] at positions ``rows`` of the sequence ``tokens``:
    the dense family's reference, which a configuration without a
    ``references/<name>.py`` of its own takes."""
    if conf["family"] != "dense":
        raise ValueError(f"no plain reference for family {conf['family']!r}: "
                         f"add references/{conf['name']}.py")
    eps = conf["rms_eps"]
    x = _embed(params, conf, tokens)
    for i in range(conf["n_layers"]):
        lp = _layer(params["layers"], i)
        x = x + attention(lp["attn"], rms_norm(x, lp["norm1"], eps), conf, prec)
        x = x + mlp(lp["mlp"], rms_norm(x, lp["norm2"], eps), conf["act"], prec)
    return _logits(params, conf, x[rows], prec)


class exact_float32:
    """TF32 off for matmuls and convolutions inside the block."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec) = self._saved
        torch.set_float32_matmul_precision(prec)
        return None
