"""AdamW with selectable moment precision (fp32 / bf16 / int8), in PyTorch.

Port of ``repro.optim.adamw``.  :func:`adamw_update` is the stateless step
that ``ClusterRuntime.data_parallel_step`` runs as a device kernel over
resident parameters and moments; :class:`AdamW` is the host optimizer, whose
moments may be kept in bfloat16 or in block-int8 (the scales of
:mod:`repro_torch.core.compression`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core import _tree
from ..core import compression as comp

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: Any = 3e-4                  # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"    # float32 | bfloat16 | int8


class _QMoment(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        c = comp.compress(x)
        return _QMoment(c.q, c.scale, tuple(x.shape))
    return x.to(_DTYPES[dtype])


def _decode(m, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return comp.decompress(comp.Compressed(m.q, m.scale), m.shape)
    return m.to(torch.float32)


def _global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in _tree.leaves(grads)))


def _clip_scale(gnorm: torch.Tensor, clip_norm: float):
    if clip_norm > 0:
        return torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return 1.0


def adamw_update(params: Any, grads: Any, mu: Any, nu: Any,
                 count: torch.Tensor, *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_norm: float = 1.0) -> Dict[str, Any]:
    """One AdamW step as a pure function of trees — the device kernel body.

    The math of :class:`AdamW` with fp32 moments, stateless:
    hyperparameters arrive as plain scalars (``firstprivate`` in a target
    region), ``count`` is an fp32 scalar tensor living on the device, and
    the returned dict names every updated buffer so it can back a
    ``device_out`` map.
    """
    count = count + 1.0
    scale = _clip_scale(_global_norm(grads), clip_norm)
    b1c = 1 - torch.pow(b1, count)
    b2c = 1 - torch.pow(b2, count)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step_dir = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        p32 = p.to(torch.float32)
        new_p = p32 - lr * (step_dir + weight_decay * p32)
        return new_p.to(p.dtype), m, v

    flat_p, tdef = _tree.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, _tree.leaves(grads), _tree.leaves(mu), _tree.leaves(nu))]
    return {"params": _tree.unflatten(tdef, [o[0] for o in out]),
            "mu": _tree.unflatten(tdef, [o[1] for o in out]),
            "nu": _tree.unflatten(tdef, [o[2] for o in out]),
            "count": count}


class AdamW:
    def __init__(self, cfg: AdamWConfig) -> None:
        self.cfg = cfg

    def init(self, params: Any) -> Dict[str, Any]:
        leaves, tdef = _tree.flatten(params)

        def zeros():
            return _tree.unflatten(tdef, [
                _encode(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        self.cfg.state_dtype) for p in leaves])

        return {"mu": zeros(), "nu": zeros(),
                "count": torch.zeros((), dtype=torch.int32)}

    def _lr(self, step):
        return self.cfg.lr(step) if callable(self.cfg.lr) else self.cfg.lr

    def update(self, grads: Any, state: Dict[str, Any], params: Any
               ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
        cfg = self.cfg
        count = state["count"] + 1
        gnorm = _global_norm(grads)
        scale = _clip_scale(gnorm, cfg.clip_norm)
        lr = self._lr(count)
        b1c = 1 - torch.pow(cfg.b1, count.to(torch.float32))
        b2c = 1 - torch.pow(cfg.b2, count.to(torch.float32))

        def upd(p, g, mu, nu):
            g = g.to(torch.float32) * scale
            m = cfg.b1 * _decode(mu, cfg.state_dtype) + (1 - cfg.b1) * g
            v = cfg.b2 * _decode(nu, cfg.state_dtype) + (1 - cfg.b2) * g * g
            step_dir = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            p32 = p.to(torch.float32)
            new_p = p32 - lr * (step_dir + cfg.weight_decay * p32)
            return (new_p.to(p.dtype), _encode(m, cfg.state_dtype),
                    _encode(v, cfg.state_dtype))

        flat_p, tdef = _tree.flatten(params)
        out = [upd(p, g, m, v) for p, g, m, v in
               zip(flat_p, _tree.leaves(grads), _tree.leaves(state["mu"]),
                   _tree.leaves(state["nu"]))]
        new_params = _tree.unflatten(tdef, [o[0] for o in out])
        new_mu = _tree.unflatten(tdef, [o[1] for o in out])
        new_nu = _tree.unflatten(tdef, [o[2] for o in out])
        return new_params, {"mu": new_mu, "nu": new_nu, "count": count}, \
            {"grad_norm": gnorm, "lr": torch.as_tensor(lr)}
