"""Roofline terms of one step on one H100 (no HLO on this path: the name is the reference's).

The port's counterpart of ``repro/launch/hlo_analysis.py``.  The reference
reads XLA's compiled HLO and cost analysis; the port has no compiler
artifact to read, so the terms come from the analytic step model
(``launch.analytic_cost``), which the reference's dry run makes
authoritative anyway (its ``flops_override``/``bytes_override``):

  compute term    = step FLOPs  / (chips × peak bf16 FLOP/s)
  memory term     = step bytes  / (chips × HBM bandwidth)
  collective term = collective bytes / (chips × link bandwidth)

The roofs are one H100 SXM's (``core/costmodel.py``): 989 TFLOP/s bf16 on
the tensor cores and 3.35 TB/s of HBM.  ``collective_stats`` and
``analyze_compiled``, which parse XLA's HLO text, have no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..core.costmodel import H100_SXM_HBM_BW_Bps, H100_SXM_PEAK_FLOPS_BF16
from ..models.config import ModelConfig, param_count
from .analytic_cost import G_BYTES, port_step_cost, step_cost

PEAK_FLOPS_BF16 = H100_SXM_PEAK_FLOPS_BF16
HBM_BW = H100_SXM_HBM_BW_Bps


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # step FLOPs (the analytic model's)
    hlo_bytes: float               # step HBM bytes (the analytic model's)
    collective_bytes: float        # 0 on one card: nothing crosses a link
    collective_by_kind: Dict[str, int]
    collective_ops: int
    model_flops: float             # 6·N·D (train) / 2·N·D (fwd-only)
    bytes_per_device: Optional[float] = None   # the step's resident bytes
    link_bytes_per_device: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        """Always 0 on one card: a single H100 runs the whole step, so no
        operand crosses a link (the reference's ICI term over its mesh).
        The field stays so the record keeps the reference's layout."""
        return 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / step FLOPs — remat/redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of compute roofline if perfectly overlapped:
        t_compute / max(all terms) — 1.0 means compute-bound already."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    @property
    def t_bound(self) -> float:
        """The least time the card could take for the step: the larger term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": self.collective_by_kind,
            "collective_ops": self.collective_ops,
            "link_bytes_per_device": self.link_bytes_per_device,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, kind: str, seq: int, batch: int,
                    n_total: int, n_active: int) -> float:
    """MODEL_FLOPS per step: 6·N·D train, 2·N·D prefill, 2·N·B decode."""
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    if kind == "decode":
        return 2.0 * n_active * batch          # one token per sequence
    raise ValueError(kind)


def analyze_step(cfg: ModelConfig, kind: str, seq: int, batch: int, *,
                 arch: Optional[str] = None, shape: Optional[str] = None,
                 opt_bytes: int = G_BYTES, cost: str = "port",
                 bytes_per_device: Optional[float] = None) -> Roofline:
    """The :class:`Roofline` of one step on one card: the counterpart of the
    reference's ``analyze_compiled``, with ``hlo_flops``/``hlo_bytes`` the
    analytic step totals and ``model_flops`` from :func:`model_flops_for`.
    ``seq`` is the cache length for decode.  ``cost="port"`` prices the step
    the port runs (``port_step_cost``: the divisor of a share measured on
    the card); ``cost="reference"`` the reference's count (``step_cost``,
    float for float), which the dry run records."""
    total, active = param_count(cfg)
    step = {"port": port_step_cost, "reference": step_cost}[cost](
        cfg, kind, seq, batch, opt_bytes=opt_bytes)
    return Roofline(
        arch=arch or cfg.name, shape=shape or f"{kind}_{seq}x{batch}",
        mesh="h100", chips=1, hlo_flops=step.flops, hlo_bytes=step.hbm_bytes,
        collective_bytes=0.0, collective_by_kind={}, collective_ops=0,
        model_flops=model_flops_for(cfg, kind, seq, batch, total, active),
        bytes_per_device=bytes_per_device)
