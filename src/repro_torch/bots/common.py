"""Paper-style speedup curves over device counts (twin of
``benchmarks/common.py``).

Per-task *compute* seconds are measured on the device (each EXEC ends in a
stream synchronize), and the parallel makespan comes from the runtime's
:class:`~repro_torch.core.costmodel.CostModel` — devices modeled concurrent,
all host↔device transfers serialized through the host NIC at the paper's
link speed.  On the card the virtual devices are shares of one H100, so the
makespan is a model of the paper's cluster, not a time measured on one.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, List

from .._device import DeviceLike
from ..core import ClusterRuntime, KernelTable, RuntimeConfig
from ..core.costmodel import PAPER_ETHERNET, LinkModel


@dataclass
class CurvePoint:
    devices: int
    compute_s: float
    comm_s: float
    makespan_s: float
    makespan_overlap_s: float
    bytes_to: float
    bytes_from: float
    speedup: float
    speedup_overlap: float


@dataclass
class Curve:
    name: str
    size: str
    serial_s: float
    device: str = ""
    points: List[CurvePoint] = field(default_factory=list)

    def to_dict(self):
        return {"name": self.name, "size": self.size, "serial_s": self.serial_s,
                "device": self.device, "points": [vars(p) for p in self.points]}

    def render(self) -> str:
        hdr = (f"## {self.name} ({self.size}, {self.device})  "
               f"serial={self.serial_s:.3f}s\n"
               f"{'devs':>5} {'compute_s':>10} {'comm_s':>9} {'makespan':>9} "
               f"{'speedup':>8} {'overlap':>8} {'MB_to':>8} {'MB_from':>8}")
        rows = [f"{p.devices:>5} {p.compute_s:>10.3f} {p.comm_s:>9.3f} "
                f"{p.makespan_s:>9.3f} {p.speedup:>8.2f} "
                f"{p.speedup_overlap:>8.2f} {p.bytes_to/1e6:>8.2f} "
                f"{p.bytes_from/1e6:>8.2f}"
                for p in self.points]
        return "\n".join([hdr] + rows)


def run_curve(name: str, size: str, table: KernelTable,
              workload: Callable[[ClusterRuntime, int], Any], *,
              serial: Callable[[ClusterRuntime], Any],
              device_counts=(1, 2, 4, 8),
              link: LinkModel = PAPER_ETHERNET,
              warmup: bool = True, repeats: int = 3,
              device: DeviceLike = "cuda") -> Curve:
    """``workload(rt, n_devices)`` runs the offloaded program; ``serial(rt)``
    runs the single-device original (the paper's baseline).  Each point is
    the median of ``repeats`` runs."""
    def median_run(rt, fn):
        sums = []
        for _ in range(max(repeats, 1)):
            rt.cost.reset()
            fn()
            sums.append(rt.cost.summary())
        sums.sort(key=lambda s: s["makespan_s"])
        return sums[len(sums) // 2]

    rt = ClusterRuntime(RuntimeConfig(n_virtual=1, link=link, device=device),
                        table=table)
    try:
        if warmup:
            serial(rt)
        s0 = median_run(rt, lambda: serial(rt))
    finally:
        rt.shutdown()
    curve = Curve(name=name, size=size, serial_s=s0["compute_s"],
                  device=str(rt.device))
    for n in device_counts:
        rt = ClusterRuntime(RuntimeConfig(n_virtual=n, link=link, device=device),
                            table=table)
        try:
            if warmup:
                workload(rt, n)
            s = median_run(rt, lambda: workload(rt, n))
        finally:
            rt.shutdown()
        curve.points.append(CurvePoint(
            devices=n, compute_s=s["compute_s"], comm_s=s["comm_s"],
            makespan_s=s["makespan_s"],
            makespan_overlap_s=s["makespan_overlap_s"],
            bytes_to=s["bytes_to"], bytes_from=s["bytes_from"],
            speedup=curve.serial_s / s["makespan_s"] if s["makespan_s"] else 0.0,
            speedup_overlap=(curve.serial_s / s["makespan_overlap_s"]
                             if s["makespan_overlap_s"] else 0.0)))
    return curve


def save_results(path: str, curves: List[Curve]) -> None:
    """Write ``curves`` as ``benchmarks/common.py::save_results`` does: a
    JSON list of :meth:`Curve.to_dict` (the reference's keys, plus
    ``device``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump([c.to_dict() for c in curves], f, indent=1)
