"""ClusterRuntime: the paper's system as one deployable object.

Port of ``repro.core.runtime`` for ``comm_mode="host-mediated"`` — the
paper-faithful topology, where every exchange crosses the host.  Ties the
configuration → :class:`DevicePool` (virtual shares of one card), the kernel
table, the :class:`TargetExecutor` and the cost model together.

Left for later slices, each raising ``NotImplementedError``:
``comm_mode="direct"``, a topology and the data-parallel fabric (ROADMAP
item 9), per-device capacity (item 10) and calibration (item 12).  The
reference's compression, peer-link and command-deadline settings are not
fields yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from .._device import DeviceLike, resolve_device
from .costmodel import CostModel, LinkModel, PAPER_ETHERNET
from .device import DevicePool
from .kernel_table import KernelTable
from .target import TargetExecutor
from .transport import HostFunnelTransport, Transport


@dataclass
class RuntimeConfig:
    nodes: Sequence[str] = ()                 # paper-style config lines
    n_virtual: Optional[int] = None           # or: N virtual devices
    link: LinkModel = PAPER_ETHERNET
    comm_mode: str = "host-mediated"          # "direct" is ROADMAP item 9
    topology: Any = None                      # ROADMAP item 9
    max_host_threads: int = 16
    device_capacity_bytes: Optional[int] = None   # ROADMAP item 10
    # where every virtual device lives: the card unless the caller asks for
    # the CPU (raises when CUDA is absent)
    device: DeviceLike = "cuda"


class ClusterRuntime:
    def __init__(self, cfg: RuntimeConfig, table: Optional[KernelTable] = None,
                 device: Optional[DeviceLike] = None) -> None:
        """``device`` overrides ``cfg.device`` when given."""
        if cfg.comm_mode == "direct" or cfg.topology is not None:
            raise NotImplementedError(
                "comm_mode='direct' and topology: ROADMAP item 9")
        if cfg.comm_mode != "host-mediated":
            raise ValueError(f"unknown comm_mode {cfg.comm_mode!r}")
        if cfg.device_capacity_bytes is not None:
            raise NotImplementedError(
                "device_capacity_bytes (spill/refetch): ROADMAP item 10")
        self.cfg = cfg
        self.device = resolve_device(cfg.device if device is None else device)
        if cfg.n_virtual is not None:
            self.pool = DevicePool.virtual(cfg.n_virtual, device=self.device,
                                           table=table, link=cfg.link)
        else:
            self.pool = DevicePool.from_config(cfg.nodes, device=self.device,
                                               table=table, link=cfg.link)
        self.ex = TargetExecutor(self.pool, max_host_threads=cfg.max_host_threads)
        self.transport: Transport = HostFunnelTransport()

    @property
    def cost(self) -> CostModel:
        return self.pool.cost

    def target(self, *a, **kw):
        return self.ex.target(*a, **kw)

    def taskwait(self):
        return self.ex.taskwait()

    def wavefront_offload(self, tasks: Sequence[Any], **kw) -> Dict[str, Any]:
        """Run a task DAG on this runtime's executor."""
        from .scheduler import wavefront_offload
        return wavefront_offload(self.ex, tasks, **kw)

    def memory_report(self) -> Dict[int, Dict[str, int]]:
        """Per-device present-table accounting: hits, misses, bytes elided,
        resident entries and bytes."""
        return {d: self.pool.present[d].stats()
                for d in range(len(self.pool))}

    def shutdown(self) -> None:
        self.pool.stop_all()
        self.ex.close()

    def calibrate(self, *a, **kw):
        raise NotImplementedError("calibrate: ROADMAP item 12")

    def data_parallel_grads(self, *a, **kw):
        raise NotImplementedError("data_parallel_grads: ROADMAP item 9")

    def data_parallel_step(self, *a, **kw):
        raise NotImplementedError("data_parallel_step: ROADMAP item 9")
