"""ClusterRuntime: the paper's system as one deployable object.

Port of ``repro.core.runtime``.  Ties the configuration → :class:`DevicePool`
(virtual shares of one card), the kernel table, the :class:`TargetExecutor`,
the cost model and the transport together, and exposes the data-parallel
trainer *fabric* built from target regions:

* ``comm_mode="host-mediated"`` — paper-faithful: every gradient crosses to
  the host, is reduced there, and the update is re-sent.  The only topology
  OpenMP allows ("Two devices cannot communicate with each other directly").
* ``comm_mode="direct"`` — beyond the paper: devices exchange buffers over
  the peer fabric (:class:`~.transport.PeerTransport`: SEND/RECV between the
  virtual devices' streams), ring all-reduce for gradients, gather → reduce
  → broadcast for parameter averaging, hierarchical under a multi-rack
  :class:`~.topology.Topology`.
* ``compress=True`` — the block-int8 wire: error feedback on the host hop,
  the wire's round trip on each device before the peer ring.

Left for later slices, each raising ``NotImplementedError``: transport
retries (ROADMAP item 11), per-device capacity (item 10) and calibration
(item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from .._device import DeviceLike, resolve_device
from . import _tree
from . import compression as comp
from .costmodel import CostModel, LinkModel, PAPER_ETHERNET
from .device import DevicePool
from .kernel_table import KernelTable
from .mediary import TensorSpec
from .target import MapSpec, TargetExecutor
from .topology import Topology
from .transport import HostFunnelTransport, PeerTransport, Transport


@dataclass
class RuntimeConfig:
    nodes: Sequence[str] = ()                 # paper-style config lines
    n_virtual: Optional[int] = None           # or: N virtual devices
    link: LinkModel = PAPER_ETHERNET
    comm_mode: str = "host-mediated"          # "host-mediated" | "direct"
    # device↔device link for comm_mode="direct" (None: the same fabric as
    # `link` — the paper's cluster is one Gbit Ethernet for every pair)
    peer_link: Optional[LinkModel] = None
    # hierarchical fabric shape (None: flat).  A multi-rack Topology makes
    # "direct" rack-aware: per-pair pricing, hierarchical collectives (still
    # bit-identical to host-mediated) and "peer+int8" edge routing.  Must
    # describe exactly the pool's device count.
    topology: Optional[Topology] = None
    compress: bool = False
    max_host_threads: int = 16
    device_capacity_bytes: Optional[int] = None   # ROADMAP item 10
    transport_retries: int = 0                    # ROADMAP item 11
    # where every virtual device lives: the card unless the caller asks for
    # the CPU (raises when CUDA is absent)
    device: DeviceLike = "cuda"


def _specs(tree: Any) -> Any:
    """The tree of :class:`TensorSpec` of a tree of tensors (the port's
    ``jax.eval_shape(lambda p: p, tree)``)."""
    leaves, tdef = _tree.flatten(tree)
    return _tree.unflatten(tdef, [TensorSpec(tuple(l.shape), l.dtype)
                                  for l in leaves])


def _tree_map(fn, *trees):
    flat = [_tree.flatten(t) for t in trees]
    return _tree.unflatten(flat[0][1],
                           [fn(*xs) for xs in zip(*(f[0] for f in flat))])


class ClusterRuntime:
    def __init__(self, cfg: RuntimeConfig, table: Optional[KernelTable] = None,
                 device: Optional[DeviceLike] = None) -> None:
        """``device`` overrides ``cfg.device`` when given."""
        if cfg.comm_mode not in ("host-mediated", "direct"):
            raise ValueError(f"unknown comm_mode {cfg.comm_mode!r}")
        if cfg.device_capacity_bytes is not None:
            raise NotImplementedError(
                "device_capacity_bytes (spill/refetch): ROADMAP item 10")
        if cfg.transport_retries > 0:
            raise NotImplementedError(
                "transport_retries (peer retry and funnel fallback): "
                "ROADMAP item 11")
        self.cfg = cfg
        self.device = resolve_device(cfg.device if device is None else device)
        if cfg.n_virtual is not None:
            self.pool = DevicePool.virtual(cfg.n_virtual, device=self.device,
                                           table=table, link=cfg.link)
        else:
            self.pool = DevicePool.from_config(cfg.nodes, device=self.device,
                                               table=table, link=cfg.link)
        self.ex = TargetExecutor(self.pool, max_host_threads=cfg.max_host_threads)
        if cfg.topology is not None and cfg.topology.n_devices != len(self.pool):
            self.shutdown()
            raise ValueError(
                f"topology describes {cfg.topology.n_devices} devices but "
                f"the pool has {len(self.pool)}")
        # the topology rides on both the cost model (per-pair peer timing,
        # cross-rack accounting) and the transport (hierarchical
        # collectives, compression-aware edge routing)
        self.pool.cost.peer_link = cfg.peer_link
        self.pool.cost.topology = cfg.topology
        self.transport: Transport = (
            PeerTransport(cfg.peer_link, topology=cfg.topology)
            if cfg.comm_mode == "direct" else HostFunnelTransport())
        self._ef_residual: Optional[List[Any]] = None
        self._dps: Optional[Dict[str, Any]] = None   # data_parallel_step state

    @property
    def cost(self) -> CostModel:
        return self.pool.cost

    def target(self, *a, **kw):
        return self.ex.target(*a, **kw)

    def taskwait(self):
        return self.ex.taskwait()

    def wavefront_offload(self, tasks: Sequence[Any], **kw) -> Dict[str, Any]:
        """Run a task DAG on this runtime's executor.  ``peer=True`` uses
        this runtime's transport when it is a peer fabric
        (``comm_mode="direct"``); under a host-mediated runtime the
        scheduler's default :class:`~.transport.PeerTransport` carries the
        DAG's edges — ``peer=True`` is an explicit request for the peer
        wire."""
        from .scheduler import wavefront_offload
        if (kw.get("peer") and "transport" not in kw
                and isinstance(self.transport, PeerTransport)):
            kw["transport"] = self.transport
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

    # -- data-parallel gradient fabric ------------------------------------------
    def _ensure_dp_params(self, d: int, params: Any, tag: str) -> None:
        """Pin ``params`` resident under the runtime's own entry name
        ``_dpg_params``, so a user's ``enter_data(d, params=...)`` is never
        refreshed or freed by the trainer fabric."""
        try:
            self.ex.ensure_resident(d, f"{tag}:params", _dpg_params=params)
        except ValueError:
            # new model/shape under the same name: replace the environment
            self.ex.exit_data(d, "_dpg_params")
            self.ex.ensure_resident(d, f"{tag}:params", _dpg_params=params)

    def data_parallel_grads(self, kernel: str, params: Any,
                            batches: Sequence[Any], *, tag: str = "dp",
                            resident: bool = True) -> Any:
        """One DP gradient exchange over the pool; returns the mean gradient.

        ``kernel`` is a registered kernel ``(params, batch) -> {"grads":
        tree}``.  host-mediated: every device's gradients cross to the host
        (the funnel), the host reduces ``sum(g) / D``; with ``compress=True``
        each is compressed with error feedback, and the byte difference is
        credited back as a zero-latency adjustment.  direct: gradients stay
        on the devices (``device_out`` into a resident buffer), the
        transport ring all-reduces them peer to peer, and the host fetches
        ONE reduced copy; with ``compress=True`` each device first applies
        the wire's block-int8 round trip and the ring accounts the
        compressed message sizes.

        ``resident=True`` keeps ``params`` in each device's data environment
        across calls (unchanged parameters move zero bytes after the first
        call); ``resident=False`` is the per-region ALLOC/XFER/FREE cycle.
        """
        D = len(self.pool)
        if len(batches) != D:
            raise ValueError(f"need one batch per device, got {len(batches)}")
        if self.cfg.comm_mode == "direct":
            return self._dp_grads_direct(kernel, params, batches, tag=tag,
                                         resident=resident)
        gspec = _specs(params)
        futs = []
        for d in range(D):
            if resident:
                self._ensure_dp_params(d, params, tag)
                maps = MapSpec(to={"batch": batches[d]},
                               present={"params": "_dpg_params"},
                               from_={"grads": gspec})
            else:
                maps = MapSpec(to={"params": params, "batch": batches[d]},
                               from_={"grads": gspec})
            futs.append(self.ex.target(kernel, d, maps, nowait=True,
                                       tag=f"{tag}[{d}]"))
        grads = [r["grads"] for r in self.ex.drain(futs)]

        if self.cfg.compress:
            if self._ef_residual is None:
                self._ef_residual = [_tree_map(comp.ef_init, g) for g in grads]
            reconstructed = []
            for d, g in enumerate(grads):
                c, self._ef_residual[d] = comp.tree_ef_compress(
                    g, self._ef_residual[d])
                nbytes = sum(comp.compressed_nbytes(x) for x in _tree.leaves(c))
                raw = sum(l.numel() * l.element_size() for l in _tree.leaves(g))
                # compression replaces the raw from-transfer bytes: credit
                # the difference back (the messages already happened; only
                # their size changes)
                self.cost.record_adjustment("from", d, int(nbytes - raw),
                                            tag=f"{tag}:compress-credit")
                reconstructed.append(comp.tree_decompress(c, g))
            grads = reconstructed
        # host reduce in ascending device order (the funnel is the fetch)
        return _tree_map(lambda *g: sum(g) / D, *grads)

    def _dp_grads_direct(self, kernel: str, params: Any, batches: Sequence[Any],
                         *, tag: str, resident: bool) -> Any:
        """The peer path: resident gradients, a real ring, one host copy."""
        D, pool, ex = len(self.pool), self.pool, self.ex
        gspec = _specs(params)
        gleaves = _tree.leaves(gspec)
        futs = []
        for d in range(D):
            if resident:
                self._ensure_dp_params(d, params, tag)
            ent = pool.present[d].get("_dpg_grads")
            if ent is not None and list(ent.specs) != gleaves:
                ex.exit_data(d, "_dpg_grads")    # param shapes changed
                ent = None
            if ent is None:
                ex.alloc_resident(d, "_dpg_grads", gspec, tag=f"{tag}:grads")
            maps = MapSpec(to={"batch": batches[d]} if resident
                           else {"params": params, "batch": batches[d]},
                           present={"params": "_dpg_params"} if resident else (),
                           device_out={"grads": "_dpg_grads"})
            futs.append(ex.target(kernel, d, maps, nowait=True, tag=f"{tag}[{d}]"))
        ex.drain(futs)
        handles = [pool.present[d].get("_dpg_grads").handles for d in range(D)]
        specs = pool.present[0].get("_dpg_grads").specs
        wire = None
        if self.cfg.compress:
            wire = self.transport.quantize_int8(pool, handles, specs,
                                                tag=f"{tag}:q8")
        wfuts = self.transport.ring_allreduce(pool, handles, specs,
                                              wire_nbytes=wire, tag=f"{tag}:ring")
        self._mark_ahead("_dpg_grads", wfuts)
        total = ex.fetch_resident(0, "_dpg_grads")   # the one funnel copy
        mean = _tree_map(lambda s: s / D, total)
        if not resident:
            for d in range(D):
                ex.exit_data(d, "_dpg_grads")
        return mean

    def _mark_ahead(self, name: str, wfuts: List[List[Any]]) -> None:
        """A collective wrote entry ``name`` on every device: device-ahead,
        a new version, its writes the collective's last ones."""
        pool = self.pool
        for d in range(len(pool)):
            with pool.env_locks[d]:
                ent = pool.present[d].get(name)
                if ent is not None:
                    ent.device_ahead = True
                    ent.version += 1
                    ent.write_futs = list(wfuts[d])

    # -- device-resident optimizer: local AdamW steps, periodic param sync ----
    def data_parallel_step(self, kernel: str, params: Any, batches: Sequence[Any],
                           *, opt_cfg: Optional[Any] = None, sync_every: int = 4,
                           tag: str = "dps") -> Any:
        """One local-update DP step with a device-resident optimizer.

        ``kernel`` is a registered ``(params, batch) -> {"grads": tree}``
        kernel.  Each device keeps ``params`` and the AdamW moments resident
        and applies the update on the device (a fused grad + AdamW kernel
        whose results ``device_out`` writes back into the present entries:
        nothing crosses the wire).  Every ``sync_every``-th step averages
        the parameters (:meth:`data_parallel_sync`): over the funnel, or,
        under ``comm_mode="direct"``, peer to peer with one mean copy to the
        host — bit-identical parameters either way.

        Returns the host's current parameter view (the last synced value).
        State lives on the runtime; the first call initializes it from
        ``params`` and later calls ignore the argument.  Hyperparameters
        come from ``opt_cfg`` (an :class:`~repro_torch.optim.AdamWConfig`)
        and travel as firstprivate scalars.
        """
        from ..optim.adamw import AdamWConfig, adamw_update

        D = len(self.pool)
        if len(batches) != D:
            raise ValueError(f"need one batch per device, got {len(batches)}")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        st = self._dps
        if st is None or st["kernel"] != kernel:
            if st is not None:      # switching kernels: release the previous
                                    # resident state
                for d in range(D):
                    self.ex.exit_data(d, "_dps_params", "_dps_mu",
                                      "_dps_nu", "_dps_count")
            cfg = opt_cfg or AdamWConfig()
            step_kernel = f"__dps_{kernel}"
            if step_kernel not in self.pool.table:
                gfn = self.pool.table.lookup(self.pool.table.index_of(kernel)).fn

                def fused(params, batch, mu, nu, count, lr, b1, b2, eps,
                          weight_decay, clip_norm):
                    grads = gfn(params, batch)["grads"]
                    return adamw_update(params, grads, mu, nu, count, lr=lr,
                                        b1=b1, b2=b2, eps=eps,
                                        weight_decay=weight_decay,
                                        clip_norm=clip_norm)

                self.pool.table.register(step_kernel, fused)
            moments = _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32),
                                params)
            # "_dps_"-namespaced entries: a user's own "params" environment
            # must not collide with the optimizer's resident state
            for d in range(D):
                self.ex.ensure_resident(d, f"{tag}:init", _dps_params=params,
                                        _dps_mu=moments, _dps_nu=moments,
                                        _dps_count=torch.zeros((), dtype=torch.float32))
            st = self._dps = {"kernel": kernel, "step_kernel": step_kernel,
                              "cfg": cfg, "step": 0, "host_params": params}
        if opt_cfg is not None:     # per-call hyperparameters are honored
            st["cfg"] = opt_cfg
        cfg = st["cfg"]
        st["step"] += 1
        lr = cfg.lr(st["step"]) if callable(cfg.lr) else cfg.lr
        fp = {"lr": float(lr), "b1": cfg.b1, "b2": cfg.b2, "eps": cfg.eps,
              "weight_decay": cfg.weight_decay, "clip_norm": cfg.clip_norm}
        alias = {"params": "_dps_params", "mu": "_dps_mu",
                 "nu": "_dps_nu", "count": "_dps_count"}
        futs = [self.ex.target(
            st["step_kernel"], d,
            MapSpec(to={"batch": batches[d]}, present=alias, device_out=alias,
                    firstprivate=fp),
            nowait=True, tag=f"{tag}[{d}]") for d in range(D)]
        try:
            self.ex.drain(futs)
        except BaseException:
            # a partial failure leaves devices at divergent step counts;
            # poison the state so the next call re-initializes
            st["kernel"] = None
            raise
        if st["step"] % sync_every == 0:
            self.data_parallel_sync(tag)
        return st["host_params"]

    def data_parallel_sync(self, tag: str = "dps") -> Any:
        """Force a parameter sync now; returns the averaged parameters.

        host-mediated: fetch every device's parameters (``D·|p|`` funnel
        from-bytes), average on the host, push the mean back (``D·|p|``
        to-bytes).  direct: the transport averages in the stream — gather →
        reduce at the root in ascending device order → broadcast, all peer
        messages — and the host fetches ONE copy of the mean (``|p|``
        from-bytes, zero to-bytes).  Both use the host's association, so
        both give bit-identical parameters.
        """
        st = self._dps
        if st is None:
            raise RuntimeError("data_parallel_step has not run yet")
        D, pool = len(self.pool), self.pool
        if self.cfg.comm_mode == "direct" and D > 1:
            handles = [pool.present[d].get("_dps_params").handles
                       for d in range(D)]
            specs = pool.present[0].get("_dps_params").specs
            wfuts = self.transport.allreduce_mean(pool, handles, specs, root=0,
                                                  tag=f"{tag}:sync")
            self._mark_ahead("_dps_params", wfuts)
            mean = self.ex.fetch_resident(0, "_dps_params")
        else:
            views = [self.ex.fetch_resident(d, "_dps_params") for d in range(D)]
            mean = _tree_map(lambda *p: sum(p) / D, *views)
            for d in range(D):
                self.ex.ensure_resident(d, f"{tag}:sync", _dps_params=mean)
        st["host_params"] = mean
        return mean

    def speedup_report(self, serial_seconds: float) -> Dict[str, float]:
        """Paper-style speedup vs a single machine, under the link model."""
        s = self.cost.summary()
        return {
            **s,
            "serial_s": serial_seconds,
            "speedup": serial_seconds / s["makespan_s"] if s["makespan_s"] else float("inf"),
            "speedup_overlap": (serial_seconds / s["makespan_overlap_s"]
                                if s["makespan_overlap_s"] else float("inf")),
        }
