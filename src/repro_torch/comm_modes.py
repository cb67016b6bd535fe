"""The fabric's workloads: data-parallel exchanges and collectives.

Twin of ``benchmarks/comm_modes.py`` and ``benchmarks/topo_collectives.py``
for the port: the same seeded inputs (numpy draws, so both packages see the
same numbers), the same runtime calls and the same byte columns.

* :func:`make_table` — the ``mse_grads`` kernel: gradients of
  ``mean((x @ w + b - y)^2)``, written out (the product is ``torch.matmul``,
  as the reference leaves it to XLA outside any Pallas kernel).
* :func:`modes` — ``data_parallel_grads`` under host-mediated, direct and
  direct + block-int8 (``BENCH_comm.json``'s ``modes``).
* :func:`dps` — gradient funnel + host AdamW against ``data_parallel_step``
  with host-mediated and direct syncs (``dps``).
* :func:`collectives` — flat ring vs hierarchical vs hierarchical + int8
  all-reduce on a two-tier topology (``BENCH_topo.json``'s ``collectives``).
* :func:`dp_ring` — ``data_parallel_step(direct)`` with flat and
  hierarchical dispatch (``dp_ring``).
* :func:`sparselu_round_robin` — the sparselu wavefront routed peer to
  peer, accounted against a topology (``sparselu``'s round-robin row).

Every function takes ``device`` (the card unless the caller asks for the
CPU) and returns its rows, plus the values its callers hold against each
other.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ._device import DeviceLike
from .core import (ClusterRuntime, DevicePool, KernelTable, PeerTransport,
                   RuntimeConfig, TensorSpec, Topology)
from .core.costmodel import PAPER_ETHERNET
from .optim import AdamW, AdamWConfig


def mse_grads(params, batch):
    """Gradients of ``mean((x @ w + b - y)^2)`` over every output element."""
    x, y = batch["x"], batch["y"]
    r = x @ params["w"] + params["b"] - y
    g = r * (2.0 / r.numel())
    return {"grads": {"w": x.t() @ g, "b": g.sum(0)}}


def make_table() -> KernelTable:
    table = KernelTable()
    table.register("mse_grads", mse_grads)
    return table


def make_params(d_model: int, device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """The reference's ``_make_params``: w from seed 0, b zero (fp32)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((d_model, d_model)).astype(np.float32)
    return {"w": torch.from_numpy(w).to(device),
            "b": torch.zeros(d_model, dtype=torch.float32, device=device)}


def make_batches(d_model: int, n_batch: int, n: int,
                 device: DeviceLike = "cpu") -> List[Dict[str, torch.Tensor]]:
    """The reference's ``_make_batches``: per-device seeded batches,
    identical across modes."""
    def draw(key, i):
        a = np.random.default_rng((key, n, i)).standard_normal((n_batch, d_model))
        return torch.from_numpy(a.astype(np.float32)).to(device)
    return [{"x": draw(1, i), "y": draw(2, i)} for i in range(n)]


def _row(s: Dict[str, float]) -> Dict[str, float]:
    return {"comm_s": s["comm_s"] + s["peer_s"], "bytes_to": s["bytes_to"],
            "bytes_from": s["bytes_from"], "bytes_peer": s["bytes_peer"]}


def modes(d_model: int = 512, n_batch: int = 64, device_counts=(2, 4, 8), *,
          device: DeviceLike = "cuda") -> Tuple[List[Dict], Dict[str, Any]]:
    """One ``data_parallel_grads`` per (mode, D); the rows and each mode's
    mean gradient at the largest D."""
    params = make_params(d_model)
    rows, grads = [], {}
    for mode, compress in (("host-mediated", False), ("direct", False),
                           ("direct+int8", True)):
        for n in device_counts:
            rt = ClusterRuntime(RuntimeConfig(
                n_virtual=n, comm_mode=mode.split("+")[0], compress=compress,
                link=PAPER_ETHERNET), table=make_table(), device=device)
            try:
                g = rt.data_parallel_grads("mse_grads", params,
                                           make_batches(d_model, n_batch, n))
                s = rt.cost.summary()
            finally:
                rt.shutdown()
            rows.append({"mode": mode, "devices": n, **_row(s)})
            if n == device_counts[-1]:
                grads[mode] = g
    return rows, grads


def dps(d_model: int = 256, n_batch: int = 16, n: int = 4, steps: int = 8,
        sync_every: int = 4, *, device: DeviceLike = "cuda"
        ) -> Tuple[List[Dict], Dict[str, Any]]:
    """Gradient funnel + host AdamW, then ``data_parallel_step`` with
    host-mediated and direct syncs; the rows and each mode's parameters."""
    params = make_params(d_model)
    batches = make_batches(d_model, n_batch, n)
    rows, got = [], {}
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n, link=PAPER_ETHERNET),
                        table=make_table(), device=device)
    try:
        opt, host_params = AdamW(AdamWConfig()), params
        state = opt.init(params)
        for _ in range(steps):
            g = rt.data_parallel_grads("mse_grads", host_params, batches)
            host_params, state, _ = opt.update(g, state, host_params)
        s = rt.cost.summary()
    finally:
        rt.shutdown()
    rows.append({"update": "host (per-step grads)", "devices": n,
                 "steps": steps, **_row(s)})
    got["host"] = host_params
    for mode in ("host-mediated", "direct"):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=n, comm_mode=mode,
                                          link=PAPER_ETHERNET),
                            table=make_table(), device=device)
        try:
            p = None
            for _ in range(steps):
                p = rt.data_parallel_step("mse_grads", params, batches,
                                          sync_every=sync_every)
            s = rt.cost.summary()
        finally:
            rt.shutdown()
        got[mode] = p
        rows.append({"update": f"device {mode} (sync/{sync_every})",
                     "devices": n, "steps": steps, **_row(s)})
    return rows, got


def collective_pool(topo: Topology, n_elem: int, seed: int, *,
                    device: DeviceLike = "cuda"):
    """A pool of ``topo.n_devices`` devices, each holding one seeded fp32
    vector of ``n_elem``; ``(pool, handles, specs, values)``."""
    D = topo.n_devices
    rng = np.random.default_rng(seed)
    values = [[torch.from_numpy(rng.standard_normal((n_elem,)).astype(np.float32))]
              for _ in range(D)]
    pool = DevicePool.virtual(D, table=KernelTable(), device=device)
    pool.cost.topology = topo                    # cross-rack accounting
    handles = [[pool.alloc(d, v.shape, v.dtype) for v in values[d]]
               for d in range(D)]
    for d in range(D):
        pool.transfer_to(d, handles[d][0], values[d][0])
    return pool, handles, [TensorSpec((n_elem,), torch.float32)], values


def collectives(shapes=((2, 4), (2, 2)), n_elem: int = 1024, ratio: float = 0.1,
                *, device: DeviceLike = "cuda") -> Tuple[List[Dict], Dict[Any, Any]]:
    """All-reduce sums (flat ring, hierarchical, hierarchical + int8) and
    means (flat, hierarchical) per topology shape; the rows and, per shape,
    ``{"values", mode: device 0's sum, "mean:flat"/"mean:hier": every
    device's mean}``."""
    rows: List[Dict] = []
    got: Dict[Any, Any] = {}
    for racks, per in shapes:
        topo = Topology.two_tier(racks, per, inter_bw_ratio=ratio)
        D = topo.n_devices
        out: Dict[str, Any] = {}
        for mode in ("flat-ring", "hier", "hier+int8"):
            pool, handles, specs, values = collective_pool(topo, n_elem, racks,
                                                           device=device)
            try:
                tr = PeerTransport() if mode == "flat-ring" \
                    else PeerTransport(topology=topo)
                wire = None
                if mode == "hier+int8":
                    wire = tr.quantize_int8(pool, handles, specs, block=topo.block)
                tr.ring_allreduce(pool, handles, specs, wire_nbytes=wire)
                pool.sync()
                out[mode] = pool.transfer_from(0, handles[0][0])
                s = pool.cost.summary()
            finally:
                pool.stop_all()
            rows.append({"section": "allreduce-sum", "mode": mode,
                         "racks": racks, "per_rack": per, "devices": D,
                         "elems": n_elem, "peer_s": s["peer_s"],
                         "bytes_peer": s["bytes_peer"],
                         "bytes_cross_rack": s["bytes_peer_cross_rack"]})
        out["values"] = [v[0] for v in values]
        for name, tr in (("flat", PeerTransport()),
                         ("hier", PeerTransport(topology=topo))):
            pool, handles, specs, _ = collective_pool(topo, n_elem, racks,
                                                      device=device)
            try:
                tr.allreduce_mean(pool, handles, specs)
                pool.sync()
                out[f"mean:{name}"] = [pool.transfer_from(d, handles[d][0])
                                       for d in range(D)]
            finally:
                pool.stop_all()
        got[(racks, per)] = out
    return rows, got


def dp_ring(d_model: int = 32, n_batch: int = 4, racks: int = 2, per: int = 4,
            steps: int = 2, sync_every: int = 2, ratio: float = 0.1, *,
            device: DeviceLike = "cuda") -> Tuple[List[Dict], Dict[str, Any]]:
    """``data_parallel_step(comm_mode="direct")`` with flat and hierarchical
    dispatch, both accounted against the topology; rows and parameters."""
    topo = Topology.two_tier(racks, per, inter_bw_ratio=ratio)
    D = topo.n_devices
    params = make_params(d_model)
    batches = make_batches(d_model, n_batch, D)
    rows, got = [], {}
    for name, cfg_topo in (("flat", None), ("hier", topo)):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=D, comm_mode="direct",
                                          link=PAPER_ETHERNET, topology=cfg_topo),
                            table=make_table(), device=device)
        try:
            p = None
            for _ in range(steps):
                p = rt.data_parallel_step("mse_grads", params, batches,
                                          sync_every=sync_every)
            rt.cost.topology = topo              # flat run: account anyway
            s = rt.cost.summary()
        finally:
            rt.shutdown()
        got[name] = p
        rows.append({"section": "dp_ring", "dispatch": name, "racks": racks,
                     "per_rack": per, "devices": D, "steps": steps,
                     "sync_every": sync_every,
                     "comm_s": s["comm_s"] + s["peer_s"],
                     "bytes_peer": s["bytes_peer"],
                     "bytes_cross_rack": s["bytes_peer_cross_rack"]})
    return rows, got


def sparselu_round_robin(K: int = 3, B: int = 16, shapes: Sequence = ((2, 2),),
                         ratio: float = 0.1, *, device: DeviceLike = "cuda"
                         ) -> Tuple[List[Dict], Dict[Any, Any]]:
    """The sparselu wavefront with every edge peer-routed under round-robin
    placement on a host-mediated runtime, accounted against a two-tier
    topology; the rows and each shape's results."""
    from .bots import sparselu as bl
    rows, got = [], {}
    for racks, per in shapes:
        topo = Topology.two_tier(racks, per, inter_bw_ratio=ratio)
        D = topo.n_devices
        mat = bl._matrix(K, B)
        rt = ClusterRuntime(RuntimeConfig(n_virtual=D, link=PAPER_ETHERNET),
                            table=bl._make_table(K), device=device)
        try:
            res = rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True,
                                       peer=True, policy="round-robin")
            rt.cost.topology = topo
            s = rt.cost.summary()
        finally:
            rt.shutdown()
        got[(racks, per)] = res
        rows.append({"section": "sparselu", "policy": "round-robin",
                     "racks": racks, "per_rack": per, "devices": D,
                     "comm_s": s["comm_s"] + s["peer_s"],
                     "bytes_peer": s["bytes_peer"],
                     "bytes_cross_rack": s["bytes_peer_cross_rack"]})
    return rows, got
