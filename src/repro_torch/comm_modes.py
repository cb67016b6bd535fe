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
* :func:`resident` — per-region against resident parameters over repeated
  ``data_parallel_grads`` steps (``resident``).
* :func:`wavefront` — a ``nowait`` wavefront DAG with per-task operands,
  per-wave resident pins and peer-routed edges (``wavefront``).
* :func:`collectives` — flat ring vs hierarchical vs hierarchical + int8
  all-reduce on a two-tier topology (``BENCH_topo.json``'s ``collectives``).
* :func:`dp_ring` — ``data_parallel_step(direct)`` with flat and
  hierarchical dispatch (``dp_ring``).
* :func:`sparselu_round_robin` — the sparselu wavefront routed peer to
  peer, accounted against a topology (``sparselu``'s round-robin row).

Every function takes ``device`` (the card unless the caller asks for the
CPU) and returns its rows, plus the values its callers hold against each
other.  :func:`modes` and :func:`dps` also take ``inject=(p, seed)`` or
``inject=(p, seed, hang_p, slow_ms)`` (an :class:`Inject`): every device of
every runtime fails SEND/RECV with probability ``p`` on a schedule keyed by
``seed`` (``benchmarks/comm_modes.py --inject-p``), and direct-mode runtimes
retry each message ``CHAOS_RETRIES`` times before the funnel.  ``hang_p``
hangs SEND/RECV for ``HANG_S`` instead, under a command deadline of
``HANG_DEADLINE_S`` and a transport op timeout of ``HANG_OP_TIMEOUT_S``
(``--hang-p``); ``slow_ms`` stalls EXEC commands with probability ``SLOW_P``
(``--slow-ms``).  Each row reports its injected faults by op and the
transport's ``fallbacks``, ``backoffs`` and ``backoff_s``
(:func:`fault_report`), and under hangs or stalls the deadline trips, stalls
and op timeouts (:func:`hedge_report`).  The values are the fault-free run's
either way.

:func:`main` is the CLI of ``benchmarks/comm_modes.py``: the four
sections with the reference's asserts, ``--json`` in ``BENCH_comm.json``'s
layout (the reference's rows, ratio rows included), ``--topology RACKSxPER``
and ``--inter-bw-ratio`` (every runtime on a partitioned two-tier
topology), and the chaos flags with their reports::

    python -m repro_torch.comm_modes --smoke --device cpu --json PATH
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import DeviceLike
from .core import (ClusterRuntime, DagTask, DevicePool, KernelTable, MapSpec,
                   PeerTransport, RuntimeConfig, TensorSpec, Topology)
from .core.costmodel import PAPER_ETHERNET
from .ft import FlakyDevice, inject_flaky
from .optim import AdamW, AdamWConfig

#: Transport retries a direct-mode runtime gets under ``inject``.
CHAOS_RETRIES = 3
#: Under ``hang_p``: the pool's command deadline (a backstop for true
#: wedges, generous so a first call's warm-up never trips it), the
#: transport's op timeout, and how long a hung SEND/RECV sleeps.
HANG_DEADLINE_S = 10.0
HANG_OP_TIMEOUT_S = 0.1
HANG_S = 0.2
#: Under ``slow_ms``: the share of EXEC commands that stall.
SLOW_P = 0.3


class Inject(NamedTuple):
    """Seeded chaos for a workload's runtimes (the reference's
    ``--inject-p``, ``--inject-seed``, ``--hang-p`` and ``--slow-ms``)."""

    p: float                 # SEND/RECV fail probability
    seed: int
    hang_p: float = 0.0      # SEND/RECV hang probability (seed + 1)
    slow_ms: float = 0.0     # EXEC stall at SLOW_P (seed + 2)


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


def make_runtime(cfg: RuntimeConfig, device: DeviceLike,
                 inject: Optional[Tuple[float, ...]] = None,
                 topology: Optional[Tuple[int, float]] = None,
                 table: Optional[KernelTable] = None) -> ClusterRuntime:
    """A runtime over ``table`` (default ``make_table()``) under ``inject``
    (an :class:`Inject` or a tuple of its fields): every device fails
    SEND/RECV with probability ``p``, hangs them with probability ``hang_p``
    and stalls EXEC for ``slow_ms``; a direct-mode runtime retries each
    failed or timed-out message before the funnel.  ``topology`` =
    ``(per_rack, inter_bw_ratio)`` partitions the pool into racks of
    ``per_rack`` (``--topology``), unless ``cfg`` names its own."""
    if topology is not None and cfg.topology is None:
        cfg.topology = Topology.partition(cfg.n_virtual, topology[0],
                                          inter_bw_ratio=topology[1])
    inj = None if inject is None else Inject(*inject)
    if inj is not None and cfg.comm_mode == "direct" and (inj.p > 0 or inj.hang_p > 0):
        cfg.transport_retries = max(cfg.transport_retries, CHAOS_RETRIES)
    if inj is not None and inj.hang_p > 0:
        if cfg.command_deadline_s is None:
            cfg.command_deadline_s = HANG_DEADLINE_S
        if cfg.transport_op_timeout_s is None:
            cfg.transport_op_timeout_s = HANG_OP_TIMEOUT_S
    rt = ClusterRuntime(cfg, table=table or make_table(), device=device)
    if inj is None:
        return rt
    if inj.p > 0:
        inject_flaky(rt.pool, p=inj.p, seed=inj.seed, ops=("SEND", "RECV"))
    if inj.hang_p > 0:
        inject_flaky(rt.pool, p=inj.hang_p, seed=inj.seed + 1, ops=("SEND", "RECV"),
                     mode="hang", hang_s=HANG_S)
    if inj.slow_ms > 0:
        inject_flaky(rt.pool, p=SLOW_P, seed=inj.seed + 2, ops=("EXEC",),
                     mode="slow", slow_s=inj.slow_ms / 1e3)
    return rt


def _layers(dev) -> Iterator[FlakyDevice]:
    """The fault injectors wrapped around one device, outermost first."""
    while isinstance(dev, FlakyDevice):
        yield dev
        dev = dev._inner


def fault_report(rt: ClusterRuntime) -> Dict[str, Any]:
    """Injected faults by op over a runtime's devices (every injector
    wrapped around each), and its transport's fallbacks and backoffs (zero
    for a fault-free or host-mediated one)."""
    by_op: Dict[str, int] = {}
    for d in rt.pool.devices:
        for layer in _layers(d):
            for op, n in layer.failures_by_op.items():
                by_op[op] = by_op.get(op, 0) + n
    tr = rt.transport
    return {"faults": sum(by_op.values()), "faults_by_op": by_op,
            "fallbacks": getattr(tr, "fallbacks", 0),
            "backoffs": getattr(tr, "backoffs", 0),
            "backoff_s": getattr(tr, "backoff_s", 0.0)}


def hedge_report(rt: ClusterRuntime) -> Dict[str, Any]:
    """A runtime's straggler accounting: blown command deadlines by op,
    stalls, and its transport's op timeouts, fallbacks and backoffs."""
    tr = rt.transport
    return {"straggler_timeouts": dict(rt.pool.straggler_timeouts),
            "stalls": sum(layer.stalls for d in rt.pool.devices
                          for layer in _layers(d)),
            "transport_timeouts": getattr(tr, "timeouts", 0),
            "transport_fallbacks": getattr(tr, "fallbacks", 0),
            "transport_backoffs": getattr(tr, "backoffs", 0),
            "transport_backoff_s": getattr(tr, "backoff_s", 0.0)}


def _chaos_report(rt: ClusterRuntime, inject: Optional[Tuple[float, ...]]
                  ) -> Dict[str, Any]:
    """A row's chaos columns: none without ``inject``, the fault report, and
    the straggler report under hangs or stalls."""
    if inject is None:
        return {}
    inj = Inject(*inject)
    if inj.hang_p > 0 or inj.slow_ms > 0:
        return {**fault_report(rt), **hedge_report(rt)}
    return fault_report(rt)


def modes(d_model: int = 512, n_batch: int = 64, device_counts=(2, 4, 8), *,
          device: DeviceLike = "cuda", inject: Optional[Tuple[float, ...]] = None,
          topology: Optional[Tuple[int, float]] = None
          ) -> Tuple[List[Dict], Dict[str, Any]]:
    """One ``data_parallel_grads`` per (mode, D); the rows and each mode's
    mean gradient at the largest D."""
    params = make_params(d_model)
    rows, grads = [], {}
    for mode, compress in (("host-mediated", False), ("direct", False),
                           ("direct+int8", True)):
        for n in device_counts:
            rt = make_runtime(RuntimeConfig(
                n_virtual=n, comm_mode=mode.split("+")[0], compress=compress,
                link=PAPER_ETHERNET), device, inject, topology)
            try:
                g = rt.data_parallel_grads("mse_grads", params,
                                           make_batches(d_model, n_batch, n))
                s = rt.cost.summary()
            finally:
                rt.shutdown()
            rows.append({"mode": mode, "devices": n, **_row(s),
                         **_chaos_report(rt, inject)})
            if n == device_counts[-1]:
                grads[mode] = g
    return rows, grads


def dps(d_model: int = 256, n_batch: int = 16, n: int = 4, steps: int = 8,
        sync_every: int = 4, *, device: DeviceLike = "cuda",
        inject: Optional[Tuple[float, ...]] = None,
        topology: Optional[Tuple[int, float]] = None
        ) -> Tuple[List[Dict], Dict[str, Any]]:
    """Gradient funnel + host AdamW, then ``data_parallel_step`` with
    host-mediated and direct syncs; the rows and each mode's parameters."""
    params = make_params(d_model)
    batches = make_batches(d_model, n_batch, n)
    rows, got = [], {}
    rt = make_runtime(RuntimeConfig(n_virtual=n, link=PAPER_ETHERNET), device,
                      inject, topology)
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
                 "steps": steps, **_row(s),
                 **_chaos_report(rt, inject)})
    got["host"] = host_params
    for mode in ("host-mediated", "direct"):
        rt = make_runtime(RuntimeConfig(n_virtual=n, comm_mode=mode,
                                        link=PAPER_ETHERNET), device, inject,
                          topology)
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
                     "devices": n, "steps": steps, **_row(s),
                     **_chaos_report(rt, inject)})
    return rows, got


def resident(d_model: int = 512, n_batch: int = 64, n: int = 4, steps: int = 6,
             *, device: DeviceLike = "cuda",
             inject: Optional[Tuple[float, ...]] = None,
             topology: Optional[Tuple[int, float]] = None) -> List[Dict]:
    """Per-region against resident parameters over ``steps`` repeated
    host-mediated ``data_parallel_grads`` steps (the reference's
    ``run_resident``): the two rows and their ratio row.  Asserts the two
    runs' gradients agree within rtol 1e-5."""
    params = make_params(d_model)
    batches = make_batches(d_model, n_batch, n)
    rows, grads = [], {}
    for res in (False, True):
        rt = make_runtime(RuntimeConfig(n_virtual=n, link=PAPER_ETHERNET), device,
                          inject, topology)
        try:
            g = None
            for _ in range(steps):
                g = rt.data_parallel_grads("mse_grads", params, batches,
                                           resident=res)
            s = rt.cost.summary()
            elided = sum(t.bytes_elided for t in rt.pool.present)
        finally:
            rt.shutdown()
        grads[res] = g["w"].cpu()
        rows.append({"params": "resident" if res else "per-region",
                     "devices": n, "steps": steps,
                     "comm_s": s["comm_s"], "bytes_to": s["bytes_to"],
                     "MB_to": s["bytes_to"] / 1e6, "MB_elided": elided / 1e6,
                     **_chaos_report(rt, inject)})
    assert torch.allclose(grads[True], grads[False], rtol=1e-5, atol=1e-6)
    base, res_to = rows[0]["bytes_to"], rows[1]["bytes_to"]
    rows.append({"params": "ratio", "devices": n, "steps": steps,
                 "comm_s": rows[0]["comm_s"] / max(rows[1]["comm_s"], 1e-12),
                 "bytes_to": base / max(res_to, 1), "MB_to": 0.0, "MB_elided": 0.0})
    return rows


def _wavefront_table() -> KernelTable:
    """The wavefront's two kernels.  Their products are ``torch.matmul`` on
    the device's stream, as the reference leaves them to XLA outside any
    Pallas kernel."""
    table = KernelTable()
    table.register("wf_gen", lambda x: {"out": x @ x * 1e-2})
    table.register("wf_consume", lambda lu, a: {"out": lu + 2 * a})
    return table


def wavefront(B: int = 64, fan: int = 8, n_dev: int = 2, waves: int = 3, *,
              device: DeviceLike = "cuda",
              inject: Optional[Tuple[float, ...]] = None,
              topology: Optional[Tuple[int, float]] = None,
              detectors: Optional[List[Any]] = None) -> List[Dict]:
    """A ``nowait`` wavefront of ``waves`` chained fan-outs (each wave's
    producer output feeds ``fan`` consumers, sparselu's pivot pattern) under
    per-task operand mapping, per-wave resident pins and peer-routed edges
    (the reference's ``run_wavefront``): three rows and their ratio row.
    Asserts equal results (rtol 1e-5) and that each mapping moves strictly
    fewer host→device bytes than the one before.  Under ``inject``'s
    ``slow_ms`` each run races its stalled tasks against hedged duplicates
    (a :class:`~.ft.StragglerDetector`, appended to ``detectors``)."""
    rng = np.random.default_rng(0)
    mat = torch.from_numpy(rng.standard_normal((B, B)).astype(np.float32))
    ams = [torch.from_numpy(rng.standard_normal((B, B)).astype(np.float32))
           for _ in range(fan)]
    spec = TensorSpec((B, B), torch.float32)
    tasks = []
    prev = None
    for w in range(waves):
        pname = f"p{w}"
        tasks.append(DagTask(
            pname, "wf_gen", tuple(d for d in (prev,) if d),
            (lambda prev=prev: lambda deps: MapSpec(
                to={"x": deps[prev] if prev else mat}, from_={"out": spec}))()))
        for i in range(fan):
            tasks.append(DagTask(
                f"c{w}_{i}", "wf_consume", (pname,),
                (lambda pname=pname, a=ams[i]: lambda deps: MapSpec(
                    to={"lu": deps[pname], "a": a}, from_={"out": spec}))()))
        prev = pname
    slow = inject is not None and Inject(*inject).slow_ms > 0
    rows, results = [], {}
    for mapping, kw in (("per-task", {}), ("resident", {"resident": True}),
                        ("peer", {"peer": True})):
        rt = make_runtime(RuntimeConfig(n_virtual=n_dev, link=PAPER_ETHERNET), device,
                          inject, topology, table=_wavefront_table())
        try:
            if slow:
                from .ft import StragglerDetector
                det = StragglerDetector(rt.cost, k=3.0, grace_s=0.05, max_hedges=32,
                                        baseline={"wf_gen": 0.005, "wf_consume": 0.005})
                if detectors is not None:
                    detectors.append(det)
                kw = dict(kw, stragglers=det)
            out = rt.wavefront_offload(list(tasks), nowait=True, **kw)
            results[mapping] = {k: v.cpu() for k, v in out.items()}
            s = rt.cost.summary()
        finally:
            rt.shutdown()
        rows.append({"mapping": mapping, "devices": n_dev, "tasks": len(tasks),
                     "comm_s": s["comm_s"] + s["peer_s"], "bytes_to": s["bytes_to"],
                     "bytes_peer": s["bytes_peer"], "MB_to": s["bytes_to"] / 1e6,
                     "MB_peer": s["bytes_peer"] / 1e6, **_chaos_report(rt, inject)})
    for mapping in ("resident", "peer"):
        for k in results["per-task"]:
            assert torch.allclose(results[mapping][k], results["per-task"][k],
                                  rtol=1e-5, atol=1e-6), (mapping, k)
    # each mapping strictly cuts host→device traffic: pins share a wave's
    # operands, peer routing takes the DAG's edges off the funnel entirely
    assert rows[1]["bytes_to"] < rows[0]["bytes_to"], rows
    assert rows[2]["bytes_to"] < rows[1]["bytes_to"], rows
    rows.append({"mapping": "ratio", "devices": n_dev, "tasks": len(tasks),
                 "comm_s": rows[0]["comm_s"] / max(rows[2]["comm_s"], 1e-12),
                 "bytes_to": rows[0]["bytes_to"] / max(rows[2]["bytes_to"], 1),
                 "bytes_peer": 0.0, "MB_to": 0.0, "MB_peer": 0.0})
    return rows


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


# ---------------------------------------------------------------------------
# the CLI: benchmarks/comm_modes.py's sections, asserts and JSON layout
# ---------------------------------------------------------------------------
#: The reference's smoke sizes (``benchmarks/comm_modes.py --smoke``).
SMOKE = {"modes": dict(d_model=128, n_batch=16, device_counts=(2, 4)),
         "resident": dict(d_model=128, n_batch=4, n=2, steps=4),
         "wavefront": dict(B=32, fan=4, n_dev=2, waves=2),
         "dps": dict(d_model=64, n_batch=8, n=4, steps=8)}


def modes_section(**kw) -> List[Dict]:
    """:func:`modes` as the reference's ``run`` rows (``funnel_MB``,
    ``peer_MB``), with its asserts: direct within rtol 1e-5 of
    host-mediated, direct + int8 within the block-int8 bound."""
    rows, grads = modes(**kw)
    for r in rows:
        r["funnel_MB"] = (r["bytes_to"] + r["bytes_from"]) / 1e6
        r["peer_MB"] = r["bytes_peer"] / 1e6
    ref = grads["host-mediated"]["w"].cpu()
    assert torch.allclose(grads["direct"]["w"].cpu(), ref, rtol=1e-5, atol=1e-6)
    err = float((grads["direct+int8"]["w"].cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= scale / 64, (err, scale)     # block-int8 error bound
    return rows


def dps_section(**kw) -> List[Dict]:
    """:func:`dps` as the reference's ``run_dps`` rows (``MB_from``, the
    ratio row), with its asserts: the device-resident optimizer cuts the
    gradient funnel ≥3×, direct syncs move ≥2× fewer host-funnel bytes than
    host-mediated ones, and both leave bit-identical parameters."""
    rows, got = dps(**kw)
    for r in rows:
        r["MB_from"] = r["bytes_from"] / 1e6
    assert rows[0]["bytes_from"] >= 3 * rows[1]["bytes_from"], rows
    assert rows[1]["bytes_from"] >= 2 * rows[2]["bytes_from"], rows
    assert (rows[1]["bytes_to"] + rows[1]["bytes_from"]
            >= (rows[2]["bytes_to"] + rows[2]["bytes_from"])
            + 2 * rows[2]["bytes_from"]), rows
    assert rows[2]["bytes_peer"] > 0 and rows[1]["bytes_peer"] == 0
    for leaf in ("w", "b"):
        assert torch.equal(got["host-mediated"][leaf].cpu(),
                           got["direct"][leaf].cpu()), leaf
    n, steps = rows[0]["devices"], rows[0]["steps"]
    rows.append({"update": "ratio (funnel/direct syncs)", "devices": n,
                 "steps": steps,
                 "comm_s": rows[1]["comm_s"] / max(rows[2]["comm_s"], 1e-12),
                 "bytes_from": rows[1]["bytes_from"] / max(rows[2]["bytes_from"], 1),
                 "bytes_to": 0.0, "bytes_peer": 0.0, "MB_from": 0.0})
    return rows


def render(rows: List[Dict]) -> str:
    out = ["## comm modes (DP gradient exchange, paper link model)",
           f"{'mode':>14} {'devs':>5} {'comm_s':>9} {'funnel_MB':>10} "
           f"{'peer_MB':>8}"]
    for r in rows:
        out.append(f"{r['mode']:>14} {r['devices']:>5} {r['comm_s']:>9.4f} "
                   f"{r['funnel_MB']:>10.2f} {r['peer_MB']:>8.2f}")
    return "\n".join(out)


def render_resident(rows: List[Dict]) -> str:
    out = ["## resident vs per-region params "
           "(host-mediated DP, repeated steps)",
           f"{'params':>12} {'devs':>5} {'steps':>6} {'comm_s':>9} "
           f"{'MB_to':>9} {'MB_elided':>10}"]
    for r in rows[:-1]:
        out.append(f"{r['params']:>12} {r['devices']:>5} {r['steps']:>6} "
                   f"{r['comm_s']:>9.4f} {r['MB_to']:>9.2f} "
                   f"{r['MB_elided']:>10.2f}")
    ratio = rows[-1]
    out.append(f"  → resident moves {ratio['bytes_to']:.1f}× fewer "
               f"host→device bytes ({ratio['comm_s']:.1f}× less comm time)")
    return "\n".join(out)


def render_wavefront(rows: List[Dict]) -> str:
    out = ["## nowait wavefront: per-task operands vs resident pins vs "
           "peer routing",
           f"{'mapping':>10} {'devs':>5} {'tasks':>6} {'comm_s':>9} "
           f"{'MB_to':>9} {'MB_peer':>8}"]
    for r in rows[:-1]:
        out.append(f"{r['mapping']:>10} {r['devices']:>5} {r['tasks']:>6} "
                   f"{r['comm_s']:>9.4f} {r['MB_to']:>9.2f} "
                   f"{r['MB_peer']:>8.2f}")
    ratio = rows[-1]
    out.append(f"  → peer routing moves {ratio['bytes_to']:.1f}× fewer "
               f"host→device bytes than per-task mapping")
    return "\n".join(out)


def render_dps(rows: List[Dict]) -> str:
    out = ["## AdamW update placement (DP, repeated steps)",
           f"{'update':>32} {'devs':>5} {'steps':>6} {'comm_s':>9} "
           f"{'MB_from':>9}"]
    for r in rows[:-1]:
        out.append(f"{r['update']:>32} {r['devices']:>5} {r['steps']:>6} "
                   f"{r['comm_s']:>9.4f} {r['MB_from']:>9.2f}")
    ratio = rows[-1]
    out.append(f"  → direct syncs move {ratio['bytes_from']:.1f}× fewer "
               f"device→host bytes than host-mediated syncs, bit-identically")
    return "\n".join(out)


def _chaos_runs(sections: Dict[str, List[Dict]]) -> List[Dict]:
    """Every row that carries a runtime's chaos columns, named by its
    section and row identity."""
    runs = []
    for name, rows in sections.items():
        for r in rows:
            if "faults" in r:
                ident = next(r[k] for k in ("mode", "update", "params", "mapping")
                             if k in r)
                runs.append({"section": name, "mode": ident, "devices": r["devices"],
                             **{k: v for k, v in r.items()
                                if k in ("faults", "faults_by_op", "fallbacks",
                                         "backoffs", "backoff_s", "straggler_timeouts",
                                         "stalls", "transport_timeouts")}})
    return runs


def _dump(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes: same code paths, seconds not minutes")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also dump every section's rows to PATH "
                         "(BENCH_comm.json's layout)")
    ap.add_argument("--topology", metavar="RACKSxPER", default=None,
                    help="run every section under a hierarchical topology: "
                         "racks of PER devices (e.g. 2x4)")
    ap.add_argument("--inter-bw-ratio", type=float, default=0.1, metavar="R",
                    help="spine bandwidth as a fraction of the intra-rack link")
    ap.add_argument("--inject-p", type=float, default=0.0, metavar="P",
                    help="seeded SEND/RECV fault probability per device command")
    ap.add_argument("--inject-seed", type=int, default=0, metavar="SEED")
    ap.add_argument("--failure-report", metavar="PATH", default=None,
                    help="dump injected-fault counts per run to PATH")
    ap.add_argument("--hang-p", type=float, default=0.0, metavar="P",
                    help="seeded SEND/RECV hang probability")
    ap.add_argument("--slow-ms", type=float, default=0.0, metavar="MS",
                    help="EXEC stalls of MS milliseconds at p = SLOW_P; the "
                         "wavefront section races them against hedges")
    ap.add_argument("--hedge-report", metavar="PATH", default=None,
                    help="dump straggler-timeout/hedge/backoff counts to PATH")
    ap.add_argument("--device", default="cuda",
                    help="where the virtual devices live (default: cuda)")
    ap.add_argument("--launches", metavar="PATH", default=None,
                    help="write this run's kernel launch counts to PATH")
    args = ap.parse_args(argv)
    topology = None
    if args.topology:
        try:
            _, per = (int(t) for t in args.topology.lower().split("x"))
        except ValueError:
            ap.error(f"--topology wants RACKSxPER (e.g. 2x4), got {args.topology!r}")
        topology = (per, args.inter_bw_ratio)
    chaos = args.inject_p > 0 or args.hang_p > 0 or args.slow_ms > 0
    inject = (Inject(args.inject_p, args.inject_seed, args.hang_p, args.slow_ms)
              if chaos else None)
    kw = dict(device=args.device, inject=inject, topology=topology)
    sizes = SMOKE if args.smoke else {k: {} for k in SMOKE}
    detectors: List[Any] = []
    sections = {
        "modes": modes_section(**sizes["modes"], **kw),
        "resident": resident(**sizes["resident"], **kw),
        "wavefront": wavefront(**sizes["wavefront"], **kw, detectors=detectors),
        "dps": dps_section(**sizes["dps"], **kw),
    }
    print(render(sections["modes"]))
    print(render_resident(sections["resident"]))
    print(render_wavefront(sections["wavefront"]))
    print(render_dps(sections["dps"]))
    if args.json:
        _dump(args.json, {"benchmark": "comm_modes", "smoke": bool(args.smoke),
                          "topology": args.topology,
                          "inter_bw_ratio": args.inter_bw_ratio,
                          "sections": sections})
    runs = _chaos_runs(sections)
    if args.inject_p > 0:
        total = sum(r["faults"] for r in runs)
        print(f"## chaos: injected {total} SEND/RECV faults at p={args.inject_p} "
              f"seed={args.inject_seed} across {len(runs)} runs — all assertions held")
        if args.failure_report:
            _dump(args.failure_report, {
                "inject_p": args.inject_p, "inject_seed": args.inject_seed,
                "ops": ["SEND", "RECV"], "runs": runs, "total_failures": total})
    if args.hang_p > 0 or args.slow_ms > 0:
        reports = [d.report() for d in detectors]
        launched = sum(r["hedges_launched"] for r in reports)
        won = sum(r["hedge_wins"] for r in reports)
        print(f"## gray chaos: hang_p={args.hang_p} slow_ms={args.slow_ms} — "
              f"{sum(sum(r.get('straggler_timeouts', {}).values()) for r in runs)} "
              f"command-deadline trips, "
              f"{sum(r.get('transport_timeouts', 0) for r in runs)} transport op "
              f"timeouts, {sum(r.get('stalls', 0) for r in runs)} injected stalls, "
              f"{launched} hedges ({won} won) — all assertions held")
        if args.hedge_report:
            _dump(args.hedge_report, {
                "hang_p": args.hang_p, "slow_ms": args.slow_ms,
                "slow_p": SLOW_P if args.slow_ms > 0 else 0.0,
                "inject_seed": args.inject_seed, "runs": runs,
                "detectors": reports, "hedges_launched": launched,
                "hedge_wins": won})
    from .kernels import write_launch_report
    write_launch_report(args.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
