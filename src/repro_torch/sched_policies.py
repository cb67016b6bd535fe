"""Placement policies on the paper's workloads: who moves fewer bytes.

Twin of ``benchmarks/sched_policies.py`` for the port: the same policy menu,
the same seeded inputs, the same asserts and the same row keys.

* :func:`run_sparselu` — the sparselu wavefront (§5.6) with peer-routed
  edges under round-robin, locality and HEFT frozen at a comm-bound
  (5 µs) and a compute-bound (100 µs) task estimate; then HEFT comm-bound
  again with each device's present table capped at six blocks, which forces
  LRU spills and refetches mid-factorization.  Every placement's result,
  the capped one included, is asserted bit-identical.
* :func:`run_strips` — dependency-free strips (§5.3–5.4): no locality
  signal, so every policy must move exactly the same bytes.

Every function takes ``device`` (the card unless the caller asks for the
CPU) and returns its rows.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ._device import DeviceLike
from .bots import sparselu as bl
from .core import (ClusterRuntime, HeftPlacement, KernelTable, MapSpec,
                   RuntimeConfig, TensorSpec, offload_strips, sec)
from .core.costmodel import PAPER_ETHERNET


def policy_menu():
    """(row name, policy) pairs; HEFT's estimates are frozen, so placement
    is deterministic."""
    return [
        ("round-robin", "round-robin"),
        ("locality", "locality"),
        ("heft (comm-bound)", HeftPlacement(default_task_s=5e-6,
                                            use_observed=False)),
        ("heft (compute-bound)", HeftPlacement(default_task_s=100e-6,
                                               use_observed=False)),
    ]


def _total(s: Dict[str, float]) -> float:
    return s["bytes_to"] + s["bytes_from"] + s["bytes_peer"]


def run_sparselu(K: int = 4, B: int = 64, n_dev: int = 4, *,
                 device: DeviceLike = "cuda") -> List[Dict]:
    """Policy comparison on the sparselu wavefront (peer-routed edges), then
    the capacity-capped HEFT run; one row each."""
    mat = bl._matrix(K, B)
    table = bl._make_table(K)
    tasks = K * (K + 1) * (2 * K + 1) // 6
    rows: List[Dict] = []
    ref = None
    base_total = None
    for name, policy in policy_menu():
        rt = ClusterRuntime(RuntimeConfig(n_virtual=n_dev, link=PAPER_ETHERNET),
                            table=table, device=device)
        try:
            res = rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True,
                                       peer=True, policy=policy)
            s = rt.cost.summary()
            devs_used = len({c.device for c in rt.cost.compute})
        finally:
            rt.shutdown()
        if ref is None:
            ref = res
        for k in ref:     # placement moves bytes, never values
            assert torch.equal(ref[k], res[k]), (name, k)
        if base_total is None:
            base_total = _total(s)
        rows.append({"policy": name, "devices": n_dev, "tasks": tasks,
                     "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
                     "bytes_peer": s["bytes_peer"],
                     "total_MB": _total(s) / 1e6,
                     "reduction_pct": 100.0 * (1 - _total(s) / base_total),
                     "devs_used": devs_used,
                     "makespan_overlap_s": s["makespan_overlap_s"]})
    by = {r["policy"]: r for r in rows}
    assert by["locality"]["reduction_pct"] > 0.0, rows
    assert by["heft (comm-bound)"]["reduction_pct"] >= 25.0, rows

    # capacity-capped re-run: LRU spill + transparent refetch mid-graph,
    # still bit for bit
    cap = 6 * B * B * 4
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n_dev, link=PAPER_ETHERNET,
                                      device_capacity_bytes=cap),
                        table=table, device=device)
    try:
        res = rt.wavefront_offload(
            bl._build_dag(mat, K, B), nowait=True, peer=True,
            policy=HeftPlacement(default_task_s=5e-6, use_observed=False))
        s = rt.cost.summary()
        mem = rt.memory_report()
    finally:
        rt.shutdown()
    for k in ref:
        assert torch.equal(ref[k], res[k]), ("capped", k)
    evictions = sum(m["evictions"] for m in mem.values())
    refetches = sum(m["refetches"] for m in mem.values())
    assert evictions >= 1, mem
    rows.append({"policy": f"heft (comm-bound, cap={cap}B)",
                 "devices": n_dev, "tasks": tasks,
                 "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
                 "bytes_peer": s["bytes_peer"], "total_MB": _total(s) / 1e6,
                 "reduction_pct": 100.0 * (1 - _total(s) / base_total),
                 "devs_used": len(mem),
                 "makespan_overlap_s": s["makespan_overlap_s"],
                 "evictions": evictions, "refetches": refetches})
    return rows


def run_strips(total: int = 4096, n_dev: int = 4, *,
               device: DeviceLike = "cuda") -> List[Dict]:
    """Policies on the dependency-free pattern: must not change anything."""
    table = KernelTable()
    table.register("sq", lambda xs: {"out": xs * xs})
    data = torch.arange(float(total))

    def make_maps(start, length):
        return MapSpec(to={"xs": sec(data, start, length)},
                       from_={"out": TensorSpec((length,), data.dtype)})

    rows: List[Dict] = []
    ref = None
    for name, policy in policy_menu():
        rt = ClusterRuntime(RuntimeConfig(n_virtual=n_dev, link=PAPER_ETHERNET),
                            table=table, device=device)
        try:
            out = offload_strips(rt.ex, "sq", total, make_maps, policy=policy)
            s = rt.cost.summary()
        finally:
            rt.shutdown()
        if ref is None:
            ref = out
        assert torch.equal(ref, out), name
        rows.append({"policy": name, "devices": n_dev, "strips": n_dev,
                     "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
                     "bytes_peer": s["bytes_peer"],
                     "makespan_overlap_s": s["makespan_overlap_s"]})
    # no dependencies -> no locality signal -> byte-identical traffic
    for r in rows[1:]:
        for key in ("bytes_to", "bytes_from", "bytes_peer"):
            assert r[key] == rows[0][key], (r["policy"], key, rows)
    return rows


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps({"sparselu": run_sparselu(device=args.device),
                      "strips": run_strips(device=args.device)}, indent=1))
