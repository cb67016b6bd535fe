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

    python -m repro_torch.sched_policies --device cpu --json PATH

writes ``{"benchmark": "sched_policies", "sections": {"sparselu": ...,
"strips": ...}}``, the layout of ``BENCH_sched.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
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


def spill_faults(rows: List[Dict], B: int = 64) -> List[str]:
    """The capacity-capped row's spill accounting, which holds whatever the
    timing (its evictions and refetches vary with when each nowait region's
    release lands, in the reference too): something spilled and came back;
    every refetch is one block sent on top of the uncapped HEFT run's bytes;
    what spilling sent back is whole blocks, at most one per eviction; no
    byte moved peer to peer.  (The capped run's results are asserted equal
    to the uncapped runs' in :func:`run_sparselu`.)  One message per broken
    rule; the trajectory gate adds them to its failures."""
    block = B * B * 4
    by = {r["policy"]: r for r in rows}
    base, capped = by["heft (comm-bound)"], by[f"heft (comm-bound, cap={6 * block}B)"]
    ev, re_ = capped["evictions"], capped["refetches"]
    extra_from = capped["bytes_from"] - base["bytes_from"]
    rules = {
        "evictions > 0": ev > 0,
        "0 < refetches <= evictions": 0 < re_ <= ev,
        "bytes_to == uncapped bytes_to + refetches x block":
            capped["bytes_to"] == base["bytes_to"] + re_ * block,
        "bytes_from - uncapped bytes_from in whole blocks, <= evictions":
            extra_from % block == 0 and 0 <= extra_from <= ev * block,
        "bytes_peer == 0": capped["bytes_peer"] == 0,
    }
    seen = {k: capped[k] for k in ("evictions", "refetches", "bytes_to", "bytes_from",
                                   "bytes_peer")}
    return [f"sched: capped row: {rule} broken: {seen}, uncapped bytes_to "
            f"{base['bytes_to']}, bytes_from {base['bytes_from']}"
            for rule, ok in rules.items() if not ok]


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


def render_sparselu(rows: List[Dict]) -> str:
    out = ["## sparselu wavefront: placement policies (peer-routed edges)",
           f"{'policy':>28} {'tasks':>6} {'funnel_MB':>10} {'peer_MB':>8} "
           f"{'total_MB':>9} {'saved':>6} {'devs':>5} {'makespan':>9}"]
    for r in rows:
        funnel = (r["bytes_to"] + r["bytes_from"]) / 1e6
        out.append(f"{r['policy']:>28} {r['tasks']:>6} {funnel:>10.2f} "
                   f"{r['bytes_peer'] / 1e6:>8.2f} {r['total_MB']:>9.2f} "
                   f"{r['reduction_pct']:>5.1f}% {r['devs_used']:>5} "
                   f"{r['makespan_overlap_s']:>9.4f}")
    capped = rows[-1]
    if "evictions" in capped:
        out.append(f"  → capacity-capped run: {capped['evictions']} evictions"
                   f", {capped['refetches']} refetches, bit-identical result")
    return "\n".join(out)


def render_strips(rows: List[Dict]) -> str:
    out = ["## strips (no dependencies): policies must be byte-identical",
           f"{'policy':>28} {'MB_to':>8} {'MB_from':>8} {'makespan':>9}"]
    for r in rows:
        out.append(f"{r['policy']:>28} {r['bytes_to'] / 1e6:>8.3f} "
                   f"{r['bytes_from'] / 1e6:>8.3f} "
                   f"{r['makespan_overlap_s']:>9.4f}")
    return "\n".join(out)


def main(argv=None) -> int:
    """The CLI of ``benchmarks/sched_policies.py``: both sections, their
    asserts, and ``--json`` in ``BENCH_sched.json``'s layout."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also dump every section's rows to PATH "
                         "(BENCH_sched.json's layout)")
    ap.add_argument("--device", default="cuda",
                    help="where the virtual devices live (default: cuda)")
    ap.add_argument("--launches", metavar="PATH", default=None,
                    help="write this run's kernel launch counts to PATH")
    args = ap.parse_args(argv)
    sections = {"sparselu": run_sparselu(device=args.device),
                "strips": run_strips(device=args.device)}
    print(render_sparselu(sections["sparselu"]))
    print(render_strips(sections["strips"]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"benchmark": "sched_policies", "sections": sections},
                      f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    from .kernels import write_launch_report
    write_launch_report(args.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
