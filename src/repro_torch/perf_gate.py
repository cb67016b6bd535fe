"""The calibration acceptance gate: the calibration half of
``benchmarks/perf_gate.py``.

On a synthetic host whose true kernel and link costs sit 4x or more off the
model defaults (a fast funnel, a pathologically thin peer fabric, cheap
kernels), HEFT seeded from a :class:`~.core.calibrate.CalibrationProfile`
of those costs (``estimates="calibrated"`` after ``load_calibration``) must
beat HEFT on its frozen defaults by at least ``min_win_pct`` percent of
*true-cost modeled makespan* on the peer-routed sparselu wavefront (K=4,
B=64, 4 devices), with results bit for bit identical either way (placement
moves bytes, never values).

    python -m repro_torch.perf_gate                  # on the card
    python -m repro_torch.perf_gate --device cpu

prints the detail JSON, writes it to ``build/perf_gate_report.json``
(``--out``) and exits 1 on a failure.  The trajectory half (each bench's
deterministic leaves against the committed ``BENCH_*.json``) is not ported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Tuple

import torch

from ._device import DeviceLike
from .bots import sparselu as bl
from .core import ClusterRuntime, HeftPlacement, RuntimeConfig
from .core.calibrate import (CalibrationProfile, KernelProfile, LinkProfile,
                             host_info)
from .core.costmodel import PAPER_ETHERNET, LinkModel

K, B, N_DEV = 4, 64, 4
# the synthetic TRUE host — every number >=4x off the model defaults
# (funnel default 125e6 Bps / 50µs, peer default = funnel, kernel default
# DEFAULT_KERNEL_TIME_S = 1e-3 s):
TRUE_FUNNEL = LinkModel("true-funnel", 1e9, 10e-6)     # 8x faster
TRUE_PEER = LinkModel("true-peer", 5e6, 1e-3)          # 25x slower, 20x lat
TRUE_KERNELS = {"lu0": 30e-6, "fwd": 25e-6, "bdiv": 25e-6,
                "bmod": 35e-6}                         # ~30x cheaper


def _true_makespan(cost, true_funnel, true_peer,
                   true_kernels: Dict[str, float]) -> float:
    """Re-price a run's recorded traffic under the synthetic host's TRUE
    costs: serialized host funnel + the busiest directed peer link + the
    busiest device's compute (the same serial structure as
    ``CostModel.makespan(overlap=False)``, with truth substituted)."""
    comm = sum(true_funnel.time(t.nbytes, t.n_messages)
               for t in cost.transfers)
    per_link: Dict[Tuple[int, int], float] = {}
    for p in cost.peers:
        key = (p.src, p.dst)
        per_link[key] = per_link.get(key, 0.0) \
            + true_peer.time(p.nbytes, p.n_messages)
    per_dev: Dict[int, float] = {}
    for c in cost.compute:
        per_dev[c.device] = per_dev.get(c.device, 0.0) \
            + true_kernels.get(c.kernel, 30e-6)
    return comm + max(per_link.values(), default=0.0) \
        + max(per_dev.values(), default=0.0)


def _profile(rt: ClusterRuntime) -> CalibrationProfile:
    """The true host's costs as a profile built in memory for ``rt``."""
    return CalibrationProfile(
        version=1, created_unix=time.time(), host=host_info(rt.device),
        n_devices=N_DEV, table_fingerprint=rt.pool.table.fingerprint(),
        topology=None,
        kernels={k: KernelProfile(name=k, seconds=s, reps=1, min_s=s, max_s=s)
                 for k, s in TRUE_KERNELS.items()},
        links={"funnel": LinkProfile("funnel", TRUE_FUNNEL.bandwidth_Bps,
                                     TRUE_FUNNEL.latency_s),
               "peer": LinkProfile("peer", TRUE_PEER.bandwidth_Bps,
                                   TRUE_PEER.latency_s)})


def run_arm(calibrated: bool, *, device: DeviceLike = "cuda"):
    """One arm: ``(results on the host, true makespan, placement report of
    the calibrated arm or None)``."""
    mat = bl._matrix(K, B)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=N_DEV, link=PAPER_ETHERNET),
                        table=bl._make_table(K), device=device)
    try:
        if calibrated:
            rt.load_calibration(_profile(rt))
            policy = HeftPlacement(estimates="calibrated")
        else:
            policy = HeftPlacement(estimates="frozen")
        res = rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True,
                                   peer=True, policy=policy)
        values = {k: v.cpu() for k, v in res.items()}
        makespan = _true_makespan(rt.cost, TRUE_FUNNEL, TRUE_PEER,
                                  TRUE_KERNELS)
        report = rt.cost.placement_report(roofline=True) if calibrated \
            else None
    finally:
        rt.shutdown()
    return values, makespan, report


def calibration_gate(min_win_pct: float = 20.0, *,
                     device: DeviceLike = "cuda"
                     ) -> Tuple[List[str], Dict[str, Any]]:
    """``(failures, detail)``: the reference's detail keys, plus the
    calibrated arm's ``placement_report`` (its roofline rows)."""
    uncal_vals, uncal_s, _ = run_arm(False, device=device)
    cal_vals, cal_s, placement_report = run_arm(True, device=device)

    fails: List[str] = []
    if sorted(uncal_vals) != sorted(cal_vals):
        fails.append("calibration: result key sets differ between arms")
    else:
        for k in uncal_vals:
            if not torch.equal(uncal_vals[k], cal_vals[k]):
                fails.append(f"calibration: result {k!r} not bit-identical "
                             "across arms")
                break
    win_pct = (1.0 - cal_s / uncal_s) * 100.0 if uncal_s > 0 else 0.0
    if win_pct < min_win_pct:
        fails.append(
            f"calibration: calibrated HEFT won only {win_pct:.1f}% of true "
            f"modeled makespan (uncal {uncal_s * 1e3:.3f}ms -> cal "
            f"{cal_s * 1e3:.3f}ms); gate requires >= {min_win_pct:g}%")

    detail = {"status": "fail" if fails else "ok",
              "uncalibrated_true_makespan_s": uncal_s,
              "calibrated_true_makespan_s": cal_s,
              "win_pct": win_pct, "min_win_pct": min_win_pct,
              "bit_identical": not any("bit-identical" in f or
                                       "key sets" in f for f in fails),
              "placement_report": placement_report}
    return fails, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the virtual devices live (default: cuda)")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "perf_gate_report.json"))
    args = ap.parse_args(argv)
    fails, detail = calibration_gate(device=args.device)
    report = {"calibration": detail, "failures": fails}
    print(json.dumps(report, indent=1, default=str))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wrote {args.out}")
    if fails:
        print("PERF GATE FAILURES:", flush=True)
        for f in fails:
            print("  -", f)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
