"""Regression gate over the committed ``BENCH_*.json`` perf trajectory, plus
the measured-calibration acceptance gate: the port of
``benchmarks/perf_gate.py``, both halves.

1. **Trajectory gate** (:func:`trajectory_gate`) — re-runs the four bench
   CLIs of the port as subprocesses, ``python -m repro_torch.<bench> ...
   --json PATH --device DEVICE`` (``comm_modes --smoke``,
   ``sched_policies``, ``topo_collectives --smoke``, ``serve_load
   --smoke``), and compares every *deterministic* leaf (modeled
   ``comm_s``/``peer_s``, byte counters, reduction percentages, token
   counts) with the committed ``artifacts/bench/BENCH_*.json`` within
   ``--noise-band`` percent (:func:`compare`, the reference's).  Boolean
   invariants (``tokens_identical``) must hold exactly.  Wall-clock metrics
   are not gated here; each bench asserts its own checks, and a bench that
   exits non-zero is a gate failure.  ``sched``'s capacity-capped row, whose
   evictions vary with timing, is also held to its spill accounting
   (``sched_policies.spill_faults``).  Each child gets the device the gate
   was asked for.

2. **Calibration gate** (:func:`calibration_gate`) — on a synthetic host
   whose true kernel and link costs sit 4x or more off the model defaults
   (a fast funnel, a pathologically thin peer fabric, cheap kernels), HEFT
   seeded from a :class:`~.core.calibrate.CalibrationProfile` of those
   costs (``estimates="calibrated"`` after ``load_calibration``) must beat
   HEFT on its frozen defaults by at least ``min_win_pct`` percent of
   *true-cost modeled makespan* on the peer-routed sparselu wavefront (K=4,
   B=64, 4 devices), with results bit for bit identical either way
   (placement moves bytes, never values).

    python -m repro_torch.perf_gate                  # on the card
    python -m repro_torch.perf_gate --device cpu

prints the report JSON, writes it to ``build/perf_gate_report.json``
(``--report``), renders the calibrated arm's placement roofline to
``build/roofline_placement.md``, refreshes this host's calibration profile
under ``build/calibration/`` (``--no-profile`` skips it) and exits 1 on a
failure.  It reads ``artifacts/`` and never writes there.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ._device import DeviceLike
from .bots import sparselu as bl
from .core import ClusterRuntime, HeftPlacement, RuntimeConfig
from .core.calibrate import (CalibrationProfile, KernelProfile, LinkProfile,
                             host_info)
from .core.costmodel import PAPER_ETHERNET, LinkModel
from .sched_policies import spill_faults

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = os.path.join(REPO, "artifacts", "bench")
BUILD_DIR = os.path.join(REPO, "build")

# (name, argv tail, committed baseline): the reference's bench CLIs, as the
# port's modules
BENCHES = [
    ("comm", ["-m", "repro_torch.comm_modes", "--smoke"], "BENCH_comm.json"),
    ("sched", ["-m", "repro_torch.sched_policies"], "BENCH_sched.json"),
    ("topo", ["-m", "repro_torch.topo_collectives", "--smoke"], "BENCH_topo.json"),
    ("serve", ["-m", "repro_torch.serve_load", "--smoke"], "BENCH_serve.json"),
]

# Deterministic leaves gated within the noise band.  Everything timed by a
# wall clock (tokens_per_s, p50/p99, wall_s, makespan_overlap_s) stays out.
GATED_LEAVES = {
    "comm": {"bytes_to", "bytes_from", "bytes_peer", "comm_s"},
    "sched": {"bytes_to", "bytes_from", "bytes_peer", "reduction_pct",
              "devs_used", "evictions", "total_MB"},
    "topo": {"bytes_peer", "bytes_cross_rack", "peer_s", "comm_s"},
    "serve": {"tokens", "requests"},
}

# Boolean invariants: must be True in the fresh run (and in the baseline).
GATED_BOOLS = {
    "serve": {"tokens_identical"},
}

# Fields that identify a row inside a JSON list (stable across runs).
_ROW_KEYS = ("section", "update", "mode", "params", "mapping", "policy",
             "dispatch", "devices", "elems", "steps", "tasks", "strips")


def flatten(obj: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a bench JSON to {path: scalar}; list rows are keyed by their
    identifying fields, not their index, so reordering never false-fails."""
    out: Dict[str, Any] = {}
    if isinstance(obj, dict):
        for k in sorted(obj):
            out.update(flatten(obj[k], f"{prefix}/{k}"))
    elif isinstance(obj, list):
        for i, row in enumerate(obj):
            if isinstance(row, dict):
                ident = ",".join(f"{k}={row[k]}" for k in _ROW_KEYS
                                 if k in row) or str(i)
                out.update(flatten(row, f"{prefix}[{ident}]"))
            else:
                out[f"{prefix}[{i}]"] = row
    else:
        out[prefix] = obj
    return out


def _leaf(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def compare(name: str, base: Dict[str, Any], fresh: Dict[str, Any],
            noise_band_pct: float) -> List[str]:
    """Failures comparing a fresh bench run against its committed baseline."""
    fails: List[str] = []
    fb, ff = flatten(base), flatten(fresh)
    gated = GATED_LEAVES.get(name, set())
    bools = GATED_BOOLS.get(name, set())
    for path, bval in sorted(fb.items()):
        leaf = _leaf(path)
        if leaf in bools:
            fval = ff.get(path)
            if bval is True and fval is not True:
                fails.append(f"{name}:{path}: invariant was true, now {fval}")
            continue
        if leaf not in gated or not isinstance(bval, (int, float)) \
                or isinstance(bval, bool):
            continue
        if path not in ff:
            fails.append(f"{name}:{path}: metric missing from fresh run")
            continue
        fval = ff[path]
        tol = abs(bval) * noise_band_pct / 100.0 + 1e-9
        if abs(fval - bval) > tol:
            fails.append(f"{name}:{path}: {bval:g} -> {fval:g} "
                         f"(band ±{noise_band_pct:g}%)")
    return fails


def n_gated(name: str, base: Dict[str, Any]) -> int:
    """The baseline's gated numeric leaves."""
    return sum(1 for p, v in flatten(base).items()
               if _leaf(p) in GATED_LEAVES.get(name, set())
               and isinstance(v, (int, float)) and not isinstance(v, bool))


def _bench_cmd(argv_tail: List[str], json_out: str, launches_out: str,
               device: str) -> List[str]:
    return ([sys.executable] + argv_tail
            + ["--json", json_out, "--launches", launches_out, "--device", device])


def _child_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def trajectory_gate(noise_band_pct: float = 15.0, *, device: str = "cuda",
                    names: Optional[Sequence[str]] = None
                    ) -> Tuple[List[str], Dict[str, Any]]:
    """``(failures, detail)``: each bench in ``names`` (default all four)
    run as a subprocess on ``device`` — all of them at once — and held
    against its committed baseline by :func:`compare`.  ``detail[name]``
    has the status, the gated metric count, the failures, the bench's
    seconds and its kernel launches (``kernels.launch_report`` of the
    child); ``sched``'s also its capped row's evictions and refetches."""
    from ._device import resolve_device
    resolve_device(device)              # no card: raise here, not in a child
    fails: List[str] = []
    detail: Dict[str, Any] = {}
    chosen = [b for b in BENCHES if names is None or b[0] in names]
    tmp = tempfile.mkdtemp(prefix="perf_gate_")
    try:
        procs = {}
        for name, argv_tail, _ in chosen:
            out, launches = (os.path.join(tmp, f"{name}.json"),
                             os.path.join(tmp, f"{name}_launches.json"))
            log = open(os.path.join(tmp, f"{name}.log"), "w+")
            procs[name] = (subprocess.Popen(_bench_cmd(argv_tail, out, launches, device),
                                            cwd=REPO, env=_child_env(), stdout=log,
                                            stderr=subprocess.STDOUT, text=True),
                           out, launches, log, time.perf_counter())
        for name, argv_tail, baseline_fn in chosen:
            proc, out, launches, log, t0 = procs[name]
            rc = proc.wait()
            seconds = time.perf_counter() - t0
            log.seek(0)
            text = log.read()
            log.close()
            if rc != 0:
                fails.append(f"{name}: bench failed: {' '.join(argv_tail)} exited {rc}\n"
                             f"{text[-2000:]}")
                detail[name] = {"status": "bench-failed", "seconds": seconds}
                continue
            with open(os.path.join(BENCH_DIR, baseline_fn)) as f:
                base = json.load(f)
            with open(out) as f:
                fresh = json.load(f)
            with open(launches) as f:
                kernel_launches = json.load(f)
            bench_fails = compare(name, base, fresh, noise_band_pct)
            extra = {}
            if name == "sched":
                rows = fresh["sections"]["sparselu"]
                bench_fails += spill_faults(rows)
                extra["capped"] = {k: rows[-1][k] for k in ("evictions", "refetches")}
            fails.extend(bench_fails)
            detail[name] = {"status": "fail" if bench_fails else "ok",
                            "gated_metrics": n_gated(name, base),
                            "failures": bench_fails, "seconds": seconds,
                            "launches": kernel_launches, **extra}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return fails, detail


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


def refresh_host_profile(device: DeviceLike = "cuda",
                         directory: str = os.path.join(BUILD_DIR, "calibration")
                         ) -> str:
    """Calibrate this host against the sparselu kernel table on a D=4
    runtime and persist the profile under ``directory`` (default
    ``build/calibration/``); returns its path."""
    a = torch.eye(B, dtype=torch.float32) * 4.0 + 0.01
    lu = bl.lu0_op(a)
    operands = {"lu0": (a,), "fwd": (lu, a), "bdiv": (lu, a), "bmod": (a, a, a)}
    rt = ClusterRuntime(RuntimeConfig(n_virtual=N_DEV, link=PAPER_ETHERNET),
                        table=bl._make_table(N_DEV), device=device)
    try:
        profile = rt.calibrate(operands, save_dir=directory)
    finally:
        rt.shutdown()
    return os.path.join(directory, f"{profile.host['hostname']}.json")


def write_placement_roofline(report: Dict[str, Any],
                             path: str = os.path.join(BUILD_DIR,
                                                      "roofline_placement.md")) -> str:
    """The calibrated arm's predicted-vs-observed placement roofline as
    markdown (``roofline.render_placement_roofline``); returns ``path``."""
    from .roofline import render_placement_roofline
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("### calibrated sparselu: predicted-vs-observed "
                "placement roofline\n\n")
        f.write(render_placement_roofline(report) + "\n")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the virtual devices live (default: cuda)")
    ap.add_argument("--noise-band", type=float, default=15.0, metavar="PCT",
                    help="allowed %% drift per deterministic metric vs the "
                         "committed BENCH_*.json baseline (default 15)")
    ap.add_argument("--min-win-pct", type=float, default=20.0, metavar="PCT",
                    help="calibration gate: required true-makespan win of "
                         "calibrated over uncalibrated HEFT (default 20)")
    ap.add_argument("--skip-bench", action="store_true",
                    help="skip the bench trajectory gate (calibration gate only)")
    ap.add_argument("--skip-calibration", action="store_true",
                    help="skip the calibration gate (trajectory gate only)")
    ap.add_argument("--no-profile", action="store_true",
                    help="do not refresh this host's calibration profile")
    ap.add_argument("--report", "--out", dest="report", metavar="PATH",
                    default=os.path.join("build", "perf_gate_report.json"),
                    help="write the gate report JSON here")
    args = ap.parse_args(argv)

    fails: List[str] = []
    report: Dict[str, Any] = {"noise_band_pct": args.noise_band}
    notes: List[str] = []
    if not args.skip_bench:
        t_fails, t_detail = trajectory_gate(args.noise_band, device=args.device)
        fails.extend(t_fails)
        report["trajectory"] = t_detail
        notes += [f"[perf-gate] {name}: {d['status']} "
                  f"({d.get('gated_metrics', 0)} gated metrics)"
                  for name, d in t_detail.items()]
    if not args.skip_calibration:
        c_fails, c_detail = calibration_gate(args.min_win_pct, device=args.device)
        fails.extend(c_fails)
        report["calibration"] = c_detail
        if c_detail["placement_report"] is not None:
            path = write_placement_roofline(c_detail["placement_report"])
            notes.append(f"[perf-gate] placement roofline: {path}")
        notes.append(f"[perf-gate] calibration: {c_detail['status']} "
                     f"(win {c_detail['win_pct']:.1f}% over uncalibrated, "
                     f"bit_identical={c_detail['bit_identical']})")
    if not args.no_profile:
        report["host_profile"] = refresh_host_profile(args.device)
        notes.append(f"[perf-gate] host profile refreshed: {report['host_profile']}")
    report["failures"] = fails
    report["ok"] = not fails
    print(json.dumps(report, indent=1, default=str))
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"wrote {args.report}")
    for note in notes:
        print(note)
    if fails:
        print(f"\n[perf-gate] FAIL ({len(fails)}):", flush=True)
        for msg in fails:
            print(f"  - {msg}")
        return 1
    print("\n[perf-gate] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
