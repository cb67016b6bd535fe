"""Aggregate the dry-run records into the roofline table, at the H100's roofs.

The port's counterpart of ``benchmarks/roofline.py``.  Reads every
``build/dryrun/*.json`` written by ``repro_torch.launch.dryrun`` and renders
the per-(arch × shape) three-term roofline table plus the bottleneck and
the MODEL_FLOPS / step-FLOPs ratio, in the reference's form.

Also renders the *measured* side: every calibration profile under
``artifacts/calibration/`` (committed) and ``build/calibration/`` (written
by ``repro_torch.perf_gate`` and ``ClusterRuntime.calibrate``) gets a
per-kernel roofline table — median seconds, FLOPs/bytes, arithmetic
intensity, achieved FLOP/s against the roof — plus the fitted link table,
and :func:`render_placement_roofline` turns a
``CostModel.placement_report(roofline=True)`` payload into the
predicted-vs-observed table the perf gate writes.

The roofs are one H100 SXM's (``core/costmodel.py``: 989 TFLOP/s bf16,
3.35 TB/s).

    python -m repro_torch.roofline                  # names the card
    python -m repro_torch.roofline --device cpu

writes ``build/roofline_table.md`` (``--out``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from .core.costmodel import H100_SXM_HBM_BW_Bps, H100_SXM_PEAK_FLOPS_BF16

PEAK_FLOPS_BF16 = H100_SXM_PEAK_FLOPS_BF16
HBM_BW_Bps = H100_SXM_HBM_BW_Bps
MESH = "h100"


def load(art_dir: str = os.path.join("build", "dryrun"),
         rules: Optional[str] = None) -> List[Dict]:
    out = []
    for fn in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        base = os.path.basename(fn)[:-5]
        parts = base.split("__")
        variant = parts[3] if len(parts) > 3 else "default"
        if rules is not None and variant != rules:
            continue
        with open(fn) as f:
            rec = json.load(f)
        rec["rules"] = variant
        out.append(rec)
    return out


def render_table(recs: List[Dict], *, mesh: str = MESH,
                 rules: str = "default") -> str:
    rows = [r for r in recs if r["mesh"] == mesh and r["rules"] == rules]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    hdr = ("| arch | shape | t_compute | t_memory | t_collective | bottleneck "
           "| useful ratio | roofline frac | GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        ma = r["memory_analysis"]
        gb = (ma.get("argument_bytes") or 0) + (ma.get("temp_bytes") or 0) \
            + (ma.get("output_bytes") or 0) - (ma.get("alias_bytes") or 0)
        gb /= 1e9
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f}s "
            f"| {r['t_memory_s']:.4f}s | {r['t_collective_s']:.4f}s "
            f"| **{r['bottleneck']}** | {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} | {gb:.2f} |")
    return "\n".join(lines)


def summarize(recs: List[Dict], *, mesh: str = MESH) -> Dict[str, List[str]]:
    """Pick the hillclimb cells: worst fraction, most collective-bound."""
    single = [r for r in recs if r["mesh"] == mesh and r["rules"] == "default"]
    trains = [r for r in single if r["kind"] == "train"]
    if not single or not trains:
        return {"worst_fraction": [], "most_collective": []}
    worst = min(trains, key=lambda r: r["roofline_fraction"])
    coll = max(single, key=lambda r: (r["t_collective_s"] /
                                      max(r["t_compute_s"], 1e-12)))
    return {"worst_fraction": [worst["arch"], worst["shape"]],
            "most_collective": [coll["arch"], coll["shape"]]}


# ---------------------------------------------------------------------------
# measured side: calibration profiles + placement roofline
# ---------------------------------------------------------------------------
def load_profiles(art_dir: str = os.path.join("artifacts", "calibration")) -> List[Dict]:
    """Every per-host calibration profile JSON under ``art_dir``."""
    out = []
    for fn in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(fn) as f:
            prof = json.load(f)
        prof["_file"] = os.path.basename(fn)
        out.append(prof)
    return out


def _fmt(v, spec: str = ".3g") -> str:
    return format(v, spec) if isinstance(v, (int, float)) else "—"


def render_calibration_table(prof: Dict) -> str:
    """Per-kernel roofline table for one calibration profile dict."""
    hdr = ("| kernel | median | reps | FLOPs | bytes | intensity "
           "| achieved FLOP/s | roof FLOP/s | frac | bound |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for name in sorted(prof.get("kernels", {})):
        k = prof["kernels"][name]
        intensity = (k["flops"] / k["bytes_accessed"]
                     if k.get("bytes_accessed") else 0.0)
        achieved = (k["flops"] / k["seconds"]
                    if k.get("flops") and k["seconds"] > 0 else None)
        roof = (min(PEAK_FLOPS_BF16, intensity * HBM_BW_Bps)
                if intensity else None)
        frac = achieved / roof if achieved and roof else None
        bound = (("compute" if intensity >= PEAK_FLOPS_BF16 / HBM_BW_Bps
                  else "memory") if intensity else "—")
        lines.append(
            f"| {name} | {k['seconds'] * 1e6:.1f}µs | {k.get('reps', 1)} "
            f"| {_fmt(k.get('flops', 0.0))} | {_fmt(k.get('bytes_accessed', 0.0))} "
            f"| {_fmt(intensity)} | {_fmt(achieved)} | {_fmt(roof)} "
            f"| {_fmt(frac)} | {bound} |")
    skipped = prof.get("skipped_kernels", [])
    if skipped:
        lines.append(f"\nskipped (no operands): {', '.join(sorted(skipped))}")
    return "\n".join(lines)


def render_links_table(prof: Dict) -> str:
    """Fitted alpha-beta link table for one calibration profile dict."""
    hdr = ("| link | bandwidth | latency | samples |\n|---|---|---|---|")
    lines = [hdr]
    for name in sorted(prof.get("links", {})):
        link = prof["links"][name]
        lines.append(
            f"| {name} | {link['bandwidth_Bps'] / 1e6:.1f} MB/s "
            f"| {link['latency_s'] * 1e6:.1f}µs | {len(link.get('samples', []))} |")
    return "\n".join(lines)


def render_placement_roofline(report: Dict) -> str:
    """Render ``CostModel.placement_report(roofline=True)`` output: the
    per-kernel predicted-vs-observed rows (``model_ratio`` = observed /
    calibrated — 1.0 means the calibrated model nailed the live run)."""
    hdr = ("| kernel | obs | observed | calibrated | model ratio "
           "| intensity | roofline frac | bound |\n"
           "|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in report.get("roofline", []):
        obs_s = (f"{r['observed_s'] * 1e6:.1f}µs"
                 if r.get("observed_s") is not None else "—")
        cal_s = (f"{r['calibrated_s'] * 1e6:.1f}µs"
                 if r.get("calibrated_s") is not None else "—")
        lines.append(
            f"| {r['kernel']} | {r['observations']} | {obs_s} | {cal_s} "
            f"| {_fmt(r.get('model_ratio'), '.2f')} "
            f"| {_fmt(r.get('intensity'))} "
            f"| {_fmt(r.get('roofline_fraction'))} "
            f"| {r.get('bound') or '—'} |")
    return "\n".join(lines)


def _card_line(device: str) -> str:
    """Which card the tables stand beside: the roofs are an H100 SXM's; on
    the card its name and power limit as ``nvidia-smi`` gives them."""
    from ._device import resolve_device
    dev = resolve_device(device)
    roofs = (f"roofs: H100 SXM, {PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s bf16, "
             f"{HBM_BW_Bps / 1e12:g} TB/s")
    if dev.type != "cuda":
        return f"{roofs}; rendered on the CPU"
    from .core.calibrate import host_info
    info = host_info(dev)
    return f"{roofs}; card: {info.get('gpu')}, {info.get('gpu_power_limit')}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="the card the tables stand beside (default: cuda)")
    ap.add_argument("--dryrun", default=os.path.join("build", "dryrun"),
                    help="directory of the dry-run records")
    ap.add_argument("--calibration", action="append", default=None,
                    help="directories of calibration profiles (default: "
                         "artifacts/calibration and build/calibration)")
    ap.add_argument("--out", default=os.path.join("build", "roofline_table.md"))
    args = ap.parse_args(argv)
    dirs: Sequence[str] = args.calibration or [os.path.join("artifacts", "calibration"),
                                               os.path.join("build", "calibration")]
    card = _card_line(args.device)
    print(card)
    recs = load(args.dryrun)
    out_lines: List[str] = [card]
    n = sum(1 for r in recs if r["mesh"] == MESH and r["rules"] == "default")
    print(f"\n### mesh={MESH} (one card, default rules, {n} cells)\n")
    print(render_table(recs))
    out_lines.append(f"\n### mesh={MESH} (one card, default rules)\n")
    out_lines.append(render_table(recs))
    print("\nhillclimb candidates:", json.dumps(summarize(recs)))
    profiles = [p for d in dirs for p in load_profiles(d)]
    for prof in profiles:
        host = prof.get("host", {}).get("hostname", prof["_file"])
        for text in (f"\n### calibration: {host} ({prof['_file']})\n",
                     render_calibration_table(prof), "", render_links_table(prof)):
            print(text)
            out_lines.append(text)
    if not profiles:
        print(f"\n(no calibration profiles under {', '.join(dirs)} — run "
              "ClusterRuntime.calibrate or repro_torch.perf_gate)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
