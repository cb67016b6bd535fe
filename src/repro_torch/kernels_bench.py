"""Kernel microbench: two timed kernels beside their plain versions, and the
tensor-core kernels' resources per CTA.

The port's counterpart of ``benchmarks/kernels_bench.py``.  The reference
times its XLA oracle paths on the CPU and derives its Pallas kernels' VMEM
working set per grid step.  Here:

* the **tile rows** give each tensor-core kernel's registers, static shared
  memory and spills per kernel function from ``nvcc -Xptxas -v``'s log
  (``kernels/_build.py``), and — at its served launch configuration, read
  from the profiler's record of one launch — its grid, block, registers per
  thread and shared memory per CTA (static + dynamic: the dynamic part is
  set at launch, so the log cannot show it): K4 at minitron-4b's prefill,
  K5 at zamba2-2.7b's, K6 at moonshot-v1-16b-a3b's;
* the **timed rows** (device time a call, from a replayed CUDA graph of
  ``REPS`` calls on the card) are K4 through ``ops.gqa_flash_attention`` at the
  reference's (1, 512, 8, 64) / (1, 512, 2, 64) causal shape, and K5
  through ``ops.ssd_chunked_scan`` at the reference's (1, 512, 8, ·) shape,
  each in bf16 (the served dtype) beside its plain version on the same
  inputs.  K5 takes only the (P, N) it serves, so its row runs at P = N =
  64 in place of the reference's P = 32, N = 16 (``served_shape`` names
  it); the reference's chunk 128 is the plain version's (the kernel keeps
  its own).

    python -m repro_torch.kernels_bench                 # on the card
    python -m repro_torch.kernels_bench --device cpu    # the plain versions

``--json PATH`` writes the timed rows as a ``CalibrationProfile``
(``to_profile_dict``), which ``load_calibration`` and
``repro_torch.roofline`` read.  Every row carries the card's name and power
limit (``nvidia-smi``) on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device

#: The tensor-core libraries whose resources the tile rows report.
TILE_KERNELS = ("flash_attention", "ssd_scan", "grouped_matmul")
#: Each one's served launch: the shape of one call on the main path.
SERVED = {
    "flash_attention": "minitron-4b prefill: q (4, 512, 24, 128), k/v (4, 512, 8, 128), "
                       "bf16, causal",
    "ssd_scan": "zamba2-2.7b prefill: x (4, 512, 80, 64), B/C (4, 512, 1, 64), bf16",
    "grouped_matmul": "moonshot-v1-16b-a3b prefill gate/up: x (64, 240, 2048), "
                      "w (64, 2048, 1408), bf16",
}
REPS = 20


def _card(dev: torch.device) -> Dict[str, Any]:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return {"card": "cpu", "power_limit": None}
    from .core.calibrate import host_info
    info = host_info(dev)
    return {"card": info.get("gpu"), "power_limit": info.get("gpu_power_limit")}


def _time(fn, dev: torch.device, reps: int = REPS, samples: int = 5) -> Dict[str, float]:
    """Seconds a call: on the card, ``reps`` calls captured in one CUDA
    graph and replayed ``samples`` times, each replay timed with CUDA events
    (so the host's per-call work stays out, as in ``chip_smoke.py``); on the
    CPU, ``reps`` calls on the host clock.  The median, min and max a call."""
    fn()
    ts = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        for _ in range(samples):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3 / reps)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return {"seconds": float(np.median(ts)), "min_s": float(np.min(ts)),
            "max_s": float(np.max(ts)), "reps": reps * (samples if dev.type == "cuda" else 1)}


# ---------------------------------------------------------------------------
# tile rows: resources per CTA
# ---------------------------------------------------------------------------
def _served_launch(name: str, dev: torch.device):
    """One call of library ``name``'s kernel at its served shape."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    if name == "flash_attention":
        from .kernels.flash_attention.ops import gqa_flash_attention
        q, k, v = randn(4, 512, 24, 128), randn(4, 512, 8, 128), randn(4, 512, 8, 128)
        return lambda: gqa_flash_attention(q, k, v, causal=True)
    if name == "ssd_scan":
        from .kernels.ssd_scan.ops import ssd_chunked_scan
        x, B, C = randn(4, 512, 80, 64), randn(4, 512, 1, 64), randn(4, 512, 1, 64)
        dt = torch.nn.functional.softplus(torch.randn(4, 512, 80, generator=g, device=dev))
        A = -torch.exp(torch.randn(80, generator=g, device=dev) * 0.3)
        return lambda: ssd_chunked_scan(x, dt, A, B, C)
    from .kernels.grouped_matmul.ops import expert_ffn_matmul
    x, w = randn(64, 240, 2048), randn(64, 2048, 1408)
    return lambda: expert_ffn_matmul(x, w)


def _launch_records(fn) -> List[Dict[str, Any]]:
    """The kernel launches the profiler recorded for one call of ``fn``:
    name, grid, block, registers per thread, shared memory per CTA."""
    from torch.profiler import ProfilerActivity, profile

    from .kernels import _build
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        a = e.get("args", {})
        out.append({"name": _build.kernel_name(e.get("name", "")), "grid": a.get("grid"),
                    "block": a.get("block"),
                    "registers_per_thread": a.get("registers per thread"),
                    "smem_bytes_per_cta": a.get("shared memory"),
                    "blocks_per_sm": a.get("blocks per SM")})
    if not out:                 # say what the trace held instead
        cats: Dict[str, int] = {}
        for e in events:
            cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
        out.append({"name": None, "trace_categories": cats})
    return out


def tile_rows(*, device: DeviceLike = "cuda",
              logs: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
    """One row per tensor-core library: its kernels' ptxas resources and the
    launches of one served call.  ``logs`` maps a library to its ``-Xptxas
    -v`` build log; without it the three libraries are rebuilt with the flag
    (on the card).  On the CPU there is no build and no launch: the row says
    so."""
    dev = resolve_device(device)
    card = _card(dev)
    if dev.type != "cuda":
        return [{"kernel": name, "served_shape": SERVED[name], "ptxas": None,
                 "launches": None, **card} for name in TILE_KERNELS]
    from .kernels import _build
    if logs is None:
        report = _build.build(TILE_KERNELS, force=True, ptxas_verbose=True)
        logs = {name: r["log"] for name, r in report.items()}
    rows = []
    for name in TILE_KERNELS:
        rows.append({"kernel": name, "served_shape": SERVED[name],
                     "ptxas": _build.ptxas_by_kernel(logs.get(name, ""), _build.nvcc()),
                     "launches": _launch_records(_served_launch(name, dev)), **card})
    return rows


# ---------------------------------------------------------------------------
# timed rows
# ---------------------------------------------------------------------------
def _k4_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4's plain version in the model layout, on the operands' device (the
    wrapper's CPU branch)."""
    from .kernels.flash_attention.ref import flash_attention_ref
    B, S, H, d = q.shape
    K = k.shape[2]
    r = H // K
    qk = q.reshape(B, S, K, r, d).permute(0, 2, 3, 1, 4).reshape(B * K, r, S, d)
    kk = k.permute(0, 2, 1, 3).reshape(B * K, -1, d)
    vk = v.permute(0, 2, 1, 3).reshape(B * K, -1, d)
    o = flash_attention_ref(qk, kk, vk, causal=True)
    return o.reshape(B, K, r, S, d).permute(0, 3, 1, 2, 4).reshape(B, S, H, d)


def timed_rows(*, device: DeviceLike = "cuda", reps: int = REPS) -> List[Dict[str, Any]]:
    """K4 and K5 through their ``ops`` wrappers at the reference's shapes
    (bf16; K5 at its nearest served P, N), each beside its plain version on
    the same inputs; times in ms, the kernel's path, the largest difference
    from the plain version."""
    from .kernels.flash_attention import flash_attention as k4
    from .kernels.flash_attention.ops import gqa_flash_attention
    from .kernels.ssd_scan import ssd_scan as k5
    from .kernels.ssd_scan.ops import ssd_chunked_scan
    from .kernels.ssd_scan.ref import ssd_chunked
    dev = resolve_device(device)
    card = _card(dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows = []
    q, k, v = randn(1, 512, 8, 64), randn(1, 512, 2, 64), randn(1, 512, 2, 64)
    kernel = lambda: gqa_flash_attention(q, k, v, causal=True)      # noqa: E731
    plain = lambda: _k4_plain(q, k, v)                              # noqa: E731
    out, want = kernel(), plain()
    st = _time(kernel, dev, reps)
    rows.append({"kernel": "flash_attention(K4)", "route": "ops.gqa_flash_attention",
                 "shape": "q (1, 512, 8, 64), k/v (1, 512, 2, 64), causal, bf16",
                 "served_shape": "the reference's", "path":
                 k4.attention_path(q, k, v) if dev.type == "cuda" else "plain",
                 "ms": st["seconds"] * 1e3, "plain_ms": _time(plain, dev, reps)["seconds"] * 1e3,
                 "max_abs_err_vs_plain": float((out.float() - want.float()).abs().max()),
                 "_timing": st, **card})

    x, B_, C_ = randn(1, 512, 8, 64), randn(1, 512, 2, 64), randn(1, 512, 2, 64)
    dt = torch.nn.functional.softplus(randn(1, 512, 8, dtype=torch.float32))
    A = -torch.exp(randn(8, dtype=torch.float32) * 0.3)
    kernel = lambda: ssd_chunked_scan(x, dt, A, B_, C_, chunk=128)   # noqa: E731
    plain = lambda: ssd_chunked(x, dt, A, B_, C_, chunk=128)         # noqa: E731
    y, _ = kernel()
    y_plain, _ = plain()
    st = _time(kernel, dev, reps)
    rows.append({"kernel": "ssd_scan(K5)", "route": "ops.ssd_chunked_scan",
                 "shape": "x (1, 512, 8, 64), B/C (1, 512, 2, 64), bf16, chunk 128",
                 "served_shape": "P = N = 64 (the reference's P = 32, N = 16 is not "
                                 "among the kernel's (P, N))",
                 "path": k5.ssd_path(x, B_) if dev.type == "cuda" else "plain",
                 "ms": st["seconds"] * 1e3, "plain_ms": _time(plain, dev, reps)["seconds"] * 1e3,
                 "max_abs_err_vs_plain": float((y.float() - y_plain.float()).abs().max()),
                 "_timing": st, **card})
    return rows


def run(*, device: DeviceLike = "cuda", logs: Optional[Dict[str, str]] = None,
        reps: int = REPS) -> List[Dict[str, Any]]:
    return tile_rows(device=device, logs=logs) + timed_rows(device=device, reps=reps)


def to_profile_dict(rows: List[Dict], device: DeviceLike = "cpu") -> Dict:
    """Timed rows as a CalibrationProfile JSON document (untimed tile rows
    land in ``skipped_kernels``; no pool was involved, so n_devices=0 and
    the link table is empty)."""
    from .core.calibrate import CalibrationProfile, KernelProfile, host_info
    kernels, skipped = {}, []
    for r in rows:
        st = r.get("_timing")
        if st is None:
            skipped.append(r["kernel"])
            continue
        kernels[r["kernel"]] = KernelProfile(
            name=r["kernel"], seconds=st["seconds"], reps=st["reps"],
            min_s=st["min_s"], max_s=st["max_s"])
    profile = CalibrationProfile(
        version=1, created_unix=time.time(), host=host_info(resolve_device(device)),
        n_devices=0, table_fingerprint="", topology=None,
        kernels=kernels, skipped_kernels=skipped)
    return profile.to_dict()


def render(rows: List[Dict]) -> str:
    out = ["## kernel resources per CTA + timed kernels beside their plain versions"]
    for r in rows:
        parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in r.items() if k != "kernel" and not k.startswith("_")
                 and k not in ("ptxas", "launches")]
        out.append(f"  {r['kernel']:<22} " + "  ".join(parts))
        if r.get("ptxas"):
            for fn, res in r["ptxas"].items():
                out.append(f"      ptxas {fn[:60]}: {res}")
        for lr in r.get("launches") or []:
            out.append(f"      launch {lr}" if lr["name"] is None else
                       f"      launch {lr['name'][:50]}: grid={lr['grid']} "
                       f"block={lr['block']} regs={lr['registers_per_thread']} "
                       f"smem={lr['smem_bytes_per_cta']}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the timed kernels as a CalibrationProfile JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ptxas-logs", metavar="PATH", default=None,
                    help="JSON {library: -Xptxas -v build log} to read, in place "
                         "of rebuilding the tensor-core libraries")
    ap.add_argument("--rows", metavar="PATH", default=None,
                    help="also write every row as JSON to PATH")
    ap.add_argument("--launches", metavar="PATH", default=None,
                    help="write this run's kernel launch counts to PATH")
    args = ap.parse_args(argv)
    logs = None
    if args.ptxas_logs:
        with open(args.ptxas_logs) as f:
            logs = json.load(f)
    rows = run(device=args.device, logs=logs)
    print(render(rows))
    if args.rows:
        os.makedirs(os.path.dirname(os.path.abspath(args.rows)), exist_ok=True)
        with open(args.rows, "w") as f:
            json.dump(rows, f, indent=1)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(to_profile_dict(rows, args.device), f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    from .kernels import write_launch_report
    write_launch_report(args.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
