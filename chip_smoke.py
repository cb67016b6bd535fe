#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root on a machine with an NVIDIA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc/*.cu``
(one ``nvcc`` per source, all started together, into ``build/kernels/``) and
runs, printing one JSON line per phase:

1. the card's name and power limit (``nvidia-smi``), the build, and
   ``-Xptxas -v``'s registers and spills per kernel;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its time, the plain version's time and (for bmod)
   ``torch.addmm``'s;
3. the paper's Listings 1–2 on 8 virtual devices;
4. BOTS mandelbrot at the paper's 4600 x 4600 image, max_iter 300:
   ``offload_strips`` on 8 virtual devices against the one-region serial
   run (the images must be equal);
5. BOTS sparselu: the ``nowait``/``resident`` wavefront on 4 virtual devices
   for K=16, B=128 (a 2048² fp32 matrix, 1,496 tasks, 1,240 bmod launches)
   and for K=5, B=96, against the serial kernel, with the residual
   ‖L·U − A‖/‖A‖ in float64.

Phases 4 and 5 then run their workload once more under ``torch.profiler``
and report the card's busy share of that run.

Every kernel's launch count is set to 0 just before a main-path phase and
read just after; a kernel of the path that did not launch fails the run.
Then it prints the ``{"kernels": [...]}`` line (times, bounds, launches) and,
last, ``{"ok": true, "device": {...}}``.  It exits non-zero at the first
failed phase, and when no card is present.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 (NVIDIA data sheets, dense, no sparsity): the
# SXM part, and the PCIe part when nvidia-smi names it.  fp32 is the CUDA
# cores' rate; bf16 the tensor cores'.
PEAKS = {
    "sxm": {"fp32_flops": 67e12, "bf16_flops": 989e12, "hbm_Bps": 3.35e12},
    "pcie": {"fp32_flops": 51e12, "bf16_flops": 756e12, "hbm_Bps": 2.0e12},
}

MANDEL_SIZE, MANDEL_ITER, MANDEL_DEVICES = 4600, 300, 8
LU_K, LU_B, LU_DEVICES = 16, 128, 4
LU_LARGE = (5, 96)                      # the reference's "large" size
BMOD_SHAPES = ((128, 128, 128), (96, 96, 96), (200, 72, 136))   # (M, N, K)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(torch, fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed and timed with CUDA events, so the host's
    per-call overhead (Python, checks, launch) stays out of the number."""
    fn()                                  # lazy init outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                        # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(peaks, nbytes: float, flops: float, flop_key: str):
    t_bytes = nbytes / peaks["hbm_Bps"] * 1e3
    t_ops = flops / peaks[flop_key] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_busy(torch, fn) -> dict:
    """Run ``fn`` once more under ``torch.profiler`` (CUDA activity) and
    report the union of the device intervals it recorded — kernels and
    copies — against that run's wall time: the card's busy share.  The
    profiled run is not the timed one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"profiled_wall_s": wall, "device_events": len(events),
            "device_busy_s": busy_us * 1e-6 if events else None,
            "device_busy_share": busy_us * 1e-6 / wall if events else None,
            "top_device_s": {name[:60]: us * 1e-6 for name, us in top}}


def phase_card_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build(force=True, ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if re.search(r"registers|spill", ln)]
             for name, r in report.items()}
    emit({"phase": "build", "card": card, "seconds": seconds,
          "sources": sorted(report), "ptxas": ptxas})
    return card


def phase_kernels(torch, peaks):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import strip_partition
    from repro_torch.kernels.block_lu import block_lu as k2mod
    from repro_torch.kernels.block_lu.block_lu import bmod_cuda
    from repro_torch.kernels.block_lu.ref import bmod_ref
    from repro_torch.kernels.mandelbrot import mandelbrot as k1mod
    from repro_torch.kernels.mandelbrot.mandelbrot import mandelbrot_rows_cuda
    from repro_torch.kernels.mandelbrot.ref import mandelbrot_rows_ref

    dev = torch.device("cuda", 0)
    k1mod.launches.reset()
    k2mod.launches.reset()
    n = MANDEL_SIZE
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    img = mandelbrot_rows_cuda(rows, n, n, MANDEL_ITER)
    torch.cuda.synchronize()
    plain = mandelbrot_rows_ref(rows, n, n, MANDEL_ITER)
    torch.cuda.synchronize()
    mismatch = float((img != plain).float().mean())
    k1_err = float((img - plain).abs().max())
    strips = torch.cat([mandelbrot_rows_cuda(rows[s:s + ln], n, n, MANDEL_ITER)
                        for s, ln in strip_partition(n, MANDEL_DEVICES)])
    torch.cuda.synchronize()
    strips_equal = bool(torch.equal(strips, img))
    k1_check_launches = k1mod.launches.count
    counts = float(img.to(torch.int64).sum())
    k1_bound, k1_by = bound_ms(peaks, 4 * n + 4 * n * n, 8 * counts, "fp32_flops")
    k1 = {"name": "mandelbrot_rows", "shape": [n, n], "max_iter": MANDEL_ITER,
          "mismatch_share": mismatch, "tolerance": 0.005,
          "max_abs_err": k1_err, "strips_tile_image": strips_equal,
          "sum_counts": counts, "check_launches": k1_check_launches,
          "ms": time_ms(torch, lambda: mandelbrot_rows_cuda(rows, n, n, MANDEL_ITER), 20),
          "plain_ms": time_ms(torch, lambda: mandelbrot_rows_ref(rows, n, n, MANDEL_ITER), 2),
          "library_ms": None, "bound_ms": k1_bound, "bound_by": k1_by}
    k1["pass"] = mismatch < 0.005 and strips_equal
    emit({"phase": "kernel_check", **k1})

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for (M, N, K) in BMOD_SHAPES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 4e-2)):
            a = torch.randn(M, N, generator=gen, device=dev).to(dtype)
            l = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            u = torch.randn(K, N, generator=gen, device=dev).to(dtype)
            out = bmod_cuda(a, l, u)
            torch.cuda.synchronize()
            ref = bmod_ref(a, l, u)
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))
            cases.append({"M": M, "N": N, "K": K, "dtype": str(dtype),
                          "max_abs_err": err, "tolerance": tol, "pass": ok})
    k2_check_launches = k2mod.launches.count
    B = LU_B
    a, l, u = (torch.randn(B, B, generator=gen, device=dev) for _ in range(3))
    k2_bound, k2_by = bound_ms(peaks, 4 * 4 * B * B, 2 * B ** 3, "fp32_flops")
    main_case = next(c for c in cases if (c["M"], c["N"], c["K"]) == (B, B, B)
                     and c["dtype"] == "torch.float32")
    k2 = {"name": "bmod", "cases": cases, "shape": [B, B, B],
          "check_launches": k2_check_launches,
          "max_abs_err": main_case["max_abs_err"],
          "ms": time_ms(torch, lambda: bmod_cuda(a, l, u), 200),
          "plain_ms": time_ms(torch, lambda: bmod_ref(a, l, u), 200),
          "library_ms": time_ms(torch, lambda: torch.addmm(a, l, u, alpha=-1), 200),
          "bound_ms": k2_bound, "bound_by": k2_by,
          "pass": all(c["pass"] for c in cases)}
    emit({"phase": "kernel_check", **k2})
    if not k1["pass"]:
        fail(f"mandelbrot kernel disagrees with its plain version: {k1}")
    if not k2["pass"]:
        fail(f"bmod kernel disagrees with its plain version: {cases}")
    return k1, k2


def phase_listings(torch):
    """Paper Listings 1–2 and offload_strips (examples/quickstart.py)."""
    from repro_torch.core import (ClusterRuntime, KernelTable, MapSpec,
                                  RuntimeConfig, TensorSpec, offload_strips, sec)
    size = 1024
    table = KernelTable()
    table.register("add_arrays", lambda a, b: {"c": a + b})
    rt = ClusterRuntime(RuntimeConfig(n_virtual=8), table=table, device="cuda")
    try:
        a = torch.arange(size, dtype=torch.float32)
        b = torch.ones(size, dtype=torch.float32)
        c1 = rt.target("add_arrays", 0, MapSpec(
            to={"a": a, "b": b}, from_={"c": TensorSpec((size,), torch.float32)}))["c"]
        chunk = size // len(rt.pool)
        for d in range(len(rt.pool)):
            rt.target("add_arrays", d, MapSpec(
                to={"a": sec(a, d * chunk, chunk), "b": sec(b, d * chunk, chunk)},
                from_={"c": TensorSpec((chunk,), torch.float32)}), nowait=True)
        c2 = torch.cat([p["c"] for p in rt.taskwait()])
        c3 = offload_strips(rt.ex, "add_arrays", size, lambda s, ln: MapSpec(
            to={"a": sec(a, s, ln), "b": sec(b, s, ln)},
            from_={"c": TensorSpec((ln,), torch.float32)}), out_name="c")
        s = rt.cost.summary()
        ok = all(torch.equal(c, a + b) for c in (c1, c2, c3))
        emit({"phase": "listings", "devices": len(rt.pool), "pass": ok,
              "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
              "trace_head": [f"{c.op}@{c.device}" for c in rt.pool.trace[:8]]})
    finally:
        rt.shutdown()
    if not ok:
        fail("Listings 1-2 / offload_strips results differ from a + b")


def phase_mandelbrot(torch):
    from repro_torch.bots import mandelbrot as bm
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.kernels.mandelbrot import mandelbrot as k1
    n = MANDEL_SIZE
    rt = ClusterRuntime(RuntimeConfig(n_virtual=MANDEL_DEVICES),
                        table=bm._make_table(n, n, MANDEL_ITER), device="cuda")
    try:
        rows = bm.all_rows(n)
        k1.launches.reset()
        t0 = time.perf_counter()
        img = bm.strips(rt, rows, n, nowait=True)
        wall = time.perf_counter() - t0
        launches = k1.launches.count
        s = rt.cost.summary()
        ser = bm.serial(rt, rows, n)
        busy = device_busy(torch, lambda: bm.strips(rt, rows, n, nowait=True))
    finally:
        rt.shutdown()
    equal = bool(torch.equal(img, ser))
    sane = (tuple(img.shape) == (n, n) and img.dtype == torch.int32
            and int(img.min()) >= 0 and int(img.max()) <= MANDEL_ITER)
    emit({"phase": "bots_mandelbrot", "size": n, "max_iter": MANDEL_ITER,
          "devices": MANDEL_DEVICES, "wall_s": wall,
          "modeled_makespan_s": s["makespan_s"],
          "modeled_makespan_overlap_s": s["makespan_overlap_s"],
          "compute_s": s["compute_s"], "bytes_to": s["bytes_to"],
          "bytes_from": s["bytes_from"], "kernel_launches": launches,
          "strips_equal_serial": equal, "sane": sane, "profiled": busy})
    if launches != MANDEL_DEVICES:
        fail(f"mandelbrot kernel launched {launches} times, expected "
             f"{MANDEL_DEVICES} (one per strip)")
    if not (equal and sane):
        fail("mandelbrot strips differ from the serial image")
    return launches


def _sparselu_once(torch, K: int, B: int, n_devices: int):
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.kernels.block_lu import block_lu as k2
    mat = bl._matrix(K, B)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n_devices),
                        table=bl._make_table(K), device="cuda")
    try:
        n_tasks = len(bl._build_dag(mat, K, B))
        k2.launches.reset()
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat)
        wall = time.perf_counter() - t0
        launches = k2.launches.count
        s = rt.cost.summary()
        ser = bl.serial(rt, mat)
        busy = device_busy(torch, lambda: bl.wavefront(rt, mat))
    finally:
        rt.shutdown()
    lu = bl.assemble(res, K)
    diff = float((lu - ser).abs().max())
    n = K * B
    dev = rt.device
    full = lu.permute(0, 2, 1, 3).reshape(n, n).to(dev, torch.float64)
    A = mat.permute(0, 2, 1, 3).reshape(n, n).to(dev, torch.float64)
    L = torch.tril(full, -1) + torch.eye(n, dtype=torch.float64, device=dev)
    U = torch.triu(full)
    residual = float(torch.linalg.norm(L @ U - A) / torch.linalg.norm(A))
    expect = sum(m * m for m in range(K))
    row = {"phase": "bots_sparselu", "K": K, "B": B, "devices": n_devices,
           "tasks": n_tasks, "wall_s": wall, "bmod_launches": launches,
           "bmod_expected": expect, "max_abs_diff_vs_serial": diff,
           "residual": residual, "finite": bool(torch.isfinite(lu).all()),
           "modeled_makespan_s": s["makespan_s"], "compute_s": s["compute_s"],
           "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
           "profiled": busy}
    emit(row)
    if launches != expect:
        fail(f"bmod launched {launches} times in the wavefront, expected {expect}")
    if not row["finite"] or diff != 0.0 or residual > 1e-5:
        fail(f"sparselu K={K} B={B}: diff {diff}, residual {residual}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.core  # noqa: F401  (fails here, before any output, without the repo)
    # full fp32 everywhere: the plain versions and the library yardstick
    # must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_card_and_build()
    peaks = PEAKS["pcie" if "pcie" in card.lower() else "sxm"]
    k1, k2 = phase_kernels(torch, peaks)
    phase_listings(torch)
    k1_launches = phase_mandelbrot(torch)
    k2_launches = _sparselu_once(torch, LU_K, LU_B, LU_DEVICES)
    _sparselu_once(torch, *LU_LARGE, LU_DEVICES)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": card, "peaks": peaks})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [
        {**k1, "route": "cuda", "source": "src/repro_torch/csrc/mandelbrot.cu",
         "replaces": "src/repro/kernels/mandelbrot/mandelbrot.py:18",
         "launches": k1_launches},
        {**k2, "route": "cuda", "source": "src/repro_torch/csrc/block_lu.cu",
         "replaces": "src/repro/kernels/block_lu/block_lu.py:21",
         "launches": k2_launches},
    ]
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
