#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root on a machine with an NVIDIA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc/*.cu``
(one ``nvcc`` per source, all started together, into ``build/kernels/``) and
runs, printing one JSON line per phase:

1. the card's name and power limit (``nvidia-smi``), the build (each
   library's own nvcc seconds), ``-Xptxas -v``'s registers and spills per
   kernel, and the count of HGMMA (``wgmma``) instructions in the two
   tensor-core libraries, flash attention and grouped matmul (none fails);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its time, the plain version's time and, where one
   PyTorch call computes the same function, that call's (``torch.addmm``
   for bmod, ``scaled_dot_product_attention`` for the attention kernels):
   mandelbrot and bmod, then flash attention (4 sequences x 24 heads over
   8 kv heads, 512 causal rows, d = 128; also a window, a ragged Sq and
   d = 256; its tensor-core path in bf16 over ``K4_SWEEP`` and on a fused
   projection's strided views) and flash decode (32 kv rows x 3 query heads
   over a 1024-row cache with per-row kv_len from 0 to 1024; also d = 256;
   its split-KV path over ``K3_SWEEP``'s kv_len edges and split counts),
   fp32 and bf16, and both at zamba2-2.7b's shared-block shapes (32 heads
   of d = 80, timed beside SDPA too); bmod and flash decode report their
   path and their CTAs (flash decode: its split count), and each check
   call of either is repeated and must give the same bits;
3. the paper's Listings 1–2 on 8 virtual devices;
4. BOTS mandelbrot at the paper's 4600 x 4600 image, max_iter 300:
   ``offload_strips`` on 8 virtual devices against the one-region serial
   run (the images must be equal);
5. BOTS sparselu: the ``nowait``/``resident`` wavefront on 4 virtual devices
   for K=16, B=128 (a 2048² fp32 matrix, 1,496 tasks, 1,240 bmod launches)
   and for K=5, B=96, against the serial kernel, with the residual
   ‖L·U − A‖/‖A‖ in float64; then the fabric: K=16 once more with
   ``comm_mode="direct"`` and ``wavefront_offload(peer=True)`` (every edge
   a SEND/RECV between two virtual devices' streams), flat and on a 2 x 2
   two-tier topology, each equal to the serial kernel bit for bit, with the
   host-mediated run's ``bytes_from``, fewer ``bytes_to`` and its edges on
   the peer links; data-parallel gradients (``mse_grads`` at d_model 4096,
   a 64 MiB weight, batch 64 per device, D=4) host-mediated, direct (a
   peer ring all-reduce, within rtol 1e-5 of host-mediated) and direct +
   block-int8 (the wire kernel ``csrc/q8_wire.cu`` on every device, within
   max|g|/64), 8 steps of ``data_parallel_step`` synced every 4 with bit-identical
   parameters in both fabrics, and the 2 x 2 hierarchical mean equal to the
   serial left-associated mean bit for bit; the wire kernel against its
   plain version on device 0's gradient and at ragged lengths, bit for bit,
   and its time; then BOTS fib(21) (``recursive_offload``, one
   busy-loop kernel launch per leaf) and alignment (128 queries x 32
   references, the bank resident, query strips) on 8 virtual devices, each
   equal to its serial run bit for bit, after the busy-loop kernel against
   its plain version (a host loop) at fib(8) and fib(15);
6. LM serving: minitron-4b at full width (32 layers, d_model 3072, bf16,
   random weights from seed 0) with the kernels on: 8 requests of 512
   tokens in continuous mode, then 4 in wave mode (one unpadded prefill:
   flash attention on each layer; 31 decodes: flash decode on each layer);
   then the kernel route against the plain route on the same weights
   (prefill and decode logits), and a 2-layer fp32 model at full width
   whose greedy tokens must be equal on both routes;
7. MoE serving: moonshot-v1-16b-a3b at full width and depth (48 layers,
   64 experts top-6, 27.7 B parameters, bf16, random weights from seed 0)
   with the kernels on: 8 requests of 512 tokens in continuous mode, then 4
   in wave mode (one unpadded prefill and 15 decodes: the grouped-matmul
   kernel three times per layer in each, flash attention in the prefill,
   flash decode in every decode); then the kernel route against the plain
   route: one MoE layer (routing equal, outputs close), full-depth logits
   (reported, not gated: a routing flip between near-tied experts is a
   legitimate difference) and a 2-layer fp32 model whose greedy tokens must
   be equal on both routes;
8. SSM and hybrid serving: zamba2-2.7b at full width and depth (54 Mamba2
   layers, one shared attention block run 9 times, 2.34 B parameters,
   bf16, random weights from seed 0) with the kernels on: 8 requests of
   ragged length (512, 509, 384, 300, two of each) in continuous mode
   (exact-length prefills: the SSD-scan kernel in every Mamba2 layer, its
   masked tail included, flash attention in every shared block; flash
   decode in every shared block of every decode), then 4 x 512 in wave
   mode; the kernel route against the plain route (prefill and decode
   logits), and a full-width fp32 model of one group (6 layers) whose
   greedy tokens must be equal on both routes; then mamba2-130m at its full
   config (24 layers, N = 128), one continuous and one wave run, its fp32
   greedy tokens equal on both routes.

Every serve phase decodes through captured CUDA graphs (``serve/graph.py``),
and reports per mode the graphs captured, the replays and the decode seconds
per step; it then serves its wave once more on the eager route
(``eager=True``), whose launch counts per kernel and per path must equal the
captured wave's, replays one bf16 decode step captured against the same
step run eagerly (the logits' difference reported), and holds the fp32
model's greedy tokens on the captured route equal to the eager route's in
both modes.

Phase 2 also holds the grouped-matmul kernel against its plain version at
the MoE path's shapes, beside ``torch.bmm`` as the library yardstick (also at
decode with ``GMM_OCCUPIED`` of 64 experts holding a token, moonshot's serve
occupancy, and over ``GMM_CAPACITIES`` with empty experts), and
the SSD-scan kernel against its plain version at the state serve paths'
prefill shapes (zamba2's, mamba2's, a ragged S, two groups).  Phases 4 to 8
then run a workload once more under ``torch.profiler`` and report the
card's busy share of that run.

Every kernel's launch count, and K2's, K3's, K4's and K6's counts per path,
are set to 0 just before a main-path phase and read just after; a kernel of
the path that did not launch fails the run, and so does a sparselu K2 launch
off the ``cp_async`` path, a serve K3 launch off the ``split`` path, a bf16
K4 launch off the ``wgmma`` path, an MoE prefill K6 launch off ``wgmma`` or a
decode K6 launch off ``small_c``.
Then it prints the ``{"kernels": [...]}`` line (times, bounds, launches) and,
last, ``{"ok": true, "device": {...}}``.  It exits non-zero at the first
failed phase, and when no card is present.
"""
from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 (NVIDIA data sheets, dense, no sparsity): the
# SXM part, and the PCIe part when nvidia-smi names it.  fp32 is the CUDA
# cores' rate, which counts a fused multiply-add as two flops; bf16 the
# tensor cores'.  fp32_unfused is the rate of separately rounded fp32
# operations, one instruction slot each: half of fp32_flops.  K1 runs at it,
# because it must not fuse (csrc/mandelbrot.cu: __fmul_rn/__fadd_rn; an FMA
# rounds once where the reference rounds twice and flips boundary pixels).
PEAKS = {
    "sxm": {"fp32_flops": 67e12, "fp32_unfused": 33.5e12, "bf16_flops": 989e12,
            "hbm_Bps": 3.35e12},
    "pcie": {"fp32_flops": 51e12, "fp32_unfused": 25.5e12, "bf16_flops": 756e12,
             "hbm_Bps": 2.0e12},
}

MANDEL_SIZE, MANDEL_ITER, MANDEL_DEVICES = 4600, 300, 8
LU_K, LU_B, LU_DEVICES = 16, 128, 4
LU_LARGE = (5, 96)                      # the reference's "large" size
# the fabric: racks, devices per rack, spine bandwidth / rack bandwidth
FABRIC_TOPO = (2, 2, 0.1)
# data-parallel gradients at an LM projection's size (benchmarks/comm_modes.py's
# mse_grads at d_model 4096: a 64 MiB fp32 weight), batch 64 per device
DP_D_MODEL, DP_BATCH, DP_DEVICES, DP_STEPS, DP_SYNC = 4096, 64, 4, 8, 4
HIER_ELEMS = 1 << 22                    # per-device vector of the 2 x 2 mean
Q8_RAGGED = (1, 255, 256, 257, 1000003) # wire kernel lengths off the 256-value block
BMOD_SHAPES = ((128, 128, 128), (96, 96, 96), (64, 64, 64), (200, 72, 136))   # (M, N, K)
# the serve phase's attention shapes (minitron-4b: 8 kv heads, r = 3, d = 128)
ATTN_MAIN = (4, 8, 3, 512, 128)         # K4: (B, K, r, Sq = Skv, d)
DECODE_MAIN = (32, 3, 1024, 128)        # K3: (B·K, r, S, d)
DECODE_LENS = (0, 1, 2, 17, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257, 300,
               383, 384, 500, 511, 512, 513, 576, 640, 700, 767, 768, 800, 900,
               1000, 1023, 1024, 31)    # per-row kv_len, one per B·K row
# back-to-back replays of one captured decode step, timed with CUDA events
REPLAY_REPS = 10
# BOTS fib and alignment ("large") on this many virtual devices; the fib
# leaf kernel is checked at the small size's root and at a leaf of that run
BOTS_DEVICES = 8
FIB_CHECK_N = (8, 15)
SERVE_ARCH, SERVE_BATCH, SERVE_MAX_LEN, SERVE_PROMPT = "minitron-4b", 4, 1024, 512
SERVE_BUDGETS = (16, 32, 48, 64)        # max_new_tokens, cycled over the requests
WAVE_BUDGET = 32
# kernel route against plain route, bf16 logits: 8-bit mantissas, and the
# two routes round attention outputs differently on every one of 32 layers
LOGITS_REL_TOL = 5e-2
# K6 at the MoE serve path's shapes (E, C, D, F): moonshot's gate/up
# projections at prefill (C = 240, the capacity of 4 x 512 tokens) and at
# decode (C = 1), its down projection at prefill, and a ragged shape
GMM_SHAPES = ((64, 240, 2048, 1408), (64, 1, 2048, 1408), (64, 240, 1408, 2048),
              (3, 3, 96, 100))
# tolerances of the reference's own K6 test (tests/test_kernels.py:138-140)
GMM_TOL = {"torch.float32": (1e-4, 1e-3), "torch.bfloat16": (3e-2, 3e-1)}
# K4's tensor-core path over the edges of its tiles (bf16, B = 2, 2 kv
# heads): query lengths around the 64-row warpgroup and 128-row CTA tiles,
# every head dim it takes, windows shorter and longer than a 64-key tile,
# and r = 1 and 3 query heads per kv head
K4_SWEEP = {"Sq": (1, 63, 64, 65, 127, 129, 200, 512), "d": (64, 80, 128),
            "window": (0, 48, 128), "r": (1, 3)}
# K3 (split-KV) over kv_len edges and split counts: a 1024-row cache, r = 3,
# zamba2's and minitron's head dims; None is the launcher's own count
K3_SWEEP = {"S": 1024, "r": 3, "d": (80, 128), "n_split": (None, 1, 2, 3, 5, 8, 16)}
K3_TIMED_SPLITS = (1, 2, 4, 8, 16)      # split counts timed beside the launcher's own
# K6 (bf16) at capacities around the small-C limit (16) and the 128-row
# wgmma tile, on moonshot's gate/up widths with 8 experts, each with some
# experts' x all zero: every third one, all of them, all but one
GMM_CAPACITIES = (1, 2, 15, 16, 17, 60, 64, 240, 257)
GMM_SWEEP_SHAPE = (8, 2048, 1408)       # (E, D, F)
# moonshot's decode occupancy: 4 rows x top-6 reach ~20 of 64 experts
GMM_OCCUPIED = 20
MOE_ARCH, MOE_PARAMS = "moonshot-v1-16b-a3b", 27_722_450_944
MOE_BUDGETS = (8, 16, 24, 32)           # max_new_tokens, cycled over the requests
MOE_WAVE_BUDGET = 16
# one MoE layer, kernel route against plain route (bf16): both accumulate
# in fp32 and round once, so outputs differ by a bf16 ulp here and there
MOE_LAYER_REL_TOL = 1e-2
# zamba2-2.7b's shared attention block: 32 heads (MHA) of d = 80
ATTN_D80 = (4, 32, 1, 512, 80)          # K4: (B, K, r, Sq = Skv, d)
DECODE_D80 = (128, 1, 1024, 80)         # K3: (B·K, r, S, d)
# K5 at the state serve paths' prefill shapes (b, S, H, P, G, N, the model's
# chunk): zamba2-2.7b's, mamba2-130m's (N = 128), a ragged S (continuous
# mode prefills exact lengths) and two groups
SSD_SHAPES = ((4, 512, 80, 64, 1, 64, 256), (4, 512, 24, 64, 1, 128, 256),
              (4, 509, 80, 64, 1, 64, 256), (2, 300, 8, 64, 2, 64, 256))
# K5 against its plain version.  fp32: elementwise 1e-3 (the plain version's
# 256-step cumsums reach ~200, whose ulp moves each decay exp(cum_i - cum_j)
# by ~1e-5 relative; the kernel sums 64-step chunks).  bf16: the plain
# version rounds the state entering each chunk to bf16 before the
# inter-chunk term (the reference's ssm.py:111) and the kernel keeps it in
# fp32, so y is held by relative L2 (1e-2: two bf16 roundings of ~2^-9 each)
# against it, and elementwise (4e-2) against the plain version on fp32
# upcasts of the same inputs rounded once to bf16 (the kernel's own
# arithmetic); the fp32 final state elementwise (4e-2) against both.
SSD_TOL = {"fp32": 1e-3, "bf16_rel_l2": 1e-2, "bf16": 4e-2}
# K5 over cluster sizes and chunks per CTA (ssd_plan): (S, cluster asked;
# None is the planner's own), at zamba2's and mamba2's widths (H, N), b = 2,
# fp32 and bf16.  Plans: 64 → 1 CTA of one chunk; 300 → 2 of three or 5 of
# one; 509 → 2 of four or 3 of three; 512 → 2 of four or 8 of one; 2048 → 8
# of four; 4096 → 8 of eight.  Each case is also held against the kernel's
# own decomposition on the CPU-tested plain ssd_cluster_ref (bf16 with its
# hi/lo pairs, elementwise 4e-2; fp32 within SSD_TOL["fp32"]) and run twice
# for the same bits.
SSD_SWEEP = {"S": ((64, None), (300, None), (300, 5), (509, None), (509, 3), (512, None),
                   (512, 8), (2048, None), (4096, None)),
             "widths": ((80, 64), (24, 128)), "b": 2, "chunk": 256}
HYBRID_ARCH, HYBRID_PARAMS = "zamba2-2.7b", 2_340_750_240
SSM_ARCH, SSM_PARAMS = "mamba2-130m", 128_983_488
STATE_LENS = (512, 509, 384, 300)       # continuous prompts, cycled over 8 requests
STATE_BUDGETS = (16, 24, 32, 20)        # max_new_tokens, cycled over the requests
STATE_WAVE_BUDGET = 32
# the state serve phases' bf16 kernel route against the plain route: each
# route's logits are held by relative L2 against the plain route run in fp32
# on the same weights upcast, and the kernel route may stand at most this much
# further from it than the plain route does.  bf16 rounding alone puts both
# ~4.8e-2 (zamba2-2.7b) and ~2.2e-2 (mamba2-130m) from fp32; on the H100 the
# kernel route stood 1.5e-4 further (zamba2 prefill) and up to 7.6e-4 nearer
# (mamba2), so 2e-3 is ~13x the largest reading.  LOGITS_REL_TOL stays as a
# backstop on the two bf16 routes' direct distance.
STATE_FP32_MARGIN = 2e-3


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


def _port_kernels() -> list:
    """The names of the __global__ functions in the port's CUDA sources."""
    names = []
    for path in sorted(glob.glob(os.path.join(ROOT, "src", "repro_torch", "csrc", "*.cu"))):
        with open(path) as f:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)"
                                r"\s+)?(\w+)\s*\(", f.read())
    return names


def device_busy(torch, fn) -> dict:
    """Run ``fn`` once more under ``torch.profiler`` (CUDA activity) and
    report the union of the device intervals it recorded — kernels and
    copies — against that run's wall time: the card's busy share.  The
    profiled run is not the timed one."""
    from repro_torch.serve.wave_timing import profiled
    events, wall, busy_s = profiled(fn)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    # the port's own kernels (the __global__ functions of csrc/*.cu), by
    # function name: K3's split and combine kernels apart, for instance
    ours: dict = {}
    for name, us in by_name.items():
        m = re.search(r"\b(" + "|".join(_port_kernels()) + r")\b", name)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + us * 1e-6
    return {"profiled_wall_s": wall, "device_events": len(events),
            "device_busy_s": busy_s if events else None,
            "device_busy_share": busy_s / wall if events else None,
            "top_device_s": {name[:60]: us * 1e-6 for name, us in top},
            "port_kernel_s": ours}


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
    hgmma = {name: _build.sass_count(name)
             for name in ("flash_attention", "grouped_matmul", "ssd_scan")}
    emit({"phase": "build", "card": card, "seconds": seconds,
          "library_seconds": {name: r["seconds"] for name, r in report.items()},
          "hgmma_instructions": hgmma,
          "ptxas": {name: _ptxas_by_kernel(_build, r["log"]) for name, r in report.items()}})
    if not all(hgmma.values()):
        fail(f"a tensor-core library holds no HGMMA instruction: {hgmma}")
    return card


def _ptxas_by_kernel(_build, log: str) -> dict:
    """``-Xptxas -v``'s registers and spills, keyed by each kernel's
    demangled name (template arguments kept, parameters dropped)."""
    rows, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif name and re.search(r"registers|spill", ln):
            rows.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    names = list(rows)
    out = subprocess.run([filt, *names], capture_output=True, text=True).stdout.splitlines()
    return {_kernel_name(sn): "; ".join(rows[n])
            for sn, n in zip(out if len(out) == len(names) else names, names)}


def _kernel_name(demangled: str) -> str:
    """``void <unnamed>::wg::k<(int)128>(CUtensorMap_st, ...)`` →
    ``wg::k<128>``: namespaces and casts dropped, the parameters cut at the
    first parenthesis outside the template arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|\((?:int|bool)\)", "",
                  demangled)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def phase_kernels(torch, peaks):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import strip_partition
    from repro_torch.kernels.block_lu import block_lu as k2mod
    from repro_torch.kernels.block_lu.block_lu import bmod_cuda, bmod_path
    from repro_torch.kernels.block_lu.ref import bmod_ref
    from repro_torch.kernels.mandelbrot import mandelbrot as k1mod
    from repro_torch.kernels.mandelbrot.mandelbrot import mandelbrot_rows_cuda
    from repro_torch.kernels.mandelbrot.ref import mandelbrot_rows_ref

    dev = torch.device("cuda", 0)
    k1mod.launches.reset()
    _reset_counts(k2mod)
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
    # 8 separately rounded fp32 operations per escape iteration
    k1_bound, k1_by = bound_ms(peaks, 4 * n + 4 * n * n, 8 * counts, "fp32_unfused")
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
            again = bmod_cuda(a, l, u)
            torch.cuda.synchronize()
            ref = bmod_ref(a, l, u)
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))
            cases.append({"M": M, "N": N, "K": K, "dtype": str(dtype), "path": bmod_path(l, u),
                          "max_abs_err": err, "tolerance": tol,
                          "bitwise_repeat": bool(torch.equal(out, again)),
                          "pass": ok and bool(torch.equal(out, again))})
    k2_check_launches = k2mod.launches.count
    B = LU_B
    a, l, u = (torch.randn(B, B, generator=gen, device=dev) for _ in range(3))
    k2_bound, k2_by = bound_ms(peaks, 4 * 4 * B * B, 2 * B ** 3, "fp32_flops")
    main_case = next(c for c in cases if (c["M"], c["N"], c["K"]) == (B, B, B)
                     and c["dtype"] == "torch.float32")
    k2 = {"name": "bmod", "cases": cases, "shape": [B, B, B], "path": bmod_path(l, u),
          "ctas": ((B + k2mod.TILE - 1) // k2mod.TILE) ** 2,
          "check_launches": k2_check_launches,
          "check_path_launches": _path_counts(k2mod),
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


def _kernel_layout(q, k, v):
    """Model layout (q [B,S,H,d], k/v [B,S,K,d]) → the kernels' (batch·kv
    head, group) layout, as the reference's ``gqa_flash_attention`` does."""
    B, S, H, d = q.shape
    K = k.shape[2]
    return (q.reshape(B, S, K, H // K, d).permute(0, 2, 3, 1, 4).reshape(B * K, H // K, S, d),
            k.permute(0, 2, 1, 3).reshape(B * K, -1, d),
            v.permute(0, 2, 1, 3).reshape(B * K, -1, d))


def _model_layout(o, B: int, K: int):
    BK, r, S, d = o.shape
    return o.reshape(B, K, r, S, d).permute(0, 3, 1, 2, 4).reshape(B, S, K * r, d)


def _k4_timing(torch, peaks, q, k, v, err):
    """K4's time, its plain version's, SDPA's and the bound, on bf16 q, k, v."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, S, H, d = q.shape
    K = k.shape[2]
    qk, kk, vk = _kernel_layout(q, k, v)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    from repro_torch.kernels.flash_attention.flash_attention import attention_path
    pairs = B * H * S * (S + 1) // 2                  # unmasked (query, key) pairs
    bound, by = bound_ms(peaks, 2 * (2 * q.numel() + 2 * k.numel()), 4 * d * pairs,
                         "bf16_flops")
    return {"shape": {"B": B, "Sq": S, "H": H, "K": K, "d": d, "causal": True,
                      "dtype": "bfloat16"},
            "path": attention_path(q, k, v), "max_abs_err": err,
            "ms": time_ms(torch, lambda: gqa_flash_attention(q, k, v, causal=True), 20),
            "plain_ms": time_ms(torch, lambda: flash_attention_ref(qk, kk, vk, causal=True), 3),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), 20),
            "bound_ms": bound, "bound_by": by}


def _k3_timing(torch, peaks, q, kc, vc, lens, err):
    """K3's time, its plain version's, SDPA's (bool mask) and the bound, on
    bf16 q [BK, r, d] and caches [BK, S, d] with per-row ``lens``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.flash_decode import (decode_path, flash_decode_cuda,
                                                               split_plan)
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    BK, r, d = q.shape
    S = kc.shape[1]
    k4d, v4d = kc[:, :, None], vc[:, :, None]
    n_split, rows_per_split = split_plan(BK, S, torch.cuda.get_device_properties(0)
                                         .multi_processor_count)
    rows = sum(min(n, S) if n > 0 else S for n in lens.tolist())   # cache rows needed
    bound, by = bound_ms(peaks, 2 * (2 * rows * d + 2 * q.numel()) + 4 * BK,
                         4 * d * r * rows, "bf16_flops")
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    q4, kl, vl = q[:, :, None], kc[:, None], vc[:, None]
    return {"shape": {"BK": BK, "r": r, "S": S, "d": d, "kv_len": lens.tolist(),
                      "dtype": "bfloat16"},
            "path": decode_path(q, k4d), "n_split": n_split,
            "rows_per_split": rows_per_split, "ctas": BK * n_split, "max_abs_err": err,
            "ms": time_ms(torch, lambda: flash_decode_cuda(q, k4d, v4d, lens), 200),
            # the split rule's neighbours: the same call at other split counts
            "ms_by_n_split": {n: time_ms(torch, lambda: flash_decode_cuda(
                q, k4d, v4d, lens, n_split=n), 200) for n in K3_TIMED_SPLITS},
            "plain_ms": time_ms(torch, lambda: flash_decode_ref(q, kc, vc, lens), 20),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kl, vl, attn_mask=mask, enable_gqa=True), 200),
            "bound_ms": bound, "bound_by": by}


def phase_attention_kernels(torch, peaks):
    """K4 and K3 against their plain versions at the serve paths' shapes
    (minitron-4b: 8 kv heads, r = 3, d = 128; zamba2-2.7b's shared block:
    32 heads, r = 1, d = 80), plus a window, a ragged Sq and d = 256 for K4
    and d = 256 for K3, in fp32 and bf16."""
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_decode.flash_decode import flash_decode_cuda
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def k4_cases(B, K, r, plan):
        cases, main = [], None
        for (Sq, dd, window) in plan:
            for dtype, tol in dtypes:
                q = randn(B, Sq, K * r, dd, dtype=dtype)
                k, v = randn(B, Sq, K, dd, dtype=dtype), randn(B, Sq, K, dd, dtype=dtype)
                out = gqa_flash_attention(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
                ref = _model_layout(flash_attention_ref(*_kernel_layout(q, k, v), causal=True,
                                                        window=window), B, K)
                err = float((out.float() - ref.float()).abs().max())
                cases.append({"Sq": Sq, "d": dd, "window": window, "dtype": str(dtype),
                              "max_abs_err": err, "tolerance": tol,
                              "pass": bool(torch.allclose(out.float(), ref.float(),
                                                          rtol=tol, atol=tol))})
                if (Sq, dd, window, dtype) == (*plan[0], torch.bfloat16):
                    main = (q, k, v, err)
        return cases, main

    def k3_cases(BK, r, S, dims, lens):
        cases, main = [], None
        for dd in dims:
            for dtype, tol in dtypes:
                q = randn(BK, r, dd, dtype=dtype)
                kc, vc = randn(BK, S, dd, dtype=dtype), randn(BK, S, dd, dtype=dtype)
                # the kernel's [BK, S, d] form: K = 1 kv head per row, per-row kv_len
                out = flash_decode_cuda(q, kc[:, :, None], vc[:, :, None], lens)
                torch.cuda.synchronize()
                ref = flash_decode_ref(q, kc, vc, lens)
                err = float((out.float() - ref.float()).abs().max())
                cases.append({"BK": BK, "r": r, "S": S, "d": dd, "dtype": str(dtype),
                              "max_abs_err": err, "tolerance": tol,
                              "pass": bool(torch.allclose(out.float(), ref.float(),
                                                          rtol=tol, atol=tol))})
                if (dd, dtype) == (dims[0], torch.bfloat16):
                    main = (q, kc, vc, err)
        return cases, main

    dtypes = ((torch.float32, 1e-4), (torch.bfloat16, 4e-2))
    B, K, r, S, d = ATTN_MAIN
    cases, (q, k, v, err) = k4_cases(B, K, r, ((S, d, 0), (S, d, 128), (200, d, 0),
                                               (S, 256, 0)))
    k4 = {"name": "flash_attention", **_k4_timing(torch, peaks, q, k, v, err),
          "cases": cases}
    B, K, r, S, d = ATTN_D80
    cases80, (q, k, v, err) = k4_cases(B, K, r, ((S, d, 0),))
    k4["d80"] = {**_k4_timing(torch, peaks, q, k, v, err), "cases": cases80}
    del q, k, v
    k4["wgmma_sweep"] = _k4_sweep(torch, randn)
    k4["pass"] = (all(c["pass"] for c in cases + cases80)
                  and not k4["wgmma_sweep"]["failed"])
    emit({"phase": "kernel_check", **k4})

    BK, r, S, d = DECODE_MAIN
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    cases, (q, kc, vc, err) = k3_cases(BK, r, S, (d, 256), lens)
    k3 = {"name": "flash_decode", **_k3_timing(torch, peaks, q, kc, vc, lens, err),
          "cases": cases}
    BK, r, S, d = DECODE_D80
    # zamba2's decode fills: rows of 4 sequences x 32 heads at spread lengths
    lens80 = torch.tensor([(8 * i + 1) % (S + 1) for i in range(BK)], dtype=torch.int32,
                          device=dev)
    cases80, (q, kc, vc, err) = k3_cases(BK, r, S, (d,), lens80)
    k3["d80"] = {**_k3_timing(torch, peaks, q, kc, vc, lens80, err), "cases": cases80}
    del q, kc, vc
    k3["split_sweep"] = _k3_sweep(torch, randn)
    k3["pass"] = (all(c["pass"] for c in cases + cases80)
                  and not k3["split_sweep"]["failed"])
    emit({"phase": "kernel_check", **k3})
    if not k4["pass"]:
        fail(f"flash_attention kernel disagrees with its plain version: "
             f"{k4['cases'] + k4['d80']['cases']}, sweep failures "
             f"{k4['wgmma_sweep']['failed']}")
    if not k3["pass"]:
        fail(f"flash_decode kernel disagrees with its plain version: "
             f"{k3['cases'] + k3['d80']['cases']}, sweep failures "
             f"{k3['split_sweep']['failed']}")
    if k3["path"] != "split" or k3["n_split"] < 2:
        fail(f"flash_decode at {DECODE_MAIN} runs {k3['n_split']} split(s) on the "
             f"{k3['path']} path; expected more than one split")
    return k4, k3


def _k3_sweep(torch, randn):
    """K3 against its plain version over ``K3_SWEEP``: per-row kv_len on
    each side of every split boundary, 0, 1, S and past S, at split counts
    from one to one per 64-row unit (and the launcher's own), fp32 and bf16;
    each call must take the path its split count names and give the same
    bits twice."""
    import itertools
    from repro_torch.kernels.flash_decode import flash_decode as k3mod
    from repro_torch.kernels.flash_decode.flash_decode import flash_decode_cuda, split_plan
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    S, r = K3_SWEEP["S"], K3_SWEEP["r"]
    failed, worst, n = [], {}, 0
    for d, dtype, n_split in itertools.product(K3_SWEEP["d"], (torch.float32, torch.bfloat16),
                                               K3_SWEEP["n_split"]):
        tol = 1e-4 if dtype == torch.float32 else 4e-2
        # split boundaries as minitron's decode (32 rows) is cut, or as asked
        _, rows = split_plan(32, S, n_sm, n_split)
        lens = sorted({0, 1, S, S + 5, *(x + o for x in range(rows, S, rows) for o in (-1, 0, 1))})
        BK = len(lens)
        q = randn(BK, r, d, dtype=dtype)
        kc, vc = randn(BK, S, d, dtype=dtype), randn(BK, S, d, dtype=dtype)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        n_call, _ = split_plan(BK, S, n_sm, n_split)
        path = "split" if n_call > 1 else "single"
        before = k3mod.path_launches[path].count
        out = flash_decode_cuda(q, kc[:, :, None], vc[:, :, None], kl, n_split=n_split)
        again = flash_decode_cuda(q, kc[:, :, None], vc[:, :, None], kl, n_split=n_split)
        torch.cuda.synchronize()
        took = k3mod.path_launches[path].count - before
        ref = flash_decode_ref(q, kc, vc, kl)
        err = float((out.float() - ref.float()).abs().max())
        key = str(dtype)
        worst[key], n = max(worst.get(key, 0.0), err), n + 1
        if (took != 2 or not torch.equal(out, again)
                or not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)):
            failed.append({"d": d, "dtype": key, "n_split": n_split, "n_split_run": n_call,
                           "path_launches": took, "max_abs_err": err,
                           "bitwise_repeat": bool(torch.equal(out, again))})
    return {"cases": n, "S": S, "r": r, "tolerance": {"torch.float32": 1e-4,
                                                      "torch.bfloat16": 4e-2},
            "max_abs_err": worst, "failed": failed}


def _k4_sweep(torch, randn):
    """K4's tensor-core path (bf16) against its plain version over
    ``K4_SWEEP``, and on q, k, v as strided views of one fused [B, S,
    (H + 2K)·d] projection; each call must take the wgmma path."""
    import itertools
    from repro_torch.kernels.flash_attention import flash_attention as k4mod
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    wg = k4mod.path_launches["wgmma"]
    dt, tol, B, K = torch.bfloat16, 4e-2, 2, 2
    failed, worst, n = [], 0.0, 0

    def check(q, k, v, window, label):
        nonlocal worst, n
        before = wg.count
        out = gqa_flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        took = wg.count - before
        ref = _model_layout(flash_attention_ref(*_kernel_layout(q, k, v), causal=True,
                                                window=window), q.shape[0], k.shape[2])
        err = float((out.float() - ref.float()).abs().max())
        worst, n = max(worst, err), n + 1
        if took != 1 or not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            failed.append({**label, "wgmma_launches": took, "max_abs_err": err})

    for Sq, d, window, r in itertools.product(*K4_SWEEP.values()):
        q = randn(B, Sq, K * r, d, dtype=dt)
        k, v = randn(B, Sq, K, d, dtype=dt), randn(B, Sq, K, d, dtype=dt)
        check(q, k, v, window, {"Sq": Sq, "d": d, "window": window, "r": r})
    for d in (80, 128):                     # fused projection: strided, in place
        S, H = 200, 6
        qkv = randn(B, S, (H + 2 * K) * d, dtype=dt)
        q, k, v = (t.unflatten(-1, (-1, d)) for t in qkv.split([H * d, K * d, K * d], -1))
        check(q, k, v, 0, {"fused_qkv": True, "Sq": S, "d": d, "r": H // K})
    return {"cases": n, "tolerance": tol, "max_abs_err": worst, "failed": failed}


def phase_gmm_kernel(torch, peaks):
    """K6 against its plain version at the MoE serve path's shapes, fp32 and
    bf16, and over ``GMM_CAPACITIES`` with empty experts (each call on the
    path ``gmm_path`` names); its time, the plain version's and
    ``torch.bmm``'s at the three serve shapes (bf16), and at decode with
    ``GMM_OCCUPIED`` of 64 experts holding a token."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul as k6mod
    from repro_torch.kernels.grouped_matmul.grouped_matmul import (grouped_matmul_cuda,
                                                                   gmm_path)
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    _reset_counts(k6mod)
    cases, serve_inputs = [], []

    def check(x, w, label):
        path = gmm_path(x, w)
        before = k6mod.path_launches[path].count
        out = grouped_matmul_cuda(x, w)
        torch.cuda.synchronize()
        took = k6mod.path_launches[path].count - before
        ref = grouped_matmul_ref(x, w)
        rtol, atol = GMM_TOL[str(x.dtype)]
        err = float((out.float() - ref.float()).abs().max())
        cases.append({**label, "dtype": str(x.dtype), "path": path, "max_abs_err": err,
                      "rtol": rtol, "atol": atol,
                      "pass": took == 1 and bool(torch.allclose(out.float(), ref.float(),
                                                                rtol=rtol, atol=atol))})
        return err

    for shape in GMM_SHAPES:
        E, C, D, F = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(E, C, D, generator=gen, device=dev).to(dtype)
            w = torch.randn(E, D, F, generator=gen, device=dev).to(dtype)
            err = check(x, w, {"E": E, "C": C, "D": D, "F": F})
            if dtype == torch.bfloat16 and shape != GMM_SHAPES[-1]:
                serve_inputs.append((shape, x, w, err))
    E, D, F = GMM_SWEEP_SHAPE
    w = torch.randn(E, D, F, generator=gen, device=dev).to(torch.bfloat16)
    for C in GMM_CAPACITIES:
        x = torch.randn(E, C, D, generator=gen, device=dev).to(torch.bfloat16)
        for empty, keep in (("every third", x), ("all", torch.zeros_like(x)),
                            ("all but one", torch.zeros_like(x))):
            xe = keep.clone()
            if empty == "every third":
                xe[::3] = 0
            elif empty == "all but one":
                xe[E // 2] = x[E // 2]
            check(xe, w, {"E": E, "C": C, "D": D, "F": F, "empty_experts": empty})
    check_launches = k6mod.launches.count
    check_paths = _path_counts(k6mod)

    # moonshot's decode at serve occupancy: GMM_OCCUPIED experts hold a row
    (E, C, D, F), x1, w1, _ = serve_inputs[1]
    xo = torch.zeros_like(x1)
    hot = torch.randperm(E, generator=gen, device=dev)[:GMM_OCCUPIED]
    xo[hot] = x1[hot]
    err = check(xo, w1, {"E": E, "C": C, "D": D, "F": F, "occupied_experts": GMM_OCCUPIED})
    serve_inputs.append(((E, C, D, F), xo, w1, err))
    timings = []
    for i, ((E, C, D, F), x, w, err) in enumerate(serve_inputs):
        reps = 50 if C == 1 else 10
        occupied = E if i < len(serve_inputs) - 1 else GMM_OCCUPIED
        # bytes: x and the output once, the weights of the occupied experts
        bound, by = bound_ms(peaks, 2 * (E * C * D + occupied * D * F + E * C * F),
                             2 * occupied * C * D * F, "bf16_flops")
        timings.append({"E": E, "C": C, "D": D, "F": F, "dtype": "bfloat16",
                        "occupied_experts": occupied, "path": gmm_path(x, w),
                        "max_abs_err": err,
                        "ms": time_ms(torch, lambda: grouped_matmul_cuda(x, w), reps),
                        "plain_ms": time_ms(torch, lambda: grouped_matmul_ref(x, w), 3),
                        "library_ms": time_ms(torch, lambda: torch.bmm(x, w), reps),
                        "bound_ms": bound, "bound_by": by})
    del serve_inputs
    torch.cuda.empty_cache()
    main = timings[0]                     # the prefill gate/up projection
    k6 = {"name": "grouped_matmul", "cases": cases, "timings": timings,
          "shape": {k: main[k] for k in ("E", "C", "D", "F", "dtype")},
          "check_launches": check_launches, "check_path_launches": check_paths,
          **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")},
          "pass": all(c["pass"] for c in cases)}
    emit({"phase": "kernel_check", **k6})
    if not k6["pass"]:
        fail(f"grouped_matmul kernel disagrees with its plain version: "
             f"{[c for c in cases if not c['pass']]}")
    return k6


def _reset_counts(*mods) -> None:
    """Set a kernel module's launch count and its per-path counts to 0."""
    for m in mods:
        m.launches.reset()
        for c in getattr(m, "path_launches", {}).values():
            c.reset()


def _path_counts(mod) -> dict:
    return {p: c.count for p, c in mod.path_launches.items()}


def _kernel_counts(mods) -> dict:
    """Each kernel module's launches and launches per path, under the keys
    the serve phases' rows use ("flash_decode_launches", ...)."""
    out = {}
    for m in mods:
        name = m.__name__.rsplit(".", 1)[-1]
        out[f"{name}_launches"] = m.launches.count
        out[f"{name}_paths"] = _path_counts(m)
    return out


def _graph_stats(eng, run: dict) -> None:
    """Add a captured serve's graph count, replays and decode seconds per
    step to its row (each graph's first step ran eagerly as its warm-up)."""
    st = eng.graph_stats
    run.update({"graphs_captured": st["graphs"], "graph_replays": st["replays"],
                "decode_steps": st["decodes"],
                "decode_s_per_step": run["decode_s"] / st["decodes"] if st["decodes"] else None})


def _eager_wave(torch, model, params, reqs, mods, captured: dict, captured_tokens: dict,
                budget: int) -> dict:
    """The wave served once more on the eager route (``eager=True``), its
    launch counts set to 0 just before: its tokens, launch counts per kernel
    and per path, and decode seconds per step beside the captured wave's."""
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(model, params, ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                                                 mode="wave"), eager=True)
    _reset_counts(*mods)
    t0 = time.perf_counter()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts(mods)
    decode_s = sum(r.decode_s for r in res.values())
    tokens = sum(len(r.tokens) for r in res.values())
    return {"wall_s": wall, "tokens_per_s": tokens / wall,
            "prefill_s": sum(r.prefill_s for r in res.values()), "decode_s": decode_s,
            "decode_s_per_step": decode_s / (budget - 1),
            "captured_decode_s_per_step": captured["decode_s_per_step"],
            "tokens_equal_captured": {r.rid: r.tokens for r in res.values()}
            == captured_tokens,
            "counts_equal_captured": counts == {k: captured[k] for k in counts},
            **counts}


def _clone_tree(tree):
    if isinstance(tree, tuple):
        return tuple(_clone_tree(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _copy_tree(dst, src) -> None:
    if isinstance(dst, (tuple, dict)):
        keys = range(len(dst)) if isinstance(dst, tuple) else dst
        for k in keys:
            _copy_tree(dst[k], src[k])
    elif dst is not None:
        dst.copy_(src)


def _captured_vs_eager_logits(torch, model, params, tok, cache, pos: int) -> dict:
    """One decode step from ``cache`` (left as it was), eagerly and as a
    captured graph replayed from the same state: the logits' largest
    difference (0 expected: the same kernels on the same inputs; cuBLAS may
    pick another algorithm inside a capture)."""
    from repro_torch.serve.graph import CapturedStep
    posv = torch.full((tok.shape[0],), pos, dtype=torch.int32, device=tok.device)
    work = _clone_tree(cache)
    eager = model.decode_step(params, tok, work, posv)[0].clone()
    eager_cache = _clone_tree(work)
    _copy_tree(work, cache)
    step = CapturedStep(lambda: model.decode_step(params, tok, work, posv)[0], tok.device)
    step()                                  # the warm-up: a real step on `work`
    _copy_tree(work, cache)
    graph = step()
    torch.cuda.synchronize()
    cache_diff = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(_leaves(work), _leaves(eager_cache)))
    row = {"logits_max_abs_diff": float((graph.float() - eager.float()).abs().max()),
           "cache_max_abs_diff": cache_diff}
    # the replayed step alone: its span on the card (CUDA events around
    # REPLAY_REPS back-to-back replays) and its kernels and their busy time
    # (one profiled replay); the span less the busy time is the card idle
    # between the graph's kernels
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAY_REPS):
        step()
    end.record()
    end.synchronize()
    prof = device_busy(torch, step)
    row.update({"replay_span_ms": start.elapsed_time(end) / REPLAY_REPS,
                "replay_kernels": prof["device_events"],
                "replay_busy_ms": prof["device_busy_s"] * 1e3,
                "replay_top_device_s": prof["top_device_s"]})
    return row


def _fp32_eager_vs_captured(torch, cfg32, params32, reqs_by_mode, max_len: int) -> dict:
    """fp32 greedy tokens of the kernel route, eager against captured, per
    mode (gated: equal)."""
    from repro_torch.models import Model
    from repro_torch.serve import ServeConfig, ServeEngine
    equal = {}
    for mode, rs in reqs_by_mode.items():
        got = {}
        for eager in (True, False):
            eng = ServeEngine(Model(cfg32.replace(use_kernels=True)), params32,
                              ServeConfig(batch=SERVE_BATCH, max_len=max_len, mode=mode),
                              eager=eager)
            got[eager] = {rid: r.tokens for rid, r in eng.serve(rs).items()}
        equal[mode] = got[True] == got[False]
    return equal


def _ssd_inputs(torch, gen, b, S, H, P, G, N, dtype):
    """x, B, C as the Mamba2 mixer hands them to K5: slices of one [b, S,
    H·P + 2·G·N] projection, read in place with its strides; dt =
    softplus(randn), A = -exp(0.3 randn), as the reference's own test
    (tests/test_kernels.py:82-87) draws them."""
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    xbc = torch.randn(b, S, H * P + 2 * G * N, generator=gen, device=dev).to(dtype)
    x, B, C = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    dt = F.softplus(torch.randn(b, S, H, generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device=dev))
    return x.reshape(b, S, H, P), dt, A, B.reshape(b, S, G, N), C.reshape(b, S, G, N)


def _ssd_case(torch, args, chunk: int, cluster=None) -> dict:
    """One K5 call against its plain version (the limits of SSD_TOL) and
    against ssd_cluster_ref, run twice for the same bits."""
    from repro_torch.kernels.ssd_scan import ssd_scan as k5mod
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_cluster_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_path, ssd_plan, ssd_scan_cuda

    x, B = args[0], args[3]
    dtype = x.dtype
    before = _path_counts(k5mod)
    y, h = ssd_scan_cuda(*args, cluster=cluster)
    y2, h2 = ssd_scan_cuda(*args, cluster=cluster)
    torch.cuda.synchronize()
    path = ssd_path(x, B)
    moved = {p: n - before[p] for p, n in _path_counts(k5mod).items()}
    yp, hp = ssd_chunked(*args, chunk=chunk)
    bf16 = dtype == torch.bfloat16
    yc, hc = ssd_cluster_ref(*args, cluster=cluster, split_bf16=bf16)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    b_, S, H, P = x.shape
    case = {"b": b_, "S": S, "H": H, "P": P, "G": B.shape[2], "N": B.shape[3],
            "chunk": chunk, "dtype": str(dtype), "path": path,
            "plan": list(ssd_plan(S, cluster)), "cluster_asked": cluster,
            "max_abs_err": float((y.float() - yp.float()).abs().max()),
            "h_max_abs_err": float((h - hp).abs().max()),
            "y_rel_l2": rel(y, yp), "finite": bool(torch.isfinite(y).all()),
            "cluster_ref_max_abs_err": float((y.float() - yc.float()).abs().max()),
            "cluster_ref_h_max_abs_err": float((h - hc).abs().max()),
            "bitwise_repeat": bool(torch.equal(y, y2) and torch.equal(h, h2))}
    if bf16:
        tol = SSD_TOL["bf16"]
        y32, h32 = ssd_chunked(*(t.float() for t in args), chunk=chunk)
        own = y32.to(dtype).float()
        case["own_max_abs_err"] = float((y.float() - own).abs().max())
        ok = (case["y_rel_l2"] <= SSD_TOL["bf16_rel_l2"]
              and torch.allclose(y.float(), own, rtol=tol, atol=tol)
              and torch.allclose(h, hp, rtol=tol, atol=tol)
              and torch.allclose(h, h32, rtol=tol, atol=tol))
        del y32, h32, own
    else:
        tol = SSD_TOL["fp32"]
        ok = (torch.allclose(y, yp, rtol=tol, atol=tol)
              and torch.allclose(h, hp, rtol=tol, atol=tol))
    ok = ok and torch.allclose(y.float(), yc.float(), rtol=tol, atol=tol) \
        and torch.allclose(h, hc, rtol=tol, atol=tol)
    case["pass"] = bool(ok) and case["finite"] and case["bitwise_repeat"] \
        and moved[path] == 2 and sum(moved.values()) == 2
    return case


def phase_ssd_kernel(torch, peaks):
    """K5 against its plain version at the state serve paths' prefill
    shapes and over SSD_SWEEP, fp32 and bf16, each call also against the
    kernel's own decomposition (ssd_cluster_ref) and repeated for the same
    bits; with its time, the plain version's and its bound at zamba2's and
    mamba2's shapes (bf16).  No single PyTorch call computes the SSD scan,
    so there is no library time."""
    from repro_torch.kernels.ssd_scan import ssd_scan as k5mod
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK, ssd_plan, ssd_scan_cuda

    gen = torch.Generator(device="cuda").manual_seed(3)
    _reset_counts(k5mod)
    cases, timed = [], []
    for shape in SSD_SHAPES:
        b, S, H, P, G, N, chunk = shape
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(torch, gen, b, S, H, P, G, N, dtype)
            cases.append(_ssd_case(torch, args, chunk))
            if dtype == torch.bfloat16 and shape in SSD_SHAPES[:2]:
                timed.append((shape, args, cases[-1]["max_abs_err"], cases[-1]["path"]))
    sweep = []
    for H, N in SSD_SWEEP["widths"]:
        for S, cluster in SSD_SWEEP["S"]:
            for dtype in (torch.float32, torch.bfloat16):
                args = _ssd_inputs(torch, gen, SSD_SWEEP["b"], S, H, 64, 1, N, dtype)
                sweep.append(_ssd_case(torch, args, SSD_SWEEP["chunk"], cluster))
                del args
    torch.cuda.empty_cache()
    check_launches = k5mod.launches.count
    check_paths = _path_counts(k5mod)
    timings = []
    for (b, S, H, P, G, N, chunk), args, err, path in timed:
        es = 2                                       # bf16
        nbytes = (2 * b * S * H * P * es + b * H * N * P * 4 + b * S * H * 4
                  + 2 * b * S * G * N * es + H * 4)
        flops = 0                                    # the kernel's chunking, causal half
        for c0 in range(0, S, CHUNK):
            q = min(CHUNK, S - c0)
            flops += 2 * b * H * (q * (q + 1) // 2 * (N + P) + 2 * q * N * P)
        bound, by = bound_ms(peaks, nbytes, flops, "bf16_flops")
        n_cta, per = ssd_plan(S)
        timings.append({"b": b, "S": S, "H": H, "P": P, "G": G, "N": N, "dtype": "bfloat16",
                        "path": path, "ctas": n_cta * b * H, "cluster": n_cta,
                        "chunks_per_cta": per, "max_abs_err": err, "bytes": nbytes,
                        "flops": flops,
                        "ms": time_ms(torch, lambda: ssd_scan_cuda(*args), 20),
                        "plain_ms": time_ms(torch, lambda: ssd_chunked(*args, chunk=chunk), 2),
                        "library_ms": None, "bound_ms": bound, "bound_by": by})
    del timed
    torch.cuda.empty_cache()
    main = timings[0]                     # zamba2-2.7b's prefill
    k5 = {"name": "ssd_scan", "kernel_chunk": CHUNK, "tolerance": SSD_TOL, "cases": cases,
          "sweep": sweep, "timings": timings, "check_launches": check_launches,
          "check_path_launches": check_paths,
          "shape": {k: main[k] for k in ("b", "S", "H", "P", "G", "N", "dtype")},
          **{k: main[k] for k in ("path", "ctas", "max_abs_err", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by")},
          "pass": all(c["pass"] for c in cases + sweep)}
    emit({"phase": "kernel_check", **k5})
    if not k5["pass"]:
        bad = [c for c in cases + sweep if not c["pass"]]
        fail(f"ssd_scan kernel disagrees with its plain version or its own decomposition, "
             f"or repeats with other bits: {bad}")
    return k5


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


def _sparselu_once(torch, K: int, B: int, n_devices: int, fabric: str = "host-mediated"):
    """One sparselu wavefront on the card against the serial kernel.
    ``fabric``: "host-mediated" (every edge through the host), "direct"
    (``comm_mode="direct"``, every edge device to device) or "direct-2x2"
    (the same under ``Topology.two_tier(2, 2, inter_bw_ratio=0.1)``)."""
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig, Topology
    from repro_torch.kernels.block_lu import block_lu as k2
    mat = bl._matrix(K, B)
    cfg = {"host-mediated": {}, "direct": {"comm_mode": "direct"},
           "direct-2x2": {"comm_mode": "direct",
                          "topology": Topology.two_tier(*FABRIC_TOPO[:2],
                                                        inter_bw_ratio=FABRIC_TOPO[2])}}[fabric]
    peer = fabric != "host-mediated"
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n_devices, **cfg),
                        table=bl._make_table(K), device="cuda")
    try:
        n_tasks = len(bl._build_dag(mat, K, B))
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat, peer=peer)
        wall = time.perf_counter() - t0
        launches = k2.launches.count
        paths = _path_counts(k2)
        s = rt.cost.summary()
        ser = bl.serial(rt, mat)
        busy = device_busy(torch, lambda: bl.wavefront(rt, mat, peer=peer))
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
    row = {"phase": "bots_sparselu", "fabric": fabric, "K": K, "B": B,
           "devices": n_devices, "tasks": n_tasks, "wall_s": wall,
           "bmod_launches": launches, "bmod_path_launches": paths,
           "bmod_expected": expect, "max_abs_diff_vs_serial": diff,
           "residual": residual, "finite": bool(torch.isfinite(lu).all()),
           "modeled_makespan_s": s["makespan_s"], "compute_s": s["compute_s"],
           "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
           "bytes_peer": s["bytes_peer"], "bytes_peer_cross_rack": s["bytes_peer_cross_rack"],
           "profiled": busy}
    emit(row)
    if launches != expect:
        fail(f"bmod launched {launches} times in the wavefront, expected {expect}")
    if paths["cp_async"] != launches:
        fail(f"sparselu K={K} B={B} ({fabric}): bmod launched {paths} by path; expected "
             f"every launch on cp_async")
    if not row["finite"] or diff != 0.0 or residual > 1e-5:
        fail(f"sparselu K={K} B={B} ({fabric}): diff {diff}, residual {residual}")
    return row


def phase_sparselu_fabric(torch, host_row: dict) -> list:
    """The K=16 sparselu wavefront through the peer fabric, flat and on a
    2 x 2 topology, beside the host-mediated run (``host_row``): each equals
    the serial factorization bit for bit (checked per run), fetches the same
    bytes, sends fewer to the devices, and moves its edges peer to peer."""
    rows = [_sparselu_once(torch, LU_K, LU_B, LU_DEVICES, fabric)
            for fabric in ("direct", "direct-2x2")]
    for r in rows:
        if r["bytes_from"] != host_row["bytes_from"]:
            fail(f"sparselu {r['fabric']}: bytes_from {r['bytes_from']} != host-mediated "
                 f"{host_row['bytes_from']}")
        if not (r["bytes_to"] < host_row["bytes_to"] and r["bytes_peer"] > 0):
            fail(f"sparselu {r['fabric']}: bytes_to {r['bytes_to']} (host-mediated "
                 f"{host_row['bytes_to']}), bytes_peer {r['bytes_peer']}")
    if not rows[1]["bytes_peer_cross_rack"] > 0:
        fail(f"sparselu direct-2x2 put no bytes on the spine: {rows[1]}")
    return rows


def phase_dp_fabric(torch, peaks):
    """Data-parallel gradients at an LM projection's size (``mse_grads``,
    d_model 4096: a 64 MiB fp32 weight; batch 64 per device; D = 4) in the
    three fabrics, ``data_parallel_step`` with host-mediated and direct
    syncs, ``hier_allreduce_mean`` on 2 x 2 racks against the serial sum,
    and the block-int8 wire kernel against its plain version on device 0's
    gradient.  The wire kernel's launch count is set to 0 just before the
    ``direct + compress`` run and read just after."""
    from repro_torch import comm_modes as cm
    from repro_torch.core import ClusterRuntime, PeerTransport, RuntimeConfig, Topology
    from repro_torch.core.compression import true_div
    from repro_torch.kernels.q8_wire import q8_wire as kq
    from repro_torch.kernels.q8_wire.q8_wire import q8_roundtrip_cuda
    from repro_torch.kernels.q8_wire.ref import q8_roundtrip_ref

    d, nb, D = DP_D_MODEL, DP_BATCH, DP_DEVICES
    params = cm.make_params(d)
    batches = cm.make_batches(d, nb, D)
    runs, grads = {}, {}
    for mode, compress in (("host-mediated", False), ("direct", False),
                           ("direct+int8", True)):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=D, comm_mode=mode.split("+")[0],
                                          compress=compress),
                            table=cm.make_table(), device="cuda")
        try:
            kq.launches.reset()
            t0 = time.perf_counter()
            g = rt.data_parallel_grads("mse_grads", params, batches)
            wall = time.perf_counter() - t0
            q8 = kq.launches.count
            s = rt.cost.summary()
        finally:
            rt.shutdown()
        grads[mode] = g
        runs[mode] = {"wall_s": wall, "q8_wire_launches": q8,
                      **{k: s[k] for k in ("bytes_to", "bytes_from", "bytes_peer",
                                           "comm_s", "peer_s")}}
    ref = grads["host-mediated"]
    scale = max(float(ref[k].abs().max()) for k in ("w", "b"))
    direct_err = max(float((grads["direct"][k] - ref[k]).abs().max()) for k in ("w", "b"))
    int8_err = max(float((grads["direct+int8"][k] - ref[k]).abs().max()) for k in ("w", "b"))
    direct_ok = all(torch.allclose(grads["direct"][k], ref[k], rtol=1e-5, atol=1e-6)
                    for k in ("w", "b"))
    q8_launches = runs["direct+int8"]["q8_wire_launches"]

    steps = {}
    for mode in ("host-mediated", "direct"):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=D, comm_mode=mode),
                            table=cm.make_table(), device="cuda")
        try:
            t0 = time.perf_counter()
            p = None
            for _ in range(DP_STEPS):
                p = rt.data_parallel_step("mse_grads", params, batches,
                                          sync_every=DP_SYNC)
            wall = time.perf_counter() - t0
            s = rt.cost.summary()
        finally:
            rt.shutdown()
        steps[mode] = (p, {"wall_s": wall, **{k: s[k] for k in ("bytes_to", "bytes_from",
                                                                "bytes_peer")}})
    step_equal = all(torch.equal(steps["host-mediated"][0][k], steps["direct"][0][k])
                     for k in ("w", "b"))
    step_finite = all(bool(torch.isfinite(steps["direct"][0][k]).all()) for k in ("w", "b"))

    topo = Topology.two_tier(*FABRIC_TOPO[:2], inter_bw_ratio=FABRIC_TOPO[2])
    pool, handles, specs, values = cm.collective_pool(topo, HIER_ELEMS, seed=0,
                                                      device="cuda")
    try:
        PeerTransport(topology=topo).hier_allreduce_mean(pool, handles, specs)
        pool.sync()
        means = [pool.transfer_from(i, handles[i][0]) for i in range(topo.n_devices)]
        s = pool.cost.summary()
    finally:
        pool.stop_all()
    serial = values[0][0]
    for v in values[1:]:
        serial = serial + v[0]
    serial = true_div(serial, topo.n_devices)
    hier_equal = all(torch.equal(m, serial) for m in means)

    # the wire kernel on device 0's gradient (the leaf the direct+int8 run
    # quantized), against its plain version on the card and on the CPU
    dev = torch.device("cuda", 0)
    g0 = cm.mse_grads({k: v.to(dev) for k, v in params.items()},
                      {k: v.to(dev) for k, v in batches[0].items()})["grads"]["w"]
    out = q8_roundtrip_cuda(g0)
    torch.cuda.synchronize()
    plain = q8_roundtrip_ref(g0)
    cpu = q8_roundtrip_ref(g0.cpu())
    bitwise = (torch.equal(out.view(torch.int32), plain.view(torch.int32))
               and torch.equal(out.cpu().view(torch.int32), cpu.view(torch.int32)))
    ragged = {}
    flat = g0.reshape(-1)
    for n in Q8_RAGGED:
        x = flat[:n] * 3.0
        ragged[n] = bool(torch.equal(q8_roundtrip_cuda(x).view(torch.int32),
                                     q8_roundtrip_ref(x).view(torch.int32)))
    n = g0.numel()
    # ~9 separately rounded operations a value (abs, max, divide, round,
    # clamp twice, two conversions, multiply); 4 bytes read and 4 written
    q8_bound, q8_by = bound_ms(peaks, 8 * n, 9 * n, "fp32_unfused")
    kq8 = {"name": "q8_wire", "n": n, "block": 256, "bitwise": bool(bitwise),
           "ragged_bitwise": ragged,
           "max_abs_err": float((out - plain).abs().max()),
           "ms": time_ms(torch, lambda: q8_roundtrip_cuda(g0), 50),
           "plain_ms": time_ms(torch, lambda: q8_roundtrip_ref(g0), 10),
           "library_ms": None, "bound_ms": q8_bound, "bound_by": q8_by,
           "pass": bool(bitwise) and all(ragged.values())}
    emit({"phase": "kernel_check", **kq8})
    row = {"phase": "dp_fabric", "d_model": d, "batch": nb, "devices": D,
           "grads": runs, "direct_max_abs_err": direct_err, "direct_allclose": direct_ok,
           "int8_max_abs_err": int8_err, "int8_bound": scale / 64,
           "step": {m: r for m, (_, r) in steps.items()}, "steps": DP_STEPS,
           "sync_every": DP_SYNC, "step_params_bitwise": step_equal,
           "hier_mean": {"elems": HIER_ELEMS, "racks": [list(r) for r in topo.racks],
                         "bitwise_serial": hier_equal, "bytes_peer": s["bytes_peer"],
                         "bytes_peer_cross_rack": s["bytes_peer_cross_rack"]}}
    emit(row)
    if not kq8["pass"]:
        fail(f"q8_wire kernel disagrees with its plain version: {kq8}")
    if not direct_ok:
        fail(f"direct DP gradients differ from host-mediated: {direct_err}")
    if not int8_err <= scale / 64:
        fail(f"int8 DP gradients off by {int8_err}, bound {scale / 64}")
    if q8_launches < 1:
        fail("the direct + compress run never launched the q8_wire kernel")
    if runs["direct"]["bytes_from"] >= runs["host-mediated"]["bytes_from"]:
        fail(f"direct DP fetched no fewer bytes than host-mediated: {runs}")
    if not (step_equal and step_finite):
        fail("data_parallel_step: direct parameters differ from host-mediated")
    if not hier_equal:
        fail("hier_allreduce_mean differs from the serial left-associated mean")
    return kq8, q8_launches


def phase_fib_alignment(torch, peaks):
    """BOTS fib and alignment at the reference's "large" size on
    ``BOTS_DEVICES`` virtual devices, each against its serial run (bit for
    bit); before them the busy-loop kernel (the fib leaf) against its plain
    version at leaf sizes of that run, and its time.  The busy-loop launch
    count is set to 0 just before the offloaded fib and read just after."""
    from repro_torch.bots import alignment as ba
    from repro_torch.bots import fib as bf
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.kernels.busy_loop import busy_loop as kb
    from repro_torch.kernels.busy_loop.busy_loop import fib_subtree_cuda
    from repro_torch.kernels.busy_loop.ref import LANES, busy_iters, fib_f32, fib_subtree_ref

    dev = torch.device("cuda", 0)
    cases = []
    for n in FIB_CHECK_N:
        out, acc = fib_subtree_cuda(torch.tensor(n, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_out, ref_acc = fib_subtree_ref(torch.tensor(n, dtype=torch.int32))
        plain_s = time.perf_counter() - t0
        cases.append({"n": n, "iters": busy_iters(fib_f32(n)), "out": float(out),
                      "max_abs_err": max(float((out.cpu() - ref_out).abs()),
                                         float((acc.cpu() - ref_acc).abs().max())),
                      "bitwise": bool(torch.equal(out.cpu(), ref_out)
                                      and torch.equal(acc.cpu(), ref_acc)),
                      "plain_ms": plain_s * 1e3})
    main = cases[-1]
    n_main = torch.tensor(main["n"], dtype=torch.int32, device=dev)
    # two separately rounded fp32 operations per step and lane; 4 bytes in,
    # 4 + 4 * LANES out
    kb_bound, kb_by = bound_ms(peaks, 4 + 4 + 4 * LANES, 2.0 * LANES * main["iters"],
                               "fp32_unfused")
    n_top = bf.SIZES["large"]
    n_dev = {n: torch.tensor(n, dtype=torch.int32, device=dev) for n in (18, n_top)}
    timed = {n: time_ms(torch, lambda t=t: fib_subtree_cuda(t), 3) for n, t in n_dev.items()}
    kbusy = {"name": "fib_subtree", "cases": cases, "lanes": LANES, "n": main["n"],
             "iters": main["iters"], "max_abs_err": max(c["max_abs_err"] for c in cases),
             "ms": time_ms(torch, lambda: fib_subtree_cuda(n_main), 5),
             "ms_by_n": timed, "plain_ms": main["plain_ms"],
             "plain_device": "cpu (the plain version is a host loop)",
             "library_ms": None, "bound_ms": kb_bound, "bound_by": kb_by,
             "pass": all(c["bitwise"] for c in cases)}
    emit({"phase": "kernel_check", **kbusy})
    if not kbusy["pass"]:
        fail(f"busy-loop kernel disagrees with its plain version: {cases}")

    rows = {}
    rt = ClusterRuntime(RuntimeConfig(n_virtual=BOTS_DEVICES), table=bf._make_table(),
                        device="cuda")
    try:
        kb.launches.reset()
        t0 = time.perf_counter()
        got = bf.offloaded(rt, n_top)
        wall = time.perf_counter() - t0
        launches = kb.launches.count
        s = rt.cost.summary()
        ser = bf.serial(rt, n_top)
        busy = device_busy(torch, lambda: bf.offloaded(rt, n_top))
    finally:
        rt.shutdown()
    rows["fib"] = {"n": n_top, "wall_s": wall, "result": float(got),
                   "equal_serial": bool(torch.equal(got, ser)),
                   "leaf_launches": launches, "bytes_to": s["bytes_to"],
                   "bytes_from": s["bytes_from"], "modeled_makespan_s": s["makespan_s"],
                   "compute_s": s["compute_s"], "profiled": busy}
    fib = [0, 1]
    while len(fib) <= n_top:
        fib.append(fib[-1] + fib[-2])

    m, R = ba.SIZES["large"]
    data = ba._data(m, R)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=BOTS_DEVICES), table=ba._make_table(),
                        device="cuda")
    try:
        t0 = time.perf_counter()
        got = ba.offloaded(rt, *data)
        wall = time.perf_counter() - t0
        s = rt.cost.summary()
        ser = ba.serial(rt, *data)
        busy = device_busy(torch, lambda: ba.offloaded(rt, *data))
    finally:
        rt.shutdown()
    host = ba.align_scores(*data)                 # the same ops on the host
    rows["alignment"] = {"queries": m, "refs": R, "wall_s": wall,
                         "equal_serial": bool(torch.equal(got, ser)),
                         "max_abs_err_vs_host": float((got - host).abs().max()),
                         "tolerance": 2e-5, "finite": bool(torch.isfinite(got).all()),
                         "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
                         "modeled_makespan_s": s["makespan_s"], "compute_s": s["compute_s"],
                         "profiled": busy}
    emit({"phase": "bots_fib_alignment", "devices": BOTS_DEVICES, **rows})
    f, a = rows["fib"], rows["alignment"]
    if not (f["equal_serial"] and f["result"] == fib[n_top]):
        fail(f"fib({n_top}) offloaded {f['result']} vs serial, expected {fib[n_top]}: {f}")
    if launches != BOTS_DEVICES:
        fail(f"fib launched the busy-loop kernel {launches} times, expected one per leaf "
             f"({BOTS_DEVICES})")
    if not (a["equal_serial"] and a["finite"]) or a["max_abs_err_vs_host"] > 2e-5:
        fail(f"alignment strips differ from the serial run or the host's scores: {a}")
    return kbusy, launches


def phase_serve(torch):
    """minitron-4b at full width (bf16, random weights from seed 0) served
    with the kernels: continuous mode, then wave mode, each with the launch
    counts set to 0 just before and read just after; then the kernel route
    against the plain route on the same weights."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4mod
    from repro_torch.kernels.flash_decode import flash_decode as k3mod
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_config(SERVE_ARCH).replace(use_kernels=True)
    L = cfg.n_layers
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).tolist() for _ in range(8)]
    reqs = [Request(i, p, max_new_tokens=SERVE_BUDGETS[i % len(SERVE_BUDGETS)])
            for i, p in enumerate(prompts)]
    wave_reqs = [Request(i, p, max_new_tokens=WAVE_BUDGET) for i, p in enumerate(prompts[:4])]

    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for mode, rs in (("continuous", reqs), ("wave", wave_reqs)):
        eng = ServeEngine(model, params, ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                                                     mode=mode))
        _reset_counts(k4mod, k3mod)
        t0 = time.perf_counter()
        res = eng.serve(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k4n, k3n = k4mod.launches.count, k3mod.launches.count
        tokens = sum(len(r.tokens) for r in res.values())
        runs[mode] = {
            "requests": len(rs), "wall_s": wall, "new_tokens": tokens,
            "tokens_per_s": tokens / wall,
            "prefill_s": sum(r.prefill_s for r in res.values()),
            "decode_s": sum(r.decode_s for r in res.values()),
            "flash_attention_launches": k4n, "flash_decode_launches": k3n,
            "flash_attention_paths": _path_counts(k4mod),
            "flash_decode_paths": _path_counts(k3mod),
            "full_budgets": all(len(res[r.rid].tokens) == r.max_new_tokens
                                and not res[r.rid].timed_out for r in rs)}
        _graph_stats(eng, runs[mode])
        if mode == "wave":
            wave_engine = eng
            wave_tokens = {rid: r.tokens for rid, r in res.items()}
    peak = torch.cuda.max_memory_allocated()
    busy = device_busy(torch, lambda: wave_engine.serve(wave_reqs))
    del wave_engine, eng
    eager_wave = _eager_wave(torch, model, params, wave_reqs, (k4mod, k3mod), runs["wave"],
                             wave_tokens, WAVE_BUDGET)

    # kernel route against plain route on the same weights
    plain = Model(cfg.replace(use_kernels=False))
    batch = {"tokens": torch.tensor(prompts[:4], dtype=torch.int32, device="cuda")}
    lk, ck, pos = model.prefill(params, batch, cache_len=SERVE_MAX_LEN)
    lp, cp, _ = plain.prefill(params, batch, cache_len=SERVE_MAX_LEN)
    tok = torch.argmax(lp[:, -1].float(), dim=-1).to(torch.int32)[:, None]
    graph_vs_eager = _captured_vs_eager_logits(torch, model, params, tok, ck, pos)
    dk, _ = model.decode_step(params, tok, ck, pos)
    dp, _ = plain.decode_step(params, tok, cp, pos)
    del ck, cp

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    route = {"prefill_rel_err": rel(lk, lp), "decode_rel_err": rel(dk, dp),
             "prefill_max_abs_err": float((lk.float() - lp.float()).abs().max()),
             "decode_max_abs_err": float((dk.float() - dp.float()).abs().max()),
             "argmax_agree": float((dk.argmax(-1) == dp.argmax(-1)).float().mean()),
             "tolerance_rel": LOGITS_REL_TOL,
             "finite": bool(torch.isfinite(lk).all() and torch.isfinite(dk).all())}
    del params, model, plain
    torch.cuda.empty_cache()

    # full width, 2 layers, fp32: kernel route tokens == plain route's (wave
    # mode), and the captured route's == the eager route's (both modes)
    cfg2 = get_config(SERVE_ARCH).replace(n_layers=2, param_dtype="float32",
                                          compute_dtype="float32")
    params2 = Model(cfg2).init(torch.Generator("cuda").manual_seed(0))
    small = [Request(i, p[:128], max_new_tokens=16) for i, p in enumerate(prompts[:4])]
    fp32_tokens = {}
    for use in (True, False):
        eng = ServeEngine(Model(cfg2.replace(use_kernels=use)), params2,
                          ServeConfig(batch=4, max_len=256, mode="wave"))
        fp32_tokens[use] = {rid: r.tokens for rid, r in eng.serve(small).items()}
    fp32_graph = _fp32_eager_vs_captured(torch, cfg2, params2, {
        "wave": small, "continuous": _ragged(prompts, 128, 16)}, 256)
    del params2, eng
    torch.cuda.empty_cache()

    card_bytes = torch.cuda.get_device_properties(0).total_memory
    kv_bytes = 2 * L * SERVE_BATCH * SERVE_MAX_LEN * cfg.n_kv * cfg.head_dim * 2
    row = {"phase": "serve", "arch": SERVE_ARCH, "layers": L, "d_model": cfg.d_model,
           "params": n_params, "init_s": init_s, **{m: r for m, r in runs.items()},
           "peak_allocated_bytes": peak, "card_bytes": card_bytes,
           "weights_bytes": 2 * n_params, "kv_cache_bytes": kv_bytes,
           "profiled_wave": busy, "kernel_vs_plain": route, "eager_wave": eager_wave,
           "captured_vs_eager_bf16": graph_vs_eager,
           "fp32_2layer_tokens_equal": fp32_tokens[True] == fp32_tokens[False],
           "fp32_2layer_captured_tokens_equal_eager": fp32_graph}
    emit(row)
    c, w = runs["continuous"], runs["wave"]
    _check_captured(SERVE_ARCH, runs, eager_wave, fp32_graph)
    if not (c["full_budgets"] and w["full_budgets"]):
        fail("a request did not get its full token budget")
    if c["flash_decode_launches"] == 0 or c["flash_decode_launches"] % L:
        fail(f"continuous serve launched flash_decode {c['flash_decode_launches']} times, "
             f"expected a positive multiple of {L}")
    if (w["flash_attention_launches"], w["flash_decode_launches"]) != (L, L * (WAVE_BUDGET - 1)):
        fail(f"wave serve launched K4/K3 {w['flash_attention_launches']}/"
             f"{w['flash_decode_launches']} times, expected {L}/{L * (WAVE_BUDGET - 1)}")
    _check_k4_paths(SERVE_ARCH, runs)
    _check_k3_paths(SERVE_ARCH, runs)
    if not route["finite"] or max(route["prefill_rel_err"],
                                  route["decode_rel_err"]) > LOGITS_REL_TOL:
        fail(f"kernel route disagrees with the plain route: {route}")
    if not row["fp32_2layer_tokens_equal"]:
        fail("fp32 kernel-route tokens differ from the plain route's")
    return runs


def _ragged(prompts, longest: int, budget: int) -> list:
    """Requests of ragged prompts (longest, longest - 16, ...; cycled) for
    the fp32 continuous runs: pad-masked prefills and masked decodes."""
    from repro_torch.serve import Request
    return [Request(i, p[:longest - 16 * (i % 4)], max_new_tokens=budget)
            for i, p in enumerate(prompts)]


def _check_captured(arch: str, runs: dict, eager_wave: dict, fp32_graph: dict) -> None:
    """Every decode of a serve phase after a signature's first replayed a
    graph; the eager wave launched what the captured wave did, per kernel
    and per path; fp32 captured tokens equal the eager route's."""
    for mode, r in runs.items():
        if (not r["graph_replays"]
                or r["decode_steps"] != r["graphs_captured"] + r["graph_replays"]):
            fail(f"{arch} {mode}: {r['decode_steps']} decode steps, {r['graphs_captured']} "
                 f"graphs captured, {r['graph_replays']} replays")
    if not eager_wave["counts_equal_captured"]:
        fail(f"{arch}: the eager wave's launch counts differ from the captured wave's: "
             f"{eager_wave}")
    if not all(fp32_graph.values()):
        fail(f"{arch}: fp32 captured-route tokens differ from the eager route's: {fp32_graph}")


def _check_k4_paths(arch: str, runs: dict) -> None:
    """Every bf16 K4 launch of a serve phase (d = 80 or 128) took the
    tensor-core path."""
    for mode, r in runs.items():
        if r["flash_attention_paths"]["wgmma"] != r["flash_attention_launches"]:
            fail(f"{arch} {mode}: K4 launched {r['flash_attention_launches']} times, "
                 f"{r['flash_attention_paths']} by path; expected every one on wgmma")


def _check_k3_paths(arch: str, runs: dict) -> None:
    """Every K3 launch of a serve phase took the split path (more than one
    split per sequence and kv head)."""
    for mode, r in runs.items():
        if r["flash_decode_paths"]["split"] != r["flash_decode_launches"]:
            fail(f"{arch} {mode}: K3 launched {r['flash_decode_launches']} times, "
                 f"{r['flash_decode_paths']} by path; expected every one on split")


def _check_k5_paths(arch: str, runs: dict) -> None:
    """Every bf16 K5 launch of a serve phase (P = 64) took the tensor-core
    path."""
    for mode, r in runs.items():
        if r["ssd_scan_paths"]["wgmma"] != r["ssd_scan_launches"]:
            fail(f"{arch} {mode}: K5 launched {r['ssd_scan_launches']} times, "
                 f"{r['ssd_scan_paths']} by path; expected every one on wgmma")


def phase_serve_moe(torch):
    """moonshot-v1-16b-a3b at full width and depth (bf16, random weights
    from seed 0) served with the kernels: continuous mode, then wave mode,
    each with the launch counts set to 0 just before and read just after;
    then the kernel route against the plain route."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4mod
    from repro_torch.kernels.flash_decode import flash_decode as k3mod
    from repro_torch.kernels.grouped_matmul import grouped_matmul as k6mod
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import embed_apply, rms_norm
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    mods = (k6mod, k4mod, k3mod)
    cfg = get_config(MOE_ARCH).replace(use_kernels=True)
    L = cfg.n_layers
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).tolist() for _ in range(8)]
    reqs = [Request(i, p, max_new_tokens=MOE_BUDGETS[i % len(MOE_BUDGETS)])
            for i, p in enumerate(prompts)]
    wave_reqs = [Request(i, p, max_new_tokens=MOE_WAVE_BUDGET)
                 for i, p in enumerate(prompts[:4])]

    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for mode, rs in (("continuous", reqs), ("wave", wave_reqs)):
        eng = ServeEngine(model, params, ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                                                     mode=mode))
        _reset_counts(*mods)
        t0 = time.perf_counter()
        res = eng.serve(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k6n, k4n, k3n = (m.launches.count for m in mods)
        tokens = sum(len(r.tokens) for r in res.values())
        runs[mode] = {
            "requests": len(rs), "wall_s": wall, "new_tokens": tokens,
            "tokens_per_s": tokens / wall,
            "prefill_s": sum(r.prefill_s for r in res.values()),
            "decode_s": sum(r.decode_s for r in res.values()),
            "grouped_matmul_launches": k6n, "flash_attention_launches": k4n,
            "flash_decode_launches": k3n, "grouped_matmul_paths": _path_counts(k6mod),
            "flash_attention_paths": _path_counts(k4mod),
            "flash_decode_paths": _path_counts(k3mod),
            "full_budgets": all(len(res[r.rid].tokens) == r.max_new_tokens
                                and not res[r.rid].timed_out for r in rs)}
        _graph_stats(eng, runs[mode])
        if mode == "wave":
            wave_engine = eng
            wave_tokens = {rid: r.tokens for rid, r in res.items()}
    peak = torch.cuda.max_memory_allocated()
    busy = device_busy(torch, lambda: wave_engine.serve(wave_reqs))
    del wave_engine, eng
    eager_wave = _eager_wave(torch, model, params, wave_reqs, mods, runs["wave"], wave_tokens,
                             MOE_WAVE_BUDGET)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    # (a) one MoE layer of the loaded weights, kernel route against plain
    # route, on the prefill batch and on a decode batch
    plain_cfg = cfg.replace(use_kernels=False)
    lp = layer_params(params["layers"], 0)
    batch = {"tokens": torch.tensor(prompts[:4], dtype=torch.int32, device="cuda")}
    x_pre = rms_norm(embed_apply(params["embed"], batch["tokens"]), lp["norm2"], cfg.rms_eps)
    m = cfg.moe
    layer = {}
    for name, x in (("prefill", x_pre), ("decode", x_pre[:, -1:].contiguous())):
        T = x.shape[0] * x.shape[1]
        C = int(np.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
        xt = x.reshape(T, -1)
        _, idx = moe_mod.router_topk(xt.float() @ lp["moe"]["router"].float(), m.top_k)
        _, dk, kk = moe_mod._dispatch(lp["moe"], xt, idx, C, cfg)
        _, dp, kp = moe_mod._dispatch(lp["moe"], xt, idx, C, plain_cfg)
        yk, _ = moe_mod.moe_apply(lp["moe"], x, cfg)
        yp, _ = moe_mod.moe_apply(lp["moe"], x, plain_cfg)
        layer[name] = {"tokens": T, "capacity": C, "kept_share": float(kk.float().mean()),
                       "dest_keep_equal": bool(torch.equal(dk, dp) and torch.equal(kk, kp)),
                       "y_rel_err": rel(yk, yp), "tolerance_rel": MOE_LAYER_REL_TOL,
                       "finite": bool(torch.isfinite(yk).all())}

    # (c) full-depth logits after prefill and one decode, both routes; the
    # top-k expert sets each route chose, recorded from the router
    chosen = []
    real_router = moe_mod.router_topk

    def recording_router(logits, top_k):
        w, idx = real_router(logits, top_k)
        chosen.append(idx.sort(dim=-1).values)
        return w, idx

    plain = Model(plain_cfg)
    moe_mod.router_topk = recording_router
    try:
        pre_k, ck, pos = model.prefill(params, batch, cache_len=SERVE_MAX_LEN)
        sets_pre_k, chosen[:] = list(chosen), []
        pre_p, cp, _ = plain.prefill(params, batch, cache_len=SERVE_MAX_LEN)
        sets_pre_p, chosen[:] = list(chosen), []
        tok = torch.argmax(pre_p[:, -1].float(), dim=-1).to(torch.int32)[:, None]
        graph_vs_eager = _captured_vs_eager_logits(torch, model, params, tok, ck, pos)
        chosen[:] = []
        dec_k, _ = model.decode_step(params, tok, ck, pos)
        sets_dec_k, chosen[:] = list(chosen), []
        dec_p, _ = plain.decode_step(params, tok, cp, pos)
        sets_dec_p, chosen[:] = list(chosen), []
    finally:
        moe_mod.router_topk = real_router
    del ck, cp

    def same_sets(a, b):
        return float(torch.cat([(x == y).all(-1) for x, y in zip(a, b)]).float().mean())

    route = {"prefill_rel_err": rel(pre_k, pre_p), "decode_rel_err": rel(dec_k, dec_p),
             "prefill_argmax_agree": float((pre_k.argmax(-1) == pre_p.argmax(-1))
                                           .float().mean()),
             "decode_argmax_agree": float((dec_k.argmax(-1) == dec_p.argmax(-1))
                                          .float().mean()),
             "prefill_topk_sets_equal_share": same_sets(sets_pre_k, sets_pre_p),
             "decode_topk_sets_equal_share": same_sets(sets_dec_k, sets_dec_p),
             "finite": bool(torch.isfinite(pre_k).all() and torch.isfinite(dec_k).all())}
    del params, model, plain, lp, x_pre, batch
    torch.cuda.empty_cache()

    # (b) full width, 2 layers, fp32, wave mode: kernel route tokens == plain route's
    cfg2 = get_config(MOE_ARCH).replace(n_layers=2, param_dtype="float32",
                                        compute_dtype="float32")
    params2 = Model(cfg2).init(torch.Generator("cuda").manual_seed(0))
    small = [Request(i, p[:128], max_new_tokens=16) for i, p in enumerate(prompts[:4])]
    fp32_tokens = {}
    for use in (True, False):
        eng = ServeEngine(Model(cfg2.replace(use_kernels=use)), params2,
                          ServeConfig(batch=4, max_len=256, mode="wave"))
        fp32_tokens[use] = {rid: r.tokens for rid, r in eng.serve(small).items()}
    fp32_graph = _fp32_eager_vs_captured(torch, cfg2, params2, {
        "wave": small, "continuous": _ragged(prompts, 128, 16)}, 256)
    del params2, eng
    torch.cuda.empty_cache()

    card_bytes = torch.cuda.get_device_properties(0).total_memory
    kv_bytes = 2 * L * SERVE_BATCH * SERVE_MAX_LEN * cfg.n_kv * cfg.head_dim * 2
    row = {"phase": "serve_moe", "arch": MOE_ARCH, "layers": L, "d_model": cfg.d_model,
           "experts": m.n_experts, "top_k": m.top_k, "params": n_params,
           "init_s": init_s, **runs, "peak_allocated_bytes": peak,
           "card_bytes": card_bytes, "weights_bytes": 2 * n_params,
           "kv_cache_bytes": kv_bytes, "profiled_wave": busy,
           "moe_layer_kernel_vs_plain": layer, "kernel_vs_plain": route,
           "eager_wave": eager_wave, "captured_vs_eager_bf16": graph_vs_eager,
           "fp32_2layer_tokens_equal": fp32_tokens[True] == fp32_tokens[False],
           "fp32_2layer_captured_tokens_equal_eager": fp32_graph}
    emit(row)
    c, w = runs["continuous"], runs["wave"]
    _check_captured(MOE_ARCH, runs, eager_wave, fp32_graph)
    if n_params != MOE_PARAMS:
        fail(f"{MOE_ARCH} has {n_params} parameters, expected {MOE_PARAMS}")
    if not (c["full_budgets"] and w["full_budgets"]):
        fail("a MoE request did not get its full token budget")
    per_step = 3 * L
    if c["grouped_matmul_launches"] == 0 or c["grouped_matmul_launches"] % per_step:
        fail(f"continuous MoE serve launched grouped_matmul {c['grouped_matmul_launches']} "
             f"times, expected a positive multiple of {per_step}")
    if c["flash_decode_launches"] == 0 or c["flash_decode_launches"] % L:
        fail(f"continuous MoE serve launched flash_decode {c['flash_decode_launches']} "
             f"times, expected a positive multiple of {L}")
    expect = (per_step * MOE_WAVE_BUDGET, L, L * (MOE_WAVE_BUDGET - 1))
    got = (w["grouped_matmul_launches"], w["flash_attention_launches"],
           w["flash_decode_launches"])
    if got != expect:
        fail(f"wave MoE serve launched K6/K4/K3 {got} times, expected {expect}")
    _check_k4_paths(MOE_ARCH, runs)
    _check_k3_paths(MOE_ARCH, runs)
    # prefill (C = 60 or more) on the tensor cores, decode (C = 1) small-C
    wpaths, cpaths = w["grouped_matmul_paths"], c["grouped_matmul_paths"]
    decodes = per_step * (MOE_WAVE_BUDGET - 1)
    if (wpaths["wgmma"], wpaths["small_c"], wpaths["cuda_core"]) != (per_step, decodes, 0):
        fail(f"wave MoE serve launched K6 by path {wpaths}, expected {per_step} wgmma and "
             f"{decodes} small_c")
    if (cpaths["cuda_core"] or not cpaths["wgmma"] or cpaths["wgmma"] % per_step
            or not cpaths["small_c"] or cpaths["small_c"] % per_step):
        fail(f"continuous MoE serve launched K6 by path {cpaths}, expected positive multiples "
             f"of {per_step} on wgmma (prefills) and small_c (decodes), none on cuda_core")
    for name, r in layer.items():
        if not (r["dest_keep_equal"] and r["finite"]) or r["y_rel_err"] > MOE_LAYER_REL_TOL:
            fail(f"MoE layer ({name}): kernel route disagrees with the plain route: {r}")
    if not route["finite"]:
        fail(f"MoE logits are not finite: {route}")
    if not row["fp32_2layer_tokens_equal"]:
        fail("fp32 MoE kernel-route tokens differ from the plain route's")
    return runs


def phase_serve_state(torch, arch: str, expect_params: int):
    """``arch`` (zamba2-2.7b: hybrid; mamba2-130m: ssm) at full width and
    depth (bf16, random weights from seed 0) served with the kernels:
    continuous mode over ragged prompts (exact-length prefill groups), then
    wave mode, each with the launch counts set to 0 just before and read
    just after; then the kernel route against the plain route (prefill and
    decode logits) and fp32 greedy tokens on both routes (the hybrid: one
    group of 6 layers at full width; the ssm: its full config)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4mod
    from repro_torch.kernels.flash_decode import flash_decode as k3mod
    from repro_torch.kernels.ssd_scan import ssd_scan as k5mod
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    mods = (k5mod, k4mod, k3mod)
    cfg = get_config(arch).replace(use_kernels=True)
    hybrid = cfg.family == "hybrid"
    L = cfg.n_layers
    G = L // cfg.hybrid_group if hybrid else 0       # shared-block runs per pass
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, STATE_LENS[i % len(STATE_LENS)]).tolist()
               for i in range(8)]
    reqs = [Request(i, p, max_new_tokens=STATE_BUDGETS[i % len(STATE_BUDGETS)])
            for i, p in enumerate(prompts)]
    wave_prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).tolist() for _ in range(4)]
    wave_reqs = [Request(i, p, max_new_tokens=STATE_WAVE_BUDGET)
                 for i, p in enumerate(wave_prompts)]

    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for mode, rs in (("continuous", reqs), ("wave", wave_reqs)):
        eng = ServeEngine(model, params, ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                                                     mode=mode))
        _reset_counts(*mods)
        t0 = time.perf_counter()
        res = eng.serve(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5n, k4n, k3n = (m.launches.count for m in mods)
        tokens = sum(len(r.tokens) for r in res.values())
        runs[mode] = {
            "requests": len(rs), "wall_s": wall, "new_tokens": tokens,
            "tokens_per_s": tokens / wall,
            "prefill_s": sum(r.prefill_s for r in res.values()),
            "decode_s": sum(r.decode_s for r in res.values()),
            "ssd_scan_launches": k5n, "flash_attention_launches": k4n,
            "flash_decode_launches": k3n, "flash_attention_paths": _path_counts(k4mod),
            "flash_decode_paths": _path_counts(k3mod), "ssd_scan_paths": _path_counts(k5mod),
            "full_budgets": all(len(res[r.rid].tokens) == r.max_new_tokens
                                and not res[r.rid].timed_out for r in rs)}
        _graph_stats(eng, runs[mode])
        if mode == "wave":
            wave_engine = eng
            wave_tokens = {rid: r.tokens for rid, r in res.items()}
    peak = torch.cuda.max_memory_allocated()
    busy = device_busy(torch, lambda: wave_engine.serve(wave_reqs))
    del wave_engine, eng
    eager_wave = _eager_wave(torch, model, params, wave_reqs, mods, runs["wave"], wave_tokens,
                             STATE_WAVE_BUDGET)

    # kernel route against plain route on the same weights
    plain = Model(cfg.replace(use_kernels=False))
    batch = {"tokens": torch.tensor(wave_prompts, dtype=torch.int32, device="cuda")}
    lk, ck, pos = model.prefill(params, batch, cache_len=SERVE_MAX_LEN)
    lp, cp, _ = plain.prefill(params, batch, cache_len=SERVE_MAX_LEN)
    tok = torch.argmax(lp[:, -1].float(), dim=-1).to(torch.int32)[:, None]
    graph_vs_eager = _captured_vs_eager_logits(torch, model, params, tok, ck, pos)
    dk, _ = model.decode_step(params, tok, ck, pos)
    dp, _ = plain.decode_step(params, tok, cp, pos)
    del ck, cp

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    route = {"prefill_rel_err": rel(lk, lp), "decode_rel_err": rel(dk, dp),
             "prefill_max_abs_err": float((lk.float() - lp.float()).abs().max()),
             "decode_max_abs_err": float((dk.float() - dp.float()).abs().max()),
             "argmax_agree": float((dk.argmax(-1) == dp.argmax(-1)).float().mean()),
             "tolerance_rel": LOGITS_REL_TOL,
             "finite": bool(torch.isfinite(lk).all() and torch.isfinite(dk).all())}
    # each bf16 route against the plain route in fp32 on the same weights
    # upcast (how far bf16 rounding alone carries the logits through this
    # depth); gated by STATE_FP32_MARGIN below
    ref = Model(cfg.replace(param_dtype="float32", compute_dtype="float32",
                            use_kernels=False))
    params32 = _to_float(params)
    l32, c32, _ = ref.prefill(params32, batch, cache_len=SERVE_MAX_LEN)
    d32, _ = ref.decode_step(params32, tok, c32, pos)
    route["vs_fp32_plain"] = {"prefill": {"kernel": rel(lk, l32), "plain": rel(lp, l32)},
                              "decode": {"kernel": rel(dk, d32), "plain": rel(dp, d32)},
                              "margin": STATE_FP32_MARGIN}
    del params, model, plain, params32, c32
    torch.cuda.empty_cache()

    # fp32: kernel route tokens == plain route's, both modes
    cfg32 = get_config(arch).replace(param_dtype="float32", compute_dtype="float32")
    if hybrid:
        cfg32 = cfg32.replace(n_layers=cfg.hybrid_group)
    params32 = Model(cfg32).init(torch.Generator("cuda").manual_seed(0))
    fp32_equal = {}
    reqs16 = {}
    for mode, rs in (("wave", wave_reqs), ("continuous", reqs)):
        reqs16[mode] = rs16 = [Request(r.rid, r.prompt, max_new_tokens=16) for r in rs]
        got = {}
        for use in (True, False):
            eng = ServeEngine(Model(cfg32.replace(use_kernels=use)), params32,
                              ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN, mode=mode))
            got[use] = {rid: r.tokens for rid, r in eng.serve(rs16).items()}
        fp32_equal[mode] = got[True] == got[False]
    fp32_graph = _fp32_eager_vs_captured(torch, cfg32, params32, reqs16, SERVE_MAX_LEN)
    del params32, eng
    torch.cuda.empty_cache()

    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    conv_ch = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    row = {"phase": f"serve_{cfg.family}", "arch": arch, "layers": L,
           "d_model": cfg.d_model, "ssd_heads": H, "d_state": s.d_state,
           "shared_block_runs": G, "params": n_params, "init_s": init_s, **runs,
           "peak_allocated_bytes": peak, "card_bytes": card_bytes,
           "weights_bytes": 2 * n_params,
           "kv_cache_bytes": 2 * G * SERVE_BATCH * SERVE_MAX_LEN * cfg.n_kv * cfg.head_dim * 2
           if hybrid else 0,
           "ssm_state_bytes": L * SERVE_BATCH * H * s.d_state * s.head_dim * 4,
           "conv_state_bytes": L * SERVE_BATCH * (s.d_conv - 1) * conv_ch * 2,
           "profiled_wave": busy, "kernel_vs_plain": route, "eager_wave": eager_wave,
           "captured_vs_eager_bf16": graph_vs_eager,
           "fp32_layers": cfg32.n_layers, "fp32_tokens_equal": fp32_equal,
           "fp32_captured_tokens_equal_eager": fp32_graph}
    emit(row)
    c, w = runs["continuous"], runs["wave"]
    _check_captured(arch, runs, eager_wave, fp32_graph)
    if n_params != expect_params:
        fail(f"{arch} has {n_params} parameters, expected {expect_params}")
    if not (c["full_budgets"] and w["full_budgets"]):
        fail(f"an {arch} request did not get its full token budget")
    prefills = c["ssd_scan_launches"] // L
    if prefills == 0 or c["ssd_scan_launches"] != prefills * L:
        fail(f"continuous {arch} serve launched ssd_scan {c['ssd_scan_launches']} times, "
             f"expected a positive multiple of {L}")
    k3c = c["flash_decode_launches"]
    if c["flash_attention_launches"] != prefills * G or (
            (k3c == 0 or k3c % G) if hybrid else k3c):
        fail(f"continuous {arch} serve launched K4/K3 {c['flash_attention_launches']}/{k3c} "
             f"times over {prefills} prefills, expected {G} per prefill and a "
             f"{'positive ' if hybrid else ''}multiple of {G} in decode")
    expect = (L, G, G * (STATE_WAVE_BUDGET - 1))
    got = (w["ssd_scan_launches"], w["flash_attention_launches"], w["flash_decode_launches"])
    if got != expect:
        fail(f"wave {arch} serve launched K5/K4/K3 {got} times, expected {expect}")
    _check_k4_paths(arch, runs)
    _check_k3_paths(arch, runs)
    _check_k5_paths(arch, runs)
    if not route["finite"] or max(route["prefill_rel_err"],
                                  route["decode_rel_err"]) > LOGITS_REL_TOL:
        fail(f"{arch}: kernel route disagrees with the plain route: {route}")
    far = route["vs_fp32_plain"]
    if any(far[p]["kernel"] - far[p]["plain"] > STATE_FP32_MARGIN for p in ("prefill", "decode")):
        fail(f"{arch}: kernel route stands more than {STATE_FP32_MARGIN} further from the "
             f"fp32 plain route than the bf16 plain route does: {far}")
    if not all(fp32_equal.values()):
        fail(f"{arch}: fp32 kernel-route tokens differ from the plain route's: {fp32_equal}")
    return runs


def _to_float(tree):
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    return tree.float()


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [] if tree is None else [tree]


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
    k4, k3 = phase_attention_kernels(torch, peaks)
    k6 = phase_gmm_kernel(torch, peaks)
    k5 = phase_ssd_kernel(torch, peaks)
    phase_listings(torch)
    k1_launches = phase_mandelbrot(torch)
    lu_rows = [_sparselu_once(torch, LU_K, LU_B, LU_DEVICES)]
    _sparselu_once(torch, *LU_LARGE, LU_DEVICES)
    lu_rows += phase_sparselu_fabric(torch, lu_rows[0])
    k2_launches = sum(r["bmod_launches"] for r in lu_rows)
    k2_paths = {p: sum(r["bmod_path_launches"][p] for r in lu_rows)
                for p in lu_rows[0]["bmod_path_launches"]}
    kq8, kq8_launches = phase_dp_fabric(torch, peaks)
    kbusy, kbusy_launches = phase_fib_alignment(torch, peaks)
    serve_runs = [*phase_serve(torch).values(), *phase_serve_moe(torch).values()]
    for arch, n in ((HYBRID_ARCH, HYBRID_PARAMS), (SSM_ARCH, SSM_PARAMS)):
        serve_runs += phase_serve_state(torch, arch, n).values()

    def served(kernel):
        """A kernel's launches over every serve run, and per path."""
        paths: dict = {}
        for r in serve_runs:
            for p, n in r.get(f"{kernel}_paths", {}).items():
                paths[p] = paths.get(p, 0) + n
        return sum(r.get(f"{kernel}_launches", 0) for r in serve_runs), paths
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": card, "peaks": peaks})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path_launches")
    rows = [
        {**k1, "route": "cuda", "source": "src/repro_torch/csrc/mandelbrot.cu",
         "replaces": "src/repro/kernels/mandelbrot/mandelbrot.py:18",
         "launches": k1_launches},
        {**k2, "route": "cuda", "source": "src/repro_torch/csrc/block_lu.cu",
         "replaces": "src/repro/kernels/block_lu/block_lu.py:21",
         "launches": k2_launches, "path_launches": k2_paths},
        {**k3, "route": "cuda", "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/flash_decode.py:30",
         "launches": served("flash_decode")[0],
         "path_launches": served("flash_decode")[1]},
        {**k4, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
         "launches": served("flash_attention")[0],
         "path_launches": served("flash_attention")[1]},
        {**k5, "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:26",
         "launches": served("ssd_scan")[0], "path_launches": served("ssd_scan")[1]},
        {**k6, "route": "cuda", "source": "src/repro_torch/csrc/grouped_matmul.cu",
         "replaces": "src/repro/kernels/grouped_matmul/grouped_matmul.py:20",
         "launches": served("grouped_matmul")[0],
         "path_launches": served("grouped_matmul")[1]},
        # a port-only kernel: the reference's busy loop is XLA's fori_loop
        {**kbusy, "route": "cuda", "source": "src/repro_torch/csrc/busy_loop.cu",
         "replaces": "benchmarks/bots_fib.py:44", "launches": kbusy_launches},
        # a port-only kernel: the reference's wire round trip is an XLA fusion
        {**kq8, "route": "cuda", "source": "src/repro_torch/csrc/q8_wire.cu",
         "replaces": "src/repro/core/compression.py:34", "launches": kq8_launches},
    ]
    emit({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
