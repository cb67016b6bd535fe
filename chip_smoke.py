#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root on a machine with an NVIDIA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc/*.cu``
(one ``nvcc`` per source, all started together, into ``build/kernels/``) and
runs, printing one JSON line per phase:

1. the card's name and power limit (``nvidia-smi``), the build (each
   library's own nvcc seconds), ``-Xptxas -v``'s registers and spills per
   kernel, the count of HGMMA (``wgmma``) instructions in the
   tensor-core libraries (none fails), and the instructions of the
   mandelbrot kernel's loops (``cuobjdump -sass``);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its time, the plain version's time and, where one
   PyTorch call computes the same function, that call's (``torch.addmm``
   for bmod, ``scaled_dot_product_attention`` for the attention kernels):
   mandelbrot (bit for bit over the whole image and ``K1_RAGGED``'s
   cases) and bmod,
   then flash attention (4 sequences x 24 heads over
   8 kv heads, 512 causal rows, d = 128; also a window, a ragged Sq and
   d = 256; its tensor-core path in bf16 over ``K4_SWEEP`` and on a fused
   projection's strided views) and flash decode (32 kv rows x 3 query heads
   over a 1024-row cache with per-row kv_len from 0 to 1024; also d = 256;
   its split-KV path over ``K3_SWEEP``'s kv_len edges and split counts),
   fp32 and bf16, and both at zamba2-2.7b's shared-block shapes (32 heads
   of d = 80, timed beside SDPA too); bmod and flash decode report their
   path and their CTAs (flash decode: its split count), and each check
   call of either is repeated and must give the same bits;
3. the paper's Listings 1–2 on 8 virtual devices, and regions that bind
   a declare-target global (``install_global``, ``use_globals``) on each
   of them, equal to the same run on the CPU;
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
   and its time; then placement: K=16 over the peer fabric under
   locality, HEFT (frozen at 5 us and 100 us, and on the card's own EXEC
   seconds) and SLO, each equal to the serial kernel bit for bit with every
   bmod on ``cp_async`` and the round-robin run's ``bytes_from``; HEFT at
   5 us again with each device's present table capped at 64 blocks (LRU
   spill and refetch), bit-identical to the uncapped run; and mandelbrot
   strips under locality and HEFT, the round-robin image and bytes with 8
   K1 launches; then fault recovery under seeded faults
   (``repro_torch.ft.inject_flaky``): K=16 over the peer fabric with every
   eligible op failing at p = 0.05 under round-robin, locality and HEFT at
   5 us, each equal to its fault-free run bit for bit, and host-mediated
   with EXEC faults, equal to the serial kernel; K=5 with every SEND
   failing (the funnel carries each edge); mandelbrot with one dead device,
   each strip through ``with_retry`` (8 K1 launches, the serial image);
   the DP fabric with transport retries under SEND/RECV faults at p = 0.2
   (the steps' parameters bit for bit the host-mediated run's) and the
   2 x 2 mean with a dead rack leader; then stragglers: K=16 host-mediated
   and over the peer fabric with device 0 stalling a quarter of its EXECs
   for 50 ms, once without and once with a ``StragglerDetector`` (hedged
   duplicates; every loser's records struck), K=16 host-mediated under a
   0.25 s command deadline with 0.5 s EXEC hangs at p = 0.01, K=5 over the
   peer fabric with 0.2 s SEND hangs at p = 0.2 under a 0.05 s transport op
   timeout, and mandelbrot 4600² at D=8 with device 3 stalling every EXEC
   for 0.2 s, with and without ``offload_strips(speculate=True)``: each
   equal to the serial run bit for bit; then checkpoints and elasticity:
   K=16 over the peer fabric checkpointed every wave and halted after 23 of
   46 waves, resumed in a fresh interpreter (``repro_torch.resume_smoke``;
   exactly the 268 EXECs left), the same halt host-mediated resumed in this
   process, a shrink from 4 to 2 devices that drains two 64 MiB weights
   updated on the departing devices (``rescale_pool``) followed by K=16 on
   the survivors, K=16 grown from 2 to 4 devices mid-graph, and mandelbrot
   strips on a pool shrunk from 8 to 4 and grown back: each equal to the
   serial run bit for bit; then calibration: K=16's four kernels timed on a
   D=4 peer runtime (``ClusterRuntime.calibrate``; each seed on the busy
   clock of an EXEC, beside bmod's CUDA-event time) and its funnel and peer
   links fitted, the profile saved, reloaded by a fresh runtime (a D=2
   profile refused as stale) and K=16 run under
   ``HeftPlacement(estimates="calibrated")``, equal to the serial kernel bit
   for bit; then the calibration acceptance gate
   (``repro_torch.perf_gate``: K=4 sparselu, D=4, peer-routed, HEFT on its
   frozen defaults against HEFT on a synthetic true host's profile, both
   bit for bit, re-priced at the true costs); then BOTS fib(21)
   (``recursive_offload``, one
   busy-loop kernel launch per leaf) and alignment (128 queries x 32
   references, the bank resident, query strips) on 8 virtual devices, each
   equal to its serial run bit for bit, after the busy-loop kernel against
   its plain version (a host loop) at fib(8) and fib(15); then the paper's
   §5 claims (``repro_torch.run``): every BOTS curve at the reference's
   sizes over D = 1, 2, 4, 8 with the reference's byte columns, and
   mandelbrot 4600² and sparselu K=16 over the same counts, each claim
   reported held or failed; then training on the plain route (the kernels
   have no backward; the ``train`` row, ``phase_train``): mamba2-130m at
   its full config through ``repro_torch.launch.train`` (30 steps, batch
   8 x 256, async checkpoints), a SIGTERM'd trainer child resumed in a
   fresh interpreter against an uninterrupted one (losses and final state
   bit for bit), microbatches 1 and 2 in fp32, the model as the runtime's
   D=4 data-parallel trainer in both fabrics with the CPU's byte counters,
   and K3-K6's wrappers refusing a gradient;
6. LM serving: minitron-4b at full width (32 layers, d_model 3072, bf16,
   random weights from seed 0) with the kernels on: 8 requests of 512
   tokens in continuous mode, then 4 in wave mode (one unpadded prefill:
   flash attention on each layer; 31 decodes: flash decode on each layer);
   then the kernel route against the plain route on the same weights
   (prefill and decode logits), and a 2-layer fp32 model at full width
   whose greedy tokens must be equal on both routes; then pool-mode serving
   (``ServeEngine(runtime=...)``) of the same weights on 2 virtual devices:
   8 requests under SLO, under round-robin, and under round-robin with each
   device's capacity at the weights + 1.5 caches (spill and refetch), then
   4 with ``migrate_every=1`` (a cache migrates), each request a prefill
   TaskNode (K4) and a decode TaskNode a step (K3) at B = 1 on a device's
   worker thread, every run's tokens equal to the local engine's at
   ``batch=1`` (wave mode, eager) bit for bit; then open-loop Poisson load
   (``repro_torch.serve_load``, the reference's traces and 64-token cache):
   continuous against waves in fp32 (tokens identical) and bf16, and SLO
   against round-robin on a capped D=2 pool in bf16 (tokens identical);
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
   greedy tokens equal on both routes;
9. the last modules: ``repro_torch.launch.serve``'s CLI at minitron-4b's
   full width (after the serve phase; its tokens equal to a ``ServeEngine``
   driven directly, bit for bit) and ``repro_torch.examples.offload_serve``
   on a 2-device pool at full width (the ``launch_serve`` row); after the
   state phases, the perf gate's trajectory half on the card
   (``comm_modes --smoke``, ``sched_policies`` and ``topo_collectives
   --smoke`` as children, each against its committed ``BENCH_*.json``
   within 15%, and the serve_load sections against ``BENCH_serve.json``;
   every K2 of the children on ``cp_async``), ``repro_torch.kernels_bench``
   in a child (K4's and K5's timed rows, the tensor-core kernels' resources
   at their served launches), the dry run over every (architecture × shape)
   cell on ``meta`` with ``memory_allocated`` unchanged and the roofline
   table rendered, and each served config's decode step and the trainer's step beside
   ``launch.hlo_analysis.analyze_step``'s bound (the ``roofline_shares``
   row: reported).

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

Every kernel's launch count, and K1's, K2's, K3's, K4's and K6's counts per
path, are set to 0 just before a main-path phase and read just after; a
kernel of the path that did not launch fails the run, and so does a
mandelbrot K1 launch off the ``chunked`` path, a sparselu K2 launch off the
``cp_async`` path (re-executions under faults, the resumed child's and
the calibration's timed launches included), a serve K3 launch off the
``split`` path (pool-mode decodes included; ``serve_load``'s 64-row caches
are one split unit, and its launches must take ``single``), a bf16
K4 launch off the ``wgmma`` path, an MoE prefill K6 launch off ``wgmma`` or a
decode K6 launch off ``small_c``.
Then it prints the ``{"kernels": [...]}`` line (times, bounds, launches) and,
last, ``{"ok": true, "device": {...}}``.  It exits non-zero at the first
failed phase, and when no card is present.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import glob
import io
import json
import math
import os
import re
import shutil
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
# rounds once where the reference rounds twice and flips boundary pixels),
# and needs 7 such operations per counted iteration: two squares and z^2 + c
# (5), with the escape sum tested once a chunk of iterations, not each one.
PEAKS = {
    "sxm": {"fp32_flops": 67e12, "fp32_unfused": 33.5e12, "bf16_flops": 989e12,
            "hbm_Bps": 3.35e12},
    "pcie": {"fp32_flops": 51e12, "fp32_unfused": 25.5e12, "bf16_flops": 756e12,
             "hbm_Bps": 2.0e12},
}

MANDEL_SIZE, MANDEL_ITER, MANDEL_DEVICES = 4600, 300, 8
# K1's ragged cases, against the plain version bit for bit: rows (strips
# that start mid-image; the second is the band around cy = 0 of the main
# image, where c passes -2 on its left edge), width (not a multiple of 32)
# and the image's height; max_iter 0, 1, around the chunk and off 300
K1_RAGGED = (((21, 58), 97, 80), ((2290, 2311), 4600, 4600))
K1_RAGGED_ITERS = (0, 1, 299, 301)      # and CHUNK - 1, CHUNK, CHUNK + 1
LU_K, LU_B, LU_DEVICES = 16, 128, 4
# the placement phase: each device's present table capped at this many
# 128 x 128 fp32 blocks (HEFT comm-bound packs the whole factorization, 1,496
# resident task outputs, onto one virtual device)
CAP_BLOCKS = 64
# rerun under torch.profiler: HEFT comm-bound, and locality, which packs the
# whole factorization onto one virtual device (HEFT at 5 us spreads at K=16:
# a device's modeled clock passes a 64 KiB edge's 0.57 ms within one wave)
PROFILED_POLICIES = ("locality", "heft-comm")
LU_LARGE = (5, 96)                      # the reference's "large" size
# the fabric: racks, devices per rack, spine bandwidth / rack bandwidth
FABRIC_TOPO = (2, 2, 0.1)
# data-parallel gradients at an LM projection's size (benchmarks/comm_modes.py's
# mse_grads at d_model 4096: a 64 MiB fp32 weight), batch 64 per device
DP_D_MODEL, DP_BATCH, DP_DEVICES, DP_STEPS, DP_SYNC = 4096, 64, 4, 8, 4
HIER_ELEMS = 1 << 22                    # per-device vector of the 2 x 2 mean
# fault recovery: seeded faults from repro_torch.ft.inject_flaky
FAULT_SEED = 1234
FAULT_P = 0.05                          # chaos sparselu, every eligible op
FAULT_RETRIES = 30                      # run_graph(max_retries=...) under chaos
FAULT_POLICIES = ("round-robin", "locality", "heft-comm")
DEAD_DEVICE = 2                         # mandelbrot: fails every EXEC
DP_FAULT_P = 0.2                        # DP fabric: SEND/RECV faults
# stragglers (repro_torch.ft, seed FAULT_SEED): an intermittently slow
# device under hedging, hung EXECs under a command deadline, hung SENDs
# under a transport op timeout, and a slow mandelbrot device under
# speculative strips
SLOW_DEVICE, SLOW_P, SLOW_S = 0, 0.25, 0.05
HEDGE = {"k": 3.0, "grace_s": 0.02, "poll_s": 0.005, "max_hedges": 512}
DEADLINE_S, HANG_P, HANG_S = 0.25, 0.01, 0.5
OP_TIMEOUT_S, SEND_HANG_P, SEND_HANG_S = 0.05, 0.2, 0.2
SPEC_DEVICE, SPEC_SLOW_S = 3, 0.2
# every per-device list of a DevicePool: a rescale keeps each one len(pool) long
POOL_LISTS = ("devices", "mirrors", "locks", "present", "env_locks", "_queues",
              "_stopped", "_async_errors", "_last_write", "_readers", "_outstanding",
              "stream_traces", "_workers")
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
# pool-mode serving (serve_pool): minitron-4b on this many virtual devices,
# budgets cycled over the 8 requests; the migration run's (prompt, budget)
# pairs, in admission order: round-robin puts both long ones on device 0,
# and each prompt's local budget (POOL_BUDGETS) covers its budget here.
# Short budgets keep the phase's six runs within the script's time beside
# serve_load's pool runs
POOL_DEVICES = 2
POOL_BUDGETS = (4, 8, 12, 16)
POOL_MIGRATION = ((3, 16), (0, 4), (7, 16), (4, 4))
# calibration: reps and warm-ups of each kernel's timed call
CALIB_REPS, CALIB_WARMUP = 5, 2
# the paper's §5 claims (repro_torch.run): every curve at the reference's
# sizes over CLAIM_DEVICES, and each curve's (bytes_to, bytes_from) per device
# count: the port's CPU run, equal to the reference's live curves
# (tests/test_torch_run.py); fib sends one 4-byte int to each leaf and gets
# one back, mandelbrot large 832 row ids out and 832 x 832 int32 counts back
CLAIM_DEVICES = (1, 2, 4, 8)
CLAIM_BYTES = {
    ("alignment", "small"): [(8192, 2048)] * 4,
    ("alignment", "large"): [(32768, 16384)] * 4,
    ("mandelbrot", "small"): [(1664, 692224)] * 4,
    ("mandelbrot", "large"): [(3328, 2768896)] * 4,
    ("fib", "small"): [(4 * d, 4 * d) for d in CLAIM_DEVICES],
    ("fib", "large"): [(4 * d, 4 * d) for d in CLAIM_DEVICES],
    ("sparselu", "small"): [(b, 491520) for b in (999424, 1015808, 1114112, 1146880)],
    ("sparselu", "large"): [(b, 2027520) for b in (4386816, 4460544, 4313088, 4681728)],
}
# the paper-scale sweep, one run a point: (workload, size, warm-up run);
# each stands in for the claims' "large" curve.  K=16 runs without a warm-up
# (its kernels are warm from the sparselu phases; ~6 s a run)
PAPER_CURVES = (("mandelbrot", MANDEL_SIZE, True), ("sparselu", (LU_K, LU_B), False))
PAPER_DEVICES = (2, 4, 8)               # the device counts the claims read
# the calibration gate (repro_torch.perf_gate): K=4 sparselu's bmods in each
# of its two arms, and the true makespans of the port's CPU run (frozen,
# calibrated; equal to the reference's)
GATE_BMODS = 2 * sum(m * m for m in range(4))
GATE_CPU_MAKESPANS = (0.022847664, 0.0031094720000000003)
# open-loop serving (repro_torch.serve_load) at SERVE_ARCH's full width on
# the reference's traces and cache: (requests, tokens) of section 1 (n = 16)
# and section 2 (n = 30), and section 2's repetitions
LOAD_COUNTS = {"continuous_vs_wave": (16, 183), "slo_vs_roundrobin": (30, 655)}
LOAD_REPS = 1
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
# the train phase: mamba2-130m at its full config through the trainer
# (``repro_torch.launch.train``), the reference's ``--full-130m`` example run
TRAIN_ARCH = "mamba2-130m"
TRAIN_ARGS = ("--arch", TRAIN_ARCH, "--preset", "full", "--global-batch", "8",
              "--seq", "256", "--lr", "3e-4", "--warmup", "10", "--save-every", "10",
              "--log-every", "1", "--device", "cuda")
TRAIN_STEPS, RESUME_STEPS, PREEMPT_AFTER = 30, 20, 10
TRAIN_TIMED = (5, 30)                   # ms/step: the median over these steps
TRAIN_PROFILED_STEPS = 3                # the busy share: steps under torch.profiler
MICRO_RTOL, MICRO_PARAM_ATOL = 1e-5, 5e-5   # tests/test_train.py:87-89
TRAIN_DP_DEVICES, TRAIN_DP_SEQS, TRAIN_DP_STEPS, TRAIN_DP_LR = 4, 2, 6, 3e-3
TRAIN_CHILD_TIMEOUT = 240
#: the card's allocated bytes around each release_card_memory call
CARD_MEMORY: list = []


T_START = time.perf_counter()


def release_card_memory(torch, label: str = "") -> None:
    """Free what finished phases left on the card: collected garbage, the
    cuBLAS workspaces (32 MiB each) PyTorch keeps for every (handle, stream)
    pair a matmul or solve ran on, and the allocator's free segments.
    Called between phases, when no other thread works on the card.  The
    allocated bytes just before and just after the workspaces are cleared
    go into ``CARD_MEMORY``: the virtual devices' workers keep their (handle,
    stream) pairs from runtime to runtime, so the bytes before a clear no
    longer grow with the runtimes a phase made."""
    gc.collect()
    before = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    CARD_MEMORY.append({"before": label, "allocated_before_clear": before,
                        "cleared_bytes": before - torch.cuda.memory_allocated()})
    torch.cuda.empty_cache()


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase row also gets ``t_s``, the
    script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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
    BUILD_REPORT.update(report)
    hgmma = {name: _build.sass_count(name)
             for name in ("flash_attention", "grouped_matmul", "ssd_scan")}
    emit({"phase": "build", "card": card, "seconds": seconds,
          "library_seconds": {name: r["seconds"] for name, r in report.items()},
          "hgmma_instructions": hgmma, "k1_sass_loops": _k1_sass_loops(_build),
          "ptxas": {name: _build.ptxas_by_kernel(r["log"], _build.nvcc())
                    for name, r in report.items()}})
    if not all(hgmma.values()):
        fail(f"a tensor-core library holds no HGMMA instruction: {hgmma}")
    return card


def _k1_sass_loops(_build) -> dict:
    """K1's loops in its SASS: each backward branch's instructions and
    FMUL / FADD / FSETP / BRA counts.  ``chunk`` is the loop with the most
    FMULs (7 operations an iteration, the escape sum once a chunk, per
    ``chunk_per_iteration``); ``exact`` is the per-iteration loop, one test
    an iteration, the kernel's whole loop before it was chunked (now the
    ``max_iter mod CHUNK`` iterations and the replay of an escaped chunk)."""
    from repro_torch.kernels.mandelbrot.mandelbrot import CHUNK
    keep = ("instructions", "FMUL", "FADD", "FSETP", "BRA")
    loops = [{k: loop.get(k, 0) for k in keep} for loop in _build.sass_loops(
        _build.sass(_build.lib_path("mandelbrot")), "mandelbrot_rows_kernel")]
    chunk = max(loops, key=lambda loop: loop["FMUL"], default=None)
    return {"chunk": chunk, "chunk_iterations": CHUNK,
            "chunk_per_iteration": chunk and {k: chunk[k] / CHUNK for k in keep},
            "exact": [loop for loop in loops if loop is not chunk]}


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
    _reset_counts(k1mod, k2mod)
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
    ragged = _k1_ragged(torch, dev, k1mod, mandelbrot_rows_cuda, mandelbrot_rows_ref)
    k1_check_launches = k1mod.launches.count
    k1_check_paths = _path_counts(k1mod)
    counts = float(img.to(torch.int64).sum())
    # 7 separately rounded fp32 operations per counted iteration: the escape
    # sum zx^2 + zy^2 is only needed for the test, which runs once a chunk,
    # so it is amortised and 7 (two squares, z^2 + c) is the least work
    k1_bound, k1_by = bound_ms(peaks, 4 * n + 4 * n * n, 7 * counts, "fp32_unfused")
    k1 = {"name": "mandelbrot_rows", "shape": [n, n], "max_iter": MANDEL_ITER,
          "path": "chunked", "chunk": k1mod.CHUNK,
          "mismatch_share": mismatch, "tolerance": 0,
          "max_abs_err": k1_err, "strips_tile_image": strips_equal,
          "ragged": ragged,
          "sum_counts": counts, "check_launches": k1_check_launches,
          "check_path_launches": k1_check_paths,
          "ms": time_ms(torch, lambda: mandelbrot_rows_cuda(rows, n, n, MANDEL_ITER), 20),
          "plain_ms": time_ms(torch, lambda: mandelbrot_rows_ref(rows, n, n, MANDEL_ITER), 2),
          "library_ms": None, "bound_ms": k1_bound, "bound_by": k1_by}
    # exact: the counts are integers computed by the same fp32 operations
    k1["pass"] = (mismatch == 0 and k1_err == 0 and strips_equal
                  and not ragged["failed"]
                  and k1_check_paths == {"chunked": k1_check_launches})
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


def _k1_ragged(torch, dev, k1mod, kernel, ref) -> dict:
    """``K1_RAGGED`` x (``K1_RAGGED_ITERS`` and the chunk's neighbours)
    against the plain version bit for bit, each run twice for the same
    bits."""
    k = k1mod.CHUNK
    failed, n_cases = [], 0
    for (r0, r1), width, total in K1_RAGGED:
        rows = torch.arange(r0, r1, dtype=torch.int32, device=dev)
        for max_iter in sorted({*K1_RAGGED_ITERS, k - 1, k, k + 1}):
            plain = ref(rows, width, total, max_iter)
            out = kernel(rows, width, total, max_iter)
            again = kernel(rows, width, total, max_iter)
            n_cases += 1
            if not (torch.equal(out, plain) and torch.equal(out, again)):
                failed.append({"rows": [r0, r1], "width": width, "max_iter": max_iter,
                               "mismatches": int((out != plain).sum())})
    return {"cases": n_cases, "failed": failed}


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
    # 16 M values at a time: a whole fp32 copy of a full-depth cache leaf
    # (1.5 GiB at moonshot) may not fit beside its weights
    cache_diff = max(float((x.float() - y.float()).abs().max())
                     for a, b in zip(_leaves(work), _leaves(eager_cache))
                     for x, y in zip(a.reshape(-1).split(1 << 24),
                                     b.reshape(-1).split(1 << 24)))
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
    # declare-target globals: ``a`` installed on every device after a buffer
    # pinned on device 0 (its handle shifts there), bound by a region on each
    # device, then re-installed; the card's run against the CPU's
    runs = {}
    for device in ("cuda", "cpu"):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=8), table=table, device=device)
        try:
            rt.ex.ensure_resident(0, keep=b)
            outs = []
            for g in (a, 2 * a):
                rt.pool.install_global("a", g)
                outs += [rt.target("add_arrays", d, MapSpec(
                    to={"b": b}, from_={"c": TensorSpec((size,), torch.float32)},
                    use_globals=("a",)))["c"].cpu() for d in range(len(rt.pool))]
            s = rt.cost.summary()
            runs[device] = (outs, dict(rt.pool.globals["a"]), s["bytes_to"], s["bytes_from"])
        finally:
            rt.shutdown()
    card, host = runs["cuda"], runs["cpu"]
    ok = (all(torch.equal(x, y) for x, y in zip(card[0], host[0])) and card[1:] == host[1:]
          and all(torch.equal(x, a + b) for x in card[0][:8])
          and all(torch.equal(x, 2 * a + b) for x in card[0][8:]))
    emit({"phase": "declare_target_globals", "devices": 8, "regions": len(card[0]),
          "handles": card[1], "bytes_to": card[2], "bytes_from": card[3],
          "equal_cpu": ok})
    if not ok:
        fail("a region using a declare-target global differs from the CPU run")


def phase_mandelbrot(torch):
    from repro_torch.bots import mandelbrot as bm
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.kernels.mandelbrot import mandelbrot as k1
    n = MANDEL_SIZE
    rt = ClusterRuntime(RuntimeConfig(n_virtual=MANDEL_DEVICES),
                        table=bm._make_table(n, n, MANDEL_ITER), device="cuda")
    try:
        rows = bm.all_rows(n)
        _reset_counts(k1)
        t0 = time.perf_counter()
        img = bm.strips(rt, rows, n, nowait=True)
        wall = time.perf_counter() - t0
        launches = k1.launches.count
        paths = _path_counts(k1)
        s = {**rt.cost.summary(), "wall_s": wall}
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
          "kernel_path_launches": paths,
          "strips_equal_serial": equal, "sane": sane, "profiled": busy})
    if launches != MANDEL_DEVICES or paths != {"chunked": launches}:
        fail(f"mandelbrot kernel launched {launches} times ({paths}), expected "
             f"{MANDEL_DEVICES} (one per strip), all chunked")
    if not (equal and sane):
        fail("mandelbrot strips differ from the serial image")
    return launches, paths, img, s


def _sparselu_once(torch, K: int, B: int, n_devices: int, fabric: str = "host-mediated",
                   profile: bool = True):
    """One sparselu wavefront on the card against the serial kernel.
    ``fabric``: "host-mediated" (every edge through the host), "direct"
    (``comm_mode="direct"``, every edge device to device) or "direct-2x2"
    (the same under ``Topology.two_tier(2, 2, inter_bw_ratio=0.1)``).
    ``profile`` runs it once more under ``torch.profiler`` for the card's
    busy share."""
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
        kernel_s = {k: rt.cost.kernel_time(k) for k in ("lu0", "fwd", "bdiv", "bmod")}
        ser = bl.serial(rt, mat)
        busy = (device_busy(torch, lambda: bl.wavefront(rt, mat, peer=peer))
                if profile else None)
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
           "kernel_time_s": kernel_s, "profiled": busy}
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
    bytes, sends fewer to the devices, and moves its edges peer to peer.
    Not profiled: the script's time goes to the later phases."""
    rows = [_sparselu_once(torch, LU_K, LU_B, LU_DEVICES, fabric, profile=False)
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


def _placement_policy(name: str):
    from repro_torch.core import HeftPlacement, SloPlacement
    return {"locality": lambda: "locality",
            # frozen estimates: deterministic placement (benchmarks/
            # sched_policies.py's two operating points)
            "heft-comm": lambda: HeftPlacement(default_task_s=5e-6, use_observed=False),
            "heft-compute": lambda: HeftPlacement(default_task_s=100e-6,
                                                  use_observed=False),
            # the default: the card's own EXEC seconds, as they retire
            "heft-observed": lambda: HeftPlacement(),
            "slo": lambda: SloPlacement(default_task_s=5e-6, use_observed=False)}[name]()


def _placement_digest(cost) -> str:
    """A digest of a run's placement decisions, (region tag, device) sorted:
    two runs with equal digests placed every task alike."""
    import hashlib
    pairs = sorted((p.task, p.device) for p in cost.placements)
    return hashlib.sha256(repr(pairs).encode()).hexdigest()[:16]


def _placed_sparselu(torch, mat, ser, policy: str, cap=None, profile: bool = False):
    """One K=16 sparselu wavefront over the peer fabric (``comm_mode=
    "direct"``) under ``policy``, optionally with each device's present
    table capped; K2's counts are set to 0 just before it and read just
    after.  Returns the row and the factorization."""
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.kernels.block_lu import block_lu as k2
    K = mat.shape[0]
    rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES, comm_mode="direct",
                                      device_capacity_bytes=cap),
                        table=bl._make_table(K), device="cuda")
    pol = _placement_policy(policy)
    try:
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat, peer=True, policy=pol)
        wall = time.perf_counter() - t0
        launches, paths = k2.launches.count, _path_counts(k2)
        s = rt.cost.summary()
        report = rt.cost.placement_report()
        digest = _placement_digest(rt.cost)
        mem = rt.memory_report()
        used = len({c.device for c in rt.cost.compute})
        busy = (device_busy(torch, lambda: bl.wavefront(rt, mat, peer=True, policy=pol))
                if profile else None)
    finally:
        rt.shutdown()
    lu = bl.assemble(res, K)
    row = {"phase": "placement_sparselu", "policy": policy, "K": K,
           "B": mat.shape[2], "devices": LU_DEVICES, "capacity_bytes": cap,
           "wall_s": wall, "devices_used": used, "bytes_to": s["bytes_to"],
           "bytes_from": s["bytes_from"], "bytes_peer": s["bytes_peer"],
           "bmod_launches": launches, "bmod_path_launches": paths,
           "max_abs_diff_vs_serial": float((lu - ser).abs().max()),
           "placements": len(report), "placement_digest": digest,
           "observed_device_ok": all(r["observed_device_ok"] for r in report),
           "cold_predictions": s["cold_predictions"]}
    if cap is not None:
        row.update({k: sum(m[k] for m in mem.values())
                    for k in ("evictions", "refetches", "bytes_reconciled",
                              "bytes_refetched")})
    if busy is not None:
        row["profiled"] = busy
    emit(row)
    expect = sum(m * m for m in range(K))
    if launches != expect or paths["cp_async"] != launches:
        fail(f"placement {policy}: bmod launched {launches} times ({paths} by path); "
             f"expected {expect}, every one on cp_async")
    if not row["observed_device_ok"]:
        fail(f"placement {policy}: a region ran off the device its policy placed it on")
    return row, lu


def phase_placement(torch, direct_row: dict, mandel_img, mandel_s: dict):
    """Placement on the card.  Sparselu K=16, B=128, D=4 over the peer fabric
    under locality, HEFT comm-bound, HEFT compute-bound, HEFT observed and
    SLO, beside the fabric phase's round-robin run (``direct_row``): each
    equals the serial kernel bit for bit with every K2 launch on cp_async
    and fetches the same bytes; ``PROFILED_POLICIES`` run once more under
    ``torch.profiler``.  Then HEFT comm-bound with each present table capped
    at ``CAP_BLOCKS`` blocks: bit-identical to the uncapped run, with
    evictions and refetches.  Then mandelbrot strips at D=8 under locality
    and HEFT comm-bound: the round-robin image, bytes and 8 K1 launches.
    Returns the phase's K1 launches and its sparselu rows."""
    from repro_torch.bots import mandelbrot as bm
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.kernels.mandelbrot import mandelbrot as k1
    mat = bl._matrix(LU_K, LU_B)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=1), table=bl._make_table(LU_K),
                        device="cuda")
    try:
        ser = bl.serial(rt, mat)
    finally:
        rt.shutdown()
    rows, lus = {}, {}
    for policy in ("locality", "heft-comm", "heft-compute", "heft-observed", "slo"):
        rows[policy], lus[policy] = _placed_sparselu(torch, mat, ser, policy,
                                                     profile=policy in PROFILED_POLICIES)
    cap = CAP_BLOCKS * LU_B * LU_B * 4
    capped, lu_capped = _placed_sparselu(torch, mat, ser, "heft-comm", cap=cap)
    for policy, r in rows.items():
        if r["max_abs_diff_vs_serial"] != 0.0:
            fail(f"placement {policy}: sparselu differs from the serial kernel by "
                 f"{r['max_abs_diff_vs_serial']}")
        if r["bytes_from"] != direct_row["bytes_from"]:
            fail(f"placement {policy}: bytes_from {r['bytes_from']} != round-robin "
                 f"{direct_row['bytes_from']}")
    if not torch.equal(lu_capped, lus["heft-comm"]):
        fail("capped sparselu differs from the uncapped HEFT run")
    if not (capped["evictions"] >= 1 and capped["refetches"] >= 1):
        fail(f"capped sparselu: {capped['evictions']} evictions, "
             f"{capped['refetches']} refetches; expected at least one of each")
    n = MANDEL_SIZE
    k1_launches, k1_paths = 0, {}
    for policy in ("locality", "heft-comm"):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=MANDEL_DEVICES),
                            table=bm._make_table(n, n, MANDEL_ITER), device="cuda")
        try:
            _reset_counts(k1)
            t0 = time.perf_counter()
            img = bm.strips(rt, bm.all_rows(n), n, nowait=True,
                            policy=_placement_policy(policy))
            wall = time.perf_counter() - t0
            launches = k1.launches.count
            paths = _path_counts(k1)
            s = rt.cost.summary()
            used = len({c.device for c in rt.cost.compute})
        finally:
            rt.shutdown()
        k1_launches += launches
        k1_paths = {p: k1_paths.get(p, 0) + c for p, c in paths.items()}
        equal = bool(torch.equal(img, mandel_img))
        emit({"phase": "placement_mandelbrot", "policy": policy, "size": n,
              "devices": MANDEL_DEVICES, "devices_used": used, "wall_s": wall,
              "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
              "kernel_launches": launches, "kernel_path_launches": paths,
              "image_equal_round_robin": equal})
        if not equal or launches != MANDEL_DEVICES or paths != {"chunked": launches}:
            fail(f"placement mandelbrot {policy}: image equal {equal}, "
                 f"{launches} K1 launches ({paths})")
        if (s["bytes_to"], s["bytes_from"]) != (mandel_s["bytes_to"], mandel_s["bytes_from"]):
            fail(f"placement mandelbrot {policy}: bytes {s['bytes_to']}/{s['bytes_from']} "
                 f"!= round-robin {mandel_s['bytes_to']}/{mandel_s['bytes_from']}")
    return k1_launches, k1_paths, [*rows.values(), capped], ser, lus


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
    return kq8, q8_launches, {"params": steps["host-mediated"][0], "grads": ref,
                              "scale": scale, "step_wall_s": steps["direct"][1]["wall_s"],
                              "int8_wall_s": runs["direct+int8"]["wall_s"]}


def _faults_by_op(pool) -> dict:
    by_op: dict = {}
    for d in pool.devices:
        for op, n in getattr(d, "failures_by_op", {}).items():
            by_op[op] = by_op.get(op, 0) + n
    return by_op


def _chaos_sparselu(torch, mat, policy: str, peer: bool, ops, p: float,
                    free_wall: float):
    """One sparselu wavefront on the card with ``inject_flaky(p, FAULT_SEED,
    ops)`` on every device and ``run_graph(max_retries=FAULT_RETRIES)``; K2's
    counts are set to 0 just before it and read just after.  Returns the row
    and the factorization."""
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.ft import inject_flaky
    from repro_torch.kernels.block_lu import block_lu as k2
    K, B = mat.shape[0], mat.shape[2]
    rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES,
                                      comm_mode="direct" if peer else "host-mediated"),
                        table=bl._make_table(K), device="cuda")
    try:
        inject_flaky(rt.pool, p=p, seed=FAULT_SEED, ops=ops)
        pol = None if policy == "round-robin" else _placement_policy(policy)
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat, peer=peer, policy=pol, max_retries=FAULT_RETRIES)
        wall = time.perf_counter() - t0
        launches, paths = k2.launches.count, _path_counts(k2)
        s = rt.cost.summary()
        by_op = _faults_by_op(rt.pool)
        blacklist = sorted(rt.pool.health.blacklist)
        execs = sum(1 for c in rt.pool.trace if c.op == "EXEC")
        tr = rt.transport
    finally:
        rt.shutdown()
    n_tasks = len(bl._build_dag(mat, K, B))
    expect = sum(m * m for m in range(K))
    row = {"phase": "fault_recovery", "case": "chaos_sparselu",
           "fabric": "peer" if peer else "host-mediated", "policy": policy,
           "K": K, "B": B, "devices": LU_DEVICES, "p": p, "seed": FAULT_SEED,
           "ops": list(ops), "max_retries": FAULT_RETRIES, "wall_s": wall,
           "fault_free_wall_s": free_wall, "wall_ratio": wall / free_wall,
           "faults": sum(by_op.values()), "faults_by_op": by_op,
           "blacklist": blacklist, "exec_commands": execs,
           "reexecuted_regions": execs - n_tasks,
           "bmod_launches": launches, "bmod_extra_launches": launches - expect,
           "bmod_path_launches": paths,
           "fallbacks": getattr(tr, "fallbacks", 0),
           "backoffs": getattr(tr, "backoffs", 0),
           "backoff_s": getattr(tr, "backoff_s", 0.0),
           "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
           "bytes_peer": s["bytes_peer"]}
    if launches < expect or paths["cp_async"] != launches:
        fail(f"chaos sparselu {row['fabric']} {policy}: bmod launched {launches} times "
             f"({paths} by path); expected at least {expect}, every one on cp_async")
    if row["faults"] <= 0 or len(blacklist) > row["faults"]:
        fail(f"chaos sparselu {row['fabric']} {policy}: {row['faults']} faults, "
             f"blacklist {blacklist}")
    return row, bl.assemble(res, K)


def phase_fault_recovery(torch, ser, lus: dict, lu_rows: list, placed_rows: list,
                         mandel_img, dp_ref: dict):
    """Failures and recovery on the card, with seeded faults
    (``repro_torch.ft.inject_flaky``, seed ``FAULT_SEED``):

    (a) sparselu K=16, B=128, D=4 over the peer fabric, every eligible op
        failing at ``FAULT_P``, under round-robin, locality and HEFT at 5 us:
        each equal to that policy's fault-free peer run bit for bit;
    (b) the same K=16 host-mediated with EXEC faults at ``FAULT_P``: equal to
        the serial kernel;
    (c) K=5, B=96 over the peer fabric with every SEND failing: equal to the
        serial kernel, with more host-wire bytes than the healthy peer run;
    (d) mandelbrot 4600² at D=8 with device ``DEAD_DEVICE`` failing every
        EXEC, each strip through ``with_retry`` with one shared blacklist: the
        serial image, blacklist {DEAD_DEVICE}, 8 K1 launches, all chunked;
    (e) the DP fabric at d_model 4096, D=4, direct with transport retries,
        SEND/RECV failing at ``DP_FAULT_P``: 8 ``data_parallel_step`` calls equal
        to the fault-free host-mediated run's parameters bit for bit, direct
        + int8 gradients within max|g|/64 of host-mediated; and the 2 x 2
        hierarchical mean with rack 1's leader failing every SEND/RECV
        (retries=1) equal to the serial mean bit for bit.

    Returns the phase's K1 launches and paths, and its sparselu rows (their
    K2 launches join the kernel line's)."""
    from repro_torch import comm_modes as cm
    from repro_torch.bots import mandelbrot as bm
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import (ClusterRuntime, MapSpec, PeerTransport, RuntimeConfig,
                                  TensorSpec, Topology, sec, strip_partition)
    from repro_torch.core.compression import true_div
    from repro_torch.ft import FAULT_OPS, inject_flaky, with_retry
    from repro_torch.kernels.block_lu import block_lu as k2
    from repro_torch.kernels.mandelbrot import mandelbrot as k1
    mat = bl._matrix(LU_K, LU_B)
    free_walls = {"round-robin": lu_rows[1]["wall_s"],
                  **{r["policy"]: r["wall_s"] for r in placed_rows
                     if r.get("capacity_bytes") is None}}
    rows = []
    # (a) chaos over the peer fabric; round-robin's fault-free peer run (the
    # fabric phase) equals ser bit for bit, as its phase checked
    for policy in FAULT_POLICIES:
        row, lu = _chaos_sparselu(torch, mat, policy, True, FAULT_OPS, FAULT_P,
                                  free_walls[policy])
        ref = lus.get(policy, ser)
        row["equal_fault_free"] = bool(torch.equal(lu, ref))
        row["max_abs_diff_vs_serial"] = float((lu - ser).abs().max())
        emit(row)
        rows.append(row)
        if not row["equal_fault_free"]:
            fail(f"chaos sparselu peer {policy} differs from its fault-free run")
    # (b) host-mediated, EXEC faults only
    row, lu = _chaos_sparselu(torch, mat, "round-robin", False, ("EXEC",), FAULT_P,
                              lu_rows[0]["wall_s"])
    row["max_abs_diff_vs_serial"] = float((lu - ser).abs().max())
    row["equal_fault_free"] = row["max_abs_diff_vs_serial"] == 0.0
    emit(row)
    rows.append(row)
    if not row["equal_fault_free"]:
        fail(f"chaos sparselu host-mediated differs from the serial kernel by "
             f"{row['max_abs_diff_vs_serial']}")
    # (c) a dead peer wire: every SEND fails, every edge goes through the funnel
    K5, B5 = LU_LARGE
    mat5 = bl._matrix(K5, B5)
    dead = {}
    for p in (0.0, 1.0):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES, comm_mode="direct"),
                            table=bl._make_table(K5), device="cuda")
        try:
            if p:
                inject_flaky(rt.pool, p=p, seed=FAULT_SEED, ops=("SEND",))
            ser5 = bl.serial(rt, mat5) if not p else dead[0.0]["ser"]
            _reset_counts(k2)
            t0 = time.perf_counter()
            res = bl.wavefront(rt, mat5, peer=True, max_retries=FAULT_RETRIES)
            wall = time.perf_counter() - t0
            s = rt.cost.summary()
            dead[p] = {"ser": ser5, "lu": bl.assemble(res, K5), "wall_s": wall,
                       "host_bytes": s["bytes_to"] + s["bytes_from"],
                       "bytes_peer": s["bytes_peer"], "faults": _faults_by_op(rt.pool),
                       "launches": k2.launches.count, "paths": _path_counts(k2)}
        finally:
            rt.shutdown()
    d1 = dead[1.0]
    row = {"phase": "fault_recovery", "case": "dead_peer_wire", "K": K5, "B": B5,
           "devices": LU_DEVICES, "p": 1.0, "seed": FAULT_SEED, "ops": ["SEND"],
           "wall_s": d1["wall_s"], "fault_free_wall_s": dead[0.0]["wall_s"],
           "wall_ratio": d1["wall_s"] / dead[0.0]["wall_s"],
           "faults": sum(d1["faults"].values()), "faults_by_op": d1["faults"],
           "host_bytes": d1["host_bytes"], "fault_free_host_bytes": dead[0.0]["host_bytes"],
           "bytes_peer": d1["bytes_peer"], "bmod_launches": d1["launches"],
           "bmod_path_launches": d1["paths"],
           "equal_fault_free": bool(torch.equal(d1["lu"], dead[0.0]["lu"])),
           "max_abs_diff_vs_serial": float((d1["lu"] - d1["ser"]).abs().max())}
    emit(row)
    rows.append(row)
    expect5 = sum(m * m for m in range(K5))
    if not (row["equal_fault_free"] and row["max_abs_diff_vs_serial"] == 0.0):
        fail(f"dead peer wire: sparselu differs ({row['max_abs_diff_vs_serial']})")
    if not (row["faults"] > 0 and row["host_bytes"] > row["fault_free_host_bytes"]):
        fail(f"dead peer wire: {row['faults']} faults, host bytes {row['host_bytes']} "
             f"(healthy {row['fault_free_host_bytes']})")
    if d1["launches"] < expect5 or d1["paths"]["cp_async"] != d1["launches"]:
        fail(f"dead peer wire: bmod launched {d1['launches']} ({d1['paths']})")
    # the healthy K=5 peer run is on the main path too: its launches count
    rows.append({"case": "dead_peer_wire_fault_free",
                 "bmod_launches": dead[0.0]["launches"],
                 "bmod_path_launches": dead[0.0]["paths"]})
    if dead[0.0]["paths"]["cp_async"] != dead[0.0]["launches"]:
        fail(f"healthy K=5 peer run: bmod launched {dead[0.0]['paths']}")
    # (d) mandelbrot strips with a dead device, each through with_retry
    n = MANDEL_SIZE
    rt = ClusterRuntime(RuntimeConfig(n_virtual=MANDEL_DEVICES),
                        table=bm._make_table(n, n, MANDEL_ITER), device="cuda")
    try:
        inject_flaky(rt.pool, p=1.0, seed=FAULT_SEED, devices=[DEAD_DEVICE])
        img_rows = bm.all_rows(n)
        blacklist: set = set()
        _reset_counts(k1)
        t0 = time.perf_counter()
        parts = []
        for dev, (s0, ln) in enumerate(strip_partition(n, MANDEL_DEVICES)):
            maps = MapSpec(to={"rows": sec(img_rows, s0, ln)},
                           from_={"out": TensorSpec((ln, n), torch.int32)})
            parts.append(with_retry(rt.ex, "mandel_strip", dev, maps,
                                    blacklist=blacklist)["out"])
        img = torch.cat(parts)
        wall = time.perf_counter() - t0
        k1_launches, k1_paths = k1.launches.count, _path_counts(k1)
        by_op = _faults_by_op(rt.pool)
        ran_on = sorted({c.device for c in rt.cost.compute})
    finally:
        rt.shutdown()
    equal = bool(torch.equal(img, mandel_img))
    emit({"phase": "fault_recovery", "case": "mandelbrot_dead_device", "size": n,
          "devices": MANDEL_DEVICES, "dead_device": DEAD_DEVICE, "wall_s": wall,
          "faults_by_op": by_op, "blacklist": sorted(blacklist),
          "devices_that_ran": ran_on, "kernel_launches": k1_launches,
          "kernel_path_launches": k1_paths, "image_equal_serial": equal})
    if not equal or blacklist != {DEAD_DEVICE} or DEAD_DEVICE in ran_on:
        fail(f"mandelbrot with a dead device: image equal {equal}, blacklist "
             f"{sorted(blacklist)}, ran on {ran_on}")
    if k1_launches != MANDEL_DEVICES or k1_paths != {"chunked": k1_launches}:
        fail(f"mandelbrot with a dead device: {k1_launches} K1 launches ({k1_paths}), "
             f"expected {MANDEL_DEVICES}, all chunked")
    # (e) the DP fabric under SEND/RECV chaos
    d, nb, D = DP_D_MODEL, DP_BATCH, DP_DEVICES
    params = cm.make_params(d)
    batches = cm.make_batches(d, nb, D)

    def chaos_rt(compress=False):
        return cm.make_runtime(RuntimeConfig(n_virtual=D, comm_mode="direct",
                                             compress=compress), "cuda",
                               (DP_FAULT_P, FAULT_SEED))

    rt = chaos_rt()
    try:
        t0 = time.perf_counter()
        p_out = None
        for _ in range(DP_STEPS):
            p_out = rt.data_parallel_step("mse_grads", params, batches, sync_every=DP_SYNC)
        step_wall = time.perf_counter() - t0
        step_faults = cm.fault_report(rt)
    finally:
        rt.shutdown()
    step_equal = all(torch.equal(p_out[k], dp_ref["params"][k]) for k in ("w", "b"))
    rt = chaos_rt(compress=True)
    try:
        t0 = time.perf_counter()
        g8 = rt.data_parallel_grads("mse_grads", params, batches)
        int8_wall = time.perf_counter() - t0
        int8_faults = cm.fault_report(rt)
    finally:
        rt.shutdown()
    int8_err = max(float((g8[k] - dp_ref["grads"][k]).abs().max()) for k in ("w", "b"))
    topo = Topology.two_tier(*FABRIC_TOPO[:2], inter_bw_ratio=FABRIC_TOPO[2])
    pool, handles, specs, values = cm.collective_pool(topo, HIER_ELEMS, seed=0,
                                                      device="cuda")
    try:
        inject_flaky(pool, p=1.0, seed=FAULT_SEED, devices=[topo.leader(1)],
                     ops=("SEND", "RECV"))
        tr = PeerTransport(retries=1, backoff_base_s=1e-5, topology=topo)
        t0 = time.perf_counter()
        tr.hier_allreduce_mean(pool, handles, specs)
        pool.sync()
        hier_wall = time.perf_counter() - t0
        means = [pool.transfer_from(i, handles[i][0]) for i in range(topo.n_devices)]
        hier_faults = _faults_by_op(pool)
    finally:
        pool.stop_all()
    serial = values[0][0]
    for v in values[1:]:
        serial = serial + v[0]
    serial = true_div(serial, topo.n_devices)
    hier_equal = all(torch.equal(m, serial) for m in means)
    emit({"phase": "fault_recovery", "case": "dp_fabric", "d_model": d, "devices": D,
          "p": DP_FAULT_P, "seed": FAULT_SEED, "ops": ["SEND", "RECV"],
          "transport_retries": cm.CHAOS_RETRIES,
          "step": {"wall_s": step_wall, "fault_free_wall_s": dp_ref["step_wall_s"],
                   "steps": DP_STEPS, "params_equal_host_mediated": step_equal,
                   **step_faults},
          "int8_grads": {"wall_s": int8_wall, "fault_free_wall_s": dp_ref["int8_wall_s"],
                         "max_abs_err": int8_err, "bound": dp_ref["scale"] / 64,
                         **int8_faults},
          "hier_mean_dead_leader": {"leader": topo.leader(1), "elems": HIER_ELEMS,
                                    "wall_s": hier_wall, "bitwise_serial": hier_equal,
                                    "faults_by_op": hier_faults,
                                    "fallbacks": tr.fallbacks, "backoffs": tr.backoffs,
                                    "backoff_s": tr.backoff_s}})
    if not step_equal or step_faults["faults"] <= 0:
        fail(f"DP steps under chaos: params equal {step_equal}, "
             f"{step_faults['faults']} faults")
    if not (int8_err <= dp_ref["scale"] / 64 and int8_faults["faults"] > 0):
        fail(f"int8 DP grads under chaos off by {int8_err} "
             f"(bound {dp_ref['scale'] / 64}), {int8_faults['faults']} faults")
    if not (hier_equal and tr.fallbacks > 0):
        fail(f"hierarchical mean with a dead rack leader: bitwise {hier_equal}, "
             f"{tr.fallbacks} fallbacks")
    return k1_launches, k1_paths, rows


def _stalls(pool) -> int:
    return sum(getattr(d, "stalls", 0) for d in pool.devices)


def _hedged_sparselu(torch, mat, ser, peer: bool, baseline):
    """One K=16 sparselu wavefront on the card with device ``SLOW_DEVICE``
    stalling ``SLOW_P`` of its EXECs for ``SLOW_S`` (seed ``FAULT_SEED``),
    hedged by a ``StragglerDetector`` when ``baseline`` (seconds per kernel)
    is given.  K2's counts are set to 0 just before it and read just after.
    Returns the run's numbers; fails unless it equals the serial kernel bit
    for bit, every loser's compute record was struck and every K2 launch is
    on cp_async."""
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.ft import FlakyDevice, StragglerDetector
    from repro_torch.kernels.block_lu import block_lu as k2
    K, B = mat.shape[0], mat.shape[2]
    rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES,
                                      comm_mode="direct" if peer else "host-mediated"),
                        table=bl._make_table(K), device="cuda")
    try:
        rt.pool.devices[SLOW_DEVICE] = FlakyDevice(
            rt.pool.devices[SLOW_DEVICE], p=SLOW_P, seed=FAULT_SEED, ops=("EXEC",),
            mode="slow", slow_s=SLOW_S)
        det = (StragglerDetector(rt.cost, baseline=baseline, **HEDGE)
               if baseline is not None else None)
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat, peer=peer, stragglers=det)
        wall = time.perf_counter() - t0
        launches, paths = k2.launches.count, _path_counts(k2)
        records = len(rt.cost.compute)
        stalls = _stalls(rt.pool)
    finally:
        rt.shutdown()
    n_tasks = len(bl._build_dag(mat, K, B))
    diff = float((bl.assemble(res, K) - ser).abs().max())
    out = {"wall_s": wall, "stalls": stalls, "compute_records": records,
           "bmod_launches": launches, "bmod_path_launches": paths,
           "bmod_extra_launches": launches - sum(m * m for m in range(K)),
           "max_abs_diff_vs_serial": diff}
    if det is not None:
        rep = det.report()
        out.update({k: rep[k] for k in ("hedges_launched", "primary_wins",
                                        "hedge_wins", "hedge_failures")})
        out["hedged_kernels"] = dict(collections.Counter(r["kernel"] for r in rep["records"]))
    what = f"hedged sparselu {'peer' if peer else 'host-mediated'}" + \
        (" with a detector" if det is not None else "")
    if diff != 0.0:
        fail(f"{what} differs from the serial kernel by {diff}")
    if records != n_tasks:
        fail(f"{what}: {records} compute records for {n_tasks} tasks (a loser not struck)")
    if launches < sum(m * m for m in range(K)) or paths["cp_async"] != launches:
        fail(f"{what}: bmod launched {launches} times ({paths}), every one on cp_async")
    return out


def phase_stragglers(torch, ser, lu_rows: list, fault_rows: list, mandel_img,
                     mandel_s: dict):
    """Stragglers and deadlines on the card (``repro_torch.ft``, seed
    ``FAULT_SEED``):

    (a) sparselu K=16, B=128, D=4, round-robin, host-mediated and over the
        peer fabric, device ``SLOW_DEVICE`` stalling ``SLOW_P`` of its EXECs
        for ``SLOW_S``: once without and once with a ``StragglerDetector``
        (``HEDGE``, baseline the fault-free run's seconds per kernel); each
        equal to the serial kernel bit for bit, one compute record per task
        (every loser struck), at least one hedge;
    (b) the same K=16 host-mediated under ``command_deadline_s=DEADLINE_S``
        with every device hanging ``HANG_P`` of its EXECs for ``HANG_S``:
        equal to the serial kernel, at least one EXEC deadline blown, and a
        final ``pool.sync()`` that raises nothing;
    (c) K=5, B=96 over the peer fabric with every device hanging
        ``SEND_HANG_P`` of its SENDs for ``SEND_HANG_S``, under
        ``transport_retries=1`` and ``transport_op_timeout_s=OP_TIMEOUT_S``:
        equal to the serial kernel, at least one op timeout, and a final
        ``pool.sync()`` after the hangs that raises nothing;
    (d) mandelbrot 4600² at D=8 with device ``SPEC_DEVICE`` stalling every
        EXEC for ``SPEC_SLOW_S``, without and with
        ``offload_strips(speculate=True)``: the serial image bit for bit,
        at least one strip respawned, every K1 launch chunked, and the
        speculative run's modeled traffic (transfers, compute tags and the
        funnel's modeled time) equal to the run without speculation's.

    The walls of the fault-free runs in this process ride along.  Returns
    the phase's K1 launches and paths, and its rows (their K2 launches join
    the kernel line's)."""
    from repro_torch.bots import mandelbrot as bm
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.ft import FlakyDevice, inject_flaky
    from repro_torch.kernels.block_lu import block_lu as k2
    from repro_torch.kernels.mandelbrot import mandelbrot as k1
    mat = bl._matrix(LU_K, LU_B)
    rows = []
    # (a) hedging; lu_rows[0] is the fault-free host-mediated run, lu_rows[1]
    # the fault-free run over the peer fabric
    for peer, free in ((False, lu_rows[0]), (True, lu_rows[1])):
        plain = _hedged_sparselu(torch, mat, ser, peer, None)
        hedged = _hedged_sparselu(torch, mat, ser, peer, free["kernel_time_s"])
        row = {"phase": "stragglers", "case": "hedged_sparselu",
               "fabric": "peer" if peer else "host-mediated", "K": LU_K, "B": LU_B,
               "devices": LU_DEVICES, "slow_device": SLOW_DEVICE, "p": SLOW_P,
               "slow_s": SLOW_S, "seed": FAULT_SEED, "detector": HEDGE,
               "baseline_s": free["kernel_time_s"],
               "fault_free_wall_s": free["wall_s"], "unhedged": plain, "hedged": hedged,
               "wall_ratio_unhedged": plain["wall_s"] / free["wall_s"],
               "wall_ratio_hedged": hedged["wall_s"] / free["wall_s"]}
        emit(row)
        rows += [plain, hedged]
        if hedged["hedges_launched"] < 1:
            fail(f"hedged sparselu {row['fabric']}: no hedge launched ({hedged})")
    # (b) command deadlines
    rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES, command_deadline_s=DEADLINE_S),
                        table=bl._make_table(LU_K), device="cuda")
    try:
        inject_flaky(rt.pool, p=HANG_P, seed=FAULT_SEED, ops=("EXEC",), mode="hang",
                     hang_s=HANG_S)
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat, max_retries=FAULT_RETRIES)
        wall = time.perf_counter() - t0
        time.sleep(HANG_S)
        rt.pool.sync()                   # the hung EXECs' late failures: none surfaces
        # read after the sync: EXECs that missed their deadline launch K2 late
        launches, paths = k2.launches.count, _path_counts(k2)
        timeouts = dict(rt.pool.straggler_timeouts)
        hangs = _faults_by_op(rt.pool)
        blacklist = sorted(rt.pool.health.blacklist)
        execs = sum(1 for c in rt.pool.trace if c.op == "EXEC")
    finally:
        rt.shutdown()
    diff = float((bl.assemble(res, LU_K) - ser).abs().max())
    row = {"phase": "stragglers", "case": "deadline_sparselu", "fabric": "host-mediated",
           "K": LU_K, "B": LU_B, "devices": LU_DEVICES, "deadline_s": DEADLINE_S,
           "p": HANG_P, "hang_s": HANG_S, "seed": FAULT_SEED, "hangs_by_op": hangs,
           "straggler_timeouts": timeouts, "blacklist": blacklist,
           "reexecuted_regions": execs - len(bl._build_dag(mat, LU_K, LU_B)),
           "wall_s": wall, "fault_free_wall_s": lu_rows[0]["wall_s"],
           "wall_ratio": wall / lu_rows[0]["wall_s"], "bmod_launches": launches,
           "bmod_path_launches": paths, "max_abs_diff_vs_serial": diff}
    emit(row)
    rows.append(row)
    if diff != 0.0 or timeouts.get("EXEC", 0) < 1:
        fail(f"deadline sparselu: diff {diff}, straggler timeouts {timeouts}")
    if launches < sum(m * m for m in range(LU_K)) or paths["cp_async"] != launches:
        fail(f"deadline sparselu: bmod launched {launches} times ({paths})")
    # (c) transport op timeouts on the peer fabric
    K5, B5 = LU_LARGE
    mat5 = bl._matrix(K5, B5)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES, comm_mode="direct",
                                      transport_retries=1,
                                      transport_op_timeout_s=OP_TIMEOUT_S),
                        table=bl._make_table(K5), device="cuda")
    try:
        ser5 = bl.serial(rt, mat5)
        inject_flaky(rt.pool, p=SEND_HANG_P, seed=FAULT_SEED, ops=("SEND",), mode="hang",
                     hang_s=SEND_HANG_S)
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat5, peer=True, max_retries=FAULT_RETRIES)
        wall = time.perf_counter() - t0
        launches, paths = k2.launches.count, _path_counts(k2)
        time.sleep(SEND_HANG_S)
        rt.pool.sync()                   # the timed-out pairs settled: nothing surfaces
        s = rt.cost.summary()
        hangs = _faults_by_op(rt.pool)
        tr = rt.transport
    finally:
        rt.shutdown()
    dead = next(r for r in fault_rows if r.get("case") == "dead_peer_wire")
    diff = float((bl.assemble(res, K5) - ser5).abs().max())
    row = {"phase": "stragglers", "case": "op_timeout_sparselu", "fabric": "peer",
           "K": K5, "B": B5, "devices": LU_DEVICES, "p": SEND_HANG_P,
           "hang_s": SEND_HANG_S, "op_timeout_s": OP_TIMEOUT_S, "transport_retries": 1,
           "seed": FAULT_SEED, "hangs_by_op": hangs, "timeouts": tr.timeouts,
           "fallbacks": tr.fallbacks, "backoffs": tr.backoffs, "backoff_s": tr.backoff_s,
           "host_bytes": s["bytes_to"] + s["bytes_from"],
           "fault_free_host_bytes": dead["fault_free_host_bytes"],
           "bytes_peer": s["bytes_peer"], "wall_s": wall, "bmod_launches": launches,
           "bmod_path_launches": paths, "max_abs_diff_vs_serial": diff}
    emit(row)
    rows.append(row)
    if diff != 0.0 or tr.timeouts < 1:
        fail(f"op-timeout sparselu: diff {diff}, {tr.timeouts} timeouts")
    if launches < sum(m * m for m in range(K5)) or paths["cp_async"] != launches:
        fail(f"op-timeout sparselu: bmod launched {launches} times ({paths})")
    # (d) speculative strips
    n = MANDEL_SIZE
    spec = {}
    for speculate in (False, True):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=MANDEL_DEVICES),
                            table=bm._make_table(n, n, MANDEL_ITER), device="cuda")
        try:
            rt.pool.devices[SPEC_DEVICE] = FlakyDevice(
                rt.pool.devices[SPEC_DEVICE], p=1.0, seed=FAULT_SEED, ops=("EXEC",),
                mode="slow", slow_s=SPEC_SLOW_S)
            _reset_counts(k1)
            t0 = time.perf_counter()
            img = bm.strips(rt, bm.all_rows(n), n, nowait=True, speculate=speculate)
            wall = time.perf_counter() - t0
            rt.pool.sync()
            cost = rt.cost
            spec[speculate] = {
                "wall_s": wall, "kernel_launches": k1.launches.count,
                "kernel_path_launches": _path_counts(k1),
                "respawned": sum(1 for c in rt.pool.trace
                                 if c.op == "EXEC" and ":spec[" in c.tag),
                "image_equal_serial": bool(torch.equal(img, mandel_img)),
                "transfers": sorted((t.direction, t.nbytes) for t in cost.transfers),
                "compute_tags": sorted(c.tag for c in cost.compute),
                "comm_s": cost.comm_time(), "modeled_makespan_s": cost.makespan(),
                "compute_s": cost.compute_time()}
        finally:
            rt.shutdown()
    plain, sp = spec[False], spec[True]
    same_model = all(plain[k] == sp[k] for k in ("transfers", "compute_tags", "comm_s"))
    emit({"phase": "stragglers", "case": "speculative_strips", "size": n,
          "devices": MANDEL_DEVICES, "slow_device": SPEC_DEVICE, "slow_s": SPEC_SLOW_S,
          "fault_free_wall_s": mandel_s["wall_s"],
          "model_equal_without_speculation": same_model,
          **{("speculative" if k else "plain"): {x: v for x, v in r.items()
                                                 if x not in ("transfers", "compute_tags")}
             for k, r in spec.items()}})
    for k, r in spec.items():
        if (not r["image_equal_serial"]
                or r["kernel_path_launches"].get("chunked", 0) != r["kernel_launches"]):
            fail(f"mandelbrot (speculate={k}) with a slow device: image equal "
                 f"{r['image_equal_serial']}, K1 launches {r['kernel_path_launches']}")
    if sp["respawned"] < 1 or plain["kernel_launches"] != MANDEL_DEVICES:
        fail(f"speculative strips: {sp['respawned']} respawned, "
             f"{plain['kernel_launches']} launches without speculation")
    if not same_model:
        fail("speculative strips: the modeled traffic differs from the run without "
             "speculation")
    k1_launches = plain["kernel_launches"] + sp["kernel_launches"]
    k1_paths = {p: plain["kernel_path_launches"].get(p, 0) + sp["kernel_path_launches"].get(p, 0)
                for p in {*plain["kernel_path_launches"], *sp["kernel_path_launches"]}}
    return k1_launches, k1_paths, rows


def _per_device_lengths(pool) -> dict:
    return {name: len(getattr(pool, name)) for name in POOL_LISTS}


def phase_checkpoint_elastic(torch, ser, lu_rows: list, placed_rows: list, mandel_img):
    """Checkpoints and elasticity on the card, against the serial
    factorization ``ser`` (K=16, B=128) and the serial image:

    (a) ``resume_smoke.run``: K=16 over the peer fabric under locality at
        D=4, a checkpoint every wave, halted after save 23 of 46 waves, then
        resumed in a fresh interpreter on the card: the serial kernel's bits,
        exactly the EXECs of the tasks not yet completed, every K2 launch of
        the killed run and of the child (counted there) on cp_async;
    (b) the same halt host-mediated under round-robin, from one save after
        wave 23 (``every_waves=23``), resumed in this process on a fresh
        runtime: the serial kernel's bits and the tail's EXECs;
    (c) a 4096 x 4096 fp32 weight entered on each of ``DP_DEVICES`` devices,
        a ``nowait`` region updating the copies of devices 2 and 3 on the
        device, then ``rescale_pool`` to 2: both updated weights moved, their
        bits read back from their new home, 2 x 64 MiB reconciled, every
        per-device list of length 2; then K=16 over the peer fabric under
        locality on the two survivors, the serial kernel's bits;
    (d) K=16 over the peer fabric under round-robin on D=2, grown to
        ``LU_DEVICES`` inside the ``make_maps`` of a task of wave 3: the
        serial kernel's bits, and the joined devices ran EXECs;
    (e) mandelbrot 4600² strips at D=8, on the pool shrunk to 4, and grown
        back to 8: each image the serial one, every K1 launch chunked.

    Returns the phase's K1 launches and paths, and its rows (their K2
    launches join the kernel line's)."""
    import dataclasses
    import tempfile
    from repro_torch import resume_smoke
    from repro_torch.bots import mandelbrot as bm
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import (ClusterRuntime, GraphCheckpoint, GraphInterrupted,
                                  MapSpec, RuntimeConfig, TaskGraph)
    from repro_torch.ft import rescale_pool
    from repro_torch.kernels.block_lu import block_lu as k2
    from repro_torch.kernels.mandelbrot import mandelbrot as k1
    mat = bl._matrix(LU_K, LU_B)
    waves = TaskGraph.from_tasks(bl._build_dag(mat, LU_K, LU_B)).waves()
    kill_at = len(waves) // 2
    tail = [n for w in waves[kill_at:] for n in w]
    tail_bmods = sum(1 for n in tail if n.startswith("bmod_"))
    expect = sum(m * m for m in range(LU_K))
    locality, round_robin = placed_rows[0], lu_rows[1]
    rows = []

    def k2_ok(what, launches, paths, want=None):
        if (want is not None and launches != want) or paths["cp_async"] != launches:
            fail(f"{what}: bmod launched {launches} times ({paths}); expected "
                 f"{want if want is not None else 'any number'}, every one on cp_async")

    def lu_ok(what, res):
        diff = float((bl.assemble(res, LU_K) - ser).abs().max())
        if diff != 0.0:
            fail(f"{what}: sparselu differs from the serial kernel by {diff}")
        return diff

    # (a) kill and resume in a fresh interpreter
    _reset_counts(k2)
    t0 = time.perf_counter()
    drill = resume_smoke.run(LU_K, LU_B, LU_DEVICES, device="cuda", reference=ser)
    wall = time.perf_counter() - t0
    parent = {"bmod_launches": k2.launches.count, "bmod_path_launches": _path_counts(k2)}
    child = drill["child_bmod_path_launches"]
    row = {"phase": "checkpoint_elastic", "case": "kill_and_resume", "fabric": "peer",
           "policy": "locality", **drill, "drill_wall_s": wall,
           "tail_tasks": len(tail), "tail_bmods": tail_bmods,
           "killed_bmod_launches": parent["bmod_launches"],
           "killed_bmod_path_launches": parent["bmod_path_launches"],
           "uninterrupted_locality_wall_s": locality["wall_s"],
           "child_wall_ratio": drill["child_wall_s"] / locality["wall_s"],
           "child_resume_wall_ratio": drill["child_resume_wall_s"] / locality["wall_s"]}
    emit(row)
    if not drill["identical"] or drill["execs_resumed"] != len(tail):
        fail(f"kill and resume: identical {drill['identical']}, "
             f"{drill['execs_resumed']} EXECs in the child for {len(tail)} tasks left")
    k2_ok("kill and resume (killed run)", parent["bmod_launches"],
          parent["bmod_path_launches"], expect - tail_bmods)
    k2_ok("kill and resume (child)", sum(child.values()), child, tail_bmods)
    rows += [parent, {"bmod_launches": sum(child.values()), "bmod_path_launches": child}]

    # (b) host-mediated, resumed in this process
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ck_") as ckdir:
        ck = GraphCheckpoint(ckdir, every_waves=kill_at, keep=2, halt_after=1)
        rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES), table=bl._make_table(LU_K),
                            device="cuda")
        _reset_counts(k2)
        t0 = time.perf_counter()
        try:
            bl.wavefront(rt, mat, checkpoint=ck)
            fail("host-mediated checkpoint: halt_after did not stop the run")
        except GraphInterrupted:
            killed_wall = time.perf_counter() - t0
        finally:
            rt.shutdown()
        rt = ClusterRuntime(RuntimeConfig(n_virtual=LU_DEVICES), table=bl._make_table(LU_K),
                            device="cuda")
        try:
            t0 = time.perf_counter()
            res = bl.wavefront(rt, mat, resume_from=ckdir)
            resume_wall = time.perf_counter() - t0
            execs = sum(1 for c in rt.pool.trace if c.op == "EXEC")
            s = rt.cost.summary()
        finally:
            rt.shutdown()
    launches, paths = k2.launches.count, _path_counts(k2)
    row = {"phase": "checkpoint_elastic", "case": "resume_in_process",
           "fabric": "host-mediated", "policy": "round-robin", "K": LU_K, "B": LU_B,
           "devices": LU_DEVICES, "every_waves": kill_at, "saves": ck.saves,
           "save_s": ck.save_s, "bytes_written": ck.bytes_written,
           "killed_wall_s": killed_wall, "resume_wall_s": resume_wall,
           "execs_resumed": execs, "resume_bytes_to": s["bytes_to"],
           "resume_bytes_from": s["bytes_from"],
           "uninterrupted_wall_s": lu_rows[0]["wall_s"], "bmod_launches": launches,
           "bmod_path_launches": paths, "max_abs_diff_vs_serial": lu_ok("resume in process", res)}
    emit(row)
    rows.append(row)
    if execs != len(tail):
        fail(f"resume in process: {execs} EXECs for {len(tail)} tasks left")
    k2_ok("resume in process", launches, paths, expect)

    # (c) shrink with device-ahead state, then sparselu on the survivors
    table = bl._make_table(LU_K)
    table.register("bump", lambda state, s: {"state": state + s})
    rt = ClusterRuntime(RuntimeConfig(n_virtual=DP_DEVICES, comm_mode="direct"),
                        table=table, device="cuda")
    try:
        g = torch.Generator().manual_seed(FAULT_SEED)
        w = torch.randn(DP_D_MODEL, DP_D_MODEL, generator=g)
        half = torch.tensor(0.5)
        updated = (w.cuda() + half.cuda()).cpu()
        for d in range(DP_DEVICES):
            rt.ex.enter_data(d, **{f"w{d}": w})
        ahead = (2, 3)
        for d in ahead:
            rt.ex.target("bump", d, MapSpec(present={"state": f"w{d}"},
                                            device_out={"state": f"w{d}"}, to={"s": half}),
                         nowait=True, tag="bump")
        t0 = time.perf_counter()
        rep = rescale_pool(rt, 2)
        rescale_s = time.perf_counter() - t0
        lengths = _per_device_lengths(rt.pool)
        moved = {m[0]: m for m in rep["moved"]}
        read_back = {f"w{d}": bool(torch.equal(rt.ex.fetch_resident(moved[f"w{d}"][2],
                                                                    f"w{d}"), updated))
                     for d in ahead if f"w{d}" in moved}
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = bl.wavefront(rt, mat, peer=True, policy="locality")
        shrunk_wall = time.perf_counter() - t0
        launches, paths = k2.launches.count, _path_counts(k2)
        n_pool = len(rt.pool)
    finally:
        rt.shutdown()
    row = {"phase": "checkpoint_elastic", "case": "shrink_device_ahead",
           "weight_shape": [DP_D_MODEL, DP_D_MODEL], "from": rep["from"], "to": rep["to"],
           "moved": rep["moved"], "dropped": rep["dropped"],
           "reconciled_bytes": rep["reconciled_bytes"], "rescale_s": rescale_s,
           "read_back_updated": read_back, "per_device_lengths": lengths,
           "sparselu_policy": "locality", "wall_s": shrunk_wall,
           "fixed_d4_locality_wall_s": locality["wall_s"],
           "wall_ratio": shrunk_wall / locality["wall_s"], "bmod_launches": launches,
           "bmod_path_launches": paths,
           "max_abs_diff_vs_serial": lu_ok("sparselu after a shrink", res)}
    emit(row)
    rows.append(row)
    if n_pool != 2 or set(lengths.values()) != {2}:
        fail(f"shrink: pool of {n_pool}, per-device lists {lengths}")
    if read_back != {"w2": True, "w3": True}:
        fail(f"shrink: updated weights moved and read back {read_back} ({rep})")
    if rep["reconciled_bytes"] != 2 * DP_D_MODEL * DP_D_MODEL * 4:
        fail(f"shrink: reconciled {rep['reconciled_bytes']} bytes")
    k2_ok("sparselu after a shrink", launches, paths, expect)

    # (d) grow from 2 to LU_DEVICES while the graph runs
    rt = ClusterRuntime(RuntimeConfig(n_virtual=2, comm_mode="direct"),
                        table=bl._make_table(LU_K), device="cuda")
    grown = {}
    try:
        grow_at = waves[3][0]

        def growing(t):
            def make_maps(deps):
                if not grown:
                    grown["wave"] = 3
                    grown["report"] = rescale_pool(rt, LU_DEVICES)
                return t.make_maps(deps)
            return dataclasses.replace(t, make_maps=make_maps)

        tasks = [growing(t) if t.name == grow_at else t
                 for t in bl._build_dag(mat, LU_K, LU_B)]
        _reset_counts(k2)
        t0 = time.perf_counter()
        res = rt.wavefront_offload(tasks, nowait=True, resident=True, peer=True,
                                   policy="round-robin")
        grow_wall = time.perf_counter() - t0
        launches, paths = k2.launches.count, _path_counts(k2)
        execs = [sum(1 for c in rt.pool.trace if c.op == "EXEC" and c.device == d)
                 for d in range(len(rt.pool))]
    finally:
        rt.shutdown()
    row = {"phase": "checkpoint_elastic", "case": "grow_mid_graph", "fabric": "peer",
           "policy": "round-robin", "from": 2, "to": LU_DEVICES, "grown_at_task": grow_at,
           "grown_in_wave": grown.get("wave"), "execs_by_device": execs,
           "wall_s": grow_wall, "fixed_d4_wall_s": round_robin["wall_s"],
           "wall_ratio": grow_wall / round_robin["wall_s"], "bmod_launches": launches,
           "bmod_path_launches": paths,
           "max_abs_diff_vs_serial": lu_ok("sparselu grown mid-graph", res)}
    emit(row)
    rows.append(row)
    if len(execs) != LU_DEVICES or not all(execs[d] > 0 for d in range(2, LU_DEVICES)):
        fail(f"grow mid-graph: EXECs by device {execs}")
    k2_ok("sparselu grown mid-graph", launches, paths, expect)

    # (e) strips on a shrunk and a regrown pool
    n = MANDEL_SIZE
    rt = ClusterRuntime(RuntimeConfig(n_virtual=MANDEL_DEVICES),
                        table=bm._make_table(n, n, MANDEL_ITER), device="cuda")
    strips = []
    try:
        _reset_counts(k1)
        for size in (MANDEL_DEVICES, MANDEL_DEVICES // 2, MANDEL_DEVICES):
            rep = rescale_pool(rt, size)
            t0 = time.perf_counter()
            img = bm.strips(rt, bm.all_rows(n), n, nowait=True)
            strips.append({"devices": len(rt.pool), "rescale": [rep["from"], rep["to"]],
                           "wall_s": time.perf_counter() - t0,
                           "image_equal_serial": bool(torch.equal(img, mandel_img))})
        k1_launches, k1_paths = k1.launches.count, _path_counts(k1)
    finally:
        rt.shutdown()
    emit({"phase": "checkpoint_elastic", "case": "rescaled_strips", "size": n,
          "runs": strips, "kernel_launches": k1_launches, "kernel_path_launches": k1_paths})
    want = sum(r["devices"] for r in strips)
    if not all(r["image_equal_serial"] for r in strips):
        fail(f"strips on a rescaled pool: {strips}")
    if k1_launches != want or k1_paths != {"chunked": want}:
        fail(f"strips on a rescaled pool: K1 launched {k1_launches} times ({k1_paths}), "
             f"expected {want}, all chunked")
    return k1_launches, k1_paths, rows


def phase_calibration(torch, ser, placed_rows: list, k2_row: dict) -> list:
    """Calibration on the card (``ClusterRuntime.calibrate``): a D=4 peer
    runtime with sparselu's K=16, B=128 table times lu0, fwd, bdiv and bmod
    on 128 x 128 fp32 blocks (``CALIB_WARMUP`` + ``CALIB_REPS`` calls each,
    on device 0's stream and busy clock: the span an EXEC records) and fits
    the funnel and the peer link; the profile is saved, and a fresh runtime
    loads it and runs K=16 under ``HeftPlacement(estimates="calibrated")``.

    Gated: no cost record of the calibration's own traffic is left; the
    loaded profile equals the live one; a D=2 profile is refused with
    ``StaleProfileError``; the calibrated run equals the serial kernel bit
    for bit with every K2 launch on cp_async and no cold prediction, and
    where it placed every task as the placement phase's HEFT at 5 us did,
    its byte counters equal that run's.  Reported: each kernel's seed beside
    bmod's CUDA-event time (phase 2), each link's fit, FLOPs, bytes and
    intensity per kernel, bmod's roofline fraction, the calibrated wall
    beside HEFT at 5 us, and the run's modeled makespan priced on the
    paper's Ethernet and on the measured links.  Returns the phase's K2
    rows (their launches join the kernel line's)."""
    import tempfile
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import (PAPER_ETHERNET, ClusterRuntime, HeftPlacement,
                                  RuntimeConfig, StaleProfileError)
    from repro_torch.kernels.block_lu import block_lu as k2
    t_phase = time.perf_counter()
    mat = bl._matrix(LU_K, LU_B)
    g = torch.Generator().manual_seed(0)

    def block(dominant=False):
        b = torch.randn(LU_B, LU_B, generator=g)
        return b + LU_B * torch.eye(LU_B) if dominant else b

    operands = {"lu0": (block(True),), "fwd": (block(True), block()),
                "bdiv": (block(True), block()), "bmod": (block(), block(), block())}
    records = ("transfers", "peers", "compute", "events", "placements", "adjustments")

    def runtime(n):
        return ClusterRuntime(RuntimeConfig(n_virtual=n, comm_mode="direct"),
                              table=bl._make_table(LU_K), device="cuda")

    _reset_counts(k2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_calib_") as pdir:
        rt = runtime(LU_DEVICES)
        try:
            t0 = time.perf_counter()
            prof = rt.calibrate(operands, reps=CALIB_REPS, warmup=CALIB_WARMUP,
                                save_dir=pdir)
            calibrate_s = time.perf_counter() - t0
            left = {k: len(getattr(rt.cost, k)) for k in records}
        finally:
            rt.shutdown()
        path = os.path.join(pdir, f"{prof.host['hostname']}.json")
        rt = runtime(2)
        try:
            prof2 = rt.calibrate({"bmod": operands["bmod"]}, reps=2, warmup=1,
                                 sizes=(1 << 14, 1 << 20), load=False)
        finally:
            rt.shutdown()
        calib_launches, calib_paths = k2.launches.count, _path_counts(k2)
        rt = runtime(LU_DEVICES)
        try:
            loaded = rt.load_calibration(path)
            same_profile = loaded.to_dict() == prof.to_dict()
            try:
                rt.load_calibration(prof2)
                stale = None
            except StaleProfileError as e:
                stale = str(e)
            _reset_counts(k2)
            t0 = time.perf_counter()
            res = bl.wavefront(rt, mat, peer=True,
                               policy=HeftPlacement(estimates="calibrated"))
            wall = time.perf_counter() - t0
            launches, paths = k2.launches.count, _path_counts(k2)
            s = rt.cost.summary()
            digest = _placement_digest(rt.cost)
            used = len({c.device for c in rt.cost.compute})
            roof = {r["kernel"]: r for r in rt.cost.roofline_summary()}
            makespan = {"measured_links": rt.cost.makespan(),
                        "measured_links_overlap": rt.cost.makespan(overlap=True)}
            rt.cost.link, rt.cost.peer_link = PAPER_ETHERNET, None
            makespan.update({"paper_ethernet": rt.cost.makespan(),
                             "paper_ethernet_overlap": rt.cost.makespan(overlap=True)})
        finally:
            rt.shutdown()
    heft5 = next(r for r in placed_rows
                 if r["policy"] == "heft-comm" and r["capacity_bytes"] is None)
    diff = float((bl.assemble(res, LU_K) - ser).abs().max())
    same_placements = digest == heft5["placement_digest"]
    counters = {k: s[k] for k in ("bytes_to", "bytes_from", "bytes_peer")}
    heft5_counters = {k: heft5[k] for k in counters}
    row = {"phase": "calibration", "K": LU_K, "B": LU_B, "devices": LU_DEVICES,
           "fabric": "peer", "calibrate_s": calibrate_s, "host": prof.host,
           "cost_records_left": left, "loaded_equals_live": same_profile,
           "d2_profile_refused": stale,
           "calibration_bmod_launches": calib_launches,
           "calibration_bmod_path_launches": calib_paths,
           "kernels": {k: {"seed_s": kp.seconds, "min_s": kp.min_s, "max_s": kp.max_s,
                           "reps": kp.reps, "flops": kp.flops,
                           "bytes_accessed": kp.bytes_accessed, "intensity": kp.intensity,
                           "observed_s": roof[k]["observed_s"],
                           "model_ratio": roof[k]["model_ratio"],
                           "roofline_fraction": roof[k]["roofline_fraction"],
                           "bound": roof[k]["bound"]}
                       for k, kp in prof.kernels.items()},
           "bmod_event_ms": k2_row["ms"],
           "bmod_seed_over_event": prof.kernels["bmod"].seconds / (k2_row["ms"] * 1e-3),
           "skipped_kernels": prof.skipped_kernels,
           "links": {k: {"bandwidth_Bps": lp.bandwidth_Bps, "latency_s": lp.latency_s,
                         "samples": len(lp.samples)} for k, lp in prof.links.items()},
           "wall_s": wall, "heft_5us_wall_s": heft5["wall_s"],
           "wall_ratio_vs_heft_5us": wall / heft5["wall_s"], "devices_used": used,
           "same_placements_as_heft_5us": same_placements, **counters,
           "heft_5us_counters": heft5_counters, "cold_predictions": s["cold_predictions"],
           "modeled_makespan_s": makespan, "bmod_launches": launches,
           "bmod_path_launches": paths, "max_abs_diff_vs_serial": diff,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if any(left.values()):
        fail(f"calibration left cost records behind: {left}")
    if not same_profile:
        fail("the loaded calibration profile differs from the live one")
    if stale is None:
        fail("a D=2 calibration profile was not refused by the D=4 runtime")
    want = CALIB_WARMUP + CALIB_REPS + 1 + 2
    if calib_launches != want or calib_paths["cp_async"] != want:
        fail(f"calibration: bmod launched {calib_launches} times ({calib_paths}); "
             f"expected {want}, every one on cp_async")
    expect = sum(m * m for m in range(LU_K))
    if launches != expect or paths["cp_async"] != launches:
        fail(f"calibrated HEFT: bmod launched {launches} times ({paths}); expected "
             f"{expect}, every one on cp_async")
    if diff != 0.0:
        fail(f"calibrated HEFT: sparselu differs from the serial kernel by {diff}")
    if s["cold_predictions"] != 0:
        fail(f"calibrated HEFT made {s['cold_predictions']} cold predictions")
    if same_placements and counters != heft5_counters:
        fail(f"calibrated HEFT placed as HEFT at 5 us but moved {counters}, "
             f"not {heft5_counters}")
    return [{"bmod_launches": calib_launches, "bmod_path_launches": calib_paths}, row]


def phase_paper_claims(torch):
    """The paper's §5 claims on the card (``repro_torch.run``): every BOTS
    curve at the reference's sizes over ``CLAIM_DEVICES`` (median of three
    runs a point) and ``sparselu.verify("small")``, then the paper-scale
    sweep (``PAPER_CURVES`` over ``PAPER_DEVICES``, one run a point), with
    the launch counts of K1, K2 and the busy loop set to 0 just before and
    read just after.

    Gated: every reference-size curve's byte columns equal ``CLAIM_BYTES``;
    the verification's error is 0.0; every K1 launch ``chunked`` and every
    K2 launch ``cp_async``, each kernel launched.  Reported: each of the six
    claims held or failed with the speedups it read, at the reference's
    sizes and with the paper-scale curves standing in for mandelbrot's and
    sparselu's "large"; each curve's points (compute, modeled
    communication, makespan, speedup, bytes).  A speedup is the measured
    serial seconds over measured EXEC seconds plus modeled communication.
    Returns (K1 launches, K1 by path, the K2 rows, busy-loop launches)."""
    import dataclasses
    from repro_torch import run as prun
    from repro_torch.kernels.block_lu import block_lu as k2
    from repro_torch.kernels.busy_loop import busy_loop as kb
    from repro_torch.kernels.mandelbrot import mandelbrot as k1
    t_phase = time.perf_counter()
    _reset_counts(k1, k2, kb)
    t0 = time.perf_counter()
    curves, err = prun.run_all("cuda", device_counts=CLAIM_DEVICES)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paper = [prun.WORKLOADS[name].run(size, PAPER_DEVICES, repeats=1, warmup=warm,
                                      device="cuda")
             for name, size, warm in PAPER_CURVES]
    paper_s = time.perf_counter() - t0
    k1_launches, k1_paths = k1.launches.count, _path_counts(k1)
    k2_launches, k2_paths = k2.launches.count, _path_counts(k2)
    kb_launches = kb.launches.count

    stand_in = {c.name: dataclasses.replace(c, size="large") for c in paper}
    paper_set = [stand_in.get(c.name, c) if c.size == "large" else c for c in curves]
    columns = {(c.name, c.size): [(p.bytes_to, p.bytes_from) for p in c.points]
               for c in curves}
    bytes_equal = {f"{n}/{s}": columns.get((n, s)) == want
                   for (n, s), want in CLAIM_BYTES.items()}
    row = {"phase": "paper_claims", "device_counts": CLAIM_DEVICES,
           "reference_sizes_s": ref_s, "paper_scale_s": paper_s,
           "paper_curves": [[n, s] for n, s, _ in PAPER_CURVES],
           "claims": prun.paper_claims(curves),
           "failures": prun.check_paper_claims(curves),
           "claims_paper_scale": prun.paper_claims(paper_set),
           "failures_paper_scale": prun.check_paper_claims(paper_set),
           "verify_max_abs_err": err, "bytes_equal_cpu": bytes_equal,
           "curves": [c.to_dict() for c in curves],
           "paper_scale_curves": [c.to_dict() for c in paper],
           "k1_launches": k1_launches, "k1_path_launches": k1_paths,
           "bmod_launches": k2_launches, "bmod_path_launches": k2_paths,
           "busy_loop_launches": kb_launches, "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if not all(bytes_equal.values()):
        fail(f"paper_claims: byte columns differ from the CPU run's: "
             f"{ {k: columns.get(tuple(k.split('/'))) for k, ok in bytes_equal.items() if not ok} }")
    if err != 0.0:
        fail(f"paper_claims: sparselu.verify('small') max abs err {err}, expected 0.0")
    if not (k1_launches and k1_paths["chunked"] == k1_launches):
        fail(f"paper_claims: K1 launched {k1_launches} times, {k1_paths} by path; "
             f"expected every one on chunked")
    if not (k2_launches and k2_paths["cp_async"] == k2_launches):
        fail(f"paper_claims: K2 launched {k2_launches} times, {k2_paths} by path; "
             f"expected every one on cp_async")
    if not kb_launches:
        fail("paper_claims: the fib curves launched no busy-loop kernel")
    return k1_launches, k1_paths, [{"bmod_launches": k2_launches,
                                    "bmod_path_launches": k2_paths}], kb_launches


def phase_calibration_gate(torch) -> list:
    """The calibration acceptance gate on the card
    (``repro_torch.perf_gate.calibration_gate``): K=4, B=64 sparselu on a
    D=4 pool, peer-routed, under HEFT on its frozen defaults and on a
    profile of the synthetic true host's costs, each run's recorded traffic
    re-priced at those costs.  The K2 counts are set to 0 just before and
    read just after.

    Gated: both arms bit for bit; K2 launched ``GATE_BMODS`` times, every
    one on cp_async.  Reported: the win and both true makespans, and whether
    they equal the CPU run's (they are modeled from recorded traffic, so
    they do where the placements agree).  Returns the phase's K2 row."""
    from repro_torch import perf_gate
    from repro_torch.kernels.block_lu import block_lu as k2
    t_phase = time.perf_counter()
    _reset_counts(k2)
    fails, detail = perf_gate.calibration_gate(device="cuda")
    launches, paths = k2.launches.count, _path_counts(k2)
    makespans = (detail["uncalibrated_true_makespan_s"],
                 detail["calibrated_true_makespan_s"])
    row = {"phase": "calibration_gate", "K": perf_gate.K, "B": perf_gate.B,
           "devices": perf_gate.N_DEV, "failures": fails, **detail,
           "cpu_true_makespans_s": GATE_CPU_MAKESPANS,
           "true_makespans_equal_cpu": [a == b for a, b in zip(makespans,
                                                               GATE_CPU_MAKESPANS)],
           "bmod_launches": launches, "bmod_path_launches": paths,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if not detail["bit_identical"]:
        fail(f"calibration_gate: the arms differ: {fails}")
    if launches != GATE_BMODS or paths["cp_async"] != launches:
        fail(f"calibration_gate: bmod launched {launches} times ({paths}); expected "
             f"{GATE_BMODS}, every one on cp_async")
    return [{"bmod_launches": launches, "bmod_path_launches": paths}]


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


def _start_train_child(args):
    """``python -m repro_torch.launch.train ARGS`` in a fresh interpreter."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _train_child(args, stop_after=None, child=None):
    """Run (or, given ``child``, follow) a trainer child to its end; with
    ``stop_after``, SIGTERM it once its log line for that step is out.
    Returns (exit code, its output)."""
    import signal
    child = child or _start_train_child(args)
    lines = []
    try:
        for line in child.stdout:
            lines.append(line)
            if (stop_after is not None and line.startswith("[train] step")
                    and int(line.split()[2]) >= stop_after):
                child.send_signal(signal.SIGTERM)
                stop_after = None
        rc = child.wait(timeout=TRAIN_CHILD_TIMEOUT)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return rc, "".join(lines)


def _train_metrics(path) -> dict:
    with open(path) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _checkpoint_bytes(directory, step) -> dict:
    """A committed checkpoint step's stored arrays, by key."""
    import numpy as np
    with np.load(os.path.join(directory, f"step_{step:08d}", "proc_0.npz")) as z:
        return {k: z[k] for k in z.files}


def _dp_batches(torch, vocab: int) -> list:
    """The DP phase's per-device shards: ``TRAIN_DP_STEPS`` global batches of
    the trainer's stream, ``TRAIN_DP_SEQS`` sequences of 256 per device."""
    from repro_torch.data import DataConfig, SyntheticLM
    D, n = TRAIN_DP_DEVICES, TRAIN_DP_SEQS
    data = SyntheticLM(DataConfig(vocab=vocab, seq=256, global_batch=D * n))
    return [[{k: torch.from_numpy(v[d * n:(d + 1) * n].copy())
              for k, v in data.batch(i).items()} for d in range(D)]
            for i in range(TRAIN_DP_STEPS)]


def _dp_exchanges(torch, device, table, params, shards, update) -> dict:
    """``TRAIN_DP_STEPS`` exchanges of ``data_parallel_grads("lm_grads")``
    in both fabrics from the same host parameters; ``update(params, mean,
    step)`` makes the next ones from the host-mediated mean.  Returns each
    step's largest fabric gap, whether every leaf was allclose, the final
    parameters and the byte counters.  (The fabrics' calls go one after
    the other: issued together from two host threads, the host threads and
    the eight workers contending for the interpreter lock took longer on
    the H100, 85.5 s against 68.0 s.)"""
    from repro_torch.core import ClusterRuntime, RuntimeConfig, _tree
    rts = {mode: ClusterRuntime(RuntimeConfig(n_virtual=TRAIN_DP_DEVICES, comm_mode=mode),
                                table=table, device=device)
           for mode in ("host-mediated", "direct")}
    gaps, ok = [], True
    try:
        for i, shard in enumerate(shards):
            means = {mode: rt.data_parallel_grads("lm_grads", params, shard)
                     for mode, rt in rts.items()}
            h, d = (_tree.leaves(means[k]) for k in ("host-mediated", "direct"))
            ok = ok and all(torch.allclose(y, x, rtol=1e-5, atol=1e-6) for x, y in zip(h, d))
            gaps.append(max(float((y - x).abs().max()) for x, y in zip(h, d)))
            params = update(params, means["host-mediated"], i)
        counters = {mode: {k: rt.cost.summary()[k]
                           for k in ("bytes_to", "bytes_from", "bytes_peer")}
                    for mode, rt in rts.items()}
    finally:
        for rt in rts.values():
            rt.shutdown()
    return {"gaps": gaps, "allclose": ok, "params": params, "bytes": counters}


def dp_cpu_bytes(path: str) -> None:
    """The DP phase's byte counters from a CPU run at the same trees: the
    fp32 full-width parameters (zeros), the same shards, a kernel that
    returns zero gradients of the parameters' tree, and new host parameter
    tensors every step, as an update makes (the counters depend only on the
    maps).  Written to ``path`` as JSON; run in a child beside the card's
    run (``python -c``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import KernelTable, _tree
    from repro_torch.models import Model
    cfg = get_config(TRAIN_ARCH).replace(param_dtype="float32", compute_dtype="float32")
    flat, tdef = _tree.flatten(Model(cfg).init_abstract())
    params = _tree.unflatten(tdef, [torch.zeros(t.shape, dtype=t.dtype) for t in flat])
    zero = KernelTable()
    zero.register("lm_grads", lambda params, batch: {"grads": _tree.unflatten(
        tdef, [torch.zeros_like(x) for x in _tree.leaves(params)])})
    out = _dp_exchanges(torch, "cpu", zero, params, _dp_batches(torch, cfg.vocab),
                        lambda p, mean, i: _tree.unflatten(
                            tdef, [x.clone() for x in _tree.leaves(p)]))
    with open(path, "w") as f:
        json.dump(out["bytes"], f)


def _mean_loss(torch, model, params, batches, group: int = 5) -> float:
    """The mean token loss over ``batches`` (of equal shapes), ``group``
    batches a forward."""
    with torch.no_grad():
        parts = [{k: torch.cat([b[k] for b in batches[i:i + group]]) for k in batches[0]}
                 for i in range(0, len(batches), group)]
        return sum(float(model.loss(params, b)[0]) * len(b["tokens"])
                   for b in parts) / sum(len(b["tokens"]) for b in parts)


def _train_micro_and_dp(torch, dev, cfg, data, tmp):
    """The train phase's parts (c) and (d) (``phase_train``): their rows
    and seconds."""
    from repro_torch.core import KernelTable, _tree
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import lm_grads_kernel, loss_and_grads, make_train_step

    seconds_cd = {}
    # (c) microbatches 1 and 2, fp32 at full width
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = Model(cfg32)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    acfg = AdamWConfig(lr=1e-3)
    opt = AdamW(acfg)
    t0 = time.perf_counter()
    p1, _, m1 = make_train_step(model, opt)(params, opt.init(params), batch)
    p2, _, m2 = make_train_step(model, opt, microbatches=2)(params, opt.init(params), batch)
    torch.cuda.synchronize()
    micro_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g1, g2 = (_tree.leaves(loss_and_grads(model, params, batch, mb)[2]) for mb in (1, 2))
    s1, s2 = (min(1.0, acfg.clip_norm / float(mt["grad_norm"])) for mt in (m1, m2))
    grad_rel = max(float((x - y).norm() / x.norm()) for x, y in zip(g1, g2))
    param_all, param_kept, over = 0.0, 0.0, 0
    for x, y, a_, b_ in zip(_tree.leaves(p1), _tree.leaves(p2), g1, g2):
        d = (x - y).abs()
        kept = torch.minimum(a_.abs() * s1, b_.abs() * s2) >= 100 * acfg.eps
        param_all = max(param_all, float(d.max()))
        param_kept = max(param_kept, float(torch.where(kept, d, 0.0).max()))
        over += int((d > MICRO_PARAM_ATOL).sum())
    loss_rel = abs(float(m1["loss"]) - float(m2["loss"])) / abs(float(m1["loss"]))
    c_row = {
        "dtype": "float32", "batch": [8, 256], "lr": acfg.lr,
        "loss": [float(m1["loss"]), float(m2["loss"])], "loss_rel_diff": loss_rel,
        "grad_max_rel_norm_diff": grad_rel, "clip_scale": [s1, s2],
        "param_max_abs_diff_conditioned": param_kept,
        "param_max_abs_diff_all": param_all, "elements_over_bound": over,
        "bounds": {"loss_rtol": MICRO_RTOL, "grad_rel": 1e-4,
                   "param_atol": MICRO_PARAM_ATOL, "min_clipped_grad": 100 * acfg.eps},
        "wall_s": micro_s}
    seconds_cd["microbatches"] = micro_s + time.perf_counter() - t0
    del p1, p2, m1, m2, g1, g2, batch
    release_card_memory(torch, "train: data-parallel")

    # (d) the runtime as the DP trainer; the CPU's byte counters in a
    # child beside it
    t_dp = time.perf_counter()
    cpu_json = os.path.join(tmp, "dp_cpu_bytes.json")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "src")])}
    cpu_child = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dp_cpu_bytes({cpu_json!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        table = KernelTable()
        table.register("lm_grads", lm_grads_kernel(model))
        tdef = _tree.flatten(params)[1]
        host = _tree.unflatten(tdef, [p.cpu() for p in _tree.leaves(params)])
        del params
        shards = _dp_batches(torch, cfg32.vocab)
        fulls = [{k: torch.cat([s[k] for s in shard]).to(dev) for k in shard[0]}
                 for shard in shards]
        opt = AdamW(AdamWConfig(lr=TRAIN_DP_LR))
        post = []

        def on_card(p):
            return _tree.unflatten(tdef, [x.to(dev) for x in _tree.leaves(p)])

        # the host's AdamW step, computed on the card (2.3 s a step on the
        # host's CPU at this size), its moments kept there; the parameters
        # go back to the host, where the runtime reads them
        state = {"opt": opt.init(on_card(host))}

        def update(p, mean, i):
            new, state["opt"], _ = opt.update(on_card(mean), state["opt"], on_card(p))
            with torch.no_grad():
                post.append(float(model.loss(new, fulls[i])[0]))
            return _tree.unflatten(tdef, [x.cpu() for x in _tree.leaves(new)])

        t0 = time.perf_counter()
        dp = _dp_exchanges(torch, "cuda", table, host, shards, update)
        dp_s = seconds_cd["dp_exchanges"] = time.perf_counter() - t0
        dp_fit = {"initial": _mean_loss(torch, model, on_card(host), fulls),
                  "final": _mean_loss(torch, model, on_card(dp["params"]), fulls)}
        t0 = time.perf_counter()
        out_cpu = cpu_child.communicate(timeout=TRAIN_CHILD_TIMEOUT)[0]
        cpu_wait_s = time.perf_counter() - t0
    finally:
        if cpu_child.poll() is None:
            cpu_child.kill()
            cpu_child.wait()
    cpu_bytes = None
    if cpu_child.returncode == 0:
        with open(cpu_json) as f:
            cpu_bytes = json.load(f)
    d_row = {
        "dtype": "float32", "devices": TRAIN_DP_DEVICES, "seqs_per_device": TRAIN_DP_SEQS,
        "steps": TRAIN_DP_STEPS, "lr": TRAIN_DP_LR, "post_update_losses": post,
        "trained_batches_mean_loss": dp_fit, "fabric_max_abs_diff": dp["gaps"],
        "fabrics_allclose": dp["allclose"], "bytes": dp["bytes"], "cpu_bytes": cpu_bytes,
        "cpu_child": {"rc": cpu_child.returncode, "tail": out_cpu[-400:],
                      "waited_s": cpu_wait_s},
        "bytes_equal_cpu": dp["bytes"] == cpu_bytes, "wall_s": dp_s}
    seconds_cd["data_parallel"] = time.perf_counter() - t_dp
    return (c_row, d_row), seconds_cd


def phase_train(torch, card: str) -> dict:
    """Training on the card, on the plain route (the kernels have no
    backward; no kernel may launch here):

    (a) ``repro_torch.launch.train.main`` in this process: mamba2-130m at its
        full config (bf16), global batch 8 x 256, lr 3e-4 with 10 warmup
        steps, 30 steps, a checkpoint every 10 (async): ms/step (the median
        over ``TRAIN_TIMED``), tok/s, the peak allocated bytes, the losses,
        the mean loss over the 30 trained batches at the initial parameters
        and at the final checkpoint's, and the card's busy share over
        ``TRAIN_PROFILED_STEPS`` more steps of the same step function.
        Gated: every loss finite, the final parameters' mean loss over the
        trained batches below the initial parameters'.
        Reported: the first and last five logged losses' means (each a new
        batch: a walk over 50,280 tokens is not learnable in 30 steps of
        2,048 tokens, each token seen about once);
    (b) the same command for 20 steps in a fresh interpreter, sent SIGTERM
        after its step-10 log line (it must checkpoint and exit 0), then
        resumed with ``--resume`` in another to step 20 (beside (c) and
        (d)), against an uninterrupted 20-step child run beside the first:
        the resumed steps' losses and the final checkpoint (parameters and
        optimizer state) bit for bit;
    (c) one step at full width in fp32 with ``microbatches`` 1 and 2: loss
        within ``MICRO_RTOL``, each leaf's accumulated gradient within 1e-4
        of its norm, and the parameters within ``MICRO_PARAM_ATOL`` wherever
        both runs' clipped gradient is at least 100 x AdamW's eps (Adam's
        first step is g / (|g| + eps): below that, summation-order noise in
        g moves the step by up to lr); the largest difference over every
        element is reported;
    (d) the runtime as the DP trainer: full width in fp32 on D=4 virtual
        devices, 2 sequences x 256 each, ``TRAIN_DP_STEPS`` exchanges of
        ``data_parallel_grads("lm_grads")`` in both fabrics from the same
        host parameters, each followed by the host's AdamW step at lr 3e-3
        (the reference's ``tests/test_system.py``; computed on the card): the fabrics' mean gradients
        within rtol 1e-5; the final parameters' mean loss over the trained
        batches below the initial parameters'; the byte counters equal to a
        CPU run's at the same trees (``dp_cpu_bytes``, in a child beside the
        card's run).  Reported: the loss on each step's batch after its
        update (the reference's last-below-first assert reads these);
    (e) a ``use_kernels=True`` model with parameters that require grad raises
        from K3's, K4's, K5's and K6's wrappers, before any launch."""
    import shutil
    import statistics
    import tempfile
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_decode import flash_decode as k3
    from repro_torch.kernels.grouped_matmul import grouped_matmul as k6
    from repro_torch.kernels.ssd_scan import ssd_scan as k5
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.models.moe import moe_apply
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    mods = (k3, k4, k5, k6)
    _reset_counts(*mods)
    dev = torch.device("cuda", 0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build"))
    row = {"phase": "train", "card": card, "arch": TRAIN_ARCH}
    seconds = row["seconds"] = {}

    try:
        # (a) the trainer, in this process
        args = [*TRAIN_ARGS, "--steps", str(TRAIN_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()         # the trainer's log lines stay off stdout
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = launch_train.main([*args, "--ckpt-dir", os.path.join(tmp, "a"),
                                    "--metrics", os.path.join(tmp, "a.jsonl")])
        wall = seconds["trainer"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        m = _train_metrics(os.path.join(tmp, "a.jsonl"))
        losses = [m[s]["loss"] for s in sorted(m)]
        lo, hi = TRAIN_TIMED
        ms = statistics.median(m[s]["s_per_step"] for s in range(lo, hi + 1)) * 1e3
        cfg = get_config(TRAIN_ARCH)
        model = Model(cfg)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=256, global_batch=8))
        trained = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
                   for i in range(TRAIN_STEPS)]
        final = restore_pytree(os.path.join(tmp, "a"), step=TRAIN_STEPS,
                               template={"params": model.init_abstract()}, device=dev)[0]
        initial = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        fit = {"initial": _mean_loss(torch, model, initial, trained),
               "final": _mean_loss(torch, model, final["params"], trained)}
        del initial
        seconds["fit_eval"] = time.perf_counter() - t0 - wall
        # the busy share: more steps of the trainer's step function from the
        # final state, under torch.profiler (the trainer's run warmed it up)
        opt = AdamW(AdamWConfig(lr=3e-4))
        step = make_train_step(model, opt)
        prof = {"p": final["params"]}
        prof["s"] = opt.init(prof["p"])

        def profiled_steps():
            for b in trained[:TRAIN_PROFILED_STEPS]:
                prof["p"], prof["s"], _ = step(prof["p"], prof["s"], b)

        t1 = time.perf_counter()
        busy = device_busy(torch, profiled_steps)
        seconds["profile"] = time.perf_counter() - t1
        del trained, final, prof
        row["trainer"] = {
            "rc": rc, "steps": TRAIN_STEPS, "wall_s": wall, "ms_per_step": ms,
            "timed_steps": list(TRAIN_TIMED), "tok_per_s": 8 * 256 / (ms * 1e-3),
            "peak_allocated_bytes": peak, "losses": losses,
            "first5_mean": sum(losses[:5]) / 5, "last5_mean": sum(losses[-5:]) / 5,
            "trained_batches_mean_loss": fit,
            "checkpoints": sorted(os.listdir(os.path.join(tmp, "a"))),
            "profiled_steps": TRAIN_PROFILED_STEPS, **busy}
        release_card_memory(torch, "train: preempt and resume")

        # (b) SIGTERM after step 10 in a fresh interpreter, resumed in another
        args = [*TRAIN_ARGS, "--steps", str(RESUME_STEPS)]
        t0 = time.perf_counter()
        uninterrupted = [*args, "--ckpt-dir", os.path.join(tmp, "u"),
                         "--metrics", os.path.join(tmp, "u.jsonl")]
        preempted = [*args, "--ckpt-dir", os.path.join(tmp, "r"),
                     "--metrics", os.path.join(tmp, "r.jsonl")]
        # the uninterrupted child runs beside the preempted one: separate
        # processes, and nothing on this path depends on the card's load
        child_u = _start_train_child(uninterrupted)
        try:
            rc_p, out_p = _train_child(preempted, stop_after=PREEMPT_AFTER)
        finally:
            rc_u, out_u = _train_child(uninterrupted, child=child_u)
        stopped = max(_train_metrics(os.path.join(tmp, "r.jsonl")))
        saved = sorted(os.listdir(os.path.join(tmp, "r")))
        # the resumed child runs beside (c) and (d), which gate correctness
        # only; its result is read after them
        child_r = _start_train_child([*preempted, "--resume"])
        seconds["preempt"] = time.perf_counter() - t0
        release_card_memory(torch, "train: microbatches")
        try:
            (c_row, d_row), seconds_cd = _train_micro_and_dp(torch, dev, cfg, data, tmp)
        except BaseException:
            child_r.kill()
            child_r.wait()
            raise
        seconds.update(seconds_cd)
        t0 = time.perf_counter()
        rc_r, out_r = _train_child([*preempted, "--resume"], child=child_r)
        resume_s = seconds["resume_wait"] = time.perf_counter() - t0
        full = _train_metrics(os.path.join(tmp, "u.jsonl"))
        got = _train_metrics(os.path.join(tmp, "r.jsonl"))
        losses_equal = (sorted(got) == sorted(full) == list(range(1, RESUME_STEPS + 1))
                        and all(got[s]["loss"] == full[s]["loss"] for s in full))
        a = _checkpoint_bytes(os.path.join(tmp, "u"), RESUME_STEPS)
        b = _checkpoint_bytes(os.path.join(tmp, "r"), RESUME_STEPS)
        state_equal = sorted(a) == sorted(b) and all(
            a[k].tobytes() == b[k].tobytes() for k in a)
        row["resume"] = {
            "rc": {"uninterrupted": rc_u, "preempted": rc_p, "resumed": rc_r},
            "sigterm_after_step": PREEMPT_AFTER, "stopped_at_step": stopped,
            "checkpoints_at_exit": saved,
            "checkpointed_on_signal": "checkpoint-and-exit" in out_p,
            "resumed_from": [l for l in out_r.splitlines() if "resumed" in l],
            "losses_bitwise": losses_equal, "final_state_bitwise": state_equal,
            "checkpoint_leaves": len(a), "waited_s": resume_s}
        row["microbatches"], row["data_parallel"] = c_row, d_row
        del a, b
        release_card_memory(torch, "train: guard")

        # (e) the kernel routes refuse gradients on the card
        t0 = time.perf_counter()
        row["guard"] = _train_guard(torch, dev, get_smoke_config, Model, moe_apply)
        seconds["guard"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["kernel_launches"] = {mod.__name__.rsplit(".", 1)[-1]: mod.launches.count
                              for mod in mods}
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    tr, rs, mb, dp = row["trainer"], row["resume"], row["microbatches"], row["data_parallel"]
    if tr["rc"] != 0 or not all(math.isfinite(x) for x in tr["losses"]):
        fail(f"train: the trainer returned {tr['rc']}, losses {tr['losses']}")
    fit = tr["trained_batches_mean_loss"]
    if not fit["final"] < fit["initial"]:
        fail(f"train: the trained batches' loss did not fall: {fit}")
    if rs["rc"] != {"uninterrupted": 0, "preempted": 0, "resumed": 0}:
        fail(f"train: a trainer child failed: {rs['rc']}")
    if not (rs["checkpointed_on_signal"] and PREEMPT_AFTER <= rs["stopped_at_step"] < RESUME_STEPS):
        fail(f"train: the SIGTERM'd child did not stop and checkpoint mid-run: {rs}")
    if not (rs["losses_bitwise"] and rs["final_state_bitwise"]):
        fail(f"train: the resumed run differs from the uninterrupted one: {rs}")
    if not (mb["loss_rel_diff"] <= MICRO_RTOL and mb["grad_max_rel_norm_diff"] <= 1e-4
            and mb["param_max_abs_diff_conditioned"] < MICRO_PARAM_ATOL):
        fail(f"train: microbatches 1 and 2 differ: {mb}")
    if not (dp["fabrics_allclose"] and dp["bytes_equal_cpu"]
            and dp["trained_batches_mean_loss"]["final"]
            < dp["trained_batches_mean_loss"]["initial"]):
        fail(f"train: the DP trainer failed: {dp}")
    if not all(row["guard"].values()):
        fail(f"train: a kernel route did not refuse a gradient: {row['guard']}")
    if any(row["kernel_launches"].values()):
        fail(f"train: the plain route launched kernels: {row['kernel_launches']}")
    return row


def _train_guard(torch, dev, get_smoke_config, Model, moe_apply) -> dict:
    """Each of K3-K6 refuses a gradient on CUDA tensors: a ``use_kernels=True``
    model's loss (K4: minitron-4b's smoke config; K5: mamba2-130m's), its
    decode step (K3) and an MoE layer (K6: moonshot-v1-16b-a3b's), each with
    parameters that require grad; the refusal names the kernel."""
    from repro_torch.core import _tree

    def grad_params(arch):
        cfg = get_smoke_config(arch).replace(use_kernels=True)
        model = Model(cfg)
        p = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        return model, _tree.unflatten(_tree.flatten(p)[1],
                                      [x.requires_grad_(True) for x in _tree.leaves(p)])

    def refuses(kernel, fn) -> bool:
        try:
            fn()
        except RuntimeError as e:
            return kernel in str(e) and "use_kernels=False" in str(e)
        return False

    tok = torch.randint(0, 100, (2, 16), device=dev, dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    dense, dense_p = grad_params("minitron-4b")
    ssm, ssm_p = grad_params("mamba2-130m")
    moe, moe_p = grad_params("moonshot-v1-16b-a3b")
    with torch.no_grad():           # the cache from the plain route: no launch
        _, cache, pos = Model(dense.cfg.replace(use_kernels=False)).prefill(
            _tree.unflatten(_tree.flatten(dense_p)[1],
                            [x.detach() for x in _tree.leaves(dense_p)]),
            {"tokens": tok}, cache_len=32)
    x = torch.randn(2, 16, moe.cfg.d_model, device=dev, dtype=torch.bfloat16)
    layer = _tree.unflatten(_tree.flatten(moe_p["layers"]["moe"])[1],
                            [v[0] for v in _tree.leaves(moe_p["layers"]["moe"])])
    return {
        "flash_attention": refuses("flash_attention", lambda: dense.loss(dense_p, batch)),
        "flash_decode": refuses("flash_decode", lambda: dense.decode_step(
            dense_p, tok[:, :1], cache, pos)),
        "ssd_scan": refuses("ssd_scan", lambda: ssm.loss(ssm_p, batch)),
        "grouped_matmul": refuses("grouped_matmul", lambda: moe_apply(layer, x, moe.cfg)),
    }


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


def phase_serve_pool(torch):
    """Pool-mode serving (``ServeEngine(runtime=...)``): minitron-4b at full
    width (bf16, the serve phase's random weights from seed 0) on a
    ``POOL_DEVICES``-device runtime, each request a prefill TaskNode (K4 per
    layer, B = 1, S = 512) and a decode TaskNode a step (K3 per layer, B = 1)
    on a virtual device's worker thread and stream, over device-resident
    weights (one copy per device) and one-sequence caches.  Runs: (a) 8
    requests under SLO; (b) under round-robin; (c) round-robin with each
    device's capacity at the weights' bytes + 1.5 caches (cold caches spill
    and refetch); (d) ``POOL_MIGRATION``'s 4 requests under round-robin with
    ``migrate_every=1``; (e) the local engine on the same weights, wave mode
    at ``batch=1`` on the eager route (the same B = 1 shapes: an unpadded
    prefill, then B = 1 decodes).  Each run's launch counts are set to 0
    just before and read just after.

    Gated: (a), (b), (c) and (e) give equal tokens, (d) (e)'s on its
    requests; every request its full budget; (c) at least one eviction and
    one refetch; (d) at least one migration; every K4 launch ``wgmma`` and
    every K3 ``split``, K4 once a layer per request and K3 once a layer per
    decode; each pool's final ``sync()`` raises nothing.  Reported: tokens/s,
    prefill and decode seconds and bytes of each run, evictions and
    refetches, peak card memory, and the share of tokens equal to a local
    batch-4 captured continuous run's (other GEMM shapes may move bf16
    rounding: not gated)."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import ClusterRuntime, KernelTable, RuntimeConfig
    from repro_torch.kernels.flash_attention import flash_attention as k4mod
    from repro_torch.kernels.flash_decode import flash_decode as k3mod
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH).replace(use_kernels=True)
    L = cfg.n_layers
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    weights_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).tolist() for _ in range(8)]
    reqs = [Request(i, p, max_new_tokens=POOL_BUDGETS[i % len(POOL_BUDGETS)])
            for i, p in enumerate(prompts)]
    mig_reqs = [Request(j, prompts[j], max_new_tokens=n) for j, n in POOL_MIGRATION]
    mods = (k4mod, k3mod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def measured(eng, rs, name, **extra):
        _reset_counts(*mods)
        t0 = time.perf_counter()
        res = eng.serve(rs)
        if eng.runtime is not None:
            eng.runtime.pool.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(r.tokens) for r in res.values())
        run = {"run": name, "requests": len(rs), "wall_s": wall, "new_tokens": tokens,
               "tokens_per_s": tokens / wall,
               "prefill_s": sum(r.prefill_s for r in res.values()),
               "decode_s": sum(r.decode_s for r in res.values()),
               "full_budgets": all(len(res[r.rid].tokens) == r.max_new_tokens
                                   and not res[r.rid].timed_out for r in rs),
               "expected_k4": L * len(rs),
               "expected_k3": L * sum(r.max_new_tokens - 1 for r in rs),
               **_kernel_counts(mods), **extra}
        return run, {rid: r.tokens for rid, r in res.items()}

    def pool_run(name, rs, policy, cap=None, **kw):
        # a table of its own: the serve entries go when the runtime does
        rt = ClusterRuntime(RuntimeConfig(n_virtual=POOL_DEVICES, device_capacity_bytes=cap),
                            table=KernelTable(), device="cuda")
        try:
            eng = ServeEngine(model, params, ServeConfig(batch=SERVE_BATCH,
                                                         max_len=SERVE_MAX_LEN, **kw),
                              runtime=rt, policy=policy)
            run, tokens = measured(eng, rs, name, policy=policy, capacity_bytes=cap)
            s = rt.cost.summary()
            mem = rt.memory_report()
            run.update({"bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
                        "bytes_peer": s["bytes_peer"], "migrations": eng.migrations,
                        "evictions": sum(m["evictions"] for m in mem.values()),
                        "refetches": sum(m["refetches"] for m in mem.values()),
                        "cache_bytes": sum(t.nbytes for t in _leaves(eng._ctpl)),
                        "execs_by_device": [sum(1 for c in rt.pool.trace
                                                if c.op == "EXEC" and c.device == d)
                                            for d in range(POOL_DEVICES)]})
        finally:
            rt.shutdown()
        del rt, eng
        gc.collect()
        torch.cuda.empty_cache()
        return run, tokens

    runs, toks = {}, {}
    runs["slo"], toks["slo"] = pool_run("slo", reqs, "slo")
    runs["round_robin"], toks["round_robin"] = pool_run("round_robin", reqs, "round-robin")
    cap = weights_bytes + int(1.5 * runs["slo"]["cache_bytes"])
    runs["capped"], toks["capped"] = pool_run("capped", reqs, "round-robin", cap=cap)
    runs["migration"], toks["migration"] = pool_run("migration", mig_reqs, "round-robin",
                                                    migrate_every=1)
    peak = torch.cuda.max_memory_allocated()
    local = ServeEngine(model, params, ServeConfig(batch=1, max_len=SERVE_MAX_LEN,
                                                   mode="wave"), eager=True)
    runs["local_b1"], toks["local_b1"] = measured(local, reqs, "local_b1")
    captured = ServeEngine(model, params, ServeConfig(batch=SERVE_BATCH,
                                                      max_len=SERVE_MAX_LEN))
    runs["local_b4_captured"], toks["local_b4_captured"] = measured(
        captured, reqs, "local_b4_captured")
    del local, captured, params, model
    gc.collect()
    torch.cuda.empty_cache()

    ref = toks["local_b1"]
    agree = sum(a == b for rid in ref for a, b in zip(ref[rid], toks["local_b4_captured"][rid]))
    mig_equal = all(toks["migration"][r.rid] == ref[r.rid][:r.max_new_tokens]
                    for r in mig_reqs)
    row = {"phase": "serve_pool", "arch": SERVE_ARCH, "layers": L, "d_model": cfg.d_model,
           "devices": POOL_DEVICES, "weights_bytes": weights_bytes, "capacity_bytes": cap,
           "runs": runs, "peak_allocated_bytes": peak,
           "pool_tokens_equal_local_b1": {n: toks[n] == ref
                                          for n in ("slo", "round_robin", "capped")},
           "migration_tokens_equal_local_b1": mig_equal,
           "local_b4_captured_agreement": agree / sum(len(t) for t in ref.values()),
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    for name, r in runs.items():
        if not r["full_budgets"]:
            fail(f"serve_pool {name}: a request did not get its full token budget")
        if name == "local_b4_captured":
            continue
        if (r["flash_attention_launches"], r["flash_decode_launches"]) != \
                (r["expected_k4"], r["expected_k3"]):
            fail(f"serve_pool {name}: K4/K3 launched {r['flash_attention_launches']}/"
                 f"{r['flash_decode_launches']} times, expected {r['expected_k4']}/"
                 f"{r['expected_k3']}")
    _check_k4_paths(f"{SERVE_ARCH} pool", runs)
    _check_k3_paths(f"{SERVE_ARCH} pool", runs)
    if not all(row["pool_tokens_equal_local_b1"].values()):
        fail(f"serve_pool: pool tokens differ from the local batch=1 run's: "
             f"{row['pool_tokens_equal_local_b1']}")
    if not (runs["capped"]["evictions"] >= 1 and runs["capped"]["refetches"] >= 1):
        fail(f"serve_pool capped: {runs['capped']['evictions']} evictions, "
             f"{runs['capped']['refetches']} refetches; expected at least one of each")
    if runs["migration"]["migrations"] < 1 or not mig_equal:
        fail(f"serve_pool migration: {runs['migration']['migrations']} migrations, "
             f"tokens equal the local run's: {mig_equal}")
    return runs


def phase_serve_load(torch):
    """Open-loop serving (``repro_torch.serve_load``) at ``SERVE_ARCH``'s full
    width (random weights from seed 0, the kernels on) on the reference's
    traces and 64-token cache: section 1 (continuous against waves, n = 16)
    in fp32 and in bf16, then section 2 (SLO against round-robin on a D=2
    pool capped at the weights + 5.5 caches, n = 30, ``LOAD_REPS`` runs) in
    bf16.  Each section's K3 and K4 counts are set to 0 just before it and
    read just after.

    Gated: each section's requests and tokens are ``LOAD_COUNTS``; fp32
    section 1's tokens are identical in both engines; section 2's SLO and
    round-robin tokens are bit for bit equal; every bf16 K4 launch is
    ``wgmma``; every K3 launch is on the path ``decode_path`` plans for a
    64-row cache (one 64-row unit: ``single``).  Reported: tokens/s, p50
    and p99, migrations, evictions and refetches, each ``checks`` entry, and
    bf16 section 1's token agreement between the engines.  The checks that
    hang on the open-loop timing are findings, not gates: the p99 and
    tokens/s orders, and ``spills_positive`` (the cap binds only when more
    than 5.5 caches pile onto one device, which the arrivals, 1.3x a
    closed-loop burst's measured rate, may not do; ``serve_pool`` gates the
    spill path at its tighter cap)."""
    from repro_torch import serve_load as sl
    from repro_torch.kernels.flash_attention import flash_attention as k4mod
    from repro_torch.kernels.flash_decode import flash_decode as k3mod
    from repro_torch.kernels.flash_decode.flash_decode import decode_path

    t_phase = time.perf_counter()
    mods = (k4mod, k3mod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, sections = {}, {}

    def section(name, fn, model, params, **kw):
        _reset_counts(*mods)
        t0 = time.perf_counter()
        sec = fn(n=LOAD_COUNTS[name][0], model=model, params=params, **kw)
        torch.cuda.synchronize()
        return sec, {"section_s": time.perf_counter() - t0, **_kernel_counts(mods)}

    for dtype in ("float32", "bfloat16"):
        model, params = sl._model(SERVE_ARCH, dtype, full=True)
        name = f"continuous_vs_wave_{dtype}"
        sections[name], runs[name] = section("continuous_vs_wave",
                                             sl.run_continuous_vs_wave, model, params)
        if dtype == "float32":
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
    cfg = model.cfg
    cap = sl._capacity_bytes(model, params, caches=10 / 2 + 0.5)
    sections["slo_vs_roundrobin"], runs["slo_vs_roundrobin"] = section(
        "slo_vs_roundrobin", sl.run_slo_vs_roundrobin, model, params, reps=LOAD_REPS)
    peak = torch.cuda.max_memory_allocated()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()

    meta = torch.device("meta")
    k3_path = decode_path(torch.empty(1, cfg.n_heads, cfg.head_dim, device=meta),
                          torch.empty(1, sl.MAX_LEN, cfg.n_kv, cfg.head_dim, device=meta))
    tokens = {name: sec.pop("tokens") for name, sec in sections.items()}
    LOAD_SECTIONS.update(sections)
    bf = tokens["continuous_vs_wave_bfloat16"]
    agree = sum(a == b for rid in bf["wave"]
                for a, b in zip(bf["wave"][rid], bf["continuous"][rid]))
    counts = {name: {e: (sec[e]["requests"], sec[e]["tokens"])
                     for e in sec if isinstance(sec[e], dict) and "tokens" in sec[e]}
              for name, sec in sections.items()}
    row = {"phase": "serve_load", "arch": SERVE_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "max_len": sl.MAX_LEN, "capacity_bytes": cap,
           "sections": sections, "runs": runs, "k3_planned_path": k3_path,
           "bf16_token_agreement": agree / sum(len(t) for t in bf["wave"].values()),
           "failed_checks": sl.failed_checks(sections),
           "peak_allocated_bytes": peak, "allocated_after_bytes": left,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    for name, by_engine in counts.items():
        want = LOAD_COUNTS["slo_vs_roundrobin" if name.startswith("slo") else
                           "continuous_vs_wave"]
        if set(by_engine.values()) != {want}:
            fail(f"serve_load {name}: (requests, tokens) {by_engine}, expected {want}")
    if not sections["continuous_vs_wave_float32"]["checks"]["tokens_identical"]:
        fail("serve_load: fp32 continuous tokens differ from the wave engine's")
    s2 = sections["slo_vs_roundrobin"]["checks"]
    if not s2["tokens_identical"]:
        fail(f"serve_load slo_vs_roundrobin: {s2}; SLO and round-robin tokens must be "
             f"equal")
    _check_k4_paths(f"{SERVE_ARCH} serve_load",
                    {k: r for k, r in runs.items() if not k.endswith("float32")})
    for name, r in runs.items():
        if not (r["flash_attention_launches"] and r["flash_decode_launches"]):
            fail(f"serve_load {name}: K4/K3 launched {r['flash_attention_launches']}/"
                 f"{r['flash_decode_launches']} times")
        if r["flash_decode_paths"][k3_path] != r["flash_decode_launches"]:
            fail(f"serve_load {name}: K3 launched {r['flash_decode_launches']} times, "
                 f"{r['flash_decode_paths']} by path; expected every one on {k3_path}")
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
    # the route comparisons below run ~9 GB under the card's 80 GB: hand the
    # engines' freed segments back first, so the allocator is not left with
    # only fragments of them
    gc.collect()
    torch.cuda.empty_cache()

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


# launch_serve: repro_torch.launch.serve's CLI at full width, then the
# offload_serve example's pool loop on POOL_DEVICES virtual devices
LAUNCH_SERVE_ARGS = ("--arch", SERVE_ARCH, "--preset", "full", "--requests", "8",
                     "--batch", "4", "--prompt-len", "512", "--max-new", "16",
                     "--max-len", "1024", "--dtype", "bfloat16")
OFFLOAD_SERVE_ARGS = ("--pool", "--devices", str(POOL_DEVICES), "--arch", SERVE_ARCH,
                      "--preset", "full")
# bench_trajectory: the perf gate's benches run as children on the card
# (serve is held from the serve_load phase's sections, not run again)
TRAJECTORY_BENCHES = ("comm", "sched", "topo")
NOISE_BAND_PCT = 15.0
#: the build's report (nvcc seconds and -Xptxas -v logs per library)
BUILD_REPORT: dict = {}
#: the serve_load phase's sections, for the trajectory gate's serve compare
LOAD_SECTIONS: dict = {}


def phase_launch_serve(torch):
    """``repro_torch.launch.serve.main`` on the card at ``SERVE_ARCH``'s full
    width (``LAUNCH_SERVE_ARGS``: 8 requests of 512 tokens, batch 4, 16 new
    tokens, a 1024-row cache, bf16, random weights from seed 0), its K3/K4
    counts set to 0 just before and read just after; then a ``ServeEngine``
    driven directly with the CLI's weights, requests and config; then
    ``repro_torch.examples.offload_serve`` with ``OFFLOAD_SERVE_ARGS`` (the
    streaming submit/step loop lowered onto a 2-device pool under SLO, at
    full width: its own weights from seed 0, one resident copy per device,
    beside nothing else on the card).

    Gated: the CLI's greedy tokens equal the direct engine's bit for bit;
    every K4 launch ``wgmma`` (the CLI's continuous prefills are pad-masked,
    so K4 launches in offload_serve's B = 1 prefills only) and every K3 of
    the CLI and the direct engine ``split``, K3 in each run and K4 in
    offload_serve; every offload_serve request its budget (the example's own
    assert)."""
    from repro_torch.examples import offload_serve
    from repro_torch.kernels.flash_attention import flash_attention as k4mod
    from repro_torch.kernels.flash_decode import flash_decode as k3mod
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    mods = (k4mod, k3mod)
    runs, out = {}, {}
    _reset_counts(*mods)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = launch_serve.main(list(LAUNCH_SERVE_ARGS), out=out)
    torch.cuda.synchronize()
    runs["launch_serve"] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                            "serve_wall_s": out["wall_s"], **out["graph_stats"],
                            **_kernel_counts(mods)}
    cli = {rid: r.tokens for rid, r in out["results"].items()}
    eng = ServeEngine(out["model"], out["params"], out["serve_config"],
                      frontend_seq=out["frontend_seq"])
    _reset_counts(*mods)
    t0 = time.perf_counter()
    direct = {rid: r.tokens for rid, r in eng.serve(out["requests"]).items()}
    torch.cuda.synchronize()
    runs["direct_engine"] = {"wall_s": time.perf_counter() - t0, **_kernel_counts(mods)}
    n_new = sum(len(t) for t in cli.values())
    del eng, out
    release_card_memory(torch, "launch_serve: offload_serve")

    pool_out = {}
    _reset_counts(*mods)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc_pool = offload_serve.main(list(OFFLOAD_SERVE_ARGS), out=pool_out)
    torch.cuda.synchronize()
    runs["offload_serve"] = {
        "rc": rc_pool, "wall_s": time.perf_counter() - t0,
        "requests": len(pool_out["requests"]),
        "new_tokens": sum(len(r.tokens) for r in pool_out["results"].values()),
        "full_budgets": all(len(pool_out["results"][r.rid].tokens) == r.max_new_tokens
                            for r in pool_out["requests"]),
        "migrations": pool_out["migrations"], "evictions": pool_out["evictions"],
        "refetches": pool_out["refetches"], **_kernel_counts(mods)}
    del pool_out
    row = {"phase": "launch_serve", "argv": list(LAUNCH_SERVE_ARGS),
           "offload_argv": list(OFFLOAD_SERVE_ARGS), "config": "full width",
           "requests": len(cli), "new_tokens": n_new,
           "tokens_equal_direct_engine": cli == direct, **runs,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if rc != 0 or rc_pool != 0:
        fail(f"launch_serve: the CLI returned {rc}, offload_serve {rc_pool}")
    if cli != direct:
        fail("launch_serve: the CLI's tokens differ from the engine driven directly")
    if not runs["offload_serve"]["full_budgets"]:
        fail("launch_serve: an offload_serve request did not get its budget")
    served = {k: r for k, r in runs.items() if k != "offload_serve"}
    _check_k4_paths(f"{SERVE_ARCH} launch_serve", runs)
    _check_k3_paths(f"{SERVE_ARCH} launch_serve", served)
    # the CLI serves continuously: its prefills are pad-masked and take the
    # plain attention (as the serve phase's continuous run), so K4 runs in
    # offload_serve's unmasked B = 1 prefills
    for name, r in runs.items():
        if not r["flash_decode_launches"] or (name == "offload_serve"
                                              and not r["flash_attention_launches"]):
            fail(f"launch_serve {name}: K4/K3 launched {r['flash_attention_launches']}/"
                 f"{r['flash_decode_launches']} times")
    return runs


def phase_bench_trajectory(torch):
    """The perf gate's trajectory half on the card
    (``repro_torch.perf_gate.trajectory_gate``): ``comm_modes --smoke``,
    ``sched_policies`` and ``topo_collectives --smoke`` as child processes
    on the card, all at once, each held against its committed
    ``BENCH_*.json`` within ``NOISE_BAND_PCT``; and the serve_load phase's
    sections (fp32 section 1, bf16 section 2) against ``BENCH_serve.json``
    through the same ``compare`` (the open-loop load is not run again).

    Gated: no failure; the sched and topo children launched K2, every
    launch on ``cp_async``.  Returns the children's K2 and wire-kernel
    launches."""
    from repro_torch import perf_gate
    t_phase = time.perf_counter()
    fails, detail = perf_gate.trajectory_gate(NOISE_BAND_PCT, device="cuda",
                                              names=TRAJECTORY_BENCHES)
    with open(os.path.join(perf_gate.BENCH_DIR, "BENCH_serve.json")) as f:
        base = json.load(f)
    fresh = {"benchmark": "serve_load", "sections": {
        "continuous_vs_wave": LOAD_SECTIONS["continuous_vs_wave_float32"],
        "slo_vs_roundrobin": LOAD_SECTIONS["slo_vs_roundrobin"]}}
    serve_fails = perf_gate.compare("serve", base, fresh, NOISE_BAND_PCT)
    detail["serve"] = {"status": "fail" if serve_fails else "ok",
                       "gated_metrics": perf_gate.n_gated("serve", base),
                       "failures": serve_fails, "from": "phase serve_load"}
    fails += serve_fails
    k2 = {name: detail[name].get("launches", {}).get("block_lu", {})
          for name in ("sched", "topo")}
    q8 = sum(d.get("launches", {}).get("q8_wire", {}).get("launches", 0)
             for d in detail.values())
    row = {"phase": "bench_trajectory", "noise_band_pct": NOISE_BAND_PCT,
           "failures": fails, "detail": detail, "bmod": k2, "q8_wire_launches": q8,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if fails:
        fail(f"bench_trajectory: {fails}")
    for name, c in k2.items():
        if not c.get("launches") or c["paths"]["cp_async"] != c["launches"]:
            fail(f"bench_trajectory {name}: bmod launched {c}; expected every launch "
                 f"on cp_async")
    return ([{"bmod_launches": c["launches"], "bmod_path_launches": c["paths"]}
             for c in k2.values()], q8)


def phase_dryrun_roofline(torch):
    """``repro_torch.launch.dryrun --all`` on ``meta`` (every cell's
    parameters, moments, inputs and cache counted, nothing allocated), then
    ``repro_torch.roofline`` renders ``build/roofline_table.md``.

    Gated: ``torch.cuda.memory_allocated`` unchanged across the dry run;
    every non-skipped cell written.  Reported: each cell's ``fits_one_card``
    and bound."""
    from repro_torch import roofline
    from repro_torch.configs import ARCHS, shape_cells
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    out = os.path.join(ROOT, "build", "dryrun")
    shutil.rmtree(out, ignore_errors=True)
    log = io.StringIO()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with contextlib.redirect_stdout(log):
        rc = dryrun.main(["--all", "--out", out])
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    cells = {}
    for fn in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        cells[f"{rec['arch']} x {rec['shape']}"] = {
            "fits_one_card": rec["fits_one_card"],
            "argument_GB": rec["memory_analysis"]["argument_bytes"] / 1e9,
            "bottleneck": rec["bottleneck"],
            "t_bound_s": max(rec["t_compute_s"], rec["t_memory_s"])}
    want = sum(1 for a in ARCHS for _, st, _ in shape_cells(a) if st == "run")
    table = os.path.join(ROOT, "build", "roofline_table.md")
    with contextlib.redirect_stdout(log):
        rc_roof = roofline.main(["--dryrun", out, "--out", table])
    row = {"phase": "dryrun_roofline", "rc": rc, "roofline_rc": rc_roof,
           "allocated_before": before, "allocated_after": after, "cells": cells,
           "fits_one_card": sum(c["fits_one_card"] for c in cells.values()),
           "table": os.path.relpath(table, ROOT), "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if rc != 0 or rc_roof != 0 or len(cells) != want:
        fail(f"dryrun_roofline: dryrun {rc}, roofline {rc_roof}, {len(cells)} of {want} cells")
    if after != before:
        fail(f"dryrun_roofline: the dry run moved memory_allocated {before} -> {after}")


def phase_kernels_bench(torch):
    """``python -m repro_torch.kernels_bench`` on the card, in a child
    process (a fresh interpreter's profiler: in this process, after the
    earlier phases' profiled runs, the exported trace once held no kernel
    event on the H100): the tensor-core kernels' resources per CTA (this
    run's ``-Xptxas -v`` logs, handed over, and one profiled launch at each
    served shape) and K4's and K5's timed rows beside their plain versions;
    its calibration profile goes to ``build/calibration/`` for the roofline
    table.  Gated: every timed row finite and on the tensor-core path, every
    tile row with its served launch recorded.  Returns the child's launch
    counts."""
    t_phase = time.perf_counter()
    tmp = os.path.join(ROOT, "build", "kernels_bench")
    os.makedirs(tmp, exist_ok=True)
    paths = {k: os.path.join(tmp, f"{k}.json") for k in ("logs", "rows", "launches")}
    with open(paths["logs"], "w") as f:
        json.dump({name: r["log"] for name, r in BUILD_REPORT.items()}, f)
    profile = os.path.join(ROOT, "build", "calibration", "kernels_bench.json")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels_bench", "--ptxas-logs", paths["logs"],
         "--rows", paths["rows"], "--launches", paths["launches"], "--json", profile],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"kernels_bench exited {proc.returncode}: {proc.stdout[-1500:]} "
             f"{proc.stderr[-1500:]}")
    with open(paths["rows"]) as f:
        rows = json.load(f)
    with open(paths["launches"]) as f:
        launches = json.load(f)
    counts = {}
    for name, c in launches.items():
        counts[f"{name}_launches"] = c["launches"]
        counts[f"{name}_paths"] = c["paths"]
    row = {"phase": "kernels_bench",
           "rows": [{k: v for k, v in r.items() if not k.startswith("_")} for r in rows],
           "profile": os.path.relpath(profile, ROOT), **counts,
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    for r in rows:
        if "ms" in r:
            if not (math.isfinite(r["ms"]) and r["ms"] > 0 and r["path"] == "wgmma"):
                fail(f"kernels_bench: {r}")
        elif not (r["launches"] and r["launches"][0]["name"]):
            fail(f"kernels_bench: no launch recorded at {r['kernel']}'s served shape: {r}")
    return counts


def roofline_shares(torch, waves: dict, train_row: dict) -> dict:
    """Report, not gate: ``launch.hlo_analysis.analyze_step``'s memory and
    compute terms at the H100's roofs beside each served config's measured
    decode seconds a step (its captured wave, batch 4, the cache at the
    prompt plus half the budget), and the train phase's ms a step beside
    ``analyze_step(cfg, "train", 256, 8)``: the bound's share of the
    measured step.  The share divides by the port's bound
    (``cost="port"``: no recompute, only routed experts);
    ``reference_bound_share`` by the reference's count, beside it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_analysis import analyze_step

    def row(cfg, kind, seq, batch, step):
        rf = analyze_step(cfg, kind, seq, batch)
        ref = analyze_step(cfg, kind, seq, batch, cost="reference")
        return {"kind": kind, "seq": seq, "batch": batch, "t_memory_s": rf.t_memory,
                "t_compute_s": rf.t_compute, "measured_s_per_step": step,
                f"{kind}_roofline_share": rf.t_bound / step if step else None,
                "reference_t_memory_s": ref.t_memory, "reference_t_compute_s": ref.t_compute,
                "reference_bound_share": ref.t_bound / step if step else None}
    out = {arch: row(get_config(arch), "decode", SERVE_PROMPT + budget // 2, SERVE_BATCH,
                     run["decode_s_per_step"])
           for arch, (run, budget) in waves.items()}
    out[f"{TRAIN_ARCH} train"] = row(get_config(TRAIN_ARCH), "train", 256, 8,
                                     train_row["trainer"]["ms_per_step"] * 1e-3)
    emit({"phase": "roofline_shares", "card": train_row["card"], "shares": out})
    return out


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
    k1_launches, k1_paths, mandel_img, mandel_s = phase_mandelbrot(torch)
    lu_rows = [_sparselu_once(torch, LU_K, LU_B, LU_DEVICES)]
    _sparselu_once(torch, *LU_LARGE, LU_DEVICES)
    lu_rows += phase_sparselu_fabric(torch, lu_rows[0])
    kq8, kq8_launches, dp_ref = phase_dp_fabric(torch, peaks)
    placed_k1, placed_paths, placed_rows, lu_ser, lu_placed = phase_placement(
        torch, lu_rows[1], mandel_img, mandel_s)
    fault_k1, fault_paths, fault_rows = phase_fault_recovery(
        torch, lu_ser, lu_placed, lu_rows, placed_rows, mandel_img, dp_ref)
    del lu_placed
    strag_k1, strag_paths, strag_rows = phase_stragglers(torch, lu_ser, lu_rows, fault_rows,
                                                         mandel_img, mandel_s)
    ck_k1, ck_paths, ck_rows = phase_checkpoint_elastic(torch, lu_ser, lu_rows, placed_rows,
                                                        mandel_img)
    cal_rows = phase_calibration(torch, lu_ser, placed_rows, k2)
    gate_rows = phase_calibration_gate(torch)
    del mandel_img
    kbusy, kbusy_launches = phase_fib_alignment(torch, peaks)
    claims_k1, claims_paths, claims_rows, claims_busy = phase_paper_claims(torch)
    kbusy_launches += claims_busy
    release_card_memory(torch, "phase_train")
    train_row = phase_train(torch, card)
    for launches, paths in ((placed_k1, placed_paths), (fault_k1, fault_paths),
                            (strag_k1, strag_paths), (ck_k1, ck_paths),
                            (claims_k1, claims_paths)):
        k1_launches += launches
        k1_paths = {p: k1_paths.get(p, 0) + paths.get(p, 0) for p in {*k1_paths, *paths}}
    lu_rows += placed_rows + fault_rows + strag_rows + ck_rows + cal_rows + gate_rows
    lu_rows += claims_rows
    serve_runs, waves = [], {}
    for phase, arch, budget in ((phase_serve, SERVE_ARCH, WAVE_BUDGET),
                                (phase_launch_serve, None, None),
                                (phase_serve_pool, None, None),
                                (phase_serve_load, None, None),
                                (phase_serve_moe, MOE_ARCH, MOE_WAVE_BUDGET)):
        release_card_memory(torch, phase.__name__)
        runs = phase(torch)
        serve_runs += runs.values()
        if arch:
            waves[arch] = (runs["wave"], budget)
    for arch, n in ((HYBRID_ARCH, HYBRID_PARAMS), (SSM_ARCH, SSM_PARAMS)):
        release_card_memory(torch, f"phase_serve_state {arch}")
        runs = phase_serve_state(torch, arch, n)
        serve_runs += runs.values()
        waves[arch] = (runs["wave"], STATE_WAVE_BUDGET)
    release_card_memory(torch, "phase_bench_trajectory")
    traj_rows, traj_q8 = phase_bench_trajectory(torch)
    lu_rows += traj_rows
    kq8_launches += traj_q8
    serve_runs.append(phase_kernels_bench(torch))
    phase_dryrun_roofline(torch)
    roofline_shares(torch, waves, train_row)
    k2_launches = sum(r["bmod_launches"] for r in lu_rows)
    k2_paths = {p: sum(r["bmod_path_launches"][p] for r in lu_rows)
                for p in lu_rows[0]["bmod_path_launches"]}

    def served(kernel):
        """A kernel's launches over every serve run, and per path."""
        paths: dict = {}
        for r in serve_runs:
            for p, n in r.get(f"{kernel}_paths", {}).items():
                paths[p] = paths.get(p, 0) + n
        return sum(r.get(f"{kernel}_launches", 0) for r in serve_runs), paths
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": card, "peaks": peaks, "card_memory": CARD_MEMORY})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path_launches")
    rows = [
        {**k1, "route": "cuda", "source": "src/repro_torch/csrc/mandelbrot.cu",
         "replaces": "src/repro/kernels/mandelbrot/mandelbrot.py:18",
         "launches": k1_launches, "path_launches": k1_paths},
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
