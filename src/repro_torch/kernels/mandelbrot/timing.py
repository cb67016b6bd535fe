"""Time the mandelbrot kernel (K1) on the card, against other builds of it.

    PYTHONPATH=src python -m repro_torch.kernels.mandelbrot.timing \\
        [--baseline path/to/mandelbrot.cu] [--chunk K ...] [--rounds 15]

At the main path's shape (the whole 4600 x 4600 image, ``max_iter`` 300):
the kernel as the package builds it; with ``--baseline``, another version
of ``csrc/mandelbrot.cu`` (one with the same C entry point
``mandelbrot_rows``, such as an earlier commit's); and with each
``--chunk K``, ``csrc/mandelbrot.cu`` built with ``-DMANDELBROT_CHUNK=K``.
The other builds go to a temporary directory with the package's ``nvcc``
flags.  Every version is first held bit for bit against the plain version.
Then ``--rounds`` rounds in turns (baseline, kernel, kernel, baseline, then
each chunk; the order reversed every other round), each sample the device
milliseconds per call over ``--reps`` back-to-back launches timed with CUDA
events.  Prints one JSON line: each version's median and quartiles, the
bound (7 and 8 separately rounded fp32 operations per counted iteration at
the H100 SXM's 33.5 T/s), the loops of each version's SASS (``cuobjdump
-sass``: instructions, FMUL, FADD per backward branch), and the card's name
and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import _build
from . import mandelbrot as k1
from .ref import XMAX, XMIN, YMAX, YMIN, mandelbrot_rows_ref

SIZE, MAX_ITER = 4600, 300
FP32_UNFUSED = 33.5e12          # H100 SXM: one separately rounded fp32 op a slot


def _build_variant(source: Path, lib: Path, *flags: str) -> Path:
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(source)],
                   check=True, capture_output=True, text=True)
    return lib


def _variant_fn(lib: Path):
    fn = ctypes.CDLL(str(lib)).mandelbrot_rows
    fn.argtypes = k1.ARGTYPES
    fn.restype = ctypes.c_int
    n = SIZE
    f32 = lambda x: float(np.float32(x))
    step_x, step_y = f32((XMAX - XMIN) / (n - 1)), f32((YMAX - YMIN) / (n - 1))

    def call(rows, out):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(rows.data_ptr(), out.data_ptr(), rows.shape[0], n, f32(XMIN),
                        step_x, f32(YMIN), step_y, MAX_ITER, stream), lib.name)
        return out
    return call


def _ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--chunk", type=int, action="append", default=[])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mandelbrot timing needs a CUDA card")
    n = SIZE
    rows = torch.arange(n, dtype=torch.int32, device="cuda")
    plain = mandelbrot_rows_ref(rows, n, n, MAX_ITER)
    counts = float(plain.to(torch.int64).sum())
    versions = {"kernel": lambda: k1.mandelbrot_rows_cuda(rows, n, n, MAX_ITER)}
    _build.library("mandelbrot")            # built before its SASS is read
    libs = {"kernel": _build.lib_path("mandelbrot")}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {f"chunk{k}": (_build.CSRC / "mandelbrot.cu", f"-DMANDELBROT_CHUNK={k}") for k in args.chunk}
        if args.baseline is not None:
            builds["baseline"] = (args.baseline,)
        for name, (source, *flags) in builds.items():
            libs[name] = _build_variant(source, Path(tmp) / f"lib{name}.so", *flags)
            call, out = _variant_fn(libs[name]), torch.empty_like(plain)
            versions[name] = lambda call=call, out=out: call(rows, out)
        sass = {name: _build.sass_loops(_build.sass(lib), "mandelbrot_rows_kernel")
                for name, lib in libs.items()}
        equal = {name: bool(torch.equal(fn(), plain)) for name, fn in versions.items()}
        torch.cuda.synchronize()
        times = {name: [] for name in versions}
        turn = (["baseline", "kernel", "kernel", "baseline"] if args.baseline else ["kernel"])
        turn += [f"chunk{k}" for k in args.chunk]
        for name in versions:                   # warm-up, not kept
            _ms(versions[name], args.reps)
        for i in range(args.rounds):
            for name in (turn if i % 2 == 0 else turn[::-1]):
                times[name].append(_ms(versions[name], args.reps))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    summary = {name: {"median_ms": float(np.median(t)),
                      "quartiles_ms": [float(q) for q in np.percentile(t, [25, 75])]}
               for name, t in times.items()}
    print(json.dumps({"size": n, "max_iter": MAX_ITER, "rounds": args.rounds,
                      "reps": args.reps, "chunk": k1.CHUNK,
                      "sum_counts": counts, "bit_equal_plain": equal,
                      "bound_ms_7op": 7 * counts / FP32_UNFUSED * 1e3,
                      "bound_ms_8op": 8 * counts / FP32_UNFUSED * 1e3,
                      "times": summary, "sass_loops": sass, "card": card}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
