"""The paper's §5 claims on the port: twin of ``benchmarks/run.py``.

Runs the four BOTS workloads as speedup curves over device counts

  Figs 2–3  alignment   (strip offload, one-shot broadcast — scales)
  Figs 4–5  mandelbrot  (strip offload, result strips — scales with size)
  Figs 6–7  fib         (recursive unroll-then-offload — imbalance-limited)
  Figs 8–9  sparselu    (host-mediated wavefront — comm-bound, no speedup)

then ``sparselu.verify("small")``, and applies the reference's claim checks
with the reference's thresholds.  A speedup is the measured serial time
over measured EXEC seconds plus modeled communication (``bots/common.py``).

    python -m repro_torch.run                  # on the card
    python -m repro_torch.run --device cpu     # the plain kernels on the CPU

writes ``build/bench/results.json`` (``--out``) in the reference's layout and
exits 1 if a claim fails or the verification error exceeds 1e-3.  The
reference's ``comm_modes``, ``kernels_bench`` and roofline sections are not
part of this module.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ._device import DeviceLike
from .bots import alignment, fib, mandelbrot, sparselu
from .bots.common import Curve, save_results

WORKLOADS = {"alignment": alignment, "mandelbrot": mandelbrot, "fib": fib,
             "sparselu": sparselu}
SIZES = ("small", "large")
DEVICE_COUNTS = (1, 2, 4, 8)
# (workload, size, device counts): one curve each
Plan = Sequence[Tuple[str, object, Sequence[int]]]


def paper_claims(curves) -> List[Dict]:
    """The six qualitative findings of §5 on ``curves``, one row each: the
    reference's failure string, whether the claim held, and the speedups it
    read (``benchmarks/run.py::check_paper_claims``'s thresholds)."""
    by = {(c.name, c.size): c for c in curves}

    def sp(name, size, devs):
        c = by[(name, size)]
        return next(p.speedup for p in c.points if p.devices == devs)

    al2, al8 = sp("alignment", "large", 2), sp("alignment", "large", 8)
    ms8, ml8 = sp("mandelbrot", "small", 8), sp("mandelbrot", "large", 8)
    fs8, fl8 = sp("fib", "small", 8), sp("fib", "large", 8)
    lu = {f"{s}@{d}": sp("sparselu", s, d) for s in SIZES for d in (2, 4, 8)}
    return [
        # Figs 2–3: alignment scales with devices; large ≥ 4× at 8 devices
        {"failure": "alignment does not scale with devices",
         "held": al8 > al2 > 1.2, "speedups": {"large@2": al2, "large@8": al8}},
        {"failure": "alignment large-input speedup below linear-ish",
         "held": not al8 < 4.0, "speedups": {"large@8": al8}},
        # Figs 4–5: mandelbrot speedup grows with image size (at 8 devices)
        {"failure": "mandelbrot speedup does not grow with image size",
         "held": ml8 >= ms8 * 0.9, "speedups": {"small@8": ms8, "large@8": ml8}},
        # Figs 6–7: fib small has ~no speedup (≤1.5); large positive but < ideal
        {"failure": "fib small-input should not benefit (paper: 0.91)",
         "held": not fs8 > 1.5, "speedups": {"small@8": fs8}},
        {"failure": "fib large should give modest (imbalance-limited) speedup",
         "held": 1.2 < fl8 < 7.5, "speedups": {"large@8": fl8}},
        # Figs 8–9: sparselu gains nothing at any device count
        {"failure": "sparselu should be comm-bound (no speedup)",
         "held": not any(v > 1.0 for v in lu.values()), "speedups": lu},
    ]


def check_paper_claims(curves) -> list:
    """The qualitative findings of §5, asserted on our curves: the failure
    strings of the claims that did not hold, in the reference's order."""
    return [c["failure"] for c in paper_claims(curves) if not c["held"]]


def run_all(device: DeviceLike = "cuda", sizes: Sequence = SIZES,
            device_counts: Sequence[int] = DEVICE_COUNTS, repeats: int = 3, *,
            plan: Optional[Plan] = None,
            echo: bool = False) -> Tuple[List[Curve], float]:
    """Run the curves and ``sparselu.verify("small")``; returns ``(curves,
    verify max abs error)``.  ``plan`` names the curves explicitly as
    ``(workload, size, device counts)`` triples; by default every workload at
    each of ``sizes`` over ``device_counts``, in the reference's order.
    ``echo`` prints each curve's :meth:`~.bots.common.Curve.render` as it
    lands."""
    plan = plan or [(name, size, device_counts) for name in WORKLOADS
                    for size in sizes]
    curves = []
    for name, size, counts in plan:
        c = WORKLOADS[name].run(size, tuple(counts), repeats=repeats,
                                device=device)
        curves.append(c)
        if echo:
            print(c.render(), flush=True)
            print()
    err = sparselu.verify("small", device=device)
    if echo:
        print(f"sparselu distributed == serial: max abs err {err:.2e}\n",
              flush=True)
    return curves, err


def _parse_curve(text: str) -> Tuple[str, str, Tuple[int, ...]]:
    """``workload:size[:d,d,...]`` → a plan triple."""
    parts = text.split(":")
    if len(parts) not in (2, 3) or parts[0] not in WORKLOADS:
        raise argparse.ArgumentTypeError(
            f"expected WORKLOAD:SIZE[:D,D,...] with WORKLOAD in "
            f"{sorted(WORKLOADS)}, got {text!r}")
    counts = (tuple(int(d) for d in parts[2].split(","))
              if len(parts) == 3 else DEVICE_COUNTS)
    return parts[0], parts[1], counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the virtual devices live (default: cuda)")
    ap.add_argument("--out", default=os.path.join("build", "bench"),
                    help="directory of results.json (default: build/bench)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs per point; each point is their median")
    ap.add_argument("--curve", action="append", type=_parse_curve,
                    metavar="WORKLOAD:SIZE[:D,...]",
                    help="run only these curves (repeatable) and check no "
                         "claim")
    args = ap.parse_args(argv)

    curves, err = run_all(args.device, repeats=args.repeats, plan=args.curve,
                          echo=True)
    path = os.path.join(args.out, "results.json")
    save_results(path, curves)
    print(f"wrote {path}", flush=True)

    if args.curve:
        print("(--curve: the paper claims are not checked)")
    failures = [] if args.curve else check_paper_claims(curves)
    if err > 1e-3:
        failures.append(f"sparselu verification error {err}")
    if failures:
        print("\nPAPER-CLAIM CHECK FAILURES:", flush=True)
        for f in failures:
            print("  -", f)
        return 1
    print("\nall paper-claim checks PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
