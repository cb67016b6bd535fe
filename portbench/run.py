#!/usr/bin/env python3
"""Run one cell of the port's serving benchmark on the card.

    python3 portbench/run.py --workload minitron-4b.chat --seed 12345 \\
        --seconds 51 --trace 0

From the root of a checkout.  The cell, its configuration, traffic mix,
limits and metric readers are found by name from ``BENCHMARK.json``.  The
program under test is ``repro_torch`` from the checkout's ``src``: its
``ServeEngine`` serves the cell's traffic for ``--seconds`` after a set-up
that builds the kernels (first run in a checkout only), makes the weights on
the card from ``--seed`` and warms every shape the traffic uses.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, read under ``torch.profiler``),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number the correctness check compared, beside its limit, which also end
standard error.  Exits non-zero, printing no result, without a CUDA card,
with fewer cards than the cell asks for, without the program, or if JAX or
the JAX package was loaded.  Caches, Python's bytecode among them, go under
``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Python's own compile cache, at a fixed place in the checkout: the first run
# compiles torch's and the program's modules to bytecode, later runs load it
# (an environment may set PYTHONDONTWRITEBYTECODE; without the cache every
# run's set-up recompiles torch)
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from pb import imports, spec
    spec.set_cache_env(ROOT)
    bench = spec.load_benchmark(ROOT)
    cell = spec.resolve_cell(bench, args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no program under test at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 4
    sys.path.insert(0, str(ROOT / "src"))
    from pb import cell as runner
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    found = imports.forbidden()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 5
    for name, (value, limit) in out["check"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
