#!/usr/bin/env python3
"""Read a cell's correctness number for the program and for its control,
seed after seed, in one process.

    python3 portbench/control.py --workload minitron-4b.chat \\
        --seeds 11,12,13 --seconds 20

For each seed the weights are drawn anew in place, the cell's traffic is
served for ``--seconds`` at the cell's own load (drained to the end), and
the same sample a run compares goes through the float32 reference twice:
the program's widest logit gap, and the control's, the reference in float8
e4m3 matrix products put in the program's place (``pb.reference.FP8``),
which picks its own best token at each served position.  Prints one JSON
line a seed.  A limit sits between the program's highest reading and the
control's lowest (``limits/<cell>.json``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from pb import spec
    spec.set_cache_env(ROOT)
    import torch
    from pb import cell as runner
    from pb.control_run import readings
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    c = spec.resolve_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    su = runner.Setup(c, seeds[0], torch.device("cuda", 0))
    for row in readings(su, seeds, args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
