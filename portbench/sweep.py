#!/usr/bin/env python3
"""Find an open-loop cell's knee: serve its traffic at several rates, one
window each, in one process (one set-up, the engine drained between
windows).

    python3 portbench/sweep.py --workload minitron-4b.chat --seed 7 \\
        --seconds 40 --rates 1.0,1.5,2.0,2.5,3.0

Prints one JSON line a rate: tokens a second, TTFT and TPOT quantiles, and
the queue (requests due and not yet admitted) at the window's middle and
at its close.  The knee is the highest rate whose queue at the close is no
longer than at the middle, and whose requests all finish; a cell's traffic
file offers 0.8 x the knee.  The sweep stops
after two rates in a row miss.  Reads and writes only inside the checkout.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from pb import spec
    spec.set_cache_env(ROOT)
    import torch
    from pb import cell as runner
    from pb.loop import Window
    from pb.traffic import make_requests
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    c = spec.resolve_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    device = torch.device("cuda", 0)
    su = runner.Setup(c, args.seed, device)
    torch.cuda.synchronize()
    print(json.dumps({"workload": c.name, "setup_s": time.perf_counter() - T_START,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    knee, misses = None, 0
    for rate in [float(r) for r in args.rates.split(",")]:
        reqs = make_requests(su.traffic, args.seconds, args.seed, su.cfg.vocab, rate=rate)
        w = Window(su.engine, reqs, su.traffic, args.seconds)
        tl = w.run()
        su.engine.drain()           # nothing of this rate's load reaches the next
        lo, hi = tl.window
        row = {"rate_rps": rate, **tl.summary(), "decodes": w.decodes,
               "queue_mid": tl.queue_at(lo + args.seconds / 2), "queue_end": tl.queue_at(hi),
               "drain_s": tl.step_ends[-1] - hi if tl.step_ends else 0.0}
        row["holds"] = (row["queue_end"] <= row["queue_mid"]
                        and row["finished"] == row["requests"])
        misses = 0 if row["holds"] else misses + 1
        if row["holds"]:
            knee = rate
        print(json.dumps(row), flush=True)
        if misses == 2:
            break
    print(json.dumps({"knee_rps": knee, "offer_rps": None if knee is None else 0.8 * knee}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
