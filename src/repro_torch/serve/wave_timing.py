"""Time wave-mode serving of full-size models on the card.

    PYTHONPATH=src python -m repro_torch.serve.wave_timing \\
        --arch minitron-4b --arch moonshot-v1-16b-a3b --arch zamba2-2.7b

For each architecture: random weights from seed 0 in the config's dtype
(bf16), the kernels on, four prompts of 512 tokens drawn from seed 0, one
wave prefill and ``--budget - 1`` batched decodes, served ``--repeats``
times after one warm-up serve (``--eager``: on the eager decode route).
Prints one JSON line per architecture with
each run's wall seconds, new tokens per second, prefill seconds and decode
seconds (host clock around work that ends in a synchronize), and the card's
busy share of one more serve, run under ``torch.profiler`` (not timed);
then the card's name.  It imports only the package found on
``PYTHONPATH``, so running this file by path against another checkout's
``src`` compares two versions of the port on one card, in turns.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Tuple

import numpy as np
import torch


def time_waves(arch: str, budget: int, repeats: int, eager: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_config(arch).replace(use_kernels=True)
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 512).tolist(), max_new_tokens=budget)
            for i in range(4)]
    # the keyword only when asked: an older checkout's engine has none
    eng = ServeEngine(model, params, ServeConfig(batch=4, max_len=1024, mode="wave"),
                      **({"eager": True} if eager else {}))
    runs = []
    for i in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(r.tokens) for r in res.values())
        if i:                                   # the first serve warms up
            runs.append({"wall_s": wall, "tokens_per_s": tokens / wall,
                         "prefill_s": sum(r.prefill_s for r in res.values()),
                         "decode_s": sum(r.decode_s for r in res.values())})
    busy = busy_share(lambda: eng.serve(reqs))
    del eng, params, model
    torch.cuda.empty_cache()
    return {"arch": arch, "budget": budget, "eager": eager, "runs": runs,
            "busy_share": busy}


def profiled(fn) -> Tuple[list, float, float]:
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity): the device
    events it recorded (kernels and copies), the run's wall seconds, and
    the seconds of the union of those events' intervals (the card busy)."""
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
    return events, wall, busy_us * 1e-6


def busy_share(fn) -> float:
    """The card's busy share of one run of ``fn``: busy seconds over wall
    seconds (:func:`profiled`)."""
    _, wall, busy = profiled(fn)
    return busy / wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--budget", type=int, default=16, help="new tokens per request")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--eager", action="store_true",
                    help="decode on the eager route (ServeEngine(eager=True))")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wave_timing needs a CUDA card")
    for arch in args.arch:
        print(json.dumps(time_waves(arch, args.budget, args.repeats, args.eager)),
              flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
