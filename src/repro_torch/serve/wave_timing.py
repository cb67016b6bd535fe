"""Time wave-mode serving of full-size models on the card.

    PYTHONPATH=src python -m repro_torch.serve.wave_timing \\
        --arch minitron-4b --arch moonshot-v1-16b-a3b --arch zamba2-2.7b

For each architecture: random weights from seed 0 in the config's dtype
(bf16), the kernels on, four prompts of 512 tokens drawn from seed 0, one
wave prefill and ``--budget - 1`` batched decodes, served ``--repeats``
times after one warm-up serve.  Prints one JSON line per architecture with
each run's wall seconds, new tokens per second, prefill seconds and decode
seconds (host clock around work that ends in a synchronize), then the card's
name.  It imports only the package found on ``PYTHONPATH``, so running this
file by path against another checkout's ``src`` compares two versions of the
port on one card, in turns.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def time_waves(arch: str, budget: int, repeats: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = get_config(arch).replace(use_kernels=True)
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 512).tolist(), max_new_tokens=budget)
            for i in range(4)]
    eng = ServeEngine(model, params, ServeConfig(batch=4, max_len=1024, mode="wave"))
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
    del eng, params, model
    torch.cuda.empty_cache()
    return {"arch": arch, "budget": budget, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--budget", type=int, default=16, help="new tokens per request")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wave_timing needs a CUDA card")
    for arch in args.arch:
        print(json.dumps(time_waves(arch, args.budget, args.repeats)), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
