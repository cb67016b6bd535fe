"""Serving entry point: batched generation over any assigned architecture.

The port's counterpart of ``repro/launch/serve.py``, with the reference's
flags plus ``--device`` (the card unless asked otherwise) and ``--dtype``
(parameter and compute dtype; default the config's own).  Weights are
random, drawn from ``torch.Generator(device).manual_seed(seed)``; prompts
come from ``np.random.default_rng(seed)``, as the reference draws them.
The engine serves on the kernel route (``use_kernels``): on the card the
attention kernels take head dims 64, 80, 128 and 256, so an attention
family's smoke config (head dim 16 or 32) serves only on the CPU, and a
published config (``--preset full``) on the card.

On the CPU, at the smoke preset:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
        --preset smoke --requests 8 --max-new 16 --device cpu

On the card, minitron-4b at its published width:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --preset full --requests 8 --batch 4 --prompt-len 512 --max-new 16 \\
        --max-len 1024 --dtype bfloat16

``main(argv, out=d)`` also puts the run's pieces into the dict ``d``
(``results``, ``requests``, ``model``, ``params``, ``serve_config``,
``frontend_seq``, ``wall_s``), so that a caller can hold its tokens
against an engine it drives itself.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..configs.registry import get_config, get_smoke_config
from ..models.model import Model
from ..serve import Request, ServeConfig, ServeEngine


def main(argv=None, *, out: Optional[Dict[str, Any]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="parameter and compute dtype (default: the config's)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.preset == "full"
           else get_smoke_config(args.arch))
    cfg = cfg.replace(use_kernels=True)
    if args.dtype is not None:
        cfg = cfg.replace(param_dtype=args.dtype, compute_dtype=args.dtype)
    if cfg.is_encdec or cfg.family == "vlm":
        print(f"[serve] note: {args.arch} needs frontend embeddings; the "
              "demo serves its text decoder with token prompts only.",
              flush=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len).tolist(),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]

    frontend_seq = (8 if (cfg.is_encdec or cfg.family == "vlm") else 0)
    serve_cfg = ServeConfig(batch=args.batch, max_len=args.max_len,
                            temperature=args.temperature, seed=args.seed)
    engine = ServeEngine(model, params, serve_cfg, frontend_seq=frontend_seq,
                         device=dev)
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid].tokens[:12]} ...", flush=True)
    if out is not None:
        out.update(results=results, requests=reqs, model=model, params=params,
                   serve_config=serve_cfg, frontend_seq=frontend_seq,
                   wall_s=wall, graph_stats=engine.graph_stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
