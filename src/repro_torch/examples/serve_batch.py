"""End-to-end serving driver: batched requests against a small LM.

The port's counterpart of ``examples/serve_batch.py``: builds an
architecture's config (a reduced gemma-7b by default), then serves a queue
of prompts in wave batches with greedy decoding — the serving-side analogue
of the paper's task offloading (each wave is one 'target region' worth of
work; see ``repro_torch.examples.offload_serve`` for the literal
multi-device version).

The reference's flags, plus ``--device`` (the card unless asked otherwise),
and ``--preset`` (on the card serve ``--preset full``: the smoke configs'
head dims are not the attention kernels').  Weights are
random from a ``torch.Generator`` seeded with 0 on the device; prompts come
from ``np.random.default_rng(0)``, as the reference draws them.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --device cpu

``main(argv, out=d)`` also puts ``results``, ``requests``, ``model``,
``params`` and ``serve_config`` into the dict ``d``.
"""
from __future__ import annotations

import argparse
import sys
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
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.preset == "full"
           else get_smoke_config(args.arch)).replace(use_kernels=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    serve_cfg = ServeConfig(batch=args.batch, max_len=96, temperature=0.0,
                            mode="wave")
    engine = ServeEngine(model, params, serve_cfg, device=dev)

    rng = np.random.default_rng(0)
    requests = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab,
                                            rng.integers(4, 12)).tolist(),
                        max_new_tokens=args.max_new)
                for i in range(args.requests)]
    results = engine.serve(requests)
    for rid in sorted(results)[:6]:
        r = results[rid]
        print(f"req {rid:2d}: {len(r.tokens)} tokens "
              f"(prefill {r.prefill_s*1e3:.1f} ms, decode {r.decode_s*1e3:.1f} "
              f"ms amortized) {r.tokens[:8]}...")
    assert all(len(results[i].tokens) == args.max_new
               for i in range(args.requests))
    if out is not None:
        out.update(results=results, requests=requests, model=model,
                   params=params, serve_config=serve_cfg)
    print("all requests served.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
