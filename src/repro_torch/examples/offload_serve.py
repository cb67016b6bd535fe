"""Continuous serving on the TaskGraph IR — local and cluster-pool modes.

The port's counterpart of ``examples/offload_serve.py``.  The continuous
batcher streams requests through a fixed set of decode slots: sequences
join and leave at step boundaries, so a short request never waits out a
long neighbour (no head-of-line blocking, unlike the wave loop in
``repro_torch.examples.serve_batch``).

With ``--pool`` the same loop is lowered onto a device pool: each decode
step is one TaskGraph whose nodes run where the sequence's KV cache is
resident, :class:`~..core.SloPlacement` admits new sequences onto the
shallowest backlog, and hot caches migrate off the deepest queue
(``--migrate-every``).  ``--capacity-mb`` caps per-device memory so cold
caches spill to host and refetch transparently — tokens are bit-identical
either way.

The reference's flags, plus ``--device`` (the card unless asked otherwise),
and ``--preset``: the smoke configs' head dims (16, 32) are not the
attention kernels', so on the card serve ``--preset full``.  Weights
are random from a ``torch.Generator`` seeded with 0 on the device; the
requests come from ``np.random.default_rng(0)``, as the reference draws
them.

    PYTHONPATH=src python -m repro_torch.examples.offload_serve --device cpu
    PYTHONPATH=src python -m repro_torch.examples.offload_serve --pool \\
        --devices 2 --device cpu
    PYTHONPATH=src python -m repro_torch.examples.offload_serve --pool \\
        --devices 2 --arch minitron-4b --preset full   # card

``main(argv, out=d)`` also puts ``results``, ``requests`` and (pool mode)
``migrations``, ``evictions`` and ``refetches`` into the dict ``d``.
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


def make_requests(cfg, n, rng):
    reqs = []
    for i in range(n):
        budget = 16 if i % 3 == 0 else int(rng.integers(3, 8))
        prompt = rng.integers(1, cfg.vocab, int(rng.integers(4, 12))).tolist()
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=budget))
    return reqs


def main(argv=None, *, out: Optional[Dict[str, Any]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pool", action="store_true",
                    help="lower the loop onto a cluster device pool")
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--policy", default="slo",
                    choices=["slo", "round-robin", "heft", "locality"])
    ap.add_argument("--migrate-every", type=int, default=4)
    ap.add_argument("--capacity-mb", type=float, default=0.0,
                    help="per-device memory cap in MiB (0 = uncapped)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.preset == "full"
           else get_smoke_config(args.arch)).replace(use_kernels=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs = make_requests(cfg, args.requests, np.random.default_rng(0))

    runtime = None
    if args.pool:
        from ..core import ClusterRuntime, KernelTable, RuntimeConfig
        cap = int(args.capacity_mb * 2**20) or None
        # a kernel table of its own: the serve entries go with the runtime
        runtime = ClusterRuntime(RuntimeConfig(
            n_virtual=args.devices, device_capacity_bytes=cap),
            table=KernelTable(), device=dev)
    try:
        engine = ServeEngine(
            model, params,
            ServeConfig(batch=args.batch, max_len=96,
                        migrate_every=args.migrate_every if args.pool else 0),
            runtime=runtime, policy=args.policy if args.pool else None,
            device=dev)

        # the streaming API: feed requests in two batches, stepping between
        # them — late arrivals slot in as earlier sequences retire
        engine.submit(*reqs[: len(reqs) // 2])
        results, late_sent = {}, False
        while len(results) < len(reqs):
            if not late_sent and len(results) >= len(reqs) // 4:
                engine.submit(*reqs[len(reqs) // 2:])
                late_sent = True
            for res in engine.step():
                results[res.rid] = res

        for rid in sorted(results)[:6]:
            r = results[rid]
            print(f"req {rid:2d}: {len(r.tokens):2d} tokens "
                  f"(prefill {r.prefill_s * 1e3:6.1f} ms, decode "
                  f"{r.decode_s * 1e3:6.1f} ms amortized) {r.tokens[:6]}...")
        assert all(len(results[r.rid].tokens) == r.max_new_tokens
                   for r in reqs)
        if out is not None:
            out.update(results=results, requests=reqs)
        if args.pool:
            runtime.pool.sync()
            stats = [runtime.pool.present[d].stats()
                     for d in range(args.devices)]
            print(f"pool: policy={args.policy} "
                  f"migrations={engine.migrations} "
                  f"evictions={[s['evictions'] for s in stats]} "
                  f"refetches={[s['refetches'] for s in stats]}")
            if out is not None:
                out.update(migrations=engine.migrations,
                           evictions=[s["evictions"] for s in stats],
                           refetches=[s["refetches"] for s in stats])
        print(f"all {len(results)} requests served.")
    finally:
        if runtime is not None:
            runtime.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
