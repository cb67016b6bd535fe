"""Serving under open-loop Poisson load: twin of ``benchmarks/serve_load.py``.

Continuous batching against fixed waves, and tail-aware placement against
round-robin, each driven by the same seeded open-loop generator (arrivals
are Poisson — a request arrives whether or not the engine is ready, so
queueing delay counts against latency):

* **continuous_vs_wave** (local engine): the same request trace served by
  the fixed-wave loop and by the continuous batcher, at ~1.5x the wave
  engine's measured service rate.  Checks: continuous sustains more
  tokens/s and a lower p99 latency, with identical greedy tokens per
  request.

* **slo_vs_roundrobin** (pool mode, capacity-capped caches): bimodal token
  budgets; round-robin places by admission parity and piles the long
  sequences onto one device, :class:`~.core.SloPlacement` admits onto the
  shallowest backlog and migrates a hot cache off the tail
  (``migrate_every``).  Checks: identical tokens, the cap binding (spills
  or refetches somewhere in the run), and SLO's p99 below round-robin's.

The reference asserts its checks inline; here each section returns them
in a ``checks`` dict, and the CLI exits 1 when one is false.

    python -m repro_torch.serve_load --smoke --device cpu
    python -m repro_torch.serve_load --smoke --arch minitron-4b --full  # card
    python -m repro_torch.serve_load --smoke --json build/bench/BENCH_serve.json

``--json`` writes ``{"benchmark": "serve_load", "sections": ...}``, the
layout of the reference's ``BENCH_serve.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .configs import get_config, get_smoke_config
from .core import ClusterRuntime, KernelTable, RuntimeConfig, _tree
from .interop import params_from_numpy
from .models import Model
from .serve import Request, ServeConfig, ServeEngine

ARCH = "gemma-7b"
MAX_LEN = 64


def _model(arch: str = ARCH, dtype: Optional[str] = None, *,
           params: Any = None, full: bool = False,
           device: DeviceLike = "cuda"):
    """``(model, params)``: ``arch``'s smoke config (``full``: its published
    config) with the kernels on, its parameters and compute in ``dtype``
    (default the config's own), and random weights from a
    ``torch.Generator`` seeded with 0 on ``device`` — or ``params``,
    the reference's parameter tree as numpy arrays, carried across.  On the
    card the attention kernels take head dims 64, 80, 128 and 256, so the
    smoke configs (gemma-7b's 32, minitron-4b's 16) serve only on the CPU;
    on the card serve a published config (``full``)."""
    dev = resolve_device(device)
    cfg = (get_config(arch) if full else get_smoke_config(arch))
    cfg = cfg.replace(use_kernels=True)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    model = Model(cfg)
    if params is not None:
        return model, params_from_numpy(params, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return model, model.init(gen, device=dev)


def _trace(model, n: int, seed: int, prompt_len: int = 8,
           long_every: int = 3, long_budget: int = 24) -> List[Request]:
    """Bimodal budgets (short interactive + long generations) — the mix
    that punishes head-of-line blocking and unbalanced queues."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        budget = long_budget if i % long_every == 0 \
            else int(rng.integers(3, 6))
        prompt = [int(t) for t in rng.integers(1, model.cfg.vocab, prompt_len)]
        reqs.append(Request(i, prompt, max_new_tokens=budget))
    return reqs


def _arrivals(n: int, rate_per_s: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_per_s, n))


def _metrics(lat_s: Dict[int, float], results, wall_s: float) -> Dict:
    lats = np.asarray(sorted(lat_s.values()))
    toks = sum(len(r.tokens) for r in results.values())
    return {"requests": len(results), "tokens": toks, "wall_s": wall_s,
            "tokens_per_s": toks / wall_s,
            "p50_ms": float(np.percentile(lats, 50) * 1e3),
            "p99_ms": float(np.percentile(lats, 99) * 1e3)}


def open_loop_continuous(engine: ServeEngine, reqs, arrivals):
    """Drive the streaming API: submit at each arrival, step the engine."""
    n = len(reqs)
    done: Dict[int, object] = {}
    lat: Dict[int, float] = {}
    t0 = time.perf_counter()
    engine._t0 = t0
    i = 0
    while len(done) < n:
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            engine.submit(reqs[i])
            i += 1
        if not engine.has_work:
            time.sleep(max(0.0, arrivals[i] - (time.perf_counter() - t0)))
            continue
        for res in engine.step():
            done[res.rid] = res
            lat[res.rid] = (time.perf_counter() - t0) - arrivals[res.rid]
    wall = time.perf_counter() - t0
    engine._t0 = None
    return done, _metrics(lat, done, wall)


def open_loop_wave(engine: ServeEngine, reqs, arrivals):
    """The baseline under the same arrivals: form a wave from whatever has
    arrived (≤B), run it to completion, repeat.  Late arrivals wait out the
    whole in-flight wave — the head-of-line cost the continuous batcher
    removes."""
    n = len(reqs)
    B = engine.cfg.batch
    done: Dict[int, object] = {}
    lat: Dict[int, float] = {}
    queue: List[Request] = []
    t0 = time.perf_counter()
    i = 0
    while len(done) < n:
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            queue.append(reqs[i])
            i += 1
        if not queue:
            time.sleep(max(0.0, arrivals[i] - (time.perf_counter() - t0)))
            continue
        live, queue = queue[:B], queue[B:]
        for res in engine.run_wave(live):
            done[res.rid] = res
            lat[res.rid] = (time.perf_counter() - t0) - arrivals[res.rid]
    wall = time.perf_counter() - t0
    return done, _metrics(lat, done, wall)


def _warm_and_rate(engine: ServeEngine, model, n_warm: int = 4) -> float:
    """Warm the step shapes (on the card: capture the decode graphs), then
    measure the engine's warm service rate (requests/sec) on a second
    closed-loop burst — the first pass would under-estimate capacity."""
    warm = _trace(model, n_warm, seed=99)
    rate = 0.0
    for rep in range(2):
        t0 = time.perf_counter()
        engine.serve([Request(1000 + 100 * rep + r.rid, r.prompt,
                              r.max_new_tokens) for r in warm])
        rate = n_warm / (time.perf_counter() - t0)
    return rate


def _tokens(done, reqs) -> Dict[int, List[int]]:
    return {r.rid: list(done[r.rid].tokens) for r in reqs}


def run_continuous_vs_wave(n: int = 24, batch: int = 4, seed: int = 0, *,
                           model=None, params=None,
                           device: DeviceLike = "cuda") -> Dict:
    """Section 1.  ``model``/``params`` default to :func:`_model`'s on
    ``device``.  The result carries each engine's greedy tokens per request
    under ``"tokens"`` (not part of the JSON layout's leaves)."""
    if model is None:
        model, params = _model(device=device)
    reqs = _trace(model, n, seed=seed)

    wave = ServeEngine(model, params,
                       ServeConfig(batch=batch, max_len=MAX_LEN, mode="wave"),
                       device=device)
    cont = ServeEngine(model, params,
                       ServeConfig(batch=batch, max_len=MAX_LEN), device=device)
    wave_rate = _warm_and_rate(wave, model)
    _warm_and_rate(cont, model)
    # ~1.5x above the wave engine's capacity: its queue must grow
    arrivals = _arrivals(n, 1.5 * wave_rate, seed=seed + 1)

    done_w, m_w = open_loop_wave(wave, reqs, arrivals)
    done_c, m_c = open_loop_continuous(cont, reqs, arrivals)

    identical = all(done_c[r.rid].tokens == done_w[r.rid].tokens
                    for r in reqs)
    checks = {"tokens_identical": identical,
              "continuous_beats_wave_tps":
                  m_c["tokens_per_s"] > m_w["tokens_per_s"],
              "continuous_beats_wave_p99": m_c["p99_ms"] < m_w["p99_ms"]}
    return {"wave": m_w, "continuous": m_c,
            "arrival_rate_per_s": 1.5 * wave_rate,
            "speedup_tps": m_c["tokens_per_s"] / m_w["tokens_per_s"],
            "p99_ratio": m_c["p99_ms"] / m_w["p99_ms"],
            "tokens_identical": identical, "checks": checks,
            "tokens": {"wave": _tokens(done_w, reqs),
                       "continuous": _tokens(done_c, reqs)}}


def _capacity_bytes(model, params, caches: float = 3.5, *,
                    device: DeviceLike = "cuda") -> int:
    """Device capacity: weights + ~`caches` sequence caches — a balanced
    split of the batch fits, an unbalanced pile-up spills."""
    eng = ServeEngine(model, params, ServeConfig(batch=1, max_len=MAX_LEN),
                      device=device)
    cache_b = sum(s.nbytes for s in _tree.leaves(eng._cache_struct()))
    param_b = sum(t.numel() * t.element_size() for t in _tree.leaves(params))
    return param_b + int(caches * cache_b)


def run_slo_vs_roundrobin(n: int = 30, batch: int = 10, n_dev: int = 2,
                          seed: int = 3, reps: int = 2, *, model=None,
                          params=None, device: DeviceLike = "cuda") -> Dict:
    """Section 2, on a fresh ``n_dev``-device runtime per policy, each with a
    kernel table of its own (its serve entries go with it).  The result
    carries each policy's greedy tokens under ``"tokens"``."""
    if model is None:
        model, params = _model(device=device)
    # every long lands on an even rid: round-robin's parity placement homes
    # ALL of them on device 0 once the shorts flush through
    reqs = _trace(model, n, seed=seed, long_every=2, long_budget=40)
    cap = _capacity_bytes(model, params, caches=batch / n_dev + 0.5,
                          device=device)
    out: Dict[str, Dict] = {}
    tokens: Dict[str, Dict] = {}
    rate = None
    for policy, migrate in (("round-robin", 0), ("slo", 2)):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=n_dev,
                                          device_capacity_bytes=cap),
                            table=KernelTable(), device=device)
        try:
            eng = ServeEngine(
                model, params,
                ServeConfig(batch=batch, max_len=MAX_LEN,
                            migrate_every=migrate),
                runtime=rt, policy=policy, device=device)
            svc = _warm_and_rate(eng, model)
            if rate is None:
                rate = 1.3 * svc
            arrivals = _arrivals(n, rate, seed=seed + 1)
            # best-of-reps: scheduler jitter on a sub-second run can hide
            # the structural gap; the minimum p99 is the stable signal
            best = None
            for _ in range(reps):
                done, m = open_loop_continuous(eng, reqs, arrivals)
                if best is None or m["p99_ms"] < best[1]["p99_ms"]:
                    best = (done, m)
            done, m = best
            rt.pool.sync()
            stats = [rt.pool.present[d].stats() for d in range(n_dev)]
            m["migrations"] = eng.migrations
            m["evictions"] = sum(s["evictions"] for s in stats)
            m["refetches"] = sum(s["refetches"] for s in stats)
            out[policy] = m
            tokens[policy] = _tokens(done, reqs)
        finally:
            rt.shutdown()
    identical = tokens["slo"] == tokens["round-robin"]
    spills = sum(out[p]["evictions"] + out[p]["refetches"] for p in out)
    checks = {"tokens_identical": identical, "spills_positive": spills > 0,
              "slo_beats_roundrobin_p99":
                  out["slo"]["p99_ms"] < out["round-robin"]["p99_ms"]}
    return {"round-robin": out["round-robin"], "slo": out["slo"],
            "arrival_rate_per_s": rate,
            "p99_ratio": out["slo"]["p99_ms"] / out["round-robin"]["p99_ms"],
            "tokens_identical": identical, "checks": checks,
            "tokens": tokens}


def failed_checks(sections: Dict[str, Dict]) -> List[str]:
    """``section.check`` for every check that is false."""
    return [f"{name}.{k}" for name, sec in sections.items()
            for k, ok in sec["checks"].items() if not ok]


def _render(title: str, rows: Dict[str, Dict]) -> str:
    out = [f"## {title}",
           f"{'engine':>14} {'tok/s':>8} {'p50_ms':>8} {'p99_ms':>9} "
           f"{'migr':>5} {'spill':>6}"]
    for name, m in rows.items():
        if not isinstance(m, dict) or "tokens_per_s" not in m:
            continue
        out.append(f"{name:>14} {m['tokens_per_s']:>8.1f} "
                   f"{m['p50_ms']:>8.0f} {m['p99_ms']:>9.0f} "
                   f"{m.get('migrations', 0):>5} {m.get('evictions', 0):>6}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="CI sizing (shorter trace)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="dump the sections to PATH")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default: cuda)")
    ap.add_argument("--arch", default=ARCH,
                    help=f"smoke config to serve (default: {ARCH})")
    ap.add_argument("--full", action="store_true",
                    help="serve the arch's published config, not its smoke "
                         "config (random weights from seed 0)")
    ap.add_argument("--dtype", default=None,
                    help="parameter and compute dtype (default: the config's)")
    args = ap.parse_args(argv)
    n1, n2 = (16, 30) if args.smoke else (24, 30)
    model, params = _model(args.arch, args.dtype, full=args.full,
                           device=args.device)
    sections = {
        "continuous_vs_wave": run_continuous_vs_wave(
            n=n1, model=model, params=params, device=args.device),
        "slo_vs_roundrobin": run_slo_vs_roundrobin(
            n=n2, model=model, params=params, device=args.device),
    }
    for sec in sections.values():
        sec.pop("tokens")
    print(_render("continuous vs fixed waves (local, open-loop Poisson)",
                  sections["continuous_vs_wave"]))
    print(_render("slo vs round-robin (pool, capacity-capped)",
                  sections["slo_vs_roundrobin"]))
    cw, sr = sections["continuous_vs_wave"], sections["slo_vs_roundrobin"]
    print(f"continuous: {cw['speedup_tps']:.2f}x tok/s, "
          f"p99 at {100 * cw['p99_ratio']:.0f}% of waves; "
          f"slo p99 at {100 * sr['p99_ratio']:.0f}% of round-robin "
          f"({sr['slo']['migrations']} migrations, "
          f"{sr['slo']['evictions']} spills)")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"benchmark": "serve_load", "sections": sections},
                      f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    failed = failed_checks(sections)
    if failed:
        print("serve_load CHECK FAILURES: " + ", ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
