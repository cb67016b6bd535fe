"""Drives ``repro_torch.serve.ServeEngine`` through one measured window.

The harness owns the loop.  Before each ``step()`` it submits every
request now due (an open loop), and it sleeps only when the engine has no
work.  It records the end of every step on the host clock
and the step each ``Result`` came back from; :mod:`pb.timeline` turns that
into each token's delivery time.  Requests in flight when the window
closes are drained; one still unfinished ``drain_s`` after the close has
failed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
from torch.profiler import record_function

from .timeline import Served, Timeline
from .traffic import Req, prefill_buckets

DRAIN_S = 120.0


def make_engine(model, params, traffic: Dict[str, Any], device):
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = traffic["engine"]
    cfg = ServeConfig(batch=int(eng["slots"]), max_len=int(eng["max_len"]), eos=-1,
                      temperature=0.0, mode="continuous")
    return ServeEngine(model, params, cfg, device=device)


def warm_up(engine, traffic: Dict[str, Any], vocab: int, seed: int) -> None:
    """Serve, one at a time, a request at each prefill length in
    :func:`pb.traffic.prefill_buckets` (a masking engine's every bucket,
    both ends of the range; an exact power of two also takes the decode
    without pads), with three new tokens each: every prefill shape the cell
    buckets to, the largest allocation, and every decode signature are
    run, and the decode graphs captured, before the window."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    lens = prefill_buckets(traffic)
    for i, L in enumerate(lens):
        engine.submit(Request(-1 - i, rng.integers(0, vocab, L).tolist(), max_new_tokens=3))
        engine.drain()


class Window:
    """One measured window over ``reqs``; ``tracer`` (optional) is started
    and stopped at step boundaries around the window's middle."""

    def __init__(self, engine, reqs: List[Req], traffic: Dict[str, Any], seconds: float,
                 tracer=None, sync=None) -> None:
        self.engine = engine
        self.reqs = reqs
        self.traffic = traffic
        self.seconds = seconds
        self.tracer = tracer
        self.sync = sync or (lambda: None)

    def run(self) -> Timeline:
        from repro_torch.serve import Request
        eng, reqs = self.engine, self.reqs
        prompts = [r.prompt.tolist() for r in reqs]
        served = [Served(r.index, float("nan"), len(r.prompt), r.max_new) for r in reqs]
        step_ends: List[float] = []
        decodes0 = eng.graph_stats["decodes"]
        t_open = time.perf_counter()
        t_close = t_open + self.seconds
        due = [t_open + r.offset_s for r in reqs]
        tr = self.tracer
        tr_from = t_open + max(0.0, (self.seconds - (tr.seconds if tr else 0)) / 2)
        i = 0
        while True:
            now = time.perf_counter()
            while i < len(reqs) and due[i] <= now:
                served[i].due = due[i]
                eng.submit(Request(i, prompts[i], max_new_tokens=reqs[i].max_new))
                i += 1
            if now > t_close + DRAIN_S:
                break
            if not eng.has_work:
                if i >= len(reqs):
                    break
                with record_function("portbench.wait"):
                    time.sleep(max(0.0, due[i] - time.perf_counter()))
                continue
            if tr is not None and not tr.started and now >= tr_from:
                tr.start()
            with record_function("portbench.step"):
                results = eng.step()
            for res in results:
                s = served[res.rid]
                s.done_step, s.tokens = len(step_ends), list(res.tokens)
                s.prefill_s, s.decode_s = res.prefill_s, res.decode_s
            step_ends.append(time.perf_counter())
            if tr is not None and tr.running and step_ends[-1] >= tr.t_start + tr.seconds:
                self._stop_trace()
        if tr is not None and tr.running:
            self._stop_trace()
        self.decodes = eng.graph_stats["decodes"] - decodes0
        return Timeline(step_ends, served[:i], (t_open, t_close))

    def _stop_trace(self) -> None:
        self.sync()
        self.tracer.stop()
