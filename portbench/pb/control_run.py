"""The program's and the control's readings of a cell, seed after seed,
on one warmed engine (``portbench/control.py``, and the tests)."""
from __future__ import annotations

import time
from typing import Dict, Iterator, List

from . import check
from .loop import Window
from .traffic import make_requests


def readings(su, seeds: List[int], seconds: float) -> Iterator[Dict]:
    for seed in seeds:
        su.weights.refill(seed)
        reqs = make_requests(su.traffic, seconds, seed, su.cfg.vocab)
        tl = Window(su.engine, reqs, su.traffic, seconds).run()
        prompts = [r.prompt for r in reqs]
        picked = check.sample(tl.served, seed, int(su.limits["sample_tokens"]))
        t0 = time.perf_counter()
        got = check.widest(su.weights.params, su.conf, picked, prompts, su.reference,
                           control=True)
        yield {"seed": seed, "gap": got["gap"], "control_gap": got["control_gap"],
               "tokens": got["tokens"], "requests": got["requests"],
               "unfinished": len(tl.served) - len(tl.finished()), **tl.summary(),
               "reference_s": time.perf_counter() - t0}
