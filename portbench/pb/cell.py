"""One run of one cell: set-up, the measured window, the metrics, the check.

:func:`run` is everything ``run.py`` does after its look for the chip, so
the tests drive it on the CPU at a tiny size.  The readers of the metrics
get a :class:`Ctx`.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import check, costs, spec
from .loop import Window, make_engine, warm_up
from .timeline import Timeline
from .trace import TraceSummary, Tracer
from .traffic import make_requests
from .weights import Weights

TRACE_SECONDS = 5.0


@dataclasses.dataclass
class Ctx:
    """What a metric's reader may read."""
    cell: spec.Cell
    cfg: Any                        # the port's ModelConfig
    conf: Dict[str, Any]
    traffic: Dict[str, Any]
    slots: int
    tl: Timeline
    summary: Dict[str, float]
    setup_s: float
    decodes: int                    # the engine's decode steps over the run
    trace: Optional[TraceSummary]
    costs: Any = costs

    def in_window(self) -> np.ndarray:
        lo, hi = self.tl.window
        ends = np.asarray(self.tl.step_ends)
        return (ends >= lo) & (ends <= hi)

    def decode_rows(self) -> List[List[int]]:
        """Each step's live rows as cache fills, the new token counted."""
        rows: List[List[int]] = [[] for _ in self.tl.step_ends]
        for s in self.tl.finished():
            a = s.admit_step
            for step in range(a, s.done_step):
                rows[step].append(s.prompt_len + step - a + 1)
        return rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Setup:
    """The cell's configuration, traffic, limits and plain reference, the
    weights made from ``seed`` on ``device``, and a warmed engine."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device) -> None:
        from repro_torch.models import Model
        self.conf = spec.read_json(cell.config_file)
        self.traffic = spec.read_json(cell.traffic_file)
        self.limits = spec.read_json(cell.limits_file)
        self.reference = spec.reference_logits(cell)
        self.cfg = spec.model_config(self.conf)
        self.model = Model(self.cfg)
        self.weights = Weights(self.model.init_abstract(), self.conf["init"], seed, device)
        self.engine = make_engine(self.model, self.weights.params, self.traffic, device)
        warm_up(self.engine, self.traffic, self.cfg.vocab, seed)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, bench_dir=None) -> Dict[str, Any]:
    """The result line's object."""
    su = Setup(cell, seed, device)
    conf, traffic, limits, cfg, weights, engine, ref_logits = (
        su.conf, su.traffic, su.limits, su.cfg, su.weights, su.engine, su.reference)
    reqs = make_requests(traffic, seconds, seed, cfg.vocab)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(min(TRACE_SECONDS, seconds)) if trace else None
    window = Window(engine, reqs, traffic, seconds, tracer, sync=lambda: _sync(device))
    tl = window.run()
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = tl.summary()
    ctx = Ctx(cell=cell, cfg=cfg, conf=conf, traffic=traffic,
              slots=int(traffic["engine"]["slots"]), tl=tl, summary=summary,
              setup_s=setup_s, decodes=window.decodes,
              trace=tracer.summary() if tracer else None)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m.name, bench_dir)(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}

    decodes, steps = window.decodes, len(tl.step_ends)
    # the check, once the program's state is gone
    del engine, su, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prompts = [r.prompt for r in reqs]
    picked = check.sample(tl.served, seed, int(limits["sample_tokens"]))
    got = check.widest(weights.params, conf, picked, prompts, ref_logits)
    attempted = len(tl.served)
    failed = attempted - len(tl.finished())
    limit = float(limits["logit_gap"]["limit"])
    numbers = {"logit_gap": [got["gap"], limit], "unfinished": [failed, 0],
               "sampled_tokens": [got["tokens"], int(limits["sample_tokens"])]}
    correct = bool(failed == 0 and picked and got["gap"] <= limit
                   and got["tokens"] >= int(limits["sample_tokens"]))
    out: Dict[str, Any] = {"correct": correct, "attempted": attempted, "failed": failed,
                           "metrics": metrics}
    out["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                     "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if ctx.trace is not None:
        out["device"]["busy_s"] = ctx.trace.busy_s
        out["device"]["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    out["detail"] = {"summary": summary, "setup_s": setup_s, "decodes": decodes,
                     "sample_requests": got["requests"], "steps": steps}
    out["check"] = numbers          # last: the numbers compared, each beside its limit
    return out
