"""Straggler detection for hedged re-execution in the TaskGraph executor.

Port of ``repro.ft.stragglers``.  "Detrimental task execution patterns in
mainstream OpenMP runtimes" (PAPERS.md) shows that a *stalled* task, not a
crashed one, is how a task runtime most often loses its speedup: one slow
node holds a whole wave.  The answer of MapReduce's backup tasks and of
tail-at-scale hedging is to launch a duplicate of a task that runs too long
on another node and take whichever copy finishes first.

:class:`StragglerDetector` is the policy half.  It holds each in-flight
task's elapsed wall time against the
:meth:`~repro_torch.core.costmodel.CostModel.kernel_time` the cost model has
gathered for its kernel, and flags the task once it runs past ``k`` times
that mean (never below ``grace_s``: short kernels have noisy means).
:func:`~repro_torch.core.taskgraph.run_graph` is the mechanism half: it
launches the hedge on another healthy device, races the two copies and
strikes the loser's cost records (``discard_tag`` / ``rename_tag``), so the
values stay bit-identical (both copies compute the same function of the
same inputs) and the modeled makespan counts each task once.

Detection is time-based, so injected ``slow`` faults change traffic and
hedge counts, never values.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["StragglerDetector", "HedgeRecord"]


@dataclass
class HedgeRecord:
    """One hedge launch, for the straggler/hedge report."""

    task: str
    kernel: str
    primary_device: int
    hedge_device: int
    elapsed_s: float            # the primary's elapsed time at the launch
    threshold_s: float
    winner: Optional[str] = None  # "primary" | "hedge" | "failed"


class StragglerDetector:
    """Flags tasks running past ``k`` times their kernel's observed time.

    ``cost`` is the pool's :class:`~repro_torch.core.costmodel.CostModel`.
    A kernel's threshold is ``max(grace_s, k * kernel_time(kernel))`` once
    ``min_observations`` regions of it have retired (a one-sample mean is
    often a warm-up spike); before that, ``baseline`` (per-kernel seconds,
    from a calibration or a reference run) stands in, and a kernel with
    neither is never hedged.

    ``max_hedges`` caps the duplicated work of one detector; ``poll_s`` is
    how often the executor's join re-checks its in-flight tasks.  The
    counters are thread-safe, so one detector may serve concurrent
    ``run_graph`` calls.
    """

    def __init__(self, cost, *, k: float = 3.0, min_observations: int = 2,
                 grace_s: float = 0.05, max_hedges: int = 8,
                 poll_s: float = 0.01,
                 baseline: Optional[Dict[str, float]] = None) -> None:
        self.cost = cost
        self.k = k
        self.min_observations = min_observations
        self.grace_s = grace_s
        self.max_hedges = max_hedges
        self.poll_s = poll_s
        self.baseline = dict(baseline or {})
        self._lock = threading.Lock()
        self.records: List[HedgeRecord] = []
        self.hedges_launched = 0
        self.primary_wins = 0
        self.hedge_wins = 0
        self.hedge_failures = 0

    # -- policy ---------------------------------------------------------------
    def threshold(self, kernel: str) -> Optional[float]:
        """Seconds after which a task of ``kernel`` is a straggler (None: no
        usable estimate yet, never hedge)."""
        # count the observations before asking kernel_time: its fallback
        # (calibration seed, then a documented default) never returns None,
        # and a cold default would hedge healthy work
        if self.cost.kernel_observations(kernel) >= self.min_observations:
            est = self.cost.kernel_time(kernel)
        else:
            est = self.baseline.get(kernel)
        if est is None:
            return None
        return max(self.grace_s, self.k * est)

    def should_hedge(self, kernel: str, elapsed_s: float) -> bool:
        with self._lock:
            if self.hedges_launched >= self.max_hedges:
                return False
        th = self.threshold(kernel)
        return th is not None and elapsed_s > th

    # -- bookkeeping (called by the executor) ---------------------------------
    def note_launch(self, **kw) -> HedgeRecord:
        """Record a hedge launch; returns the record to pass to
        :meth:`note_winner` once the race is decided."""
        record = HedgeRecord(**kw)
        with self._lock:
            self.hedges_launched += 1
            self.records.append(record)
        return record

    def note_winner(self, record: HedgeRecord, winner: str) -> None:
        record.winner = winner
        with self._lock:
            if winner == "primary":
                self.primary_wins += 1
            elif winner == "hedge":
                self.hedge_wins += 1
            else:
                self.hedge_failures += 1

    def report(self) -> Dict[str, object]:
        """A JSON-ready summary: counters and one entry per hedge."""
        with self._lock:
            return {
                "hedges_launched": self.hedges_launched,
                "primary_wins": self.primary_wins,
                "hedge_wins": self.hedge_wins,
                "hedge_failures": self.hedge_failures,
                "max_hedges": self.max_hedges,
                "k": self.k,
                "records": [
                    {"task": r.task, "kernel": r.kernel,
                     "primary_device": r.primary_device,
                     "hedge_device": r.hedge_device,
                     "elapsed_s": r.elapsed_s,
                     "threshold_s": r.threshold_s,
                     "winner": r.winner}
                    for r in self.records],
            }
