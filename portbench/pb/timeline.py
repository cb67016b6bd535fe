"""When each token reached its user, worked out from the ends of the
engine's steps.

``ServeEngine.step`` admits into free slots (the prefill gives each
admitted request its first token), then hands every live request its
pending token and retires the finished ones, then decodes once for the
rest.  So a request admitted in step a gets its token i in step a + i - 1
and comes back from the step that hands it its last token, c = a + n - 1.
From the step a request came back in and its token count, the harness
knows every one of its delivery steps; the step's end on the host clock is
the token's delivery time.  Nothing but the engine's public API is read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default rule), frozen here."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of nothing")
    pos = q * (len(xs) - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Served:
    """One request as the harness saw it."""
    index: int
    due: float                      # host clock
    prompt_len: int
    max_new: int
    done_step: Optional[int] = None  # index of the step it came back from
    tokens: Optional[List[int]] = None
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def finished(self) -> bool:
        return self.done_step is not None and len(self.tokens) == self.max_new

    @property
    def admit_step(self) -> int:
        return self.done_step - len(self.tokens) + 1


@dataclasses.dataclass
class Timeline:
    step_ends: List[float]
    served: List[Served]
    window: tuple                   # (open, close) on the host clock

    def finished(self) -> List[Served]:
        return [s for s in self.served if s.finished]

    def ttft_s(self) -> List[float]:
        ends = self.step_ends
        return [ends[s.admit_step] - s.due for s in self.finished()]

    def tpot_s(self) -> List[float]:
        ends = self.step_ends
        return [(ends[s.done_step] - ends[s.admit_step]) / (len(s.tokens) - 1)
                for s in self.finished() if len(s.tokens) >= 2]

    def itl_s(self) -> List[float]:
        """Every gap between two tokens of one request, pooled over the
        requests: the steps that hand out tokens 2 .. n, each less the one
        before it."""
        ends = self.step_ends
        return [ends[k + 1] - ends[k] for s in self.finished()
                for k in range(s.admit_step, s.done_step)]

    def tokens_in_window(self) -> int:
        ends = np.asarray(self.step_ends)
        lo, hi = self.window
        inside = (ends >= lo) & (ends <= hi)
        csum = np.concatenate([[0], np.cumsum(inside)])
        # the tokens of s land in steps admit .. done, one a step
        return int(sum(csum[s.done_step + 1] - csum[s.admit_step]
                       for s in self.finished()))

    def live_per_step(self) -> np.ndarray:
        """Live slots in each step's decode: s is decoded in steps
        admit .. done - 1 (its last token is handed out, not decoded)."""
        diff = np.zeros(len(self.step_ends) + 1, np.int64)
        for s in self.finished():
            diff[s.admit_step] += 1
            diff[s.done_step] -= 1
        return np.cumsum(diff)[:-1]

    def admitted_by(self, t: float) -> int:
        ends = self.step_ends
        return sum(1 for s in self.finished() if ends[s.admit_step] <= t)

    def queue_at(self, t: float) -> int:
        """Requests due by ``t`` and not yet admitted by the end of the
        last step that ended by then (at most one step late)."""
        due = sum(1 for s in self.served if s.due <= t)
        return due - self.admitted_by(t)

    def summary(self) -> Dict[str, float]:
        lo, hi = self.window
        out = {"requests": len(self.served), "finished": len(self.finished()),
               "tok_s": self.tokens_in_window() / (hi - lo)}
        for name, xs in (("ttft", self.ttft_s()), ("tpot", self.tpot_s()),
                         ("itl", self.itl_s())):
            if xs:
                for q in (50, 75, 90):
                    out[f"{name}_p{q}_ms"] = quantile(xs, q / 100) * 1e3
                out[f"{name}_mean_ms"] = float(np.mean(xs)) * 1e3
        return out
