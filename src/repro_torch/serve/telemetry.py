"""What the continuous serving loop records about its own steps.

Two kinds of data, both written by :class:`~repro_torch.serve.ServeEngine`
in continuous local mode (pool and wave mode record nothing here):

* **Records, always on.**  One :class:`StepRecord` per ``step()`` and one
  :class:`RequestRecord` per admitted request, kept in bounded deques of
  the one process-wide :data:`TELEMETRY` (the oldest drop first), as the
  kernels' launch counters are process-wide (``kernels/_build.py``).  Every
  time is ``time.perf_counter()``, the clock a caller's own timeline reads,
  so a reader filters the records by its window directly.
* **Spans, on only while a ``torch.profiler`` session records.**  They are
  the profiler's own ``record_function(name, args)``, so they land in its
  trace on the clock of the kernels and copies.  :func:`span` with the gate
  off returns one shared no-op context and never calls ``args``.

Step record fields: ``t0`` / ``t1`` the step's start and end;
``prefill_tokens`` (rows x padded length, summed over the step's prefill
groups; on the kernel route the real rows at their own length) and
``prompt_tokens`` (the real lengths summed); ``decode_rows``
(live rows decoded, 0 for none), ``masked`` (the decode took the pad-masked
signature), ``t_launch`` when the decode's launch call returned and
``t_synced`` when the step's wait for the card ended (NaN without a
decode); ``profiled``, a profiler recorded the step (its spans were on,
and the profiler's own cost is in its times: under CUDA tracing a graph
launch call takes milliseconds, and more than before it once tracing
has stopped); ``moe_prefill`` and ``moe_decode``, a model with MoE layers:
what they did in the step's prefills and in its decode
(``models.moe.MoECounts``: layer launches, experts that held a token,
real expert rows, rows the expert GEMMs computed; None otherwise, and
``moe_decode`` None in a step without a decode).  Request record fields: ``t_admit`` the start of its prefill
group, ``t_first`` when its first token was read back to the host (NaN
until then).
"""
from __future__ import annotations

import contextlib
import math
from collections import deque
from typing import Callable, List, Optional

import torch
from torch.profiler import record_function

MAXLEN = 65536

_NAN = math.nan
_OFF = contextlib.nullcontext()


class StepRecord:
    __slots__ = ("t0", "t1", "t_launch", "t_synced", "prefill_tokens", "prompt_tokens",
                 "decode_rows", "masked", "profiled", "moe_prefill", "moe_decode")

    def __init__(self, t0: float, profiled: bool = False) -> None:
        self.t0 = t0
        self.profiled = profiled
        self.t1 = self.t_launch = self.t_synced = _NAN
        self.prefill_tokens = self.prompt_tokens = self.decode_rows = 0
        self.masked = False
        self.moe_prefill = self.moe_decode = None


class RequestRecord:
    __slots__ = ("rid", "prompt_len", "padded_len", "t_admit", "t_first")

    def __init__(self, rid: int, prompt_len: int, padded_len: int, t_admit: float) -> None:
        self.rid = rid
        self.prompt_len = prompt_len
        self.padded_len = padded_len
        self.t_admit = t_admit
        self.t_first = _NAN


class ServeTelemetry:
    """Bounded logs of step and request records."""

    def __init__(self, maxlen: int = MAXLEN) -> None:
        self.step_log: deque = deque(maxlen=maxlen)
        self.request_log: deque = deque(maxlen=maxlen)

    def steps(self, lo: float, hi: float) -> List[StepRecord]:
        """The steps that ended in ``[lo, hi]``."""
        return [s for s in self.step_log if lo <= s.t1 <= hi]

    def requests(self, lo: float, hi: float) -> List[RequestRecord]:
        """The requests whose first token was read back in ``[lo, hi]``."""
        return [r for r in self.request_log if lo <= r.t_first <= hi]

    def clear(self) -> None:
        self.step_log.clear()
        self.request_log.clear()


TELEMETRY = ServeTelemetry()


def recording() -> bool:
    """The spans' gate: a ``torch.profiler`` session is recording."""
    return torch.autograd._profiler_enabled()


def span(on: bool, name: str, args: Optional[Callable[[], str]] = None):
    """``record_function(name, args())`` where ``on``, else a shared no-op
    context (``args`` is not called)."""
    if not on:
        return _OFF
    return record_function(name, None if args is None else args())
