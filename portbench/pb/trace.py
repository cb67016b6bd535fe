"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA activity) over whole engine steps around the window's middle.

:class:`Tracer` is started before a step and stopped after one, with the
card synchronised, and wraps the traced steps in a ``portbench.window``
annotation whose span is the traced window on the trace's own clock.
:meth:`Tracer.summary` reads the raw events once: the union of the device's
kernel and copy intervals inside that span (busy seconds), device seconds
by kernel name, and the longest idle gaps, each named by what the host was
doing at its middle (the innermost CPU event there, under the harness's
own annotation).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]     # name -> (device seconds, calls)
    idle_gaps: List[Tuple[str, float]]

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[short_name(n), t] for n, (t, _) in ops],
                "idle_gaps": [[n, t] for n, t in self.idle_gaps[:10]]}


class Tracer:
    def __init__(self, seconds: float) -> None:
        self.seconds = seconds
        self.running = False
        self.t_start = 0.0
        self._prof = None
        self._span = None

    @property
    def started(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._span = record_function("portbench.window")
        self._span.__enter__()
        self.t_start = time.perf_counter()
        self.running = True

    def stop(self) -> None:
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.running = False

    def summary(self) -> Optional[TraceSummary]:
        if self._prof is None:
            return None
        return summarize(_raw_events(self._prof))


def _raw_events(prof) -> list:
    """(is_device, name, start_ns, end_ns) of every event the profiler kept."""
    from torch.autograd import DeviceType
    out = []
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            name, start = e.name(), e.start_ns()
            dev = e.device_type() == DeviceType.CUDA
            if dev and _annotation(e, name):
                continue    # a record_function span mirrored on the device: no work
            out.append((dev, name, start, start + e.duration_ns()))
        return out
    for e in prof.events():         # an older profiler: µs ranges
        out.append((e.device_type == DeviceType.CUDA, e.name,
                    int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)))
    return out


def _annotation(e, name: str) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return name.startswith("portbench.") or (callable(flag) and bool(flag()))


def short_name(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def summarize(events: list) -> TraceSummary:
    spans = [(s, e) for dev, n, s, e in events if not dev and n == "portbench.window"]
    if not spans:
        raise RuntimeError("the trace holds no portbench.window span")
    lo, hi = spans[0]
    dev = sorted((max(s, lo), min(e, hi), n) for is_dev, n, s, e in events
                 if is_dev and e > lo and s < hi)
    kernels: Dict[str, Tuple[float, int]] = {}
    busy_ns, gaps, cur = 0, [], lo
    for s, e, n in dev:
        t, c = kernels.get(n, (0.0, 0))
        kernels[n] = (t + (e - s) * 1e-9, c + 1)
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy_ns += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted((s, e, n) for is_dev, n, s, e in events
                  if not is_dev and n != "portbench.window")
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        inner = [(s, n) for s, e, n in host if s <= mid <= e]
        name = max(inner)[1] if inner else "no host event"
        named.append((name, (g1 - g0) * 1e-9))
    return TraceSummary(window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
                        kernels=kernels, idle_gaps=named)
