"""A step captured as one CUDA graph: the port's counterpart of ``jax.jit``.

The reference jits ``Model.decode_step`` (``repro/serve/engine.py``); eager
PyTorch pays a host dispatch for each of its thousands of small ops, and the
card idles through most of a decode.  :class:`CapturedStep` runs a step
function once eagerly as the warm-up (on a side stream, as capture requires;
kernels are built and loaded there, never inside the capture), captures it
right after, and replays the graph at every later call.

The function takes no arguments: it reads tensors that outlive it (static
inputs that the caller refills in place before each call, the parameters, a
cache it writes in place) and returns its output, a tensor or a tuple of
tensors, which a replay overwrites in place.  It must not read a value on
the host (``.item()``, ``int()`` of a tensor) or copy from pageable host
memory: such a call fails the capture, and the error is raised, not worked
around.

A replay launches the captured kernels without calling their wrappers, so
the wrappers' launch counters (``kernels/_build.py``) would miss them: the
counters' change over the capture is taken back out (the capture ran
nothing) and added again at every replay.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch

from ..kernels import _build


class CapturedStep:
    """``fn`` as one CUDA graph on ``device``: the first call runs ``fn``
    eagerly (a real step; its output is returned) and captures it, every
    later call replays the graph and returns the captured output tensors."""

    def __init__(self, fn: Callable[[], Any], device: torch.device) -> None:
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.fn: Optional[Callable[[], Any]] = fn
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        #: each launch counter's launches per replay
        self.launches: Dict[_build.LaunchCounter, int] = {}
        self.replays = 0

    def __call__(self) -> Any:
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        _build.add_counts(self.launches)
        self.replays += 1
        return self.out

    def _warm_up_and_capture(self) -> Any:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn()
        main.wait_stream(side)
        for t in (out if isinstance(out, tuple) else (out,)):
            t.record_stream(main)         # made on the side stream, used on main
        # capture on a stream of our own, so that a step which fails the
        # capture leaves the stream context as it was and its own error is
        # the one raised
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.Stream(self.device)
        torch.cuda.synchronize(self.device)
        before = _build.launch_counts()
        with torch.cuda.stream(capture):
            graph.capture_begin()
            try:
                self.out = self.fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        self.launches = _build.counts_since(before)
        _build.add_counts(self.launches, -1)
        self.graph = graph
        self.fn = None            # the graph replays without it
        return out
