"""Failure injection and the retry/blacklist policy of the offload runtime.

Port of ``repro.ft.failures``:

* :class:`FlakyDevice` wraps a :class:`~repro_torch.core.device.NodeDevice`
  and fails a seeded fraction of its commands: EXEC, the transport ops
  (``SEND``/``RECV``) and the host wire (``XFER_TO``/``XFER_FROM``), so every
  recovery path of the runtime can be driven.  A failed command raises
  before it touches the device, so an injected EXEC never launches its
  kernel.
* :func:`with_retry` re-issues a failed target region on the next healthy
  device, feeding the caller's ``blacklist`` and the pool's
  :class:`~repro_torch.core.device.HealthRegistry`.  The region rides the
  ``nowait`` path and is joined at once, so a retry composes with resident
  buffers and concurrent regions.

Graph-level recovery (re-placement, funnel reroute, lineage replay) is
:func:`repro_torch.core.taskgraph.run_graph`'s.  A ``hang`` fault sleeps and
then fails; a command deadline (``DevicePool(deadline_s=)``) or a transport
op timeout (``PeerTransport(op_timeout_s=)``) fires long before, and the
host recovers while the hung command runs on.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..core.device import Command, DeviceFailure, NodeDevice
from ..core.target import MapSpec, TargetExecutor

__all__ = ["DeviceFailure", "FlakyDevice", "inject_flaky", "with_retry",
           "FAULT_OPS", "FAULT_MODES"]

#: Ops eligible for injection.  ALLOC/FREE/STOP are left out: faulting them
#: would desynchronize the host mirror's first-fit prediction from the
#: device store, a runtime bug rather than a fault.
FAULT_OPS = ("EXEC", "SEND", "RECV", "XFER_TO", "XFER_FROM")

#: How an injected fault shows: ``fail`` raises at once; ``hang`` sleeps
#: ``hang_s`` and then raises without side effects; ``slow`` sleeps
#: ``slow_s`` and then runs the command (a straggler, counted in ``stalls``).
FAULT_MODES = ("fail", "hang", "slow")


class FlakyDevice:
    """Proxy over a :class:`NodeDevice` failing selected ops with
    probability ``p``.

    The draws come from ``np.random.default_rng((seed, inner.index))``, one
    per eligible command in the device's execution order, so a given (seed,
    p, ops, mode) replays the same schedule for the same per-device command
    sequence, in both packages.  ``failures`` counts injected faults
    (``fail`` and ``hang``), ``stalls`` the ``slow`` delays (their seconds in
    ``stalled_s``); each count has a per-op breakdown.  Every other
    attribute is the wrapped device's.
    """

    def __init__(self, inner: NodeDevice, p: float, seed: int = 0,
                 ops: Sequence[str] = ("EXEC",), mode: str = "fail",
                 hang_s: float = 0.25, slow_s: float = 0.05) -> None:
        bad = set(ops) - set(FAULT_OPS)
        if bad:
            raise ValueError(f"cannot inject faults on ops {sorted(bad)}; "
                             f"eligible: {FAULT_OPS}")
        if mode not in FAULT_MODES:
            raise ValueError(f"unknown fault mode {mode!r}; "
                             f"eligible: {FAULT_MODES}")
        self._inner = inner
        self._p = p
        self._ops = frozenset(ops)
        self._mode = mode
        self._hang_s = hang_s
        self._slow_s = slow_s
        self._rng = np.random.default_rng((seed, inner.index))
        self.failures = 0
        self.failures_by_op: Dict[str, int] = {}
        self.stalls = 0
        self.stalls_by_op: Dict[str, int] = {}
        self.stalled_s = 0.0

    def execute(self, cmd: Command, table, payload=None):
        if cmd.op in self._ops and self._rng.random() < self._p:
            if self._mode == "slow":
                self.stalls += 1
                self.stalls_by_op[cmd.op] = self.stalls_by_op.get(cmd.op, 0) + 1
                time.sleep(self._slow_s)
                self.stalled_s += self._slow_s
                return self._inner.execute(cmd, table, payload)
            self.failures += 1
            self.failures_by_op[cmd.op] = self.failures_by_op.get(cmd.op, 0) + 1
            if self._mode == "hang":
                time.sleep(self._hang_s)
            raise DeviceFailure(
                f"injected {cmd.op} {self._mode} on device {self._inner.index}"
                + (f" (kernel index {cmd.kernel_index})"
                   if cmd.op == "EXEC" else ""),
                op=cmd.op, device=self._inner.index,
                kernel_index=cmd.kernel_index)
        return self._inner.execute(cmd, table, payload)

    def busy_clock(self) -> float:
        """The wrapped device's busy clock, with the stalls injected here
        counted as device time on the CPU, where that clock is the worker's
        CPU time and does not see a sleep (the card's wall clock does)."""
        if self._inner.stream is not None:
            return self._inner.busy_clock()
        return self._inner.busy_clock() + self.stalled_s

    def __getattr__(self, name):
        return getattr(self._inner, name)


def inject_flaky(pool, p: float, seed: int = 0,
                 devices: Optional[Sequence[int]] = None,
                 ops: Sequence[str] = ("EXEC",), mode: str = "fail",
                 hang_s: float = 0.25, slow_s: float = 0.05) -> None:
    """Wrap (some of) a pool's devices with failure injection, in place.

    The pool looks a device up at every command, so commands issued after
    this call go through the wrapper."""
    for i, d in enumerate(pool.devices):
        if devices is None or i in devices:
            pool.devices[i] = FlakyDevice(d, p, seed, ops=ops, mode=mode,
                                          hang_s=hang_s, slow_s=slow_s)


def with_retry(ex: TargetExecutor, kernel: str, device: int, maps: MapSpec, *,
               max_retries: int = 3, blacklist: Optional[set] = None,
               tag: str = "") -> Dict[str, Any]:
    """Run a target region, retrying on other devices on failure.

    Returns the region's outputs; raises the last error if every candidate
    device fails.  ``blacklist`` (shared across calls) gathers the devices
    that failed, and the pool's health registry is fed too.  Only a
    :class:`DeviceFailure` is retried: any other error (a kernel's build or
    launch error) surfaces at once.  After a failed attempt the pool's
    stashed injected errors are absorbed, so they cannot resurface at an
    innocent region's next sync.
    """
    blacklist = blacklist if blacklist is not None else set()
    pool = ex.pool
    last: Optional[BaseException] = None
    candidates = [device] + [d for d in range(len(pool)) if d != device]
    tried = 0
    for d in candidates:
        if d in blacklist or not pool.health.is_healthy(d) or tried > max_retries:
            continue
        tried += 1
        try:
            fut = ex.target(kernel, d, maps, nowait=True, tag=tag or kernel)
            return ex.drain([fut])[0]
        except DeviceFailure as e:
            last = e
            blacklist.add(d)
            pool.health.mark_failed(d if e.device is None else e.device)
            pool.absorb_failures()
    if last is not None:
        raise last
    raise RuntimeError("no healthy devices")
