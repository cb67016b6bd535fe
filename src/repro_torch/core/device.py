"""NodeDevice / DevicePool: cluster nodes as offload devices (paper §4).

An ``mpinode`` device in the paper is "simply a computer with MPI installed",
listed in a configuration file; listing a node with a multiplier ``D`` starts
``D`` devices on it.  In this port every device is a *virtual share* of one
card (or of the CPU, for the tests): each :class:`NodeDevice` owns a
:class:`MediaryStore` on that ``torch.device`` and, on the card, its own
``torch.cuda.Stream``.  The host side owns one :class:`HostMirror` per device
plus a per-device mutex (paper §4.2), and every transfer is accounted in a
:class:`CostModel`.

Commands run on one worker thread per device, each issued under that
device's stream.  A command that hands a value to the host or to another
device (EXEC, XFER_TO, SEND, RECV) synchronizes its stream before its future
resolves, so a reader on any other stream or thread only ever sees finished
data, and the caching allocator can reuse a freed block without
``record_stream``.  Finer-grained ordering with CUDA events is later work.

Device→device copies (:meth:`DevicePool.peer_copy`) are a SEND on the
source's stream and a RECV on the destination's: the RECV copies the payload
into a buffer of its own on its own stream, so no device's slot ever aliases
another device's, and the bytes are counted as peer traffic, never against
the host funnel.

Left for later slices: elastic membership and command deadlines (ROADMAP
item 11), declare-target globals.
"""
from __future__ import annotations

import collections
import concurrent.futures as _cf
import contextlib
import inspect
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from . import _tree
from .costmodel import CostModel, LinkModel, PAPER_ETHERNET
from .kernel_table import GLOBAL_KERNEL_TABLE, KernelTable
from .mediary import HostMirror, MediaryStore, PresentTable


# ---------------------------------------------------------------------------
# Command stream (paper §4.1: the four command types + STOP)
# ---------------------------------------------------------------------------
#: Pseudo-handle every ALLOC/FREE writes: chains them in issue order so the
#: device-side first-fit allocator sees the exact sequence the host mirror
#: predicted, even though unrelated transfers/EXECs may reorder around them.
SLOT_STREAM = -1

_DTYPE_64_TO_32 = {torch.float64: torch.float32, torch.int64: torch.int32,
                   torch.complex128: torch.complex64}


def as_host_tensor(value: Any) -> torch.Tensor:
    """A host value as a tensor, with the reference's default widths.

    Tensors keep their dtype.  numpy arrays and Python scalars become
    tensors with 64-bit types narrowed to 32 bits — what ``jnp.asarray``
    does without x64 — so byte counters agree with the reference.
    """
    if isinstance(value, torch.Tensor):
        return value
    t = torch.as_tensor(np.asarray(value))
    return t.to(_DTYPE_64_TO_32.get(t.dtype, t.dtype))


@dataclass(frozen=True)
class Command:
    op: str                 # ALLOC | FREE | XFER_TO | XFER_FROM | EXEC |
                            # SEND | RECV | STOP
    device: int
    handle: Optional[int] = None
    nbytes: int = 0
    kernel_index: Optional[int] = None
    tag: str = ""
    # dependency-aware stream: the buffer handles this command reads/writes
    reads: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    # SEND/RECV only: the other endpoint of the device↔device transfer
    peer: Optional[int] = None


class NodeDevice:
    """One offload device: buffer store + kernel executor on a share of the card."""

    def __init__(self, index: int, device: torch.device, *,
                 hostname: str = "localhost") -> None:
        self.index = index
        self.hostname = hostname
        self.device = device
        self.store = MediaryStore(device)
        self.stopped = False
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)

    def stream_context(self):
        """Context that makes this device's stream current (no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def synchronize(self) -> None:
        """Wait until every operation issued on this device's stream is done."""
        if self.stream is not None:
            self.stream.synchronize()

    def _place(self, value: torch.Tensor) -> torch.Tensor:
        # always a copy: the device buffer must never alias a host tensor
        # that the host may later update in place
        return value.to(self.device, copy=True)

    # -- the device-side command loop (paper §4.1) --------------------------
    def execute(self, cmd: Command, table: KernelTable,
                payload: Optional[Dict[str, Any]] = None):
        if self.stopped:
            raise RuntimeError(f"device {self.index} is stopped")
        if cmd.op == "ALLOC":
            handle = self.store.alloc(payload["shape"], payload["dtype"])
            if handle != cmd.handle:
                raise RuntimeError(
                    f"mediary desync: device allocated slot {handle}, host "
                    f"reserved {cmd.handle}")
            return handle
        if cmd.op == "FREE":
            self.store.free(cmd.handle)
            return None
        if cmd.op == "XFER_TO":
            self.store.write(cmd.handle, self._place(payload["value"]),
                             section=payload.get("section"))
            self.synchronize()
            return None
        if cmd.op == "XFER_FROM":
            out = self.store.read(cmd.handle, section=payload.get("section"))
            return out.to("cpu", copy=True)
        if cmd.op == "SEND":
            # peer rendezvous, source side: the future carries the slot's
            # tensor itself to the peer's RECV.  The store replaces slots
            # and never writes one in place, so a later writer of this
            # handle installs a new tensor and cannot change what is in
            # flight.  Synchronize first: the tensor may still be in the
            # making on this stream (a fresh ALLOC's zeros), and the RECV
            # reads it on another stream.
            value = self.store.read(cmd.handle)
            self.synchronize()
            return value
        if cmd.op == "RECV":
            # peer rendezvous, sink side: the matching SEND has settled (the
            # stream gates RECV on it), so this never blocks the worker; a
            # failed SEND re-raises here.  The copy lands in a buffer of
            # this device's own, made on this device's stream — a device
            # buffer never aliases another device's — and is finished
            # before the future resolves.
            value = payload["source"].result()
            self.store.write(cmd.handle, self._place(value))
            self.synchronize()
            return None
        if cmd.op == "EXEC":
            entry = table.lookup(cmd.kernel_index)
            # buffers: name -> handle, or name -> [handles] for pytree-valued
            # maps; the treedef travels in the EXEC message (paper §4.2)
            trees = payload.get("trees", {})
            kwargs = {}
            for name, h in payload["buffers"].items():
                if isinstance(h, (list, tuple)):
                    leaves = [self.store.device_address(x) for x in h]
                    kwargs[name] = _tree.unflatten(trees[name], leaves)
                else:
                    kwargs[name] = self.store.device_address(h)
            kwargs.update(payload.get("firstprivate", {}))
            # a kernel only receives the mapped names it declares as
            # parameters and returns the from/tofrom values
            params = inspect.signature(entry.fn).parameters
            if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
                kwargs = {k: v for k, v in kwargs.items() if k in params}
            out = entry.fn(**kwargs)
            self.synchronize()
            return out
        if cmd.op == "STOP":
            self.stopped = True
            return None
        raise ValueError(f"unknown command {cmd.op}")


class DeviceStoppedError(RuntimeError):
    """Command issued to a device whose queue has been closed by stop_all."""


class DeviceFailure(RuntimeError):
    """A device-side command failed (injected or real).

    ``op`` names the failed command and ``device`` the device that raised.
    Graph-level recovery from it is ROADMAP item 11.
    """

    def __init__(self, message: str, *, op: str = "EXEC",
                 device: Optional[int] = None,
                 kernel_index: Optional[int] = None) -> None:
        super().__init__(message)
        self.op = op
        self.device = device
        self.kernel_index = kernel_index


class HealthRegistry:
    """Shared device-health bookkeeping for failure-aware scheduling.

    Placement policies consult :meth:`healthy`.  A device is blacklisted once
    its failure count reaches ``max_failures``; when every device is
    blacklisted, :meth:`healthy` falls back to the full set.
    ``probation_waves=N`` lets a blacklisted device that stays clean for
    ``N`` consecutive waves rejoin with one strike left, at most
    ``max_rejoins`` times.
    """

    def __init__(self, max_failures: int = 2, *,
                 probation_waves: Optional[int] = None,
                 max_rejoins: int = 2) -> None:
        self.max_failures = max_failures
        self.probation_waves = probation_waves
        self.max_rejoins = max_rejoins
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._blacklist: set = set()
        self._clean: Dict[int, int] = {}     # consecutive clean waves
        self._rejoins: Dict[int, int] = {}   # probation rejoins so far
        self._dirty: set = set()             # failed since last tick_wave

    def mark_failed(self, device: Optional[int]) -> None:
        if device is None:
            return
        with self._lock:
            self._counts[device] = self._counts.get(device, 0) + 1
            self._dirty.add(device)
            self._clean.pop(device, None)
            if self._counts[device] >= self.max_failures:
                self._blacklist.add(device)

    def mark_healthy(self, device: int) -> None:
        """Forget a device's failure history (rejoin after repair)."""
        with self._lock:
            self._counts.pop(device, None)
            self._blacklist.discard(device)
            self._clean.pop(device, None)
            self._rejoins.pop(device, None)
            self._dirty.discard(device)

    def tick_wave(self) -> List[int]:
        """Advance probation at a wave boundary; returns devices rejoined."""
        rejoined: List[int] = []
        with self._lock:
            dirty, self._dirty = self._dirty, set()
            if self.probation_waves is None:
                return rejoined
            for d in sorted(self._blacklist):
                if d in dirty:
                    self._clean[d] = 0
                    continue
                self._clean[d] = self._clean.get(d, 0) + 1
                if self._clean[d] < self.probation_waves:
                    continue
                if self._rejoins.get(d, 0) >= self.max_rejoins:
                    continue                 # chronic offender: stays out
                self._rejoins[d] = self._rejoins.get(d, 0) + 1
                self._blacklist.discard(d)
                self._clean.pop(d, None)
                self._counts[d] = self.max_failures - 1
                rejoined.append(d)
        return rejoined

    def failures(self, device: int) -> int:
        with self._lock:
            return self._counts.get(device, 0)

    @property
    def blacklist(self) -> set:
        with self._lock:
            return set(self._blacklist)

    def is_healthy(self, device: int) -> bool:
        with self._lock:
            return device not in self._blacklist

    def healthy(self, n: int) -> List[int]:
        """Non-blacklisted device indices in ``range(n)`` (all if none are)."""
        with self._lock:
            out = [d for d in range(n) if d not in self._blacklist]
        return out if out else list(range(n))


class _WorkItem:
    """One enqueued command: a closure the device worker runs in order."""

    __slots__ = ("fn", "future")

    def __init__(self, fn: Callable[[], Any], future: "_cf.Future") -> None:
        self.fn = fn
        self.future = future


class StreamTicket:
    """A registered *reader* of device-stream handles.

    Opened under the data-environment lock when a region matches a present
    entry, closed once the region's EXEC has consumed the matched content.
    While open, any later command that writes those handles is held back.
    ``deps`` are the last-writer futures of the handles at open time: the
    consuming EXEC must run after them.
    """

    __slots__ = ("deps", "_fut")

    def __init__(self, deps: Sequence["_cf.Future"], fut: "_cf.Future") -> None:
        self.deps: Tuple["_cf.Future", ...] = tuple(deps)
        self._fut = fut

    def close(self) -> None:
        """Release the reader registration (idempotent)."""
        if not self._fut.done():
            self._fut.set_result(None)


class DevicePool:
    """Host view of all devices (paper: the parsed configuration file).

    ``DevicePool.from_config(["node0 2", "node1"], device="cuda")`` yields 3
    devices, all virtual shares of the one card.

    Commands flow through a **dependency-aware per-device stream** drained by
    one worker thread per device.  Each command names the buffer handles it
    reads and writes; a command becomes runnable once the last writer of
    every handle it touches — and, for writers, every registered reader —
    has settled.  ALLOC/FREE additionally write the ``SLOT_STREAM``
    pseudo-handle, chaining them in issue order so the device's first-fit
    allocator replays the exact sequence the host mirror predicted.  Ops
    that produce a value (EXEC, XFER_FROM) block on their command's future.
    ``stream_traces[d]`` records *execution* order (``trace`` keeps issue
    order).
    """

    def __init__(self, devices: Sequence[NodeDevice], *,
                 table: Optional[KernelTable] = None,
                 link: LinkModel = PAPER_ETHERNET) -> None:
        self.devices = list(devices)
        self.table = table or GLOBAL_KERNEL_TABLE
        self.cost = CostModel(link)
        self.health = HealthRegistry()
        self.mirrors = [HostMirror() for _ in self.devices]
        # RLocks: _submit re-acquires the issue lock the issue methods hold
        self.locks = [threading.RLock() for _ in self.devices]
        self.present = [PresentTable() for _ in self.devices]
        self.env_locks = [threading.RLock() for _ in self.devices]
        self.trace: List[Command] = []
        self._trace_lock = threading.Lock()
        self._queues: List["queue.SimpleQueue[Optional[_WorkItem]]"] = [
            queue.SimpleQueue() for _ in self.devices]
        self._stopped = [False for _ in self.devices]
        self._async_errors: List[Optional[BaseException]] = [None] * len(self.devices)
        # dependency-stream state, all guarded by locks[d]:
        self._last_write: List[Dict[int, "_cf.Future"]] = [
            {} for _ in self.devices]       # handle -> last writer's future
        self._readers: List[Dict[int, List["_cf.Future"]]] = [
            {} for _ in self.devices]       # handle -> readers since last write
        self._outstanding: List[List["_cf.Future"]] = [[] for _ in self.devices]
        # ring-buffered: execution order is a testing aid and must not grow
        # with run length
        self.stream_traces: List["collections.deque[Command]"] = [
            collections.deque(maxlen=4096) for _ in self.devices]
        self._workers = []
        for i in range(len(self.devices)):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name=f"omp-dev{i}", daemon=True)
            t.start()
            self._workers.append(t)

    # -- the per-device command-queue worker ---------------------------------
    def _worker(self, device: int) -> None:
        q = self._queues[device]
        dev = self.devices[device]
        while True:
            item = q.get()
            if item is None:                 # sentinel: queue closed
                return
            try:
                with dev.stream_context():
                    result = item.fn()
                item.future.set_result(result)
            except BaseException as e:       # propagate to the issuer
                item.future.set_exception(e)

    def _stream_deps(self, device: int, fut: "_cf.Future",
                     reads: Sequence[int], writes: Sequence[int],
                     extra_deps: Sequence["_cf.Future"]) -> List["_cf.Future"]:
        """Collect this command's dependencies and register it; under locks[d].

        Read-after-write: wait for the last writer of every handle touched.
        Write-after-read: a writer also waits for every reader registered
        since that last write (including open :class:`StreamTicket`\\ s).
        """
        lw, rd = self._last_write[device], self._readers[device]
        deps: Dict[int, "_cf.Future"] = {}
        for h in (*reads, *writes):
            f = lw.get(h)
            if f is not None and not f.done():
                deps[id(f)] = f
        for h in writes:
            for f in rd.get(h, ()):
                if not f.done():
                    deps[id(f)] = f
        for f in extra_deps:
            if f is not None and not f.done():
                deps[id(f)] = f
        for h in writes:
            lw[h] = fut
            rd[h] = []
        for h in reads:
            self._note_reader(rd, h, fut)
        return list(deps.values())

    @staticmethod
    def _note_reader(rd: Dict[int, List["_cf.Future"]], h: int,
                     fut: "_cf.Future") -> None:
        """Register a reader of ``h``, pruning settled ones."""
        lst = rd.setdefault(h, [])
        if len(lst) > 8:
            lst[:] = [f for f in lst if not f.done()]
        lst.append(fut)

    def _gate(self, device: int, item: _WorkItem,
              deps: Sequence["_cf.Future"]) -> None:
        """Hand the item to the worker once every dependency has settled
        (success *or* failure: dependencies order the stream, they do not
        gate on success)."""
        if not deps:
            self._queues[device].put(item)
            return
        remaining = [len(deps)]
        lk = threading.Lock()

        def _one_done(_f: "_cf.Future") -> None:
            with lk:
                remaining[0] -= 1
                if remaining[0]:
                    return
            self._queues[device].put(item)

        for f in deps:
            f.add_done_callback(_one_done)

    def _submit(self, device: int, fn: Callable[[], Any], *,
                reads: Sequence[int] = (), writes: Sequence[int] = (),
                extra_deps: Sequence["_cf.Future"] = ()) -> "_cf.Future":
        # stopped-check and registration are atomic under the issue lock so
        # no item can land behind stop_all's close sentinel
        with self.locks[device]:
            if self._stopped[device]:
                raise DeviceStoppedError(f"device {device} is stopped")
            fut: "_cf.Future" = _cf.Future()
            deps = self._stream_deps(device, fut, reads, writes, extra_deps)
            out = self._outstanding[device]
            if len(out) > 64:                # prune settled commands in place
                out[:] = [f for f in out if not f.done()]
            out.append(fut)
        self._gate(device, _WorkItem(fn, fut), deps)
        return fut

    def _submit_async(self, device: int, fn: Callable[[], Any], *,
                      reads: Sequence[int] = (), writes: Sequence[int] = (),
                      extra_deps: Sequence["_cf.Future"] = ()) -> "_cf.Future":
        """Enqueue fire-and-forget; failures surface at the next sync op."""
        fut = self._submit(device, fn, reads=reads, writes=writes,
                           extra_deps=extra_deps)

        def _stash(f: "_cf.Future") -> None:
            err = f.exception()
            if err is not None and self._async_errors[device] is None:
                self._async_errors[device] = err

        fut.add_done_callback(_stash)
        return fut

    def _raise_async(self, device: int) -> None:
        err, self._async_errors[device] = self._async_errors[device], None
        if err is not None:
            raise err

    def _traced(self, device: int, cmd: Command,
                fn: Callable[[], Any]) -> Callable[[], Any]:
        """Wrap ``fn`` to log the command in execution (not issue) order."""

        def run():
            self.stream_traces[device].append(cmd)
            return fn()

        return run

    def open_reader(self, device: int, handles: Sequence[int]) -> StreamTicket:
        """Register a reader of ``handles`` ahead of the EXEC that uses them.

        Returns a :class:`StreamTicket` whose ``deps`` are the handles' last
        writers (pass them to the EXEC via ``extra_deps``) and which, while
        open, blocks any later writer of the handles.  Call under the
        device's data-environment lock; always close it.
        """
        with self.locks[device]:
            lw, rd = self._last_write[device], self._readers[device]
            fut: "_cf.Future" = _cf.Future()
            deps: Dict[int, "_cf.Future"] = {}
            for h in handles:
                f = lw.get(h)
                if f is not None and not f.done():
                    deps[id(f)] = f
            for h in dict.fromkeys(handles):
                self._note_reader(rd, h, fut)
            return StreamTicket(list(deps.values()), fut)

    def sync(self, device: Optional[int] = None) -> None:
        """Barrier: wait until every command issued so far has settled."""
        devs = range(len(self.devices)) if device is None else [device]
        futs: List["_cf.Future"] = []
        for d in devs:
            with self.locks[d]:
                futs.extend(self._outstanding[d])
                self._outstanding[d][:] = [
                    f for f in self._outstanding[d] if not f.done()]
        if futs:
            _cf.wait(futs)
        for d in devs:
            self._raise_async(d)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_config(cls, lines: Sequence[str], *, device: DeviceLike = "cuda",
                    **kw) -> "DevicePool":
        """Parse paper-style config lines (``host [multiplier]``); every
        device is a virtual share of ``device``."""
        dev = resolve_device(device)
        devices: List[NodeDevice] = []
        for line in lines:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            host = parts[0]
            mult = int(parts[1]) if len(parts) > 1 else 1
            for _ in range(mult):
                devices.append(NodeDevice(len(devices), dev, hostname=host))
        return cls(devices, **kw)

    @classmethod
    def virtual(cls, n: int, *, device: DeviceLike = "cuda", **kw) -> "DevicePool":
        """n virtual devices on one card (or the CPU, when asked)."""
        return cls.from_config([f"vnode{i}" for i in range(n)], device=device,
                               **kw)

    def __len__(self) -> int:
        return len(self.devices)

    # -- command issue (host side) -------------------------------------------
    def _log(self, cmd: Command) -> None:
        with self._trace_lock:
            self.trace.append(cmd)

    def alloc(self, device: int, shape: Sequence[int], dtype: torch.dtype,
              tag: str = "") -> int:
        with self.locks[device]:
            handle = self.mirrors[device].reserve(shape, dtype)  # 0x999 mark
            cmd = Command("ALLOC", device, handle=handle,
                          nbytes=self.mirrors[device].nbytes(handle), tag=tag,
                          writes=(handle, SLOT_STREAM))
            self._log(cmd)
            payload = {"shape": tuple(shape), "dtype": dtype}
            self._submit_async(
                device,
                self._traced(device, cmd,
                             lambda: self.devices[device].execute(cmd, self.table, payload)),
                writes=cmd.writes)
            return handle

    def free(self, device: int, handle: int) -> None:
        with self.locks[device]:
            self.mirrors[device].free(handle)
            cmd = Command("FREE", device, handle=handle,
                          writes=(handle, SLOT_STREAM))
            self._log(cmd)
            self._submit_async(
                device,
                self._traced(device, cmd,
                             lambda: self.devices[device].execute(cmd, self.table)),
                writes=cmd.writes)

    def transfer_to(self, device: int, handle: int, value: Any,
                    section: Optional[slice] = None, tag: str = "") -> "_cf.Future":
        value = as_host_tensor(value)
        nbytes = value.numel() * value.element_size()
        with self.locks[device]:
            cmd = Command("XFER_TO", device, handle=handle, nbytes=nbytes,
                          tag=tag, writes=(handle,))
            self._log(cmd)
            self.cost.record_transfer("to", device, nbytes, tag=tag)
            payload = {"value": value, "section": section}
            return self._submit_async(
                device,
                self._traced(device, cmd,
                             lambda: self.devices[device].execute(cmd, self.table, payload)),
                writes=cmd.writes)

    def transfer_from(self, device: int, handle: int,
                      section: Optional[slice] = None, tag: str = "") -> torch.Tensor:
        with self.locks[device]:
            cmd = Command("XFER_FROM", device, handle=handle, tag=tag,
                          reads=(handle,))
            self._log(cmd)
            payload = {"section": section}
            fut = self._submit(
                device,
                self._traced(device, cmd,
                             lambda: self.devices[device].execute(cmd, self.table, payload)),
                reads=cmd.reads)
        out = fut.result()
        self._raise_async(device)
        nbytes = out.numel() * out.element_size()
        self.cost.record_transfer("from", device, nbytes, tag=tag)
        return out

    def transfer_to_writeback(self, device: int, handle: int,
                              value: torch.Tensor) -> "_cf.Future":
        """Device-local write-back of a kernel result (no host↔device traffic).

        A writer of ``handle`` in the device stream: it runs after the
        region's EXEC (a registered reader) and before any later consumer.
        ``value`` is the EXEC's output, already on the device and finished.
        """

        def wb():
            store = self.devices[device].store
            store.free(handle)
            store.install(handle, value)

        return self._submit_async(device, wb, writes=(handle,))

    def peer_copy(self, src: int, src_handle: int, dst: int, dst_handle: int,
                  *, nbytes: Optional[int] = None, tag: str = "") -> "_cf.Future":
        """Device→device copy: a SEND on ``src``'s stream rendezvousing with
        a RECV on ``dst``'s stream; the transfer never touches the host
        funnel (it is accounted as peer-link traffic instead).

        Ordering composes with ``nowait`` and resident buffers like
        XFER/EXEC: SEND *reads* ``src_handle`` (runs after its last
        producer, holds back its next writer) and RECV *writes*
        ``dst_handle``.  RECV is gated on the SEND future (``extra_deps``),
        so the destination worker gets the command only once the payload
        exists.  That edge always points from an earlier-issued command to
        a later-issued one, so no cycle can form: any interleaving of peer
        copies, full rings included, is deadlock-free.

        ``nbytes`` overrides the accounted message size (modeled wire
        compression); the payload itself always moves intact.  Returns the
        RECV future (a registered writer of ``dst_handle``); a SEND failure
        propagates through it.
        """
        if src == dst:
            raise ValueError(f"peer_copy: src and dst are both device {src}")
        wire = self.mirrors[src].nbytes(src_handle) if nbytes is None else int(nbytes)
        with self.locks[src]:
            scmd = Command("SEND", src, handle=src_handle, nbytes=wire,
                           tag=tag, peer=dst, reads=(src_handle,))
            self._log(scmd)
            send_fut = self._submit_async(
                src,
                self._traced(src, scmd,
                             lambda: self.devices[src].execute(scmd, self.table)),
                reads=scmd.reads)
        with self.locks[dst]:
            rcmd = Command("RECV", dst, handle=dst_handle, nbytes=wire,
                           tag=tag, peer=src, writes=(dst_handle,))
            self._log(rcmd)
            payload = {"source": send_fut}
            recv_fut = self._submit_async(
                dst,
                self._traced(dst, rcmd,
                             lambda: self.devices[dst].execute(rcmd, self.table,
                                                               payload)),
                writes=rcmd.writes, extra_deps=(send_fut,))
        self.cost.record_peer(src, dst, wire, tag=tag)
        return recv_fut

    def exec_kernel(self, device: int, kernel_name: str,
                    buffers: Dict[str, Any],
                    firstprivate: Optional[Dict[str, Any]] = None,
                    trees: Optional[Dict[str, Any]] = None,
                    tag: str = "", skip_reads: Sequence[int] = (),
                    extra_deps: Sequence["_cf.Future"] = ()) -> Any:
        """Run a kernel; reads are derived from the mapped buffer handles.

        ``skip_reads`` names handles an open :class:`StreamTicket` already
        covers; their ordering arrives via ``extra_deps`` instead.  The
        kernel runs eagerly on the device's stream, which is synchronized
        before the result is handed back (the reference's
        ``block_until_ready``).
        """
        index = self.table.index_of(kernel_name)   # name → wire integer
        all_handles: List[int] = []
        for h in buffers.values():
            all_handles.extend(h if isinstance(h, (list, tuple)) else [h])
        skip = set(skip_reads)
        reads = tuple(h for h in all_handles if h not in skip)
        with self.locks[device]:
            cmd = Command("EXEC", device, kernel_index=index,
                          tag=tag or kernel_name, reads=tuple(all_handles))
            self._log(cmd)
            payload = {"buffers": buffers, "firstprivate": firstprivate or {},
                       "trees": trees or {}}

            def run_exec():
                t0 = time.perf_counter()
                out = self.devices[device].execute(cmd, self.table, payload)
                return out, time.perf_counter() - t0

            fut = self._submit(device, self._traced(device, cmd, run_exec),
                               reads=reads, extra_deps=extra_deps)
        out, seconds = fut.result()
        self._raise_async(device)
        self.cost.record_compute(device, seconds, tag=tag or kernel_name,
                                 kernel=kernel_name)
        return out

    def _stop_device(self, i: int) -> Optional["_cf.Future"]:
        """Close device ``i``'s stream: gate a STOP on everything in flight,
        mark the queue refused, and schedule the worker-exit sentinel."""
        with self.locks[i]:
            if self._stopped[i]:
                return None
            cmd = Command("STOP", i)
            self._log(cmd)
            deps = [f for f in self._outstanding[i] if not f.done()]
            fut: "_cf.Future" = _cf.Future()
            self._outstanding[i].append(fut)
            self._stopped[i] = True
        self._gate(i, _WorkItem(
            self._traced(i, cmd,
                         lambda i=i, cmd=cmd: self.devices[i].execute(cmd, self.table)),
            fut), deps)
        fut.add_done_callback(lambda _f, i=i: self._queues[i].put(None))
        return fut

    def stop_all(self) -> None:
        futs = [self._stop_device(d.index) for d in self.devices]
        for f in futs:
            if f is not None:
                f.result()
        for t in self._workers:
            t.join()
