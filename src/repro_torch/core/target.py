"""``target()`` offload regions with OpenMP ``map`` semantics (paper §3).

An OpenMP target region names a kernel, a device, and a set of ``map``
clauses; port of ``repro.core.target``:

* ``map(to=...)``      — value copied host → device before execution,
* ``map(from_=...)``   — value copied device → host after execution,
* ``map(tofrom=...)``  — both,
* ``map(alloc=...)``   — device allocation, no transfer either way,
* ``firstprivate``     — small scalars passed by value in the EXEC message,
* array *sections* — ``sec(array, start, length)`` moves only a sub-array
  (paper Listing 2).

A kernel returns a dict ``{name: new_value}`` for every ``from_``/``tofrom``
name; the runtime writes results back into the mediary store and transfers
them to the host.  ``MapSpec.present`` binds names that must already be
resident; ``MapSpec.device_out`` writes an output back into a present entry
on the device without fetching it (the entry becomes *device-ahead* until
:meth:`TargetExecutor.fetch_resident`).

``nowait=True`` returns a :class:`TargetFuture`; the pool's dependency-aware
stream orders commands per buffer handle.  ``taskwait()`` joins everything;
``drain(futs)`` joins exactly the given futures.

Device data environments (``enter_data``/``exit_data``/``target_data``/
``ensure_resident``) pin named buffers in the device's reference-counted
present table.  A region whose map clause names a present buffer with the
same, unmodified host value skips ALLOC and XFER; a changed value re-sends
only the changed leaves.  Tensors are mutable, so "unmodified" is identity
**and** an unchanged ``tensor._version`` (:func:`~.mediary.leaf_unchanged`).

``alloc_resident`` pins an uninitialized, device-ahead buffer (the output
half of a data environment) and ``propagate_resident`` fulfills a present
entry on another device straight from a device copy, over the peer fabric.

Left for later slices: capacity spill/refetch (ROADMAP item 10),
self-healing of failed writers (item 11), declare-target globals.
"""
from __future__ import annotations

import concurrent.futures as _cf
import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Tuple, Union

import torch

from . import _tree
from .device import DevicePool, DeviceStoppedError, StreamTicket, as_host_tensor
from .mediary import (PresentEntry, TensorSpec, host_version, leaf_unchanged,
                      same_treedef)


@dataclass(frozen=True)
class Section:
    """An OpenMP array section ``a[start:start+length]`` along axis 0."""

    array: Any
    start: int
    length: int

    @property
    def value(self) -> torch.Tensor:
        return as_host_tensor(self.array)[self.start:self.start + self.length]

    @property
    def slice(self) -> slice:
        return slice(self.start, self.start + self.length)


def sec(array: Any, start: int, length: int) -> Section:
    return Section(array, start, length)


@dataclass
class MapSpec:
    """The map clauses of one target region."""

    to: Dict[str, Any] = field(default_factory=dict)
    from_: Dict[str, Any] = field(default_factory=dict)     # name -> TensorSpec | template
    tofrom: Dict[str, Any] = field(default_factory=dict)
    alloc: Dict[str, Any] = field(default_factory=dict)
    firstprivate: Dict[str, Any] = field(default_factory=dict)
    use_globals: Tuple[str, ...] = ()                       # declare-target vars
    # OpenMP's ``present`` modifier: names that MUST already be resident;
    # a tuple of names or a dict {kernel kwarg: entry name}
    present: Any = ()
    # outputs written back on-device into a present entry, not fetched
    device_out: Any = ()


class TargetFuture:
    """Handle to an in-flight ``nowait`` region."""

    def __init__(self, fut: _cf.Future) -> None:
        self._fut = fut

    def result(self) -> Dict[str, torch.Tensor]:
        return self._fut.result()

    def done(self) -> bool:
        return self._fut.done()


def _as_spec(x: Any) -> TensorSpec:
    if isinstance(x, TensorSpec):
        return x
    t = as_host_tensor(x)
    return TensorSpec(tuple(t.shape), t.dtype)


def _alias_map(x: Any) -> Dict[str, str]:
    """Normalize a present/device_out clause: kernel kwarg -> entry name."""
    if isinstance(x, Mapping):
        return dict(x)
    return {n: n for n in x}


def _flatten_map_value(val: Any) -> Tuple[List[Any], Any]:
    """(leaves, treedef|None): None treedef = plain single array."""
    if isinstance(val, (Section, TensorSpec)) or hasattr(val, "shape"):
        return [val], None
    leaves, treedef = _tree.flatten(val)
    if treedef == _tree.LEAF:
        return leaves, None
    return leaves, treedef


class TargetExecutor:
    """Executes target regions against a :class:`DevicePool`."""

    def __init__(self, pool: DevicePool, max_host_threads: int = 16) -> None:
        self.pool = pool
        self._tp = _cf.ThreadPoolExecutor(max_workers=max_host_threads,
                                          thread_name_prefix="omp-host")
        self._inflight: List[TargetFuture] = []
        self._inflight_lock = threading.Lock()

    def close(self) -> None:
        """Stop the host threads that run ``nowait`` regions."""
        self._tp.shutdown(wait=True)

    # -- the target construct -------------------------------------------------
    def target(self, kernel: str, device: int, maps: MapSpec, *,
               nowait: bool = False, tag: str = ""
               ) -> Union[Dict[str, torch.Tensor], TargetFuture]:
        if nowait:
            fut = TargetFuture(self._tp.submit(self._run, kernel, device, maps, tag))
            with self._inflight_lock:
                self._inflight.append(fut)
            return fut
        return self._run(kernel, device, maps, tag)

    def taskwait(self) -> List[Dict[str, torch.Tensor]]:
        with self._inflight_lock:
            futs = list(self._inflight)
        return self.drain(futs)

    def drain(self, futs: Iterable[TargetFuture]) -> List[Dict[str, torch.Tensor]]:
        """Join exactly ``futs`` and retire them from the in-flight list.

        Waits for every future to settle before retiring, even when an early
        one failed, so no region keeps running unjoined.
        """
        futs = list(futs)
        try:
            return [f.result() for f in futs]
        finally:
            if futs:
                _cf.wait([f._fut for f in futs])
            self.retire(futs)

    def retire(self, futs: Iterable[TargetFuture]) -> None:
        """Remove already-settled futures from the in-flight list."""
        with self._inflight_lock:
            ids = {id(f) for f in futs}
            self._inflight = [f for f in self._inflight if id(f) not in ids]

    # -- device data environments (OpenMP target data, paper §3) --------------
    def enter_data(self, device: int, _tag: str = "enter_data", /,
                   **values: Any) -> None:
        """``target enter data``: make named buffers resident on ``device``.

        Already-present names gain a reference; their device copy is
        refreshed (changed leaves only).  Pair every ``enter_data`` with an
        :meth:`exit_data`.  All-or-nothing: if a later name fails, references
        already taken by this call are unwound.
        """
        entered: List[str] = []
        try:
            for name, val in values.items():
                self._enter_one(device, name, val, retain=True, tag=_tag)
                entered.append(name)
        except BaseException:
            if entered:
                self.exit_data(device, *entered)
            raise

    def ensure_resident(self, device: int, _tag: str = "resident", /,
                        **values: Any) -> None:
        """Idempotent residency: enter once, afterwards only refresh (the
        buffer stays pinned with refcount 1 until :meth:`exit_data`)."""
        for name, val in values.items():
            self._enter_one(device, name, val, retain=False, tag=_tag)

    def _enter_one(self, device: int, name: str, val: Any, *,
                   retain: bool, tag: str) -> None:
        pool = self.pool
        leaves, treedef = _flatten_map_value(val)
        if any(isinstance(l, Section) for l in leaves):
            raise TypeError(f"array section {name!r} cannot be made resident")
        with pool.env_locks[device]:
            ent = pool.present[device].get(name)
            if ent is None:
                # convert before allocating: a bad leaf must fail with zero
                # device state
                vals = [as_host_tensor(leaf) for leaf in leaves]
                hs, specs, wfuts = [], [], []
                try:
                    for v in vals:
                        h = pool.alloc(device, v.shape, v.dtype, tag=f"{tag}:{name}")
                        hs.append(h)
                        wfuts.append(pool.transfer_to(device, h, v,
                                                      tag=f"{tag}:{name}"))
                        specs.append(TensorSpec(tuple(v.shape), v.dtype))
                except BaseException:
                    with contextlib.suppress(DeviceStoppedError):
                        for h in hs:
                            pool.free(device, h)
                    raise
                entry = PresentEntry(
                    name=name, handles=hs, treedef=treedef,
                    host_leaves=list(leaves),
                    host_versions=[host_version(l) for l in leaves],
                    specs=specs, write_futs=wfuts)
                entry.debit = entry.nbytes()
                pool.present[device].add(entry)
            else:
                # refresh first: a structure-mismatch error must not leak a
                # reference
                self._refresh(device, ent, leaves, treedef, tag)
                if retain:
                    ent.refcount += 1

    def _refresh(self, device: int, ent: PresentEntry, leaves: List[Any],
                 treedef: Any, tag: str) -> None:
        """Re-send only the leaves whose host value changed (version bump).

        Validates every leaf before moving any bytes.  A leaf is unchanged
        only if it is the same tensor with the same ``_version`` — identity
        alone would keep a stale device copy after an in-place update.  A
        device-ahead entry re-sends every leaf (host-authoritative overwrite).
        """
        pool = self.pool
        if not same_treedef(ent.treedef, treedef) or len(ent.host_leaves) != len(leaves):
            raise ValueError(
                f"resident buffer {ent.name!r} structure changed; "
                f"exit_data it first")
        stale = []
        for i, leaf in enumerate(leaves):
            if (not ent.device_ahead
                    and leaf_unchanged(ent.host_leaves[i], ent.host_versions[i],
                                       leaf)):
                continue
            v = as_host_tensor(leaf)
            if TensorSpec(tuple(v.shape), v.dtype) != ent.specs[i]:
                raise ValueError(
                    f"resident buffer {ent.name!r} leaf {i} changed "
                    f"shape/dtype {ent.specs[i]} -> {tuple(v.shape)}/{v.dtype}; "
                    f"exit_data it first")
            stale.append((i, leaf, v))
        for i, leaf, v in stale:
            fut = pool.transfer_to(device, ent.handles[i], v,
                                   tag=f"{tag}:{ent.name}")
            if i < len(ent.write_futs):
                ent.write_futs[i] = fut
            ent.host_leaves[i] = leaf
            ent.host_versions[i] = host_version(leaf)
            ent.debit += ent.specs[i].nbytes
        if stale:
            ent.version += 1
            ent.device_ahead = False       # the host push wins from here on

    def exit_data(self, device: int, *names: str) -> None:
        """``target exit data``: drop one reference; free at zero."""
        pool = self.pool
        dead: List[PresentEntry] = []
        with pool.env_locks[device]:
            for name in names:
                e = pool.present[device].release(name)
                if e is not None:
                    dead.append(e)
        for e in dead:
            for h in e.handles:
                pool.free(device, h)

    @contextlib.contextmanager
    def target_data(self, device: int, /, **values: Any):
        """Scoped data environment (OpenMP ``target data`` region).

        ``nowait`` regions launched inside must be joined before the block
        exits.
        """
        self.enter_data(device, "target_data", **values)
        try:
            yield self
        finally:
            self.exit_data(device, *values.keys())

    def fetch_resident(self, device: int, name: str) -> Any:
        """Pull a resident buffer's device copy back to the host.

        Records the fetched values as the entry's host view (so host-value
        matches work again) and clears the device-ahead flag.
        """
        pool = self.pool
        with pool.env_locks[device]:
            ent = pool.present[device].get(name)
            if ent is None:
                raise KeyError(f"{name!r} is not resident on device {device}")
            ent.refcount += 1          # hold: a concurrent exit_data must not
                                       # free the handles mid-fetch
            handles, treedef = list(ent.handles), ent.treedef
            seen = (ent.version, tuple(ent.write_futs))
        try:
            fetched = [pool.transfer_from(device, h, tag=f"fetch:{name}")
                       for h in handles]
            with pool.env_locks[device]:
                ent = pool.present[device].get(name)
                # reconcile only if nothing wrote the entry while we fetched
                if (ent is not None and len(ent.host_leaves) == len(fetched)
                        and (ent.version, tuple(ent.write_futs)) == seen):
                    ent.host_leaves = list(fetched)
                    ent.host_versions = [host_version(l) for l in fetched]
                    ent.device_ahead = False
        finally:
            self.exit_data(device, name)
        return fetched[0] if treedef is None else _tree.unflatten(treedef, fetched)

    def alloc_resident(self, device: int, name: str, template: Any, *,
                       tag: str = "alloc_resident") -> None:
        """Pin an *uninitialized* buffer: ALLOC only, zero host transfer.

        The entry starts *device-ahead* (the host has no value for it:
        ``host_leaves`` are None placeholders, so value matches miss until a
        fetch reconciles); a kernel's ``device_out`` map writes it, a peer
        collective reduces it, :meth:`fetch_resident` reads it back.
        ``template`` is a value, a :class:`TensorSpec`, or a pytree of
        either.
        """
        pool = self.pool
        leaves, treedef = _flatten_map_value(template)
        if any(isinstance(l, Section) for l in leaves):
            raise TypeError(f"array section {name!r} cannot be made resident")
        specs = [_as_spec(l) for l in leaves]
        with pool.env_locks[device]:
            if pool.present[device].get(name) is not None:
                raise KeyError(f"{name!r} is already resident on device {device}")
            hs = [pool.alloc(device, s.shape, s.dtype, tag=f"{tag}:{name}")
                  for s in specs]
            pool.present[device].add(PresentEntry(
                name=name, handles=hs, treedef=treedef,
                host_leaves=[None] * len(hs), specs=specs,
                host_versions=[None] * len(hs),
                write_futs=[None] * len(hs), device_ahead=True))

    def propagate_resident(self, src: int, dst: int, name: str, *,
                           transport: Any = None, tag: str = "peer",
                           compress_wire: bool = False) -> None:
        """Fulfill a present entry device→device: ``dst`` gains (or
        refreshes) entry ``name`` from ``src``'s device copy, without host
        reconciliation.

        The peer-path analogue of ``enter_data``: a *device-ahead* entry
        propagates still device-ahead — the host never sees the bytes.  If
        ``dst`` already holds ``name`` (same structure), its handles are
        overwritten; otherwise fresh handles are allocated and the entry
        installed with one reference, owned by the caller.  ``transport``
        defaults to a :class:`~.transport.PeerTransport`; a
        ``HostFunnelTransport`` routes the same fulfillment through the
        host NIC.

        ``compress_wire=True`` accounts each leaf's message at its
        block-int8 wire size (the transport topology's block, 256 without
        one) — *modeled* wire compression: the payload moves intact, so the
        destination's value is bit-identical either way.  The graph runner
        sets it for edges the policy routed ``"peer+int8"``.
        """
        if src == dst:
            return
        pool = self.pool
        if transport is None:
            from .transport import PeerTransport
            transport = PeerTransport()
        with pool.env_locks[src]:
            sent = pool.present[src].get(name)
            if sent is None:
                raise KeyError(f"{name!r} is not resident on device {src}")
            sent.refcount += 1         # hold: a concurrent exit_data must not
                                       # free the source handles mid-copy
            src_handles = list(sent.handles)
            snap = sent.peer_clone(src_handles, [])
            specs, treedef = list(snap.specs), snap.treedef
        try:
            with pool.env_locks[dst]:
                dent = pool.present[dst].get(name)
                if dent is not None:
                    if (not same_treedef(dent.treedef, treedef)
                            or list(dent.specs) != specs):
                        raise ValueError(
                            f"resident buffer {name!r} structure differs "
                            f"between devices {src} and {dst}; exit_data the "
                            f"stale one first")
                    dst_handles = list(dent.handles)
                else:
                    dst_handles = [pool.alloc(dst, s.shape, s.dtype,
                                              tag=f"{tag}:{name}")
                                   for s in specs]
                wires: List[Any] = [None] * len(specs)
                if compress_wire:
                    from .compression import int8_wire_nbytes
                    block = getattr(getattr(transport, "topology", None),
                                    "block", 256)
                    wires = [int8_wire_nbytes(math.prod(s.shape), block)
                             for s in specs]
                futs = [transport.sendrecv(pool, src, sh, dst, dh,
                                           nbytes=w, tag=f"{tag}:{name}")
                        for sh, dh, w in zip(src_handles, dst_handles, wires)]
                if dent is None:
                    pool.present[dst].add(snap.peer_clone(dst_handles, futs))
                else:
                    # refresh in place: the peer write is the new producer
                    dent.host_leaves = list(snap.host_leaves)
                    dent.host_versions = list(snap.host_versions)
                    dent.device_ahead = snap.device_ahead
                    dent.write_futs = futs
                    dent.version += 1
        finally:
            self.exit_data(src, name)  # release the hold taken above

    # -- region lifecycle (paper §4.1/§4.2) ------------------------------------
    def _run(self, kernel: str, device: int, maps: MapSpec,
             tag: str) -> Dict[str, torch.Tensor]:
        pool = self.pool
        if maps.use_globals:
            raise NotImplementedError(
                "declare-target globals (use_globals) are not ported yet")
        handles: Dict[str, Any] = {}   # name -> handle | [handles] (pytree)
        trees: Dict[str, Any] = {}     # name -> treedef for pytree maps
        owned: List[int] = []    # region-lifetime handles, freed at region end
        retained: List[str] = []  # present-table names released at region end
        # matched present entries are consumed through a StreamTicket: opened
        # under the env lock at match time, closed right after EXEC
        tickets: Dict[str, StreamTicket] = {}
        ticketed: set = set()          # handles covered by an open ticket
        exec_deps: List[Any] = []

        def _retain_ticketed(name: str, ent: PresentEntry) -> List[int]:
            hs = list(ent.handles)
            retained.append(name)
            if name not in tickets:    # same name in two clauses reuses the
                                       # ticket
                t = pool.open_reader(device, hs)
                tickets[name] = t
                exec_deps.extend(t.deps)
            ticketed.update(hs)
            exec_deps.extend(f for f in ent.write_futs if f is not None)
            return hs

        try:
            # 0) present/device_out names bind the resident handles directly
            present_alias = _alias_map(maps.present)
            out_alias = _alias_map(maps.device_out)
            for kwarg, rname in {**present_alias, **out_alias}.items():
                with pool.env_locks[device]:
                    ent = pool.present[device].get(rname)
                    if ent is None:
                        raise KeyError(
                            f"map(present) name {rname!r} is not resident on "
                            f"device {device}; enter_data/ensure_resident it first")
                    ent.refcount += 1
                    hs = _retain_ticketed(rname, ent)
                    treedef = ent.treedef
                handles[kwarg] = hs[0] if treedef is None else hs
                if treedef is not None:
                    trees[kwarg] = treedef
            # 1) ALLOC + XFER_TO for to/tofrom — unless the name is present on
            #    the device with the same host value (transfer elided)
            for name, val in {**maps.to, **maps.tofrom}.items():
                leaves, treedef = _flatten_map_value(val)
                ent = None
                if not any(isinstance(l, Section) for l in leaves):
                    with pool.env_locks[device]:
                        ent = pool.present[device].match_value(name, leaves, treedef)
                        if ent is not None:
                            hs = _retain_ticketed(name, ent)
                if ent is None:
                    hs = []
                    for leaf in leaves:
                        v = leaf.value if isinstance(leaf, Section) else as_host_tensor(leaf)
                        h = pool.alloc(device, v.shape, v.dtype, tag=f"{tag}:{name}")
                        # the send is a dep of our EXEC, so its failure
                        # surfaces in this region
                        exec_deps.append(
                            pool.transfer_to(device, h, v, tag=f"{tag}:{name}"))
                        hs.append(h)
                        owned.append(h)
                handles[name] = hs[0] if treedef is None else hs
                if treedef is not None:
                    trees[name] = treedef
            # ALLOC only for alloc/from_ — a present entry of matching shape
            # is reused as the output buffer
            for name, spec in {**maps.alloc, **maps.from_}.items():
                leaves, treedef = _flatten_map_value(spec)
                specs = [_as_spec(leaf) for leaf in leaves]
                with pool.env_locks[device]:
                    ent = pool.present[device].match_specs(name, specs, treedef)
                    if ent is not None:
                        hs = _retain_ticketed(name, ent)
                if ent is None:
                    hs = []
                    for s in specs:
                        h = pool.alloc(device, s.shape, s.dtype, tag=f"{tag}:{name}")
                        hs.append(h)
                        owned.append(h)
                handles[name] = hs[0] if treedef is None else hs
                if treedef is not None:
                    trees[name] = treedef

            # 2) EXEC — the kernel sees device-resident buffers as kwargs and
            #    returns replacements for from_/tofrom/device_out names.
            result = pool.exec_kernel(device, kernel, buffers=handles, trees=trees,
                                      firstprivate=maps.firstprivate, tag=tag,
                                      skip_reads=tuple(ticketed),
                                      extra_deps=tuple(exec_deps))
            # the EXEC was *ordered* after its deps, not gated on their
            # success: surface a failed dep instead of a result computed on
            # an unwritten buffer
            for f in exec_deps:
                if f is not None and f.done() and f.exception() is not None:
                    raise f.exception()
            returned: Dict[str, Any] = {}
            if result is not None:
                if not isinstance(result, Mapping):
                    raise TypeError(
                        f"kernel {kernel!r} must return a dict of mapped outputs, "
                        f"got {type(result)}")
                returned = dict(result)

            # the EXEC has consumed the matched content: release the readers
            for t in tickets.values():
                t.close()

            def _ret_leaves(name: str) -> Tuple[List[int], List[Any], Any]:
                if name not in returned:
                    raise KeyError(f"kernel {kernel!r} did not return mapped output {name!r}")
                h = handles[name]
                hs = h if isinstance(h, list) else [h]
                ret_leaves, ret_def = _tree.flatten(returned[name])
                if len(ret_leaves) != len(hs):
                    raise ValueError(
                        f"kernel {kernel!r} returned {len(ret_leaves)} leaves "
                        f"for {name!r}, mapped {len(hs)}")
                return hs, ret_leaves, ret_def

            def _writeback_ahead(rname: str, hs: List[int], ret_leaves: List[Any],
                                 bump_version: bool):
                """Mark the entry device-ahead and submit the writebacks in
                ONE env-lock critical section; returns a (version,
                write_futs) snapshot for the reconcile guard."""
                with pool.env_locks[device]:
                    ent = pool.present[device].get(rname)
                    if ent is not None:
                        ent.device_ahead = True
                        if bump_version:
                            ent.version += 1
                    wfuts = [pool.transfer_to_writeback(device, hh, leaf)
                             for hh, leaf in zip(hs, ret_leaves)]
                    if ent is None:
                        return None
                    ent.write_futs = wfuts
                    return (ent.version, tuple(wfuts))

            # 3a) device_out: write back on-device, move nothing over the wire
            for kwarg, rname in out_alias.items():
                hs, ret_leaves, _ = _ret_leaves(kwarg)
                _writeback_ahead(rname, hs, ret_leaves, bump_version=True)

            # 3b) write-back + XFER_FROM for from_/tofrom.
            out: Dict[str, torch.Tensor] = {}
            for name in list(maps.from_) + list(maps.tofrom):
                hs, ret_leaves, ret_def = _ret_leaves(name)
                fetched: List[Any] = []
                if name in retained:
                    # resident output: device-ahead until the fetch below
                    # reconciles the entry with the fetched host value
                    seen = _writeback_ahead(name, hs, ret_leaves,
                                            bump_version=False)
                    for hh in hs:
                        fetched.append(pool.transfer_from(device, hh,
                                                          tag=f"{tag}:{name}"))
                    with pool.env_locks[device]:
                        ent = pool.present[device].get(name)
                        if (ent is not None and seen is not None
                                and len(ent.host_leaves) == len(fetched)
                                and (ent.version, tuple(ent.write_futs)) == seen):
                            ent.host_leaves = list(fetched)
                            ent.host_versions = [host_version(l) for l in fetched]
                            ent.version += 1
                            ent.device_ahead = False
                else:
                    for hh, leaf in zip(hs, ret_leaves):
                        pool.transfer_to_writeback(device, hh, leaf)
                        fetched.append(pool.transfer_from(device, hh,
                                                          tag=f"{tag}:{name}"))
                out[name] = (fetched[0] if not isinstance(handles[name], list)
                             else _tree.unflatten(ret_def, fetched))
            return out
        finally:
            # 4) region end: free region-lifetime handles on both device and
            #    host mirror and settle the device queue; present entries
            #    only drop the region's reference
            for t in tickets.values():
                t.close()              # idempotent; vital on the error path
            try:
                for h in owned:
                    pool.free(device, h)
                if owned:
                    pool.sync(device)
                if retained:
                    self.exit_data(device, *retained)
            except DeviceStoppedError:
                pass                       # device stopped mid-teardown
