"""Mediary addresses: host↔device buffer-handle indirection (paper §4.2).

The host cannot know remote addresses, so OMPi maps a host address to an
abstract *mediary address* — an integer slot in a per-device dynamic array.
The device stores the real buffer at that slot; the host keeps a *mirror* of
the array so it can assign the next handle without a round trip.

PyTorch port of ``repro.core.mediary``: the device buffer is a tensor on the
device's ``torch.device``, and the mirror keeps only :class:`TensorSpec`
metadata (the port's stand-in for ``jax.ShapeDtypeStruct``).  Handles come
from the same first-fit allocator, so one ALLOC/FREE script gives the same
handle sequence in both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

#: Paper §4.2: "marks it with the special (and arbitrary) value of 0x999".
RESERVED = 0x999


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a buffer that does not exist yet (an output map)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self) -> None:
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def same_treedef(a: Any, b: Any) -> bool:
    """None-safe treedef equality (None = a single array, not a tree)."""
    if (a is None) != (b is None):
        return False
    return a is None or a == b


class SlotTableBase:
    """First-fit slot allocator shared by device store and host mirror."""

    def __init__(self) -> None:
        self._slots: List[Any] = []  # None = unused (paper: NULL address)

    def _first_free(self) -> int:
        for i, v in enumerate(self._slots):
            if v is None:
                return i
        self._slots.append(None)
        return len(self._slots) - 1

    def free(self, handle: int) -> None:
        if not (0 <= handle < len(self._slots)) or self._slots[handle] is None:
            raise KeyError(f"mediary handle {handle} is not live")
        self._slots[handle] = None

    def live_handles(self) -> List[int]:
        return [i for i, v in enumerate(self._slots) if v is not None]

    def __len__(self) -> int:
        return len(self._slots)


class MediaryStore(SlotTableBase):
    """Device-side mediary array: handle → actual buffer (paper: calloc'd ptr)."""

    def __init__(self, device: torch.device) -> None:
        super().__init__()
        self.device = device

    # -- commands from the host (paper §4.1 command types) -----------------
    def alloc(self, shape: Sequence[int], dtype: torch.dtype) -> int:
        """ALLOC: zero-initialized, as OMPi uses ``calloc()``."""
        handle = self._first_free()
        self._slots[handle] = torch.zeros(tuple(shape), dtype=dtype,
                                          device=self.device)
        return handle

    def install(self, handle: int, value: torch.Tensor) -> None:
        """Place an existing buffer at a specific slot."""
        while len(self._slots) <= handle:
            self._slots.append(None)
        if self._slots[handle] is not None:
            raise KeyError(f"mediary handle {handle} already live")
        self._slots[handle] = value

    def write(self, handle: int, value: torch.Tensor,
              section: Optional[slice] = None) -> None:
        """TRANSFER_TO: host → device (optionally into an array section).

        ``value`` is already on the device.  A section write builds a new
        buffer rather than writing in place, so a tensor an earlier kernel
        returned (and that may alias this slot) never changes under it.
        """
        cur = self._lookup(handle)
        value = value.to(cur.dtype)
        if section is not None:
            cur = cur.clone()
            cur[section] = value
        else:
            if tuple(value.shape) != tuple(cur.shape):
                raise ValueError(f"shape mismatch {tuple(value.shape)} vs "
                                 f"{tuple(cur.shape)}")
            cur = value
        self._slots[handle] = cur

    def read(self, handle: int, section: Optional[slice] = None) -> torch.Tensor:
        """TRANSFER_FROM: device → host (the caller copies to the host)."""
        cur = self._lookup(handle)
        return cur[section] if section is not None else cur

    def _lookup(self, handle: int) -> torch.Tensor:
        if not (0 <= handle < len(self._slots)) or self._slots[handle] is None:
            raise KeyError(f"mediary handle {handle} is not live")
        return self._slots[handle]

    # Device addresses (paper fig. 1 right column).
    def device_address(self, handle: int) -> torch.Tensor:
        return self._lookup(handle)


@dataclass(frozen=True)
class MirrorEntry:
    spec: TensorSpec
    nbytes: int


# ---------------------------------------------------------------------------
# Present table: persistent device data environments (OpenMP target data)
# ---------------------------------------------------------------------------
def leaf_unchanged(old: Any, old_version: Optional[int], new: Any) -> bool:
    """Whether host leaf ``new`` is provably the value last sent as ``old``.

    The reference elides a leaf only when it is the identical immutable
    ``jax.Array``.  Tensors are mutable, so identity alone would serve a
    stale device copy after an in-place update: the tensor's ``_version``
    counter (bumped by every in-place op) must also be unchanged.  Other
    host values (numpy arrays, scalars) never elide, as in the reference.
    """
    return (old is new and isinstance(new, torch.Tensor)
            and old_version is not None and new._version == old_version)


def host_version(leaf: Any) -> Optional[int]:
    return leaf._version if isinstance(leaf, torch.Tensor) else None


@dataclass
class PresentEntry:
    """One logical buffer resident on a device.

    ``host_leaves`` are the host-side objects last sent and
    ``host_versions`` their ``_version`` counters at that moment (the change
    detector, see :func:`leaf_unchanged`).  ``version`` bumps on every
    re-send.
    """

    name: str
    handles: List[int]
    treedef: Any                       # None = single array (not a pytree)
    host_leaves: List[Any]
    specs: List[TensorSpec]
    host_versions: List[Optional[int]] = field(default_factory=list)
    refcount: int = 1
    version: int = 0
    # bytes sent by the enter/refresh that produced the current content —
    # the first elision hit consumes this debit so "bytes elided" reports
    # net savings vs a per-region baseline
    debit: int = 0
    # per-leaf future of the last command that wrote the device copy; a
    # consumer that matched this entry orders its EXEC after these
    write_futs: List[Any] = field(default_factory=list)
    # the device copy has advanced past host_leaves (a ``device_out`` map
    # wrote it on-device and nothing fetched it yet)
    device_ahead: bool = False
    # capacity eviction spilled the device copy: ``handles`` are empty, the
    # authoritative value lives on the host (device-ahead entries are
    # reconciled to the host before their buffers are freed), and the next
    # present binding refetches transparently
    spilled: bool = False
    # what a refetch sends while spilled: the reconcile fetch, or a copy of
    # ``host_leaves`` taken at the spill.  ``host_leaves`` stay the caller's
    # objects for the identity test; being mutable, they may change in
    # place after the spill, and a refetch must restore the device copy as
    # it was, as it would be had the entry stayed resident
    spill_leaves: Optional[List[Any]] = None
    # LRU clock stamp (PresentTable._clock at last touch)
    last_used: int = 0
    # pinned entries are never eviction candidates, whatever their refcount
    pinned: bool = False

    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.specs)

    def peer_clone(self, handles: List[int], write_futs: List[Any]) -> "PresentEntry":
        """A copy of this entry fulfilled on *another* device, device→device.

        The clone keeps this entry's logical identity (name, structure, host
        view and its version counters) but binds the peer's mediary
        ``handles``, with ``write_futs`` the RECV futures filling them.  A
        *device-ahead* entry propagates device-ahead: the peer's copy is as
        far past the host as the source's, and no host reconciliation
        happens on the way.
        """
        return PresentEntry(
            name=self.name, handles=list(handles), treedef=self.treedef,
            host_leaves=list(self.host_leaves), specs=list(self.specs),
            host_versions=list(self.host_versions), refcount=1,
            version=self.version, debit=0, write_futs=list(write_futs),
            device_ahead=self.device_ahead)


class PresentTable:
    """Reference-counted name → device-buffer map (OpenMP's present table).

    A map clause whose variable is *present* with an unchanged host value
    skips allocation and transfer and only adjusts the reference count.
    Synchronization is the owner's job (the pool holds one data-environment
    lock per device).

    ``capacity_bytes`` (None = unbounded) caps the *resident* device memory
    this table may hold.  The table itself never moves bytes: the
    :class:`~repro_torch.core.target.TargetExecutor` evicts through
    :meth:`lru_victim` — the least-recently-used entry that is neither
    pinned nor retained by an in-flight region (refcount > 1) is *spilled*
    (device buffers freed, logical entry kept) and refetched on its next
    binding.
    """

    def __init__(self, capacity_bytes: Optional[int] = None) -> None:
        self._entries: Dict[str, PresentEntry] = {}
        self.capacity_bytes = capacity_bytes
        self.hits = 0
        self.misses = 0
        self.bytes_elided = 0
        self.evictions = 0
        self.refetches = 0
        self.bytes_reconciled = 0     # device-ahead content fetched at spill
        self.bytes_refetched = 0      # spilled content re-sent at next bind
        self._clock = 0               # LRU stamp source

    def get(self, name: str) -> Optional[PresentEntry]:
        return self._entries.get(name)

    def add(self, entry: PresentEntry) -> None:
        if entry.name in self._entries:
            raise KeyError(f"{entry.name!r} already present")
        self.touch(entry)
        self._entries[entry.name] = entry

    def touch(self, entry_or_name) -> None:
        """Stamp an entry as most-recently-used (LRU bookkeeping)."""
        e = (self._entries.get(entry_or_name)
             if isinstance(entry_or_name, str) else entry_or_name)
        if e is not None:
            self._clock += 1
            e.last_used = self._clock

    def used_bytes(self) -> int:
        """Device bytes held by resident (non-spilled) entries."""
        return sum(e.nbytes() for e in self._entries.values() if not e.spilled)

    def lru_victim(self, protect: Sequence[str] = ()) -> Optional[PresentEntry]:
        """Least-recently-used evictable entry, or None: not pinned, not
        spilled, not in ``protect``, and refcount <= 1 (a higher count means
        an in-flight region retains it)."""
        best: Optional[PresentEntry] = None
        for e in self._entries.values():
            if e.pinned or e.spilled or e.refcount > 1 or e.name in protect:
                continue
            if best is None or e.last_used < best.last_used:
                best = e
        return best

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def names(self) -> List[str]:
        return list(self._entries)

    def match_value(self, name: str, leaves: Sequence[Any],
                    treedef: Any) -> Optional[PresentEntry]:
        """Entry iff ``name`` is present with the *same*, unmodified host
        value (:func:`leaf_unchanged` per leaf).  A hit means zero bytes need
        to move.  Retains the entry (refcount++); pair with :meth:`release`.
        """
        e = self._entries.get(name)
        if (e is None or e.device_ahead or e.spilled
                or not same_treedef(e.treedef, treedef)
                or len(e.host_leaves) != len(leaves)
                or not all(leaf_unchanged(a, v, b) for a, v, b in
                           zip(e.host_leaves, e.host_versions, leaves))):
            self.misses += 1
            return None
        e.refcount += 1
        self.hits += 1
        self.touch(e)
        self.bytes_elided += max(0, e.nbytes() - e.debit)
        e.debit = 0
        return e

    def match_specs(self, name: str, specs: Sequence[TensorSpec],
                    treedef: Any) -> Optional[PresentEntry]:
        """Entry iff ``name`` is present with matching shapes/dtypes (an
        output map reuses the resident buffer).  Retains the entry."""
        e = self._entries.get(name)
        if (e is None or e.spilled or not same_treedef(e.treedef, treedef)
                or len(e.specs) != len(specs)
                or any(a != b for a, b in zip(e.specs, specs))):
            return None
        e.refcount += 1
        self.hits += 1
        self.touch(e)
        return e

    def pop_entry(self, name: str) -> Optional[PresentEntry]:
        """Remove and return an entry without touching refcounts or buffers
        (the caller owns the device buffers): a heal drops an entry whose
        write was lost, an elastic rescale relocates one."""
        return self._entries.pop(name, None)

    def adopt(self, entry: PresentEntry) -> bool:
        """Install a relocated entry; False (no-op) if the name is taken —
        the table keeps its own copy, which was reachable all along."""
        if entry.name in self._entries:
            return False
        self.touch(entry)
        self._entries[entry.name] = entry
        return True

    def release(self, name: str) -> Optional[PresentEntry]:
        """Refcount--; returns the now-dead entry (caller frees) or None."""
        e = self._entries.get(name)
        if e is None:
            return None
        e.refcount -= 1
        if e.refcount <= 0:
            del self._entries[name]
            return e
        return None

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "bytes_elided": self.bytes_elided,
                "resident": len(self._entries),
                "resident_bytes": self.used_bytes(),
                "capacity_bytes": (-1 if self.capacity_bytes is None
                                   else self.capacity_bytes),
                "spilled": sum(1 for e in self._entries.values() if e.spilled),
                "evictions": self.evictions, "refetches": self.refetches,
                "bytes_reconciled": self.bytes_reconciled,
                "bytes_refetched": self.bytes_refetched}


class HostMirror(SlotTableBase):
    """Host-side mirror (paper §4.2 optimization): predicts handles, holds no data.

    ``reserve()`` returns the handle the device *will* use for its next
    alloc; because both sides run first-fit over identical op sequences,
    handles always agree.
    """

    def reserve(self, shape: Sequence[int], dtype: torch.dtype) -> int:
        handle = self._first_free()
        spec = TensorSpec(tuple(shape), dtype)
        self._slots[handle] = MirrorEntry(spec=spec, nbytes=spec.nbytes)
        return handle

    def nbytes(self, handle: int) -> int:
        entry = self._slots[handle]
        if entry is None:
            raise KeyError(f"mirror handle {handle} is not live")
        return entry.nbytes
