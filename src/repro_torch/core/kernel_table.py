"""Kernel table: stable integer identifiers for offloadable kernels.

Paper §4.1: remote processes are replicas of the host executable, so function
*pointers* differ across nodes but registration *order* does not.  Every node
builds a ``kerneltable`` mapping each kernel function to a unique integer, and
the host offloads by sending the integer index.

PyTorch port: registration, lookup and :meth:`KernelTable.fingerprint` are
those of ``repro.core.kernel_table`` (the fingerprint hashes only
``index:name``, so both packages agree on the same registrations).  The
reference's ``lax.switch`` dispatch over a signature class becomes host-side
index dispatch: PyTorch runs eagerly, so the wire index selects the function
directly.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class KernelEntry:
    """One row of the kerneltable (paper: {name, code pointer})."""

    index: int
    name: str
    fn: Callable
    signature: Optional[str] = None  # signature class for switch_dispatch


class KernelTable:
    """Deterministic-order kernel registry (paper §4.1 ``kerneltable``).

    Registration order defines the index; every process must register the
    same kernels in the same order.  ``fingerprint()`` lets a runtime verify
    that property instead of assuming it.
    """

    def __init__(self) -> None:
        self._entries: List[KernelEntry] = []
        self._by_name: Dict[str, KernelEntry] = {}

    # -- registration -----------------------------------------------------
    def register(self, name: str, fn: Callable, *,
                 signature: Optional[str] = None) -> int:
        if name in self._by_name:
            raise ValueError(f"kernel {name!r} already registered")
        entry = KernelEntry(index=len(self._entries), name=name, fn=fn,
                            signature=signature)
        self._entries.append(entry)
        self._by_name[name] = entry
        return entry.index

    def kernel(self, name: Optional[str] = None, *,
               signature: Optional[str] = None):
        """Decorator: ``@table.kernel()`` — the 'outlining' step of paper §4."""

        def deco(fn: Callable) -> Callable:
            self.register(name or fn.__name__, fn, signature=signature)
            return fn

        return deco

    # -- lookup -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def index_of(self, name: str) -> int:
        """Host side of an offload: name → wire index (paper: array index)."""
        return self._by_name[name].index

    def lookup(self, index: int) -> KernelEntry:
        """Device side: wire index → local function pointer."""
        return self._entries[index]

    def names(self) -> List[str]:
        return [e.name for e in self._entries]

    def fingerprint(self) -> str:
        """Digest of (index, name) pairs; all nodes must agree before EXEC."""
        h = hashlib.sha256()
        for e in self._entries:
            h.update(f"{e.index}:{e.name};".encode())
        return h.hexdigest()[:16]

    # -- dispatch over a signature class ------------------------------------
    def switch_dispatch(self, signature: str) -> Callable:
        """``dispatch(kernel_id, *operands)`` over one signature class.

        ``kernel_id`` is the position within the class (``class_index_of``);
        the reference traces this as ``lax.switch``, here the host indexes
        the branch and calls it.
        """
        branches = [e.fn for e in self._entries if e.signature == signature]
        if not branches:
            raise ValueError(f"no kernels with signature {signature!r}")

        def dispatch(kernel_id, *operands):
            return branches[int(kernel_id)](*operands)

        return dispatch

    def class_index_of(self, name: str) -> int:
        """Index of ``name`` within its signature class (for switch_dispatch)."""
        entry = self._by_name[name]
        peers = [e for e in self._entries if e.signature == entry.signature]
        return next(i for i, e in enumerate(peers) if e.name == name)


# The process-global table, mirroring the paper's per-executable kerneltable.
GLOBAL_KERNEL_TABLE = KernelTable()


def kernel(name: Optional[str] = None, *, signature: Optional[str] = None):
    """Module-level decorator registering into the global kerneltable."""
    return GLOBAL_KERNEL_TABLE.kernel(name, signature=signature)
