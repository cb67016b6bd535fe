"""Elastic rescale: go on with a job on another device count (port of
``repro.ft.elastic``'s pool path).

:func:`rescale_pool` resizes ``runtime.pool`` **in place**.  The pool and
the executor keep their identity (present tables, cost accounting, health
registry and in-flight machinery all survive), so a graph already running
against ``runtime.ex`` sees the new membership at its next wave boundary: a
joined device takes work mid-graph, and a departing device's resident state
is *drained*, never dropped:

1. the departing device's stream is synced;
2. every present entry goes through the LRU **spill** path
   (``TargetExecutor._spill_locked``), which fetches device-ahead content to
   the host before freeing the device buffers, so no update is lost;
3. the entry, now held on the host, is **relocated** to the survivor that
   holds the fewest resident bytes (ties to the lowest index), where its next
   binding refetches it;
4. only then is the device's worker stopped and its slot truncated.

A name already resident on the chosen survivor keeps the survivor's copy;
the migrant is reported as dropped and, on the TaskGraph path, is rebuilt
from lineage if it is needed again.

The reference's ``elastic_shardings`` rebuilds JAX mesh shardings and has no
counterpart on one card.
"""
from __future__ import annotations

from typing import Any, Dict


def rescale_pool(runtime, n_virtual: int) -> Dict[str, Any]:
    """Resize ``runtime.pool`` to ``n_virtual`` devices in place.

    Grow appends devices (``DevicePool.add_device``), placeable at once.
    Shrink first joins every in-flight ``nowait`` region (``ex.taskwait()``),
    so no departing stream holds half-issued work, then drains each departing
    device's present table and relocates its entries before
    ``DevicePool.remove_tail``.  Returns::

        {"from": int, "to": int,
         "moved":   [(name, from_dev, to_dev), ...],
         "dropped": [(name, from_dev, to_dev), ...],   # the survivor kept its own
         "reconciled_bytes": int}                      # device-ahead bytes drained
    """
    pool = runtime.pool
    ex = runtime.ex
    n_old = len(pool)
    if n_virtual < 1:
        raise ValueError(f"cannot rescale to {n_virtual} devices")
    report: Dict[str, Any] = {"from": n_old, "to": n_virtual, "moved": [],
                              "dropped": [], "reconciled_bytes": 0}
    if n_virtual > n_old:
        for _ in range(n_virtual - n_old):
            pool.add_device()
        return report
    if n_virtual == n_old:
        return report
    # a region mid-dispatch on a departing device would race the drain (its
    # write-back frees and installs handles the spill is about to free)
    ex.taskwait()
    for d in range(n_virtual, n_old):
        pool.sync(d)
        migrants = []
        with pool.env_locks[d]:
            table = pool.present[d]
            for name in table.names():
                ent = table.get(name)
                if not ent.spilled:
                    before = table.bytes_reconciled
                    ex._spill_locked(d, ent, tag="rescale")
                    report["reconciled_bytes"] += table.bytes_reconciled - before
                table.pop_entry(name)
                migrants.append(ent)
        # relocate outside the departing device's lock (never two env locks
        # at once); a spilled entry is held on the host, so adopting it is
        # bookkeeping only: the survivor's next binding refetches it
        for ent in migrants:
            target = min(range(n_virtual),
                         key=lambda s: (pool.present[s].used_bytes(), s))
            with pool.env_locks[target]:
                adopted = pool.present[target].adopt(ent)
            report["moved" if adopted else "dropped"].append((ent.name, d, target))
        pool.sync(d)                     # the spill's FREEs are in flight
    pool.remove_tail(n_old - n_virtual)
    return report
