"""Task-restructuring patterns from the paper's evaluation (§5).

Port of ``repro.core.scheduler``: thin builders that lower into the
:class:`~.taskgraph.TaskGraph` IR and run through :func:`~.taskgraph.run_graph`.

* **Strip partitioning** (alignment §5.3, mandelbrot §5.4): split an index
  space into per-device strips, offload each as a ``nowait`` target region
  with array sections, stitch the results.
* **Recursive unroll-then-offload** (fib §5.5): the host expands the task
  recursion until the frontier has one task per device, offloads the
  subtrees, and combines.
* **Wavefront with host-mediated dependencies** (sparselu §5.6): a task DAG
  where every inter-device dependency round-trips through the host — or,
  with ``peer=True``, moves device→device over the peer fabric.

Beyond the paper: speculative re-dispatch of straggler strips.
"""
from __future__ import annotations

import concurrent.futures as _cf
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .target import MapSpec, TargetExecutor, TargetFuture
from .taskgraph import (PeerRef, PlacementContext, TaskGraph, TaskNode,
                        resolve_policy, run_graph)

__all__ = ["strip_partition", "offload_strips", "recursive_offload",
           "DagTask", "PeerRef", "wavefront_offload"]


# ---------------------------------------------------------------------------
# Strip partitioning
# ---------------------------------------------------------------------------
def strip_partition(total: int, n_devices: int) -> List[Tuple[int, int]]:
    """Split ``range(total)`` into ≤n_devices contiguous (start, length) strips.

    Remainder elements go to the leading strips, so strip lengths differ by
    at most 1.
    """
    if total <= 0 or n_devices <= 0:
        return []
    n = min(total, n_devices)
    base, rem = divmod(total, n)
    strips, start = [], 0
    for i in range(n):
        length = base + (1 if i < rem else 0)
        strips.append((start, length))
        start += length
    return strips


def _strip_nodes(kernel: str, strips: List[Tuple[int, int]],
                 make_maps: Callable[[int, int], MapSpec],
                 tags: List[str]) -> List[TaskNode]:
    return [TaskNode(name=f"strip{i}", kernel=kernel,
                     make_maps=(lambda s=start, l=length:
                                lambda deps: make_maps(s, l))(),
                     tag=tags[i])
            for i, (start, length) in enumerate(strips)]


def offload_strips(ex: TargetExecutor, kernel: str, total: int,
                   make_maps: Callable[[int, int], MapSpec], *,
                   combine_axis: int = 0, out_name: str = "out",
                   speculate: bool = False, nowait: bool = True,
                   policy: Any = None, tag: str = "strips") -> torch.Tensor:
    """The alignment/mandelbrot pattern: one nowait region per device strip.

    ``make_maps(start, length)`` builds the MapSpec for a strip (only the
    needed sections move — paper Listing 2).  Lowers into a single-wave
    :class:`TaskGraph`; ``policy`` picks the device per strip (default
    round-robin).  ``nowait=False`` dispatches the strips serially and wins
    over ``speculate``: strips that run one at a time have no straggler to
    race.

    ``speculate=True``: once every strip is dispatched, the host waits for
    the first to land and re-dispatches each strip still running onto the
    devices that have finished (round-robin over them); each such strip
    takes whichever copy lands first.  Both copies settle before the loser's
    cost records are struck, and a winning copy's records are renamed onto
    the strip's tag, so the modeled work reads as without speculation.  The
    one pattern that is not wave-synchronous: it shares the graph's
    placement and keeps its own harvest loop.
    """
    strips = strip_partition(total, len(ex.pool))
    orig_tags = [f"{tag}[{start}:{start+length}]" for start, length in strips]
    nodes = _strip_nodes(kernel, strips, make_maps, orig_tags)
    if not speculate or not nowait:
        res = run_graph(ex, TaskGraph(nodes), policy=policy,
                        out_name=out_name, nowait=nowait, tag=tag)
        return torch.cat([res[n.name] for n in nodes], dim=combine_axis)
    pol = resolve_policy(policy)
    D = len(ex.pool)
    ctx = PlacementContext(pool=ex.pool, cost=ex.pool.cost, D=D)
    pol.begin(ctx)
    futs: List[TargetFuture] = []
    devs: List[int] = []
    respawned: Dict[int, TargetFuture] = {}
    try:
        for i, (start, length) in enumerate(strips):
            dev = pol.place(ctx, nodes[i], i, orig_tags[i])
            if not (0 <= dev < D):
                raise ValueError(f"policy {pol.name!r} placed strip {i} on "
                                 f"device {dev} of {D}")
            ctx.load[dev] = ctx.load.get(dev, 0) + 1
            ctx.home[nodes[i].name] = dev
            devs.append(dev)
            futs.append(ex.target(kernel, dev, make_maps(start, length),
                                  nowait=True, tag=orig_tags[i]))
        results = _speculative_harvest(ex, kernel, strips, make_maps, futs,
                                       devs, respawned, orig_tags, tag)
    finally:
        # a failed strip propagates; every dispatched copy is settled before
        # it is unregistered
        dispatched = futs + list(respawned.values())
        _cf.wait([f._fut for f in dispatched])
        ex.retire(dispatched)
    return torch.cat([r[out_name] for r in results], dim=combine_axis)


def _speculative_harvest(ex: TargetExecutor, kernel: str,
                         strips: List[Tuple[int, int]],
                         make_maps: Callable[[int, int], MapSpec],
                         futs: List[TargetFuture], devs: List[int],
                         respawned: Dict[int, TargetFuture],
                         orig_tags: List[str], tag: str
                         ) -> List[Dict[str, torch.Tensor]]:
    results: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(strips)
    pending = set(range(len(strips)))
    # wait for the first strip to land: a harvest that only peeked would
    # find no device finished and respawn nothing
    _cf.wait([f._fut for f in futs], return_when=_cf.FIRST_COMPLETED)
    done_devices: List[int] = []
    for i in sorted(pending):
        if futs[i].done():
            results[i] = futs[i].result()
            pending.discard(i)
            # the device the strip ran on (the reference appends the strip
            # index, which is that device only under round-robin)
            done_devices.append(devs[i])
    spec_tags: Dict[int, str] = {}
    if done_devices:
        for j, i in enumerate(sorted(pending)):
            dev = done_devices[j % len(done_devices)]
            start, length = strips[i]
            spec_tags[i] = f"{tag}:spec[{i}]"
            respawned[i] = ex.target(kernel, dev, make_maps(start, length),
                                     nowait=True, tag=spec_tags[i])
    for i in sorted(pending):
        if i not in respawned:
            results[i] = futs[i].result()
            continue
        # whichever copy lands first; a failed copy surfaces only if the
        # other cannot produce a result either
        pair = (futs[i], respawned[i])
        done, _ = _cf.wait([f._fut for f in pair],
                           return_when=_cf.FIRST_COMPLETED)
        first = pair[0] if pair[0]._fut in done else pair[1]
        other = pair[1] if first is pair[0] else pair[0]
        try:
            results[i] = first.result()
        except Exception:
            results[i] = other.result()   # both failed: this re-raises
    # settle BOTH copies of every duplicated strip before striking the
    # loser: a discard while the loser still runs would miss its late
    # records.  discard_tag strikes every lane carrying the loser's tag —
    # transfers, compute and peer records.
    for i, spec_fut in respawned.items():
        _cf.wait([futs[i]._fut, spec_fut._fut])
        won_spec = (spec_fut._fut.exception() is None
                    and results[i] is spec_fut.result())
        ex.pool.cost.discard_tag(orig_tags[i] if won_spec else spec_tags[i])
        if won_spec:
            # the model reads the same whichever copy won, and consumers
            # (placement_report, discard by region) key on the strip's tag
            ex.pool.cost.rename_tag(spec_tags[i], orig_tags[i])
    return results


# ---------------------------------------------------------------------------
# Recursive unroll-then-offload (fib pattern)
# ---------------------------------------------------------------------------
def recursive_offload(ex: TargetExecutor, kernel: str,
                      root: Any,
                      split: Callable[[Any], Optional[List[Any]]],
                      host_combine: Callable[[Any, List[Any]], Any],
                      make_maps: Callable[[Any], MapSpec], *,
                      out_name: str = "out", nowait: bool = True,
                      policy: Any = None, tag: str = "rec") -> Any:
    """Expand the recursion on the host until ≥1 task per device, then offload.

    ``split(payload)`` returns child payloads (or None at a leaf);
    ``host_combine(payload, child_results)`` folds children back up the tree.
    The frontier lowers into a single-wave :class:`TaskGraph`.
    """
    n_dev = len(ex.pool)

    class _Node:
        __slots__ = ("payload", "children", "result")

        def __init__(self, payload):
            self.payload, self.children, self.result = payload, [], None

    root_node = _Node(root)
    frontier = [root_node]
    while len(frontier) < n_dev:
        node = frontier.pop(0)
        kids = split(node.payload)
        if kids is None:           # leaf reached before enough parallelism
            node.result = None
            frontier.append(node)  # will be offloaded as-is
            if all(split(n.payload) is None for n in frontier):
                break
            continue
        node.children = [_Node(k) for k in kids]
        frontier.extend(node.children)

    gnodes = [TaskNode(name=f"leaf{i}", kernel=kernel,
                       make_maps=(lambda p=node.payload:
                                  lambda deps: make_maps(p))(),
                       tag=f"{tag}[{i}]")
              for i, node in enumerate(frontier)]
    res = run_graph(ex, TaskGraph(gnodes), policy=policy, out_name=out_name,
                    nowait=nowait, tag=tag)
    for i, node in enumerate(frontier):
        node.result = res[f"leaf{i}"]

    def fold(node: _Node) -> Any:
        if not node.children:
            return node.result
        return host_combine(node.payload, [fold(c) for c in node.children])

    return fold(root_node)


# ---------------------------------------------------------------------------
# Wavefront DAG with host-mediated dependencies (sparselu pattern)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DagTask:
    name: str
    kernel: str
    deps: Tuple[str, ...]
    make_maps: Callable[[Dict[str, Any]], MapSpec]   # dep results -> maps
    device: Optional[int] = None                      # None = policy picks


def wavefront_offload(ex: TargetExecutor, tasks: Sequence[DagTask], *,
                      out_name: str = "out", nowait: bool = True,
                      resident: bool = False, peer: bool = False,
                      transport: Optional[Any] = None,
                      policy: Any = None,
                      tag: str = "dag", **graph_kw) -> Dict[str, Any]:
    """Run a dependency DAG, by default with every edge crossing the host
    (the OpenMP rule).

    Lowers the :class:`DagTask` list into a :class:`TaskGraph` and runs it
    through :func:`~.taskgraph.run_graph`: tasks whose dependencies are
    satisfied run as concurrent nowait regions, one wave at a time; each
    inter-device value is fetched to the host and re-sent to the consumer
    (paper §5.6).  ``resident=True`` pins the wave's shared plain inputs once
    per device per wave.  ``peer=True`` keeps each output on its device and
    moves the edges device→device over ``transport`` (default: a
    :class:`~.transport.PeerTransport`).
    """
    graph = TaskGraph.from_tasks(tasks)
    return run_graph(ex, graph, policy=policy, out_name=out_name,
                     nowait=nowait, resident=resident, peer=peer,
                     transport=transport, tag=tag, **graph_kw)
