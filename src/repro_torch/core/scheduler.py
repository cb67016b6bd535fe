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

Speculative re-dispatch of straggler strips is ROADMAP item 11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .target import MapSpec, TargetExecutor
from .taskgraph import PeerRef, TaskGraph, TaskNode, run_graph

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


def offload_strips(ex: TargetExecutor, kernel: str, total: int,
                   make_maps: Callable[[int, int], MapSpec], *,
                   combine_axis: int = 0, out_name: str = "out",
                   speculate: bool = False, nowait: bool = True,
                   policy: Any = None, tag: str = "strips") -> torch.Tensor:
    """The alignment/mandelbrot pattern: one nowait region per device strip.

    ``make_maps(start, length)`` builds the MapSpec for a strip (only the
    needed sections move — paper Listing 2).  Lowers into a single-wave
    :class:`TaskGraph`; ``policy`` picks the device per strip (default
    round-robin).  ``nowait=False`` dispatches the strips serially.
    """
    if speculate and nowait:
        raise NotImplementedError(
            "offload_strips(speculate=True): ROADMAP item 11")
    strips = strip_partition(total, len(ex.pool))
    nodes = [TaskNode(name=f"strip{i}", kernel=kernel,
                      make_maps=(lambda s=start, l=length:
                                 lambda deps: make_maps(s, l))(),
                      tag=f"{tag}[{start}:{start+length}]")
             for i, (start, length) in enumerate(strips)]
    res = run_graph(ex, TaskGraph(nodes), policy=policy, out_name=out_name,
                    nowait=nowait, tag=tag)
    return torch.cat([res[n.name] for n in nodes], dim=combine_axis)


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
