"""Unified TaskGraph IR and placement, first cut.

Port of ``repro.core.taskgraph`` to the extent the main path needs it:

* :class:`TaskNode` / :class:`TaskGraph` — the IR.  A node names its kernel,
  its dependency edges (producer task names) and a ``make_maps`` callback
  producing the region's :class:`~.target.MapSpec` from its dependencies'
  values.
* :func:`run_graph` — the one executor every pattern lowers into: waves of
  ready nodes dispatched as ``nowait`` regions, host-mediated edges (the
  paper's funnel) or device→device edges (``peer=True``), and per-wave
  resident pins (``resident=True``).
* :class:`RoundRobin` placement, the reference's default.

Left for later slices, each raising ``NotImplementedError`` naming its
ROADMAP item: the locality/HEFT/SLO policies (item 10), straggler hedging,
checkpoints, failure recovery and lineage replay (item 11).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import _tree
from .device import DeviceFailure
from .mediary import TensorSpec
from .target import (MapSpec, Section, TargetExecutor, TargetFuture, _alias_map,
                     _flatten_map_value)


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PeerRef:
    """A dependency value that lives on a device, not on the host.

    Under ``run_graph(peer=True)`` the ``deps`` handed to a node's
    ``make_maps`` hold these placeholders instead of host tensors: a callback
    that places dependency values in a ``to=`` clause works unchanged, and
    the runner rewrites each such entry into a ``present`` binding.  The
    runner resolves a ref through its live producer map, so ``device`` (where
    the entry lived when the ref was minted) is informational only.
    """

    task: str
    entry: str
    device: Optional[int] = None


@dataclass(frozen=True)
class TaskNode:
    """One node of the IR: kernel + map-building callback + edge names.

    ``deps`` are producer task names; ``reads`` extends them with logical
    buffer names consumed without a producer in the graph; ``writes`` names
    what the node produces (default: its own name).  ``device`` forces
    placement; ``tag`` overrides the region tag.
    """

    name: str
    kernel: str
    deps: Tuple[str, ...] = ()
    make_maps: Callable[[Dict[str, Any]], MapSpec] = None
    device: Optional[int] = None
    tag: Optional[str] = None
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()


class TaskGraph:
    """An ordered collection of :class:`TaskNode`\\ s forming a DAG."""

    def __init__(self, nodes: Iterable[Any] = ()) -> None:
        self._nodes: Dict[str, TaskNode] = {}
        for n in nodes:
            self.add(n)

    @classmethod
    def from_tasks(cls, tasks: Iterable[Any]) -> "TaskGraph":
        """Build from anything node-shaped (``TaskNode``, ``DagTask``, …),
        duck-typed on ``name/kernel/deps/make_maps``."""
        return cls(tasks)

    def add(self, node: Any) -> TaskNode:
        if not isinstance(node, TaskNode):
            node = TaskNode(
                name=node.name, kernel=node.kernel,
                deps=tuple(node.deps), make_maps=node.make_maps,
                device=getattr(node, "device", None),
                tag=getattr(node, "tag", None),
                reads=tuple(getattr(node, "reads", ()) or ()),
                writes=tuple(getattr(node, "writes", ()) or ()))
        if node.name in self._nodes:
            raise ValueError(f"duplicate task {node.name!r}")
        if not node.reads:
            node = TaskNode(**{**node.__dict__, "reads": node.deps})
        if not node.writes:
            node = TaskNode(**{**node.__dict__, "writes": (node.name,)})
        self._nodes[node.name] = node
        return node

    def node(self, name: str) -> TaskNode:
        return self._nodes[name]

    def __len__(self) -> int:
        return len(self._nodes)

    def __iter__(self):
        return iter(self._nodes.values())

    def waves(self) -> List[List[str]]:
        """Topological wave decomposition (raises on cycles/missing deps)."""
        done: set = set()
        remaining = dict(self._nodes)
        out: List[List[str]] = []
        while remaining:
            ready = [n for n in remaining.values()
                     if all(d in done for d in n.deps)]
            if not ready:
                raise ValueError(
                    f"dependency cycle among {sorted(remaining)}")
            out.append([n.name for n in ready])
            for n in ready:
                done.add(n.name)
                del remaining[n.name]
        return out


# ---------------------------------------------------------------------------
# Placement policies
# ---------------------------------------------------------------------------
@dataclass
class PlacementContext:
    """What a policy may look at when placing a node.

    ``home`` maps every already-placed task to its device, ``out_bytes`` to
    its output size; ``load`` counts this wave's placements per device;
    ``healthy`` lists the placeable devices (None: all of them).
    """

    pool: Any
    cost: Any
    D: int
    transport: Any = None
    home: Dict[str, int] = field(default_factory=dict)
    out_bytes: Dict[str, int] = field(default_factory=dict)
    load: Dict[int, int] = field(default_factory=dict)
    wave: int = 0
    healthy: Optional[List[int]] = None

    def candidates(self) -> List[int]:
        """The devices a policy may place onto, always non-empty."""
        if self.healthy:
            cands = [d for d in self.healthy if d < self.D]
            if cands:
                return cands
        return list(range(self.D))


class PlacementPolicy:
    """Where does a ready node run, and over which wire do its edges ride."""

    name = "abstract"

    def begin(self, ctx: PlacementContext) -> None:
        """Reset per-run state (policies may be reused across runs)."""

    def place(self, ctx: PlacementContext, node: TaskNode,
              ready_index: int, region_tag: str) -> int:
        raise NotImplementedError

    def route_edge(self, ctx: PlacementContext, src: int, dst: int,
                   nbytes: int) -> str:
        """Which wire carries one cross-device dependency edge: ``"peer"``
        (a raw peer message), ``"peer+int8"`` (a peer message under the
        modeled block-int8 wire, where the transport's topology says the
        byte savings beat the quantize cost) or ``"funnel"`` (fetch and
        re-send on the host NIC).  The base policy defers to the transport's
        :meth:`~.transport.Transport.edge_route`; without a topology that is
        always ``"peer"``."""
        if ctx.transport is not None:
            return ctx.transport.edge_route(ctx.cost, src, dst, nbytes)[1]
        return "peer"


class RoundRobin(PlacementPolicy):
    """Arrival order modulo device count — the historical static placement."""

    name = "round-robin"

    def place(self, ctx: PlacementContext, node: TaskNode,
              ready_index: int, region_tag: str) -> int:
        cands = ctx.candidates()
        if node.device is not None:
            # a forced device is honored while healthy
            if ctx.healthy is None or node.device in cands:
                return node.device
        return cands[ready_index % len(cands)]


#: Policies of the reference that later slices port (ROADMAP item 10).
_UNPORTED_POLICIES = ("locality", "heft", "slo")


def resolve_policy(policy: Any) -> PlacementPolicy:
    """None | name | class | instance → a ready :class:`PlacementPolicy`."""
    if policy is None or policy == "round-robin":
        return RoundRobin()
    if isinstance(policy, str):
        if policy in _UNPORTED_POLICIES:
            raise NotImplementedError(
                f"placement policy {policy!r} is not ported yet: ROADMAP item 10")
        raise ValueError(f"unknown placement policy {policy!r}; "
                         f"one of {sorted(('round-robin',) + _UNPORTED_POLICIES)}")
    if isinstance(policy, type) and issubclass(policy, PlacementPolicy):
        return policy()
    if isinstance(policy, PlacementPolicy):
        return policy
    raise TypeError(f"not a placement policy: {policy!r}")


def _value_nbytes(val: Any) -> int:
    """Bytes of a value / TensorSpec template / pytree of either."""
    total = 0
    for l in _tree.leaves(val):
        if isinstance(l, TensorSpec):
            total += l.nbytes
        else:
            total += math.prod(getattr(l, "shape", ())) * l.dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# The executor every pattern lowers into
# ---------------------------------------------------------------------------
def run_graph(ex: TargetExecutor, graph: TaskGraph, *,
              policy: Any = None, out_name: str = "out",
              nowait: bool = True, resident: bool = False,
              peer: bool = False, transport: Optional[Any] = None,
              tag: str = "graph", stragglers: Optional[Any] = None,
              checkpoint: Optional[Any] = None,
              resume_from: Optional[str] = None) -> Dict[str, Any]:
    """Run a :class:`TaskGraph`: waves of ready nodes, policy-placed.

    * nodes whose dependencies are satisfied dispatch as concurrent
      ``nowait`` regions (serially with ``nowait=False``), one wave at a
      time; host-mediated edges fetch the producer's value and re-send it
      with the consumer's map (the paper's funnel);
    * ``resident=True`` pins a wave's *shared* plain ``to`` inputs once per
      device per wave (present-table elision for fan-outs);
    * ``peer=True`` keeps every node's ``out_name`` output resident on its
      device (``device_out``), hands consumers :class:`PeerRef`
      placeholders, and moves each cross-device edge once, over the wire
      the policy routes it to — device→device via
      :meth:`TargetExecutor.propagate_resident`, or through the host funnel
      where the policy prices that cheaper.  Without a ``transport`` the
      default :class:`~.transport.PeerTransport` inherits the pool's
      topology.  At the end every output is fetched once (the bytes the
      host-mediated run's ``from_`` maps moved) and every pinned entry is
      released.

    ``policy`` (default :class:`RoundRobin`) decides device placement per
    ready node; placement affects traffic, never values.  Returns
    ``{task: host value}`` for every node.  A region that fails with
    :class:`~.device.DeviceFailure` is not recovered in this port yet.
    """
    if stragglers is not None:
        raise NotImplementedError("run_graph(stragglers=...): ROADMAP item 11")
    if checkpoint is not None or resume_from is not None:
        raise NotImplementedError(
            "run_graph(checkpoint=/resume_from=): ROADMAP item 11")
    policy = resolve_policy(policy)
    pool = ex.pool
    if peer and transport is None:
        from .transport import PeerTransport
        # inherit the pool's topology (ClusterRuntime installs it on the
        # cost model): per-pair edge prices and "peer+int8" routing
        transport = PeerTransport(topology=getattr(pool.cost, "topology", None))
    D = len(pool)
    ctx = PlacementContext(pool=pool, cost=pool.cost, D=D, transport=transport,
                           healthy=pool.health.healthy(D))
    policy.begin(ctx)
    results: Dict[str, Any] = {}
    # peer mode: every (device, entry) this run pinned — producer outputs and
    # their propagated copies — released at the end; ``producer`` maps a
    # task to its output's current (device, entry)
    peer_entries: Dict[Tuple[int, str], bool] = {}
    producer: Dict[str, Tuple[int, str]] = {}
    funnel_cache: Dict[str, Any] = {}   # producer task -> fetched host value

    def _join(futs: List[TargetFuture]) -> List[Dict[str, Any]]:
        try:
            return ex.drain(futs)
        except DeviceFailure as err:
            raise NotImplementedError(
                "recovery from a failed region (re-place, reroute, replay): "
                "ROADMAP item 11") from err

    def _entry_live(dev: int, entry: str) -> bool:
        return 0 <= dev < len(pool) and pool.present[dev].get(entry) is not None

    def _fetch_task(name: str) -> Any:
        dev, entry = producer[name]
        if not _entry_live(dev, entry):
            raise NotImplementedError(
                f"the resident output of {name!r} is gone; rebuilding it "
                f"from lineage is ROADMAP item 11")
        try:
            return ex.fetch_resident(dev, entry)
        except DeviceFailure as err:
            raise NotImplementedError(
                "recovery from a failed fetch: ROADMAP item 11") from err

    def _peer_rewrite(t: TaskNode, dev: int, maps: MapSpec,
                      region_tag: str) -> MapSpec:
        new_to: Dict[str, Any] = {}
        pres: Dict[str, str] = {}
        for k, v in maps.to.items():
            if not isinstance(v, PeerRef):
                new_to[k] = v
                continue
            # placement-independent resolution: the live producer map, not
            # the device the ref was minted with
            src_dev, entry = producer[v.task]
            if not _entry_live(src_dev, entry):
                raise NotImplementedError(
                    f"the resident output of {v.task!r} is gone; rebuilding "
                    f"it from lineage is ROADMAP item 11")
            if src_dev == dev or ((dev, entry) in peer_entries
                                  and _entry_live(dev, entry)):
                pres[k] = entry
                continue
            route = policy.route_edge(ctx, src_dev, dev,
                                      ctx.out_bytes.get(v.task, 0))
            if route == "funnel":
                # the policy priced the funnel cheaper for this edge: ONE
                # fetch per producer (outputs are write-once), re-sent per
                # consumer, like the faithful pattern
                if v.task not in funnel_cache:
                    funnel_cache[v.task] = _fetch_task(v.task)
                new_to[k] = funnel_cache[v.task]
                continue
            # per-region edge tag; "peer+int8" accounts the compressed wire
            # (the payload moves intact, so results stay bit-identical)
            ex.propagate_resident(src_dev, dev, entry, transport=transport,
                                  tag=f"{region_tag}:edge",
                                  compress_wire=(route == "peer+int8"))
            peer_entries[(dev, entry)] = True
            pres[k] = entry
        for k, v in {**maps.tofrom, **maps.alloc, **maps.from_}.items():
            if isinstance(v, PeerRef):
                raise TypeError(
                    f"task {t.name!r}: a PeerRef dependency may only appear "
                    f"in a to= clause (got it in {k!r})")
        if out_name not in maps.from_:
            raise ValueError(
                f"peer graph requires task {t.name!r} to declare "
                f"from_[{out_name!r}] (its resident output shape)")
        entry = f"{tag}:{t.name}"
        if not _entry_live(dev, entry):
            ex.alloc_resident(dev, entry, maps.from_[out_name], tag=f"{tag}:out")
        peer_entries[(dev, entry)] = True
        producer[t.name] = (dev, entry)
        ctx.out_bytes[t.name] = _value_nbytes(maps.from_[out_name])
        return MapSpec(to=new_to,
                       from_={n: v for n, v in maps.from_.items() if n != out_name},
                       tofrom=maps.tofrom, alloc=maps.alloc,
                       firstprivate=maps.firstprivate,
                       use_globals=maps.use_globals,
                       present={**_alias_map(maps.present), **pres},
                       device_out={**_alias_map(maps.device_out),
                                   out_name: entry})

    def _done(t: TaskNode, out: Dict[str, Any]) -> None:
        if peer:
            dev, entry = producer[t.name]
            results[t.name] = PeerRef(t.name, entry, dev)
        else:
            results[t.name] = out[out_name]
            ctx.out_bytes[t.name] = _value_nbytes(results[t.name])

    def _release_peer_entries() -> None:
        for dev, n in peer_entries:
            if dev < len(pool):
                ex.exit_data(dev, n)

    # the topological decomposition is the graph's own; cycles and missing
    # deps surface here, before anything is dispatched
    for wave_idx, wave in enumerate(graph.waves()):
        ready = [graph.node(n) for n in wave]
        ctx.wave = wave_idx
        pool.health.tick_wave()
        ctx.D = D = len(pool)
        ctx.healthy = pool.health.healthy(D)
        ctx.load = {d: 0 for d in range(D)}
        entered: List[Tuple[int, str]] = []
        futs: List[TargetFuture] = []
        joined = False
        try:
            plans: List[Dict[str, Any]] = []
            for j, t in enumerate(ready):
                region_tag = t.tag or f"{tag}:w{wave_idx}:{t.name}"
                dev = policy.place(ctx, t, j, region_tag)
                if not (0 <= dev < D):
                    raise ValueError(
                        f"policy {policy.name!r} placed {t.name!r} on "
                        f"device {dev} of {D}")
                ctx.load[dev] = ctx.load.get(dev, 0) + 1
                ctx.home[t.name] = dev
                maps = t.make_maps({d: results[d] for d in t.deps})
                if peer:
                    maps = _peer_rewrite(t, dev, maps, region_tag)
                plans.append({"t": t, "dev": dev, "tag": region_tag,
                              "maps": maps})
            if resident:
                # pin only values genuinely shared: a (device, name) whose
                # plain ``to`` value is the same object across >=2 of the
                # wave's tasks (a per-task value would gain nothing, and its
                # refresh could race a sibling region out of its elision)
                usage: Dict[Tuple[int, str], List[Tuple[Tuple[int, ...], Any]]] = {}
                for p in plans:
                    dev, maps = p["dev"], p["maps"]
                    for n, v in maps.to.items():
                        leaves, _ = _flatten_map_value(v)
                        if any(isinstance(l, Section) for l in leaves):
                            continue   # sections differ per task: not pinnable
                        usage.setdefault((dev, n), []).append(
                            (tuple(id(l) for l in leaves), v))
                for (dev, n), uses in usage.items():
                    if len(uses) < 2 or len({k for k, _ in uses}) != 1:
                        continue       # unique or conflicting values: no pin
                    try:
                        ex.enter_data(dev, f"{tag}:w{wave_idx}", **{n: uses[0][1]})
                        entered.append((dev, n))
                    except ValueError:
                        pass           # shape changed under this name: skip pin
            for p in plans:
                t = p["t"]
                if nowait:
                    futs.append(ex.target(t.kernel, p["dev"], p["maps"],
                                          nowait=True, tag=p["tag"]))
                else:
                    _done(t, ex.target(t.kernel, p["dev"], p["maps"],
                                       nowait=False, tag=p["tag"]))
            if futs:
                joined = True
                for p, out in zip(plans, _join(futs)):
                    _done(p["t"], out)
        except BaseException:
            if peer:
                # failed run: nothing will fetch the resident outputs.  Safe
                # before the finally below joins a mid-dispatch wave: a
                # region holds its own references to the entries it binds
                _release_peer_entries()
            raise
        finally:
            if futs and not joined:
                # a mid-dispatch failure: the already-launched regions must
                # still be joined before their pins are released
                try:
                    ex.drain(futs)
                except BaseException:
                    pass               # the dispatch error propagates
            for dev, n in entered:      # wave boundary: release pins
                ex.exit_data(dev, n)
    if peer:
        # the host view: one fetch per task output, the bytes the
        # host-mediated run's from_ maps moved; then release every entry
        try:
            for name in list(producer):
                results[name] = _fetch_task(name)
        finally:
            _release_peer_entries()
    return results
