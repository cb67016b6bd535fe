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
* Placement policies: :class:`RoundRobin` (the reference's default),
  :class:`LocalityAffinity`, :class:`HeftPlacement` (earliest finish time
  under the cost model, pricing each edge on the cheaper of the host funnel
  and the peer fabric) and :class:`SloPlacement` (tail-first, with backlogs
  that persist across graphs and drain in wall-clock time).

* Recovery: a region that fails with a
  :class:`~.device.DeviceFailure` is re-placed, rerouted through the funnel
  or retried in place, and a lost resident output is replayed from its
  producer (its lineage); the result is bit-identical to the fault-free run.
* Hedging: with a straggler detector, a region that runs past its kernel's
  threshold races a duplicate on another device; the first copy to land
  wins and the loser's cost records are struck.
* Resumable runs: a :class:`GraphCheckpoint` saves the completed frontier at
  wave boundaries in the reference's checkpoint format, and
  ``run_graph(resume_from=...)`` skips what it holds, in this process or a
  fresh one.
"""
from __future__ import annotations

import concurrent.futures as _cf
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import _tree
from .device import DeviceFailure
from .mediary import TensorSpec
from .target import (MapSpec, Section, TargetExecutor, TargetFuture, _alias_map,
                     _flatten_map_value)
from .transport import HostFunnelTransport


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
    ``replicas`` maps a task to every device holding a live copy of its
    output (the home plus each peer-propagated copy: a repeat edge is
    free); ``healthy`` lists the placeable devices (None: all of them);
    ``topology`` is the transport's, when it has one.
    """

    pool: Any
    cost: Any
    D: int
    peer: bool = False
    transport: Any = None
    home: Dict[str, int] = field(default_factory=dict)
    out_bytes: Dict[str, int] = field(default_factory=dict)
    load: Dict[int, int] = field(default_factory=dict)
    replicas: Dict[str, set] = field(default_factory=dict)
    wave: int = 0
    healthy: Optional[List[int]] = None
    topology: Any = None

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


class LocalityAffinity(PlacementPolicy):
    """Prefer the device that already holds the node's inputs.

    Scores each device by the bytes of the node's ``reads`` homed there —
    producer outputs through the runner's replica map, producer-less names
    through the device present tables — and breaks ties by this wave's
    queue depth, then lowest index.  With no locality signal it is
    :class:`RoundRobin`.
    """

    name = "locality"

    def place(self, ctx: PlacementContext, node: TaskNode,
              ready_index: int, region_tag: str) -> int:
        cands = ctx.candidates()
        if node.device is not None and (ctx.healthy is None
                                        or node.device in cands):
            return node.device
        score = {d: 0 for d in cands}
        for dep in node.reads:
            if dep in ctx.replicas:
                nb = ctx.out_bytes.get(dep, 0) or 1
                for d in ctx.replicas[dep]:   # home + propagated copies
                    if d in score:
                        score[d] += nb
                continue
            src = ctx.home.get(dep)
            if src is not None:
                if src in score:
                    score[src] += ctx.out_bytes.get(dep, 0) or 1
                continue
            for d in cands:
                e = ctx.pool.present[d].get(dep)
                if e is not None and not e.spilled:
                    score[d] += e.nbytes()
        best = max(score.values())
        if best == 0:
            return cands[ready_index % len(cands)]
        tied = [d for d in cands if score[d] == best]
        return min(tied, key=lambda d: (ctx.load.get(d, 0), d))


class HeftPlacement(PlacementPolicy):
    """Earliest-finish-time placement under the recorded cost model.

    Each device carries a modeled ready clock; a node's finish on device
    ``d`` is ``max(ready[d], latest edge arrival) + est``.  ``est`` comes
    from ``estimates``: ``"observed"`` (default) is
    :meth:`CostModel.kernel_time` — the mean of the EXEC seconds recorded so
    far, else ``default_task_s``; ``"calibrated"`` is the seed of the
    profile installed by ``ClusterRuntime.calibrate`` / ``load_calibration``
    (``default_task_s`` for a kernel without one); ``"frozen"``
    is ``default_task_s`` always (``use_observed=False``).  Each
    cross-device edge costs the cheaper of the host funnel and the peer
    fabric — the comparison :meth:`route_edge` answers, so the runner moves
    each edge over the wire the policy priced.  Every decision is logged
    through :meth:`CostModel.record_placement`.
    """

    name = "heft"

    def __init__(self, default_task_s: float = 1e-3,
                 use_observed: bool = True,
                 estimates: Optional[str] = None) -> None:
        self.default_task_s = default_task_s
        self.use_observed = use_observed
        if estimates is None:
            estimates = "observed" if use_observed else "frozen"
        if estimates not in ("observed", "calibrated", "frozen"):
            raise ValueError(f"unknown estimates mode {estimates!r}")
        self.estimates = estimates
        self._ready: Dict[int, float] = {}

    def begin(self, ctx: PlacementContext) -> None:
        self._ready = {d: 0.0 for d in range(ctx.D)}

    def _estimate(self, ctx: PlacementContext, kernel: str) -> float:
        """The compute estimate for one node, per the estimates mode."""
        if self.estimates == "frozen":
            return self.default_task_s
        if self.estimates == "calibrated":
            profile = getattr(ctx.cost, "profile", None)
            seed = profile.kernel_seed(kernel) if profile is not None else None
            return seed if seed is not None else self.default_task_s
        return ctx.cost.kernel_time(kernel, default=self.default_task_s)

    _FUNNEL = HostFunnelTransport()     # prices the fetch + re-send wire

    def _edge(self, ctx: PlacementContext, src: int, dst: int,
              nbytes: int) -> Tuple[float, str]:
        # the funnel price is the transport layer's own model; edge_route
        # folds in the per-pair topology price and the int8-wire decision
        funnel = self._FUNNEL.edge_time(ctx.cost, src, dst, nbytes)
        if ctx.peer and ctx.transport is not None:
            peer_s, wire = ctx.transport.edge_route(ctx.cost, src, dst,
                                                    nbytes)
            if peer_s <= funnel:
                return peer_s, wire
        return funnel, "funnel"

    def route_edge(self, ctx: PlacementContext, src: int, dst: int,
                   nbytes: int) -> str:
        return self._edge(ctx, src, dst, nbytes)[1]

    def _arrival(self, ctx: PlacementContext, node: TaskNode, d: int) -> float:
        """When the last of ``node``'s inputs can be on device ``d``."""
        arrive = 0.0
        for dep in node.deps:
            src = ctx.home.get(dep)
            if src is None or src == d or d in ctx.replicas.get(dep, ()):
                continue   # already local (home or replica): free edge
            s, _ = self._edge(ctx, src, d, ctx.out_bytes.get(dep, 0))
            arrive = max(arrive, s)
        return arrive

    def _candidates(self, ctx: PlacementContext, node: TaskNode) -> List[int]:
        cands = ctx.candidates()
        if node.device is not None and (ctx.healthy is None
                                        or node.device in cands):
            return [node.device]
        return cands

    def place(self, ctx: PlacementContext, node: TaskNode,
              ready_index: int, region_tag: str) -> int:
        est = self._estimate(ctx, node.kernel)
        best, best_t = None, None
        for d in self._candidates(ctx, node):
            t = max(self._ready.get(d, 0.0), self._arrival(ctx, node, d)) + est
            if best_t is None or t < best_t:
                best, best_t = d, t
        self._ready[best] = best_t
        ctx.cost.record_placement(region_tag, best, best_t, policy=self.name)
        return best


class SloPlacement(HeftPlacement):
    """Tail-latency-aware EFT placement for serving (p99, not makespan).

    Unlike :class:`HeftPlacement`, the per-device backlog (estimated seconds
    of queued work) persists across graphs and :meth:`begin` drains it by
    the wall-clock time elapsed since the previous graph.  A candidate's
    cost is the fleet tail the placement would produce,
    ``max(tail, finish_d)``; ties break by earliest finish, then by present
    table fullness (a full table spills on the next admission), then index.
    A caller may adjust the backlog between ``place`` calls with
    :meth:`charge` / :meth:`release`.  Edge pricing and routing are HEFT's.
    """

    name = "slo"

    def __init__(self, default_task_s: float = 1e-3,
                 use_observed: bool = True,
                 estimates: Optional[str] = None) -> None:
        super().__init__(default_task_s, use_observed, estimates)
        self._backlog: Dict[int, float] = {}
        self._drained_at: Optional[float] = None

    def begin(self, ctx: PlacementContext) -> None:
        for d in range(ctx.D):
            self._backlog.setdefault(d, 0.0)
        now = time.monotonic()
        if self._drained_at is not None:
            dt = now - self._drained_at
            for d in self._backlog:
                self._backlog[d] = max(0.0, self._backlog[d] - dt)
        self._drained_at = now

    def charge(self, device: int, seconds: float) -> None:
        """Pre-charge known future work (e.g. a sequence's token budget)."""
        self._backlog[device] = self._backlog.get(device, 0.0) + seconds

    def release(self, device: int, seconds: float) -> None:
        """Return charged-but-unspent work (retirement, shed, migration)."""
        self._backlog[device] = max(0.0,
                                    self._backlog.get(device, 0.0) - seconds)

    def backlog(self, device: int) -> float:
        return self._backlog.get(device, 0.0)

    def _pressure(self, ctx: PlacementContext, d: int) -> float:
        """Resident bytes / capacity of device ``d``'s present table (0 when
        uncapped)."""
        try:
            table = ctx.pool.present[d]
        except (AttributeError, IndexError):
            return 0.0
        cap = getattr(table, "capacity_bytes", None)
        if not cap:
            return 0.0
        return table.used_bytes() / cap

    def place(self, ctx: PlacementContext, node: TaskNode,
              ready_index: int, region_tag: str) -> int:
        est = self._estimate(ctx, node.kernel)
        cands = self._candidates(ctx, node)
        for d in cands:
            self._backlog.setdefault(d, 0.0)
        tail = max((self._backlog[d] for d in cands), default=0.0)
        best, best_key, best_finish = None, None, None
        for d in cands:
            finish = max(self._backlog[d], self._arrival(ctx, node, d)) + est
            key = (max(tail, finish), finish, self._pressure(ctx, d), d)
            if best_key is None or key < best_key:
                best, best_key, best_finish = d, key, finish
        self._backlog[best] = best_finish
        ctx.cost.record_placement(region_tag, best, best_finish,
                                  policy=self.name)
        return best


_POLICIES = {"round-robin": RoundRobin, "locality": LocalityAffinity,
             "heft": HeftPlacement, "slo": SloPlacement}


def resolve_policy(policy: Any) -> PlacementPolicy:
    """None | name | class | instance → a ready :class:`PlacementPolicy`."""
    if policy is None:
        return RoundRobin()
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise ValueError(f"unknown placement policy {policy!r}; "
                             f"one of {sorted(_POLICIES)}") from None
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
# Resumable runs: the frontier checkpoint
# ---------------------------------------------------------------------------
@dataclass
class GraphCheckpoint:
    """Periodic frontier checkpoint making a :func:`run_graph` resumable.

    Every ``every_waves`` wave boundaries (and at the final wave) the
    completed-node frontier — each finished task's host output value (in
    peer mode fetched from its device once and cached across saves) and the
    completion order — is written with
    :func:`repro_torch.checkpoint.save_pytree` under ``directory`` as
    ``step_<wave+1>``.  ``keep`` bounds retention (older steps are deleted;
    None keeps all).  A coordinator that died restarts with
    ``run_graph(resume_from=directory)``: completed nodes are skipped, their
    values seeded from the snapshot and, in peer mode, entered again on
    policy-placed devices, so the remaining waves run as they would have.

    ``halt_after=k`` raises :class:`GraphInterrupted` after the ``k``-th
    save: a coordinator killed at a wave boundary, on purpose (pinned peer
    entries are released first, as on any abort).

    Task outputs must be tensors or dicts of tensors, and task names must
    not contain ``/``.  ``saves``, ``save_s`` and ``bytes_written`` count
    the saves of every run that used this object: how many, their host
    seconds (fetches included) and the bytes of the snapshots written.
    """

    directory: str
    every_waves: int = 1
    keep: Optional[int] = 2
    halt_after: Optional[int] = None
    saves: int = field(default=0, init=False, compare=False)
    save_s: float = field(default=0.0, init=False, compare=False)
    bytes_written: int = field(default=0, init=False, compare=False)


class GraphInterrupted(RuntimeError):
    """A :class:`GraphCheckpoint` ``halt_after`` fired: the run stopped on
    purpose after saving; resume with ``run_graph(resume_from=...)``."""


def load_graph_checkpoint(directory: str, *, step: Optional[int] = None
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a :class:`GraphCheckpoint` snapshot: ``(values, extra)``.

    ``values`` maps each completed task to its output as CPU tensors, the
    host values of a graph in this package; ``extra`` carries the
    completion order (``"completed"``), the wave index and the graph tag.
    The restore template is rebuilt from the manifest, so no live tree is
    needed: the fresh-process resume.
    """
    from ..checkpoint.manager import (latest_step, read_manifest,
                                      restore_pytree, torch_dtype)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no graph checkpoint steps under {directory!r}")
    manifest = read_manifest(directory, step)
    template: Dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        parts = key.split("/")
        node = template
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = TensorSpec(tuple(meta["shape"]), torch_dtype(meta["dtype"]))
    tree, _, extra = restore_pytree(directory, step=step, template=template,
                                    device="cpu")
    return tree, dict(extra or {})


# ---------------------------------------------------------------------------
# The executor every pattern lowers into
# ---------------------------------------------------------------------------
def run_graph(ex: TargetExecutor, graph: TaskGraph, *,
              policy: Any = None, out_name: str = "out",
              nowait: bool = True, resident: bool = False,
              peer: bool = False, transport: Optional[Any] = None,
              tag: str = "graph", max_retries: int = 8,
              stragglers: Optional[Any] = None,
              checkpoint: Optional[GraphCheckpoint] = None,
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

    **Recovery.**  A region that fails with a
    :class:`~.device.DeviceFailure` (or binds an entry another region's heal
    just dropped, a ``KeyError``) is recovered, up to ``max_retries``
    attempts per node — failed recovery steps count too:

    * a failed **EXEC** marks its device in the pool's health registry and
      the active policy re-places the node over the surviving candidates;
      in peer mode its output entry moves with it;
    * a failed **SEND/RECV** reroutes the node's incoming peer edges through
      the host funnel, on the same device;
    * a failed **XFER** retries in place: resident inputs heal at the next
      binding (:meth:`TargetExecutor._heal_locked`);
    * a producer whose resident output is gone or unreadable is **replayed**
      from its recorded dependencies (lineage) and the live producer map
      re-pointed at the new copy.

    Every retry re-runs the same kernel on the same declared operands, on a
    device of the same card, so a recovered run is bit-identical to the
    fault-free one.  Any other exception re-raises at once.  ``policy``
    (default :class:`RoundRobin`) places each ready node; placement affects
    traffic, never values.  Returns ``{task: host value}``.

    **Hedging** (``stragglers=``, duck-typed on
    :class:`repro_torch.ft.StragglerDetector`): the join polls the wave's
    regions every ``poll_s``, and a region whose time since dispatch passes
    its kernel's threshold gets one duplicate on another healthy candidate
    (least loaded, lowest index), tagged ``<tag>~hedge<n>``.  The first copy
    to land wins, the primary on a tie; a failed primary with a live hedge
    waits for the hedge, and only when both fail does recovery re-dispatch.
    Once both copies have settled, the loser's cost records are struck
    (``discard_tag``) and a winning hedge's renamed onto the primary's tag,
    so each task is modeled once, and the values are bit-identical.  In
    peer mode a hedge binds its inputs where the live producer map says
    they are: an input resident only on the stalled device is sent from
    there by a SEND that queues behind the stalled command on that device's
    one worker, so such a hedge starts only once the stall is over: it can
    still beat its primary's own return, but it cannot save the stall.  ``stragglers=None`` keeps the blocking join: no hedge, no poll.

    **Membership**: the pool's size and health are read again at every wave
    boundary, so a device that ``rescale_pool`` added mid-graph takes work
    from the next wave on, and a removed one leaves the candidate set.

    **Resumable runs** (``checkpoint=`` / ``resume_from=``): see
    :class:`GraphCheckpoint`.  A resumed run must pass the same graph,
    ``tag`` and ``out_name`` as the checkpointed one; a checkpointed task
    the graph lacks raises ``ValueError``.
    """
    policy = resolve_policy(policy)
    pool = ex.pool
    if peer and transport is None:
        from .transport import PeerTransport
        # inherit the pool's topology (ClusterRuntime installs it on the
        # cost model): per-pair edge prices and "peer+int8" routing
        transport = PeerTransport(topology=getattr(pool.cost, "topology", None))
    D = len(pool)
    ctx = PlacementContext(pool=pool, cost=pool.cost, D=D, peer=peer,
                           transport=transport,
                           healthy=pool.health.healthy(D),
                           topology=getattr(transport, "topology", None))
    policy.begin(ctx)
    results: Dict[str, Any] = {}
    # peer mode: every (device, entry) this run pinned — producer outputs and
    # their propagated copies — released at the end; ``producer`` maps a
    # task to its output's current (device, entry), ``entry_owner`` is its
    # inverse: the lineage index recovery replays from
    peer_entries: Dict[Tuple[int, str], bool] = {}
    producer: Dict[str, Tuple[int, str]] = {}
    entry_owner: Dict[str, str] = {}
    funnel_cache: Dict[str, Any] = {}   # producer task -> fetched host value

    def _refresh_membership() -> None:
        ctx.D = len(pool)
        ctx.healthy = pool.health.healthy(ctx.D)

    def _absorb() -> None:
        pool.absorb_failures()

    def _entry_live(dev: int, entry: str) -> bool:
        return 0 <= dev < len(pool) and pool.present[dev].get(entry) is not None

    def _replay_producer(name: str) -> None:
        """Lineage replay: re-derive a lost resident output by re-running its
        producer synchronously from its settled dependency values, on a
        device the policy picks, and re-point the producer map.  Recursion
        through :func:`_peer_rewrite` covers multi-level loss."""
        t = graph.node(name)
        old = producer.get(name)
        if old is not None and old in peer_entries and _entry_live(*old):
            ex.exit_data(old[0], old[1])   # drop the dead copy's pin
        if old is not None:
            peer_entries.pop(old, None)
        ctx.replicas.pop(name, None)
        _refresh_membership()
        rtag = t.tag or f"{tag}:replay:{name}"
        dev = policy.place(ctx, t, 0, rtag)
        ctx.home[name] = dev
        ctx.replicas.setdefault(name, set()).add(dev)
        orig_maps = t.make_maps({d: results[d] for d in t.deps})
        maps = _peer_rewrite(t, dev, orig_maps, rtag)
        attempts = 0
        while True:
            try:
                ex.target(t.kernel, dev, maps, nowait=False, tag=rtag)
                return
            except (DeviceFailure, KeyError):
                _absorb()
                attempts += 1
                if attempts > max_retries:
                    raise
                # the failed attempt's heal may have dropped a replica it
                # bound or the output entry itself: bind afresh (the
                # reference retries the stale bindings, which then miss)
                maps = _peer_rewrite(t, dev, orig_maps, rtag)

    def _fetch_task(name: str) -> Any:
        """fetch_resident with bounded retries, then a lineage replay."""
        attempts = 0
        while True:
            dev, entry = producer[name]
            try:
                if not _entry_live(dev, entry):
                    raise KeyError(entry)
                return ex.fetch_resident(dev, entry)
            except (DeviceFailure, KeyError):
                _absorb()
                attempts += 1
                if attempts > max_retries:
                    raise
                # a fetch that keeps failing, or a vanished entry: the device
                # copy is lost, rebuild it from lineage
                _replay_producer(name)

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
                # the producer's copy is lost: rebuild it from lineage
                if v.task in funnel_cache:
                    new_to[k] = funnel_cache[v.task]
                    continue
                _replay_producer(v.task)
                src_dev, entry = producer[v.task]
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
            ctx.replicas.setdefault(v.task, set()).add(dev)
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
        # re-entrant on retry: a node re-placed on a device that already
        # holds the entry reuses it as its output buffer
        if not _entry_live(dev, entry):
            ex.alloc_resident(dev, entry, maps.from_[out_name], tag=f"{tag}:out")
        peer_entries[(dev, entry)] = True
        producer[t.name] = (dev, entry)
        entry_owner[entry] = t.name
        ctx.out_bytes[t.name] = _value_nbytes(maps.from_[out_name])
        return MapSpec(to=new_to,
                       from_={n: v for n, v in maps.from_.items() if n != out_name},
                       tofrom=maps.tofrom, alloc=maps.alloc,
                       firstprivate=maps.firstprivate,
                       use_globals=maps.use_globals,
                       present={**_alias_map(maps.present), **pres},
                       device_out={**_alias_map(maps.device_out),
                                   out_name: entry})

    def _recover(rec: Dict[str, Any], err: BaseException) -> None:
        """Make a failed node's record ready for re-dispatch: an EXEC fault
        re-places it (the device is marked in the health registry), a
        SEND/RECV fault reroutes its peer edges through the funnel on the
        same device, an XFER fault retries in place."""
        t = rec["t"]
        # a KeyError: the region bound a replica another region's heal had
        # just dropped — recovered like an XFER fault (edges rebuilt)
        op = getattr(err, "op", "XFER_TO")
        if op == "EXEC":
            fdev = err.device if err.device is not None else rec["dev"]
            pool.health.mark_failed(fdev)
            _refresh_membership()
            new_dev = policy.place(ctx, t, rec["index"], rec["tag"])
            if not (0 <= new_dev < ctx.D):
                raise ValueError(
                    f"policy {policy.name!r} re-placed {t.name!r} on "
                    f"device {new_dev} of {ctx.D}")
            ctx.load[new_dev] = ctx.load.get(new_dev, 0) + 1
            ctx.home[t.name] = new_dev
            if peer:
                entry = f"{tag}:{t.name}"
                if new_dev != rec["dev"]:
                    # abandon the unwritten output entry on the failed device
                    if (rec["dev"], entry) in peer_entries:
                        ex.exit_data(rec["dev"], entry)
                        peer_entries.pop((rec["dev"], entry), None)
                    ctx.replicas.setdefault(t.name, set()).discard(rec["dev"])
                ctx.replicas.setdefault(t.name, set()).add(new_dev)
                rec["maps"] = _peer_rewrite(t, new_dev, rec["orig_maps"],
                                            rec["tag"])
            rec["dev"] = new_dev
        elif op in ("SEND", "RECV") and peer:
            # a peer-fabric fault: this node's incoming edges go through the
            # host funnel (route_edge's other wire), same device
            funnel = HostFunnelTransport()
            for entry in _alias_map(rec["maps"].present).values():
                src_task = entry_owner.get(entry)
                if src_task is None:
                    continue               # a user-supplied present binding
                src_dev, src_entry = producer[src_task]
                if not _entry_live(src_dev, src_entry):
                    _replay_producer(src_task)
                    src_dev, src_entry = producer[src_task]
                if src_dev != rec["dev"]:
                    ex.propagate_resident(src_dev, rec["dev"], src_entry,
                                          transport=funnel,
                                          tag=f"{rec['tag']}:edge")
                    peer_entries[(rec["dev"], src_entry)] = True
        elif peer:
            # an XFER fault, or a replica dropped by a heal: healable inputs
            # re-send at the next binding; a dropped edge replica must be
            # propagated again, so rebuild the node's maps
            rec["maps"] = _peer_rewrite(t, rec["dev"], rec["orig_maps"],
                                        rec["tag"])
        # XFER faults outside peer mode: a plain retry (the heal re-sends
        # damaged resident inputs at the next binding)

    def _recover_or_raise(rec: Dict[str, Any], err: BaseException) -> None:
        """Spend attempts until ``_recover`` succeeds; past ``max_retries``
        the last error raises."""
        _absorb()
        while True:
            rec["attempts"] += 1
            if rec["attempts"] > max_retries:
                raise err
            try:
                _recover(rec, err)
                return
            except (DeviceFailure, KeyError) as err2:
                _absorb()
                err = err2

    def _run_recovering(rec: Dict[str, Any]) -> Dict[str, Any]:
        """Synchronous dispatch (``nowait=False``) with the recovery loop."""
        while True:
            try:
                return ex.target(rec["t"].kernel, rec["dev"], rec["maps"],
                                 nowait=False, tag=rec["tag"])
            except (DeviceFailure, KeyError) as err:
                _recover_or_raise(rec, err)

    def _launch_hedge(rec: Dict[str, Any]) -> None:
        """Race a duplicate of a straggling region on another device.

        The ``~`` in ``<tag>~hedge<n>`` is no child separator of
        ``_tag_matches`` (only ``:`` and ``[`` are), so striking the primary
        never strikes the hedge's records, nor the other way round."""
        t = rec["t"]
        cands = [d for d in ctx.candidates() if d != rec["dev"]]
        if not cands:
            return
        hdev = min(cands, key=lambda d: (ctx.load.get(d, 0), d))
        rec["hedge_count"] = rec.get("hedge_count", 0) + 1
        htag = f"{rec['tag']}~hedge{rec['hedge_count']}"
        prev = producer.get(t.name) if peer else None
        elapsed = time.monotonic() - rec["start"]
        entry = f"{tag}:{t.name}"
        try:
            hmaps = (_peer_rewrite(t, hdev, rec["orig_maps"], htag)
                     if peer else rec["orig_maps"])
            hfut = ex.target(t.kernel, hdev, hmaps, nowait=True, tag=htag)
        except (DeviceFailure, KeyError):
            # the hedge could not launch: undo its peer bookkeeping and let
            # the primary race alone
            _absorb()
            if peer:
                if prev is not None:
                    producer[t.name] = prev
                if ((prev is None or prev[0] != hdev)
                        and (hdev, entry) in peer_entries):
                    ex.exit_data(hdev, entry)
                    peer_entries.pop((hdev, entry), None)
            return
        ctx.load[hdev] = ctx.load.get(hdev, 0) + 1
        hrec = stragglers.note_launch(
            task=t.name, kernel=t.kernel, primary_device=rec["dev"],
            hedge_device=hdev, elapsed_s=elapsed,
            threshold_s=stragglers.threshold(t.kernel) or 0.0)
        rec["hedge"] = {"fut": hfut, "tag": htag, "dev": hdev,
                        "prev_producer": prev, "record": hrec}

    def _drop_hedge(rec: Dict[str, Any], outcome: str) -> None:
        """Strike a settled, losing hedge; restore the primary's state."""
        h = rec["hedge"]
        t = rec["t"]
        entry = f"{tag}:{t.name}"
        _absorb()
        pool.cost.discard_tag(h["tag"])
        if peer:
            if h["prev_producer"] is not None:
                producer[t.name] = h["prev_producer"]
            keep_dev = producer.get(t.name, (None,))[0]
            if h["dev"] != keep_dev and (h["dev"], entry) in peer_entries:
                ex.exit_data(h["dev"], entry)
                peer_entries.pop((h["dev"], entry), None)
                ctx.replicas.setdefault(t.name, set()).discard(h["dev"])
        stragglers.note_winner(h["record"], outcome)
        rec["hedge"] = None

    def _promote_hedge(rec: Dict[str, Any]) -> None:
        """The hedge won: strike the primary, canonicalize the hedge."""
        h = rec["hedge"]
        t = rec["t"]
        entry = f"{tag}:{t.name}"
        _absorb()
        # strike the loser first: renaming first would hand the winner's
        # records to the discard
        pool.cost.discard_tag(rec["tag"])
        pool.cost.rename_tag(h["tag"], rec["tag"])
        if peer:
            producer[t.name] = (h["dev"], entry)
            pdev = rec["dev"]
            if pdev != h["dev"] and (pdev, entry) in peer_entries:
                ex.exit_data(pdev, entry)
                peer_entries.pop((pdev, entry), None)
                ctx.replicas.setdefault(t.name, set()).discard(pdev)
            ctx.replicas.setdefault(t.name, set()).add(h["dev"])
            ctx.home[t.name] = h["dev"]
        stragglers.note_winner(h["record"], "hedge")
        rec["hedge"] = None

    def _settle_hedges(records: List[Dict[str, Any]]) -> None:
        """Decide every open race once both copies have settled: a loser's
        cost records land when it completes, so it can be struck only
        then."""
        for rec in records:
            h = rec.get("hedge")
            if h is None:
                continue
            _cf.wait([rec["fut"]._fut, h["fut"]._fut])
            if rec.get("winner") == "hedge":
                _promote_hedge(rec)
            else:
                _drop_hedge(rec, "primary")

    def _maybe_hedge(rec: Dict[str, Any], thresholds: Dict[str, Any]) -> None:
        """Launch a hedge for an in-flight primary past its threshold.  The
        threshold is read once per kernel and poll (``thresholds``): each
        read scans the cost model's records."""
        if rec.get("hedge_count", 0) >= 1:
            return
        kernel = rec["t"].kernel
        if kernel not in thresholds:
            thresholds[kernel] = stragglers.threshold(kernel)
        th = thresholds[kernel]
        elapsed = time.monotonic() - rec["start"]
        if (th is not None and elapsed > th
                and stragglers.should_hedge(kernel, elapsed)):
            _launch_hedge(rec)

    def _join_recovering(records: List[Dict[str, Any]]) -> None:
        """Join a wave's ``nowait`` regions, recovering failed ones.

        Returns only once EVERY region, re-dispatched ones and hedges
        included, has settled, so the pin releases after it never pull a
        buffer from under a running region.  Outcomes land in each record's
        ``out``.  With a straggler detector the wait becomes a poll (see
        :func:`run_graph`).
        """
        all_futs: List[TargetFuture] = [r["fut"] for r in records]
        pending = list(records)
        try:
            while pending:
                waitset = [r["fut"]._fut for r in pending]
                waitset += [r["hedge"]["fut"]._fut for r in pending
                            if r.get("hedge")]
                if stragglers is None:
                    _cf.wait(waitset)
                else:
                    _cf.wait(waitset, timeout=stragglers.poll_s,
                             return_when=_cf.FIRST_COMPLETED)
                thresholds: Dict[str, Any] = {}
                nxt: List[Dict[str, Any]] = []
                for rec in pending:
                    pf = rec["fut"]._fut
                    h = rec.get("hedge")
                    if pf.done() and pf.exception() is None:
                        rec["out"] = pf.result()
                        if h is not None:
                            rec["winner"] = "primary"
                        continue
                    if h is not None and h["fut"]._fut.done():
                        herr = h["fut"]._fut.exception()
                        if herr is None:
                            rec["out"] = h["fut"]._fut.result()
                            rec["winner"] = "hedge"
                            continue
                        if not isinstance(herr, (DeviceFailure, KeyError)):
                            raise herr
                        _drop_hedge(rec, "failed")
                        h = None
                    if pf.done():
                        err = pf.exception()
                        if not isinstance(err, (DeviceFailure, KeyError)):
                            raise err
                        if h is not None:
                            # the hedge still races: let it decide the node
                            # before a recovery attempt is spent
                            nxt.append(rec)
                            continue
                        _recover_or_raise(rec, err)
                        rec["start"] = time.monotonic()
                        rec["fut"] = ex.target(rec["t"].kernel, rec["dev"],
                                               rec["maps"], nowait=True,
                                               tag=rec["tag"])
                        all_futs.append(rec["fut"])
                        nxt.append(rec)
                        continue
                    if stragglers is not None and h is None:
                        _maybe_hedge(rec, thresholds)
                        if rec.get("hedge") is not None:
                            all_futs.append(rec["hedge"]["fut"])
                    nxt.append(rec)
                pending = nxt
            if stragglers is not None:
                _settle_hedges(records)
        finally:
            # the error path too: settle everything still in flight before
            # the caller's teardown releases pins
            live = [f._fut for f in all_futs if not f._fut.done()]
            if live:
                _cf.wait(live)
            ex.retire(all_futs)

    def _done(t: TaskNode, out: Dict[str, Any]) -> None:
        if peer:
            dev, entry = producer[t.name]
            results[t.name] = PeerRef(t.name, entry, dev)
        else:
            results[t.name] = out[out_name]
            ctx.out_bytes[t.name] = _value_nbytes(results[t.name])

    def _release_peer_entries() -> None:
        for dev, n in peer_entries:
            if dev < len(pool):        # a shrink may have removed it
                ex.exit_data(dev, n)

    # -- resumable runs: the frontier snapshot, and the resume ----------------
    completed: set = set()
    host_snap: Dict[str, Any] = {}     # task -> host value, the snapshot cache
    saves = [0]                        # this run's saves

    def _save_checkpoint(wave_idx: int) -> None:
        """Write the completed frontier after ``wave_idx``.  In peer mode
        each output is fetched once (through :func:`_fetch_task`: bounded
        retries, then a lineage replay) and cached across saves, so the
        snapshot needs no live device state to restore."""
        from ..checkpoint.manager import prune_steps, save_pytree
        t0 = time.perf_counter()
        for name in results:
            if name not in host_snap:
                host_snap[name] = _fetch_task(name) if peer else results[name]
        snap = {n: host_snap[n] for n in results}
        save_pytree(checkpoint.directory, wave_idx + 1, snap,
                    extra={"completed": list(results), "wave": wave_idx,
                           "graph_tag": tag, "out_name": out_name})
        prune_steps(checkpoint.directory, checkpoint.keep)
        saves[0] += 1
        checkpoint.saves += 1
        checkpoint.bytes_written += _value_nbytes(snap)
        checkpoint.save_s += time.perf_counter() - t0
        if checkpoint.halt_after is not None and saves[0] >= checkpoint.halt_after:
            raise GraphInterrupted(
                f"run_graph halted on purpose after save {saves[0]} "
                f"(wave {wave_idx}); resume from {checkpoint.directory!r}")

    if resume_from is not None:
        snap, ck_extra = load_graph_checkpoint(resume_from)
        order = [n for n in ck_extra.get("completed", sorted(snap)) if n in snap]
        for idx, name in enumerate(order):
            if name not in graph._nodes:
                raise ValueError(
                    f"checkpointed task {name!r} is not in this graph: a "
                    f"resume needs the graph that was checkpointed")
            value = snap[name]
            completed.add(name)
            host_snap[name] = value
            ctx.out_bytes[name] = _value_nbytes(value)
            if not peer:
                results[name] = value
                continue
            # peer mode: the restored value enters a device data environment
            # on a policy-placed device, so the remaining waves bind it as
            # they would a live producer's output
            t = graph.node(name)
            dev = policy.place(ctx, t, idx, t.tag or f"{tag}:resume:{name}")
            if not (0 <= dev < ctx.D):
                raise ValueError(
                    f"policy {policy.name!r} placed restored {name!r} on "
                    f"device {dev} of {ctx.D}")
            entry = f"{tag}:{name}"
            ex.enter_data(dev, f"{tag}:resume", **{entry: value})
            peer_entries[(dev, entry)] = True
            producer[name] = (dev, entry)
            entry_owner[entry] = name
            ctx.home[name] = dev
            ctx.replicas.setdefault(name, set()).add(dev)
            results[name] = PeerRef(name, entry, dev)

    # the topological decomposition is the graph's own; cycles and missing
    # deps surface here, before anything is dispatched
    waves = graph.waves()
    for wave_idx, wave in enumerate(waves):
        ready = [graph.node(n) for n in wave if n not in completed]
        ctx.wave = wave_idx
        # wave boundary: advance blacklist probation, re-read membership and
        # health, so a device joined mid-graph takes work from this wave on
        # and a removed or blacklisted one leaves the candidate set
        pool.health.tick_wave()
        _refresh_membership()
        D = ctx.D
        ctx.load = {d: 0 for d in range(D)}
        entered: List[Tuple[int, str]] = []
        records: List[Dict[str, Any]] = []
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
                ctx.replicas.setdefault(t.name, set()).add(dev)
                orig_maps = t.make_maps({d: results[d] for d in t.deps})
                maps = (_peer_rewrite(t, dev, orig_maps, region_tag)
                        if peer else orig_maps)
                plans.append({"t": t, "dev": dev, "tag": region_tag,
                              "maps": maps, "orig_maps": orig_maps,
                              "index": j, "attempts": 0, "out": None})
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
                if nowait:
                    p["start"] = time.monotonic()
                    p["fut"] = ex.target(p["t"].kernel, p["dev"], p["maps"],
                                         nowait=True, tag=p["tag"])
                    records.append(p)
                else:
                    _done(p["t"], _run_recovering(p))
            if records:
                # the join waits for EVERY region to settle, past failures
                # and re-dispatches, before the pins below are released
                joined = True
                _join_recovering(records)
                for p in records:
                    _done(p["t"], p["out"])
            if checkpoint is not None and ready and (
                    (wave_idx + 1) % max(1, checkpoint.every_waves) == 0
                    or wave_idx == len(waves) - 1):
                # inside the try: a halt takes the teardown below, which
                # releases the pinned peer entries as any abort does
                _save_checkpoint(wave_idx)
        except BaseException:
            if peer:
                # failed run: nothing will fetch the resident outputs.  Safe
                # before the finally below joins a mid-dispatch wave: a
                # region holds its own references to the entries it binds
                _release_peer_entries()
            raise
        finally:
            if records and not joined:
                # a mid-dispatch failure: the already-launched regions must
                # still be joined before their pins are released
                try:
                    ex.drain([p["fut"] for p in records])
                except BaseException:
                    pass               # the dispatch error propagates
            for dev, n in entered:      # wave boundary: release pins
                if dev < len(pool):
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
