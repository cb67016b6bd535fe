"""Transport layer: who carries a byte between two devices.

Port of ``repro.core.transport``.  The topology is a swappable object:

* :class:`HostFunnelTransport` — paper-faithful: a device→device copy is a
  fetch to the host plus a re-send, every byte crossing the host NIC twice.
* :class:`PeerTransport` — devices exchange buffers with SEND/RECV commands
  that rendezvous across two device streams (:meth:`DevicePool.peer_copy`);
  bytes are accounted per directed link and timed on per-link lanes.

Collectives are built on the transport from that one primitive, so the same
code runs over either topology and the cost model shows the difference:

* :meth:`Transport.ring_allreduce` — whole-buffer ring: D-1 rounds, each
  device forwards the buffer it received and adds the one arriving into its
  own; per-link traffic ``(D-1)·|buf|``.  Each device adds in ring order,
  so it agrees with the serial sum only to float tolerance.
* :meth:`Transport.gather` / :meth:`Transport.broadcast` (a ring chain).
* :meth:`Transport.allreduce_mean` — gather, reduce at the root in
  ascending device order, divide by D, broadcast: the association of the
  host's ``sum(views) / D``, so direct parameter averaging is bit-identical
  to the funnel path.
* The hierarchical path: with a :class:`~.topology.Topology` of more than
  one rack installed, every collective reduces within each rack onto its
  leader, chains the partial across the leaders in ascending order, and
  broadcasts back — ``O(R)`` spine crossings instead of ``O(D)``, and still
  the serial left-associated ascending sum, bit for bit.

All collectives work on mediary handles already resident on the devices and
compose with the dependency-aware stream: SEND reads, RECV writes, and the
on-device EXECs (add, divide, identity, the block-int8 round trip) return a
new tensor that a writeback installs in the slot.  Nothing here writes a
live slot in place: a SEND hands the slot's tensor itself to its RECV, which
is only safe because slots are replaced, never written through.

``PeerTransport(retries>0)`` makes the fabric fault tolerant: a failed
message is re-sent after a seeded backoff and, once the peer wire has failed
``retries`` times, carried through the host funnel; ``op_timeout_s`` treats
a hung message as such a failure.
"""
from __future__ import annotations

import concurrent.futures as cf
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .compression import int8_wire_nbytes, true_div
from .costmodel import LinkModel

#: Kernels the collectives EXEC on the devices; registered lazily into the
#: pool's own table so every pool agrees on the wire index.
ADD_KERNEL = "__transport_add"
DIV_KERNEL = "__transport_div"
Q8_KERNEL = "__transport_q8"
ID_KERNEL = "__transport_id"


def _q8_roundtrip(a, block=256):
    # what the wire does to a message under block-int8 compression:
    # quantize, (send,) dequantize — one launch of csrc/q8_wire.cu on the
    # card, the plain composition of compress/decompress on the CPU.  The
    # result is a new tensor (the slot is replaced by a writeback)
    from ..kernels.q8_wire.ops import q8_roundtrip
    return q8_roundtrip(a, block)


def _ensure_kernels(pool) -> None:
    table = pool.table
    if ADD_KERNEL not in table:
        table.register(ADD_KERNEL, lambda a, b: a + b)
    if DIV_KERNEL not in table:
        # the IEEE quotient, as the host's ``sum(views) / D`` on the CPU
        # computes it (a Python divisor is a reciprocal multiply on CUDA)
        table.register(DIV_KERNEL, lambda a, s: true_div(a, s))
    if ID_KERNEL not in table:
        # device-local move of a finished scratch accumulator into a live
        # buffer (a stream writer, no wire traffic).  A copy: the scratch
        # slot and the live slot must not share one tensor
        table.register(ID_KERNEL, lambda a: a.clone())
    if Q8_KERNEL not in table:
        table.register(Q8_KERNEL, _q8_roundtrip)


class Transport:
    """How a buffer moves from one device's mediary slot to another's.

    Subclasses implement :meth:`sendrecv`; the collectives below are
    topology-agnostic and inherit whichever fabric the subclass provides.
    """

    kind = "abstract"

    #: Optional :class:`~.topology.Topology`.  When set (and it describes
    #: the pool with more than one rack) the collectives dispatch
    #: hierarchically and :meth:`edge_time`/:meth:`edge_route` price per
    #: device pair instead of uniformly.
    topology = None

    def _hier_ok(self, D: int) -> bool:
        """Whether the hierarchical collective path applies at size ``D``."""
        t = self.topology
        return t is not None and t.n_racks > 1 and t.n_devices == D

    def sendrecv(self, pool, src: int, src_handle: int,
                 dst: int, dst_handle: int, *,
                 nbytes: Optional[int] = None, tag: str = ""):
        """Copy ``(src, src_handle)`` into ``(dst, dst_handle)``; returns the
        future of the destination write (a registered writer of
        ``dst_handle`` in ``dst``'s stream)."""
        raise NotImplementedError

    def edge_time(self, cost, src: int, dst: int, nbytes: int) -> float:
        """Modeled seconds to carry one ``nbytes`` dependency edge src→dst.

        The base transport is the host funnel: a device→device copy is a
        fetch plus a re-send, two messages on the host NIC.
        """
        return cost.link.time(nbytes, 1) * 2

    def edge_route(self, cost, src: int, dst: int,
                   nbytes: int) -> Tuple[float, str]:
        """``(seconds, wire)`` for one dependency edge over this fabric:
        ``"peer"`` for a raw message, ``"peer+int8"`` where a
        topology-aware transport decides the block-int8 wire beats the raw
        bytes on this pair's link.  The base fabric has no per-pair
        knowledge: one raw message at :meth:`edge_time`'s price."""
        return self.edge_time(cost, src, dst, nbytes), "peer"

    # -- collectives -----------------------------------------------------------
    def ring_allreduce(self, pool, handles: Sequence[Sequence[int]],
                       specs: Sequence[Any], *,
                       wire_nbytes: Optional[Sequence[int]] = None,
                       tag: str = "ring") -> List[List[Any]]:
        """In-place sum across devices: ``handles[d][j] ← Σ_d handles[d][j]``.

        In round ``t`` device ``d`` forwards the buffer it received in round
        ``t-1`` (its own in round 0) to ``d+1`` and adds the buffer arriving
        from ``d-1`` into its accumulator.  Receive buffers ping-pong between
        two scratch slots, so a round's SENDs and RECVs never touch the same
        handle.  ``wire_nbytes[j]`` overrides leaf ``j``'s accounted message
        size (modeled wire compression).  Returns the per-device per-leaf
        futures of the final accumulator writes.

        With a multi-rack :attr:`topology` installed this dispatches to
        :meth:`hier_allreduce` (the serial ascending order, ``O(R)`` spine
        crossings).
        """
        D, L = len(handles), len(specs)
        last: List[List[Any]] = [[None] * L for _ in range(D)]
        if D <= 1:
            return last
        if self._hier_ok(D):
            return self.hier_allreduce(pool, handles, specs,
                                       wire_nbytes=wire_nbytes, tag=tag)
        _ensure_kernels(pool)
        tmp = [[[pool.alloc(d, s.shape, s.dtype, tag=f"{tag}:tmp")
                 for s in specs] for d in range(D)] for _ in range(2)]
        try:
            for step in range(D - 1):
                cur, prev = tmp[step % 2], tmp[(step - 1) % 2]
                for d in range(D):
                    nxt = (d + 1) % D
                    for j in range(L):
                        src_h = handles[d][j] if step == 0 else prev[d][j]
                        self.sendrecv(pool, d, src_h, nxt, cur[nxt][j],
                                      nbytes=None if wire_nbytes is None
                                      else wire_nbytes[j],
                                      tag=f"{tag}:r{step}")
                for d in range(D):
                    for j in range(L):
                        out = pool.exec_kernel(
                            d, ADD_KERNEL,
                            buffers={"a": handles[d][j], "b": cur[d][j]},
                            tag=f"{tag}:add")
                        last[d][j] = pool.transfer_to_writeback(d, handles[d][j],
                                                                out)
        finally:
            # scratch is freed even on a failed round (FREE is a stream
            # writer: it runs after any in-flight SEND/RECV of the slot)
            for half in tmp:
                for d in range(D):
                    for j in range(L):
                        pool.free(d, half[d][j])
        return last

    def gather(self, pool, handles: Sequence[Sequence[int]],
               specs: Sequence[Any], *, root: int = 0,
               tag: str = "gather") -> Dict[int, List[int]]:
        """Copy every non-root device's buffer into fresh scratch slots on
        ``root``.  Returns ``{src_device: [scratch handles]}``; the caller
        owns (and frees) the scratch."""
        scratch: Dict[int, List[int]] = {}
        for d in range(len(handles)):
            if d == root:
                continue
            scratch[d] = [pool.alloc(root, s.shape, s.dtype, tag=f"{tag}:buf")
                          for s in specs]
            for j in range(len(specs)):
                self.sendrecv(pool, d, handles[d][j], root, scratch[d][j],
                              tag=tag)
        return scratch

    def broadcast(self, pool, handles: Sequence[Sequence[int]],
                  specs: Sequence[Any], *, root: int = 0,
                  tag: str = "bcast") -> List[List[Any]]:
        """Ring-chain broadcast of ``root``'s buffer into every device's
        handles (root → root+1 → …); each hop's SEND reads the handle the
        previous hop's RECV wrote, so the chain pipelines per leaf.
        Dispatches to :meth:`hier_broadcast` under a multi-rack topology."""
        D, L = len(handles), len(specs)
        last: List[List[Any]] = [[None] * L for _ in range(D)]
        if self._hier_ok(D):
            return self.hier_broadcast(pool, handles, specs, root=root,
                                       tag=tag)
        chain = [(root + i) % D for i in range(D)]
        for prev, cur in zip(chain, chain[1:]):
            for j in range(L):
                last[cur][j] = self.sendrecv(pool, prev, handles[prev][j],
                                             cur, handles[cur][j], tag=tag)
        return last

    def allreduce_mean(self, pool, handles: Sequence[Sequence[int]],
                       specs: Sequence[Any], *,
                       root: int = 0, tag: str = "avg") -> List[List[Any]]:
        """Mean across devices, bit-identical to the host-mediated path.

        Gather to ``root``, reduce there in ascending device order (the
        association of the host's ``sum(views) / D``), divide by ``D``, then
        broadcast the mean back into every device's handles.  Dispatches to
        :meth:`hier_allreduce_mean` under a multi-rack topology.
        """
        D, L = len(handles), len(specs)
        last: List[List[Any]] = [[None] * L for _ in range(D)]
        if D <= 1:
            return last
        if self._hier_ok(D):
            return self.hier_allreduce_mean(pool, handles, specs, root=root,
                                            tag=tag)
        _ensure_kernels(pool)
        scratch = self.gather(pool, handles, specs, root=root, tag=f"{tag}:gather")
        # accumulate in ASCENDING DEVICE order — device d's operand is its
        # gathered scratch copy, the root's its own buffer — so the
        # association matches the host's for any root.  Partial sums land
        # only in scratch slots: the root's live buffer is written exactly
        # once, by the final divide (all-or-nothing, like the funnel path)
        try:
            for j in range(L):
                acc = handles[root][j] if root == 0 else scratch[0][j]
                for d in range(1, D):
                    operand = handles[root][j] if d == root else scratch[d][j]
                    out = pool.exec_kernel(root, ADD_KERNEL,
                                           buffers={"a": acc, "b": operand},
                                           tag=f"{tag}:reduce")
                    if acc == handles[root][j]:  # first add when root == 0:
                        acc = operand            # park the sum in scratch
                    pool.transfer_to_writeback(root, acc, out)
                out = pool.exec_kernel(root, DIV_KERNEL, buffers={"a": acc},
                                       firstprivate={"s": float(D)},
                                       tag=f"{tag}:mean")
                last[root][j] = pool.transfer_to_writeback(root,
                                                           handles[root][j], out)
        finally:
            for hs in scratch.values():
                for h in hs:
                    pool.free(root, h)
        bcast = self.broadcast(pool, handles, specs, root=root, tag=f"{tag}:bcast")
        for d in range(D):
            if d != root:
                last[d] = bcast[d]
        return last

    # -- hierarchical collectives (rack-aware) ---------------------------------
    def _hier_chain_reduce(self, pool, handles, specs, wire_nbytes, tag,
                           scratch):
        """Serial-association hierarchical SUM: returns ``(root, total)``.

        Every non-leader member SENDs its buffer to its rack leader; each
        leader folds ``incoming partial + own buffer + member copies``
        left to right in ascending device order and SENDs the new partial
        to the next rack's leader, so the total is bitwise the serial
        left-associated ascending sum.  ``total`` are per-leaf scratch
        handles on ``root`` (the last rack's leader); live buffers are never
        written.  Every allocated slot is appended to ``scratch`` as
        ``(device, handle)`` — the caller frees.
        """
        L = len(specs)
        topo = self.topology
        wb = (lambda j: None) if wire_nbytes is None \
            else (lambda j: wire_nbytes[j])

        def _alloc(dev, j, kind):
            h = pool.alloc(dev, specs[j].shape, specs[j].dtype,
                           tag=f"{tag}:{kind}")
            scratch.append((dev, h))
            return h

        # 1) intra-rack gather onto each leader (all racks concurrent)
        gathered: Dict[int, List[int]] = {}     # member -> handles at leader
        for rack in topo.racks:
            lead = rack[0]
            for m in rack[1:]:
                gathered[m] = [_alloc(lead, j, "up") for j in range(L)]
                for j in range(L):
                    self.sendrecv(pool, m, handles[m][j],
                                  lead, gathered[m][j], nbytes=wb(j),
                                  tag=f"{tag}:up")
        # 2) fold + chain across leaders in ascending rack order
        carry_dev, carry = None, None
        for rack in topo.racks:
            lead = rack[0]
            incoming = None
            if carry is not None:
                incoming = [_alloc(lead, j, "chain") for j in range(L)]
                for j in range(L):
                    self.sendrecv(pool, carry_dev, carry[j],
                                  lead, incoming[j], nbytes=wb(j),
                                  tag=f"{tag}:chain")
            acc: List[Optional[int]] = [None] * L
            for j in range(L):
                ops = ([] if incoming is None else [incoming[j]])
                ops += [handles[m][j] if m == lead else gathered[m][j]
                        for m in rack]
                a = ops[0]
                for b in ops[1:]:
                    out = pool.exec_kernel(lead, ADD_KERNEL,
                                           buffers={"a": a, "b": b},
                                           tag=f"{tag}:add")
                    if acc[j] is None:
                        # partials park in scratch, never in a live buffer
                        acc[j] = _alloc(lead, j, "acc")
                    pool.transfer_to_writeback(lead, acc[j], out)
                    a = acc[j]
                if acc[j] is None:
                    acc[j] = a   # singleton first rack: its live buffer IS
                                 # the partial (read-only from here on)
            carry_dev, carry = lead, acc
        return carry_dev, carry

    def hier_allreduce(self, pool, handles: Sequence[Sequence[int]],
                       specs: Sequence[Any], *,
                       wire_nbytes: Optional[Sequence[int]] = None,
                       tag: str = "hier") -> List[List[Any]]:
        """Rack-aware in-place sum (the :meth:`ring_allreduce` contract):
        reduce within racks, chain across leaders, move the total into the
        final leader's live buffer, :meth:`hier_broadcast` it back out.
        ``2·(R-1)`` spine messages of ``|buf|``; every device's result is
        bitwise the serial ascending sum."""
        D, L = len(handles), len(specs)
        last: List[List[Any]] = [[None] * L for _ in range(D)]
        if D <= 1:
            return last
        _ensure_kernels(pool)
        scratch: List[Any] = []
        try:
            root, total = self._hier_chain_reduce(pool, handles, specs,
                                                  wire_nbytes, tag, scratch)
            for j in range(L):
                out = pool.exec_kernel(root, ID_KERNEL,
                                       buffers={"a": total[j]},
                                       tag=f"{tag}:fin")
                last[root][j] = pool.transfer_to_writeback(
                    root, handles[root][j], out)
            down = self.hier_broadcast(pool, handles, specs, root=root,
                                       tag=f"{tag}:down",
                                       wire_nbytes=wire_nbytes)
            for d in range(D):
                if d != root:
                    last[d] = down[d]
        finally:
            for dev, h in scratch:
                pool.free(dev, h)
        return last

    def hier_allreduce_mean(self, pool, handles: Sequence[Sequence[int]],
                            specs: Sequence[Any], *, root: int = 0,
                            tag: str = "havg") -> List[List[Any]]:
        """Rack-aware mean, bit-identical to flat :meth:`allreduce_mean`
        and to the host-mediated ``sum(views)/D``: the leader chain, then
        the final leader divides by ``D`` (its live buffer written once)
        and :meth:`hier_broadcast` distributes the mean.  Every device gets
        the same bits whatever ``root``, so the reduction is anchored at the
        last rack's leader."""
        D, L = len(handles), len(specs)
        last: List[List[Any]] = [[None] * L for _ in range(D)]
        if D <= 1:
            return last
        _ensure_kernels(pool)
        scratch: List[Any] = []
        try:
            anchor, total = self._hier_chain_reduce(pool, handles, specs,
                                                    None, tag, scratch)
            for j in range(L):
                out = pool.exec_kernel(anchor, DIV_KERNEL,
                                       buffers={"a": total[j]},
                                       firstprivate={"s": float(D)},
                                       tag=f"{tag}:mean")
                last[anchor][j] = pool.transfer_to_writeback(
                    anchor, handles[anchor][j], out)
            down = self.hier_broadcast(pool, handles, specs, root=anchor,
                                       tag=f"{tag}:bcast")
            for d in range(D):
                if d != anchor:
                    last[d] = down[d]
        finally:
            for dev, h in scratch:
                pool.free(dev, h)
        return last

    def hier_broadcast(self, pool, handles: Sequence[Sequence[int]],
                       specs: Sequence[Any], *,
                       root: int = 0, tag: str = "hbcast",
                       wire_nbytes: Optional[Sequence[int]] = None
                       ) -> List[List[Any]]:
        """Rack-aware broadcast of ``root``'s buffer into every handle: the
        root's rack first, a leader chain across the other racks (one spine
        message per boundary), then an intra-rack chain in each rack."""
        D, L = len(handles), len(specs)
        last: List[List[Any]] = [[None] * L for _ in range(D)]
        topo = self.topology
        wb = (lambda j: None) if wire_nbytes is None \
            else (lambda j: wire_nbytes[j])
        r0 = topo.rack_of(root)
        order = [r0] + [r for r in range(topo.n_racks) if r != r0]
        entry = {r0: root}
        prev = root
        for r in order[1:]:
            lead = topo.leader(r)
            for j in range(L):
                last[lead][j] = self.sendrecv(pool, prev, handles[prev][j],
                                              lead, handles[lead][j],
                                              nbytes=wb(j), tag=f"{tag}:x")
            entry[r] = lead
            prev = lead
        for r, rack in enumerate(topo.racks):
            chain = [entry[r]] + [m for m in rack if m != entry[r]]
            for p, c in zip(chain, chain[1:]):
                for j in range(L):
                    last[c][j] = self.sendrecv(pool, p, handles[p][j],
                                               c, handles[c][j],
                                               nbytes=wb(j), tag=f"{tag}:in")
        return last

    def quantize_int8(self, pool, handles: Sequence[Sequence[int]],
                      specs: Sequence[Any], *,
                      block: int = 256, tag: str = "q8") -> List[int]:
        """Apply the wire's block-int8 round trip to every device's buffer
        (a new tensor per leaf, written back into the slot) and return the
        per-leaf compressed message sizes, for use as ``wire_nbytes`` in a
        following collective.  The sizes are the compressed layout's
        (:func:`~.compression.int8_wire_nbytes`), so they track ``block``."""
        _ensure_kernels(pool)
        block = int(block)
        for d in range(len(handles)):
            for j in range(len(specs)):
                out = pool.exec_kernel(d, Q8_KERNEL,
                                       buffers={"a": handles[d][j]},
                                       firstprivate={"block": block},
                                       tag=f"{tag}:quantize")
                pool.transfer_to_writeback(d, handles[d][j], out)
        return [int8_wire_nbytes(math.prod(s.shape), block) for s in specs]


class HostFunnelTransport(Transport):
    """Paper-faithful topology: the host is the only wire.

    A device→device copy is TRANSFER_FROM(src) + TRANSFER_TO(dst): the bytes
    cross the host NIC twice and are accounted there.
    """

    kind = "host-funnel"

    def sendrecv(self, pool, src: int, src_handle: int,
                 dst: int, dst_handle: int, *,
                 nbytes: Optional[int] = None, tag: str = ""):
        value = pool.transfer_from(src, src_handle, tag=tag)
        return pool.transfer_to(dst, dst_handle, value, tag=tag)


class PeerTransport(Transport):
    """Direct device↔device fabric over SEND/RECV stream commands.

    Bytes are accounted per directed link, never against the host funnel.
    Message *timing* comes from the pool's ``cost.peer_link`` (and
    ``cost.topology``), which ``RuntimeConfig`` installs; ``link`` documents
    the fabric this transport was built for.  A ``topology`` makes the
    fabric hierarchical: per-pair edge pricing, compression-aware edge
    routing and rack-aware collectives.

    ``retries > 0`` makes the fabric fault tolerant: each ``sendrecv``
    waits for its RECV, and an injected :class:`~.device.DeviceFailure`
    re-sends the message, falling back to the host funnel (fetch + re-send,
    always available) once the peer wire has failed ``retries`` times.
    Re-sends are paced by exponential backoff with seeded jitter:
    ``backoff_base_s``·2^(attempt-1), capped at ``backoff_cap_s``, scaled by
    a draw in [0.5, 1) from ``np.random.default_rng((seed, 0xB0FF))``, so the
    same (seed, failure schedule) replays the same delays.  The delivered
    value is the same on either wire, so collectives stay bit-identical
    under injection.

    ``op_timeout_s`` bounds how long a ``sendrecv`` waits for its RECV: a
    blown timeout counts in ``timeouts``, is classified as a
    :class:`~.device.StragglerTimeout` and takes the same retry → backoff →
    funnel path as a failure.  The timed-out pair is disowned
    (:meth:`~.device.DevicePool.disown`): it runs on to its end, and a
    failure it ends with is cleared from its devices' stashes as it lands,
    before either device's worker runs another command.  So the funnel's
    fetch, which queues on the source device behind the hung SEND, cannot
    inherit the SEND's failure.  ``retries=0`` without a timeout keeps the
    fire-and-forget fabric.
    """

    kind = "peer"

    def __init__(self, link: Optional[LinkModel] = None,
                 retries: int = 0, *, op_timeout_s: Optional[float] = None,
                 backoff_base_s: float = 1e-3, backoff_cap_s: float = 0.1,
                 seed: int = 0, topology=None) -> None:
        self.link = link
        self.topology = topology
        self.retries = retries
        self.op_timeout_s = op_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = np.random.default_rng((seed, 0xB0FF))
        self._rng_lock = threading.Lock()
        self.fallbacks = 0      # edges rerouted to the funnel
        self.timeouts = 0       # messages that blew op_timeout_s
        self.backoffs = 0       # backoff sleeps taken
        self.backoff_s = 0.0    # seconds spent backing off

    def _backoff(self, attempt: int) -> None:
        """Sleep the attempt's backoff: exponential, capped, seeded jitter."""
        with self._rng_lock:
            u = float(self._rng.random())
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * (2.0 ** (attempt - 1)))
        delay *= 0.5 + 0.5 * u
        self.backoffs += 1
        self.backoff_s += delay
        time.sleep(delay)

    def sendrecv(self, pool, src: int, src_handle: int,
                 dst: int, dst_handle: int, *,
                 nbytes: Optional[int] = None, tag: str = ""):
        if self.retries <= 0 and self.op_timeout_s is None:
            return pool.peer_copy(src, src_handle, dst, dst_handle,
                                  nbytes=nbytes, tag=tag)
        from .device import DeviceFailure, StragglerTimeout
        attempt = 0
        while True:
            fut = pool.peer_copy(src, src_handle, dst, dst_handle,
                                 nbytes=nbytes, tag=tag)
            try:
                err = fut.exception(timeout=self.op_timeout_s)
            except cf.TimeoutError:
                # a straggler: the pair runs on, and whatever it ends with is
                # no one's to raise
                self.timeouts += 1
                pool.disown(src, fut.send)
                pool.disown(dst, fut)
                err = StragglerTimeout(
                    f"SEND/RECV {src}->{dst} exceeded the "
                    f"{self.op_timeout_s}s transport op timeout",
                    op="RECV", device=dst)
            if err is None:
                return fut
            if not isinstance(err, DeviceFailure):
                raise err
            # the pair stashed its failure on both endpoints; it is handled
            # here
            pool.absorb_failures()
            attempt += 1
            if attempt > self.retries:
                # the peer wire is down for this edge: the host funnel
                # delivers the same bytes over the paper's wire
                self.fallbacks += 1
                value = pool.transfer_from(src, src_handle, tag=f"{tag}:fallback")
                return pool.transfer_to(dst, dst_handle, value,
                                        tag=f"{tag}:fallback")
            self._backoff(attempt)

    def edge_time(self, cost, src: int, dst: int, nbytes: int) -> float:
        """One message on the directed (src, dst) peer link — no funnel hop.
        With a :attr:`topology` covering both endpoints the price is per
        pair and already the cheaper of the raw and block-int8 wires (the
        number :meth:`edge_route` routes by)."""
        if self.topology is not None and self.topology.covers(src, dst):
            return self.topology.edge_seconds(src, dst, nbytes)[0]
        plink = self.link or cost.peer_link or cost.link
        return plink.time(nbytes, 1)

    def edge_route(self, cost, src: int, dst: int, nbytes: int):
        """Per-pair price and wire: ``"peer+int8"`` where the link's
        bandwidth-delay arithmetic says compression wins, else ``"peer"``."""
        if self.topology is not None and self.topology.covers(src, dst):
            seconds, compressed = self.topology.edge_seconds(src, dst, nbytes)
            return seconds, ("peer+int8" if compressed else "peer")
        return self.edge_time(cost, src, dst, nbytes), "peer"
