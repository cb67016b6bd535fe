"""Interconnect cost models and transfer accounting.

Port of ``repro.core.costmodel``: every host↔device transfer of the offload
runtime is logged against a :class:`LinkModel` (the paper's Gbit Ethernet by
default), and the same event stream gives the same ``summary()`` as the
reference.  Two makespan models:

* ``makespan(overlap=False)`` — paper-faithful: all communication serialized
  at the host NIC, then compute (the OpenMP host-funnel restriction).
* ``makespan(overlap=True)`` — an event timeline: recorded events are
  list-scheduled onto a host-TX lane, a host-RX lane and one compute lane
  per device, so transfers for strip *k+1* overlap device *k*'s compute.

Peer (device→device) messages are timed per directed link: on the one
``peer_link``, or, with a :class:`~.topology.Topology` installed, on each
pair's own link (intra-rack vs spine), and the spine's share is counted in
``bytes_peer_cross_rack``.

Left for later slices: the TPU roofline constants (the port measures on the
card instead), per-kernel time estimates for cost-driven placement (ROADMAP
item 10), calibration profiles and the roofline report (item 12).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class LinkModel:
    """alpha-beta model: time(n bytes) = latency + n / bandwidth."""

    name: str
    bandwidth_Bps: float  # bytes per second
    latency_s: float

    def time(self, nbytes: int, n_messages: int = 1) -> float:
        return self.latency_s * n_messages + nbytes / self.bandwidth_Bps


# The paper's cluster: Gbit Ethernet (§5.2). ~125 MB/s peak, ~50us MPI latency.
PAPER_ETHERNET = LinkModel("gbit-ethernet", 125e6, 50e-6)


@dataclass
class TransferRecord:
    direction: str          # "to" | "from"
    device: int
    nbytes: int
    n_messages: int = 1
    tag: str = ""


@dataclass
class ComputeRecord:
    device: int
    seconds: float          # measured task compute time
    tag: str = ""
    kernel: str = ""        # registered kernel name


@dataclass
class PeerRecord:
    """One device↔device transfer on a peer link (never the host NIC)."""

    src: int
    dst: int
    nbytes: int
    n_messages: int = 1
    tag: str = ""


@dataclass
class Event:
    """One entry of the recorded event stream (issue order preserved)."""

    kind: str               # "xfer" | "compute" | "peer"
    device: int             # peer: the destination device
    tag: str = ""
    direction: str = ""     # xfer only: "to" | "from"
    nbytes: int = 0
    n_messages: int = 1
    seconds: float = 0.0    # compute only
    src: int = -1           # peer only: the source device


@dataclass
class TimelineSpan:
    """One scheduled event on the modeled timeline."""

    start: float
    end: float
    lane: str               # "tx" | "rx" | "dev<k>" | "p<src>>dst>"
    event: Event


def _tag_matches(tag: str, prefix: str) -> bool:
    return tag == prefix or tag.startswith(prefix + ":") or tag.startswith(prefix + "[")


class CostModel:
    """Accounts transfers/compute per device and models end-to-end makespan.

    ``makespan()`` reflects the paper's execution model: the host serializes
    its own sends/receives over a single NIC, while device compute runs
    concurrently across devices.
    """

    def __init__(self, link: LinkModel = PAPER_ETHERNET,
                 peer_link: Optional[LinkModel] = None,
                 topology=None) -> None:
        self.link = link
        # the device↔device link (None = same fabric as the host link)
        self.peer_link = peer_link
        # optional Topology: each directed peer pair is timed on ITS link
        # and cross-rack traffic is counted apart (bytes_peer_cross_rack)
        self.topology = topology
        self.transfers: List[TransferRecord] = []
        self.compute: List[ComputeRecord] = []
        self.adjustments: List[TransferRecord] = []
        self.peers: List[PeerRecord] = []
        self.events: List[Event] = []
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self.transfers.clear()
            self.compute.clear()
            self.adjustments.clear()
            self.peers.clear()
            self.events.clear()

    # -- accounting ---------------------------------------------------------
    def record_transfer(self, direction: str, device: int, nbytes: int,
                        n_messages: int = 1, tag: str = "") -> None:
        with self._lock:
            self.transfers.append(TransferRecord(direction, device, int(nbytes),
                                                 n_messages, tag))
            self.events.append(Event("xfer", device, tag=tag, direction=direction,
                                     nbytes=int(nbytes), n_messages=n_messages))

    def record_compute(self, device: int, seconds: float, tag: str = "",
                       kernel: str = "") -> None:
        with self._lock:
            self.compute.append(ComputeRecord(device, float(seconds), tag,
                                              kernel))
            self.events.append(Event("compute", device, tag=tag,
                                     seconds=float(seconds)))

    def record_peer(self, src: int, dst: int, nbytes: int,
                    n_messages: int = 1, tag: str = "") -> None:
        """One device→device transfer over the (src, dst) peer link; never
        counted against the host NIC."""
        with self._lock:
            self.peers.append(PeerRecord(src, dst, int(nbytes), n_messages, tag))
            self.events.append(Event("peer", dst, tag=tag, nbytes=int(nbytes),
                                     n_messages=n_messages, src=src))

    def record_adjustment(self, direction: str, device: int, nbytes: int,
                          tag: str = "") -> None:
        """Zero-latency byte-accounting correction (no wire messages): counts
        toward ``bytes_moved`` and adds pure bandwidth time to ``comm_time``,
        never an event on the timeline."""
        with self._lock:
            self.adjustments.append(TransferRecord(direction, device,
                                                   int(nbytes), 0, tag))

    def discard_tag(self, prefix: str) -> int:
        """Drop every record whose tag belongs to region ``prefix`` (a losing
        speculative copy must not count); returns the number removed."""
        with self._lock:
            before = (len(self.transfers) + len(self.compute)
                      + len(self.adjustments) + len(self.peers)
                      + len(self.events))
            self.transfers = [t for t in self.transfers
                              if not _tag_matches(t.tag, prefix)]
            self.compute = [c for c in self.compute
                            if not _tag_matches(c.tag, prefix)]
            self.adjustments = [a for a in self.adjustments
                                if not _tag_matches(a.tag, prefix)]
            self.peers = [p for p in self.peers
                          if not _tag_matches(p.tag, prefix)]
            self.events = [e for e in self.events
                           if not _tag_matches(e.tag, prefix)]
            return before - (len(self.transfers) + len(self.compute)
                             + len(self.adjustments) + len(self.peers)
                             + len(self.events))

    def rename_tag(self, prefix: str, new_prefix: str) -> int:
        """Rewrite every record in region ``prefix`` into ``new_prefix`` (the
        winning speculative copy takes the original task's tag); returns the
        number renamed."""
        renamed = 0
        with self._lock:
            for rec in (*self.transfers, *self.compute, *self.adjustments,
                        *self.peers, *self.events):
                if _tag_matches(rec.tag, prefix):
                    renamed += 1
                    rec.tag = new_prefix + rec.tag[len(prefix):]
        return renamed

    # -- summaries ------------------------------------------------------------
    def bytes_moved(self, direction: Optional[str] = None) -> int:
        return sum(t.nbytes for t in self.transfers + self.adjustments
                   if direction is None or t.direction == direction)

    def bytes_peer(self) -> int:
        """Bytes moved device→device — real messages, zero host-NIC load."""
        return sum(p.nbytes for p in self.peers)

    def bytes_peer_cross_rack(self) -> int:
        """Peer bytes whose (src, dst) pair crosses a rack boundary under
        the installed topology (0 without one: a flat fabric has none)."""
        if self.topology is None:
            return 0
        return sum(p.nbytes for p in self.peers
                   if self.topology.covers(p.src, p.dst)
                   and self.topology.cross_rack(p.src, p.dst))

    def peer_link_for(self, src: int, dst: int) -> LinkModel:
        """The link model timing one directed peer message: the topology's
        per-pair link when one is installed, else the uniform ``peer_link``
        (the host link as the final fallback)."""
        if self.topology is not None and self.topology.covers(src, dst):
            return self.topology.link_between(src, dst)
        return self.peer_link or self.link

    def comm_time(self) -> float:
        """Total host-funnel communication time (serialized at the host NIC)."""
        wire = sum(self.link.time(t.nbytes, t.n_messages) for t in self.transfers)
        # adjustments are latency-free: pure bandwidth credits/debits
        wire += sum(a.nbytes / self.link.bandwidth_Bps for a in self.adjustments)
        return wire

    def peer_time(self) -> float:
        """Peer-fabric time: each directed link serializes its own messages,
        links run concurrently — the max per-link sum."""
        per_link: Dict[Tuple[int, int], float] = {}
        for p in self.peers:
            k = (p.src, p.dst)
            per_link[k] = per_link.get(k, 0.0) \
                + self.peer_link_for(p.src, p.dst).time(p.nbytes,
                                                        p.n_messages)
        return max(per_link.values(), default=0.0)

    def compute_time(self) -> float:
        """Parallel compute time: max over devices of their summed task time."""
        per_dev: Dict[int, float] = {}
        for c in self.compute:
            per_dev[c.device] = per_dev.get(c.device, 0.0) + c.seconds
        return max(per_dev.values(), default=0.0)

    # -- event timeline (pipelined model) -------------------------------------
    def timeline(self) -> List[TimelineSpan]:
        """List-schedule the recorded events onto lanes.

        Lanes: ``tx`` and ``rx`` (the NIC is full duplex), one compute lane
        per device, one lane per directed peer link.  A host transfer
        occupies its NIC lane and its device's lane; compute occupies the
        device lane after the device's in-flight peer messages.  Per-lane
        order follows the recorded issue order.
        """
        with self._lock:
            events = list(self.events)
        tx_t, rx_t = 0.0, 0.0
        dev_t: Dict[int, float] = {}          # compute / host-xfer occupancy
        dev_tx: Dict[int, float] = {}         # peer send side, full duplex
        dev_rx: Dict[int, float] = {}         # peer receive side
        link_t: Dict[Tuple[int, int], float] = {}
        spans: List[TimelineSpan] = []
        for e in events:
            if e.kind == "xfer":
                nic_t = tx_t if e.direction == "to" else rx_t
                start = max(nic_t, dev_t.get(e.device, 0.0))
                end = start + self.link.time(e.nbytes, e.n_messages)
                if e.direction == "to":
                    tx_t = end
                else:
                    rx_t = end
                dev_t[e.device] = end
                spans.append(TimelineSpan(start, end,
                                          "tx" if e.direction == "to" else "rx", e))
            elif e.kind == "peer":
                lk = (e.src, e.device)
                start = max(link_t.get(lk, 0.0),
                            dev_t.get(e.src, 0.0), dev_tx.get(e.src, 0.0),
                            dev_t.get(e.device, 0.0), dev_rx.get(e.device, 0.0))
                end = start + self.peer_link_for(e.src, e.device).time(
                    e.nbytes, e.n_messages)
                link_t[lk] = dev_tx[e.src] = dev_rx[e.device] = end
                spans.append(TimelineSpan(start, end, f"p{e.src}>{e.device}", e))
            elif e.kind == "compute":
                start = max(dev_t.get(e.device, 0.0), dev_tx.get(e.device, 0.0),
                            dev_rx.get(e.device, 0.0))
                end = start + e.seconds
                dev_t[e.device] = end
                spans.append(TimelineSpan(start, end, f"dev{e.device}", e))
        return spans

    def makespan(self, overlap: bool = False) -> float:
        """Modeled wall time: comm then compute (``overlap=False``, the
        paper's model) or the lane timeline (``overlap=True``)."""
        if not overlap:
            return self.comm_time() + self.peer_time() + self.compute_time()
        spans = self.timeline()
        if not spans:
            return 0.0
        # adjustments move bytes on/off the NIC without being schedulable
        # events: apply their net bandwidth time to the lane ends
        adj = {"to": 0.0, "from": 0.0}
        for a in self.adjustments:
            adj[a.direction] = adj.get(a.direction, 0.0) \
                + a.nbytes / self.link.bandwidth_Bps
        other_end = max((s.end for s in spans if s.lane not in ("tx", "rx")),
                        default=0.0)
        tx_end = max((s.end for s in spans if s.lane == "tx"), default=0.0)
        rx_end = max((s.end for s in spans if s.lane == "rx"), default=0.0)
        return max(other_end,
                   (tx_end + adj["to"]) if tx_end else 0.0,
                   (rx_end + adj["from"]) if rx_end else 0.0,
                   0.0)

    def summary(self) -> Dict[str, float]:
        return {
            "bytes_to": float(self.bytes_moved("to")),
            "bytes_from": float(self.bytes_moved("from")),
            "bytes_peer": float(self.bytes_peer()),
            "bytes_peer_cross_rack": float(self.bytes_peer_cross_rack()),
            "comm_s": self.comm_time(),
            "peer_s": self.peer_time(),
            "compute_s": self.compute_time(),
            "makespan_s": self.makespan(),
            "makespan_overlap_s": self.makespan(overlap=True),
            # no cost-driven placement yet (ROADMAP item 10): never a
            # blind kernel-time estimate
            "cold_predictions": 0.0,
        }
