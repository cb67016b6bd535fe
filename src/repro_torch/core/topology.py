"""Hierarchical fabric topology: racks, tiers, per-pair link costs.

Port of ``repro.core.topology`` (pure Python, its own copy).

The paper's bottom line is that offload pays "as long as the application
tasks do not produce excessive communication overheads" — and its cluster is
the friendly case, one flat Gbit Ethernet where every pair of nodes costs the
same.  Real clusters are node/rack/spine hierarchies with order-of-magnitude
bandwidth gaps between the tiers; a placement or collective that is blind to
them lands exactly in the "excessive communication" regime where the model
dies.  Both the OpenMP Cluster model (arXiv:2207.05677) and OMP2MPI schedule
against heterogeneous link costs; this module makes our fabric do the same.

:class:`Topology` groups the pool's devices into **racks** and answers, for
any directed device pair, *which link carries the message and what it costs*:

* :meth:`link_between` — the :class:`~repro_torch.core.costmodel.LinkModel` for a
  pair: ``intra`` within a rack, ``inter`` across racks, with optional
  per-pair overrides (:meth:`set_link`) for asymmetric fabrics.
* :meth:`edge_seconds` — modeled seconds for one dependency edge, including
  the **compression decision**: the block-int8 wire
  (:mod:`repro_torch.core.compression`) is applied only where the link's
  bandwidth-delay arithmetic says the byte savings beat the quantize cost —
  ``(nbytes - wire) / bandwidth > 2·nbytes / quantize_Bps`` — so fat
  intra-rack links carry raw bytes while the thin spine carries int8.
  Small messages never compress: below ~1 block the scale overhead makes
  the wire *larger*, which the same arithmetic rejects.

The transport layer (:class:`~repro_torch.core.transport.PeerTransport`) prices
``edge_time`` per pair through this object and dispatches its collectives
hierarchically (reduce-within-rack → chain-across-rack-leaders →
broadcast-within-rack) when the topology has more than one rack; the
placement policies see it through ``PlacementContext.topology`` and
``route_edge`` returns ``"peer+int8"`` for edges where compression wins.

**Contiguity rule.** Racks must partition ``0..D-1`` into contiguous
ascending blocks (``two_tier``/``partition`` build exactly that).  The
hierarchical reduction threads its partial sum through the racks in that
order, adding members ascending, so the result carries the *serial*
left-associated ascending association — bitwise identical to the host's
``sum(views)`` and to the flat ``allreduce_mean`` reduction, for free.
A non-contiguous grouping would silently change the association (and the
bits), so the constructor rejects it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .compression import int8_wire_nbytes
from .costmodel import LinkModel, PAPER_ETHERNET

#: Default in-rack fabric: a 10GbE leaf switch (10× the paper's Gbit spine).
#: ``Topology.two_tier(...)`` with the default ``inter_bw_ratio=0.1`` then
#: models exactly the paper's cluster as the *cross-rack* tier.
INTRA_RACK = LinkModel("intra-rack-10g", 1.25e9, 5e-6)


class Topology:
    """Devices grouped into racks, with per-link-pair bandwidth/latency.

    ``racks`` is a sequence of device-index groups that must partition
    ``0..D-1`` into contiguous ascending blocks (see the module docstring
    for why the hierarchical collectives need that).  ``intra`` prices
    same-rack pairs, ``inter`` cross-rack pairs (derived from ``intra`` and
    ``inter_bw_ratio`` when not given); :meth:`set_link` overrides single
    pairs.  ``quantize_Bps`` is the modeled throughput of the block-int8
    quantize/dequantize pair (both ends charged), ``block`` its block size
    — together they decide :meth:`compression_wins` per link.
    """

    def __init__(self, racks: Sequence[Sequence[int]], *,
                 intra: LinkModel = INTRA_RACK,
                 inter: LinkModel = None,
                 inter_bw_ratio: float = 0.1,
                 inter_latency_s: float = None,
                 quantize_Bps: float = 2e9,
                 block: int = 256) -> None:
        rk = tuple(tuple(int(d) for d in r) for r in racks)
        if not rk or any(not r for r in rk):
            raise ValueError("racks must be non-empty device groups")
        flat = [d for r in rk for d in r]
        if flat != list(range(len(flat))):
            raise ValueError(
                "racks must partition devices 0..D-1 into contiguous "
                "ascending blocks (the hierarchical reduction's serial "
                f"association depends on it), got {rk}")
        self.racks = rk
        self.intra = intra
        if inter is None:
            inter = LinkModel(
                f"{intra.name}-spine",
                intra.bandwidth_Bps * inter_bw_ratio,
                intra.latency_s * 4 if inter_latency_s is None
                else inter_latency_s)
        self.inter = inter
        self.quantize_Bps = float(quantize_Bps)
        self.block = int(block)
        self._rack_of: Dict[int, int] = {d: r for r, rack in enumerate(rk)
                                         for d in rack}
        self._overrides: Dict[Tuple[int, int], LinkModel] = {}

    # -- constructors --------------------------------------------------------
    @classmethod
    def two_tier(cls, racks: int, per_rack: int, **kw) -> "Topology":
        """``racks`` equal racks of ``per_rack`` devices each."""
        return cls(tuple(tuple(range(r * per_rack, (r + 1) * per_rack))
                         for r in range(racks)), **kw)

    @classmethod
    def partition(cls, n_devices: int, per_rack: int, **kw) -> "Topology":
        """Chunk ``0..n_devices-1`` into racks of ``per_rack`` (the last rack
        takes the remainder — D need not divide evenly)."""
        if per_rack < 1:
            raise ValueError(f"per_rack must be >= 1, got {per_rack}")
        return cls(tuple(tuple(range(i, min(i + per_rack, n_devices)))
                         for i in range(0, n_devices, per_rack)), **kw)

    @classmethod
    def flat(cls, n_devices: int, *, link: LinkModel = PAPER_ETHERNET,
             **kw) -> "Topology":
        """One rack holding every device: per-pair pricing with no hierarchy
        (collectives stay flat — a single rack never dispatches the
        hierarchical path)."""
        return cls((tuple(range(n_devices)),), intra=link, inter=link, **kw)

    # -- structure queries ---------------------------------------------------
    @property
    def n_devices(self) -> int:
        return len(self._rack_of)

    @property
    def n_racks(self) -> int:
        return len(self.racks)

    def covers(self, *devices: int) -> bool:
        """Whether every index is a device this topology describes."""
        return all(d in self._rack_of for d in devices)

    def rack_of(self, device: int) -> int:
        return self._rack_of[device]

    def same_rack(self, a: int, b: int) -> bool:
        return self._rack_of[a] == self._rack_of[b]

    def members(self, rack: int) -> Tuple[int, ...]:
        return self.racks[rack]

    def leader(self, rack: int) -> int:
        """The rack's lowest device index — the hierarchical collectives'
        aggregation point and cross-rack endpoint."""
        return self.racks[rack][0]

    def leaders(self) -> List[int]:
        return [r[0] for r in self.racks]

    def leader_of(self, device: int) -> int:
        return self.racks[self._rack_of[device]][0]

    # -- link pricing --------------------------------------------------------
    def set_link(self, a: int, b: int, link: LinkModel, *,
                 directed: bool = False) -> None:
        """Override the link for one pair (both directions unless
        ``directed``) — asymmetric or degraded fabrics."""
        self._overrides[(a, b)] = link
        if not directed:
            self._overrides[(b, a)] = link

    def link_between(self, src: int, dst: int) -> LinkModel:
        """The :class:`LinkModel` carrying one ``src → dst`` message."""
        ov = self._overrides.get((src, dst))
        if ov is not None:
            return ov
        return self.intra if self._rack_of[src] == self._rack_of[dst] \
            else self.inter

    def cross_rack(self, src: int, dst: int) -> bool:
        return self._rack_of[src] != self._rack_of[dst]

    def pair_time(self, src: int, dst: int, nbytes: int,
                  n_messages: int = 1) -> float:
        return self.link_between(src, dst).time(nbytes, n_messages)

    # -- compression routing -------------------------------------------------
    def int8_wire_nbytes(self, nbytes: int, itemsize: int = 4) -> int:
        """Modeled wire size of an ``nbytes`` message under the block-int8
        scheme (``itemsize`` bytes per raw element)."""
        return int8_wire_nbytes(-(-int(nbytes) // itemsize), self.block)

    def quantize_seconds(self, nbytes: int) -> float:
        """Modeled cost of the quantize (src) + dequantize (dst) pair."""
        return 2.0 * nbytes / self.quantize_Bps

    def edge_seconds(self, src: int, dst: int,
                     nbytes: int) -> Tuple[float, bool]:
        """Best modeled seconds for one dependency edge, and whether that
        best applies the block-int8 wire.  Compression wins only where the
        link is thin enough that the saved wire time exceeds the quantize
        cost — on a fat intra-rack link the savings are too small, on a tiny
        message the per-block scales make the wire larger."""
        link = self.link_between(src, dst)
        raw = link.time(nbytes, 1)
        wire = self.int8_wire_nbytes(nbytes)
        if wire < nbytes:
            comp = link.time(wire, 1) + self.quantize_seconds(nbytes)
            if comp < raw:
                return comp, True
        return raw, False

    def compression_wins(self, src: int, dst: int, nbytes: int) -> bool:
        return self.edge_seconds(src, dst, nbytes)[1]

    # -- reporting -----------------------------------------------------------
    def describe(self) -> Dict[str, object]:
        """JSON-friendly shape summary for benchmark artifacts."""
        return {
            "racks": [list(r) for r in self.racks],
            "n_devices": self.n_devices,
            "intra": {"name": self.intra.name,
                      "bandwidth_Bps": self.intra.bandwidth_Bps,
                      "latency_s": self.intra.latency_s},
            "inter": {"name": self.inter.name,
                      "bandwidth_Bps": self.inter.bandwidth_Bps,
                      "latency_s": self.inter.latency_s},
            "quantize_Bps": self.quantize_Bps,
            "block": self.block,
        }

    def __repr__(self) -> str:
        shape = "x".join(str(len(r)) for r in self.racks)
        return (f"Topology({self.n_racks} racks [{shape}], "
                f"intra={self.intra.name}, inter={self.inter.name})")
