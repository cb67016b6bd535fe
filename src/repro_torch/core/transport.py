"""Transport layer: who carries a byte between two devices.

First cut of ``repro.core.transport``: only the pricing interface
(:meth:`Transport.edge_time`/:meth:`Transport.edge_route`) and the
paper-faithful :class:`HostFunnelTransport`, where a device→device copy is a
fetch to the host plus a re-send.  ``PeerTransport`` and the collectives
built on the transport are the fabric slice (ROADMAP item 9).
"""
from __future__ import annotations

from typing import Optional, Tuple


class Transport:
    """How a buffer moves from one device's mediary slot to another's."""

    kind = "abstract"

    def sendrecv(self, pool, src: int, src_handle: int,
                 dst: int, dst_handle: int, *,
                 nbytes: Optional[int] = None, tag: str = ""):
        """Copy ``(src, src_handle)`` into ``(dst, dst_handle)``; returns the
        future of the destination write."""
        raise NotImplementedError

    def edge_time(self, cost, src: int, dst: int, nbytes: int) -> float:
        """Modeled seconds to carry one ``nbytes`` dependency edge src→dst.

        The base transport is the host funnel: a device→device copy is a
        fetch plus a re-send, two messages on the host NIC.
        """
        return cost.link.time(nbytes, 1) * 2

    def edge_route(self, cost, src: int, dst: int,
                   nbytes: int) -> Tuple[float, str]:
        """``(seconds, wire)`` for one dependency edge over this fabric; the
        base fabric has no per-pair knowledge: one raw message at
        :meth:`edge_time`'s price."""
        return self.edge_time(cost, src, dst, nbytes), "peer"


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
