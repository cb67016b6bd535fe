"""repro_torch.core — cluster nodes as OpenMP-style devices, in PyTorch.

Public API (counterparts of ``repro.core``):
  KernelTable / kernel         stable-integer kernel registry (paper §4.1)
  MediaryStore / HostMirror    buffer-handle indirection (paper §4.2)
  NodeDevice / DevicePool      virtual devices on one card, one stream each
  MapSpec / sec / TargetExecutor   target regions with map(to/from/tofrom/alloc)
  strip_partition / offload_strips / recursive_offload / wavefront_offload
  TaskGraph / TaskNode / run_graph    task-graph IR the patterns lower into
  GraphCheckpoint / GraphInterrupted / load_graph_checkpoint   resumable runs
  RoundRobin / LocalityAffinity / HeftPlacement / SloPlacement   placement policies
  Transport / HostFunnelTransport / PeerTransport   the wire, and collectives
  Topology                     racks and per-pair links of the peer fabric
  ClusterRuntime / RuntimeConfig   deployable runtime (host-mediated or
                               direct), data-parallel fabric, cost model
  DeviceFailure / HealthRegistry   failures that run_graph and the peer
                               transport recover from (injection: repro_torch.ft)
  StragglerTimeout             a blown command deadline or transport op
                               timeout, recovered like any DeviceFailure
  CalibrationProfile / calibrate   measured kernel/link costs seeding the model
"""
from .calibrate import (CalibrationProfile, KernelProfile, LinkProfile,
                        RegionMarker, StaleProfileError, calibrate,
                        fit_alpha_beta, profile_kernels, profile_links)
from .costmodel import (CostModel, DEFAULT_KERNEL_TIME_S, Event, LinkModel,
                        PAPER_ETHERNET, PeerRecord, PlacementRecord,
                        TimelineSpan)
from .device import (Command, DeviceFailure, DevicePool, DeviceStoppedError,
                     HealthRegistry, NodeDevice, SLOT_STREAM, StragglerTimeout,
                     StreamTicket)
from .kernel_table import GLOBAL_KERNEL_TABLE, KernelTable, kernel
from .mediary import (RESERVED, HostMirror, MediaryStore, PresentEntry,
                      PresentTable, TensorSpec)
from .runtime import ClusterRuntime, RuntimeConfig
from .scheduler import (DagTask, PeerRef, offload_strips, recursive_offload,
                        strip_partition, wavefront_offload)
from .target import MapSpec, Section, TargetExecutor, TargetFuture, sec
from .taskgraph import (GraphCheckpoint, GraphInterrupted, HeftPlacement,
                        LocalityAffinity, PlacementContext, PlacementPolicy,
                        RoundRobin, SloPlacement, TaskGraph, TaskNode,
                        load_graph_checkpoint, resolve_policy, run_graph)
from .topology import Topology
from .transport import HostFunnelTransport, PeerTransport, Transport

__all__ = [
    "KernelTable", "kernel", "GLOBAL_KERNEL_TABLE",
    "MediaryStore", "HostMirror", "RESERVED", "PresentTable", "PresentEntry",
    "TensorSpec",
    "NodeDevice", "DevicePool", "Command", "DeviceStoppedError",
    "DeviceFailure", "HealthRegistry", "SLOT_STREAM", "StragglerTimeout",
    "StreamTicket",
    "MapSpec", "Section", "sec", "TargetExecutor", "TargetFuture",
    "strip_partition", "offload_strips", "recursive_offload",
    "wavefront_offload", "DagTask", "PeerRef",
    "TaskGraph", "TaskNode", "run_graph", "resolve_policy",
    "GraphCheckpoint", "GraphInterrupted", "load_graph_checkpoint",
    "PlacementPolicy", "PlacementContext", "RoundRobin", "LocalityAffinity",
    "HeftPlacement", "SloPlacement",
    "ClusterRuntime", "RuntimeConfig",
    "Transport", "HostFunnelTransport", "PeerTransport", "Topology",
    "CostModel", "LinkModel", "Event", "PeerRecord", "PlacementRecord",
    "TimelineSpan", "PAPER_ETHERNET", "DEFAULT_KERNEL_TIME_S",
    "CalibrationProfile", "KernelProfile", "LinkProfile", "RegionMarker",
    "StaleProfileError", "calibrate", "fit_alpha_beta",
    "profile_kernels", "profile_links",
]
