"""Measured cost calibration: profiled kernels and links seeding the CostModel.

Port of ``repro.core.calibrate``.  ``HeftPlacement`` and
``Transport.edge_route`` price compute and edges from :class:`CostModel`
constants.  A calibration pass measures them instead: it times every kernel
of a :class:`~.kernel_table.KernelTable` that has example operands (each rep
a :class:`RegionMarker` region), counts its FLOPs and bytes, and fits the
host funnel and the peer fabric per direction and per rack tier, then keeps
the result as a versioned per-host :class:`CalibrationProfile` (JSON under
``artifacts/calibration/``, the reference's layout: a profile written by
either package loads in the other).

Two choices differ from the reference, each where PyTorch has no
counterpart of what it uses:

* **The clock.**  A kernel's seed stands in for
  :meth:`CostModel.kernel_time` until live EXEC observations replace it, so
  it is read on the clock those observations use: the pool device's
  :meth:`~.device.NodeDevice.busy_clock` around the call and a synchronize
  of that device's stream (on the card the host's wall clock, as the
  reference's ``perf_counter`` around ``block_until_ready``; on the CPU the
  thread's CPU time).  A CUDA-event time would be the kernel alone, several
  times smaller than the EXEC span that later replaces it.
* **The counts.**  XLA's ``cost_analysis()`` has no PyTorch counterpart
  that sees inside a hand-written kernel.  The entry runs once on CPU
  copies of its operands under ``torch.utils.flop_counter.FlopCounterMode``,
  which counts the plain version's matmul-class operations (elementwise
  work counts 0); the bytes are each operand and each output once.

``CostModel.load_profile`` seeds ``kernel_time`` and the link models from a
profile after a staleness check (:class:`StaleProfileError`): a profile of
another pool shape, topology, kernel table or schema version is refused.

Calibration changes *models*, never results: its wire traffic is tagged
``__calib`` and discarded from the cost records afterwards, and a profile
only reshapes placement and routing, which move bytes, not values.
"""
from __future__ import annotations

import contextlib
import json
import os
import platform
import socket
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _tree
from .costmodel import LinkModel

#: Bump when the JSON layout changes; ``CalibrationProfile.check`` rejects
#: profiles written under any other version.
SCHEMA_VERSION = 1

#: Default directory the calibration artifacts live under (per-host files).
PROFILE_DIR = os.path.join("artifacts", "calibration")

#: Tag on every wire operation the link calibration issues, so the records
#: can be discarded (``CostModel.discard_tag``) once the fits are done.
CALIB_TAG = "__calib"


class StaleProfileError(RuntimeError):
    """A profile does not describe this pool/topology/table/schema."""


# ---------------------------------------------------------------------------
# LIKWID-style region marking
# ---------------------------------------------------------------------------
class RegionMarker:
    """Named timing regions (the LIKWID marker API, host-clock edition).

    ``with marker.region("lu0"): ...`` appends one sample of ``clock`` to
    the region's series; the calibration pass wraps every measured kernel
    rep in a region so the raw samples survive into the profile.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self.clock = clock
        self._samples: Dict[str, List[float]] = {}

    @contextmanager
    def region(self, name: str):
        t0 = self.clock()
        try:
            yield self
        finally:
            self._samples.setdefault(name, []).append(self.clock() - t0)

    def samples(self, name: str) -> List[float]:
        return list(self._samples.get(name, ()))

    def regions(self) -> List[str]:
        return sorted(self._samples)


# ---------------------------------------------------------------------------
# Profile records
# ---------------------------------------------------------------------------
@dataclass
class KernelProfile:
    """One calibrated kernel: marked-region timing + counted FLOPs/bytes."""

    name: str
    seconds: float                  # median of the marked-region samples
    reps: int = 1
    min_s: float = 0.0
    max_s: float = 0.0
    flops: float = 0.0              # FlopCounterMode's count (matmul-class)
    bytes_accessed: float = 0.0     # operands + outputs, each once

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOPs per byte accessed (0 when unknown)."""
        return self.flops / self.bytes_accessed if self.bytes_accessed else 0.0

    @property
    def achieved_flops_per_s(self) -> float:
        return self.flops / self.seconds if self.seconds > 0 else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "seconds": self.seconds, "reps": self.reps,
                "min_s": self.min_s, "max_s": self.max_s, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "intensity": self.intensity,
                "achieved_flops_per_s": self.achieved_flops_per_s}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KernelProfile":
        return cls(name=d["name"], seconds=float(d["seconds"]),
                   reps=int(d.get("reps", 1)),
                   min_s=float(d.get("min_s", 0.0)),
                   max_s=float(d.get("max_s", 0.0)),
                   flops=float(d.get("flops", 0.0)),
                   bytes_accessed=float(d.get("bytes_accessed", 0.0)))


@dataclass
class LinkProfile:
    """One calibrated link: alpha-beta fit over (nbytes, seconds) samples."""

    name: str                       # "funnel", "funnel:to", "peer:inter", ...
    bandwidth_Bps: float
    latency_s: float
    samples: List[Tuple[int, float]] = field(default_factory=list)

    def link_model(self) -> LinkModel:
        return LinkModel(f"calibrated-{self.name}", self.bandwidth_Bps,
                         self.latency_s)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "bandwidth_Bps": self.bandwidth_Bps,
                "latency_s": self.latency_s,
                "samples": [[int(n), float(t)] for n, t in self.samples]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LinkProfile":
        return cls(name=d["name"], bandwidth_Bps=float(d["bandwidth_Bps"]),
                   latency_s=float(d["latency_s"]),
                   samples=[(int(n), float(t))
                            for n, t in d.get("samples", [])])


def fit_alpha_beta(samples: Sequence[Tuple[int, float]]
                   ) -> Tuple[float, float]:
    """Least-squares fit of ``t = latency + n / bandwidth`` over samples.

    Returns ``(latency_s, bandwidth_Bps)``.  Degenerate fits (non-positive
    slope from timer noise on tiny messages) clamp to a near-infinite
    bandwidth rather than a negative one; latency clamps at >= 0.
    """
    n = np.asarray([s[0] for s in samples], dtype=float)
    t = np.asarray([s[1] for s in samples], dtype=float)
    if len(samples) < 2 or float(np.ptp(n)) == 0.0:
        lat = float(t.mean()) if len(samples) else 0.0
        return max(lat, 0.0), 1e12
    coef, *_ = np.linalg.lstsq(np.stack([np.ones_like(n), n], axis=1), t,
                               rcond=None)
    latency, inv_bw = float(coef[0]), float(coef[1])
    bandwidth = 1.0 / inv_bw if inv_bw > 0 else 1e12
    return max(latency, 0.0), max(bandwidth, 1.0)


def _power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it (None without)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def host_info(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The reference's host block; on a CUDA ``device`` it also names the
    card and its power limit (the block is a free dict in the schema)."""
    info: Dict[str, Any] = {"hostname": socket.gethostname(),
                            "platform": platform.platform(),
                            "machine": platform.machine(),
                            "python": sys.version.split()[0],
                            "cpu_count": os.cpu_count() or 1}
    if device is not None and device.type == "cuda":
        info["gpu"] = torch.cuda.get_device_name(device)
        info["gpu_power_limit"] = _power_limit()
    return info


@dataclass
class CalibrationProfile:
    """Per-host measured kernel/link costs, persistable as versioned JSON.

    ``check()`` / ``CostModel.load_profile`` reject a profile whose pool
    shape, topology, kernel-table fingerprint or schema version does not
    match the runtime it is being loaded into — stale seeds are worse than
    no seeds.
    """

    version: int = SCHEMA_VERSION
    created_unix: float = 0.0
    host: Dict[str, Any] = field(default_factory=dict)
    n_devices: int = 0
    table_fingerprint: Optional[str] = None
    topology: Optional[Dict[str, Any]] = None   # Topology.describe() snapshot
    kernels: Dict[str, KernelProfile] = field(default_factory=dict)
    links: Dict[str, LinkProfile] = field(default_factory=dict)
    skipped_kernels: List[str] = field(default_factory=list)

    # -- seeds --------------------------------------------------------------
    def kernel_seed(self, kernel: str) -> Optional[float]:
        kp = self.kernels.get(kernel)
        return kp.seconds if kp is not None else None

    def link_model(self, key: str) -> Optional[LinkModel]:
        lp = self.links.get(key)
        return lp.link_model() if lp is not None else None

    # -- staleness ----------------------------------------------------------
    def check(self, *, n_devices: Optional[int] = None,
              topology: Any = None,
              table_fingerprint: Optional[str] = None) -> None:
        """Raise :class:`StaleProfileError` unless this profile describes
        the given pool shape / topology / kernel table.  ``None`` arguments
        skip their check (the caller has nothing to compare against)."""
        problems: List[str] = []
        if self.version != SCHEMA_VERSION:
            problems.append(f"schema version {self.version} != "
                            f"{SCHEMA_VERSION}")
        if n_devices is not None and self.n_devices != n_devices:
            problems.append(f"profiled {self.n_devices} devices, pool has "
                            f"{n_devices}")
        if topology is not None or self.topology is not None:
            want = topology.describe() if topology is not None else None
            if (want is None) != (self.topology is None):
                problems.append("topology presence mismatch (profiled "
                                f"{'with' if self.topology else 'without'} "
                                "a topology)")
            elif want is not None and \
                    want["racks"] != self.topology.get("racks"):
                problems.append(f"topology racks {self.topology.get('racks')}"
                                f" != {want['racks']}")
        if (table_fingerprint is not None
                and self.table_fingerprint is not None
                and self.table_fingerprint != table_fingerprint):
            problems.append(f"kernel table fingerprint "
                            f"{self.table_fingerprint} != {table_fingerprint}")
        if problems:
            raise StaleProfileError("stale calibration profile: "
                                    + "; ".join(problems))

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.version,
            "created_unix": self.created_unix,
            "host": self.host,
            "n_devices": self.n_devices,
            "table_fingerprint": self.table_fingerprint,
            "topology": self.topology,
            "kernels": {k: v.to_dict() for k, v in self.kernels.items()},
            "links": {k: v.to_dict() for k, v in self.links.items()},
            "skipped_kernels": list(self.skipped_kernels),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationProfile":
        return cls(
            version=int(d.get("schema_version", -1)),
            created_unix=float(d.get("created_unix", 0.0)),
            host=dict(d.get("host", {})),
            n_devices=int(d.get("n_devices", 0)),
            table_fingerprint=d.get("table_fingerprint"),
            topology=d.get("topology"),
            kernels={k: KernelProfile.from_dict(v)
                     for k, v in d.get("kernels", {}).items()},
            links={k: LinkProfile.from_dict(v)
                   for k, v in d.get("links", {}).items()},
            skipped_kernels=list(d.get("skipped_kernels", [])))

    def save(self, directory: str = PROFILE_DIR,
             filename: Optional[str] = None) -> str:
        """Write ``<directory>/<hostname>.json`` (schema-versioned) and
        return the path."""
        os.makedirs(directory, exist_ok=True)
        name = filename or f"{self.host.get('hostname', 'unknown-host')}.json"
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Kernel micro-benchmarks
# ---------------------------------------------------------------------------
def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree)
               if isinstance(t, torch.Tensor))


def _on(tree: Any, device: torch.device) -> Any:
    """``tree`` with every tensor leaf copied to ``device``."""
    leaves, tdef = _tree.flatten(tree)
    return _tree.unflatten(tdef, [t.detach().to(device, copy=True)
                                  if isinstance(t, torch.Tensor) else t
                                  for t in leaves])


def _dry_run_counts(fn, args: Sequence[Any],
                    kwargs: Dict[str, Any]) -> Tuple[float, float, Any]:
    """(flops, bytes_accessed, callable) of one call of ``fn``.

    The call runs once on CPU copies of the operands, so a kernel wrapper
    takes its plain version and the aten ops are visible, under
    ``FlopCounterMode`` (matmul-class FLOPs; elementwise work counts 0).
    The bytes are the operands' plus the outputs', each once.  An entry
    that cannot run on the CPU counts (0, 0), as the reference falls back.
    """
    from torch.utils.flop_counter import FlopCounterMode
    try:
        cargs, ckwargs = _on(list(args), torch.device("cpu")), \
            _on(dict(kwargs), torch.device("cpu"))
        counter = FlopCounterMode(display=False)
        with counter:
            out = fn(*cargs, **ckwargs)
        flops = float(counter.get_total_flops())
        nbytes = float(_tensor_bytes(cargs) + _tensor_bytes(ckwargs)
                       + _tensor_bytes(out))
        return flops, nbytes, fn
    except Exception:
        return 0.0, 0.0, fn


def _pool_of(obj: Any) -> Any:
    """The :class:`DevicePool` of a pool or a runtime (None for a table)."""
    if hasattr(obj, "devices"):
        return obj
    return getattr(obj, "pool", None)


def profile_kernels(table: Any,
                    operands: Optional[Dict[str, Any]] = None,
                    *, reps: int = 5, warmup: int = 2,
                    marker: Optional[RegionMarker] = None
                    ) -> Tuple[Dict[str, KernelProfile], List[str]]:
    """Micro-benchmark every registered kernel that has example operands.

    ``table`` is a :class:`KernelTable`, a :class:`DevicePool` or a
    :class:`ClusterRuntime` (its pool's table).
    ``operands`` maps kernel name → positional tuple (or kwargs dict) of
    example arguments; kernels registered with ``example=`` supply their
    own.  Kernels with neither are skipped and reported, never guessed.

    Given a pool (or a runtime), the operands are moved to its devices'
    ``torch.device`` and each rep runs under device 0's stream, ending in
    that stream's synchronize, on device 0's ``busy_clock`` — the span an
    EXEC records.  Given a bare table, the operands stay where they are and
    the clock is ``marker``'s.

    Returns ``(profiles, skipped_names)``.
    """
    pool = _pool_of(table)
    node = pool.devices[0] if pool is not None else None
    table = pool.table if pool is not None else table
    operands = operands or {}
    if marker is None:
        marker = RegionMarker(node.busy_clock) if node is not None \
            else RegionMarker()
    context = node.stream_context if node is not None else contextlib.nullcontext
    profiles: Dict[str, KernelProfile] = {}
    skipped: List[str] = []
    for name in table.names():
        entry = table.lookup(table.index_of(name))
        ops = operands.get(name)
        if ops is None:
            example = getattr(entry, "example", None)
            ops = example() if callable(example) else example
        if ops is None:
            skipped.append(name)
            continue
        if isinstance(ops, dict):
            args, kwargs = (), ops
        elif isinstance(ops, (list, tuple)):
            args, kwargs = tuple(ops), {}
        else:
            args, kwargs = (ops,), {}
        flops, nbytes, call = _dry_run_counts(entry.fn, args, kwargs)
        if node is not None:
            args, kwargs = tuple(_on(list(args), node.device)), \
                _on(dict(kwargs), node.device)

        def run() -> None:
            with context():
                call(*args, **kwargs)
                if node is not None:
                    node.synchronize()

        for _ in range(max(warmup, 1)):     # absorb first-call costs
            run()
        for _ in range(max(reps, 1)):
            with marker.region(name):
                run()
        ts = marker.samples(name)
        profiles[name] = KernelProfile(
            name=name, seconds=float(np.median(ts)), reps=len(ts),
            min_s=float(min(ts)), max_s=float(max(ts)),
            flops=flops, bytes_accessed=nbytes)
    return profiles, skipped


# ---------------------------------------------------------------------------
# Link micro-benchmarks
# ---------------------------------------------------------------------------
def _merged(name: str, parts: Sequence[LinkProfile]) -> LinkProfile:
    samples = [s for p in parts for s in p.samples]
    latency, bandwidth = fit_alpha_beta(samples)
    return LinkProfile(name, bandwidth, latency, samples)


def profile_links(pool: Any, *, sizes: Sequence[int] = (1 << 14, 1 << 20, 1 << 23),
                  reps: int = 3, topology: Any = None
                  ) -> Dict[str, LinkProfile]:
    """Time the host funnel (per direction) and the peer fabric (per
    direction, per rack tier of ``topology``) with the pool's own wire
    operations — ``transfer_to`` / ``transfer_from`` / ``peer_copy``, what
    the runtime itself issues — on the host's wall clock.

    Every operation is tagged :data:`CALIB_TAG` and its cost records are
    discarded afterwards, so calibration never skews the makespan model of
    the run that follows it.
    """
    D = len(pool)
    raw: Dict[str, List[Tuple[int, float]]] = {}

    def sample(key: str, nbytes: int, seconds: float) -> None:
        raw.setdefault(key, []).append((nbytes, seconds))

    # -- host funnel, both directions ---------------------------------------
    dev = 0
    for size in sizes:
        n = max(size // 4, 1)
        value = torch.zeros(n, dtype=torch.float32)
        handle = pool.alloc(dev, (n,), torch.float32, tag=CALIB_TAG)
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            pool.transfer_to(dev, handle, value, tag=CALIB_TAG).result()
            sample("funnel:to", n * 4, time.perf_counter() - t0)
            t0 = time.perf_counter()
            pool.transfer_from(dev, handle, tag=CALIB_TAG)
            sample("funnel:from", n * 4, time.perf_counter() - t0)
        pool.free(dev, handle)

    # -- peer fabric: representative directed pairs per tier ----------------
    def tier_pairs() -> Dict[str, Tuple[int, int]]:
        if D < 2:
            return {}
        if topology is not None and getattr(topology, "n_racks", 1) > 1 \
                and topology.covers(*range(D)):
            pairs = {}
            rack0 = topology.members(0)
            if len(rack0) >= 2:
                pairs["peer:intra"] = (rack0[0], rack0[1])
            leaders = topology.leaders()
            pairs["peer:inter"] = (leaders[0], leaders[1])
            return pairs
        return {"peer": (0, 1)}

    for tier, (a, b) in tier_pairs().items():
        for size in sizes:
            n = max(size // 4, 1)
            value = torch.zeros(n, dtype=torch.float32)
            ha = pool.alloc(a, (n,), torch.float32, tag=CALIB_TAG)
            hb = pool.alloc(b, (n,), torch.float32, tag=CALIB_TAG)
            pool.transfer_to(a, ha, value, tag=CALIB_TAG).result()
            pool.transfer_to(b, hb, value, tag=CALIB_TAG).result()
            for _ in range(max(reps, 1)):
                t0 = time.perf_counter()
                pool.peer_copy(a, ha, b, hb, tag=CALIB_TAG).result()
                dt = time.perf_counter() - t0
                sample(f"{tier}:fwd", n * 4, dt)
                sample(tier, n * 4, dt)
                t0 = time.perf_counter()
                pool.peer_copy(b, hb, a, ha, tag=CALIB_TAG).result()
                dt = time.perf_counter() - t0
                sample(f"{tier}:rev", n * 4, dt)
                sample(tier, n * 4, dt)
            pool.free(a, ha)
            pool.free(b, hb)

    # calibration traffic must not count toward the run's cost model
    pool.cost.discard_tag(CALIB_TAG)

    links: Dict[str, LinkProfile] = {}
    for key, samples in raw.items():
        latency, bandwidth = fit_alpha_beta(samples)
        links[key] = LinkProfile(key, bandwidth, latency, samples)
    if "funnel:to" in links and "funnel:from" in links:
        links["funnel"] = _merged("funnel", [links["funnel:to"],
                                             links["funnel:from"]])
    return links


# ---------------------------------------------------------------------------
# The calibration pass
# ---------------------------------------------------------------------------
def calibrate(pool: Any, operands: Optional[Dict[str, Any]] = None, *,
              reps: int = 5, warmup: int = 2,
              sizes: Sequence[int] = (1 << 14, 1 << 20, 1 << 23),
              topology: Any = None,
              save_dir: Optional[str] = PROFILE_DIR) -> CalibrationProfile:
    """Run the full pass over ``pool`` and persist the per-host profile.

    ``operands`` supplies example arguments per kernel name (positional
    tuple or kwargs dict); kernels registered with ``example=`` bring their
    own.  ``topology`` defaults to the one installed on ``pool.cost``.
    ``save_dir=None`` skips persistence (tests, synthetic profiles).
    """
    if topology is None:
        topology = getattr(pool.cost, "topology", None)
    kernels, skipped = profile_kernels(pool, operands, reps=reps,
                                       warmup=warmup)
    links = profile_links(pool, sizes=sizes, reps=max(reps // 2, 2),
                          topology=topology)
    profile = CalibrationProfile(
        version=SCHEMA_VERSION,
        created_unix=time.time(),
        host=host_info(pool.devices[0].device),
        n_devices=len(pool),
        table_fingerprint=pool.table.fingerprint(),
        topology=topology.describe() if topology is not None else None,
        kernels=kernels, links=links, skipped_kernels=skipped)
    if save_dir is not None:
        profile.save(save_dir)
    return profile
