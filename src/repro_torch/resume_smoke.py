"""Kill and resume: checkpoint a sparselu run mid-graph, resume it in a fresh
interpreter, and hold the factorization bit for bit.

Twin of ``benchmarks/resume_smoke.py`` for the port.  :func:`run` runs the
BOTS sparselu DAG over the peer fabric under locality three times:

1. uninterrupted (unless the caller hands in the factorization to hold the
   resume to, ``reference=``);
2. under a :class:`~repro_torch.core.GraphCheckpoint` that saves every wave
   (``keep=2``) and halts after ``waves // 2`` saves, a coordinator killed
   at a wave boundary;
3. resumed with ``resume_from=`` in a new interpreter (``sys.executable
   -c``, ``PYTHONPATH`` at this package's source tree, ``jax`` and
   ``repro`` made unimportable), on the parent's device.

The child skips the completed prefix (its EXEC count says so), runs the
tail and writes its outputs with ``save_pytree``, which the parent reads
back and compares bit for bit.

Run it as ``PYTHONPATH=src python -m repro_torch.resume_smoke
[--device cpu] [--K 4 --B 32 --D 4]``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from ._device import DeviceLike, resolve_device
from .bots import sparselu as bl
from .checkpoint.manager import (latest_step, read_manifest, restore_pytree,
                                 torch_dtype)
from .core import (ClusterRuntime, GraphCheckpoint, GraphInterrupted,
                   RuntimeConfig, TaskGraph, TensorSpec)

_CHILD = r"""
import json, sys, time
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
from repro_torch.bots import sparselu as bl
from repro_torch.checkpoint import save_pytree
from repro_torch.core import ClusterRuntime, RuntimeConfig
from repro_torch.kernels.block_lu import block_lu as k2

K, B, D, ckdir, outdir, device = {K}, {B}, {D}, {ckdir!r}, {outdir!r}, {device!r}
mat = bl._matrix(K, B)
rt = ClusterRuntime(RuntimeConfig(n_virtual=D), table=bl._make_table(K),
                    device=device)
try:
    t0 = time.perf_counter()
    res = rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True, peer=True,
                               policy="locality", tag="sparselu",
                               resume_from=ckdir)
    wall = time.perf_counter() - t0
    # pool.trace keeps every command; stream_traces are bounded ring buffers
    execs = sum(1 for c in rt.pool.trace if c.op == "EXEC")
    s = rt.cost.summary()
finally:
    rt.shutdown()
save_pytree(outdir, 0, res)
print(json.dumps({{"execs": execs, "resume_wall_s": wall,
                  "bytes_to": s["bytes_to"], "bytes_from": s["bytes_from"],
                  "bmod_path_launches": {{p: c.count
                                         for p, c in k2.path_launches.items()}}}}))
"""


def _runtime(K: int, D: int, device) -> ClusterRuntime:
    return ClusterRuntime(RuntimeConfig(n_virtual=D), table=bl._make_table(K),
                          device=device)


def run(K: int = 4, B: int = 32, D: int = 4, ckdir: Optional[str] = None, *,
        device: DeviceLike = "cuda",
        reference: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The drill; returns the reference's row (``K``, ``B``, ``devices``,
    ``tasks``, ``waves_total``, ``waves_before_kill``,
    ``tasks_completed_at_kill``, ``execs_resumed``, ``identical``) and the
    port's own fields: the child's K2 launches by path, its ``bytes_to`` /
    ``bytes_from`` and walls, the saves' count, seconds and bytes, the last
    snapshot's bytes, and the parent's walls.

    ``identical`` compares every task output with the uninterrupted run's;
    with ``reference`` (the factorization's final blocks ``[K, K, B, B]``,
    the serial kernel's, say) the uninterrupted run is skipped and the
    resumed run's final blocks are compared with it instead.  Raises if the
    child fails, if the resume diverges, or if it ran the whole graph again.
    """
    dev = resolve_device(device)
    mat = bl._matrix(K, B)
    graph = TaskGraph.from_tasks(bl._build_dag(mat, K, B))
    n_waves = len(graph.waves())
    kill_at = max(1, n_waves // 2)
    tmp = None
    if ckdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="resume_smoke_")
        ckdir = os.path.join(tmp.name, "ck")
    try:
        row: Dict[str, Any] = {"uninterrupted_wall_s": None}
        ref = None
        if reference is None:
            rt = _runtime(K, D, dev)
            try:
                t0 = time.perf_counter()
                ref = rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True,
                                           peer=True, policy="locality",
                                           tag="sparselu")
                row["uninterrupted_wall_s"] = time.perf_counter() - t0
            finally:
                rt.shutdown()

        # the "killed" run: a checkpoint every wave, halted at the midpoint
        ck = GraphCheckpoint(ckdir, every_waves=1, keep=2, halt_after=kill_at)
        rt = _runtime(K, D, dev)
        t0 = time.perf_counter()
        try:
            rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True, peer=True,
                                 policy="locality", tag="sparselu", checkpoint=ck)
            raise AssertionError("halt_after did not interrupt the run")
        except GraphInterrupted:
            pass
        finally:
            killed_wall = time.perf_counter() - t0
            rt.shutdown()
        manifest = read_manifest(ckdir, latest_step(ckdir))
        extra = manifest["extra"]
        snapshot_bytes = sum(TensorSpec(m["shape"], torch_dtype(m["dtype"])).nbytes
                             for m in manifest["leaves"].values())

        # the resume, in a new interpreter on the parent's device
        outdir = os.path.join(os.path.dirname(os.path.abspath(ckdir)), "resumed")
        child = _CHILD.format(K=K, B=B, D=D, ckdir=ckdir, outdir=outdir,
                              device=str(dev))
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", child], env=env,
                              capture_output=True, text=True, timeout=480)
        child_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"resume child failed:\n{proc.stderr}")
        payload = json.loads(proc.stdout.strip().splitlines()[-1])
        resumed, _, _ = restore_pytree(
            outdir, template={t.name: TensorSpec((B, B), torch.float32)
                              for t in graph}, device="cpu")

        if ref is not None:
            identical = all(torch.equal(resumed[name], v) for name, v in ref.items())
        else:
            identical = torch.equal(bl.assemble(resumed, K), reference.cpu())
        if not identical:
            raise AssertionError("the resumed run diverged from the uninterrupted run")
        if payload["execs"] >= len(graph):
            raise AssertionError(f"the resume re-executed the whole graph "
                                 f"({payload['execs']} EXECs, {len(graph)} tasks)")
        row.update({
            "K": K, "B": B, "devices": D, "tasks": len(graph),
            "waves_total": n_waves, "waves_before_kill": extra["wave"] + 1,
            "tasks_completed_at_kill": len(extra["completed"]),
            "execs_resumed": payload["execs"], "identical": identical,
            "device": str(dev), "killed_wall_s": killed_wall,
            "saves": ck.saves, "save_s": ck.save_s, "bytes_written": ck.bytes_written,
            "snapshot_bytes": snapshot_bytes, "child_wall_s": child_wall,
            "child_resume_wall_s": payload["resume_wall_s"],
            "child_bytes_to": payload["bytes_to"],
            "child_bytes_from": payload["bytes_from"],
            "child_bmod_path_launches": payload["bmod_path_launches"]})
        return row
    finally:
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--B", type=int, default=32)
    ap.add_argument("--D", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(run(args.K, args.B, args.D, device=args.device)))
