"""Paper Figs 8–9: sparselu — comm-bound block LU, the workload that loses.

Twin of ``benchmarks/bots_sparselu.py``: block LU over a K×K grid of B×B
blocks with the BOTS task kernels (lu0/fwd/bdiv/bmod).  Every inter-task
dependency crosses the host, so each factorization step re-sends block
operands and fetches block results — unless ``wavefront(peer=True)`` routes
them device to device over the runtime's peer fabric.  On the card the
``bmod`` tasks — the
O(n³) trailing updates — launch the hand-written CUDA kernel; the solves are
plain PyTorch.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike
from ..core import (ClusterRuntime, DagTask, KernelTable, MapSpec,
                    RuntimeConfig, TensorSpec)
from ..kernels.block_lu.ops import bdiv_op, bmod_op, fwd_op, lu0_op

SIZES = {"small": (4, 64), "large": (5, 96)}
Size = Union[str, Tuple[int, int]]


def dims(size: Size) -> Tuple[int, int]:
    """(K, B) of a named size, or the pair itself."""
    return SIZES[size] if isinstance(size, str) else tuple(size)


def factorize_serial(mat: torch.Tensor) -> torch.Tensor:
    """The whole factorization in one place (the single-node original):
    packed L\\U blocks [K, K, B, B], on ``mat``'s device."""
    K = mat.shape[0]
    blocks = {(i, j): mat[i, j] for i in range(K) for j in range(K)}
    for k in range(K):
        blocks[(k, k)] = lu0_op(blocks[(k, k)])
        for j in range(k + 1, K):
            blocks[(k, j)] = fwd_op(blocks[(k, k)], blocks[(k, j)])
        for i in range(k + 1, K):
            blocks[(i, k)] = bdiv_op(blocks[(k, k)], blocks[(i, k)])
        for i in range(k + 1, K):
            for j in range(k + 1, K):
                blocks[(i, j)] = bmod_op(blocks[(i, j)],
                                         blocks[(i, k)], blocks[(k, j)])
    return torch.stack([torch.stack([blocks[(i, j)] for j in range(K)])
                        for i in range(K)])


def _make_table(K: int) -> KernelTable:
    table = KernelTable()
    table.register("lu0", lambda a: {"out": lu0_op(a)})
    table.register("fwd", lambda lu, a: {"out": fwd_op(lu, a)})
    table.register("bdiv", lambda lu, a: {"out": bdiv_op(lu, a)})
    table.register("bmod", lambda a, l, u: {"out": bmod_op(a, l, u)})
    table.register("sparselu_serial", lambda mat: {"out": factorize_serial(mat)})
    return table


def _matrix(K: int, B: int, seed: int = 0) -> torch.Tensor:
    """The reference's diagonally dominant test matrix, on the host (the
    same numpy draws, so both packages factor the same numbers)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((K, K, B, B)).astype(np.float32)
    for i in range(K):
        m[i, i] += np.eye(B, dtype=np.float32) * (4 * B)
    return torch.from_numpy(m)


def _build_dag(mat: torch.Tensor, K: int, B: int):
    spec = TensorSpec((B, B), torch.float32)

    def blk(i, j, k):
        """Name of the task producing block (i,j) entering step k."""
        if k == 0:
            return None                          # initial matrix block
        if i == k - 1 and j == k - 1:
            return f"lu0_{k-1}"
        if i == k - 1:
            return f"fwd_{k-1}_{j}"
        if j == k - 1:
            return f"bdiv_{k-1}_{i}"
        return f"bmod_{k-1}_{i}_{j}"

    tasks = []
    for k in range(K):
        dep = blk(k, k, k)
        tasks.append(DagTask(
            f"lu0_{k}", "lu0", tuple(d for d in (dep,) if d),
            (lambda dep=dep, k=k: lambda deps: MapSpec(
                to={"a": deps[dep] if dep else mat[k, k]}, from_={"out": spec}))()))
        for j in range(k + 1, K):
            dep = blk(k, j, k)
            tasks.append(DagTask(
                f"fwd_{k}_{j}", "fwd", tuple(d for d in (f"lu0_{k}", dep) if d),
                (lambda dep=dep, k=k, j=j: lambda deps: MapSpec(
                    to={"lu": deps[f"lu0_{k}"],
                        "a": deps[dep] if dep else mat[k, j]},
                    from_={"out": spec}))()))
        for i in range(k + 1, K):
            dep = blk(i, k, k)
            tasks.append(DagTask(
                f"bdiv_{k}_{i}", "bdiv", tuple(d for d in (f"lu0_{k}", dep) if d),
                (lambda dep=dep, k=k, i=i: lambda deps: MapSpec(
                    to={"lu": deps[f"lu0_{k}"],
                        "a": deps[dep] if dep else mat[i, k]},
                    from_={"out": spec}))()))
        for i in range(k + 1, K):
            for j in range(k + 1, K):
                dep = blk(i, j, k)
                deps_t = tuple(d for d in (f"bdiv_{k}_{i}", f"fwd_{k}_{j}", dep) if d)
                tasks.append(DagTask(
                    f"bmod_{k}_{i}_{j}", "bmod", deps_t,
                    (lambda dep=dep, k=k, i=i, j=j: lambda deps: MapSpec(
                        to={"a": deps[dep] if dep else mat[i, j],
                            "l": deps[f"bdiv_{k}_{i}"],
                            "u": deps[f"fwd_{k}_{j}"]},
                        from_={"out": spec}))()))
    return tasks


def wavefront(rt: ClusterRuntime, mat: torch.Tensor, *,
              peer: bool = False) -> Dict[str, torch.Tensor]:
    """The offloaded program: the task DAG as nowait waves, with each wave's
    shared operands pinned once per device (``resident=True``).
    ``peer=True`` keeps every block on its device and moves each dependency
    device→device over the runtime's peer fabric instead of through the
    host (the DAG's edges leave the funnel; each block is fetched once at
    the end)."""
    K, _, B, _ = mat.shape
    return rt.wavefront_offload(_build_dag(mat, K, B), nowait=True,
                                resident=True, peer=peer)


def serial(rt: ClusterRuntime, mat: torch.Tensor) -> torch.Tensor:
    """The single-node original as one region on device 0."""
    return rt.target("sparselu_serial", 0, MapSpec(
        to={"mat": mat},
        from_={"out": TensorSpec(tuple(mat.shape), torch.float32)}))["out"]


def assemble(res: Dict[str, torch.Tensor], K: int) -> torch.Tensor:
    """The wavefront's final blocks [K, K, B, B]: lu0 on the diagonal, fwd
    above it, bdiv below it."""
    def final(i, j):
        if i == j:
            return res[f"lu0_{i}"]
        if i < j:
            return res[f"fwd_{i}_{j}"]
        return res[f"bdiv_{j}_{i}"]

    return torch.stack([torch.stack([final(i, j) for j in range(K)])
                        for i in range(K)])


def run(size: Size = "small", device_counts=(1, 2, 4, 8), *,
        device: DeviceLike = "cuda"):
    from .common import run_curve
    K, B = dims(size)
    mat = _matrix(K, B)
    return run_curve("sparselu", str(size), _make_table(K),
                     lambda rt, n: wavefront(rt, mat),
                     serial=lambda rt: serial(rt, mat),
                     device_counts=device_counts, device=device)


def verify(size: Size = "small", n_devices: int = 3, *,
           device: DeviceLike = "cuda") -> float:
    """Distributed factorization == serial kernel (max abs diff); expect 0.0."""
    K, B = dims(size)
    mat = _matrix(K, B)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n_devices, device=device),
                        table=_make_table(K))
    try:
        res = wavefront(rt, mat)
        ref = serial(rt, mat)
    finally:
        rt.shutdown()
    return float((assemble(res, K) - ref).abs().max())


if __name__ == "__main__":
    print("verify err:", verify("small"))
    for size in ("small", "large"):
        print(run(size).render())
