"""Paper Figs 6–7: fib — recursive tasks, unroll-then-offload, imbalance.

Twin of ``benchmarks/bots_fib.py``.  The host expands fib's recursion until
there is at least one task per device (paper §5.5), then offloads the
subtrees; each leaf's work is proportional to its subtree's size, so the
frontier's tasks are unequal (fib(n−1) against fib(n−2) subtrees).  A leaf
is one launch of the hand-written busy-loop kernel on the card
(``csrc/busy_loop.cu``), its plain version on the CPU.  Communication is two
scalars per task.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .._device import DeviceLike
from ..core import (ClusterRuntime, KernelTable, MapSpec, RuntimeConfig,
                    TensorSpec, recursive_offload)
from ..kernels.busy_loop.ops import fib_subtree

SIZES = {"small": 8, "large": 21}       # paper: 35 vs 45, scaled


def _make_table() -> KernelTable:
    table = KernelTable()

    @table.kernel("fib_subtree")
    def fib_subtree_kernel(n):
        """n int32 scalar → {"out": fib(n) fp32}, after busy work the size
        of fib(n)'s recursion tree."""
        out, _ = fib_subtree(n)
        return {"out": out}

    return table


def split(k: int) -> Optional[List[int]]:
    return [k - 1, k - 2] if k > 2 else None


def combine(_k: int, kids: List[torch.Tensor]) -> torch.Tensor:
    return kids[0] + kids[1]


def make_maps(k: int) -> MapSpec:
    return MapSpec(to={"n": torch.tensor(k, dtype=torch.int32)},
                   from_={"out": TensorSpec((), torch.float32)})


def offloaded(rt: ClusterRuntime, n: int) -> torch.Tensor:
    """The offloaded program: unroll to one leaf per device, offload the
    leaves, fold their results on the host."""
    return recursive_offload(rt.ex, "fib_subtree", n, split, combine, make_maps,
                             nowait=False)


def serial(rt: ClusterRuntime, n: int) -> torch.Tensor:
    """The single-node original: the whole tree as one region on device 0."""
    return rt.target("fib_subtree", 0, make_maps(n))["out"]


def run(size: str = "small", device_counts=(1, 2, 4, 8), *,
        repeats: int = 3, warmup: bool = True, device: DeviceLike = "cuda"):
    from .common import run_curve
    n = SIZES[size]
    return run_curve("fib", size, _make_table(), lambda rt, _d: offloaded(rt, n),
                     serial=lambda rt: serial(rt, n), device_counts=device_counts,
                     repeats=repeats, warmup=warmup, device=device)


def verify(size: str = "small", n_devices: int = 4, *,
           device: DeviceLike = "cuda") -> bool:
    """Whether the offloaded leaves fold to the serial run's value, bit for
    bit (fib's values are integers, exact in fp32)."""
    n = SIZES[size]
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n_devices, device=device),
                        table=_make_table())
    try:
        return bool(torch.equal(offloaded(rt, n), serial(rt, n)))
    finally:
        rt.shutdown()


if __name__ == "__main__":
    for size in ("small", "large"):
        print(run(size).render())
