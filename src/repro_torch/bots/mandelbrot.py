"""Paper Figs 4–5: mandelbrot — compute ∝ pixels·iter, comm ∝ pixels.

Twin of ``benchmarks/bots_mandelbrot.py``.  Each device renders a strip of
rows (paper §5.4); the only communication is the row ids going out and the
strip coming back (``map(from:...)``).  The table kernel ``mandel_strip``
takes global row ids, so one kernel serves every strip; on the card it
launches the hand-written CUDA kernel, on the CPU its plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._device import DeviceLike
from ..core import (ClusterRuntime, KernelTable, MapSpec, RuntimeConfig,
                    TensorSpec, offload_strips, sec)
from ..kernels.mandelbrot.ops import mandelbrot_rows

SIZES = {"small": 416, "large": 832}
MAX_ITER = 300


def _make_table(width: int, total_height: int, max_iter: int) -> KernelTable:
    table = KernelTable()

    @table.kernel("mandel_strip")
    def mandel_strip(rows):
        """rows [n] int32 (global row ids) → {"out": [n, width] counts}."""
        return {"out": mandelbrot_rows(rows, width, total_height, max_iter)}

    return table


def all_rows(height: int) -> torch.Tensor:
    """Global row ids of the image, on the host."""
    return torch.arange(height, dtype=torch.int32)


def strips(rt: ClusterRuntime, rows: torch.Tensor, width: int, *,
           nowait: bool = False) -> torch.Tensor:
    """The offloaded program: one strip of ``rows`` per device."""
    def make_maps(start, length):
        return MapSpec(to={"rows": sec(rows, start, length)},
                       from_={"out": TensorSpec((length, width), torch.int32)})

    return offload_strips(rt.ex, "mandel_strip", rows.shape[0], make_maps,
                          nowait=nowait)


def serial(rt: ClusterRuntime, rows: torch.Tensor, width: int) -> torch.Tensor:
    """The single-node original: the whole image as one region on device 0."""
    return rt.target("mandel_strip", 0, MapSpec(
        to={"rows": rows},
        from_={"out": TensorSpec((rows.shape[0], width), torch.int32)}))["out"]


def run(size: str = "small", device_counts=(1, 2, 4, 8), *,
        device: DeviceLike = "cuda"):
    from .common import run_curve
    H = W = SIZES[size]
    table = _make_table(W, H, MAX_ITER)
    rows = all_rows(H)
    return run_curve("mandelbrot", size, table,
                     lambda rt, n: strips(rt, rows, W),
                     serial=lambda rt: serial(rt, rows, W),
                     device_counts=device_counts, device=device)


def verify(size: str = "small", n_devices: int = 4, *,
           device: DeviceLike = "cuda") -> Tuple[int, float]:
    """(mismatched pixels, share) between the strips and the serial image;
    expect (0, 0.0): every pixel runs the same computation either way."""
    H = W = SIZES[size]
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n_devices, device=device),
                        table=_make_table(W, H, MAX_ITER))
    try:
        rows = all_rows(H)
        diff = strips(rt, rows, W) != serial(rt, rows, W)
    finally:
        rt.shutdown()
    return int(diff.sum()), float(diff.float().mean())


if __name__ == "__main__":
    for size in ("small", "large"):
        print(run(size).render())
