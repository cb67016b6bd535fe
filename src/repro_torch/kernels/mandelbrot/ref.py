"""Plain PyTorch version of the mandelbrot strip kernel.

The same fp32 operations, in the same order, as the JAX table kernel
``mandel_strip(rows)`` of ``benchmarks/bots_mandelbrot.py``: every pixel runs
all ``max_iter`` iterations under an "alive" mask.  It runs on any device;
the tests use it on the CPU and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.  :func:`mandelbrot_chunked_ref` takes the CUDA
kernel's own steps (chunked escape tests with an exact replay), so the CPU
tests can hold that decomposition against the plain version; it shares no
code with :func:`mandelbrot_rows_ref`.
"""
from __future__ import annotations

import torch

XMIN, XMAX, YMIN, YMAX = -2.0, 0.6, -1.3, 1.3


def mandelbrot_rows_ref(rows: torch.Tensor, width: int, total_height: int,
                        max_iter: int, *, xmin: float = XMIN, xmax: float = XMAX,
                        ymin: float = YMIN, ymax: float = YMAX) -> torch.Tensor:
    """Escape-time counts int32 [len(rows), width] for global row ids ``rows``
    of a ``total_height`` x ``width`` image of [xmin,xmax]×[ymin,ymax]."""
    dev = rows.device
    cols = torch.arange(width, device=dev)[None, :]
    # a Python-float step times an fp32 index computes in fp32, as JAX's
    # weakly typed scalar does
    cx = xmin + cols.to(torch.float32) * ((xmax - xmin) / (width - 1))
    cy = ymin + rows[:, None].to(torch.float32) * ((ymax - ymin) / (total_height - 1))
    shape = (rows.shape[0], width)
    zx = torch.zeros(shape, dtype=torch.float32, device=dev)
    zy = torch.zeros(shape, dtype=torch.float32, device=dev)
    count = torch.zeros(shape, dtype=torch.int32, device=dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        zx2, zy2 = zx * zx, zy * zy
        alive = alive & (zx2 + zy2 <= 4.0)
        nzx = zx2 - zy2 + cx
        nzy = 2.0 * zx * zy + cy
        zx = torch.where(alive, nzx, zx)
        zy = torch.where(alive, nzy, zy)
        count = count + alive.to(torch.int32)
    return count


def mandelbrot_chunked_ref(rows: torch.Tensor, width: int, total_height: int,
                           max_iter: int, chunk: int) -> torch.Tensor:
    """The counts as ``csrc/mandelbrot.cu`` computes them, over the default
    plane: the first ``max_iter mod chunk`` iterations one test each, then
    ``chunk`` iterations at a time with the escape test only at each
    chunk's end; the chunk that fails it is replayed from its start one
    test at a time.  Equal to :func:`mandelbrot_rows_ref` wherever escape
    is permanent."""
    dev = rows.device
    shape = (rows.shape[0], width)
    x = torch.arange(width, device=dev).to(torch.float32)[None, :]
    y = rows.to(torch.float32)[:, None]
    cx = (XMIN + x * ((XMAX - XMIN) / (width - 1))).expand(shape)
    cy = (YMIN + y * ((YMAX - YMIN) / (total_height - 1))).expand(shape)

    def one_test_each(zx, zy, todo):
        """Iterations from z, each after the test, ``todo`` [per pixel] of
        them at most: the count that found z alive, and z where it stopped."""
        count = torch.zeros(shape, dtype=torch.int32, device=dev)
        alive = todo > 0
        for _ in range(int(todo.max()) if todo.numel() else 0):
            zx2, zy2 = zx * zx, zy * zy
            alive = alive & (zx2 + zy2 <= 4.0) & (count < todo)
            zx, zy = (torch.where(alive, zx2 - zy2 + cx, zx),
                      torch.where(alive, 2.0 * zx * zy + cy, zy))
            count = count + alive.to(torch.int32)
        return count, zx, zy

    head = torch.full(shape, max_iter % chunk, dtype=torch.int32, device=dev)
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    count, zx, zy = one_test_each(zero, zero, head)
    done = count < head                         # escaped within the head
    replay = torch.zeros_like(done)
    zx2, zy2 = zx * zx, zy * zy
    sx, sy = zx, zy                             # z at the escaped chunk's start
    for _ in range(max_iter // chunk):
        tx, ty, tx2, ty2 = zx, zy, zx2, zy2
        for _ in range(chunk):                  # no test inside a chunk
            tx, ty = tx2 - ty2 + cx, 2.0 * tx * ty + cy
            tx2, ty2 = tx * tx, ty * ty
        esc = ~done & ~(tx2 + ty2 <= 4.0)
        ok = ~done & ~esc
        sx, sy = torch.where(esc, zx, sx), torch.where(esc, zy, sy)
        zx, zy = torch.where(ok, tx, zx), torch.where(ok, ty, zy)
        zx2, zy2 = torch.where(ok, tx2, zx2), torch.where(ok, ty2, zy2)
        count = count + ok.to(torch.int32) * chunk
        replay, done = replay | esc, done | esc
    return count + one_test_each(sx, sy, torch.where(replay, chunk, 0).to(torch.int32))[0]
