"""Plain PyTorch version of the BOTS fib leaf (``csrc/busy_loop.cu``).

The same fp32 operations, in the same order, as the JAX table kernel
``fib_subtree(n)`` of ``benchmarks/bots_fib.py``: fib(n) by n fp32 steps of
(a, b) -> (b, a + b); ``iters = (2 fib(n) - 1) * 600`` (the size of fib's
recursion tree, times the work per call); ``iters`` dependent steps of
``acc * 1.0000001 + 1e-7`` on 128 lanes, each operation rounded to fp32;
the lanes' sum folded into the output (an infinite sum would add 1; the sum
is finite, so the output is fib(n)).  The loop runs on the CPU, one step at
a time: nothing in it can be batched.
"""
from __future__ import annotations

from typing import Tuple

import torch

WORK_PER_CALL = 600     # busy steps per simulated recursive call
LANES = 128             # the width of the busy accumulator
MUL, ADD = 1.0000001, 1e-7

_F32 = torch.float32


def fib_f32(n: int) -> torch.Tensor:
    """fib(n) as a 0-dim fp32 tensor, by n steps of (a, b) -> (b, a + b)."""
    a, b = torch.zeros((), dtype=_F32), torch.ones((), dtype=_F32)
    for _ in range(max(n, 0)):
        a, b = b, a + b
    return a


def busy_iters(fib_n: torch.Tensor) -> int:
    """The busy steps of a leaf whose result is ``fib_n``: (2 fib(n) - 1)
    calls of ``WORK_PER_CALL`` steps, in fp32, truncated to int32."""
    calls = 2.0 * fib_n - 1.0
    return int((calls * WORK_PER_CALL).to(torch.int32))


def busy_loop_ref(iters: int) -> torch.Tensor:
    """``iters`` steps of acc = acc * 1.0000001 + 1e-7 from acc = 1 on
    ``LANES`` fp32 lanes (the multiply and the add rounded apart)."""
    acc = torch.ones(LANES, dtype=_F32)
    mul, add = torch.tensor(MUL, dtype=_F32), torch.tensor(ADD, dtype=_F32)
    for _ in range(iters):
        torch.mul(acc, mul, out=acc)
        torch.add(acc, add, out=acc)
    return acc


def fib_subtree_ref(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """n (a CPU int32 scalar tensor) -> (fib(n) as fp32 with the busy
    loop's result folded in, the busy accumulator [LANES])."""
    fib_n = fib_f32(int(n))
    acc = busy_loop_ref(busy_iters(fib_n))
    fold = torch.where(torch.isinf(acc.sum()), 1.0, 0.0).to(_F32)
    return fib_n + fold, acc
