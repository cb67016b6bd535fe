"""Paper Figs 2–3: protein alignment — embarrassingly parallel, tiny comm.

Twin of ``benchmarks/bots_alignment.py``: every query sequence is scored
against every reference with a banded Smith-Waterman-style DP (O(L²) per
pair, batched over all pairs, a loop over the L rows); the output is one
score row per query.  The reference bank and the scoring matrix are
invariant and go resident once per device (paper §5.3: "can be sent once at
each device at the beginning of the execution"); per strip only the query
slice moves.  Plain PyTorch ops, on the card or the CPU: the reference's
kernel is plain jnp too.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .._device import DeviceLike
from ..core import (ClusterRuntime, KernelTable, MapSpec, RuntimeConfig,
                    TensorSpec, offload_strips, sec)

L = 64          # sequence length
AA = 24         # alphabet
SIZES = {"small": (32, 16), "large": (128, 32)}      # (queries, references)
GAP = 0.5


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The in-row scan's operator: a gap from the left costs 0.5."""
    return torch.maximum(a - GAP, b)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty(*even.shape[:-1], even.shape[-1] + odd.shape[-1])
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def gap_scan(x: torch.Tensor, fn: Callable = _gap) -> torch.Tensor:
    """Inclusive scan of ``fn`` along the last axis, combining in the order
    of ``jax.lax.associative_scan``: pairs reduced, the scan of the reduced
    half, then the even elements (``fn`` is not associative, so the order
    sets the bits)."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = gap_scan(fn(x[..., 0:n - 1:2], x[..., 1::2]), fn)
    even = fn(odd[..., :-1] if n % 2 == 0 else odd, x[..., 2::2])
    return _interleave(torch.cat([x[..., :1], even], dim=-1), odd)


def align_scores(queries: torch.Tensor, refs: torch.Tensor,
                 subst: torch.Tensor) -> torch.Tensor:
    """queries [m, L] int32, refs [R, L] int32, subst [AA, AA] fp32 →
    [m, R] best local-alignment scores (an affine-gap-free band)."""
    sub = subst[queries.long()[:, None, :, None], refs.long()[None, :, None, :]]
    prev = sub.new_zeros(sub.shape[:2] + (L,))          # [m, R, L]
    best = None
    for i in range(L):
        shifted = torch.cat([prev.new_zeros(prev.shape[:2] + (1,)), prev[..., :-1]], -1)
        cur = gap_scan(torch.clamp_min(shifted + sub[:, :, i], 0.0))
        row_best = cur.amax(-1)
        best = row_best if best is None else torch.maximum(best, row_best)
        prev = torch.maximum(cur, prev - GAP)
    return best


def _make_table() -> KernelTable:
    table = KernelTable()
    table.register("align_strip",
                   lambda queries, refs, subst: {"out": align_scores(queries, refs, subst)})
    return table


def _data(m: int, R: int, seed: int = 0
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Queries, references and the scoring matrix, on the host, drawn as
    the reference draws them."""
    rng = np.random.default_rng(seed)
    queries = rng.integers(0, AA, (m, L)).astype(np.int32)
    refs = rng.integers(0, AA, (R, L)).astype(np.int32)
    subst = (rng.standard_normal((AA, AA)) + 2 * np.eye(AA)).astype(np.float32)
    return torch.from_numpy(queries), torch.from_numpy(refs), torch.from_numpy(subst)


def offloaded(rt: ClusterRuntime, queries, refs, subst) -> torch.Tensor:
    """The offloaded program: refs and subst resident on every device (the
    one-shot broadcast of §5.3; repeated runs over one pool send them no
    more), one strip of queries per device."""
    m, R = queries.shape[0], refs.shape[0]
    for d in range(len(rt.pool)):
        rt.ex.ensure_resident(d, refs=refs, subst=subst)

    def make_maps(start, length):
        return MapSpec(to={"queries": sec(queries, start, length),
                           "refs": refs, "subst": subst},
                       from_={"out": TensorSpec((length, R), torch.float32)})

    return offload_strips(rt.ex, "align_strip", m, make_maps, nowait=False)


def serial(rt: ClusterRuntime, queries, refs, subst) -> torch.Tensor:
    """The single-node original: every query in one region on device 0."""
    m, R = queries.shape[0], refs.shape[0]
    rt.ex.ensure_resident(0, refs=refs, subst=subst)
    return rt.target("align_strip", 0, MapSpec(
        to={"queries": queries, "refs": refs, "subst": subst},
        from_={"out": TensorSpec((m, R), torch.float32)}))["out"]


def run(size: str = "small", device_counts=(1, 2, 4, 8), *,
        repeats: int = 3, warmup: bool = True, device: DeviceLike = "cuda"):
    from .common import run_curve
    data = _data(*SIZES[size])
    return run_curve("alignment", size, _make_table(),
                     lambda rt, _d: offloaded(rt, *data),
                     serial=lambda rt: serial(rt, *data),
                     device_counts=device_counts, repeats=repeats,
                     warmup=warmup, device=device)


def verify(size: str = "small", n_devices: int = 4, *,
           device: DeviceLike = "cuda") -> bool:
    """Whether the strips equal the serial run's scores, bit for bit."""
    data = _data(*SIZES[size])
    rt = ClusterRuntime(RuntimeConfig(n_virtual=n_devices, device=device),
                        table=_make_table())
    try:
        return bool(torch.equal(offloaded(rt, *data), serial(rt, *data)))
    finally:
        rt.shutdown()


if __name__ == "__main__":
    for size in ("small", "large"):
        print(run(size).render())
