"""K5's cluster decomposition on the CPU: the plain ``ssd_cluster_ref`` (the
CUDA kernel's own steps: 64-row chunks in runs per CTA, local states from
zero, the fold in CTA order, the hi/lo bf16 pairs of its tensor-core path)
against the reference's jnp oracle ``ssd_chunked`` and its Pallas kernel in
interpret mode, and the card-free planner ``ssd_plan`` and path choice
``ssd_path``.

Inputs are numpy arrays from seeds, drawn as the reference's own test draws
them (``tests/test_kernels.py:82-87``).  Tolerances: fp32 2e-5 and bf16 4e-2
(``tests/test_kernels.py:21-25``).  The oracle and the Pallas kernel run the
kernel's chunk length (64) where S allows it, so the cumsums round alike;
the Pallas kernel halves its chunk until it divides S (S = 509: one row).
Each shape goes through the reference once (cached) and is checked under
several cluster sizes: the reference's compiles are this file's cost.  The
planner's and the path's tables are one test each, so that this file holds
fewer tests than ``tests/test_fault_tolerance.py``: pytest-xdist's
``--dist loadfile`` hands out the largest files first, and that file's
timing-sensitive test passes only when it starts early.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_chunked_pallas
from repro.models import ssm as jssm
from repro_torch.interop import to_numpy_tree
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_cluster_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (CHUNK, MAX_CLUSTER, ssd_path,
                                                   ssd_plan)

torch.set_num_threads(1)      # six test workers share the CPU

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=4e-2, atol=4e-2)}


def _inputs(seed: int, b: int, S: int, H: int, P: int, G: int, N: int, dtype: str):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B, jdt),
         jnp.asarray(C, jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(B).to(tdt), torch.from_numpy(C).to(tdt))
    return j, t


def _close(port, ref, tol):
    np.testing.assert_allclose(to_numpy_tree(port), np.asarray(ref, np.float32), **tol)


# (S, G) -> the clusters asked of it, and the plans they give: 64 → 1 CTA of
# one chunk; 300 → 2 of three, 1 of five, 5 of one; 509 → 2 of four, 3 of
# three, 4 of two, 8 of one (the planner's own for None); ragged tails
SHAPES = {(64, 2): (None,), (300, 2): (None, 1, 5), (509, 1): (None, 3, 5, 8)}
CASES = [(S, G, cluster) for (S, G), clusters in SHAPES.items() for cluster in clusters]


@functools.lru_cache(maxsize=None)
def _reference(S: int, G: int, dtype: str):
    """The torch operands of one shape, and the jnp oracle's and the Pallas
    kernel's (y, h) on the same inputs."""
    (jx, jdt, jA, jB, jC), t = _inputs(S + G, 1, S, 4, 16, G, 8, dtype)
    oracle = jssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk=CHUNK)
    pallas = ssd_chunked_pallas(jx, jdt, jA, jB, jC, chunk=CHUNK, interpret=True)
    return t, oracle, pallas


@pytest.mark.parametrize("S,G,cluster", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_cluster_ref_matches_reference(S, G, cluster, dtype):
    """The kernel's decomposition (hi/lo pairs in bf16, as its tensor-core
    path takes them) against the jnp oracle and the Pallas kernel."""
    n_cta, per = ssd_plan(S, cluster)
    assert 1 <= n_cta <= MAX_CLUSTER and (n_cta - 1) * per < -(-S // CHUNK) <= n_cta * per
    (x, dt, A, B, C), oracle, pallas = _reference(S, G, dtype)
    y, h = ssd_cluster_ref(x, dt, A, B, C, cluster=cluster, split_bf16=dtype == "bfloat16")
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (1, S, 4, 16) and tuple(h.shape) == (1, 4, 8, 16)
    for jy, jh in (oracle, pallas):
        _close(y, jy, TOL[dtype])
        _close(h, jh, TOL[dtype])


@pytest.mark.parametrize("cluster", [1, 2, 5, 8])
def test_ssd_cluster_ref_is_the_plain_scan_under_any_cluster(cluster):
    """fp32: every cluster size gives the port's own plain version at the
    kernel's chunk length, within 2e-5 (only the fold's order moves)."""
    _, (x, dt, A, B, C) = _inputs(cluster, 2, 509, 4, 16, 2, 8, "float32")
    y, h = ssd_cluster_ref(x, dt, A, B, C, cluster=cluster)
    yp, hp = ssd_chunked(x, dt, A, B, C, chunk=CHUNK)
    torch.testing.assert_close(y, yp, **TOL["float32"])
    torch.testing.assert_close(h, hp, **TOL["float32"])


def test_ssd_cluster_ref_pairs_stay_near_fp32():
    """The hi/lo pairs keep each derived operand within 2^-16 of its fp32
    value, so on fp32 inputs the split arithmetic stays within 1e-4
    relative L2 of the unsplit one (y and the final state)."""
    _, (x, dt, A, B, C) = _inputs(5, 2, 300, 4, 16, 2, 8, "float32")
    y, h = ssd_cluster_ref(x, dt, A, B, C, cluster=2)
    ys, hs = ssd_cluster_ref(x, dt, A, B, C, cluster=2, split_bf16=True)
    for got, want in ((ys, y), (hs, h)):
        assert float((got - want).norm() / want.norm()) < 1e-4
    assert not torch.equal(ys, y)


def test_ssd_plan():
    """By default about four chunks a CTA, at most eight CTAs; asked for a
    cluster, at most that many CTAs; each a run of whole 64-row chunks, none
    empty."""
    plans = {0: (1, 1), 1: (1, 1), 63: (1, 1), 64: (1, 1), 190: (1, 3), 300: (2, 3),
             509: (2, 4), 512: (2, 4), 640: (3, 4), 2048: (8, 4), 4096: (8, 8)}
    for S, plan in plans.items():
        assert ssd_plan(S) == plan, S
        for want in range(1, MAX_CLUSTER + 1):
            n_cta, per = ssd_plan(S, want)
            chunks = max(1, -(-S // CHUNK))
            assert n_cta <= want and (n_cta - 1) * per < chunks <= n_cta * per, (S, want)


def test_ssd_plan_refuses_bad_clusters():
    for bad in (0, MAX_CLUSTER + 1, 2.0):
        with pytest.raises(ValueError, match="cluster"):
            ssd_plan(512, bad)


def test_ssd_path():
    """The tensor-core path for bf16 at P = 64 (N = 64, 128), CUDA-core FMAs
    otherwise; decided from dtype, shape and strides on meta tensors, on the
    in-projection's strided slices as the mixer hands them over."""
    H, G = 4, 1
    for dtype in (torch.float32, torch.bfloat16):
        for P, N in ((64, 64), (64, 128), (16, 16)):
            for S in (1, 63, 64, 300, 509, 512, 4096):
                xbc = torch.empty(2, S, H * P + 2 * G * N, dtype=dtype, device="meta")
                x, B, _ = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
                x, B = x.reshape(2, S, H, P), B.reshape(2, S, G, N)
                want = "wgmma" if dtype == torch.bfloat16 and P == 64 else "fma"
                assert ssd_path(x, B) == want, (dtype, P, N, S)


def test_ssd_path_refuses_what_no_kernel_takes():
    x = torch.empty(1, 8, 2, 64, dtype=torch.bfloat16, device="meta")
    B = torch.empty(1, 8, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="not among"):
        ssd_path(x, torch.empty(1, 8, 1, 256, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="dtype"):
        ssd_path(x, B.float())
    with pytest.raises(ValueError, match="dtype"):
        ssd_path(x.half(), B.half())
    with pytest.raises(ValueError, match="16-byte"):
        ssd_path(x, torch.empty(1, 8, 1, 68, dtype=torch.bfloat16,
                                device="meta")[..., :64])        # rows 136 bytes apart
    with pytest.raises(ValueError, match="contiguous"):
        ssd_path(x, torch.empty(1, 8, 1, 128, dtype=torch.bfloat16,
                                device="meta")[..., ::2])
