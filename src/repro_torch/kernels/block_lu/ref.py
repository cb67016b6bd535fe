"""Plain PyTorch versions of the sparselu block kernels (BOTS semantics).

``bmod`` is the plain version of the CUDA kernel; ``lu0``, ``fwd`` and
``bdiv`` are plain PyTorch in the port as ``repro``'s are jnp (they are
O(n²)-per-column solves, not Pallas kernels).  Results are contiguous, as
the CUDA ``bmod`` requires of its operands.
"""
from __future__ import annotations

import threading

import torch

_linalg_lock = threading.Lock()
_linalg_ready = False


def _solve_triangular(A: torch.Tensor, B: torch.Tensor, **kw) -> torch.Tensor:
    """``torch.linalg.solve_triangular``, whose first CUDA call is serialized.

    PyTorch loads its CUDA linear-algebra library lazily on the first call,
    and two threads making that first call together fail ("lazy wrapper
    should be called at most once"); the virtual devices' workers do exactly
    that.  One call under a lock loads it; later calls run concurrently.
    """
    global _linalg_ready
    if A.is_cuda and not _linalg_ready:
        with _linalg_lock:
            if not _linalg_ready:
                out = torch.linalg.solve_triangular(A, B, **kw)
                _linalg_ready = True
                return out
    return torch.linalg.solve_triangular(A, B, **kw)


def bmod_ref(a: torch.Tensor, l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Trailing update A − L·U, accumulated in fp32, returned in A's dtype."""
    return (a.to(torch.float32)
            - l.to(torch.float32) @ u.to(torch.float32)).to(a.dtype)


def lu0_ref(a: torch.Tensor) -> torch.Tensor:
    """Unpivoted dense LU of a diagonal block, packed L\\U in one matrix.

    A column loop: scale the column below the pivot into L's factors, then
    subtract their outer product with the pivot row from the trailing block
    — per element the reference's ``m[i,j] - f[i]*m[k,j]``.
    """
    m = a.to(torch.float32).clone()
    n = m.shape[0]
    for k in range(n - 1):
        m[k + 1:, k] /= m[k, k]
        m[k + 1:, k + 1:] -= torch.outer(m[k + 1:, k], m[k, k + 1:])
    return m.to(a.dtype)


def _unpack(lu: torch.Tensor):
    l = torch.tril(lu, -1) + torch.eye(lu.shape[0], dtype=lu.dtype, device=lu.device)
    u = torch.triu(lu)
    return l, u


def fwd_ref(diag_lu: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Forward solve: L · X = A (L unit-lower from packed LU)."""
    l, _ = _unpack(diag_lu.to(torch.float32))
    x = _solve_triangular(l, a.to(torch.float32), upper=False,
                          unitriangular=True)
    return x.to(a.dtype).contiguous()


def bdiv_ref(diag_lu: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Right solve: X · U = A (U upper from packed LU)."""
    _, u = _unpack(diag_lu.to(torch.float32))
    x = _solve_triangular(u, a.to(torch.float32), upper=True, left=False)
    return x.to(a.dtype).contiguous()
