"""Plain PyTorch version of the SSD chunked-scan kernel (K5).

The port's own copy of the reference's jnp SSD: ``segsum`` and
``ssd_chunked`` (``repro/models/ssm.py``), which the reference's models run
and which its Pallas kernel is held against, plus the kernel-layout
``ssd_scan_ref`` and the sequential recurrence ``ssd_naive_ref``
(``repro/kernels/ssd_scan/ref.py``).

The dtypes are the reference's.  JAX promotes a bf16 operand against an
fp32 one to fp32, and ``preferred_element_type=float32`` gives the scores in
fp32: here every product is taken on fp32 upcasts (a torch bf16 matmul would
round its output to bf16).  The state entering a chunk is rounded to the
projections' dtype before the inter-chunk term (``h_prev.astype(Ch.dtype)``),
and ``y`` is rounded once to x's dtype.  A ragged tail is zero-padded: dt = 0
decays nothing and adds nothing, so the final state is exact.

The cumulative sums of dt·A are taken in the order XLA takes ``jnp.cumsum``
on the CPU (:func:`cumsum`: sequential within blocks of 16, the blocks'
totals scanned the same way, recursively), so that the plain version rounds
as the reference does: over a chunk of 128 or 256 steps the sums reach ~100
and any other order moves them by ulps of that size, which the exponentials
carry into y.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


SCAN_BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last dim, one rounding per step in x's
    dtype (``torch.cumsum`` accumulates fp32 in fp64 on the CPU)."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _sequential_cumsum(x)
    xp = F.pad(x, (0, -n % SCAN_BLOCK))
    local = _sequential_cumsum(xp.reshape(*x.shape[:-1], -1, SCAN_BLOCK))
    before = F.pad(_blocked_cumsum(local[..., -1])[..., :-1], (1, 0))
    return (before[..., None] + local).reshape(*x.shape[:-1], -1)[..., :n]


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum along ``dim`` in XLA's CPU order: sequential within
    blocks of 16, each block offset by the scan of the blocks' totals."""
    return _blocked_cumsum(x.movedim(dim, -1)).movedim(-1, dim)


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[i,j] = sum_{j<t<=i} log_a[t] (j<=i).

    log_a: [..., Q]; returns [..., Q, Q] with -inf above the diagonal.
    """
    Q = log_a.shape[-1]
    cum = cumsum(log_a, dim=-1)                              # [..., Q]
    diff = cum[..., :, None] - cum[..., None, :]             # sum_{j<t<=i}
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  [b, S, H, P]   inputs per head
    dt: [b, S, H]      positive step sizes (softplus'd), fp32
    A:  [H]            negative decay rates, fp32
    B:  [b, S, G, N]   input projections (G groups, H % G == 0)
    C:  [b, S, G, N]   output projections
    h0: [b, H, N, P]   optional initial state
    Returns (y [b,S,H,P] in x's dtype, h_final [b,H,N,P] fp32).
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    S_pad = x.shape[1]
    nc, Q = S_pad // chunk, chunk
    rep = H // G
    f32 = torch.float32

    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, G, N)
    Cc = C.reshape(b, nc, Q, G, N)

    log_a = dtc * A                                          # [b,nc,Q,H] (A<0)
    L = torch.exp(segsum(log_a.movedim(-1, -2)))             # [b,nc,H,Q,Q]

    Bh = Bc.repeat_interleave(rep, dim=3)                    # [b,nc,Q,H,N]
    Ch = Cc.repeat_interleave(rep, dim=3)
    xdt = xc.to(f32) * dtc[..., None]                        # dt-weighted input

    # intra-chunk (quadratic within chunk)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch.to(f32), Bh.to(f32))
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xdt)

    # chunk-final states: sum_j a(j->end) * B_j ⊗ xdt_j
    cum = cumsum(log_a, dim=2)
    a_end = torch.exp(cum[:, :, -1:] - cum)                  # [b,nc,Q,H]
    states = torch.einsum("bcqhn,bcqhp->bchnp", Bh.to(f32) * a_end[..., None], xdt)

    # inter-chunk recurrence over nc chunks
    a_chunk = torch.exp(log_a.sum(dim=2))                    # [b,nc,H]
    h = (torch.zeros(b, H, N, P, dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * a_chunk[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(entering, dim=1)                    # [b,nc,H,N,P]

    # inter-chunk contribution: C_t · (a(start->t) * h_prev), the state
    # rounded to the projections' dtype as the reference does
    a_in = torch.exp(cum)                                    # start->t inclusive
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch.to(f32) * a_in[..., None],
                           h_prev.to(Ch.dtype).to(f32))
    y = (y_intra + y_inter).reshape(b, S_pad, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel layout: x [BH, S, P]; dt [BH, S]; A [BH]; B, C [BH, S, N].

    Each BH row is a head of its own group (G = H = BH) of one
    :func:`ssd_chunked` batch entry, so every row keeps its own A.
    """
    S = x.shape[1]
    y, h = ssd_chunked(x.transpose(0, 1)[None], dt.transpose(0, 1)[None], A,
                       B.transpose(0, 1)[None], C.transpose(0, 1)[None],
                       chunk=min(chunk, S))
    return y[0].transpose(0, 1), h[0]


def ssd_naive_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(S·N·P) sequential recurrence in fp32, kernel layout — the ground
    truth for small shapes.  Returns (y [BH,S,P], h [BH,N,P])."""
    BH, S, P = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    x, dt, B, C = (t.to(f32) for t in (x, dt, B, C))
    h = torch.zeros(BH, N, P, dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)                          # [BH]
        h = h * a[:, None, None] + dt[:, t, None, None] * (B[:, t, :, None] * x[:, t, None, :])
        ys.append(torch.einsum("bn,bnp->bp", C[:, t], h))
    return torch.stack(ys, dim=1), h
