"""Interpolation (counterpart of gps_jamming_tpu.ops.interp).

Lagrange polynomial interpolation matching the reference's `interp1`
(sdrcmn.c:442-504), used for observable alignment in measurement sync
(sdrsync.c:47-93).
"""
from __future__ import annotations

import torch


def lagrange_interp(x: torch.Tensor, y: torch.Tensor, xq) -> torch.Tensor:
    """Lagrange interpolation of y(x) at query points xq.

    x: (n,) strictly monotonic sample locations; y: (..., n) values; xq: a
    scalar or (...,) queries, on x's device. Full-order polynomial through
    all points, the scheme of sdrcmn.c:442-504 (which uses the whole ring
    window)."""
    xq = torch.as_tensor(xq, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    diffs = xq[..., None] - x                                  # (..., n)
    denom = torch.where(eye, one, x[:, None] - x[None, :])     # (n, n)
    # L_j(xq) = prod_{k != j} (xq - x_k) / (x_j - x_k)
    num = torch.where(eye, one, diffs[..., None, :])           # (..., n, n)
    basis = num.prod(dim=-1) / denom.prod(dim=-1)
    return (y * basis).sum(dim=-1)
