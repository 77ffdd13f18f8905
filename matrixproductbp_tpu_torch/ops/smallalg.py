"""Unrolled small-matrix linear algebra over a leading batch.

Counterpart of ``matrixproductbp_tpu/ops/smallalg.py``: the same
Cholesky-Crout recurrence and substitutions, column by column, with the same
1e-30 floor on pivots, so the sketch solve and the Cholesky-QR agree with the
JAX package to round-off.  All functions take small trailing dims and any
leading batch.
"""
from __future__ import annotations

import torch

__all__ = ["chol_unrolled", "solve_lower_unrolled", "solve_lower_t_unrolled",
           "spd_solve_unrolled", "cholqr_unrolled"]

_FLOOR = 1e-30


def chol_unrolled(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``G [..., n, n]``."""
    n = G.shape[-1]
    idx = torch.arange(n, device=G.device)
    cols = []                                   # cols[j] = L[..., :, j]
    for j in range(n):
        v = G[..., :, j]
        for k in range(j):
            v = v - cols[k] * cols[k][..., j:j + 1]
        d = torch.sqrt(torch.clamp(v[..., j], min=_FLOOR))
        col = v / d[..., None]
        cols.append(torch.where(idx >= j, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=-1)


def solve_lower_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L Y = B`` by forward substitution; L [..., n, n], B [..., n, k]."""
    n = L.shape[-1]
    rows = []
    for i in range(n):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[..., i, k][..., None] * rows[k]
        rows.append(acc / torch.clamp(L[..., i, i][..., None], min=_FLOOR))
    return torch.stack(rows, dim=-2)


def solve_lower_t_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L^T X = B`` by back substitution; L [..., n, n] lower."""
    n = L.shape[-1]
    rows: list = [None] * n
    for i in range(n - 1, -1, -1):
        acc = B[..., i, :]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i][..., None] * rows[k]
        rows[i] = acc / torch.clamp(L[..., i, i][..., None], min=_FLOOR)
    return torch.stack(rows, dim=-2)


def spd_solve_unrolled(G: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``G X = B`` for SPD ``G [..., n, n]`` and ``B [..., n, k]``."""
    L = chol_unrolled(G)
    return solve_lower_t_unrolled(L, solve_lower_unrolled(L, B))


def cholqr_unrolled(A: torch.Tensor, eps: float | None = None):
    """Thin QR by Cholesky-QR: A [..., m, n] -> (Q [..., m, n], R [..., n, n])
    with A = Q R and R = L^T upper triangular, where L = chol(A^T A + eps *
    max(tr, 1e-30) / n * I).  The plain version of the CholQR kernel
    (``ops/kernels.py``).

    ``eps`` defaults to the jitter of A's dtype (1e-12 for float64, 1e-6 for
    float32).  float32 inputs are factored in float64 with that float32
    jitter and the results rounded back: in float32 the Gram of a low-rank A
    stays positive definite only through the jitter, and at n = 20 its
    rounding exceeds it (the JAX package's float32 ``cholqr_unrolled``
    returns non-finite Q on a rank-1 [80, 20] A).  float64 inputs take the
    JAX package's path unchanged."""
    out_dtype = A.dtype
    if eps is None:
        eps = 1e-12 if out_dtype == torch.float64 else 1e-6
    if out_dtype == torch.float32:
        A = A.double()
    n = A.shape[-1]
    G = torch.einsum("...mi,...mj->...ij", A, A)
    tr = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).sum(-1), min=_FLOOR)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L = chol_unrolled(G + (eps / n) * tr[..., None, None] * eye)
    # Q = A L^{-T}  <=>  Q^T = L^{-1} A^T
    Qt = solve_lower_unrolled(L, A.transpose(-1, -2))
    return (Qt.transpose(-1, -2).to(out_dtype),
            L.transpose(-1, -2).to(out_dtype))
