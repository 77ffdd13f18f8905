"""Batched thin QR by Cholesky-QR as a Hopper kernel.

Counterpart of ``matrixproductbp_tpu/ops/kernels.py``.  :func:`batched_cholqr`
runs its plain version (``smallalg.cholqr_unrolled``) when A lies on the CPU
and launches the CUDA kernel (``csrc/cholqr.cu``, which replaces
``_cholqr_kernel``, ``kernels.py:61``) when A lies on a CUDA device; there is
no fallback between the two.  ``batched_cholqr.launches`` counts kernel
launches.  :func:`cholqr` is the dispatcher the randomized merge calls
(``ops/randomized.py``); :func:`cholqr_reference` (``torch.linalg``) is the
tests' third opinion and is never on the sweep's path.

Both the kernel and the plain version factor float32 inputs in float64 with
the float32 jitter (see ``smallalg.cholqr_unrolled``).
"""
from __future__ import annotations

import torch

from . import build
from .smallalg import cholqr_unrolled

__all__ = ["cholqr", "batched_cholqr", "cholqr_reference", "cholqr_unrolled",
           "MAX_N"]

#: widest A the kernel takes (the column loop is sequential per instance)
MAX_N = 64


def _smem_cholqr(m: int, n: int) -> int:
    """Bytes of shared memory per block (float64 staging, ``cholqr.cu``)."""
    return 8 * (m * (n + 1) + n * (n + 1) + n)


def _threads(m: int, n: int) -> int:
    """One thread per row of A for the substitution, in whole warps."""
    return min(256, 32 * ((max(m, n) + 31) // 32))


def batched_cholqr(A: torch.Tensor, eps: float = 1e-6):
    """A [..., m, n] -> (Q [..., m, n], R [..., n, n]), A = Q R.

    CPU tensors run :func:`cholqr_unrolled`; CUDA tensors launch the kernel,
    which takes float32 or float64, contiguous A, and n <= 64."""
    if A.device.type == "cpu":
        return cholqr_unrolled(A, eps)
    if A.device.type != "cuda":
        raise ValueError(f"A must lie on the CPU or a CUDA device: {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CholQR kernel takes float32 or float64, got "
                        f"{A.dtype}")
    if A.ndim < 2:
        raise ValueError(f"A must be [..., m, n], got shape {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    *batch, m, n = A.shape
    if not 1 <= n <= MAX_N or m < 1:
        raise ValueError(f"the CholQR kernel takes 1 <= n <= {MAX_N} and "
                         f"m >= 1, got [{m}, {n}]")
    smem = _smem_cholqr(m, n)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"CholQR [{m}, {n}]: needs {smem} bytes of shared "
                         f"memory per block, over the {build.SMEM_PER_BLOCK}"
                         "-byte limit")
    Q = torch.empty_like(A)
    R = A.new_empty(tuple(batch) + (n, n))
    Bn = Q.numel() // (m * n)
    if Bn == 0:
        return Q, R
    rc = build.library("cholqr").cholqr(
        0 if A.dtype == torch.float32 else 1, A.data_ptr(), Q.data_ptr(),
        R.data_ptr(), Bn, m, n, float(eps), _threads(m, n), smem,
        torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CholQR: CUDA launch failed with error {rc}")
    batched_cholqr.launches += 1
    return Q, R


batched_cholqr.launches = 0


def cholqr(A: torch.Tensor, eps: float | None = None):
    """Thin QR for the randomized merge's projection step; ``eps`` defaults
    to the jitter of A's dtype (1e-12 for float64, 1e-6 for float32)."""
    if eps is None:
        eps = 1e-12 if A.dtype == torch.float64 else 1e-6
    return batched_cholqr(A, eps)


def cholqr_reference(A: torch.Tensor, eps: float = 1e-7):
    """``torch.linalg`` reference: A [..., m, n] -> (Q, R) with the same
    jitter rule and no pivot floors."""
    n = A.shape[-1]
    G = torch.einsum("...mi,...mj->...ij", A, A)
    tr = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).sum(-1), min=1e-30)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(G + eps * tr[..., None, None] * eye / n)
    Q = torch.linalg.solve_triangular(L.transpose(-1, -2), A, upper=True,
                                      left=False)
    return Q, L.transpose(-1, -2)
