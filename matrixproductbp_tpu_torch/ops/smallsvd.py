"""Batched thin SVD of small float32 matrices on the card, through the Gram
matrix in float64 and a hand-written batched Jacobi eigensolver.

The JAX package calls ``jnp.linalg.svd`` (XLA, outside Pallas) on thousands
of small matrices per time step of every SVD sweep.  On the card,
``torch.linalg.svd`` runs those batched only up to 32 x 32 (cuSOLVER's
batched Jacobi); the sweeps' matrices are [80, 20] and [20, 40] at D=10 and
[160, 40] and [40, 80] at D=20, and larger ones run one matrix per launch.
:func:`svd_by_gram` takes float32 ``M [..., m, n]`` with k = min(m, n) <= 64:
it forms the k x k Gram matrix in float64, factors it with :func:`eigh_desc`
and derives the other side's vectors by one product.  In float64 the
Gram's rounding (~1e-16 of its norm) resolves singular values down to
~1e-8 of the largest, below float32's own resolution; singular values under
``RTOL`` times the largest are set to zero together with the vectors derived
from them, which keeps those vectors finite.

:func:`eigh_desc` launches the CUDA kernel (``csrc/jacobi_eigh.cu``) on a
CUDA tensor and runs its plain version (``torch.linalg.eigh``, reordered) on
a CPU tensor; ``eigh_desc.launches`` counts kernel launches.  The kernel
gives one warp to each matrix up to k = 32 and two warps above, several
matrices to a block; A lives in the warp's own slice of shared memory and
each thread keeps one row of V in registers.  :func:`eigh_geometry`
computes that launch geometry and refuses what does not fit.
"""
from __future__ import annotations

import torch

from . import build

__all__ = ["svd_by_gram", "eigh_desc", "eigh_desc_plain", "eigh_geometry",
           "EIGH_SIZES", "MAX_K", "RTOL"]

#: largest Gram matrix the kernel takes
MAX_K = 64
#: singular values at or under this fraction of the largest are set to 0
RTOL = 1e-7


#: the kernel's tournament sizes (compiled instances): the sweeps' k = 20
#: (D=10) and 40 (D=20), and 32 and 64 to cover every k; one warp per
#: matrix up to 32, two above
EIGH_SIZES = (20, 32, 40, 64)


def eigh_geometry(k: int):
    """Launch geometry of ``jacobi_eigh.cu`` for k x k matrices:
    (tournament size K, matrices per block, bytes of shared memory per
    block).  K is the least of ``EIGH_SIZES`` that holds k; a block holds
    128 threads' worth of matrices.  Shared memory follows the kernel's
    layout: per matrix the round's rotations, two scratch values, the
    output permutation, two buffers of A [K, K + 1] and, above K = 32, the
    table of the round's 2 x 2 blocks."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the Jacobi eigen kernel takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    K = next(n for n in EIGH_SIZES if n >= k)
    mpb = 4 if K <= 32 else 2
    npairs = K // 2
    table = 0 if K <= 32 else 2 * npairs * (npairs + 1) // 2
    smem = mpb * 8 * (3 * npairs + 2 + 2 * K * (K + 1) + table)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"Jacobi eigen k={k}: needs {smem} bytes of shared "
                         f"memory per block, over the {build.SMEM_PER_BLOCK}"
                         "-byte limit")
    return K, mpb, smem


def eigh_desc_plain(G: torch.Tensor):
    """Eigen-decomposition of symmetric ``G [..., k, k]``: (w [..., k]
    descending, V [..., k, k] with the eigenvectors as columns)."""
    w, V = torch.linalg.eigh(G)
    return w.flip(-1), V.flip(-1)


def eigh_desc(G: torch.Tensor):
    """:func:`eigh_desc_plain` on CPU tensors; the Jacobi kernel on CUDA
    tensors (float64, contiguous, k <= 64)."""
    if G.device.type == "cpu":
        return eigh_desc_plain(G)
    if G.device.type != "cuda":
        raise ValueError(f"G must lie on the CPU or a CUDA device: "
                         f"{G.device}")
    if G.dtype != torch.float64:
        raise TypeError(f"the Jacobi eigen kernel takes float64, got "
                        f"{G.dtype}")
    if G.ndim < 2 or G.shape[-1] != G.shape[-2]:
        raise ValueError(f"G must be [..., k, k], got {tuple(G.shape)}")
    if not G.is_contiguous():
        raise ValueError("G must be contiguous")
    K, mpb, smem = eigh_geometry(G.shape[-1])
    w = G.new_empty(G.shape[:-1])
    V = torch.empty_like(G)
    k = G.shape[-1]
    Bn = w.numel() // k
    if Bn == 0:
        return w, V
    rc = build.library("jacobi_eigh").jacobi_eigh(
        G.data_ptr(), w.data_ptr(), V.data_ptr(), Bn, k, K, mpb, smem,
        torch.cuda.current_stream(G.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Jacobi eigen: CUDA launch failed with error {rc}")
    eigh_desc.launches += 1
    return w, V


eigh_desc.launches = 0


def svd_by_gram(M: torch.Tensor):
    """Thin SVD ``M = U diag(S) Vh`` of ``M [..., m, n]`` (k = min(m, n) <=
    64), singular values descending, computed in float64 and returned in
    M's dtype."""
    X = M.double()
    tall = X.shape[-2] >= X.shape[-1]
    G = (X.transpose(-1, -2) @ X) if tall else (X @ X.transpose(-1, -2))
    w, E = eigh_desc(G.contiguous())
    S = w.clamp(min=0.0).sqrt()
    keep = S > RTOL * S[..., :1]
    S = torch.where(keep, S, torch.zeros_like(S))
    inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                      torch.zeros_like(S))
    if tall:                                   # E = V
        U, Vh = (X @ E) * inv[..., None, :], E.transpose(-1, -2)
    else:                                      # E = U
        U, Vh = E, inv[..., :, None] * (E.transpose(-1, -2) @ X)
    return U.to(M.dtype), S.to(M.dtype), Vh.to(M.dtype)
