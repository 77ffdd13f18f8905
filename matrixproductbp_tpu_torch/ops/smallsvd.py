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
a CPU tensor; ``eigh_desc.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import build

__all__ = ["svd_by_gram", "eigh_desc", "eigh_desc_plain", "MAX_K", "RTOL"]

#: largest Gram matrix the kernel takes
MAX_K = 64
#: singular values at or under this fraction of the largest are set to 0
RTOL = 1e-7


def _smem_eigh(k: int) -> int:
    """Bytes of shared memory per block (``jacobi_eigh.cu``)."""
    npairs = (k + 1) // 2
    return 8 * 2 * k * (k + 1) + (8 * 2 + 4 * 2) * npairs


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
    k = G.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the Jacobi eigen kernel takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    smem = _smem_eigh(k)
    if smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"Jacobi eigen k={k}: needs {smem} bytes of shared "
                         f"memory per block, over the {build.SMEM_PER_BLOCK}"
                         "-byte limit")
    w = G.new_empty(G.shape[:-1])
    V = torch.empty_like(G)
    Bn = w.numel() // k
    if Bn == 0:
        return w, V
    rc = build.library("jacobi_eigh").jacobi_eigh(
        G.data_ptr(), w.data_ptr(), V.data_ptr(), Bn, k,
        128 if k <= 32 else 256, smem,
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
