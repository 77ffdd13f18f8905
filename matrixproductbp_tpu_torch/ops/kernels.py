"""Batched thin QR by Cholesky-QR as Hopper kernels.

Counterpart of ``matrixproductbp_tpu/ops/kernels.py``.  :func:`batched_cholqr`
runs its plain version (``smallalg.cholqr_unrolled``) when A lies on the CPU
and launches a CUDA kernel when A lies on a CUDA device; there is no
fallback between the two.  Two kernels replace ``_cholqr_kernel``
(``kernels.py:61``), picked by shape in :func:`cholqr_geometry`:
``cholqr_staged_kernel`` (``csrc/cholqr_staged.cu``, built once per shape
with its sizes as macros) for every float32 A whose buffers fit (n <= 40;
the randomized merge's [4s, s] at every bond to D=20), and
``cholqr_kernel`` (``csrc/cholqr.cu``) for float64 and the rest.
``batched_cholqr.launches`` counts kernel launches,
``batched_cholqr.variant_launches`` each kernel's.  :func:`cholqr` is the
dispatcher the randomized merge calls (``ops/randomized.py``);
:func:`cholqr_reference` (``torch.linalg``) is the tests' third opinion and
is never on the sweep's path.

Both kernels and the plain version factor float32 inputs in float64 with
the float32 jitter (see ``smallalg.cholqr_unrolled``).
"""
from __future__ import annotations

import functools

import torch

from . import build
from .smallalg import cholqr_unrolled

__all__ = ["cholqr", "batched_cholqr", "cholqr_reference", "cholqr_unrolled",
           "cholqr_geometry", "cholqr_staged_macros", "build_cholqr",
           "MAX_N", "STAGED_MAX_N"]

#: widest A the kernels take (the column loop is sequential per instance)
MAX_N = 64
#: widest A the staged kernel takes: each thread keeps a row of G (or a
#: column of L^{-1}) of n doubles in registers
STAGED_MAX_N = 40


def _smem_cholqr(m: int, n: int) -> int:
    """Bytes of shared memory per block (float64 staging, ``cholqr.cu``)."""
    return 8 * (m * (n + 1) + n * (n + 1) + n)


def _threads(m: int, n: int) -> int:
    """One thread per row of A for the substitution, in whole warps."""
    return min(256, 32 * ((max(m, n) + 31) // 32))


def _stride(least: int, mod: int, rem: int) -> int:
    """The least row stride >= ``least`` that is ``rem`` modulo ``mod``."""
    return least + (rem - least) % mod


def _staged_strides(m: int, n: int):
    """(n8, mp, LDA, LDG, LDX) of ``cholqr_staged.cu``: n rounded up to 8
    and m to 16 (a DMMA tile's columns and rows), and the row strides of A
    (floats; 4 mod 8, so that both products' fragment loads are free of
    bank conflicts), of the Gram / L^T buffer (doubles; 8 mod 16, for the
    16-byte stores of the Gram's fragments) and of L^{-1} (doubles; 4 mod
    8, for its fragment loads)."""
    n8, mp = -(-n // 8) * 8, -(-m // 16) * 16
    return (n8, mp, _stride(n8, 8, 4), _stride(n8, 16, 8),
            _stride(n8, 8, 4))


def _smem_cholqr_staged(m: int, n: int) -> int:
    """Bytes of shared memory per instance of ``cholqr_staged_kernel``:
    the Gram (then L^T) [n][LDG], L^{-1} [n8][LDX], the pivots' 1/sqrt
    [n8] and two partial traces in float64, and A [mp][LDA] in float32."""
    n8, mp, lda, ldg, ldx = _staged_strides(m, n)
    return 8 * (n * ldg + n8 * ldx + n8 + 2) + 4 * mp * lda


@functools.lru_cache(maxsize=None)
def _cholqr_staged_plan(m: int, n: int):
    """(instances a block, blocks an SM, row tiles of Q a pass, threads a
    block, shared-memory bytes a block) of the staged kernel, or None where
    it does not fit.  An instance takes 2 x 32 x ceil(n/32) threads (the
    Cholesky's rows and the inverse's columns); two instances share a block
    of 128 threads where n <= 32.  Blocks an SM: as many as shared memory,
    2048 threads and the registers allow, at 4n + 8 registers a thread
    (the row of n doubles and the pivot column's loads), at least 64: the
    budget ``tools/probe_cholqr.py --minb`` timed fastest at n = 20 and
    n = 40 (PERF.md)."""
    if not 1 <= n <= STAGED_MAX_N or m < 1:
        return None
    per = _smem_cholqr_staged(m, n)
    nti = 64 * -(-n // 32)
    ipb = 128 // nti
    smem, threads = ipb * per, ipb * nti
    if smem > build.SMEM_PER_BLOCK:
        return None
    regs = max(64, 4 * n + 8)
    blocks = min(build.SMEM_PER_SM // (smem + build.SMEM_RESERVED),
                 2048 // threads,
                 65536 // (threads * regs), 32)
    # Q's row tiles of 16 rows a warp, taken in balanced passes of at most
    # 15 / ceil(n/8) tiles (<= 60 float64 accumulators a thread)
    tiles = -(-m // 16)
    per_warp = -(-tiles // (nti // 32))
    passes = -(-per_warp // max(1, min(per_warp, 15 // -(-n // 8))))
    return ipb, blocks, -(-per_warp // passes), threads, smem


def cholqr_geometry(m: int, n: int, dtype, variant=None):
    """(variant, threads a block, shared-memory bytes a block) of the CholQR
    kernel for A [m, n]: ``"staged"`` (``cholqr_staged_kernel``) for
    float32 where its buffers fit (n <= 40), else ``"base"``
    (``cholqr_kernel``: float64 and the rest).  ``variant`` forces one of
    the two.  Raises ``ValueError`` where none fits (or the forced one does
    not)."""
    names = (("staged", "base") if dtype == torch.float32 else ("base",)) \
        if variant is None else (variant,)
    for name in names:
        if name == "staged":
            if dtype != torch.float32:
                why = f"takes float32 only, got {dtype}"
                continue
            plan = _cholqr_staged_plan(m, n)
            if plan is not None:
                return name, plan[3], plan[4]
            why = (f"takes 1 <= n <= {STAGED_MAX_N} and m >= 1 within "
                   f"{build.SMEM_PER_BLOCK} bytes of shared memory per "
                   f"block, got [{m}, {n}]")
        elif name == "base":
            smem = _smem_cholqr(m, n)
            if smem <= build.SMEM_PER_BLOCK:
                return name, _threads(m, n), smem
            why = (f"needs {smem} bytes of shared memory per block, over "
                   f"the {build.SMEM_PER_BLOCK}-byte limit")
        else:
            raise ValueError(f"no CholQR kernel {name!r}: 'staged' or 'base'")
    raise ValueError(f"CholQR [{m}, {n}] ({name} kernel): {why}")


def cholqr_staged_macros(m: int, n: int):
    """The macros ``cholqr_staged.cu`` is built with for A [m, n]: its
    sizes, the instances a block (``CQ_IPB``), the blocks an SM should hold
    (``CQ_MINB``, the register budget) and Q's row tiles a pass
    (``CQ_QR``).  Raises ``ValueError`` where its buffers do not fit."""
    cholqr_geometry(m, n, torch.float32, "staged")          # raises
    ipb, blocks, qr, _, _ = _cholqr_staged_plan(m, n)
    return (f"CQ_M={m}", f"CQ_N={n}", f"CQ_IPB={ipb}", f"CQ_MINB={blocks}",
            f"CQ_QR={qr}")


def build_cholqr(shapes):
    """Build, all at once, the staged CholQR libraries of the float32
    shapes ``(m, n)``."""
    build.build_all([("cholqr_staged", cholqr_staged_macros(m, n))
                     for m, n in shapes])


def batched_cholqr(A: torch.Tensor, eps: float = 1e-6, _variant=None):
    """A [..., m, n] -> (Q [..., m, n], R [..., n, n]), A = Q R.

    CPU tensors run :func:`cholqr_unrolled` (whatever ``_variant``); CUDA
    tensors launch the kernel :func:`cholqr_geometry` picks (``_variant``
    forces one, for tests), which takes float32 or float64, contiguous A
    (16-byte aligned for the staged kernel), and n <= 64."""
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
    variant, threads, smem = cholqr_geometry(m, n, A.dtype, _variant)
    if variant == "staged" and A.data_ptr() % 16:
        raise ValueError("the staged CholQR kernel takes 16-byte aligned A")
    Q = torch.empty_like(A)
    R = A.new_empty(tuple(batch) + (n, n))
    Bn = Q.numel() // (m * n)
    if Bn == 0:
        return Q, R
    stream = torch.cuda.current_stream(A.device).cuda_stream
    if variant == "staged":
        rc = build.library("cholqr_staged", cholqr_staged_macros(
            m, n)).cholqr_staged(A.data_ptr(), Q.data_ptr(), R.data_ptr(),
                                 Bn, m, n, float(eps), smem, stream)
    else:
        rc = build.library("cholqr").cholqr(
            0 if A.dtype == torch.float32 else 1, A.data_ptr(), Q.data_ptr(),
            R.data_ptr(), Bn, m, n, float(eps), threads, smem, stream)
    if rc != 0:
        raise RuntimeError(f"CholQR: CUDA launch failed with error {rc}")
    batched_cholqr.launches += 1
    batched_cholqr.variant_launches[variant] += 1
    return Q, R


batched_cholqr.launches = 0
batched_cholqr.variant_launches = {"staged": 0, "base": 0}


def cholqr(A: torch.Tensor, eps: float | None = None, _variant=None):
    """Thin QR for the randomized merge's projection step; ``eps`` defaults
    to the jitter of A's dtype (1e-12 for float64, 1e-6 for float32);
    ``_variant`` forces one kernel (see :func:`cholqr_geometry`)."""
    if eps is None:
        eps = 1e-12 if A.dtype == torch.float64 else 1e-6
    return batched_cholqr(A, eps, _variant)


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
