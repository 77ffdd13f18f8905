"""Randomized structured rounding of the cavity merge, batched over instances.

Counterpart of ``matrixproductbp_tpu/ops/randomized.py:46-134``.  The merge
``L (x) B`` contracted with ``prob_yy`` is never formed at its Kronecker bond
``DL * DB``: a right-to-left pass contracts it with a Gaussian train of bond
``s = min(oversample * Dout, DL * DB)`` (the partial products ``W_t``), a
left-to-right pass projects each site onto the column space of its sketch
``[s * Y * q, s]`` through a thin QR, and a truncating SVD sweep of the
resulting bond-``s`` train applies the caller's policy down to ``Dout``.
Each time step runs once for the whole batch; the thin QR is the CholQR
kernel (``ops/kernels.py``), one launch per time step.  ``yy_off`` selects
the sum-type (banded) merge: ``y_expand`` in place of ``prob_yy``
(``ops/randomized.py:63-104`` of the JAX package).
"""
from __future__ import annotations

import torch

from . import kernels
from .stta import DEFAULT_SKETCHES
from .sumy import y_expand
from .tensortrain import (TensorTrain, _maxabs, _sweep_truncate_rl,
                          normalize_eachmatrix)
from .truncation import SVDTrunc

__all__ = ["merge_rounded"]


def _onehot(Bn, shape, like):
    w = like.new_zeros((Bn,) + tuple(shape))
    w.view(Bn, -1)[:, 0] = 1.0
    return w


def _zstep(C, Lt, Bt, pyy, yy_off):
    """Z[z, p, nL, nB, y, x] = sum C[z, p, k, m] L_t[z, k, nL, u, x]
    pyy[y, u, v, x] B_t[z, m, nB, v, x] (the band ``u = y + off - v`` where
    ``yy_off`` is set)."""
    t1 = torch.einsum("zpkm,zknux->zpnmux", C, Lt)
    if yy_off is None:
        z1 = torch.einsum("yuvx,zpnmux->zpnmyvx", pyy, t1)
    else:
        z1 = y_expand(t1, yy_off, axis=4, mode="diff")
    return torch.einsum("zpnmyvx,zmjvx->zpnjyx", z1, Bt)


def merge_rounded(Lc, Llz, Bc, Blz, pyy, trunc: SVDTrunc, Dout: int, Y: int,
                  q: int, sketches=None, oversample: int = 2, yy_off=None):
    """Merge two batches of cavity trains and round to bond ``Dout``.

    Lc [B, T1, DL, DL, Y*q], Bc [B, T1, DB, DB, Y*q], pyy [Y, Y, Y, q] shared
    (or [T1, Y, Y, Y, q], one a step) -> (cores [B, T1, Dout, Dout, Y*q],
    logz [B] from ``Llz + Blz``).
    ``sketches.normal`` supplies the Gaussian train ``[T1, s, s, Y, q]``,
    shared by every instance (the JAX package's unsplit ``PRNGKey(17)``);
    ``yy_off`` selects the banded merge, where ``pyy`` is not read."""
    Bn, T1, DL = Lc.shape[0], Lc.shape[1], Lc.shape[2]
    DB = Bc.shape[2]
    P = Y * q
    dtype, device = Lc.dtype, Lc.device
    s = min(oversample * Dout, DL * DB)
    L = Lc.reshape(Bn, T1, DL, DL, Y, q)
    B = Bc.reshape(Bn, T1, DB, DB, Y, q)
    sk = DEFAULT_SKETCHES if sketches is None else sketches
    theta = sk.normal((T1, s, s, Y, q), dtype, device)
    if yy_off is None:
        pyy = pyy.to(dtype)
        if pyy.ndim == 4:
            pyy = pyy.expand((T1,) + pyy.shape)
        Th = torch.einsum("tabyx,tyuvx->tabuvx", theta, pyy)
    else:
        pyy = Lc.new_zeros((T1, 1))             # placeholder, never read
        Th = y_expand(theta, yy_off, axis=3, mode="sum")

    # right-to-left sketch pass: Ws[t] = W_{t+1}, t = 0..T1-2
    W = _onehot(Bn, (DL, DB, s), Lc)
    Ws = [None] * (T1 - 1)
    for t in range(T1 - 1, 0, -1):
        t1 = torch.einsum("zmnvx,zlnb->zmlvxb", B[:, t], W)
        u = torch.einsum("abuvx,zmlvxb->zmluxa", Th[t], t1)
        W = torch.einsum("zknux,zmnuxa->zkma", L[:, t], u)
        W = W / _maxabs(W, 3)[:, None, None, None]
        Ws[t - 1] = W

    # left-to-right projection pass
    C = _onehot(Bn, (s, DL, DB), Lc)
    lg = Llz + Blz
    cores = []
    for t in range(T1 - 1):
        Z = _zstep(C, L[:, t], B[:, t], pyy[t], yy_off)  # [z, s, nL, nB, Y, q]
        m = _maxabs(Z, 5)
        Z = Z / m[:, None, None, None, None, None]
        lg = lg - torch.log(m)
        Yk = torch.einsum("zpnjyx,znja->zpyxa", Z, Ws[t]).reshape(Bn, s * P, s)
        Q, _ = kernels.cholqr(Yk.contiguous())
        cores.append(Q.reshape(Bn, s, P, s).transpose(-1, -2))
        C = torch.einsum("zpyxa,zpnjyx->zanj", Q.reshape(Bn, s, Y, q, s), Z)

    # last core: absorb the carry; its right bond is column 0
    Zl = _zstep(C, L[:, -1], B[:, -1], pyy[-1], yy_off)
    last = Lc.new_zeros((Bn, s, s, P))
    last[:, :, 0, :] = Zl[:, :, 0, 0].reshape(Bn, s, P)
    cores.append(last)

    out, lg = _sweep_truncate_rl(torch.stack(cores, dim=1), lg, trunc, Dout)
    tt = normalize_eachmatrix(TensorTrain(out, lg, (Y, q)))
    return tt.cores, tt.logz
