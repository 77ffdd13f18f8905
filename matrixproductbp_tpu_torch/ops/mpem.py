"""MPEM3 -> MPEM2 conversion: the left-to-right SVD regrouping sweep, batched.

Counterpart of ``matrixproductbp_tpu/ops/mpem.py``.  The BP
update produces a 5-leg transfer object ``B[t][m, n, xi, xj, xi']`` (``xi'``
is x_i at t+1); the sweep SVD-regroups ``(xi, xj)`` onto the left bond and
pushes ``xi'`` into the next core, giving a left-orthogonal message train
with legs ``(xi, xj)`` and bond capacity ``Dmid = qi * Db``, without
truncation (the caller compresses with ``assume="left"``).  Each time step is
one batched SVD over every instance (``tensortrain.batched_svd``); the
per-step max-abs rescale accumulates into ``logz``.  The periodic variant
(:func:`mpem3_to_mpem2_periodic`) sweeps every core and folds the last
carry into core 0, which closes the ring.
"""
from __future__ import annotations

import torch

from .tensortrain import TensorTrain, _fit_axis, _maxabs, batched_svd

__all__ = ["mpem3_to_mpem2", "mpem3_to_mpem2_periodic", "mpem3_lognorm",
           "evaluate_mpem3", "evaluate_mpem3_periodic"]


def _regroup(A: torch.Tensor) -> torch.Tensor:
    """[..., a, b, i, j, r] -> [..., (i, j, a), (b, r)]."""
    nb = A.ndim - 5
    a, b, i, j, r = A.shape[-5:]
    perm = list(range(nb)) + [nb + 2, nb + 3, nb, nb + 1, nb + 4]
    return A.permute(perm).reshape(A.shape[:-5] + (i * j * a, b * r))


def _svd_step(M: torch.Tensor, lg: torch.Tensor):
    m = _maxabs(M, 2)
    U, S, Vt = batched_svd(M / m[..., None, None])
    return U, S, Vt, lg - torch.log(m)


def mpem3_to_mpem2(B: torch.Tensor, logz: torch.Tensor) -> TensorTrain:
    """B [..., T1, Db, Db, qi, qj, qi], logz [...] -> left-orthogonal trains
    with phys ``(qi, qj)`` and bond capacity ``qi * Db``.  The last core's
    ``xi'`` leg is taken at index 0."""
    batch = B.shape[:-6]
    T1, Db, _, qi, qj, _ = B.shape[-6:]
    Dmid = qi * Db
    U, S, Vt, lg = _svd_step(_regroup(B[..., 0, :, :, :, :, :]), logz)
    C0 = U.reshape(batch + (qi, qj, Db, Dmid)).movedim((-4, -3), (-2, -1)) \
        .reshape(batch + (Db, Dmid, qi * qj))
    C = (S[..., :, None] * Vt).reshape(batch + (Dmid, Db, qi))
    mids = []
    for t in range(1, T1 - 1):
        A = torch.einsum("...kli,...lnijr->...knijr", C,
                         B[..., t, :, :, :, :, :])
        U, S, Vt, lg = _svd_step(_regroup(A), lg)
        mids.append(U.reshape(batch + (qi, qj, Dmid, Dmid))
                    .movedim((-4, -3), (-2, -1))
                    .reshape(batch + (Dmid, Dmid, qi * qj)))
        C = (S[..., :, None] * Vt).reshape(batch + (Dmid, Db, qi))
    A = torch.einsum("...kli,...lnijr->...knijr", C, B[..., -1, :, :, :, :, :])
    last = A[..., 0].reshape(batch + (Dmid, Db, qi * qj))
    cores = torch.stack([_fit_axis(C0, -3, Dmid)] + mids
                        + [_fit_axis(last, -2, Dmid)], dim=-4)
    return TensorTrain(cores, lg, (qi, qj))


def mpem3_to_mpem2_periodic(B: torch.Tensor, logz: torch.Tensor
                            ) -> TensorTrain:
    """Periodic MPEM3s ``B [..., T1, Db, Db, qi, qj, qi]`` (the last ``xi'``
    wraps to ``xi`` at time 0) -> periodic trains with phys ``(qi, qj)`` and
    bond ``qi * Db`` (``mpem.py:84-118``): the sweep runs over all T1 cores
    and the final carry folds into core 0, diagonal in its ``xi`` leg."""
    batch = B.shape[:-6]
    T1, Db, _, qi, qj, _ = B.shape[-6:]
    Dmid = qi * Db
    U, S, Vt, lg = _svd_step(_regroup(B[..., 0, :, :, :, :, :]), logz)
    C0 = U.reshape(batch + (qi, qj, Db, Dmid)).movedim((-4, -3), (-2, -1))
    C = (S[..., :, None] * Vt).reshape(batch + (Dmid, Db, qi))
    cores = []
    for t in range(1, T1):
        A = torch.einsum("...kli,...lnijr->...knijr", C,
                         B[..., t, :, :, :, :, :])
        U, S, Vt, lg = _svd_step(_regroup(A), lg)
        cores.append(U.reshape(batch + (qi, qj, Dmid, Dmid))
                     .movedim((-4, -3), (-2, -1))
                     .reshape(batch + (Dmid, Dmid, qi * qj)))
        C = (S[..., :, None] * Vt).reshape(batch + (Dmid, Db, qi))
    C0w = torch.einsum("...mli,...lnij->...mnij", C, C0)
    cores.insert(0, C0w.reshape(batch + (Dmid, Dmid, qi * qj)))
    return TensorTrain(torch.stack(cores, dim=-4), lg, (qi, qj), True)


def mpem3_lognorm(B: torch.Tensor, logz: torch.Tensor):
    """(log |Z|, sign) of the total sum of MPEM3s ``B [..., T1, Db, Db, qi,
    qj, qi]`` (the last ``xi'`` at index 0), contracted directly: the
    environment ``v[n, xi']`` carries the shared ``xi`` leg from one core to
    the next, rescaled to max-abs 1 each step.  Equals ``lognorm`` of
    :func:`mpem3_to_mpem2`'s trains, without their SVDs."""
    batch = B.shape[:-6]
    T1, Db, _, qi = B.shape[-6:-2]
    v = B.new_zeros(batch + (Db, qi))
    v[..., 0, :] = 1.0
    lg = logz
    for t in range(T1 - 1):
        v = torch.einsum("...mi,...mnijr->...nr", v, B[..., t, :, :, :, :, :])
        m = _maxabs(v, 2)
        v = v / m[..., None, None]
        lg = lg - torch.log(m)
    z = torch.einsum("...mi,...mij->...", v, B[..., -1, :, 0, :, :, 0])
    return torch.log(z.abs()) - lg, torch.sign(z)


def evaluate_mpem3(B: torch.Tensor, logz, xi, xj) -> torch.Tensor:
    """Value of one MPEM3 ``B [T1, Db, Db, qi, qj, qi]`` at the trajectory
    ``(xi, xj)``: the product of ``B[t][:, :, xi_t, xj_t, xi_{t+1}]`` with
    the last ``xi'`` at index 0."""
    T1 = B.shape[0]
    xnext = list(xi[1:]) + [0]
    v = B.new_zeros(B.shape[1])
    v[0] = 1.0
    for t in range(T1):
        v = v @ B[t][:, :, int(xi[t]), int(xj[t]), int(xnext[t])]
    return v[0] * torch.exp(-torch.as_tensor(logz, dtype=B.dtype))


def evaluate_mpem3_periodic(B: torch.Tensor, logz, xi, xj) -> torch.Tensor:
    """Value of one periodic MPEM3 at ``(xi, xj)``: the last ``xi'`` wraps
    to ``xi[0]`` and the product closes with the trace."""
    T1 = B.shape[0]
    xnext = list(xi[1:]) + [xi[0]]
    M = torch.eye(B.shape[1], dtype=B.dtype, device=B.device)
    for t in range(T1):
        M = M @ B[t][:, :, int(xi[t]), int(xj[t]), int(xnext[t])]
    return torch.trace(M) * torch.exp(-torch.as_tensor(logz, dtype=B.dtype))
