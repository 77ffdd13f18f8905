"""Batched, padded tensor trains — the L0 engine of the port.

Counterpart of ``matrixproductbp_tpu/ops/tensortrain.py``.  A train is a
dense stack ``cores[..., T1, D, D, P]`` with a static bond capacity ``D``
and flattened physical dimension ``P``; any leading axes are a batch (edges,
nodes) that every function here runs over at once, in place of the JAX
package's ``vmap``.  An open train represents
``p(x) = (prod_t cores[t][:, :, x_t])[0, 0] * exp(-logz)`` with
``logz[...]``; its boundaries populate row 0 of the first core and column 0
of the last.  A periodic (trace-closed) train represents
``tr(prod_t cores[t][:, :, x_t]) * exp(-logz)``: its environments are
``D x D`` matrices (:func:`_accumulate_mats`) and it is compressed by
cut-and-rotate open sweeps (:func:`_sweep_truncate_periodic`).  Zero
padding of the bond is exact.  The canonical sweeps run each time step as
one batched QR or SVD over the whole batch (:func:`batched_svd`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from . import smallsvd
from .truncation import SVDTrunc, TruncThresh

__all__ = ["TensorTrain", "flat_tt", "rand_tt", "evaluate", "lognorm",
           "normalization", "normalize", "normalize_eachmatrix", "marginals",
           "twovar_marginals", "orthogonalize_left", "orthogonalize_right",
           "compress", "tt_sum", "tt_dot", "bond_ranks", "batched_svd"]


@dataclasses.dataclass
class TensorTrain:
    """Tensor train(s): ``cores [..., T1, D, D, P]``, ``logz [...]``; open
    unless ``periodic``."""

    cores: torch.Tensor
    logz: torch.Tensor
    phys: tuple = ()
    periodic: bool = False

    @property
    def T1(self) -> int:
        return self.cores.shape[-4]


def flat_tt(T1: int, D: int, phys: Sequence[int], dtype=torch.float64,
            device=None, periodic: bool = False) -> TensorTrain:
    """Uniform train of value 1 for every configuration (bond 1 embedded in
    capacity ``D``); ``flat_tt`` of ``tensortrain.py:107-117``."""
    P = int(math.prod(phys)) if phys else 1
    cores = torch.zeros((T1, D, D, P), dtype=dtype, device=device)
    cores[:, 0, 0, :] = 1.0
    return TensorTrain(cores, torch.zeros((), dtype=dtype, device=device),
                       tuple(phys), periodic)


def rand_tt(generator: torch.Generator | None, T1: int, D: int,
            phys: Sequence[int], bond: int | None = None,
            dtype=torch.float64, periodic: bool = False, device=None
            ) -> TensorTrain:
    """Random positive train with effective bond ``bond`` (default ``D``),
    uniform entries drawn from ``generator`` (``rand_tt`` of
    ``tensortrain.py:120-132``, which takes a key).  A periodic train keeps
    every row and column of its first and last cores."""
    P = int(math.prod(phys)) if phys else 1
    bond = D if bond is None else bond
    if generator is not None:
        device = generator.device
    vals = torch.rand((T1, D, D, P), generator=generator, dtype=dtype,
                      device=device)
    mask = torch.zeros((T1, D, D, 1), dtype=dtype, device=device)
    mask[:, :bond, :bond] = 1.0
    if not periodic:
        mask[0, 1:] = 0.0                 # first core: row 0 only
        mask[-1, :, 1:] = 0.0             # last core: column 0 only
    return TensorTrain(vals * mask, torch.zeros((), dtype=dtype,
                                                device=device), tuple(phys),
                       periodic)


def _safe_scale(m: torch.Tensor) -> torch.Tensor:
    """Max-abs scale, guarded: a zero or non-finite max gives 1."""
    ok = torch.isfinite(m) & (m > 0)
    return torch.where(ok, m, torch.ones_like(m))


def _fit_axis(a: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Crop or zero-pad ``axis`` of ``a`` to ``size``."""
    axis = axis % a.ndim
    cur = a.shape[axis]
    if cur == size:
        return a
    if cur > size:
        return a.narrow(axis, 0, size)
    shape = list(a.shape)
    shape[axis] = size - cur
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _accumulate(cores: torch.Tensor, reverse: bool):
    """Environment sweep of the phys-summed transfer matrices.

    Returns (envs [..., T1+1, D], logs [..., T1+1]): envs[t] is the rescaled
    product of transfers 0..t-1 (or T1-1..t for ``reverse``), logs the
    accumulated log-scales."""
    transfer = cores.sum(dim=-1)                       # [..., T1, D, D]
    T1, D = transfer.shape[-3], transfer.shape[-1]
    batch = transfer.shape[:-3]
    v0 = torch.zeros(batch + (D,), dtype=cores.dtype, device=cores.device)
    v0[..., 0] = 1.0
    lg0 = torch.zeros(batch, dtype=cores.dtype, device=cores.device)
    vs, lgs = [None] * T1, [None] * T1
    v, lg = v0, lg0
    order = range(T1 - 1, -1, -1) if reverse else range(T1)
    for t in order:
        M = transfer[..., t, :, :]
        v2 = (M @ v[..., None])[..., 0] if reverse else \
            (v[..., None, :] @ M)[..., 0, :]
        m = _safe_scale(v2.abs().amax(dim=-1))
        v = v2 / m[..., None]
        lg = lg + torch.log(m)
        vs[t], lgs[t] = v, lg
    if reverse:
        envs = torch.stack(vs + [v0], dim=-2)
        logs = torch.stack(lgs + [lg0], dim=-1)
    else:
        envs = torch.stack([v0] + vs, dim=-2)
        logs = torch.stack([lg0] + lgs, dim=-1)
    return envs, logs


def _accumulate_mats(cores: torch.Tensor, reverse: bool):
    """Matrix environment sweep of periodic trains: (envs [..., T1+1, D, D],
    logs [..., T1+1]) with envs[t] the rescaled product of transfers
    0..t-1 (or t..T1-1 for ``reverse``), starting from the identity
    (``tensortrain.py:186-205``)."""
    transfer = cores.sum(dim=-1)                       # [..., T1, D, D]
    T1, D = transfer.shape[-3], transfer.shape[-1]
    batch = transfer.shape[:-3]
    eye = torch.eye(D, dtype=cores.dtype, device=cores.device).expand(
        batch + (D, D))
    lg0 = torch.zeros(batch, dtype=cores.dtype, device=cores.device)
    Es, lgs = [None] * T1, [None] * T1
    E, lg = eye, lg0
    order = range(T1 - 1, -1, -1) if reverse else range(T1)
    for t in order:
        M = transfer[..., t, :, :]
        E2 = M @ E if reverse else E @ M
        m = _maxabs(E2, 2)
        E = E2 / m[..., None, None]
        lg = lg + torch.log(m)
        Es[t], lgs[t] = E, lg
    if reverse:
        return (torch.stack(Es + [eye], dim=-3),
                torch.stack(lgs + [lg0], dim=-1))
    return torch.stack([eye] + Es, dim=-3), torch.stack([lg0] + lgs, dim=-1)


def lognorm(tt: TensorTrain):
    """(log |Z|, sign) of the total sum ``Z = sum_x p(x)``."""
    if tt.periodic:
        envs, logs = _accumulate_mats(tt.cores, reverse=False)
        z = torch.diagonal(envs[..., -1, :, :], dim1=-2, dim2=-1).sum(-1)
    else:
        envs, logs = _accumulate(tt.cores, reverse=False)
        z = envs[..., -1, 0]
    return torch.log(z.abs()) + logs[..., -1] - tt.logz, torch.sign(z)


def normalization(tt: TensorTrain) -> torch.Tensor:
    """Z = sum_x p(x) (may overflow for long horizons; prefer ``lognorm``)."""
    lg, sg = lognorm(tt)
    return sg * torch.exp(lg)


def normalize(tt: TensorTrain):
    """Rescale so the total sum is 1; return (tt', log-norm).  The sign of
    ``Z`` goes into the first core (``tensortrain.py:252``)."""
    lg, sg = lognorm(tt)
    scale = torch.exp(-(lg + tt.logz) / tt.T1)
    cores = tt.cores * scale[..., None, None, None, None]
    cores = torch.cat([cores[..., :1, :, :, :] * sg[..., None, None, None, None],
                       cores[..., 1:, :, :, :]], dim=-4)
    return TensorTrain(cores, torch.zeros_like(tt.logz), tt.phys,
                       tt.periodic), lg


def normalize_eachmatrix(tt: TensorTrain) -> TensorTrain:
    """Rescale each core to max-abs 1, folding the scales into ``logz``."""
    m = _safe_scale(tt.cores.abs().amax(dim=(-3, -2, -1)))   # [..., T1]
    cores = tt.cores / m[..., None, None, None]
    return TensorTrain(cores, tt.logz - torch.log(m).sum(dim=-1), tt.phys,
                       tt.periodic)


def marginals(tt: TensorTrain) -> torch.Tensor:
    """Per-time single-site marginals ``[..., T1, P]``, each summing to 1
    (periodic: ``p_t[x] ~ tr(P_t . cores[t][:, :, x] . S_{t+1})``)."""
    if tt.periodic:
        Pm, _ = _accumulate_mats(tt.cores, reverse=False)
        Sm, _ = _accumulate_mats(tt.cores, reverse=True)
        p = torch.einsum("...tam,...tmnp,...tna->...tp", Pm[..., :-1, :, :],
                         tt.cores, Sm[..., 1:, :, :])
    else:
        L, _ = _accumulate(tt.cores, reverse=False)
        R, _ = _accumulate(tt.cores, reverse=True)
        p = torch.einsum("...tm,...tmnp,...tn->...tp", L[..., :-1, :],
                         tt.cores, R[..., 1:, :])
    return p / p.sum(dim=-1, keepdim=True)


def twovar_marginals(tt: TensorTrain, maxdist: int | None = None
                     ) -> torch.Tensor:
    """Two-time marginals ``[..., T1, T1, P, P]``: entry (t, u) for
    t < u <= t + maxdist, each normalized to sum 1, the rest zero
    (``tensortrain.py:287-339``).  Every step runs over the whole batch;
    the propagated environment is rescaled to max-abs 1 each step, which
    the normalization removes.  A periodic train carries a matrix
    environment, closed by the trace with ``S_{u+1}``."""
    cores = tt.cores
    batch, (T1, D, _, P) = cores.shape[:-4], cores.shape[-4:]
    maxdist = T1 if maxdist is None else maxdist
    transfer = cores.sum(dim=-1)
    if tt.periodic:
        L, _ = _accumulate_mats(cores, reverse=False)
        R, _ = _accumulate_mats(cores, reverse=True)
        first, close = "...am,...mnp->...pan", "...pam,...mnq,...na->...pq"
    else:
        L, _ = _accumulate(cores, reverse=False)
        R, _ = _accumulate(cores, reverse=True)
        first, close = "...m,...mnp->...pn", "...pm,...mnq,...n->...pq"
    out = cores.new_zeros(batch + (T1, T1, P, P))
    for t in range(T1 - 1):
        # E[x, (a,) n] = (L[t] . cores[t][:, :, x]), then propagated over u
        Lt = L[..., t, :, :] if tt.periodic else L[..., t, :]
        E = torch.einsum(first, Lt, cores[..., t, :, :, :])
        for u in range(t + 1, min(t + maxdist, T1 - 1) + 1):
            Ru = R[..., u + 1, :, :] if tt.periodic else R[..., u + 1, :]
            p = torch.einsum(close, E, cores[..., u, :, :, :], Ru)
            s = p.sum(dim=(-2, -1), keepdim=True)
            out[..., t, u, :, :] = p / torch.where(s != 0, s,
                                                   torch.ones_like(s))
            M = transfer[..., u, :, :]
            E = E @ (M[..., None, :, :] if tt.periodic else M)
            k = E.ndim - len(batch)
            E = E / _maxabs(E, k)[(...,) + (None,) * k]
    return out


def evaluate(tt: TensorTrain, x: torch.Tensor) -> torch.Tensor:
    """Value at configurations ``x [..., T1]`` (ints indexing the flattened
    phys axis), one per train of the batch; periodic trains close with the
    trace."""
    idx = x.to(torch.int64)[..., None, None, None].expand(
        tt.cores.shape[:-1] + (1,))
    sel = torch.gather(tt.cores, -1, idx)[..., 0]           # [..., T1, D, D]
    if tt.periodic:
        M = torch.eye(sel.shape[-1], dtype=sel.dtype, device=sel.device)
        for t in range(sel.shape[-3]):
            M = M @ sel[..., t, :, :]
        return (torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
                * torch.exp(-tt.logz))
    v = torch.zeros(sel.shape[:-3] + (sel.shape[-1],), dtype=sel.dtype,
                    device=sel.device)
    v[..., 0] = 1.0
    for t in range(sel.shape[-3]):
        v = (v[..., None, :] @ sel[..., t, :, :])[..., 0, :]
    return v[..., 0] * torch.exp(-tt.logz)


# ---------------------------------------------------------------------------
# canonical forms and compression
# ---------------------------------------------------------------------------

def batched_svd(M: torch.Tensor):
    """Thin SVD ``M = U diag(S) Vh`` of a batch of small matrices
    ``M [..., m, n]``, singular values descending.

    float32 matrices on a CUDA device with min(m, n) <= 64 go through the
    float64 Gram matrix and the batched Jacobi eigen kernel
    (``ops/smallsvd.py``), which stays one launch for the whole batch;
    everything else goes to ``torch.linalg.svd`` (cuSOLVER on the card,
    which takes matrices above 32 x 32 one at a time).  float64 on the card
    takes cuSOLVER's ``gesvd`` (QR iteration): with the default Jacobi
    solver, periodic BP on the infinite 3-regular graph did not converge in
    150 sweeps and sat 8.8e-4 from the host's fixed point, where ``gesvd``
    gives the host's to 1e-14 (``tools/probe_periodic.py``).  On the card,
    ``batched_svd.calls`` counts the batches by route (``"jacobi"``,
    ``"linalg"``)."""
    on_card = M.device.type == "cuda"
    if (on_card and M.dtype == torch.float32
            and min(M.shape[-2:]) <= smallsvd.MAX_K):
        batched_svd.calls["jacobi"] += 1
        return smallsvd.svd_by_gram(M)
    if on_card:
        batched_svd.calls["linalg"] += 1
        if M.dtype == torch.float64:
            return torch.linalg.svd(M, full_matrices=False, driver="gesvd")
    return torch.linalg.svd(M, full_matrices=False)


batched_svd.calls = {"jacobi": 0, "linalg": 0}


def _right_orth(M: torch.Tensor):
    """``M [..., m, n] = Rt @ Qt`` with ``Qt [..., k, n]`` of orthonormal rows
    and ``Rt [..., m, k]``, k = min(m, n): the LQ step of the periodic
    sweep.  The JAX package takes ``qr(M.T)`` (``tensortrain.py:467``),
    which on the CPU this does too; float32 batches on the card take
    ``Qt = Vh``, ``Rt = U S`` from :func:`batched_svd`, since
    ``torch.linalg.qr`` factors their matrices one at a time
    (``tools/probe_linalg.py``).  Either leaves the same train, up to a
    gauge on the new bond."""
    if M.device.type == "cuda" and M.dtype == torch.float32:
        U, S, Vh = batched_svd(M)
        return U * S[..., None, :], Vh
    if M.device.type == "cuda":
        _right_orth.qr_calls += 1
    Q, R = torch.linalg.qr(M.transpose(-1, -2))
    return R.transpose(-1, -2), Q.transpose(-1, -2)


#: ``torch.linalg.qr`` batches of the periodic sweep on the card
_right_orth.qr_calls = 0


def _maxabs(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Guarded max-abs over the last ``ndim`` axes."""
    return _safe_scale(a.abs().amax(dim=tuple(range(-ndim, 0))))


def orthogonalize_left(tt: TensorTrain) -> TensorTrain:
    """Left-canonical gauge by a left-to-right QR sweep (value-preserving).
    Each core is pre-scaled to max-abs 1 before its QR and the carried R is
    rescaled to max-abs 1, both scales folded into ``logz``."""
    cores = tt.cores
    batch, (T1, D, _, P) = cores.shape[:-4], cores.shape[-4:]
    C = torch.eye(D, dtype=cores.dtype, device=cores.device).expand(
        batch + (D, D))
    lg = tt.logz
    out = []
    for t in range(T1 - 1):
        core = torch.einsum("...km,...mnp->...knp", C, cores[..., t, :, :, :])
        m0 = _maxabs(core, 3)
        M = (core / m0[..., None, None, None]).transpose(-1, -2) \
            .reshape(batch + (D * P, D))
        Q, Rm = torch.linalg.qr(M)
        m = _maxabs(Rm, 2)
        out.append(Q.reshape(batch + (D, P, D)).transpose(-1, -2))
        C = Rm / m[..., None, None]
        lg = lg - torch.log(m) - torch.log(m0)
    out.append(torch.einsum("...km,...mnp->...knp", C,
                            cores[..., -1, :, :, :]))
    return TensorTrain(torch.stack(out, dim=-4), lg, tt.phys)


def orthogonalize_right(tt: TensorTrain) -> TensorTrain:
    """Right-canonical gauge by a right-to-left LQ sweep (value-preserving),
    with the same pre-scale and carry rescale as :func:`orthogonalize_left`."""
    cores = tt.cores
    batch, (T1, D, _, P) = cores.shape[:-4], cores.shape[-4:]
    C = torch.eye(D, dtype=cores.dtype, device=cores.device).expand(
        batch + (D, D))
    lg = tt.logz
    out = [None] * T1
    for t in range(T1 - 1, 0, -1):
        core = torch.einsum("...mnp,...nk->...mkp", cores[..., t, :, :, :], C)
        m0 = _maxabs(core, 3)
        M = (core / m0[..., None, None, None]).transpose(-1, -2) \
            .reshape(batch + (D, P * D))
        Q, Rm = torch.linalg.qr(M.transpose(-1, -2))   # M = R^T Q^T
        m = _maxabs(Rm, 2)
        out[t] = Q.transpose(-1, -2).reshape(batch + (D, P, D)) \
            .transpose(-1, -2)
        C = Rm.transpose(-1, -2) / m[..., None, None]
        lg = lg - torch.log(m) - torch.log(m0)
    out[0] = torch.einsum("...mnp,...nk->...mkp", cores[..., 0, :, :, :], C)
    return TensorTrain(torch.stack(out, dim=-4), lg, tt.phys)


def _sweep_truncate_rl(cores: torch.Tensor, logz: torch.Tensor,
                       trunc: SVDTrunc, Dout: int):
    """Right-to-left truncating SVD sweep of left-orthogonal trains
    ``cores [..., T1, Din, Din, P]`` -> (cores [..., T1, Dout, Dout, P],
    logz).  The carried factor ``U S`` is rescaled to max-abs 1."""
    batch, (T1, Din, _, P) = cores.shape[:-4], cores.shape[-4:]
    nxt = _fit_axis(cores[..., -1, :, :, :], -2, Dout)  # col 0 only: exact
    lg = logz
    out = [None] * T1
    for t in range(T1 - 2, -1, -1):
        M = nxt.transpose(-1, -2).reshape(batch + (Din, P * Dout))
        U, S, Vt = batched_svd(M)
        S = S * trunc.keep_mask(S).to(S.dtype)
        k = S.shape[-1]
        out[t + 1] = _fit_axis(
            Vt.reshape(batch + (k, P, Dout)).transpose(-1, -2), -3, Dout)
        C = _fit_axis(U * S[..., None, :], -1, Dout)         # [..., Din, Dout]
        m = _maxabs(C, 2)
        nxt = torch.einsum("...mnp,...nk->...mkp", cores[..., t, :, :, :],
                           C / m[..., None, None])
        lg = lg - torch.log(m)
    out[0] = _fit_axis(nxt, -3, Dout)                    # row 0 only: exact
    return torch.stack(out, dim=-4), lg


def _sweep_truncate_lr(cores: torch.Tensor, logz: torch.Tensor,
                       trunc: SVDTrunc, Dout: int):
    """Left-to-right truncating SVD sweep of right-orthogonal trains."""
    batch, (T1, Din, _, P) = cores.shape[:-4], cores.shape[-4:]
    prv = _fit_axis(cores[..., 0, :, :, :], -3, Dout)
    lg = logz
    out = []
    for t in range(1, T1):
        M = prv.transpose(-1, -2).reshape(batch + (Dout * P, Din))
        U, S, Vt = batched_svd(M)
        S = S * trunc.keep_mask(S).to(S.dtype)
        k = S.shape[-1]
        out.append(_fit_axis(
            U.reshape(batch + (Dout, P, k)).transpose(-1, -2), -2, Dout))
        C = _fit_axis(S[..., :, None] * Vt, -2, Dout)        # [..., Dout, Din]
        m = _maxabs(C, 2)
        prv = torch.einsum("...km,...mnp->...knp", C / m[..., None, None],
                           cores[..., t, :, :, :])
        lg = lg - torch.log(m)
    out.append(_fit_axis(prv, -2, Dout))
    return torch.stack(out, dim=-4), lg


def _open_pass_periodic(cs, lg, trunc: SVDTrunc, Dout: int):
    """One right-to-left orthogonalization and left-to-right truncating pass
    over the internal bonds of periodic trains (``tensortrain.py:427-492``),
    batched: ``cs`` is the list of T1 cores ``[..., Dl_t, Dr_t, P]``.  The
    wrap bond is folded into the physical legs of the first and last cores
    (a spectator), which turns the ring into an open train whose canonical
    sweep is optimal.  Returns (the new core list, lg); internal bonds are
    at most ``Dout``, the wrap bond is untouched."""
    T1 = len(cs)
    batch = cs[0].shape[:-3]
    a_dim, D1, P = cs[0].shape[-3:]
    DT, ap_dim = cs[-1].shape[-3:-1]
    o = ([cs[0].transpose(-3, -2).reshape(batch + (1, D1, a_dim * P))]
         + list(cs[1:-1]) + [cs[-1].reshape(batch + (DT, 1, ap_dim * P))])
    for t in range(T1 - 1, 0, -1):
        Dl, Dr, Pt = o[t].shape[-3:]
        M = o[t].reshape(batch + (Dl, Dr * Pt))
        s = _maxabs(M, 2)
        lg = lg - torch.log(s)
        Rt, Qt = _right_orth(M / s[..., None, None])
        o[t] = Qt.reshape(batch + (Qt.shape[-2], Dr, Pt))
        o[t - 1] = torch.einsum("...mnp,...nk->...mkp", o[t - 1], Rt)
    for t in range(T1 - 1):
        Dl, Dr, Pt = o[t].shape[-3:]
        M = o[t].transpose(-1, -2).reshape(batch + (Dl * Pt, Dr))
        s = _maxabs(M, 2)
        lg = lg - torch.log(s)
        U, S, Vt = batched_svd(M / s[..., None, None])
        S = S * trunc.keep_mask(S).to(S.dtype)
        k = min(Dout, S.shape[-1])
        o[t] = U[..., :k].reshape(batch + (Dl, Pt, k)).transpose(-1, -2)
        C = S[..., :k, None] * Vt[..., :k, :]
        o[t + 1] = torch.einsum("...km,...mnp->...knp", C, o[t + 1])
    c0, cT = o[0], o[-1]
    out0 = c0.reshape(batch + (c0.shape[-2], a_dim, P)).transpose(-3, -2)
    outT = cT.reshape(batch + (cT.shape[-3], ap_dim, P))
    return [out0] + o[1:-1] + [outT], lg


def _sweep_truncate_periodic(cores: torch.Tensor, logz: torch.Tensor,
                             trunc: SVDTrunc, Dout: int):
    """Bond truncation of periodic trains by cut-and-rotate open sweeps
    (``tensortrain.py:495-534``): the ring rotated by one site, so that the
    wrap bond is internal, takes one :func:`_open_pass_periodic`; rotated
    back it takes another, which compresses the remaining bonds."""
    T1 = cores.shape[-4]
    if T1 == 1:
        return _fit_axis(_fit_axis(cores, -3, Dout), -2, Dout), logz
    cs = [cores[..., t, :, :, :] for t in range(T1)]
    rot, lg = _open_pass_periodic(cs[1:] + cs[:1], logz, trunc, Dout)
    cs, lg = _open_pass_periodic(rot[-1:] + rot[:-1], lg, trunc, Dout)
    return torch.stack([_fit_axis(_fit_axis(c, -3, Dout), -2, Dout)
                        for c in cs], dim=-4), lg


def compress(tt: TensorTrain, trunc: SVDTrunc | None = None,
             Dout: int | None = None, assume: str | None = None
             ) -> TensorTrain:
    """Truncated-SVD compression to bond capacity ``Dout``.

    ``assume``: None (orthogonalize first), ``"left"`` or ``"right"`` if the
    input is already canonical on that side; periodic trains ignore it."""
    trunc = TruncThresh(0.0) if trunc is None else trunc
    Dout = tt.cores.shape[-3] if Dout is None else Dout
    if tt.periodic:
        cores, lg = _sweep_truncate_periodic(tt.cores, tt.logz, trunc, Dout)
        return TensorTrain(cores, lg, tt.phys, True)
    if assume == "left":
        cores, lg = _sweep_truncate_rl(tt.cores, tt.logz, trunc, Dout)
    elif assume == "right":
        cores, lg = _sweep_truncate_lr(tt.cores, tt.logz, trunc, Dout)
    elif assume is None:
        o = orthogonalize_right(tt)
        cores, lg = _sweep_truncate_lr(o.cores, o.logz, trunc, Dout)
    else:
        raise ValueError(f"assume must be None, 'left' or 'right': {assume!r}")
    return TensorTrain(cores, lg, tt.phys)


# ---------------------------------------------------------------------------
# algebra
# ---------------------------------------------------------------------------

def tt_sum(a: TensorTrain, b: TensorTrain, wb) -> TensorTrain:
    """Direct sum ``a + wb * b`` with bond capacity ``Da + Db`` (damping);
    the caller re-compresses the doubled bond.  Periodic trains are
    block-diagonal everywhere (the trace adds)."""
    if a.periodic != b.periodic:
        raise ValueError("tt_sum of an open and a periodic train")
    Da, Db = a.cores.shape[-3], b.cores.shape[-3]
    T1, P = a.cores.shape[-4], a.cores.shape[-1]
    batch = a.cores.shape[:-4]
    scale = wb * torch.exp(a.logz - b.logz)
    bc = torch.cat([b.cores[..., :1, :, :, :]
                    * scale[..., None, None, None, None],
                    b.cores[..., 1:, :, :, :]], dim=-4)
    D = Da + Db
    cores = a.cores.new_zeros(batch + (T1, D, D, P))
    cores[..., :Da, :Da, :] = a.cores
    cores[..., Da:, Da:, :] = bc
    if a.periodic:
        return TensorTrain(cores, a.logz, a.phys, True)
    # open boundaries: both trains enter through row 0 and leave through
    # column 0
    cores[..., 0, :, :, :] = 0.0
    cores[..., 0, 0, :Da, :] = a.cores[..., 0, 0, :, :]
    cores[..., 0, 0, Da:, :] = bc[..., 0, 0, :, :]
    cores[..., -1, :, :, :] = 0.0
    cores[..., -1, :Da, 0, :] = a.cores[..., -1, :, 0, :]
    cores[..., -1, Da:, 0, :] = bc[..., -1, :, 0, :]
    return TensorTrain(cores, a.logz, a.phys)


def tt_dot(a: TensorTrain, b: TensorTrain) -> torch.Tensor:
    """Inner product ``sum_x a(x) b(x)`` (periodic: the environment carries
    both trains' starting bonds and closes with their trace)."""
    Da, Db = a.cores.shape[-3], b.cores.shape[-3]
    if a.periodic:
        E = torch.einsum("ac,bd->abcd",
                         torch.eye(Da, dtype=a.cores.dtype,
                                   device=a.cores.device),
                         torch.eye(Db, dtype=a.cores.dtype,
                                   device=a.cores.device))
        for t in range(a.cores.shape[-4]):
            E = torch.einsum("...abcd,...cep,...dfp->...abef", E,
                             a.cores[..., t, :, :, :],
                             b.cores[..., t, :, :, :])
        return (torch.einsum("...abab->...", E)
                * torch.exp(-a.logz - b.logz))
    E = a.cores.new_zeros(a.cores.shape[:-4] + (Da, Db))
    E[..., 0, 0] = 1.0
    for t in range(a.cores.shape[-4]):
        E = torch.einsum("...mk,...mnp,...kjp->...nj", E,
                         a.cores[..., t, :, :, :], b.cores[..., t, :, :, :])
    return E[..., 0, 0] * torch.exp(-a.logz - b.logz)


def bond_ranks(tt: TensorTrain, tol: float = 0.0) -> torch.Tensor:
    """Effective bond dimensions (diagnostic, ``tensortrain.py:646-652``):
    after a right-orthogonal gauge and an untruncated left-to-right SVD
    sweep, the rows of each core with an entry above ``tol`` -> [..., T1]."""
    o = orthogonalize_right(tt)
    c = compress(o, TruncThresh(0.0), assume="right")
    return (c.cores.abs() > tol).any(dim=-1).any(dim=-1).sum(dim=-1)
