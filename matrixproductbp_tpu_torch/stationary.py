"""Stationary (T -> infinity) mode: uniform single-core edge messages.

Counterpart of ``matrixproductbp_tpu/stationary.py``.  In the T -> infinity
limit every message is an infinite uniform tensor train, one repeated core
``A[D, D, P]``, and its algebra reduces to the D x D transfer matrix
``E = sum_x A[x]``: the normalization per time step is E's leading
eigenvalue, marginals come from its leading eigenvectors, and the bond is
truncated in the canonical gauge (Gram fixed points, Cholesky, one SVD)
or by the variational fit of :func:`truncate_vumps_variational`.

Node updates are host loops over single cores, one node after another in
index order, each reading the messages the nodes before it wrote, as the
JAX package does (it compiles one ``jax.jit`` per degree; here every step
is a plain torch call on the state's device).  The spectral helpers run
fixed iteration counts, with no eigensolver and no early stop, so that
the two packages agree to round-off.  Gauges (SVD signs and rotations)
differ between LAPACK, torch and cuSOLVER: compare marginals, overlaps,
log-norms and free energies, never cores.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .bp import resolve_device
from .factors import RecursiveFactorTables
from .graph import Graph
from .infinite import infinite_bipartite_graph, infinite_regular_graph
from .ops.tensortrain import batched_svd
from .ops.truncation import SVDTrunc

__all__ = ["UniformMessage", "TruncVUMPS", "flat_uniform", "rand_uniform",
           "uniform_lognorm", "uniform_normalize", "uniform_marginals",
           "uniform_twovar_marginals", "uniform_dot", "truncate_vumps",
           "truncate_vumps_variational",
           "MPBPStationary", "mpbp_stationary",
           "mpbp_stationary_infinite_graph",
           "mpbp_stationary_infinite_bipartite_graph",
           "iterate_stationary", "beliefs_stationary",
           "bethe_free_energy_stationary", "pair_beliefs_stationary"]

#: Cholesky jitter of the canonical-gauge and variational truncations
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class TruncVUMPS(SVDTrunc):
    """Bond cap for uniform trains (reference default ``TruncVUMPS(4)``).

    ``refine = 0``: canonical-gauge SVD crop.  ``refine > 0``: the crop is
    then improved by ``refine`` rounds of the variational uniform-MPS fit
    (:func:`truncate_vumps_variational`)."""
    d: int
    power_iters: int = 100
    refine: int = 0

    @property
    def max_bond(self):
        return self.d


@dataclasses.dataclass
class UniformMessage:
    """One repeated core; the value per site carries ``exp(-logz)``."""
    core: torch.Tensor    # [D, D, P]
    logz: torch.Tensor    # []
    phys: tuple = ()

    @property
    def D(self):
        return self.core.shape[0]

    @property
    def P(self):
        return self.core.shape[2]


def flat_uniform(D: int, phys: Sequence[int], dtype=torch.float64,
                 device=None) -> UniformMessage:
    """The flat message on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    P = int(np.prod(phys)) if phys else 1
    core = torch.zeros((D, D, P), dtype=dtype, device=dev)
    core[0, 0, :] = 1.0
    return UniformMessage(core, torch.zeros((), dtype=dtype, device=dev),
                          tuple(phys))


def rand_uniform(gen: torch.Generator, D: int, phys: Sequence[int],
                 dtype=torch.float64, device=None) -> UniformMessage:
    """A core of uniform [0, 1) entries drawn from ``gen`` (a generator on
    the CPU, whose draw is then moved to ``device``)."""
    dev = resolve_device(device)
    P = int(np.prod(phys)) if phys else 1
    core = torch.rand((D, D, P), generator=gen, dtype=dtype).to(dev)
    return UniformMessage(core, torch.zeros((), dtype=dtype, device=dev),
                          tuple(phys))


# ---------------------------------------------------------------------------
# spectral helpers
# ---------------------------------------------------------------------------

def _power(apply, V: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` normalised steps ``V <- apply(V)`` of a stack of vectors
    ``V [n, ...]``, each scaled by its norm floored at 1e-300."""
    for _ in range(iters):
        V = apply(V)
        n = torch.linalg.vector_norm(V.reshape(V.shape[0], -1), dim=1)
        V = V / n.clamp_min(1e-300).reshape((-1,) + (1,) * (V.ndim - 1))
    return V


def _leading_eig(E: torch.Tensor, iters: int = 200):
    """(lambda, l, r) of a (nonnegative-ish) matrix by power iteration."""
    D = E.shape[0]
    M = torch.stack([E, E.T])
    V = torch.full((2, D, 1), 1.0 / np.sqrt(D), dtype=E.dtype,
                   device=E.device)
    r, l = _power(lambda V: torch.bmm(M, V), V, iters)[..., 0]
    lam = (l @ E @ r) / (l @ r)
    return lam, l, r


def _leading_eig_kron(x: torch.Tensor, y: torch.Tensor, iters: int = 200):
    """:func:`_leading_eig` of the mixed transfers ``E[(m,k),(n,l)] =
    sum_p x[m,n,p] y[k,l,p]`` of a batch of pairs ``x [B, Dx, Dx, P]``,
    ``y [B, Dy, Dy, P]``, without forming them: ``E r = sum_p x_p r
    y_p^T`` and ``E^T l = sum_p x_p^T l y_p`` on [Dx, Dy] matrices (the
    D^4 matrix of two bond-128 cores would be 2 GB in f64).  Returns
    (lambda [B], l [B, Dx*Dy], r [B, Dx*Dy]), l and r in E's (m, k) row
    order."""
    Bn, Dx, Dy, P = x.shape[0], x.shape[1], y.shape[1], x.shape[3]
    # first factors [(m,p), n] (r side) and [(n,p), m] (l side); second
    # factors [(p,l), k] and [(p,k), l]; rows 0..B-1 of V are r, B..2B-1 l
    X = torch.cat([x.permute(0, 1, 3, 2).reshape(Bn, Dx * P, Dx),
                   x.permute(0, 2, 3, 1).reshape(Bn, Dx * P, Dx)])
    Y = torch.cat([y.permute(0, 3, 2, 1).reshape(Bn, P * Dy, Dy),
                   y.permute(0, 3, 1, 2).reshape(Bn, P * Dy, Dy)])

    def apply(V):
        return torch.bmm(torch.bmm(X, V).reshape(2 * Bn, Dx, P * Dy), Y)

    V = torch.full((2 * Bn, Dx, Dy), 1.0 / np.sqrt(Dx * Dy), dtype=x.dtype,
                   device=x.device)
    V = _power(apply, V, iters)
    r, l = V[:Bn], V[Bn:]
    Er = apply(V)[:Bn]
    lam = torch.sum(l * Er, dim=(1, 2)) / torch.sum(l * r, dim=(1, 2))
    return lam, l.reshape(Bn, -1), r.reshape(Bn, -1)


def _gram_fixed_points(core: torch.Tensor, iters: int = 200):
    """(left, right) fixed points of rho -> sum_x A[x]^T rho A[x] and
    rho -> sum_x A[x] rho A[x]^T, PSD-symmetric, in one batched loop (the
    right one is the left one of the transposed cores)."""
    D, P = core.shape[0], core.shape[2]
    # [side, m, p, n] of A and of A^T
    A = torch.stack([core, core.transpose(0, 1)]).permute(0, 1, 3, 2) \
        .contiguous()
    rows = A.reshape(2, D * P, D).mT                # [n, (m,p)]
    cols = A.reshape(2, D, P * D)                   # [m, (p,n)]
    rho = torch.eye(D, dtype=core.dtype, device=core.device).expand(2, D, D)
    for _ in range(iters):
        # sum_{m,p} A[m,n,p] (rho A_p)[m,l]
        r2 = torch.bmm(rows, torch.bmm(rho, cols).reshape(2, D * P, D))
        # 0.5 (r2 + r2^T) / max|.|: the halving is exact, so it folds
        # into the floor
        r2 = r2 + r2.mT
        m = torch.linalg.vector_norm(r2, ord=float("inf"), dim=(1, 2))
        rho = r2 / m.clamp_min(2e-300)[:, None, None]
    return rho[0], rho[1]


def uniform_lognorm(u: UniformMessage):
    """log of the per-time-step normalization (leading transfer
    eigenvalue), and its sign."""
    lam, _, _ = _leading_eig(u.core.sum(dim=2))
    return torch.log(torch.abs(lam)) - u.logz, torch.sign(lam)


def uniform_normalize(u: UniformMessage):
    """Scale so the per-site normalization is 1; return (u', log-norm)."""
    lg, sg = uniform_lognorm(u)
    core = u.core * sg * torch.exp(-(lg + u.logz))
    return UniformMessage(core, torch.zeros_like(u.logz), u.phys), lg


def uniform_normalize_eachmatrix(u: UniformMessage) -> UniformMessage:
    m = u.core.abs().amax().clamp_min(1e-300)
    return UniformMessage(u.core / m, u.logz - torch.log(m), u.phys)


def uniform_marginals(u: UniformMessage) -> torch.Tensor:
    """Single-site marginal [P] from the leading eigenvectors."""
    _, l, r = _leading_eig(u.core.sum(dim=2))
    p = torch.einsum("m,mnp,n->p", l, u.core, r)
    return p / torch.sum(p)


def uniform_twovar_marginals(u: UniformMessage, maxdist: int) -> torch.Tensor:
    """p_delta(x, y) for time separations delta = 1..maxdist,
    [maxdist, P, P]."""
    E = u.core.sum(dim=2)
    lam, l, r = _leading_eig(E)
    En = E / lam
    M = torch.eye(u.D, dtype=u.core.dtype, device=u.core.device)
    ps = []
    for _ in range(maxdist):
        # p[x, y] = l A[x] M A[y] r
        p = torch.einsum("m,mnx,nk,kjy,j->xy", l, u.core, M, u.core, r)
        ps.append(p / torch.sum(p))
        M = En @ M
    return torch.stack(ps)


def _lam2(pairs, iters: int = 200) -> torch.Tensor:
    """Leading eigenvalues of the mixed transfers of ``pairs`` of cores of
    one shape pair, in one batched power iteration."""
    return _leading_eig_kron(torch.stack([x for x, _ in pairs]),
                             torch.stack([y for _, y in pairs]), iters)[0]


def uniform_dot(a: UniformMessage, b: UniformMessage) -> torch.Tensor:
    """Cosine overlap per site: lambda(mixed) / sqrt(lambda(aa)
    lambda(bb)); 1 iff the represented functions coincide."""
    x, y = a.core, b.core
    if x.shape == y.shape:
        ab, aa, bb = _lam2([(x, y), (x, x), (y, y)])
    else:
        ab, aa, bb = (_lam2([p])[0] for p in ((x, y), (x, x), (y, y)))
    return ab / torch.sqrt(torch.abs(aa * bb))


def _cholesky_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where ``M`` is not positive definite (as
    JAX's ``cholesky`` returns); no exception and no host sync."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _svd_or_nan(M: torch.Tensor):
    """:func:`batched_svd` of one matrix; a non-finite ``M`` gives NaN
    factors (as XLA's SVD does) instead of LAPACK's exception."""
    bad = ~torch.isfinite(M).all()
    U, S, Vt = batched_svd(torch.where(bad, torch.zeros_like(M), M))
    nan = torch.where(bad, float("nan"), 0.0).to(M.dtype)
    return U + nan, S + nan, Vt + nan


def truncate_vumps(u: UniformMessage, d: int, iters: int = 200
                   ) -> UniformMessage:
    """Canonical-gauge bond truncation to ``d`` (Vidal/Orus scheme):
    Gram fixed points -> Cholesky -> SVD -> oblique projectors."""
    D = u.D
    if D <= d:
        return u
    rho_l, rho_r = _gram_fixed_points(u.core, iters)
    I = torch.eye(D, dtype=u.core.dtype, device=u.core.device)
    L = _cholesky_or_nan(rho_l + _EPS * I).T    # rho_l = L^T L
    R = _cholesky_or_nan(rho_r + _EPS * I)      # rho_r = R R^T
    U, S, Vt = _svd_or_nan(L @ R)
    inv_sqrt = 1.0 / torch.sqrt(S[:d].clamp_min(_EPS))
    P_right = inv_sqrt[:, None] * (U[:, :d].T @ L)          # [d, D]
    P_left = (R @ Vt[:d].T) * inv_sqrt[None, :]             # [D, d]
    core = torch.einsum("am,mnp,nb->abp", P_right, u.core, P_left)
    return UniformMessage(core, u.logz, u.phys)


def truncate_vumps_variational(u: UniformMessage, d: int, iters: int = 100,
                               refine: int = 8) -> UniformMessage:
    """Variational bond truncation of a uniform MPS: maximizes the per-site
    overlap ``lam_mix / sqrt(lam_BB lam_AA)`` over bond-``d`` cores B by
    alternating least squares on ``l_B B r_B ∝ L_mix A R_mix`` (the
    leading eigenvectors of the mixed transfer, and B's Gram fixed points),
    from the canonical-gauge crop.  The refinement is kept only where it
    is finite and no worse than the crop; a Gram that is not positive
    definite makes it NaN, so the crop is kept."""
    D = u.D
    if D <= d:
        return u
    A = u.core
    P = A.shape[2]
    B0 = truncate_vumps(u, d, iters).core
    I = torch.eye(d, dtype=A.dtype, device=A.device)
    B = B0
    for _ in range(refine):
        _, lm, rm = _leading_eig_kron(B[None], A[None], iters)
        G = torch.einsum("am,mnp,bn->abp", lm.reshape(d, D), A,
                         rm.reshape(d, D))
        lB, rB = _gram_fixed_points(B, iters)
        cl = _cholesky_or_nan(lB + _EPS * I)
        cr = _cholesky_or_nan(rB + _EPS * I)
        # solve l_B X r_B = G (PSD: two Cholesky solves)
        X = torch.cholesky_solve(G.reshape(d, d * P), cl).reshape(d, d, P)
        X = torch.cholesky_solve(X.transpose(0, 1).reshape(d, d * P), cr) \
            .reshape(d, d, P).transpose(0, 1)
        B = X / X.abs().amax().clamp_min(1e-300)
    # keep the refinement only where it helps: ALS on a defective
    # environment can stall (non-finite output or a worse overlap)
    (aa,) = _lam2([(A, A)])
    ba, b0a = _lam2([(B, A), (B0, A)])
    bb, b0b0 = _lam2([(B, B), (B0, B0)])
    ov_cand = ba / torch.sqrt(torch.abs(bb * aa))
    ov_crop = b0a / torch.sqrt(torch.abs(b0b0 * aa))
    ok = torch.isfinite(B).all() & (torch.abs(1.0 - ov_cand)
                                    <= torch.abs(1.0 - ov_crop))
    return UniformMessage(torch.where(ok, B, B0), u.logz, u.phys)


def _truncate(u: UniformMessage, d: int, trunc: TruncVUMPS) -> UniformMessage:
    """The variational fit when ``trunc.refine > 0``, else the crop."""
    if trunc.refine > 0:
        return truncate_vumps_variational(u, d, trunc.power_iters,
                                          trunc.refine)
    return truncate_vumps(u, d, trunc.power_iters)


# ---------------------------------------------------------------------------
# BP pieces
# ---------------------------------------------------------------------------

def _lift(mu: UniformMessage, pxy_k, psi_k, Y, q) -> UniformMessage:
    """B_k[m,n,y,xi] = sum_xk Pxy[y,xk,xi] psi[xi,xk] mu[m,n,xk,xi]."""
    A = mu.core.reshape(mu.D, mu.D, q, q)
    B = torch.einsum("yci,ic,mnci->mnyi", pxy_k, psi_k, A)
    return UniformMessage(B.reshape(mu.D, mu.D, Y * q), mu.logz, (Y, q))


def _merge_inf(u1: UniformMessage, u2: UniformMessage, pyy, Y, q
               ) -> UniformMessage:
    """Kronecker merge of two lifted messages, no truncation."""
    D1, D2 = u1.D, u2.D
    a = u1.core.reshape(D1, D1, Y, q)
    b = u2.core.reshape(D2, D2, Y, q)
    tmp = torch.einsum("yabx,mnax->mnybx", pyy, a)
    M = torch.einsum("mnybx,uvbx->munvyx", tmp, b)
    out = UniformMessage(M.reshape(D1 * D2, D1 * D2, Y * q),
                         u1.logz + u2.logz, (Y, q))
    return uniform_normalize_eachmatrix(out)


def _f_bp_partial_inf(C: UniformMessage, Wtab, phi_i, q, Y) -> torch.Tensor:
    """B[m,n,xi,xj,xp] of the cavity C."""
    A = C.core.reshape(C.D, C.D, Y, q)
    return torch.einsum("pijy,mnyi,i->mnijp", Wtab, A, phi_i)


def _mpem2_inf(B: torch.Tensor, logz, qj) -> UniformMessage:
    """Single-SVD rotation of the 5-leg uniform transfer into a 4-leg
    message."""
    Db, qi = B.shape[0], B.shape[2]
    m = B.abs().amax()
    m = torch.where(torch.isfinite(m) & (m > 0), m, torch.ones_like(m))
    B = B / m
    logz = logz - torch.log(m)
    M = B.permute(2, 3, 0, 1, 4).reshape(qi * qj * Db, Db * qi)
    U, S, Vt = _svd_or_nan(M)
    k = S.shape[0]                       # = qi * Db
    C = U.reshape(qi, qj, Db, k)         # [xi, xj, m, k]
    V3 = Vt.reshape(k, Db, qi)           # [k, n, xi']
    D = torch.einsum("m,mli,ijln->mnij", S, V3, C)   # [k, k, qi, qj]
    return UniformMessage(D.reshape(k, k, qi * qj), logz, (qi, qj))


@dataclasses.dataclass
class MPBPStationary:
    """Stationary BP state: per-edge uniform messages (lists), on the device
    of ``phi``."""
    graph: Graph
    tables: RecursiveFactorTables
    phi: torch.Tensor             # [N, q]
    psi: torch.Tensor             # [E, q, q]
    msgs: list                    # [E] UniformMessage (qk, qi)
    beliefs: list                 # [N] UniformMessage (q,)
    f: torch.Tensor               # [N]
    pyy: torch.Tensor             # [G, S, Y, Y, Y, q] dense merge tables

    @property
    def q(self):
        return self.phi.shape[1]

    @property
    def device(self):
        return self.phi.device


def mpbp_stationary(graph: Graph, tables: RecursiveFactorTables, D: int = 1,
                    phi=None, psi=None, dtype=torch.float64,
                    device=None) -> MPBPStationary:
    """Flat stationary state on ``device`` (default: the CUDA card).  The
    stationary mode needs time-constant tables."""
    if tables.time_varying:
        raise ValueError("the stationary mode needs time-constant tables")
    dev = resolve_device(device)
    q = tables.q
    phi = torch.ones((graph.N, q)) if phi is None else \
        torch.as_tensor(np.asarray(phi, float))
    psi = torch.ones((graph.E, q, q)) if psi is None else \
        torch.as_tensor(np.asarray(psi, float))
    msgs = [uniform_normalize(flat_uniform(D, (q, q), dtype, dev))[0]
            for _ in range(graph.E)]
    bels = [flat_uniform(D, (q,), dtype, dev) for _ in range(graph.N)]
    tables = tables.to(dev, dtype)
    if tables.yy_off is None:
        pyy = tables.Pyy
    else:
        pyy = torch.as_tensor(
            _dense_pyy_from_off(tables.yy_off, tables.Y, q)[None],
            dtype=dtype, device=dev)
    return MPBPStationary(graph, tables, phi.to(dev, dtype),
                          psi.to(dev, dtype), msgs, bels,
                          torch.zeros(graph.N, dtype=dtype, device=dev), pyy)


def mpbp_stationary_infinite_graph(k: int, tables, phi=None, psi=None,
                                   D: int = 1, device=None) -> MPBPStationary:
    """Stationary state on the infinite k-regular graph."""
    return mpbp_stationary(infinite_regular_graph(k), tables, D=D, phi=phi,
                           psi=psi, device=device)


def mpbp_stationary_infinite_bipartite_graph(k, tables, phi=None, psi=None,
                                             D: int = 1, device=None
                                             ) -> MPBPStationary:
    """Stationary state on the infinite bipartite graph of degrees
    ``k = (k1, k2)``."""
    return mpbp_stationary(infinite_bipartite_graph(*k), tables, D=D,
                           phi=phi, psi=psi, device=device)


def _node_update(msgs_in, psi_out, Py_i, Pyp_i, Pxy_i, Py0_i, Pyy_i, phi_i,
                 d: int, q: int, Y: int, trunc: TruncVUMPS):
    """One node's update: (d out messages, belief, f_i)."""

    def pyy_at(d1):
        return Pyy_i[min(d1, Pyy_i.shape[0] - 1)]

    B = [_lift(msgs_in[s], Pxy_i[s], psi_out[s], Y, q) for s in range(d)]

    core0 = torch.zeros((1, 1, Y * q), dtype=phi_i.dtype, device=phi_i.device)
    core0[0, 0, :] = Py0_i.reshape(-1)
    init = UniformMessage(core0, torch.zeros_like(phi_i[0]), (Y, q))

    # the cavity-fold bond cap of the JAX package: the reference leaves the
    # stationary fold uncompressed, which is exponential in the degree;
    # re-truncate once the bond exceeds 2 d
    cap = 2 * trunc.d

    def fold(a, b, pyy_t):
        out = _merge_inf(a, b, pyy_t, Y, q)
        if out.D > cap:
            out = _truncate(out, cap, trunc)
        return out

    # prefix / suffix folds
    L = [init]
    for s in range(d):
        L.append(fold(L[-1], B[s], pyy_at(s)))
    R = [None] * (d + 1)
    R[d] = init
    for s in range(d - 1, -1, -1):
        R[s] = fold(B[s], R[s + 1], pyy_at(1))
    full = L[d]

    outs, logzs = [], []
    for s in range(d):
        if d == 1:
            C = init
        elif s == 0:
            C = R[1]
        elif s == d - 1:
            C = L[d - 1]
        else:
            C = fold(L[s], R[s + 1], pyy_at(s))
        B5 = _f_bp_partial_inf(C, Pyp_i[s], phi_i, q, Y)
        mu = _mpem2_inf(B5, C.logz, q)
        mu = _truncate(mu, trunc.d, trunc)
        mu = uniform_normalize_eachmatrix(mu)
        mu, logz_k = uniform_normalize(mu)
        outs.append(mu)
        logzs.append(logz_k)

    Wb = Py_i[:, :, None, :]                         # [q, q, 1, Y]
    B5 = _f_bp_partial_inf(full, Wb, phi_i, q, Y)
    bel = _mpem2_inf(B5, full.logz, 1)
    bel = _truncate(bel, trunc.d, trunc)
    bel = UniformMessage(bel.core.reshape(bel.D, bel.D, q, 1).sum(dim=3),
                         bel.logz, (q,))
    bel, logz_i = uniform_normalize(bel)
    f_i = (d / 2.0 - 1.0) * logz_i - 0.5 * sum(logzs)
    return outs, bel, f_i


def _dense_pyy_from_off(off: int, Y: int, q: int) -> np.ndarray:
    """The banded sum-type merge ``prob_yy(y, y1, y2) = (y == y1 + y2 -
    off)`` as a dense [1, Y, Y, Y, q] table."""
    y = np.arange(Y)
    p = (y[:, None, None] == y[None, :, None] + y[None, None, :] - off)
    return np.broadcast_to(p.astype(float)[None, :, :, :, None],
                           (1, Y, Y, Y, q)).copy()


def _stationary_node_update(bp: MPBPStationary, i: int, trunc: TruncVUMPS):
    """Update node ``i`` in place: its out-messages, belief and ``f[i]``."""
    g, tb, q = bp.graph, bp.tables, bp.q
    Y = tb.Y
    d = int(g.degree[i])
    e_ins = [int(g.in_edges[i, s]) for s in range(d)]
    e_outs = [int(g.rev_edge[e]) for e in e_ins]
    msgs_in = [bp.msgs[e] for e in e_ins]
    psi_out = [bp.psi[e] for e in e_outs]
    outs, bel, f_i = _node_update(
        msgs_in, psi_out,
        tb.Py[i % tb.Py.shape[0]], tb.Pyp[i % tb.Pyp.shape[0]],
        tb.Pxy[i % tb.Pxy.shape[0]], tb.Py0[i % tb.Py0.shape[0]],
        bp.pyy[i % bp.pyy.shape[0]], bp.phi[i], d, q, Y, trunc)
    for s, e in enumerate(e_outs):
        bp.msgs[e] = outs[s]
    bp.beliefs[i] = bel
    bp.f[i] = f_i


def iterate_stationary(bp: MPBPStationary, maxiter: int = 50,
                       trunc: TruncVUMPS | None = None, tol: float = 1e-10):
    """Sweeps with marginal-delta and message-overlap convergence
    (``CB_BPVUMPS``).  Returns ``(bp, iters, deltas, overlaps)``; a
    message whose bond changed counts as overlap 1."""
    trunc = TruncVUMPS(4) if trunc is None else trunc
    m_old = beliefs_stationary(bp)
    deltas, overlaps = [], []
    for it in range(maxiter):
        old_msgs = list(bp.msgs)
        for i in range(bp.graph.N):
            _stationary_node_update(bp, i, trunc)
        m_new = beliefs_stationary(bp)
        delta = float(np.max(np.abs(m_new - m_old)))
        eps = [torch.abs(1.0 - uniform_dot(a, b)) if a.D == b.D
               else a.core.new_ones(()) for a, b in zip(bp.msgs, old_msgs)]
        deltas.append(delta)
        overlaps.append(float(torch.stack(eps).max()))
        if delta < tol:
            return bp, it + 1, deltas, overlaps
        m_old = m_new
    return bp, maxiter, deltas, overlaps


def beliefs_stationary(bp: MPBPStationary) -> np.ndarray:
    """Single-site stationary beliefs [N, q] (host numpy)."""
    return torch.stack([uniform_marginals(b) for b in bp.beliefs]) \
        .cpu().numpy()


def bethe_free_energy_stationary(bp: MPBPStationary) -> float:
    """Free energy density per time step."""
    return float(torch.sum(bp.f))


def pair_beliefs_stationary(bp: MPBPStationary) -> np.ndarray:
    """Per-edge stationary pair marginals [E, q, q] (host numpy)."""
    g, q = bp.graph, bp.q
    out = []
    for e in range(g.E):
        a = bp.msgs[e]
        b = bp.msgs[int(g.rev_edge[e])]
        A = a.core.reshape(a.D, a.D, q, q)
        Bc = b.core.reshape(b.D, b.D, q, q)
        M = torch.einsum("abij,cdji,ij->acbdij", A, Bc, bp.psi[e])
        u = UniformMessage(M.reshape(a.D * b.D, a.D * b.D, q * q),
                           a.logz + b.logz, (q, q))
        out.append(uniform_marginals(u).reshape(q, q))
    return torch.stack(out).cpu().numpy() if out else np.zeros((0, q, q))
