"""Exhaustive-enumeration oracle for tiny instances.

Counterpart of ``matrixproductbp_tpu/exact.py``: enumerate every
trajectory of the reweighted dynamics, accumulate log-factors from the dense
factor tables (``factors.transition_probs``) and normalize.  It shares no
code path with the BP sweep.  Runs on the host in float64 whatever the
state's device.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .bp import MPBP
from .factors import transition_probs

__all__ = [
    "exact_prob", "site_marginals", "exact_marginals",
    "exact_pair_marginals", "exact_alternate_marginals",
    "exact_autocorrelations", "exact_autocovariances",
    "exact_marginal_expectations", "exact_pair_marginal_expectations",
    "exact_alternate_marginal_expectations",
]


def _decode_all(Q: int, q: int, N: int, T1: int) -> np.ndarray:
    """X[Q, N, T1]: trajectory of config index x; time is the fast digit."""
    codes = np.arange(Q, dtype=np.int64)
    digits = (codes[:, None] // (q ** np.arange(N * T1, dtype=np.int64))) % q
    return digits.reshape(Q, N, T1).astype(np.int64)


def exact_prob(bp: MPBP):
    """(p[Q], Z): exact trajectory distribution and partition function.
    Step t reads the tables of step t (``tables.at_time``); a periodic state
    adds the wrap x^T -> x^0 with the last step's (``exact.py:75-83``)."""
    g = bp.graph
    N, T1, q = bp.N, bp.T + 1, bp.q
    if N * (T1 - 1) > 16:
        warnings.warn(f"T*N={N * (T1 - 1)}: exhaustive enumeration will be slow")
    Q = q ** (N * T1)
    X = _decode_all(Q, q, N, T1)                      # [Q, N, T1]
    phi = bp.phi.detach().cpu().double().numpy()
    psi = bp.psi.detach().cpu().double().numpy()
    tables = bp.tables.to(device="cpu", dtype=torch.float64)
    nbr = np.minimum(g.nbr, g.N - 1)
    mask = torch.as_tensor(g.in_mask)
    ar = np.arange(N)[None, :]
    with np.errstate(divide="ignore"):
        logp = np.zeros(Q)
        for t in range(T1):
            logp += np.log(phi[ar, t, X[:, :, t]]).sum(axis=1)
        for t in range(T1 if bp.periodic else T1 - 1):
            xt = torch.as_tensor(X[:, :, t])
            p = transition_probs(tables.at_time(t), mask, xt[:, nbr],
                                 xt).numpy()
            logp += np.log(p[np.arange(Q)[:, None], ar,
                             X[:, :, (t + 1) % T1]]).sum(axis=1)
        src, dst = g.edge_src, g.edge_dst
        for t in range(T1):
            logp += 0.5 * np.log(
                psi[np.arange(g.E)[None, :], t, X[:, src, t], X[:, dst, t]]
            ).sum(axis=1)
    m = logp.max()
    logZ = m + np.log(np.exp(logp - m).sum())
    return np.exp(logp - logZ), np.exp(logZ)


def site_marginals(bp: MPBP, p=None):
    """Full per-site trajectory marginals: a list of [q]*T1 arrays."""
    if p is None:
        p, _ = exact_prob(bp)
    N, T1, q = bp.N, bp.T + 1, bp.q
    X = _decode_all(len(p), q, N, T1)
    out = []
    for i in range(N):
        m = np.zeros((q,) * T1)
        np.add.at(m, tuple(X[:, i, t] for t in range(T1)), p)
        out.append(m)
    return out


def exact_marginals(bp: MPBP, p=None) -> np.ndarray:
    """[N, T1, q] single-site single-time marginals."""
    if p is None:
        p, _ = exact_prob(bp)
    N, T1, q = bp.N, bp.T + 1, bp.q
    X = _decode_all(len(p), q, N, T1)
    out = np.zeros((N, T1, q))
    for i in range(N):
        for t in range(T1):
            np.add.at(out[i, t], X[:, i, t], p)
    return out


def _values(q: int, values) -> np.ndarray:
    return np.arange(q, dtype=float) if values is None else np.asarray(values)


def exact_pair_marginals(bp: MPBP, p=None) -> np.ndarray:
    """[E, T1, q, q] same-time pair marginals per directed edge, legs
    (x_src, x_dst)."""
    if p is None:
        p, _ = exact_prob(bp)
    g = bp.graph
    N, T1, q = bp.N, bp.T + 1, bp.q
    X = _decode_all(len(p), q, N, T1)
    out = np.zeros((g.E, T1, q, q))
    for e in range(g.E):
        i, j = int(g.edge_src[e]), int(g.edge_dst[e])
        for t in range(T1):
            np.add.at(out[e, t], (X[:, i, t], X[:, j, t]), p)
    return out


def exact_alternate_marginals(bp: MPBP, p=None) -> np.ndarray:
    """[E, T1-1, q, q]: p(x_i^t, x_j^{t+1}) per directed edge (i, j)."""
    if p is None:
        p, _ = exact_prob(bp)
    g = bp.graph
    N, T1, q = bp.N, bp.T + 1, bp.q
    X = _decode_all(len(p), q, N, T1)
    out = np.zeros((g.E, T1 - 1, q, q))
    for e in range(g.E):
        i, j = int(g.edge_src[e]), int(g.edge_dst[e])
        for t in range(T1 - 1):
            np.add.at(out[e, t], (X[:, i, t], X[:, j, t + 1]), p)
    return out


def exact_autocorrelations(bp: MPBP, values=None, p=None) -> np.ndarray:
    """[N, T1, T1] <f(x^t) f(x^u)> for t < u (zero elsewhere)."""
    if p is None:
        p, _ = exact_prob(bp)
    N, T1, q = bp.N, bp.T + 1, bp.q
    v = _values(q, values)
    X = _decode_all(len(p), q, N, T1)
    out = np.zeros((N, T1, T1))
    for i in range(N):
        fv = v[X[:, i, :]]                            # [Q, T1]
        for t in range(T1):
            for u in range(t + 1, T1):
                out[i, t, u] = np.sum(fv[:, t] * fv[:, u] * p)
    return out


def exact_marginal_expectations(bp: MPBP, values=None, p=None) -> np.ndarray:
    """[N, T1] <f(x_i^t)>."""
    return exact_marginals(bp, p) @ _values(bp.q, values)


def exact_autocovariances(bp: MPBP, values=None, p=None) -> np.ndarray:
    """[N, T1, T1] autocorrelations minus the product of means, t < u."""
    if p is None:
        p, _ = exact_prob(bp)
    r = exact_autocorrelations(bp, values, p)
    mu = exact_marginal_expectations(bp, values, p)
    c = r - mu[:, :, None] * mu[:, None, :]
    T1 = mu.shape[1]
    return c * np.triu(np.ones((T1, T1), bool), k=1)[None]


def exact_pair_marginal_expectations(bp: MPBP, values=None, p=None
                                     ) -> np.ndarray:
    """[E, T1] <f(x_i^t) f(x_j^t)> per directed edge."""
    v = _values(bp.q, values)
    return np.einsum("etab,a,b->et", exact_pair_marginals(bp, p), v, v)


def exact_alternate_marginal_expectations(bp: MPBP, values=None, p=None
                                          ) -> np.ndarray:
    """[E, T1-1] <f(x_i^t) f(x_j^{t+1})> per directed edge."""
    v = _values(bp.q, values)
    return np.einsum("etab,a,b->et", exact_alternate_marginals(bp, p), v, v)
