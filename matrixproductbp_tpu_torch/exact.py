"""Exhaustive-enumeration oracle for tiny instances.

Counterpart of ``matrixproductbp_tpu/exact.py:29-122``: enumerate every
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

__all__ = ["exact_prob", "exact_marginals"]


def _decode_all(Q: int, q: int, N: int, T1: int) -> np.ndarray:
    """X[Q, N, T1]: trajectory of config index x; time is the fast digit."""
    codes = np.arange(Q, dtype=np.int64)
    digits = (codes[:, None] // (q ** np.arange(N * T1, dtype=np.int64))) % q
    return digits.reshape(Q, N, T1).astype(np.int64)


def exact_prob(bp: MPBP):
    """(p[Q], Z): exact trajectory distribution and partition function."""
    if bp.periodic:
        raise NotImplementedError("periodic trains are not ported yet "
                                  "(ROADMAP Queue 1 item 6)")
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
        for t in range(T1 - 1):
            xt = torch.as_tensor(X[:, :, t])
            p = transition_probs(tables, mask, xt[:, nbr], xt).numpy()
            logp += np.log(p[np.arange(Q)[:, None], ar,
                             X[:, :, t + 1]]).sum(axis=1)
        src, dst = g.edge_src, g.edge_dst
        for t in range(T1):
            logp += 0.5 * np.log(
                psi[np.arange(g.E)[None, :], t, X[:, src, t], X[:, dst, t]]
            ).sum(axis=1)
    m = logp.max()
    logZ = m + np.log(np.exp(logp - m).sum())
    return np.exp(logp - logZ), np.exp(logZ)


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
