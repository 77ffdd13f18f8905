"""Epidemic inference metrics: patient-zero ranking, ROC/AUC, marginal
errors.

Counterpart of ``matrixproductbp_tpu/models/inference.py``.  The metrics are
numpy; :func:`find_infected_bp` runs the port's BP on the state's device.
"""
from __future__ import annotations

import numpy as np

from .. import bp as bpmod
from ..ops.truncation import TruncBond

__all__ = ["find_infected_bp", "roc", "auc", "kl_marginals", "l1_marginals"]


def find_infected_bp(bp, trunc=None, tol=1e-3, maxiter=100,
                     require_convergence=True):
    """Rank nodes by posterior infection probability at every time
    (``inference.jl:3-24``).  Returns guesses[t] = node indices sorted by
    decreasing P(infected at t)."""
    trunc = TruncBond(5) if trunc is None else trunc
    bp = bpmod.reset_messages(bp)
    bp, iters, _ = bpmod.iterate(bp, maxiter=maxiter, trunc=trunc, tol=tol)
    if require_convergence and iters == maxiter:
        raise RuntimeError("BP did not converge")
    b = bpmod.beliefs(bp).double().cpu().numpy()    # [N, T1, q]
    T1 = b.shape[1]
    guesses = [np.argsort(b[:, t, 0]) for t in range(T1)]  # ascending P(S)
    return guesses, bp


def roc(guess_zp, true_zp):
    """Cumulative false/true positives along the ranking (``inference.jl:27-36``)."""
    r = np.isin(np.asarray(guess_zp), np.asarray(true_zp))
    if r.sum() == 0:
        return np.zeros(len(r)), np.ones(len(r))
    return np.cumsum(~r), np.cumsum(r)


def auc(guess_zp, true_zp):
    """Area under the ROC curve (``inference.jl:38-51``)."""
    x, y = roc(guess_zp, true_zp)
    Z = x.max() * y.max()
    if Z == 0:
        return 1.0
    a = 0.0
    for i in range(1, len(y)):
        if y[i] == y[i - 1]:
            a += y[i]
    return a / Z


def _xlogy(x, y):
    out = np.zeros_like(np.asarray(x, float))
    m = np.asarray(x) > 0
    out[m] = np.asarray(x)[m] * np.log(np.asarray(y)[m])
    return out


def kl_marginals(b_guess, b_true):
    """Mean KL(b_guess || b_true) per time (``inference.jl:54-81``)."""
    bg, bt = np.asarray(b_guess), np.asarray(b_true)
    kl = (_xlogy(bg, bg) - _xlogy(bg, bt)).sum(axis=2)   # [N, T1]
    return kl.mean(axis=0)


def l1_marginals(b_guess, b_true, state=1):
    """Mean |b_guess - b_true| of the target state per time
    (``inference.jl:84-96``)."""
    bg, bt = np.asarray(b_guess), np.asarray(b_true)
    return np.abs(bg[:, :, state] - bt[:, :, state]).mean(axis=0)
