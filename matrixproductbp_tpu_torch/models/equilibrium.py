"""Equilibrium oracles for Ising on random graphs.

Counterpart (a numpy copy) of ``matrixproductbp_tpu/models/equilibrium.py``:
the scalar cavity-field fixed point on random-regular graphs and population
dynamics over degree, coupling and field distributions.  Scalar oracles
that validate dynamics at stationarity; nothing here runs on the card.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

__all__ = ["RandomRegular", "ErdosRenyi", "equilibrium_observables",
           "equilibrium_magnetization", "CB_Pop"]


class CB_Pop:
    """Records the population-mean trajectory of the population-dynamics
    solver (reference ``CB_Pop``, ``equilibrium.jl:43-69``).  Pass as
    ``callback=`` to :func:`equilibrium_magnetization`."""

    def __init__(self):
        self.m: list = []

    def __call__(self, it: int, m: float) -> None:
        self.m.append(m)


@dataclasses.dataclass(frozen=True)
class RandomRegular:
    k: int


@dataclasses.dataclass(frozen=True)
class ErdosRenyi:
    c: float


def _iterate_fixedpoint(f, init, maxiter=1000, rtol=1e-16, atol=0.0, damp=0.0):
    x = init
    err = np.inf
    for _ in range(maxiter):
        xnew = f(x)
        err = abs(x - xnew)
        if err <= max(atol, rtol * max(abs(x), abs(xnew))):
            return x
        x = (1 - damp) * xnew + damp * x
    warnings.warn(f"fixed point iterations did not converge, err={err}")
    return x


def equilibrium_observables(g: RandomRegular, J, beta=1.0, h=0.0,
                            maxiter=1000, tol=1e-16, init=None, damp=0.0):
    """(m, r, e): magnetization, nn correlation, energy density at
    equilibrium on the infinite k-regular graph (``equilibrium.jl:25-34``)."""
    k = g.k
    if init is None:
        init = 100.0 * (np.sign(h) + np.random.default_rng(0).random())

    def f(u):
        return (k - 1) / beta * np.arctanh(
            np.tanh(beta * u) * np.tanh(beta * J)) + h

    ustar = _iterate_fixedpoint(f, init, maxiter, rtol=tol, atol=tol, damp=damp)
    m = np.tanh(beta * (h + (ustar - h) * k / (k - 1)))
    tj, tu = np.tanh(beta * J), np.tanh(beta * ustar)
    r = (1 + tu ** 2 / tj) / (1 / tj + tu ** 2)
    e = -k / 2 * J * r - m * h
    return m, r, e


def equilibrium_magnetization(g, pJ=None, beta=1.0, ph=None, popsize=10**3,
                              maxiter=10**3, tol=None, nsamples=10**3,
                              rng=None, callback=None):
    """Population-dynamics estimate of |m| with standard error
    (``equilibrium_magnetization``, ``equilibrium.jl:85-127``).

    ``g``: RandomRegular or ErdosRenyi; ``pJ``/``ph``: samplers (rng, size) ->
    array, defaulting to constants 1 / 0.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    tol = 0.1 / np.sqrt(popsize) if tol is None else tol
    pJ = (lambda r, s: np.ones(s)) if pJ is None else pJ
    ph = (lambda r, s: np.zeros(s)) if ph is None else ph

    if isinstance(g, RandomRegular):
        def sample_km1(size):
            return np.full(size, g.k - 1)

        def sample_k(size):
            return np.full(size, g.k)
    elif isinstance(g, ErdosRenyi):
        def sample_km1(size):
            return rng.poisson(g.c, size)

        def sample_k(size):
            return rng.poisson(g.c, size)
    else:
        raise TypeError(g)

    P = rng.standard_normal(popsize)
    m_old = np.inf
    for it in range(maxiter):
        km1 = sample_km1(popsize)
        for idx in range(popsize):
            k = int(km1[idx])
            us = P[rng.integers(0, popsize, k)]
            Js = pJ(rng, k)
            h = float(ph(rng, 1)[0])
            P[idx] = np.sum(np.arctanh(np.tanh(beta * us)
                                       * np.tanh(beta * Js))) / beta + h
        m_new = P.mean()
        if callback is not None:
            callback(it, float(m_new))
        if abs(m_new - m_old) < tol:
            break
        m_old = m_new
    else:
        warnings.warn("population dynamics did not converge")

    ks = sample_k(nsamples)
    m = np.empty(nsamples)
    for s in range(nsamples):
        k = int(ks[s])
        us = P[rng.integers(0, popsize, k)]
        Js = pJ(rng, k)
        h = float(ph(rng, 1)[0])
        u = np.sum(np.arctanh(np.tanh(beta * us) * np.tanh(beta * Js))) / beta + h
        m[s] = np.tanh(beta * u)
    return abs(m.mean()), m.std() / np.sqrt(nsamples)
