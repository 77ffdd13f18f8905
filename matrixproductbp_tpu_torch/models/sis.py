"""SIS epidemic model (discrete time).

Counterpart of ``matrixproductbp_tpu/models/sis.py``.  States are 0-indexed:
SUSCEPTIBLE=0, INFECTIOUS=1.  The auxiliary y ("some infectious neighbour
transmitted") is binary and merged with OR.  :func:`sis_tables` builds the
node-independent tables with a broadcast node axis of size 1;
``build_tables(g, [SISFactorSpec(...)] * N)`` builds the same factor per
node through the generic path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bp import MPBP, mpbp
from ..factors import FactorSpec, RecursiveFactorTables
from ..graph import Graph
from ..stationary import mpbp_stationary

SUSCEPTIBLE = 0
INFECTIOUS = 1

__all__ = ["SIS", "SISFactorSpec", "sis_tables", "mpbp_sis",
           "periodic_mpbp_sis", "mpbp_stationary_sis", "SUSCEPTIBLE",
           "INFECTIOUS"]


class SISFactorSpec(FactorSpec):
    """Behavioural SIS factor: infection probability ``lam`` per infectious
    neighbour, recovery ``rho``, self-infection ``alpha``."""

    q = 2

    def __init__(self, lam: float, rho: float, alpha: float = 0.0):
        if not (0 <= lam <= 1 and 0 <= rho <= 1 and 0 <= alpha <= 1):
            raise ValueError("lam, rho and alpha must lie in [0, 1]")
        self.lam, self.rho, self.alpha = lam, rho, alpha

    def nstates(self, l: int) -> int:
        return 1 if l == 0 else 2

    def prob_y(self, xp, x, y, d):
        rho, alpha = self.rho, self.alpha
        w = (1.0 - alpha) * (y == SUSCEPTIBLE)
        if xp == INFECTIOUS:
            return (x == INFECTIOUS) * (1 - rho) + (x == SUSCEPTIBLE) * (1 - w)
        return (x == INFECTIOUS) * rho + (x == SUSCEPTIBLE) * w

    def prob_xy(self, y, xk, xi, k):
        pin = self.lam * (xk == INFECTIOUS)
        return pin if y == INFECTIOUS else 1.0 - pin

    def prob_yy(self, y, y1, y2, xi, d1, d2):
        return float((y == INFECTIOUS) ==
                     ((y1 == INFECTIOUS) or (y2 == INFECTIOUS)))

    def prob_y0(self, y, xi):
        return 1.0 if y == SUSCEPTIBLE else 0.0

    def w(self, xp, x_nbrs, x):
        lam, rho, alpha = self.lam, self.rho, self.alpha
        if x == INFECTIOUS:
            return rho if xp == SUSCEPTIBLE else 1 - rho
        p = (1 - alpha) * (1 - lam) ** sum(xk == INFECTIOUS for xk in x_nbrs)
        return p if xp == SUSCEPTIBLE else 1 - p


def sis_tables(graph: Graph, lam: float, rho: float, alpha: float = 0.0
               ) -> RecursiveFactorTables:
    """Dense float64 CPU tables, built by the same loops as the JAX
    package's ``sis_tables`` (so they agree bit for bit)."""
    q, Y = 2, 2
    K = graph.dmax
    spec = SISFactorSpec(lam, rho, alpha)
    Py = np.zeros((1, q, q, Y))
    for xp in range(q):
        for x in range(q):
            for y in range(Y):
                Py[0, xp, x, y] = spec.prob_y(xp, x, y, 0)
    Pxy = np.zeros((1, 1, Y, q, q))
    for y in range(Y):
        for xk in range(q):
            for xi in range(q):
                Pxy[0, 0, y, xk, xi] = spec.prob_xy(y, xk, xi, 0)
    Pxy = np.broadcast_to(Pxy, (1, K, Y, q, q)).copy()
    Pyy = np.zeros((1, Y, Y, Y, q))
    for y in range(Y):
        for a in range(Y):
            for b in range(Y):
                Pyy[0, y, a, b, :] = spec.prob_yy(y, a, b, 0, 1, 1)
    Py0 = np.zeros((1, Y, q))
    Py0[0, SUSCEPTIBLE, :] = 1.0
    Pyp = np.zeros((1, 1, q, q, q, Y))
    for xp in range(q):
        for x in range(q):
            for xk in range(q):
                for y1 in range(Y):
                    Pyp[0, 0, xp, x, xk, y1] = sum(
                        spec.prob_y(xp, x, y, 0) * spec.prob_xy(y2, xk, x, 0)
                        * spec.prob_yy(y, y1, y2, x, 1, 1)
                        for y in range(Y) for y2 in range(Y))
    Pyp = np.broadcast_to(Pyp, (1, K, q, q, q, Y)).copy()
    Pyy_stack = np.broadcast_to(Pyy[:, None], (1, max(K, 1), Y, Y, Y, q)).copy()
    return RecursiveFactorTables(*(torch.from_numpy(a) for a in
                                   (Py, Pyp, Pxy, Pyy_stack, Py0)))


@dataclasses.dataclass
class SIS:
    """Model container (reference ``SIS`` struct)."""
    graph: Graph
    lam: float
    rho: float
    T: int
    gamma: float | np.ndarray = 0.5   # patient-zero probability
    alpha: float = 0.0
    phi: np.ndarray | None = None
    psi: np.ndarray | None = None

    def default_phi(self) -> np.ndarray:
        N, T1 = self.graph.N, self.T + 1
        phi = np.ones((N, T1, 2))
        g = np.broadcast_to(np.asarray(self.gamma), (N,))
        phi[:, 0, SUSCEPTIBLE] = 1 - g
        phi[:, 0, INFECTIOUS] = g
        return phi


def mpbp_sis(sis: SIS, D: int, dtype=torch.float64, periodic: bool = False,
             device=None) -> MPBP:
    """BP state for an SIS model on ``device`` (default: the CUDA card)."""
    tables = sis_tables(sis.graph, sis.lam, sis.rho, sis.alpha)
    phi = sis.phi if sis.phi is not None else sis.default_phi()
    return mpbp(sis.graph, tables, sis.T, D, phi=phi, psi=sis.psi,
                dtype=dtype, periodic=periodic, device=device)


def periodic_mpbp_sis(sis: SIS, D: int, dtype=torch.float64,
                      device=None) -> MPBP:
    """Reference ``periodic_mpbp(::SIS)`` (``sis_bp.jl:49-53``)."""
    return mpbp_sis(sis, D, dtype=dtype, periodic=True, device=device)


def mpbp_stationary_sis(sis: SIS, D: int = 1, device=None):
    """Reference ``mpbp_stationary(::SIS)`` (``sis_bp.jl:55-58``): the
    stationary (T -> infinity uniform) state on ``device`` (default: the
    CUDA card), reweighted by the model's t=0 ``phi`` and ``psi``."""
    tables = sis_tables(sis.graph, sis.lam, sis.rho, sis.alpha)
    phi = sis.phi if sis.phi is not None else sis.default_phi()
    psi0 = None if sis.psi is None else np.asarray(sis.psi)[:, 0]
    return mpbp_stationary(sis.graph, tables, D=D,
                           phi=np.asarray(phi)[:, 0, :], psi=psi0,
                           device=device)
