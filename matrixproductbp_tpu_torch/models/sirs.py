"""SIRS epidemic model (3 states: S=0, I=1, R=2).

Counterpart of ``matrixproductbp_tpu/models/sirs.py``: infection lam,
recovery rho, deimmunization sigma, self-infection alpha; the auxiliary
variable stays binary (OR-merge).  The periodic and stationary constructors
are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bp import MPBP, mpbp
from ..factors import FactorSpec, build_tables
from ..graph import Graph
from ..stationary import mpbp_stationary
from .sis import SUSCEPTIBLE, INFECTIOUS

RECOVERED = 2

__all__ = ["SIRS", "SIRSFactorSpec", "mpbp_sirs", "periodic_mpbp_sirs",
           "mpbp_stationary_sirs", "RECOVERED"]


class SIRSFactorSpec(FactorSpec):
    """Mirrors ``SIRSFactor`` (``sirs_bp.jl:1-60``)."""

    q = 3

    def __init__(self, lam, rho, sigma, alpha=0.0):
        if not all(0 <= v <= 1 for v in (lam, rho, sigma, alpha)):
            raise ValueError("lam, rho, sigma and alpha must lie in [0, 1]")
        self.lam, self.rho, self.sigma, self.alpha = lam, rho, sigma, alpha

    def nstates(self, l):
        return 1 if l == 0 else 2

    def prob_y(self, xp, x, y, d):
        lam, rho, sigma, alpha = self.lam, self.rho, self.sigma, self.alpha
        w = (1.0 - alpha) * (y == SUSCEPTIBLE)
        if xp == INFECTIOUS:
            return (x == INFECTIOUS) * (1 - rho) + (x == SUSCEPTIBLE) * (1 - w)
        if xp == SUSCEPTIBLE:
            return (x == RECOVERED) * sigma + (x == SUSCEPTIBLE) * w
        return (x == INFECTIOUS) * rho + (x == RECOVERED) * (1 - sigma)

    def prob_xy(self, y, xk, xi, k):
        pin = self.lam * (xk == INFECTIOUS)
        return pin if y == INFECTIOUS else 1.0 - pin

    def prob_yy(self, y, y1, y2, xi, d1, d2):
        return float((y == INFECTIOUS) ==
                     ((y1 == INFECTIOUS) or (y2 == INFECTIOUS)))

    def prob_y0(self, y, xi):
        return 1.0 if y == SUSCEPTIBLE else 0.0

    def w(self, xp, x_nbrs, x):
        lam, rho, sigma, alpha = self.lam, self.rho, self.sigma, self.alpha
        if x == INFECTIOUS:
            return rho if xp == RECOVERED else (1 - rho if xp == INFECTIOUS else 0.0)
        if x == RECOVERED:
            return sigma if xp == SUSCEPTIBLE else (1 - sigma if xp == RECOVERED else 0.0)
        p = (1 - alpha) * (1 - lam) ** sum(xk == INFECTIOUS for xk in x_nbrs)
        return p if xp == SUSCEPTIBLE else (1 - p if xp == INFECTIOUS else 0.0)


@dataclasses.dataclass
class SIRS:
    """Model container (reference ``SIRS`` struct, ``sirs.jl:1-33``)."""
    graph: Graph
    lam: float
    rho: float
    sigma: float
    T: int
    gamma: float | np.ndarray = 0.5
    alpha: float = 0.0
    phi: np.ndarray | None = None
    psi: np.ndarray | None = None

    def default_phi(self) -> np.ndarray:
        N, T1 = self.graph.N, self.T + 1
        phi = np.ones((N, T1, 3))
        g = np.broadcast_to(np.asarray(self.gamma), (N,))
        phi[:, 0, SUSCEPTIBLE] = 1 - g
        phi[:, 0, INFECTIOUS] = g
        phi[:, 0, RECOVERED] = 0.0
        return phi


def mpbp_sirs(sirs: SIRS, D: int, dtype=torch.float64,
              periodic: bool = False, device=None) -> MPBP:
    """BP state for an SIRS model on ``device`` (default: the CUDA card);
    reference ``mpbp(::SIRS)`` (``sirs_bp.jl:22-26``).  The tables come
    from :func:`build_tables`: per-node, with a dense ``prob_yy``;
    ``periodic`` makes the state trace-closed."""
    spec = SIRSFactorSpec(sirs.lam, sirs.rho, sirs.sigma, sirs.alpha)
    tables = build_tables(sirs.graph, [spec] * sirs.graph.N)
    phi = sirs.phi if sirs.phi is not None else sirs.default_phi()
    return mpbp(sirs.graph, tables, sirs.T, D, phi=phi, psi=sirs.psi,
                dtype=dtype, periodic=periodic, device=device)


def periodic_mpbp_sirs(sirs: SIRS, D: int, dtype=torch.float64,
                       device=None) -> MPBP:
    """Trace-closed SIRS state (reference ``periodic_mpbp(::SIRS)``)."""
    return mpbp_sirs(sirs, D, dtype=dtype, periodic=True, device=device)


def mpbp_stationary_sirs(sirs: SIRS, D: int = 1, device=None):
    """Stationary SIRS state on ``device`` (default: the CUDA card): the
    pattern of ``mpbp_stationary(::SIS)`` applied to SIRS."""
    spec = SIRSFactorSpec(sirs.lam, sirs.rho, sirs.sigma, sirs.alpha)
    tables = build_tables(sirs.graph, [spec] * sirs.graph.N)
    phi = sirs.phi if sirs.phi is not None else sirs.default_phi()
    psi0 = None if sirs.psi is None else np.asarray(sirs.psi)[:, 0]
    return mpbp_stationary(sirs.graph, tables, D=D,
                           phi=np.asarray(phi)[:, 0, :], psi=psi0,
                           device=device)
