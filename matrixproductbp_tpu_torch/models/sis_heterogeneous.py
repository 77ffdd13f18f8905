"""Heterogeneous SIS: per-edge infection rates, per-node recovery and
self-infection.

Counterpart of ``matrixproductbp_tpu/models/sis_heterogeneous.py``.  Here
``prob_xy`` depends on the neighbour slot ``k`` (per-edge lambda), which
exercises the slot axis of the ``Pxy`` and ``Pyp`` tables.  The periodic
constructor is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bp import MPBP, mpbp
from ..factors import FactorSpec, build_tables
from ..graph import Graph
from .sis import SUSCEPTIBLE, INFECTIOUS

__all__ = ["SISHeterogeneous", "SISHeterogeneousFactorSpec",
           "mpbp_sis_heterogeneous", "periodic_mpbp_sis_heterogeneous"]


class SISHeterogeneousFactorSpec(FactorSpec):
    """Per-slot lambda vector (``SIS_heterogeneousFactor``,
    ``sis_heterogeneous_bp.jl:4-16``)."""

    q = 2

    def __init__(self, lams, rho, alpha=0.0):
        self.lams = [float(v) for v in lams]
        self.rho, self.alpha = rho, alpha

    def nstates(self, l):
        return 1 if l == 0 else 2

    def prob_y(self, xp, x, y, d):
        w = (1.0 - self.alpha) * (y == SUSCEPTIBLE)
        if xp == INFECTIOUS:
            return (x == INFECTIOUS) * (1 - self.rho) + (x == SUSCEPTIBLE) * (1 - w)
        return (x == INFECTIOUS) * self.rho + (x == SUSCEPTIBLE) * w

    def prob_xy(self, y, xk, xi, k):
        pin = self.lams[k] * (xk == INFECTIOUS)
        return pin if y == INFECTIOUS else 1.0 - pin

    def prob_yy(self, y, y1, y2, xi, d1, d2):
        return float((y == INFECTIOUS) ==
                     ((y1 == INFECTIOUS) or (y2 == INFECTIOUS)))

    def prob_y0(self, y, xi):
        return 1.0 if y == SUSCEPTIBLE else 0.0

    def w(self, xp, x_nbrs, x):
        if x == INFECTIOUS:
            return self.rho if xp == SUSCEPTIBLE else 1 - self.rho
        p = 1 - self.alpha
        for lam, xk in zip(self.lams, x_nbrs):
            p *= 1 - lam * (xk == INFECTIOUS)
        return p if xp == SUSCEPTIBLE else 1 - p


@dataclasses.dataclass
class SISHeterogeneous:
    """Per-directed-edge lambda (indexed like the graph's directed edges —
    lam_d[e] is the rate of infection *along* e = (src -> dst)), per-node rho.

    Reference takes a sparse matrix lambda[i, j] (``sis_heterogeneous.jl``);
    entry (k -> i) governs slot k of node i, matching ``nzrange`` order.
    """
    graph: Graph
    lam_d: np.ndarray            # [E]
    rho: np.ndarray              # [N]
    T: int
    gamma: float | np.ndarray = 0.5
    alpha: np.ndarray | None = None
    phi: np.ndarray | None = None
    psi: np.ndarray | None = None

    def default_phi(self) -> np.ndarray:
        N, T1 = self.graph.N, self.T + 1
        phi = np.ones((N, T1, 2))
        g = np.broadcast_to(np.asarray(self.gamma), (N,))
        phi[:, 0, SUSCEPTIBLE] = 1 - g
        phi[:, 0, INFECTIOUS] = g
        return phi


def mpbp_sis_heterogeneous(m: SISHeterogeneous, D: int,
                           dtype=torch.float64, periodic: bool = False,
                           device=None) -> MPBP:
    """BP state for heterogeneous SIS on ``device`` (default: the CUDA
    card): one spec a node, with the rates of its in-edges by slot;
    ``periodic`` makes the state trace-closed."""
    g = m.graph
    alpha = np.zeros(g.N) if m.alpha is None else np.asarray(m.alpha)
    specs = []
    for i in range(g.N):
        d = int(g.degree[i])
        lams = [float(m.lam_d[g.in_edges[i, k]]) for k in range(d)]
        specs.append(SISHeterogeneousFactorSpec(lams, float(m.rho[i]),
                                                float(alpha[i])))
    tables = build_tables(g, specs)
    phi = m.phi if m.phi is not None else m.default_phi()
    return mpbp(g, tables, m.T, D, phi=phi, psi=m.psi, dtype=dtype,
                periodic=periodic, device=device)


def periodic_mpbp_sis_heterogeneous(m: SISHeterogeneous, D: int,
                                    dtype=torch.float64, device=None) -> MPBP:
    """Reference ``periodic_mpbp(::SIS_heterogeneous)``."""
    return mpbp_sis_heterogeneous(m, D, dtype=dtype, periodic=True,
                                  device=device)
