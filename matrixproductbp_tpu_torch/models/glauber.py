"""Glauber dynamics on Ising models: four factor variants and their dispatch.

Counterpart of ``matrixproductbp_tpu/models/glauber.py``.  States are
0-indexed: x=0 is spin +1, x=1 is spin -1 (``potts2spin(x) = 1 - 2x``).

Variants, picked per node as the reference's ``glauber_factors`` does:
- ``HomogeneousGlauberFactorSpec``  all J equal: y counts +1 spins, Y = d+1
- ``PMJGlauberFactorSpec``          |J| constant, mixed signs: y in 0..2d
- ``IntegerGlauberFactorSpec``      integer J: y = sum J_k s_k + (K-1)
- generic J                          exhaustive trace via ``TraceFactorSpec``

The first three have the sum-type ``prob_yy`` (``sum_y_offset``), so their
tables carry ``yy_off`` and the sweep merges by the banded contraction.
The periodic and stationary constructors are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import torch

from ..bp import MPBP, mpbp
from ..factors import FactorSpec, TraceFactorSpec, build_tables
from ..graph import Graph
from ..stationary import mpbp_stationary

__all__ = ["Ising", "Glauber", "potts2spin", "spin2potts", "energy",
           "HomogeneousGlauberFactorSpec", "PMJGlauberFactorSpec",
           "IntegerGlauberFactorSpec", "GenericGlauberFactorSpec",
           "glauber_factor_specs", "mpbp_glauber", "periodic_mpbp_glauber",
           "mpbp_stationary_glauber"]


def potts2spin(x):
    return 1 - 2 * np.asarray(x)


def spin2potts(s):
    return (1 - np.asarray(s)) // 2


def _glauber_prob(s_next: float, field: float) -> float:
    """P(spin s_next | local field h) = 1/(1+exp(-2 s h)) (``glauber_bp.jl:17-19``)."""
    return 1.0 / (1.0 + np.exp(-2.0 * s_next * field))


@dataclasses.dataclass
class Ising:
    """Ising couplings on a graph (``glauber.jl:6-28``). ``J`` is indexed by
    undirected edge (the order of ``graph.undirected_edges()``)."""
    graph: Graph
    J: np.ndarray
    h: np.ndarray
    beta: float = 1.0

    def __post_init__(self):
        self.J = np.asarray(self.J, float)
        self.h = np.asarray(self.h, float)
        if len(self.J) != self.graph.E // 2 or len(self.h) != self.graph.N:
            raise ValueError("J needs one entry per undirected edge and h "
                             "one per node")

    def directed_J(self) -> np.ndarray:
        """J per *directed* edge id."""
        Jd = np.zeros(self.graph.E)
        for u, (i, j, e) in enumerate(self.graph.undirected_edges()):
            Jd[e] = self.J[u]
            Jd[self.graph.rev_edge[e]] = self.J[u]
        return Jd

    def slot_J(self) -> np.ndarray:
        """J per (node, in-slot): coupling to the slot's neighbor."""
        g = self.graph
        Jd = self.directed_J()
        Js = np.zeros((g.N, g.dmax))
        Js[g.in_mask] = Jd[g.in_edges[g.in_mask]]
        return Js

    def is_homogeneous(self):
        return np.all(self.J == self.J[0]) if len(self.J) else True

    def is_absJ_const(self):
        return (np.all(np.abs(self.J) == np.abs(self.J[0]))
                if len(self.J) else True)


def energy(ising: Ising, x: np.ndarray) -> float:
    """-sum J s_i s_j - sum h s_i (``glauber.jl:30-39``)."""
    s = potts2spin(np.asarray(x))
    e = -np.dot(ising.h, s)
    for u, (i, j, _) in enumerate(ising.graph.undirected_edges()):
        e -= ising.J[u] * s[i] * s[j]
    return float(e)


class HomogeneousGlauberFactorSpec(FactorSpec):
    """All couplings equal: y = number of +1 neighbors (``glauber_bp.jl:22-55``)."""

    q = 2
    sum_y_offset = 0     # prob_yy(y,y1,y2) == (y == y1+y2): banded merge

    def __init__(self, J: float, h: float, beta: float):
        self.bJ, self.bh = beta * J, beta * h

    def nstates(self, l):
        return l + 1

    def prob_y_partial(self, xp, x, xk, y1, d_cav, k):
        """Closed form: the slot contributes y2 = 1 - xk deterministically
        (``recursive_bp_factor.jl:49-54`` specialization)."""
        return self.prob_y(xp, x, y1 + (1 - xk), d_cav + 1)

    def prob_y(self, xp, x, y, d):
        field = self.bJ * (2 * y - d) + self.bh
        return _glauber_prob(1 - 2 * xp, field)

    def prob_xy(self, y, xk, xi, k):
        return float(y == 1 - xk)

    def prob_yy(self, y, y1, y2, xi, d1, d2):
        return float(y == y1 + y2)

    def w(self, xp, x_nbrs, x):
        field = self.bJ * sum(1 - 2 * np.asarray(x_nbrs)) + self.bh
        return _glauber_prob(1 - 2 * xp, field)


class PMJGlauberFactorSpec(FactorSpec):
    """+/-J couplings: y = sum over neighbors of (s_k sign_k + 1) in 0..2d
    (``glauber_bp.jl:57-91``)."""

    q = 2
    sum_y_offset = 0     # prob_yy(y,y1,y2) == (y == y1+y2): banded merge

    def __init__(self, signs: Sequence[int], absJ: float, h: float, beta: float):
        self.signs = list(signs)
        self.bJ, self.bh = beta * absJ, beta * h

    def nstates(self, l):
        return 2 * l + 1

    def prob_y_partial(self, xp, x, xk, y1, d_cav, k):
        y2 = (1 - 2 * xk) * self.signs[k] + 1
        return self.prob_y(xp, x, y1 + y2, d_cav + 1)

    def prob_y(self, xp, x, y, d):
        field = self.bJ * (y - d) + self.bh
        return _glauber_prob(1 - 2 * xp, field)

    def prob_xy(self, y, xk, xi, k):
        return float(y == (1 - 2 * xk) * self.signs[k] + 1)

    def prob_yy(self, y, y1, y2, xi, d1, d2):
        return float(y == y1 + y2)

    def w(self, xp, x_nbrs, x):
        field = self.bJ * sum(s * (1 - 2 * xk)
                              for s, xk in zip(self.signs, x_nbrs)) + self.bh
        return _glauber_prob(1 - 2 * xp, field)


class IntegerGlauberFactorSpec(FactorSpec):
    """Integer couplings: y = sum J_k s_k + (K-1), K = sum|J|+1
    (``glauber_bp.jl:144-179``)."""

    q = 2

    def __init__(self, J: Sequence[int], h: float, beta: float):
        self.J = [int(j) for j in J]
        self.h, self.beta = h, beta
        self.K = int(sum(abs(j) for j in self.J)) + 1
        # prob_yy(y,y1,y2) == (y == y1+y2-(K-1)): banded merge
        self.sum_y_offset = self.K - 1

    def nstates(self, l):
        return 2 * self.K - 1

    def prob_y_partial(self, xp, x, xk, y1, d_cav, k):
        y = y1 + (1 - 2 * xk) * self.J[k]
        if not (0 <= y < 2 * self.K - 1):
            return 0.0
        return self.prob_y(xp, x, y, d_cav + 1)

    def prob_y(self, xp, x, y, d):
        field = self.beta * ((y - (self.K - 1)) + self.h)
        return _glauber_prob(1 - 2 * xp, field)

    def prob_xy(self, y, xk, xi, k):
        return float(y == (1 - 2 * xk) * self.J[k] + self.K - 1)

    def prob_yy(self, y, y1, y2, xi, d1, d2):
        return float(y + self.K - 1 == y1 + y2)

    def prob_y0(self, y, xi):
        return float(y == self.K - 1)

    def w(self, xp, x_nbrs, x):
        field = self.beta * (sum(j * (1 - 2 * xk)
                                 for j, xk in zip(self.J, x_nbrs)) + self.h)
        return _glauber_prob(1 - 2 * xp, field)


def GenericGlauberFactorSpec(J: Sequence[float], h: float, beta: float,
                             degree: int) -> TraceFactorSpec:
    """Arbitrary real couplings -> exhaustive-trace path (``glauber_bp.jl:1-20``)."""
    Jv = [float(j) for j in J]

    def fn(xp, x_nbrs, x):
        field = beta * (sum(j * (1 - 2 * xk)
                            for j, xk in zip(Jv, x_nbrs)) + h)
        return _glauber_prob(1 - 2 * xp, field)

    return TraceFactorSpec(fn, 2, degree)


def glauber_factor_specs(ising: Ising, force: str | None = None):
    """Pick the cheapest factor variant per node (``glauber_factors``,
    ``glauber_bp.jl:119-142``).  ``force`` in {None, 'homogeneous', 'pmj',
    'integer', 'generic'} overrides the dispatch (for cross-validation)."""
    g = ising.graph
    Js = ising.slot_J()
    specs = []
    for i in range(g.N):
        d = int(g.degree[i])
        J = Js[i, :d]
        h = float(ising.h[i])
        kind = force
        if kind is None:
            if ising.is_absJ_const():
                kind = "homogeneous" if ising.is_homogeneous() else "pmj"
            elif np.all(J == np.round(J)):
                kind = "integer"
            else:
                kind = "generic"
        if kind == "homogeneous":
            J0 = float(J[0]) if d else (float(ising.J[0]) if len(ising.J) else 0.0)
            specs.append(HomogeneousGlauberFactorSpec(J0, h, ising.beta))
        elif kind == "pmj":
            absJ = float(abs(J[0])) if d else 0.0
            specs.append(PMJGlauberFactorSpec(
                np.sign(J).astype(int).tolist(), absJ, h, ising.beta))
        elif kind == "integer":
            specs.append(IntegerGlauberFactorSpec(
                np.round(J).astype(int).tolist(), h, ising.beta))
        elif kind == "generic":
            specs.append(GenericGlauberFactorSpec(J.tolist(), h, ising.beta, d))
        else:
            raise ValueError(kind)
    return specs


@dataclasses.dataclass
class Glauber:
    """Dynamics container with observations (``glauber.jl:43-64``)."""
    ising: Ising
    T: int
    phi: np.ndarray | None = None       # [N, T1, 2]
    psi: np.ndarray | None = None       # [E, T1, 2, 2] per directed edge


def mpbp_glauber(gl: Glauber, D: int, force: str | None = None,
                 dtype=torch.float64, periodic: bool = False,
                 device=None) -> MPBP:
    """BP state for Glauber dynamics on ``device`` (default: the CUDA card);
    reference ``mpbp(::Glauber)`` (``glauber_bp.jl:94-100``).  The factor
    variant is picked per node as :func:`glauber_factor_specs` does;
    ``periodic=True`` mirrors ``periodic_mpbp(::Glauber)``
    (``glauber_bp.jl:102-108``)."""
    specs = glauber_factor_specs(gl.ising, force)
    tables = build_tables(gl.ising.graph, specs)
    return mpbp(gl.ising.graph, tables, gl.T, D, phi=gl.phi, psi=gl.psi,
                dtype=dtype, periodic=periodic, device=device)


def periodic_mpbp_glauber(gl: Glauber, D: int, force: str | None = None,
                          dtype=torch.float64, device=None) -> MPBP:
    """Reference ``periodic_mpbp(::Glauber)`` (``glauber_bp.jl:102-108``)."""
    return mpbp_glauber(gl, D, force=force, dtype=dtype, periodic=True,
                        device=device)


def mpbp_stationary_glauber(gl: Glauber, D: int = 1,
                            force: str | None = None, device=None):
    """Reference ``mpbp_stationary(::Glauber)`` (``glauber_bp.jl:110-116``)
    on ``device`` (default: the CUDA card)."""
    specs = glauber_factor_specs(gl.ising, force)
    tables = build_tables(gl.ising.graph, specs)
    phi0 = None if gl.phi is None else np.asarray(gl.phi)[:, 0, :]
    psi0 = None if gl.psi is None else np.asarray(gl.psi)[:, 0]
    return mpbp_stationary(gl.ising.graph, tables, D=D, phi=phi0, psi=psi0,
                           device=device)
