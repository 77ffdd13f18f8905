"""Pair-observation builders: sparse (i, j, t, psi) lists -> dense psi arrays.

A numpy copy of ``matrixproductbp_tpu/observations.py`` (reference
``mpbp.jl:327-396``).  The dense ``psi[E, T1, q, q]`` layout (legs x_src,
x_dst) is what ``mpbp`` takes; the reverse edge always carries the
transpose, so the symmetry ``mpbp`` checks holds.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph

__all__ = ["pair_observations_directed", "pair_observations_nondirected",
           "pair_obs_undirected_to_directed"]


def _edge_index(graph: Graph):
    return {(int(graph.edge_src[e]), int(graph.edge_dst[e])): e
            for e in range(graph.E)}


def pair_observations_directed(obs, graph: Graph, T: int, q: int
                               ) -> np.ndarray:
    """obs: list of (i, j, t, psi_matrix[q, q]) with psi in (x_i, x_j)
    order -> dense psi[E, T1, q, q]: each observation is installed on edge
    (i, j) and, transposed, on (j, i)."""
    psi = np.ones((graph.E, T + 1, q, q))
    eidx = _edge_index(graph)
    for (i, j, t, m) in obs:
        m = np.asarray(m, float)
        if m.shape != (q, q):
            raise ValueError(f"pair observation of shape {m.shape}, want "
                             f"{(q, q)}")
        psi[eidx[(int(i), int(j))], t] = m
        psi[eidx[(int(j), int(i))], t] = m.T
    return psi


def pair_observations_nondirected(obs, graph: Graph, T: int, q: int
                                  ) -> np.ndarray:
    """The same, with (i, j) unordered."""
    return pair_observations_directed(obs, graph, T, q)


def pair_obs_undirected_to_directed(psi_undirected, graph: Graph
                                    ) -> np.ndarray:
    """psi per undirected edge (the order of ``graph.undirected_edges()``,
    legs (x_i, x_j) with i < j) -> psi per directed edge."""
    psi_u = np.asarray(psi_undirected, float)      # [E/2, T1, q, q]
    T1, q = psi_u.shape[1], psi_u.shape[2]
    psi = np.ones((graph.E, T1, q, q))
    for u, (i, j, e) in enumerate(graph.undirected_edges()):
        psi[e] = psi_u[u]
        psi[graph.rev_edge[e]] = psi_u[u].transpose(0, 2, 1)
    return psi
