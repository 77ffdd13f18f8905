"""Infinite regular and bipartite-regular graphs: symmetry-collapsed BP.

Counterpart of ``matrixproductbp_tpu/infinite.py``.  On an infinite
k-regular graph every message is the same, so one node whose k slots all
read one stored edge runs the usual sweep and converges to the symmetric
fixed point; the bipartite variant stores two messages.  These are plain
``Graph`` instances whose index arrays alias one (or two) edges, flagged
``infinite`` so that the sweep keeps one message where several slots write
the same edge, and the pair-belief logz takes the ``1/(k-1) - 1/2`` weight.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bp import MPBP, mpbp
from .graph import Graph
from .ops.tensortrain import TensorTrain, normalize, rand_tt

__all__ = ["infinite_regular_graph", "infinite_bipartite_graph",
           "mpbp_infinite_graph", "periodic_mpbp_infinite_graph",
           "mpbp_infinite_bipartite_graph",
           "bethe_free_energy_infinite_bipartite"]


def infinite_regular_graph(k: int) -> Graph:
    """One node, one stored message, k aliased in-slots
    (``InfiniteRegularGraph``, ``infinite_graph.jl:1-17``)."""
    return Graph(
        N=1, E=1, dmax=k,
        edge_src=np.zeros(1, np.int32), edge_dst=np.zeros(1, np.int32),
        rev_edge=np.zeros(1, np.int32),
        in_edges=np.zeros((1, k), np.int32),
        in_mask=np.ones((1, k), bool),
        nbr=np.zeros((1, k), np.int32),
        degree=np.array([k], np.int32),
        infinite=True)


def infinite_bipartite_graph(k1: int, k2: int) -> Graph:
    """Two blocks of degrees (k1, k2); edge i is the message into node i
    (``InfiniteBipartiteRegularGraph``, ``infinite_graph.jl:60-100``)."""
    k = max(k1, k2)
    in_edges = np.zeros((2, k), np.int32)
    in_edges[1, :] = 1
    in_mask = np.zeros((2, k), bool)
    in_mask[0, :k1] = True
    in_mask[1, :k2] = True
    nbr = np.zeros((2, k), np.int32)
    nbr[0, :] = 1
    return Graph(
        N=2, E=2, dmax=k,
        edge_src=np.array([1, 0], np.int32),
        edge_dst=np.array([0, 1], np.int32),
        rev_edge=np.array([1, 0], np.int32),
        in_edges=in_edges, in_mask=in_mask, nbr=nbr,
        degree=np.array([k1, k2], np.int32),
        infinite=True)


def mpbp_infinite_graph(k: int, tables, T: int, D: int, phi=None, psi=None,
                        dtype=torch.float64, device=None) -> MPBP:
    """Reference ``mpbp_infinite_graph`` (``infinite_graph.jl:19-32``);
    ``tables`` built for the one-node graph (degree k)."""
    return mpbp(infinite_regular_graph(k), tables, T, D, phi=phi, psi=psi,
                dtype=dtype, device=device)


def periodic_mpbp_infinite_graph(k: int, tables, T: int, D: int, phi=None,
                                 psi=None, dtype=torch.float64, bond: int = 1,
                                 seed: int = 0, device=None,
                                 message=None) -> MPBP:
    """Time-periodic infinite k-regular state (reference
    ``periodic_mpbp_infinite_graph``, ``infinite_graph.jl:46-60``): the
    message starts as a random periodic train of bond ``bond``, since the
    flat one can sit on a symmetric unstable point.  The train is drawn
    from a ``torch.Generator`` seeded with ``seed`` (the JAX package draws
    from ``PRNGKey(seed)``, another stream), or given as ``message =
    (cores [T1, D, D, q*q], logz)``, which is normalized."""
    bp = mpbp(infinite_regular_graph(k), tables, T, D, phi=phi, psi=psi,
              dtype=dtype, periodic=True, device=device)
    q = tables.q
    if message is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        tt = rand_tt(gen, T + 1, D, (q, q), bond=bond, dtype=dtype,
                     periodic=True)
    else:
        tt = TensorTrain(*(torch.as_tensor(np.asarray(a), dtype=dtype)
                           for a in message), (q, q), True)
    msg, _ = normalize(tt)
    return dataclasses.replace(
        bp, msg_cores=msg.cores[None].to(bp.device),
        msg_logz=msg.logz.reshape(1).to(bp.device))


def mpbp_infinite_bipartite_graph(k: tuple, tables, T: int, D: int,
                                  phi=None, psi=None, dtype=torch.float64,
                                  device=None) -> MPBP:
    """Reference ``mpbp_infinite_bipartite_graph``
    (``infinite_graph.jl:102-121``)."""
    return mpbp(infinite_bipartite_graph(*k), tables, T, D, phi=phi,
                psi=psi, dtype=dtype, device=device)


def bethe_free_energy_infinite_bipartite(bp: MPBP) -> float:
    """The blocks' free energies weighted by their fractions
    (``infinite_graph.jl:113-121``)."""
    k1, k2 = (int(d) for d in bp.graph.degree[:2])
    f = bp.f.detach().cpu().double().numpy()
    return float((f[0] * k2 + f[1] * k1) / (k1 + k2))
