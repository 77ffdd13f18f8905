"""Graph partitioning for the multi-rank sweep (host numpy).

Counterpart of ``matrixproductbp_tpu/parallel/partition.py``.  Partition
quality sets how many messages cross ranks each sweep (the halo), so the
parts are grown breadth-first, balanced, from seeds in a random order
instead of hashed.  The same ``rng`` gives the JAX package's partition on
both paths: the native path draws ``rng.permutation(N)`` once, and where
``native=None`` finds no library the numpy path draws a second one, as the
JAX package does.
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph

__all__ = ["partition_nodes", "edge_cut"]


def partition_nodes(graph: Graph, nparts: int,
                    rng: np.random.Generator | None = None,
                    native: bool | None = None) -> np.ndarray:
    """Greedy balanced BFS partitioning: ``part[N]`` in ``[0, nparts)``.

    ``native=None`` takes the C++ partitioner (``native/graphbuild.cpp``)
    when its library builds, else the numpy path; ``True`` raises where the
    library is unavailable; ``False`` takes the numpy path."""
    rng = np.random.default_rng(0) if rng is None else rng
    N = graph.N
    if native is not False:
        from .. import native as native_mod
        order = rng.permutation(N).astype(np.int32)
        part = native_mod.partition_native(graph, nparts, order)
        if part is not None:
            return part
        if native is True:
            raise RuntimeError("native partitioner unavailable")
    target = (N + nparts - 1) // nparts
    part = np.full(N, -1, dtype=np.int32)
    nbrs = [graph.nbr[i][graph.in_mask[i]] for i in range(N)]
    order = rng.permutation(N)
    p = 0
    count = 0
    for seed in order:
        if part[seed] >= 0:
            continue
        # breadth-first from the seed into the current part
        queue = [int(seed)]
        head = 0
        while head < len(queue) and count < target:
            v = queue[head]
            head += 1
            if part[v] >= 0:
                continue
            part[v] = p
            count += 1
            for u in nbrs[v]:
                if part[u] < 0:
                    queue.append(int(u))
        if count >= target:
            p = min(p + 1, nparts - 1)
            count = 0
    part[part < 0] = nparts - 1
    return part


def edge_cut(graph: Graph, part: np.ndarray) -> int:
    """Number of directed edges whose ends lie in different parts (the
    messages a halo sweep sends)."""
    return int(np.sum(part[graph.edge_src] != part[graph.edge_dst]))
