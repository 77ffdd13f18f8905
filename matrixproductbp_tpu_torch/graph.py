"""Bidirected graph with edge ids as flat index arrays (host numpy).

Counterpart of ``matrixproductbp_tpu/graph.py``.  Directed edge ids are
ordered by ``(dst, src)``; ``in_edges[i]`` lists the edge ids ``k -> i`` in
ascending neighbour order, padded with the dummy id ``E``; the out-edge paired
with in-slot ``(i, k)`` is ``rev_edge`` of the in-edge.  The arrays equal the
JAX package's for the same edges.  :func:`graph_from_edges` builds them with
the C++ builder of ``native/`` when it builds (as the JAX package does) and
otherwise with numpy; both give the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Graph", "graph_from_edges", "random_regular_graph",
           "erdos_renyi_graph", "erdos_renyi_gnm", "random_tree",
           "star_graph", "path_graph"]


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    """Static bidirected graph; E = number of directed edges."""

    N: int
    E: int
    dmax: int
    edge_src: np.ndarray      # i[E]
    edge_dst: np.ndarray      # i[E]
    rev_edge: np.ndarray      # i[E]   id of (dst -> src)
    in_edges: np.ndarray      # i[N, dmax]  padded with E
    in_mask: np.ndarray       # bool[N, dmax]
    nbr: np.ndarray           # i[N, dmax]  neighbour indices, padded with N
    degree: np.ndarray        # i[N]
    infinite: bool = False

    @property
    def out_edges(self) -> np.ndarray:
        """i[N, dmax]: out-edge id for each in-slot (same neighbour), padded E."""
        out = np.full_like(self.in_edges, self.E)
        valid = self.in_mask
        out[valid] = self.rev_edge[self.in_edges[valid]]
        return out

    def undirected_edges(self):
        """[(i, j, dir_id_ij)] with i < j, ordered by directed edge id of
        i->j."""
        return [(int(i), int(j), e) for e, (i, j) in
                enumerate(zip(self.edge_src, self.edge_dst)) if i < j]


def graph_from_edges(N: int, undirected_edges, dmax: int | None = None,
                     native: bool | None = None) -> Graph:
    """Build from a list (or [M, 2] array) of undirected pairs (i, j).

    ``native=None`` takes the C++ builder (``native/graphbuild.cpp``) when
    its library builds and loads, else numpy; ``True`` raises where the
    library is unavailable; ``False`` takes numpy.  The arrays are the
    same either way."""
    arr = np.asarray(list(undirected_edges) if not isinstance(
        undirected_edges, np.ndarray) else undirected_edges, dtype=np.int64)
    if arr.size == 0:
        arr = arr.reshape(0, 2)
    if np.any(arr[:, 0] == arr[:, 1]):
        raise ValueError("self loops not supported")
    if arr.size and (arr.min() < 0 or arr.max() >= N):
        raise ValueError(f"edge endpoints must lie in [0, {N})")
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    uniq = np.unique(lo * np.int64(N) + hi)
    a, b = uniq // N, uniq % N
    if native is not False:
        from . import native as native_mod
        out = native_mod.build_graph_native(N, np.stack([a, b], 1), dmax)
        if out is not None:
            return Graph(N, *out)
        if native is True:
            raise RuntimeError("native graph builder unavailable")
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    order = np.lexsort((src, dst))              # by (dst, src)
    src, dst = src[order], dst[order]
    E = len(src)
    keys = dst * np.int64(N) + src              # sorted ascending
    rev_edge = np.searchsorted(keys, src * np.int64(N) + dst).astype(np.int32)
    degree = np.bincount(dst, minlength=N).astype(np.int32)
    K = int(degree.max()) if N and E else 0
    if dmax is not None:
        if dmax < K:
            raise ValueError(f"dmax={dmax} is below the max degree {K}")
        K = dmax
    K = max(K, 1)
    first = np.concatenate([[0], np.cumsum(degree)[:-1]]) if N else \
        np.zeros(0, np.int64)
    slot = np.arange(E) - first[dst]
    in_edges = np.full((N, K), E, dtype=np.int32)
    in_mask = np.zeros((N, K), dtype=bool)
    nbr = np.full((N, K), N, dtype=np.int32)
    in_edges[dst, slot] = np.arange(E, dtype=np.int32)
    in_mask[dst, slot] = True
    nbr[dst, slot] = src
    return Graph(N, E, K, src.astype(np.int32), dst.astype(np.int32),
                 rev_edge, in_edges, in_mask, nbr, degree)


def path_graph(N: int) -> Graph:
    return graph_from_edges(N, [(i, i + 1) for i in range(N - 1)])


def star_graph(N: int) -> Graph:
    """Node 0 is the hub."""
    return graph_from_edges(N, [(0, i) for i in range(1, N)])


def random_tree(N: int, rng: np.random.Generator) -> Graph:
    edges = [(int(rng.integers(0, i)), i) for i in range(1, N)]
    return graph_from_edges(N, edges)


def random_regular_graph(N: int, k: int, rng: np.random.Generator,
                         max_tries: int = 200) -> Graph:
    """Configuration-model random k-regular simple graph (the same draws as
    the JAX package's, so the same ``rng`` gives the same graph)."""
    if (N * k) % 2:
        raise ValueError("N * k must be even")
    for _ in range(max_tries):
        stubs = np.repeat(np.arange(N), k)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        edges = set()
        ok = True
        for a, b in pairs:
            a, b = int(a), int(b)
            if a == b or (min(a, b), max(a, b)) in edges:
                ok = False
                break
            edges.add((min(a, b), max(a, b)))
        if ok:
            return graph_from_edges(N, list(edges))
    raise RuntimeError("failed to sample a simple regular graph")


def erdos_renyi_graph(N: int, c: float, rng: np.random.Generator) -> Graph:
    """G(N, p) with mean degree c (p = c / (N-1)), isolated nodes kept (the
    same draws as the JAX package's, so the same ``rng`` gives the same
    graph)."""
    p = c / (N - 1)
    edges = []
    for i in range(N):
        js = np.nonzero(rng.random(N - i - 1) < p)[0] + i + 1
        edges.extend((i, int(j)) for j in js)
    return graph_from_edges(N, edges)


def erdos_renyi_gnm(N: int, M: int, rng: np.random.Generator) -> Graph:
    """M edges drawn as the JAX package's scale run draws them
    (``scripts/scale_run.py:44-52``): 3M uniform node pairs, those with
    i < j, deduplicated in sorted order, the first M kept.  The sorted cut
    leaves low-numbered nodes more edges than high-numbered ones; isolated
    nodes are kept.  O(M) host work, where :func:`erdos_renyi_graph`
    draws N^2 / 2 uniforms."""
    src = rng.integers(0, N, 3 * M)
    dst = rng.integers(0, N, 3 * M)
    keep = src < dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)[:M]
    return graph_from_edges(N, pairs)
