"""The port's C++ graph builder and partitioner (``native/``) against its
numpy paths and the JAX package's (host numpy, no torch device).

The native and numpy graph arrays equal each other and the JAX package's,
on random graphs and on ``erdos_renyi_gnm(10^5, 1.5 10^5)``;
``partition_nodes`` equals the JAX package's on both paths (and where the
library is missing, as the JAX package draws its second permutation then);
``native=None/True/False`` keeps the JAX package's contract; the port
builds its own library in its own build directory.
"""
import os

import numpy as np
import pytest

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import native as jnative
from matrixproductbp_tpu.parallel import partition_nodes as jpartition

import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import native
from matrixproductbp_tpu_torch.ops.build import BUILD_DIR
from matrixproductbp_tpu_torch.parallel import edge_cut, partition_nodes

FIELDS = ("N", "E", "dmax", "edge_src", "edge_dst", "rev_edge", "in_edges",
          "in_mask", "nbr", "degree")


def _edges(rng, N, m):
    e = set()
    while len(e) < m:
        i, j = rng.integers(0, N, 2)
        if i != j:
            e.add((min(int(i), int(j)), max(int(i), int(j))))
    return list(e)


def _same_graph(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_native_library_builds_in_the_ports_build_dir():
    assert native.load() is not None
    lib = native._lib_path()
    assert os.path.dirname(lib) == BUILD_DIR and os.path.exists(lib)
    assert os.path.dirname(BUILD_DIR) == os.path.dirname(tp.__file__)
    # the JAX package's directory holds its committed files only
    assert set(os.listdir(os.path.dirname(jnative.__file__))) <= {
        "Makefile", "__init__.py", "graphbuild.cpp", "libgraphbuild.so",
        "__pycache__"}


@pytest.mark.parametrize("N, m, dmax", [(50, 120, None), (30, 10, None),
                                        (12, 20, 9), (5, 0, None)])
def test_native_matches_numpy_and_jax(N, m, dmax):
    edges = _edges(np.random.default_rng(N + m), N, m)
    g_np = tp.graph_from_edges(N, edges, dmax, native=False)
    g_cc = tp.graph_from_edges(N, edges, dmax, native=True)
    _same_graph(g_np, g_cc)
    _same_graph(g_cc, tp.graph_from_edges(N, edges, dmax))
    _same_graph(g_cc, mp.graph_from_edges(N, edges, dmax, native=False))


def test_native_matches_at_the_scale_graph():
    """``erdos_renyi_gnm(10^5, 1.5 10^5)``: the scale sweep's graph."""
    N, M = 10 ** 5, 150_000
    g = tp.erdos_renyi_gnm(N, M, np.random.default_rng(0))
    assert g.E == 2 * M
    pairs = np.stack([g.edge_src, g.edge_dst], 1)[g.edge_src < g.edge_dst]
    _same_graph(g, tp.graph_from_edges(N, pairs, native=False))
    _same_graph(g, tp.graph_from_edges(N, pairs, native=True))
    _same_graph(g, mp.graph_from_edges(N, pairs))


def test_dmax_below_the_degree_and_bad_endpoints_raise():
    for nat in (False, True):
        with pytest.raises(ValueError, match="dmax"):
            tp.graph_from_edges(4, [(0, 1), (0, 2), (0, 3)], 2, native=nat)
    for nat in (False, True):
        for bad in ([(0, 3)], [(-1, 2)]):
            with pytest.raises(ValueError, match="endpoints"):
                tp.graph_from_edges(3, bad, native=nat)


@pytest.mark.parametrize("N, k, nparts", [(64, 3, 4), (96, 3, 4), (40, 4, 3)])
def test_partition_equals_jax(N, k, nparts):
    g = tp.random_regular_graph(N, k, np.random.default_rng(N))
    jg = mp.graph_from_edges(N, [(i, j) for i, j, _ in g.undirected_edges()])
    default = jpartition(jg, nparts)
    np.testing.assert_array_equal(partition_nodes(g, nparts), default)
    np.testing.assert_array_equal(partition_nodes(g, nparts, native=True),
                                  default)
    for nat in (True, False):
        for seed in (1, 2):
            got = partition_nodes(g, nparts, np.random.default_rng(seed),
                                  native=nat)
            want = jpartition(jg, nparts, np.random.default_rng(seed),
                              native=nat)
            np.testing.assert_array_equal(got, want)
            counts = np.bincount(got, minlength=nparts)
            assert counts.sum() == N and counts.max() <= -(-N // nparts)
            assert edge_cut(g, got) < g.E


def test_native_contract_without_the_library(monkeypatch):
    """Without the library ``native=None`` takes numpy (the partition from
    a second permutation, as the JAX package's), ``True`` raises."""
    rng = np.random.default_rng(3)
    edges = _edges(rng, 40, 70)
    g = tp.graph_from_edges(40, edges)
    jg = mp.graph_from_edges(40, edges)
    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    _same_graph(tp.graph_from_edges(40, edges), g)
    with pytest.raises(RuntimeError, match="native graph builder"):
        tp.graph_from_edges(40, edges, native=True)
    with pytest.raises(RuntimeError, match="native partitioner"):
        partition_nodes(g, 4, native=True)
    got = partition_nodes(g, 4, np.random.default_rng(5))
    want = jpartition(jg, 4, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)
    second = np.random.default_rng(5)
    second.permutation(40)
    np.testing.assert_array_equal(
        got, partition_nodes(g, 4, second, native=False))
