"""The port's halo-exchange sweep over gloo ranks on the CPU (f64).

One spawned group of 8 ranks (``parallel.spawn_ranks``, a ``FileStore``
under ``tmp_path``, one torch thread a rank) runs every case of
``_torch_ranks.HALO_CASES``, the 4-rank ones on a subgroup; the rank
functions live in ``_torch_ranks.py``, which imports no JAX.  Each case is
held to the port's single-device ``bp_sweep`` on the same state to 1e-12,
mirroring ``tests/test_halo.py``'s five cases (single-device match with
pair beliefs through ``halo_to_mpbp``, damping, heterogeneous per-node
tables, cut-only traffic, chunked mixed degree), and with time-varying
tables and periodic trains.  Besides, the plan arrays equal the JAX
package's ``halo_plan``, a sketch sweep over a graph with six distinct
degrees takes the whole graph's buckets, the direct K = 3 cavity is
decided by the whole bucket's size, and the 4-rank halo equals the JAX
package's ``halo_sweep`` on the 4-device CPU mesh to 1e-9, by ``qr`` and by
``sketch`` (the ranks then take the JAX package's sketches, drawn here and
handed over as numpy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import matrixproductbp_tpu as mp
from matrixproductbp_tpu.models import SIS as JSIS, mpbp_sis as jmpbp_sis
from matrixproductbp_tpu.parallel import halo as jhalo

import _torch_ranks as R
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import bp as tbp
from matrixproductbp_tpu_torch.entry import dryrun_multichip, entry
from matrixproductbp_tpu_torch.parallel import (edge_cut, halo_plan,
                                                partition_nodes, spawn_ranks)

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSketchTable:
    """The JAX package's sketches (``PRNGKey(17)``, split for the sketch
    path), each draw kept in ``table`` by its shapes and dtype, in the form
    ``_torch_ranks.TableSketches`` reads."""

    def __init__(self):
        self.table = {}

    def draw(self, phi_shape, psi_shape, dtype, device):
        key = (tuple(phi_shape), tuple(psi_shape), str(dtype))
        if key not in self.table:
            kphi, kpsi = jax.random.split(jax.random.PRNGKey(17))
            jd = jnp.float64 if dtype == torch.float64 else jnp.float32
            self.table[key] = (
                np.array(jax.random.normal(kphi, phi_shape, jd)),
                np.array(jax.random.normal(kpsi, psi_shape, jd)))
        return R.TableSketches(self.table).draw(phi_shape, psi_shape, dtype,
                                                device)


@pytest.fixture(scope="module")
def jax_sketches():
    """Every sketch the single-device sweeps of ``cross_sketch`` draw."""
    src = JaxSketchTable()
    _reference("cross_sketch", src)
    return src


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_sketches):
    """{case: [each rank's result]} of every halo case."""
    res = spawn_ranks(R.halo_cases, 8, args=(jax_sketches.table,),
                      threads=1, timeout=600,
                      store_dir=str(tmp_path_factory.mktemp("ranks")))
    return {case: [r[case] for r in res] for case in R.HALO_CASES}


def _reference(case, sketches=None):
    """The single-device sweeps of a halo case (``bp_sweep``, as
    ``tests/test_halo.py`` holds every case to it)."""
    g, bp, sweeps, kw, _ = R.halo_state(case)
    kw = {k: v for k, v in kw.items() if k != "chunk"}
    for _ in range(sweeps):
        bp = tp.bp_sweep(bp, tp.TruncBond(bp.D), sketches=sketches, **kw)
    return bp


def _check_case(ranks, case, sketches=None):
    ref = _reference(case, sketches)
    got = ranks[case][0]
    b_ref = tp.beliefs(ref).numpy()
    assert np.abs(got["beliefs"] - b_ref).max() < TOL
    assert abs(got["f"] - float(tp.bethe_free_energy(ref))) < TOL
    # every rank of the case read the same gathered beliefs
    for other in ranks[case][1:]:
        if other is not None:
            np.testing.assert_array_equal(other["beliefs"], got["beliefs"])
    return ref, got


def test_halo_matches_single_device(ranks):
    ref, got = _check_case(ranks, "match")
    assert sum(r is not None for r in ranks["match"]) == 8
    pb, lz = tp.pair_beliefs(ref)
    assert np.abs(got["pair"] - pb.numpy()).max() < TOL
    assert np.abs(got["pair_lognorms"] - lz.numpy()).max() < TOL


def test_halo_with_damping(ranks):
    _check_case(ranks, "damp")


def test_halo_per_node_tables(ranks):
    _, bp, *_ = R.halo_state("het")
    assert bp.tables.Pyp.shape[0] == bp.N > 1     # per-node tables
    _check_case(ranks, "het")


def test_halo_traffic_is_cut_only(ranks):
    """The rows sent are the partition's cut, not the edge count."""
    g = tp.random_regular_graph(64, 3, np.random.default_rng(0))
    part = partition_nodes(g, 4)
    plan = halo_plan(g, 4, part)
    cut = edge_cut(g, part)
    assert plan.cut == cut < g.E
    res = ranks["cut"][:4]
    np.testing.assert_array_equal(res[0]["part"], part)
    assert sum(r["rows_sent"] for r in res) == cut
    assert sum(r["rows_received"] for r in res) == cut


def test_halo_chunked_mixed_degree_matches_single_device(ranks):
    g, *_ = R.halo_state("chunk")
    assert sorted(set(g.degree.tolist())) == [2, 4]
    _check_case(ranks, "chunk")


def _jax_graph(g):
    return mp.graph_from_edges(g.N, [(i, j) for i, j, _ in
                                     g.undirected_edges()])


@pytest.mark.parametrize("case", ["match", "het", "chunk", "buckets", "cut"])
def test_halo_plan_equals_jax(case):
    if case == "cut":
        g, part = tp.random_regular_graph(64, 3, np.random.default_rng(0)), \
            None
    else:
        g, _, _, _, part = R.halo_state(case)
    ndev = R.HALO_CASES[case][0]
    jg = _jax_graph(g)
    # the default partitions (the native partitioner on both sides) agree
    jpart = mp.parallel.partition_nodes(jg, ndev)
    np.testing.assert_array_equal(partition_nodes(g, ndev), jpart)
    part = jpart if part is None else part
    plan, jplan = halo_plan(g, ndev, part), jhalo.halo_plan(jg, ndev, part)
    for name in ("ndev", "Nloc", "Eloc", "K"):
        assert getattr(plan, name) == getattr(jplan, name), name
    for name in ("part", "node_new", "edge_new", "in_edges_loc", "in_mask",
                 "degree", "local_src", "local_dst", "send_idx", "recv_dst"):
        a, b = getattr(plan, name), getattr(jplan, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the two JAX-only masks follow from the port's plan
    counts = np.bincount(plan.part, minlength=ndev)
    np.testing.assert_array_equal(
        jplan.node_mask, np.arange(plan.Nloc)[None, :] < counts[:, None])
    np.testing.assert_array_equal(jplan.out_owner_valid, plan.in_mask)


def test_halo_sketch_takes_the_whole_graphs_buckets(ranks):
    """Six distinct degrees bucket by powers of two (1, 2, 4, 6); each
    part holds at most three, which alone would bucket by degree."""
    g, _, _, kw, part = R.halo_state("buckets")
    assert kw["method"] == "sketch" and len(set(g.degree.tolist())) > 4
    assert [k for _, k in tbp._degree_buckets(g)] == [1, 2, 4, 6]
    assert all(len(set(g.degree[part == p].tolist())) <= 3
               for p in range(4))
    _check_case(ranks, "buckets")


def test_halo_direct_k3_by_the_whole_bucket(ranks, monkeypatch):
    """With a threshold of 8 nodes, the 24-node K = 3 bucket folds by prefix
    and suffix on one device; each rank holds 6 of its nodes and must fold
    the same way, not by the direct cavity its own count would allow."""
    monkeypatch.setattr(tbp, "DIRECT_K3_MAX", R.HALO_CASES["direct_k3"][1])
    with R.direct_k3_calls() as calls:
        _reference("direct_k3")
    assert calls and not any(calls)
    for res in ranks["direct_k3"][:4]:
        assert res["direct_k3"] and not any(res["direct_k3"])
    _check_case(ranks, "direct_k3")


def test_halo_time_varying_tables(ranks):
    _, bp, *_ = R.halo_state("tv")
    assert bp.tables.time_varying
    _check_case(ranks, "tv")


def test_halo_periodic_trains(ranks):
    _, bp, *_ = R.halo_state("periodic")
    assert bp.periodic
    _check_case(ranks, "periodic")


def _jax_halo(case):
    """JAX's halo sweeps of a cross case on the 4-device CPU mesh: its
    beliefs and free energy."""
    g, bp, sweeps, kw, _ = R.halo_state(case)
    jg = _jax_graph(g)
    st = jhalo.halo_mpbp(jmpbp_sis(JSIS(jg, lam=0.3, rho=0.2, T=bp.T,
                                        gamma=0.3), D=bp.D),
                         Mesh(np.array(jax.devices()[:4]), ("p",)))
    for _ in range(sweeps):
        st = jhalo.halo_sweep(st, mp.TruncBond(bp.D), **kw)
    return (np.asarray(jhalo.halo_beliefs(st, jg)),
            float(jhalo.halo_bethe_free_energy(st)))


@pytest.fixture(scope="module")
def jax_halo():
    return _jax_halo("cross")


def test_halo_matches_jax_halo(ranks, jax_halo):
    b, f = jax_halo
    got = ranks["cross"][0]
    assert np.abs(got["beliefs"] - b).max() < 1e-9
    assert abs(got["f"] - f) < 1e-8


def test_halo_sketch_matches_jax_halo(ranks, jax_sketches):
    """The card's method: the 4-rank sketch halo, on the JAX package's
    sketches, equals the port's ``bp_sweep`` on the same sketches to 1e-12
    and JAX's sketch ``halo_sweep`` to 1e-9."""
    _check_case(ranks, "cross_sketch", jax_sketches)
    b, f = _jax_halo("cross_sketch")
    got = ranks["cross_sketch"][0]
    assert np.abs(got["beliefs"] - b).max() < 1e-9
    assert abs(got["f"] - f) < 1e-8


def test_entry_and_dryrun_multichip():
    for method in ("sketch", "qr"):
        fn, args = entry(method, device="cpu")
        out = fn(*args)
        assert np.allclose(tp.beliefs(out).sum(-1).numpy(), 1.0, atol=1e-5)
    assert np.isfinite(dryrun_multichip(2, device="cpu"))
