"""The port's graph, SIS tables, state conversion and entry-point rules
against the JAX package (CPU)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import checkpoint as jckpt
from matrixproductbp_tpu.factors import transition_probs as jtransition
from matrixproductbp_tpu.models import SIS as JSIS, sis_tables as jsis_tables
from matrixproductbp_tpu.models import mpbp_sis as jmpbp_sis
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch.models import SIS, mpbp_sis, sis_tables

_GRAPH_FIELDS = ("N", "E", "dmax", "edge_src", "edge_dst", "rev_edge",
                 "in_edges", "in_mask", "nbr", "degree", "out_edges")

KARATE_HEAD = [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (1, 2), (1, 3),
               (2, 3), (3, 7), (4, 6), (5, 6), (6, 16), (2, 8), (8, 30)]


def _assert_same_graph(tg, jg):
    for f in _GRAPH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)


@pytest.mark.parametrize("N,edges", [
    (4, [(0, 1), (0, 2), (2, 3)]),
    (5, [(0, i) for i in range(1, 5)]),
    (31, KARATE_HEAD + [(3, 2), (10, 20)]),     # a duplicate pair is dropped
])
def test_graph_arrays_match_jax(N, edges):
    _assert_same_graph(tp.graph_from_edges(N, edges),
                       mp.graph_from_edges(N, edges, native=False))


@pytest.mark.parametrize("N,k", [(64, 3), (4096, 3)])
def test_random_regular_graph_matches_jax(N, k):
    tg = tp.random_regular_graph(N, k, np.random.default_rng(0))
    jg = mp.random_regular_graph(N, k, np.random.default_rng(0))
    _assert_same_graph(tg, jg)


def test_random_tree_matches_jax():
    _assert_same_graph(tp.random_tree(12, np.random.default_rng(5)),
                       mp.random_tree(12, np.random.default_rng(5)))


@pytest.mark.parametrize("lam,rho,alpha", [(0.2, 0.1, 0.0), (0.5, 0.3, 0.1)])
def test_sis_tables_bit_equal(lam, rho, alpha):
    edges = [(0, 1), (0, 2), (2, 3), (0, 3)]
    t = sis_tables(tp.graph_from_edges(4, edges), lam, rho, alpha)
    j = jsis_tables(mp.graph_from_edges(4, edges), lam, rho, alpha)
    for name in ("Py", "Pyp", "Pxy", "Pyy", "Py0"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_transition_probs_match_jax():
    import jax
    edges = [(0, 1), (0, 2), (2, 3)]
    g = mp.graph_from_edges(4, edges)
    tb_j = jsis_tables(g, 0.3, 0.2, 0.05)
    tb_t = sis_tables(tp.graph_from_edges(4, edges), 0.3, 0.2, 0.05)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, size=(16, 4))
    xn = x[:, np.minimum(g.nbr, 3)]
    ref = jax.vmap(lambda a, b: jtransition(tb_j, jnp.asarray(g.in_mask), a,
                                            b))(jnp.asarray(xn), jnp.asarray(x))
    out = tp.transition_probs(tb_t, g.in_mask, torch.as_tensor(xn),
                              torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-14,
                               atol=1e-14)


def _sis_pair(D=4):
    edges = [(0, 1), (0, 2), (2, 3)]
    jb = jmpbp_sis(JSIS(mp.graph_from_edges(4, edges), 0.2, 0.1, T=3,
                        gamma=0.3), D=D)
    tb = mpbp_sis(SIS(tp.graph_from_edges(4, edges), 0.2, 0.1, T=3,
                      gamma=0.3), D=D, device="cpu")
    return jb, tb


def test_initial_state_matches_jax():
    jb, tb = _sis_pair()
    for name in ("phi", "psi", "msg_cores", "msg_logz", "bel_cores",
                 "bel_logz", "f"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


def test_numpy_state_round_trip():
    _, tb = _sis_pair()
    tb.msg_logz.normal_(generator=torch.Generator().manual_seed(0))
    back = tp.from_numpy_state(tp.to_numpy_state(tb, step=3), device="cpu")
    for name in ("phi", "psi", "msg_cores", "msg_logz", "bel_cores",
                 "bel_logz", "f"):
        assert torch.equal(getattr(back, name), getattr(tb, name)), name
    for name in ("Py", "Pyp", "Pxy", "Pyy", "Py0"):
        assert torch.equal(getattr(back.tables, name),
                           getattr(tb.tables, name)), name
    _assert_same_graph(back.graph, tb.graph)
    assert back.tables.yy_off is None and back.tables.ydims is None


def test_jax_checkpoint_loads_into_port(tmp_path):
    jb, _ = _sis_pair()
    jb = mp.bp_sweep(jb, mp.TruncBond(4), method="sketch")
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), jb, step=7)
    tb = tp.from_numpy_state(dict(np.load(path)), device="cpu")
    np.testing.assert_array_equal(tb.msg_cores.numpy(),
                                  np.asarray(jb.msg_cores))
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=1e-13,
                               atol=1e-13)
    # and back: the port's arrays are a checkpoint the JAX package reads
    out = str(tmp_path / "port.npz")
    np.savez(out, **tp.to_numpy_state(tb, step=7))
    jb2, meta = jckpt.load_checkpoint(out)
    assert meta["step"] == 7
    np.testing.assert_array_equal(np.asarray(jb2.msg_cores),
                                  np.asarray(jb.msg_cores))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tp.graph_from_edges(3, [(0, 1), (1, 2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpbp_sis(SIS(g, 0.2, 0.1, T=2), D=3)
    _, tb = _sis_pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.from_numpy_state(tp.to_numpy_state(tb))


@pytest.mark.parametrize("kwargs", [
    # ids fixed to the ones these cases had when they pinned the raise of
    # ROADMAP Queue 1 item 3, so that runs of this test stay comparable
    pytest.param(dict(method="sketch", chunk=2), id="kwargs3-item 7"),
    pytest.param(dict(method="sketch", schedule="seidel"),
                 id="kwargs4-item 7"),
])
def test_unported_options_raise(kwargs):
    """The options that raised until item 3 was ported now run: finite,
    normalised beliefs."""
    _, tb = _sis_pair()
    tb, n, _ = tp.iterate(tb, maxiter=2, trunc=tp.TruncBond(4), tol=0.0,
                          **kwargs)
    b = tp.beliefs(tb)
    assert n == 2 and bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, atol=1e-12)


@pytest.mark.parametrize("kwargs", [
    dict(method="qr"), dict(method="randomized"),
    dict(method="sketch", damp=0.5), dict(method="sketch", polish=1),
], ids=["qr", "randomized", "damp", "polish"])
def test_iterate_options_run(kwargs):
    """Every method and option ``iterate`` takes runs on the SIS pair's
    state and gives finite, normalised beliefs."""
    _, tb = _sis_pair()
    tb, n, _ = tp.iterate(tb, maxiter=1, trunc=tp.TruncBond(4), **kwargs)
    b = tp.beliefs(tb)
    assert n == 1 and bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, rtol=1e-12)


def test_unported_modes_raise():
    """The modes of ROADMAP Queue 1 item 6 run (they raised before it was
    ported): a periodic SIS state sweeps to normalised beliefs, and tables
    stacked to a time axis (one slice a step) sweep as the constant ones
    do."""
    g = tp.graph_from_edges(3, [(0, 1), (1, 2)])
    bp = mpbp_sis(SIS(g, 0.2, 0.1, T=2), D=3, periodic=True, device="cpu")
    b = tp.beliefs(tp.bp_sweep(bp, tp.TruncBond(3)))
    assert bp.periodic and bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, rtol=1e-12)
    _, tb = _sis_pair()
    T1 = tb.T + 1
    t = tb.tables
    tv = dataclasses.replace(tb, tables=dataclasses.replace(
        t, Py=t.Py[:, None].expand(-1, T1, -1, -1, -1),
        Pyp=t.Pyp[:, :, None].expand(-1, -1, T1, -1, -1, -1, -1),
        Pxy=t.Pxy[:, :, None].expand(-1, -1, T1, -1, -1, -1),
        Pyy=t.Pyy[:, :, None].expand(-1, -1, T1, -1, -1, -1, -1),
        Py0=t.Py0[:, None].expand(-1, T1, -1, -1)))
    np.testing.assert_allclose(
        tp.beliefs(tp.bp_sweep(tv, tp.TruncBond(4))).numpy(),
        tp.beliefs(tp.bp_sweep(tb, tp.TruncBond(4))).numpy(), rtol=0,
        atol=1e-12)


@pytest.mark.parametrize("method", ["sketch", "qr", "randomized"])
def test_banded_sweep_runs(method):
    """Tables tagged with ``yy_off`` take the banded merge on every method:
    a Glauber tree's sweep gives finite, normalised beliefs."""
    from matrixproductbp_tpu_torch.models import Glauber, Ising, mpbp_glauber
    g = tp.graph_from_edges(4, [(0, 1), (0, 2), (2, 3)])
    tb = mpbp_glauber(Glauber(Ising(g, [0.5] * 3, [0.1] * 4), T=3), D=4,
                      device="cpu")
    assert tb.tables.yy_off == 0
    tb = tp.bp_sweep(tb, tp.TruncBond(4), method=method)
    b = tp.beliefs(tb)
    assert bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, rtol=1e-12)
