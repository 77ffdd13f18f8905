"""The port's Glauber model against the JAX package and the enumeration
oracle (f64, CPU), and the numpy pieces of ``models`` against their JAX
twins.

One sweep of a homogeneous Glauber tree (the banded ``yy_off`` merge) by
each method, with the JAX package's sketches: beliefs and the free-energy
ledger ``f`` to 1e-9.  Iterated on trees, every factor variant reaches
enumeration at the JAX package's gates (``tests/test_glauber_small_tree.py``:
beliefs and ``-F = log Z`` to 1e-8), through the banded merge where the
variant has one, and the K = 4 prefix/suffix folds on a star.  The
Restricted (dense ``prob_yy``) tables give the banded path's beliefs
(1e-10, ``tests/test_factor_adapters.py``).  An Erdos-Renyi graph with
isolated nodes runs, and its isolated nodes' beliefs are their exact
single-spin marginals.
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu.models import equilibrium as jeq
from matrixproductbp_tpu.models import glauber as jglauber
from matrixproductbp_tpu.models import inference as jinf
from matrixproductbp_tpu import stationary as jstat
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch import stationary as tstat
from matrixproductbp_tpu_torch.models import equilibrium as teq
from matrixproductbp_tpu_torch.models import glauber as tglauber
from matrixproductbp_tpu_torch.models import inference as tinf
from test_torch_sweep_svd import JaxSketches

TREE = (4, [(0, 1), (0, 2), (2, 3)])
H = [0.2, -0.1, 0.0, 0.3]
# (method, D, port truncation, JAX truncation) of the one-sweep comparisons
METHODS = [("sketch", 8, tp.TruncBond(8), mp.TruncBond(8)),
           ("qr", 8, tp.TruncThresh(0.0), mp.TruncThresh(0.0)),
           ("randomized", 8, tp.TruncThresh(0.0), mp.TruncThresh(0.0))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _glauber_pair(J, D, force=None, T=2, graph=TREE, h=H, beta=0.7):
    N, edges = graph
    jb = jglauber.mpbp_glauber(jglauber.Glauber(jglauber.Ising(
        mp.graph_from_edges(N, edges), J, h, beta), T), D=D, force=force)
    tb = tglauber.mpbp_glauber(tglauber.Glauber(tglauber.Ising(
        tp.graph_from_edges(N, edges), J, h, beta), T), D=D, force=force,
        device="cpu")
    return jb, tb


def _assert_one_sweep_matches(jb, tb, method, jtrunc, trunc, tol=1e-9):
    jb = mp.bp_sweep(jb, jtrunc, method=method)
    tb = tp.bp_sweep(tb, trunc, method=method, sketches=JaxSketches())
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=tol, atol=tol)
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("method,D,trunc,jtrunc", METHODS,
                         ids=[m[0] for m in METHODS])
def test_banded_sweep_matches_jax(method, D, trunc, jtrunc):
    jb, tb = _glauber_pair([0.5, 0.5, 0.5], D)
    assert tb.tables.yy_off == jb.tables.yy_off == 0
    _assert_one_sweep_matches(jb, tb, method, jtrunc, trunc)


def _assert_enumeration(tb, tol=1e-8):
    p, Z = exact.exact_prob(tb)
    b = tp.beliefs(tb).numpy()
    assert np.abs(b - exact.exact_marginals(tb, p)).max() < tol
    assert abs(-float(tp.bethe_free_energy(tb)) - np.log(Z)) < tol


# the couplings of tests/test_glauber_small_tree.py, each taking its variant
VARIANTS = {"homogeneous": ([0.5, 0.5, 0.5], 0.7, 0),
            "pmj": ([0.5, -0.5, 0.5], 0.9, 0),
            "integer": ([1.0, -2.0, 1.0], 0.4, None),
            "generic": ([0.37, -0.81, 1.13], 0.6, None)}


@pytest.mark.parametrize("method", ["randomized", "qr"])
@pytest.mark.parametrize("kind", list(VARIANTS))
def test_variants_reach_enumeration(kind, method):
    J, beta, yy_off = VARIANTS[kind]
    tb = tglauber.mpbp_glauber(tglauber.Glauber(tglauber.Ising(
        tp.graph_from_edges(*TREE), J, H, beta), 2), D=8, device="cpu")
    assert tb.tables.yy_off == yy_off
    tb, n, _ = tp.iterate(tb, maxiter=15, trunc=tp.TruncThresh(0.0),
                          tol=1e-13, method=method)
    assert n < 15
    _assert_enumeration(tb)


@pytest.mark.parametrize("method,trunc,tol", [
    ("sketch", tp.TruncBond(8), 1e-6),
    ("randomized", tp.TruncThresh(0.0), 1e-8)])
def test_banded_star_reaches_enumeration(method, trunc, tol):
    """A hub of degree 4 (the K > 3 prefix/suffix folds over the band,
    Y = 5) and the leaves' K = 1 bucket."""
    g = tp.star_graph(5)
    tb = tglauber.mpbp_glauber(tglauber.Glauber(tglauber.Ising(
        g, np.full(4, 0.4), np.linspace(-0.3, 0.3, 5), 0.8), 2), D=8,
        device="cpu")
    assert tb.tables.yy_off == 0 and tb.tables.Y == 5
    tb, _, _ = tp.iterate(tb, maxiter=10, trunc=trunc, tol=0.0,
                          method=method)
    _assert_enumeration(tb, tol)


@pytest.mark.parametrize("method", ["sketch", "randomized"])
def test_restricted_dense_matches_banded(method):
    """The Restricted specs (explicit-sum Pyp, dense per-node Pyy: the
    grouped update) against the banded path, sweep for sweep."""
    g = tp.graph_from_edges(*TREE)
    h = np.random.default_rng(5).normal(0, 0.3, 4)
    fast = tglauber.mpbp_glauber(tglauber.Glauber(tglauber.Ising(
        g, np.full(3, 0.4), h, 1.0), 3), D=8, device="cpu")
    specs = [tp.RestrictedFactorSpec(
        tglauber.HomogeneousGlauberFactorSpec(0.4, float(h[i]), 1.0))
        for i in range(4)]
    slow = tp.mpbp(g, tp.build_tables(g, specs), 3, D=8, phi=fast.phi,
                   device="cpu")
    assert fast.tables.yy_off == 0 and slow.tables.yy_off is None
    assert slow.tables.Pyy.shape[0] == 4
    trunc = tp.TruncBond(8) if method == "sketch" else tp.TruncThresh(0.0)
    for _ in range(4):
        fast = tp.bp_sweep(fast, trunc, method=method)
        slow = tp.bp_sweep(slow, trunc, method=method)
    np.testing.assert_allclose(tp.beliefs(fast).numpy(),
                               tp.beliefs(slow).numpy(), atol=1e-10)
    np.testing.assert_allclose(float(tp.bethe_free_energy(fast)),
                               float(tp.bethe_free_energy(slow)), atol=1e-9)


def test_erdos_renyi_with_isolated_nodes_runs():
    """Every method runs on an ER graph with isolated nodes (their slots
    all padded); an isolated spin's beliefs are its exact marginals under
    the field alone."""
    g = tp.erdos_renyi_graph(24, 1.5, np.random.default_rng(2))
    iso = np.nonzero(g.degree == 0)[0]
    assert len(iso) and g.dmax >= 3
    h, beta, T = np.linspace(-0.5, 0.5, g.N), 0.8, 3
    ising = tglauber.Ising(g, np.full(g.E // 2, 0.6), h, beta)
    for method, trunc in (("sketch", tp.TruncBond(4)),
                          ("qr", tp.TruncBond(4)),
                          ("randomized", tp.TruncBond(4))):
        tb = tglauber.mpbp_glauber(tglauber.Glauber(ising, T), D=4,
                                   device="cpu")
        tb = tp.bp_sweep(tb, trunc, method=method)
        b = tp.beliefs(tb).numpy()
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b.sum(-1), 1.0, rtol=1e-12)
        for i in iso:
            p = np.array([0.5, 0.5])
            up = 1.0 / (1.0 + np.exp(-2.0 * beta * h[i]))   # P(spin +1)
            for t in range(T + 1):
                np.testing.assert_allclose(b[i, t], p, atol=1e-12)
                p = np.array([up, 1.0 - up])


def test_spins_and_energy_match_jax():
    N, edges = TREE
    x = np.array([0, 1, 1, 0])
    assert np.array_equal(tglauber.potts2spin(x), jglauber.potts2spin(x))
    assert np.array_equal(tglauber.spin2potts(tglauber.potts2spin(x)), x)
    J, h = [0.3, -0.7, 1.1], [0.2, -0.1, 0.0, 0.3]
    te = tglauber.energy(tglauber.Ising(tp.graph_from_edges(N, edges), J, h),
                         x)
    je = jglauber.energy(jglauber.Ising(mp.graph_from_edges(N, edges), J, h),
                         x)
    assert te == je
    with pytest.raises(ValueError):
        tglauber.Ising(tp.graph_from_edges(N, edges), [0.1], h)


@pytest.mark.parametrize("ctor", ["periodic", "stationary", "flag"])
def test_unported_constructors_raise(ctor):
    """Every constructor beside ``mpbp_glauber`` builds the JAX package's
    state: both periodic ones a trace-closed state whose first sweep
    matches its own (1e-10), the stationary one (ported with
    ``stationary.py``) a state whose three sweeps match its own (beliefs
    and ``f``, 1e-9)."""
    g = tp.graph_from_edges(*TREE)
    gl = tglauber.Glauber(tglauber.Ising(g, [0.5] * 3, H), 2)
    jgl = jglauber.Glauber(jglauber.Ising(mp.graph_from_edges(*TREE),
                                          [0.5] * 3, H), 2)
    if ctor == "stationary":
        tb = tglauber.mpbp_stationary_glauber(gl, D=4, device="cpu")
        jb = jglauber.mpbp_stationary_glauber(jgl, D=4)
        tb, _, _, _ = tstat.iterate_stationary(
            tb, maxiter=3, trunc=tstat.TruncVUMPS(4), tol=0.0)
        jb, _, _, _ = jstat.iterate_stationary(
            jb, maxiter=3, trunc=jstat.TruncVUMPS(4), tol=0.0)
        np.testing.assert_allclose(tstat.beliefs_stationary(tb),
                                   jstat.beliefs_stationary(jb), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=0,
                                   atol=1e-9)
        return
    if ctor == "periodic":
        tb = tglauber.periodic_mpbp_glauber(gl, D=4, device="cpu")
    else:
        tb = tglauber.mpbp_glauber(gl, D=4, periodic=True, device="cpu")
    jb = jglauber.periodic_mpbp_glauber(jgl, D=4)
    assert tb.periodic and tb.tables.yy_off == jb.tables.yy_off
    tb = tp.bp_sweep(tb, tp.TruncBond(4))
    jb = mp.bp_sweep(jb, mp.TruncBond(4))
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=0,
                               atol=1e-10)


def test_equilibrium_oracles_match_jax():
    for k, J, h in ((3, 0.6, 0.1), (4, 0.3, 0.0)):
        np.testing.assert_array_equal(
            teq.equilibrium_observables(teq.RandomRegular(k), J, 0.8, h),
            jeq.equilibrium_observables(jeq.RandomRegular(k), J, 0.8, h))
    cb_t, cb_j = teq.CB_Pop(), jeq.CB_Pop()
    out_t = teq.equilibrium_magnetization(
        teq.ErdosRenyi(3.0), beta=0.9, popsize=40, maxiter=5, nsamples=20,
        rng=np.random.default_rng(4), callback=cb_t)
    out_j = jeq.equilibrium_magnetization(
        jeq.ErdosRenyi(3.0), beta=0.9, popsize=40, maxiter=5, nsamples=20,
        rng=np.random.default_rng(4), callback=cb_j)
    assert out_t == out_j and cb_t.m == cb_j.m


def test_inference_metrics_match_jax():
    rng = np.random.default_rng(6)
    guess, true = rng.permutation(20), rng.choice(20, 4, replace=False)
    for a, b in zip(tinf.roc(guess, true), jinf.roc(guess, true)):
        np.testing.assert_array_equal(a, b)
    assert tinf.auc(guess, true) == jinf.auc(guess, true)
    bg = rng.dirichlet(np.ones(3), size=(5, 4))
    bt = rng.dirichlet(np.ones(3), size=(5, 4))
    bg[0, 0] = [0.0, 0.5, 0.5]
    np.testing.assert_array_equal(tinf.kl_marginals(bg, bt),
                                  jinf.kl_marginals(bg, bt))
    np.testing.assert_array_equal(tinf.l1_marginals(bg, bt, 2),
                                  jinf.l1_marginals(bg, bt, 2))
