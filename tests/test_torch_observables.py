"""The port's observables against the JAX package and enumeration (f64,
CPU).

Every function of the port's tensor-train, time, pair, normalization and
accessor observables runs on the same state as the JAX package's (carried
across as arrays), to 1e-10: ``normalization``, ``twovar_marginals``,
``bond_ranks``, ``beliefs_tu``, ``autocorrelations``, ``autocovariances``,
``pair_beliefs``, ``pair_lognorms``, ``pair_correlations``,
``alternate_marginals``, ``alternate_correlations``,
``pair_beliefs_as_tt``, ``logprob``, the resets and the accessors (the
belief normalizations and the pair-route free energy are in
``test_torch_belief_lognorms.py``).  The small-tree gates of
``tests/test_sis_small_tree.py:47-110`` hold against enumeration, and the
repaired ``transition_probs`` takes a batch of particles.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import checkpoint as jckpt
from matrixproductbp_tpu import exact as jexact
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
from matrixproductbp_tpu_torch.ops.tensortrain import TensorTrain

TREE4 = (4, [(0, 1), (0, 2), (2, 3)])
# node 0 has degree 4: buckets K = 1, 4 (the prefix fold over 4 slots)
STAR5 = (5, [(0, 1), (0, 2), (0, 3), (0, 4)])
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(tb, path):
    """The port state as a JAX state, through the shared checkpoint
    format."""
    np.savez(path, **tp.to_numpy_state(tb))
    return jckpt.load_checkpoint(str(path))[0]


def _sis(graph, T=2, D=16, lam=0.35, rho=0.25, gamma=0.4, phi=None):
    N, edges = graph
    tb = mpbp_sis(SIS(tp.graph_from_edges(N, edges), lam, rho, T,
                      gamma=gamma), D=D, device="cpu")
    if phi is not None:
        tb = dataclasses.replace(tb, phi=torch.as_tensor(phi))
    return tb


def _converged(tb, maxiter=12):
    return tp.iterate(tb, maxiter=maxiter, trunc=tp.TruncThresh(0.0),
                      tol=1e-13)[0]


@pytest.fixture(scope="module")
def tree4(tmp_path_factory):
    """The converged 4-node tree of tests/test_sis_small_tree.py, in both
    packages, with its enumeration."""
    tb = _converged(_sis(TREE4))
    p, Z = exact.exact_prob(tb)
    return to_jax(tb, tmp_path_factory.mktemp("t4") / "s.npz"), tb, p, Z


@pytest.fixture(scope="module")
def star5(tmp_path_factory):
    """A 5-node star (a degree-4 node), observed at two cells and
    converged, in both packages."""
    phi = np.ones((5, 3, 2))
    phi[:, 0] = [0.6, 0.4]
    phi[4, 2] = [0.2, 0.8]
    phi[1, 1] = [0.9, 0.1]
    tb = _converged(_sis(STAR5, phi=phi))
    return to_jax(tb, tmp_path_factory.mktemp("t6") / "s.npz"), tb


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# tensor trains
# ---------------------------------------------------------------------------

def test_tensortrain_observables_match_jax():
    """normalization, twovar_marginals (all and maxdist) and bond_ranks of
    the same random trains; rand_tt's bond pattern and positivity, and
    its periodic rings (no boundary rows)."""
    from matrixproductbp_tpu.ops import tensortrain as jtt
    g = torch.Generator().manual_seed(3)
    t = tp.rand_tt(g, 5, 4, (2, 3), bond=3)
    c = t.cores.numpy()
    assert (c >= 0).all() and (c[:, 3:] == 0).all() and (c[:, :, 3:] == 0).all()
    assert (c[0, 1:] == 0).all() and (c[-1, :, 1:] == 0).all()
    assert t.cores.shape == (5, 4, 4, 6) and (c[1, :3, :3] > 0).all()
    batch = torch.stack([t.cores, tp.rand_tt(g, 5, 4, (2, 3)).cores])
    tt = TensorTrain(batch, torch.tensor([0.3, -0.2], dtype=torch.float64),
                     (2, 3))
    jts = [jtt.TensorTrain(jnp.asarray(batch[k].numpy()),
                           jnp.asarray(float(tt.logz[k])), (2, 3))
           for k in range(2)]
    _close(tp.normalization(tt)[1], jtt.normalization(jts[1]))
    np.testing.assert_array_equal(tp.bond_ranks(tt, tol=1e-12)[0],
                                  np.asarray(jtt.bond_ranks(jts[0], 1e-12)))
    _close(tp.twovar_marginals(tt)[1], jtt.twovar_marginals(jts[1]))
    _close(tp.twovar_marginals(tt, maxdist=2)[0],
           jtt.twovar_marginals(jts[0], maxdist=2))
    np.testing.assert_array_equal(tp.bond_ranks(tt, tol=1e-12)[0],
                                  [1, 3, 3, 3, 3])
    ring = tp.rand_tt(g, 3, 2, (2,), periodic=True)
    assert ring.periodic and (ring.cores[0, 1:] > 0).any()


# ---------------------------------------------------------------------------
# time and pair observables on the same state as the JAX package
# ---------------------------------------------------------------------------

def test_time_observables_match_jax(star5):
    """Two-time marginals (all and maxdist=1) from the JAX package; the
    correlations with a value table on its two-time marginals, and its
    autocovariances."""
    jb, tb = star5
    v = np.array([0.5, -1.5])
    jtu = np.asarray(mp.beliefs_tu(jb))
    _close(tp.beliefs_tu(tb), jtu)
    jtu1 = np.asarray(mp.beliefs_tu(jb, maxdist=1))
    _close(tp.beliefs_tu(tb, maxdist=1), jtu1)
    _close(tp.autocorrelations(tb), np.einsum("ntupq,p,q->ntu", jtu,
                                              np.arange(2.0), np.arange(2.0)))
    _close(tp.autocorrelations(tb, v, maxdist=1),
           np.einsum("ntupq,p,q->ntu", jtu1, v, v))
    _close(tp.autocovariances(tb, v), mp.autocovariances(jb, jnp.asarray(v)))


def test_pair_observables_match_jax(star5):
    jb, tb = star5
    v = np.array([1.0, 3.0])
    pb, lzn = tp.pair_beliefs(tb)
    jpb, jlzn = mp.pair_beliefs(jb)
    _close(pb, jpb)
    _close(lzn, jlzn)
    _close(tp.pair_lognorms(tb), mp.pair_lognorms(jb))
    _close(tp.pair_correlations(tb, v),
           np.einsum("etpq,p,q->et", np.asarray(jpb), v, v))
    jam = np.asarray(mp.alternate_marginals(jb))
    _close(tp.alternate_marginals(tb), jam)
    _close(tp.alternate_correlations(tb),
           np.einsum("etpq,p,q->et", jam, np.arange(2.0), np.arange(2.0)))
    cores, lz = tp.pair_beliefs_as_tt(tb)
    jcores, jlz = mp.pair_beliefs_as_tt(jb)
    assert cores.shape == (tb.graph.E, 3, 256, 256, 4)
    _close(cores, jcores, 1e-12)
    _close(lz, jlz, 1e-12)
    assert tp.pair_beliefs_as_mpem is tp.pair_beliefs_as_tt


def test_pair_sums_and_consistency(star5):
    """Pair and alternate marginals sum to 1; summed over x_j the pair
    belief is the belief of x_i (BP's fixed point on a tree)."""
    _, tb = star5
    pb, _ = tp.pair_beliefs(tb)
    _close(pb.sum(dim=(-2, -1)), torch.ones(pb.shape[:2], dtype=pb.dtype))
    am = tp.alternate_marginals(tb)
    _close(am.sum(dim=(-2, -1)), torch.ones(am.shape[:2], dtype=am.dtype))
    src = torch.as_tensor(tb.graph.edge_src, dtype=torch.int64)
    _close(pb.sum(-1), tp.beliefs(tb)[src], 1e-9)


def test_logprob_matches_jax_and_enumeration(tree4):
    jb, tb, p, Z = tree4
    X = exact._decode_all(len(p), 2, 4, 3)
    rng = np.random.default_rng(0)
    for idx in rng.choice(np.nonzero(p > 1e-6)[0], size=4, replace=False):
        lp = tp.logprob(tb, X[idx])
        assert abs(lp - mp.logprob(jb, X[idx])) < TOL
        assert abs(lp - (np.log(p[idx]) + np.log(Z))) < 1e-9
        assert abs(tp.logprob(tb, torch.as_tensor(X[idx])) - lp) == 0.0


def test_resets_and_accessors_match_jax(star5):
    jb, tb = star5
    for name in ("reset_messages", "reset_beliefs", "reset_observations"):
        a, b = getattr(tp, name)(tb), getattr(mp, name)(jb)
        for leaf in ("msg_cores", "msg_logz", "bel_cores", "bel_logz",
                     "phi", "psi"):
            _close(getattr(a, leaf), getattr(b, leaf), 1e-14)
    r = tp.reset(tb, observations=True)
    jr = mp.reset(jb, observations=True)
    _close(tp.beliefs(r), mp.beliefs(jr), 1e-14)
    _close(r.phi, jr.phi, 0.0)
    assert tp.is_periodic(tb) is False
    assert tp.is_free_dynamics(tb) == mp.is_free_dynamics(jb) is False
    assert tp.is_free_dynamics(tp.reset_observations(tb))
    assert (tp.getT(tb), tp.getN(tb), tp.nstates(tb), tp.nstates(tb, 2)) == \
        (mp.getT(jb), mp.getN(jb), mp.nstates(jb), mp.nstates(jb, 2))
    pm = np.array([[0.1, 0.2], [0.3, 0.4]])
    for f in ([1.0, -1.0], lambda x: 2.0 * x - 1.0):
        assert tp.expectation(f, pm) == mp.expectation(f, pm)
        np.testing.assert_array_equal(tp.expectation(f, pm[0]),
                                      mp.expectation(f, pm[0]))


def test_cb_bp_records_like_jax(star5):
    """The callback records what the JAX package's records on the same
    state, and one entry a sweep of ``iterate``."""
    jb, tb = star5
    jcb, tcb = mp.CB_BP(jnp.asarray([1.0, 2.0])), tp.CB_BP([1.0, 2.0])
    assert tcb(tb, 0, 0.25) == jcb(jb, 0, 0.25) == 0.25
    _close(tcb.m[0], jcb.m[0])
    assert tcb.Delta == jcb.Delta
    cb = tp.CB_BP()
    _, _, deltas = tp.iterate(_sis(TREE4), maxiter=3,
                              trunc=tp.TruncThresh(0.0), tol=0.0,
                              callback=cb)
    assert cb.Delta == deltas and len(cb.m) == 3
    assert cb.m[0].shape == (4, 3)


def test_inference_resets_through_bp():
    """``find_infected_bp`` now starts from ``bp.reset_messages``."""
    from matrixproductbp_tpu_torch.models import find_infected_bp
    guesses, out = find_infected_bp(_sis(TREE4), tol=1e-8, maxiter=30)
    assert len(guesses) == 3 and sorted(guesses[0]) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the small-tree gates against enumeration (tests/test_sis_small_tree.py)
# ---------------------------------------------------------------------------

def test_pair_marginals_match_exact(tree4):
    _, tb, p, _ = tree4
    pb, _ = tp.pair_beliefs(tb)
    np.testing.assert_allclose(pb.numpy(), exact.exact_pair_marginals(tb, p),
                               atol=1e-8)


def test_pair_logz_assembles_free_energy(tree4):
    _, tb, _, Z = tree4
    F_pair = float(tp.bethe_free_energy_pair(tb))
    assert np.isclose(F_pair, float(tp.bethe_free_energy(tb)), atol=1e-9)
    assert np.isclose(-F_pair, np.log(Z), atol=1e-9)
    _, logz_pair = tp.pair_beliefs(tb)
    lz_e = tp.pair_lognorms(tb).numpy()
    dst = tb.graph.edge_dst
    deg = np.asarray(tb.graph.degree, float)
    expect = np.zeros(tb.N)
    np.add.at(expect, dst, (1.0 / deg[dst] - 0.5) * lz_e)
    np.testing.assert_allclose(logz_pair.numpy(), expect, atol=1e-10)


def test_autocorrelations_match_exact(tree4):
    _, tb, p, _ = tree4
    np.testing.assert_allclose(tp.autocorrelations(tb).numpy(),
                               exact.exact_autocorrelations(tb, p=p),
                               atol=1e-8)


def test_autocovariances_match_exact(tree4):
    _, tb, p, _ = tree4
    np.testing.assert_allclose(tp.autocovariances(tb).numpy(),
                               exact.exact_autocovariances(tb, p=p),
                               atol=1e-8)


def test_alternate_marginals_match_exact(tree4):
    _, tb, p, _ = tree4
    np.testing.assert_allclose(tp.alternate_marginals(tb).numpy(),
                               exact.exact_alternate_marginals(tb, p),
                               atol=1e-8)


def test_observations_reweighting(tmp_path):
    """Soft observations (phi) keep BP equal to enumeration on the tree, and
    every observable with them; the JAX package's enumeration agrees."""
    bp = _sis(TREE4)
    phi = bp.phi.clone()
    phi[1, 2] = torch.tensor([0.2, 0.8])
    phi[3, 1] = torch.tensor([0.9, 0.1])
    bp = dataclasses.replace(bp, phi=phi)
    bp, _, _ = tp.iterate(bp, maxiter=15, trunc=tp.TruncThresh(0.0),
                          tol=1e-13)
    p, Z = exact.exact_prob(bp)
    np.testing.assert_allclose(tp.beliefs(bp).numpy(),
                               exact.exact_marginals(bp, p), atol=1e-9)
    assert np.isclose(-float(tp.bethe_free_energy(bp)), np.log(Z),
                      atol=1e-9)
    assert np.isclose(-float(tp.bethe_free_energy_pair(bp)), np.log(Z),
                      atol=1e-9)
    np.testing.assert_allclose(tp.pair_beliefs(bp)[0].numpy(),
                               exact.exact_pair_marginals(bp, p), atol=1e-8)
    np.testing.assert_allclose(tp.alternate_marginals(bp).numpy(),
                               exact.exact_alternate_marginals(bp, p),
                               atol=1e-8)
    jp, jZ = jexact.exact_prob(to_jax(bp, tmp_path / "obs.npz"))
    np.testing.assert_allclose(p, jp, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# transition_probs: any leading batch, on the tables' device
# ---------------------------------------------------------------------------

def test_transition_probs_takes_a_particle_batch(star5):
    jb, tb = star5
    g = tb.graph
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2, size=(5, g.N))
    nbr = np.minimum(g.nbr, g.N - 1)
    out = tp.transition_probs(tb.tables, g.in_mask, torch.as_tensor(x[:, nbr]),
                              torch.as_tensor(x))
    assert out.shape == (5, g.N, 2)
    for s in range(5):
        ref = mp.transition_probs(jb.tables, jnp.asarray(g.in_mask),
                                  jnp.asarray(x[s][nbr]), jnp.asarray(x[s]))
        _close(out[s], ref, 1e-14)
