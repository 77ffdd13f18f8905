"""The port's soft-margin sampler, its estimators, the observation draw and
the Gillespie SIS against the JAX package, BP and enumeration (f64, CPU).

The two packages draw from different generators, so: the estimators run on
the JAX package's own ``X`` and ``logw`` and equal its output (1e-12); the
port's draws hold BP and enumeration within 6 max(err, 5e-3 | 8e-3), as
``tests/test_sampling_and_observations.py:17-54`` does; the observation
draw picks the JAX package's cells from the same numpy ``rng`` and
reweights them as it does; the host Gillespie simulator is bit-equal from
the same ``rng``.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import sampling as jsampling
from matrixproductbp_tpu.models import SIS as JSIS, mpbp_sis as jmpbp_sis
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact, sampling
from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
from matrixproductbp_tpu_torch.observations import pair_observations_directed

TREE4 = (4, [(0, 1), (0, 2), (2, 3)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return tp.graph_from_edges(*TREE4)


def _converged(T, psi=None):
    bp = mpbp_sis(SIS(_tree(), lam=0.3, rho=0.2, T=T, gamma=0.4, psi=psi),
                  D=16, device="cpu")
    return tp.iterate(bp, maxiter=20, trunc=tp.TruncThresh(0.0),
                      tol=1e-12)[0]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def jax_samples():
    """The JAX package's own weighted samples of an observed tree, and the
    same model in the port."""
    N, edges = TREE4
    jb = jmpbp_sis(JSIS(mp.graph_from_edges(N, edges), 0.3, 0.2, 3,
                        gamma=0.4), D=4)
    jb, _, _ = jsampling.draw_node_observations(
        jb, nobs=4, rng=np.random.default_rng(0), softinf=5.0)
    sms = jsampling.sample(jb, 3000, key=jax.random.PRNGKey(1))
    tb = mpbp_sis(SIS(_tree(), 0.3, 0.2, 3, gamma=0.4), D=4, device="cpu")
    tb = dataclasses.replace(tb, phi=torch.as_tensor(np.array(jb.phi)))
    ours = sampling.SoftMarginSampler(tb, torch.as_tensor(np.array(sms.X)),
                                      torch.as_tensor(np.array(sms.logw)))
    return sms, ours


def _eq(a, b, tol=1e-12):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


def test_estimators_on_jax_samples_equal_jax(jax_samples):
    theirs, ours = jax_samples
    assert len(np.unique(theirs.logw)) > 1          # the weights matter
    _eq(ours.weights, theirs.weights, 1e-14)
    v = [0.5, 2.0]
    for name, args in (("marginals_mc", ()), ("pair_marginals_mc", ()),
                       ("means_mc", (v,)), ("autocorrelations_mc", ()),
                       ("autocorrelations_mc", (v, 2)),
                       ("autocovariances_mc", (v,))):
        a = getattr(sampling, name)(ours, *args)
        b = getattr(jsampling, name)(theirs, *args)
        for x, y in zip(a, b):
            _eq(x, y)


def test_sampler_matches_bp_marginals():
    bp = _converged(3)
    b = tp.beliefs(bp)
    sms = sampling.sample(bp, 20000, generator=_gen(1))
    assert sms.X.dtype == torch.int32 and sms.X.shape == (20000, 4, 4)
    assert sms.logw.dtype == torch.float64
    m, err = sampling.marginals_mc(sms)
    assert bool((torch.abs(m - b) < 6 * torch.clamp(err, min=5e-3)).all())


def test_sampler_weighted_by_observations():
    """With observations the sampler importance-weights; its marginals
    still agree with enumeration on the tree."""
    bp = mpbp_sis(SIS(_tree(), lam=0.3, rho=0.2, T=2, gamma=0.4), D=16,
                  device="cpu")
    bp, X, obs = sampling.draw_node_observations(
        bp, nobs=2, rng=np.random.default_rng(0), softinf=50.0,
        generator=_gen(0))
    bp, _, _ = tp.iterate(bp, maxiter=15, trunc=tp.TruncThresh(0.0),
                          tol=1e-12)
    p, _ = exact.exact_prob(bp)
    m_ex = exact.exact_marginals(bp, p)
    np.testing.assert_allclose(tp.beliefs(bp).numpy(), m_ex, atol=1e-8)
    sms = sampling.sample(bp, 40000, generator=_gen(2))
    m, err = sampling.marginals_mc(sms)
    assert (np.abs(m.numpy() - m_ex)
            < 6 * np.maximum(err.numpy(), 8e-3)).all()


def test_pair_and_time_estimators_match_bp():
    bp = _converged(2)
    sms = sampling.sample(bp, 20000, generator=_gen(3))
    m, err = sampling.pair_marginals_mc(sms)
    pb, _ = tp.pair_beliefs(bp)
    assert bool((torch.abs(m - pb) < 6 * torch.clamp(err, min=8e-3)).all())
    r, e = sampling.autocorrelations_mc(sms)
    assert bool((torch.abs(r - tp.autocorrelations(bp))
                 < 6 * torch.clamp(e, min=8e-3)).all())
    c, e = sampling.autocovariances_mc(sms)
    assert float(torch.abs(c - tp.autocovariances(bp)).max()) < 0.03
    mm, me = sampling.means_mc(sms)
    assert bool((torch.abs(mm - tp.means(bp))
                 < 6 * torch.clamp(me, min=8e-3)).all())


def test_sample_one_and_logw_without_observations():
    bp = _converged(2)
    x, lw = sampling.sample_one(bp, generator=_gen(4))
    assert x.shape == (4, 3) and float(lw) == 0.0
    a = sampling.sample(bp, 5)
    b = sampling.sample(bp, 5)                       # default: seeded with 0
    assert torch.equal(a.X, b.X)


@pytest.mark.parametrize("softinf", [np.inf, 20.0])
def test_draw_node_observations_like_jax(softinf):
    """The cells come from the numpy rng as the JAX package's do; each
    observed phi row is scaled by the soft indicator of the drawn state."""
    N, edges = TREE4
    jb = jmpbp_sis(JSIS(mp.graph_from_edges(N, edges), 0.3, 0.2, 2,
                        gamma=0.4), D=4)
    tb = mpbp_sis(SIS(_tree(), 0.3, 0.2, 2, gamma=0.4), D=4, device="cpu")
    _, _, jobs = jsampling.draw_node_observations(
        jb, 5, np.random.default_rng(9), softinf=softinf,
        key=jax.random.PRNGKey(0))
    tb2, X, obs = sampling.draw_node_observations(
        tb, 5, np.random.default_rng(9), softinf=softinf, generator=_gen(0))
    assert obs == jobs
    assert X.shape == (4, 3) and X.device == tb.phi.device
    one = 1.0 if np.isinf(softinf) else 1.0 / (1.0 + 1.0 / softinf)
    for (i, t) in obs:
        ind = np.where(np.arange(2) == int(X[i, t]), one, 1.0 - one)
        np.testing.assert_allclose(tb2.phi[i, t].numpy(),
                                   tb.phi[i, t].numpy() * ind, rtol=1e-15)
    _, _, last = sampling.draw_node_observations(
        tb, 3, np.random.default_rng(9), last_time=True)
    assert all(t == 2 for _, t in last)


def test_draw_node_observations_raises_on_a_zeroed_node():
    bp = mpbp_sis(SIS(_tree(), 0.3, 0.2, 2, gamma=0.4), D=4, device="cpu")
    phi = bp.phi.clone()
    phi[:, 1:] = torch.tensor([0.0, 1.0])           # only "infected" allowed
    phi[:, 0] = torch.tensor([1.0, 0.0])            # starts susceptible
    bp = dataclasses.replace(bp, phi=phi)
    with pytest.raises(ValueError, match="zeroes out node"):
        sampling.draw_node_observations(bp, 8, np.random.default_rng(0))


def test_pair_observations_vs_exact():
    """Edge reweighting psi: BP equals enumeration with pair observations
    (``test/pair_observations.jl:43-57``)."""
    rng = np.random.default_rng(5)
    obs = [(0, 2, 1, rng.uniform(0.2, 1.0, (2, 2))),
           (2, 3, 2, rng.uniform(0.2, 1.0, (2, 2)))]
    bp = _converged(2, psi=pair_observations_directed(obs, _tree(), 2, 2))
    p, Z = exact.exact_prob(bp)
    np.testing.assert_allclose(tp.beliefs(bp).numpy(),
                               exact.exact_marginals(bp, p), atol=1e-8)
    assert np.isclose(-float(tp.bethe_free_energy(bp)), np.log(Z), atol=1e-8)
    sms = sampling.sample(bp, 20000, generator=_gen(6))
    m, err = sampling.pair_marginals_mc(sms)
    assert (np.abs(m.numpy() - exact.exact_pair_marginals(bp, p))
            < 6 * np.maximum(err.numpy(), 8e-3)).all()


def test_hard_observation_log_semantics():
    """Hard observations give -inf log-weights without warnings, and
    enumeration zeroes exactly the excluded trajectories."""
    g = tp.graph_from_edges(2, [(0, 1)])
    bp = mpbp_sis(SIS(g, 0.4, 0.2, T=1, gamma=0.5), D=4, device="cpu")
    phi = bp.phi.clone()
    phi[0, 1] = torch.tensor([1.0, 0.0])
    bp = dataclasses.replace(bp, phi=phi)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        p, Z = exact.exact_prob(bp)
    assert np.isclose(p.sum(), 1.0) and np.isfinite(np.log(Z))
    X = exact._decode_all(len(p), 2, 2, 2)
    assert np.all(p[X[:, 0, 1] == 1] == 0.0)
    sms = sampling.sample(bp, 500, generator=_gen(7))
    hit = sms.X[:, 0, 1] == 1
    assert bool(hit.any()) and bool(torch.isinf(sms.logw[hit]).all())
    m, _ = sampling.marginals_mc(sms)
    assert float(m[0, 1, 1]) == 0.0


def test_gillespie_bit_equal_to_jax():
    N, edges = TREE4
    jg, tg = mp.graph_from_edges(N, edges), _tree()
    P0 = np.array([0.9, 0.8, 0.9, 0.7])
    seen = {}
    for name, mod, g in (("jax", jsampling, jg), ("port", sampling, tg)):
        ev = []
        x = mod.simulate_queue_sis(g, P0, 0.9, 0.3, 0.2, 8.0,
                                   np.random.default_rng(7),
                                   lambda t, i, x: ev.append((t, i)))
        seen[name] = (x.copy(), ev)
    np.testing.assert_array_equal(seen["jax"][0], seen["port"][0])
    assert seen["jax"][1] == seen["port"][1] and len(seen["port"][1]) > 4
    sis_j = JSIS(jg, 0.4, 0.1, 3, gamma=0.5)
    sis_t = SIS(tg, 0.4, 0.1, 3, gamma=0.5)
    a = sampling.continuous_sis_sampler(sis_t, T=3.0, lam=0.4, rho=0.1,
                                        nsamples=50, nbins=10,
                                        rng=np.random.default_rng(7))
    b = jsampling.continuous_sis_sampler(sis_j, T=3.0, lam=0.4, rho=0.1,
                                         nsamples=50, nbins=10,
                                         rng=np.random.default_rng(7))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape == (4, 11) and (np.abs(a[0]) <= 1.0).all()


def test_sampling_names_exported():
    for name in sampling.__all__:
        assert getattr(tp, name) is getattr(sampling, name)
