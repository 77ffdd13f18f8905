"""The port's enumeration oracles and observation builders against the JAX
package's (numpy both: 1e-14, or bit for bit given the same inputs).

``exact_prob`` to 1e-14 on an SIS tree with node and pair observations and
on a q=3 SIRS tree; every other oracle fed the JAX package's trajectory law
``p`` equals its counterpart bit for bit (with and without a value table);
the pair-observation builders equal the JAX package's for the same lists.
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import exact as jexact
from matrixproductbp_tpu import observations as jobs
from matrixproductbp_tpu.models import SIS as JSIS, mpbp_sis as jmpbp_sis
from matrixproductbp_tpu.models import SIRS as JSIRS, mpbp_sirs as jmpbp_sirs
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact, observations
from matrixproductbp_tpu_torch.models import SIS, mpbp_sis, SIRS, mpbp_sirs

TREE4 = (4, [(0, 1), (0, 2), (2, 3)])
ORACLES = ["site_marginals", "exact_marginals", "exact_pair_marginals",
           "exact_alternate_marginals", "exact_autocorrelations",
           "exact_autocovariances", "exact_marginal_expectations",
           "exact_pair_marginal_expectations",
           "exact_alternate_marginal_expectations"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair_obs(rng, q):
    return [(0, 2, 1, rng.uniform(0.2, 1.0, (q, q))),
            (3, 2, 2, rng.uniform(0.2, 1.0, (q, q)))]


@pytest.fixture(scope="module", params=["sis_observed", "sirs"])
def states(request):
    """The same model in both packages: SIS on the 4-node tree with two
    pair observations and a node observation (T=2), or SIRS (q=3, T=1)."""
    N, edges = TREE4
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    if request.param == "sirs":
        jb = jmpbp_sirs(JSIRS(jg, 0.3, 0.2, 0.15, T=1, gamma=0.4), D=4)
        tb = mpbp_sirs(SIRS(tg, 0.3, 0.2, 0.15, T=1, gamma=0.4), D=4,
                       device="cpu")
        return jb, tb
    psi = jobs.pair_observations_directed(_pair_obs(
        np.random.default_rng(5), 2), jg, 2, 2)
    jb = jmpbp_sis(JSIS(jg, 0.3, 0.2, 2, gamma=0.4, psi=psi), D=4)
    tb = mpbp_sis(SIS(tg, 0.3, 0.2, 2, gamma=0.4, psi=psi), D=4,
                  device="cpu")
    phi = np.asarray(jb.phi).copy()
    phi[3, 1] = [0.9, 0.1]
    jb = mp.MPBP(jb.tables, jb.phi.at[:].set(phi), jb.psi, jb.msg_cores,
                 jb.msg_logz, jb.bel_cores, jb.bel_logz, jb.f, jb.garrays,
                 jb.graph)
    tb.phi[:] = torch.as_tensor(phi)
    return jb, tb


def test_exact_prob_matches_jax(states):
    jb, tb = states
    p, Z = exact.exact_prob(tb)
    jp, jZ = jexact.exact_prob(jb)
    np.testing.assert_allclose(p, jp, rtol=1e-12, atol=1e-14)
    assert abs(np.log(Z) - np.log(jZ)) < 1e-14 * max(1.0, abs(np.log(jZ)))


@pytest.mark.parametrize("name", ORACLES)
def test_oracle_equals_jax(states, name):
    jb, tb = states
    jp, _ = jexact.exact_prob(jb)
    ours, theirs = getattr(exact, name), getattr(jexact, name)
    if name == "site_marginals" or "expectation" not in name and \
            "auto" not in name:
        a, b = ours(tb, p=jp), theirs(jb, p=jp)
    else:
        v = np.array([0.5, -1.0, 2.0])[:tb.q]
        a, b = ours(tb, v, p=jp), theirs(jb, v, p=jp)
        np.testing.assert_array_equal(ours(tb, p=jp), theirs(jb, p=jp))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_top_level_oracles_exported():
    for name in ORACLES + ["exact_prob"]:
        assert getattr(tp, name) is getattr(exact, name)


def test_pair_observation_builders_match_jax():
    N, edges = TREE4
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    obs = _pair_obs(np.random.default_rng(7), 3)
    for name in ("pair_observations_directed",
                 "pair_observations_nondirected"):
        a = getattr(observations, name)(obs, tg, 3, 3)
        np.testing.assert_array_equal(a, getattr(jobs, name)(obs, jg, 3, 3))
        assert getattr(tp, name) is getattr(observations, name)
    psi_u = np.random.default_rng(1).uniform(0.5, 1.0, (tg.E // 2, 2, 2, 2))
    a = observations.pair_obs_undirected_to_directed(psi_u, tg)
    np.testing.assert_array_equal(
        a, jobs.pair_obs_undirected_to_directed(psi_u, jg))
    np.testing.assert_array_equal(a, a[tg.rev_edge].transpose(0, 1, 3, 2))
    with pytest.raises(ValueError, match="shape"):
        observations.pair_observations_directed(obs, tg, 3, 2)


def test_misc_utilities_match_jax():
    from matrixproductbp_tpu.utils import misc as jmisc
    from matrixproductbp_tpu_torch.utils import misc
    vals = np.random.default_rng(0).normal(size=(5, 3))
    errs = np.abs(vals) * 0.1
    for a, b in zip(misc.mean_with_uncertainty(vals, errs),
                    jmisc.mean_with_uncertainty(vals, errs)):
        np.testing.assert_array_equal(a, b)
    assert tp.mean_with_uncertainty is misc.mean_with_uncertainty
    p = np.array([0.2, 0.5, 0.3])
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    assert [misc.sample_categorical(r1, p) for _ in range(50)] == \
        [jmisc.sample_categorical(r2, p) for _ in range(50)]
