"""The port's SMC sampler against the JAX package and enumeration (f64,
CPU).

The effective sample size and systematic resampling equal the JAX
package's on the same ``logw`` and ``u``; the posterior under strong
observations lies within 0.03 of enumeration and ``log_evidence`` within
0.06 of log Z (``tests/test_smc.py:30-39``); resampling keeps the residual
weights non-degenerate at ``ess_frac=0.9``; with no observations it
reduces to the prior sampler; a device mesh raises (the sharded SMC waits
for the multi-device work).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixproductbp_tpu import smc as jsmc
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact, sampling, smc
from matrixproductbp_tpu_torch.models import SISFactorSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _observed_bp(T=3, seed=3):
    g = tp.graph_from_edges(4, [(0, 1), (1, 2), (1, 3)])
    tables = tp.build_tables(g, [SISFactorSpec(lam=0.3, rho=0.25)] * g.N)
    phi = np.ones((g.N, T + 1, 2))
    phi[:, 0] = [0.6, 0.4]
    bp = tp.mpbp(g, tables, T=T, D=8, phi=phi, device="cpu")
    bp, _, _ = sampling.draw_node_observations(
        bp, 5, np.random.default_rng(seed), softinf=20.0, generator=_gen(9))
    return bp


def test_ess_and_systematic_resampling_equal_jax():
    rng = np.random.default_rng(0)
    for P in (7, 64, 1000):
        logw = rng.normal(scale=3.0, size=P)
        logw[rng.integers(P)] = -np.inf
        ess = smc.effective_sample_size(torch.as_tensor(logw))
        assert abs(float(ess) - float(jsmc.effective_sample_size(
            jnp.asarray(logw)))) < 1e-10 * P
        for u in (0.0, 0.37, rng.random()):
            idx = smc.systematic_resample_indices(torch.as_tensor(logw), u)
            jidx = jsmc.systematic_resample_indices(jnp.asarray(logw),
                                                    jnp.asarray(u))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert tp.smc.smc_sample is tp.smc_sample


def test_smc_posterior_marginals_vs_exact():
    bp = _observed_bp()
    p, Z = exact.exact_prob(bp)
    m_ex = exact.exact_marginals(bp, p)
    sms = smc.smc_sample(bp, 16384, generator=_gen(0))
    m, _ = sampling.marginals_mc(sms)
    assert np.abs(m.numpy() - m_ex).max() < 0.03
    assert abs(sms.log_evidence - np.log(Z)) < 0.06


def test_smc_resampling_triggers_and_beats_degeneracy():
    bp = _observed_bp()
    sms = smc.smc_sample(bp, 2048, generator=_gen(1), ess_frac=0.9)
    assert float(smc.effective_sample_size(sms.logw)) > 0.3 * 2048
    # without resampling the same weights degenerate
    sms = smc.smc_sample(bp, 2048, generator=_gen(1), ess_frac=0.0)
    assert float(smc.effective_sample_size(sms.logw)) < 0.3 * 2048


def test_smc_reduces_to_prior_sampler_without_observations():
    g = tp.graph_from_edges(3, [(0, 1), (1, 2)])
    tables = tp.build_tables(g, [SISFactorSpec(lam=0.3, rho=0.25)] * g.N)
    phi = np.ones((g.N, 4, 2))
    phi[:, 0] = [0.7, 0.3]
    bp = tp.mpbp(g, tables, T=3, D=4, phi=phi, device="cpu")
    sms = smc.smc_sample(bp, 4096, generator=_gen(3))
    assert np.allclose(sms.logw.numpy(), 0.0)
    assert abs(sms.log_evidence) < 1e-12
    m, _ = sampling.marginals_mc(sms)
    p, _ = exact.exact_prob(bp)
    assert np.abs(m.numpy() - exact.exact_marginals(bp, p)).max() < 0.04


def test_smc_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 9"):
        smc.smc_sample(_observed_bp(), 8, mesh=object())
