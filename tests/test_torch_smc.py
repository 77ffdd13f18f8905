"""The port's SMC sampler against the JAX package and enumeration (f64,
CPU).

The effective sample size and systematic resampling equal the JAX
package's on the same ``logw`` and ``u``; the posterior under strong
observations lies within 0.03 of enumeration and ``log_evidence`` within
0.06 of log Z (``tests/test_smc.py:30-39``); resampling keeps the residual
weights non-degenerate at ``ess_frac=0.9``; with no observations it
reduces to the prior sampler.  Split over 2 and 4 gloo ranks (one spawned
group of 4, rank functions in ``_torch_ranks.py``), SMC draws the
single-device run's trajectories exactly and its weights to rtol 1e-12,
and its posterior lies within 0.03 of enumeration.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixproductbp_tpu import smc as jsmc
import _torch_ranks as R
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact, sampling, smc
from matrixproductbp_tpu_torch.models import SISFactorSpec
from matrixproductbp_tpu_torch.parallel import spawn_ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


_observed_bp = R.observed_tree


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


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{case: [each rank's (X, logw, log_evidence)]} of every sharded run
    of ``_torch_ranks.SMC_CASES``: one spawned group of 4 gloo ranks, the
    2-rank run on a subgroup."""
    res = spawn_ranks(R.smc_cases, 4, threads=1, timeout=600,
                      store_dir=str(tmp_path_factory.mktemp("ranks")))
    return {case: [r[case] for r in res] for case in R.SMC_CASES}


def _joined(runs, P):
    runs = [r for r in runs if r is not None]
    for rank, (X, _, _) in enumerate(runs):
        assert len(X) == len(smc.particle_range(P, rank, len(runs)))
    return (np.concatenate([X for X, _, _ in runs]),
            np.concatenate([lw for _, lw, _ in runs]),
            [lz for _, _, lz in runs])


@pytest.mark.parametrize("case", ["two", "four"])
def test_smc_sharded_matches_single_device(sharded, case, monkeypatch):
    """2 and 4 ranks draw the single-device run's trajectories, in batches
    that straddle the ranks' blocks, through resampling steps."""
    nranks, P, batch, seed = R.SMC_CASES[case]
    monkeypatch.setattr(smc, "_STEP_CELLS", batch * 4)
    ref = smc.smc_sample(_observed_bp(), P, generator=_gen(seed))
    assert float(smc.effective_sample_size(ref.logw)) < P    # resampled
    X, logw, lzs = _joined(sharded[case], P)
    np.testing.assert_array_equal(X, ref.X.numpy())
    np.testing.assert_allclose(logw, ref.logw.numpy(), rtol=1e-12)
    assert all(abs(lz - ref.log_evidence) <= 1e-12 * abs(ref.log_evidence)
               for lz in lzs)


def test_smc_sharded_posterior_vs_exact(sharded):
    nranks, P, _, _ = R.SMC_CASES["posterior"]
    bp = _observed_bp()
    X, logw, lzs = _joined(sharded["posterior"], P)
    p, Z = exact.exact_prob(bp)
    sms = sampling.SoftMarginSampler(bp, torch.as_tensor(X),
                                     torch.as_tensor(logw))
    m, _ = sampling.marginals_mc(sms)
    assert np.abs(m.numpy() - exact.exact_marginals(bp, p)).max() < 0.03
    assert all(abs(lz - np.log(Z)) < 0.06 for lz in lzs)
