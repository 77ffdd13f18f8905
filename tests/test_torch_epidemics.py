"""The port's SIRS model against the JAX package and the enumeration oracle
(f64, CPU).

SIRS builds its tables with ``build_tables``: per-node, dense ``prob_yy``,
which the sweep runs as groups of nodes with one shared table (here one
group a bucket).  One sweep on a tree by each method, with the JAX
package's sketches: beliefs and the free-energy ledger ``f`` to 1e-9.
Iterated, it reaches enumeration at the JAX package's gate
(``tests/test_sirs_and_heterogeneous.py``: 1e-8).  The periodic
constructors of every epidemic model sweep, and the stationary ones
iterate as the JAX package's do.
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import stationary as jstat
from matrixproductbp_tpu.models import sirs as jsirs
from matrixproductbp_tpu.models import sis as jsis
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import bp as tbp
from matrixproductbp_tpu_torch import stationary as tstat
from matrixproductbp_tpu_torch.models import (SIS, mpbp_stationary_sis,
                                              periodic_mpbp_sis)
from matrixproductbp_tpu_torch.models import sirs as tsirs
from matrixproductbp_tpu_torch.models import sis_heterogeneous as thet
from test_torch_models import METHODS, _assert_enumeration, \
    _assert_one_sweep_matches

TREE = (4, [(0, 1), (0, 2), (2, 3)])
SIRS_ARGS = dict(lam=0.3, rho=0.2, sigma=0.15, T=2, gamma=0.4, alpha=0.05)
# the stationary mode applies phi[:, 0] at every step: the default's
# phi(R) = 0 would leave only the all-susceptible state
FLAT_SIRS_PHI = np.ones((4, 3, 3))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _het_args(g):
    rng = np.random.default_rng(0)
    return dict(lam_d=rng.uniform(0.1, 0.5, g.E),
                rho=rng.uniform(0.1, 0.4, g.N), T=2, gamma=0.3)


def _sirs(D, device="cpu"):
    return tsirs.mpbp_sirs(tsirs.SIRS(tp.graph_from_edges(*TREE),
                                      **SIRS_ARGS), D=D, device=device)


@pytest.mark.parametrize("method,D,trunc,jtrunc", METHODS,
                         ids=[m[0] for m in METHODS])
def test_sirs_sweep_matches_jax(method, D, trunc, jtrunc):
    jb = jsirs.mpbp_sirs(jsirs.SIRS(mp.graph_from_edges(*TREE), **SIRS_ARGS),
                         D=D)
    tb = _sirs(D)
    assert tb.q == 3 and tb.tables.Pyy.shape[0] == 4
    _assert_one_sweep_matches(jb, tb, method, jtrunc, trunc)


def test_sirs_reaches_enumeration():
    tb, n, _ = tp.iterate(_sirs(10), maxiter=15, trunc=tp.TruncThresh(0.0),
                          tol=1e-13, method="randomized")
    assert n < 15
    _assert_enumeration(tb)


def test_sirs_buckets_form_one_group_each():
    tb = _sirs(4)
    for idx, Kb in tbp._degree_buckets(tb.graph):
        Yb = tb.tables.ydims[Kb]
        ((gidx, P),) = tbp._pyy_groups(tb.tables, idx, Kb, Yb)
        assert np.array_equal(gidx, idx) and P.shape == (1, Kb, 2, 2, 2, 3)


@pytest.mark.parametrize("ctor,stationary", [
    (lambda g: tsirs.periodic_mpbp_sirs(tsirs.SIRS(g, **SIRS_ARGS), D=4,
                                        device="cpu"), False),
    (lambda g: (tsirs.mpbp_stationary_sirs(
        tsirs.SIRS(g, **SIRS_ARGS, phi=FLAT_SIRS_PHI), device="cpu"),
                jsirs.mpbp_stationary_sirs(jsirs.SIRS(
                    mp.graph_from_edges(*TREE), **SIRS_ARGS,
                    phi=FLAT_SIRS_PHI))), True),
    (lambda g: tsirs.mpbp_sirs(tsirs.SIRS(g, **SIRS_ARGS), D=4,
                               periodic=True, device="cpu"), False),
    (lambda g: thet.periodic_mpbp_sis_heterogeneous(
        thet.SISHeterogeneous(g, **_het_args(g)), D=4, device="cpu"), False),
    (lambda g: periodic_mpbp_sis(SIS(g, 0.3, 0.2, T=2), D=4, device="cpu"),
     False),
    (lambda g: (mpbp_stationary_sis(SIS(g, 0.3, 0.2, T=2, alpha=0.05),
                                    device="cpu"),
                jsis.mpbp_stationary_sis(jsis.SIS(mp.graph_from_edges(*TREE),
                                                  0.3, 0.2, T=2,
                                                  alpha=0.05))), True),
], ids=["sirs-periodic", "sirs-stationary", "sirs-flag", "het-periodic",
        "sis-periodic", "sis-stationary"])
def test_unported_constructors_raise(ctor, stationary):
    """Every epidemic constructor beside ``mpbp_*`` builds its state: the
    periodic ones (ported with item 6) a trace-closed state that sweeps to
    finite, normalised beliefs; the stationary ones (ported with
    ``stationary.py``) the JAX package's state, whose three sweeps match
    its own (beliefs and ``f``, 1e-9)."""
    g = tp.graph_from_edges(*TREE)
    if stationary:
        tb, jb = ctor(g)
        tb, _, _, _ = tstat.iterate_stationary(
            tb, maxiter=3, trunc=tstat.TruncVUMPS(4), tol=0.0)
        jb, _, _, _ = jstat.iterate_stationary(
            jb, maxiter=3, trunc=jstat.TruncVUMPS(4), tol=0.0)
        b = tstat.beliefs_stationary(tb)
        np.testing.assert_allclose(b, jstat.beliefs_stationary(jb), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(b.sum(-1), 1.0, atol=1e-12)
        return
    bp = ctor(g)
    assert bp.periodic and tp.is_periodic(bp)
    bp, _, _ = tp.iterate(bp, maxiter=2, trunc=tp.TruncBond(4), tol=0.0)
    b = tp.beliefs(bp)
    assert bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, rtol=1e-12)
