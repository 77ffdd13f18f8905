"""The port's heterogeneous SIS and the generic factor adapters against the
JAX package and the enumeration oracle (f64, CPU).

Heterogeneous SIS has per-slot rates (``Pxy``, ``Pyp`` differ by slot) and
per-node dense ``prob_yy``.  One sweep on a tree by each method, with the
JAX package's sketches: beliefs and ``f`` to 1e-9; iterated, it reaches
enumeration (``tests/test_sirs_and_heterogeneous.py``: 1e-8), and with
uniform rates it equals plain SIS (1e-9).  The adapters of
``tests/test_factor_adapters.py`` and the mixed-q tree of
``tests/test_heterogeneous_q.py`` reach enumeration at their gates (1e-8,
1e-9).
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu.models import sis_heterogeneous as jhet
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import bp as tbp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.models import SIS, SISFactorSpec, mpbp_sis
from matrixproductbp_tpu_torch.models import sis_heterogeneous as thet
from test_torch_models import METHODS, _assert_enumeration, \
    _assert_one_sweep_matches

TREE = (4, [(0, 1), (0, 2), (2, 3)])


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


def _het(D):
    g = tp.graph_from_edges(*TREE)
    return thet.mpbp_sis_heterogeneous(
        thet.SISHeterogeneous(g, **_het_args(g)), D=D, device="cpu")


def _iterated(bp, method="randomized"):
    bp, n, _ = tp.iterate(bp, maxiter=15, trunc=tp.TruncThresh(0.0),
                          tol=1e-13, method=method)
    assert n < 15
    return bp


@pytest.mark.parametrize("method,D,trunc,jtrunc", METHODS,
                         ids=[m[0] for m in METHODS])
def test_sis_heterogeneous_sweep_matches_jax(method, D, trunc, jtrunc):
    g = mp.graph_from_edges(*TREE)
    jb = jhet.mpbp_sis_heterogeneous(jhet.SISHeterogeneous(g, **_het_args(g)),
                                     D=D)
    tb = _het(D)
    assert tb.tables.Pyy.shape[0] == 4
    _assert_one_sweep_matches(jb, tb, method, jtrunc, trunc)


def test_sis_heterogeneous_reaches_enumeration():
    _assert_enumeration(_iterated(_het(8)))


def test_uniform_heterogeneous_equals_homogeneous():
    g = tp.graph_from_edges(*TREE)
    bp1 = _iterated(mpbp_sis(SIS(g, 0.3, 0.2, T=2, gamma=0.4), D=8,
                             device="cpu"))
    bp2 = _iterated(thet.mpbp_sis_heterogeneous(thet.SISHeterogeneous(
        g, np.full(g.E, 0.3), np.full(g.N, 0.2), T=2, gamma=0.4), D=8,
        device="cpu"))
    np.testing.assert_allclose(tp.beliefs(bp1).numpy(),
                               tp.beliefs(bp2).numpy(), atol=1e-9)
    assert abs(float(tp.bethe_free_energy(bp1))
               - float(tp.bethe_free_energy(bp2))) < 1e-9


@pytest.mark.parametrize("method", ["randomized", "qr"])
def test_trace_adapter_matches_native_tables(method):
    """SIS wrapped as exhaustive-trace specs (per-node Pyy) gives the
    beliefs and free energy of the native SIS tables."""
    g = tp.graph_from_edges(*TREE)
    sis = SIS(g, 0.3, 0.2, T=2, gamma=0.4)
    bp1 = _iterated(mpbp_sis(sis, D=8, device="cpu"), method)
    specs = [tp.TraceFactorSpec(SISFactorSpec(0.3, 0.2).w, 2, int(d))
             for d in g.degree]
    bp2 = _iterated(tp.mpbp(g, tp.build_tables(g, specs), 2, D=8,
                            phi=sis.default_phi(), device="cpu"), method)
    np.testing.assert_allclose(tp.beliefs(bp1).numpy(),
                               tp.beliefs(bp2).numpy(), atol=1e-9)
    assert abs(float(tp.bethe_free_energy(bp1))
               - float(tp.bethe_free_energy(bp2))) < 1e-9


def test_sis_by_spec_and_trace_nodes_in_one_bucket():
    """Leaves of two kinds (SIS by spec, SIS as a trace spec, both with
    Y = 2) in the degree-1 bucket: two Pyy groups there, one in the
    degree-2 bucket, and the sweep still reaches enumeration."""
    g = tp.graph_from_edges(6, [(0, 1), (1, 2), (3, 4), (4, 5)])
    sis = SISFactorSpec(0.3, 0.2)
    specs = [tp.TraceFactorSpec(sis.w, 2, 1) if i in (3, 5) else sis
             for i in range(6)]
    phi = SIS(g, 0.3, 0.2, T=2, gamma=0.4).default_phi()
    bp = tp.mpbp(g, tp.build_tables(g, specs), 2, D=8, phi=phi,
                 device="cpu")
    assert bp.tables.Y == 2
    bp = _iterated(bp)
    assert [sorted(map(list, (i for i, _ in groups))) for groups in
            tbp._PYY_GROUPS[bp.tables.Pyy].values()] \
        == [[[0, 2], [3, 5]], [[1, 4]]]
    _assert_enumeration(bp)


def test_sis_by_spec_beside_wider_trace_specs_reaches_enumeration():
    """SIS by spec on the path 0-1-2 and SIS as trace specs on 3-4-5 give
    Y = 4 (node 4's nstates(2)); the SIS specs' OR would merge their states
    0 and 1 onto the padded y = 2, 3.  The port's tables leave those
    entries at zero and reach enumeration; the JAX package's fill them
    (ROADMAP Queue 3) and miss it."""
    from matrixproductbp_tpu import factors as jfactors
    from matrixproductbp_tpu.models.sis import SISFactorSpec as JSISFactorSpec
    edges = [(0, 1), (1, 2), (3, 4), (4, 5)]
    g = tp.graph_from_edges(6, edges)
    phi = SIS(g, 0.3, 0.2, T=2, gamma=0.4).default_phi()

    def specs(sis_spec, trace_spec):
        sis = sis_spec(0.3, 0.2)
        return [trace_spec(sis.w, 2, int(g.degree[i])) if i >= 3 else sis
                for i in range(6)]

    tb = tp.mpbp(g, tp.build_tables(g, specs(SISFactorSpec,
                                             tp.TraceFactorSpec)),
                 2, D=8, phi=phi, device="cpu")
    assert tb.tables.Y == 4
    tb = _iterated(tb, "qr")
    p, Z = exact.exact_prob(tb)          # 2^18 trajectories: once
    want = exact.exact_marginals(tb, p)
    assert np.abs(tp.beliefs(tb).numpy() - want).max() < 1e-8
    assert abs(-float(tp.bethe_free_energy(tb)) - np.log(Z)) < 1e-8
    jg = mp.graph_from_edges(6, edges)
    jb = mp.mpbp(jg, jfactors.build_tables(
        jg, specs(JSISFactorSpec, jfactors.TraceFactorSpec)), 2, D=8,
        phi=phi)
    jb, _, _ = mp.iterate(jb, maxiter=15, trunc=mp.TruncThresh(0.0),
                          tol=1e-13, method="qr")
    assert np.abs(np.asarray(mp.beliefs(jb)) - want).max() > 1e-2


def test_damped_factor_reaches_enumeration():
    g = tp.graph_from_edges(*TREE)
    spec = tp.DampedFactorSpec(SISFactorSpec(0.35, 0.25, alpha=0.02), p=0.3)
    phi = np.ones((g.N, 3, 2))
    phi[:, 0] = [0.6, 0.4]
    bp = tp.mpbp(g, tp.build_tables(g, [spec] * g.N), 2, D=8, phi=phi,
                 device="cpu")
    _assert_enumeration(_iterated(bp))


def test_mixed_q_tree_reaches_enumeration():
    """Path 0 - 1 - 2 with q = (2, 3, 2), padded to q = 3 (the JAX
    package's ``tests/test_heterogeneous_q.py`` model)."""
    g = tp.graph_from_edges(3, [(0, 1), (1, 2)])
    qs, T = (2, 3, 2), 2

    def fn_for(qi):
        def fn(xp, x_nbrs, x):
            if xp >= qi:
                return 0.0
            return 0.3 / qi + 0.7 * (xp == (int(x) + int(sum(x_nbrs))) % qi)
        return fn

    specs = [tp.TraceFactorSpec(fn_for(qs[i]), 3, int(g.degree[i]))
             for i in range(3)]
    phi = np.ones((3, T + 1, 3))
    phi[:, 0, :] = np.random.default_rng(11).uniform(0.2, 1.0, (3, 3))
    bp = tp.mpbp(g, tp.build_tables(g, specs), T, D=16, phi=phi, qs=qs,
                 device="cpu")
    bp = _iterated(bp)
    p, Z = exact.exact_prob(bp)
    b = tp.beliefs(bp).numpy()
    assert np.abs(b - exact.exact_marginals(bp, p)).max() < 1e-9
    for i, qi in enumerate(qs):
        assert np.all(np.abs(b[i, :, qi:]) < 1e-12)
    assert abs(-float(tp.bethe_free_energy(bp)) - np.log(Z)) < 1e-9
