"""The port's stationary (T -> infinity) mode against the JAX package
(f64, CPU).

* The uniform-train functions on random cores (D=4, P=2 and 4): log-norm
  with its sign, normalization, marginals, two-time marginals and
  ``uniform_dot``, to 1e-10.
* ``truncate_vumps`` and ``truncate_vumps_variational`` (12 -> 4; the
  refinement kept), compared
  by marginals, two-time marginals and overlap with the input (1e-8): SVD
  gauges differ between the packages, so cores are never compared.  The
  lossless bond-2-in-6 case and "the variational fit is no worse than the
  crop", as ``tests/test_stationary.py`` has them, and a Gram that is not
  positive definite, which takes the crop with no exception.
* One sweep, then six, of stationary SIS, Glauber and SIRS on the 3-node
  path: beliefs, ``f``, pair beliefs and deltas to 1e-9 of JAX's on the
  same tables.
* One sweep, then six, of stationary SIS on the infinite 3-regular and
  (3, 3) bipartite graphs at D=4, against JAX's to 1e-9.
* The bipartite (3, 3) graph's fixed point equal to the 3-regular one.
* A ``prob_yy`` that reads the degree (SIS whose d1-th neighbour passes
  its infection with a probability set by d1) on a star of degree 4, whose
  suffix folds take ``pyy_at(1)`` in both packages: both stationary
  iterates agree to 1e-12 and reach long-horizon finite-T BP (T=5,
  Aitken-extrapolated over t = 3, 4, 5) to 1e-4, while the degree
  dependence moves the beliefs by over 1e-2.

The golden anchor of ``tests/test_stationary.py:108-129`` (D=12, 28
sweeps) takes ~90 s in the port on one CPU thread, over this file's
budget: ``chip_smoke.py``'s ``stationary_modes`` phase holds it on the
card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import stationary as js
from matrixproductbp_tpu.models import glauber as jgl
from matrixproductbp_tpu.models import sirs as jsirs
from matrixproductbp_tpu.models import sis as jsis
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import stationary as ts
from matrixproductbp_tpu_torch.models import glauber as tgl
from matrixproductbp_tpu_torch.models import sirs as tsirs
from matrixproductbp_tpu_torch.models import sis as tsis

PATH = (3, [(0, 1), (1, 2)])
SWEEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(core, logz=0.0, phys=None):
    """The same uniform message in both packages."""
    phys = phys or (core.shape[2],)
    return (js.UniformMessage(jnp.asarray(core), jnp.asarray(logz), phys),
            ts.UniformMessage(torch.as_tensor(core),
                              torch.tensor(logz, dtype=torch.float64), phys))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("P", [2, 4])
def test_uniform_functions_match_jax(P):
    rng = np.random.default_rng(P)
    ja, ta = _pair(rng.uniform(size=(4, 4, P)), 0.3)
    jb, tb = _pair(rng.uniform(size=(3, 3, P)))
    (jl, jsg), (tl, tsg) = js.uniform_lognorm(ja), ts.uniform_lognorm(ta)
    _close(jl, tl, 1e-10)
    assert float(jsg) == float(tsg) == 1.0
    (jn, jln), (tn, tln) = js.uniform_normalize(ja), ts.uniform_normalize(ta)
    _close(jln, tln, 1e-10)
    _close(js.uniform_lognorm(jn)[0], ts.uniform_lognorm(tn)[0], 1e-10)
    _close(js.uniform_marginals(ja), ts.uniform_marginals(ta), 1e-10)
    _close(js.uniform_twovar_marginals(ja, 3),
           ts.uniform_twovar_marginals(ta, 3), 1e-10)
    _close(js.uniform_dot(ja, jb), ts.uniform_dot(ta, tb), 1e-10)
    _close(ts.uniform_dot(ta, ta), 1.0, 1e-12)


@pytest.fixture(scope="module")
def big_message():
    """A bond-12 message whose variational fit to bond 4 improves on the
    crop (on most random cores the crop is already the fixed point)."""
    return _pair(np.random.default_rng(0).uniform(size=(12, 12, 4)),
                 phys=(2, 2))


@pytest.mark.parametrize("variational", [False, True],
                         ids=["crop", "variational"])
def test_truncations_match_jax(big_message, variational):
    ju, tu = big_message
    if variational:
        jt = js.truncate_vumps_variational(ju, 4, refine=8)
        tt = ts.truncate_vumps_variational(tu, 4, refine=8)
    else:
        jt, tt = js.truncate_vumps(ju, 4), ts.truncate_vumps(tu, 4)
    assert tt.D == 4
    _close(js.uniform_marginals(jt), ts.uniform_marginals(tt), 1e-8)
    _close(js.uniform_twovar_marginals(jt, 3),
           ts.uniform_twovar_marginals(tt, 3), 1e-8)
    _close(js.uniform_dot(jt, ju), ts.uniform_dot(tt, tu), 1e-8)


def test_truncate_vumps_lossless_when_rank_small():
    """A bond-2 train embedded in bond 6, truncated back to 2, keeps its
    marginals and two-time marginals."""
    small = np.random.default_rng(2).uniform(size=(2, 2, 2))
    core = np.zeros((6, 6, 2))
    core[:2, :2] = small
    _, u = _pair(core)
    t = ts.truncate_vumps(u, 2)
    assert t.D == 2
    _close(ts.uniform_marginals(u), ts.uniform_marginals(t), 1e-7)
    _close(ts.uniform_twovar_marginals(u, 3),
           ts.uniform_twovar_marginals(t, 3), 1e-6)


def test_variational_no_worse_than_crop(big_message):
    _, u = big_message
    crop = ts.truncate_vumps(u, 4)
    var = ts.truncate_vumps_variational(u, 4, refine=8)
    assert (abs(1.0 - float(ts.uniform_dot(var, u)))
            < abs(1.0 - float(ts.uniform_dot(crop, u))))
    # no truncation: the message itself
    _, small = _pair(np.random.default_rng(4).uniform(size=(3, 3, 2)))
    assert torch.equal(ts.truncate_vumps_variational(small, 4).core,
                       small.core)


def test_non_pd_gram_takes_the_crop(big_message, monkeypatch):
    """With the refined cores' Gram fixed points made negative definite,
    both packages' Cholesky factors are NaN (the port's without raising),
    the refinement is non-finite, and both keep the crop (which they do
    not without the patch)."""
    ju, tu = big_message
    crop = ts.truncate_vumps(tu, 4, 100)
    assert not torch.equal(ts.truncate_vumps_variational(tu, 4, refine=2)
                           .core, crop.core)
    jgram = js._gram_fixed_point

    def jax_negative_at_d(core, side, iters=200):
        return -jnp.eye(4) if core.shape[0] == 4 else jgram(core, side,
                                                               iters)
    tgrams = ts._gram_fixed_points

    def port_negative_at_d(core, iters=200):
        if core.shape[0] == 4:
            return (-torch.eye(4, dtype=torch.float64),) * 2
        return tgrams(core, iters)
    monkeypatch.setattr(js, "_gram_fixed_point", jax_negative_at_d)
    monkeypatch.setattr(ts, "_gram_fixed_points", port_negative_at_d)
    jt = js.truncate_vumps_variational(ju, 4, refine=2)
    tt = ts.truncate_vumps_variational(tu, 4, refine=2)
    monkeypatch.undo()
    assert torch.equal(tt.core, crop.core)
    assert bool(torch.isfinite(tt.core).all())
    _close(js.uniform_marginals(jt), ts.uniform_marginals(tt), 1e-8)
    _close(js.uniform_dot(jt, ju), ts.uniform_dot(tt, tu), 1e-8)


def _states(name, graph):
    """(JAX state, port state) of one stationary model on ``graph``."""
    N, edges = graph
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    if name == "sis":
        args = dict(lam=0.4, rho=0.3, T=0, gamma=0.3, alpha=0.05)
        return (jsis.mpbp_stationary_sis(jsis.SIS(jg, **args), D=4),
                tsis.mpbp_stationary_sis(tsis.SIS(tg, **args), D=4,
                                         device="cpu"))
    if name == "glauber":
        J, h = np.full(len(edges), 0.4), np.full(N, 0.1)
        return (jgl.mpbp_stationary_glauber(
                    jgl.Glauber(jgl.Ising(jg, J=J, h=h, beta=0.7), T=0),
                    D=4),
                tgl.mpbp_stationary_glauber(
                    tgl.Glauber(tgl.Ising(tg, J=J, h=h, beta=0.7), T=0),
                    D=4, device="cpu"))
    # a flat phi: the default puts phi(R) = 0 at every step, which leaves
    # only the all-susceptible stationary state
    args = dict(lam=0.3, rho=0.2, sigma=0.15, T=0, alpha=0.05,
                phi=np.ones((N, 1, 3)))
    return (jsirs.mpbp_stationary_sirs(jsirs.SIRS(jg, **args), D=4),
            tsirs.mpbp_stationary_sirs(tsirs.SIRS(tg, **args), D=4,
                                       device="cpu"))


def _infinite_states(kind):
    """(JAX state, port state) of stationary SIS on the infinite 3-regular
    graph or the infinite (3, 3) bipartite graph, flat messages of bond 1.
    An infinite graph's node writes one edge as many times as its degree."""
    spec = dict(lam=0.1, rho=0.2, alpha=0.05)
    jt = mp.build_tables(mp.infinite_regular_graph(3),
                         [jsis.SISFactorSpec(**spec)])
    tt = tp.build_tables(tp.infinite_regular_graph(3),
                         [tsis.SISFactorSpec(**spec)])
    if kind == "regular":
        return (js.mpbp_stationary_infinite_graph(3, jt),
                ts.mpbp_stationary_infinite_graph(3, tt, device="cpu"))
    return (js.mpbp_stationary_infinite_bipartite_graph((3, 3), jt),
            ts.mpbp_stationary_infinite_bipartite_graph((3, 3), tt,
                                                        device="cpu"))


def iterate_both(states, sweeps, trunc=(6, 0)):
    """Both packages' stationary iterates from ``states`` (JAX, port),
    ``sweeps`` sweeps with tol 0, each read out after its first sweep and
    its last."""
    jb, tb = states
    out = []
    for n in (1, sweeps - 1):
        jb, _, jd, _ = js.iterate_stationary(
            jb, maxiter=n, trunc=js.TruncVUMPS(*trunc), tol=0.0)
        tb, _, td, _ = ts.iterate_stationary(
            tb, maxiter=n, trunc=ts.TruncVUMPS(*trunc), tol=0.0)
        out.append(((js.beliefs_stationary(jb), np.asarray(jb.f),
                     js.pair_beliefs_stationary(jb), jd),
                    (ts.beliefs_stationary(tb), tb.f.numpy(),
                     ts.pair_beliefs_stationary(tb), td)))
    return out


def assert_iterates_match(pairs, tol=1e-9):
    for jres, tres in pairs:
        for a, b in zip(jres, tres):
            _close(a, b, tol)


@pytest.fixture(scope="module")
def path_iterates():
    return {name: iterate_both(_states(name, PATH), SWEEPS)
            for name in ("sis", "glauber", "sirs")}


@pytest.fixture(scope="module")
def infinite_iterates():
    return {kind: iterate_both(_infinite_states(kind), SWEEPS, trunc=(4, 0))
            for kind in ("regular", "bipartite")}


@pytest.mark.parametrize("name", ["sis", "glauber", "sirs"])
def test_stationary_models_match_jax(path_iterates, name):
    """One sweep and six: beliefs, f, pair beliefs and deltas to 1e-9."""
    assert_iterates_match(path_iterates[name])
    b = path_iterates[name][-1][1][0]
    np.testing.assert_allclose(b.sum(-1), 1.0, atol=1e-12)
    assert b.min() > 1e-3            # not a trivial fixed point


@pytest.mark.parametrize("kind", ["regular", "bipartite"])
def test_infinite_graphs_match_jax(infinite_iterates, kind):
    """Stationary SIS on the infinite 3-regular and (3, 3) bipartite graphs
    at D=4, one sweep and six: beliefs, f, pair beliefs and deltas to 1e-9
    of JAX's."""
    assert_iterates_match(infinite_iterates[kind])


def test_bipartite_equals_regular():
    """Stationary SIS on the bipartite (3, 3) graph reaches the 3-regular
    graph's fixed point (its two blocks are the same)."""
    tables = tp.build_tables(tp.infinite_regular_graph(3),
                             [tsis.SISFactorSpec(0.1, 0.2, alpha=0.05)])
    trunc = ts.TruncVUMPS(4)
    reg, n, _, _ = ts.iterate_stationary(
        ts.mpbp_stationary_infinite_graph(3, tables, device="cpu"),
        maxiter=60, trunc=trunc, tol=1e-13)
    bip, m, _, _ = ts.iterate_stationary(
        ts.mpbp_stationary_infinite_bipartite_graph((3, 3), tables,
                                                    device="cpu"),
        maxiter=60, trunc=trunc, tol=1e-13)
    assert n < 60 and m < 60
    b = ts.beliefs_stationary(reg)
    _close(ts.beliefs_stationary(bip), np.repeat(b, 2, axis=0), 1e-10)
    _close(ts.bethe_free_energy_stationary(bip),
           2 * ts.bethe_free_energy_stationary(reg), 1e-10)


def test_stationary_needs_constant_tables_and_a_card(monkeypatch):
    g = tp.graph_from_edges(*PATH)
    spec = tsis.SISFactorSpec(0.2, 0.1)
    tables = tp.build_tables_t(g, [[spec] * 3 for _ in range(g.N)])
    with pytest.raises(ValueError, match="time-constant"):
        ts.mpbp_stationary(g, tables, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsis.mpbp_stationary_sis(tsis.SIS(g, 0.2, 0.1, T=0))


# ---------------------------------------------------------------------------
# a prob_yy that reads the degree (ROADMAP Queue 3 item 2)
# ---------------------------------------------------------------------------

#: the probability that the d1-th neighbour folded in passes its infection
#: (the first always does, so folding the empty y0 core changes nothing)
CROWDING = (1.0, 0.35, 0.8, 0.5)
STAR = (5, [(0, 1), (0, 2), (0, 3), (0, 4)])
CROWDED_RATES = dict(lam=0.5, rho=0.6, alpha=0.3)


def _crowded(base):
    class CrowdedSIS(base):
        """SIS whose accumulated infection takes the new neighbour's with
        probability CROWDING[d1]: ``prob_yy`` reads the degree."""

        def prob_yy(self, y, y1, y2, xi, d1, d2):
            p = 1.0 if y1 == 1 else (CROWDING[min(d1, 3)] if y2 == 1
                                     else 0.0)
            return p if y == 1 else 1.0 - p
    return CrowdedSIS


@pytest.fixture(scope="module")
def crowded_star():
    """Both packages' stationary iterates (to tol 1e-12) and the port's
    finite-T beliefs (T=5, ``qr`` at TruncThresh(0), exact on the star) of
    the degree-dependent SIS on a star of degree 4, and the port's
    stationary beliefs of plain SIS."""
    N, edges = STAR
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    jt = mp.build_tables(jg, [_crowded(jsis.SISFactorSpec)(**CROWDED_RATES)]
                         * N)
    tt = tp.build_tables(tg, [_crowded(tsis.SISFactorSpec)(**CROWDED_RATES)]
                         * N)
    assert not torch.equal(tt.Pyy[0, 1], tt.Pyy[0, 2])   # reads d1
    jb, _, _, _ = js.iterate_stationary(
        js.mpbp_stationary(jg, jt), maxiter=40, trunc=js.TruncVUMPS(4),
        tol=1e-12)
    tb, n, _, _ = ts.iterate_stationary(
        ts.mpbp_stationary(tg, tt, device="cpu"), maxiter=40,
        trunc=ts.TruncVUMPS(4), tol=1e-12)
    assert n < 40
    fb = tp.mpbp(tg, tt, T=5, D=16, device="cpu")
    fb, _, _ = tp.iterate(fb, maxiter=10, trunc=tp.TruncThresh(0.0),
                          tol=1e-13, method="qr")
    sis = tp.build_tables(tg, [tsis.SISFactorSpec(**CROWDED_RATES)] * N)
    sb, _, _, _ = ts.iterate_stationary(
        ts.mpbp_stationary(tg, sis, device="cpu"), maxiter=40,
        trunc=ts.TruncVUMPS(4), tol=1e-12)
    return {"jax": jb, "port": tb, "finite": tp.beliefs(fb).numpy(),
            "sis": ts.beliefs_stationary(sb)}


def test_degree_dependent_pyy_stationary_matches_jax(crowded_star):
    jb, tb = crowded_star["jax"], crowded_star["port"]
    _close(js.beliefs_stationary(jb), ts.beliefs_stationary(tb), 1e-12)
    _close(np.asarray(jb.f), tb.f.numpy(), 1e-12)
    _close(js.pair_beliefs_stationary(jb), ts.pair_beliefs_stationary(tb),
           1e-12)


def test_degree_dependent_pyy_stationary_matches_finite_t(crowded_star):
    """Both stationary iterates reach the finite-T beliefs' limit (Aitken's
    extrapolation over t = 3, 4, 5: the beliefs approach it by a factor
    ~-0.4 a step) to 1e-4: the suffix folds' ``pyy_at(1)`` is the table
    finite-T BP folds its suffixes with; the degree dependence moves the
    fixed point by over 1e-2, so a misused table would show."""
    b = crowded_star["finite"]
    d1, d2 = b[:, -1] - b[:, -2], b[:, -2] - b[:, -3]
    limit = b[:, -1] - d1 * d1 / (d1 - d2)
    port = ts.beliefs_stationary(crowded_star["port"])
    _close(port, limit, 1e-4)
    _close(np.asarray(js.beliefs_stationary(crowded_star["jax"])), limit,
           1e-4)
    assert np.abs(port - crowded_star["sis"]).max() > 1e-2
