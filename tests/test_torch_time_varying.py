"""Time-varying tables (the reference's ``w[i][t]``) in the port, against
the JAX package and enumeration (f64, CPU).

* ``build_tables_t`` bit for bit as the JAX package's (dense SIS and banded
  Glauber), and ``at_time`` slices with them;
* tables stacked from one spec a step give the constant-table sweep on
  every method (1e-12);
* one sweep of genuinely time-varying SIS on the JAX package's sketches
  (``JaxSketches``) and Gaussian trains within 1e-10 of its sweep, on every
  method;
* the time-varying tree of ``tests/test_time_varying.py`` against
  enumeration: beliefs (``qr`` 1e-9; the sketch, on the JAX package's
  sketches as its test draws them, 1e-7), the Bethe free energy (as the
  JAX test holds it), pair and alternate marginals (1e-9), ``logprob``
  (1e-9), the sampler and SMC (0.03);
* the in-place sweep still refuses time-varying tables.
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import exact as jexact
from matrixproductbp_tpu.factors import transition_probs as jtransition
from matrixproductbp_tpu.models.glauber import \
    HomogeneousGlauberFactorSpec as JGlauberSpec
from matrixproductbp_tpu.models.sis import SISFactorSpec as JSISSpec
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import bigsweep, exact, sampling, smc
from matrixproductbp_tpu_torch.models import (HomogeneousGlauberFactorSpec,
                                              SISFactorSpec)
from test_torch_sweep_svd import JaxSketches

TREE = (4, [(0, 1), (1, 2), (1, 3)])
TABLES = ("Py", "Pyp", "Pxy", "Pyy", "Py0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sis_specs(cls, N, T):
    """``tests/test_time_varying.py``'s rates: lam and rho grow with t."""
    return [[cls(lam=0.15 + 0.1 * t, rho=0.3 + 0.05 * t)
             for t in range(T + 1)] for _ in range(N)]


def _tv(T=3, D=12):
    """The time-varying tree in both packages, with the test's phi."""
    N, edges = TREE
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    jt = mp.build_tables_t(jg, _sis_specs(JSISSpec, N, T))
    tt = tp.build_tables_t(tg, _sis_specs(SISFactorSpec, N, T))
    phi = np.random.default_rng(5).uniform(0.3, 1.0, size=(N, T + 1, 2))
    return (mp.mpbp(jg, jt, T=T, D=D, phi=phi),
            tp.mpbp(tg, tt, T=T, D=D, phi=phi, device="cpu"))


@pytest.mark.parametrize("model", ["sis", "glauber"])
def test_build_tables_t_bit_equal_to_jax(model):
    N, edges = TREE
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    if model == "sis":
        js, ts = (_sis_specs(c, N, 3) for c in (JSISSpec, SISFactorSpec))
    else:   # banded: beta grows with t
        js, ts = ([[c(0.4, 0.1, 0.5 + 0.2 * t) for t in range(4)]
                   for _ in range(N)]
                  for c in (JGlauberSpec, HomogeneousGlauberFactorSpec))
    jt, tt = mp.build_tables_t(jg, js), tp.build_tables_t(tg, ts)
    assert tt.time_varying and tt.yy_off == jt.yy_off
    assert tt.ydims == jt.ydims and (tt.yy_off is not None) == (
        model == "glauber")
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
        for t in (0, 3):
            np.testing.assert_array_equal(
                getattr(tt.at_time(t), name).numpy(),
                np.asarray(getattr(jt.at_time(t), name)), name)
    with pytest.raises(ValueError, match="same number"):
        tp.build_tables_t(tg, [s[:2] if i else s for i, s in enumerate(ts)])


def test_transition_probs_takes_a_slice():
    """``transition_probs`` refuses time-varying tables; each slice gives
    the JAX package's probabilities."""
    _, tb = _tv(T=2)
    jb, _ = _tv(T=2)
    g = tb.graph
    x = np.array([1, 0, 1, 1])
    nbr = np.minimum(g.nbr, g.N - 1)
    with pytest.raises(ValueError, match="at_time"):
        tp.transition_probs(tb.tables, g.in_mask, x[nbr], x)
    for t in range(3):
        np.testing.assert_allclose(
            tp.transition_probs(tb.tables.at_time(t), g.in_mask, x[nbr],
                                x).numpy(),
            np.asarray(jtransition(jb.tables.at_time(t), g.in_mask, x[nbr],
                                   x)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("method", ["qr", "randomized", "sketch"])
def test_stacked_constant_matches_constant_path(method):
    """Tables stacked from one spec a step (``tests/test_time_varying.py::
    test_stacked_constant_matches_constant_path``) give the constant-table
    sweep, 4 sweeps, on each method."""
    N, edges = TREE
    g = tp.graph_from_edges(N, edges)
    T = 3
    specs = [SISFactorSpec(lam=0.3, rho=0.2) for _ in range(N)]
    phi = np.ones((N, T + 1, 2))
    phi[:, 0, 1] = 0.4
    b0 = tp.mpbp(g, tp.build_tables(g, specs), T=T, D=8, phi=phi,
                 device="cpu")
    b1 = tp.mpbp(g, tp.build_tables_t(g, [[s] * (T + 1) for s in specs]),
                 T=T, D=8, phi=phi, device="cpu")
    assert b1.tables.time_varying and not b0.tables.time_varying
    for _ in range(4):
        b0 = tp.bp_sweep(b0, tp.TruncBond(8), method=method)
        b1 = tp.bp_sweep(b1, tp.TruncBond(8), method=method)
    np.testing.assert_allclose(tp.beliefs(b1).numpy(),
                               tp.beliefs(b0).numpy(), rtol=0, atol=1e-12)
    assert abs(float(tp.bethe_free_energy(b1))
               - float(tp.bethe_free_energy(b0))) < 1e-12


@pytest.mark.parametrize("method", ["qr", "randomized", "sketch"])
def test_one_sweep_matches_jax(method):
    """One sweep of the time-varying tree (T=3, D=8), the port fed the JAX
    package's sketches, against the JAX package's vmapped node update
    (which every time-varying sweep takes there)."""
    jb, tb = _tv(T=3, D=8)
    jb = mp.bp_sweep(jb, mp.TruncBond(8), method=method)
    tb = tp.bp_sweep(tb, tp.TruncBond(8), method=method,
                     sketches=JaxSketches())
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("method", ["qr", "sketch"])
def test_time_varying_matches_enumeration(method):
    """``tests/test_time_varying.py::test_time_varying_matches_enumeration``
    on the port; the sketch reads the JAX package's sketches, the draw that
    test's 1e-7 gate holds for."""
    _, tb = _tv(T=3, D=12)
    tb, _, _ = tp.iterate(tb, maxiter=12, trunc=tp.TruncBond(12), tol=1e-13,
                          method=method, sketches=JaxSketches())
    p, Z = exact.exact_prob(tb)
    err = np.abs(tp.beliefs(tb).numpy() - exact.exact_marginals(tb, p)).max()
    assert err < (1e-9 if method == "qr" else 1e-7), err
    # the JAX test's np.isclose(atol=1e-8), whose rtol 1e-5 the sketch
    # needs: on these sketches both packages miss log Z by 3.7e-8
    assert np.isclose(-float(tp.bethe_free_energy(tb)), np.log(Z), atol=1e-8)


def test_time_varying_pair_and_alternate_marginals():
    _, tb = _tv(T=2, D=12)
    tb, _, _ = tp.iterate(tb, maxiter=10, trunc=tp.TruncBond(12), tol=1e-13)
    p, _ = exact.exact_prob(tb)
    assert np.abs(tp.pair_beliefs(tb)[0].numpy()
                  - exact.exact_pair_marginals(tb, p)).max() < 1e-9
    assert np.abs(tp.alternate_marginals(tb).numpy()
                  - exact.exact_alternate_marginals(tb, p)).max() < 1e-9


def test_time_varying_oracle_matches_jax():
    """The port's enumeration reads each step's table as the JAX package's
    does."""
    jb, tb = _tv(T=2, D=4)
    p, Z = exact.exact_prob(tb)
    jp, jZ = jexact.exact_prob(jb)
    np.testing.assert_allclose(p, jp, rtol=1e-12, atol=1e-15)
    assert abs(Z / jZ - 1) < 1e-12


def test_time_varying_logprob_sampler_and_smc():
    _, tb = _tv(T=2, D=8)
    p, Z = exact.exact_prob(tb)
    X = exact._decode_all(len(p), 2, tb.N, 3)
    rng = np.random.default_rng(0)
    for idx in rng.choice(np.nonzero(p > 1e-12)[0], size=10, replace=False):
        assert abs(tp.logprob(tb, X[idx]) - np.log(p[idx]) - np.log(Z)) < 1e-9
    m_ex = exact.exact_marginals(tb, p)
    gen = torch.Generator().manual_seed(1)
    m_mc, _ = sampling.marginals_mc(sampling.sample(tb, 20000, gen))
    assert np.abs(m_mc.numpy() - m_ex).max() < 0.03
    m_smc, _ = sampling.marginals_mc(smc.smc_sample(tb, 20000, gen))
    assert np.abs(m_smc.numpy() - m_ex).max() < 0.03


def test_flat_sweep_refuses_time_varying_tables():
    _, tb = _tv(T=2, D=4)
    fs = bigsweep.flat_init(tb.graph, tb.tables, 2, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="time-varying"):
        bigsweep.bp_sweep_flat(tb.graph, tb.tables, fs, tp.TruncBond(4), 2,
                               4, method="qr")


@pytest.mark.parametrize("varying", [False, True])
def test_bucket_tables_carry_a_time_axis(varying):
    """The sweep's bucket gather gives every table a T1 axis after its slot
    axes: the steps' own where the tables vary, a stride-0 view of the one
    table where they do not (which the merge F kernels read as one
    table)."""
    from matrixproductbp_tpu_torch import bp as tbp
    N, edges = TREE
    g = tp.graph_from_edges(N, edges)
    T = 3
    tables = (tp.build_tables_t(g, _sis_specs(SISFactorSpec, N, T))
              if varying else tp.build_tables(g, [SISFactorSpec(0.2, 0.3)]
                                              * N))
    st = tp.mpbp(g, tables, T=T, D=4, device="cpu")
    sw = tbp._Sweep(st.garrays, st.tables, g.E, st.phi, st.psi)
    idx, Kb = tbp._degree_buckets(g)[-1]
    Yb = tbp._bucket_y(st.tables, Kb)
    (_, P), = tbp._pyy_groups(st.tables, idx, Kb, Yb)
    *_, (_, _, _, _, Py, Pyp, Pxy, Py0, _, _, Pyy) = tbp._group_inputs(
        sw, idx, Kb, Yb, (st.msg_cores, st.msg_logz), P)
    for t, axis in ((Py, 1), (Pyp, 2), (Pxy, 2), (Py0, 1), (Pyy, 2)):
        assert t.shape[axis] == T + 1
        assert (t.stride(axis) == 0) == (not varying)
    assert Pyy[0, 0, 0].is_contiguous()         # what merge_fscan reads
    np.testing.assert_array_equal(Pyy[:, :, 2].numpy(),
                                  (P[:, :, 2] if varying else P).numpy())


def test_time_varying_merge_f_builds():
    """A merge F build for time-varying tables adds ``MF_TV=1`` (and counts
    a second ``Pyy`` buffer); a shared table's build keeps the macros it
    had before time-varying tables, so it compiles to the same kernel."""
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    for D, variant, macros in ((10, "staged", fs.merge_f_staged_macros),
                               (20, "cluster", fs.merge_f_cluster_macros)):
        dims = (D, D, 2, 2, D, D + 4, torch.float32)
        shared, tv = macros(*dims), macros(*dims, True)
        assert macros(*dims, False) == shared
        assert not any(m.startswith("MF_TV") for m in shared)
        assert tv[-1] == "MF_TV=1" and tv[:8] == shared[:8]
        assert fs.merge_f_geometry(*dims)[0] == variant
        assert fs.merge_f_geometry(*dims, None, True)[0] == variant
        assert (fs.merge_f_geometry(*dims, None, True)[2]
                - fs.merge_f_geometry(*dims)[2]) == 4 * 2 ** 4
