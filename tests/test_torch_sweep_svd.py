"""The port's SVD-method sweeps (``method="qr"``, ``"randomized"``), damping
and ``iterate(polish=n)`` against the JAX package (f64, CPU, same sketches)
and against enumeration, at the JAX package's gates
(``tests/test_methods_consistency.py``, ``tests/test_sis_small_tree.py``).

One sweep: beliefs and the free-energy ledger ``f`` to 1e-8 (raw cores are
not compared: QR and SVD fix signs differently in torch and XLA).  Iterated
on a tree: beliefs to enumeration at 1e-8, ``-bethe_free_energy`` to log Z
at 1e-7.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import matrixproductbp_tpu as mp
from matrixproductbp_tpu.models import SIS as JSIS, mpbp_sis as jmpbp_sis
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.models import SIS, mpbp_sis

TREE = (4, [(0, 1), (0, 2), (2, 3)])
STAR = (5, [(0, 1), (0, 2), (0, 3), (0, 4)])     # hub of degree 4: K > 3
TREE_SIS = dict(lam=0.35, rho=0.25, gamma=0.4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores (one sweep test ran 40x
    slower beside a second worker with them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSketches:
    """Sketch source drawing exactly what the JAX package draws from
    ``PRNGKey(17)`` (split for the sketch path, unsplit for the randomized
    merge), handed over as numpy."""

    @staticmethod
    def _jd(dtype):
        return jnp.float64 if dtype == torch.float64 else jnp.float32

    def draw(self, phi_shape, psi_shape, dtype, device):
        kphi, kpsi = jax.random.split(jax.random.PRNGKey(17))
        return (torch.as_tensor(np.array(jax.random.normal(
                    kphi, phi_shape, self._jd(dtype))), device=device),
                torch.as_tensor(np.array(jax.random.normal(
                    kpsi, psi_shape, self._jd(dtype))), device=device))

    def normal(self, shape, dtype, device):
        return torch.as_tensor(np.array(jax.random.normal(
            jax.random.PRNGKey(17), shape, self._jd(dtype))), device=device)


def _pair(graph, T, D, lam, rho, gamma, dtype=torch.float64):
    N, edges = graph
    jb = jmpbp_sis(JSIS(mp.graph_from_edges(N, edges), lam, rho, T=T,
                        gamma=gamma), D=D)
    tb = mpbp_sis(SIS(tp.graph_from_edges(N, edges), lam, rho, T=T,
                      gamma=gamma), D=D, dtype=dtype, device="cpu")
    return jb, tb


def _assert_enumeration(tb, belief_tol=1e-8, logz_tol=1e-7):
    p, Z = exact.exact_prob(tb)
    b = tp.beliefs(tb).numpy()
    assert np.abs(b - exact.exact_marginals(tb, p)).max() < belief_tol
    assert abs(-float(tp.bethe_free_energy(tb)) - np.log(Z)) < logz_tol


@pytest.mark.parametrize("method", ["qr", "randomized"])
def test_one_sweep_matches_jax(method):
    jb, tb = _pair(TREE, 2, 16, **TREE_SIS)
    jb = mp.bp_sweep(jb, mp.TruncThresh(0.0), method=method)
    tb = tp.bp_sweep(tb, tp.TruncThresh(0.0), method=method,
                     sketches=JaxSketches())
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=1e-8,
                               atol=1e-8)


@pytest.mark.parametrize("method", ["qr", "randomized"])
def test_iterate_reaches_enumeration(method):
    _, tb = _pair(TREE, 2, 16, **TREE_SIS)
    tb, n, _ = tp.iterate(tb, maxiter=15, trunc=tp.TruncThresh(0.0),
                          tol=1e-12, method=method)
    assert n < 15
    _assert_enumeration(tb)


def test_star_k4_folds_reach_enumeration():
    """The hub's K = 4 bucket runs the prefix/suffix folds and the leaves'
    K = 1 bucket the bare init element, under method="qr"."""
    jb, tb = _pair(STAR, 2, 8, 0.2, 0.1, 0.3)
    j1 = mp.bp_sweep(jb, mp.TruncThresh(0.0), method="qr")
    t1 = tp.bp_sweep(tb, tp.TruncThresh(0.0), method="qr")
    np.testing.assert_allclose(tp.beliefs(t1).numpy(),
                               np.asarray(mp.beliefs(j1)), rtol=1e-8,
                               atol=1e-8)
    tb, _, _ = tp.iterate(tb, maxiter=10, trunc=tp.TruncThresh(0.0),
                          tol=1e-12, method="qr")
    _assert_enumeration(tb)


def test_damping_reaches_the_same_fixed_point():
    _, tb = _pair(TREE, 2, 16, **TREE_SIS)
    tb, _, deltas = tp.iterate(tb, maxiter=25, trunc=tp.TruncThresh(0.0),
                               tol=1e-13, damp=0.3, method="qr")
    p, _ = exact.exact_prob(tb)
    assert np.abs(tp.beliefs(tb).numpy()
                  - exact.exact_marginals(tb, p)).max() < 1e-8


def test_sketch_polish_matches_jax(monkeypatch):
    from matrixproductbp_tpu import bp as jbp
    monkeypatch.setattr(jbp, "_BATCH_MIN_NODES", 1)
    jb, tb = _pair(TREE, 3, 8, 0.2, 0.1, 0.3)
    jb, _, _ = mp.iterate(jb, maxiter=3, trunc=mp.TruncBond(8), tol=0.0,
                          method="sketch", polish=2)
    tb, n, _ = tp.iterate(tb, maxiter=3, trunc=tp.TruncBond(8), tol=0.0,
                          method="sketch", polish=2, sketches=JaxSketches())
    assert n == 3
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=1e-8,
                               atol=1e-8)


def test_options_still_not_ported_raise():
    _, tb = _pair(TREE, 2, 4, **TREE_SIS)
    # chunked sweeps (ROADMAP Queue 1 item 3, ported) run on the qr path
    tc, _, _ = tp.iterate(tb, maxiter=1, chunk=2, method="qr")
    b = tp.beliefs(tc)
    assert bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, atol=1e-12)
    with pytest.raises(ValueError, match="unknown method"):
        tp.bp_sweep(tb, tp.TruncBond(4), method="svd")
    with pytest.raises(ValueError, match="damp"):
        tp.bp_sweep(tb, tp.TruncBond(4), damp=1.0)
