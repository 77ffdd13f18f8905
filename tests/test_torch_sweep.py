"""The port's sketch sweep against the JAX package's batched sketch sweep
(f64, CPU, same sketches) and against enumeration.

JAX takes ``_bucket_update_batched`` with ``_BATCH_MIN_NODES = 1``.  After
one sweep, beliefs and the free-energy ledger ``f`` are held to 1e-8 (raw
``msg_cores`` are not: the solve amplifies round-off by kappa^2; measured
belief and ``f`` differences after one sweep are ~1e-15).  After 12 sweeps
beliefs are held to JAX and to enumeration at 1e-6, the JAX package's gate
(``test_fused_stta.py:300``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import bp as jbp
from matrixproductbp_tpu.models import SIS as JSIS, mpbp_sis as jmpbp_sis
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.models import SIS, mpbp_sis

TREE = (4, [(0, 1), (0, 2), (2, 3)])
STAR = (5, [(0, 1), (0, 2), (0, 3), (0, 4)])     # hub of degree 4: K > 3


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
    ``PRNGKey(17)``, handed over as numpy."""

    def draw(self, phi_shape, psi_shape, dtype, device):
        kphi, kpsi = jax.random.split(jax.random.PRNGKey(17))
        jd = jnp.float64 if dtype == torch.float64 else jnp.float32
        phi = np.array(jax.random.normal(kphi, phi_shape, jd))
        psi = np.array(jax.random.normal(kpsi, psi_shape, jd))
        return (torch.as_tensor(phi, device=device),
                torch.as_tensor(psi, device=device))


def _pair(graph, T, D, lam=0.2, rho=0.1, gamma=0.3):
    N, edges = graph
    jb = jmpbp_sis(JSIS(mp.graph_from_edges(N, edges), lam, rho, T=T,
                        gamma=gamma), D=D)
    tb = mpbp_sis(SIS(tp.graph_from_edges(N, edges), lam, rho, T=T,
                      gamma=gamma), D=D, device="cpu")
    return jb, tb


@pytest.fixture
def jax_batched(monkeypatch):
    monkeypatch.setattr(jbp, "_BATCH_MIN_NODES", 1)


@pytest.mark.parametrize("graph,T,D,jax_batched", [
    (TREE, 3, 12, True),
    # the hub's K > 3 bucket is held to the JAX package's vmapped
    # _node_update: its batched K > 3 branch pairs each suffix with the
    # wrong prefix (ROADMAP Queue 3)
    (STAR, 2, 6, False)])
def test_one_sweep_matches_jax(graph, T, D, jax_batched, monkeypatch):
    if jax_batched:
        monkeypatch.setattr(jbp, "_BATCH_MIN_NODES", 1)
    jb, tb = _pair(graph, T, D)
    jb = mp.bp_sweep(jb, mp.TruncBond(D), method="sketch")
    tb = tp.bp_sweep(tb, tp.TruncBond(D), method="sketch",
                     sketches=JaxSketches())
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(tb.msg_logz.numpy(), np.asarray(jb.msg_logz),
                               rtol=1e-8, atol=1e-8)


def test_iterate_matches_jax_and_enumeration(jax_batched):
    jb, tb = _pair(TREE, 3, 12)
    jb, _, _ = mp.iterate(jb, maxiter=12, trunc=mp.TruncBond(12), tol=0.0,
                          method="sketch")
    tb, n, deltas = tp.iterate(tb, maxiter=12, trunc=tp.TruncBond(12),
                               tol=0.0, method="sketch",
                               sketches=JaxSketches())
    assert n == 12 and len(deltas) == 12
    b = tp.beliefs(tb).numpy()
    np.testing.assert_allclose(b, np.asarray(mp.beliefs(jb)), rtol=1e-6,
                               atol=1e-6)
    assert np.abs(b - exact.exact_marginals(tb)).max() < 1e-6
    np.testing.assert_allclose(float(tp.bethe_free_energy(tb)),
                               float(mp.bethe_free_energy(jb)), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(tp.means(tb).numpy(),
                               np.asarray(mp.means(jb)), rtol=1e-6,
                               atol=1e-6)


def test_star_converges_to_enumeration():
    """Default sketches (torch generator): the K > 3 prefix/suffix branch
    and the K = 1 bucket reach the oracle on a tree.  (The JAX package's
    batched K > 3 branch misses it by 5.1e-3 here; ROADMAP Queue 3.)"""
    _, tb = _pair(STAR, 2, 6)
    tb, _, _ = tp.iterate(tb, maxiter=8, trunc=tp.TruncBond(6), tol=0.0,
                          method="sketch")
    assert np.abs(tp.beliefs(tb).numpy()
                  - exact.exact_marginals(tb)).max() < 1e-6


def test_exact_prob_matches_jax():
    from matrixproductbp_tpu import exact as jexact
    jb, tb = _pair(TREE, 2, 3)
    p, Z = exact.exact_prob(tb)
    jp, jZ = jexact.exact_prob(jb)
    np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(Z, float(jZ), rtol=1e-12)


def test_f32_d20_sweep_stays_finite():
    """float32, D=20 (sketch size 20): the solve's normal equations run in
    float64.  Solved in float32 (as the JAX package does), this shape's
    beliefs turn non-finite by the second sweep."""
    g = tp.random_regular_graph(16, 3, np.random.default_rng(0))
    tb = mpbp_sis(SIS(g, 0.2, 0.1, T=15, gamma=0.3), D=20,
                  dtype=torch.float32, device="cpu")
    for _ in range(2):
        tb = tp.bp_sweep(tb, tp.TruncBond(20), method="sketch")
    b = tp.beliefs(tb)
    assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, rtol=1e-5)
