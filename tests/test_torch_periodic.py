"""Periodic (trace-closed) trains in the port, against the JAX package and
enumeration (f64, CPU).

* periodic ``rand_tt``, ``evaluate`` (trace), ``normalization``,
  ``marginals``, ``twovar_marginals``, ``tt_sum``, ``tt_dot`` and the
  cut-and-rotate ``compress`` on a batch of rings, and
  ``mpem3_to_mpem2_periodic``, against the JAX package on the same cores
  (1e-10, relative, on the represented tensors: QR and SVD gauges differ);
* one periodic SIS sweep on each method (all take the Kronecker merge and
  the SVD conversion), and one damped, against the JAX package (1e-10);
* periodic SIS on the 3-node path against enumeration at D=16 (5e-4, as
  ``tests/test_periodic.py``'s tight-capacity gate), with observations too,
  and exact (1e-10) with ``TruncThresh(1e-12)``;
* the periodic observables on the converged state against the JAX package
  on the same state (1e-10) and against enumeration, ``logprob`` with the
  wrap included;
* a periodic state through ``convert.py`` and back, and a periodic JAX
  checkpoint loaded by the port.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import checkpoint as jckpt
from matrixproductbp_tpu.models import sis_tables as jsis_tables
from matrixproductbp_tpu.ops import mpem as jmpem
from matrixproductbp_tpu.ops import tensortrain as jtt
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.models import sis_tables
from matrixproductbp_tpu_torch.ops.tensortrain import TensorTrain

PATH3 = (3, [(0, 1), (1, 2)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(cores, logz, phys_n, T1):
    """Every configuration's value of one periodic train [T1, D, D, P]."""
    configs = np.array(list(itertools.product(range(phys_n), repeat=T1)))
    tt = TensorTrain(torch.as_tensor(np.asarray(cores)).expand(
        (len(configs),) + tuple(np.shape(cores))),
        torch.as_tensor(np.asarray(logz)), (phys_n,), True)
    return configs, tp.evaluate(tt, torch.as_tensor(configs)).numpy()


def _jax_values(jt, T1, P):
    configs = np.array(list(itertools.product(range(P), repeat=T1)))
    return np.asarray(jax.vmap(lambda x: jtt.evaluate(jt, x))(
        jnp.asarray(configs)))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_periodic_tensor_trains_match_jax():
    gen = torch.Generator().manual_seed(3)
    batch = torch.stack([tp.rand_tt(gen, 4, 5, (2, 2), bond=4,
                                    periodic=True).cores for _ in range(3)])
    logz = torch.tensor([0.2, -0.4, 1.1], dtype=torch.float64)
    tt = TensorTrain(batch, logz, (2, 2), True)
    assert (batch[:, 0, 1:] != 0).any()       # no open boundary rows
    configs, vals = _values(batch[1], logz[1], 4, 4)
    M = np.eye(5)
    for t in range(4):
        M = M @ batch[1, t, :, :, configs[7, t]].numpy()
    assert abs(vals[7] - np.trace(M) * np.exp(0.4)) < 1e-12 * abs(vals[7])
    assert abs(float(tp.normalization(tt)[1]) / vals.sum() - 1) < 1e-12
    m = tp.marginals(tt)[1].numpy()
    for t in range(4):
        for p in range(4):
            assert abs(m[t, p] - vals[configs[:, t] == p].sum()
                       / vals.sum()) < 1e-12
    assert abs(float(tp.normalization(tp.normalize(tt)[0])[1]) - 1) < 1e-12
    for k in range(3):
        jt = jtt.TensorTrain(jnp.asarray(batch[k].numpy()),
                             jnp.asarray(float(logz[k])), (2, 2), True)
        np.testing.assert_allclose(tp.twovar_marginals(tt, maxdist=2)[k],
                                   jtt.twovar_marginals(jt, 2), rtol=0,
                                   atol=1e-12)
        assert abs(float(tp.tt_dot(tt, tt)[k]) / float(jtt.tt_dot(jt, jt))
                   - 1) < 1e-12
        s = tp.tt_sum(tt, tt, 0.3)
        assert abs(float(tp.lognorm(s)[0][k])
                   - float(jtt.lognorm(jtt.tt_sum(jt, jt, 0.3))[0])) < 1e-12
        for trunc, jtrunc in ((tp.TruncThresh(0.0), mp.TruncThresh(0.0)),
                              (tp.TruncBond(3), mp.TruncBond(3)))[k % 2:][:1]:
            c = tp.compress(tt, trunc, Dout=4)
            assert c.periodic and c.cores.shape == (3, 4, 4, 4, 4)
            want = _jax_values(jtt.compress(jt, jtrunc, Dout=4), 4, 4)
            assert _rel(_values(c.cores[k], c.logz[k], 4, 4)[1], want) \
                < 1e-10


def test_mpem3_to_mpem2_periodic_matches_jax():
    B = np.random.default_rng(0).normal(size=(2, 3, 3, 3, 2, 2, 2))
    tt = tp.mpem3_to_mpem2_periodic(torch.as_tensor(B),
                                    torch.tensor([0.0, 0.5],
                                                 dtype=torch.float64))
    assert tt.periodic and tt.cores.shape == (2, 3, 6, 6, 4)
    for k, lz in enumerate((0.0, 0.5)):
        jt = jmpem.mpem3_to_mpem2_periodic(jnp.asarray(B[k]),
                                           jnp.asarray(lz))
        configs, vals = _values(tt.cores[k], tt.logz[k], 4, 3)
        assert _rel(vals, _jax_values(jt, 3, 4)) < 1e-10
        ev = [float(tp.evaluate_mpem3_periodic(torch.as_tensor(B[k]), lz,
                                               c // 2, c % 2))
              for c in configs[:20]]
        assert _rel(np.array(ev), vals[:20]) < 1e-10


def _pair(D=8, phi=None, T=2):
    N, edges = PATH3
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    return (mp.mpbp(jg, jsis_tables(jg, 0.35, 0.25), T, D=D, phi=phi,
                    periodic=True),
            tp.periodic_mpbp(tg, sis_tables(tg, 0.35, 0.25), T, D=D, phi=phi,
                             device="cpu"))


@pytest.mark.parametrize("method,damp", [("qr", 0.0), ("sketch", 0.0),
                                         ("randomized", 0.0), ("qr", 0.3)])
def test_periodic_sweep_matches_jax(method, damp):
    """Two periodic sweeps on each method (every one takes the Kronecker
    merge and the periodic conversion), and damped ones."""
    jb, tb = _pair(D=8)
    for _ in range(2):
        jb = mp.bp_sweep(jb, mp.TruncBond(8), method=method, damp=damp)
        tb = tp.bp_sweep(tb, tp.TruncBond(8), method=method, damp=damp)
    assert tb.periodic and tp.is_periodic(tb)
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=0,
                               atol=1e-10)


def _obs_phi():
    phi = np.ones((3, 3, 2))
    phi[0, 1] = [0.8, 0.2]
    phi[2, 0] = [0.3, 0.7]
    return phi


@pytest.mark.parametrize("observed", [False, True])
def test_periodic_sis_vs_exact(observed):
    """``tests/test_periodic.py``'s tight-capacity gate (D=16, 5e-4) on the
    port, free and with observations."""
    _, tb = _pair(D=16, phi=_obs_phi() if observed else None)
    tb, _, _ = tp.iterate(tb, maxiter=12, trunc=tp.TruncThresh(0.0),
                          tol=1e-13)
    p, Z = exact.exact_prob(tb)
    assert np.abs(tp.beliefs(tb).numpy()
                  - exact.exact_marginals(tb, p)).max() < 5e-4
    assert abs(-float(tp.bethe_free_energy(tb)) - np.log(Z)) < 5e-4


@pytest.mark.parametrize("observed", [False, True])
def test_periodic_sis_exact_without_noise_directions(observed):
    """The same path at D=16 with ``TruncThresh(1e-12)``: dropping the
    noise-level singular directions (which ``TruncThresh(0.0)`` keeps, and
    which make its fixed point move with the SVD's rounding), periodic BP
    is exact on this tree: beliefs and the Bethe free energy within 1e-10
    of periodic enumeration, as on the card (``chip_smoke.py``'s
    ``modes_accuracy``)."""
    _, tb = _pair(D=16, phi=_obs_phi() if observed else None)
    tb, _, _ = tp.iterate(tb, maxiter=12, trunc=tp.TruncThresh(1e-12),
                          tol=1e-13)
    p, Z = exact.exact_prob(tb)
    assert np.abs(tp.beliefs(tb).numpy()
                  - exact.exact_marginals(tb, p)).max() < 1e-10
    assert abs(-float(tp.bethe_free_energy(tb)) - np.log(Z)) < 1e-10


@pytest.fixture(scope="module")
def converged(tmp_path_factory):
    """The observed periodic path at D=8, converged, in the port and (as
    arrays through the checkpoint format) in the JAX package."""
    _, tb = _pair(D=8, phi=_obs_phi())
    tb, _, _ = tp.iterate(tb, maxiter=12, trunc=tp.TruncThresh(0.0),
                          tol=1e-13)
    path = tmp_path_factory.mktemp("periodic") / "state.npz"
    np.savez(path, **tp.to_numpy_state(tb))
    jb = jckpt.load_checkpoint(str(path))[0]
    assert jb.periodic
    return tb, jb


def test_periodic_observables_match_jax(converged):
    tb, jb = converged
    for name in ("beliefs", "beliefs_tu", "alternate_marginals",
                 "pair_lognorms"):
        np.testing.assert_allclose(getattr(tp, name)(tb).numpy(),
                                   np.asarray(getattr(mp, name)(jb)),
                                   rtol=0, atol=1e-10, err_msg=name)
    (pb, lz), (jpb, jlz) = tp.pair_beliefs(tb), mp.pair_beliefs(jb)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jpb), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(lz.numpy(), np.asarray(jlz), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tp.belief_lognorms(tb).numpy(),
                               np.asarray(mp.belief_lognorms(jb)), rtol=0,
                               atol=1e-10)
    assert abs(float(tp.bethe_free_energy_pair(tb))
               - float(mp.bethe_free_energy_pair(jb))) < 1e-10
    c, lz2 = tp.pair_beliefs_as_tt(tb)
    jc, jlz2 = mp.pair_beliefs_as_tt(jb)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-12)
    assert not tp.is_free_dynamics(tb)


def test_periodic_observables_match_enumeration(converged):
    """Pair and alternate marginals against enumeration (at D=8 the periodic
    truncation leaves them ~1e-4 off, the beliefs' gate), and ``logprob``
    (which reads no message) with the wrap x^T -> x^0, to 1e-9."""
    tb, _ = converged
    p, Z = exact.exact_prob(tb)
    assert np.abs(tp.pair_beliefs(tb)[0].numpy()
                  - exact.exact_pair_marginals(tb, p)).max() < 5e-4
    assert np.abs(tp.alternate_marginals(tb).numpy()
                  - exact.exact_alternate_marginals(tb, p)).max() < 5e-4
    X = exact._decode_all(len(p), 2, 3, 3)
    rng = np.random.default_rng(1)
    for idx in rng.choice(np.nonzero(p > 1e-12)[0], size=10, replace=False):
        assert abs(tp.logprob(tb, X[idx]) - np.log(p[idx]) - np.log(Z)) < 1e-9


def test_periodic_state_round_trip_and_jax_checkpoint(converged, tmp_path):
    tb, jb = converged
    back = tp.from_numpy_state(tp.to_numpy_state(tb), device="cpu")
    assert back.periodic
    np.testing.assert_array_equal(tp.beliefs(back).numpy(),
                                  tp.beliefs(tb).numpy())
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax.npz"),
                                  mp.bp_sweep(jb, mp.TruncThresh(0.0)))
    loaded = tp.from_numpy_state(dict(np.load(jpath)), device="cpu")
    assert loaded.periodic
    swept = mp.bp_sweep(jb, mp.TruncThresh(0.0))
    np.testing.assert_allclose(tp.beliefs(loaded).numpy(),
                               np.asarray(mp.beliefs(swept)), rtol=0,
                               atol=1e-12)
