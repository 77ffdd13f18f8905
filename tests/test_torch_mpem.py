"""The port's MPEM3 -> MPEM2 regrouping sweep against the JAX package (f64,
CPU, same inputs).  SVD signs differ between torch and XLA, so the cores are
compared through the represented tensors (relative 1e-10) and logz (1e-10),
and both against the MPEM3 evaluated directly."""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matrixproductbp_tpu.ops import mpem as jmpem
from matrixproductbp_tpu_torch.ops import mpem as tmpem

TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores (one sweep test ran 40x
    slower beside a second worker with them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mpem3(seed, Bn, T1, Db, qi, qj):
    """Random MPEM3 stacks with the open boundary and a uniform last xi'."""
    rng = np.random.default_rng(seed)
    B = rng.random((Bn, T1, Db, Db, qi, qj, qi)) - 0.2
    B[:, 0, 1:] = 0.0
    B[:, -1, :, 1:] = 0.0
    B[:, -1] = np.broadcast_to(B[:, -1, ..., :1], B[:, -1].shape)
    return B, rng.normal(size=(Bn,))


def _dense(cores, logz, T1, P):
    """Values of open trains [B, T1, D, D, P] at every configuration, in
    the order of ``itertools.product(range(P), repeat=T1)``."""
    cores = np.asarray(cores)
    out = []
    for x in itertools.product(range(P), repeat=T1):
        v = cores[:, 0, 0, :, x[0]]
        for t in range(1, T1):
            v = np.einsum("bn,bnm->bm", v, cores[:, t, :, :, x[t]])
        out.append(v[:, 0])
    return np.stack(out, axis=1) * np.exp(-np.asarray(logz))[:, None]


@pytest.mark.parametrize("qi,qj", [(2, 2), (2, 1)])
def test_mpem3_to_mpem2_matches_jax(qi, qj):
    T1, Db, Bn = 4, 3, 3
    B, logz = _mpem3(qj, Bn, T1, Db, qi, qj)
    j = jax.vmap(jmpem.mpem3_to_mpem2)(jnp.asarray(B), jnp.asarray(logz))
    t = tmpem.mpem3_to_mpem2(torch.as_tensor(B), torch.as_tensor(logz))
    assert t.cores.shape == j.cores.shape == (Bn, T1, qi * Db, qi * Db,
                                              qi * qj)
    assert t.phys == (qi, qj)
    np.testing.assert_allclose(t.logz.numpy(), np.asarray(j.logz), **TOL)
    dt = _dense(t.cores, t.logz, T1, qi * qj)
    dj = _dense(j.cores, j.logz, T1, qi * qj)
    scale = np.abs(dj).max()
    np.testing.assert_allclose(dt / scale, dj / scale, **TOL)
    # against the MPEM3 itself, for the first instance
    ref = []
    for x in itertools.product(range(qi * qj), repeat=T1):
        xi, xj = [v // qj for v in x], [v % qj for v in x]
        ref.append(float(tmpem.evaluate_mpem3(torch.as_tensor(B[0]), logz[0],
                                              xi, xj)))
        assert np.isclose(ref[-1], float(jmpem.evaluate_mpem3(
            jnp.asarray(B[0]), logz[0], jnp.asarray(xi), jnp.asarray(xj))),
            rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(dt[0] / scale, np.asarray(ref) / scale, **TOL)


def test_mpem3_to_mpem2_is_left_orthogonal():
    B, logz = _mpem3(5, 2, 5, 3, 2, 2)
    c = tmpem.mpem3_to_mpem2(torch.as_tensor(B), torch.as_tensor(logz)) \
        .cores.numpy()
    g = np.einsum("btmnp,btmkp->btnk", c[:, :-1], c[:, :-1])
    np.testing.assert_allclose(g, np.broadcast_to(np.eye(c.shape[2]), g.shape),
                               atol=1e-12)
