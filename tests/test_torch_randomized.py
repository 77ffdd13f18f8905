"""The port's CholQR (plain version of the CUDA kernel) and randomized merge
against the JAX package (f64, CPU, same inputs).

CholQR is held to JAX's ``cholqr_unrolled`` and the ``torch.linalg``
reference at 1e-12, and to the JAX Pallas kernel (``batched_cholqr`` in
interpret mode) at 1e-10.  The randomized merge gets JAX's Gaussian train
(``PRNGKey(17)``) and is held to JAX in the represented tensor (relative
1e-8) and, where the kept directions are all above round-off, in logz
(1e-10); its cores differ by SVD signs."""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matrixproductbp_tpu.ops import kernels as jk
from matrixproductbp_tpu.ops import randomized as jr
from matrixproductbp_tpu.ops import smallalg as jsa
from matrixproductbp_tpu.ops.truncation import TruncBond as JTruncBond
from matrixproductbp_tpu.ops.truncation import TruncThresh as JTruncThresh
from matrixproductbp_tpu_torch.ops import kernels as tk
from matrixproductbp_tpu_torch.ops import randomized as tr
from matrixproductbp_tpu_torch.ops.truncation import TruncBond, TruncThresh

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores (one sweep test ran 40x
    slower beside a second worker with them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxNormal:
    """Sketch source drawing what the JAX package's randomized merge draws:
    ``jax.random.normal(PRNGKey(17), shape)``, handed over as numpy."""

    def normal(self, shape, dtype, device):
        jd = jnp.float64 if dtype == torch.float64 else jnp.float32
        return torch.as_tensor(
            np.array(jax.random.normal(jax.random.PRNGKey(17), shape, jd)),
            device=device)


@pytest.mark.parametrize("m,n", [(24, 8), (80, 20)])
def test_cholqr_matches_jax(m, n):
    A = np.random.default_rng(m).standard_normal((5, m, n))
    Q, R = tk.cholqr(torch.as_tensor(A))
    Qk, Rk = jk.batched_cholqr(jnp.asarray(A), eps=1e-12)   # Pallas, interpret
    Qu, Ru = jsa.cholqr_unrolled(jnp.asarray(A))
    Qr, Rr = tk.cholqr_reference(torch.as_tensor(A), eps=1e-12)
    for q, r in ((Qu, Ru), (Qr, Rr)):
        np.testing.assert_allclose(Q.numpy(), np.asarray(q), **TOL)
        np.testing.assert_allclose(R.numpy(), np.asarray(r), **TOL)
    # the interpreted Pallas kernel sums the Gram in another order: it
    # differs from JAX's own cholqr_unrolled by up to 1.2e-11 in R here
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qk), rtol=0, atol=1e-10)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rk), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Q.numpy().transpose(0, 2, 1) @ Q.numpy(),
                               np.broadcast_to(np.eye(n), (5, n, n)),
                               atol=1e-10)
    np.testing.assert_allclose(Q.numpy() @ R.numpy(), A, **TOL)
    assert np.all(np.tril(R.numpy(), -1) == 0.0)


def test_cholqr_f32_rank1_stays_finite():
    """float32, rank 1: the float32 Cholesky of the Gram loses definiteness
    (the JAX package's float32 cholqr_unrolled returns non-finite Q here);
    the port factors in float64 with the float32 jitter 1e-6."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal
    A = np.stack([g((80, 1)) @ g((1, 20)) for _ in range(64)]) \
        .astype(np.float32)
    Q, R = tk.cholqr(torch.as_tensor(A))
    assert Q.dtype == R.dtype == torch.float32
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    assert float(Q.abs().max()) < 1.0
    np.testing.assert_allclose(Q.double().numpy() @ R.double().numpy(), A,
                               rtol=0, atol=1e-5 * np.abs(A).max())


def _dense(cores, logz, T1, P):
    cores = np.asarray(cores)
    out = []
    for x in itertools.product(range(P), repeat=T1):
        v = cores[:, 0, 0, :, x[0]]
        for t in range(1, T1):
            v = np.einsum("bn,bnm->bm", v, cores[:, t, :, :, x[t]])
        out.append(v[:, 0])
    return np.stack(out, axis=1) * np.exp(-np.asarray(logz))[:, None]


def _cavity_trains(rng, Bn, T1, D, P):
    c = rng.random((Bn, T1, D, D, P)) - 0.3
    c[:, 0, 1:] = 0.0
    c[:, -1, :, 1:] = 0.0
    return c, rng.normal(size=(Bn,))


@pytest.mark.parametrize("trunc,jtrunc,Dout,DB,gauge_free_logz", [
    # TruncThresh(0.0) keeps the round-off directions of a rank-deficient
    # merge; their singular vectors are arbitrary and set the cores' max-abs
    # rescale, so only the represented tensor is compared there
    (TruncThresh(0.0), JTruncThresh(0.0), 6, 2, False),
    (TruncBond(3), JTruncBond(3), 3, 2, True),
    (TruncBond(4), JTruncBond(4), 4, 3, True)])          # s = 8 < DL*DB = 9
def test_merge_rounded_matches_jax(trunc, jtrunc, Dout, DB, gauge_free_logz):
    rng = np.random.default_rng(Dout)
    T1, DL, Y, q, Bn = 4, 3, 2, 2, 3
    Lc, Llz = _cavity_trains(rng, Bn, T1, DL, Y * q)
    Bc, Blz = _cavity_trains(rng, Bn, T1, DB, Y * q)
    pyy = rng.random((Y, Y, Y, q))
    jc, jz = jax.vmap(lambda a, b, c, d: jr.merge_rounded(
        a, b, c, d, jnp.asarray(pyy), jtrunc, Dout, Y, q,
        jax.random.PRNGKey(17)))(jnp.asarray(Lc), jnp.asarray(Llz),
                                 jnp.asarray(Bc), jnp.asarray(Blz))
    tc, tz = tr.merge_rounded(*map(torch.as_tensor, (Lc, Llz, Bc, Blz, pyy)),
                              trunc, Dout, Y, q, sketches=JaxNormal())
    assert tc.shape == jc.shape == (Bn, T1, Dout, Dout, Y * q)
    if gauge_free_logz:
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-10,
                                   atol=1e-10)
    dt, dj = _dense(tc, tz, T1, Y * q), _dense(jc, jz, T1, Y * q)
    scale = np.abs(dj).max()
    np.testing.assert_allclose(dt / scale, dj / scale, rtol=1e-8, atol=1e-8)


def test_cholqr_wrapper_counts_only_kernel_launches():
    before = tk.batched_cholqr.launches
    tk.cholqr(torch.ones((2, 4, 3), dtype=torch.float64))
    assert tk.batched_cholqr.launches == before
