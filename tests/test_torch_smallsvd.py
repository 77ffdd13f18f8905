"""The port's float32 SVD route on the card (``ops/smallsvd.svd_by_gram``:
the float64 Gram, its eigendecomposition, singular values at or under
``RTOL`` of the largest set to zero) against the JAX package's float32
``jnp.linalg.svd``, on the CPU.  There ``eigh_desc`` runs its plain version,
so this holds the route's algebra; ``tests/test_torch_gpu.py`` holds the
Jacobi kernel to that plain version on the card.

Tolerances are float32-sized: singular values and reconstructions to 1e-5
of the largest (measured differences stay under 1e-6), compressed trains to
2e-5 of the represented tensor's max-abs and logz to 1e-5 (measured
~2e-6 and ~1e-6).  On rank-deficient inputs JAX keeps its float32 noise
singular values (~1e-7 of the largest) while the port zeroes them; the
represented tensors agree all the same, under every truncation policy."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrixproductbp_tpu.ops import tensortrain as jtt
from matrixproductbp_tpu.ops import truncation as jtr
from matrixproductbp_tpu_torch.ops import smallsvd
from matrixproductbp_tpu_torch.ops import tensortrain as ttt
from matrixproductbp_tpu_torch.ops import truncation as ttr
from test_torch_tensortrain import _dense, _jax_vmap

SV_TOL = 1e-5
TT_TOL = 2e-5
LOGZ_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrices(kind, m, n, B=16, seed=0):
    """float32 [B, m, n]: Gaussian, rank 5, or graded singular values 1 ..
    1e-9 with the lower half exactly zero."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        M = rng.standard_normal((B, m, n))
    elif kind == "rank5":
        M = rng.standard_normal((B, m, 5)) @ rng.standard_normal((B, 5, n))
    else:
        k = min(m, n)
        U = np.linalg.qr(rng.standard_normal((B, m, k)))[0]
        V = np.linalg.qr(rng.standard_normal((B, n, k)))[0]
        s = np.logspace(0, -9, k)
        s[k // 2:] = 0.0
        M = (U * s) @ V.transpose(0, 2, 1)
    return M.astype(np.float32)


@pytest.mark.parametrize("kind", ["gauss", "rank5", "graded"])
@pytest.mark.parametrize("m,n", [(80, 20), (20, 40), (40, 20), (20, 20)])
def test_svd_by_gram_f32_matches_jax_svd(m, n, kind):
    M = _matrices(kind, m, n)
    U, S, Vh = smallsvd.svd_by_gram(torch.as_tensor(M))
    assert U.dtype == S.dtype == Vh.dtype == torch.float32
    U, S, Vh = U.numpy(), S.numpy(), Vh.numpy()
    jU, jS, jVh = (np.asarray(x) for x in
                   jnp.linalg.svd(jnp.asarray(M), full_matrices=False))
    S0 = jS[:, :1]
    assert np.all(np.abs(S - jS) <= SV_TOL * S0)
    assert np.all((S == 0) | (S > smallsvd.RTOL * S[:, :1]))
    scale = np.abs(M).max(axis=(1, 2), keepdims=True)
    rec = (U * S[:, None, :]) @ Vh
    jrec = (jU * jS[:, None, :]) @ jVh
    assert np.all(np.abs(rec - jrec) <= SV_TOL * scale)
    assert np.all(np.abs(rec - M) <= SV_TOL * scale)
    assert np.isfinite(U).all() and np.isfinite(Vh).all()
    kept = S > 0
    both = kept[:, :, None] & kept[:, None, :]
    eye = np.eye(S.shape[-1], dtype=np.float32)
    for gram in (U.transpose(0, 2, 1) @ U, Vh @ Vh.transpose(0, 2, 1)):
        assert np.all(np.abs(gram - eye) * both <= SV_TOL)


def _f32_trains(seed, rank=None, B=4, T1=5, D=5, P=4):
    """Open trains [B, T1, D, D, P]; with ``rank``, bond rank ``rank``
    spread over all D bond indices by random orthogonal gauges."""
    rng = np.random.default_rng(seed)
    r = D if rank is None else rank
    c = np.zeros((B, T1, D, D, P))
    c[:, :, :r, :r] = rng.standard_normal((B, T1, r, r, P))
    c[:, 0, 1:] = 0.0
    c[:, -1, :, 1:] = 0.0
    if rank is not None:
        Q = np.linalg.qr(rng.standard_normal((B, T1 - 1, D, D)))[0]
        c[:, :-1] = np.einsum("btmnp,btnk->btmkp", c[:, :-1], Q)
        c[:, 1:] = np.einsum("btnm,btnkp->btmkp", Q, c[:, 1:])
    return c, rng.normal(size=(B,))


@pytest.mark.parametrize("rank", [None, 2], ids=["full", "rank2"])
@pytest.mark.parametrize("assume", [None, "left"])
@pytest.mark.parametrize("name,args,Dout", [
    ("TruncThresh", (0.0,), 5), ("TruncThresh", (1e-3,), 5),
    ("TruncBond", (3,), 3), ("TruncBondThresh", (4, 1e-2), 4)])
def test_f32_compress_through_svd_by_gram_matches_jax(monkeypatch, rank,
                                                      assume, name, args,
                                                      Dout):
    """``compress`` in float32 with every SVD of its sweeps taken by
    ``svd_by_gram`` (as on the card) against the JAX package's float32
    ``compress``: ``assume=None`` runs the left-to-right sweep, ``"left"``
    the right-to-left one."""
    monkeypatch.setattr(ttt, "batched_svd", smallsvd.svd_by_gram)
    c, z = _f32_trains(6, rank=rank)
    if assume is not None:   # both sides get the same canonical input
        o = _jax_vmap(getattr(jtt, "orthogonalize_" + assume), c, z, (2, 2))
        c, z = np.array(o.cores), np.array(o.logz)
    c, z = c.astype(np.float32), z.astype(np.float32)
    j = _jax_vmap(lambda t: jtt.compress(t, getattr(jtr, name)(*args),
                                         Dout=Dout, assume=assume),
                  c, z, (2, 2))
    t = ttt.compress(
        ttt.TensorTrain(torch.as_tensor(c), torch.as_tensor(z), (2, 2)),
        getattr(ttr, name)(*args), Dout=Dout, assume=assume)
    assert t.cores.dtype == torch.float32 and j.cores.dtype == jnp.float32
    assert t.cores.shape == j.cores.shape
    np.testing.assert_allclose(t.logz.numpy(), np.asarray(j.logz),
                               rtol=0, atol=LOGZ_TOL)
    f64 = lambda a: np.asarray(a, dtype=np.float64)     # noqa: E731
    da = _dense(f64(t.cores), f64(t.logz))
    db = _dense(f64(j.cores), f64(j.logz))
    scale = np.abs(db).max(axis=1, keepdims=True)
    assert np.all(np.abs(da - db) <= TT_TOL * scale)
