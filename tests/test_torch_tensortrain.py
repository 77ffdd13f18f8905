"""The port's tensor-train L0 and unrolled SPD solve against the JAX package,
on the same random inputs (f64, CPU): rtol/atol 1e-12, since both sides run
the same recurrences and differ only in summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matrixproductbp_tpu.ops import tensortrain as jtt
from matrixproductbp_tpu.ops import smallalg as jsa
from matrixproductbp_tpu_torch.ops import tensortrain as ttt
from matrixproductbp_tpu_torch.ops import smallalg as tsa

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


def _trains(seed, B=4, T1=5, D=4, P=4, signed=False):
    rng = np.random.default_rng(seed)
    cores = rng.random((B, T1, D, D, P))
    if signed:
        cores = cores - 0.3
    cores[:, 0, 1:] = 0.0
    cores[:, -1, :, 1:] = 0.0
    logz = rng.normal(size=(B,))
    return cores, logz


def _jax_vmap(fn, cores, logz, phys):
    return jax.vmap(lambda c, z: fn(jtt.TensorTrain(c, z, phys)))(
        jnp.asarray(cores), jnp.asarray(logz))


@pytest.mark.parametrize("seed,signed", [(0, False), (1, True), (2, False)])
def test_lognorm_and_normalize_match_jax(seed, signed):
    cores, logz = _trains(seed, signed=signed)
    jlg, jsg = _jax_vmap(jtt.lognorm, cores, logz, (2, 2))
    tt = ttt.TensorTrain(torch.as_tensor(cores), torch.as_tensor(logz), (2, 2))
    lg, sg = ttt.lognorm(tt)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(jsg))
    jn, jl = _jax_vmap(jtt.normalize, cores, logz, (2, 2))
    n, l2 = ttt.normalize(tt)
    np.testing.assert_allclose(n.cores.numpy(), np.asarray(jn.cores), **TOL)
    np.testing.assert_allclose(n.logz.numpy(), np.asarray(jn.logz), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_normalize_eachmatrix_and_marginals_match_jax(seed):
    cores, logz = _trains(seed, D=5, P=2)
    tt = ttt.TensorTrain(torch.as_tensor(cores), torch.as_tensor(logz), (2,))
    je = _jax_vmap(jtt.normalize_eachmatrix, cores, logz, (2,))
    e = ttt.normalize_eachmatrix(tt)
    np.testing.assert_allclose(e.cores.numpy(), np.asarray(je.cores), **TOL)
    np.testing.assert_allclose(e.logz.numpy(), np.asarray(je.logz), **TOL)
    jm = _jax_vmap(jtt.marginals, cores, logz, (2,))
    np.testing.assert_allclose(ttt.marginals(tt).numpy(), np.asarray(jm),
                               **TOL)


def test_flat_tt_matches_jax():
    j = jtt.flat_tt(4, 3, (2, 2), jnp.float64)
    t = ttt.flat_tt(4, 3, (2, 2), torch.float64, device="cpu")
    np.testing.assert_array_equal(t.cores.numpy(), np.asarray(j.cores))
    jn, jl = jtt.normalize(j)
    tn, tl = ttt.normalize(t)
    np.testing.assert_allclose(tn.cores.numpy(), np.asarray(jn.cores), **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_safe_scale_and_fit_axis():
    m = torch.tensor([0.0, float("nan"), float("inf"), 2.5])
    np.testing.assert_array_equal(ttt._safe_scale(m).numpy(),
                                  [1.0, 1.0, 1.0, 2.5])
    a = torch.arange(6.0).reshape(2, 3)
    j = np.asarray(jtt._fit_axis(jnp.asarray(a.numpy()), 1, 5))
    np.testing.assert_array_equal(ttt._fit_axis(a, 1, 5).numpy(), j)
    np.testing.assert_array_equal(ttt._fit_axis(a, 1, 2).numpy(),
                                  a[:, :2].numpy())


@pytest.mark.parametrize("n,k", [(5, 3), (12, 8)])
def test_spd_solve_unrolled_matches_jax(n, k):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(6, n + 3, n))
    G = np.einsum("bij,bik->bjk", A, A) + 1e-3 * np.eye(n)
    R = rng.normal(size=(6, n, k))
    ref = np.asarray(jsa.spd_solve_unrolled(jnp.asarray(G), jnp.asarray(R)))
    out = tsa.spd_solve_unrolled(torch.as_tensor(G), torch.as_tensor(R))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    L = tsa.chol_unrolled(torch.as_tensor(G))
    np.testing.assert_allclose(
        L.numpy(), np.asarray(jsa.chol_unrolled(jnp.asarray(G))), **TOL)


# ---------------------------------------------------------------------------
# truncation policies, canonical forms, compression and algebra (the SVD
# sweeps): against the JAX package on the same trains.  QR and SVD fix
# signs differently in torch and XLA, so cores are compared through what is
# gauge-free: the represented tensors (relative 1e-10) and logz (1e-10).
# ---------------------------------------------------------------------------

from matrixproductbp_tpu.ops import truncation as jtr
from matrixproductbp_tpu_torch.ops import truncation as ttr

GAUGE_TOL = dict(rtol=1e-10, atol=1e-10)


def _dense(cores, logz):
    """All values of open trains [B, T1, D, D, P] -> [B, P**T1]."""
    cores, logz = np.asarray(cores), np.asarray(logz)
    v = cores[:, 0, 0]                                   # [B, D, P]
    v = np.moveaxis(v, 1, 2)                             # [B, X, D]
    for t in range(1, cores.shape[1]):
        v = np.einsum("bxn,bnmp->bxpm", v, cores[:, t])
        v = v.reshape(v.shape[0], -1, v.shape[-1])
    return v[:, :, 0] * np.exp(-logz)[:, None]


def _assert_same_tensor(a_cores, a_logz, b_cores, b_logz):
    da, db = _dense(a_cores, a_logz), _dense(b_cores, b_logz)
    scale = np.abs(db).max(axis=1, keepdims=True)
    np.testing.assert_allclose(da / scale, db / scale, **GAUGE_TOL)


POLICIES = [("TruncThresh", (0.0,)), ("TruncThresh", (1e-3,)),
            ("TruncBond", (3,)), ("TruncBondMax", (3,)),
            ("TruncBondThresh", (3, 0.0)), ("TruncBondThresh", (3, 1e-2))]


@pytest.mark.parametrize("name,args", POLICIES)
def test_keep_mask_matches_jax_bit_for_bit(name, args):
    rng = np.random.default_rng(7)
    s = -np.sort(-rng.random((9, 6)) ** 4, axis=1)
    s[1, 2:] = 0.0                                       # exact zeros
    s[2, :4] = s[2, 0]                                   # a tie at the cut
    s[3] = 0.0
    s[4, 1:] = 1e-4 * s[4, 0]                            # near a threshold
    got = getattr(ttr, name)(*args).keep_mask(torch.as_tensor(s))
    ref = getattr(jtr, name)(*args).keep_mask(jnp.asarray(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert getattr(ttr, name)(*args).max_bond == \
        getattr(jtr, name)(*args).max_bond


@pytest.mark.parametrize("side", ["left", "right"])
def test_orthogonalize_preserves_value_and_is_canonical(side):
    cores, logz = _trains(5, D=4, P=4, signed=True)
    tt = ttt.TensorTrain(torch.as_tensor(cores), torch.as_tensor(logz), (2, 2))
    o = getattr(ttt, "orthogonalize_" + side)(tt)
    _assert_same_tensor(o.cores.numpy(), o.logz.numpy(), cores, logz)
    c = o.cores.numpy()
    eye = np.eye(c.shape[2])
    if side == "left":      # every core but the last: sum_{m,p} c c = I
        g = np.einsum("btmnp,btmkp->btnk", c[:, :-1], c[:, :-1])
    else:                   # every core but the first: sum_{n,p} c c = I
        g = np.einsum("btmnp,btknp->btmk", c[:, 1:], c[:, 1:])
    np.testing.assert_allclose(g, np.broadcast_to(eye, g.shape), atol=1e-12)


@pytest.mark.parametrize("assume", [None, "left", "right"])
@pytest.mark.parametrize("trunc_args", [("TruncThresh", (0.0,), 5),
                                        ("TruncBond", (3,), 3)])
def test_compress_matches_jax(assume, trunc_args):
    name, args, Dout = trunc_args
    cores, logz = _trains(6, T1=5, D=5, P=4, signed=True)
    if assume is not None:  # hand both sides the same canonical input
        o = _jax_vmap(getattr(jtt, "orthogonalize_" + assume), cores, logz,
                      (2, 2))
        cores, logz = np.array(o.cores), np.array(o.logz)
    j = _jax_vmap(lambda t: jtt.compress(t, getattr(jtr, name)(*args),
                                         Dout=Dout, assume=assume),
                  cores, logz, (2, 2))
    t = ttt.compress(
        ttt.TensorTrain(torch.as_tensor(cores), torch.as_tensor(logz), (2, 2)),
        getattr(ttr, name)(*args), Dout=Dout, assume=assume)
    assert t.cores.shape == j.cores.shape
    np.testing.assert_allclose(t.logz.numpy(), np.asarray(j.logz),
                               **GAUGE_TOL)
    _assert_same_tensor(t.cores.numpy(), t.logz.numpy(), j.cores, j.logz)


def test_tt_sum_tt_dot_evaluate_match_jax():
    ca, za = _trains(8, D=3, P=4, signed=True)
    cb, zb = _trains(9, D=2, P=4)
    ta = ttt.TensorTrain(torch.as_tensor(ca), torch.as_tensor(za), (2, 2))
    tb = ttt.TensorTrain(torch.as_tensor(cb), torch.as_tensor(zb), (2, 2))
    pair = lambda f: jax.vmap(                              # noqa: E731
        lambda a, x, b, y: f(jtt.TensorTrain(a, x, (2, 2)),
                             jtt.TensorTrain(b, y, (2, 2))))(
        jnp.asarray(ca), jnp.asarray(za), jnp.asarray(cb), jnp.asarray(zb))
    js = pair(lambda a, b: jtt.tt_sum(a, b, 0.7))
    s = ttt.tt_sum(ta, tb, 0.7)
    np.testing.assert_allclose(s.cores.numpy(), np.asarray(js.cores), **TOL)
    np.testing.assert_allclose(s.logz.numpy(), np.asarray(js.logz), **TOL)
    np.testing.assert_allclose(
        _dense(s.cores, s.logz),
        _dense(ca, za) + 0.7 * _dense(cb, zb), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ttt.tt_dot(ta, tb).numpy(),
                               np.asarray(pair(jtt.tt_dot)), **TOL)
    x = np.random.default_rng(10).integers(0, 4, size=(ca.shape[0], 5))
    jv = jax.vmap(lambda c, z, xx: jtt.evaluate(jtt.TensorTrain(c, z, (2, 2)),
                                                xx))(
        jnp.asarray(ca), jnp.asarray(za), jnp.asarray(x))
    np.testing.assert_allclose(ttt.evaluate(ta, torch.as_tensor(x)).numpy(),
                               np.asarray(jv), **TOL)
