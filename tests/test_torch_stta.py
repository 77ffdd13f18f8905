"""The port's four plain scans and its three sketch entry points against the
JAX package on the same inputs and the same sketches (f64, CPU).

The scans are compared with the Pallas bodies (interpret mode) and with the
XLA scan algebra of ``test_fused_stta.py`` at the scan outputs (Ws, Ns, Ms),
to 1e-12.  The entry points are compared on the dense tensor each output train
represents, ``exp(-logz) * prod(cores)``, to 1e-8 relative to its max-abs
(measured: <= ~1e-11).  Raw cores are not a fair surface: the oblique solve
amplifies summation-order round-off by kappa^2 (``test_fused_stta.py:3-8``)
along directions the neighbouring cores annihilate, and the JAX package's
own core gate is 1e-2.  The same holds for a merge's logz on its own, which
absorbs the per-core max-abs scales of those cores: on the first merge case
below the port and the Pallas path differ by 1.2e-4 in logz, and the JAX
package's Pallas and XLA paths by 1.0e-4, while the represented tensors
agree to 2e-13.  So a merge's logz is held to the JAX package's own gate
between its two paths, 1e-3 (``test_fused_stta.py:174``); a conversion
returns logz unchanged, which is held to 1e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matrixproductbp_tpu.ops import fused_stta as jfs
from matrixproductbp_tpu.ops.tensortrain import _safe_scale as jsafe
from matrixproductbp_tpu_torch.ops import fused_stta as tfs
from matrixproductbp_tpu_torch.ops import stta as tstta
from test_fused_stta import _ref_mpem3_scans, _ref_scans

TOL = dict(rtol=1e-12, atol=1e-12)


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


def _lanes_first(x, B):
    return np.moveaxis(np.asarray(x), -1, 0)[:B]


@pytest.mark.parametrize("DL,DB,Y,q,Dout,lean", [
    pytest.param(4, 3, 2, 2, 5, False, id="4-3-2-2-5"),
    pytest.param(3, 3, 3, 2, 4, False, id="3-3-3-2-4"),
    # the lean Pallas F body, the one the TPU ran at D=20 (sl > DL, DB)
    pytest.param(4, 3, 2, 2, 5, True, id="lean-4-3-2-2-5"),
    pytest.param(3, 4, 2, 2, 6, True, id="lean-3-4-2-2-6"),
])
def test_merge_scans_match_pallas_and_xla(DL, DB, Y, q, Dout, lean,
                                          monkeypatch):
    monkeypatch.setattr(jfs, "_FORCE_LEAN", lean)
    assert jfs._f_variant(DL, DB, Y, q, min(Dout, DL * DB),
                          min(Dout + 4, DL * DB)) == ("lean" if lean
                                                      else "orig")
    rng = np.random.default_rng(0)
    B, T1 = 5, 5
    S = T1 - 1
    sr = min(Dout, DL * DB)
    sl = min(sr + 4, DL * DB)
    Lc = rng.normal(size=(B, T1, DL, DL, Y * q))
    Bc = rng.normal(size=(B, T1, DB, DB, Y * q))
    pyy = rng.random(size=(Y, Y, Y, q))
    phi, psi = JaxSketches().draw((T1, sl, sl, Y, q), (T1, sr, sr, Y, q),
                                  torch.float64, "cpu")
    jphi, jpsi = jnp.asarray(phi.numpy()), jnp.asarray(psi.numpy())

    # the XLA scan algebra, one instance at a time
    Ws_x, Ns_x, Ms_x = jax.vmap(
        lambda lc, bc: _ref_scans(lc, bc, jnp.asarray(pyy), jphi, jpsi, DL,
                                  DB, Y, q, sr, sl))(jnp.asarray(Lc),
                                                     jnp.asarray(Bc))
    # the Pallas bodies in interpret mode
    Lf = jnp.asarray(Lc.reshape(B, T1, DL, DL, Y, q))
    Bf = jnp.asarray(Bc.reshape(B, T1, DB, DB, Y, q))
    Th = jnp.einsum("tabyx,yuvx->tabuvx", jpsi, jnp.asarray(pyy))
    c0 = jnp.einsum("yuvx,znux,zjvx->znjyx", jnp.asarray(pyy), Lf[:, 0, 0],
                    Bf[:, 0, 0])
    S_init = jnp.einsum("fyx,znjyx->zfnj", jphi[0, 0], c0)
    S_init = S_init / jsafe(jnp.max(jnp.abs(S_init), axis=(1, 2, 3),
                                    keepdims=True))
    L1 = jfs._pad_lanes(jnp.moveaxis(Lf[:, 1:], 0, -1), -1)
    B1 = jfs._pad_lanes(jnp.moveaxis(Bf[:, 1:], 0, -1), -1)
    Ws_p = jfs._merge_wscan(L1, B1, jnp.transpose(Th, (0, 2, 4, 3, 5, 1))[1:],
                            DL=DL, DB=DB, Y=Y, q=q, sr=sr, interpret=True)
    Ns_p, Ms_p = jfs._merge_fscan(
        L1, B1, jnp.asarray(pyy), jnp.transpose(jphi, (0, 3, 4, 2, 1))[1:],
        Ws_p, jfs._pad_lanes(jnp.moveaxis(S_init, 0, -1), -1), DL=DL, DB=DB,
        Y=Y, q=q, sr=sr, sl=sl, interpret=True)

    # the port's plain scans (what the CPU wrappers run)
    tL = torch.as_tensor(Lc).reshape(B, T1, DL, DL, Y, q)
    tB = torch.as_tensor(Bc).reshape(B, T1, DB, DB, Y, q)
    Ws = tfs.merge_wscan(tL[:, 1:], tB[:, 1:],
                         torch.as_tensor(np.array(Th))[1:].contiguous())
    Ns, Ms = tfs.merge_fscan(tL[:, 1:], tB[:, 1:], torch.as_tensor(pyy),
                             phi[1:].contiguous(), Ws,
                             torch.as_tensor(np.array(S_init)))
    for ref_ws, ref_ns, ref_ms in (
            (Ws_x, np.asarray(Ns_x).reshape(B, S, sl, Y, q, sr), Ms_x),
            (_lanes_first(Ws_p, B), _lanes_first(Ns_p, B),
             _lanes_first(Ms_p, B))):
        np.testing.assert_allclose(Ws.numpy(), np.asarray(ref_ws), **TOL)
        np.testing.assert_allclose(Ns.numpy(), np.asarray(ref_ns), **TOL)
        np.testing.assert_allclose(Ms.numpy(), np.asarray(ref_ms), **TOL)


@pytest.mark.parametrize("Db,qi,qj,Dout", [(4, 2, 2, 5), (3, 2, 1, 4)])
def test_mpem3_scans_match_pallas_and_xla(Db, qi, qj, Dout):
    rng = np.random.default_rng(1)
    B, T1 = 5, 5
    S = T1 - 1
    sr = min(Dout, Db * qi)
    sl = min(sr + 4, Db * qi)
    B3 = rng.normal(size=(B, T1, Db, Db, qi, qj, qi))
    phi, psi = JaxSketches().draw((T1, sl, sl, qi, qj), (T1, sr, sr, qi, qj),
                                  torch.float64, "cpu")
    jphi, jpsi = jnp.asarray(phi.numpy()), jnp.asarray(psi.numpy())
    jB3 = jnp.asarray(B3)

    Ws_x, Ns_x, Ms_x = jax.vmap(
        lambda b3: _ref_mpem3_scans(b3, jphi, jpsi, Db, qi, qj, sr, sl))(jB3)
    S_init = jnp.einsum("fij,znijr->zfnr", jphi[0, 0], jB3[:, 0, 0])
    S_init = S_init / jsafe(jnp.max(jnp.abs(S_init), axis=(1, 2, 3),
                                    keepdims=True))
    B1 = jfs._pad_lanes(jnp.moveaxis(jB3[:, 1:], 0, -1), -1)
    Ws_p = jfs._mpem3_wscan(B1, jpsi[1:], Db=Db, qi=qi, qj=qj, sr=sr,
                            interpret=True)
    Ns_p, Ms_p = jfs._mpem3_fscan(
        B1, jphi[1:], Ws_p, jfs._pad_lanes(jnp.moveaxis(S_init, 0, -1), -1),
        Db=Db, qi=qi, qj=qj, sr=sr, sl=sl, interpret=True)

    tB3 = torch.as_tensor(B3)
    Ws = tfs.mpem3_wscan(tB3[:, 1:], psi[1:].contiguous())
    Ns, Ms = tfs.mpem3_fscan(tB3[:, 1:], phi[1:].contiguous(), Ws,
                             torch.as_tensor(np.array(S_init)))
    for ref_ws, ref_ns, ref_ms in (
            (Ws_x, np.asarray(Ns_x).reshape(B, S, sl, qi, qj, sr), Ms_x),
            (_lanes_first(Ws_p, B), _lanes_first(Ns_p, B),
             _lanes_first(Ms_p, B))):
        np.testing.assert_allclose(Ws.numpy(), np.asarray(ref_ws), **TOL)
        np.testing.assert_allclose(Ns.numpy(), np.asarray(ref_ns), **TOL)
        np.testing.assert_allclose(Ms.numpy(), np.asarray(ref_ms), **TOL)


def _dense(cores, logz):
    """The tensor each train of a batch represents: [B, P, ..., P]."""
    cores = np.asarray(cores)
    B, T1, D, _, P = cores.shape
    v = cores[:, 0, 0]                                  # [B, D, P]
    v = np.moveaxis(v, 1, -1)                           # [B, P, D]
    for t in range(1, T1):
        v = np.einsum("b...m,bmnp->b...pn", v, cores[:, t])
    return v[..., 0] * np.exp(-np.asarray(logz)).reshape(
        (B,) + (1,) * T1)


def _assert_same_trains(out, ref, logz_tol=1e-10):
    (c, z), (jc, jz) = out, ref
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=logz_tol,
                               atol=logz_tol)
    d, jd = _dense(c.numpy(), z.numpy()), _dense(jc, jz)
    scale = np.abs(jd).reshape(len(jd), -1).max(axis=1)
    err = np.abs(d - jd).reshape(len(jd), -1).max(axis=1)
    assert np.all(err <= 1e-8 * scale), (err / scale).max()


@pytest.mark.parametrize("DL,DB,Dout", [(4, 3, 5), (3, 3, 4)])
def test_merge_stta_fused_matches_jax(DL, DB, Dout):
    rng = np.random.default_rng(2)
    B, T1, Y, q = 5, 5, 2, 2
    Lc = rng.normal(size=(B, T1, DL, DL, Y * q))
    Bc = rng.normal(size=(B, T1, DB, DB, Y * q))
    Llz, Blz = rng.normal(size=(B,)), rng.normal(size=(B,))
    pyy = rng.random((Y, Y, Y, q))
    ref = jfs.merge_stta_fused(*(jnp.asarray(a) for a in
                                 (Lc, Llz, Bc, Blz, pyy)), Dout, Y, q,
                               jax.random.PRNGKey(17), interpret=True)
    out = tfs.merge_stta_fused(*(torch.as_tensor(a) for a in
                                 (Lc, Llz, Bc, Blz, pyy)), Dout, Y, q,
                               sketches=JaxSketches())
    _assert_same_trains(out, ref, logz_tol=1e-3)
    plain = tstta.merge_stta_batched(*(torch.as_tensor(a) for a in
                                       (Lc, Llz, Bc, Blz, pyy)), Dout, Y, q,
                                     sketches=JaxSketches())
    np.testing.assert_array_equal(plain[0].numpy(), out[0].numpy())


@pytest.mark.parametrize("Db,qj,Dout", [(4, 2, 5), (3, 1, 4)])
def test_mpem3_stta_fused_matches_jax(Db, qj, Dout):
    rng = np.random.default_rng(3)
    B, T1, qi = 5, 5, 2
    B3 = rng.normal(size=(B, T1, Db, Db, qi, qj, qi))
    lz = rng.normal(size=(B,))
    ref = jfs.mpem3_stta_fused(jnp.asarray(B3), jnp.asarray(lz), Dout,
                               jax.random.PRNGKey(17), interpret=True)
    out = tfs.mpem3_stta_fused(torch.as_tensor(B3), torch.as_tensor(lz), Dout,
                               sketches=JaxSketches())
    _assert_same_trains(out, ref)


def test_mpem3_stta_fused_tm_matches_jax():
    rng = np.random.default_rng(4)
    B, T1, Db, qi, qj, Dout = 5, 5, 4, 2, 2, 5
    B3f = rng.normal(size=(T1, B, qi * qj * qi * Db * Db))
    lz = rng.normal(size=(B,))
    ref = jfs.mpem3_stta_fused_tm(jnp.asarray(B3f), jnp.asarray(lz), Db, qi,
                                  qj, Dout, jax.random.PRNGKey(17),
                                  interpret=True)
    out = tfs.mpem3_stta_fused_tm(torch.as_tensor(B3f), torch.as_tensor(lz),
                                  Db, qi, qj, Dout, sketches=JaxSketches())
    _assert_same_trains(out, ref)
    # the tm layout is a strided view of the 7-D one: same result
    B7 = tstta.tm_to_7d(torch.as_tensor(B3f), Db, qi, qj).contiguous()
    out7 = tfs.mpem3_stta_fused(B7, torch.as_tensor(lz), Dout,
                                sketches=JaxSketches())
    np.testing.assert_allclose(out7[0].numpy(), out[0].numpy(), **TOL)


def test_default_sketches_repeat_per_shape():
    a = tstta.DEFAULT_SKETCHES.draw((2, 3), (4,), torch.float64, "cpu")
    b = tstta.DEFAULT_SKETCHES.draw((2, 3), (4,), torch.float64, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_wrappers_count_no_launch():
    before = tfs.mpem3_wscan.launches
    tfs.mpem3_wscan(torch.zeros(1, 2, 2, 2, 2, 1, 2, dtype=torch.float64),
                    torch.zeros(2, 3, 3, 2, 1, dtype=torch.float64))
    assert tfs.mpem3_wscan.launches == before
