"""Streaming two-sided sketch (STTA) compression, batched over instances.

Counterpart of ``matrixproductbp_tpu/ops/stta.py:45-62, 311-558``.  Each
compression is a right-to-left sketch scan, a left-to-right scan that emits
the cross matrices ``M_t`` and numerators ``N_t``, and one batched SPD solve
``B_t = pinv(M_t) N_t``; the first and last cores come from the boundary
rows.  The four time loops are the plain versions of the Hopper kernels in
``fused_stta.py`` (``csrc/stta_scans.cu``); they run instance-major:
``[B, S, ...]`` with ``S = T1 - 1`` steps for the times 1..T1-1.

The JAX package staggers the time scans for XLA (``ops/pipeline.py``); the
port has no such stagger.

The sum-type (banded) merge of ``yy_off`` tables feeds the same scans the
inputs the JAX package feeds its Pallas bodies (``fused_stta.py:860-878``):
``Th`` from ``y_expand(psi, off, axis=3, mode="sum")``, the band as a dense
``prob_yy`` (``sumy.band_indicator``) and the site-0 boundary through
``mode="diff"``.

Sketch randomness: JAX draws every sketch from ``PRNGKey(17)``, so a draw
depends only on its shape and dtype.  The port takes a ``sketches`` source
with ``draw(phi_shape, psi_shape, dtype, device) -> (phi, psi)`` (the sketch
path) and ``normal(shape, dtype, device)`` (the randomized merge,
``ops/randomized.py``); the default re-seeds a ``torch.Generator`` with 17 on
every draw, which keeps the same property (but not JAX's bits).
"""
from __future__ import annotations

import torch

from .smallalg import spd_solve_unrolled
from .sumy import band_indicator, y_expand
from .tensortrain import _fit_axis, _safe_scale

__all__ = ["SeededSketches", "DEFAULT_SKETCHES", "merge_stta_batched",
           "mpem3_stta_batched", "mpem3_stta_batched_tm",
           "merge_wscan_plain", "merge_fscan_plain", "mpem3_wscan_plain",
           "mpem3_fscan_plain"]


class SeededSketches:
    """Gaussian sketches from a fresh ``torch.Generator`` seeded with
    ``seed`` at every draw: equal shapes give equal sketches."""

    def __init__(self, seed: int = 17):
        self.seed = seed

    def _generator(self, device):
        g = torch.Generator(device=device)
        g.manual_seed(self.seed)
        return g

    def draw(self, phi_shape, psi_shape, dtype, device):
        g = self._generator(device)
        phi = torch.randn(phi_shape, generator=g, dtype=dtype, device=device)
        psi = torch.randn(psi_shape, generator=g, dtype=dtype, device=device)
        return phi, psi

    def normal(self, shape, dtype, device):
        return torch.randn(shape, generator=self._generator(device),
                           dtype=dtype, device=device)


DEFAULT_SKETCHES = SeededSketches(17)


#: the solve's jitter, relative to the Gram's mean diagonal (the JAX
#: package's float64 value: both dtypes solve in float64 here)
SOLVE_EPS = 1e-12


def _solve_batched(M, N, eps):
    """pinv(M) @ N by the normal equations with a trace-scaled jitter.

    M: [..., sl, sr]; N: [..., sl, k] -> [..., sr, k].

    float32 inputs are solved in float64 and the result rounded back.  In
    float32 the normal equations of a rank-deficient M (the early time
    steps: rank <= (Y*q)^t < sr) keep positive definiteness only through
    the jitter, and at sr = 20 round-off exceeds the JAX package's float32
    jitter 1e-6: Cholesky pivots go negative, hit the 1e-30 floor and the
    cores overflow (its float32 sweep, which has no float64 on a TPU,
    returns non-finite beliefs after one D=20 sweep).  In float64 the
    float64 jitter ``eps`` = 1e-12 keeps them positive.  A jitter of 1e-6
    would also shrink every direction of M whose squared singular value is
    below 1e-6 of the mean: a lone SIS node's infected share late in a T=50
    horizon (0.3 * 0.9^50 ~ 1.5e-3), whose marginal it then misses by up to
    1e-2 (``tests/test_torch_bigsweep.py::test_f32_lone_node_exact``)."""
    out_dtype = M.dtype
    if out_dtype == torch.float32:
        M = M.double()
    sr = M.shape[-1]
    G = torch.einsum("...ij,...ik->...jk", M, M)
    tr = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).sum(-1), min=1e-30)
    eye = torch.eye(sr, dtype=M.dtype, device=M.device)
    Gj = G + (eps * tr / sr)[..., None, None] * eye
    # N's float64 copy lives only for this product (N is the largest
    # operand: [..., sl, P * sr])
    rhs = torch.einsum("...ij,...ik->...jk", M, N.to(M.dtype))
    return spd_solve_unrolled(Gj, rhs).to(out_dtype)


def _rescale(x):
    """Per-instance max-abs rescale over all axes but the first."""
    dims = tuple(range(1, x.ndim))
    return x / _safe_scale(x.abs().amax(dim=dims, keepdim=True))


def _onehot000(Bn, shape, like):
    w = like.new_zeros((Bn,) + tuple(shape))
    w.view(Bn, -1)[:, 0] = 1.0
    return w


# ---------------------------------------------------------------------------
# the four scans (plain versions of the Hopper kernels)
# ---------------------------------------------------------------------------

def merge_wscan_plain(L1, B1, Th, yy_off=None):
    """Reverse sketch scan of the cavity merge.

    L1 [B, S, DL, DL, Y, q], B1 [B, S, DB, DB, Y, q] (times 1..T1-1; strided
    views are fine), Th [S, sr(a), sr(b), Y(u), Y(v), q(x)] shared ->
    Ws [B, S, DL, DB, sr] with ``Ws[:, s] = W_{s+1}``:
    ``W_t[k,m,a] = sum L_t[k,n,u,x] Th_t[a,b,u,v,x] B_t[m,j,v,x] W_{t+1}[n,j,b]``
    rescaled per instance; ``W_{T1}`` is the one-hot at (0, 0, 0).
    ``yy_off`` (the band a banded merge's Th was made for) is not read: the
    plain scan takes Th dense.
    """
    Bn, S, DL = L1.shape[:3]
    DB, sr = B1.shape[2], Th.shape[1]
    W = _onehot000(Bn, (DL, DB, sr), L1)
    Ws = L1.new_empty((Bn, S, DL, DB, sr))
    for s in range(S - 1, -1, -1):
        t1 = torch.einsum("zmnvx,zlnb->zmlvxb", B1[:, s], W)
        u = torch.einsum("abuvx,zmlvxb->zmluxa", Th[s], t1)
        W = _rescale(torch.einsum("zknux,zmnuxa->zkma", L1[:, s], u))
        Ws[:, s] = W
    return Ws


def merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S_init, yy_off=None):
    """Forward scan of the cavity merge.

    Pyy [S, Y(y), Y(u), Y(v), q], step s reading ``Pyy[s]`` (a shared
    [Y, Y, Y, q] is expanded over S); Phi [S, sl(e), sl(f), Y, q] (phi at times
    1..T1-1); Ws from :func:`merge_wscan_plain`; S_init [B, sl, DL, DB] ->
    (Ns [B, S, sl, Y, q, sr], Ms [B, S, sl, sr]).  Step s (time t = s+1)
    emits ``M = S W_t`` and ``N = t2 W_{t+1}`` (the one-hot at the last
    step), then carries ``S <- Phi_t . t2``, rescaled, where
    ``t2[e,n,j,y,x] = sum S[e,k,m] L_t[k,n,u,x] Pyy[y,u,v,x] B_t[m,j,v,x]``.
    ``yy_off`` (the band a banded merge's Pyy indicates) is not read.
    """
    Bn, S = L1.shape[:2]
    sl, sr = Phi.shape[1], Ws.shape[-1]
    Y, q = Pyy.shape[-4], Pyy.shape[-1]
    if Pyy.ndim == 4:
        Pyy = Pyy.expand((S,) + Pyy.shape)
    Ns = L1.new_empty((Bn, S, sl, Y, q, sr))
    Ms = L1.new_empty((Bn, S, sl, sr))
    Sc = S_init
    W_end = _onehot000(Bn, Ws.shape[2:], Ws)
    for s in range(S):
        Wt1 = Ws[:, s + 1] if s + 1 < S else W_end
        Ms[:, s] = torch.einsum("zekm,zkma->zea", Sc, Ws[:, s])
        t1 = torch.einsum("zekm,zknux->zenmux", Sc, L1[:, s])
        z1 = torch.einsum("yuvx,zenmux->zenmyvx", Pyy[s], t1)
        t2 = torch.einsum("zenmyvx,zmjvx->zenjyx", z1, B1[:, s])
        Ns[:, s] = torch.einsum("zenjyx,znjb->zeyxb", t2, Wt1)
        Sc = _rescale(torch.einsum("efyx,zenjyx->zfnj", Phi[s], t2))
    return Ns, Ms


def mpem3_wscan_plain(B1, Psi):
    """Reverse sketch scan of MPEM3 -> MPEM2.

    B1 [B, S, Db(m), Db(n), qi(i), qj(j), qi(r)] (strided views are fine),
    Psi [S, sr(b), sr(c), qi, qj] -> Ws [B, S, Db, qi, sr] with
    ``W_t[m,i,b] = sum B_t[m,n,i,j,r] W_{t+1}[n,r,c] Psi_t[b,c,i,j]``,
    rescaled per instance."""
    Bn, S, Db = B1.shape[:3]
    qi, sr = B1.shape[4], Psi.shape[1]
    W = _onehot000(Bn, (Db, qi, sr), B1)
    Ws = B1.new_empty((Bn, S, Db, qi, sr))
    for s in range(S - 1, -1, -1):
        t1 = torch.einsum("zmnijr,znrc->zmijc", B1[:, s], W)
        W = _rescale(torch.einsum("zmijc,bcij->zmib", t1, Psi[s]))
        Ws[:, s] = W
    return Ws


def mpem3_fscan_plain(B1, Phi, Ws, S_init):
    """Forward scan of MPEM3 -> MPEM2.

    Phi [S, sl(e), sl(f), qi, qj]; S_init [B, sl, Db, qi] ->
    (Ns [B, S, sl, qi, qj, sr], Ms [B, S, sl, sr]).  ``t1 = S . B_t``;
    emits ``M = S W_t``, ``N = t1 W_{t+1}``; carries ``S <- Phi_t . t1``."""
    Bn, S = B1.shape[:2]
    qi, qj = B1.shape[4], B1.shape[5]
    sl, sr = Phi.shape[1], Ws.shape[-1]
    Ns = B1.new_empty((Bn, S, sl, qi, qj, sr))
    Ms = B1.new_empty((Bn, S, sl, sr))
    Sc = S_init
    W_end = _onehot000(Bn, Ws.shape[2:], Ws)
    for s in range(S):
        Wt1 = Ws[:, s + 1] if s + 1 < S else W_end
        Ms[:, s] = torch.einsum("zemi,zmib->zeb", Sc, Ws[:, s])
        t1 = torch.einsum("zemi,zmnijr->zenijr", Sc, B1[:, s])
        Ns[:, s] = torch.einsum("zenijr,znrb->zeijb", t1, Wt1)
        Sc = _rescale(torch.einsum("zenijr,efij->zfnr", t1, Phi[s]))
    return Ns, Ms


# ---------------------------------------------------------------------------
# whole compressions: sketches, boundary, scans, solve, assembly
# ---------------------------------------------------------------------------

def _assemble(first_v, Ms, Ns, Bn, S, sr, P, Dout, dtype, device):
    """Cores [B, T1, Dout, Dout, P] from the first-core row, the cross
    matrices and the numerators (``fused_stta.py:903-911``)."""
    first = torch.zeros((Bn, sr, sr, P), dtype=dtype, device=device)
    first[:, 0] = first_v
    Bsol = _solve_batched(Ms, Ns.reshape(Bn, S, Ns.shape[2], P * sr),
                          SOLVE_EPS)
    Bsol = Bsol.reshape(Bn, S, sr, P, sr).transpose(3, 4)
    last = torch.zeros((Bn, sr, sr, P), dtype=dtype, device=device)
    last[:, :, 0, :] = Bsol[:, -1][:, :, 0, :]
    cores = torch.cat([first[:, None], Bsol[:, :-1], last[:, None]], dim=1)
    return _fit_axis(_fit_axis(cores, 2, Dout), 3, Dout)


def merge_sketch(Lc, Llz, Bc, Blz, pyy, Dout, Y, q, sketches, oversample,
                 wscan, fscan, yy_off=None):
    """Cavity merge ``L (x) B`` contracted with ``prob_yy`` -> bond Dout,
    through the given scan functions.

    Lc [B, T1, DL, DL, Y*q], Bc [B, T1, DB, DB, Y*q], pyy [T1, Y, Y, Y, q]
    (``Th`` and the site-0 boundary read each step's, and the forward scan
    gets the table of every step it runs, ``stta.py:84, 118, 157, 168``; a
    shared [Y, Y, Y, q] is expanded over T1 with stride 0, which the scan
    kernels read as one table) -> (cores [B, T1, Dout, Dout, Y*q], logz
    [B]); cores are rescaled to max-abs 1 each, the scales
    folded into logz (``fused_stta.py:912-914``).  ``yy_off`` selects the
    banded merge, where ``pyy`` is not read.
    """
    Bn, T1, DL = Lc.shape[0], Lc.shape[1], Lc.shape[2]
    DB = Bc.shape[2]
    P = Y * q
    dtype, device = Lc.dtype, Lc.device
    sr = min(Dout, DL * DB)
    sl = min(sr + oversample, DL * DB)
    S = T1 - 1
    sk = DEFAULT_SKETCHES if sketches is None else sketches
    phi, psi = sk.draw((T1, sl, sl, Y, q), (T1, sr, sr, Y, q), dtype, device)
    Lf = Lc.reshape(Bn, T1, DL, DL, Y, q)
    Bf = Bc.reshape(Bn, T1, DB, DB, Y, q)
    if yy_off is None:
        pyy = pyy.to(dtype)
        if pyy.ndim == 4:
            pyy = pyy.expand((T1,) + pyy.shape)
        Th = torch.einsum("tabyx,tyuvx->tabuvx", psi, pyy).contiguous()
        c0 = torch.einsum("yuvx,znux,zjvx->znjyx", pyy[0], Lf[:, 0, 0],
                          Bf[:, 0, 0])
        pyy = pyy[1:]
    else:
        pyy = band_indicator(Y, yy_off, q, dtype, device)
        Th = y_expand(psi, yy_off, axis=3, mode="sum").contiguous()
        LT = y_expand(Lf[:, 0, 0], yy_off, axis=2, mode="diff")
        c0 = torch.einsum("znyvx,zjvx->znjyx", LT, Bf[:, 0, 0])
    S_init = _rescale(torch.einsum("fyx,znjyx->zfnj", phi[0, 0], c0))

    Ws = wscan(Lf[:, 1:], Bf[:, 1:], Th[1:], yy_off=yy_off)
    Ns, Ms = fscan(Lf[:, 1:], Bf[:, 1:], pyy, phi[1:].contiguous(), Ws,
                   S_init.contiguous(), yy_off=yy_off)

    v0 = torch.einsum("znjyx,znjb->zbyx", c0, Ws[:, 0]).reshape(Bn, sr, P)
    cores = _assemble(v0, Ms, Ns, Bn, S, sr, P, Dout, dtype, device)
    m = _safe_scale(cores.abs().amax(dim=(2, 3, 4)))
    cores = cores / m[:, :, None, None, None]
    return cores, Llz + Blz - torch.log(m).sum(dim=1)


def mpem3_sketch(B7, logz, Dout, sketches, oversample, wscan, fscan):
    """MPEM3 -> bond-Dout MPEM2 through the given scan functions.

    B7 [B, T1, Db(m), Db(n), qi(i), qj(j), qi(r)], any strides ->
    (cores [B, T1, Dout, Dout, qi*qj], logz unchanged)."""
    Bn, T1, Db, _, qi, qj, _ = B7.shape
    P = qi * qj
    dtype, device = B7.dtype, B7.device
    sr = min(Dout, Db * qi)
    sl = min(sr + oversample, max(Db * qi, 1))
    S = T1 - 1
    sk = DEFAULT_SKETCHES if sketches is None else sketches
    phi, psi = sk.draw((T1, sl, sl, qi, qj), (T1, sr, sr, qi, qj), dtype,
                       device)

    B00 = B7[:, 0, 0]                                    # [z, n, i, j, r]
    S_init = _rescale(torch.einsum("fij,znijr->zfnr", phi[0, 0], B00))
    Ws = wscan(B7[:, 1:], psi[1:].contiguous())
    Ns, Ms = fscan(B7[:, 1:], phi[1:].contiguous(), Ws, S_init.contiguous())

    c0 = torch.einsum("znijr,znrb->zijb", B00, Ws[:, 0])
    cores = _assemble(c0.reshape(Bn, P, sr).transpose(1, 2), Ms, Ns, Bn, S,
                      sr, P, Dout, dtype, device)
    return cores, logz


def tm_to_7d(B3f, Db, qi, qj):
    """View the time-major flat ``[T1, B, (i, j, r, m, n)]`` layout as the
    7-D ``[B, T1, m, n, i, j, r]`` one (no copy)."""
    T1, Bn = B3f.shape[0], B3f.shape[1]
    return B3f.reshape(T1, Bn, qi, qj, qi, Db, Db).permute(1, 0, 5, 6, 2, 3, 4)


def merge_stta_batched(Lc, Llz, Bc, Blz, pyy, Dout: int, Y: int, q: int,
                       sketches=None, oversample: int = 4, yy_off=None):
    """Batched cavity merge through the plain scans, on any device."""
    return merge_sketch(Lc, Llz, Bc, Blz, pyy, Dout, Y, q, sketches,
                        oversample, merge_wscan_plain, merge_fscan_plain,
                        yy_off)


def mpem3_stta_batched(B3, logz, Dout: int, sketches=None,
                       oversample: int = 4):
    """Batched MPEM3 -> MPEM2 through the plain scans: B3 [B, T1, Db, Db,
    qi, qj, qi'] -> (cores [B, T1, Dout, Dout, qi*qj], logz)."""
    return mpem3_sketch(B3, logz, Dout, sketches, oversample,
                        mpem3_wscan_plain, mpem3_fscan_plain)


def mpem3_stta_batched_tm(B3f, logz, Db: int, qi: int, qj: int, Dout: int,
                          sketches=None, oversample: int = 4):
    """Time-major flat entry: B3f [T1, B, qi*qj*qi'*Db*Db], column order
    ``(i, j, r, m, n)``."""
    return mpem3_sketch(tm_to_7d(B3f, Db, qi, qj), logz, Dout, sketches,
                        oversample, mpem3_wscan_plain, mpem3_fscan_plain)
