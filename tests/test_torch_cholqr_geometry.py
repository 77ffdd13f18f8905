"""Which CholQR kernel ``batched_cholqr`` launches, decided on the CPU by the
pure :func:`cholqr_geometry`: the staged kernel (``cholqr_staged.cu``,
built per shape) for every float32 [4s, s] of the randomized merge from D=4
to D=20, ``cholqr_kernel`` for float64, ``ValueError`` where a forced kernel
does not fit; the staged kernel's shared memory and macros at D=10 and
D=20, summed by hand; its row strides free of bank conflicts for both
products' fragment loads; the library each shape is cached as.  On the CPU
the wrapper runs ``cholqr_unrolled`` whatever kernel is asked for and
counts no launch, and every line ``tools/probe_cholqr.py`` replaces still
exists in the kernel.

The staged kernel orders the arithmetic otherwise than ``cholqr_unrolled``
(a right-looking Cholesky with unscaled columns and 1/sqrt of the pivot,
Q = A times the explicit inverse of L).  :func:`staged_order` writes that
order in plain torch; it is held to ``cholqr_unrolled`` and to the JAX
package's Pallas kernel (interpret mode) on Gaussian and rank-1 inputs in
float64 and float32, which fixes the card's tolerance before the card
runs: float32 within 1e-5 of max-abs (~1e-11 measured); float64 within
1e-10 on Gaussian inputs, but ~2e-10 of max-abs on rank-1 ones (the
float64 jitter 1e-12 lets kappa(L) reach ~6e6), which is why float64 keeps
``cholqr_kernel``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrixproductbp_tpu.ops import kernels as jk
from matrixproductbp_tpu_torch.ops import build, kernels
from matrixproductbp_tpu_torch.ops.smallalg import cholqr_unrolled
from matrixproductbp_tpu_torch.tools import probe_cholqr

F32, F64 = torch.float32, torch.float64
_FLOOR = 1e-30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("D", range(4, 21))
def test_sketch_shapes_take_the_staged_kernel(D):
    m, n = 8 * D, 2 * D
    variant, threads, smem = kernels.cholqr_geometry(m, n, F32)
    assert (variant, threads) == ("staged", 128)
    ipb, blocks, qr, nt, per_block = kernels._cholqr_staged_plan(m, n)
    assert smem == per_block == ipb * kernels._smem_cholqr_staged(m, n)
    assert smem <= build.SMEM_PER_BLOCK
    assert ipb == (2 if n <= 32 else 1) and nt == threads
    # as many blocks an SM as shared memory and the register estimate allow
    assert blocks * (smem + 1024) <= 233472
    assert blocks * threads * max(64, 4 * n + 8) <= 65536
    # Q's passes of 16-row tiles cover a warp's tiles, <= 60 accumulators
    per_warp = -(-(-(-m // 16)) // (2 * -(-n // 32)))
    assert 1 <= qr <= per_warp and (qr == 1 or qr * -(-n // 8) <= 15)
    assert kernels.cholqr_geometry(m, n, F64)[0] == "base"


def test_shared_memory_and_macros_by_hand_at_d20():
    """[160, 40]: n8 = 40, LDA 44 (4 mod 8), LDG 40 (8 mod 16), LDX 44:
    Gs 40 x 40, Xs 40 x 44, 40 pivots and two traces in doubles, A 160 x 44
    floats; one instance a block of 128 threads, three blocks an SM (the
    registers: 168 a thread; shared memory would hold four), Q's three
    16-row tiles a warp in one pass."""
    assert kernels._staged_strides(160, 40) == (40, 160, 44, 40, 44)
    by_hand = 8 * (40 * 40 + 40 * 44 + 40 + 2) + 4 * 160 * 44
    assert by_hand == 55376 == kernels._smem_cholqr_staged(160, 40)
    assert kernels.cholqr_geometry(160, 40, F32) == ("staged", 128, 55376)
    assert kernels.cholqr_staged_macros(160, 40) == (
        "CQ_M=160", "CQ_N=40", "CQ_IPB=1", "CQ_MINB=3", "CQ_QR=3")
    assert 4 * (55376 + 1024) <= 233472 and 4 * 128 * 168 > 65536


def test_shared_memory_and_macros_by_hand_at_d10():
    """[80, 20]: n8 = 24, LDA 28, LDG 24, LDX 28: Gs 20 x 24, Xs 24 x 28,
    24 pivots and two traces in doubles, A 80 x 28 floats; two instances a
    block, five blocks an SM (the registers, 88 a thread; shared memory
    would hold six), Q's three 16-row tiles a warp in one pass."""
    assert kernels._staged_strides(80, 20) == (24, 80, 28, 24, 28)
    by_hand = 8 * (20 * 24 + 24 * 28 + 24 + 2) + 4 * 80 * 28
    assert by_hand == 18384 == kernels._smem_cholqr_staged(80, 20)
    assert kernels.cholqr_geometry(80, 20, F32) == ("staged", 128, 36768)
    assert kernels.cholqr_staged_macros(80, 20) == (
        "CQ_M=80", "CQ_N=20", "CQ_IPB=2", "CQ_MINB=5", "CQ_QR=3")
    assert 6 * (36768 + 1024) <= 233472 and 6 * 128 * 88 > 65536


def _banks(words):
    """Shared-memory wavefronts of one warp-wide 4-byte access."""
    per_bank = {}
    for w in words:
        per_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("D", range(1, 21))
def test_fragment_loads_of_a_are_free_of_bank_conflicts(D):
    """The Gram's fragment (rows 2 lc apart, column lr) and Q's (row lr,
    column lc) read 32 floats of A in 32 banks; Q's fragments of L^{-1}
    (doubles) two half-warps of 16 bank pairs each."""
    _, _, lda, _, ldx = kernels._staged_strides(8 * D, 2 * D)
    lanes = range(32)
    assert _banks([2 * (l % 4) * lda + l // 4 for l in lanes]) == 1
    assert _banks([(l // 4) * lda + l % 4 for l in lanes]) == 1
    for half in (range(16), range(16, 32)):
        pairs = [((l // 4) * ldx + l % 4) % 16 for l in half]
        assert len(set(pairs)) == 16


def test_forced_kernel_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="float32 only"):
        kernels.cholqr_geometry(80, 20, F64, "staged")
    with pytest.raises(ValueError, match="n <= 40"):
        kernels.cholqr_geometry(96, 48, F32, "staged")
    with pytest.raises(ValueError, match="n <= 40"):
        kernels.cholqr_staged_macros(96, 48)
    assert kernels.cholqr_geometry(96, 48, F32)[0] == "base"
    # m = 1000: cholqr_kernel's float64 staging needs 341 KB, the staged
    # kernel's float32 A 198 KB
    assert kernels.cholqr_geometry(1000, 40, F32)[0] == "staged"
    with pytest.raises(ValueError, match="shared memory"):
        kernels.cholqr_geometry(1000, 40, F32, "base")
    with pytest.raises(ValueError, match="shared memory"):
        kernels.cholqr_geometry(1000, 40, F64)
    with pytest.raises(ValueError, match="no CholQR kernel"):
        kernels.cholqr_geometry(80, 20, F32, "fast")


def test_staged_builds_are_cached_by_shape():
    m20 = kernels.cholqr_staged_macros(160, 40)
    m10 = kernels.cholqr_staged_macros(80, 20)
    libs = {build._paths("cholqr_staged", m)[1] for m in (m20, m10)}
    assert len(libs) == 2
    assert build._paths("cholqr_staged", m20) == \
        build._paths("cholqr_staged", m20)
    assert "cholqr_staged" in build.PER_SHAPE
    assert "cholqr_staged" not in build.SOURCES and "cholqr" in build.SOURCES
    with pytest.raises(ValueError, match="macros"):
        build._target("cholqr_staged")
    assert build._target(("cholqr_staged", m20)) == ("cholqr_staged", m20)


@pytest.mark.parametrize("variant", [None, "staged", "base"])
def test_cpu_wrapper_runs_the_plain_version(variant):
    A = torch.randn(3, 12, 5, generator=torch.Generator().manual_seed(0))
    before = (kernels.batched_cholqr.launches,
              dict(kernels.batched_cholqr.variant_launches))
    Q, R = kernels.cholqr(A, _variant=variant)
    Qp, Rp = cholqr_unrolled(A)
    assert torch.equal(Q, Qp) and torch.equal(R, Rp)
    assert (kernels.batched_cholqr.launches,
            kernels.batched_cholqr.variant_launches) == before


def test_probe_variants_apply_to_the_kernel_source():
    texts = probe_cholqr.read_sources()
    sources = probe_cholqr.variant_sources(texts, probe_cholqr.VARIANTS)
    assert set(sources) == set(probe_cholqr.VARIANTS)
    kernel = "cholqr_staged_kernel"
    for name, src in sources.items():
        assert src != texts[kernel]
    with pytest.raises(RuntimeError, match="staged_without_q"):
        probe_cholqr.variant_sources(
            {kernel: texts[kernel].replace("fa[a][3], b0, b1);",
                                           "fa[a][3], b0,b1);")},
            probe_cholqr.VARIANTS)


def staged_order(A: torch.Tensor, eps: float):
    """``cholqr_staged_kernel``'s arithmetic in plain torch (float64 for
    float32 A): Gram and jitter as ``cholqr_unrolled``; a right-looking
    Cholesky that keeps each pivot column unscaled (c) and updates a_ik -=
    c_i c_k / max(c_j, floor) with 1/sqrt(max(c_j, floor)) squared; L^{-1}
    by forward substitution with the same 1/sqrt; Q = A L^{-1}^T; R[j][i] =
    c_i / sqrt(pivot), sqrt(max(pivot, floor)) on the diagonal."""
    out = A.dtype
    A = A.double()
    n = A.shape[-1]
    idx = torch.arange(n)
    G = A.transpose(-1, -2) @ A
    tr = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).sum(-1), min=_FLOOR)
    a = G + torch.eye(n, dtype=A.dtype) * (eps * tr / n)[..., None, None]
    LT, rds = torch.zeros_like(a), []
    for j in range(n):
        c = a[..., :, j].clone()
        LT[..., j, :] = torch.where(idx >= j, c, torch.zeros_like(c))
        rd = torch.rsqrt(torch.clamp(c[..., j], min=_FLOOR))
        tt = torch.where(idx > j, c * (rd * rd)[..., None],
                         torch.zeros_like(c))
        a = a - tt[..., :, None] * c[..., None, :]
        rds.append(rd)
    X = torch.eye(n, dtype=A.dtype).expand_as(a).clone()
    for j in range(n):
        X[..., j, :] = X[..., j, :] * rds[j][..., None]
        z = X[..., j, :] * rds[j][..., None]
        X[..., j + 1:, :] -= LT[..., j, j + 1:, None] * z[..., None, :]
    rd = torch.stack(rds, -1)
    R = torch.where(idx[:, None] < idx[None, :], LT * rd[..., :, None],
                    torch.zeros_like(LT))
    R = R + torch.diag_embed(torch.sqrt(torch.clamp(
        torch.diagonal(LT, dim1=-2, dim2=-1), min=_FLOOR)))
    return (A @ X.transpose(-1, -2)).to(out), R.to(out)


def _inputs(m, n, seed):
    """Six Gaussian [m, n], instances 0 and 3 rank 1."""
    g = np.random.default_rng(seed).standard_normal
    A = g((6, m, n))
    A[::3] = np.stack([g((m, 1)) @ g((1, n)) for _ in range(2)])
    return A


def _err(x, y):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(x, y))


@pytest.mark.parametrize("m,n", [(24, 8), (80, 20)])
def test_staged_order_against_cholqr_unrolled_and_jax(m, n):
    A = _inputs(m, n, m)
    gauss, rank1 = [1, 2, 4, 5], [0, 3]
    for dt, jd, eps in ((F64, jnp.float64, 1e-12), (F32, jnp.float32, 1e-6)):
        At = torch.as_tensor(A, dtype=dt)
        mine = [t.numpy() for t in staged_order(At, eps)]
        plain = [t.numpy() for t in cholqr_unrolled(At, eps)]
        pallas = [np.asarray(t) for t in jk.batched_cholqr(
            jnp.asarray(A, jd), eps=eps)]
        assert np.isfinite(mine[0]).all()
        for rows in (gauss, rank1):
            scale = max(float(np.abs(t[rows]).max()) for t in plain)
            err = _err([t[rows] for t in mine], [t[rows] for t in plain])
            if dt == F32:
                # both factor in float64 and round once: a few float32 ulps
                assert err <= 1e-5 * scale
            elif rows is gauss:
                assert err <= 1e-10 * max(1.0, scale)
            else:
                # kappa(L) ~ 6e6: the float64 tolerance 1e-10 is missed
                assert err <= 1e-9 * scale
        # the interpreted Pallas kernel sums the Gram in another order; on
        # rank-1 inputs its float64 Q differs from cholqr_unrolled's by as
        # much as from this order's (the directions the jitter alone
        # defines), and in float32 it is not finite (ROADMAP Queue 3)
        scale = max(float(np.abs(t[gauss]).max()) for t in plain)
        err = _err([t[gauss] for t in mine], [t[gauss] for t in pallas])
        assert err <= (1e-10 if dt == F64 else 1e-5 * scale)
        if dt == F64:
            e_mine = _err([t[rank1] for t in mine],
                          [t[rank1] for t in pallas])
            e_plain = _err([t[rank1] for t in plain],
                           [t[rank1] for t in pallas])
            scale1 = max(float(np.abs(t[rank1]).max()) for t in plain)
            assert e_plain <= 1e-6 * scale1
            assert e_mine <= e_plain + 1e-9 * scale1
        Q = mine[0].astype(np.float64)
        eye = np.eye(n)
        # (float32: Q rounded once, over sums of m terms: the card's 1e-4)
        assert np.abs(np.swapaxes(Q[gauss], 1, 2) @ Q[gauss] - eye).max() \
            <= (1e-10 if dt == F64 else 1e-4)
        assert np.abs(Q @ mine[1].astype(np.float64) - A).max() <= (
            1e-12 if dt == F64 else 1e-5) * np.abs(A).max()
