"""Each CUDA kernel against its plain version on the card: the scan kernels
(f64 at small shapes, 1e-10, the three merge F kernels at its edge shapes;
f32 at the bench shape, all three with one ``Pyy`` a step too (and bit for
bit with a stacked table as with the shared one), and, for the staged
merge F kernel, at the sketch
merges of D = 4 to 15 (one to three blocks an SM), for the cluster one at
D = 16, 17 (odd sl), 20 and one DL != DB, 1e-4 of the plain output's
max-abs; D=20 takes the cluster merge F kernel; both merge W kernels at
the f64 edge shapes and at the f32 sketch merges of D = 4, 10, 16, 20 and
20 x 16), the CholQR kernels (f64 1e-10; f32 at the D=10 and D=20
sketch shapes, 1e-5 of max-abs: both factor in f64 and round once; the
staged one at every [4s, s] from D=4 to D=20, n=1, odd m and n and a
ragged batch, every third instance rank 1, with Q finite, Q^T Q - I <=
1e-4 and Q R - A <= 1e-5 of max |A| on the Gaussian ones) and the
Jacobi eigen kernel (f64, 1e-10 relative in eigenvalues and in the
reconstruction, V orthonormal to 1e-10; Gaussian, degenerate, zero and
diagonal inputs at k = 1..64 and ragged batches), and the staged MPEM3
W and F kernels (f32, 1e-4 of max-abs, against the plain scans at both
launches of a sketch sweep at every D from 4 to 20, S = 1, a ragged batch,
zero and non-finite instances; strided and f64 inputs taking the first
designs); every merge F kernel and both MPEM3 kernels non-finite exactly
where the plain scans are (N's last step is the full product with the
one-hot); the banded Glauber merges at Y = 3, 5 and 10 and the q = 3
SIRS merges and conversions (f32, 1e-4 of max-abs); and the chunked sweep
against the monolithic one, the flat Jacobi sweep bit for bit against the
chunked one; ``transition_probs`` on the card against the CPU on a batch
of particles; ``belief_lognorms(method="sketch")`` on the merge kernels
against the plain scans (f32, 1e-3); the wide (cluster) merge kernels
at the Glauber D=18 buckets (banded, dense and one Pyy a step), f64 from
D=16 to D=20 and f32 D=24, q=3 (1e-10 f64, 1e-4 f32), and merge F wide
forced at the f64 edge shapes and in the non-finite cases.  Marked
``gpu``; skips
from its fixture when no CUDA device is present.  Needs no JAX: on the
card run it with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py``.
"""
import pytest
import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.ops import kernels, smallsvd
from matrixproductbp_tpu_torch.ops.smallalg import cholqr_unrolled

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(g, *shape):
    return torch.randn(shape, generator=g, dtype=torch.float64)


def _merge_case(Bn, S, DL, DB, Y, q, sr, sl, dtype, dev, variant=None,
                pyy="shared"):
    """(kernel outputs, plain outputs): Ws, Ns, Ms; ``variant`` forces the
    merge F kernel.  ``pyy``: "shared" (one [Y, Y, Y, q] table,
    ``pyy_step`` 0), "steps" (one random table a step, [S, Y, Y, Y, q],
    ``pyy_step`` Y^3 q), "stacked" (the shared table repeated a step) or
    "expanded" (the shared table viewed over S with stride 0, ``pyy_step``
    0)."""
    g = torch.Generator().manual_seed(0)
    L = _randn(g, Bn, S + 1, DL, DL, Y, q).to(dev, dtype)
    B = _randn(g, Bn, S + 1, DB, DB, Y, q).to(dev, dtype)
    Th = _randn(g, S, sr, sr, Y, Y, q).to(dev, dtype)
    Pyy = torch.rand((Y, Y, Y, q), generator=g, dtype=torch.float64) \
        .to(dev, dtype)
    if pyy == "steps":
        Pyy = torch.rand((S, Y, Y, Y, q), generator=g,
                         dtype=torch.float64).to(dev, dtype)
    elif pyy == "stacked":
        Pyy = Pyy.expand((S,) + Pyy.shape).contiguous()
    elif pyy == "expanded":
        Pyy = Pyy.expand((S,) + Pyy.shape)
    Phi = _randn(g, S, sl, sl, Y, q).to(dev, dtype)
    S0 = _randn(g, Bn, sl, DL, DB).to(dev, dtype)
    L1, B1 = L[:, 1:], B[:, 1:]
    Ws = fs.merge_wscan(L1, B1, Th)
    out = [Ws, *fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0, _variant=variant)]
    Wp = fs.merge_wscan_plain(L1, B1, Th)
    ref = [Wp, *fs.merge_fscan_plain(L1, B1, Pyy, Phi, Wp, S0)]
    return out, ref


def _mpem3_case(Bn, S, Db, qi, qj, sr, sl, dtype, dev):
    g = torch.Generator().manual_seed(1)
    B3f = _randn(g, S + 1, Bn, qi * qj * qi * Db * Db).to(dev, dtype)
    B1 = B3f.reshape(S + 1, Bn, qi, qj, qi, Db, Db) \
        .permute(1, 0, 5, 6, 2, 3, 4)[:, 1:]
    Psi = _randn(g, S, sr, sr, qi, qj).to(dev, dtype)
    Phi = _randn(g, S, sl, sl, qi, qj).to(dev, dtype)
    S0 = _randn(g, Bn, sl, Db, qi).to(dev, dtype)
    out, ref = [], []
    for w, f, dst in ((fs.mpem3_wscan, fs.mpem3_fscan, out),
                      (fs.mpem3_wscan_plain, fs.mpem3_fscan_plain, ref)):
        Ws = w(B1, Psi)
        dst.extend([Ws, *f(B1, Phi, Ws, S0)])
    return out, ref


def _assert_close(out, ref, tol_rel):
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        scale = max(1.0, float(r.abs().max())) if tol_rel is None else \
            float(r.abs().max())
        tol = 1e-10 * scale if tol_rel is None else tol_rel * scale
        assert float((o - r).abs().max()) <= tol


# the two small shapes; S=1 (only the last step: the one-hot W_{T1}, nothing
# to prefetch); S=2; odd sl/sr (ragged tiles and K splits); DL != DB both
# ways; Y=3; q=1; the D=10 sketch merge -- each through both merge F kernels
MERGE_F64 = [
    (dict(DL=4, DB=3, Y=2, q=2, sr=5, sl=9), 4),
    (dict(DL=3, DB=3, Y=3, q=2, sr=4, sl=8), 4),
    (dict(DL=4, DB=3, Y=2, q=2, sr=5, sl=9), 1),
    (dict(DL=4, DB=3, Y=2, q=2, sr=5, sl=9), 2),
    (dict(DL=3, DB=5, Y=2, q=2, sr=7, sl=11), 3),
    (dict(DL=5, DB=2, Y=2, q=2, sr=6, sl=10), 3),
    (dict(DL=3, DB=3, Y=3, q=2, sr=5, sl=9), 3),
    (dict(DL=4, DB=4, Y=2, q=1, sr=5, sl=9), 3),
    (dict(DL=10, DB=10, Y=2, q=2, sr=10, sl=14), 3)]
# the f32 sketch merges at bond D that the staged kernel takes: 3 blocks an
# SM (D <= 10), 2 (D=11) and 1 (D >= 12); the largest that fits is D=15
MERGE_F32_D = [4, 8, 11, 12, 15]


def _sketch_dims(D, DB=None):
    return dict(DL=D, DB=D if DB is None else DB, Y=2, q=2, sr=D, sl=D + 4)


# the f32 sketch merges that the cluster kernel takes: D=16, 17 (odd sl:
# 11 rows e on one block of the pair, 10 on the other), 20, and DL != DB
MERGE_F32_CLUSTER = [_sketch_dims(16), _sketch_dims(17), _sketch_dims(20),
                     _sketch_dims(20, 16)]


@pytest.fixture(scope="module", autouse=True)
def staged_builds():
    """Build the staged and the cluster merge F kernels at every shape below
    at once (each shape is its own build)."""
    if torch.cuda.is_available():
        shapes = [(*d.values(), torch.float64) for d, _ in MERGE_F64] + [
            (*_sketch_dims(4).values(), torch.float64)]
        fs.build_merge_f(shapes, "cluster")
        shapes += [(*_sketch_dims(D).values(), torch.float32)
                   for D in MERGE_F32_D + [10]]
        shapes += [(*d.values(), torch.float32) for d in MERGE_F32_CLUSTER]
        fs.build_merge_f(shapes)
        fs.build_merge_wide(_wide_builds())


def _wide_builds():
    """The wide kernels' builds of the tests below, one nvcc each, started
    together: merge F forced at the f64 edge shapes and the D=10 sketch
    merge, and both kernels the geometry picks at MERGE_WIDE's shapes."""
    out = [("f", *d.values(), torch.float64) for d, _ in MERGE_F64]
    out.append(("f", *_sketch_dims(10).values(), torch.float32))
    for d, dtype, pyy, _ in MERGE_WIDE:
        off = (0,) if pyy == "band" else ()
        out.append(("f", *d.values(), dtype, *off))
        if fs.merge_w_geometry(*list(d.values())[:5], dtype,
                               band=bool(off))[0] == "wide":
            out.append(("w", *list(d.values())[:5], 0, dtype, *off))
    return list(dict.fromkeys(out))


@pytest.mark.parametrize("variant", ["staged", "base", "cluster", "wide",
                                     "streamed"])
@pytest.mark.parametrize("dims,S", MERGE_F64)
def test_merge_kernels_f64(cuda, dims, S, variant):
    before = fs.merge_fscan.variant_launches[variant]
    _assert_close(*_merge_case(7, S, **dims, dtype=torch.float64, dev=cuda,
                               variant=variant), None)
    assert fs.merge_fscan.variant_launches[variant] == before + 1


@pytest.mark.parametrize("variant", ["staged", "base", "cluster"])
def test_merge_f_kernels_f32_bench_shape(cuda, variant):
    _assert_close(*_merge_case(64, 15, 10, 10, 2, 2, 10, 14, torch.float32,
                               cuda, variant), 1e-4)


@pytest.mark.parametrize("D", MERGE_F32_D)
def test_merge_f_staged_f32_sketch_shapes(cuda, D):
    before = dict(fs.merge_fscan.variant_launches)
    _assert_close(*_merge_case(32, 6, **_sketch_dims(D), dtype=torch.float32,
                               dev=cuda), 1e-4)
    assert fs.merge_fscan.variant_launches == {
        **before, "staged": before["staged"] + 1}


@pytest.mark.parametrize("dims", MERGE_F32_CLUSTER,
                         ids=lambda d: f"{d['DL']}x{d['DB']}")
def test_merge_f_cluster_f32_sketch_shapes(cuda, dims):
    assert fs.merge_f_geometry(*dims.values(), torch.float32)[0] == "cluster"
    before = dict(fs.merge_fscan.variant_launches)
    _assert_close(*_merge_case(32, 6, **dims, dtype=torch.float32, dev=cuda),
                  1e-4)
    assert fs.merge_fscan.variant_launches == {
        **before, "cluster": before["cluster"] + 1}


def test_merge_f_cluster_refuses_another_shape(cuda):
    """As the staged library: built for one shape, it refuses any other."""
    from matrixproductbp_tpu_torch.ops import build
    lib = build.library("merge_f_cluster", fs.merge_f_cluster_macros(
        *_sketch_dims(20).values(), torch.float32))
    strides = fs._strides(torch.empty(1, 1, 8, 8, 2, 2))
    rc = lib.merge_f_cluster(0, strides, 0, strides, 0, 0, 0, 0, 0, 0, 0, 1,
                             1, 8, 8, 2, 2, 8, 12, 1024, 0)
    assert rc == 1
    assert lib.merge_f_cluster_occupancy(fs.merge_f_geometry(
        *_sketch_dims(20).values(), torch.float32)[2]) >= 1


def test_merge_f_staged_refuses_another_shape(cuda):
    """A staged library is built for one shape; its launcher refuses any
    other (cudaErrorInvalidValue) and launches nothing."""
    from matrixproductbp_tpu_torch.ops import build
    dims = _sketch_dims(10)
    lib = build.library("merge_f_staged", fs.merge_f_staged_macros(
        *dims.values(), torch.float32))
    strides = fs._strides(torch.empty(1, 1, 8, 8, 2, 2))
    rc = lib.merge_f_staged(0, strides, 0, strides, 0, 0, 0, 0, 0, 0, 0, 1,
                            1, 8, 8, 2, 2, 8, 12, 1024, 0)
    assert rc == 1


def test_merge_f_d20_takes_the_cluster_kernel(cuda):
    before = dict(fs.merge_fscan.variant_launches)
    _assert_close(*_merge_case(16, 15, 20, 20, 2, 2, 20, 24, torch.float32,
                               cuda), 1e-4)
    assert fs.merge_fscan.variant_launches == {
        **before, "cluster": before["cluster"] + 1}


# time-varying tables: each merge F kernel reads one Pyy a step
# (pyy_step = Y^3 q), held to the plain scan at the f64 edge shapes
# (1e-10: S=1, S=2, odd sl, Y=3, q=1, D=10) and at the f32 sketch merges it
# is picked for (1e-4 of max-abs: staged D=10, cluster D=20)
MERGE_F_TV64 = [MERGE_F64[k] for k in (0, 2, 3, 4, 6, 7, 8)]


@pytest.mark.parametrize("variant", ["staged", "base", "cluster"])
@pytest.mark.parametrize("dims,S", MERGE_F_TV64)
def test_merge_f_per_step_pyy_f64(cuda, dims, S, variant):
    before = fs.merge_fscan.tv_launches[variant]
    _assert_close(*_merge_case(7, S, **dims, dtype=torch.float64, dev=cuda,
                               variant=variant, pyy="steps"), None)
    assert fs.merge_fscan.tv_launches[variant] == before + 1


@pytest.mark.parametrize("D,variant", [(10, "staged"), (20, "cluster")])
def test_merge_f_per_step_pyy_f32_sketch_shapes(cuda, D, variant):
    before = dict(fs.merge_fscan.tv_launches)
    _assert_close(*_merge_case(32, 15, **_sketch_dims(D),
                               dtype=torch.float32, dev=cuda, pyy="steps"),
                  1e-4)
    assert fs.merge_fscan.tv_launches == {**before,
                                          variant: before[variant] + 1}


@pytest.mark.parametrize("variant", ["staged", "base", "cluster"])
@pytest.mark.parametrize("dtype,D", [(torch.float64, 4),
                                     (torch.float32, 10)])
def test_merge_f_stacked_pyy_bit_equal_to_shared(cuda, variant, dtype, D):
    """One table repeated a step (pyy_step = Y^3 q) gives every kernel's
    outputs bit for bit as the shared table (pyy_step = 0) does."""
    if variant == "cluster" and dtype == torch.float32:
        D = 20
    dims = _sketch_dims(D)
    shared, _ = _merge_case(16, 6, **dims, dtype=dtype, dev=cuda,
                            variant=variant)
    stacked, _ = _merge_case(16, 6, **dims, dtype=dtype, dev=cuda,
                             variant=variant, pyy="stacked")
    torch.cuda.synchronize()
    for a, b in zip(shared, stacked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["staged", "base", "cluster"])
def test_merge_f_expanded_pyy_takes_the_shared_build(cuda, variant):
    """A shared table viewed over S with stride 0 (how the sweep hands
    constant tables on) reads as one table: no launch counts as a
    time-varying one, and the outputs are the shared table's bit for
    bit."""
    D = 20 if variant == "cluster" else 10
    dims = _sketch_dims(D)
    shared, _ = _merge_case(16, 6, **dims, dtype=torch.float32, dev=cuda,
                            variant=variant)
    before = dict(fs.merge_fscan.tv_launches)
    expanded, _ = _merge_case(16, 6, **dims, dtype=torch.float32, dev=cuda,
                              variant=variant, pyy="expanded")
    torch.cuda.synchronize()
    assert fs.merge_fscan.tv_launches == before
    for a, b in zip(shared, expanded):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["staged", "cluster"])
def test_merge_f_build_refuses_the_other_pyy_step(cuda, variant):
    """A per-shape build for one shared table (no ``MF_TV``) refuses a
    ``pyy_step``, and a time-varying build (``MF_TV=1``) refuses 0, with
    cudaErrorInvalidValue before anything is launched."""
    from matrixproductbp_tpu_torch.ops import build
    dims = tuple(_sketch_dims(20 if variant == "cluster" else 10).values())
    strides = fs._strides(torch.empty(1, 1, 8, 8, 2, 2))
    macros = {"staged": fs.merge_f_staged_macros,
              "cluster": fs.merge_f_cluster_macros}[variant]
    for tv, step in ((False, 16), (True, 0)):
        m = macros(*dims, torch.float32, tv)
        assert ("MF_TV=1" in m) == tv
        lib = build.library("merge_f_" + variant, m)
        launch = getattr(lib, "merge_f_" + variant)
        rc = launch(0, strides, 0, strides, 0, step, 0, 0, 0, 0, 0, 1, 1,
                    *dims, 1024, 0)
        assert rc == 1


# merge W in f64 (1e-10): the two small shapes, S=1 (the one-hot W_{T1}
# only), S=2, ragged DL != DB both ways, Y=3, q=1 and the D=10 shape --
# each through both merge W kernels
MERGE_W64 = [(dict(DL=4, DB=3, Y=2, q=2, sr=5), 4),
             (dict(DL=3, DB=3, Y=3, q=2, sr=4), 4),
             (dict(DL=4, DB=3, Y=2, q=2, sr=5), 1),
             (dict(DL=4, DB=3, Y=2, q=2, sr=5), 2),
             (dict(DL=3, DB=5, Y=2, q=2, sr=7), 3),
             (dict(DL=5, DB=2, Y=2, q=2, sr=6), 3),
             (dict(DL=4, DB=4, Y=2, q=1, sr=5), 3),
             (dict(DL=10, DB=10, Y=2, q=2, sr=10), 3)]
# merge W in f32 (1e-4 of max-abs): the sketch merges at D = 4, 10, 16, 20
# (one chunk of rows n up to D=17, two at D=20) and 20 x 16
MERGE_W32 = [dict(DL=D, DB=D, Y=2, q=2, sr=D) for D in (4, 10, 16, 20)] + [
    dict(DL=20, DB=16, Y=2, q=2, sr=20)]


@pytest.fixture(scope="module")
def merge_w_builds():
    """The staged merge W kernel at every shape below, built at once."""
    if torch.cuda.is_available():
        fs.build_merge_w([(*d.values(), torch.float64) for d, _ in MERGE_W64]
                         + [(*d.values(), torch.float32) for d in MERGE_W32])


def _merge_w_case(Bn, S, DL, DB, Y, q, sr, dtype, dev, variant):
    """(kernel Ws, plain Ws) on L1/B1 strided views; checks that exactly
    ``variant``'s launch was counted."""
    g = torch.Generator().manual_seed(4)
    L = _randn(g, Bn, S + 1, DL, DL, Y, q).to(dev, dtype)
    B = _randn(g, Bn, S + 1, DB, DB, Y, q).to(dev, dtype)
    Th = _randn(g, S, sr, sr, Y, Y, q).to(dev, dtype)
    before = dict(fs.merge_wscan.variant_launches)
    Ws = fs.merge_wscan(L[:, 1:], B[:, 1:], Th, _variant=variant)
    assert fs.merge_wscan.variant_launches == {
        **before, variant: before[variant] + 1}
    return [Ws], [fs.merge_wscan_plain(L[:, 1:], B[:, 1:], Th)]


@pytest.mark.parametrize("variant", ["staged", "base", "streamed"])
@pytest.mark.parametrize("dims,S", MERGE_W64)
def test_merge_w_kernels_f64(cuda, merge_w_builds, dims, S, variant):
    _assert_close(*_merge_w_case(7, S, **dims, dtype=torch.float64,
                                 dev=cuda, variant=variant), None)


@pytest.mark.parametrize("variant", ["staged", "base"])
@pytest.mark.parametrize("dims", MERGE_W32,
                         ids=lambda d: f"{d['DL']}x{d['DB']}")
def test_merge_w_kernels_f32_sketch_shapes(cuda, merge_w_builds, dims,
                                           variant):
    _assert_close(*_merge_w_case(32, 15, **dims, dtype=torch.float32,
                                 dev=cuda, variant=variant), 1e-4)


def test_merge_w_staged_refuses_another_shape(cuda, merge_w_builds):
    """A staged merge W library is built for one shape; its launcher
    refuses any other (cudaErrorInvalidValue) and launches nothing."""
    from matrixproductbp_tpu_torch.ops import build
    lib = build.library("merge_w_staged", fs.merge_w_staged_macros(
        20, 20, 2, 2, 20, torch.float32))
    strides = fs._strides(torch.empty(1, 1, 8, 8, 2, 2))
    rc = lib.merge_w_staged(0, strides, 0, strides, 0, 0, 1, 1, 8, 8, 2, 2,
                            8, 1024, 0)
    assert rc == 1


@pytest.mark.parametrize("dims", [dict(Db=4, qi=2, qj=2, sr=5, sl=8),
                                  dict(Db=3, qi=2, qj=1, sr=4, sl=6)])
def test_mpem3_kernels_f64(cuda, dims):
    _assert_close(*_mpem3_case(7, 4, **dims, dtype=torch.float64, dev=cuda),
                  None)


def test_kernels_f32_bench_shape(cuda):
    _assert_close(*_merge_case(64, 15, 10, 10, 2, 2, 10, 14, torch.float32,
                               cuda), 1e-4)
    _assert_close(*_mpem3_case(64, 15, 10, 2, 2, 10, 14, torch.float32,
                               cuda), 1e-4)


def test_kernel_launches_are_counted(cuda):
    before = fs.merge_wscan.launches
    _merge_case(2, 2, 2, 2, 2, 2, 2, 4, torch.float32, cuda)
    assert fs.merge_wscan.launches == before + 1


def test_oversized_shape_raises(cuda):
    """A shape over every shared-memory kernel's limit raises where one of
    them is forced; unforced, the streamed kernel takes it."""
    L = torch.zeros(1, 1, 40, 40, 2, 2, device=cuda)
    Th = torch.zeros(1, 40, 40, 2, 2, 2, device=cuda)
    for variant in ("staged", "base"):
        with pytest.raises(ValueError, match="shared memory"):
            fs.merge_wscan(L, L, Th, _variant=variant)
    before = fs.merge_wscan.variant_launches["streamed"]
    assert bool((fs.merge_wscan(L, L, Th) == 0).all())
    assert fs.merge_wscan.variant_launches["streamed"] == before + 1


# the streamed merge kernels (merge_streamed.cu), forced, at shapes no
# single-block merge kernel fits (the wide cluster kernels take them
# unforced): f64 at D = 16, 18, 20 and DL != DB (20 x 12, both ways); f32
# at Y=2 D=24 (one Pyy a step too), q=3 D=24 and the Glauber buckets'
# banded merges (Y = 5, 9, 10 at D=18); f64 1e-10, f32 1e-4 of max-abs
MERGE_STREAMED = [
    (dict(DL=16, DB=16, Y=2, q=2, sr=16, sl=20), torch.float64, None),
    (dict(DL=18, DB=18, Y=2, q=2, sr=18, sl=22), torch.float64, None),
    (dict(DL=20, DB=20, Y=2, q=2, sr=20, sl=24), torch.float64, None),
    (dict(DL=20, DB=12, Y=2, q=2, sr=20, sl=24), torch.float64, None),
    (dict(DL=12, DB=20, Y=2, q=2, sr=20, sl=24), torch.float64, "steps"),
    (dict(DL=24, DB=24, Y=2, q=2, sr=24, sl=28), torch.float32, None),
    (dict(DL=24, DB=24, Y=2, q=2, sr=24, sl=28), torch.float32, "steps"),
    (dict(DL=24, DB=24, Y=2, q=3, sr=24, sl=28), torch.float32, None),
    (dict(DL=18, DB=18, Y=5, q=2, sr=18, sl=22), torch.float32, "band"),
    (dict(DL=18, DB=18, Y=9, q=2, sr=18, sl=22), torch.float32, "band"),
    (dict(DL=18, DB=18, Y=10, q=2, sr=18, sl=22), torch.float32, "band")]


@pytest.mark.parametrize("dims,dtype,pyy", MERGE_STREAMED, ids=lambda v: (
    f"{v['DL']}x{v['DB']}-Y{v['Y']}-q{v['q']}" if isinstance(v, dict)
    else str(v)))
def test_merge_streamed_takes_the_shapes_beyond(cuda, dims, dtype, pyy):
    from matrixproductbp_tpu_torch.ops import sumy
    DL, DB, Y, q, sr, sl = dims.values()
    Bn, S = 5, 4
    g = torch.Generator().manual_seed(11)
    L = _randn(g, Bn, S + 1, DL, DL, Y, q).to(cuda, dtype)[:, 1:]
    B = _randn(g, S + 1, Bn, DB, DB, Y, q).to(cuda, dtype) \
        .transpose(0, 1)[:, 1:]
    if pyy == "band":
        Th = sumy.y_expand(_randn(g, S, sr, sr, Y, q).to(cuda, dtype), 0,
                           axis=3, mode="sum").contiguous()
        Pyy = sumy.band_indicator(Y, 0, q, dtype, cuda)
    else:
        Th = _randn(g, S, sr, sr, Y, Y, q).to(cuda, dtype)
        Pyy = torch.rand(((S,) if pyy == "steps" else ()) + (Y, Y, Y, q),
                         generator=g, dtype=torch.float64).to(cuda, dtype)
    Phi = _randn(g, S, sl, sl, Y, q).to(cuda, dtype)
    S0 = _randn(g, Bn, sl, DL, DB).to(cuda, dtype)
    w = fs.merge_w_geometry(DL, DB, Y, q, sr, dtype)[0]
    f = fs.merge_f_geometry(DL, DB, Y, q, sr, sl, dtype,
                            tv=pyy == "steps")[0]
    # f64 merge W fits merge_w_kernel up to D=16
    assert f in ("wide", "streamed")
    assert w in (("base",) if DL == 16 else ("wide", "streamed"))
    bw = dict(fs.merge_wscan.variant_launches)
    bf = dict(fs.merge_fscan.tv_launches)
    Ws = fs.merge_wscan(L, B, Th, _variant="streamed")
    out = [Ws, *fs.merge_fscan(L, B, Pyy, Phi, Ws, S0, _variant="streamed")]
    assert fs.merge_wscan.variant_launches["streamed"] == \
        bw["streamed"] + 1
    assert fs.merge_fscan.tv_launches["streamed"] == bf["streamed"] + (
        pyy == "steps")
    Wp = fs.merge_wscan_plain(L, B, Th)
    ref = [Wp, *fs.merge_fscan_plain(L, B, Pyy, Phi, Wp, S0)]
    _assert_close(out, ref, None if dtype == torch.float64 else 1e-4)


# the wide merge kernels (merge_wide.cu), picked by the geometry: the Glauber
# D=18 buckets' banded merges (Y = 5, 9, 10: clusters of 2, 4 and 8 blocks
# for merge F), Y=5 with a dense Pyy, shared and one a step; f64 at D = 16
# (merge F only), 18, 20 (a cluster of 8) and DL != DB both ways, one Pyy
# a step too; f32 at D=24, q = 3; S = 1 and 2; f64 1e-10, f32 1e-4 of
# max-abs
MERGE_WIDE = [
    (dict(DL=18, DB=18, Y=5, q=2, sr=18, sl=22), torch.float32, "band", 4),
    (dict(DL=18, DB=18, Y=9, q=2, sr=18, sl=22), torch.float32, "band", 4),
    (dict(DL=18, DB=18, Y=10, q=2, sr=18, sl=22), torch.float32, "band", 4),
    (dict(DL=18, DB=18, Y=5, q=2, sr=18, sl=22), torch.float32, None, 4),
    (dict(DL=18, DB=18, Y=5, q=2, sr=18, sl=22), torch.float32, "steps", 4),
    (dict(DL=18, DB=18, Y=9, q=2, sr=18, sl=22), torch.float32, "band", 1),
    (dict(DL=18, DB=18, Y=10, q=2, sr=18, sl=22), torch.float32, "band", 2),
    (dict(DL=16, DB=16, Y=2, q=2, sr=16, sl=20), torch.float64, None, 4),
    (dict(DL=18, DB=18, Y=2, q=2, sr=18, sl=22), torch.float64, None, 4),
    (dict(DL=20, DB=20, Y=2, q=2, sr=20, sl=24), torch.float64, None, 4),
    (dict(DL=20, DB=20, Y=2, q=2, sr=20, sl=24), torch.float64, None, 1),
    (dict(DL=20, DB=12, Y=2, q=2, sr=20, sl=24), torch.float64, None, 4),
    (dict(DL=12, DB=20, Y=2, q=2, sr=20, sl=24), torch.float64, "steps", 4),
    (dict(DL=24, DB=24, Y=2, q=3, sr=24, sl=28), torch.float32, None, 3)]


@pytest.mark.parametrize("dims,dtype,pyy,S", MERGE_WIDE, ids=lambda v: (
    f"{v['DL']}x{v['DB']}-Y{v['Y']}-q{v['q']}" if isinstance(v, dict)
    else str(v)))
def test_merge_wide_takes_the_cluster_shapes(cuda, dims, dtype, pyy, S):
    from matrixproductbp_tpu_torch.ops import sumy
    DL, DB, Y, q, sr, sl = dims.values()
    Bn = 5
    g = torch.Generator().manual_seed(12)
    L = _randn(g, Bn, S + 1, DL, DL, Y, q).to(cuda, dtype)[:, 1:]
    B = _randn(g, S + 1, Bn, DB, DB, Y, q).to(cuda, dtype) \
        .transpose(0, 1)[:, 1:]
    band = {"yy_off": 0} if pyy == "band" else {}
    if pyy == "band":
        Th = sumy.y_expand(_randn(g, S, sr, sr, Y, q).to(cuda, dtype), 0,
                           axis=3, mode="sum").contiguous()
        Pyy = sumy.band_indicator(Y, 0, q, dtype, cuda)
    else:
        Th = _randn(g, S, sr, sr, Y, Y, q).to(cuda, dtype)
        Pyy = torch.rand(((S,) if pyy == "steps" else ()) + (Y, Y, Y, q),
                         generator=g, dtype=torch.float64).to(cuda, dtype)
    Phi = _randn(g, S, sl, sl, Y, q).to(cuda, dtype)
    S0 = _randn(g, Bn, sl, DL, DB).to(cuda, dtype)
    w = fs.merge_w_geometry(DL, DB, Y, q, sr, dtype, band=bool(band))[0]
    f = fs.merge_f_geometry(DL, DB, Y, q, sr, sl, dtype, tv=pyy == "steps",
                            band=bool(band))[0]
    assert f == "wide" and w == ("base" if DL == DB == 16 else "wide")
    bw = dict(fs.merge_wscan.variant_launches)
    bf = dict(fs.merge_fscan.variant_launches)
    bt = dict(fs.merge_fscan.tv_launches)
    Ws = fs.merge_wscan(L, B, Th, **band)
    out = [Ws, *fs.merge_fscan(L, B, Pyy, Phi, Ws, S0, **band)]
    assert fs.merge_wscan.variant_launches[w] == bw[w] + 1
    assert fs.merge_fscan.variant_launches["wide"] == bf["wide"] + 1
    assert fs.merge_fscan.tv_launches["wide"] == bt["wide"] + (
        pyy == "steps")
    Wp = fs.merge_wscan_plain(L, B, Th)
    ref = [Wp, *fs.merge_fscan_plain(L, B, Pyy, Phi, Wp, S0)]
    _assert_close(out, ref, None if dtype == torch.float64 else 1e-4)


def test_merge_wide_refuses_another_shape(cuda):
    """A wide build takes only its own shape: the launcher returns an
    error for another, and the wrapper raises."""
    lib = build.library("merge_wide", fs.merge_wide_macros(
        "w", 18, 18, 5, 2, 18, 0, torch.float32, 0))
    L = torch.zeros(1, 1, 18, 18, 5, 2, device=cuda)
    Th = torch.zeros(1, 18, 18, 5, 5, 2, device=cuda)
    Ws = torch.empty(1, 1, 18, 18, 17, device=cuda)
    rc = lib.merge_w_wide(L.data_ptr(), fs._strides(L), L.data_ptr(),
                          fs._strides(L), Th.data_ptr(), Ws.data_ptr(), 1,
                          1, 18, 18, 5, 2, 17, 0, 0)
    assert rc != 0


def test_merge_streamed_walks_more_instances_than_blocks(cuda):
    """More instances than resident blocks: each block walks several, and
    the workspace stays the blocks'."""
    dims = _sketch_dims(10)
    blocks, _ = fs.merge_streamed_plan("f", *dims.values(), 10 ** 6,
                                       fs._sm_count(cuda))
    out, ref = _merge_case(blocks + 37, 3, **dims, dtype=torch.float32,
                           dev=cuda, variant="streamed")
    _assert_close(out, ref, 1e-4)


# the staged MPEM3 kernels: both launches of a sketch sweep at every bond D
# from 4 to 20 (the message conversion, qj = 2, B_t in the time-major
# (i, j, r, m, n) rows; the belief conversion, qj = 1, contiguous
# (m, n, i, j, r)), and each layout with the other qj at D = 10
MPEM3_STAGED = ([(D, 2, "ijrmn") for D in range(4, 21)]
                + [(D, 1, "mnijr") for D in range(4, 21)]
                + [(10, 1, "ijrmn"), (10, 2, "mnijr")])


def _mpem3_dims(D, qj):
    """(Db, qi, qj, sr, sl) of a sketch sweep's conversion to bond D."""
    return D, 2, qj, D, D + 4


@pytest.fixture(scope="module")
def mpem3_builds():
    """The staged MPEM3 W and F kernels at every shape below, built at
    once."""
    if torch.cuda.is_available():
        shapes = []
        for D, qj, layout in MPEM3_STAGED:
            Db, qi, qj, sr, sl = _mpem3_dims(D, qj)
            shapes += [(Db, qi, qj, sr, s, torch.float32, layout)
                       for s in (None, sl)]
        fs.build_mpem3(shapes)


def _mpem3_inputs(Bn, S, Db, qi, qj, sr, sl, layout, dtype, dev, seed=2):
    """B1 in ``layout`` (the sweep's strided views), Psi, Phi, S_init."""
    g = torch.Generator().manual_seed(seed)
    if layout == "ijrmn":
        B1 = _randn(g, S + 1, Bn, qi * qj * qi * Db * Db).to(dev, dtype) \
            .reshape(S + 1, Bn, qi, qj, qi, Db, Db) \
            .permute(1, 0, 5, 6, 2, 3, 4)[:, 1:]
    else:
        B1 = _randn(g, Bn, S + 1, Db, Db, qi, qj, qi).to(dev, dtype)[:, 1:]
    return (B1, _randn(g, S, sr, sr, qi, qj).to(dev, dtype),
            _randn(g, S, sl, sl, qi, qj).to(dev, dtype),
            _randn(g, Bn, sl, Db, qi).to(dev, dtype))


def _mpem3_run(B1, Psi, Phi, S0, variant=None):
    """Ws, Ns, Ms through the kernels, checking that each scan counted one
    launch of ``variant`` (the picked kernel where None)."""
    out = []
    for w, args in ((fs.mpem3_wscan, (B1, Psi)), (fs.mpem3_fscan, None)):
        before = dict(w.variant_launches)
        res = w(*(args or (B1, Phi, out[0], S0)), _variant=variant)
        v = variant or "staged"
        assert w.variant_launches == {**before, v: before[v] + 1}
        out += [res] if args else list(res)
    return out


def _mpem3_plain(B1, Psi, Phi, S0):
    Wp = fs.mpem3_wscan_plain(B1, Psi)
    return [Wp, *fs.mpem3_fscan_plain(B1, Phi, Wp, S0)]


@pytest.mark.parametrize("D,qj,layout", MPEM3_STAGED,
                         ids=lambda x: str(x))
def test_mpem3_staged_f32_sketch_shapes(cuda, mpem3_builds, D, qj, layout):
    """Both staged kernels (picked by default) against the plain scans,
    1e-4 of max-abs; 37 instances leave the last block ragged."""
    args = _mpem3_inputs(37, 15, *_mpem3_dims(D, qj), layout, torch.float32,
                         cuda)
    assert fs.mpem3_layout(args[0], args[1], args[2]) == layout
    _assert_close(_mpem3_run(*args), _mpem3_plain(*args), 1e-4)


@pytest.mark.parametrize("qj,layout", [(2, "ijrmn"), (1, "mnijr")])
def test_mpem3_staged_one_step_and_ragged(cuda, mpem3_builds, qj, layout):
    """S = 1 (only the one-hot W_{T1}, nothing to prefetch) and a batch of
    one, then of five, at D = 10 and 20."""
    for D in (10, 20):
        for Bn, S in ((5, 1), (1, 4)):
            args = _mpem3_inputs(Bn, S, *_mpem3_dims(D, qj), layout,
                                 torch.float32, cuda)
            _assert_close(_mpem3_run(*args), _mpem3_plain(*args), 1e-4)


def _assert_nonfinite_as_plain(out, ref, keep):
    """The kernels' outputs against the plain scans': the unaltered
    instances ``keep`` within 1e-4 of max-abs, every instance non-finite
    exactly where the plain scans are, and equal to them (1e-4) where
    finite."""
    _assert_close([o[keep] for o in out], [r[keep] for r in ref], 1e-4)
    for o, r in zip(out, ref):
        assert torch.equal(torch.isfinite(o), torch.isfinite(r))
        fin = torch.isfinite(r)
        assert float((o[fin] - r[fin]).abs().max()) <= 1e-4 * float(
            r[fin].abs().max())


@pytest.mark.parametrize("qj,layout", [(2, "ijrmn"), (1, "mnijr")])
def test_mpem3_staged_safe_scale(cuda, mpem3_builds, qj, layout):
    """The _safe_scale guard and N's last step: an instance whose B_t are
    all zero (every max 0, scale 1), one with an inf in its last step's
    B_t and a NaN in its first (non-finite max, scale 1), and one with an
    inf off the one-hot's entry (m, n) = (0, 0) in its last step only,
    among Gaussian ones.  The staged and the first-design kernels are
    non-finite exactly where the plain scans are (N's last step is the
    product with the one-hot, so a NaN or inf anywhere in a row of t1
    reaches every column b) and match them elsewhere."""
    args = _mpem3_inputs(9, 6, *_mpem3_dims(10, qj), layout, torch.float32,
                         cuda)
    B1 = args[0]
    B1[3] = 0.0
    B1[5, -1, 0, 0, 0, 0, 0] = float("inf")
    B1[5, 0, 1, 1, 0, 0, 1] = float("nan")
    B1[7, -1, 2, 3, 1, 0, 1] = float("inf")
    ref = _mpem3_plain(*args)
    keep = torch.tensor([z not in (3, 5, 7) for z in range(9)], device=cuda)
    for variant in (None, "base"):
        _assert_nonfinite_as_plain(_mpem3_run(*args, variant=variant), ref,
                                   keep)
    assert not bool(torch.isfinite(ref[1][7, -1, ..., 1:]).all())
    assert bool(torch.isfinite(ref[0][3]).all())


@pytest.mark.parametrize("variant", ["staged", "cluster", "base", "wide",
                                     "streamed"])
def test_merge_f_safe_scale(cuda, variant):
    """As ``test_mpem3_staged_safe_scale`` for each merge F kernel at the
    D=10 sketch merge, with finite W_t: a zero instance, one with a NaN in
    its first step's B_t and an inf in its last, one with an inf off
    (m, j) = (0, 0) in its last step only (M and the earlier N stay
    finite, the last N turns non-finite in every column b); non-finite
    exactly where the plain scans are."""
    g = torch.Generator().manual_seed(9)
    d = _sketch_dims(10)
    Bn, S, DL, DB, Y, q, sr, sl = 9, 6, *d.values()
    L = _randn(g, Bn, S + 1, DL, DL, Y, q).to(cuda, torch.float32)
    B = _randn(g, Bn, S + 1, DB, DB, Y, q).to(cuda, torch.float32)
    Th = _randn(g, S, sr, sr, Y, Y, q).to(cuda, torch.float32)
    Pyy = torch.rand((Y, Y, Y, q), generator=g, dtype=torch.float64) \
        .to(cuda, torch.float32)
    Phi = _randn(g, S, sl, sl, Y, q).to(cuda, torch.float32)
    S0 = _randn(g, Bn, sl, DL, DB).to(cuda, torch.float32)
    L[3], B[3] = 0.0, 0.0
    Wp = fs.merge_wscan_plain(L[:, 1:], B[:, 1:], Th)      # finite W_t
    B[5, 1, 1, 1, 0, 1] = float("nan")
    B[5, -1, 0, 0, 1, 0] = float("inf")
    B[7, -1, 2, 3, 1, 0] = float("inf")
    L1, B1 = L[:, 1:], B[:, 1:]
    ref = [Wp, *fs.merge_fscan_plain(L1, B1, Pyy, Phi, Wp, S0)]
    before = dict(fs.merge_fscan.variant_launches)
    out = [Wp, *fs.merge_fscan(L1, B1, Pyy, Phi, Wp, S0, _variant=variant)]
    assert fs.merge_fscan.variant_launches == {
        **before, variant: before[variant] + 1}
    keep = torch.tensor([z not in (3, 5, 7) for z in range(9)], device=cuda)
    _assert_nonfinite_as_plain(out, ref, keep)
    assert not bool(torch.isfinite(ref[1][7, -1, ..., 1:]).all())
    assert bool(torch.isfinite(ref[1][7, :-1]).all())
    assert bool(torch.isfinite(ref[2][7]).all())


def test_mpem3_strided_and_f64_take_the_base_kernels(cuda, mpem3_builds):
    """A B1 whose instance-steps are not dense runs, and f64, take the
    first-design kernels; forcing the staged one on the strided view
    raises."""
    args = _mpem3_inputs(6, 4, *_mpem3_dims(10, 2), "mnijr", torch.float32,
                         cuda)
    wide = torch.zeros(6, 4, 10, 10, 2, 2, 4, device=cuda)
    wide[..., :2] = args[0]
    strided = wide[..., :2]
    assert fs.mpem3_layout(strided) is None
    sargs = (strided,) + args[1:]
    _assert_close(_mpem3_run(*sargs, variant="base"), _mpem3_plain(*sargs),
                  1e-4)
    before = dict(fs.mpem3_wscan.variant_launches)
    fs.mpem3_wscan(strided, args[1])
    assert fs.mpem3_wscan.variant_launches == {
        **before, "base": before["base"] + 1}
    with pytest.raises(ValueError, match="dense"):
        fs.mpem3_wscan(strided, args[1], _variant="staged")
    d64 = [a.double() for a in args]
    before = dict(fs.mpem3_fscan.variant_launches)
    Wp = fs.mpem3_wscan(d64[0], d64[1])
    fs.mpem3_fscan(d64[0], d64[2], Wp, d64[3])
    assert fs.mpem3_fscan.variant_launches == {
        **before, "base": before["base"] + 1}


def test_mpem3_staged_refuses_another_shape(cuda, mpem3_builds):
    """A staged MPEM3 library is built for one shape and B_t layout; its
    launcher refuses any other (cudaErrorInvalidValue) and launches
    nothing."""
    from matrixproductbp_tpu_torch.ops import build
    lib = build.library("mpem3_staged", fs.mpem3_staged_macros(
        10, 2, 2, 10, 14, torch.float32, "ijrmn"))
    other = fs._strides(torch.empty(1, 1, 8, 8, 2, 2, 2))
    assert lib.mpem3_f_staged(0, other, 0, 0, 0, 0, 0, 1, 1, 8, 2, 2, 8, 12,
                              1024, 0) == 1
    own = fs._strides(torch.empty(1, 1, 10, 10, 2, 2, 2))   # (m,n,i,j,r)
    assert lib.mpem3_f_staged(0, own, 0, 0, 0, 0, 0, 1, 1, 10, 2, 2, 10, 14,
                              1024, 0) == 1
    assert not hasattr(lib, "mpem3_w_staged")


@pytest.mark.parametrize("dtype,shape", [
    (torch.float64, (7, 24, 8)), (torch.float64, (5, 80, 20)),
    (torch.float32, (4096, 80, 20)), (torch.float32, (4096, 160, 40))])
def test_cholqr_kernel(cuda, dtype, shape):
    g = torch.Generator().manual_seed(2)
    A = _randn(g, *shape).to(cuda, dtype)
    A[::3] = A[::3, :, :1] * A[::3, :1, :]               # rank 1 instances
    before = kernels.batched_cholqr.launches
    Q, R = kernels.cholqr(A)
    assert kernels.batched_cholqr.launches == before + 1
    Qp, Rp = cholqr_unrolled(A)
    tol = None if dtype == torch.float64 else 1e-5
    _assert_close((Q, R), (Qp, Rp), tol)
    assert bool(torch.isfinite(Q).all())


# the staged CholQR kernel: the randomized merge's projection [4s, s], s =
# 2D, for D = 4 to 20; n = 1; odd m and n (4-byte copies, padded rows,
# single stores); a batch of 13 at a shape with two instances a block
CHOLQR_SKETCH = [(8 * D, 2 * D) for D in range(4, 21)]
CHOLQR_EDGE = [(4, 1), (80, 1), (37, 13)]


@pytest.fixture(scope="module")
def cholqr_builds():
    """The staged CholQR kernel at every shape below, built at once."""
    if torch.cuda.is_available():
        kernels.build_cholqr(CHOLQR_SKETCH + CHOLQR_EDGE)


def _cholqr_case(Bn, m, n, dev, variant, seed=6):
    """Gaussian float32 A with every third instance rank 1, through the
    forced kernel (its launch counted alone) and cholqr_unrolled: max-abs
    error within 1e-5 of max-abs, Q finite, and on the Gaussian instances
    Q^T Q - I <= 1e-4 and Q R - A <= 1e-5 of max |A|."""
    g = torch.Generator().manual_seed(seed)
    A = _randn(g, Bn, m, n)
    A[::3] = A[::3, :, :1] * A[::3, :1, :]
    A = A.to(dev, torch.float32)
    before = dict(kernels.batched_cholqr.variant_launches)
    Q, R = kernels.cholqr(A, _variant=variant)
    assert kernels.batched_cholqr.variant_launches == {
        **before, variant: before[variant] + 1}
    _assert_close((Q, R), cholqr_unrolled(A), 1e-5)
    assert bool(torch.isfinite(Q).all())
    keep = torch.arange(Bn, device=dev) % 3 != 0
    if bool(keep.any()):
        Qd, Rd, Ad = Q[keep].double(), R[keep].double(), A[keep].double()
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        assert float((Qd.transpose(1, 2) @ Qd - eye).abs().max()) <= 1e-4
        assert float((Qd @ Rd - Ad).abs().max()) <= 1e-5 * float(
            Ad.abs().max())
    assert bool((torch.tril(R, -1) == 0).all())


@pytest.mark.parametrize("m,n", CHOLQR_SKETCH + CHOLQR_EDGE,
                         ids=lambda x: str(x))
def test_cholqr_staged_kernel(cuda, cholqr_builds, m, n):
    _cholqr_case(64, m, n, cuda, "staged")


@pytest.mark.parametrize("variant", ["staged", "base"])
@pytest.mark.parametrize("m,n", [(80, 20), (160, 40)])
def test_cholqr_kernels_bench_shapes(cuda, cholqr_builds, m, n, variant):
    _cholqr_case(4096, m, n, cuda, variant)


def test_cholqr_staged_ragged_batch(cuda, cholqr_builds):
    """13 instances, two a block: the last block holds one."""
    assert kernels._cholqr_staged_plan(80, 20)[0] == 2
    _cholqr_case(13, 80, 20, cuda, "staged")
    _cholqr_case(1, 37, 13, cuda, "staged")


def test_cholqr_f32_takes_the_staged_kernel(cuda, cholqr_builds):
    A = torch.randn(8, 80, 20, device=cuda)
    before = dict(kernels.batched_cholqr.variant_launches)
    kernels.cholqr(A)
    kernels.cholqr(A.double())
    assert kernels.batched_cholqr.variant_launches == {
        "staged": before["staged"] + 1, "base": before["base"] + 1}


def test_cholqr_forced_kernel_that_does_not_fit_raises(cuda, cholqr_builds):
    with pytest.raises(ValueError, match="float32"):
        kernels.cholqr(torch.zeros(2, 80, 20, device=cuda,
                                   dtype=torch.float64), _variant="staged")
    with pytest.raises(ValueError, match="n <= 40"):
        kernels.cholqr(torch.zeros(2, 96, 48, device=cuda),
                       _variant="staged")
    with pytest.raises(ValueError, match="shared memory"):
        kernels.cholqr(torch.zeros(2, 1000, 40, device=cuda),
                       _variant="base")
    with pytest.raises(ValueError, match="aligned"):
        kernels.cholqr(torch.zeros(2 * 80 * 20 + 1, device=cuda)[1:]
                       .view(2, 80, 20))


def test_cholqr_staged_refuses_another_shape(cuda, cholqr_builds):
    """A staged CholQR library is built for one shape; its launcher
    refuses any other (cudaErrorInvalidValue) and launches nothing."""
    from matrixproductbp_tpu_torch.ops import build
    lib = build.library("cholqr_staged", kernels.cholqr_staged_macros(80, 20))
    smem = kernels.cholqr_geometry(80, 20, torch.float32)[2]
    assert lib.cholqr_staged(0, 0, 0, 1, 160, 40, 1e-6, smem, 0) == 1
    assert lib.cholqr_staged(0, 0, 0, 1, 80, 20, 1e-6, smem + 16, 0) == 1


def _eigh_inputs(kind, B, k, seed):
    """[B, k, k] float64: Gram matrices of Gaussian [2k, k] matrices with
    the first half rank-deficient, multiples of the identity, a 5-fold
    degenerate eigenvalue cluster, zeros, or diagonal matrices."""
    g = torch.Generator().manual_seed(seed)
    if kind == "gauss":
        X = _randn(g, B, 2 * k, k)
        X[: B // 2, :, k // 2:] = 0.0                    # rank-deficient half
        return X.transpose(1, 2) @ X
    if kind == "identity":
        return _randn(g, B, 1, 1) * torch.eye(k, dtype=torch.float64)
    if kind == "cluster5":
        Q, _ = torch.linalg.qr(_randn(g, B, k, k))
        ev = _randn(g, B, k)
        ev[:, : min(5, k)] = 2.0
        return (Q * ev[:, None, :]) @ Q.transpose(1, 2)
    if kind == "zero":
        return torch.zeros(B, k, k, dtype=torch.float64)
    return torch.diag_embed(_randn(g, B, k))


# odd k (the dummy index), k on either side of a warp (31, 32, 33), the
# bench shapes, and a batch of 13 that leaves the last block ragged
@pytest.mark.parametrize("kind", ["gauss", "identity", "cluster5", "zero",
                                  "diagonal"])
@pytest.mark.parametrize("k,B", [(5, 7), (20, 512), (40, 512), (64, 16),
                                 (1, 13), (2, 13), (21, 13), (31, 13),
                                 (32, 13), (33, 13), (40, 13), (63, 13),
                                 (64, 13)])
def test_jacobi_eigh_kernel(cuda, k, B, kind):
    G = _eigh_inputs(kind, B, k, k).to(cuda)
    before = smallsvd.eigh_desc.launches
    w, V = smallsvd.eigh_desc(G)
    assert smallsvd.eigh_desc.launches == before + 1
    wp, _ = smallsvd.eigh_desc_plain(G)
    torch.cuda.synchronize()
    scale = float(G.abs().max())
    assert float((w - wp).abs().max()) <= 1e-10 * scale
    rec = (V * w[..., None, :]) @ V.transpose(1, 2)
    assert float((rec - G).abs().max()) <= 1e-10 * scale
    eye = torch.eye(k, dtype=G.dtype, device=cuda)
    assert float((V.transpose(1, 2) @ V - eye).abs().max()) <= 1e-10
    assert bool((w[..., :-1] >= w[..., 1:]).all())


def test_svd_by_gram_on_the_card(cuda):
    g = torch.Generator().manual_seed(3)
    M = _randn(g, 256, 80, 20).to(cuda, torch.float32)
    M[:128, :, 10:] = 0.0
    U, S, Vh = smallsvd.svd_by_gram(M)
    Sr = torch.linalg.svdvals(M.double())
    assert float((S.double() - Sr).abs().max()) <= 1e-5 * float(Sr.max())
    rec = (U.double() * S.double()[..., None, :]) @ Vh.double()
    assert float((rec - M.double()).abs().max()) <= 1e-5 * float(
        M.abs().max())


def test_cholqr_and_eigh_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="n <= 64"):
        kernels.cholqr(torch.zeros(2, 80, 65, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.cholqr(torch.zeros(2, 20, 80, device=cuda).transpose(1, 2))
    with pytest.raises(TypeError, match="float64"):
        smallsvd.eigh_desc(torch.zeros(2, 4, 4, device=cuda))


# the banded (sum-type) merge of the Glauber tables at D=10: Y = 3, 5 and
# 10 (the ER graph's K = 2, 4 and 9 buckets; Y=9 at K=8 takes the Y=10
# kernels), Th from y_expand and the band as a dense Pyy, as the sweep
# feeds them; and the q = 3 (SIRS) merges at D=10 and D=20
BANDED_Y = [3, 5, 10]
Q3_MERGES = [dict(DL=D, DB=D, Y=2, q=3, sr=D, sl=D + 4) for D in (10, 20)]
# the q = 3 conversions of a SIRS sketch sweep: messages (qj = 3, the
# time-major rows) and beliefs (qj = 1, contiguous) at D=10 and D=20
MPEM3_Q3 = [(D, qj, "ijrmn" if qj == 3 else "mnijr") for D in (10, 20)
            for qj in (3, 1)]


def _q3_mpem3_dims(D, qj):
    return D, 3, qj, D, D + 4


@pytest.fixture(scope="module")
def slice_builds():
    """The per-shape merge F and MPEM3 kernels at every shape below, built
    at once."""
    if torch.cuda.is_available():
        banded = [(10, 10, Y, 2, 10, 14, torch.float32) for Y in BANDED_Y]
        fs.build_merge_f(banded[:2], "cluster")
        fs.build_merge_f(banded + [(*d.values(), torch.float32)
                                   for d in Q3_MERGES if d["DL"] == 10])
        fs.build_mpem3([(*_q3_mpem3_dims(D, qj)[:4], s, torch.float32, lay)
                        for D, qj, lay in MPEM3_Q3
                        for s in (None, D + 4)])


def _banded_merge_inputs(Bn, S, D, Y, q, off, dev, seed=10):
    """L1, B1 (strided views), the banded Th and Pyy, Phi, S_init."""
    from matrixproductbp_tpu_torch.ops import sumy
    g = torch.Generator().manual_seed(seed)
    L = _randn(g, Bn, S + 1, D, D, Y, q).to(dev, torch.float32)
    B = _randn(g, Bn, S + 1, D, D, Y, q).to(dev, torch.float32)
    psi = _randn(g, S, D, D, Y, q).to(dev, torch.float32)
    Th = sumy.y_expand(psi, off, axis=3, mode="sum").contiguous()
    Pyy = sumy.band_indicator(Y, off, q, torch.float32, dev)
    Phi = _randn(g, S, D + 4, D + 4, Y, q).to(dev, torch.float32)
    S0 = _randn(g, Bn, D + 4, D, D).to(dev, torch.float32)
    return L[:, 1:], B[:, 1:], Th, Pyy, Phi, S0


@pytest.mark.parametrize("Y", BANDED_Y)
def test_banded_merge_scans(cuda, slice_builds, Y):
    """The kernels merge_*_geometry picks (merge W: the first design; merge
    F: staged to Y=5, the cluster kernel at Y=10) and every other merge F
    kernel that fits, against the plain scans, 1e-4 of max-abs."""
    L1, B1, Th, Pyy, Phi, S0 = _banded_merge_inputs(33, 15, 10, Y, 2, 0,
                                                    cuda)
    want = {3: "staged", 5: "staged", 10: "cluster"}[Y]
    assert fs.merge_f_geometry(10, 10, Y, 2, 10, 14, torch.float32)[0] \
        == want
    assert fs.merge_w_geometry(10, 10, Y, 2, 10, torch.float32)[0] == "base"
    Wp = fs.merge_wscan_plain(L1, B1, Th)
    ref = [Wp, *fs.merge_fscan_plain(L1, B1, Pyy, Phi, Wp, S0)]
    before = dict(fs.merge_wscan.variant_launches)
    Ws = fs.merge_wscan(L1, B1, Th)
    assert fs.merge_wscan.variant_launches == {
        **before, "base": before["base"] + 1}
    for variant in (want, "base") + (("cluster",) if Y < 10 else ()):
        before = dict(fs.merge_fscan.variant_launches)
        out = [Ws, *fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0,
                                   _variant=None if variant == want
                                   else variant)]
        assert fs.merge_fscan.variant_launches == {
            **before, variant: before[variant] + 1}
        _assert_close(out, ref, 1e-4)


def test_banded_merge_beyond_the_kernels_raises(cuda):
    """Y=10 at D=11: merge W's buffers do not fit, and no kernel is
    quietly replaced by the plain scans."""
    L1, B1, Th, _, _, _ = _banded_merge_inputs(2, 3, 11, 10, 2, 0, cuda)
    before = fs.merge_wscan.launches
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_wscan(L1, B1, Th)
    assert fs.merge_wscan.launches == before


@pytest.mark.parametrize("dims", Q3_MERGES, ids=lambda d: f"D{d['DL']}")
def test_q3_merge_scans(cuda, slice_builds, dims):
    """SIRS merges (Y=2, q=3, a dense OR-merge Pyy): the picked kernels
    (merge F staged at D=10, the first design at D=20; merge W the first
    design) against the plain scans."""
    out, ref = _merge_case(17, 15, **dims, dtype=torch.float32, dev=cuda)
    _assert_close(out, ref, 1e-4)


@pytest.mark.parametrize("D,qj,layout", MPEM3_Q3, ids=lambda x: str(x))
def test_mpem3_staged_q3(cuda, slice_builds, D, qj, layout):
    """Both staged MPEM3 kernels at the q = 3 conversions of a SIRS sketch
    sweep against the plain scans, 1e-4 of max-abs."""
    args = _mpem3_inputs(37, 15, *_q3_mpem3_dims(D, qj), layout,
                         torch.float32, cuda)
    assert fs.mpem3_layout(args[0], args[1], args[2]) == layout
    _assert_close(_mpem3_run(*args), _mpem3_plain(*args), 1e-4)


def test_chunked_sweep_on_the_card(cuda):
    """SIS on a random 3-regular graph of 96 nodes (T=5, D=6, f32,
    sketch): ``bp_sweep_chunked`` in chunks of 40 nodes (the last one 16)
    against ``bp_sweep``, beliefs and the messages' marginals to 1e-5 and
    every merge and conversion on a kernel; the Jacobi flat sweep on the
    same chunks bit for bit against the chunked one; a Gauss-Seidel
    shuffled sweep finite and normalised."""
    import numpy as np
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import bigsweep
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    from matrixproductbp_tpu_torch.ops.tensortrain import TensorTrain, \
        marginals
    g = tp.random_regular_graph(96, 3, np.random.default_rng(0))
    bp0 = mpbp_sis(SIS(g, 0.2, 0.1, T=5, gamma=0.3), D=6,
                   dtype=torch.float32)
    trunc = tp.TruncBond(6)
    mono = tp.bp_sweep(bp0, trunc, method="sketch")
    before = (fs.merge_fscan.launches, fs.mpem3_fscan.launches)
    chunked = tp.bp_sweep_chunked(bp0, trunc, method="sketch", chunk=40)
    assert (fs.merge_fscan.launches - before[0],
            fs.mpem3_fscan.launches - before[1]) == (9, 6)

    def msg(bp):
        return marginals(TensorTrain(bp.msg_cores, bp.msg_logz, (2, 2)))

    assert float((tp.beliefs(chunked) - tp.beliefs(mono)).abs().max()) \
        <= 1e-5
    assert float((msg(chunked) - msg(mono)).abs().max()) <= 1e-5
    fl = bigsweep.flat_init(g, bp0.tables, 5, 6, belief_cores=True)
    fl = bigsweep.bp_sweep_flat(g, bp0.tables, fl, trunc, 5, 6,
                                phi=bp0.phi, chunk=120, jacobi=True)
    for name in ("msg_cores", "msg_logz", "bel_cores", "bel_logz", "f"):
        assert torch.equal(getattr(fl, name), getattr(chunked, name)), name
    seidel = tp.bp_sweep_chunked(bp0, trunc, method="sketch", chunk=40,
                                 schedule="seidel",
                                 rng=np.random.default_rng(0))
    b = tp.beliefs(seidel)
    assert bool(torch.isfinite(b).all())
    assert float((b.sum(-1) - 1).abs().max()) <= 1e-5


def test_transition_probs_on_the_card(cuda):
    """``factors.transition_probs`` with the tables, the mask and a batch of
    64 particles on the card equals the CPU result (SIS on a random tree
    with a degree-5 node, and the banded Glauber tables)."""
    import numpy as np
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import (SIS, mpbp_sis, Glauber,
                                                  Ising, mpbp_glauber)
    g = tp.random_tree(40, np.random.default_rng(1))
    states = [mpbp_sis(SIS(g, 0.2, 0.1, T=2, gamma=0.3), D=2,
                       device="cpu"),
              mpbp_glauber(Glauber(Ising(g, J=[0.5] * (g.E // 2),
                                         h=[0.1] * g.N, beta=0.7), T=2),
                           D=2, device="cpu")]
    rng = np.random.default_rng(0)
    nbr = np.minimum(g.nbr, g.N - 1)
    for bp in states:
        x = torch.as_tensor(rng.integers(0, 2, size=(64, g.N)))
        ref = tp.transition_probs(bp.tables, g.in_mask, x[:, nbr], x)
        out = tp.transition_probs(bp.tables.to(device=cuda),
                                  torch.as_tensor(g.in_mask, device=cuda),
                                  x[:, nbr].to(cuda), x.to(cuda))
        assert out.device.type == "cuda"
        assert float((out.cpu() - ref).abs().max()) <= 1e-12


def test_belief_lognorms_sketch_on_the_kernels(cuda, monkeypatch):
    """``belief_lognorms(method="sketch")`` at a small size (SIS on a
    random tree of 80 nodes, buckets up to K=8, T=5, D=6, f32): on the
    merge kernels, with no plain-scan call, within 1e-3 of the same call
    on the plain scans with the same sketches."""
    import numpy as np
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    from matrixproductbp_tpu_torch.ops import stta
    g = tp.random_tree(80, np.random.default_rng(0))
    bp = mpbp_sis(SIS(g, 0.2, 0.1, T=5, gamma=0.3), D=6,
                  dtype=torch.float32)
    bp, _, _ = tp.iterate(bp, maxiter=4, trunc=tp.TruncBond(6), tol=0.0,
                          method="sketch")
    calls = []
    for name in ("merge_wscan_plain", "merge_fscan_plain"):
        for mod in (fs, stta):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name,
                                lambda *a, _f=fn, **k: (calls.append(1),
                                                        _f(*a, **k))[1])
    before = fs.merge_fscan.launches
    lz = tp.belief_lognorms(bp, trunc=tp.TruncBond(6), method="sketch")
    assert fs.merge_fscan.launches > before and not calls
    for name in ("merge_wscan", "merge_fscan"):
        monkeypatch.setattr(fs, name, getattr(fs, name + "_plain"))
    ref = tp.belief_lognorms(bp, trunc=tp.TruncBond(6), method="sketch")
    assert bool(torch.isfinite(lz).all())
    assert float((lz - ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("m,n", [(100, 64), (64, 100), (128, 128)])
def test_f64_svd_on_the_card_takes_gesvd(cuda, m, n):
    """float64 SVDs on the card (every periodic compress and conversion in
    f64, and the f64 ``qr`` sweeps) take cuSOLVER's ``gesvd``: singular
    values within 1e-12 of the host's (relative to the largest), the
    factors orthonormal and reproducing M to 1e-12, on Gaussian matrices
    and on the Kronecker product of a matrix with itself, whose singular
    values come in exactly equal pairs."""
    from matrixproductbp_tpu_torch.ops import tensortrain as tt
    g = torch.Generator().manual_seed(m + n)
    A = _randn(g, 3, m, n)
    a = _randn(g, 3, 10, 10)
    K = torch.einsum("bij,bkl->bikjl", a, a).reshape(3, 100, 100)
    for M in (A, K):
        before = dict(tt.batched_svd.calls)
        U, S, Vh = tt.batched_svd(M.to(cuda))
        assert tt.batched_svd.calls["linalg"] == before["linalg"] + 1
        U, S, Vh = U.cpu(), S.cpu(), Vh.cpu()
        ref = torch.linalg.svdvals(M)
        top = ref[:, :1]
        assert float(((S - ref).abs() / top).max()) <= 1e-12
        k = S.shape[-1]
        eye = torch.eye(k, dtype=M.dtype)
        assert float((U.mT @ U - eye).abs().max()) <= 1e-12
        assert float((Vh @ Vh.mT - eye).abs().max()) <= 1e-12
        rec = (U * S[..., None, :]) @ Vh
        assert float(((rec - M).abs() / top[..., None]).max()) <= 1e-12
