"""Which MPEM3 kernels ``mpem3_wscan`` / ``mpem3_fscan`` launch, decided on
the CPU by the pure :func:`mpem3_geometry`: the staged kernels
(``mpem3_staged.cu``, built per shape) for f32 where B_t is one dense,
16-byte-aligned run an instance-step (the message conversion's time-major
rows and the belief conversion's contiguous ones, D = 4 to 20, qj = 1 and
2), the first designs (``mpem3_w_kernel``, ``mpem3_f_kernel``) for f64 and
strided views, ``ValueError`` where a forced kernel cannot run; the shared
memory and the macros, worked by hand at D = 10 and D = 20; the padded
rows' banks; and, on the CPU, the wrappers still running the plain scans
and counting no launch."""
import pytest
import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.tools import probe_mpem3

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


def _dims(D, qj):
    """(Db, qi, qj, sr, sl) of a sketch sweep's conversion to bond D."""
    return D, 2, qj, D, D + 4


def _views(Bn, S, Db, qi, qj):
    """B1 as the message conversion hands it over (time-major rows, first
    step dropped) and as the belief conversion does (contiguous)."""
    tm = torch.zeros(S + 1, Bn, qi * qj * qi * Db * Db).reshape(
        S + 1, Bn, qi, qj, qi, Db, Db).permute(1, 0, 5, 6, 2, 3, 4)[:, 1:]
    bt = torch.zeros(Bn, S + 1, Db, Db, qi, qj, qi)[:, 1:]
    return tm, bt


@pytest.mark.parametrize("qj", [1, 2])
@pytest.mark.parametrize("D", range(4, 21))
def test_sweep_shapes_take_the_staged_kernels(D, qj):
    for layout in fs.MPEM3_LAYOUTS:
        for sl in (None, D + 4):
            variant, threads, smem = fs.mpem3_geometry(
                D, 2, qj, D, sl, F32, layout)
            assert variant == "staged" and smem <= fs.SMEM_LIMIT
            gt, ipb, blocks, tiles, elems = fs._mpem3_staged_plan(
                D, 2, qj, D, sl, 4, layout)
            assert threads == gt * ipb <= 1024 and gt % 32 == 0
            assert smem == 4 * elems and 1 <= ipb <= 8
            assert blocks * (smem + 1024) <= build.SMEM_PER_SM
            assert blocks * threads <= fs._MPEM3_THREADS_AN_SM
            assert len(tiles) == (2 if sl is None else 4)
            # f64 and strided B_t keep the first designs
            assert fs.mpem3_geometry(D, 2, qj, D, sl, F64, layout)[0] == \
                "base"
            assert fs.mpem3_geometry(D, 2, qj, D, sl, F32, None)[0] == "base"


@pytest.mark.parametrize("qj", [1, 2])
def test_layout_of_the_sweep_views(qj):
    tm, bt = _views(3, 4, 10, 2, qj)
    assert fs.mpem3_layout(tm) == "ijrmn"
    assert fs.mpem3_layout(bt) == "mnijr"
    # a view whose instance-steps are not dense, one that starts off 16
    # bytes, and a contiguous [Bn, S, i, j, r, m, n] (neither order)
    wide = torch.zeros(3, 4, 10, 10, 2, qj, 4)
    assert fs.mpem3_layout(wide[..., :2]) is None
    flat = torch.zeros(3 * 4 * 10 * 10 * 2 * qj * 2 + 1)
    assert fs.mpem3_layout(flat[1:].reshape(3, 4, 10, 10, 2, qj, 2)) is None
    # instance-major (i, j, r, m, n) rows are the first order too; rows
    # with n before m are neither
    inst = torch.zeros(3, 4, 2, qj, 2, 10, 10).permute(0, 1, 5, 6, 2, 3, 4)
    assert fs.mpem3_layout(inst) == "ijrmn"
    nm = torch.zeros(3, 4, 2, qj, 2, 10, 10).permute(0, 1, 6, 5, 2, 3, 4)
    assert fs.mpem3_layout(nm) is None
    # an operand that starts off 16 bytes sends the scan to the base kernel
    psi = torch.zeros(4 * 10 * 10 * 2 * qj + 1)[1:]
    assert fs.mpem3_layout(tm, psi) is None


def test_shared_memory_by_hand():
    """f32, qj = 2: MI = 20 (D=10) or 40 (D=20), rows of S and t1 padded to
    MI|1 = 21 or 41, B_t 8*D^2, W MI*D; M and N (sl*sr + sl*4*sr) over the
    step's B_t buffer (700 <= 800, 2,400 <= 3,200).  F, a block: Phi_t for
    two steps 2*sl^2*4; an instance: S, S2 2*sl*(MI|1) (D=10: 294 rounded
    up to 296), B_t 2*8*D^2, W 3*MI*D, t1 sl*4*(MI|1).  W, a block: Psi_t
    2*D^2*4; an instance: W MI*D, B_t 2*8*D^2, t1 MI*(2*D|1)."""
    assert fs._smem_mpem3_staged(10, 2, 2, 10, 14, 4) == (
        2 * 784, 2 * 296 + 2 * 800 + 3 * 200 + 56 * 21)
    assert fs._smem_mpem3_staged(10, 2, 2, 10, 14, 4)[1] == 3968
    assert fs._smem_mpem3_staged(20, 2, 2, 20, 24, 4) == (
        2 * 2304, 2 * 984 + 2 * 3200 + 3 * 800 + 96 * 41)
    assert fs._smem_mpem3_staged(20, 2, 2, 20, 24, 4)[1] == 14704
    assert fs._smem_mpem3_staged(10, 2, 2, 10, None, 4) == (
        2 * 400, 200 + 2 * 800 + 20 * 21)
    assert fs._smem_mpem3_staged(20, 2, 2, 20, None, 4) == (
        2 * 1600, 800 + 2 * 3200 + 40 * 41)
    # beliefs at D=4 (qj = 1): M and N (8*4 + 8*2*4 = 96) do not fit over
    # B_t (4*4*2*1*2 = 64) and take a buffer of their own
    shared, inst = fs._smem_mpem3_staged(4, 2, 1, 4, 8, 4)
    assert inst == 2 * 72 + 2 * 64 + 3 * 32 + 16 * 9 + 96
    # D=20 messages: three instances of 64 threads a block, one block an SM
    assert fs.mpem3_geometry(20, 2, 2, 20, 24, F32, "ijrmn") == (
        "staged", 192, 4 * (4608 + 3 * 14704))


@pytest.mark.parametrize("D,qj,sl,gt", [
    (10, 2, 14, 32), (10, 2, None, 32), (20, 2, 24, 64), (20, 2, None, 64),
    (20, 1, 24, 64), (20, 1, None, 32), (13, 2, 17, 32), (18, 1, None, 32)])
def test_one_warp_an_instance_up_to_90k_fmas_a_step(D, qj, sl, gt):
    """FMAs an instance-step: F (t1, M, N, S2) 40,880 at D=10, qj=2, and
    264,960 at D=20; W (t1, W2) 96,000 at D=20, qj=2, and 48,000 at
    qj=1."""
    prods = fs._mpem3_products(D, 2, qj, D, sl, "ijrmn")
    fma = sum(r * c * b * k1 * k2 for r, c, b, k1, k2 in prods)
    assert (fma > fs._MPEM3_TWO_WARPS_FMA) == (gt == 64)
    assert fs._mpem3_staged_plan(D, 2, qj, D, sl, 4, "ijrmn")[0] == gt
    if (D, qj, sl) == (10, 2, 14):
        assert fma == 14 * 20 * 4 * 10 + 14 * 10 * 20 + 56 * 10 * 20 \
            + 14 * 20 * 56 == 40880
    if (D, qj, sl) == (20, 2, None):
        assert fma == 20 * 10 * 4 * 40 * 2 + 20 * 20 * 2 * 40 == 96000


def test_macros_at_the_bench_shapes():
    m = fs.mpem3_staged_macros(10, 2, 2, 10, 14, F32, "ijrmn")
    assert m[:10] == ("M3_T=float", "M3_DB=10", "M3_QI=2", "M3_QJ=2",
                      "M3_SR=10", "M3_SL=14", "M3_LAYOUT=0", "M3_GT=32",
                      "M3_IPB=3", "M3_MINB=4")
    assert len(m) == 10 + 4 * 3
    w = fs.mpem3_staged_macros(20, 2, 1, 20, None, F32, "mnijr")
    assert w[:10] == ("M3_T=float", "M3_DB=20", "M3_QI=2", "M3_QJ=1",
                      "M3_SR=20", "M3_SL=0", "M3_LAYOUT=1", "M3_GT=32",
                      "M3_IPB=2", "M3_MINB=5")
    assert len(w) == 10 + 2 * 3
    # each (shape, layout, kernel) is a library of its own
    shapes = [(10, 2, 2, 10, s, F32, lay) for s in (None, 14)
              for lay in fs.MPEM3_LAYOUTS]
    libs = {build._paths("mpem3_staged", fs.mpem3_staged_macros(*x))[1]
            for x in shapes}
    assert len(libs) == 4
    assert "mpem3_staged" in build.PER_SHAPE
    with pytest.raises(ValueError, match="macros"):
        build._target("mpem3_staged")


@pytest.mark.parametrize("D", [10, 20])
def test_tiles_and_k_splits(D):
    """Every product's tile covers it, the K split is a power of two no
    larger than its k1 steps, and a split leaves whole warps of tasks."""
    for qj, layout in ((2, "ijrmn"), (1, "mnijr")):
        for sl in (None, D + 4):
            prods = fs._mpem3_products(*_dims(D, qj)[:4], sl, layout)
            gt, _, _, tiles, _ = fs._mpem3_staged_plan(
                *_dims(D, qj)[:4], sl, 4, layout)
            for (rows, cols, nb, k1, k2), (tm, tn, ks) in zip(prods, tiles):
                assert 1 <= tm <= min(rows, 8) and 1 <= tn <= min(cols, 10)
                assert tm * tn <= 32
                assert ks & (ks - 1) == 0 and ks <= min(k1, 32, gt)


@pytest.mark.parametrize("D", [10, 20])
def test_padded_rows_are_free_of_bank_conflicts(D):
    """S and t1 rows are padded to the odd MI|1 words: 32 lanes reading one
    column of 32 consecutive rows touch 32 banks (with MI words, even,
    they would share banks)."""
    MI = 2 * D
    for stride in (MI | 1, (2 * D) | 1):
        banks = {row * stride % 32 for row in range(32)}
        assert len(banks) == 32
    assert len({row * MI % 32 for row in range(32)}) < 32
    # a row tile of TM rows: lanes 32 tiles apart
    tm = fs._mpem3_staged_plan(D, 2, 2, D, D + 4, 4, "ijrmn")[3][2][0]
    assert len({(tm * t) * (MI | 1) % 32 for t in range(32)}) >= 32 // tm


def test_forced_kernels_that_cannot_run_raise():
    """The staged kernel forced on a strided view raises; at f32 D=32 both
    staged kernels fit (F 183 KiB a block of one instance, W 120 KiB); at
    D=40 the staged F kernel does not (60.5 + 221 KiB), so the pick is the
    first design (163 KiB), and forcing the staged one raises; at D=48
    neither F kernel fits."""
    with pytest.raises(ValueError, match="dense"):
        fs.mpem3_geometry(10, 2, 2, 10, 14, F32, None, "staged")
    for sl in (None, 36):
        assert fs.mpem3_geometry(32, 2, 2, 32, sl, F32, "ijrmn")[0] == \
            "staged"
    assert fs.mpem3_geometry(40, 2, 2, 40, 44, F32, "ijrmn")[0] == "base"
    assert fs.mpem3_geometry(40, 2, 2, 40, None, F32, "ijrmn")[0] == \
        "staged"
    with pytest.raises(ValueError, match="shared memory"):
        fs.mpem3_geometry(40, 2, 2, 40, 44, F32, "ijrmn", "staged")
    with pytest.raises(ValueError, match="shared memory"):
        fs.mpem3_staged_macros(40, 2, 2, 40, 44, F32, "ijrmn")
    for variant in (None, "staged", "base"):
        with pytest.raises(ValueError, match="shared memory"):
            fs.mpem3_geometry(48, 2, 2, 48, 52, F32, "ijrmn", variant)


@pytest.mark.parametrize("variant", [None, "staged", "base"])
def test_cpu_wrappers_run_the_plain_scans(variant):
    g = torch.Generator().manual_seed(0)
    Bn, S, Db, qi, qj, sr, sl = 3, 4, 3, 2, 2, 4, 6

    def r(*s):
        return torch.randn(s, generator=g, dtype=F64)
    B1 = r(S + 1, Bn, qi * qj * qi * Db * Db).reshape(
        S + 1, Bn, qi, qj, qi, Db, Db).permute(1, 0, 5, 6, 2, 3, 4)[:, 1:]
    Psi, Phi, S0 = r(S, sr, sr, qi, qj), r(S, sl, sl, qi, qj), r(Bn, sl, Db,
                                                                 qi)
    before = (fs.mpem3_wscan.launches, dict(fs.mpem3_wscan.variant_launches),
              fs.mpem3_fscan.launches, dict(fs.mpem3_fscan.variant_launches))
    Ws = fs.mpem3_wscan(B1, Psi, _variant=variant)
    assert torch.equal(Ws, fs.mpem3_wscan_plain(B1, Psi))
    out = fs.mpem3_fscan(B1, Phi, Ws, S0, _variant=variant)
    for a, b in zip(out, fs.mpem3_fscan_plain(B1, Phi, Ws, S0)):
        assert torch.equal(a, b)
    assert (fs.mpem3_wscan.launches, fs.mpem3_wscan.variant_launches,
            fs.mpem3_fscan.launches, fs.mpem3_fscan.variant_launches) == \
        before


def test_probe_builds_both_scans_of_each_conversion():
    """The probe's targets: the staged W and F builds of each conversion
    (``--gt`` overrides the threads an instance), with the clock counters
    as one more macro."""
    for name, n, qj, layout in probe_mpem3.LAUNCHES:
        (sw, mw), (sf, mf) = probe_mpem3.targets(10, qj, layout)
        assert sw == sf == "mpem3_staged"
        assert "M3_SL=0" in mw and "M3_SL=14" in mf
        assert f"M3_QJ={qj}" in mf
        _, mg = probe_mpem3.targets(10, qj, layout, 64)[1]
        assert "M3_GT=64" in mg
        _, mc = probe_mpem3.targets(10, qj, layout, None, ("M3_CLOCKS=1",))[1]
        assert mc[-1] == "M3_CLOCKS=1"
    assert probe_mpem3.shape(20, 1) == (20, 2, 1, 20, 24)
