"""Which merge F kernel ``merge_fscan`` launches, decided on the CPU by the
pure :func:`merge_f_geometry`: the staged kernel for the f32 sketch merges
up to D=15 (the D=10 bench shape included), the cluster kernel from D=16
to D=20 (D=20 at the bench), ``merge_f_kernel`` where neither fits, every
shape of the sketch sweeps up to D=20 under the shared-memory limit, the
streamed kernel above it (``ValueError`` where a shared-memory kernel is
forced there); the macros each per-shape build takes, and the
library each is cached as.  Also: on the CPU the wrapper runs the plain
scan whatever kernel is asked for, every line that
``tools/probe_merge_f.py`` replaces still exists in its kernel, and the
shared-memory wavefront model counts bank conflicts as the hardware
serialises them, and distributed shared-memory loads apart."""
import pytest
import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.tools import model_merge_f_smem, probe_merge_f

F32, F64 = torch.float32, torch.float64


def _sweep_dims(D, DL, DB, Y=2, q=2, oversample=4):
    """(DL, DB, Y, q, sr, sl) of a sketch merge to bond D, as
    ``stta.merge_sketch`` sizes it."""
    sr = min(D, DL * DB)
    return DL, DB, Y, q, sr, min(sr + oversample, DL * DB)


def test_d10_bench_shape_takes_the_staged_kernel():
    variant, threads, smem = fs.merge_f_geometry(*_sweep_dims(10, 10, 10),
                                                 F32)
    assert (variant, threads) == ("staged", 256)
    # three blocks of 256 threads share an SM: 3 x (smem + 1 KiB) <= 228 KiB
    assert smem == 4 * fs._smem_merge_f_staged(10, 10, 2, 2, 10, 14, 4)
    assert 3 * (smem + 1024) <= 228 * 1024


def test_d20_bench_shape_takes_the_cluster_kernel():
    dims = _sweep_dims(20, 20, 20)
    assert dims == (20, 20, 2, 2, 20, 24)
    variant, threads, smem = fs.merge_f_geometry(*dims, F32)
    assert (variant, threads) == ("cluster", 480)
    assert smem == 4 * fs._smem_merge_f_cluster(*dims, 4)
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_f_geometry(*dims, F32, variant="staged")
    # merge_f_kernel still takes it when forced
    assert fs.merge_f_geometry(*dims, F32, variant="base") == (
        "base", 768, 4 * fs._smem_merge_f(*dims))


def test_cluster_shared_memory_by_hand_at_d20():
    """The cluster kernel's buffers a block at the D=20 sketch merge, f32
    (DL = DB = sr = 20, Y = q = 2, sl = 24; rows e split 12 and 12): W_t
    and W_{t+1} 2*8000, L_t and B_t for two steps 2*(1600 + 1600), S
    12*401, t1 of one x 12*20*41, t2 of one x 2*12*400, Bp 20*2*20*4, Phi_t
    for two steps 2*24*24*4, Pyy 16, M 12*20, N 12*4*20."""
    by_hand = (2 * 8000 + 2 * (1600 + 1600) + 12 * 401 + 12 * 20 * 41
               + 2 * 12 * 400 + 20 * 2 * 20 * 4 + 2 * 24 * 24 * 4 + 16
               + 12 * 20 + 12 * 4 * 20)
    assert by_hand == 55676
    assert fs._smem_merge_f_cluster(20, 20, 2, 2, 20, 24, 4) == by_hand
    assert 4 * by_hand <= fs.SMEM_LIMIT
    # odd sl: both blocks' buffers are sized for the larger half
    assert fs._smem_merge_f_cluster(17, 17, 2, 2, 17, 21, 4) == \
        fs._smem_merge_f_cluster(17, 17, 2, 2, 17, 22, 4) - (
            2 * (22 * 22 - 21 * 21) * 4)


def test_base_kernel_takes_what_neither_fits():
    """merge_f_kernel keeps the shapes neither per-shape kernel takes, such
    as a leaf's merge (DL=1) with a wide B and Y=4, in f32."""
    dims = (1, 30, 4, 2, 20, 24)
    assert fs.merge_f_geometry(*dims, F32)[0] == "base"
    for v in ("staged", "cluster"):
        with pytest.raises(ValueError, match="shared memory"):
            fs.merge_f_geometry(*dims, F32, variant=v)


@pytest.mark.parametrize("D", range(2, 21))
def test_sketch_merge_kernel_by_bond(D):
    """Staged up to D=15, built for as many blocks an SM as its shared
    memory allows (3 up to D=10, 2 at D=11, 1 above); cluster from D=16 to
    D=20, one block an SM."""
    dims = _sweep_dims(D, D, D)
    variant, threads, smem = fs.merge_f_geometry(*dims, F32)
    assert variant == ("staged" if D <= 15 else "cluster")
    assert fs.merge_f_geometry(*dims, F32, variant="base")[0] == "base"
    shape = ("MF_T=float", f"MF_DL={D}", f"MF_DB={D}", "MF_Y=2", "MF_Q=2",
             f"MF_SR={D}", f"MF_SL={dims[5]}")
    if variant == "staged":
        macros = fs.merge_f_staged_macros(*dims, F32)
        minb = 3 if D <= 10 else 2 if D == 11 else 1
        assert macros == shape + (f"MF_MINB={minb}",)
        assert minb * (smem + 1024) <= 228 * 1024
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fs.merge_f_staged_macros(*dims, F32)
        assert threads == 480
        assert fs.merge_f_cluster_macros(*dims, F32) == shape + ("MF_MINB=1",)
        assert 2 * (smem + 1024) > 228 * 1024


def test_staged_builds_are_cached_by_shape():
    """Each (shape, dtype) has a library of its own; the per-shape source
    needs its macros and the others take none."""
    m10 = fs.merge_f_staged_macros(*_sweep_dims(10, 10, 10), F32)
    m10d = fs.merge_f_staged_macros(*_sweep_dims(10, 10, 10), F64)
    m8 = fs.merge_f_staged_macros(*_sweep_dims(8, 8, 8), F32)
    libs = {build._paths("merge_f_staged", m)[1] for m in (m10, m10d, m8)}
    assert len(libs) == 3
    assert build._paths("merge_f_staged", m10) == \
        build._paths("merge_f_staged", m10)
    assert "merge_f_staged" not in build.SOURCES
    with pytest.raises(ValueError, match="macros"):
        build._target("merge_f_staged")
    with pytest.raises(ValueError, match="macros"):
        build._target(("stta_scans", m10))


def test_cluster_builds_are_cached_by_shape():
    """The cluster source, like the staged one, is built once per (shape,
    dtype); the same sizes give the staged and the cluster source libraries
    of their own; build_merge_f builds the kernel each shape takes."""
    m20 = fs.merge_f_cluster_macros(*_sweep_dims(20, 20, 20), F32)
    m16 = fs.merge_f_cluster_macros(*_sweep_dims(16, 16, 16), F32)
    m10d = fs.merge_f_cluster_macros(*_sweep_dims(10, 10, 10), F64)
    libs = {build._paths("merge_f_cluster", m)[1] for m in (m20, m16, m10d)}
    assert len(libs) == 3
    assert build._paths("merge_f_cluster", m20) == \
        build._paths("merge_f_cluster", m20)
    m10 = fs.merge_f_cluster_macros(*_sweep_dims(10, 10, 10), F32)
    assert build._paths("merge_f_cluster", m10)[1] != \
        build._paths("merge_f_staged", m10)[1]
    assert "merge_f_cluster" in build.PER_SHAPE
    assert "merge_f_cluster" not in build.SOURCES
    with pytest.raises(ValueError, match="macros"):
        build._target("merge_f_cluster")
    assert fs._merge_f_target("cluster", (*_sweep_dims(20, 20, 20), F32)) \
        == ("merge_f_cluster", m20)


@pytest.mark.parametrize("D", [4, 8, 10, 12, 16, 20])
def test_every_sketch_sweep_shape_fits(D):
    for DL in range(1, D + 1):
        for DB in range(1, D + 1):
            variant, threads, smem = fs.merge_f_geometry(
                *_sweep_dims(D, DL, DB), F32)
            assert smem <= fs.SMEM_LIMIT
            assert threads in (256, 480, 768)
            if D <= 15:
                assert variant == "staged"
            else:
                assert variant in ("staged", "cluster")


def test_shape_over_the_limit_raises():
    """Past the shared-memory limit each of the three single-block kernels
    raises where it is forced; unforced, the wide cluster kernel takes the
    shape where a cluster holds it (f64 D=20), the streamed kernel beyond
    (f32 D=40)."""
    for dims, dtype, want in ((_sweep_dims(40, 40, 40), F32, "streamed"),
                              (_sweep_dims(20, 20, 20), F64, "wide")):
        for v in ("staged", "cluster", "base"):
            with pytest.raises(ValueError, match="shared memory"):
                fs.merge_f_geometry(*dims, dtype, variant=v)
        assert fs.merge_f_geometry(*dims, dtype)[0] == want


@pytest.mark.parametrize("variant", [None, "staged", "base", "cluster",
                                     "streamed"])
def test_cpu_wrapper_runs_the_plain_scan(variant):
    g = torch.Generator().manual_seed(0)
    Bn, S, DL, DB, Y, q, sr, sl = 3, 2, 3, 2, 2, 2, 4, 6

    def r(*s):
        return torch.randn(s, generator=g, dtype=F64)
    L1, B1 = r(Bn, S, DL, DL, Y, q), r(Bn, S, DB, DB, Y, q)
    args = (L1, B1, torch.rand((Y, Y, Y, q), generator=g, dtype=F64),
            r(S, sl, sl, Y, q), r(Bn, S, DL, DB, sr), r(Bn, sl, DL, DB))
    before = fs.merge_fscan.launches, dict(fs.merge_fscan.variant_launches)
    out = fs.merge_fscan(*args, _variant=variant)
    ref = fs.merge_fscan_plain(*args)
    assert all(torch.equal(o, p) for o, p in zip(out, ref))
    assert (fs.merge_fscan.launches,
            fs.merge_fscan.variant_launches) == before


def test_probe_variants_apply_to_the_kernel_source():
    texts = probe_merge_f.read_sources()
    sources = probe_merge_f.variant_sources(texts)
    assert set(sources) == set(probe_merge_f.VARIANTS)
    for name, src in sources.items():
        assert src != texts[probe_merge_f.VARIANTS[name][0]]
    staged = "merge_f_staged_kernel"
    with pytest.raises(RuntimeError, match="staged_without_t1"):
        probe_merge_f.variant_sources({**texts, staged: texts[staged].replace(
            "(Sb, Lc, t1, g1)", "(Sb, Lc,t1, g1)")})


@pytest.mark.parametrize("stride,waves", [(1, 1), (2, 2), (32, 32), (33, 1)])
def test_smem_model_counts_bank_conflicts(stride, waves):
    """32 lanes each load one row of A (row stride ``stride`` words) and the
    same word of B: the A load costs the most distinct words one bank holds
    (consecutive or odd strides one wavefront, a stride of 32 all 32), the
    B load is a broadcast."""
    tasks, loads, total = model_merge_f_smem.wavefronts(
        32, 1, 1, 1, 1, stride, 1, 0, 0, 1, 1, 0, 0, TM=1, TN=1)
    assert (tasks, loads, total) == (32, 2, waves + 1)


@pytest.mark.parametrize("rows_fastest,waves", [(False, 1), (True, 32)])
def test_smem_model_counts_task_order(rows_fastest, waves):
    """1024 tasks of 1x1 tiles over a 32 x 32 output, A's rows 32 words
    apart: with the column tile fastest each warp shares one row of A (a
    broadcast) and reads 32 neighbouring words of B; with the row tile
    fastest its 32 rows of A all sit in one bank and B is a broadcast."""
    tasks, loads, total = model_merge_f_smem.wavefronts(
        32, 32, 1, 1, 1, 32, 1, 0, 0, 1, 1, 0, 0, TM=1, TN=1,
        rows_fastest=rows_fastest)
    assert (tasks, loads, total) == (1024, 64, 32 * (waves + 1))


def test_smem_model_counts_cluster_exchange_apart():
    """At the D=20 sketch merge the model counts merge_f_kernel and the
    cluster kernel (the staged one does not fit); the cluster kernel's
    first block reads each of its 12 x 400 outputs once from its peer's
    shared memory, each warp-wide remote load within 128 bytes (4
    sectors)."""
    counts = model_merge_f_smem.count(model_merge_f_smem.sketch_dims(20))
    assert set(counts) == {"merge_f_kernel", "merge_f_cluster_kernel"}
    loads, words, sectors = counts["merge_f_cluster_kernel"]["dsmem"]
    assert words == 12 * 400
    assert sectors <= 4 * loads
    assert set(model_merge_f_smem.count()) == {
        "merge_f_kernel", "merge_f_staged_kernel", "merge_f_cluster_kernel"}
