"""Which merge W kernel ``merge_wscan`` launches, decided on the CPU by the
pure :func:`merge_w_geometry`: the staged kernel (``merge_w_staged.cu``,
built per shape) for the f32 sketch merges (the D=10 and D=20 bench shapes
included, one chunk of rows n up to D=17, two at D=20), ``merge_w_kernel``
for f64, Y=3 and the shapes whose staged buffers do not fit, the streamed
kernel where neither fits, ``ValueError`` where the forced kernel does not
fit; its shared-memory sum, summed by hand
at D=20; the macros each build takes and the library each is cached as.
Also: on the CPU the wrapper runs the plain scan whatever kernel is asked
for and counts no launch, every line ``tools/probe_merge_w.py`` replaces
still exists in its kernel, and ``tools/model_merge_w_smem.py`` counts the
staged kernel's loads as its tiles issue them and vector loads by the
words they touch."""
import pytest
import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.tools import model_merge_w_smem, probe_merge_w

F32, F64 = torch.float32, torch.float64


def _sweep_dims(D, DL, DB, Y=2, q=2):
    """(DL, DB, Y, q, sr) of a sketch merge to bond D, as
    ``stta.merge_sketch`` sizes it."""
    return DL, DB, Y, q, min(D, DL * DB)


@pytest.mark.parametrize("D,threads,blocks", [(10, 128, 4), (20, 416, 1)])
def test_bench_shapes_take_the_staged_kernel(D, threads, blocks):
    dims = _sweep_dims(D, D, D)
    variant, nt, smem = fs.merge_w_geometry(*dims, F32)
    assert (variant, nt) == ("staged", threads)
    plan = fs._merge_w_staged_plan(*dims, 4)
    assert smem == 4 * plan[4]
    # as many blocks an SM as their shared memory allows (at most 4)
    assert blocks * (smem + 1024) <= 228 * 1024
    assert blocks == 4 or (blocks + 1) * (smem + 1024) > 228 * 1024
    # merge_w_kernel still takes it when forced
    assert fs.merge_w_geometry(*dims, F32, "base") == (
        "base", fs._merge_threads(4 * fs._smem_merge_w(*dims)),
        4 * fs._smem_merge_w(*dims))


def test_staged_shared_memory_by_hand_at_d20():
    """The staged kernel's buffers at the D=20 sketch merge, f32 (DL = DB =
    sr = 20, Y = q = 2; two chunks of 10 rows n), each rounded up to 16
    bytes: W 20*402, L_t for two steps 2*20*84, B_t for two steps 2*20*81,
    Th_t for two steps 2*2*2*20*40, t1 of a chunk 2*(10*20*41 + 1) rounded
    up to 16404, u of a chunk 10*4*402."""
    by_hand = (20 * 402 + 2 * 20 * 84 + 2 * 20 * 81 + 2 * 2 * 2 * 20 * 40
               + 16404 + 10 * 4 * 402)
    assert by_hand == 53524
    assert fs._smem_merge_w_staged(20, 20, 2, 2, 20, 10, 4) == by_hand
    assert fs._merge_w_chunk(20, 20, 2, 2, 20, 4) == 10
    assert 4 * by_hand <= fs.SMEM_LIMIT
    # one chunk of 20 rows would need 323 KiB
    assert 4 * fs._smem_merge_w_staged(20, 20, 2, 2, 20, 20, 4) > \
        fs.SMEM_LIMIT


def test_macros_at_the_bench_shapes():
    shape = ("MW_T=float", "MW_DL=20", "MW_DB=20", "MW_Y=2", "MW_Q=2",
             "MW_SR=20")
    assert fs.merge_w_staged_macros(20, 20, 2, 2, 20, F32) == shape + (
        "MW_NC=10", "MW_NT=416", "MW_MINB=1", "MW_AM=4", "MW_AN=10",
        "MW_BM=4", "MW_BN=10", "MW_CM=4", "MW_CN=5")
    m10 = fs.merge_w_staged_macros(10, 10, 2, 2, 10, F32)
    assert m10[:9] == ("MW_T=float", "MW_DL=10", "MW_DB=10", "MW_Y=2",
                       "MW_Q=2", "MW_SR=10", "MW_NC=10", "MW_NT=128",
                       "MW_MINB=4")


@pytest.mark.parametrize("D", range(2, 21))
def test_sketch_merge_kernel_by_bond(D):
    """Every f32 sketch merge to D=20 takes the staged kernel; W2's
    register tiles cover it with one tile a thread; t1 and u are formed in
    as few chunks of rows n as fit (one up to D=17, two above)."""
    dims = _sweep_dims(D, D, D)
    variant, threads, smem = fs.merge_w_geometry(*dims, F32)
    assert variant == "staged" and smem <= fs.SMEM_LIMIT
    nc, blocks, nt, tiles, _ = fs._merge_w_staged_plan(*dims, 4)
    assert nt == threads == fs._MERGE_W_THREADS[blocks]
    assert nc == (D if D <= 17 else -(-D // 2))
    CM, CN = tiles[4:]
    assert -(-D // CM) * -(-(D * D) // CN) <= threads
    assert all(t >= 1 for t in tiles)
    macros = dict(m.split("=") for m in fs.merge_w_staged_macros(*dims,
                                                                 F32))
    assert int(macros["MW_NC"]) == nc and int(macros["MW_MINB"]) == blocks


@pytest.mark.parametrize("D", [4, 10, 16, 20])
def test_every_sketch_sweep_shape_takes_the_staged_kernel(D):
    for DL in range(1, D + 1):
        for DB in range(1, D + 1):
            variant, threads, smem = fs.merge_w_geometry(
                *_sweep_dims(D, DL, DB), F32)
            assert variant == "staged" and smem <= fs.SMEM_LIMIT
            assert threads in fs._MERGE_W_THREADS.values()


def test_f64_and_y3_take_the_base_kernel():
    assert fs.merge_w_geometry(10, 10, 2, 2, 10, F64)[0] == "base"
    assert fs.merge_w_geometry(4, 3, 2, 2, 5, F64)[0] == "base"
    assert fs.merge_w_geometry(3, 3, 3, 2, 4, F32)[0] == "base"
    # forced, the staged kernel takes the small f64 and Y=3 shapes
    assert fs.merge_w_geometry(4, 3, 2, 2, 5, F64, "staged")[0] == "staged"
    assert fs.merge_w_geometry(3, 3, 3, 2, 4, F32, "staged")[0] == "staged"


def test_forced_kernel_that_does_not_fit_raises():
    # a leaf's merge (DL=1) with a wide B, Y=4 and sr=24: Th_t,
    # double-buffered, alone needs 288 KiB of the staged kernel;
    # merge_w_kernel fits
    dims = (1, 30, 4, 2, 24)
    assert fs.merge_w_geometry(*dims, F32)[0] == "base"
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_w_geometry(*dims, F32, "staged")
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_w_staged_macros(*dims, F32)
    # D=24 in f32 and D=20 in f64: neither single-block kernel fits, and
    # the wide cluster kernel takes the shape (D=40: the streamed kernel)
    for dims, dtype, want in (((24, 24, 2, 2, 24), F32, "wide"),
                              ((20, 20, 2, 2, 20), F64, "wide"),
                              ((40, 40, 2, 2, 40), F32, "streamed")):
        for variant in ("staged", "base"):
            with pytest.raises(ValueError, match="shared memory"):
                fs.merge_w_geometry(*dims, dtype, variant)
        assert fs.merge_w_geometry(*dims, dtype)[0] == want


def test_staged_builds_are_cached_by_shape():
    """Each (shape, dtype) has a library of its own; the staged source
    needs its macros; build_merge_w builds the staged kernel's shapes."""
    m20 = fs.merge_w_staged_macros(20, 20, 2, 2, 20, F32)
    m10 = fs.merge_w_staged_macros(10, 10, 2, 2, 10, F32)
    m10d = fs.merge_w_staged_macros(10, 10, 2, 2, 10, F64)
    libs = {build._paths("merge_w_staged", m)[1] for m in (m20, m10, m10d)}
    assert len(libs) == 3
    assert build._paths("merge_w_staged", m20) == \
        build._paths("merge_w_staged", m20)
    assert "merge_w_staged" in build.PER_SHAPE
    assert "merge_w_staged" not in build.SOURCES
    with pytest.raises(ValueError, match="macros"):
        build._target("merge_w_staged")
    assert build._target(("merge_w_staged", m20)) == ("merge_w_staged", m20)


@pytest.mark.parametrize("variant", [None, "staged", "base", "streamed"])
def test_cpu_wrapper_runs_the_plain_scan(variant):
    g = torch.Generator().manual_seed(0)
    Bn, S, DL, DB, Y, q, sr = 3, 3, 3, 2, 2, 2, 4

    def r(*s):
        return torch.randn(s, generator=g, dtype=F64)
    L1 = r(Bn, S + 1, DL, DL, Y, q)[:, 1:]
    B1 = r(Bn, S + 1, DB, DB, Y, q)[:, 1:]
    Th = r(S, sr, sr, Y, Y, q)
    before = fs.merge_wscan.launches, dict(fs.merge_wscan.variant_launches)
    out = fs.merge_wscan(L1, B1, Th, _variant=variant)
    assert torch.equal(out, fs.merge_wscan_plain(L1, B1, Th))
    assert (fs.merge_wscan.launches,
            fs.merge_wscan.variant_launches) == before


def test_probe_variants_apply_to_the_kernel_sources():
    texts = probe_merge_w.read_sources()
    sources = probe_merge_w.variant_sources(texts, probe_merge_w.VARIANTS)
    assert set(sources) == set(probe_merge_w.VARIANTS)
    for name, src in sources.items():
        assert src != texts[probe_merge_w.VARIANTS[name][0]]
    staged = "merge_w_staged_kernel"
    with pytest.raises(RuntimeError, match="staged_without_u"):
        probe_merge_w.variant_sources(
            {**texts, staged: texts[staged].replace("prod_u(t1, Tc, u);",
                                                    "prod_u(t1, Tc,u);")},
            probe_merge_w.VARIANTS)


@pytest.mark.parametrize("addrs,width,waves", [
    ([0] * 32, 1, 1), ([0] * 32, 4, 1), (range(32), 1, 1),
    (range(0, 64, 2), 2, 2), ([32 * i for i in range(32)], 1, 32),
    ([0, 4, 8, 12, 16, 20, 24, 28], 4, 1), ([0, 32], 4, 2)])
def test_smem_model_charges_vector_loads_by_words(addrs, width, waves):
    """A warp-wide access costs the most distinct words one bank holds:
    broadcasts one wavefront whatever their width, 32 lanes' pairs of
    neighbouring words two, a stride of 32 words all 32."""
    assert model_merge_w_smem._charge(list(addrs), width) == waves


def test_smem_model_counts_the_staged_loads_at_d10():
    """At D=10 (128 threads, 4 warps, one chunk of 10 rows n) each product
    issues its tile's loads every K step: t1 4 rows and 5 pairs over K=10,
    u 5 rows and 7 columns (an odd tile: no pairs) over K=20, W2 2 rows of
    L_t by fours and 5 columns over K=40; merge_w_kernel's counts are the
    merge F model's for its three block_gemm products."""
    counts = model_merge_w_smem.count(model_merge_w_smem.sketch_dims(10))
    staged = counts["merge_w_staged_kernel"]
    assert staged["t1"][1] == 4 * 10 * (4 + 5)
    assert staged["u"][1] == 4 * 20 * (5 + 7)
    assert staged["W2"][1] == 4 * (2 * 40 // 4 + 5 * 40)
    for name in ("t1", "u", "W2"):
        assert staged[name][2] >= staged[name][1]
    base = counts["merge_w_kernel"]
    assert set(base) == {"t1", "u", "W2", "total"}
    assert base["total"] > staged["total"]
