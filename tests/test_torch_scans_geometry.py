"""Which merge F kernel ``merge_fscan`` launches, decided on the CPU by the
pure :func:`merge_f_geometry`: the staged kernel for the f32 sketch merges
up to D=15 (the D=10 bench shape included), ``merge_f_kernel`` from D=16
(D=20 at the bench), every shape of the sketch sweeps up to D=20 under the
shared-memory limit, ``ValueError`` above it; the macros each staged build
takes, and the library each is cached as.  Also: on the CPU the wrapper
runs the plain scan whatever kernel is asked for, every line that
``tools/probe_merge_f.py`` replaces still exists in its kernel, and the
shared-memory wavefront model counts bank conflicts as the hardware
serialises them."""
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


def test_d20_bench_shape_takes_the_base_kernel():
    dims = _sweep_dims(20, 20, 20)
    assert dims == (20, 20, 2, 2, 20, 24)
    variant, threads, smem = fs.merge_f_geometry(*dims, F32)
    assert (variant, threads) == ("base", 768)
    assert smem == 4 * fs._smem_merge_f(*dims)
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_f_geometry(*dims, F32, variant="staged")


@pytest.mark.parametrize("D", range(2, 21))
def test_sketch_merge_kernel_by_bond(D):
    """Staged up to D=15, built for as many blocks an SM as its shared
    memory allows (3 up to D=10, 2 at D=11, 1 above); base from D=16."""
    dims = _sweep_dims(D, D, D)
    variant, threads, smem = fs.merge_f_geometry(*dims, F32)
    assert variant == ("staged" if D <= 15 else "base")
    assert fs.merge_f_geometry(*dims, F32, variant="base")[0] == "base"
    if variant == "staged":
        macros = fs.merge_f_staged_macros(*dims, F32)
        minb = 3 if D <= 10 else 2 if D == 11 else 1
        assert macros == ("MF_T=float", f"MF_DL={D}", f"MF_DB={D}", "MF_Y=2",
                          "MF_Q=2", f"MF_SR={D}", f"MF_SL={dims[5]}",
                          f"MF_MINB={minb}")
        assert minb * (smem + 1024) <= 228 * 1024
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fs.merge_f_staged_macros(*dims, F32)


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


@pytest.mark.parametrize("D", [4, 8, 10, 12, 16, 20])
def test_every_sketch_sweep_shape_fits(D):
    for DL in range(1, D + 1):
        for DB in range(1, D + 1):
            variant, threads, smem = fs.merge_f_geometry(
                *_sweep_dims(D, DL, DB), F32)
            assert smem <= fs.SMEM_LIMIT
            assert threads in (256, 768)
            if D <= 15:
                assert variant == "staged"


def test_shape_over_the_limit_raises():
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_f_geometry(*_sweep_dims(40, 40, 40), F32)
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_f_geometry(*_sweep_dims(20, 20, 20), F64)


@pytest.mark.parametrize("variant", [None, "staged", "base"])
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
