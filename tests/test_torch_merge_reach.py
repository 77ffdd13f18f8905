"""The merge scans' reach: every shape the JAX package merges has a kernel.

The pure :func:`merge_f_geometry` and :func:`merge_w_geometry` return a
kernel, without raising, anywhere in the envelope (DL, DB, sr <= 32, sl =
min(sr + 4, DL * DB), 2 <= Y <= 17, q in {2, 3}, f32 and f64, one shared or
one per-step ``Pyy``); the wide kernels (``csrc/merge_wide.cu``, one
instance over a cluster) take the shapes no single block holds where a
cluster of up to 8 blocks does, and the streamed kernels
(``csrc/merge_streamed.cu``) exactly the rest, so every shape that fitted
before keeps its kernel; the streamed workspace is sized by the blocks
resident on the card, not by the instances.  And the port's merge at
such shapes (the plain scans on the CPU) against the JAX package's XLA
merge on the same inputs and sketches, at the tensors the cores represent
(f64, 1e-8 of their max-abs).  The kernels themselves run on the card only
(``tests/test_torch_gpu.py -k streamed``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matrixproductbp_tpu.ops import stta as jstta
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from test_torch_stta import JaxSketches, _assert_same_trains

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
# bonds of the envelope's grid: small, both sides of every shared-memory
# kernel's limit, and its edge
BONDS = (1, 2, 5, 8, 12, 16, 17, 20, 21, 24, 28, 32)


def _envelope():
    """(DL, DB, Y, sr, sl) over the grid: Y = 2 to 17, every DL, DB of
    BONDS, each sketch sr = min(D, DL * DB) of a merge to a bond D of
    BONDS."""
    for Y in range(2, 18):
        for DL in BONDS:
            for DB in BONDS:
                for sr in sorted({min(D, DL * DB) for D in BONDS}):
                    yield DL, DB, Y, sr, min(sr + 4, DL * DB)


def _fits(geometry, *args):
    try:
        geometry(*args)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("tv", [False, True], ids=["shared", "per_step"])
@pytest.mark.parametrize("q", [2, 3])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_envelope_has_a_kernel_everywhere(dtype, q, tv):
    """Both geometries return a kernel at every shape of the grid, DL != DB
    included; "streamed" exactly where no shared-memory kernel fits, the
    wide cluster kernel included (where one does, the pick is the one it
    was before the streamed kernels, or "wide" where only a cluster
    holds the step)."""
    for DL, DB, Y, sr, sl in _envelope():
        f, f_threads, f_smem = fs.merge_f_geometry(DL, DB, Y, q, sr, sl,
                                                   dtype, tv=tv)
        w, w_threads, w_smem = fs.merge_w_geometry(DL, DB, Y, q, sr, dtype)
        assert max(f_smem, w_smem) <= fs.SMEM_LIMIT
        f_fits = any(_fits(fs.merge_f_geometry, DL, DB, Y, q, sr, sl, dtype,
                           v, tv) for v in ("staged", "cluster", "base",
                                            "wide"))
        assert (f == "streamed") != f_fits, (DL, DB, Y, q, sr, sl)
        w_fits = any(_fits(fs.merge_w_geometry, DL, DB, Y, q, sr, dtype, v)
                     for v in ("base", "wide")) or (
            dtype == F32 and (Y, q) == (2, 2)
            and fs._merge_w_staged_plan(DL, DB, Y, q, sr, 4) is not None)
        assert (w == "streamed") != w_fits, (DL, DB, Y, q, sr)
        assert f != "streamed" or f_threads == 256
        assert w != "streamed" or w_threads == 256


# (DL, DB, Y, q, sr, sl, dtype) -> (merge F, merge W) picks, as before the
# streamed kernels: the D=10 and D=18 SIS merges, the Glauber K8 bucket at
# D=10 and K2 at D=18, the f64 merge at D=15, SIRS at D=20; and the shapes
# that raised before: f64 at D=16 (merge_w_kernel still fits), 18, 20 and
# 20 x 12, f32 at D=21 and 24, and Y = 5, 9, 10 at D=18 with a dense Pyy
# (the wide cluster kernels take those a cluster holds; the Glauber
# buckets' banded merges, all wide, in tests/test_torch_merge_wide.py)
PICKS = [
    ((10, 10, 2, 2, 10, 14, F32), ("staged", "staged")),
    ((18, 18, 2, 2, 18, 22, F32), ("cluster", "staged")),
    ((10, 10, 9, 2, 10, 14, F32), ("cluster", "base")),
    ((18, 18, 3, 2, 18, 22, F32), ("cluster", "base")),
    ((15, 15, 2, 2, 15, 19, F64), ("cluster", "base")),
    ((20, 20, 2, 3, 20, 24, F32), ("base", "base")),
    ((16, 16, 2, 2, 16, 20, F64), ("wide", "base")),
    ((18, 18, 2, 2, 18, 22, F64), ("wide", "wide")),
    ((20, 20, 2, 2, 20, 24, F64), ("wide", "wide")),
    ((20, 12, 2, 2, 20, 24, F64), ("wide", "wide")),
    ((21, 21, 2, 2, 21, 25, F32), ("wide", "wide")),
    ((24, 24, 2, 3, 24, 28, F32), ("wide", "wide")),
    ((18, 18, 5, 2, 18, 22, F32), ("wide", "wide")),
    ((18, 18, 9, 2, 18, 22, F32), ("streamed", "streamed")),
    ((18, 18, 10, 2, 18, 22, F32), ("streamed", "streamed")),
]


@pytest.mark.parametrize("shape,picks", PICKS,
                         ids=[f"{s[0]}x{s[1]}-Y{s[2]}-q{s[3]}-{str(s[6])[6:]}"
                              for s, _ in PICKS])
def test_picks_at_the_sweeps_shapes(shape, picks):
    assert (fs.merge_f_geometry(*shape)[0],
            fs.merge_w_geometry(*shape[:5], shape[6])[0]) == picks


def test_forced_kernels_raise_where_they_do_not_fit():
    """A forced shared-memory kernel still raises past its limit; the
    streamed ones take any shape but those whose buffers outgrow their
    32-bit sizes, and empty axes."""
    dims = (24, 24, 2, 2, 24, 28)
    for v in ("staged", "cluster", "base"):
        with pytest.raises(ValueError, match="shared memory"):
            fs.merge_f_geometry(*dims, F32, v)
    for v in ("staged", "base"):
        with pytest.raises(ValueError, match="shared memory"):
            fs.merge_w_geometry(*dims[:5], F32, v)
    assert fs.merge_f_geometry(4, 3, 2, 2, 5, 9, F64, "streamed")[0] == \
        "streamed"
    with pytest.raises(ValueError, match="32-bit|elements"):
        fs.merge_f_geometry(512, 512, 17, 3, 512, 516, F32)
    with pytest.raises(ValueError, match="empty axis"):
        fs.merge_w_geometry(0, 4, 2, 2, 4, F32, "streamed")


@pytest.mark.parametrize("kind", ["w", "f"])
def test_streamed_workspace_is_bounded_by_the_resident_blocks(kind):
    """The workspace is blocks x a block's buffers, at most two blocks an
    SM: the same for a million instances as for ten million, and one block
    an instance below that."""
    dims = (18, 18, 10, 2, 18, 22)
    per = sum(fs._streamed_buffers(kind, *dims))
    for Bn in (10 ** 6, 10 ** 7):
        assert fs.merge_streamed_plan(kind, *dims, Bn, 132) == (264, per)
    assert fs.merge_streamed_plan(kind, *dims, 3, 132) == (3, per)
    # f32 Glauber K8 at D=18 on 132 SMs: ~0.4 GB (merge W), whatever Bn
    assert 264 * per * 4 < 0.5e9
    if kind == "w":
        nW, nT = 18 * 18 * 18, 18 * 10 * 18 * 18
        assert per == nW + 2 * nT + (10 * 18) ** 2
    else:
        nS = 22 * 18 * 18
        assert per == 18 * 18 * 18 + 2 * nS + 2 * nS * 10 + (18 * 10) ** 2


# the port's merge against the JAX package's XLA merge (merge_stta_batched)
# at two shapes the shared-memory kernels refuse: the Glauber K9 bucket's
# banded merge (Y=10, yy_off=0) at D=18, and an f64 merge to D=20 of a
# bond-20 train with a bond-12 one; Bn=2, T1=4, f64
JAX_CASES = {"banded-y10-d18": (18, 18, 10, 20, 0),
             "dense-y2-20x12": (20, 12, 2, 20, None)}


def _inputs(name):
    DL, DB, Y, Dout, off = JAX_CASES[name]
    rng = np.random.default_rng(17)
    Bn, T1, q = 2, 4, 2
    Lc = rng.normal(size=(Bn, T1, DL, DL, Y * q))
    Bc = rng.normal(size=(Bn, T1, DB, DB, Y * q))
    Llz, Blz = rng.normal(size=(Bn,)), rng.normal(size=(Bn,))
    pyy = (np.zeros((1, 1, 1, q)) if off is not None
           else rng.random((Y, Y, Y, q)))
    return (Lc, Llz, Bc, Blz, pyy), (Dout, Y, q), off


@pytest.fixture(scope="module")
def jax_merges():
    """Each case's JAX merge (cores, logz), computed once."""
    out = {}
    for name in JAX_CASES:
        args, (Dout, Y, q), off = _inputs(name)
        out[name] = jstta.merge_stta_batched(
            *(jnp.asarray(a) for a in args), Dout, Y, q,
            jax.random.PRNGKey(17), yy_off=off)
    return out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_merge_at_streamed_shapes_matches_jax(name, jax_merges):
    args, (Dout, Y, q), off = _inputs(name)
    DL, DB = args[0].shape[2], args[2].shape[2]
    sr = min(Dout, DL * DB)
    shape = (DL, DB, Y, q, sr, min(sr + 4, DL * DB))
    shared = ("staged", "cluster", "base")
    assert fs.merge_f_geometry(*shape, F64, band=off is not None)[0] \
        not in shared
    assert fs.merge_w_geometry(*shape[:5], F64, band=off is not None)[0] \
        not in shared
    out = fs.merge_stta_fused(*(torch.as_tensor(a) for a in args), Dout, Y,
                              q, sketches=JaxSketches(), yy_off=off)
    jc, jz = jax_merges[name]
    _assert_same_trains(out, (np.asarray(jc), np.asarray(jz)),
                        logz_tol=1e-3)


def test_probe_variants_apply_to_the_kernel_source():
    """Every text that ``tools/probe_merge_streamed.py --attribute`` leaves
    out is in ``merge_streamed.cu`` exactly once."""
    from matrixproductbp_tpu_torch.tools import probe_merge_streamed as probe
    with open(probe.SOURCE) as fh:
        text = fh.read()
    for name, edits in probe.VARIANTS.items():
        assert probe.variant_source(text, edits) != text, name
    with pytest.raises(RuntimeError, match="exactly once"):
        probe.variant_source(text, [("no such line", "")])
