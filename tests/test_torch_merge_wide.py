"""The wide merge kernels' geometry and design, on the CPU.

``csrc/merge_wide.cu`` splits one merge instance over a thread-block
cluster: merge W by the rows m of W_t (each block's t1, u and W_t slice;
the slices all-gathered after each step), merge F by the sketch rows e
(each block's t1, t2, M and N; the S2 partials reduce-scattered after each
step), with a cluster-wide max-abs rescale; banded tables read Th's band
as ``psi[w] = Th[uw, vw]`` (u + v - off = w) and B_t along the band.
Here: the geometry picks the wide kernels at the Glauber D=18 buckets
(banded) and the f64 merges from D=16 to D=20, moves no earlier pick, and
leaves the streamed kernels the shapes no cluster holds; the build macros
are a pure function of the shape; and a plain-torch model of the cluster
split (each block's slice, the all-gather and reduce-scatter in rank
order, the band's pairs) reproduces the plain scans in f64.  The kernels
themselves run on the card (``tests/test_torch_gpu.py -k wide``).
"""
import numpy as np
import pytest
import torch

from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.ops import sumy
from matrixproductbp_tpu_torch.ops.stta import _onehot000
from matrixproductbp_tpu_torch.ops.tensortrain import _safe_scale

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


def _dims(D, Y, q=2):
    return (D, D, Y, q, D, D + 4)


# the Glauber ER D=18 sweep's K4, K8 and K9 buckets (banded), and the f64
# sketch merges at D = 16, 18, 20 and 20 x 12
GLAUBER_D18 = [_dims(18, Y) for Y in (5, 9, 10)]
F64_MERGES = [_dims(16, 2), _dims(18, 2), _dims(20, 2), (20, 12, 2, 2, 20, 24)]


@pytest.mark.parametrize("dims", GLAUBER_D18, ids=lambda d: f"Y{d[2]}")
def test_glauber_d18_buckets_take_the_wide_kernels(dims):
    assert fs.merge_f_geometry(*dims, F32, band=True)[0] == "wide"
    assert fs.merge_w_geometry(*dims[:5], F32, band=True)[0] == "wide"
    for kind in ("w", "f"):
        c = fs._wide_plan(kind, *dims[:5], dims[5] if kind == "f" else 0,
                          4, True)[0]
        assert c in fs._WIDE_CLUSTERS and c > 1


@pytest.mark.parametrize("dims", F64_MERGES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_f64_merges_take_the_wide_kernels(dims):
    assert fs.merge_f_geometry(*dims, F64)[0] == "wide"
    # merge_w_kernel still holds the f64 merge at D=16
    want_w = "base" if dims[:2] == (16, 16) else "wide"
    assert fs.merge_w_geometry(*dims[:5], F64)[0] == want_w


def _grid():
    for Y in (2, 3, 5, 9, 10, 13):
        for DL, DB in ((4, 4), (10, 10), (12, 16), (16, 16), (18, 18),
                       (20, 20), (20, 12), (24, 24), (28, 28)):
            for D in (8, 16, 20):
                sr = min(D, DL * DB)
                yield DL, DB, Y, sr, min(sr + 4, DL * DB)


@pytest.mark.parametrize("band", [False, True], ids=["dense", "band"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_no_earlier_pick_moves_and_streamed_only_past_every_cluster(dtype,
                                                                     band):
    """Where a single-block kernel fits, the pick is the first of them (as
    before the wide kernels); "wide" only where none does and a cluster
    does; "streamed" only where no cluster holds the step."""
    for DL, DB, Y, sr, sl in _grid():
        for q in (2, 3):
            f = fs.merge_f_geometry(DL, DB, Y, q, sr, sl, dtype, band=band)
            w = fs.merge_w_geometry(DL, DB, Y, q, sr, dtype, band=band)
            for kind, (pick, _, smem), first, earlier in (
                    ("f", f, [v for v in ("staged", "cluster", "base")
                              if _fits(fs.merge_f_geometry, DL, DB, Y, q, sr,
                                       sl, dtype, v)],
                     ("staged", "cluster", "base")),
                    ("w", w, [v for v in ("staged", "base")
                              if _w_fits(DL, DB, Y, q, sr, dtype, v)],
                     ("staged", "base"))):
                plan = fs._wide_plan(kind, DL, DB, Y, q, sr,
                                     sl if kind == "f" else 0,
                                     4 if dtype == F32 else 8, band)
                if first:
                    assert pick == first[0], (kind, DL, DB, Y, q, sr)
                elif plan is not None:
                    assert pick == "wide" and smem <= fs.SMEM_LIMIT
                else:
                    assert pick == "streamed"
                assert pick in earlier + ("wide", "streamed")


def _fits(geometry, *args):
    try:
        geometry(*args)
    except ValueError:
        return False
    return True


def _w_fits(DL, DB, Y, q, sr, dtype, v):
    if v == "staged":
        return (dtype == F32 and (Y, q) == (2, 2) and fs._merge_w_staged_plan(
            DL, DB, Y, q, sr, 4) is not None)
    return _fits(fs.merge_w_geometry, DL, DB, Y, q, sr, dtype, v)


def test_wide_forced_where_no_cluster_fits_raises():
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_f_geometry(*_dims(40, 2), F32, "wide")
    with pytest.raises(ValueError, match="shared memory"):
        fs.merge_w_geometry(*_dims(40, 2)[:5], F32, "wide")
    with pytest.raises(ValueError, match="no cluster"):
        fs.merge_wide_macros("f", *_dims(40, 2), F32)


def test_macros_are_a_pure_function_of_the_shape():
    a = fs.merge_wide_macros("f", *_dims(18, 9), F32, 0)
    assert a == fs.merge_wide_macros("f", *_dims(18, 9), F32, 0)
    assert a != fs.merge_wide_macros("f", *_dims(18, 9), F32, 1)
    assert a != fs.merge_wide_macros("f", *_dims(18, 5), F32, 0)
    assert fs.merge_wide_macros("f", *_dims(20, 2), F64) != \
        fs.merge_wide_macros("f", *_dims(20, 2), F32)
    m = dict(x.split("=") for x in a)
    assert (m["WD_T"], m["WD_KIND"], m["WD_BAND"], m["WD_OFF"]) == (
        "float", "1", "1", "0")
    assert int(m["WD_C"]) == fs._wide_plan("f", *_dims(18, 9), 4, True)[0]
    assert all(f"WD_P{i}_{k}" in m for i in range(5)
               for k in ("TM", "TN", "KS"))
    # merge W reads no sl: every sl gives the same build
    w = fs.merge_wide_macros("w", *_dims(18, 9), F32, 0)
    assert w == fs.merge_wide_macros("w", *_dims(18, 9)[:5], 7, F32, 0)
    assert dict(x.split("=") for x in w)["WD_SL"] == "0"
    assert not any(x.startswith("WD_P3") for x in w)
    # the band's tiles: each register tile lies in one column block
    for i, (tm, tn, ks) in enumerate(
            (int(m[f"WD_P{i}_TM"]), int(m[f"WD_P{i}_TN"]),
             int(m[f"WD_P{i}_KS"])) for i in range(5)):
        assert 1 <= tm <= 8 and 1 <= tn <= 8 and ks in (1, 2, 4, 8, 16)


def test_smem_reckoning_matches_the_kernel_layout():
    """At K8 D=18 (f32, banded): merge F over 4 blocks of 6 rows e, merge W
    over 4 blocks of 5 rows m, each buffer as merge_wide.cu carves it
    (rounded up to 16 bytes: B_t's 810 rows-elements to 812)."""
    DLB, Y, sr, sl = 324, 9, 18, 22
    f = fs._smem_merge_wide("f", 18, 18, Y, 2, sr, sl, 4, 4, True)
    assert f == (6 * DLB + sl * DLB + DLB * sr + 18 * 18 * Y + 18 * 18 * Y
                 + 6 * sl * Y + 2 * 6 * DLB * Y)
    w = fs._smem_merge_wide("w", 18, 18, Y, 2, sr, 0, 4, 4, True)
    assert w == (DLB * sr + 2 * 18 * 5 * sr + 18 * 18 * Y + 812
                 + Y * sr * sr + 2 * 5 * Y * 18 * sr)
    assert fs.merge_f_geometry(18, 18, Y, 2, sr, sl, F32, band=True) == (
        "wide", fs._WIDE_THREADS, f * 4)


# ---------------------------------------------------------------------------
# the cluster split in plain torch, against the plain scans
# ---------------------------------------------------------------------------

def _band_range(j0, Y, off, kind):
    """The band's sums of column block j0: merge W's v for column u, merge
    F's u for column y (merge_wide.cu's Prod::lo / hi)."""
    if kind == "w":
        return max(0, off - j0), min(Y, Y + off - j0)
    return max(0, j0 + off - Y + 1), min(Y, j0 + off + 1)


def _slices(n, c):
    per = -(-n // c)
    return [(r * per, min(per, n - r * per)) for r in range(c)]


def _scale(parts, dims):
    m = torch.stack([p.abs().amax(dim=dims) for p in parts]).amax(dim=0)
    return _safe_scale(m)


def wscan_model(L1, B1, Th, c, off=None):
    Bn, S, DL, _, Y, q = L1.shape
    DB, sr = B1.shape[2], Th.shape[1]
    Wf = _onehot000(Bn, (DL, DB, sr), L1)
    Ws = L1.new_empty((Bn, S, DL, DB, sr))
    for s in range(S - 1, -1, -1):
        parts = []
        for m0, mr in _slices(DB, c):
            Wacc = 0
            for x in range(q):
                Bx = B1[:, s, m0:m0 + mr, :, :, x]
                t1 = torch.einsum("zmjv,znjb->zmvnb", Bx, Wf)
                if off is None:
                    u = torch.einsum("zmvnb,abuv->zmnua", t1, Th[s, ..., x])
                else:
                    psi = []
                    for w in range(Y):
                        uw = max(0, w + off - (Y - 1))
                        vw = w + off - uw
                        ok = uw < Y and 0 <= vw < Y
                        psi.append(Th[s, :, :, uw, vw, x] if ok
                                   else torch.zeros_like(Th[s, :, :, 0, 0, x]))
                    u = t1.new_zeros((Bn, mr, DL, Y, sr))
                    for uu in range(Y):
                        lo, hi = _band_range(uu, Y, off, "w")
                        for v in range(lo, hi):
                            u[:, :, :, uu] += torch.einsum(
                                "zmnb,ab->zmna", t1[:, :, v],
                                psi[uu + v - off])
                Wacc = Wacc + torch.einsum("zknu,zmnua->zkma",
                                           L1[:, s, ..., x], u)
            parts.append(Wacc)
        sc = _scale(parts, (1, 2, 3))[:, None, None, None]
        Wf = torch.cat([p / sc for p in parts], dim=2)
        Ws[:, s] = Wf
    return Ws


def fscan_model(L1, B1, Pyy, Phi, Ws, S_init, c, off=None):
    Bn, S, DL, _, Y, q = L1.shape
    DB, sl, sr = B1.shape[2], Phi.shape[1], Ws.shape[-1]
    if Pyy.ndim == 4:
        Pyy = Pyy.expand((S,) + Pyy.shape)
    blocks = _slices(sl, c)
    rows = [S_init[:, e0:e0 + el] for e0, el in blocks]
    Ns = L1.new_empty((Bn, S, sl, Y, q, sr))
    Ms = L1.new_empty((Bn, S, sl, sr))
    for (e0, el), Sr in zip(blocks, rows):
        Ms[:, 0, e0:e0 + el] = torch.einsum("zekm,zkma->zea", Sr, Ws[:, 0])
    W_end = _onehot000(Bn, Ws.shape[2:], Ws)
    for s in range(S):
        Wn = Ws[:, s + 1] if s + 1 < S else W_end
        partials = []
        for (e0, el), Sr in zip(blocks, rows):
            S2p = 0
            for x in range(q):
                Bx = B1[:, s, ..., x]                        # [z, m, j, v]
                t1 = torch.einsum("zekm,zknu->zemnu", Sr, L1[:, s, ..., x])
                if off is None:
                    Bp = torch.einsum("yuv,zmjv->zumyj", Pyy[s, ..., x], Bx)
                    t2 = torch.einsum("zemnu,zumyj->zeynj", t1, Bp)
                else:
                    t2 = t1.new_zeros((Bn, el, Y, DL, DB))
                    for y in range(Y):
                        lo, hi = _band_range(y, Y, off, "f")
                        for uu in range(lo, hi):
                            t2[:, :, y] += torch.einsum(
                                "zemn,zmj->zenj", t1[..., uu],
                                Bx[..., y + off - uu])
                Ns[:, s, e0:e0 + el, :, x] = torch.einsum(
                    "zeynj,znjb->zeyb", t2, Wn)
                S2p = S2p + torch.einsum("efy,zeynj->zfnj",
                                         Phi[s, e0:e0 + el, :, :, x], t2)
            partials.append(S2p)
        new = []
        for e0, el in blocks:
            v = partials[0][:, e0:e0 + el]
            for p in partials[1:]:
                v = v + p[:, e0:e0 + el]
            new.append(v)
        sc = _scale(new, (1, 2, 3))[:, None, None, None]
        rows = [v / sc for v in new]
        if s + 1 < S:
            for (e0, el), Sr in zip(blocks, rows):
                Ms[:, s + 1, e0:e0 + el] = torch.einsum("zekm,zkma->zea",
                                                        Sr, Wn)
    return Ns, Ms


def _inputs(Bn, S, DL, DB, Y, q, sr, sl, off, steps=False, seed=5):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s))   # noqa: E731
    L = t(Bn, S + 1, DL, DL, Y, q)
    B = t(S + 1, Bn, DB, DB, Y, q).transpose(0, 1)
    if off is None:
        Th = t(S, sr, sr, Y, Y, q)
        Pyy = torch.from_numpy(rng.random(((S,) if steps else ())
                                          + (Y, Y, Y, q)))
    else:
        Th = sumy.y_expand(t(S, sr, sr, Y, q), off, axis=3,
                           mode="sum").contiguous()
        Pyy = sumy.band_indicator(Y, off, q)
    return (L[:, 1:], B[:, 1:], Th, Pyy, t(S, sl, sl, Y, q),
            t(Bn, sl, DL, DB))


# (Bn, S, DL, DB, Y, q, sr, sl), band offset, cluster sizes: banded at Y=4
# (off 0 and 1: the band's edges on both sides), ragged slices (the last
# block owns fewer rows); dense f64 at DL != DB, one Pyy a step, S=1
MODEL_CASES = [
    ((3, 4, 4, 5, 4, 2, 6, 10), 0, (1, 2, 4)),
    ((3, 3, 3, 4, 4, 2, 5, 9), 1, (2, 3)),
    ((2, 3, 5, 3, 5, 2, 7, 11), 0, (2, 3)),
    ((3, 4, 3, 4, 2, 2, 6, 10), None, (1, 2, 4)),
    ((2, 1, 4, 4, 2, 3, 6, 10), None, (4,)),
]


# a banded merge takes one shared band indicator; the dense cases also run
# with one Pyy a step
MODEL_RUNS = [(case, off, cs, steps) for case, off, cs in MODEL_CASES
              for steps in ((False,) if off is not None else (False, True))]


@pytest.mark.parametrize("case,off,cs,steps", MODEL_RUNS, ids=[
    f"{c[0][2]}x{c[0][3]}-Y{c[0][4]}-off{c[1]}-{'steps' if c[3] else 'shared'}"
    for c in MODEL_RUNS])
def test_cluster_split_reproduces_the_plain_scans(case, off, cs, steps):
    Bn, S, DL, DB, Y, q, sr, sl = case
    L1, B1, Th, Pyy, Phi, S0 = _inputs(Bn, S, DL, DB, Y, q, sr, sl, off,
                                       steps)
    Wp = fs.merge_wscan_plain(L1, B1, Th)
    Np, Mp = fs.merge_fscan_plain(L1, B1, Pyy, Phi, Wp, S0)
    for c in cs:
        # a cluster size the geometry would take for each kind: every block
        # owns a row
        got = []
        if (c - 1) * -(-DB // c) < DB:
            got.append((wscan_model(L1, B1, Th, c, off), Wp))
        if (c - 1) * -(-sl // c) < sl:
            got += zip(fscan_model(L1, B1, Pyy, Phi, Wp, S0, c, off),
                       (Np, Mp))
        assert got, c
        for a, want in got:
            assert float((a - want).abs().max()) <= \
                1e-12 * float(want.abs().max()), c


def test_wrappers_take_the_band_on_the_cpu():
    """On the CPU the wrappers run the plain scans whatever the band: the
    band is a hint for the kernels; a band with a Pyy a step is refused
    only where a kernel would read it (the card)."""
    L1, B1, Th, Pyy, Phi, S0 = _inputs(2, 3, 4, 4, 4, 2, 6, 10, 0)
    Ws = fs.merge_wscan(L1, B1, Th, yy_off=0)
    assert torch.equal(Ws, fs.merge_wscan_plain(L1, B1, Th))
    out = fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0, yy_off=0)
    for a, b in zip(out, fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S0)):
        assert torch.equal(a, b)


def test_probe_variants_apply_to_the_kernel_source():
    """Every text that ``tools/probe_merge_wide.py`` leaves out is in
    ``merge_wide.cu`` as often as its edit says."""
    from matrixproductbp_tpu_torch.tools import probe_merge_wide as probe
    with open(probe.SOURCE) as fh:
        text = fh.read()
    for name, edits in probe.VARIANTS.items():
        assert probe.variant_source(text, edits) != text, name
    with pytest.raises(RuntimeError, match="holds"):
        probe.variant_source(text, [("no such line", "", None)])
