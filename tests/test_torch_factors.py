"""The port's generic factor layer against the JAX package (f64, CPU): the
tables ``build_tables`` makes from every kind of spec (bit for bit, with
``yy_off`` and ``ydims``), ``y_expand`` and the band indicator (exact), the
banded ``transition_probs`` (1e-14), the new graph generators (the same
arrays from the same draws), the per-node ``prob_yy`` grouping of the
sweep, a JAX Glauber state carried into the port, and the banded merges:
the sketch merge against the JAX Pallas bodies (interpret mode) and the
randomized merge against JAX's, each on the dense tensor its output train
represents (1e-8 of its max-abs; logz as ``test_torch_stta.py`` and
``test_torch_randomized.py`` hold it)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import factors as jfactors
from matrixproductbp_tpu.models import glauber as jglauber
from matrixproductbp_tpu.models import sirs as jsirs
from matrixproductbp_tpu.models import sis as jsis
from matrixproductbp_tpu.models import sis_heterogeneous as jhet
from matrixproductbp_tpu.ops import fused_stta as jfs
from matrixproductbp_tpu.ops import randomized as jr
from matrixproductbp_tpu.ops import sumy as jsumy
from matrixproductbp_tpu.ops.truncation import TruncBond as JTruncBond
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import bp as tbp
from matrixproductbp_tpu_torch.models import glauber as tglauber
from matrixproductbp_tpu_torch.models import sirs as tsirs
from matrixproductbp_tpu_torch.models import sis as tsis
from matrixproductbp_tpu_torch.models import sis_heterogeneous as thet
from matrixproductbp_tpu_torch.ops import fused_stta as tfs
from matrixproductbp_tpu_torch.ops import randomized as tr
from matrixproductbp_tpu_torch.ops import stta as tstta
from matrixproductbp_tpu_torch.ops import sumy as tsumy
from test_torch_randomized import JaxNormal, _cavity_trains
from test_torch_randomized import _dense as _dense_rounded
from test_torch_stta import JaxSketches, _assert_same_trains

# a tree with a hub of degree 4 (the K > 3 folds), a node of degree 2, and
# an isolated node (degree 0: padded slots only)
HUB = (7, [(0, 1), (0, 2), (0, 3), (0, 4), (4, 5)])
TABLES = ("Py", "Pyp", "Pxy", "Pyy", "Py0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs(N, edges):
    return mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)


def _trace_fn(xp, x_nbrs, x):
    """A neighbour-asymmetric factor: slot s weighs (s + 1)."""
    field = 0.3 * sum((s + 1) * (1 - 2 * xk) for s, xk in enumerate(x_nbrs))
    p = 1.0 / (1.0 + np.exp(-2.0 * (1 - 2 * xp) * (field + 0.1 * x)))
    return p


def _ising_J(kind, n):
    rng = np.random.default_rng(3)
    return {"homogeneous": np.full(n, 0.6),
            "pmj": 0.5 * np.where(np.arange(n) % 2, 1.0, -1.0),
            "integer": np.array([1.0, -2.0, 1.0, 3.0, -1.0])[:n],
            "generic": rng.normal(size=n)}[kind]


def _specs(kind, jg, tg):
    """(JAX specs, port specs) of one kind on the HUB graph."""
    N = jg.N
    if kind in ("homogeneous", "pmj", "integer", "generic"):
        J, h = _ising_J(kind, jg.E // 2), np.linspace(-0.3, 0.4, N)
        return (jglauber.glauber_factor_specs(jglauber.Ising(jg, J, h, 0.8),
                                              kind),
                tglauber.glauber_factor_specs(tglauber.Ising(tg, J, h, 0.8),
                                              kind))
    if kind == "sis":
        return ([jsis.SISFactorSpec(0.3, 0.2, 0.05)] * N,
                [tsis.SISFactorSpec(0.3, 0.2, 0.05)] * N)
    if kind == "trace":
        return ([jfactors.TraceFactorSpec(_trace_fn, 2, int(d))
                 for d in jg.degree],
                [tp.TraceFactorSpec(_trace_fn, 2, int(d)) for d in tg.degree])
    if kind == "sirs":
        return ([jsirs.SIRSFactorSpec(0.3, 0.2, 0.15, 0.05)] * N,
                [tsirs.SIRSFactorSpec(0.3, 0.2, 0.15, 0.05)] * N)
    if kind == "sis_heterogeneous":
        lams = [[0.1 + 0.05 * k + 0.01 * i for k in range(int(d))]
                for i, d in enumerate(jg.degree)]
        return ([jhet.SISHeterogeneousFactorSpec(lams[i], 0.2 + 0.01 * i)
                 for i in range(N)],
                [thet.SISHeterogeneousFactorSpec(lams[i], 0.2 + 0.01 * i)
                 for i in range(N)])
    if kind == "restricted":
        return ([jfactors.RestrictedFactorSpec(
                    jglauber.HomogeneousGlauberFactorSpec(0.4, 0.1, 1.0))] * N,
                [tp.RestrictedFactorSpec(
                    tglauber.HomogeneousGlauberFactorSpec(0.4, 0.1, 1.0))] * N)
    if kind == "damped":
        return ([jfactors.DampedFactorSpec(jsis.SISFactorSpec(0.35, 0.25),
                                           0.3)] * N,
                [tp.DampedFactorSpec(tsis.SISFactorSpec(0.35, 0.25),
                                     0.3)] * N)
    raise ValueError(kind)


SPEC_KINDS = ["sis", "trace", "homogeneous", "pmj", "integer", "generic",
              "sirs", "sis_heterogeneous", "restricted", "damped"]


def _padded_outputs_zeroed(Pyy, specs):
    """JAX's dense ``Pyy`` with the entries the port leaves at zero: a
    merge of states a node's spec has (y1 < nstates(d1), y2 < nstates(1))
    onto a y beyond its nstates(d1 + 1), which JAX fills from the spec's
    ``prob_yy`` (ROADMAP Queue 3)."""
    Pyy = np.array(Pyy)
    Y = Pyy.shape[2]
    y = np.arange(Y)
    for i, s in enumerate(specs):
        for d1 in range(Pyy.shape[1]):
            pad = ((y[:, None, None] >= s.nstates(d1 + 1))
                   & (y[None, :, None] < s.nstates(d1))
                   & (y[None, None, :] < s.nstates(1)))
            Pyy[i, d1][pad] = 0.0
    return Pyy


@pytest.mark.parametrize("kind", SPEC_KINDS)
def test_build_tables_bit_equal(kind):
    """Bit for bit, but for the padded-output entries of ``Pyy`` that the
    port zeroes; only the integer Glauber specs have any that JAX fills
    (merges of unreachable partial sums, which no sweep reaches)."""
    jg, tg = _graphs(*HUB)
    js, ts = _specs(kind, jg, tg)
    jt, tt = jfactors.build_tables(jg, js), tp.build_tables(tg, ts)
    for name in TABLES:
        a, b = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "Pyy" and tt.yy_off is None:
            zeroed = _padded_outputs_zeroed(b, ts)
            assert (zeroed != b).any() == (kind == "integer")
            b = zeroed
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tt.yy_off == jt.yy_off and tt.ydims == jt.ydims
    want_banded = kind in ("homogeneous", "pmj")
    assert (tt.yy_off is not None) == want_banded


def test_build_tables_y_pad_and_unported_time_varying():
    """With Y padded to 4, SIS's OR would merge states 0 and 1 onto y = 2
    and 3: the port zeroes those entries of ``Pyy``, JAX does not.  The
    time-varying tables (ported with ROADMAP Queue 1 item 6) of the same
    specs stack JAX's slices bit for bit."""
    jg, tg = _graphs(*HUB)
    js, ts = _specs("sis", jg, tg)
    tt, jt = tp.build_tables(tg, ts, Y_pad=4), \
        jfactors.build_tables(jg, js, Y_pad=4)
    for name in TABLES:
        want = np.asarray(getattr(jt, name))
        if name == "Pyy":
            zeroed = _padded_outputs_zeroed(want, ts)
            assert zeroed[:, :, 2:, :2, :2].sum() == 0
            assert want[:, :, 2:, :2, :2].sum() > 0
            want = zeroed
        np.testing.assert_array_equal(getattr(tt, name).numpy(), want)
    with pytest.raises(ValueError, match="Y_pad"):
        tp.build_tables(tg, ts, Y_pad=1)
    tt_t = tp.build_tables_t(tg, [[s] * 3 for s in ts])
    jt_t = jfactors.build_tables_t(jg, [[s] * 3 for s in js])
    assert tt_t.time_varying and tt_t.ydims == jt_t.ydims
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tt_t, name).numpy(),
                                      np.asarray(getattr(jt_t, name)))


@pytest.mark.parametrize("mode", ["diff", "sum"])
@pytest.mark.parametrize("off", [0, 1, 3])
@pytest.mark.parametrize("axis", [0, 2, -2])
def test_y_expand_is_exact(mode, off, axis):
    A = np.random.default_rng(off).normal(size=(4, 3, 5, 2))
    out = tsumy.y_expand(torch.as_tensor(A), off, axis, mode)
    ref = jsumy.y_expand(jnp.asarray(A), off, axis, mode)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("Y,off,q", [(2, 0, 2), (5, 0, 2), (7, 3, 2),
                                     (3, 1, 3)])
def test_band_indicator_is_exact(Y, off, q):
    out = tsumy.band_indicator(Y, off, q)
    ref = jfs._band_indicator(Y, off, q, jnp.float64)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["homogeneous", "pmj", "integer", "sirs"])
def test_transition_probs_match_jax_and_spec(kind):
    """The table fold (banded for the sum-type Glauber tables) against the
    JAX package's and against the specs' own ``w``."""
    jg, tg = _graphs(*HUB)
    js, ts = _specs(kind, jg, tg)
    jt, tt = jfactors.build_tables(jg, js), tp.build_tables(tg, ts)
    q = tt.q
    rng = np.random.default_rng(1)
    x = rng.integers(0, q, size=(12, jg.N))
    xn = x[:, np.minimum(jg.nbr, jg.N - 1)]
    ref = jax.vmap(lambda a, b: jfactors.transition_probs(
        jt, jnp.asarray(jg.in_mask), a, b))(jnp.asarray(xn), jnp.asarray(x))
    out = tp.transition_probs(tt, tg.in_mask, torch.as_tensor(xn),
                              torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-14, atol=1e-14)
    for c in range(len(x)):
        for i in range(jg.N):
            nb = [int(x[c, j]) for j in tg.nbr[i][tg.in_mask[i]]]
            for xp in range(q):
                np.testing.assert_allclose(out[c, i, xp],
                                           ts[i].w(xp, nb, int(x[c, i])),
                                           rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("N,c,seed", [(60, 2.5, 0), (200, 1.5, 3)])
def test_erdos_renyi_graph_matches_jax(N, c, seed):
    tg = tp.erdos_renyi_graph(N, c, np.random.default_rng(seed))
    jg = mp.graph.erdos_renyi_graph(N, c, np.random.default_rng(seed))
    for f in ("N", "E", "dmax", "edge_src", "edge_dst", "rev_edge",
              "in_edges", "in_mask", "nbr", "degree", "out_edges"):
        np.testing.assert_array_equal(np.asarray(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert (tg.degree == 0).any()                 # isolated nodes kept
    assert tg.undirected_edges() == jg.undirected_edges()


def test_star_graph_matches_jax():
    tg, jg = tp.star_graph(6), mp.graph.star_graph(6)
    np.testing.assert_array_equal(tg.in_edges, jg.in_edges)
    np.testing.assert_array_equal(tg.degree, jg.degree)
    assert tg.undirected_edges() == jg.undirected_edges()


def test_pyy_groups_split_a_bucket_by_table():
    """SIS-by-spec and TraceFactorSpec nodes of one degree in one bucket:
    two groups, each with its node's own cropped table; a shared table is
    one group; banded tables are one group with the placeholder."""
    g = tp.graph_from_edges(6, [(0, 1), (1, 2), (3, 4), (4, 5)])
    sis = tsis.SISFactorSpec(0.3, 0.2)
    specs = [tp.TraceFactorSpec(sis.w, 2, int(d)) if i >= 3 else sis
             for i, d in enumerate(g.degree)]
    tb = tp.build_tables(g, specs)
    Yb = tb.ydims[2]
    idx, K = [(i, k) for i, k in tbp._degree_buckets(g) if k == 2][0]
    assert list(idx) == [1, 4]
    groups = tbp._pyy_groups(tb, idx, K, Yb)
    assert [list(i) for i, _ in groups] in ([[1], [4]], [[4], [1]])
    for i, P in groups:
        want = tb.Pyy[i[0], :K][..., :Yb, :Yb, :Yb, :]
        assert P.shape == (1,) + want.shape and torch.equal(P[0], want)
    assert tbp._pyy_groups(tb, idx, K, Yb) is groups      # kept
    shared = tsis.sis_tables(g, 0.3, 0.2)
    ((i, P),) = tbp._pyy_groups(shared, idx, K, 2)
    assert list(i) == [1, 4] and P.shape == (1, 2, 2, 2, 2, 2)
    gl = tglauber.mpbp_glauber(tglauber.Glauber(tglauber.Ising(
        g, np.full(4, 0.5), np.zeros(6)), 2), D=4, device="cpu")
    ((i, P),) = tbp._pyy_groups(gl.tables, idx, K, 3)
    assert P is gl.tables.Pyy


def test_jax_glauber_state_loads_into_port():
    jg, tg = _graphs(*HUB)
    ising = jglauber.Ising(jg, np.full(jg.E // 2, 0.5),
                           np.linspace(-0.2, 0.2, jg.N), 0.7)
    jb = jglauber.mpbp_glauber(jglauber.Glauber(ising, 2), D=4)
    assert jb.tables.yy_off == 0
    arrays = {"state." + n: np.asarray(getattr(jb, n))
              for n in ("phi", "psi", "msg_cores", "msg_logz", "bel_cores",
                        "bel_logz", "f")}
    arrays.update({"tables." + n: np.asarray(getattr(jb.tables, n))
                   for n in TABLES})
    arrays.update({"graph." + n: np.asarray(getattr(jg, n))
                   for n in ("edge_src", "edge_dst", "rev_edge", "in_edges",
                             "in_mask", "nbr", "degree")})
    meta = {"format_version": 1, "periodic": False, "graph.N": jg.N,
            "graph.E": jg.E, "graph.dmax": jg.dmax,
            "tables.yy_off": jb.tables.yy_off,
            "tables.ydims": list(jb.tables.ydims)}
    tb = tp.from_numpy_state(arrays, meta, device="cpu")
    assert tb.tables.yy_off == 0 and tb.tables.ydims == jb.tables.ydims
    ref = tglauber.mpbp_glauber(tglauber.Glauber(tglauber.Ising(
        tg, np.full(jg.E // 2, 0.5), np.linspace(-0.2, 0.2, jg.N), 0.7), 2),
        D=4, device="cpu")
    for n in TABLES:
        assert torch.equal(getattr(tb.tables, n), getattr(ref.tables, n)), n
    tb = tp.bp_sweep(tb, tp.TruncBond(4), method="sketch")
    assert bool(torch.isfinite(tp.beliefs(tb)).all())


def _banded_trains(rng, B, T1, D, Y, q, off):
    """Cavity-like trains whose y-support is the band's: Y entries, the
    first ``off`` rows smaller."""
    c = rng.normal(size=(B, T1, D, D, Y, q))
    c[..., :off, :] *= 0.5
    return c.reshape(B, T1, D, D, Y * q), rng.normal(size=(B,))


@pytest.mark.parametrize("DL,DB,Y,off,Dout", [(3, 2, 3, 0, 4),
                                              (2, 3, 5, 2, 5)])
def test_banded_merge_stta_fused_matches_jax(DL, DB, Y, off, Dout):
    """The banded sketch merge through the port's scans against the JAX
    package's Pallas bodies (interpret mode): the same Th, band indicator
    and boundary; the plain entry point gives the same cores."""
    rng = np.random.default_rng(7)
    B, T1, q = 4, 4, 2
    Lc, Llz = _banded_trains(rng, B, T1, DL, Y, q, off)
    Bc, Blz = _banded_trains(rng, B, T1, DB, Y, q, off)
    pyy = np.zeros((1, 1, 1, q))
    ref = jfs.merge_stta_fused(*(jnp.asarray(a) for a in
                                 (Lc, Llz, Bc, Blz, pyy)), Dout, Y, q,
                               jax.random.PRNGKey(17), yy_off=off,
                               interpret=True)
    args = [torch.as_tensor(a) for a in (Lc, Llz, Bc, Blz, pyy)]
    out = tfs.merge_stta_fused(*args, Dout, Y, q, sketches=JaxSketches(),
                               yy_off=off)
    _assert_same_trains(out, ref, logz_tol=1e-3)
    plain = tstta.merge_stta_batched(*args, Dout, Y, q,
                                     sketches=JaxSketches(), yy_off=off)
    np.testing.assert_array_equal(plain[0].numpy(), out[0].numpy())


def test_banded_merge_rounded_matches_jax():
    rng = np.random.default_rng(8)
    T1, DL, DB, Y, q, Bn, off, Dout = 4, 3, 2, 3, 2, 3, 0, 3
    Lc, Llz = _cavity_trains(rng, Bn, T1, DL, Y * q)
    Bc, Blz = _cavity_trains(rng, Bn, T1, DB, Y * q)
    pyy = np.zeros((1, 1, 1, q))
    jc, jz = jax.vmap(lambda a, b, c, d: jr.merge_rounded(
        a, b, c, d, jnp.asarray(pyy), JTruncBond(Dout), Dout, Y, q,
        jax.random.PRNGKey(17), yy_off=off))(
        jnp.asarray(Lc), jnp.asarray(Llz), jnp.asarray(Bc), jnp.asarray(Blz))
    tc, tz = tr.merge_rounded(*map(torch.as_tensor, (Lc, Llz, Bc, Blz, pyy)),
                              tp.TruncBond(Dout), Dout, Y, q,
                              sketches=JaxNormal(), yy_off=off)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-10,
                               atol=1e-10)
    dt = _dense_rounded(tc, tz, T1, Y * q)
    dj = _dense_rounded(jc, jz, T1, Y * q)
    scale = np.abs(dj).max()
    np.testing.assert_allclose(dt / scale, dj / scale, rtol=1e-8, atol=1e-8)


# the largest bond D at which both shared-memory merge scan kernels hold an
# f32 sketch merge (sr = D, sl = D + 4, q = 2) of y-axis Y: Glauber's Y
# grows with the degree (Y = K + 1), so an Erdos-Renyi graph with a
# degree-9 node (Y=10) runs on them to D=10; above, the wide cluster
# kernels (csrc/merge_wide.cu) take the merge where a cluster holds it and
# the streamed kernels (csrc/merge_streamed.cu) beyond, to D=32 and beyond
MAX_D_BY_Y = {2: 20, 3: 18, 4: 16, 5: 15, 6: 14, 7: 13, 8: 12, 9: 11,
              10: 10, 11: 10, 12: 9, 13: 9}


@pytest.mark.parametrize("Y", list(MAX_D_BY_Y))
def test_merge_kernels_reach_by_y(Y):
    """No merge raises up to D=32: to MAX_D_BY_Y[Y] on the single-block
    kernels, from the next bond on at least one scan on a wide (cluster)
    or a streamed one."""
    for D in range(2, 33):
        picks = (tfs.merge_f_geometry(D, D, Y, 2, D, D + 4,
                                      torch.float32)[0],
                 tfs.merge_w_geometry(D, D, Y, 2, D, torch.float32)[0])
        beyond = any(p in ("wide", "streamed") for p in picks)
        assert beyond == (D > MAX_D_BY_Y[Y]), (D, picks)
