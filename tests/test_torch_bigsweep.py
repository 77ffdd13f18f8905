"""The port's in-place large-graph sweep (``bigsweep``) against its chunked
sweep, the JAX package's flat sweep and enumeration (f64, CPU).

A Jacobi flat sweep equals ``bp_sweep_chunked`` on the same chunks bit for
bit (``tests/test_bigsweep.py``); one in-place (Gauss-Seidel) sweep matches
the JAX package's ``bigsweep.bp_sweep_flat`` with its sketches (marginals
and the messages' marginals to 1e-10, ``f`` to 1e-9); iterated on a tree
by the ``qr`` method it reaches enumeration with -F = log Z (1e-8); damped
it converges.  ``flat_init`` places the
state on the card unless told ``device="cpu"``.  In float32 a lone node's
marginal late in a T=50 horizon is exact to 1e-5 for every sketch seed
(the scale target's isolated-node check, in miniature).
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import bigsweep as jbigsweep
from matrixproductbp_tpu.models.sis import SISFactorSpec as JSISFactorSpec
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import bigsweep, exact
from matrixproductbp_tpu_torch.models import SISFactorSpec, sis_tables
from test_torch_chunked import _msg_marginals
from test_torch_sweep_svd import JaxSketches

TREE5 = (5, [(0, 1), (1, 2), (1, 3), (3, 4)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(N):
    return [(i, i + 1) for i in range(N - 1)]


def _port(N, edges):
    g = tp.graph_from_edges(N, edges)
    return g, tp.build_tables(g, [SISFactorSpec(0.2, 0.3)] * N)


def test_jacobi_sweep_bitexact_vs_chunked():
    """40-node chain: chunks of 16 nodes in both (the slot budget 16 gives
    max(16, 16 // K) nodes), the same updates, the same numbers."""
    g, tables = _port(40, _chain(40))
    T, D = 3, 8
    trunc = tp.TruncBond(D)
    fs = bigsweep.flat_init(g, tables, T, D, dtype=torch.float64,
                            device="cpu", belief_cores=True)
    fs1 = bigsweep.bp_sweep_flat(g, tables, fs, trunc, T, D, chunk=16,
                                 method="sketch", jacobi=True)
    assert fs1 is fs                       # in place
    bp = tp.mpbp(g, tables, T=T, D=D, device="cpu")
    bp1 = tp.bp_sweep_chunked(bp, trunc, method="sketch", chunk=16)
    for name in ("msg_cores", "msg_logz", "bel_cores", "bel_logz", "f"):
        assert torch.equal(getattr(bp1, name), getattr(fs1, name)), name
    np.testing.assert_allclose(
        bigsweep.flat_beliefs(fs1, T, D, 2).numpy(),
        tp.beliefs(bp1).numpy(), atol=1e-15)


def test_seidel_sweep_matches_jax():
    """One in-place sweep of a 40-node chain from the initial state, with a
    t = 0 prior: the ends' bucket first, then the inner nodes in chunks of
    16, each reading what the chunks before it wrote.  Beliefs and the
    messages' marginals to 1e-10; ``f``, a sum of log-norms, to 1e-9 as
    the other one-sweep gates hold it (its merges' logz round apart)."""
    N, T, D = 40, 3, 6
    g, tables = _port(N, _chain(N))
    phi = np.ones((N, T + 1, 2))
    phi[:, 0] = [0.7, 0.3]
    fs = bigsweep.flat_init(g, tables, T, D, dtype=torch.float64,
                            device="cpu")
    fs = bigsweep.bp_sweep_flat(g, tables, fs, tp.TruncBond(D), T, D,
                                phi=phi, chunk=16, sketches=JaxSketches())
    jg = mp.graph_from_edges(N, _chain(N))
    jt = mp.build_tables(jg, [JSISFactorSpec(0.2, 0.3)] * N)
    jfs = jbigsweep.flat_init(jg, jt, T, D, dtype=np.float64)
    jfs = jbigsweep.bp_sweep_flat(jg, jt, jfs, mp.TruncBond(D), T, D,
                                  phi=phi, chunk=16)
    np.testing.assert_allclose(
        bigsweep.flat_beliefs(fs, T, D, 2).numpy(),
        jbigsweep.flat_beliefs(jfs, T, D, 2), atol=1e-10)
    np.testing.assert_allclose(
        _msg_marginals(fs.msg_cores, fs.msg_logz, 2).numpy(),
        _msg_marginals(np.asarray(jfs.msg2).reshape(fs.msg_cores.shape),
                       jfs.msg_logz, 2).numpy(), atol=1e-10)
    np.testing.assert_allclose(fs.f.numpy(), np.asarray(jfs.f), rtol=1e-9,
                               atol=1e-9)


def test_seidel_fixed_point_matches_exact_tree():
    """In-place Gauss-Seidel to its fixed point on a tree: enumeration
    and -F = log Z (``tests/test_bigsweep.py:46-61``), here by the exact
    ``qr`` method at 1e-8; the sketch method's flat sweep is held to the
    JAX package's above."""
    g, tables = _port(*TREE5)
    T, D = 2, 8
    fs = bigsweep.flat_init(g, tables, T, D, dtype=torch.float64,
                            device="cpu")
    fs, nit, delta = bigsweep.iterate_flat(g, tables, fs,
                                           tp.TruncThresh(0.0), T, D,
                                           maxiter=40, tol=1e-12, chunk=8,
                                           method="qr")
    assert nit < 40 and delta < 1e-12
    bp = tp.mpbp(g, tables, T=T, D=D, device="cpu")     # oracle container
    p, Z = exact.exact_prob(bp)
    b = bigsweep.flat_beliefs(fs, T, D, 2).numpy()
    assert np.abs(b - exact.exact_marginals(bp, p)).max() < 1e-8
    assert abs(-bigsweep.flat_free_energy(fs) - np.log(Z)) < 1e-8


def test_iterate_flat_converges_and_damping_runs():
    g, tables = _port(20, _chain(20))
    T, D = 2, 6
    fs = bigsweep.flat_init(g, tables, T, D, dtype=torch.float64,
                            device="cpu")
    fs, nit, delta = bigsweep.iterate_flat(
        g, tables, fs, tp.TruncBond(D), T, D, maxiter=30, tol=1e-8,
        chunk=8, method="sketch", damp=0.2)
    assert nit < 30 and delta < 1e-8
    b = bigsweep.flat_beliefs(fs, T, D, 2)
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, atol=1e-12)


def test_flat_init_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, tables = _port(3, _chain(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bigsweep.flat_init(g, tables, 2, 4)
    fs = bigsweep.flat_init(g, tables, 2, 4, device="cpu")
    assert fs.msg_cores.device.type == "cpu" and fs.bel_cores is None
    assert fs.msg_cores.shape == (g.E, 3, 4, 4, 4)
    assert fs.marg.shape == (3, 3, 2) and fs.msg_cores.dtype == torch.float32


@pytest.mark.parametrize("seed", [17, 0, 1, 2, 3, 4])
def test_f32_lone_node_exact(seed):
    """One in-place float32 sketch sweep at T=50, D=10 of SIS (lambda=0.2,
    rho=0.1, the t=0 prior (0.7, 0.3) as ``phi``) on a lone node beside an
    edge: the lone node only recovers, P(I, t) = 0.3 * 0.9^t, to 1e-5 with
    each seed's sketches.  A solve jitter of 1e-6 (the JAX package's
    float32 one) misses it by 3e-4 to 1.2e-2: it shrinks the infected
    share, ~1.5e-3 at t=50."""
    g = tp.graph_from_edges(3, [(1, 2)])
    tables = sis_tables(g, 0.2, 0.1)
    T, D = 50, 10
    phi = np.ones((g.N, T + 1, 2), np.float32)
    phi[:, 0] = [0.7, 0.3]
    fs = bigsweep.flat_init(g, tables, T, D, dtype=torch.float32,
                            device="cpu")
    fs = bigsweep.bp_sweep_flat(g, tables, fs, tp.TruncBond(D), T, D,
                                phi=phi, method="sketch",
                                sketches=tp.SeededSketches(seed))
    want = 0.3 * 0.9 ** np.arange(T + 1)
    assert np.abs(fs.marg[0, :, 1].double().numpy() - want).max() < 1e-5


def test_iterate_flat_groups_nodes_once(monkeypatch):
    """Per-node float64 tables under a float32 state: ``iterate_flat``
    converts them once, so the nodes are grouped by ``prob_yy`` (one
    ``np.unique`` over the table rows a chunk) in its first sweep only."""
    g, tables = _port(20, _chain(20))
    assert tables.Pyy.shape[0] == g.N
    T, D = 2, 4
    unique, calls = np.unique, []

    def counted(*a, **k):
        calls.append(k.get("axis"))
        return unique(*a, **k)
    monkeypatch.setattr(np, "unique", counted)
    groupings = []
    for sweeps in (1, 3):
        calls.clear()
        fs = bigsweep.flat_init(g, tables, T, D, dtype=torch.float32,
                                device="cpu")
        bigsweep.iterate_flat(g, tables, fs, tp.TruncBond(D), T, D,
                              maxiter=sweeps, tol=0.0, chunk=8, method="qr")
        groupings.append(calls.count(0))
    assert groupings[0] > 0 and groupings[1] == groupings[0]


def test_f32_sweep_near_f64_at_t50():
    """The scale target in miniature (SIS, lambda=0.2, rho=0.1, the t=0
    prior as ``phi``, on ``erdos_renyi_gnm(40, 60)``), T=50, D=10: one
    in-place float32 sketch sweep stays within 1e-3 of the same sweep in
    float64 (a solve jitter of 1e-6 puts it 4e-2 away)."""
    g = tp.erdos_renyi_gnm(40, 60, np.random.default_rng(0))
    tables = sis_tables(g, 0.2, 0.1)
    T, D = 50, 10
    phi = np.ones((g.N, T + 1, 2))
    phi[:, 0] = [0.7, 0.3]
    marg = []
    for dtype in (torch.float32, torch.float64):
        fs = bigsweep.flat_init(g, tables, T, D, dtype=dtype, device="cpu")
        fs = bigsweep.bp_sweep_flat(g, tables, fs, tp.TruncBond(D), T, D,
                                    phi=phi, chunk=64, method="sketch")
        marg.append(fs.marg.double().numpy())
    assert np.abs(marg[0] - marg[1]).max() < 1e-3
