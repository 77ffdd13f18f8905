"""Symmetry-collapsed infinite graphs in the port, against the JAX package
and the finite graphs they stand for (f64, CPU).

* the reference's golden belief vector of SIS on the infinite 3-regular
  graph (``tests/test_sis_infinite_graph.py``, rtol 2e-8);
* where several slots write the one stored edge, the sweep keeps the
  message the JAX package's scatter keeps (two sweeps at k = 4 with a rate
  a slot, so that each slot's message is its own, 1e-10);
* Glauber on the infinite 3-regular graph equal to the complete graph K4
  (1e-7), the symmetric bipartite graph equal to the regular one (1e-8,
  beliefs and the block-weighted free energy), the pair-route free energy
  equal to the sweep's ledger (1e-8) with the ``1/(k-1) - 1/2`` logz weight;
* periodic Glauber on the infinite 3-regular graph equal to periodic K4
  (1e-6), both started from the JAX package's random periodic message
  (carried across: the two packages' random streams differ), and one
  damped sweep of it against the JAX package (1e-10).
"""
import dataclasses

import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import infinite as jinf
from matrixproductbp_tpu.factors import build_tables as jbuild_tables
from matrixproductbp_tpu.models import HomogeneousGlauberFactorSpec as JGS
from matrixproductbp_tpu.models.sis_heterogeneous import \
    SISHeterogeneousFactorSpec as JHet
from matrixproductbp_tpu.ops import tensortrain as jtt
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch.models import (HomogeneousGlauberFactorSpec,
                                              SISFactorSpec)
from matrixproductbp_tpu_torch.models.sis_heterogeneous import \
    SISHeterogeneousFactorSpec

GOLDEN = np.array([
    [0.9000000001671186, 0.0999999998328814],
    [0.8932690998131098, 0.10673090018689023],
    [0.8899420329322244, 0.11005796706777556],
    [0.8884643888492034, 0.11153561115079656],
    [0.8880305235706524, 0.1119694764293476],
    [0.8882121515614524, 0.11178784843854758],
    [0.8887717202217936, 0.1112282797782064],
])
TRUNC = tp.TruncThresh(0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _complete(N):
    return tp.graph_from_edges(N, [(i, j) for i in range(N) for j in range(i)])


def test_sis_infinite_3regular_golden():
    T, k = 6, 3
    g = tp.infinite_regular_graph(k)
    phi = np.ones((1, T + 1, 2))
    phi[0, 0] = [0.9, 0.1]
    bp = tp.mpbp_infinite_graph(k, tp.build_tables(g, [SISFactorSpec(0.1,
                                                                      0.2)]),
                                T, D=10, phi=phi, device="cpu")
    bp, _, _ = tp.iterate(bp, maxiter=200, trunc=tp.TruncBond(10), tol=1e-14)
    np.testing.assert_allclose(tp.beliefs(bp).numpy()[0], GOLDEN, rtol=2e-8,
                               atol=0)


@pytest.mark.parametrize("method", ["qr"])
def test_aliased_edge_keeps_the_jax_slot(method):
    """k = 4 slots of one node write the one stored edge.  A factor whose
    rate differs by slot (heterogeneous SIS) makes each slot's message its
    own, so the stored one tells which slot was kept: the JAX package's."""
    from test_torch_sweep_svd import JaxSketches
    T, k = 2, 4
    phi = np.ones((1, T + 1, 2))
    phi[0, 0] = [0.7, 0.3]
    lams, rho = [0.05, 0.2, 0.35, 0.5], 0.2
    jb = jinf.mpbp_infinite_graph(k, jbuild_tables(
        jinf.infinite_regular_graph(k), [JHet(lams, rho)]), T, D=3, phi=phi)
    tb = tp.mpbp_infinite_graph(k, tp.build_tables(
        tp.infinite_regular_graph(k), [SISHeterogeneousFactorSpec(lams,
                                                                  rho)]),
        T, D=3, phi=phi, device="cpu")
    for _ in range(2):
        jb = mp.bp_sweep(jb, mp.TruncBond(3), method=method)
        tb = tp.bp_sweep(tb, tp.TruncBond(3), method=method,
                         sketches=JaxSketches())
    want = jtt.marginals(jtt.TensorTrain(jb.msg_cores[0], jb.msg_logz[0],
                                         (2, 2)))
    got = tp.marginals(tp.TensorTrain(tb.msg_cores, tb.msg_logz, (2, 2)))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=0,
                               atol=1e-10)


def test_infinite_regular_equals_complete_graph():
    J, h, beta, T = 0.4, 0.15, 0.8, 3
    spec = HomogeneousGlauberFactorSpec(J, h, beta)
    g = _complete(4)
    bp = tp.mpbp(g, tp.build_tables(g, [spec] * 4), T, D=12, device="cpu")
    bp, _, _ = tp.iterate(bp, maxiter=25, trunc=TRUNC, tol=1e-12)
    gi = tp.infinite_regular_graph(3)
    bpi = tp.mpbp_infinite_graph(3, tp.build_tables(gi, [spec]), T, D=12,
                                 device="cpu")
    bpi, _, _ = tp.iterate(bpi, maxiter=60, trunc=TRUNC, tol=1e-12)
    np.testing.assert_allclose(tp.beliefs(bpi).numpy()[0],
                               tp.beliefs(bp).numpy()[0], rtol=0, atol=1e-7)


def test_infinite_bipartite_symmetric_equals_regular():
    T, k = 3, 3
    spec = SISFactorSpec(0.25, 0.15, alpha=0.01)
    phi = np.ones((1, T + 1, 2))
    phi[0, 0] = [0.7, 0.3]
    bp1 = tp.mpbp_infinite_graph(k, tp.build_tables(
        tp.infinite_regular_graph(k), [spec]), T, D=16, phi=phi,
        device="cpu")
    bp1, _, _ = tp.iterate(bp1, maxiter=60, trunc=TRUNC, tol=1e-12)
    gb = tp.infinite_bipartite_graph(k, k)
    phi2 = np.ones((2, T + 1, 2))
    phi2[:, 0] = [0.7, 0.3]
    bp2 = tp.mpbp_infinite_bipartite_graph(
        (k, k), tp.build_tables(gb, [spec] * 2), T, D=16, phi=phi2,
        device="cpu")
    bp2, _, _ = tp.iterate(bp2, maxiter=60, trunc=TRUNC, tol=1e-12)
    b1, b2 = tp.beliefs(bp1).numpy()[0], tp.beliefs(bp2).numpy()
    np.testing.assert_allclose(b2[0], b1, rtol=0, atol=1e-8)
    np.testing.assert_allclose(b2[1], b1, rtol=0, atol=1e-8)
    assert abs(float(tp.bethe_free_energy(bp1))
               - tp.bethe_free_energy_infinite_bipartite(bp2)) < 1e-8


def test_infinite_graph_pair_route_free_energy():
    """As ``tests/test_infinite_and_equilibrium.py``: the pair route equals
    the ledger where the k-message fold is not truncated, which T=2 keeps
    at D=16 (the JAX test takes T=3 to D=24)."""
    k, T = 3, 2
    gi = tp.infinite_regular_graph(k)
    bpi = tp.mpbp_infinite_graph(k, tp.build_tables(
        gi, [HomogeneousGlauberFactorSpec(0.4, 0.15, 0.8)]), T, D=16,
        device="cpu")
    bpi, _, _ = tp.iterate(bpi, maxiter=60, trunc=TRUNC, tol=1e-12)
    assert abs(float(tp.bethe_free_energy_pair(bpi))
               - float(tp.bethe_free_energy(bpi))) < 1e-8
    _, logz = tp.pair_beliefs(bpi)
    lz_e = float(tp.pair_lognorms(bpi)[0])
    assert abs(float(logz[0]) - (1.0 / (k - 1) - 0.5) * lz_e) < 1e-12


def test_periodic_infinite_graph_vs_complete():
    """``tests/test_infinite_and_equilibrium.py::
    test_periodic_infinite_graph_vs_complete`` on the port: beliefs and pair
    beliefs, 1e-6.  K4 starts from the infinite graph's message on every
    edge, the JAX package's random one."""
    J, h, beta, k, Tp = 1.0, 0.0, 1.0, 3, 2
    phi1 = np.ones((1, Tp + 1, 2))
    phi1[0, 0] = [0.75, 0.25]
    phi1[0, 1] = [0.4, 0.6]
    phi1[0, 2] = [0.95, 0.05]
    jb = jinf.periodic_mpbp_infinite_graph(
        k, jbuild_tables(jinf.infinite_regular_graph(k), [JGS(J, h, beta)]),
        Tp, D=10, phi=phi1)
    msg = (np.array(jb.msg_cores[0]), np.array(jb.msg_logz[0]))
    spec = HomogeneousGlauberFactorSpec(J, h, beta)
    bpi = tp.periodic_mpbp_infinite_graph(
        k, tp.build_tables(tp.infinite_regular_graph(k), [spec]), Tp, D=10,
        phi=phi1, device="cpu", message=msg)
    np.testing.assert_allclose(bpi.msg_cores[0].numpy(),
                               np.asarray(jb.msg_cores[0]), rtol=1e-13,
                               atol=1e-15)
    # one damped sweep against the JAX package
    one = tp.bp_sweep(bpi, tp.TruncBond(10), damp=0.2)
    np.testing.assert_allclose(
        tp.beliefs(one).numpy(),
        np.asarray(mp.beliefs(mp.bp_sweep(jb, mp.TruncBond(10), damp=0.2))),
        rtol=0, atol=1e-10)
    N = k + 1
    g = _complete(N)
    bp = tp.periodic_mpbp(g, tp.build_tables(g, [spec] * N), Tp, D=10,
                          phi=np.broadcast_to(phi1, (N, Tp + 1, 2)).copy(),
                          device="cpu")
    bp = dataclasses.replace(bp, msg_cores=bpi.msg_cores.expand(
        (g.E,) + bpi.msg_cores.shape[1:]).clone())
    bpi, _, _ = tp.iterate(bpi, maxiter=150, trunc=tp.TruncBond(10),
                           tol=1e-12, damp=0.2)
    bp, _, _ = tp.iterate(bp, maxiter=150, trunc=tp.TruncBond(10), tol=1e-12,
                          damp=0.2)
    np.testing.assert_allclose(tp.beliefs(bpi).numpy()[0],
                               tp.beliefs(bp).numpy()[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.pair_beliefs(bpi)[0].numpy()[0],
                               tp.pair_beliefs(bp)[0].numpy()[0], rtol=0,
                               atol=1e-6)
