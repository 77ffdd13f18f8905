"""The port's chunked sweeps (``bp_sweep_chunked``, ``iterate(chunk=,
schedule=, shuffle=)``) against the JAX package, its own monolithic sweep
and enumeration (f64, CPU).

One sweep on a graph of mixed degrees (four buckets, chunks of 3 nodes, the
last one short), Jacobi and Gauss-Seidel (with the same numpy permutation
on both sides), ``qr`` and ``sketch`` with the JAX package's sketches:
messages' marginals, beliefs and ``f`` to 1e-10.  Chunked Jacobi equals the
monolithic sweep to 1e-12 (``tests/test_chunked_sweep.py``) and leaves the
caller's state intact; iterated in chunks of 2 on a tree it reaches
enumeration (1e-9).  The shuffle permutes each bucket as the JAX package's
does, and chunks visit the nodes in that order.  The Gauss-Seidel schedule
on a frustrated graph is in ``test_torch_seidel.py``.
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import bp as jbp
from matrixproductbp_tpu.models.sis import SISFactorSpec as JSISFactorSpec
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.models import SISFactorSpec
from matrixproductbp_tpu_torch.ops.tensortrain import TensorTrain, marginals
from test_torch_sweep_svd import JaxSketches

# star-ish + chain: degrees 1..4, four buckets (tests/test_chunked_sweep.py)
MIXED = (10, [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (4, 5), (5, 6),
              (6, 7), (7, 8), (8, 9), (2, 9)])
TREE5 = (5, [(0, 1), (1, 2), (1, 3), (3, 4)])
TRUNC = {"qr": (tp.TruncThresh(0.0), mp.TruncThresh(0.0)),
         "sketch": (tp.TruncBond(8), mp.TruncBond(8))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sis_pair(graph, T, D):
    N, edges = graph
    jg, tg = mp.graph_from_edges(N, edges), tp.graph_from_edges(N, edges)
    jb = mp.mpbp(jg, mp.build_tables(jg, [JSISFactorSpec(0.2, 0.3)] * N),
                 T=T, D=D)
    tb = tp.mpbp(tg, tp.build_tables(tg, [SISFactorSpec(0.2, 0.3)] * N),
                 T=T, D=D, device="cpu")
    return jb, tb


def _msg_marginals(c, lz, q):
    """Marginals of the messages' trains: what they represent, up to the
    QR and SVD sign choices that differ between torch and XLA."""
    return marginals(TensorTrain(torch.as_tensor(np.asarray(c)),
                                 torch.as_tensor(np.asarray(lz)), (q, q)))


@pytest.mark.parametrize("schedule", ["jacobi", "seidel"])
@pytest.mark.parametrize("method", ["qr", "sketch"])
def test_chunked_sweep_matches_jax(method, schedule):
    jb, tb = _sis_pair(MIXED, 3, 8)
    trunc, jtrunc = TRUNC[method]
    seidel = schedule == "seidel"
    jb = mp.bp_sweep_chunked(jb, jtrunc, method=method, chunk=3,
                             schedule=schedule,
                             rng=np.random.default_rng(0) if seidel else None)
    tb = tp.bp_sweep_chunked(tb, trunc, method=method, chunk=3,
                             schedule=schedule,
                             rng=np.random.default_rng(0) if seidel else None,
                             sketches=JaxSketches())
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), atol=1e-10)
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), atol=1e-10)
    np.testing.assert_allclose(
        _msg_marginals(tb.msg_cores, tb.msg_logz, 2).numpy(),
        _msg_marginals(jb.msg_cores, jb.msg_logz, 2).numpy(), atol=1e-10)


@pytest.mark.parametrize("method", ["qr", "sketch"])
def test_chunked_equals_monolithic(method):
    """The belief trains are compared by their marginals: the sketch
    conversion of a one-node chunk rounds differently, and its solve
    amplifies that into the trains' gauge (5e-4 in the cores, 3e-16 in
    the marginals)."""
    _, tb = _sis_pair(MIXED, 4, 8)
    trunc = TRUNC[method][0]
    a = tp.bp_sweep(tb, trunc, method=method)
    b = tp.bp_sweep_chunked(tb, trunc, method=method, chunk=3)
    for name in ("msg_cores", "msg_logz", "bel_logz", "f"):
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   getattr(a, name).numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(tp.beliefs(b).numpy(), tp.beliefs(a).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_chunked_preserves_input_state():
    _, tb = _sis_pair(MIXED, 3, 6)
    before = {n: getattr(tb, n).clone() for n in
              ("msg_cores", "msg_logz", "bel_cores", "bel_logz", "f")}
    tp.bp_sweep_chunked(tb, tp.TruncBond(6), method="sketch", chunk=4,
                        schedule="seidel", rng=np.random.default_rng(1))
    for n, t in before.items():
        assert torch.equal(getattr(tb, n), t), n


def test_chunked_iterate_converges_to_oracle():
    _, tb = _sis_pair(TREE5, 2, 8)
    tb, n, _ = tp.iterate(tb, maxiter=20, trunc=tp.TruncThresh(0.0),
                          tol=1e-12, chunk=2)
    assert n < 20
    err = np.abs(tp.beliefs(tb).numpy() - exact.exact_marginals(tb)).max()
    assert err < 1e-9



def test_shuffle_draws_like_jax(monkeypatch):
    """One permutation a bucket a sweep, in bucket order, before chunking:
    the order the port's chunks visit the nodes is the JAX package's."""
    jb, tb = _sis_pair(MIXED, 2, 4)
    seen = {}
    for name, mod, g in (("port", tp.bp, tb.graph), ("jax", jbp, jb.graph)):
        rng = np.random.default_rng(5)
        seen[name] = [rng.permutation(idx)
                      for idx, _ in mod._degree_buckets(g)]
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    visited = []
    update = tp.bp._update_nodes

    def spy(sw, idx, *a, **k):
        visited.append(np.array(idx))
        return update(sw, idx, *a, **k)

    monkeypatch.setattr(tp.bp, "_update_nodes", spy)
    tp.bp_sweep_chunked(tb, tp.TruncBond(4), method="sketch", chunk=3,
                        schedule="seidel", rng=np.random.default_rng(5))
    chunks = [p[lo:lo + 3] for p in seen["jax"] for lo in range(0, len(p), 3)]
    assert len(visited) == len(chunks)
    for a, b in zip(visited, chunks):
        np.testing.assert_array_equal(a, b)
