"""The port's Gauss-Seidel schedule with a per-sweep shuffle
(``iterate(schedule="seidel", shuffle=True)``) against the JAX package
(f64, CPU), on ``tests/test_seidel_schedule.py``'s cases.

On the frustrated K4 antiferromagnet (Glauber, beta = 3, T=4, D=8) Jacobi
is still moving after 25 sweeps while shuffled Gauss-Seidel converges
(tol 1e-6), near Jacobi's beliefs (5e-3); its first six sweeps follow
the JAX package's (beliefs to 1e-8): the same numpy permutations give the
same schedule.  On a tree both schedules reach the same fixed point
(1e-9).
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu.models import Glauber as JGlauber, Ising as JIsing
from matrixproductbp_tpu.models import mpbp_glauber as jmpbp_glauber
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch.models import Glauber, Ising, mpbp_glauber


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frustrated_k4(ising, glauber, T=4):
    """tests/test_seidel_schedule.py's K4 antiferromagnet, beta = 3."""
    rng = np.random.default_rng(3)
    n = 4
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)]
    g = (mp if ising is JIsing else tp).graph_from_edges(n, edges)
    return glauber(ising(g, J=-1.0 * np.ones(g.E // 2),
                         h=rng.normal(0, 0.2, n), beta=3.0), T=T)


def test_seidel_converges_where_jacobi_stalls():
    tol = 1e-6
    gl = _frustrated_k4(Ising, Glauber)
    bp_j, nj, dj = tp.iterate(mpbp_glauber(gl, D=8, device="cpu"),
                              maxiter=25, trunc=tp.TruncBond(8), tol=tol)
    assert nj == 25 and dj[-1] > tol
    bp_s, ns, ds = tp.iterate(mpbp_glauber(gl, D=8, device="cpu"),
                              maxiter=25, trunc=tp.TruncBond(8), tol=tol,
                              schedule="seidel", shuffle=True, chunk=2)
    assert ns < 25 and ds[-1] < tol
    assert np.allclose(tp.beliefs(bp_j).numpy(), tp.beliefs(bp_s).numpy(),
                       atol=5e-3)
    # the JAX package's first sweeps of the same schedule, sweep for sweep
    # (its 18 sweeps to convergence take ~20 s on the CPU)
    jgl = _frustrated_k4(JIsing, JGlauber)
    jb, _, jd = mp.iterate(jmpbp_glauber(jgl, D=8), maxiter=6,
                           trunc=mp.TruncBond(8), tol=0.0, schedule="seidel",
                           shuffle=True, chunk=2)
    tb, _, td = tp.iterate(mpbp_glauber(gl, D=8, device="cpu"), maxiter=6,
                           trunc=tp.TruncBond(8), tol=0.0, schedule="seidel",
                           shuffle=True, chunk=2)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), atol=1e-8)


def test_seidel_shuffle_matches_jacobi_on_tree():
    g = tp.graph_from_edges(4, [(0, 1), (0, 2), (2, 3)])
    rng = np.random.default_rng(1)
    gl = Glauber(Ising(g, J=0.5 * np.ones(g.E // 2),
                       h=rng.normal(0, 0.3, g.N), beta=1.0), T=3)
    bp_j, _, _ = tp.iterate(mpbp_glauber(gl, D=16, device="cpu"),
                            maxiter=12, trunc=tp.TruncThresh(0.0),
                            tol=1e-13)
    bp_s, _, _ = tp.iterate(mpbp_glauber(gl, D=16, device="cpu"),
                            maxiter=12, trunc=tp.TruncThresh(0.0),
                            tol=1e-13, schedule="seidel", shuffle=True,
                            chunk=1)
    np.testing.assert_allclose(tp.beliefs(bp_j).numpy(),
                               tp.beliefs(bp_s).numpy(), atol=1e-9)
