"""Buckets padded past a node's degree: the port's sweeps against the JAX
package's on the tree of ``tests/test_batched_sweep.py:124`` (degrees 1-5,
buckets K = 1, 2, 4, 5, so the K = 4 bucket pads its degree-3 node), four
sweeps of each method, f64, CPU, the same sketches.  JAX takes its default
path (vmapped, under 256 nodes a bucket).  Measured in beliefs after four
sweeps: 2.4e-10 (sketch; also after ten), 1.5e-15 (qr), 7.7e-12
(randomized) (ROADMAP Queue 3).  A file of its own because each method
costs one JAX compile of the whole sweep, 7-30 s on a CPU core.
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
import matrixproductbp_tpu_torch as tp
from test_torch_sweep_svd import JaxSketches, _pair

PADDED = (12, [(0, i) for i in range(1, 6)] + [(1, i) for i in range(6, 9)]
          + [(2, 9), (2, 10), (3, 11)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method,tol", [("sketch", 1e-8), ("qr", 1e-12),
                                        ("randomized", 1e-10)])
def test_padded_buckets_match_jax(method, tol):
    jb, tb = _pair(PADDED, 3, 8, 0.3, 0.2, 0.3)
    assert sorted(k for _, k in tp.bp._degree_buckets(tb.graph)) == [1, 2,
                                                                     4, 5]
    for _ in range(4):
        jb = mp.bp_sweep(jb, mp.TruncBond(8), method=method)
        tb = tp.bp_sweep(tb, tp.TruncBond(8), method=method,
                         sketches=JaxSketches())
    np.testing.assert_allclose(tp.beliefs(tb).numpy(),
                               np.asarray(mp.beliefs(jb)), rtol=0, atol=tol)
