"""Compression methods of the port against each other (``method="qr"``
against ``"randomized"``, the JAX package's ``test_methods_consistency.py``
gate) and the randomized sweep's float32 tier against float64, on the port
alone (f64 and f32, CPU)."""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch.models import SIS, mpbp_sis


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores (one sweep test ran 40x
    slower beside a second worker with them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_randomized_matches_qr_bench_shape():
    """3-regular, T=15, D=12 (the bench configuration cut in N): the
    randomized merge agrees with the Kronecker merge when the bond capacity
    is generous (``test_methods_consistency.py:48-59``)."""
    g = tp.random_regular_graph(8, 3, np.random.default_rng(3))
    sis = SIS(g, 0.2, 0.1, T=15, gamma=0.3)
    out = {}
    for method in ("qr", "randomized"):
        tb = mpbp_sis(sis, D=12, device="cpu")
        tb, _, _ = tp.iterate(tb, maxiter=8, trunc=tp.TruncBond(12), tol=0.0,
                              method=method)
        out[method] = tp.beliefs(tb).numpy()
    assert np.abs(out["qr"] - out["randomized"]).max() < 5e-5


@pytest.mark.parametrize("N,D", [(32, 10), (16, 20)])
def test_f32_randomized_sweep_stays_finite(N, D):
    """float32 at sketch width s = 2D: the CholQR factors in float64.  The
    JAX package's float32 randomized sweep on the N=32 graph returns
    non-finite beliefs after one D=10 sweep (ROADMAP Queue 3)."""
    g = tp.random_regular_graph(N, 3, np.random.default_rng(0))
    sis = SIS(g, 0.2, 0.1, T=15, gamma=0.3)
    b = {}
    for dtype in (torch.float32, torch.float64):
        tb = tp.bp_sweep(mpbp_sis(sis, D=D, dtype=dtype, device="cpu"),
                         tp.TruncBond(D), method="randomized")
        b[dtype] = tp.beliefs(tb)
    assert b[torch.float32].dtype == torch.float32
    assert bool(torch.isfinite(b[torch.float32]).all())
    assert float((b[torch.float32].double()
                  - b[torch.float64]).abs().max()) < 1e-4
