"""The Restricted (dense ``prob_yy``) Glauber tables through the port's
grouped per-node update against the JAX package (f64, CPU, the JAX
package's sketches): one sweep of a Glauber tree by each method, beliefs
and the free-energy ledger ``f`` to 1e-9 (the dense twin of
``test_torch_models.py::test_banded_sweep_matches_jax``)."""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu import factors as jfactors
from matrixproductbp_tpu.models import glauber as jglauber
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch.models import glauber as tglauber
from test_torch_models import H, METHODS, TREE, _assert_one_sweep_matches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's intra-op threads would only contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method,D,trunc,jtrunc", METHODS,
                         ids=[m[0] for m in METHODS])
def test_restricted_sweep_matches_jax(method, D, trunc, jtrunc):
    jg, tg = mp.graph_from_edges(*TREE), tp.graph_from_edges(*TREE)
    phi = np.ones((4, 3, 2))
    phi[:, 0] = [0.7, 0.3]
    jspecs = [jfactors.RestrictedFactorSpec(
        jglauber.HomogeneousGlauberFactorSpec(0.5, h, 0.7)) for h in H]
    tspecs = [tp.RestrictedFactorSpec(
        tglauber.HomogeneousGlauberFactorSpec(0.5, h, 0.7)) for h in H]
    jb = mp.mpbp(jg, jfactors.build_tables(jg, jspecs), 2, D, phi=phi)
    tb = tp.mpbp(tg, tp.build_tables(tg, tspecs), 2, D, phi=phi,
                 device="cpu")
    assert tb.tables.yy_off is None and tb.tables.Pyy.shape[0] == 4
    _assert_one_sweep_matches(jb, tb, method, jtrunc, trunc)
