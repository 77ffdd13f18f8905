"""The port's belief normalizations and pair-route free energy against
the JAX package and enumeration (f64, CPU).

``belief_lognorms`` per degree bucket against the JAX package's vmapped
one on the same state, to 1e-10: ``qr`` and ``randomized`` on a star with
a degree-4 node at D=4, ``sketch`` on a cycle with the JAX package's PRNGKey(17)
sketches; ``bethe_free_energy_pair`` likewise, and against the sweep's
ledger and -log Z from enumeration.  The log-norm taken from the MPEM3
directly equals the one of its MPEM2 conversion.  (And the q=3 case of
the pair, alternate and two-time marginals of
``test_torch_observables.py``, kept here to balance the two files' time.)
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.ops.mpem import mpem3_lognorm, mpem3_to_mpem2
from test_torch_observables import (STAR5, TREE4, _close,  # noqa: F401
                                    _one_torch_thread, _sis, star5, to_jax)
from test_torch_sweep_svd import JaxSketches

CYCLE5 = (5, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)])


def test_mpem3_lognorm_equals_the_conversion_route():
    """The belief normalization taken from the MPEM3 directly equals the
    log-norm of its MPEM2 conversion (the conversion keeps the sum)."""
    g = torch.Generator().manual_seed(1)
    B = torch.rand((3, 5, 4, 4, 2, 3, 2), generator=g, dtype=torch.float64)
    B[:, 0, 1:] = 0
    B[:, -1, :, 1:] = 0
    lz = torch.tensor([0.1, 0.2, -0.3], dtype=torch.float64)
    lg, sg = mpem3_lognorm(B, lz)
    lg2, sg2 = tp.lognorm(mpem3_to_mpem2(B, lz))
    _close(lg, lg2, 1e-12)
    assert torch.equal(sg, sg2)


@pytest.fixture(scope="module")
def star5_d4(tmp_path_factory):
    """The observed star at D=4 (three ``qr`` sweeps; the merges' bond 16
    keeps the JAX package's compile short), in both packages."""
    phi = np.ones((5, 3, 2))
    phi[:, 0] = [0.6, 0.4]
    phi[4, 2] = [0.2, 0.8]
    tb = _sis(STAR5, D=4, phi=phi)
    for _ in range(3):
        tb = tp.bp_sweep(tb, tp.TruncThresh(0.0))
    return to_jax(tb, tmp_path_factory.mktemp("s5") / "s.npz"), tb


@pytest.mark.parametrize("case", ["star5_qr", "cycle5_sketch",
                                  "star5_randomized"])
def test_belief_lognorms_and_pair_free_energy_match_jax(case, star5_d4,
                                                        tmp_path):
    """``belief_lognorms`` per bucket against the JAX package's vmapped
    one: ``qr`` on the star (a degree-4 node); ``sketch`` on a cycle (one
    bucket, no padded slot) with the JAX package's PRNGKey(17) sketches;
    ``randomized`` with its Gaussian trains.  Then the pair-route free
    energy."""
    if case.startswith("star5"):
        jb, tb = star5_d4
        method, trunc, jtrunc = case.split("_")[1], None, None
    else:
        tb = tp.bp_sweep(tp.bp_sweep(_sis(CYCLE5, T=3, D=4),
                                     tp.TruncThresh(0.0)),
                         tp.TruncThresh(0.0))
        jb = to_jax(tb, tmp_path / "c5.npz")
        method, trunc, jtrunc = "sketch", tp.TruncBond(4), mp.TruncBond(4)
    lz = tp.belief_lognorms(tb, trunc=trunc, method=method,
                            sketches=JaxSketches())
    jlz = mp.belief_lognorms(jb, trunc=jtrunc, method=method)
    _close(lz, jlz)
    if method == "qr":
        _close(tp.bethe_free_energy_pair(tb), mp.bethe_free_energy_pair(jb))


def test_belief_lognorms_on_the_sweeps_beliefs(star5):
    """At the fixed point the rebuilt belief normalizations are what the
    sweep itself normalized by: f_i = (d_i/2 - 1) log z_i - ... holds with
    them, i.e. the pair route gives the ledger's free energy."""
    _, tb = star5
    _close(tp.bethe_free_energy_pair(tb), tp.bethe_free_energy(tb), 1e-9)
    _close(tp.bethe_free_energy_pair(tb, trunc=tp.TruncBond(16),
                                     method="sketch"),
           tp.bethe_free_energy(tb), 1e-8)


def test_degree4_tree_matches_exact(star5):
    """The degree-4 node's bucket (prefix folds over 4 slots) on every
    observable against enumeration."""
    _, tb = star5
    p, Z = exact.exact_prob(tb)
    np.testing.assert_allclose(tp.pair_beliefs(tb)[0].numpy(),
                               exact.exact_pair_marginals(tb, p), atol=1e-8)
    np.testing.assert_allclose(tp.autocovariances(tb).numpy(),
                               exact.exact_autocovariances(tb, p=p),
                               atol=1e-8)
    assert np.isclose(-float(tp.bethe_free_energy_pair(tb)), np.log(Z),
                      atol=1e-9)


def test_pair_and_time_observables_q3_match_jax(tmp_path):
    """SIRS (q=3, per-node tables) after two ``qr`` sweeps: the pair,
    alternate and two-time marginals against the JAX package's."""
    from matrixproductbp_tpu_torch.models import SIRS, mpbp_sirs
    tb = mpbp_sirs(SIRS(tp.graph_from_edges(*TREE4), 0.3, 0.2, 0.15, T=2,
                        gamma=0.4), D=4, device="cpu")
    for _ in range(2):
        tb = tp.bp_sweep(tb, tp.TruncThresh(0.0))
    jb = to_jax(tb, tmp_path / "sirs.npz")
    _close(tp.pair_beliefs(tb)[0], mp.pair_beliefs(jb)[0])
    _close(tp.alternate_marginals(tb), mp.alternate_marginals(jb))
    _close(tp.beliefs_tu(tb), mp.beliefs_tu(jb))
