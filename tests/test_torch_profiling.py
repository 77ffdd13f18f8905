"""The port's roofline module against the JAX package's (f64, CPU).

``sweep_flops_estimate`` gives the JAX package's FLOP count for the same
state (SIS, Glauber with its banded y-axis, SIRS with q = 3; both
methods); ``roofline_report`` times sweeps on the state's device and gives
no H100 utilization for a CPU state.
"""
import numpy as np
import pytest
import torch

import matrixproductbp_tpu as mp
from matrixproductbp_tpu.models import (Glauber as JGlauber, Ising as JIsing,
                                        SIRS as JSIRS, SIS as JSIS,
                                        mpbp_glauber as jmpbp_glauber,
                                        mpbp_sirs as jmpbp_sirs,
                                        mpbp_sis as jmpbp_sis)
from matrixproductbp_tpu.utils import profiling as jprofiling

import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch.models import (Glauber, Ising, SIRS, SIS,
                                              mpbp_glauber, mpbp_sirs,
                                              mpbp_sis)
from matrixproductbp_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(model):
    edges = [(0, 1), (0, 2), (2, 3), (2, 4), (2, 5)]
    g, jg = tp.graph_from_edges(6, edges), mp.graph_from_edges(6, edges)
    if model == "sis":
        return (mpbp_sis(SIS(g, 0.2, 0.1, T=4, gamma=0.3), D=6, device="cpu"),
                jmpbp_sis(JSIS(jg, 0.2, 0.1, T=4, gamma=0.3), D=6))
    if model == "glauber":
        J, h = [0.5] * len(edges), [0.1] * 6
        return (mpbp_glauber(Glauber(Ising(g, J=J, h=h, beta=0.7), T=3), D=5,
                             device="cpu"),
                jmpbp_glauber(JGlauber(JIsing(jg, J=J, h=h, beta=0.7), T=3),
                              D=5))
    return (mpbp_sirs(SIRS(g, 0.3, 0.2, 0.15, T=3, gamma=0.4), D=4,
                      device="cpu"),
            jmpbp_sirs(JSIRS(jg, 0.3, 0.2, 0.15, T=3, gamma=0.4), D=4))


@pytest.mark.parametrize("model", ["sis", "glauber", "sirs"])
@pytest.mark.parametrize("method", ["sketch", "qr"])
def test_sweep_flops_estimate_equals_jax(model, method):
    bp, jbp = _states(model)
    assert bp.tables.Y == jbp.tables.Y and bp.q == jbp.q
    got = profiling.sweep_flops_estimate(bp, method)
    assert got > 0 and got == jprofiling.sweep_flops_estimate(jbp, method)


def test_roofline_report_on_the_cpu():
    bp, _ = _states("sis")
    rep = profiling.roofline_report(bp, tp.TruncBond(6), reps=1)
    assert rep["device"] == "cpu" and rep["h100_f32_utilization"] is None
    assert rep["sweep_seconds"] > 0
    assert np.isclose(rep["achieved_flops_per_s"] * rep["sweep_seconds"],
                      profiling.sweep_flops_estimate(bp))
    assert rep["edge_updates_per_s"] == bp.graph.E / rep["sweep_seconds"]
