"""Does the JAX package's f64 sketch iterate on an Erdos-Renyi Glauber graph
diverge as the port's does?  A one-off probe, not a test (pytest does not
collect it); it imports both packages, so it lives beside the tests and not
in the port, which imports no JAX.

    JAX_PLATFORMS=cpu python tests/probe_glauber_er_sketch.py [--n=300]
        [--sweeps=20] [--D=10]

Homogeneous Glauber (chip_smoke.py's J=1, h=0.1, beta=0.6) on
``erdos_renyi_graph(n, 2.5, default_rng(0))``, T=15, f64, ``method="sketch"``
with ``TruncBond(D)``: each package's Jacobi ``iterate`` one sweep at a time,
the port fed the JAX package's ``PRNGKey(17)`` sketches (``JaxSketches``).
Prints, a line a sweep, both packages' belief deltas (max-abs change of the
beliefs over the sweep), the largest |belief| outside [0, 1] and the
beliefs' distance between the two packages, then one JSON summary line.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import matrixproductbp_tpu as mp  # noqa: E402
from matrixproductbp_tpu.models import glauber as jglauber  # noqa: E402
import matrixproductbp_tpu_torch as tp  # noqa: E402
from matrixproductbp_tpu_torch.models import glauber as tglauber  # noqa: E402
from test_torch_sweep_svd import JaxSketches  # noqa: E402

J, H, BETA, C, T = 1.0, 0.1, 0.6, 2.5, 15


def states(n, D):
    jg = mp.erdos_renyi_graph(n, C, np.random.default_rng(0))
    tg = tp.erdos_renyi_graph(n, C, np.random.default_rng(0))
    assert np.array_equal(jg.degree, tg.degree)
    ne = jg.E // 2
    jb = jglauber.mpbp_glauber(jglauber.Glauber(jglauber.Ising(
        jg, np.full(ne, J), np.full(n, H), BETA), T), D=D)
    tb = tglauber.mpbp_glauber(tglauber.Glauber(tglauber.Ising(
        tg, np.full(ne, J), np.full(n, H), BETA), T), D=D,
        dtype=torch.float64, device="cpu")
    return jb, tb


def outside(b):
    """How far the beliefs leave [0, 1]."""
    return float(max(0.0, -b.min(), b.max() - 1.0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--D", type=int, default=10)
    a = ap.parse_args()
    torch.set_num_threads(4)
    jb, tb = states(a.n, a.D)
    degrees = np.bincount(np.asarray(jb.graph.degree)).tolist()
    jtrunc, ttrunc = mp.TruncBond(a.D), tp.TruncBond(a.D)
    rows = []
    for it in range(a.sweeps):
        t0 = time.perf_counter()
        jb, _, jd = mp.iterate(jb, maxiter=1, trunc=jtrunc, tol=0.0,
                               method="sketch")
        t1 = time.perf_counter()
        tb, _, td = tp.iterate(tb, maxiter=1, trunc=ttrunc, tol=0.0,
                               method="sketch", sketches=JaxSketches())
        t2 = time.perf_counter()
        jbel = np.asarray(mp.beliefs(jb))
        tbel = tp.beliefs(tb).numpy()
        rows.append({"sweep": it + 1, "jax_delta": float(jd[-1]),
                     "port_delta": float(td[-1]),
                     "jax_outside_01": outside(jbel),
                     "port_outside_01": outside(tbel),
                     "beliefs_jax_vs_port": float(np.abs(jbel - tbel).max()),
                     "jax_s": t1 - t0, "port_s": t2 - t1})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"n": a.n, "T": T, "D": a.D, "sweeps": a.sweeps,
                      "nodes_by_degree": degrees,
                      "jax_last_delta": rows[-1]["jax_delta"],
                      "port_last_delta": rows[-1]["port_delta"],
                      "jax_max_outside_01": max(r["jax_outside_01"]
                                                for r in rows),
                      "port_max_outside_01": max(r["port_outside_01"]
                                                 for r in rows),
                      "max_beliefs_jax_vs_port": max(
                          r["beliefs_jax_vs_port"] for r in rows)}))


if __name__ == "__main__":
    main()
