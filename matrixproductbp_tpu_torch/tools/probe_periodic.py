"""Where periodic BP on the card parts from the host, and why.

    python3 -m matrixproductbp_tpu_torch.tools.probe_periodic [--maxiter=150]

Runs, in float64, periodic Glauber on the infinite 3-regular graph and on
K4 from the same message (``tests/test_infinite_and_equilibrium.py::
test_periodic_infinite_graph_vs_complete``: T=2, D=10, ``TruncBond(10)``,
damping 0.2), and the observed periodic SIS path of ``tests/
test_periodic.py`` (T=2) against enumeration, at D=32 with
``TruncThresh(0.0)`` (the JAX test's setting) and at D=16 with
``TruncThresh(1e-12)``, each by several routes (``--routes``): ``card``
as the port runs it (f64 SVDs by cuSOLVER's ``gesvd``); ``card_default``
with ``torch.linalg.svd``'s default driver; ``card_host_svd`` with every
SVD (and the periodic sweep's QR) computed on the host; and ``host``.  One
JSON line a route: iterations, the last deltas, the distance between the
two graphs' beliefs and pair beliefs (or from enumeration), and each
route's distance from the host's one-sweep and converged beliefs.  Needs a
CUDA card.
"""
import argparse
import dataclasses
import json
import time

import numpy as np
import torch

import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import exact
from matrixproductbp_tpu_torch.models import (HomogeneousGlauberFactorSpec,
                                              sis_tables)
from matrixproductbp_tpu_torch.ops import mpem as mpm
from matrixproductbp_tpu_torch.ops import tensortrain as ttm


def emit(**kv):
    print(json.dumps(kv), flush=True)


_SVD, _ORTH = ttm.batched_svd, ttm._right_orth


def _host_svd(M):
    U, S, Vh = torch.linalg.svd(M.cpu(), full_matrices=False)
    return U.to(M.device), S.to(M.device), Vh.to(M.device)


def _host_orth(M):
    Rt, Qt = _ORTH(M.cpu())
    return Rt.to(M.device), Qt.to(M.device)


def _default_svd(M):
    return torch.linalg.svd(M, full_matrices=False)


def route(name):
    """Set the SVD and LQ routes the periodic sweep takes."""
    svd, orth = {"card": (_SVD, _ORTH), "host": (_SVD, _ORTH),
                 "card_host_svd": (_host_svd, _host_orth),
                 "card_default": (_default_svd, _ORTH)}[name]
    ttm.batched_svd = mpm.batched_svd = svd
    ttm._right_orth = orth
    return "cpu" if name == "host" else "cuda"


def glauber_pair(dev, maxiter):
    J, h, beta, k, Tp = 1.0, 0.0, 1.0, 3, 2
    phi1 = np.ones((1, Tp + 1, 2))
    phi1[0, 0] = [0.75, 0.25]
    phi1[0, 1] = [0.4, 0.6]
    phi1[0, 2] = [0.95, 0.05]
    spec = HomogeneousGlauberFactorSpec(J, h, beta)
    bpi = tp.periodic_mpbp_infinite_graph(
        k, tp.build_tables(tp.infinite_regular_graph(k), [spec]), Tp, D=10,
        phi=phi1, device=dev)
    N = k + 1
    g = tp.graph_from_edges(N, [(i, j) for i in range(N) for j in range(i)])
    bp = tp.periodic_mpbp(g, tp.build_tables(g, [spec] * N), Tp, D=10,
                          phi=np.broadcast_to(phi1, (N, Tp + 1, 2)).copy(),
                          device=dev)
    bp = dataclasses.replace(bp, msg_cores=bpi.msg_cores.expand(
        (g.E,) + bpi.msg_cores.shape[1:]).clone())
    out = {}
    for name, st in (("inf", bpi), ("k4", bp)):
        one = tp.bp_sweep(st, tp.TruncBond(10), damp=0.2)
        t0 = time.perf_counter()
        st, it, deltas = tp.iterate(st, maxiter=maxiter,
                                    trunc=tp.TruncBond(10), tol=1e-12,
                                    damp=0.2)
        out[name] = {"one": tp.beliefs(one)[0].cpu().numpy(),
                     "b": tp.beliefs(st)[0].cpu().numpy(),
                     "pb": tp.pair_beliefs(st)[0][0].cpu().numpy(),
                     "it": it, "tail": deltas[-3:],
                     "s": time.perf_counter() - t0}
    return out


def sis_path(dev, maxiter, D, eps):
    g3 = tp.graph_from_edges(3, [(0, 1), (1, 2)])
    phi3 = np.ones((3, 3, 2))
    phi3[0, 1] = [0.8, 0.2]
    phi3[2, 0] = [0.3, 0.7]
    st = tp.periodic_mpbp(g3, sis_tables(g3, 0.35, 0.25), 2, D=D, phi=phi3,
                          device=dev)
    one = tp.bp_sweep(st, tp.TruncThresh(eps))
    st, it, deltas = tp.iterate(st, maxiter=maxiter,
                                trunc=tp.TruncThresh(eps), tol=1e-13)
    p, Z = exact.exact_prob(st)
    b = tp.beliefs(st).cpu().numpy()
    return {"one": tp.beliefs(one).cpu().numpy(), "b": b, "it": it,
            "tail": deltas[-3:],
            "beliefs_vs_exact": float(np.abs(
                b - exact.exact_marginals(st, p)).max()),
            "free_energy_vs_exact": abs(
                -float(tp.bethe_free_energy(st)) - np.log(Z))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=150)
    ap.add_argument("--routes", default="host,card,card_default")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = {}
    for name in a.routes.split(","):
        dev = route(name)
        gl = glauber_pair(dev, a.maxiter)
        paths = {f"path{D}": sis_path(dev, 12, D, eps)
                 for D, eps in ((32, 0.0), (16, 1e-12))}
        if name == "host":
            ref = {"inf": gl["inf"], "k4": gl["k4"], **paths}

        def d(x, y):
            return float(np.abs(x - y).max()) if ref else None
        emit(route=name,
             inf_vs_k4_beliefs=float(np.abs(gl["inf"]["b"]
                                            - gl["k4"]["b"]).max()),
             inf_vs_k4_pairs=float(np.abs(gl["inf"]["pb"]
                                          - gl["k4"]["pb"]).max()),
             **{f"{g}_{k}": gl[g][k] for g in ("inf", "k4")
                for k in ("it", "tail", "s")},
             **({f"{g}_{w}_vs_host": d(gl[g][w], ref[g][w])
                 for g in ("inf", "k4") for w in ("one", "b")} if ref else {}),
             **{f"{p}_{k}": sp[k] for p, sp in paths.items()
                for k in ("it", "tail", "beliefs_vs_exact",
                          "free_energy_vs_exact")},
             **({f"{p}_{w}_vs_host": d(sp[w], ref[p][w])
                 for p, sp in paths.items() for w in ("one", "b")}
                if ref else {}))
    route("card")


if __name__ == "__main__":
    main()
