"""Rank functions of the port's multi-rank tests (torch only).

``parallel.spawn_ranks`` starts each rank in a spawned process, which
imports this module and not the test modules, so no rank imports JAX.
Every state is built from a seed in each rank; the tests build the same
ones in their own process (the ``*_state`` functions) for the single-device
reference.  Each function returns plain numpy and Python values.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

import matrixproductbp_tpu_torch as tp
from matrixproductbp_tpu_torch import bp as tbp
from matrixproductbp_tpu_torch import sampling, smc
from matrixproductbp_tpu_torch.models import (SIS, SISFactorSpec, mpbp_sis,
                                              periodic_mpbp_sis)
from matrixproductbp_tpu_torch.models.sis_heterogeneous import (
    SISHeterogeneous, mpbp_sis_heterogeneous)
from matrixproductbp_tpu_torch.parallel import (halo_beliefs,
                                                halo_bethe_free_energy,
                                                halo_mpbp, halo_sweep,
                                                halo_to_mpbp)


def mixed_ring(n):
    """A ring with chords at even nodes: degrees 2 and 4."""
    return tp.graph_from_edges(n, [(i, (i + 1) % n) for i in range(n)]
                               + [(i, (i + 2) % n) for i in range(0, n, 2)])


def wide_degrees():
    """A tree with degrees 1-6 (6 distinct: power-of-two buckets 1, 2, 4,
    6), and a partition in which each of 4 parts holds at most 3 distinct
    degrees (each rank alone would bucket by degree)."""
    edges, nxt = [(h, h + 1) for h in range(5)], 6     # a path of hubs
    for hub, deg in enumerate((6, 5, 4, 3, 2, 2)):
        while sum(hub in e for e in edges) < deg:
            edges.append((hub, nxt))                    # and leaves
            nxt += 1
    g = tp.graph_from_edges(nxt, edges)
    part = np.searchsorted([1, 2, 4], g.degree, side="left").astype(np.int32)
    return g, part


def halo_state(case):
    """(graph, state, sweeps, sweep kwargs, part) of each halo case."""
    if case == "match":
        g = tp.random_regular_graph(24, 3, np.random.default_rng(2))
        return g, mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=4, gamma=0.3), D=8,
                           device="cpu"), 5, {}, None
    if case == "damp":
        g = tp.random_regular_graph(16, 3, np.random.default_rng(4))
        return g, mpbp_sis(SIS(g, lam=0.25, rho=0.15, T=3, gamma=0.2), D=6,
                           device="cpu"), 4, {"damp": 0.3}, None
    if case == "het":
        rng = np.random.default_rng(7)
        g = tp.random_tree(10, rng)
        lam_d = rng.uniform(0.1, 0.5, size=g.E)
        rho = rng.uniform(0.1, 0.4, size=g.N)
        het = SISHeterogeneous(g, lam_d, rho, T=3, gamma=0.3)
        return g, mpbp_sis_heterogeneous(het, D=8, device="cpu"), 4, {}, None
    if case == "chunk":
        g = mixed_ring(24)
        return g, mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=3, gamma=0.25), D=6,
                           device="cpu"), 4, {"chunk": 2}, None
    if case == "buckets":
        g, part = wide_degrees()
        return g, mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=3, gamma=0.25), D=5,
                           device="cpu"), 3, {"method": "sketch"}, part
    if case == "direct_k3":
        g = tp.random_regular_graph(24, 3, np.random.default_rng(5))
        return g, mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=3, gamma=0.3), D=3,
                           device="cpu"), 3, {}, None
    if case == "tv":
        # a lockdown: lam 0.3 until t=2, then 0.1 (per-step tables)
        g = tp.random_regular_graph(16, 3, np.random.default_rng(6))
        T = 3
        specs = [[SISFactorSpec(0.3 if t < 2 else 0.1, 0.2)
                  for t in range(T + 1)]] * g.N
        phi = SIS(g, lam=0.3, rho=0.2, T=T, gamma=0.3).default_phi()
        return g, tp.mpbp(g, tp.build_tables_t(g, specs), T, 5, phi=phi,
                          device="cpu"), 3, {"method": "sketch"}, None
    if case == "periodic":
        g = tp.random_regular_graph(12, 3, np.random.default_rng(8))
        return g, periodic_mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=3,
                                        gamma=0.3), D=4, device="cpu"), \
            2, {}, None
    if case in ("cross", "cross_sketch"):
        g = tp.random_regular_graph(24, 3, np.random.default_rng(2))
        return g, mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=3, gamma=0.3), D=6,
                           device="cpu"), 3, \
            {"method": "sketch"} if case == "cross_sketch" else {}, None
    raise ValueError(case)


#: the halo cases, their ranks and the direct K = 3 threshold they run at
HALO_CASES = {"match": (8, None), "damp": (4, None), "het": (4, None),
              "chunk": (4, None), "buckets": (4, None),
              "direct_k3": (4, 8), "tv": (4, None), "periodic": (4, None),
              "cross": (4, None), "cross_sketch": (4, None),
              "cut": (4, None)}


class TableSketches:
    """A sketch source that looks each draw up by its shapes and dtype in
    ``table`` ({(phi_shape, psi_shape, str(dtype)): (phi, psi)}, numpy),
    which the test process fills with the JAX package's draws."""

    def __init__(self, table):
        self.table = table

    def draw(self, phi_shape, psi_shape, dtype, device):
        phi, psi = self.table[(tuple(phi_shape), tuple(psi_shape),
                               str(dtype))]
        return (torch.as_tensor(phi, device=device),
                torch.as_tensor(psi, device=device))


@contextlib.contextmanager
def direct_k3_calls():
    """The ``direct_k3`` argument of every ``bp._update_nodes`` call made
    inside the block, in a list."""
    calls, update = [], tbp._update_nodes

    def spy(*args, **kw):
        calls.append(args[6])
        return update(*args, **kw)
    tbp._update_nodes = spy
    try:
        yield calls
    finally:
        tbp._update_nodes = update


def _halo_case(case, group, sketches):
    if case == "cut":
        g = tp.random_regular_graph(64, 3, np.random.default_rng(0))
        bp = mpbp_sis(SIS(g, lam=0.3, rho=0.2, T=1, gamma=0.3), D=2,
                      device="cpu")
        st = halo_mpbp(bp, group=group, device="cpu")
        return {"rows_sent": st.rows_sent,
                "rows_received": sum(st.routes.recv_splits),
                "part": st.plan.part}
    g, bp, sweeps, kw, part = halo_state(case)
    D = bp.D
    st = halo_mpbp(bp, group=group, part=part, device="cpu")
    if case == "cross_sketch":
        kw = dict(kw, sketches=sketches)
    with direct_k3_calls() as calls:
        for _ in range(sweeps):
            st = halo_sweep(st, tp.TruncBond(D), **kw)
    out = {"beliefs": halo_beliefs(st, g).numpy(),
           "f": float(halo_bethe_free_energy(st)),
           "rows_sent": st.rows_sent, "direct_k3": calls}
    if case == "match":
        pb, lz = tp.pair_beliefs(halo_to_mpbp(st, bp))
        out.update(pair=pb.numpy(), pair_lognorms=lz.numpy())
    return out


def halo_cases(rank, world, sketch_table):
    """Every case of ``HALO_CASES`` on its ranks (a subgroup of the first
    ones); {case: this rank's result, or None where it sits out}.
    ``cross_sketch`` draws its sketches from ``sketch_table``
    (:class:`TableSketches`)."""
    res = {}
    for case, (nranks, k3) in HALO_CASES.items():
        group = dist.new_group(list(range(nranks)))   # every rank calls it
        if rank >= nranks:
            res[case] = None
            continue
        default = tbp.DIRECT_K3_MAX
        if k3 is not None:
            tbp.DIRECT_K3_MAX = k3
        try:
            res[case] = _halo_case(case, group,
                                   TableSketches(sketch_table))
        finally:
            tbp.DIRECT_K3_MAX = default
    return res


def observed_tree(T=3, seed=3):
    """The 4-node observed tree of ``tests/test_torch_smc.py``."""
    g = tp.graph_from_edges(4, [(0, 1), (1, 2), (1, 3)])
    tables = tp.build_tables(g, [SISFactorSpec(lam=0.3, rho=0.25)] * g.N)
    phi = np.ones((g.N, T + 1, 2))
    phi[:, 0] = [0.6, 0.4]
    bp = tp.mpbp(g, tables, T=T, D=8, phi=phi, device="cpu")
    bp, _, _ = sampling.draw_node_observations(
        bp, 5, np.random.default_rng(seed), softinf=20.0,
        generator=torch.Generator().manual_seed(9))
    return bp


#: (ranks, particles, particles a batch, generator seed) of each SMC run
SMC_CASES = {"two": (2, 1000, 96, 2), "four": (4, 1000, 96, 2),
             "posterior": (4, 16384, None, 0)}


def smc_cases(rank, world):
    """Every run of ``SMC_CASES`` on its ranks: {case: (X, logw,
    log_evidence) of this rank's particles, or None}."""
    res = {}
    bp = observed_tree()
    for case, (nranks, P, batch, seed) in SMC_CASES.items():
        group = dist.new_group(list(range(nranks)))
        if rank >= nranks:
            res[case] = None
            continue
        default = smc._STEP_CELLS
        if batch is not None:
            smc._STEP_CELLS = batch * bp.N
        try:
            sms = smc.smc_sample(bp, P, generator=torch.Generator()
                                 .manual_seed(seed), group=group)
        finally:
            smc._STEP_CELLS = default
        res[case] = (sms.X.numpy(), sms.logw.numpy(), sms.log_evidence)
    return res
