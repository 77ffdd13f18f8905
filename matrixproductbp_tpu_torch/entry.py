"""Entry points of the port: the torch twin of the repository's
``__graft_entry__.py``.

``entry``: one sweep of the flagship workload (SIS on a 16-node ring, T=5,
D=8, f32) as ``(fn, args)``, on the card unless the caller asks for the CPU.

``dryrun_multichip``: the multi-rank path.  The mixed-degree ring (degrees
2 and 4) goes through ``parallel.halo_mpbp`` / ``halo_sweep`` over ``n``
spawned ranks: one damped ``qr`` sweep and one sketch sweep, both chunked
by two nodes, and the free energy reduced over the ranks.  There is no
GSPMD half: the JAX twin also places the whole state over a device mesh
with GSPMD (``parallel/shard.py``), which the port does not port; the halo
layout spreads the state over the ranks instead.
"""
from __future__ import annotations

import math

import torch

__all__ = ["entry", "dryrun_multichip"]


def _state(edges, n_nodes, T, D, device):
    from .graph import graph_from_edges
    from .models import SIS, mpbp_sis
    g = graph_from_edges(n_nodes, edges)
    sis = SIS(g, lam=0.2, rho=0.1, T=T, gamma=0.3)
    return mpbp_sis(sis, D=D, dtype=torch.float32, device=device)


def entry(method: str = "sketch", device=None):
    """``(fn, (bp,))``: ``fn(bp)`` is one ``bp_sweep`` of ``method``
    (``"sketch"`` or ``"qr"``) of SIS on a 16-node ring, T=5, D=8, f32, the
    state on ``device`` (default: the CUDA card)."""
    from .bp import bp_sweep
    from .ops.truncation import TruncBond

    n = 16
    bp = _state([(i, (i + 1) % n) for i in range(n)], n, 5, 8, device)

    def step(state):
        return bp_sweep(state, TruncBond(8), method=method)

    return step, (bp,)


def _dryrun_rank(rank: int, world: int, device_type: str) -> float:
    from .ops.truncation import TruncBond
    from .parallel import halo_bethe_free_energy, halo_mpbp, halo_sweep
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(device_type)
    n = 4 * world
    edges = [(i, (i + 1) % n) for i in range(n)] + \
        [(i, (i + 2) % n) for i in range(0, n, 2)]      # degrees 2 and 4
    st = halo_mpbp(_state(edges, n, 3, 4, dev), device=dev)
    st = halo_sweep(st, TruncBond(4), damp=0.2, chunk=2)
    st = halo_sweep(st, TruncBond(4), method="sketch", chunk=2)
    return float(halo_bethe_free_energy(st))


def dryrun_multichip(n_ranks: int, device=None) -> float:
    """Run the halo path over ``n_ranks`` spawned ranks and return the free
    energy.  ``device`` None: rank r on CUDA card r over NCCL (raising
    without ``n_ranks`` cards); ``"cpu"``: gloo ranks on the CPU."""
    from .bp import resolve_device
    from .parallel import spawn_ranks
    dev = resolve_device(device)
    if dev.type == "cuda" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(f"{n_ranks} NCCL ranks need {n_ranks} cards; "
                           f"{torch.cuda.device_count()} found")
    fs = spawn_ranks(_dryrun_rank, n_ranks, (dev.type,),
                     backend="nccl" if dev.type == "cuda" else "gloo",
                     threads=1 if dev.type == "cpu" else None)
    if not all(math.isfinite(f) and f == fs[0] for f in fs):
        raise RuntimeError(f"ranks disagree on the free energy: {fs}")
    return fs[0]
