"""Large-graph sweep in place, with marginal-only beliefs.

Counterpart of ``matrixproductbp_tpu/bigsweep.py``'s flat mode
(``bigsweep.py:51-410``).  At the scale target (SIS on Erdos-Renyi,
N=10^5, T=50, D=10, f32) the messages alone take E * T1 * D^2 * q^2 * 4 B
= 24.5 GB.  :func:`bp_sweep_flat` keeps one copy of them and updates it in
place, chunk by chunk (Gauss-Seidel: each chunk reads the messages earlier
chunks have written, the reference's asynchronous ``iterate!``,
``mpbp.jl:185-198``), and keeps each node's time marginals instead of its
belief train.  The chunks are those of :func:`bp.bp_sweep_chunked`, cut by
a node-slot budget.

The JAX package keeps these residents as flat 2-D rows and pins their
layouts, and has a segment mode that never scatters into them; both work
around the TPU compiler's relayouts (``bigsweep.py:1-27, 413-435``).  Here
the residents keep their natural shapes (:class:`FlatState`), a chunk's
results go in by ``index_copy_``, and the segment mode is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from .bp import (_Sweep, _Update, _buckets, _check_sweep_options, _sweep,
                 graph_arrays, resolve_device)
from .factors import RecursiveFactorTables
from .graph import Graph
from .ops.tensortrain import TensorTrain, flat_tt, marginals, normalize
from .ops.truncation import SVDTrunc

__all__ = ["FlatState", "flat_init", "bp_sweep_flat", "flat_beliefs",
           "flat_free_energy", "iterate_flat"]


@dataclasses.dataclass
class FlatState:
    """Big-graph sweep state, on one device.

    The beliefs are kept as time marginals ``marg`` [N, T1, q], what the
    scale workload reads; their tensor trains (N * T1 * D^2 * q floats)
    only with ``flat_init(belief_cores=True)``.  The JAX package's fields
    ``msg2`` and ``bel2`` are its 2-D views of ``msg_cores`` and
    ``bel_cores``."""
    msg_cores: torch.Tensor                 # [E, T1, D, D, q*q]
    msg_logz: torch.Tensor                  # [E]
    marg: torch.Tensor                      # [N, T1, q]
    bel_logz: torch.Tensor                  # [N]
    f: torch.Tensor                         # [N]
    bel_cores: torch.Tensor | None = None   # [N, T1, D, D, q]


def flat_init(graph: Graph, tables: RecursiveFactorTables, T: int, D: int,
              dtype=torch.float32, device=None,
              belief_cores: bool = False) -> FlatState:
    """The initial state of :func:`bp.mpbp` on ``device`` (default: the
    CUDA card), with uniform marginals."""
    dev = resolve_device(device)
    N, E, q = graph.N, graph.E, tables.q
    T1 = T + 1
    msg, _ = normalize(flat_tt(T1, D, (q, q), dtype))
    bel = None
    if belief_cores:
        c = flat_tt(T1, D, (q,), dtype).cores.to(dev)
        bel = c.expand((N,) + c.shape).clone()
    c = msg.cores.to(dev)
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=dev)  # noqa: E731
    return FlatState(c.expand((E,) + c.shape).clone(), zeros(E),
                     torch.full((N, T1, q), 1.0 / q, dtype=dtype, device=dev),
                     zeros(N), zeros(N), bel)


def bp_sweep_flat(graph: Graph, tables: RecursiveFactorTables,
                  fs: FlatState, trunc: SVDTrunc, T: int, D: int,
                  phi=None, trunc_cav: SVDTrunc | None = None,
                  Dcav: int | None = None, damp: float = 0.0,
                  method: str = "sketch", chunk: int = 1024,
                  jacobi: bool = False, sketches=None) -> FlatState:
    """One sweep over all nodes, written into ``fs`` in place (its tensors
    are updated; the returned state holds them).

    Each chunk reads the live message buffer (Gauss-Seidel) unless
    ``jacobi=True``, which reads a copy of the pre-sweep messages (the
    semantics of :func:`bp.bp_sweep_chunked`, at the cost of a second
    message array).  ``chunk`` is a node-slot budget: a bucket of Kb slots
    takes ``max(16, chunk // Kb)`` nodes a chunk (``bigsweep.py:293-297``).
    ``phi`` [N, T1, q] (host or device) reweights the nodes, None for free
    dynamics; every ``psi`` is all ones.  ``sketches`` as in
    :func:`bp.bp_sweep`.  ``tables`` not already on the state's device and
    dtype are copied there on every call, and per-node tables then
    regroup their nodes by ``prob_yy`` on every call: convert them once
    (``tables.to(device=..., dtype=...)``), as :func:`iterate_flat`
    does.  Time-varying tables raise, as in the JAX package
    (``bigsweep.py:265``)."""
    _check_sweep_options(method, damp)
    if tables.time_varying:
        raise NotImplementedError("bp_sweep_flat: time-varying tables")
    dev, dtype = fs.msg_cores.device, fs.msg_cores.dtype
    q, T1 = tables.q, T + 1
    tb = tables.to(device=dev, dtype=dtype)
    phi = (torch.ones((1, T1, q), dtype=dtype, device=dev) if phi is None
           else torch.as_tensor(phi).to(device=dev, dtype=dtype))
    trunc_cav = trunc if trunc_cav is None else trunc_cav
    Dcav = D if Dcav is None else Dcav
    sw = _Sweep(graph_arrays(graph, dev), tb, graph.E, phi, None)
    src = ((fs.msg_cores.clone(), fs.msg_logz.clone()) if jacobi
           else (fs.msg_cores, fs.msg_logz))

    def store(u: _Update):
        fs.msg_cores.index_copy_(0, u.edges, u.out_c)
        fs.msg_logz.index_copy_(0, u.edges, u.out_lz)
        fs.marg.index_copy_(0, u.nodes, marginals(
            TensorTrain(u.bel_c, u.bel_lz, (q,))))
        if fs.bel_cores is not None:
            fs.bel_cores.index_copy_(0, u.nodes, u.bel_c)
        fs.bel_logz.index_copy_(0, u.nodes, u.bel_lz)
        fs.f.index_copy_(0, u.nodes, u.f)

    _sweep(sw, _buckets(graph), src, store,
           lambda Kb: max(16, chunk // max(1, Kb)),
           None, None, trunc, trunc_cav, D, Dcav, damp, method, sketches)
    return fs


def flat_beliefs(fs: FlatState, T: int, D: int, q: int) -> torch.Tensor:
    """Single-site time marginals [N, T1, q], on the state's device."""
    return fs.marg


def flat_free_energy(fs: FlatState) -> float:
    """Bethe free energy: the sum of the per-node terms (``mpbp.jl:298``)."""
    return float(fs.f.sum())


def iterate_flat(graph, tables, fs, trunc, T, D, maxiter: int = 50,
                 tol: float = 1e-6, probe: int = 2048, **kw):
    """Sweep until the max-abs change of the marginals of the first
    ``probe`` nodes drops below ``tol``.  Returns (fs, n_iters, delta)."""
    nprobe = min(probe, graph.N)
    tables = tables.to(device=fs.msg_cores.device, dtype=fs.msg_cores.dtype)
    m_old = None
    for it in range(maxiter):
        fs = bp_sweep_flat(graph, tables, fs, trunc, T, D, **kw)
        m_new = fs.marg[:nprobe].clone()
        if m_old is not None:
            delta = float((m_new - m_old).abs().max())
            if delta < tol:
                return fs, it + 1, delta
        m_old = m_new
    return fs, maxiter, float("inf")
