"""Halo-exchange BP sweep over ``torch.distributed`` ranks.

Counterpart of ``matrixproductbp_tpu/parallel/halo.py``.  The JAX package
holds every device's block in one process under ``shard_map``; the port
runs one process per rank, each holding its own block:

* **Partition-aligned layout**: nodes are renumbered so that each rank owns
  a contiguous block of ``Nloc`` (padded) nodes (BFS partition: a low
  cut); each directed edge's message lives on the rank that owns its
  destination, so every message a node reads is on its own rank.
* **Static halo plan** (:func:`halo_plan`, host numpy, deterministic):
  every rank builds the whole plan, equal to the JAX package's.  The only
  traffic is each freshly produced message mu_{i->j} whose destination j
  lives on another rank, and with damping the old value fetched back along
  the same route.
* **One ``all_to_all_single`` a sweep** (two with damping): each rank sends
  each other rank exactly the rows it needs (the split sizes come from the
  plan), cores and log-norms packed into one buffer.  Messages that stay on
  a rank take a local scatter and never enter the collective; a plan
  without a cut exchanges nothing.  The free energy is an ``all_reduce``;
  beliefs and :func:`halo_to_mpbp` gather to every rank.
* **The node update is the single-device sweep's**: each rank runs
  ``bp._sweep`` on its local arrays, its in-edges indexing the local
  message buffer and its out-slots a produce buffer (position ``loc * K +
  slot``).  Its buckets are the whole graph's degree buckets (a rank's own
  degrees may bucket differently) and each bucket's whole size decides the
  direct K = 3 cavity, so every node is updated exactly as ``bp_sweep``
  (or, with ``chunk``, ``bp_sweep_chunked``) updates it.

The collectives run on whatever backend the caller's ``init_process_group``
chose (``gloo`` on the CPU; ``nccl`` with one rank a card, or ``gloo``
where several ranks share a card); this module never switches it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import bp as _bp
from ..bp import (MPBP, GraphArrays, _check_sweep_options, _degree_buckets,
                  _Sweep, _sweep, _Update)
from ..factors import RecursiveFactorTables
from ..graph import Graph
from ..ops.tensortrain import TensorTrain, marginals
from ..ops.truncation import SVDTrunc
from .partition import partition_nodes

__all__ = ["HaloPlan", "HaloState", "halo_plan", "halo_mpbp", "halo_sweep",
           "halo_beliefs", "halo_bethe_free_energy", "halo_to_mpbp"]


@dataclasses.dataclass(frozen=True, eq=False)
class HaloPlan:
    """Static (host numpy) partition and routing plan; the arrays equal the
    JAX package's ``HaloPlan``'s of the same names for the same partition."""
    ndev: int
    Nloc: int            # nodes per rank (padded)
    Eloc: int            # edges per rank (padded)
    K: int
    part: np.ndarray     # [N] part of each original node
    node_new: np.ndarray  # [N] original -> new (block) node id
    edge_new: np.ndarray  # [E] original edge id -> new global edge id
    in_edges_loc: np.ndarray  # [ndev, Nloc, K] local in-edge ids (pad Eloc)
    in_mask: np.ndarray       # [ndev, Nloc, K]
    degree: np.ndarray        # [ndev, Nloc]
    # routing (produce-buffer position = loc * K + slot on the producer)
    local_src: np.ndarray     # [ndev, Lh] produce positions staying local
    local_dst: np.ndarray     # [ndev, Lh] local edge ids (pad Eloc)
    send_idx: np.ndarray      # [ndev, ndev, H] produce positions for rank r
    recv_dst: np.ndarray      # [ndev, ndev, H] local edge ids (pad Eloc)

    @property
    def cut(self) -> int:
        """Messages crossing ranks each sweep (the partition's edge cut)."""
        return int(np.sum(self.send_idx < self.Nloc * self.K))


def _rank_within(keys: np.ndarray, n: int) -> np.ndarray:
    """Each element's position among the elements with its key, in order."""
    order = np.argsort(keys, kind="stable")
    first = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=n))])
    out = np.empty(len(keys), np.int64)
    out[order] = np.arange(len(keys)) - first[keys[order]]
    return out


def halo_plan(graph: Graph, ndev: int, part: np.ndarray | None = None,
              rng: np.random.Generator | None = None) -> HaloPlan:
    """The partition-aligned layout and the static routing maps (the
    partition ``part``, else :func:`partition_nodes` with ``rng``)."""
    N, E, K = graph.N, graph.E, graph.dmax
    if part is None:
        part = partition_nodes(graph, ndev, rng)
    part = np.asarray(part, dtype=np.int32)
    if part.shape != (N,) or (N and (part.min() < 0 or part.max() >= ndev)):
        raise ValueError(f"part must give each of the {N} nodes a part in "
                         f"[0, {ndev})")

    # node renumbering: per-part contiguous blocks, padded to Nloc
    counts = np.bincount(part, minlength=ndev)
    Nloc = int(counts.max()) if N else 1
    node_new = part.astype(np.int64) * Nloc + _rank_within(part, ndev)
    loc = node_new % Nloc

    # edge renumbering: owner = part(dst); the (dst, src) order of the edge
    # ids is kept within a part
    e_owner = part[graph.edge_dst]
    Eloc = int(np.bincount(e_owner, minlength=ndev).max()) if E else 1
    edge_new = e_owner.astype(np.int64) * Eloc + _rank_within(e_owner, ndev)

    # per-rank in-edge tables (the graph's slot order)
    ii, ss = np.nonzero(graph.in_mask)
    pi = part[ii]
    in_edges_loc = np.full((ndev, Nloc, K), Eloc, dtype=np.int32)
    in_mask = np.zeros((ndev, Nloc, K), dtype=bool)
    degree = np.zeros((ndev, Nloc), dtype=np.int32)
    degree[part, loc] = graph.degree
    in_edges_loc[pi, loc[ii], ss] = edge_new[graph.in_edges[ii, ss]] % Eloc
    in_mask[pi, loc[ii], ss] = True

    # routing: producer p computes mu_{i->k} at position loc * K + slot;
    # the message lives at owner(k)
    e_out = graph.out_edges[ii, ss]
    r = e_owner[e_out]
    pos = loc[ii] * K + ss
    dst_loc = edge_new[e_out] % Eloc
    is_loc = r == pi
    jl = _rank_within(pi[is_loc], ndev)
    hkey = pi[~is_loc].astype(np.int64) * ndev + r[~is_loc]
    jh = _rank_within(hkey, ndev * ndev)
    Lh = max(int(jl.max()) + 1 if len(jl) else 0, 1)
    H = max(int(jh.max()) + 1 if len(jh) else 0, 1)
    # pads are one-past-the-end sentinels
    local_src = np.full((ndev, Lh), Nloc * K, dtype=np.int32)
    local_dst = np.full((ndev, Lh), Eloc, dtype=np.int32)
    local_src[pi[is_loc], jl] = pos[is_loc]
    local_dst[pi[is_loc], jl] = dst_loc[is_loc]
    send_idx = np.full((ndev, ndev, H), Nloc * K, dtype=np.int32)
    recv_dst = np.full((ndev, ndev, H), Eloc, dtype=np.int32)
    send_idx[pi[~is_loc], r[~is_loc], jh] = pos[~is_loc]
    recv_dst[r[~is_loc], pi[~is_loc], jh] = dst_loc[~is_loc]

    return HaloPlan(ndev, Nloc, Eloc, K, part, node_new, edge_new,
                    in_edges_loc, in_mask, degree, local_src, local_dst,
                    send_idx, recv_dst)


class _Routes(NamedTuple):
    """One rank's share of the plan's routing, on its device."""
    local_src: torch.Tensor   # i64: produce positions staying on the rank
    local_dst: torch.Tensor   # i64: their local edge ids
    send_pos: torch.Tensor    # i64: produce positions sent, by destination
    send_splits: list         # rows sent to each rank
    recv_dst: torch.Tensor    # i64: local edge ids of the rows received
    recv_splits: list         # rows received from each rank


def _routes(plan: HaloPlan, p: int, device) -> _Routes:
    PK = plan.Nloc * plan.K

    def rows(a, valid):
        return torch.as_tensor(a[valid], dtype=torch.int64, device=device)

    send_valid = plan.send_idx < PK                     # [ndev, ndev, H]
    loc_valid = plan.local_src[p] < PK
    return _Routes(
        rows(plan.local_src[p], loc_valid), rows(plan.local_dst[p], loc_valid),
        rows(plan.send_idx[p], send_valid[p]),
        [int(n) for n in send_valid[p].sum(1)],
        rows(plan.recv_dst[p], plan.recv_dst[p] < plan.Eloc),
        [int(n) for n in send_valid[:, p].sum(1)])


@dataclasses.dataclass
class HaloState:
    """One rank's block of the halo layout, and the whole plan."""
    tables: RecursiveFactorTables  # per-node axes: this rank's block
    phi: torch.Tensor        # [Nloc, T1, q]
    psi_out: torch.Tensor    # [Nloc * K, T1, q, q]: each slot's out-edge psi
    msg_cores: torch.Tensor  # [Eloc, T1, D, D, q*q]
    msg_logz: torch.Tensor   # [Eloc]
    bel_cores: torch.Tensor  # [Nloc, T1, D, D, q]
    bel_logz: torch.Tensor   # [Nloc]
    f: torch.Tensor          # [Nloc]
    garrays: GraphArrays     # local: in-edges index msg_cores, out-edges
    #                          the produce buffer (pad Nloc * K)
    buckets: list            # [(local node ids, K_b, the bucket's width)]
    routes: _Routes
    plan: HaloPlan
    rank: int
    group: object = None
    periodic: bool = False

    @property
    def D(self) -> int:
        return self.msg_cores.shape[2]

    @property
    def q(self) -> int:
        return self.tables.q

    @property
    def rows_sent(self) -> int:
        """Message rows this rank sends in a sweep's delivery."""
        return sum(self.routes.send_splits)


def halo_mpbp(bp: MPBP, group=None, part: np.ndarray | None = None,
              rng: np.random.Generator | None = None,
              device=None) -> HaloState:
    """This rank's block of the whole state ``bp`` (messages, beliefs and
    free-energy terms as ``bp`` holds them), on ``device`` (default: this
    rank's CUDA device, ``torch.cuda.current_device()``).  Every rank of
    ``group`` (None: the default group) calls it with the same ``bp`` and
    the same ``part`` (or ``rng`` in the same state: each rank draws the
    partition itself).  Without a card, ``device=None`` raises."""
    if bp.graph.infinite:
        raise ValueError("the halo sweep takes finite graphs: an infinite "
                         "graph's slots alias one stored edge")
    ndev, p = dist.get_world_size(group), dist.get_rank(group)
    dev = _bp.resolve_device(device)
    g = bp.graph
    plan = halo_plan(g, ndev, part, rng)
    N, K, Nloc, Eloc = g.N, plan.K, plan.Nloc, plan.Eloc

    # this rank's nodes and edges in the new numbering (-1: padding)
    node_of = np.full(ndev * Nloc, -1, np.int64)
    node_of[plan.node_new] = np.arange(N)
    edge_of = np.full(ndev * Eloc, -1, np.int64)
    edge_of[plan.edge_new] = np.arange(g.E)
    nodes = node_of[p * Nloc:(p + 1) * Nloc]
    edges = edge_of[p * Eloc:(p + 1) * Eloc]
    n_real, e_real = nodes >= 0, edges >= 0
    src_dev = bp.device

    def block(x, ids, real, fill):
        """Rows ``ids`` of ``x`` (``fill`` on padding), on ``dev``."""
        out = torch.full((len(ids),) + x.shape[1:], fill, dtype=x.dtype,
                         device=src_dev)
        sel = torch.as_tensor(ids[real], dtype=torch.int64, device=src_dev)
        out[torch.as_tensor(np.nonzero(real)[0], device=src_dev)] = x[sel]
        return out.to(dev)

    out_e = g.out_edges[np.maximum(nodes, 0)]            # [Nloc, K]
    slot_real = g.in_mask[np.maximum(nodes, 0)] & n_real[:, None]
    psi_out = block(bp.psi, out_e.reshape(-1), slot_real.reshape(-1), 1.0)

    # per-node tables take this rank's block (padding: node 0's rows)
    tb = bp.tables
    node_sel = torch.as_tensor(np.maximum(nodes, 0), device=tb.Py.device)

    def local(t):
        return (t[node_sel] if t.shape[0] == N and N > 1 else t).to(dev)
    tb_loc = RecursiveFactorTables(*(local(t) for t in (
        tb.Py, tb.Pyp, tb.Pxy, tb.Pyy, tb.Py0)), tb.yy_off, tb.ydims)

    in_mask = plan.in_mask[p]
    prod_pos = np.where(in_mask, np.arange(Nloc)[:, None] * K
                        + np.arange(K)[None, :], Nloc * K)
    ga = GraphArrays(
        torch.as_tensor(plan.in_edges_loc[p], dtype=torch.int64, device=dev),
        torch.as_tensor(prod_pos, dtype=torch.int64, device=dev),
        torch.as_tensor(in_mask, device=dev),
        torch.as_tensor(plan.degree[p], dtype=torch.int64, device=dev))

    # the whole graph's buckets, each cut to this rank's nodes
    buckets = []
    for bidx, Kb in _degree_buckets(g):
        mine = bidx[plan.part[bidx] == p]
        if len(mine):
            buckets.append((plan.node_new[mine] % Nloc, Kb, len(bidx)))

    return HaloState(
        tb_loc, block(bp.phi, nodes, n_real, 1.0), psi_out,
        block(bp.msg_cores, edges, e_real, 0.0),
        block(bp.msg_logz, edges, e_real, 0.0),
        block(bp.bel_cores, nodes, n_real, 0.0),
        block(bp.bel_logz, nodes, n_real, 0.0),
        block(bp.f, nodes, n_real, 0.0), ga, buckets,
        _routes(plan, p, dev), plan, p, group, bp.periodic)


def _pack(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Message rows and their log-norms as one [n, cells + 1] buffer."""
    return torch.cat([c.reshape(len(c), -1), z[:, None]], dim=1)


def _exchange(state: HaloState, c, z, send_splits, recv_splits):
    """Rows ``(c, z)`` grouped by destination rank sent with one
    ``all_to_all_single``; returns the rows received, grouped by source."""
    buf = _pack(c, z)
    out = buf.new_empty((sum(recv_splits), buf.shape[1]))
    dist.all_to_all_single(out, buf, recv_splits, send_splits,
                           group=state.group)
    return out[:, :-1].reshape((len(out),) + c.shape[1:]), out[:, -1]


def halo_sweep(state: HaloState, trunc: SVDTrunc,
               trunc_cav: SVDTrunc | None = None, Dcav: int | None = None,
               damp: float = 0.0, method: str = "qr",
               chunk: int | None = None, sketches=None) -> HaloState:
    """One synchronous BP sweep with the halo exchange; every rank of the
    state's group calls it with the same arguments.  Each rank updates its
    nodes as ``bp.bp_sweep`` does (with ``chunk``, at most that many nodes
    an update, as ``bp.bp_sweep_chunked`` does), then delivers the new
    messages: a local scatter and one ``all_to_all_single`` of the cut
    (damping first fetches the old cut messages back the reverse way).
    ``sketches``: the sketch source, as ``bp.bp_sweep``'s (sketches depend
    only on their shapes, so every rank draws what one device draws)."""
    _check_sweep_options(method, damp)
    trunc_cav = trunc if trunc_cav is None else trunc_cav
    Dm = state.D
    Dcav = Dm if Dcav is None else Dcav
    plan, rt = state.plan, state.routes
    PK = plan.Nloc * plan.K
    exchange = plan.cut > 0          # the same on every rank
    msg_c, msg_z = state.msg_cores, state.msg_logz

    old = None
    if damp > 0.0:
        # the old out-messages by produce position: the local ones read
        # here, the cut ones fetched back along the reversed route
        old_c = msg_c.new_zeros((PK,) + msg_c.shape[1:])
        old_z = msg_z.new_zeros((PK,))
        old_c[rt.local_src] = msg_c[rt.local_dst]
        old_z[rt.local_src] = msg_z[rt.local_dst]
        if exchange:
            got_c, got_z = _exchange(state, msg_c[rt.recv_dst],
                                     msg_z[rt.recv_dst], rt.recv_splits,
                                     rt.send_splits)
            old_c[rt.send_pos] = got_c
            old_z[rt.send_pos] = got_z
        old = (old_c, old_z)

    prod_c = msg_c.new_zeros((PK,) + msg_c.shape[1:])
    prod_z = msg_z.new_zeros((PK,))
    bel_c, bel_z = state.bel_cores.clone(), state.bel_logz.clone()
    f = torch.zeros_like(state.f)

    def store(u: _Update):
        prod_c.index_copy_(0, u.edges, u.out_c)
        prod_z.index_copy_(0, u.edges, u.out_lz)
        bel_c.index_copy_(0, u.nodes, u.bel_c)
        bel_z.index_copy_(0, u.nodes, u.bel_lz)
        f.index_copy_(0, u.nodes, u.f)

    sw = _Sweep(state.garrays, state.tables, plan.Eloc, state.phi,
                state.psi_out, state.periodic, False, PK, old)
    _sweep(sw, state.buckets, (msg_c, msg_z), store,
           None if chunk is None else (lambda Kb: chunk), None,
           _bp.DIRECT_K3_MAX if chunk is None else None, trunc, trunc_cav,
           Dm, Dcav, damp, method, sketches)

    new_c, new_z = torch.zeros_like(msg_c), torch.zeros_like(msg_z)
    new_c[rt.local_dst] = prod_c[rt.local_src]
    new_z[rt.local_dst] = prod_z[rt.local_src]
    if exchange:
        got_c, got_z = _exchange(state, prod_c[rt.send_pos],
                                 prod_z[rt.send_pos], rt.send_splits,
                                 rt.recv_splits)
        new_c[rt.recv_dst] = got_c
        new_z[rt.recv_dst] = got_z
    return dataclasses.replace(state, msg_cores=new_c, msg_logz=new_z,
                               bel_cores=bel_c, bel_logz=bel_z, f=f)


def _gather(state: HaloState, x: torch.Tensor) -> torch.Tensor:
    """Every rank's block of ``x`` stacked in rank order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(state.plan.ndev)]
    dist.all_gather(parts, x.contiguous(), group=state.group)
    return torch.cat(parts)


def halo_beliefs(state: HaloState, graph: Graph) -> torch.Tensor:
    """Single-site marginals [N, T1, q] in the original node order, on
    every rank."""
    m = marginals(TensorTrain(state.bel_cores, state.bel_logz, (state.q,),
                              state.periodic))
    new = torch.as_tensor(state.plan.node_new, device=m.device)
    return _gather(state, m)[new]


def halo_bethe_free_energy(state: HaloState) -> torch.Tensor:
    """sum_i f_i over every rank's nodes (an ``all_reduce``)."""
    tot = state.f.sum().reshape(1)
    dist.all_reduce(tot, group=state.group)
    return tot[0]


def halo_to_mpbp(state: HaloState, bp_template: MPBP) -> MPBP:
    """The whole state gathered to every rank and un-permuted into an
    ordinary :class:`MPBP` on ``bp_template``'s device, so that every
    observable of ``bp.py`` applies."""
    plan = state.plan
    dev = bp_template.device

    def whole(x, new):
        return _gather(state, x)[torch.as_tensor(new, device=x.device)].to(dev)

    return dataclasses.replace(
        bp_template,
        msg_cores=whole(state.msg_cores, plan.edge_new),
        msg_logz=whole(state.msg_logz, plan.edge_new),
        bel_cores=whole(state.bel_cores, plan.node_new),
        bel_logz=whole(state.bel_logz, plan.node_new),
        f=whole(state.f, plan.node_new))
