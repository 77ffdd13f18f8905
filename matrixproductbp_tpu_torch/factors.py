"""Factors as dense probability tables.

Counterpart of ``matrixproductbp_tpu/factors.py``:

* ``Py  [N, q, q, Y]``        P(x_i^{t+1} | x_i^t, y)              (prob_y)
* ``Pyp [N, K, q, q, q, Y]``  P(x' | x, x_k, y_cav)               (prob_y_partial)
* ``Pxy [N, K, Y, q, q]``     P(y_k | x_k, x_i)                    (prob_xy)
* ``Pyy [N, K, Y, Y, Y, q]``  P(y | y_acc, y_new, x_i), by d1      (prob_yy)
* ``Py0 [N, Y, q]``           initial distribution of y            (prob_y0)

Any leading node axis may be 1 (broadcast).  A factor is described by a
:class:`FactorSpec` (the reference's five-method interface, 0-indexed
states); :func:`build_tables` packs a per-node list of specs into the dense
tables with the same host loops as the JAX package, so the two packages'
tables agree bit for bit.  Factors whose ``prob_yy`` is the sum type
``y == y1 + y2 - off`` (every Glauber variant) set ``sum_y_offset``; their
tables carry ``yy_off`` and a placeholder ``Pyy``, and the sweep merges by
the banded (Toeplitz) contraction.

Time-varying tables (``build_tables_t``, the reference's ``w[i][t]``) insert
a T1 axis after the slot axes: ``Py [N, T1, q, q, Y]``, ``Pyp [N, K, T1, q,
q, q, Y]``, ``Pxy [N, K, T1, Y, q, q]``, ``Pyy [N, K, T1, Y, Y, Y, q]``,
``Py0 [N, T1, Y, q]``; entry t governs the transition x^t -> x^{t+1}, and
entry T only the periodic wrap.  ``at_time(t)`` gives the time-constant
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .graph import Graph

__all__ = ["RecursiveFactorTables", "FactorSpec", "TraceFactorSpec",
           "DampedFactorSpec", "RestrictedFactorSpec", "build_tables",
           "build_tables_t", "transition_probs"]


@dataclasses.dataclass
class RecursiveFactorTables:
    """Dense factor tables (torch tensors), time-constant or, with a T1
    axis after the slot axes, time-varying (module docstring)."""

    Py: torch.Tensor
    Pyp: torch.Tensor
    Pxy: torch.Tensor
    Pyy: torch.Tensor
    Py0: torch.Tensor
    #: sum-type y-merge offset (banded merge; ``Pyy`` is then a placeholder
    #: the sweep never reads); None = dense ``Pyy``
    yy_off: int | None = None
    #: ``ydims[d]`` = y-cardinality at degree d; None = no cropping
    ydims: tuple | None = None

    @property
    def time_varying(self) -> bool:
        return self.Py.ndim == 5

    @property
    def q(self) -> int:
        return self.Py.shape[-3]

    @property
    def Y(self) -> int:
        return self.Py.shape[-1]

    @property
    def N(self) -> int:
        return self.Py.shape[0]

    @property
    def K(self) -> int:
        return self.Pxy.shape[1]

    def at_time(self, t: int) -> "RecursiveFactorTables":
        """The time-constant tables of step ``t`` (the tables themselves
        when they are time-constant)."""
        if not self.time_varying:
            return self
        return RecursiveFactorTables(self.Py[:, t], self.Pyp[:, :, t],
                                     self.Pxy[:, :, t], self.Pyy[:, :, t],
                                     self.Py0[:, t], self.yy_off, self.ydims)

    def to(self, device=None, dtype=None) -> "RecursiveFactorTables":
        return RecursiveFactorTables(
            *(t.to(device=device, dtype=dtype)
              for t in (self.Py, self.Pyp, self.Pxy, self.Pyy, self.Py0)),
            self.yy_off, self.ydims)


class FactorSpec:
    """Behavioural factor description (host side, 0-indexed states): the
    reference's ``nstates``, ``prob_y``, ``prob_xy``, ``prob_yy`` and
    ``prob_y0``.  :func:`build_tables` turns a per-node list of specs into
    dense :class:`RecursiveFactorTables`."""

    q: int
    #: when not None, ``prob_yy(y, y1, y2) == (y == y1 + y2 - sum_y_offset)``
    #: (0-indexed), the sum type of every Glauber variant: ``build_tables``
    #: then skips the dense ``Pyy`` and the sweep merges by the banded
    #: contraction
    sum_y_offset: int | None = None

    def nstates(self, l: int) -> int:
        raise NotImplementedError

    def prob_y(self, xp: int, x: int, y: int, d: int) -> float:
        raise NotImplementedError

    def prob_xy(self, y: int, xk: int, xi: int, k: int) -> float:
        raise NotImplementedError

    def prob_yy(self, y: int, y1: int, y2: int, xi: int, d1: int,
                d2: int) -> float:
        raise NotImplementedError

    def prob_y0(self, y: int, xi: int) -> float:
        return 1.0 if y == 0 else 0.0

    def w(self, xp: int, x_nbrs: Sequence[int], x: int) -> float:
        """P(x' | x, x_nbrs), folded through the five methods (the
        enumeration oracle's and the sampler's view of the factor)."""
        d = len(x_nbrs)
        v = np.array([self.prob_y0(y, 0) for y in range(self.nstates(0))])
        for k, xk in enumerate(x_nbrs):
            Y2 = self.nstates(1)
            vn = np.zeros(self.nstates(k + 1))
            for y in range(len(vn)):
                for y2 in range(Y2):
                    pxy = self.prob_xy(y2, xk, x, k)
                    if pxy == 0.0:
                        continue
                    for y1 in range(len(v)):
                        vn[y] += (self.prob_yy(y, y1, y2, x, k, 1) * pxy
                                  * v[y1])
            v = vn
        return float(sum(self.prob_y(xp, x, y, d) * v[y]
                         for y in range(len(v))))


class TraceFactorSpec(FactorSpec):
    """Exhaustive-trace adapter: y is the positional tuple of neighbour
    states (slot s at digit s, slot 0 least significant), so any factor
    ``fn(xp, x_nbrs, x) -> prob`` takes the recursive form, neighbour-
    asymmetric ones included."""

    def __init__(self, fn: Callable, q: int, degree: int):
        self.fn = fn
        self.q = q
        self.degree = degree

    def nstates(self, l):
        return self.q ** l

    def _decode(self, y, l):
        out = []
        for _ in range(l):
            out.append(y % self.q)
            y //= self.q
        return out

    def prob_y(self, xp, x, y, d):
        return float(self.fn(xp, self._decode(y, d), x))

    def prob_xy(self, y, xk, xi, k):
        return 1.0 if y == xk else 0.0

    def prob_yy(self, y, y1, y2, xi, d1, d2):
        return 1.0 if y == y1 + y2 * (self.q ** d1) else 0.0

    def prob_y0(self, y, xi):
        return 1.0 if y == 0 else 0.0

    def prob_y_partial(self, xp, x, xk, y1, d, k):
        """Cavity decode: y1's digits are the neighbours but slot k; xk is
        inserted at k."""
        rest = self._decode(y1, d)
        return float(self.fn(xp, rest[:k] + [xk] + rest[k:], x))

    def w(self, xp, x_nbrs, x):
        return float(self.fn(xp, list(x_nbrs), x))


class RestrictedFactorSpec(FactorSpec):
    """An inner spec with its shortcuts hidden: no ``prob_y_partial`` (so
    :func:`build_tables` sums ``Pyp`` explicitly) and no ``sum_y_offset``
    (so the sweep takes the dense ``Pyy`` merge).  Results must equal the
    unwrapped spec's."""

    sum_y_offset = None

    def __init__(self, inner: FactorSpec):
        self.inner = inner
        self.q = inner.q

    def nstates(self, l):
        return self.inner.nstates(l)

    def prob_y(self, *a):
        return self.inner.prob_y(*a)

    def prob_xy(self, *a):
        return self.inner.prob_xy(*a)

    def prob_yy(self, *a):
        return self.inner.prob_yy(*a)

    def prob_y0(self, *a):
        return self.inner.prob_y0(*a)

    def w(self, *a):
        return self.inner.w(*a)


class DampedFactorSpec(FactorSpec):
    """Any factor mixed with a lazy self-transition of probability ``p``."""

    def __init__(self, inner: FactorSpec, p: float):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must lie in [0, 1]: {p}")
        self.inner = inner
        self.p = p
        self.q = inner.q

    def nstates(self, l):
        return self.inner.nstates(l)

    def prob_y(self, xp, x, y, d):
        return ((1 - self.p) * self.inner.prob_y(xp, x, y, d)
                + self.p * (xp == x))

    def prob_xy(self, *a):
        return self.inner.prob_xy(*a)

    def prob_yy(self, *a):
        return self.inner.prob_yy(*a)

    def prob_y0(self, *a):
        return self.inner.prob_y0(*a)

    def w(self, xp, x_nbrs, x):
        return (1 - self.p) * self.inner.w(xp, x_nbrs, x) + self.p * (xp == x)


def _node_rows(s: FactorSpec, d: int, i: int, K: int, Y: int, q: int,
               yy_off, Py, Pyp, Pxy, Pyy, Py0):
    """Fill node i's rows of the tables from its spec ``s`` and degree
    ``d``, by the JAX package's loops."""
    # Pyy[i, d1][y, y_first, y_second, xi], d1 = #elements in the first.
    # A merge of states the spec has (y1 < nstates(d1), y2 < nstates(1))
    # never lands on a y beyond nstates(d1 + 1): the JAX package
    # (factors.py:334-341) asks prob_yy there too, and a spec such as SIS's
    # OR puts mass on those padded y
    if yy_off is None:
        for d1 in range(max(K, 1)):
            n_out, n1, n2 = s.nstates(d1 + 1), s.nstates(d1), s.nstates(1)
            for y in range(Y):
                for y1 in range(Y):
                    for y2 in range(Y):
                        if y >= n_out and y1 < n1 and y2 < n2:
                            continue
                        for xi in range(q):
                            Pyy[i, d1, y, y1, y2, xi] = \
                                s.prob_yy(y, y1, y2, xi, d1, 1)
    for xi in range(q):
        for y in range(s.nstates(0)):
            Py0[i, y, xi] = s.prob_y0(y, xi)
        for xp in range(q):
            for y in range(s.nstates(d)):
                Py[i, xp, xi, y] = s.prob_y(xp, xi, y, d)
    for k in range(d):
        for y in range(s.nstates(1)):
            for xk in range(q):
                for xi in range(q):
                    Pxy[i, k, y, xk, xi] = s.prob_xy(y, xk, xi, k)
    # prob_y_partial: the spec's own, or the explicit sum over (y, y2)
    for k in range(d):
        for xp in range(q):
            for xi in range(q):
                for xk in range(q):
                    for y1 in range(s.nstates(max(d - 1, 0))):
                        if hasattr(s, "prob_y_partial"):
                            v = s.prob_y_partial(xp, xi, xk, y1, d - 1, k)
                        else:
                            v = sum(
                                s.prob_y(xp, xi, y, d)
                                * s.prob_xy(y2, xk, xi, k)
                                * s.prob_yy(y, y1, y2, xi, d - 1, 1)
                                for y in range(s.nstates(d))
                                for y2 in range(s.nstates(1)))
                        Pyp[i, k, xp, xi, xk, y1] = v


def build_tables(graph: Graph, specs: Sequence[FactorSpec],
                 dtype=np.float64, Y_pad: int | None = None
                 ) -> RecursiveFactorTables:
    """Dense tables from per-node specs, built on the host in numpy by the
    JAX package's loops (once for each distinct spec object and degree)
    and returned as CPU torch tensors.  ``Y_pad`` forces a larger
    y-axis."""
    N, K = graph.N, graph.dmax
    q = specs[0].q
    deg = graph.degree
    Y = max(max((specs[i].nstates(l) for l in range(int(deg[i]) + 1)),
                default=1) for i in range(N))
    Y = max(Y, 1)
    if Y_pad is not None:
        if Y_pad < Y:
            raise ValueError(f"Y_pad={Y_pad} < required Y={Y}")
        Y = Y_pad

    # per-degree y-cardinality, for the bucketed sweep's exact cropping
    ydims = tuple(min(Y, max((specs[i].nstates(l) for i in range(N)),
                             default=1)) for l in range(K + 1))

    # a sum type shared by every node: no dense Pyy, the banded merge
    offs = {s.sum_y_offset for s in specs}
    yy_off = offs.pop() if (len(offs) == 1 and None not in offs) else None

    Py = np.zeros((N, q, q, Y), dtype)
    Pyp = np.zeros((N, K, q, q, q, Y), dtype)
    Pxy = np.zeros((N, K, Y, q, q), dtype)
    Pyy = (np.zeros((1, 1, 1, 1, 1, q), dtype) if yy_off is not None
           else np.zeros((N, max(K, 1), Y, Y, Y, q), dtype))
    Py0 = np.zeros((N, Y, q), dtype)

    # a node's rows depend on its spec and degree alone: nodes sharing both
    # copy the first one's rows
    first = {}
    for i in range(N):
        key = (id(specs[i]), int(deg[i]))
        if key in first:
            j = first[key]
            for a in (Py, Pyp, Pxy, Py0) + ((Pyy,) if yy_off is None else ()):
                a[i] = a[j]
        else:
            first[key] = i
            _node_rows(specs[i], int(deg[i]), i, K, Y, q, yy_off, Py, Pyp,
                       Pxy, Pyy, Py0)
    return RecursiveFactorTables(
        *(torch.from_numpy(a) for a in (Py, Pyp, Pxy, Pyy, Py0)), yy_off,
        ydims)


def build_tables_t(graph: Graph, specs_t: Sequence[Sequence[FactorSpec]],
                   dtype=np.float64) -> RecursiveFactorTables:
    """Time-varying tables: ``specs_t[i][t]`` is node i's factor for the
    transition x^t -> x^{t+1} (T+1 of them a node; the last one matters
    only to periodic trains).  Each step's slice is :func:`build_tables`
    padded to the largest y-axis of all, stacked on the T1 axis of the
    module docstring; every step must share the y-merge structure."""
    N = graph.N
    T1 = len(specs_t[0])
    if any(len(s) != T1 for s in specs_t):
        raise ValueError("every node needs the same number of factors")
    deg = graph.degree
    Y = max(max((specs_t[i][t].nstates(l) for l in range(int(deg[i]) + 1)),
                default=1) for i in range(N) for t in range(T1))
    Y = max(Y, 1)
    slices = [build_tables(graph, [specs_t[i][t] for i in range(N)], dtype,
                           Y_pad=Y) for t in range(T1)]
    if any(s.yy_off != slices[0].yy_off for s in slices):
        raise ValueError("time-varying factors must share the y-merge "
                         "structure")
    ydims = tuple(max(s.ydims[d] for s in slices)
                  for d in range(len(slices[0].ydims)))
    return RecursiveFactorTables(
        torch.stack([s.Py for s in slices], dim=1),
        torch.stack([s.Pyp for s in slices], dim=2),
        torch.stack([s.Pxy for s in slices], dim=2),
        torch.stack([s.Pyy for s in slices], dim=2),
        torch.stack([s.Py0 for s in slices], dim=1),
        slices[0].yy_off, ydims)


def _rows(table: torch.Tensor, n_idx, *idx) -> torch.Tensor:
    """``table[n % N', i1, i2, ...]`` for index tensors broadcast to one
    shape: the leading axes flattened into rows, picked by one row index
    instead of a multi-tensor advanced index."""
    lead = table.shape[:1 + len(idx)]
    flat = table.reshape(-1, int(np.prod(table.shape[1 + len(idx):])))
    row = n_idx % lead[0]
    for i, d in zip(idx, lead[1:]):
        row = row * d + i
    return flat[row].reshape(row.shape + table.shape[1 + len(idx):])


def transition_probs(tables: RecursiveFactorTables, in_mask, x_nbr, x
                     ) -> torch.Tensor:
    """P(x_i^{t+1} | x_nbrs, x_i) for every node and any leading batch of
    configurations (particles, enumerated trajectories): x_nbr i[..., N, K]
    padded neighbour states, x i[..., N] -> [..., N, q], on the tables'
    device.  Used by the enumeration oracle, ``bp.logprob`` and the
    samplers.  Each slot folds ``prob_yy`` over both y legs for every
    value of x_i at once (one batched product) and then picks x_i, so no
    per-configuration copy of the table is made.  Time-varying tables are
    sliced by the caller (``tables.at_time(t)``)."""
    if tables.time_varying:
        raise ValueError("slice time-varying tables with at_time(t)")
    dev = tables.Py.device
    x_nbr = torch.as_tensor(x_nbr, device=dev).long()
    x = torch.as_tensor(x, device=dev).long()
    N, K = x_nbr.shape[-2:]
    q, Y = tables.q, tables.Y
    n_idx = torch.arange(N, device=dev)
    mask = torch.as_tensor(in_mask, device=dev)
    v = _rows(tables.Py0.transpose(1, 2), n_idx, x)        # [..., N, Y]
    Pxy = tables.Pxy.permute(0, 1, 3, 4, 2)                 # [N', K, xn, x, Y]
    if tables.yy_off is not None:
        # sum type: v2[y] = sum_b v[y + off - b] pxy[b]
        iy = torch.arange(Y, device=dev)
        idx = iy[:, None] + tables.yy_off - iy[None, :]
        ok = ((idx >= 0) & (idx < Y)).to(v.dtype)
        idx = idx.clamp(0, Y - 1)
    else:
        # W[n, k', (a, b), (y, x)] = Pyy[n, k', y, a, b, x]
        W = tables.Pyy.permute(0, 1, 3, 4, 2, 5).reshape(
            tables.Pyy.shape[:2] + (Y * Y, Y * q))
    for k in range(K):
        pxy = _rows(Pxy[:, k], n_idx, x_nbr[..., k], x)     # [..., N, Y]
        if tables.yy_off is not None:
            vt = v[..., idx] * ok                           # [..., N, Y, Y]
            v2 = torch.einsum("...nyb,...nb->...ny", vt, pxy)
        else:
            u = (v[..., :, None] * pxy[..., None, :]).reshape(
                v.shape[:-1] + (Y * Y,))
            Wk = W[:, min(k, W.shape[1] - 1)]
            if Wk.shape[0] == 1:
                full = u @ Wk[0]                            # [..., N, Y*q]
            else:
                full = torch.einsum("nay,...na->...ny", Wk[n_idx % Wk.shape[0]],
                                    u)
            v2 = torch.gather(full.reshape(full.shape[:-1] + (Y, q)), -1,
                              x[..., None, None].expand(
                                  x.shape + (Y, 1)))[..., 0]
        v = torch.where(mask[:, k][:, None], v2, v)
    Py = _rows(tables.Py.permute(0, 2, 1, 3), n_idx, x)     # [..., N, q, Y]
    return (Py * v[..., None, :]).sum(dim=-1)
