"""MPBP state and the node-batched sweep.

Counterpart of ``matrixproductbp_tpu/bp.py``.  All edge messages live in one
padded tensor ``msg_cores[E, T1, D, D, q*q]`` (plus ``msg_logz[E]``), beliefs
likewise.  One sweep updates every node at once (Jacobi): per degree bucket
it lifts the in-messages to y-space, forms the all-but-one cavity folds,
contracts each cavity with the transition table into an MPEM3 and converts
it to a bond-D message; the belief comes from the full fold.  Every step
runs over the whole bucket at once, in place of the JAX package's ``vmap``.

The observables read the stored messages and beliefs: two-time and pair
marginals, the pair and belief normalizations of the pair-route free
energy, and trajectory log-probabilities.  Pair quantities contract the
two messages of an edge factor by factor through ``D x D`` environments,
never forming the bond-``D^2`` pair train (only ``pair_beliefs_as_tt``,
whose output it is).

Three compression methods share the lift and the folds:

* ``method="sketch"``: sketch merges and sketch conversions through the
  Hopper scan kernels (``ops/fused_stta.py``);
* ``method="qr"``: Kronecker merges compressed by QR and truncating SVD
  sweeps, conversions by the SVD regrouping sweep (``ops/mpem.py``) and a
  truncating sweep;
* ``method="randomized"``: the ``qr`` conversions with the randomized
  merge (``ops/randomized.py``), whose thin QR is the CholQR kernel.

``damp > 0`` mixes every new message with the old one on each method, and
``iterate(polish=n)`` ends with ``n`` undamped ``qr`` sweeps.  Tables with
``yy_off`` (the sum-type ``prob_yy`` of every Glauber variant) merge by the
banded contraction on each method.  Per-node dense ``prob_yy`` tables (those
of ``build_tables``) run each degree bucket as groups of nodes whose cropped
``prob_yy`` is identical, each group one batched update with its shared
table.  ``bp_sweep_chunked`` bounds the temporaries by updating each bucket
in chunks of nodes, read from the pre-sweep messages (Jacobi) or from those
earlier chunks wrote (Gauss-Seidel), optionally in a shuffled order; the
in-place sweep of ``bigsweep.py`` runs on the same chunks.

Time-varying tables (``factors.build_tables_t``) run through the same
batched steps with a time axis on every table: the lift, the embeds, each
merge's ``prob_yy`` (the sketch merge hands the merge F kernels one table a
step) and the contractions with ``prob_y`` and ``prob_y_partial``.
Periodic (trace-closed) trains, ``periodic=True``, take on every method the
Kronecker merge and the periodic SVD conversion, each compressed by the
cut-and-rotate sweep (``ops/tensortrain.py``), as the JAX package's
periodic sweep does; their observables close every environment with a
trace.  Symmetry-collapsed infinite graphs (``infinite.py``) alias one
stored edge to several slots; the sweep keeps the last slot's message,
which is the one the JAX package's scatter keeps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .factors import RecursiveFactorTables
from .graph import Graph
from .ops import fused_stta
from .ops.mpem import (mpem3_lognorm, mpem3_to_mpem2,
                       mpem3_to_mpem2_periodic)
from .ops.randomized import merge_rounded
from .ops.sumy import y_expand
from .ops.tensortrain import (TensorTrain, _fit_axis, _safe_scale, compress,
                              flat_tt, lognorm, marginals, normalize,
                              normalize_eachmatrix, tt_sum, twovar_marginals)
from .ops.truncation import SVDTrunc, TruncThresh, default_truncator

__all__ = ["GraphArrays", "MPBP", "mpbp", "periodic_mpbp", "bp_sweep",
           "bp_sweep_chunked",
           "iterate", "beliefs", "beliefs_tu", "pair_beliefs",
           "pair_beliefs_as_tt", "pair_beliefs_as_mpem", "pair_lognorms",
           "belief_lognorms", "bethe_free_energy_pair", "bethe_free_energy",
           "means", "autocorrelations", "autocovariances",
           "pair_correlations", "alternate_marginals",
           "alternate_correlations", "logprob", "expectation", "reset",
           "reset_messages", "reset_beliefs", "reset_observations",
           "is_periodic", "is_free_dynamics", "getT", "getN", "nstates",
           "CB_BP", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one that raises instead of
    running on the CPU.  Pass ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class GraphArrays(NamedTuple):
    """Device copies of the Graph index arrays."""
    in_edges: torch.Tensor   # i64[N, K]
    out_edges: torch.Tensor  # i64[N, K]
    in_mask: torch.Tensor    # bool[N, K]
    degree: torch.Tensor     # i64[N]


def graph_arrays(graph: Graph, device) -> GraphArrays:
    return GraphArrays(
        torch.as_tensor(graph.in_edges, dtype=torch.int64, device=device),
        torch.as_tensor(graph.out_edges, dtype=torch.int64, device=device),
        torch.as_tensor(graph.in_mask, device=device),
        torch.as_tensor(graph.degree, dtype=torch.int64, device=device))


@dataclasses.dataclass
class MPBP:
    """The full BP state (reference ``MPBP`` struct)."""

    tables: RecursiveFactorTables
    phi: torch.Tensor        # [N, T1, q]
    psi: torch.Tensor        # [E, T1, q, q]  (x_src, x_dst)
    msg_cores: torch.Tensor  # [E, T1, D, D, q*q]
    msg_logz: torch.Tensor   # [E]
    bel_cores: torch.Tensor  # [N, T1, D, D, q]
    bel_logz: torch.Tensor   # [N]
    f: torch.Tensor          # [N]
    garrays: GraphArrays
    graph: Graph
    periodic: bool = False
    qs: tuple | None = None

    @property
    def T(self) -> int:
        return self.phi.shape[1] - 1

    @property
    def N(self) -> int:
        return self.graph.N

    @property
    def q(self) -> int:
        return self.tables.q

    @property
    def D(self) -> int:
        return self.msg_cores.shape[2]

    @property
    def device(self) -> torch.device:
        return self.msg_cores.device


def mpbp(graph: Graph, tables: RecursiveFactorTables, T: int, D: int,
         phi=None, psi=None, dtype=torch.float64, periodic: bool = False,
         qs=None, device=None) -> MPBP:
    """Flat-initialised state on ``device`` (default: the CUDA card);
    ``periodic`` makes every train trace-closed.  Time-varying tables need
    T + 1 steps."""
    if tables.time_varying and tables.Py.shape[1] != T + 1:
        raise ValueError(f"time-varying tables have {tables.Py.shape[1]} "
                         f"steps, T + 1 = {T + 1}")
    dev = resolve_device(device)
    N, E, q = graph.N, graph.E, tables.q
    T1 = T + 1
    phi = (torch.ones((N, T1, q), dtype=dtype) if phi is None
           else torch.as_tensor(np.asarray(phi), dtype=dtype))
    if qs is not None:
        qs = tuple(int(x) for x in qs)
        if len(qs) != N or max(qs) > q or min(qs) < 1:
            raise ValueError("qs needs one state count in [1, q] per node")
        qmask = np.arange(q)[None, :] < np.asarray(qs)[:, None]
        phi = phi * torch.as_tensor(qmask[:, None, :], dtype=dtype)
    if psi is None:
        psi = torch.ones((E, T1, q, q), dtype=dtype)
    else:
        psi = torch.as_tensor(np.asarray(psi), dtype=dtype)
        pt = psi[torch.as_tensor(graph.rev_edge, dtype=torch.int64)]
        if not torch.allclose(psi, pt.transpose(2, 3)):
            raise ValueError("psi on edge (i,j) must be the transpose of (j,i)")
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=dev)  # noqa: E731
    return MPBP(
        tables.to(device=dev, dtype=dtype), phi.to(dev), psi.to(dev),
        _flat_cores(E, T1, D, (q, q), dtype, dev), zeros(E),
        _flat_cores(N, T1, D, (q,), dtype, dev), zeros(N),
        zeros(N), graph_arrays(graph, dev), graph, periodic, qs)


def _flat_cores(n: int, T1: int, D: int, phys, dtype, device):
    """``n`` copies of the flat train's cores: normalized for the messages
    (phys ``(q, q)``), raw for the beliefs (``(q,)``), as ``mpbp`` starts."""
    tt = flat_tt(T1, D, phys, dtype, device)
    if len(phys) == 2:
        tt, _ = normalize(tt)
    return tt.cores.expand((n,) + tt.cores.shape).clone()


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _merge(Lc, Llz, Rc, Rlz, pyy, trunc: SVDTrunc, Dout: int, Y: int, q: int,
           method: str = "qr", sketches=None, yy_off: int | None = None,
           periodic: bool = False):
    """op for the SVD methods, batched (``bp.py:178-211``): Hadamard on x_i,
    ``prob_yy`` contraction on y (the band where ``yy_off`` is set; ``pyy``
    is then not read), Kronecker on bonds, then truncate (periodic trains
    always so, by the cut-and-rotate sweep).

    Lc [B, T1, DL, DL, Y*q], Rc [B, T1, DR, DR, Y*q], pyy [T1, Y, Y, Y, q]
    (one a step; a stride-0 view for constant tables) -> (cores [B, T1,
    Dout, Dout, Y*q], logz [B])."""
    if method == "randomized" and not periodic:
        return merge_rounded(Lc, Llz, Rc, Rlz, pyy, trunc, Dout, Y, q,
                             sketches, yy_off=yy_off)
    Bn, T1, DL = Lc.shape[:3]
    DR = Rc.shape[2]
    L = Lc.reshape(Bn, T1, DL, DL, Y, q)
    R = Rc.reshape(Bn, T1, DR, DR, Y, q)
    if yy_off is not None:
        # tmp[z, t, m, n, y, b, x] = L[z, t, m, n, y + off - b, x]
        tmp = y_expand(L, yy_off, axis=4, mode="diff")
    else:
        tmp = torch.einsum("tyabx,ztmnax->ztmnybx", pyy, L)
    M = torch.einsum("ztmnybx,ztuvbx->ztmunvyx", tmp, R)
    tt = TensorTrain(M.reshape(Bn, T1, DL * DR, DL * DR, Y * q), Llz + Rlz,
                     (Y, q), periodic)
    tt = normalize_eachmatrix(compress(tt, trunc, Dout=Dout))
    return tt.cores, tt.logz


class _Lifted(NamedTuple):
    """A bucket's in-messages lifted to y-space, with the fold's pieces."""
    B: torch.Tensor          # [Nb, K, T1, Dm, Dm, Y*q]; padded slots = ident
    Blz: torch.Tensor        # [Nb, K]
    ident: torch.Tensor      # [Nb, T1, Dm, Dm, Y*q], the prob_y0 one-hot
    pyy_at: object           # d1 -> prob_yy [T1, Y, Y, Y, q]
    embed_first: object      # op(init, B): a y-relabelling
    embed_second: object     # op(B, init)
    pad_dc: object           # embed a Dm-bond train into capacity Dc


def _lift(msgs_in_c, msgs_in_lz, psi_out, mask, Pxy_b, Py0_b, pyy_b,
          Dc: int, yy_off: int | None = None) -> _Lifted:
    """Lift a bucket's incoming messages to y-space
    (``recursive_bp_factor.jl:108-115``); padded slots become the identity
    element of op.  ``Pxy_b [Nb, K, T1, Y, q, q]``, ``Py0_b [Nb, T1, Y, q]``
    carry a node axis of Nb (expanded by :func:`_expand`) and the T1 axis
    of :func:`_group_inputs` (the embeds are per step, ``bp.py:214-251``);
    ``pyy_b[0]`` is shared across nodes, and where ``yy_off`` is set it is
    a placeholder: the embeds relabel along the band (``bp.py:533-548``)."""
    Nb, K, T1, Dm = msgs_in_c.shape[:4]
    q = psi_out.shape[-1]
    Y = Py0_b.shape[-2]
    A = msgs_in_c.reshape(Nb, K, T1, Dm, Dm, q, q)
    B = torch.einsum("zktyci,zktic,zktmnci->zktmnyi", Pxy_b, psi_out, A)
    ident = B.new_zeros((Nb, T1, Dm, Dm, Y, q))
    ident[:, :, 0, 0] = Py0_b
    B = torch.where(mask[:, :, None, None, None, None, None], B,
                    ident[:, None])
    Blz = torch.where(mask, msgs_in_lz, torch.zeros_like(msgs_in_lz))
    pyy0 = pyy_b[0]                          # [K', T1, Y, Y, Y, q] shared

    def pyy_at(d1):
        return pyy0[min(d1, pyy0.shape[0] - 1)]

    def band():
        # W[z, t, y, b, x] = Py0[z, t, y + off - b, x]
        return y_expand(Py0_b, yy_off, axis=2, mode="diff")

    def embed_first(Bc, Blz_):
        W = band() if yy_off is not None else torch.einsum(
            "tyabx,ztax->ztybx", pyy_at(0), Py0_b)
        out = torch.einsum("ztybx,ztmnbx->ztmnyx", W,
                           Bc.reshape(Nb, T1, Dm, Dm, Y, q))
        return out.reshape(Nb, T1, Dm, Dm, Y * q), Blz_

    def embed_second(Bc, Blz_):
        W = band() if yy_off is not None else torch.einsum(
            "tyabx,ztbx->ztyax", pyy_at(1), Py0_b)
        out = torch.einsum("ztyax,ztmnax->ztmnyx", W,
                           Bc.reshape(Nb, T1, Dm, Dm, Y, q))
        return out.reshape(Nb, T1, Dm, Dm, Y * q), Blz_

    def pad_dc(c):
        return _fit_axis(_fit_axis(c, 2, Dc), 3, Dc)

    return _Lifted(B.reshape(Nb, K, T1, Dm, Dm, Y * q), Blz,
                   ident.reshape(Nb, T1, Dm, Dm, Y * q), pyy_at, embed_first,
                   embed_second, pad_dc)


def _expand(Nb: int, *tables):
    """Broadcast bucket-cropped tables with a node axis of 1 to Nb."""
    return [t.expand((Nb,) + t.shape[1:]) for t in tables]


def _cavity_folds(lf: _Lifted, mrg, direct_k3: bool, pad_pairs: bool):
    """All-but-one folds of op over each node's slots, every fold step
    batched over the bucket (``bp.py:330-421``, ``:552-603``).

    ``mrg(lc, llz, rc, rlz, d1)`` merges with ``prob_yy[d1]``.  K = 3 takes
    the direct all-pairs scheme when ``direct_k3`` (two merge levels; with
    ``pad_pairs`` the second level's bare slots are padded to Dc first, as
    in the JAX package's ``_node_update``); otherwise prefix/suffix folds
    with C_k = op(L_k, R_{k+1}).  Returns (Cs_c [Nb, K, ...], Cs_lz [Nb, K],
    full_c, full_lz)."""
    B, Blz, pad_dc = lf.B, lf.Blz, lf.pad_dc
    Nb, K = B.shape[:2]
    if K == 1:
        full_c, full_lz = lf.embed_first(B[:, 0], Blz[:, 0])
        Cs_c = pad_dc(lf.ident)[:, None]
        return Cs_c, Blz.new_zeros((Nb, 1)), pad_dc(full_c), full_lz
    if K == 2:
        L1c, L1lz = lf.embed_first(B[:, 0], Blz[:, 0])
        R1c, R1lz = lf.embed_second(B[:, 1], Blz[:, 1])
        L1c, R1c = pad_dc(L1c), pad_dc(R1c)
        full_c, full_lz = mrg(L1c, L1lz, B[:, 1], Blz[:, 1], 1)
        return (torch.stack([R1c, L1c], dim=1),
                torch.stack([R1lz, L1lz], dim=1), full_c, full_lz)
    if K == 3 and direct_k3:
        # C0 = op(B1, B2) and C2 = op(B0, B1) in one merge, then
        # C1 = op(B0, B2) and the full fold op(C2, B2)
        P1c, P1lz = mrg(torch.cat([B[:, 1], B[:, 0]]),
                        torch.cat([Blz[:, 1], Blz[:, 0]]),
                        torch.cat([B[:, 2], B[:, 1]]),
                        torch.cat([Blz[:, 2], Blz[:, 1]]), 1)
        C0c, C2c = P1c[:Nb], P1c[Nb:]
        C0lz, C2lz = P1lz[:Nb], P1lz[Nb:]
        B0, B2 = (pad_dc(B[:, 0]), pad_dc(B[:, 2])) if pad_pairs else \
            (B[:, 0], B[:, 2])
        C1c, C1lz = mrg(B0, Blz[:, 0], B2, Blz[:, 2], 1)
        full_c, full_lz = mrg(C2c, C2lz, B2, Blz[:, 2], 2)
        return (torch.stack([C0c, C1c, C2c], dim=1),
                torch.stack([C0lz, C1lz, C2lz], dim=1), full_c, full_lz)
    Lc, Llz = lf.embed_first(B[:, 0], Blz[:, 0])
    Ls = [(pad_dc(Lc), Llz)]                  # Ls[j] = L_{j+1}
    for k in range(1, K):
        Ls.append(mrg(*Ls[-1], B[:, k], Blz[:, k], k))
    full_c, full_lz = Ls.pop()                # L_K, the full fold
    Rc, Rlz = lf.embed_second(B[:, K - 1], Blz[:, K - 1])
    Rs = [(pad_dc(Rc), Rlz)]                  # R_{K-1}, ..., R_1
    for k in range(K - 2, 0, -1):
        Rs.append(mrg(B[:, k], Blz[:, k], *Rs[-1], 1))
    Rs = Rs[::-1]                             # Rs[j] = R_{j+1}
    # C_0 = R_1; C_{K-1} = L_{K-1}; interior C_k = op(L_k, R_{k+1}).  The
    # JAX package's batched branch (bp.py:583-601) pairs R_{k+1} with
    # L_{k+1}, one prefix too far; its vmapped _node_update and the
    # enumeration oracle agree with the pairing here.
    Cs = [Rs[0]]
    for k in range(1, K - 1):
        Cs.append(mrg(*Ls[k - 1], *Rs[k], k))
    Cs.append(Ls[K - 2])
    return (torch.stack([c for c, _ in Cs], dim=1),
            torch.stack([z for _, z in Cs], dim=1), full_c, full_lz)


def _finish_messages(mu: TensorTrain, logz_ks, old_c, old_lz, mask,
                     damp: float, trunc: SVDTrunc):
    """Damp a bucket's normalised new messages ``mu [Nb*K, ...]`` against the
    old ones ``old_c [Nb, K, ...]``: ``tt_sum`` with weight ``damp / (1 -
    damp)``, recompressed to Dm and normalised (``recursive_bp_factor.jl:
    168-179``, ``bp.py:436-441, 662-668``).  Returns (out_cores [Nb, K,
    ...], out_logz [Nb, K], the sum of the slots' log-norms [Nb])."""
    Nb, K = mask.shape
    out_cores, out_lz = mu.cores, mu.logz
    if damp > 0.0:
        old = TensorTrain(old_c.reshape((Nb * K,) + old_c.shape[2:]),
                          old_lz.reshape(Nb * K), mu.phys, mu.periodic)
        mixed = tt_sum(mu, old, damp / (1.0 - damp))
        mixed, _ = normalize(compress(mixed, trunc, Dout=mu.cores.shape[-3]))
        out_cores, out_lz = mixed.cores, mixed.logz
    logz_ks = logz_ks.reshape(Nb, K)
    return (out_cores.reshape((Nb, K) + out_cores.shape[1:]),
            out_lz.reshape(Nb, K),
            torch.where(mask, logz_ks, torch.zeros_like(logz_ks)).sum(1))


def _bucket_update_batched(msgs_in_c, msgs_in_lz, msgs_out_old_c,
                           msgs_out_old_lz, psi_out, mask, Py_b, Pyp_b,
                           Pxy_b, Py0_b, phi_b, deg_b, pyy_b, trunc: SVDTrunc,
                           Dm: int, Dc: int, damp: float, sketches=None,
                           yy_off: int | None = None, pad_k3: bool = False):
    """Whole-bucket sketch update (``bp.py:469-696``).

    msgs_in_c: [Nb, K, T1, Dm, Dm, q*q]; tables bucket-cropped with node
    axis 1 (broadcast) or Nb and the T1 axis of :func:`_group_inputs` (each
    merge hands the merge F kernels one ``prob_yy`` a step, a stride-0 one
    for constant tables); ``pyy_b[0]`` is shared across nodes.  ``pad_k3``
    pads the direct K = 3 cavity's bare slots, as the JAX package's vmapped
    node update (which runs time-varying sweeps) does.  Returns (out_cores
    [Nb, K, ...], out_logz [Nb, K], bel_cores, bel_logz, f)."""
    Nb, K, T1 = msgs_in_c.shape[:3]
    q = phi_b.shape[-1]
    Y = Py0_b.shape[-2]
    Py_b, Pyp_b, Pxy_b, Py0_b = _expand(Nb, Py_b, Pyp_b, Pxy_b, Py0_b)
    lf = _lift(msgs_in_c, msgs_in_lz, psi_out, mask, Pxy_b, Py0_b, pyy_b, Dc,
               yy_off)

    def mrg(lc, llz, rc, rlz, d1):
        return fused_stta.merge_stta_fused(lc, llz, rc, rlz, lf.pyy_at(d1),
                                           Dc, Y, q, sketches, yy_off=yy_off)

    Cs_c, Cs_lz, full_c, full_lz = _cavity_folds(lf, mrg, True, pad_k3)

    # ---- outgoing messages: f_bp_partial -> MPEM3 sketch -> normalize ------
    # B3_tm[t, (z,k), (i,j,p,m,n)] = sum_y Pyp[z,k,p,i,j,y] C[z,k,t,m,n,y,i]
    # phi[z,t,i]: the time-major flat layout of bp.py:613-631
    Dcc = Cs_c.shape[-3]
    T = T1 - 1
    C = Cs_c.reshape(Nb, K, T1, Dcc, Dcc, Y, q)
    main = torch.einsum("zktpijy,zktmnyi,zti->tzkijpmn", Pyp_b[:, :, :-1],
                        C[:, :, :-1], phi_b[:, :-1])
    main = main.reshape(T, Nb * K, q * q * q * Dcc * Dcc)
    lastC = torch.einsum("zkmnyi,zi->zkimn", C[:, :, -1], phi_b[:, -1])
    last = lastC[:, :, :, None, None].expand(Nb, K, q, q, q, Dcc, Dcc)
    B3_tm = torch.cat([main, last.reshape(1, Nb * K, -1)], dim=0)
    del main         # as large as B3_tm: free it before the conversion
    out_c, out_lz0 = fused_stta.mpem3_stta_fused_tm(
        B3_tm, Cs_lz.reshape(Nb * K), Dcc, q, q, Dm, sketches)
    m = _safe_scale(out_c.abs().amax(dim=(2, 3, 4)))           # [NbK, T1]
    out_c = out_c / m[:, :, None, None, None]
    out_lz0 = out_lz0 - torch.log(m).sum(dim=1)
    mu, logz_ks = normalize(TensorTrain(out_c, out_lz0, (q, q)))
    out_cores, out_lz, sum_logz = _finish_messages(
        mu, logz_ks, msgs_out_old_c, msgs_out_old_lz, mask, damp, trunc)

    # ---- belief from the full fold ------------------------------------------
    Dcf = full_c.shape[-3]
    Cf = full_c.reshape(Nb, T1, Dcf, Dcf, Y, q)
    mainb = torch.einsum("ztpiy,ztmnyi,zti->ztmnip", Py_b[:, :-1],
                         Cf[:, :-1], phi_b[:, :-1])
    lastb = torch.einsum("zmnyi,zi->zmni", Cf[:, -1], phi_b[:, -1])
    lastb = lastb[..., None].expand(Nb, Dcf, Dcf, q, q)
    B3b = torch.cat([mainb, lastb[:, None]], dim=1)[:, :, :, :, :, None, :]
    bel_c, bel_lz0 = fused_stta.mpem3_stta_fused(B3b, full_lz, Dm, sketches)
    bel1, logz_i = normalize(
        TensorTrain(bel_c.reshape(Nb, T1, Dm, Dm, q), bel_lz0, (q,)))

    d_i = deg_b.to(bel_lz0.dtype)
    f_i = (d_i / 2.0 - 1.0) * logz_i - 0.5 * sum_logz
    return out_cores, out_lz, bel1.cores, bel1.logz, f_i


def _f_bp_partial(C, phi_b, W, periodic: bool = False):
    """MPEM3 stacks of a batch of cavity trains (``bp.py:253-283``):
    C [Z, T1, Dc, Dc, Y, q], phi_b [Z, T1, q], W [Z, T1, q(p), q(i), qj, Y]
    -> B3 [Z, T1, Dc, Dc, q, qj, q(p)].  An open
    train's last step has no transition factor (uniform in xj and p); a
    periodic one applies it at every step (the wrap)."""
    Z, T1, Dc = C.shape[:3]
    q, qj = W.shape[-3], W.shape[-2]
    if periodic:
        return torch.einsum("ztpijy,ztmnyi,zti->ztmnijp", W, C, phi_b)
    main = torch.einsum("ztpijy,ztmnyi,zti->ztmnijp", W[:, :-1], C[:, :-1],
                        phi_b[:, :-1])
    lastC = torch.einsum("zmnyi,zi->zmni", C[:, -1], phi_b[:, -1])
    last = lastC[..., None, None].expand(Z, Dc, Dc, q, qj, q)
    return torch.cat([main, last[:, None]], dim=1)


def _node_update(msgs_in_c, msgs_in_lz, msgs_out_old_c, msgs_out_old_lz,
                 psi_out, mask, Py_b, Pyp_b, Pxy_b, Py0_b, phi_b, deg_b,
                 pyy_b, trunc: SVDTrunc, trunc_cav: SVDTrunc, Dm: int, Dc: int,
                 damp: float, method: str, sketches=None,
                 direct_k3: bool = True, yy_off: int | None = None,
                 periodic: bool = False):
    """Whole-bucket update for the SVD methods, ``method="qr"`` or
    ``"randomized"``, and for periodic trains on every method (the JAX
    package's vmapped ``_node_update``, ``bp.py:286-466``, with the node
    axis threaded through every step).  Arguments and results as
    :func:`_bucket_update_batched`."""
    Nb, K, T1 = msgs_in_c.shape[:3]
    q = phi_b.shape[-1]
    Y = Py0_b.shape[-2]
    Py_b, Pyp_b, Pxy_b, Py0_b = _expand(Nb, Py_b, Pyp_b, Pxy_b, Py0_b)
    lf = _lift(msgs_in_c, msgs_in_lz, psi_out, mask, Pxy_b, Py0_b, pyy_b, Dc,
               yy_off)

    def mrg(lc, llz, rc, rlz, d1):
        return _merge(lc, llz, rc, rlz, lf.pyy_at(d1), trunc_cav, Dc, Y, q,
                      method, sketches, yy_off, periodic)

    Cs_c, Cs_lz, full_c, full_lz = _cavity_folds(lf, mrg, direct_k3, True)
    to_mpem2 = mpem3_to_mpem2_periodic if periodic else mpem3_to_mpem2

    # ---- outgoing messages: f_bp_partial -> mpem2 -> compress -> normalize
    #      -> damping (recursive_bp_factor.jl:154-158, 168-179) -------------
    Dcc = Cs_c.shape[-3]
    C = Cs_c.reshape(Nb * K, T1, Dcc, Dcc, Y, q)
    W = Pyp_b.reshape((Nb * K,) + Pyp_b.shape[2:])
    phi_k = phi_b[:, None].expand((Nb, K) + phi_b.shape[1:]) \
        .reshape((Nb * K,) + phi_b.shape[1:])
    mu = to_mpem2(_f_bp_partial(C, phi_k, W, periodic), Cs_lz.reshape(Nb * K))
    mu = normalize_eachmatrix(compress(mu, trunc, Dout=Dm, assume="left"))
    mu, logz_ks = normalize(mu)
    out_cores, out_lz, sum_logz = _finish_messages(
        mu, logz_ks, msgs_out_old_c, msgs_out_old_lz, mask, damp, trunc)

    # ---- belief: f_bp_partial on the full fold, then sum the dummy leg ----
    Dcf = full_c.shape[-3]
    B3b = _f_bp_partial(full_c.reshape(Nb, T1, Dcf, Dcf, Y, q), phi_b,
                        Py_b[..., None, :], periodic)
    bel2 = compress(to_mpem2(B3b, full_lz), trunc, Dout=Dm, assume="left")
    bel1, logz_i = normalize(TensorTrain(
        bel2.cores.reshape(Nb, T1, Dm, Dm, q, 1).sum(-1), bel2.logz, (q,),
        periodic))

    d_i = deg_b.to(logz_i.dtype)
    f_i = (d_i / 2.0 - 1.0) * logz_i - 0.5 * sum_logz
    return out_cores, out_lz, bel1.cores, bel1.logz, f_i


def _degree_buckets(graph: Graph):
    """Static degree buckets [(node_idx, K_b)]: one bucket per degree when
    there are at most 4 distinct degrees, else power-of-two bounds clamped
    to dmax (``bp.py:706-735``)."""
    degs = np.asarray(graph.degree)
    dmax = int(np.maximum(degs, 1).max())
    distinct = np.unique(np.maximum(degs, 1))
    if len(distinct) <= 4:
        bounds = [int(b) for b in distinct]
    else:
        bounds = sorted({min(1 << int(np.ceil(np.log2(b))), dmax)
                         for b in distinct})
    buckets = []
    lo = 0
    for b in bounds:
        idx = np.nonzero((np.maximum(degs, 1) > lo)
                         & (np.maximum(degs, 1) <= b))[0]
        if len(idx):
            buckets.append((idx, int(b)))
        lo = b
    return buckets


def _check_sweep_options(method: str, damp: float):
    if method not in ("sketch", "qr", "randomized"):
        raise ValueError(f"unknown method {method!r}")
    if not 0.0 <= damp < 1.0:
        raise ValueError(f"damp must lie in [0, 1): {damp}")


#: per-node ``prob_yy`` tensor -> {(Kb, Yb, node bytes): its groups}
_PYY_GROUPS = WeakIdKeyDictionary()


def _pyy_groups(tb: RecursiveFactorTables, idx, Kb: int, Yb: int):
    """A bucket's nodes grouped by identical bucket-cropped ``prob_yy``:
    [(node indices, that group's table [1, K', Yb, Yb, Yb, q])].  Shared
    (node axis 1) and banded tables give one group.  Computed once per
    bucket on the host and kept while the table lives."""
    if tb.yy_off is not None or tb.Pyy.shape[0] == 1:
        P = tb.Pyy if tb.yy_off is not None else \
            tb.Pyy[:, :min(Kb, tb.Pyy.shape[1])][..., :Yb, :Yb, :Yb, :]
        return [(idx, P)]
    memo = _PYY_GROUPS.setdefault(tb.Pyy, {})
    key = (Kb, Yb, idx.tobytes())
    if key not in memo:
        P = tb.Pyy[torch.as_tensor(idx, device=tb.Pyy.device)]
        P = P[:, :min(Kb, tb.Pyy.shape[1])][..., :Yb, :Yb, :Yb, :]
        flat = P.reshape(len(idx), -1).cpu().numpy()
        _, first, inv = np.unique(flat, axis=0, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)
        memo[key] = [(idx[inv == g], P[first[g]][None])
                     for g in range(len(first))]
    return memo[key]


def _bucket_y(tb: RecursiveFactorTables, Kb: int) -> int:
    """The y-axis a bucket of Kb slots is cropped to (``bp.py:759-764``)."""
    if tb.ydims is None:
        return tb.Y
    Yb = max(1, min(tb.Y, tb.ydims[min(Kb, len(tb.ydims) - 1)]))
    if tb.yy_off is not None:
        Yb = max(Yb, tb.yy_off + 1)       # the init element y0 = off
    return Yb


#: the most nodes a degree bucket of :func:`bp_sweep` may hold for the SVD
#: methods' direct K = 3 cavity, which triples the merge batch; the JAX
#: package takes it up to 4096 nodes (bp.py:812), and the merge order
#: decides what is truncated
DIRECT_K3_MAX = 4096


class _Sweep(NamedTuple):
    """What a node update reads besides the messages."""
    garrays: GraphArrays
    tables: RecursiveFactorTables
    E: int
    phi: torch.Tensor            # [N, T1, q]
    psi: torch.Tensor | None     # [E, T1, q, q]; None: all ones
    periodic: bool = False       # trace-closed trains
    infinite: bool = False       # edges aliased to several slots
    #: size of the space ``garrays.out_edges`` and ``psi`` index (None:
    #: ``E``, the message buffer's; the halo sweep's produce buffer)
    E_out: int | None = None
    #: (cores, logz) the old out-messages are read from to damp, indexed
    #: by out-edge id (None: the source buffer)
    old: tuple | None = None


class _Update(NamedTuple):
    """One node update's results, to be stored by the sweep."""
    edges: torch.Tensor          # i64[M], the out-edges that exist
    out_c: torch.Tensor          # [M, T1, Dm, Dm, q*q]
    out_lz: torch.Tensor         # [M]
    nodes: torch.Tensor          # i64[Nb]
    bel_c: torch.Tensor          # [Nb, T1, Dm, Dm, q]
    bel_lz: torch.Tensor         # [Nb]
    f: torch.Tensor              # [Nb]


def _per_step(t: torch.Tensor, axis: int, T1: int, varying: bool):
    """A table with its T1 axis at ``axis``: time-varying tables have it,
    a constant one gets a stride-0 view of T1 steps."""
    if varying:
        return t
    t = t.unsqueeze(axis)
    return t.expand(t.shape[:axis] + (T1,) + t.shape[axis + 1:])


def _group_inputs(sw: _Sweep, idx, Kb: int, Yb: int, src, Pyy_b):
    """What a node update reads for the nodes ``idx`` of a degree bucket
    (slots Kb, y-axis cropped to Yb, shared ``prob_yy`` ``Pyy_b``) from the
    messages ``src = (cores, logz)``: (node ids, out-edge ids (E on padded
    slots), their clamped indices, (in-messages, their logz, psi on the
    out-edges, slot mask, Py, Pyp, Pxy, Py0 cropped to the bucket, phi,
    degrees, Pyy_b)).  Every table comes with a T1 axis after its slot axes,
    a stride-0 one where the tables are constant: the one place that tells
    the two apart."""
    ga, tb, E = sw.garrays, sw.tables, sw.E
    E_out = E if sw.E_out is None else sw.E_out
    msg_c, msg_lz = src
    nb = torch.as_tensor(idx, dtype=torch.int64, device=msg_c.device)
    Nb = len(idx)
    in_m = ga.in_mask[nb][:, :Kb]
    out_e = ga.out_edges[nb][:, :Kb]
    in_idx = ga.in_edges[nb][:, :Kb].clamp(max=E - 1)  # padded: masked
    out_idx = out_e.clamp(max=E_out - 1)  # ... and dropped at the store
    T1, q = msg_c.shape[1], tb.q

    def nsel(t):
        return t if t.shape[0] == 1 else t[nb]

    psi_out = (sw.psi[out_idx] if sw.psi is not None else
               msg_c.new_ones((Nb, Kb, T1, q, q)))
    phi_b = (sw.phi[nb] if sw.phi.shape[0] > 1 else
             sw.phi.expand(Nb, -1, -1).contiguous())
    tv = tb.time_varying
    return nb, out_e, out_idx, (
        msg_c[in_idx], msg_lz[in_idx], psi_out, in_m,
        _per_step(nsel(tb.Py)[..., :Yb], 1, T1, tv),
        _per_step(nsel(tb.Pyp)[:, :Kb][..., :Yb], 2, T1, tv),
        _per_step(nsel(tb.Pxy)[:, :Kb][..., :Yb, :, :], 2, T1, tv),
        _per_step(nsel(tb.Py0)[..., :Yb, :], 1, T1, tv),
        phi_b, ga.degree[nb], _per_step(Pyy_b.contiguous(), 2, T1, tv))


def _update_nodes(sw: _Sweep, idx, Kb: int, Yb: int, Pyy_b, src,
                  direct_k3: bool, trunc, trunc_cav, Dm: int, Dcav: int,
                  damp: float, method: str, sketches) -> _Update:
    """Update the nodes ``idx`` of a degree bucket (slots Kb, y-axis cropped
    to Yb, shared ``prob_yy`` ``Pyy_b``) from the messages ``src =
    (cores, logz)``; the old out-messages (``sw.old``, else ``src``) are
    read only to damp."""
    tb = sw.tables
    E_out = sw.E if sw.E_out is None else sw.E_out
    old_c, old_lz = src if sw.old is None else sw.old
    nb, out_e, out_idx, (in_c, in_lz, *rest) = _group_inputs(
        sw, idx, Kb, Yb, src, Pyy_b)
    Nb = len(idx)
    old = ((old_c[out_idx], old_lz[out_idx]) if damp > 0.0
           else (None, None))
    args = (in_c, in_lz, *old, *rest)
    if method == "sketch" and not sw.periodic:
        out_c, out_lz, bel_c, bel_lz, f = _bucket_update_batched(
            *args, trunc, Dm, Dcav, damp, sketches, tb.yy_off,
            tb.time_varying)
    else:
        # periodic trains take the Kronecker merge and the SVD conversion
        # on every method (bp.py:189-193, 428-431)
        out_c, out_lz, bel_c, bel_lz, f = _node_update(
            *args, trunc, trunc_cav, Dm, Dcav, damp,
            "qr" if sw.periodic else method, sketches,
            direct_k3=direct_k3, yy_off=tb.yy_off, periodic=sw.periodic)
    # padded slots carry out-edge id E_out and are dropped
    flat = out_e.reshape(-1)
    keep = flat < E_out
    if sw.infinite:
        # an aliased edge is written by each of its slots: keep the last
        # one (what the JAX package's scatter keeps), so that no two rows
        # of the store name one edge
        later = flat[None, :] == flat[:, None]
        keep &= ~torch.triu(later, diagonal=1).any(dim=1)
    return _Update(flat[keep],
                   out_c.reshape((Nb * Kb,) + out_c.shape[2:])[keep],
                   out_lz.reshape(-1)[keep], nb, bel_c, bel_lz, f)


def _buckets(graph: Graph):
    """:func:`_degree_buckets` with each bucket's size: [(node_idx, K_b,
    nodes in the bucket)], what :func:`_sweep` takes."""
    return [(idx, Kb, len(idx)) for idx, Kb in _degree_buckets(graph)]


def _sweep(sw: _Sweep, buckets, src, store, nodes_per_chunk, rng,
           direct_k3_max: int | None, trunc, trunc_cav, Dm: int, Dcav: int,
           damp: float, method: str, sketches):
    """Update every node once, degree bucket by degree bucket.

    ``buckets`` are [(node_idx, K_b, width)] (:func:`_buckets`; the halo
    sweep passes a rank's share of the whole graph's buckets, ``width``
    their whole size).  Each bucket is permuted by ``rng`` when given (one
    ``permutation`` a bucket, in bucket order, as the JAX package draws),
    then cut into chunks of ``nodes_per_chunk(Kb)`` nodes (None: the whole
    bucket); each chunk is split into its ``prob_yy`` groups, every group
    reads ``src``, and then ``store`` takes each group's :class:`_Update`.
    Where ``src`` is the buffer ``store`` writes, later chunks read earlier
    chunks' messages (Gauss-Seidel).  Buckets of a width above
    ``direct_k3_max`` take the prefix/suffix folds at K = 3 on the SVD
    methods."""
    tb = sw.tables
    for bidx, Kb, width in buckets:
        order = bidx if rng is None else rng.permutation(bidx)
        Yb = _bucket_y(tb, Kb)
        groups = _pyy_groups(tb, bidx, Kb, Yb)
        label = np.zeros(len(bidx), np.int64)
        for g, (gidx, _) in enumerate(groups):
            label[np.searchsorted(bidx, gidx)] = g
        direct_k3 = direct_k3_max is None or width <= direct_k3_max
        n = nodes_per_chunk(Kb) if nodes_per_chunk else len(order)
        for lo in range(0, len(order), n):
            ids = order[lo:lo + n]
            lab = label[np.searchsorted(bidx, ids)]
            ups = [_update_nodes(sw, ids[lab == g], Kb, Yb, P, src,
                                 direct_k3, trunc, trunc_cav, Dm, Dcav, damp,
                                 method, sketches)
                   for g, (_, P) in enumerate(groups) if (lab == g).any()]
            for u in ups:
                store(u)


def _sweep_state(bp: MPBP, nodes_per_chunk, rng, seidel: bool,
                 direct_k3_max, trunc, trunc_cav, Dcav, damp, method,
                 sketches) -> MPBP:
    """A sweep of ``bp`` into fresh copies of its state (the caller's stays
    intact), read from the copies themselves when ``seidel``."""
    _check_sweep_options(method, damp)
    trunc_cav = trunc if trunc_cav is None else trunc_cav
    Dm = bp.D
    Dcav = Dm if Dcav is None else Dcav
    new_c, new_lz = bp.msg_cores.clone(), bp.msg_logz.clone()
    bel_c, bel_lz, f = bp.bel_cores.clone(), bp.bel_logz.clone(), bp.f.clone()

    def store(u: _Update):
        new_c.index_copy_(0, u.edges, u.out_c)
        new_lz.index_copy_(0, u.edges, u.out_lz)
        bel_c.index_copy_(0, u.nodes, u.bel_c)
        bel_lz.index_copy_(0, u.nodes, u.bel_lz)
        f.index_copy_(0, u.nodes, u.f)

    sw = _Sweep(bp.garrays, bp.tables, bp.graph.E, bp.phi, bp.psi,
                bp.periodic, bp.graph.infinite)
    src = (new_c, new_lz) if seidel else (bp.msg_cores, bp.msg_logz)
    _sweep(sw, _buckets(bp.graph), src, store, nodes_per_chunk, rng,
           direct_k3_max, trunc, trunc_cav, Dm, Dcav, damp, method,
           sketches)
    return dataclasses.replace(bp, msg_cores=new_c, msg_logz=new_lz,
                               bel_cores=bel_c, bel_logz=bel_lz, f=f)


def bp_sweep(bp: MPBP, trunc: SVDTrunc, trunc_cav: SVDTrunc | None = None,
             Dcav: int | None = None, damp: float = 0.0, method: str = "qr",
             sketches=None) -> MPBP:
    """One synchronous (Jacobi) sweep over all nodes, on the state's device.

    ``trunc`` truncates the messages and beliefs of the SVD methods and the
    damping recompression, ``trunc_cav`` (default ``trunc``) their cavity
    merges; the sketch method reads only the bond caps.  ``sketches``:
    source of the Gaussian sketches of ``"sketch"`` and ``"randomized"``
    (``ops/stta.py``); default re-seeds a generator with 17 every draw."""
    return _sweep_state(bp, None, None, False, DIRECT_K3_MAX, trunc,
                        trunc_cav, Dcav, damp, method, sketches)


def bp_sweep_chunked(bp: MPBP, trunc: SVDTrunc,
                     trunc_cav: SVDTrunc | None = None,
                     Dcav: int | None = None, damp: float = 0.0,
                     method: str = "sketch", chunk: int = 1024,
                     schedule: str = "jacobi",
                     rng: np.random.Generator | None = None,
                     sketches=None) -> MPBP:
    """Memory-bounded sweep (``bp.py:990-1120``): each degree bucket in
    chunks of at most ``chunk`` nodes, so the temporaries grow with the
    chunk and not with N.  Per node it computes what :func:`bp_sweep` does
    (the sketches have no batch axis, so a chunk's nodes see the same
    ones), except that the SVD methods take the direct K = 3 cavity at any
    bucket size, as the JAX package's chunks do.

    ``schedule="jacobi"`` reads the pre-sweep messages; ``"seidel"`` reads
    the messages earlier chunks of the same sweep have written (the
    reference's asynchronous ``iterate!``, ``mpbp.jl:190-195``).  ``rng``
    (a numpy ``Generator``) permutes each bucket before it is chunked, a
    new order every sweep.  The caller's state is left intact."""
    if schedule not in ("jacobi", "seidel"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return _sweep_state(bp, lambda Kb: chunk, rng, schedule == "seidel",
                        None, trunc, trunc_cav, Dcav, damp, method, sketches)


# ---------------------------------------------------------------------------
# iteration & observables
# ---------------------------------------------------------------------------

def iterate(bp: MPBP, maxiter: int = 5, trunc: SVDTrunc | None = None,
            tol: float = 1e-10, damp: float = 0.0,
            trunc_cav: SVDTrunc | None = None, Dcav: int | None = None,
            callback=None, method: str = "qr", chunk: int | None = None,
            polish: int = 0, schedule: str = "jacobi", shuffle: bool = False,
            seed: int = 0, sketches=None):
    """Run sweeps until the beliefs and the free-energy ledger stop moving
    (reference ``iterate!``), then ``polish`` undamped ``method="qr"``
    sweeps.  Returns (bp, n_iters, deltas).

    ``chunk`` sweeps by :func:`bp_sweep_chunked` in chunks of that many
    nodes; ``schedule="seidel"`` and ``shuffle=True`` (each bucket
    reshuffled every sweep by ``np.random.default_rng(seed)``) give the
    reference's asynchronous schedule and chunk by 1024 nodes unless
    ``chunk`` is set.  With ``chunk`` the polish sweeps are chunked Jacobi
    sweeps.

    The JAX package runs its polish sweeps under full-float32 matmul
    precision, a TPU setting; on the card float32 matmuls are full float32
    unless TF32 is switched on, which polish refuses."""
    trunc = default_truncator() if trunc is None else trunc
    if schedule not in ("jacobi", "seidel"):
        raise ValueError(f"unknown schedule {schedule!r}")
    _check_sweep_options(method, damp)
    if (polish > 0 and bp.device.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("polish sweeps need full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    rng = np.random.default_rng(seed) if shuffle else None
    if (schedule == "seidel" or shuffle) and chunk is None:
        chunk = 1024

    def sweep(bp, damp, method, rng=None, schedule="jacobi"):
        if chunk is None:
            return bp_sweep(bp, trunc, trunc_cav, Dcav, damp, method,
                            sketches)
        return bp_sweep_chunked(bp, trunc, trunc_cav, Dcav, damp, method,
                                chunk, schedule, rng, sketches)

    m_old = beliefs(bp)
    f_old = bp.f
    deltas = []
    n_done = maxiter
    for it in range(maxiter):
        bp = sweep(bp, damp, method, rng, schedule)
        m_new = beliefs(bp)
        delta = float(torch.maximum((m_new - m_old).abs().max(),
                                    (bp.f - f_old).abs().max()))
        deltas.append(delta)
        if callback is not None:
            callback(bp, it, delta)
        if delta < tol:
            n_done = it + 1
            break
        m_old, f_old = m_new, bp.f
    for _ in range(polish):
        bp = sweep(bp, 0.0, "qr")
    return bp, n_done, deltas


def beliefs(bp: MPBP) -> torch.Tensor:
    """Single-site time marginals [N, T1, q] (reference ``beliefs``)."""
    return marginals(TensorTrain(bp.bel_cores, bp.bel_logz, (bp.q,),
                                 bp.periodic))


def _values(bp: MPBP, values) -> torch.Tensor:
    """The value table f [q] on the state's device (default 0..q-1)."""
    if values is None:
        return torch.arange(bp.q, dtype=bp.phi.dtype, device=bp.device)
    return torch.as_tensor(values, dtype=bp.phi.dtype, device=bp.device)


def means(bp: MPBP, values: torch.Tensor | None = None) -> torch.Tensor:
    """<f(x_i^t)> with f a value table [q] (default 0..q-1)."""
    return torch.einsum("ntq,q->nt", beliefs(bp), _values(bp, values))


def bethe_free_energy(bp: MPBP) -> torch.Tensor:
    """sum_i f_i (reference ``bethe_free_energy``)."""
    return bp.f.sum()


# ---------------------------------------------------------------------------
# time observables
# ---------------------------------------------------------------------------

def beliefs_tu(bp: MPBP, maxdist: int | None = None) -> torch.Tensor:
    """Two-time marginals [N, T1, T1, q, q], entries t < u <= t + maxdist
    (reference ``beliefs_tu``)."""
    return twovar_marginals(TensorTrain(bp.bel_cores, bp.bel_logz, (bp.q,),
                                        bp.periodic), maxdist)


def autocorrelations(bp: MPBP, values=None, maxdist: int | None = None
                     ) -> torch.Tensor:
    """<f(x_i^t) f(x_i^u)> for t < u, [N, T1, T1] (reference
    ``autocorrelations``, ``mpbp.jl:245-255``)."""
    v = _values(bp, values)
    return torch.einsum("ntupq,p,q->ntu", beliefs_tu(bp, maxdist), v, v)


def autocovariances(bp: MPBP, values=None, maxdist: int | None = None
                    ) -> torch.Tensor:
    """Autocorrelations minus the product of means, entries t < u
    (``mpbp.jl:288-296``)."""
    r = autocorrelations(bp, values, maxdist)
    m = means(bp, values)
    T1 = m.shape[1]
    mask = torch.ones((T1, T1), dtype=torch.bool, device=m.device).triu(1)
    return (r - m[:, :, None] * m[:, None, :]) * mask


# ---------------------------------------------------------------------------
# pair observables: the two messages of an edge contracted factor by factor
# ---------------------------------------------------------------------------

def _pair_factors(bp: MPBP, t: int):
    """The pair belief's factors at time t, per directed edge e = (i, j):
    ``A[e, a, b, xi, xj]`` of mu_ij and ``Bp[e, c, d, xi, xj]``, mu_ji with
    its legs swapped to (xi, xj), times psi_ij^t."""
    E, D, q = bp.graph.E, bp.D, bp.q
    rev = torch.as_tensor(bp.graph.rev_edge, dtype=torch.int64,
                          device=bp.device)
    A = bp.msg_cores[:, t].reshape(E, D, D, q, q)
    Bp = bp.msg_cores[rev, t].reshape(E, D, D, q, q).transpose(-1, -2)
    return A, Bp * bp.psi[:, t, None, None]


def _rescale(env: torch.Tensor):
    """Environments [E, ...] scaled to max-abs 1 each, and the logs of the
    scales."""
    m = _safe_scale(env.reshape(env.shape[0], -1).abs().amax(dim=1))
    return env / m.reshape((-1,) + (1,) * (env.ndim - 1)), torch.log(m)


def _pair_left(bp: MPBP, keep: bool = True):
    """Left environments of every edge's pair belief, ``L[t][e, a, c]`` the
    product of factors 0..t-1 rescaled to max-abs 1 (``keep``: all T1 + 1 of
    them, else the last), and the log of the total sum [E]."""
    E, D = bp.graph.E, bp.D
    L = bp.msg_cores.new_zeros((E, D, D))
    L[:, 0, 0] = 1.0
    lg = bp.msg_cores.new_zeros((E,))
    Ls = [L]
    for t in range(bp.T + 1):
        A, Bp = _pair_factors(bp, t)
        X = torch.einsum("eac,eabij->ecbij", L, A)
        L, lm = _rescale(torch.einsum("ecbij,ecdij->ebd", X, Bp))
        lg = lg + lm
        if keep:
            Ls.append(L)
    rev = torch.as_tensor(bp.graph.rev_edge, dtype=torch.int64,
                          device=bp.device)
    lz = (torch.log(L[:, 0, 0].abs()) + lg - bp.msg_logz
          - bp.msg_logz[rev])
    return (Ls if keep else None), lz


def _pair_right(bp: MPBP):
    """Right environments ``R[t][e, b, d]``: factors t..T rescaled, with
    ``R[T1]`` the open boundary."""
    E, D = bp.graph.E, bp.D
    R = bp.msg_cores.new_zeros((E, D, D))
    R[:, 0, 0] = 1.0
    Rs = [R]
    for t in range(bp.T, -1, -1):
        A, Bp = _pair_factors(bp, t)
        Z = torch.einsum("ecdij,ebd->ecbij", Bp, R)
        R, _ = _rescale(torch.einsum("eabij,ecbij->eac", A, Z))
        Rs.append(R)
    return Rs[::-1]


def _normalized(p: torch.Tensor) -> torch.Tensor:
    return p / p.sum(dim=(-2, -1), keepdim=True)


def _ring_env(bp: MPBP, start: int, n: int):
    """The pair factors ``start, start+1, ..., start+n-1`` (mod T1) of a
    periodic state multiplied into a matrix environment ``env[e, b0, d0, a,
    c]`` (from the left bond (b0, d0) of factor ``start`` to the right bond
    (a, c) of the last), rescaled to max-abs 1 each step, and the log of
    the scales [E].  One ``[D^2, D^2]`` matrix an edge, grown factor by
    factor (O(D^5 q^2) a step), never a pair core."""
    E, D, T1 = bp.graph.E, bp.D, bp.T + 1
    env = torch.eye(D * D, dtype=bp.msg_cores.dtype, device=bp.device) \
        .reshape(1, D * D, D, D).expand(E, -1, -1, -1)
    lg = bp.msg_cores.new_zeros((E,))
    for k in range(n):
        A, Bp = _pair_factors(bp, (start + k) % T1)
        X = torch.einsum("eBac,eabij->eBcbij", env, A)
        env, lm = _rescale(torch.einsum("eBcbij,ecdij->eBbd", X, Bp))
        lg = lg + lm
    return env.reshape(E, D, D, D, D), lg


def _rev_index(bp: MPBP) -> torch.Tensor:
    return torch.as_tensor(bp.graph.rev_edge, dtype=torch.int64,
                           device=bp.device)


def _pair_lognorms_periodic(bp: MPBP) -> torch.Tensor:
    """log z_ij of periodic states: the trace of the whole ring."""
    env, lg = _ring_env(bp, 0, bp.T + 1)
    z = torch.einsum("eacac->e", env)
    return (torch.log(z.abs()) + lg - bp.msg_logz
            - bp.msg_logz[_rev_index(bp)])


def pair_lognorms(bp: MPBP) -> torch.Tensor:
    """log normalization of every directed-edge pair belief,
    log z_ij = log sum_{x_i, x_j} mu_ij mu_ji psi_ij, [E]
    (``bp.py:1293-1312``; periodic: the trace of the ring)."""
    if bp.periodic:
        return _pair_lognorms_periodic(bp)
    return _pair_left(bp, keep=False)[1]


def _node_weights(bp: MPBP, dtype) -> torch.Tensor:
    """The (1/d_j - 1/2) weight of each edge's log z in its head's logz
    (``mpbp.jl:230``; ``1/(d_j - 1) - 1/2`` on a symmetry-collapsed
    infinite graph, ``infinite_graph.jl:38-44``)."""
    dst = torch.as_tensor(bp.graph.edge_dst, dtype=torch.int64,
                          device=bp.device)
    deg = bp.garrays.degree.to(dtype)[dst]
    if bp.graph.infinite:
        return 1.0 / torch.clamp(deg - 1, min=1) - 0.5
    return 1.0 / torch.clamp(deg, min=1) - 0.5


def pair_beliefs(bp: MPBP):
    """Per-directed-edge pair marginals [E, T1, q, q] (legs x_i, x_j) and
    per-node logz contributions [N] (reference ``pair_beliefs``,
    ``mpbp.jl:200-235``).  One left and one right environment sweep,
    O(D^3 q^2) an edge and step.  Periodic states close each time's
    factor with the ring of the others (:func:`_ring_env`, built anew for
    each t: O(T1^2 D^5 q^2) an edge)."""
    if bp.periodic:
        lz = _pair_lognorms_periodic(bp)
        marg = []
        for t in range(bp.T + 1):
            A, Bp = _pair_factors(bp, t)
            R, _ = _ring_env(bp, t + 1, bp.T)
            marg.append(_normalized(torch.einsum(
                "eabij,ecdij,ebdac->eij", A, Bp, R)))
    else:
        Ls, lz = _pair_left(bp)
        Rs = _pair_right(bp)
        marg = []
        for t in range(bp.T + 1):
            A, Bp = _pair_factors(bp, t)
            X = torch.einsum("eac,eabij->ecbij", Ls[t], A)
            Z = torch.einsum("ecdij,ebd->ecbij", Bp, Rs[t + 1])
            marg.append(_normalized((X * Z).sum(dim=(1, 2))))
    dst = torch.as_tensor(bp.graph.edge_dst, dtype=torch.int64,
                          device=bp.device)
    logz_nodes = lz.new_zeros((bp.N,)).index_add_(
        0, dst, _node_weights(bp, lz.dtype) * lz)
    return torch.stack(marg, dim=1), logz_nodes


def alternate_marginals(bp: MPBP) -> torch.Tensor:
    """p(x_i^t, x_j^{t+1}) per directed edge, [E, T, q, q] (reference
    ``alternate_marginals``, ``mpbp.jl:270-280``): the (t, t+1) block of
    the pair belief from the same environments as :func:`pair_beliefs`
    (periodic: closed by the ring of the other factors)."""
    if bp.periodic:
        out = []
        for t in range(bp.T):
            A, Bp = _pair_factors(bp, t)
            A1, Bp1 = _pair_factors(bp, t + 1)
            R, _ = _ring_env(bp, t + 2, bp.T - 1)    # [e, b', d', a, c]
            X = torch.einsum("eBDac,eabij->eBDcbij", R, A)
            X = torch.einsum("eBDcbij,ecdij->eBDbdi", X, Bp)
            X = torch.einsum("eBDbdi,ebBkl->eDdikl", X, A1)
            out.append(_normalized(torch.einsum("eDdikl,edDkl->eil", X,
                                                Bp1)))
        return torch.stack(out, dim=1)
    Ls, _ = _pair_left(bp)
    Rs = _pair_right(bp)
    out = []
    nxt = _pair_factors(bp, 0)
    for t in range(bp.T):
        (A, Bp), nxt = nxt, _pair_factors(bp, t + 1)
        # left: factor t open in x_i^t; right: factor t+1 open in x_j^{t+1}
        X = torch.einsum("eac,eabij->ecbij", Ls[t], A)
        left = torch.einsum("ecbij,ecdij->ebdi", X, Bp)
        A1, Bp1 = nxt
        Z = torch.einsum("ecdij,ebd->ecbij", Bp1, Rs[t + 2])
        right = torch.einsum("eabij,ecbij->eacj", A1, Z)
        out.append(_normalized(torch.einsum("ebdi,ebdj->eij", left, right)))
    return torch.stack(out, dim=1)


def pair_beliefs_as_tt(bp: MPBP):
    """Pair beliefs as trains: cores [E, T1, D*D, D*D, q*q] and logz [E]
    (reference ``pair_beliefs_as_mpem``, ``mpbp.jl:208-216``).  The cores
    are the output, so this builds them: E * T1 * D^4 * q^2 entries (21 GB
    in f32 at E=8,190, T1=16, D=10, q=2).  The other pair observables
    contract the same factors without them.  The trains are periodic where
    the state is."""
    E, T1, D, q = bp.graph.E, bp.T + 1, bp.D, bp.q
    rev = torch.as_tensor(bp.graph.rev_edge, dtype=torch.int64,
                          device=bp.device)
    A = bp.msg_cores.reshape(E, T1, D, D, q, q)
    Bt = bp.msg_cores[rev].reshape(E, T1, D, D, q, q)
    M = torch.einsum("etabij,etcdji,etij->etacbdij", A, Bt, bp.psi)
    return (M.reshape(E, T1, D * D, D * D, q * q),
            bp.msg_logz + bp.msg_logz[rev])


#: reference name for :func:`pair_beliefs_as_tt` (``mpbp.jl:208-216``)
pair_beliefs_as_mpem = pair_beliefs_as_tt


def pair_correlations(bp: MPBP, values=None) -> torch.Tensor:
    """<f(x_i^t) f(x_j^t)> per directed edge, [E, T1]."""
    v = _values(bp, values)
    return torch.einsum("etpq,p,q->et", pair_beliefs(bp)[0], v, v)


def alternate_correlations(bp: MPBP, values=None) -> torch.Tensor:
    """<f(x_i^t) f(x_j^{t+1})> per directed edge, [E, T]."""
    v = _values(bp, values)
    return torch.einsum("etpq,p,q->et", alternate_marginals(bp), v, v)


# ---------------------------------------------------------------------------
# normalizations of the pair-route free energy
# ---------------------------------------------------------------------------

def _belief_lognorm_nodes(sw: _Sweep, idx, Kb: int, Yb: int, Pyy_b, src,
                          trunc, Dc: int, method: str, sketches):
    """log z_i of the nodes ``idx`` of a bucket (Kb slots, y cropped to Yb,
    shared ``prob_yy`` ``Pyy_b``): lift the in-messages as the sweep does,
    fold all of them (op(init, B_0), then one merge a slot), contract the
    fold with ``prob_y`` into the belief's MPEM3 and take its total sum
    (periodic: the Kronecker merges, and the lognorm of the periodic MPEM2,
    as the JAX package computes it)."""
    tb = sw.tables
    _, _, _, (in_c, in_lz, psi_out, in_m, Py_b, _, Pxy_b, Py0_b, phi_b,
              _, Pyy_b) = _group_inputs(sw, idx, Kb, Yb, src, Pyy_b)
    Nb, T1, q = len(idx), in_c.shape[2], tb.q
    Py_b, Pxy_b, Py0_b = _expand(Nb, Py_b, Pxy_b, Py0_b)
    lf = _lift(in_c, in_lz, psi_out, in_m, Pxy_b, Py0_b, Pyy_b, Dc,
               tb.yy_off)
    Lc, Llz = lf.embed_first(lf.B[:, 0], lf.Blz[:, 0])
    Lc = lf.pad_dc(Lc)
    for k in range(1, Kb):
        if method == "sketch" and not sw.periodic:
            Lc, Llz = fused_stta.merge_stta_fused(
                Lc, Llz, lf.B[:, k], lf.Blz[:, k], lf.pyy_at(k), Dc, Yb, q,
                sketches, yy_off=tb.yy_off)
        else:
            Lc, Llz = _merge(Lc, Llz, lf.B[:, k], lf.Blz[:, k], lf.pyy_at(k),
                             trunc, Dc, Yb, q,
                             "qr" if sw.periodic else method, sketches,
                             tb.yy_off, sw.periodic)
    B3 = _f_bp_partial(Lc.reshape(Nb, T1, Dc, Dc, Yb, q), phi_b,
                       Py_b[..., None, :], sw.periodic)
    if sw.periodic:
        return lognorm(mpem3_to_mpem2_periodic(B3, Llz))[0]
    return mpem3_lognorm(B3, Llz)[0]


def belief_lognorms(bp: MPBP, trunc: SVDTrunc | None = None,
                    Dcav: int | None = None, method: str = "qr",
                    sketches=None) -> torch.Tensor:
    """log z_i: the normalization of each node's belief rebuilt from the
    stored messages (reference ``logz_i = log(normalization(bp.b[i]))``,
    ``mpbp.jl:135``; ``bp.py:1315-1385``), [N], without changing the
    state.  Per degree bucket and ``prob_yy`` group, batched: the sweep's
    lift, the full fold with ``method``'s merge (``"sketch"``: the merge W
    and F scans; ``"qr"``, ``"randomized"``: the SVD merges truncated by
    ``trunc``, default ``TruncThresh(0)``) at bond ``Dcav`` (default D),
    the contraction with ``prob_y`` and the MPEM3's total sum, which the
    MPEM2 conversion leaves unchanged.  ``sketches`` as :func:`bp_sweep`."""
    trunc = TruncThresh(0.0) if trunc is None else trunc
    _check_sweep_options(method, 0.0)
    Dc = bp.D if Dcav is None else Dcav
    tb = bp.tables
    sw = _Sweep(bp.garrays, tb, bp.graph.E, bp.phi, bp.psi, bp.periodic)
    out = bp.bel_logz.new_zeros((bp.N,))
    for bidx, Kb in _degree_buckets(bp.graph):
        Yb = _bucket_y(tb, Kb)
        for gidx, P in _pyy_groups(tb, bidx, Kb, Yb):
            lz = _belief_lognorm_nodes(sw, gidx, Kb, Yb, P,
                                       (bp.msg_cores, bp.msg_logz), trunc,
                                       Dc, method, sketches)
            out[torch.as_tensor(gidx, dtype=torch.int64,
                                device=out.device)] = lz
    return out


def bethe_free_energy_pair(bp: MPBP, trunc: SVDTrunc | None = None,
                           Dcav: int | None = None, method: str = "qr",
                           sketches=None) -> torch.Tensor:
    """Bethe free energy through the pair route,
    F = sum_i [ -log z_i + 1/2 sum_{j in di} log z_ij ], with z_i from
    :func:`belief_lognorms` (its ``method`` and ``sketches``) and z_ij from
    :func:`pair_lognorms`.  At a BP fixed point it equals
    :func:`bethe_free_energy` (``bp.py:1388-1411``)."""
    lz_i = belief_lognorms(bp, trunc=trunc, Dcav=Dcav, method=method,
                           sketches=sketches)
    lz_e = pair_lognorms(bp)
    ga = bp.garrays
    lz_pad = torch.cat([lz_e, lz_e.new_zeros((1,))])
    half = 0.5 * torch.where(ga.in_mask, lz_pad[ga.in_edges],
                             torch.zeros((), dtype=lz_e.dtype,
                                         device=lz_e.device)).sum(dim=1)
    return (-lz_i + half).sum()


# ---------------------------------------------------------------------------
# trajectories, resets and accessors
# ---------------------------------------------------------------------------

def logprob(bp: MPBP, x) -> float:
    """Log posterior weight of a trajectory x[N, T1] (reference
    ``logprob``, ``mpbp.jl:301-324``; unnormalized: the observations enter
    as weights), on the state's device and accumulated in float64.  Step t
    reads the tables of step t; a periodic state adds the wrap x^T -> x^0
    with the last step's (``exact.jl:24-26``)."""
    from .factors import transition_probs
    g, dev = bp.graph, bp.device
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=dev).long()
    N, T1 = x.shape
    ar = torch.arange(N, device=dev)
    nbr = torch.as_tensor(np.minimum(g.nbr, g.N - 1), dtype=torch.int64,
                          device=dev)
    tables = bp.tables.to(dtype=torch.float64)
    phi = bp.phi.double()
    tt = torch.arange(T1, device=dev)
    lp = torch.log(phi[ar[:, None], tt[None, :], x]).sum()
    for t in range(T1 if bp.periodic else T1 - 1):
        p = transition_probs(tables.at_time(t), bp.garrays.in_mask,
                             x[:, t][nbr], x[:, t])
        lp = lp + torch.log(p[ar, x[:, (t + 1) % T1]]).sum()
    src = torch.as_tensor(g.edge_src, dtype=torch.int64, device=dev)
    dst = torch.as_tensor(g.edge_dst, dtype=torch.int64, device=dev)
    ae = torch.arange(g.E, device=dev)
    lp = lp + 0.5 * torch.log(bp.psi.double()[
        ae[:, None], tt[None, :], x[src], x[dst]]).sum()
    return float(lp)


def periodic_mpbp(graph: Graph, tables: RecursiveFactorTables, T: int,
                  D: int, phi=None, psi=None, dtype=torch.float64,
                  device=None) -> MPBP:
    """Trace-closed (periodic-in-time) state (reference ``periodic_mpbp``,
    ``mpbp.jl:399-409``)."""
    return mpbp(graph, tables, T, D, phi=phi, psi=psi, dtype=dtype,
                periodic=True, device=device)


def reset_messages(bp: MPBP) -> MPBP:
    """``bp`` with every message flat again (``mpbp.jl:72-80``)."""
    return dataclasses.replace(
        bp, msg_cores=_flat_cores(bp.graph.E, bp.T + 1, bp.D, (bp.q, bp.q),
                                  bp.msg_cores.dtype, bp.device),
        msg_logz=torch.zeros_like(bp.msg_logz))


def reset_beliefs(bp: MPBP) -> MPBP:
    """``bp`` with every belief flat again (``mpbp.jl:82-90``)."""
    return dataclasses.replace(
        bp, bel_cores=_flat_cores(bp.N, bp.T + 1, bp.D, (bp.q,),
                                  bp.bel_cores.dtype, bp.device),
        bel_logz=torch.zeros_like(bp.bel_logz))


def reset_observations(bp: MPBP) -> MPBP:
    """``bp`` with phi and psi all ones (``mpbp.jl:92-95``)."""
    return dataclasses.replace(bp, phi=torch.ones_like(bp.phi),
                               psi=torch.ones_like(bp.psi))


def reset(bp: MPBP, messages: bool = True, beliefs: bool = True,
          observations: bool = False) -> MPBP:
    """Combined reset (reference ``reset!``, ``mpbp.jl:97-102``)."""
    if messages:
        bp = reset_messages(bp)
    if beliefs:
        bp = reset_beliefs(bp)
    if observations:
        bp = reset_observations(bp)
    return bp


def is_periodic(bp: MPBP) -> bool:
    """Reference ``is_periodic`` (``mpbp.jl:113-114``)."""
    return bp.periodic


def is_free_dynamics(bp: MPBP) -> bool:
    """True iff no reweighting: every phi_i^t but t=0 is constant in x
    (reference ``is_free_dynamics``, ``mpbp.jl:105-111``)."""
    sl = bp.phi if bp.periodic else bp.phi[:, 1:]
    return bool((sl == sl[..., :1]).all())


def getT(bp: MPBP) -> int:
    """Final time index T (trains have T+1 cores; ``mpbp.jl:35``)."""
    return bp.T


def getN(bp: MPBP) -> int:
    return bp.N


def nstates(bp: MPBP, i: int | None = None) -> int:
    """Single-variable states of node ``i`` (``mpbp.jl:37``): the per-node
    count of heterogeneous-q states, else ``q``."""
    if i is not None and bp.qs is not None:
        return int(bp.qs[i])
    return bp.q


def expectation(f, p):
    """<f(x)> under a vector pmf, or <f(xi) f(xj)> under a matrix pmf
    (reference ``expectation``, ``mpbp.jl:241-243``); ``f`` a callable on
    the 0-indexed state or an array of per-state values, ``p`` numpy."""
    p = np.asarray(p)
    q = p.shape[-1]
    v = np.asarray([f(x) for x in range(q)], dtype=p.dtype) \
        if callable(f) else np.asarray(f, dtype=p.dtype)
    if p.ndim == 2 and p.shape == (q, q):
        return np.einsum("ij,i,j->", p, v, v)
    return np.einsum("...i,i->...", p, v)


class CB_BP:
    """Per-sweep callback (reference ``CB_BP``, ``mpbp.jl:157-183``): pass
    as ``callback=`` to :func:`iterate`; records each sweep's mean
    trajectories ``m`` (host numpy [N, T1]) and convergence deltas
    ``Delta``."""

    def __init__(self, values=None):
        self.values = values
        self.m: list = []
        self.Delta: list = []

    def __call__(self, bp: MPBP, it: int, delta: float) -> float:
        self.m.append(means(bp, self.values).cpu().numpy())
        self.Delta.append(delta)
        return delta
