"""The sketch sweep's four time scans as Hopper kernels, and the entry points
that run whole compressions through them.

Counterpart of ``matrixproductbp_tpu/ops/fused_stta.py``.  Each scan wrapper
(:func:`merge_wscan`, :func:`merge_fscan`, :func:`mpem3_wscan`,
:func:`mpem3_fscan`) runs its plain PyTorch version (``ops/stta.py``,
re-exported here as ``*_plain``) when its tensors lie on the CPU, and
launches its CUDA kernel (``csrc/stta_scans.cu``, ``csrc/merge_f_staged.cu``,
``csrc/merge_f_cluster.cu``, ``csrc/merge_w_staged.cu``,
``csrc/merge_wide.cu``, ``csrc/merge_streamed.cu``,
``csrc/mpem3_staged.cu``) when they lie on a
CUDA device; there is no
fallback between the two.  ``<wrapper>.launches``
counts kernel launches.

The kernels replace, in order, ``_merge_wstep_kernel`` (``fused_stta.py:231``),
``_merge_fstep_kernel`` / ``_merge_fstep_kernel_lean`` (``:281``, ``:382``),
``_mpem3_wstep_kernel`` (``:508``) and ``_mpem3_fstep_kernel`` (``:545``).
Merge F has five kernels, picked by shape in :func:`merge_f_geometry`:
``merge_f_staged_kernel`` (``merge_f_staged.cu``, built once per shape with
its sizes as constants) wherever its buffers fit (the f32 sketch merges up to
D=15); ``merge_f_cluster_kernel`` (``merge_f_cluster.cu``, built likewise: a
cluster of two blocks per instance, which share the sketch rows through
distributed shared memory) wherever its buffers fit (the f32 sketch merges
from D=16 to D=20); ``merge_f_kernel`` for the shapes neither takes where
its buffers fit; ``merge_f_wide_kernel`` (``merge_wide.cu``, built once per
shape: one instance over a cluster of up to 8 blocks, every intermediate
in the cluster's shared memory) where a cluster holds the step; and
``merge_f_streamed_kernel`` (``merge_streamed.cu``, one build for every
shape: fixed shared memory, the shape's buffers in a global workspace) for
the rest.  Merge W has four, picked in :func:`merge_w_geometry`:
``merge_w_staged_kernel`` (``merge_w_staged.cu``, built once per shape) at
the f32 sketch merges (Y = q = 2) where its buffers fit, all of which it
ran faster than ``merge_w_kernel``; ``merge_w_kernel`` for the rest where
its buffers fit; ``merge_w_wide_kernel`` (``merge_wide.cu``) where a
cluster holds the step; and ``merge_w_streamed_kernel``
(``merge_streamed.cu``) beyond.  So the merge scans take every shape; the
streamed kernels' workspace is sized by the blocks resident on the card
(:func:`merge_streamed_plan`), not by the instances.
MPEM3 W and F have two each, picked in :func:`mpem3_geometry`: the staged
``mpem3_w_staged_kernel`` / ``mpem3_f_staged_kernel`` (``mpem3_staged.cu``,
built once per shape and B_t layout) for f32 where B_t is one dense,
16-byte-aligned run an instance-step and the buffers fit (both conversions
of the sketch sweep), and ``mpem3_w_kernel`` / ``mpem3_f_kernel`` for f64,
strided views and the rest.
The TPU-only machinery around them (lane padding, instance chunking, the
VMEM admission model) has no counterpart: one thread block (or one cluster)
owns one instance, and the only admission rule is the 227 KB shared-memory
limit a block, past which the wide (cluster) and then the streamed merge
kernels take the shape.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build
from .stta import (merge_fscan_plain, merge_sketch, merge_wscan_plain,
                   mpem3_fscan_plain, mpem3_sketch, mpem3_wscan_plain,
                   tm_to_7d)

__all__ = ["merge_stta_fused", "mpem3_stta_fused", "mpem3_stta_fused_tm",
           "merge_wscan", "merge_fscan", "mpem3_wscan", "mpem3_fscan",
           "merge_wscan_plain", "merge_fscan_plain", "mpem3_wscan_plain",
           "mpem3_fscan_plain", "merge_f_geometry", "merge_f_staged_macros",
           "merge_f_cluster_macros", "build_merge_f", "merge_w_geometry",
           "merge_w_staged_macros", "build_merge_w", "mpem3_geometry",
           "mpem3_staged_macros", "mpem3_layout", "build_mpem3",
           "merge_streamed_plan", "merge_wide_macros", "build_merge_wide",
           "MPEM3_LAYOUTS", "SMEM_LIMIT"]

#: dynamic shared memory a scan kernel's block may use: the card's limit
#: less the kernels' static reduction scratch
SMEM_LIMIT = build.SMEM_PER_BLOCK - 1024
_MPEM3_THREADS = 128
#: the staged merge F kernel's block (``NT`` in ``merge_f_staged.cu``)
_STAGED_THREADS = 256
#: the most staged blocks an SM is built for: 3 x 256 threads x 80 registers
#: fill its 65,536 registers
_STAGED_MAX_BLOCKS = 3
#: the cluster merge F kernel's block (``NT`` in ``merge_f_cluster.cu``; two
#: blocks an instance), and the most of its blocks an SM is built for: one
#: (136 registers a thread; the shapes it is picked for fill an SM's shared
#: memory with one block)
_CLUSTER_THREADS = 480
_CLUSTER_MAX_BLOCKS = 1
#: the streamed merge kernels' block (``MS_NT`` in ``merge_streamed.cu``),
#: and the blocks an SM they are built for (``__launch_bounds__``): the
#: blocks of a launch, one workspace each, are this many an SM at most
_STREAMED_THREADS = 256
_STREAMED_BLOCKS_PER_SM = 2
#: the most elements a streamed kernel's buffer may have (its sizes and
#: in-step offsets are 32-bit)
_STREAMED_MAX_ELEMENTS = 2 ** 31 - 1
#: the wide merge kernels' block (``WD_NT`` in ``merge_wide.cu``; one block
#: an SM: the shapes they take fill its shared memory) and the cluster sizes
#: they may take (blocks an instance; at most 8, the portable limit)
_WIDE_THREADS = 384
_WIDE_CLUSTERS = (1, 2, 4, 8)


def _merge_threads(smem: int) -> int:
    """256 threads while several blocks share an SM; a block that needs over
    half the shared memory runs alone on its SM, so it gets 768 threads to
    hide latency (the merge kernels use <= 78 registers: 768 x 78 fits the
    SM's 65,536)."""
    return 768 if smem > SMEM_LIMIT // 2 else 256


def _smem_merge_w(DL, DB, Y, q, sr):
    return (2 * DL * DB * sr + DL * DL * Y * q + DB * DB * Y * q
            + sr * sr * Y * Y * q + 2 * DB * DL * Y * sr)


def _smem_merge_f(DL, DB, Y, q, sr, sl, tv=False):
    """merge_f_kernel's buffers: S, S2, t1 (all y), t2, L_t, B_t, Bp, Phi_t
    and Pyy (one step's, copied in at each step where ``tv``)."""
    nS = sl * DL * DB
    return (3 * nS + nS * Y + DL * DL * Y * q + DB * DB * Y * q
            + DB * DB * Y + sl * sl * Y * q + Y * Y * Y * q)


def _smem_merge_f_staged(DL, DB, Y, q, sr, sl, esize, tv=False):
    """merge_f_staged_kernel's buffers: W_t/W_{t+1}, and L_t, B_t and Phi_t
    double-buffered (the cp.async copies run a step ahead), W, L and B each
    padded to 16 bytes; S (S2 written over it) with rows padded to an odd
    stride; t1 for both x (rows padded to an odd stride; N of one step
    reuses it); t2 and Bp for all (y, x) pairs; Pyy, double-buffered where
    ``tv`` (each step's table is staged with Phi_t, its second buffer after
    M); M of one step."""
    DLB, P = DL * DB, Y * q
    v16 = 16 // esize

    def pad(n):
        return -(-n // v16) * v16
    return (2 * pad(DLB * sr) + 2 * pad(DL * DL * P) + 2 * pad(DB * DB * P)
            + sl * (DLB | 1) + max(sl * DL * ((DB * P) | 1), sl * P * sr)
            + sl * DLB * P + DB * Y * DB * P + 2 * sl * sl * P
            + (1 + tv) * Y * Y * P + sl * sr)


def _smem_merge_f_cluster(DL, DB, Y, q, sr, sl, esize, tv=False):
    """merge_f_cluster_kernel's buffers, a block (each of the two blocks of
    an instance owns ``E0 = ceil(sl/2)`` rows of the sketch, the second
    ``floor(sl/2)``, in buffers sized for ``E0``): W_t/W_{t+1}, and L_t and
    B_t double-buffered, each padded to 16 bytes; S, own rows, padded to an
    odd stride; t1 of one x (rows padded to an odd stride; the S2 partials
    sent to the peer, 20 words for each 2x10 tile of S2, reuse it); t2 of
    one x for both y; Bp for all (y, x) pairs; Phi_t (all rows)
    double-buffered; Pyy, double-buffered where ``tv`` (its second buffer
    after N); M and N of one step, own rows."""
    DLB, P, E0 = DL * DB, Y * q, (sl + 1) // 2
    v16 = 16 // esize

    def pad(n):
        return -(-n // v16) * v16
    return (2 * pad(DLB * sr) + 2 * pad(DL * DL * P) + 2 * pad(DB * DB * P)
            + E0 * (DLB | 1)
            + max(E0 * DL * ((DB * Y) | 1), 20 * -(-sl // 2) * -(-DLB // 10))
            + Y * E0 * DLB
            + DB * Y * DB * P + 2 * sl * sl * P + (1 + tv) * Y * Y * P
            + E0 * sr + E0 * P * sr)


def _smem_merge_streamed(esize):
    """``merge_streamed.cu``'s dynamic shared memory (bytes), the same at
    every shape: the offset tables (``MS_TAB`` = 576 i64) and the two
    operand tiles (``MS_TK`` x ``MS_SPAN`` = 16 x 160 elements)."""
    return 8 * (4 * 128 + 4 * 16) + 16 * 160 * esize


def _streamed_buffers(kind, DL, DB, Y, q, sr, sl):
    """The element counts of one block's workspace buffers in
    ``merge_streamed.cu``: merge W (``kind`` "w") the one-hot W, t1, u
    and the step's Th_t transposed; merge F (``kind`` "f") the one-hot W,
    the two S buffers, t1, Bp and t2."""
    nW = DL * DB * sr
    if kind == "w":
        return (nW, DB * Y * DL * sr, DB * DL * Y * sr, (Y * sr) ** 2)
    nS = sl * DL * DB
    return (nW, nS, nS, nS * Y, (DB * Y) ** 2, nS * Y)


def merge_streamed_plan(kind, DL, DB, Y, q, sr, sl, Bn, sms):
    """(blocks, workspace elements a block) of a streamed merge W (``kind``
    "w") or F ("f") launch over ``Bn`` instances on a card of ``sms`` SMs:
    at most ``_STREAMED_BLOCKS_PER_SM`` blocks an SM (the persistent grid
    walks over the instances), so the workspace, blocks x elements, is
    bounded by the card and not by ``Bn``."""
    return (max(1, min(Bn, sms * _STREAMED_BLOCKS_PER_SM)),
            sum(_streamed_buffers(kind, DL, DB, Y, q, sr, sl)))


def _streamed_geometry(kind, DL, DB, Y, q, sr, sl, esize):
    """("streamed", threads, shared bytes) of the streamed kernel, or
    ``ValueError`` where a buffer outgrows its 32-bit sizes."""
    what = "merge W scan" if kind == "w" else "merge F scan"
    n = max(_streamed_buffers(kind, DL, DB, Y, q, sr, sl)
            + (DL * DL * Y * q, DB * DB * Y * q))
    if n > _STREAMED_MAX_ELEMENTS or min(DL, DB, Y, q, sr, sl or 1) < 1:
        raise ValueError(f"{what}: the streamed kernel takes no shape with "
                         f"an empty axis or a buffer over "
                         f"{_STREAMED_MAX_ELEMENTS} elements, at DL={DL}, "
                         f"DB={DB}, Y={Y}, q={q}, sr={sr}"
                         + (f", sl={sl}" if kind == "f" else ""))
    return "streamed", _STREAMED_THREADS, _smem_merge_streamed(esize)


def _band_pairs(Y, off):
    """The (u, v) pairs of the sum-type band ``0 <= u + v - off < Y``."""
    return sum(1 for u in range(Y) for v in range(Y) if 0 <= u + v - off < Y)


def _smem_merge_wide(kind, DL, DB, Y, q, sr, sl, c, esize, band):
    """Shared elements of one block of the wide merge W (``kind`` "w") or F
    ("f") kernel over a cluster of ``c`` blocks, each buffer rounded up to
    16 bytes.  W, a block owning MR = ceil(DB/c) rows m: W_{t+1}, W_t's
    slice twice (step parity), L_t, B_t's rows, Th_t (its band ``psi``
    where ``band``, else dense), t1 and u of its rows.  F, a block owning
    EL = ceil(sl/c) rows e: S's rows, the S2 partials (every row), W_{t+1},
    L_t, B_t, Phi_t's rows, t1 and t2 of its rows, and Bp unless
    ``band``."""
    v16 = 16 // esize

    def pad(n):
        return -(-n // v16) * v16
    if kind == "w":
        mr = -(-DB // c)
        th = Y * sr * sr if band else Y * Y * sr * sr
        return (pad(DL * DB * sr) + 2 * pad(DL * mr * sr) + pad(DL * DL * Y)
                + pad(mr * DB * Y) + pad(th) + pad(mr * Y * DL * sr)
                + pad(mr * DL * Y * sr))
    el, DLB = -(-sl // c), DL * DB
    return (pad(el * DLB) + pad(sl * DLB) + pad(DLB * sr) + pad(DL * DL * Y)
            + pad(DB * DB * Y) + pad(el * sl * Y) + 2 * pad(el * DLB * Y)
            + (0 if band else pad(Y * DB * Y * DB)))


def _wide_products(kind, DL, DB, Y, q, sr, sl, c, band, off):
    """(rows, column blocks, columns a block, sums on average, the inner
    sums K1 that lanes may split) of each product of the wide kernel, in
    the order of its tile macros ``WD_P<i>_*``: W's t1, u, W_t; F's M, t1,
    t2, N, S2.  Banded products count the band's pairs."""
    pairs = _band_pairs(Y, off or 0) if band else Y * Y
    if kind == "w":
        mr = -(-DB // c)
        return [(mr * Y, DL, sr, DB, DB), (mr * DL, Y, sr, pairs * sr / Y, sr),
                (DL, mr, sr, DL * Y, DL * Y)]
    el, DLB = -(-sl // c), DL * DB
    return [(el, 1, sr, DLB, DLB), (el * DB, 1, DL * Y, DL, DL),
            (el * DL, Y, DB, pairs * DB / Y, DB), (el * Y, 1, sr, DLB, DLB),
            (sl, 1, DLB, el * Y, Y)]


def _wide_tile(rows, n0, n1, k, k1, threads, esize):
    """(TM, TN, KS) of one product of the wide kernel: in f32, a TM x TN
    register tile (TM, TN <= 8) of one column block, its sums split over KS
    lanes (KS <= k1, the inner sums), the least instructions a thread
    issues (rounds of tasks times the FMAs and loads of its sums), the
    larger tile on a tie; in f64, a warp tile of TM x TN tensor-core tiles
    of 8 x 8 (TM * TN <= 4), KS 1."""
    best = None
    if esize == 8:
        for wm in (1, 2, 4):
            for wn in (1, 2, 4):
                if wm * wn > 4:
                    continue
                tiles = -(-rows // (8 * wm)) * n0 * -(-n1 // (8 * wn))
                cost = -(-tiles // (threads // 32)) * -(-k // 4) * (
                    4 * wm * wn + wm + wn)
                if best is None or (cost, -wm * wn) < best[0]:
                    best = ((cost, -wm * wn), (wm, wn, 1))
        return best[1]
    for tm in range(1, min(rows, 8) + 1):
        for tn in range(1, min(n1, 8) + 1):
            tiles = -(-rows // tm) * n0 * -(-n1 // tn)
            for ks in (1, 2, 4, 8, 16):
                if ks > k1:
                    break
                tasks = tiles if ks == 1 else -(-tiles * ks // 32) * 32
                cost = -(-tasks // threads) * (
                    -(-k // ks) * (tm * tn + tm + tn)
                    + 2 * tm * tn * (ks.bit_length() - 1))
                if best is None or (cost, -tm * tn) < best[0]:
                    best = ((cost, -tm * tn), (tm, tn, ks))
    return best[1]


@functools.lru_cache(maxsize=None)
def _wide_plan(kind, DL, DB, Y, q, sr, sl, esize, band):
    """(blocks a cluster, shared elements a block) of the wide merge kernel:
    the fewest blocks of :data:`_WIDE_CLUSTERS` whose shared memory holds
    the step, each block owning at least one row; None if none does."""
    rows = DB if kind == "w" else sl
    for c in _WIDE_CLUSTERS:
        if c > rows or (c - 1) * -(-rows // c) >= rows:
            continue
        n = _smem_merge_wide(kind, DL, DB, Y, q, sr, sl, c, esize, band)
        if n * esize <= SMEM_LIMIT:
            return c, n
    return None


def _wide_geometry(kind, DL, DB, Y, q, sr, sl, esize, band):
    """("wide", threads, shared bytes) of the wide kernel, or None."""
    plan = _wide_plan(kind, DL, DB, Y, q, sr, sl, esize, band)
    return None if plan is None else ("wide", _WIDE_THREADS,
                                      plan[1] * esize)


@functools.lru_cache(maxsize=None)
def merge_wide_macros(kind, DL, DB, Y, q, sr, sl, dtype, off=None):
    """The macros ``merge_wide.cu`` is built with for one merge W (``kind``
    "w"; ``sl`` is not read) or merge F ("f") shape: its sizes, its element
    type, the cluster's blocks (``WD_C``), the threads a block
    (``WD_NT``), the band (``WD_BAND``, and its offset ``WD_OFF``, where
    ``off`` is given: the tables' ``yy_off``) and each product's tiles.  A
    pure function of its arguments.  Raises ``ValueError`` where no
    cluster holds the shape."""
    esize = 4 if dtype == torch.float32 else 8
    band = off is not None
    sl = sl if kind == "f" else 0
    plan = _wide_plan(kind, DL, DB, Y, q, sr, sl, esize, band)
    if plan is None:
        raise ValueError(f"merge {kind.upper()} scan: no cluster of up to "
                         f"{_WIDE_CLUSTERS[-1]} blocks holds the wide "
                         f"kernel's buffers at DL={DL}, DB={DB}, Y={Y}, "
                         f"q={q}, sr={sr}" + (f", sl={sl}" if sl else ""))
    c = plan[0]
    out = [f"WD_T={'float' if esize == 4 else 'double'}",
           f"WD_KIND={0 if kind == 'w' else 1}", f"WD_DL={DL}",
           f"WD_DB={DB}", f"WD_Y={Y}", f"WD_Q={q}", f"WD_SR={sr}",
           f"WD_SL={sl}", f"WD_C={c}", f"WD_NT={_WIDE_THREADS}",
           f"WD_BAND={int(band)}", f"WD_OFF={off if band else 0}"]
    for i, p in enumerate(_wide_products(kind, DL, DB, Y, q, sr, sl, c, band,
                                         off)):
        tm, tn, ks = _wide_tile(*p, _WIDE_THREADS, esize)
        out += [f"WD_P{i}_TM={tm}", f"WD_P{i}_TN={tn}", f"WD_P{i}_KS={ks}"]
    return tuple(out)


def build_merge_wide(shapes):
    """Build, all at once, the wide merge libraries of the shapes ``(kind,
    DL, DB, Y, q, sr, sl, dtype[, off])``."""
    build.build_all([("merge_wide", merge_wide_macros(*shape))
                     for shape in shapes])


_WIDE_CHECKED = set()


def _wide_library(macros, smem):
    """The wide kernel's library for one shape; at its first use, raises if
    the card cannot hold one of its clusters at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = build.library("merge_wide", macros)
    if (macros, smem) not in _WIDE_CHECKED:
        n = lib.merge_wide_occupancy(smem)
        if n < 0:
            _raise_on(-n, "wide merge set-up")
        if n == 0:
            raise RuntimeError(
                "wide merge kernel: a cluster of its blocks of "
                f"{smem} bytes of shared memory cannot be scheduled")
        _WIDE_CHECKED.add((macros, smem))
    return lib


def merge_f_geometry(DL, DB, Y, q, sr, sl, dtype, variant=None, tv=False,
                     band=False):
    """(variant, threads a block, shared-memory bytes a block) of the merge F
    kernel for one shape (``tv``: reading one ``Pyy`` a step), the first
    whose buffers fit in ``SMEM_LIMIT`` of:
    ``"staged"`` (``merge_f_staged_kernel``; f32 sketch merges up to D=15:
    it ran faster than ``merge_f_kernel`` at every D from 4 to 15, one
    block an SM included), ``"cluster"`` (``merge_f_cluster_kernel``, two
    blocks an instance; f32 sketch merges from D=16 to D=20) and ``"base"``
    (``merge_f_kernel``); else ``"wide"`` (``merge_f_wide_kernel``, one
    instance over a cluster of up to 8 blocks: f64 from D=16, the banded
    Glauber merges at D=18, f32 Y=2 from D=21), where a cluster holds the
    step (``band``: the tables are the sum-type band, whose merges need no
    dense Bp); else ``"streamed"`` (``merge_f_streamed_kernel``, whose
    shared memory does not grow with the shape).  ``variant`` forces one of
    the five.  Raises ``ValueError`` where the forced kernel does not fit,
    or a streamed buffer outgrows its 32-bit sizes."""
    esize = 4 if dtype == torch.float32 else 8
    sizes = {"staged": _smem_merge_f_staged(DL, DB, Y, q, sr, sl, esize, tv),
             "cluster": _smem_merge_f_cluster(DL, DB, Y, q, sr, sl, esize,
                                              tv),
             "base": _smem_merge_f(DL, DB, Y, q, sr, sl, tv)}
    threads = {"staged": _STAGED_THREADS, "cluster": _CLUSTER_THREADS}
    for name in (tuple(sizes) + ("wide", "streamed") if variant is None
                 else (variant,)):
        if name == "streamed":
            return _streamed_geometry("f", DL, DB, Y, q, sr, sl, esize)
        if name == "wide":
            picked = _wide_geometry("f", DL, DB, Y, q, sr, sl, esize, band)
            if picked is not None:
                return picked
            nbytes = _smem_merge_wide("f", DL, DB, Y, q, sr, sl,
                                      _WIDE_CLUSTERS[-1], esize, band) * esize
            continue
        nbytes = sizes[name] * esize
        if nbytes <= SMEM_LIMIT:
            return name, threads.get(name, _merge_threads(nbytes)), nbytes
    raise ValueError(f"merge F scan: needs {nbytes} bytes of shared memory "
                     f"per block, over the {SMEM_LIMIT}-byte limit, at "
                     f"DL={DL}, DB={DB}, Y={Y}, q={q}, sr={sr}, sl={sl}"
                     + (", one Pyy a step" if tv else ""))


def _merge_f_macros(variant, most, DL, DB, Y, q, sr, sl, dtype, tv=False):
    _, _, smem = merge_f_geometry(DL, DB, Y, q, sr, sl, dtype, variant, tv)
    minb = min(most, build.SMEM_PER_SM // (smem + build.SMEM_RESERVED))
    return (f"MF_T={'float' if dtype == torch.float32 else 'double'}",
            f"MF_DL={DL}", f"MF_DB={DB}", f"MF_Y={Y}", f"MF_Q={q}",
            f"MF_SR={sr}", f"MF_SL={sl}", f"MF_MINB={minb}"
            ) + (("MF_TV=1",) if tv else ())


def merge_f_staged_macros(DL, DB, Y, q, sr, sl, dtype, tv=False):
    """The macros ``merge_f_staged.cu`` is built with for one shape: its
    sizes, its element type and ``MF_MINB``, the blocks whose shared memory
    fits on one SM (at most ``_STAGED_MAX_BLOCKS``), which sets the
    register budget ptxas gets.  A time-varying shape (``tv``: a ``Pyy`` a
    step) adds ``MF_TV=1`` and so gets a build of its own; a shared table's
    build has no ``MF_TV`` and compiles none of the per-step staging."""
    return _merge_f_macros("staged", _STAGED_MAX_BLOCKS, DL, DB, Y, q, sr, sl,
                           dtype, tv)


def merge_f_cluster_macros(DL, DB, Y, q, sr, sl, dtype, tv=False):
    """The macros ``merge_f_cluster.cu`` is built with for one shape, as
    :func:`merge_f_staged_macros` (``MF_MINB`` at most
    ``_CLUSTER_MAX_BLOCKS``)."""
    return _merge_f_macros("cluster", _CLUSTER_MAX_BLOCKS, DL, DB, Y, q, sr,
                           sl, dtype, tv)


#: the per-shape merge F kernels: variant -> (source, its macros)
_PER_SHAPE_MERGE_F = {"staged": ("merge_f_staged", merge_f_staged_macros),
                      "cluster": ("merge_f_cluster", merge_f_cluster_macros)}


def _merge_f_target(variant, shape):
    src, macros = _PER_SHAPE_MERGE_F[variant]
    return src, macros(*shape)


def build_merge_f(shapes, variant=None):
    """Build, all at once, the per-shape merge F libraries (staged or
    cluster) of the shapes ``(DL, DB, Y, q, sr, sl, dtype[, tv])``: the kernel
    :func:`merge_f_geometry` picks for each, or ``variant`` for all; a
    caller that knows its shapes ahead spares their serial builds at first
    use."""
    targets = []
    for shape in shapes:
        v = variant or merge_f_geometry(*shape[:7], None, *shape[7:])[0]
        if v in _PER_SHAPE_MERGE_F:
            targets.append(_merge_f_target(v, shape))
    build.build_all(targets)


_CLUSTERS_CHECKED = set()


def _cluster_library(macros, smem):
    """The cluster kernel's library for one shape; at its first use, raises
    if the card cannot hold one cluster of two such blocks at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = build.library("merge_f_cluster", macros)
    if (macros, smem) not in _CLUSTERS_CHECKED:
        n = lib.merge_f_cluster_occupancy(smem)
        if n < 0:
            _raise_on(-n, "merge F cluster set-up")
        if n == 0:
            raise RuntimeError(
                "merge F cluster kernel: a cluster of two blocks of "
                f"{smem} bytes of shared memory cannot be scheduled")
        _CLUSTERS_CHECKED.add((macros, smem))
    return lib


#: the staged merge W kernel's threads a block (``MW_NT``) by the blocks an
#: SM holds (``MW_MINB``): 13 warps alone on an SM, fewer as more blocks
#: share one, so that each thread may have 128 registers or more
_MERGE_W_THREADS = {1: 416, 2: 256, 3: 160, 4: 128}


def _smem_merge_w_staged(DL, DB, Y, q, sr, nc, esize):
    """merge_w_staged_kernel's buffers (elements) with chunks of ``nc`` rows
    n, each rounded up to 16 bytes: W (NP = nc x chunks rows); L_t, B_t and
    Th_t (transposed) double-buffered; t1 and u of one chunk.  Rows are
    padded against bank conflicts (t1's rows and x blocks and B_t's rows to
    odd strides, W's and u's rows to even ones that are not multiples of 4
    at the sketch merges, L_t's rows to 4 mod 8 words, for its 16-byte
    loads)."""
    P, v16 = Y * q, 16 // esize
    NP = -(-DL // nc) * nc

    def pad(n):
        return -(-n // v16) * v16
    wn = ((DB * sr) | 1) + 1
    return (pad(NP * wn) + 2 * pad(DL * ((-(-NP * P // 4) * 4) | 4))
            + 2 * pad(DB * ((DB * P) | 1)) + 2 * pad(q * Y * sr * Y * sr)
            + pad(q * ((nc * DB * ((Y * sr) | 1)) | 1)) + pad(nc * P * wn))


def _merge_w_chunk(DL, DB, Y, q, sr, esize):
    """The rows n a chunk of the staged merge W kernel takes: the fewest
    chunks whose buffers fit in ``SMEM_LIMIT``, or None."""
    for chunks in range(1, DL + 1):
        nc = -(-DL // chunks)
        if (_smem_merge_w_staged(DL, DB, Y, q, sr, nc, esize) * esize
                <= SMEM_LIMIT):
            return nc
    return None


def _tile_tasks(rows, cols, batches, tm, tn):
    return -(-rows // tm) * -(-cols // tn) * batches


def _tile_step_cost(cols, tm, tn):
    """Instructions one tile issues a K step: its FMAs and loads, the loads
    of a column operand row charged the bank conflict of up to 32
    neighbouring column tiles TN words apart."""
    banks = collections.Counter(
        tn * j % 32 for j in range(min(-(-cols // tn), 32)))
    return tm * tn + tm + tn * max(banks.values())


def _pick_tile(rows, cols, batches, threads, most, one_round=False):
    """(TM, TN) register tile of one product ([rows x cols] per batch): the
    least instructions a thread issues per K step (rounds of tasks times
    FMAs and loads), at most ``most`` outputs; ``one_round`` asks for one
    tile a thread at most.  A warp's lanes take neighbouring column tiles,
    so the loads of a column operand row are charged the bank conflict of
    up to 32 tiles TN words apart.  None if nothing fits."""
    best = None
    for tm in range(1, min(rows, 8) + 1):
        for tn in range(1, min(cols, 10) + 1):
            if tm * tn > most:
                continue
            tasks = _tile_tasks(rows, cols, batches, tm, tn)
            if one_round and tasks > threads:
                continue
            cost = -(-tasks // threads) * _tile_step_cost(cols, tm, tn)
            if best is None or (cost, -tm * tn) < best[0]:
                best = ((cost, -tm * tn), (tm, tn))
    return None if best is None else best[1]


def _pick_tile_split(rows, cols, batches, k1, k2, threads, most):
    """(TM, TN, KS) of one product of the staged MPEM3 kernels: K = k1 x k2
    steps, the k1 ones split over KS neighbouring lanes (a power of two,
    reduced by warp shuffles, the tasks padded to whole warps) where that
    costs fewer instructions a thread than one lane a tile; the tile for
    each KS from :func:`_pick_tile` over ``threads // KS`` lanes."""
    best = None
    ks = 1
    while ks <= min(k1, 32, threads):
        tm, tn = _pick_tile(rows, cols, batches, threads // ks, most)
        tasks = _tile_tasks(rows, cols, batches, tm, tn) * ks
        if ks > 1:
            tasks = -(-tasks // 32) * 32
        rounds = -(-tasks // threads)
        cost = rounds * (-(-k1 // ks) * k2 * _tile_step_cost(cols, tm, tn)
                         + 2 * tm * tn * (ks.bit_length() - 1))
        if best is None or cost < best[0]:
            best = (cost, (tm, tn, ks))
        ks *= 2
    return best[1]


@functools.lru_cache(maxsize=None)
def _merge_w_staged_plan(DL, DB, Y, q, sr, esize):
    """(nc, blocks an SM, threads, (AM, AN, BM, BN, CM, CN), smem elements)
    of the staged merge W kernel, or None where it does not fit: t1's
    tiles over [DB x sr] per (n, v, x), u's over [DB x Y*sr] per (x, n),
    W2's over [DL x DB*sr] with one tile a thread (it stays in registers);
    up to 40 outputs a tile in f32 (20 for W2), half that in f64."""
    nc = _merge_w_chunk(DL, DB, Y, q, sr, esize)
    if nc is None:
        return None
    smem = _smem_merge_w_staged(DL, DB, Y, q, sr, nc, esize)
    blocks = min(4, build.SMEM_PER_SM // (smem * esize
                                        + build.SMEM_RESERVED))
    threads = _MERGE_W_THREADS[blocks]
    most = 40 if esize == 4 else 20
    a = _pick_tile(DB, sr, nc * Y * q, threads, most)
    b = _pick_tile(DB, Y * sr, q * nc, threads, most)
    c = _pick_tile(DL, DB * sr, 1, threads, most // 2, one_round=True)
    if c is None:
        return None
    return nc, blocks, threads, a + b + c, smem


def merge_w_geometry(DL, DB, Y, q, sr, dtype, variant=None, band=False):
    """(variant, threads a block, shared-memory bytes a block) of the merge W
    kernel for one shape: ``"staged"`` (``merge_w_staged_kernel``) at the
    f32 sketch merges (Y = q = 2) where its buffers fit, the shapes where
    ``tools/probe_merge_w.py`` timed it faster than ``merge_w_kernel``;
    else ``"base"`` (``merge_w_kernel``: f64, Y=3 and the other shapes)
    where its buffers fit; else ``"wide"`` (``merge_w_wide_kernel``, one
    instance over a cluster of up to 8 blocks; ``band``: Th is the
    sum-type band's) where a cluster holds the step; else ``"streamed"``
    (``merge_w_streamed_kernel``, whose shared memory does not grow with
    the shape).  ``variant`` forces one of the four.  Raises
    ``ValueError`` where the forced kernel does not fit, or a streamed
    buffer outgrows its 32-bit sizes."""
    esize = 4 if dtype == torch.float32 else 8
    timed = esize == 4 and (Y, q) == (2, 2)
    names = (("staged", "base") if timed else ("base",)) + (
        "wide", "streamed") if variant is None else (variant,)
    for name in names:
        if name == "streamed":
            return _streamed_geometry("w", DL, DB, Y, q, sr, None, esize)
        if name == "wide":
            picked = _wide_geometry("w", DL, DB, Y, q, sr, 0, esize, band)
            if picked is not None:
                return picked
            nbytes = _smem_merge_wide("w", DL, DB, Y, q, sr, 0,
                                      _WIDE_CLUSTERS[-1], esize, band) * esize
            continue
        if name == "staged":
            plan = _merge_w_staged_plan(DL, DB, Y, q, sr, esize)
            if plan is not None:
                return name, plan[2], plan[4] * esize
            nbytes = _smem_merge_w_staged(DL, DB, Y, q, sr, 1, esize) * esize
        else:
            nbytes = _smem_merge_w(DL, DB, Y, q, sr) * esize
            if nbytes <= SMEM_LIMIT:
                return name, _merge_threads(nbytes), nbytes
    raise ValueError(f"merge W scan: needs {nbytes} bytes of shared memory "
                     f"per block, over the {SMEM_LIMIT}-byte limit, at "
                     f"DL={DL}, DB={DB}, Y={Y}, q={q}, sr={sr}")


def merge_w_staged_macros(DL, DB, Y, q, sr, dtype):
    """The macros ``merge_w_staged.cu`` is built with for one shape: its
    sizes, its element type, the chunk of rows n (``MW_NC``), the threads
    (``MW_NT``), the blocks whose shared memory fits on one SM (``MW_MINB``,
    at most 4; the register budget) and the three products' register
    tiles.  Raises ``ValueError`` where its buffers do not fit."""
    esize = 4 if dtype == torch.float32 else 8
    plan = _merge_w_staged_plan(DL, DB, Y, q, sr, esize)
    if plan is None:
        merge_w_geometry(DL, DB, Y, q, sr, dtype, "staged")   # raises
    nc, blocks, threads, tiles, _ = plan
    return ((f"MW_T={'float' if esize == 4 else 'double'}", f"MW_DL={DL}",
             f"MW_DB={DB}", f"MW_Y={Y}", f"MW_Q={q}", f"MW_SR={sr}",
             f"MW_NC={nc}", f"MW_NT={threads}", f"MW_MINB={blocks}")
            + tuple(f"MW_{k}={v}" for k, v in zip(
                ("AM", "AN", "BM", "BN", "CM", "CN"), tiles)))


def build_merge_w(shapes):
    """Build, all at once, the staged merge W libraries of the shapes
    ``(DL, DB, Y, q, sr, dtype)``."""
    build.build_all([("merge_w_staged", merge_w_staged_macros(*shape))
                     for shape in shapes])


def _smem_mpem3_w(Db, qi, qj, sr):
    return (2 * Db * qi * sr + Db * Db * qi * qj * qi + sr * sr * qi * qj
            + Db * qi * qj * sr)


def _smem_mpem3_f(Db, qi, qj, sr, sl):
    return (2 * sl * Db * qi + Db * Db * qi * qj * qi + sl * sl * qi * qj
            + sl * Db * qi * qj * qi)


#: the staged MPEM3 kernels' B_t element orders (``M3_LAYOUT`` 0 and 1): the
#: message conversion's time-major rows ``(i, j, r, m, n)`` and the belief
#: conversion's contiguous ``(m, n, i, j, r)``
MPEM3_LAYOUTS = ("ijrmn", "mnijr")
#: the FMAs an instance-step above which a staged MPEM3 instance takes two
#: warps, not one: ``tools/probe_mpem3.py --gt`` timed 32, 64 and 128
#: threads an instance at D = 8 to 20; one warp was fastest, or within 2%,
#: at every step of up to 82k FMAs, two at the D=20 steps of 96k to 265k,
#: four at none; between, one and two came within 8% of each other
_MPEM3_TWO_WARPS_FMA = 90_000
#: the most threads of staged MPEM3 blocks an SM holds, so that each may
#: keep 64 registers: with up to 2,048 (32 registers) ptxas spilled at the
#: small shapes, which ran up to 30% slower (``tools/probe_mpem3.py``)
_MPEM3_THREADS_AN_SM = 1024


def _smem_mpem3_staged(Db, qi, qj, sr, sl, esize):
    """(a block's shared elements, an instance's) of the staged MPEM3 F
    kernel (``sl`` given) or W kernel (``sl`` None), each buffer rounded up
    to 16 bytes.  F, a block: Phi_t for two steps; an instance: S and S2
    (rows padded to the odd MI|1), B_t for two steps, W_t, W_{t+1} and
    W_{t+2}, t1 (rows MI|1), and M and N where they do not fit over the
    step's B_t buffer.  W, a block: Psi_t for two steps; an instance: W,
    B_t for two steps, t1 (rows (qj*sr)|1)."""
    P, MI, v16 = qi * qj, Db * qi, 16 // esize

    def pad(n):
        return -(-n // v16) * v16
    nB, nW = pad(Db * Db * P * qi), pad(MI * sr)
    if sl is None:
        return 2 * pad(sr * sr * P), nW + 2 * nB + pad(MI * ((qj * sr) | 1))
    ob = pad(sl * sr) + sl * P * sr
    return 2 * pad(sl * sl * P), (2 * pad(sl * (MI | 1)) + 2 * nB + 3 * nW
                                  + pad(sl * P * (MI | 1))
                                  + (0 if ob <= nB else pad(ob)))


def _mpem3_products(Db, qi, qj, sr, sl, layout):
    """(rows, cols, batches, k1, k2) of each product of the staged F kernel
    (t1, M, N, S2) or W kernel (t1, W2; ``sl`` None), in the order of
    their tile macros ``M3_P0_*``, ``M3_P1_*``, ..."""
    P, MI = qi * qj, Db * qi
    if sl is None:
        k = (qi, Db) if layout == "ijrmn" else (Db, qi)
        return [(Db, sr, P) + k, (Db, sr, qi, qj, sr)]
    return [(sl, MI, P, Db, 1), (sl, sr, 1, MI, 1), (sl * P, sr, 1, MI, 1),
            (sl, MI, 1, sl, P)]


@functools.lru_cache(maxsize=None)
def _mpem3_staged_plan(Db, qi, qj, sr, sl, esize, layout, gt=None):
    """(threads an instance, instances a block, blocks an SM, tiles, shared
    elements a block) of the staged MPEM3 F kernel (``sl`` given) or W
    kernel (``sl`` None), or None where one instance's buffers do not fit.
    An instance takes one warp, or two where its step does more than
    ``_MPEM3_TWO_WARPS_FMA`` FMAs, unless ``gt`` (threads) is given; a
    block takes the instances (at most 8) that put the most on an SM, then
    the most blocks, with at most ``_MPEM3_THREADS_AN_SM`` threads an SM;
    each product's tile from :func:`_pick_tile_split` (up to 32 outputs in
    f32, 16 in f64)."""
    shared, inst = _smem_mpem3_staged(Db, qi, qj, sr, sl, esize)
    if (shared + inst) * esize > SMEM_LIMIT:
        return None
    products = _mpem3_products(Db, qi, qj, sr, sl, layout)
    if gt is None:
        fma = sum(r * c * b * k1 * k2 for r, c, b, k1, k2 in products)
        gt = 64 if fma > _MPEM3_TWO_WARPS_FMA else 32
    best = None
    for ipb in range(1, min(8, 1024 // gt) + 1):
        smem = (shared + ipb * inst) * esize
        if smem > SMEM_LIMIT:
            break
        blocks = min(build.SMEM_PER_SM // (smem + build.SMEM_RESERVED),
                     _MPEM3_THREADS_AN_SM // (ipb * gt))
        key = (blocks * ipb, blocks)
        if best is None or key > best[0]:
            best = (key, ipb, blocks, smem)
    _, ipb, blocks, smem = best
    most = 32 if esize == 4 else 16
    tiles = tuple(_pick_tile_split(*p, gt, most) for p in products)
    return gt, ipb, blocks, tiles, smem // esize


def mpem3_geometry(Db, qi, qj, sr, sl, dtype, layout, variant=None):
    """(variant, threads a block, shared-memory bytes a block) of the MPEM3
    F kernel (``sl`` given) or W kernel (``sl`` None) for one shape:
    ``"staged"`` (``mpem3_f_staged_kernel`` / ``mpem3_w_staged_kernel``,
    built per shape) for f32 where B_t is one dense, 16-byte-aligned run an
    instance-step (``layout`` one of :data:`MPEM3_LAYOUTS`, not None) and
    the buffers fit; else ``"base"`` (``mpem3_f_kernel`` /
    ``mpem3_w_kernel``: f64, strided views and the rest).  ``variant``
    forces one of the two.  Raises ``ValueError`` where the kernel does not
    fit (or the forced staged one cannot read B_t)."""
    esize = 4 if dtype == torch.float32 else 8
    what = "MPEM3 W scan" if sl is None else "MPEM3 F scan"
    if variant is None:
        variant = "staged" if esize == 4 and layout is not None else "base"
        if variant == "staged" and _mpem3_staged_plan(
                Db, qi, qj, sr, sl, esize, layout) is None:
            variant = "base"
    if variant == "staged":
        if layout not in MPEM3_LAYOUTS:
            raise ValueError(f"{what}: the staged kernel needs B_t as one "
                             "dense, 16-byte-aligned run an instance-step "
                             f"in one of {MPEM3_LAYOUTS}")
        plan = _mpem3_staged_plan(Db, qi, qj, sr, sl, esize, layout)
        if plan is None:
            shared, inst = _smem_mpem3_staged(Db, qi, qj, sr, sl, esize)
            nbytes = (shared + inst) * esize
        else:
            return "staged", plan[0] * plan[1], plan[4] * esize
    else:
        nbytes = esize * (_smem_mpem3_w(Db, qi, qj, sr) if sl is None
                          else _smem_mpem3_f(Db, qi, qj, sr, sl))
        if nbytes <= SMEM_LIMIT:
            return "base", _MPEM3_THREADS, nbytes
    raise ValueError(f"{what}: needs {nbytes} bytes of shared memory per "
                     f"block, over the {SMEM_LIMIT}-byte limit, at Db={Db}, "
                     f"qi={qi}, qj={qj}, sr={sr}, sl={sl}")


def mpem3_staged_macros(Db, qi, qj, sr, sl, dtype, layout, gt=None):
    """The macros ``mpem3_staged.cu`` is built with for one shape: the
    staged F kernel's (``sl`` given) or W kernel's (``sl`` None, built as
    ``M3_SL=0``): its sizes, its element type, B_t's element order
    (``M3_LAYOUT``), the threads an instance (``M3_GT``; ``gt`` overrides
    the plan's, for the probe), the instances a block (``M3_IPB``), the
    blocks an SM (``M3_MINB``, the register budget) and each product's tile
    and K split.  Raises ``ValueError`` where it does not fit."""
    esize = 4 if dtype == torch.float32 else 8
    mpem3_geometry(Db, qi, qj, sr, sl, dtype, layout, "staged")  # raises
    gt, ipb, blocks, tiles, _ = _mpem3_staged_plan(Db, qi, qj, sr, sl,
                                                   esize, layout, gt)
    out = [f"M3_T={'float' if esize == 4 else 'double'}", f"M3_DB={Db}",
           f"M3_QI={qi}", f"M3_QJ={qj}", f"M3_SR={sr}", f"M3_SL={sl or 0}",
           f"M3_LAYOUT={MPEM3_LAYOUTS.index(layout)}", f"M3_GT={gt}",
           f"M3_IPB={ipb}", f"M3_MINB={blocks}"]
    for k, (tm, tn, ks) in enumerate(tiles):
        out += [f"M3_P{k}_TM={tm}", f"M3_P{k}_TN={tn}", f"M3_P{k}_KS={ks}"]
    return tuple(out)


def build_mpem3(shapes):
    """Build, all at once, the staged MPEM3 libraries of the shapes ``(Db,
    qi, qj, sr, sl, dtype, layout)`` (``sl`` None for the W kernel)."""
    build.build_all([("mpem3_staged", mpem3_staged_macros(*shape))
                     for shape in shapes])


def mpem3_layout(B1, *others):
    """B1's B_t element order (one of :data:`MPEM3_LAYOUTS`) where each
    instance-step [Db, Db, qi, qj, qi] is one dense run and every tensor of
    B1 and ``others`` (the contiguous streamed operands) starts on 16
    bytes, with B1's instance and time strides whole 16-byte chunks; else
    None.  Axes of size one match any stride."""
    Bn, S, Db, _, qi, qj, _ = B1.shape
    esize = B1.element_size()
    shape, st = B1.shape, B1.stride()
    orders = {"ijrmn": (Db, 1, qj * qi * Db * Db, qi * Db * Db, Db * Db),
              "mnijr": (Db * qi * qj * qi, qi * qj * qi, qj * qi, qi, 1)}
    if any(t.data_ptr() % 16 for t in (B1,) + others) or any(
            shape[a] > 1 and st[a] * esize % 16 for a in (0, 1)):
        return None
    for name, inner in orders.items():
        if all(shape[2 + a] == 1 or st[2 + a] == inner[a] for a in range(5)):
            return name
    return None


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors must share one CPU or CUDA device: {devs}")
    return False


def _dtype_code(*ts) -> int:
    dt = ts[0].dtype
    if any(t.dtype != dt for t in ts) or dt not in (torch.float32,
                                                    torch.float64):
        raise TypeError("scan kernels take float32 or float64 tensors of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    return 0 if dt == torch.float32 else 1


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_contiguous(**ts):
    for name, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _strides(t):
    return (ctypes.c_longlong * t.ndim)(*t.stride())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def merge_wscan(L1, B1, Th, _variant=None, yy_off=None):
    """Reverse merge scan; arguments and result as
    :func:`merge_wscan_plain`.  L1/B1 may be strided views.  On the card it
    launches the kernel :func:`merge_w_geometry` picks (``_variant`` forces
    one, for tests).  ``yy_off``: Th is ``y_expand(psi, yy_off, mode="sum")``
    (zero off the band), and the wide kernel reads its band alone."""
    if _on_cpu(L1, B1, Th):
        return merge_wscan_plain(L1, B1, Th)
    code = _dtype_code(L1, B1, Th)
    Bn, S, DL, _, Y, q = L1.shape
    DB, sr = B1.shape[2], Th.shape[1]
    _check_shape("B1", B1, (Bn, S, DB, DB, Y, q))
    _check_shape("Th", Th, (S, sr, sr, Y, Y, q))
    _check_contiguous(Th=Th)
    band = yy_off is not None
    variant, threads, smem = merge_w_geometry(DL, DB, Y, q, sr, L1.dtype,
                                              _variant, band)
    Ws = L1.new_empty((Bn, S, DL, DB, sr))
    if Bn == 0 or S == 0:
        return Ws
    args = (L1.data_ptr(), _strides(L1), B1.data_ptr(), _strides(B1),
            Th.data_ptr(), Ws.data_ptr(), Bn, S, DL, DB, Y, q, sr)
    if variant == "staged":
        lib = build.library("merge_w_staged", merge_w_staged_macros(
            DL, DB, Y, q, sr, L1.dtype))
        rc = lib.merge_w_staged(*args, smem, _stream(L1))
    elif variant == "wide":
        lib = _wide_library(merge_wide_macros("w", DL, DB, Y, q, sr, 0,
                                              L1.dtype, yy_off), smem)
        rc = lib.merge_w_wide(*args, smem, _stream(L1))
    elif variant == "streamed":
        blocks, per = merge_streamed_plan("w", DL, DB, Y, q, sr, None, Bn,
                                          _sm_count(L1.device))
        work = L1.new_empty(blocks * per)
        rc = build.library("merge_streamed").merge_w_streamed(
            code, *args[:6], work.data_ptr(), *args[6:], blocks, smem,
            _stream(L1))
    else:
        rc = build.library("stta_scans").stta_merge_w(
            code, *args, threads, smem, _stream(L1))
    _raise_on(rc, "merge W scan")
    merge_wscan.launches += 1
    merge_wscan.variant_launches[variant] += 1
    return Ws


def merge_fscan(L1, B1, Pyy, Phi, Ws, S_init, _variant=None, yy_off=None):
    """Forward merge scan; arguments and results as
    :func:`merge_fscan_plain`.  On the card it launches the kernel
    :func:`merge_f_geometry` picks (``_variant`` forces one, for tests).
    ``Pyy`` is [S, Y, Y, Y, q], one table a step, or [Y, Y, Y, q], one for
    all; the kernels read step s's at ``Pyy + s * pyy_step``, with
    ``pyy_step = Pyy.stride(0)``: 0 for a shared table (also one expanded
    over S), and then they load it once.  ``yy_off``: Pyy is the shared
    ``band_indicator(Y, yy_off, q)``, which the wide kernel does not read:
    it takes B_t along the band."""
    if _on_cpu(L1, B1, Pyy, Phi, Ws, S_init):
        return merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S_init)
    code = _dtype_code(L1, B1, Pyy, Phi, Ws, S_init)
    Bn, S, DL, _, Y, q = L1.shape
    DB, sl, sr = B1.shape[2], Phi.shape[1], Ws.shape[-1]
    _check_shape("B1", B1, (Bn, S, DB, DB, Y, q))
    if Pyy.ndim == 4:
        Pyy = Pyy.expand((S,) + Pyy.shape)
    _check_shape("Pyy", Pyy, (S, Y, Y, Y, q))
    # one step reads one table (a leading axis of size one keeps its
    # stride, even when expanded)
    pyy_step = Pyy.stride(0) if S > 1 else 0
    tv = pyy_step != 0
    _check_shape("Phi", Phi, (S, sl, sl, Y, q))
    _check_shape("Ws", Ws, (Bn, S, DL, DB, sr))
    _check_shape("S_init", S_init, (Bn, sl, DL, DB))
    _check_contiguous(Pyy=Pyy[:1], Phi=Phi, Ws=Ws, S_init=S_init)
    band = yy_off is not None
    if band and tv:
        raise ValueError("merge F scan: a banded merge (yy_off) takes one "
                         "shared band indicator, not a Pyy a step")
    variant, threads, smem = merge_f_geometry(DL, DB, Y, q, sr, sl,
                                              L1.dtype, _variant, tv, band)
    Ns = L1.new_empty((Bn, S, sl, Y, q, sr))
    Ms = L1.new_empty((Bn, S, sl, sr))
    if Bn == 0 or S == 0:
        return Ns, Ms
    args = (L1.data_ptr(), _strides(L1), B1.data_ptr(), _strides(B1),
            Pyy.data_ptr(), pyy_step, Phi.data_ptr(), Ws.data_ptr(),
            S_init.data_ptr(), Ns.data_ptr(), Ms.data_ptr(), Bn, S, DL, DB,
            Y, q, sr, sl)
    shape = (DL, DB, Y, q, sr, sl, L1.dtype, tv)
    if variant == "staged":
        rc = build.library(*_merge_f_target(variant, shape)).merge_f_staged(
            *args, smem, _stream(L1))
    elif variant == "cluster":
        lib = _cluster_library(merge_f_cluster_macros(*shape), smem)
        rc = lib.merge_f_cluster(*args, smem, _stream(L1))
    elif variant == "wide":
        lib = _wide_library(merge_wide_macros("f", *shape[:7], yy_off), smem)
        rc = lib.merge_f_wide(*args, smem, _stream(L1))
    elif variant == "streamed":
        blocks, per = merge_streamed_plan("f", DL, DB, Y, q, sr, sl, Bn,
                                          _sm_count(L1.device))
        work = L1.new_empty(blocks * per)
        rc = build.library("merge_streamed").merge_f_streamed(
            code, *args[:11], work.data_ptr(), *args[11:], blocks, smem,
            _stream(L1))
    else:
        rc = build.library("stta_scans").stta_merge_f(
            code, *args, threads, smem, _stream(L1))
    _raise_on(rc, "merge F scan")
    merge_fscan.launches += 1
    merge_fscan.variant_launches[variant] += 1
    if tv:
        merge_fscan.tv_launches[variant] += 1
    return Ns, Ms


def mpem3_wscan(B1, Psi, _variant=None):
    """Reverse MPEM3 scan; arguments and result as
    :func:`mpem3_wscan_plain`.  B1 may be a strided view.  On the card it
    launches the kernel :func:`mpem3_geometry` picks (``_variant`` forces
    one, for tests)."""
    if _on_cpu(B1, Psi):
        return mpem3_wscan_plain(B1, Psi)
    code = _dtype_code(B1, Psi)
    Bn, S, Db, _, qi, qj, _ = B1.shape
    sr = Psi.shape[1]
    _check_shape("B1", B1, (Bn, S, Db, Db, qi, qj, qi))
    _check_shape("Psi", Psi, (S, sr, sr, qi, qj))
    _check_contiguous(Psi=Psi)
    layout = mpem3_layout(B1, Psi)
    variant, threads, smem = mpem3_geometry(Db, qi, qj, sr, None, B1.dtype,
                                            layout, _variant)
    Ws = B1.new_empty((Bn, S, Db, qi, sr))
    if Bn == 0 or S == 0:
        return Ws
    if variant == "staged":
        lib = build.library("mpem3_staged", mpem3_staged_macros(
            Db, qi, qj, sr, None, B1.dtype, layout))
        rc = lib.mpem3_w_staged(B1.data_ptr(), _strides(B1), Psi.data_ptr(),
                                Ws.data_ptr(), Bn, S, Db, qi, qj, sr, smem,
                                _stream(B1))
    else:
        rc = build.library("stta_scans").stta_mpem3_w(
            code, B1.data_ptr(), _strides(B1), Psi.data_ptr(),
            Ws.data_ptr(), Bn, S, Db, qi, qj, sr, threads, smem,
            _stream(B1))
    _raise_on(rc, "MPEM3 W scan")
    mpem3_wscan.launches += 1
    mpem3_wscan.variant_launches[variant] += 1
    return Ws


def mpem3_fscan(B1, Phi, Ws, S_init, _variant=None):
    """Forward MPEM3 scan; arguments and results as
    :func:`mpem3_fscan_plain`.  On the card it launches the kernel
    :func:`mpem3_geometry` picks (``_variant`` forces one, for tests)."""
    if _on_cpu(B1, Phi, Ws, S_init):
        return mpem3_fscan_plain(B1, Phi, Ws, S_init)
    code = _dtype_code(B1, Phi, Ws, S_init)
    Bn, S, Db, _, qi, qj, _ = B1.shape
    sl, sr = Phi.shape[1], Ws.shape[-1]
    _check_shape("B1", B1, (Bn, S, Db, Db, qi, qj, qi))
    _check_shape("Phi", Phi, (S, sl, sl, qi, qj))
    _check_shape("Ws", Ws, (Bn, S, Db, qi, sr))
    _check_shape("S_init", S_init, (Bn, sl, Db, qi))
    _check_contiguous(Phi=Phi, Ws=Ws, S_init=S_init)
    layout = mpem3_layout(B1, Phi, Ws)
    variant, threads, smem = mpem3_geometry(Db, qi, qj, sr, sl, B1.dtype,
                                            layout, _variant)
    Ns = B1.new_empty((Bn, S, sl, qi, qj, sr))
    Ms = B1.new_empty((Bn, S, sl, sr))
    if Bn == 0 or S == 0:
        return Ns, Ms
    args = (B1.data_ptr(), _strides(B1), Phi.data_ptr(), Ws.data_ptr(),
            S_init.data_ptr(), Ns.data_ptr(), Ms.data_ptr(), Bn, S, Db, qi,
            qj, sr, sl)
    if variant == "staged":
        lib = build.library("mpem3_staged", mpem3_staged_macros(
            Db, qi, qj, sr, sl, B1.dtype, layout))
        rc = lib.mpem3_f_staged(*args, smem, _stream(B1))
    else:
        rc = build.library("stta_scans").stta_mpem3_f(
            code, *args, threads, smem, _stream(B1))
    _raise_on(rc, "MPEM3 F scan")
    mpem3_fscan.launches += 1
    mpem3_fscan.variant_launches[variant] += 1
    return Ns, Ms


for _w in (merge_wscan, merge_fscan, mpem3_wscan, mpem3_fscan):
    _w.launches = 0
#: merge F launches by kernel: "staged", "cluster", "base", "wide" and
#: "streamed" (see merge_f_geometry), and those of them that read a table a
#: step
merge_fscan.variant_launches = {"staged": 0, "cluster": 0, "base": 0,
                                "wide": 0, "streamed": 0}
merge_fscan.tv_launches = {"staged": 0, "cluster": 0, "base": 0, "wide": 0,
                           "streamed": 0}
#: merge W launches by kernel: "staged", "base", "wide" and "streamed" (see
#: merge_w_geometry)
merge_wscan.variant_launches = {"staged": 0, "base": 0, "wide": 0,
                                "streamed": 0}
#: MPEM3 W and F launches by kernel: "staged" and "base" (see
#: mpem3_geometry)
mpem3_wscan.variant_launches = {"staged": 0, "base": 0}
mpem3_fscan.variant_launches = {"staged": 0, "base": 0}


# ---------------------------------------------------------------------------
# entry points (same arguments as the JAX package's, with ``sketches`` in
# place of the PRNG key)
# ---------------------------------------------------------------------------

def merge_stta_fused(Lc, Llz, Bc, Blz, pyy, Dout: int, Y: int, q: int,
                     sketches=None, oversample: int = 4, yy_off=None):
    """Cavity merge through the scan kernels: Lc [B, T1, DL, DL, Y*q],
    Bc [B, T1, DB, DB, Y*q], pyy [T1, Y, Y, Y, q] (or [Y, Y, Y, q] shared)
    -> (cores [B, T1, Dout, Dout, Y*q], logz [B] = Llz + Blz - sum log
    scales).
    ``yy_off`` selects the banded merge: the kernels take its banded ``Th``
    and the band as a dense ``Pyy`` (``pyy`` is not read), and are told the
    band (the wide kernels read its entries alone)."""
    return merge_sketch(Lc, Llz, Bc, Blz, pyy, Dout, Y, q, sketches,
                        oversample, merge_wscan, merge_fscan, yy_off)


def mpem3_stta_fused(B3, logz, Dout: int, sketches=None,
                     oversample: int = 4):
    """MPEM3 -> MPEM2 through the scan kernels: B3 [B, T1, Db, Db, qi, qj,
    qi'] -> (cores [B, T1, Dout, Dout, qi*qj], logz unchanged)."""
    return mpem3_sketch(B3, logz, Dout, sketches, oversample, mpem3_wscan,
                        mpem3_fscan)


def mpem3_stta_fused_tm(B3f, logz, Db: int, qi: int, qj: int, Dout: int,
                        sketches=None, oversample: int = 4):
    """MPEM3 -> MPEM2 from the time-major flat layout B3f [T1, B,
    qi*qj*qi'*Db*Db], column order ``(i, j, r, m, n)``; the kernels read it
    through strides, without a transposed copy."""
    return mpem3_sketch(tm_to_7d(B3f, Db, qi, qj), logz, Dout, sketches,
                        oversample, mpem3_wscan, mpem3_fscan)
