#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (one ``nvcc`` per source,
all at once), holds each against its plain PyTorch version on the card,
drives the main paths (SIS on a random 3-regular graph, N=4096, T=15, f32:
``bp_sweep(method="sketch")`` and ``bp_sweep(method="randomized")`` at D=10
and D=20; the same at N=128 and D=20, one randomized sweep against its
plain version; a 4-node tree against enumeration, with
``iterate(polish=2)``; the karate-club graph, 10 sketch iterations and
one ``qr`` polish sweep; homogeneous Glauber dynamics on an Erdos-Renyi
graph, N=5000, T=15, D=10, through the banded merge, and at the
reference's D=18, where its K4, K8 and K9 buckets take the wide (cluster)
merge kernels; the streamed merge kernels, forced, against the plain scans
at the shapes no single-block merge kernel fits (f64 to D=20, f32 D=24,
q=3, the Glauber D=18 buckets), with one f64 D=20 sketch sweep on the wide
kernels; the wide and the streamed kernels timed in turns at the Glauber
D=18 buckets and the f64 D=20 merge; SIRS on the 3-regular graph at D=10
and D=20, through per-node tables; the bench state swept in chunks, Jacobi
and in place, against the monolithic sweep; the Glauber state by the
shuffled Gauss-Seidel ``iterate``; SIS inference on a tree of 4096
nodes with 256 soft observations, through every observable, the
soft-margin sampler and SMC; time-varying SIS on the bench graph (a
lockdown lowers lam at t=8; tables from ``build_tables_t``) at D=10 and
D=20, every merge F launch reading one ``prob_yy`` a step; periodic SIS on
a 3-regular graph of 1024 nodes, T=10, D=8, ``qr``, and at D=10 (f32 SVDs
above k=64) with cuSOLVER's default and ``gesvd`` drivers against the host
in f64; the modes' accuracy
gates (the infinite 3-regular graph's golden vector and the time-varying
tree against enumeration; periodic SIS on a path reported); the
scale target, SIS on an Erdos-Renyi graph of 10^5 nodes, T=50, D=10, swept
in place by ``bigsweep.bp_sweep_flat``; the stationary (T -> infinity)
mode in f64, SIS on the infinite 3-regular graph to its golden fixed point
and against long-horizon finite T, bipartite against regular, Glauber and
SIRS on a path on the card against the host; and the checkpoint API, the
D=10 bench state saved three times, restored bit for bit and swept; the
multi-rank layer, the D=10 bench state swept by halo exchange on one NCCL
rank and on two gloo ranks sharing the card, and SMC on the observed
inference tree split over the two ranks, each against one device; the
scale graph's host build by the C++ builder and by numpy; and the
roofline report), checks the results, and times each kernel beside its
bound.
Each path runs with the launch counts set to 0 just before it and read
just after.  One JSON line per phase; any failed phase raises.
The second-to-last line is the ``kernels`` record, the line before it the
card's name and power limit from ``nvidia-smi``, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
Imports torch and numpy only, and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, fp32
# FLOP/s outside the tensor cores, and fp64 FLOP/s on the tensor cores
# (DMMA; 34e12 outside them), the card's highest rate for that type
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 67e12

BENCH_N, BENCH_DEG, BENCH_T = 4096, 3, 15
# Glauber dynamics on Erdos-Renyi (examples/glauber_erdos_renyi.py's
# constants), at D=10 and at the reference's own D=18 (TruncBond(18),
# BASELINE.md:14), where the K4, K8 and K9 buckets' merges take the
# streamed kernels
GLAUBER_N, GLAUBER_C, GLAUBER_T, GLAUBER_D = 5000, 2.5, 15, 10
GLAUBER_J, GLAUBER_H, GLAUBER_BETA = 1.0, 0.1, 0.6
TIMED_SWEEPS_GLAUBER = 3
GLAUBER_D18, TIMED_SWEEPS_GLAUBER_D18 = 18, 2
# the Glauber D=18 buckets whose merges take the wide kernels, with their
# y-axis (K2, Y=3, keeps the cluster merge F and merge_w_kernel)
WIDE_BUCKETS = ("K4_Y5", "K8_Y9", "K9_Y10")
# the streamed merge kernels held to the plain scans: f64 sketch merges
# [1024, 15] at D = 16, 18, 20 and DL != DB (1e-10 of max-abs), f32 at the
# shapes past the shared-memory kernels (1e-4), and forced at two shapes
# that other kernels take, timed in turns beside them
REACH_BN = 1024
REACH_F64_DIMS = [(16, 16, 16), (18, 18, 18), (20, 20, 20), (20, 12, 20)]
# SIRS on the bench's 3-regular graph, tables from build_tables
SIRS_LAM, SIRS_RHO, SIRS_SIGMA = 0.2, 0.1, 0.05
TIMED_SWEEPS_SIRS = {10: 3, 20: 2}
TIMED_SWEEPS_D10, TIMED_SWEEPS_D20 = 3, 2
TIMED_RANDOMIZED_D10, TIMED_RANDOMIZED_D20 = 2, 1
# the D=20 randomized sweep held to its plain version (the plain Jacobi
# runs one matrix per launch at k=40, ~7 min at N=4096)
CHECK_N_D20 = 128
# karate: iterations and polish sweeps, cut from 20 and 2 to make room for
# the Glauber D=18 and merge-reach phases (both the iterate and the polish
# are host-bound: ~2 s and ~20 s a sweep on the card's host)
KARATE_ITERS, POLISH_SWEEPS = 10, 1
# chunked sweeps of the bench state: chunks of 1024 nodes (the K=3
# bucket's 4096 in four), and the in-place sweep on the same chunks
CHUNK_NODES = 1024
TOL_CHUNKED = 1e-5
# Gauss-Seidel on the Glauber state (iterate's shuffled schedule), and on
# SIS over the same graph, where both schedules converge: its sweeps, the
# most each last delta may be, and how far apart the two fixed points may
# be (f32 sketch sweeps settle to deltas of order 1e-3, not lower: their
# rounding moves each sweep that much)
GLAUBER_SEIDEL_CHUNK, GLAUBER_SEIDEL_SWEEPS = 2048, 3
SIS_SEIDEL_SWEEPS, TOL_SIS_SEIDEL_DELTA, TOL_SIS_SEIDEL_FIXED = 10, 1e-2, 5e-3
# the scale target: SIS on erdos_renyi_gnm(1e5, 1.5e5), T=50, D=10, f32,
# in place (scripts/scale_run.py:44-58); the node-slot budget of a chunk
# (tools/probe_scale.py); its isolated nodes' marginals to 1e-5 of exact
SCALE_N, SCALE_T, SCALE_D = 100_000, 50, 10
SCALE_LAM, SCALE_RHO, SCALE_PRIOR_I = 0.2, 0.1, 0.3
SCALE_CHUNK = 24576
TIMED_SWEEPS_SCALE = 2
TOL_ISOLATED = 1e-5
# SIS inference with observations on a tree (the bench's SIS): iterate,
# the sampler against BP, observe, iterate again, then every observable,
# the soft-margin sampler and SMC on the observed state
INFER_N, INFER_T, INFER_D = 4096, 15, 10
INFER_MAXITER, INFER_TOL = 60, 1e-4
INFER_SAMPLES, INFER_PARTICLES = 4096, 4096
INFER_NOBS, INFER_SOFTINF = 256, 10.0
TOL_MC_FLOOR = 8e-3         # the sampler's gate: 6 max(err, 8e-3)
TOL_SUMS = 1e-5             # pair, alternate and two-time marginals sum to 1
PAIR_PEAK_BYTES = 4e9       # pair_beliefs' peak (the D^2 cores: 21 GB)
TOL_LOGNORM_PLAIN = 1e-3    # belief_lognorms on the kernels vs plain scans
# time-varying SIS on the bench graph: lam drops from TV_LAM to
# TV_LAM_LOCKDOWN at t = TV_SWITCH (rho, the prior and the graph as the
# bench's); stacked constant tables (one spec a step) held to the constant
# tables' sweep on the same sketches
TV_LAM, TV_LAM_LOCKDOWN, TV_SWITCH = 0.2, 0.05, 8
TIMED_SWEEPS_TV = {10: 3, 20: 2}
TOL_TV_STACKED = 1e-6
# periodic SIS (qr) on random_regular_graph(PERIODIC_N, 3): timed sweeps;
# one sweep against the same sweep on the host with every SVD through
# torch.linalg.svd, and against the host's float64 sweep, at
# PERIODIC_CHECK_N nodes (the host's sweep takes ~15 s there)
PERIODIC_N, PERIODIC_T, PERIODIC_D = 1024, 10, 8
# f32 SVDs above k=64 (ROADMAP Queue 3 item 1): periodic SIS at D=10 (the
# Kronecker merge's bond 100), SVD_DRIVER_SWEEPS sweeps of
# SVD_DRIVER_N nodes on the card with cuSOLVER's default driver and with
# gesvd, each against the same sweeps on the host in f64
SVD_DRIVER_D, SVD_DRIVER_N, SVD_DRIVER_SWEEPS = 10, 64, 1
PERIODIC_CHECK_N = 256
TIMED_SWEEPS_PERIODIC = 2
TOL_PERIODIC_SUMS = 1e-5
# the modes' accuracy gates: the golden vector (rtol), periodic Glauber on
# the infinite 3-regular graph against periodic K4 (beliefs and pair
# beliefs, both iterates converged within INF_K4_MAXITER sweeps), periodic
# SIS on the observed 3-node path against periodic enumeration (D=16,
# TruncThresh(1e-12): exact there) and the time-varying tree against
# enumeration (qr in f64, the sketch in f32)
TOL_GOLDEN_RTOL = 2e-8
TOL_INF_K4, INF_K4_MAXITER = 1e-6, 150
TOL_PERIODIC_EXACT = 1e-10
TOL_TV_QR, TOL_TV_SKETCH = 1e-9, 1e-3
# the stationary (T -> infinity) mode, f64: SIS (lam, rho, alpha) on the
# infinite 3-regular graph; the golden fixed point of
# tests/test_stationary.py:108-129 (TruncVUMPS(12), tol 1e-14); the
# long-horizon comparison of :78-105 (TruncVUMPS(8, refine=4) against
# finite-T BP at T=96, D=8, read at t=48); bipartite (3, 3) against
# regular; Glauber and SIRS on the 3-node path on the card against the
# host
STAT_LAM, STAT_RHO, STAT_ALPHA = 0.1, 0.2, 0.05
STAT_GOLDEN_BS, TOL_STAT_GOLDEN, TOL_STAT_F = 0.5600047320179407, 1e-9, 1e-7
STAT_LONG_T, STAT_LONG_D = 96, 8
TOL_STAT_LONG, TOL_STAT_OVERLAP = 3e-4, 1e-5
TOL_STAT_BIPARTITE, TOL_STAT_HOST = 1e-10, 1e-8
# checkpoints of the sketch D=10 bench state after one sweep: three
# asynchronous saves kept two at a time, the latest restored
CKPT_SAVES, CKPT_KEEP = 3, 2
# the multi-rank layer: the sketch D=10 bench state swept by halo exchange
# on one NCCL rank, and on two gloo ranks sharing the card (NCCL refuses
# two ranks on one card), against bp_sweep from the same state; SMC over
# the two ranks on the observed inference tree against one device; the
# scale graph's host build, native against numpy; the roofline report
HALO_SWEEPS = 3
TOL_HALO_BELIEFS, TOL_HALO_F_REL = 1e-5, 1e-4
TOL_SMC_SHARDED_RTOL = 1e-6
NATIVE_N, NATIVE_M = 10 ** 5, 150_000
# one randomized sweep at the bench shape: 3 merge calls (one bucket, K=3,
# the direct all-pairs cavity), each with one CholQR per time step 0..T-1
# and one SVD per step of its truncating sweep; the message and belief
# conversions take 2 x T SVDs each
CHOLQR_PER_SWEEP = 3 * BENCH_T
SVD_PER_SWEEP = 3 * BENCH_T + 2 * 2 * BENCH_T

# tolerances: f64 kernels against f64 plain versions; f32 kernels against
# f32 plain versions relative to the plain output's max-abs (both round at
# ~6e-8 per op over sums of up to ~400 terms and 15 rescaled steps); the
# one-sweep belief gate at the bench shape; the BASELINE accuracy gate
TOL_F64 = 1e-10
TOL_F32_REL = 1e-4
TOL_SWEEP_BELIEFS = 1e-3
TOL_ORACLE = 1e-3
# CholQR and the Jacobi eigensolver compute in f64 on both sides: f32
# outputs differ by the rounding of one store (1e-5 of max-abs leaves room
# for the f64 sums' order amplified by the jitter's 1/sqrt(1e-6)); Q of a
# Gaussian f32 A is orthonormal to f32 rounding
TOL_F32_CHOLQR_REL = 1e-5
TOL_F32_ORTH = 1e-4

KARATE_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]


_START = time.perf_counter()


def emit(phase: str, **kv):
    """One JSON line: the phase's record and ``at_s``, the seconds since
    the script started (the differences of ``at_s`` are each phase's
    share of the time limit)."""
    print(json.dumps({"phase": phase, **kv,
                      "at_s": time.perf_counter() - _START}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# kernel shapes, inputs, and their work counts
# ---------------------------------------------------------------------------

def merge_dims(D, Y=2, q=2):
    sr = min(D, D * D)
    return dict(DL=D, DB=D, Y=Y, q=q, sr=sr, sl=min(sr + 4, D * D))


def mpem3_dims(D, qi=2, qj=2):
    sr = min(D, D * qi)
    return dict(Db=D, qi=qi, qj=qj, sr=sr, sl=min(sr + 4, D * qi))


def band_pairs(Y, off=0):
    """The (y, v) pairs of the sum-type band ``0 <= y + off - v < Y``: the
    entries of the band's dense Pyy that are not zero, for each x."""
    return sum(1 for y in range(Y) for v in range(Y) if 0 <= y + off - v < Y)


def banded_merge_inputs(Bn, S, DL, DB, Y, q, sr, sl, device, seed, off=0):
    """Random f32 merge-scan inputs with the banded merge's Th (``y_expand``
    of a Gaussian psi) and Pyy (the band indicator), as the sweep feeds a
    Glauber bucket's merges; L1/B1 are strided views."""
    import torch
    from matrixproductbp_tpu_torch.ops import sumy
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)  # noqa
    f32 = torch.float32
    L = r(Bn, S + 1, DL, DL, Y, q).to(device, f32)
    B = r(Bn, S + 1, DB, DB, Y, q).to(device, f32)
    Th = sumy.y_expand(r(S, sr, sr, Y, q).to(device, f32), off, axis=3,
                       mode="sum").contiguous()
    Pyy = sumy.band_indicator(Y, off, q, f32, device)
    Phi = r(S, sl, sl, Y, q).to(device, f32)
    S_init = r(Bn, sl, DL, DB).to(device, f32)
    return L[:, 1:], B[:, 1:], Th, Pyy, Phi, S_init


def merge_inputs(Bn, S, DL, DB, Y, q, sr, sl, dtype, device, seed):
    """Random merge-scan inputs, drawn on ``device`` (the bench shapes' f64
    draws take minutes on the host); L1/B1 are strided views as in the
    sweep."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64,  # noqa
                               device=device)
    L = r(Bn, S + 1, DL, DL, Y, q).to(device, dtype)
    B = r(Bn, S + 1, DB, DB, Y, q).to(device, dtype)
    Th = r(S, sr, sr, Y, Y, q).to(device, dtype)
    Pyy = torch.rand((Y, Y, Y, q), generator=g, dtype=torch.float64,
                     device=device).to(device, dtype)
    Phi = r(S, sl, sl, Y, q).to(device, dtype)
    S_init = r(Bn, sl, DL, DB).to(device, dtype)
    return L[:, 1:], B[:, 1:], Th, Pyy, Phi, S_init


def mpem3_layout_of(qj):
    """The B_t layout a sketch sweep hands each conversion: the message
    conversion (qj = q > 1) the time-major rows ``(i, j, r, m, n)``, the
    belief conversion (qj = 1) the contiguous ``(m, n, i, j, r)``."""
    return "ijrmn" if qj > 1 else "mnijr"


def mpem3_inputs(Bn, S, Db, qi, qj, sr, sl, dtype, device, seed):
    """Random MPEM3-scan inputs; B1 is the view the sweep hands over
    (:func:`mpem3_layout_of`): the permuted time-major one of the message
    path or the contiguous one of the belief path, without its first
    step.  Drawn on ``device``, as :func:`merge_inputs`'s."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64,  # noqa
                               device=device)
    if mpem3_layout_of(qj) == "ijrmn":
        B3f = r(S + 1, Bn, qi * qj * qi * Db * Db).to(device, dtype)
        B1 = B3f.reshape(S + 1, Bn, qi, qj, qi, Db, Db) \
            .permute(1, 0, 5, 6, 2, 3, 4)[:, 1:]
    else:
        B1 = r(Bn, S + 1, Db, Db, qi, qj, qi).to(device, dtype)[:, 1:]
    Psi = r(S, sr, sr, qi, qj).to(device, dtype)
    Phi = r(S, sl, sl, qi, qj).to(device, dtype)
    S_init = r(Bn, sl, Db, qi).to(device, dtype)
    return B1, Psi, Phi, S_init


def work_merge_w(Bn, S, DL, DB, Y, q, sr, sl, esize, band=None):
    """FLOPs and bytes of the merge W scan; ``band`` (the band's (u, v)
    pairs, :func:`band_pairs`) counts the banded Th's product by its pairs
    alone, not all Y * Y."""
    uv = Y * Y if band is None else band
    fma = q * (DB * DL * Y * sr * DB + DB * DL * sr * uv * sr
               + DL * DB * sr * DL * Y)
    nbytes = esize * (2 * Bn * S * DL * DL * Y * q + S * sr * sr * Y * Y * q
                      + Bn * S * DL * DB * sr)
    return 2 * fma * Bn * S, nbytes


def work_merge_f(Bn, S, DL, DB, Y, q, sr, sl, esize, band=None):
    """FLOPs and bytes of the merge F scan; with ``band`` (the band
    indicator's pairs) Bp is a relabelling of B_t (no operations) and t2
    sums over the band's pairs alone."""
    nS = sl * DL * DB
    yy = (Y * (DB * DB * Y * Y + nS * DB * Y) if band is None
          else nS * DB * band)
    per_step = (sl * sr * DL * DB + q * (nS * Y * DL + yy + Y * nS * sl))
    n_fma = q * Y * sl * sr * DL * DB                       # N, not at s=S-1
    flops = 2 * Bn * (S * per_step + (S - 1) * n_fma)
    nbytes = esize * (2 * Bn * S * DL * DL * Y * q + Y * Y * Y * q
                      + S * sl * sl * Y * q + Bn * S * DL * DB * sr
                      + Bn * nS + Bn * S * sl * Y * q * sr + Bn * S * sl * sr)
    return flops, nbytes


def work_mpem3_w(Bn, S, Db, qi, qj, sr, sl, esize):
    fma = Db * qi * qj * sr * Db * qi + Db * qi * sr * qj * sr
    nbytes = esize * (Bn * S * Db * Db * qi * qj * qi + S * sr * sr * qi * qj
                      + Bn * S * Db * qi * sr)
    return 2 * fma * Bn * S, nbytes


def work_mpem3_f(Bn, S, Db, qi, qj, sr, sl, esize):
    per_step = (sl * sr * Db * qi + sl * Db * qi * qj * qi * Db
                + sl * Db * qi * sl * qi * qj)
    n_fma = sl * qi * qj * sr * Db * qi
    flops = 2 * Bn * (S * per_step + (S - 1) * n_fma)
    nbytes = esize * (Bn * S * Db * Db * qi * qj * qi + S * sl * sl * qi * qj
                      + Bn * S * Db * qi * sr + Bn * sl * Db * qi
                      + Bn * S * sl * qi * qj * sr + Bn * S * sl * sr)
    return flops, nbytes


def work_cholqr(Bn, m, n, esize):
    """f64 FLOPs (lower-triangle Gram, Cholesky, forward substitution) and
    bytes (A in, Q and R out) of the CholQR kernel."""
    flops = Bn * (m * n * (n + 1) + n ** 3 // 3 + m * n * n)
    return flops, esize * Bn * (2 * m * n + n * n)


def work_eigh(Bn, k):
    """f64 FLOPs a symmetric eigendecomposition with eigenvectors needs,
    ~9 k^3 per matrix (tridiagonalisation and implicit QR, Golub & Van Loan
    8.3; the Jacobi kernel itself does ~6x more), and bytes (G in, w and V
    out)."""
    return 9 * k ** 3 * Bn, 8 * Bn * (2 * k * k + k)


def bound_ms(flops, nbytes, flop_rate=FP32_FLOP_PER_S):
    """Least time: FLOPs at peak (fp32 unless given) or bytes at HBM rate."""
    t_ops = flops / flop_rate
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def max_err(a, b):
    """(max-abs difference, max-abs of the reference) over tuples."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    ref = max(float(y.abs().max()) for y in b)
    return err, ref


def run_merge(fs, L1, B1, Th, Pyy, Phi, S_init, plain=False, variant=None):
    """Ws, Ns, Ms through the kernels (``variant`` forces the merge F
    kernel, and the merge W kernel where it is "streamed") or through the
    plain versions."""
    if plain:
        Ws = fs.merge_wscan_plain(L1, B1, Th)
        return (Ws,) + tuple(fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws,
                                                  S_init))
    Ws = fs.merge_wscan(L1, B1, Th,
                        _variant="streamed" if variant == "streamed" else None)
    return (Ws,) + tuple(fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S_init,
                                        _variant=variant))


def _fitting(geometry, shape, dtype, variants):
    out = []
    for v in variants:
        try:
            geometry(*shape, dtype, v)
        except ValueError:
            continue
        out.append(v)
    return tuple(out)


def merge_f_variants(dims, dtype):
    """The merge F kernels whose buffers fit this shape, the one
    ``merge_f_geometry`` picks first: staged, cluster, base and streamed
    where all four fit; cluster, base and streamed at D=20."""
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    shape = tuple(dims[k] for k in ("DL", "DB", "Y", "q", "sr", "sl"))
    return _fitting(fs.merge_f_geometry, shape, dtype,
                    ("staged", "cluster", "base", "streamed"))


def merge_w_variants(dims, dtype):
    """The merge W kernels whose buffers fit this shape: staged, base and
    streamed at every merge here (``merge_w_geometry`` picks staged in
    f32)."""
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    shape = tuple(dims[k] for k in ("DL", "DB", "Y", "q", "sr"))
    return _fitting(fs.merge_w_geometry, shape, dtype,
                    ("staged", "base", "streamed"))


def run_mpem3(fs, B1, Psi, Phi, S_init, plain=False, variant=None):
    """Ws, Ns, Ms through the kernels (``variant`` forces both) or through
    the plain versions."""
    if plain:
        Ws = fs.mpem3_wscan_plain(B1, Psi)
        return (Ws,) + tuple(fs.mpem3_fscan_plain(B1, Phi, Ws, S_init))
    Ws = fs.mpem3_wscan(B1, Psi, _variant=variant)
    return (Ws,) + tuple(fs.mpem3_fscan(B1, Phi, Ws, S_init,
                                        _variant=variant))


def mpem3_variants(dims, dtype):
    """The MPEM3 kernels that take this shape: staged and base in f32
    (``mpem3_geometry`` picks staged), base in f64."""
    import torch
    return ("staged", "base") if dtype == torch.float32 else ("base",)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def per_shape_builds():
    """The per-shape kernels' builds this script runs, one per (kernel,
    shape): the staged and the cluster merge F kernel and the staged merge
    W kernel at the D=10 sketch merge in f32 (the main path, the accuracy
    tree and karate take the staged ones), the cluster merge F and the
    staged merge W kernel at the D=20 one (the D=20 sweep), all three at
    phase_kernels' f64 merges, the staged CholQR kernel at the
    randomized merge's [4s, s], s = 2D, at D=10 and D=20 (the only shapes
    the randomized sweeps here launch), the staged MPEM3 W and F
    kernels at both conversions of the D=10 and D=20 sketch sweeps, at
    q = 2 and (SIRS) q = 3, and of the Glauber D=18 sweep, the merge F
    kernel ``merge_f_geometry`` picks for each bucket of the Glauber sweep
    (Y = 3, 5, 9, 10) and for the SIRS merges at D=10, and for the K2
    bucket (Y=3) of the Glauber D=18 sweep, the wide merge W and F kernels
    of its K4, K8 and K9 buckets (banded) and of the f64 D=20 sketch
    merge, and the time-varying sweeps' merge F builds (``MF_TV=1``:
    staged at D=10, cluster at D=20)."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    from matrixproductbp_tpu_torch.ops import kernels
    shapes = [(*merge_dims(10).values(), torch.float32),
              (*merge_dims(20).values(), torch.float32),
              (4, 3, 2, 2, 5, 9, torch.float64),
              (3, 3, 3, 2, 4, 8, torch.float64)]
    out = []
    for d in shapes:
        dims = dict(zip(("DL", "DB", "Y", "q", "sr", "sl"), d[:6]))
        out += [fs._merge_f_target(v, d) for v in merge_f_variants(dims, d[6])
                if v in fs._PER_SHAPE_MERGE_F]
        out.append(("merge_w_staged", fs.merge_w_staged_macros(*d[:5], d[6])))
    out += [("cholqr_staged", kernels.cholqr_staged_macros(m, n))
            for m, n in ((80, 20), (160, 40))]
    for D, qs in ((10, ((2, 2), (2, 1), (3, 3), (3, 1))),
                  (20, ((2, 2), (2, 1), (3, 3), (3, 1))),
                  (GLAUBER_D18, ((2, 2), (2, 1)))):
        for qi, qj in qs:
            d = mpem3_dims(D, qi=qi, qj=qj)
            out += [("mpem3_staged", fs.mpem3_staged_macros(
                d["Db"], qi, qj, d["sr"], sl, torch.float32,
                mpem3_layout_of(qj))) for sl in (None, d["sl"])]
    for Y, q in ((3, 2), (5, 2), (9, 2), (10, 2), (2, 3)):
        shape = (*merge_dims(GLAUBER_D, Y, q).values(), torch.float32)
        picked = fs.merge_f_geometry(*shape)[0]
        if picked in fs._PER_SHAPE_MERGE_F:
            out.append(fs._merge_f_target(picked, shape))
    # the D=18 Glauber bucket that keeps a per-shape kernel (K2, Y=3)
    shape = (*merge_dims(GLAUBER_D18, 3).values(), torch.float32)
    picked = fs.merge_f_geometry(*shape)[0]
    if picked in fs._PER_SHAPE_MERGE_F:
        out.append(fs._merge_f_target(picked, shape))
    # the wide kernels: the Glauber D=18 buckets' banded merges (yy_off 0)
    # and the f64 D=20 sketch merge
    for key in WIDE_BUCKETS:
        md = merge_dims(GLAUBER_D18, int(key.split("_Y")[1]))
        out += [("merge_wide", fs.merge_wide_macros(
            kind, *md.values(), torch.float32, 0)) for kind in ("w", "f")]
    out += [("merge_wide", fs.merge_wide_macros(
        kind, *merge_dims(20).values(), torch.float64)) for kind in ("w", "f")]
    for D in (10, 20):
        shape = (*merge_dims(D).values(), torch.float32, True)
        out.append(fs._merge_f_target(
            fs.merge_f_geometry(*shape[:7], None, True)[0], shape))
    return list(dict.fromkeys(out))


def phase_build():
    """Every source, and the staged and cluster merge F kernels, the staged
    merge W kernel, the staged CholQR kernel and the staged MPEM3 kernels
    at each shape the script runs, one nvcc each, all started together."""
    from matrixproductbp_tpu_torch.ops import build
    targets = list(build.SOURCES) + per_shape_builds()
    t0 = time.perf_counter()
    build.build_all(targets)
    seconds = time.perf_counter() - t0
    report = [ln.strip() for t in targets
              for ln in (build.build_log(t) if isinstance(t, str)
                         else build.build_log(*t)).splitlines()
              if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    for ln in report:
        print("ptxas:", ln, flush=True)
    emit("build", seconds=seconds, sources=list(build.SOURCES),
         per_shape=[f"{n}: {' '.join(m)}" for n, m in targets[len(
             build.SOURCES):]], lines=len(report))


def phase_kernels():
    """Each kernel against its plain version on the card: f64 at small
    shapes, f32 at the bench shapes for D=10 and D=20.  Each merge case
    runs every merge F kernel whose buffers fit its shape (all four at
    D=10 and the f64 shapes, the cluster, base and streamed kernels at
    D=20) and every merge W kernel, and names each.  Then the staged
    MPEM3 kernels at the SIS and SIRS sweeps' conversions and the merge
    kernels at the SIRS sweeps' merge, at D=10 and D=20, each on the
    kernel its geometry picks, launches checked."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dev = torch.device("cuda")
    results = []
    small = dict(DL=4, DB=3, Y=2, q=2, sr=5, sl=9)
    # S=1: the one-hot W_{T1} at the only step, nothing to prefetch
    f64_cases = [("merge", small, 4),
                 ("merge", dict(DL=3, DB=3, Y=3, q=2, sr=4, sl=8), 4),
                 ("merge", small, 1),
                 ("mpem3", dict(Db=4, qi=2, qj=2, sr=5, sl=8), 4),
                 ("mpem3", dict(Db=3, qi=2, qj=1, sr=4, sl=6), 4)]
    f32_cases = []
    for D in (10, 20):
        f32_cases += [("merge", merge_dims(D), BENCH_T),
                      ("mpem3", mpem3_dims(D), BENCH_T),
                      ("mpem3", mpem3_dims(D, qj=1), BENCH_T)]
    for dtype, cases, Bn in ((torch.float64, f64_cases, 7),
                             (torch.float32, f32_cases, 256)):
        for i, (kind, dims, S) in enumerate(cases):
            if kind == "merge":
                args = merge_inputs(Bn, S, **dims, dtype=dtype, device=dev,
                                    seed=i)
                ref = run_merge(fs, *args, plain=True)
                outs = [({"merge_f_kernel": v}, run_merge(fs, *args,
                                                          variant=v), ref)
                        for v in merge_f_variants(dims, dtype)]
                outs += [({"merge_w_kernel": v}, fs.merge_wscan(
                    *args[:3], _variant=v), ref[0])
                         for v in merge_w_variants(dims, dtype)]
            else:
                args = mpem3_inputs(Bn, S, **dims, dtype=dtype, device=dev,
                                    seed=i)
                ref = run_mpem3(fs, *args, plain=True)
                outs = [({"mpem3_kernel": v}, run_mpem3(fs, *args,
                                                        variant=v), ref)
                        for v in mpem3_variants(dims, dtype)]
            torch.cuda.synchronize()
            for variant, out, want in outs:
                err, scale = max_err(out, want)
                if dtype == torch.float64:
                    tol = TOL_F64 * max(1.0, scale)
                else:
                    tol = TOL_F32_REL * scale
                results.append({"kind": kind, "dtype": str(dtype)[6:],
                                **dims, "B": Bn, "S": S, "max_abs_err": err,
                                "ref_max_abs": scale, "tol": tol, **variant})
                check(err <= tol, f"{kind} kernels disagree with their "
                                  f"plain versions: {results[-1]}")
    results += mpem3_bench_vs_plain(dev) + sirs_merges_vs_plain(dev)
    results += cholqr_vs_plain(dev) + eigh_vs_plain(dev)
    emit("kernels_vs_plain", cases=results)


def mpem3_bench_vs_plain(dev):
    """The staged MPEM3 W and F kernels at the sketch sweeps' shapes, D=10
    and D=20, for SIS (q = 2) and SIRS (q = 3): the message conversion
    [12288, 15, D, D, q, q, q] in its time-major view and the belief
    conversion [4096, 15, D, D, q, 1, q] contiguous, each against the
    plain scans at Ws, Ns and Ms, 1e-4 of the plain output's max-abs; the
    launches counted on the staged kernels."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    rows = []
    for D in (10, 20):
        for Bn, qi, qj in ((BENCH_N * BENCH_DEG, 2, 2), (BENCH_N, 2, 1),
                           (BENCH_N * BENCH_DEG, 3, 3), (BENCH_N, 3, 1)):
            dims = mpem3_dims(D, qi=qi, qj=qj)
            args = mpem3_inputs(Bn, BENCH_T, **dims, dtype=torch.float32,
                                device=dev, seed=20 + D + qj + 10 * (qi - 2))
            check(fs.mpem3_layout(*args[:3]) == mpem3_layout_of(qj),
                  f"MPEM3 inputs not in the sweep's layout: {dims}")
            before = (dict(fs.mpem3_wscan.variant_launches),
                      dict(fs.mpem3_fscan.variant_launches))
            out = run_mpem3(fs, *args)
            after = (fs.mpem3_wscan.variant_launches,
                     fs.mpem3_fscan.variant_launches)
            ref = run_mpem3(fs, *args, plain=True)
            torch.cuda.synchronize()
            err, scale = max_err(out, ref)
            rows.append({"kind": "mpem3", "dtype": "float32", **dims,
                         "B": Bn, "S": BENCH_T,
                         "layout": mpem3_layout_of(qj),
                         "mpem3_kernel": "staged", "max_abs_err": err,
                         "ref_max_abs": scale, "tol": TOL_F32_REL * scale})
            check(all(a["staged"] == b["staged"] + 1 and a["base"] == b["base"]
                      for a, b in zip(after, before)),
                  f"MPEM3 at the sweep's shape not on the staged kernels: "
                  f"{rows[-1]}")
            check(err <= TOL_F32_REL * scale,
                  f"staged MPEM3 kernels disagree with the plain scans: "
                  f"{rows[-1]}")
            del args, out, ref
    return rows


def merge_vs_plain(args, dims, what, dtype=None, variant=None):
    """Ws, Ns and Ms of the merge kernels ``merge_*_geometry`` picks for
    ``dims`` (or ``variant`` for both) against the plain scans on
    ``args``: f32 (the default) within 1e-4 of the plain output's max-abs,
    f64 within 1e-10 of it; one launch counted on each picked kernel and
    none on the others.  Returns the row."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dtype = dtype or torch.float32
    tol_rel = TOL_F32_REL if dtype == torch.float32 else TOL_F64
    shape = tuple(dims[k] for k in ("DL", "DB", "Y", "q", "sr", "sl"))
    picks = (variant or fs.merge_w_geometry(*shape[:5], dtype)[0],
             variant or fs.merge_f_geometry(*shape, dtype)[0])
    counters = (fs.merge_wscan.variant_launches,
                fs.merge_fscan.variant_launches)
    before = [dict(c) for c in counters]
    out = run_merge(fs, *args, variant=variant)
    seen = [{v: n - b[v] for v, n in c.items()}
            for c, b in zip(counters, before)]
    ref = run_merge(fs, *args, plain=True)
    torch.cuda.synchronize()
    err, scale = max_err(out, ref)
    row = {"kind": "merge", "what": what, "dtype": str(dtype)[6:], **dims,
           "B": args[0].shape[0], "S": args[0].shape[1],
           "merge_w_kernel": picks[0], "merge_f_kernel": picks[1],
           "max_abs_err": err, "ref_max_abs": scale,
           "tol": tol_rel * scale}
    check(all(n == (v == p) for d, p in zip(seen, picks)
              for v, n in d.items()),
          f"{what}: merge launches {seen}, want one on each of {picks}")
    check(err <= tol_rel * scale,
          f"{what}: merge kernels disagree with the plain scans: {row}")
    return row


def sirs_merges_vs_plain(dev):
    """The merge kernels at the SIRS sweeps' merge shape (q = 3, Y = 2,
    [8192, 15], the shared dense Pyy), D=10 (staged merge F and W) and
    D=20 (the first designs), against the plain scans."""
    import torch
    rows = []
    for D in (10, 20):
        dims = merge_dims(D, Y=2, q=3)
        args = merge_inputs(2 * BENCH_N, BENCH_T, **dims,
                            dtype=torch.float32, device=dev, seed=50 + D)
        rows.append(merge_vs_plain(args, dims, f"sirs_rrg_d{D} merge"))
        del args
    return rows


def cholqr_variants(shape, dtype):
    """The CholQR kernels whose buffers fit this shape: staged and base at
    the f32 sketch shapes (``cholqr_geometry`` picks staged), base in
    f64."""
    from matrixproductbp_tpu_torch.ops import kernels
    return _fitting(kernels.cholqr_geometry, shape, dtype, ("staged", "base"))


def cholqr_vs_plain(dev):
    """The CholQR kernels against their plain version: f64 at small shapes
    (``cholqr_kernel``), f32 at the D=10 and D=20 sketch shapes ([s*Y*q, s]
    = [80, 20], [160, 40]) and the bench batch through both kernels, every
    third instance rank 1 (the sweeps' early steps); Q finite, and on the
    Gaussian instances Q^T Q against I and Q R against A."""
    import torch
    from matrixproductbp_tpu_torch.ops import kernels
    from matrixproductbp_tpu_torch.ops.smallalg import cholqr_unrolled
    g = torch.Generator(device="cpu").manual_seed(5)
    rows = []
    for dtype, shape in ((torch.float64, (7, 24, 8)),
                         (torch.float64, (5, 80, 20)),
                         (torch.float32, (2 * BENCH_N, 80, 20)),
                         (torch.float32, (2 * BENCH_N, 160, 40))):
        A = torch.randn(shape, generator=g, dtype=torch.float64)
        A[::3] = A[::3, :, :1] * A[::3, :1, :]
        A = A.to(dev, dtype)
        Qp, Rp = cholqr_unrolled(A)
        gauss = torch.arange(shape[0], device=dev) % 3 != 0
        for variant in cholqr_variants(shape[1:], dtype):
            Q, R = kernels.cholqr(A, _variant=variant)
            torch.cuda.synchronize()
            err, scale = max_err((Q, R), (Qp, Rp))
            n = shape[-1]
            Qd = Q[gauss].double()
            orth = float((Qd.transpose(1, 2) @ Qd - torch.eye(
                n, dtype=torch.float64, device=dev)).abs().max())
            recon = float((Qd @ R[gauss].double() - A[gauss].double())
                          .abs().max() / A[gauss].abs().max())
            f64 = dtype == torch.float64
            tol = (TOL_F64 * max(1.0, scale) if f64
                   else TOL_F32_CHOLQR_REL * scale)
            rows.append({"kind": "cholqr", "cholqr_kernel": variant,
                         "dtype": str(dtype)[6:], "shape": list(shape),
                         "rank1_every": 3, "max_abs_err": err,
                         "ref_max_abs": scale, "tol": tol, "orth_err": orth,
                         "recon_rel_err": recon,
                         "finite": bool(torch.isfinite(Q).all())})
            check(err <= tol, f"CholQR kernel vs plain: {rows[-1]}")
            check(rows[-1]["finite"], f"CholQR Q not finite: {rows[-1]}")
            check(orth <= (1e-8 if f64 else TOL_F32_ORTH),
                  f"CholQR Q not orthonormal: {rows[-1]}")
            check(recon <= (1e-12 if f64 else 1e-5),
                  f"CholQR Q R != A: {rows[-1]}")
    return rows


def gram_inputs(Bn, k, dev, seed):
    """f64 Gram matrices of Gaussian [2k, k] matrices, half of them with
    the last k/2 columns zero (rank-deficient, as at the sweeps' early time
    steps)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.randn((Bn, 2 * k, k), generator=g, dtype=torch.float64)
    X[: Bn // 2, :, k // 2:] = 0.0
    return (X.transpose(1, 2) @ X).to(dev)


def eigh_vs_plain(dev):
    """Jacobi eigen kernel against torch.linalg.eigh (f64): eigenvalues,
    the reconstruction V diag(w) V^T and V's orthonormality.  k = 20 and
    40 (D=10 and D=20) at the message conversion's batch; torch.linalg.eigh
    runs one matrix per launch at k = 40 (~6 s for this batch).  k = 33
    (two warps per matrix, dummy index) in a batch of 13, which leaves the
    last block of matrices ragged."""
    import torch
    from matrixproductbp_tpu_torch.ops import smallsvd
    rows = []
    for k, Bn in ((5, 7), (20, BENCH_N * BENCH_DEG),
                  (40, BENCH_N * BENCH_DEG), (64, 16), (33, 13)):
        G = gram_inputs(Bn, k, dev, k)
        w, V = smallsvd.eigh_desc(G)
        wp, _ = smallsvd.eigh_desc_plain(G)
        torch.cuda.synchronize()
        scale = float(G.abs().max())
        err = float((w - wp).abs().max())
        recon = float(((V * w[..., None, :]) @ V.transpose(1, 2) - G)
                      .abs().max())
        orth = float((V.transpose(1, 2) @ V - torch.eye(
            k, dtype=torch.float64, device=dev)).abs().max())
        rows.append({"kind": "jacobi_eigh", "dtype": "float64", "k": k,
                     "B": Bn, "max_abs_err": err, "ref_max_abs": scale,
                     "recon_err": recon, "orth_err": orth,
                     "tol": TOL_F64 * scale})
        check(max(err, recon) <= TOL_F64 * scale and orth <= TOL_F64,
              f"Jacobi eigen kernel vs plain: {rows[-1]}")
    return rows


@contextlib.contextmanager
def plain_scans():
    """Route the sweep's scans through their plain versions (on the card)."""
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    names = ("merge_wscan", "merge_fscan", "mpem3_wscan", "mpem3_fscan")
    saved = {n: getattr(fs, n) for n in names}
    try:
        for n in names:
            setattr(fs, n, getattr(fs, n + "_plain"))
        yield
    finally:
        for n, f in saved.items():
            setattr(fs, n, f)


@contextlib.contextmanager
def plain_linalg():
    """Route CholQR and the Jacobi eigensolver through their plain versions
    (on the card)."""
    from matrixproductbp_tpu_torch.ops import kernels, smallsvd
    from matrixproductbp_tpu_torch.ops.smallalg import cholqr_unrolled
    saved = kernels.batched_cholqr, smallsvd.eigh_desc
    try:
        kernels.batched_cholqr = (
            lambda A, eps, _variant=None: cholqr_unrolled(A, eps))
        smallsvd.eigh_desc = smallsvd.eigh_desc_plain
        yield
    finally:
        kernels.batched_cholqr, smallsvd.eigh_desc = saved


def _wrappers():
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    from matrixproductbp_tpu_torch.ops import kernels, smallsvd
    return {"merge_w": fs.merge_wscan, "merge_f": fs.merge_fscan,
            "mpem3_w": fs.mpem3_wscan, "mpem3_f": fs.mpem3_fscan,
            "cholqr": kernels.batched_cholqr,
            "jacobi_eigh": smallsvd.eigh_desc}


def reset_counts():
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    for w in _wrappers().values():
        w.launches = 0
    for c in (fs.merge_fscan.variant_launches, fs.merge_fscan.tv_launches,
              fs.merge_wscan.variant_launches):
        c.update(dict.fromkeys(c, 0))
    fs.mpem3_wscan.variant_launches.update(staged=0, base=0)
    fs.mpem3_fscan.variant_launches.update(staged=0, base=0)
    from matrixproductbp_tpu_torch.ops import kernels
    kernels.batched_cholqr.variant_launches.update(staged=0, base=0)


def read_counts():
    """Launches by kernel: the merge wrappers count their kernels apart,
    ``merge_f`` (``merge_f_kernel``), ``merge_f_staged``,
    ``merge_f_cluster``, ``merge_f_wide`` and ``merge_f_streamed``;
    ``merge_w`` (``merge_w_kernel``), ``merge_w_staged``, ``merge_w_wide``
    and ``merge_w_streamed``; the
    MPEM3 and CholQR wrappers likewise,
    ``mpem3_w`` (``mpem3_w_kernel``) and ``mpem3_w_staged``, ``mpem3_f``
    and ``mpem3_f_staged``, ``cholqr`` (``cholqr_kernel``) and
    ``cholqr_staged``."""
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    from matrixproductbp_tpu_torch.ops import kernels
    counts = {name: w.launches for name, w in _wrappers().items()}
    by_f = fs.merge_fscan.variant_launches
    by_w = fs.merge_wscan.variant_launches
    by_q = kernels.batched_cholqr.variant_launches
    check(sum(by_q.values()) == counts["cholqr"],
          f"CholQR launches {counts['cholqr']} != {by_q}")
    check(sum(by_f.values()) == counts["merge_f"],
          f"merge F launches {counts['merge_f']} != {by_f}")
    check(sum(by_w.values()) == counts["merge_w"],
          f"merge W launches {counts['merge_w']} != {by_w}")
    by_mw = fs.mpem3_wscan.variant_launches
    by_mf = fs.mpem3_fscan.variant_launches
    check(sum(by_mw.values()) == counts["mpem3_w"],
          f"MPEM3 W launches {counts['mpem3_w']} != {by_mw}")
    check(sum(by_mf.values()) == counts["mpem3_f"],
          f"MPEM3 F launches {counts['mpem3_f']} != {by_mf}")
    counts.update(merge_f=by_f["base"], merge_f_staged=by_f["staged"],
                  merge_f_cluster=by_f["cluster"], merge_f_wide=by_f["wide"],
                  merge_f_streamed=by_f["streamed"], merge_w=by_w["base"],
                  merge_w_staged=by_w["staged"], merge_w_wide=by_w["wide"],
                  merge_w_streamed=by_w["streamed"], mpem3_w=by_mw["base"],
                  mpem3_w_staged=by_mw["staged"], mpem3_f=by_mf["base"],
                  mpem3_f_staged=by_mf["staged"], cholqr=by_q["base"],
                  cholqr_staged=by_q["staged"])
    return counts


#: MPEM3 launches a sketch sweep (the message and the belief conversion),
#: all on the staged kernels
MPEM3_WANTS = {"mpem3_w": 0, "mpem3_w_staged": 2, "mpem3_f": 0,
               "mpem3_f_staged": 2}
#: the SIS sweeps at D=10 and D=20 launch no wide or streamed merge kernel
NO_STREAMED = {"merge_w_streamed": 0, "merge_f_streamed": 0,
               "merge_w_wide": 0, "merge_f_wide": 0}


def merge_w_wants(D):
    """Merge W launches a sketch sweep at bond D: 3 on the kernel
    ``merge_w_geometry`` picks for its merges, 0 on the other."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    md = merge_dims(D)
    picked = fs.merge_w_geometry(*list(md.values())[:5], torch.float32)[0]
    return {"merge_w": 3 * (picked == "base"),
            "merge_w_staged": 3 * (picked == "staged")}


def phase_accuracy():
    """4-node tree, T=3, D=10, f32: 10 sketch sweeps on the card, beliefs
    against the enumeration oracle; the f32 plain version on the CPU gives
    the error the algorithm itself leaves at f32.  On the card's sketch
    state, the pair, alternate and two-time observables against
    enumeration and the pair-route free energy (``qr`` and ``sketch``
    normalizations) against -log Z; SMC on an observed tree against
    enumeration (``tests/test_smc.py:30-39``'s gate)."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import exact
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    g = tp.graph_from_edges(4, [(0, 1), (0, 2), (2, 3)])
    sis = SIS(g, lam=0.2, rho=0.1, T=3, gamma=0.3)
    ref = mpbp_sis(sis, D=10, device="cpu")
    p_ex, Z = exact.exact_prob(ref)
    b_ex = exact.exact_marginals(ref, p_ex)
    errs, states = {}, {}
    legs = (("cuda", "sketch", 0), ("cpu", "sketch", 0),
            ("cuda", "sketch", POLISH_SWEEPS), ("cuda", "randomized", 0))
    for dev, method, polish in legs:
        bp = mpbp_sis(sis, D=10, dtype=torch.float32, device=dev)
        bp, _, _ = tp.iterate(bp, maxiter=10, trunc=tp.TruncBond(10),
                              tol=0.0, method=method, polish=polish)
        errs[(dev, method, polish)] = float(np.abs(
            tp.beliefs(bp).double().cpu().numpy() - b_ex).max())
        states[(dev, method, polish)] = bp
    plain = errs[("cpu", "sketch", 0)]
    tol = TOL_ORACLE if plain <= TOL_ORACLE else 2 * plain
    bp = states[("cuda", "sketch", 0)]

    def host(t):
        return t.double().cpu().numpy()

    obs = {
        "pair": float(np.abs(host(tp.pair_beliefs(bp)[0])
                             - exact.exact_pair_marginals(ref, p_ex)).max()),
        "alternate": float(np.abs(host(tp.alternate_marginals(bp))
                                  - exact.exact_alternate_marginals(
                                      ref, p_ex)).max()),
        "autocorrelations": float(np.abs(
            host(tp.autocorrelations(bp))
            - exact.exact_autocorrelations(ref, p=p_ex)).max()),
        "free_energy_pair_qr": abs(
            -float(tp.bethe_free_energy_pair(bp)) - np.log(Z)),
        "free_energy_pair_sketch": abs(-float(tp.bethe_free_energy_pair(
            bp, trunc=tp.TruncBond(10), method="sketch")) - np.log(Z))}
    smc_err = accuracy_smc()
    emit("accuracy", belief_err_card_f32=errs[("cuda", "sketch", 0)],
         belief_err_cpu_plain_f32=plain,
         belief_err_card_f32_sketch_polish2=errs[
             ("cuda", "sketch", POLISH_SWEEPS)],
         belief_err_card_f32_randomized=errs[("cuda", "randomized", 0)],
         tol=tol, tol_polish_randomized=TOL_ORACLE,
         observables_err_card_f32=obs, tol_observables=TOL_ORACLE,
         smc_vs_exact=smc_err)
    check(errs[("cuda", "sketch", 0)] <= tol, f"beliefs off the oracle: "
                                               f"{errs}")
    check(errs[("cuda", "sketch", POLISH_SWEEPS)] <= TOL_ORACLE
          and errs[("cuda", "randomized", 0)] <= TOL_ORACLE,
          f"polished or randomized beliefs off the oracle: {errs}")
    check(max(obs.values()) <= TOL_ORACLE,
          f"observables off the oracle: {obs}")
    check(smc_err["marginals"] < 0.03 and smc_err["log_evidence"] < 0.06,
          f"SMC off the oracle: {smc_err}")


def accuracy_smc():
    """SMC with 16,384 particles on the card for the observed 4-node tree
    of ``tests/test_smc.py`` (T=3, five soft observations): its marginals'
    and log-evidence's distance from enumeration."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import exact, sampling, smc
    from matrixproductbp_tpu_torch.models import SISFactorSpec
    g = tp.graph_from_edges(4, [(0, 1), (1, 2), (1, 3)])
    tables = tp.build_tables(g, [SISFactorSpec(lam=0.3, rho=0.25)] * g.N)
    phi = np.ones((g.N, 4, 2))
    phi[:, 0] = [0.6, 0.4]
    gen = torch.Generator(device="cuda")
    bp = tp.mpbp(g, tables, T=3, D=8, phi=phi, device="cuda")
    bp, _, _ = sampling.draw_node_observations(
        bp, 5, np.random.default_rng(3), softinf=20.0,
        generator=gen.manual_seed(9))
    p, Z = exact.exact_prob(bp)
    sms = smc.smc_sample(bp, 16384, generator=gen.manual_seed(0))
    m, _ = sampling.marginals_mc(sms)
    return {"marginals": float(np.abs(m.cpu().numpy()
                                      - exact.exact_marginals(bp, p)).max()),
            "log_evidence": abs(sms.log_evidence - np.log(Z))}


def bench_state(D, dtype, N=BENCH_N):
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    g = tp.random_regular_graph(N, BENCH_DEG, np.random.default_rng(0))
    sis = SIS(g, lam=0.2, rho=0.1, T=BENCH_T, gamma=0.3)
    return mpbp_sis(sis, D=D, dtype=dtype, device="cuda")


def timed_main_path(D, sweeps, method="sketch"):
    """Warm-up sweep, then ``sweeps`` timed sweeps with the launch counts
    set to 0 just before and read just after."""
    import torch
    import matrixproductbp_tpu_torch as tp
    bp0 = bench_state(D, torch.float32)
    trunc = tp.TruncBond(D)
    bp1 = tp.bp_sweep(bp0, trunc, method=method)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cur = bp1
    for _ in range(sweeps):
        cur = tp.bp_sweep(cur, trunc, method=method)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / sweeps
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    b = tp.beliefs(cur)
    check(bool(torch.isfinite(b).all()), f"D={D}: beliefs not finite")
    check(bool(torch.isfinite(cur.f).all()), f"D={D}: f not finite")
    E = bp0.graph.E
    return bp0, bp1, {"method": method, "D": D, "N": bp0.N, "E": E,
                      "T": BENCH_T, "sweeps": sweeps, "s_per_sweep": dt,
                      "edge_updates_per_s": E / dt, "peak_bytes": peak,
                      "launches": counts}


def phase_main_d10():
    import torch
    import matrixproductbp_tpu_torch as tp
    bp0, bp1, res = timed_main_path(10, TIMED_SWEEPS_D10)
    want = {**merge_w_wants(10), "merge_f": 0, "merge_f_staged": 3,
            "merge_f_cluster": 0, **NO_STREAMED, **MPEM3_WANTS, "cholqr": 0,
            "cholqr_staged": 0, "jacobi_eigh": 0}
    per_sweep = {k: v / TIMED_SWEEPS_D10 for k, v in res["launches"].items()}
    check(per_sweep == want, f"launches per sweep {per_sweep}, want {want}")
    with plain_scans():
        bp1p = tp.bp_sweep(bp0, tp.TruncBond(10), method="sketch")
    torch.cuda.synchronize()
    diff = float((tp.beliefs(bp1) - tp.beliefs(bp1p)).abs().max())
    res.update(launches_per_sweep=per_sweep,
               one_sweep_belief_diff_vs_plain=diff, tol=TOL_SWEEP_BELIEFS)
    emit("main_d10", **res)
    check(diff <= TOL_SWEEP_BELIEFS, f"kernel sweep vs plain sweep: {diff}")
    return res["launches"], bp1


def phase_profile(bp, method="sketch", label=None):
    """One sweep of the state ``bp`` (the bench state at D=10, or D=20 for
    the sketch path; the Glauber and SIRS states, named by ``label``) under
    torch.profiler: device time by kernel name and the device's busy share
    of the (profiled) wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import matrixproductbp_tpu_torch as tp
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tp.bp_sweep(bp, tp.TruncBond(bp.D), method=method)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernel entries only: the CPU-side operator entries carry
    # their kernels' time too, and summing both counts it twice
    rows = sorted(((e.self_device_time_total, e.count, e.key[:90])
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6

    def named(*parts):
        hit = [(us, c) for us, c, k in rows if any(p in k for p in parts)]
        return sum(us for us, _ in hit) / 1e6, sum(c for _, c in hit)

    ours_s, _ = named("merge_w_kernel<", "merge_w_staged_kernel(",
                      "merge_f_kernel<",
                      "merge_f_staged_kernel(", "merge_f_cluster_kernel(",
                      "mpem3_w_kernel<", "mpem3_f_kernel<",
                      "mpem3_w_staged_kernel(", "mpem3_f_staged_kernel(",
                      "cholqr_kernel<",
                      "cholqr_staged_kernel(", "jacobi_eigh_kernel")
    svd_s, svd_n = named("jacobi_eigh_kernel", "gesvd", "syevj", "syevd")
    qr_s, qr_n = named("cholqr_kernel<", "cholqr_staged_kernel(", "geqrf",
                       "orgqr", "ormqr", "householder")
    emit(label or f"profile_{method}_d{bp.D}", wall_s=wall,
         device_busy_s=busy,
         busy_share=busy / wall, hand_kernels_s=ours_s,
         svd_launches=svd_n, svd_device_s=svd_s, qr_launches=qr_n,
         qr_device_s=qr_s, kernels_named=len(rows),
         top=[{"name": k, "device_ms": us / 1e3, "count": c}
              for us, c, k in rows[:16]])


def phase_main_d20():
    """The D=20 sketch sweep: all 3 merge F launches a sweep take the
    cluster kernel (the staged kernel's buffers do not fit), all 3 merge W
    launches the kernel merge_w_geometry picks."""
    _, bp1, res = timed_main_path(20, TIMED_SWEEPS_D20)
    per_sweep = {k: v / TIMED_SWEEPS_D20 for k, v in res["launches"].items()}
    want = {**merge_w_wants(20), "merge_f": 0, "merge_f_staged": 0,
            "merge_f_cluster": 3, **NO_STREAMED, **MPEM3_WANTS, "cholqr": 0,
            "cholqr_staged": 0, "jacobi_eigh": 0}
    res.update(launches_per_sweep=per_sweep)
    emit("main_d20", **res)
    check(per_sweep == want, f"D=20: launches per sweep {per_sweep}, want "
                             f"{want}")
    return res["launches"], bp1


def phase_main_randomized(D, sweeps):
    """The randomized path at the bench shape: exact CholQR and SVD launch
    counts per sweep (every CholQR on the staged kernel), finite beliefs;
    at D=10 also one sweep through the kernels against the same sweep
    through their plain versions."""
    import torch
    import matrixproductbp_tpu_torch as tp
    bp0, bp1, res = timed_main_path(D, sweeps, method="randomized")
    per_sweep = {k: v / sweeps for k, v in res["launches"].items()}
    want = {"merge_w": 0, "merge_w_staged": 0, "merge_f": 0,
            "merge_f_staged": 0, "merge_f_cluster": 0, **NO_STREAMED,
            "mpem3_w": 0, "mpem3_w_staged": 0, "mpem3_f": 0,
            "mpem3_f_staged": 0, "cholqr": 0,
            "cholqr_staged": CHOLQR_PER_SWEEP,
            "jacobi_eigh": SVD_PER_SWEEP}
    res.update(launches_per_sweep=per_sweep)
    if D == 10:
        with plain_linalg():
            bp1p = tp.bp_sweep(bp0, tp.TruncBond(D), method="randomized")
        torch.cuda.synchronize()
        res.update(one_sweep_belief_diff_vs_plain=float(
            (tp.beliefs(bp1) - tp.beliefs(bp1p)).abs().max()),
            tol=TOL_SWEEP_BELIEFS)
    emit(f"main_randomized_d{D}", **res)
    check(per_sweep == want, f"randomized D={D}: launches per sweep "
                             f"{per_sweep}, want {want}")
    if D == 10:
        check(res["one_sweep_belief_diff_vs_plain"] <= TOL_SWEEP_BELIEFS,
              f"randomized kernel sweep vs plain sweep: {res}")
    return res["launches"], bp1


def phase_randomized_vs_plain_d20():
    """One randomized D=20 sweep of SIS on ``random_regular_graph(128, 3)``
    (T=15, f32) through the kernels against the same sweep through the
    plain CholQR and Jacobi (``plain_linalg``), beliefs within
    ``TOL_SWEEP_BELIEFS``; its launches: 45 on the staged CholQR kernel,
    105 Jacobi batches."""
    import torch
    import matrixproductbp_tpu_torch as tp
    bp0 = bench_state(20, torch.float32, N=CHECK_N_D20)
    trunc = tp.TruncBond(20)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bp1 = tp.bp_sweep(bp0, trunc, method="randomized")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    with plain_linalg():
        bp1p = tp.bp_sweep(bp0, trunc, method="randomized")
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    b, bpl = tp.beliefs(bp1), tp.beliefs(bp1p)
    diff = float((b - bpl).abs().max())
    want = {"cholqr": 0, "cholqr_staged": CHOLQR_PER_SWEEP,
            "jacobi_eigh": SVD_PER_SWEEP}
    emit("randomized_vs_plain_d20", N=CHECK_N_D20, D=20, T=BENCH_T,
         seconds=seconds, plain_seconds=plain_seconds,
         one_sweep_belief_diff_vs_plain=diff, tol=TOL_SWEEP_BELIEFS,
         launches={k: counts[k] for k in want})
    check(bool(torch.isfinite(b).all()), "randomized D=20 check: beliefs "
                                         "not finite")
    check({k: counts[k] for k in want} == want,
          f"randomized D=20 check: launches {counts}, want {want}")
    check(diff <= TOL_SWEEP_BELIEFS,
          f"randomized D=20 kernel sweep vs plain sweep: {diff}")


def phase_karate():
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    g = tp.graph_from_edges(34, KARATE_EDGES)
    sis = SIS(g, lam=0.2, rho=0.1, T=50, gamma=0.1)
    bp = mpbp_sis(sis, D=10, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp, n, deltas = tp.iterate(bp, maxiter=KARATE_ITERS,
                               trunc=tp.TruncBond(10), tol=0.0,
                               method="sketch")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    b = tp.beliefs(bp)
    check(bool(torch.isfinite(b).all()), "karate: beliefs not finite")
    t0 = time.perf_counter()
    bpp, _, _ = tp.iterate(bp, maxiter=0, trunc=tp.TruncBond(10),
                           method="sketch", polish=POLISH_SWEEPS)
    torch.cuda.synchronize()
    dt_polish = time.perf_counter() - t0
    bp_ = tp.beliefs(bpp)
    check(bool(torch.isfinite(bp_).all()), "karate polish: beliefs not "
                                           "finite")
    emit("karate", N=34, T=50, D=10, iters=n, seconds=dt,
         last_delta=deltas[-1], polish_sweeps=POLISH_SWEEPS,
         polish_seconds=dt_polish,
         polish_belief_change=float((bp_ - b).abs().max()),
         buckets=[int(k) for _, k in tp.bp._degree_buckets(g)])


_PLAIN_SCANS = ("merge_wscan_plain", "merge_fscan_plain",
                "mpem3_wscan_plain", "mpem3_fscan_plain")


@contextlib.contextmanager
def count_plain_scans():
    """Count the calls of the four plain scans (in ``fused_stta`` and
    ``stta``, the modules that call them) while the block runs: a sweep on
    the card must make none."""
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    from matrixproductbp_tpu_torch.ops import stta
    calls = dict.fromkeys(_PLAIN_SCANS, 0)
    saved = [(m, n, getattr(m, n)) for m in (fs, stta) for n in _PLAIN_SCANS]

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    try:
        for m, n, fn in saved:
            setattr(m, n, counted(n, fn))
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def count_by_bucket(target="_update_nodes"):
    """Launches by kernel and by degree bucket while the block runs:
    {"K<slots>_Y<y-axis>": {"updates": groups (of chunks) updated,
    "nodes": ..., kernel: launches}}, read around each call of the sweep's
    per-group update (``bp._update_nodes``) or of ``target``, another
    per-group function of ``bp`` with the same leading arguments."""
    from matrixproductbp_tpu_torch import bp as tbp
    update = getattr(tbp, target)
    rec = {}

    def counted(sw, idx, Kb, Yb, *a, **k):
        before = read_counts()
        out = update(sw, idx, Kb, Yb, *a, **k)
        after = read_counts()
        r = rec.setdefault(f"K{Kb}_Y{Yb}", {"updates": 0, "nodes": 0})
        r["updates"] += 1
        r["nodes"] += len(idx)
        for name, n in after.items():
            if n != before[name]:
                r[name] = r.get(name, 0) + n - before[name]
        return out
    try:
        setattr(tbp, target, counted)
        yield rec
    finally:
        setattr(tbp, target, update)


def merges_per_update(Kb):
    """Merge calls one bucket update makes: none at one slot, the full fold
    at two, the direct all-pairs cavity's three at three, and above that
    K-1 prefix, K-2 suffix and K-2 interior merges."""
    return {1: 0, 2: 1, 3: 3}.get(Kb, 3 * Kb - 5)


def bucket_wants(Kb, Yb, q, D, updates, band=False):
    """The launches a bucket's ``updates`` group updates must make: its
    merges on the merge W and F kernels the geometry picks for (Y, q, D;
    ``band``: the banded merge of ``yy_off`` tables), and both conversions
    on the staged MPEM3 kernels."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    shape = (*merge_dims(D, Yb, q).values(), torch.float32)
    w = fs.merge_w_geometry(*shape[:5], shape[6], band=band)[0]
    f = fs.merge_f_geometry(*shape, band=band)[0]
    m = merges_per_update(Kb) * updates
    want = {"mpem3_w_staged": 2 * updates, "mpem3_f_staged": 2 * updates}
    if m:
        want.update({"merge_w" + ("" if w == "base" else "_" + w): m,
                     "merge_f" + ("" if f == "base" else "_" + f): m})
    return want


def timed_model_sweeps(bp0, sweeps, check_plain=True):
    """Warm-up sweep, then ``sweeps`` timed sketch sweeps of ``bp0`` (at its
    bond) with the launch counts set to 0 just before and read just after,
    by kernel and by bucket, and the plain scans' calls counted (none
    allowed); then one sweep from ``bp0`` through the plain scans held to
    the warm-up sweep."""
    import torch
    import matrixproductbp_tpu_torch as tp
    torch.cuda.empty_cache()       # the cached blocks of earlier phases
    trunc = tp.TruncBond(bp0.D)
    bp1 = tp.bp_sweep(bp0, trunc, method="sketch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_plain_scans() as plain, count_by_bucket() as buckets:
        t0 = time.perf_counter()
        cur = bp1
        for _ in range(sweeps):
            cur = tp.bp_sweep(cur, trunc, method="sketch")
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / sweeps
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    b = tp.beliefs(cur)
    check(bool(torch.isfinite(b).all()) and bool(torch.isfinite(cur.f).all()),
          "beliefs or f not finite")
    E = bp0.graph.E
    res = {"N": bp0.N, "E": E, "T": bp0.T, "D": bp0.D, "q": bp0.q,
           "sweeps": sweeps, "s_per_sweep": dt, "edge_updates_per_s": E / dt,
           "peak_bytes": peak, "launches": counts, "by_bucket": buckets,
           "plain_scan_calls": plain}
    if check_plain:
        t0 = time.perf_counter()
        with plain_scans():
            bp1p = tp.bp_sweep(bp0, trunc, method="sketch")
        torch.cuda.synchronize()
        res.update(plain_sweep_s=time.perf_counter() - t0,
                   one_sweep_belief_diff_vs_plain=float(
                       (tp.beliefs(bp1) - tp.beliefs(bp1p)).abs().max()),
                   tol=TOL_SWEEP_BELIEFS)
    return cur, res


def check_buckets(res, q, what):
    """Every bucket's launches are the ones :func:`bucket_wants` names, no
    plain scan ran, and the totals add up."""
    check(not any(res["plain_scan_calls"].values()),
          f"{what}: plain scans ran on the card: {res['plain_scan_calls']}")
    total = {}
    for key, got in res["by_bucket"].items():
        Kb, Yb = (int(v[1:]) for v in key.split("_"))
        want = bucket_wants(Kb, Yb, q, res["D"], got["updates"],
                            res.get("yy_off") is not None)
        seen = {k: v for k, v in got.items() if k not in ("updates", "nodes")}
        check(seen == want, f"{what}: bucket {key} launched {seen}, want "
                            f"{want}")
        for k, v in seen.items():
            total[k] = total.get(k, 0) + v
    check(total == {k: v for k, v in res["launches"].items() if v},
          f"{what}: bucket launches {total} != {res['launches']}")


def glauber_state(N=GLAUBER_N, D=GLAUBER_D, dtype=None):
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import Glauber, Ising, mpbp_glauber
    g = tp.erdos_renyi_graph(N, GLAUBER_C, np.random.default_rng(0))
    ising = Ising(g, np.full(g.E // 2, GLAUBER_J), np.full(N, GLAUBER_H),
                  GLAUBER_BETA)
    return mpbp_glauber(Glauber(ising, GLAUBER_T), D=D,
                        dtype=dtype or torch.float32, device="cuda")


def isolated_spin_err(bp):
    """Max-abs difference between the isolated nodes' beliefs and their
    exact marginals: a lone spin flips by the field alone, P(+1) =
    1 / (1 + exp(-2 beta h)) at every step after the uniform start."""
    import matrixproductbp_tpu_torch as tp
    iso = np.nonzero(bp.graph.degree == 0)[0]
    b = tp.beliefs(bp).double().cpu().numpy()[iso]
    up = 1.0 / (1.0 + np.exp(-2.0 * GLAUBER_BETA * GLAUBER_H))
    want = np.tile([up, 1.0 - up], (bp.T + 1, 1))
    want[0] = 0.5
    return len(iso), float(np.abs(b - want[None]).max())


def phase_glauber_er():
    """Homogeneous Glauber on ``erdos_renyi_graph(5000, 2.5)``, T=15, D=10,
    f32, sketch: the banded merge in every bucket (K = 1, 2, 4, 8, 9 slots,
    Y = 2, 3, 5, 9, 10).  Timed sweeps; launches by kernel and by bucket,
    every merge and conversion on a hand kernel and no plain scan; one
    sweep held to the same sweep through the plain scans; the isolated
    spins' beliefs held to their exact marginals; the banded merge scans
    at the K = 2, 4, 8 and 9 buckets' shapes (Y = 3, 5, 9, 10) held to the
    plain scans, each on the kernels the geometry picks (its own per-shape
    build where it has one)."""
    bp0 = glauber_state()
    cur, res = timed_model_sweeps(bp0, TIMED_SWEEPS_GLAUBER)
    phase_profile(cur, label="profile_glauber_er")
    n_iso, iso_err = isolated_spin_err(cur)
    res.update(isolated_nodes=n_iso, isolated_belief_err=iso_err,
               tol_isolated=TOL_ISOLATED, yy_off=bp0.tables.yy_off)
    emit("glauber_er", **res)
    check_buckets(res, 2, "glauber_er")
    check(res["one_sweep_belief_diff_vs_plain"] <= TOL_SWEEP_BELIEFS,
          f"glauber_er: kernel sweep vs plain sweep: {res}")
    check(iso_err <= TOL_ISOLATED,
          f"glauber_er: isolated spins off: {iso_err}")
    scans = []
    for key in ("K2_Y3", "K4_Y5", "K8_Y9", "K9_Y10"):
        Y = int(key.split("_Y")[1])
        md = merge_dims(GLAUBER_D, Y)
        Bn = res["by_bucket"][key]["nodes"] // res["by_bucket"][key]["updates"]
        args = banded_merge_inputs(Bn, GLAUBER_T, **md, device="cuda",
                                   seed=30 + Y)
        scans.append({"bucket": key, **merge_vs_plain(
            args, md, f"glauber_er bucket {key} banded merge")})
        del args
    emit("glauber_er_banded_scans_vs_plain", cases=scans)
    return res


def phase_glauber_er_d18():
    """The reference's own Glauber run (``BASELINE.md:14``): homogeneous
    Glauber on ``erdos_renyi_graph(5000, 2.5)``, T=15, at D=18, f32,
    sketch.  Warm-up, then 2 timed sweeps; launches by kernel and by
    bucket, every merge and conversion on a hand kernel and no plain scan:
    the K4, K8 and K9 buckets' merges (Y = 5, 9, 10) on the wide kernels
    (none on the streamed ones), the K2 bucket's (Y=3) on the cluster
    merge F kernel and ``merge_w_kernel``; one sweep held to the same
    sweep through the plain scans; the isolated spins held to their exact
    marginals; s/sweep and peak memory."""
    bp0 = glauber_state(D=GLAUBER_D18)
    cur, res = timed_model_sweeps(bp0, TIMED_SWEEPS_GLAUBER_D18)
    n_iso, iso_err = isolated_spin_err(cur)
    del cur
    res.update(isolated_nodes=n_iso, isolated_belief_err=iso_err,
               tol_isolated=TOL_ISOLATED, yy_off=bp0.tables.yy_off)
    emit("glauber_er_d18", **res)
    check_buckets(res, 2, "glauber_er_d18")
    by = res["by_bucket"]
    for key in WIDE_BUCKETS:
        check(by[key].get("merge_w_wide", 0) > 0
              and by[key].get("merge_f_wide", 0) > 0
              and not by[key].get("merge_w_streamed")
              and not by[key].get("merge_f_streamed"),
              f"glauber_er_d18: bucket {key} not on the wide kernels: "
              f"{by[key]}")
    check(by["K2_Y3"].get("merge_f_cluster", 0) > 0
          and by["K2_Y3"].get("merge_w", 0) > 0,
          f"glauber_er_d18: bucket K2_Y3 left its kernels: {by['K2_Y3']}")
    check(res["one_sweep_belief_diff_vs_plain"] <= TOL_SWEEP_BELIEFS,
          f"glauber_er_d18: kernel sweep vs plain sweep: {res}")
    check(iso_err <= TOL_ISOLATED,
          f"glauber_er_d18: isolated spins off: {iso_err}")
    return res


def _bucket_batch(res, key):
    """(Y, merge batch) of a bucket of a model sweep's record."""
    bk = res["by_bucket"][key]
    return int(key.split("_Y")[1]), bk["nodes"] // bk["updates"]


def phase_merge_reach_vs_plain(res18, reps=3):
    """The streamed merge kernels, forced, against the plain scans at the
    shapes no single-block merge kernel fits (one launch counted on each;
    the wide kernels take them unforced): f64 sketch merges [1024, 15] at
    D = 16, 18, 20 and DL=20, DB=12, within 1e-10 of the plain outputs'
    max-abs; f32 within 1e-4 at the Glauber D=18 sweep's K4 and K8
    buckets (banded, Y = 5 and 9, their merge batch) and at D=24, Y=2, q
    = 2 and 3.  Forced onto the streamed kernels at the D=10 bench merge
    (Y=2, [8192, 15]) and the Glauber K8 bucket at D=10 (Y=9), and timed
    in turns beside the kernels those shapes take (picked, streamed,
    streamed, picked).  Then one f64 sketch sweep at D=20 (SIS on
    ``random_regular_graph(512, 3)``, its merge batch 1024): 3 merge W
    and 3 merge F launches on the wide kernels, no plain scan, beliefs
    within 1e-3 of the same sweep through the plain scans.  Returns the
    f64 sweep's launches."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    cases = []
    for i, (DL, DB, sr) in enumerate(REACH_F64_DIMS):
        dims = dict(DL=DL, DB=DB, Y=2, q=2, sr=sr, sl=sr + 4)
        args = merge_inputs(REACH_BN, BENCH_T, **dims, dtype=f64, device=dev,
                            seed=60 + i)
        cases.append(merge_vs_plain(args, dims, f"f64 {DL}x{DB}", f64,
                                    variant="streamed"))
        del args
    for key in ("K4_Y5", "K8_Y9"):
        Y, Bn = _bucket_batch(res18, key)
        md = merge_dims(GLAUBER_D18, Y)
        args = banded_merge_inputs(Bn, GLAUBER_T, **md, device=dev,
                                   seed=70 + Y)
        cases.append({"bucket": key, **merge_vs_plain(
            args, md, f"glauber_er_d18 bucket {key} banded merge",
            variant="streamed")})
        del args
    for q in (2, 3):
        md = merge_dims(24, 2, q)
        args = merge_inputs(REACH_BN, BENCH_T, **md, dtype=f32, device=dev,
                            seed=80 + q)
        cases.append(merge_vs_plain(args, md, f"f32 D=24 q={q}",
                                    variant="streamed"))
        del args
    for c in cases:
        check(c["merge_w_kernel"] == c["merge_f_kernel"] == "streamed",
              f"merge_reach_vs_plain: {c['what']} took no streamed kernel")
    emit("merge_reach_vs_plain", cases=cases)
    turns = []
    _, Bn8 = _bucket_batch(res18, "K8_Y9")
    for what, md, args in (
            ("bench D=10", merge_dims(10),
             merge_inputs(2 * BENCH_N, BENCH_T, **merge_dims(10), dtype=f32,
                          device=dev, seed=90)),
            ("glauber K8 D=10", merge_dims(GLAUBER_D, 9),
             banded_merge_inputs(Bn8, GLAUBER_T, **merge_dims(GLAUBER_D, 9),
                                 device=dev, seed=91))):
        row = merge_vs_plain(args, md, f"{what}, forced streamed",
                             variant="streamed")
        shape = tuple(md.values())
        L1, B1, Th, Pyy, Phi, S0 = args
        Ws = fs.merge_wscan(L1, B1, Th)
        picks = (fs.merge_w_geometry(*shape[:5], f32)[0],
                 fs.merge_f_geometry(*shape, f32)[0])
        tw = in_turns({v: (lambda v=v: fs.merge_wscan(L1, B1, Th,
                                                      _variant=v))
                       for v in (picks[0], "streamed")}, reps)
        tf = in_turns({v: (lambda v=v: fs.merge_fscan(
            L1, B1, Pyy, Phi, Ws, S0, _variant=v))
            for v in (picks[1], "streamed")}, reps)
        turns.append({**row, "picked": picks, "merge_w_ms_turns": tw,
                      "merge_f_ms_turns": tf})
        del args, L1, B1, Th, Pyy, Phi, S0, Ws
    emit("merge_reach_forced_streamed", cases=turns)
    bp0 = bench_state(20, f64, N=REACH_BN // 2)
    trunc = tp.TruncBond(20)
    bp1 = tp.bp_sweep(bp0, trunc, method="sketch")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with count_plain_scans() as plain:
        bp2 = tp.bp_sweep(bp1, trunc, method="sketch")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    with plain_scans():
        bp2p = tp.bp_sweep(bp1, trunc, method="sketch")
    torch.cuda.synchronize()
    diff = float((tp.beliefs(bp2) - tp.beliefs(bp2p)).abs().max())
    emit("sis_f64_d20_sweep", N=bp0.N, D=20, dtype="float64", seconds=dt,
         launches=counts, plain_scan_calls=plain,
         one_sweep_belief_diff_vs_plain=diff, tol=TOL_SWEEP_BELIEFS)
    check(counts["merge_w_wide"] == 3 and counts["merge_f_wide"] == 3
          and counts["merge_w_streamed"] == counts["merge_f_streamed"] == 0
          and not any(plain.values()),
          f"f64 D=20 sweep: launches {counts}, plain scans {plain}")
    check(diff <= TOL_SWEEP_BELIEFS, f"f64 D=20 sweep vs plain: {diff}")
    return counts


def streamed_kernel_times(res18, f64_launches, reps=3):
    """The wide and the streamed merge W and F kernels, timed in turns on
    the same inputs (wide, streamed, streamed, wide; CUDA events over
    ``reps`` launches each), at the Glauber D=18 sweep's K4, K8 and K9
    buckets (banded, their merge batch; the bound counts the band's pairs,
    which the wide kernels read alone and the streamed ones dense) and at
    the f64 D=20 sketch merge [1024, 15] (the bound at the fp64 rate),
    beside the plain version's time; each kernel's outputs held to the
    plain scans'.  Launches from the Glauber D=18 sweeps and from the f64
    sweep (the main paths launch the wide kernels, no streamed one).
    Returns a row for each kernel, kind and shape."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dev = torch.device("cuda")
    shapes = []
    for key in WIDE_BUCKETS:
        Y, Bn = _bucket_batch(res18, key)
        md = merge_dims(GLAUBER_D18, Y)
        bk = res18["by_bucket"][key]
        shapes.append((f"_glauber_y{Y}_d18", md, 4, band_pairs(Y),
                       lambda Bn=Bn, md=md, Y=Y: banded_merge_inputs(
                           Bn, GLAUBER_T, **md, device=dev, seed=40 + Y),
                       lambda v, bk=bk: bk.get(v, 0), {"yy_off": 0},
                       FP32_FLOP_PER_S, TOL_F32_REL, Bn,
                       f"glauber_er_d18, bucket {key}"))
    md = merge_dims(20)
    shapes.append(("_f64_d20", md, 8, None,
                   lambda: merge_inputs(REACH_BN, BENCH_T, **md,
                                        dtype=torch.float64, device=dev,
                                        seed=62),
                   lambda v: f64_launches[v], {}, FP64_FLOP_PER_S, TOL_F64,
                   REACH_BN, "sis_f64_d20_sweep"))
    rows = []
    for suffix, md, esize, band, inputs, launched, yy, rate, tol, Bn, src \
            in shapes:
        L1, B1, Th, Pyy, Phi, S0 = inputs()
        Ws = fs.merge_wscan(L1, B1, Th, **yy)
        cases = [
            ("w", lambda v: fs.merge_wscan(L1, B1, Th, _variant=v, **yy),
             lambda: fs.merge_wscan_plain(L1, B1, Th),
             work_merge_w(Bn, GLAUBER_T, **md, esize=esize, band=band)),
            ("f", lambda v: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0,
                                           _variant=v, **yy),
             lambda: fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S0),
             work_merge_f(Bn, GLAUBER_T, **md, esize=esize, band=band))]
        for kind, kern, plain, (flops, nbytes) in cases:
            ref = plain()
            errs = {}
            for v in ("wide", "streamed"):
                out = kern(v)
                torch.cuda.synchronize()
                err, scale = max_err(tuple(out) if kind == "f" else out,
                                     tuple(ref) if kind == "f" else ref)
                check(err <= tol * scale,
                      f"{v} merge {kind}{suffix} disagrees with its plain "
                      f"version: {err} > {tol} * {scale}")
                errs[v] = err
                del out
            turns = in_turns({v: (lambda v=v: kern(v))
                              for v in ("wide", "streamed")}, reps)
            plain_ms = time_cuda(plain, 1)
            bms, by = bound_ms(flops, nbytes, rate)
            dense = (work_merge_w if kind == "w" else work_merge_f)(
                Bn, GLAUBER_T, **md, esize=esize)[0]
            for v in ("wide", "streamed"):
                name, srcfile, line = (MERGE_W_ROWS if kind == "w"
                                       else MERGE_F_ROWS)[v]
                rows.append({
                    "name": name + suffix, "route": "cuda",
                    "source": "matrixproductbp_tpu_torch/csrc/" + srcfile,
                    "replaces": "matrixproductbp_tpu/ops/fused_stta.py"
                                + line,
                    "launches": launched(f"merge_{kind}_{v}"),
                    "max_abs_err": errs[v], "ms": sum(turns[v]) / 2,
                    "ms_turns": turns[v], "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "flops": flops, "dense_flops": dense, "bytes": nbytes,
                    "dtype": "float32" if esize == 4 else "float64",
                    "D": md["DL"], "Y": md["Y"], "B": Bn, "band_pairs": band,
                    "launches_from": src})
                emit("kernel_time_" + v, **rows[-1])
            del ref
        del L1, B1, Th, Pyy, Phi, S0, Ws
    return rows


def sirs_state(D):
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIRS, mpbp_sirs
    g = tp.random_regular_graph(BENCH_N, BENCH_DEG, np.random.default_rng(0))
    sirs = SIRS(g, SIRS_LAM, SIRS_RHO, SIRS_SIGMA, T=BENCH_T, gamma=0.3)
    return mpbp_sirs(sirs, D=D, dtype=torch.float32, device="cuda")


def phase_sirs_rrg(D):
    """SIRS (q=3) on the bench graph, T=15, f32, sketch, tables from
    build_tables (per-node dense Pyy: one group, the whole bucket): timed
    sweeps, launches by kernel and bucket, no plain scan, one sweep held to
    its plain version."""
    bp0 = sirs_state(D)
    cur, res = timed_model_sweeps(bp0, TIMED_SWEEPS_SIRS[D])
    res.update(per_node_pyy=tuple(bp0.tables.Pyy.shape))
    del bp0
    phase_profile(cur, label=f"profile_sirs_rrg_d{D}")
    emit(f"sirs_rrg_d{D}", **res)
    check_buckets(res, 3, f"sirs_rrg D={D}")
    check(all(r["updates"] == TIMED_SWEEPS_SIRS[D]
              for r in res["by_bucket"].values()),
          f"sirs_rrg D={D}: not one Pyy group a bucket: {res['by_bucket']}")
    check(res["one_sweep_belief_diff_vs_plain"] <= TOL_SWEEP_BELIEFS,
          f"sirs_rrg D={D}: kernel sweep vs plain sweep: {res}")
    return res


def msg_marginals(cores, logz, q):
    """The messages' time marginals [E, T1, q*q]: what they represent."""
    from matrixproductbp_tpu_torch.ops import tensortrain as tt
    return tt.marginals(tt.TensorTrain(cores, logz, (q, q)))


def phase_chunked_vs_monolithic():
    """One sketch sweep of the bench state (D=10) three ways: ``bp_sweep``;
    ``bp_sweep_chunked(chunk=1024)`` (Jacobi: the K=3 bucket's 4096 nodes
    in four chunks), its launches counted; and ``bigsweep.bp_sweep_flat(
    jacobi=True, belief_cores=True, chunk=3072)`` (the same 1024-node
    chunks).  Chunked against monolithic: beliefs and the messages'
    marginals within ``TOL_CHUNKED`` (the cores' difference printed);
    flat against chunked bit for bit."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import bigsweep
    torch.cuda.empty_cache()
    bp0 = bench_state(10, torch.float32)
    trunc = tp.TruncBond(10)
    mono = tp.bp_sweep(bp0, trunc, method="sketch")
    torch.cuda.synchronize()
    reset_counts()
    chunked = tp.bp_sweep_chunked(bp0, trunc, method="sketch",
                                  chunk=CHUNK_NODES)
    torch.cuda.synchronize()
    counts = read_counts()
    fs = bigsweep.flat_init(bp0.graph, bp0.tables, BENCH_T, 10,
                            dtype=torch.float32, belief_cores=True)
    fs = bigsweep.bp_sweep_flat(bp0.graph, bp0.tables, fs, trunc, BENCH_T,
                                10, phi=bp0.phi, chunk=3 * CHUNK_NODES,
                                jacobi=True)
    torch.cuda.synchronize()
    chunks = -(-BENCH_N // CHUNK_NODES)
    want = {**{k: 0 for k in counts}, "merge_w_staged": 3 * chunks,
            "merge_f_staged": 3 * chunks, "mpem3_w_staged": 2 * chunks,
            "mpem3_f_staged": 2 * chunks}
    diffs = {
        "beliefs": float((tp.beliefs(chunked) - tp.beliefs(mono))
                         .abs().max()),
        "msg_marginals": float((msg_marginals(chunked.msg_cores,
                                              chunked.msg_logz, 2)
                                - msg_marginals(mono.msg_cores,
                                                mono.msg_logz, 2))
                               .abs().max()),
        "msg_cores": float((chunked.msg_cores - mono.msg_cores).abs().max())}
    names = ("msg_cores", "msg_logz", "bel_cores", "bel_logz", "f")
    flat_equal = {n: bool(torch.equal(getattr(fs, n), getattr(chunked, n)))
                  for n in names}
    emit("chunked_vs_monolithic", N=BENCH_N, T=BENCH_T, D=10,
         chunk=CHUNK_NODES, chunks=chunks, chunked_vs_monolithic=diffs,
         tol=TOL_CHUNKED, flat_vs_chunked_bit_equal=flat_equal,
         flat_vs_chunked_beliefs=float((fs.marg - tp.beliefs(chunked))
                                       .abs().max()),
         launches=counts)
    check(counts == want, f"chunked sweep: launches {counts}, want {want}")
    check(max(diffs["beliefs"], diffs["msg_marginals"]) <= TOL_CHUNKED,
          f"chunked sweep off the monolithic one: {diffs}")
    check(all(flat_equal.values()),
          f"flat Jacobi sweep not bit-equal to the chunked: {flat_equal}")


def seidel_sweep(bp0, plain=False):
    """One shuffled Gauss-Seidel sweep of ``bp0`` in chunks of
    ``GLAUBER_SEIDEL_CHUNK``, permuted by ``default_rng(0)``: on the
    kernels, or through the plain scans."""
    import matrixproductbp_tpu_torch as tp
    with plain_scans() if plain else contextlib.nullcontext():
        return tp.bp_sweep_chunked(
            bp0, tp.TruncBond(bp0.D), method="sketch",
            chunk=GLAUBER_SEIDEL_CHUNK, schedule="seidel",
            rng=np.random.default_rng(0))


def seidel_sweep_errors(state):
    """One shuffled sweep (:func:`seidel_sweep`) of ``state(dtype)`` on the
    f32 kernels, through the f32 plain scans and through the f64 plain
    scans (the f64 merge kernels do not hold Glauber's Y=9 bucket at D=10):
    the f32 kernels' belief range, the max-abs distance of both f32
    sweeps' beliefs from the f64 sweep's and from each other, and the
    tolerance for the kernels' distance, ``TOL_SWEEP_BELIEFS`` or twice
    the plain sweep's (the accuracy phase's rule)."""
    import torch
    import matrixproductbp_tpu_torch as tp
    bp0 = state(torch.float32)
    b = {"kernels": tp.beliefs(seidel_sweep(bp0)),
         "plain": tp.beliefs(seidel_sweep(bp0, plain=True))}
    del bp0
    ref = tp.beliefs(seidel_sweep(state(torch.float64), plain=True))
    torch.cuda.synchronize()
    out = {"kernels_vs_f64": float((b["kernels"].double() - ref)
                                   .abs().max()),
           "plain_vs_f64": float((b["plain"].double() - ref).abs().max()),
           "kernels_vs_plain": float((b["kernels"] - b["plain"])
                                     .abs().max()),
           "range": [float(b["kernels"].min()), float(b["kernels"].max())]}
    out["tol"] = max(TOL_SWEEP_BELIEFS, 2 * out["plain_vs_f64"])
    return out


def check_seidel_sweep(one, what):
    check(-1e-5 <= one["range"][0] and one["range"][1] <= 1.0 + 1e-5,
          f"{what}: one Seidel sweep left [0, 1]: {one}")
    check(one["kernels_vs_f64"] <= one["tol"],
          f"{what}: Seidel sweep on the kernels off f64: {one}")


def phase_glauber_seidel():
    """``iterate(schedule="seidel", shuffle=True, chunk=2048, maxiter=3,
    tol=0)`` on the Glauber ER state (T=15, D=10, f32, sketch): each
    bucket a chunk a sweep, in a shuffled order, reading what earlier
    chunks wrote.  Beliefs finite and normalised; every merge and
    conversion on a hand kernel, by bucket, and no plain scan.  Then one
    shuffled sweep from the same start on the f32 kernels, and through the
    f32 and the f64 plain scans (:func:`seidel_sweep_errors`): the kernels'
    beliefs in [0, 1] (to 1e-5), and no further from the f64 sweep's than
    ``TOL_SWEEP_BELIEFS`` or twice the plain f32 sweep's distance, as the
    accuracy phase holds the card to the plain f32 error.  Glauber at this
    D is ill-conditioned: it leaves [0, 1] within a few sweeps by either
    schedule, and a single Seidel sweep (which reads messages already
    updated in it) moves ~1e-2 with f32 rounding alone, so the kernels are
    not held to the plain f32 sweep itself (PERF.md section 7);
    :func:`phase_sis_er_seidel` checks the schedule where it converges."""
    import torch
    import matrixproductbp_tpu_torch as tp
    torch.cuda.empty_cache()
    bp0 = glauber_state()
    torch.cuda.synchronize()
    reset_counts()
    with count_plain_scans() as plain, count_by_bucket() as buckets:
        t0 = time.perf_counter()
        bp, n, deltas = tp.iterate(
            bp0, maxiter=GLAUBER_SEIDEL_SWEEPS,
            trunc=tp.TruncBond(GLAUBER_D), tol=0.0, method="sketch",
            schedule="seidel", shuffle=True, chunk=GLAUBER_SEIDEL_CHUNK)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = read_counts()
    b = tp.beliefs(bp)
    norm = float((b.sum(-1) - 1.0).abs().max())
    finite = bool(torch.isfinite(b).all()) and bool(torch.isfinite(bp.f).all())
    belief_range = [float(b.min()), float(b.max())]
    del bp, b, bp0
    one = seidel_sweep_errors(lambda dtype: glauber_state(dtype=dtype))
    res = {"N": GLAUBER_N, "T": GLAUBER_T, "D": GLAUBER_D,
           "chunk": GLAUBER_SEIDEL_CHUNK, "sweeps": n, "deltas": deltas,
           "s_per_sweep": dt / n, "launches": counts, "by_bucket": buckets,
           "plain_scan_calls": plain, "normalisation_err": norm,
           "belief_range": belief_range, "one_sweep": one}
    emit("glauber_seidel", **res)
    check(finite, "glauber_seidel: beliefs or f not finite")
    check(norm <= 1e-5, f"glauber_seidel: beliefs not normalised: {norm}")
    check_buckets(res, 2, "glauber_seidel")
    check_seidel_sweep(one, "glauber_seidel")


def phase_sis_er_seidel():
    """SIS (lambda=0.2, rho=0.1, gamma=0.3, the bench's model) on the
    Glauber phase's graph (``erdos_renyi_graph(5000, 2.5)``), T=15, D=10,
    f32, sketch: one shuffled Gauss-Seidel sweep held as in
    :func:`phase_glauber_seidel` (:func:`seidel_sweep_errors`); then
    ``iterate``
    ``SIS_SEIDEL_SWEEPS`` sweeps by shuffled Gauss-Seidel in chunks of 2048
    nodes, and as many by Jacobi, both converging.  Checks: beliefs
    finite, normalised (1e-5) and in [0, 1] (to 1e-5) after each; both
    last deltas under ``TOL_SIS_SEIDEL_DELTA``; the two schedules' fixed
    points within ``TOL_SIS_SEIDEL_FIXED`` of each other; no plain scan."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    torch.cuda.empty_cache()
    g = tp.erdos_renyi_graph(GLAUBER_N, GLAUBER_C, np.random.default_rng(0))
    sis = SIS(g, lam=0.2, rho=0.1, T=GLAUBER_T, gamma=0.3)
    one = seidel_sweep_errors(
        lambda dtype: mpbp_sis(sis, D=GLAUBER_D, dtype=dtype, device="cuda"))
    res = {"N": g.N, "E": g.E, "T": GLAUBER_T, "D": GLAUBER_D,
           "one_sweep": one, "chunk": GLAUBER_SEIDEL_CHUNK, "sweeps": SIS_SEIDEL_SWEEPS,
           "tol_last_delta": TOL_SIS_SEIDEL_DELTA,
           "tol_fixed_points": TOL_SIS_SEIDEL_FIXED}
    beliefs = {}
    with count_plain_scans() as plain:
        for sched, kw in (("seidel", dict(schedule="seidel", shuffle=True,
                                          chunk=GLAUBER_SEIDEL_CHUNK)),
                          ("jacobi", {})):
            bp0 = mpbp_sis(sis, D=GLAUBER_D, dtype=torch.float32,
                           device="cuda")
            t0 = time.perf_counter()
            bp, n, deltas = tp.iterate(bp0, maxiter=SIS_SEIDEL_SWEEPS,
                                       trunc=tp.TruncBond(GLAUBER_D), tol=0.0,
                                       method="sketch", **kw)
            torch.cuda.synchronize()
            b = tp.beliefs(bp)
            beliefs[sched] = b
            res[sched] = {
                "s_per_sweep": (time.perf_counter() - t0) / n,
                "deltas": deltas, "range": [float(b.min()), float(b.max())],
                "finite": bool(torch.isfinite(b).all())
                and bool(torch.isfinite(bp.f).all()),
                "normalisation_err": float((b.sum(-1) - 1.0).abs().max())}
    res["fixed_points_diff"] = float(
        (beliefs["seidel"] - beliefs["jacobi"]).abs().max())
    res["plain_scan_calls"] = plain
    emit("sis_er_seidel", **res)
    check(not any(plain.values()),
          f"sis_er_seidel: plain scans ran on the card: {plain}")
    check_seidel_sweep(one, "sis_er_seidel")
    for sched in ("seidel", "jacobi"):
        r = res[sched]
        check(r["finite"] and r["normalisation_err"] <= 1e-5,
              f"sis_er_seidel: {sched} beliefs not finite or normalised: {r}")
        check(-1e-5 <= r["range"][0] and r["range"][1] <= 1.0 + 1e-5,
              f"sis_er_seidel: {sched} beliefs left [0, 1]: {r['range']}")
        check(r["deltas"][-1] <= TOL_SIS_SEIDEL_DELTA,
              f"sis_er_seidel: {sched} not converging: {r['deltas']}")
    check(res["fixed_points_diff"] <= TOL_SIS_SEIDEL_FIXED,
          f"sis_er_seidel: Seidel and Jacobi fixed points apart: {res}")


def lognorm_wants(Kb, Yb, q, D, calls):
    """The launches ``calls`` group calls of ``belief_lognorms(method=
    "sketch")`` on a bucket of Kb slots make: the full fold's Kb - 1
    merges, on the merge W and F kernels the geometry picks, and no
    conversion (the log-norm is taken from the MPEM3)."""
    want = {k: v for k, v in bucket_wants(Kb, Yb, q, D, calls).items()
            if k.startswith("merge")}
    return {k: (Kb - 1) * calls for k in want} if Kb > 1 else {}


def timed_call(fn):
    """(result, seconds, peak bytes allocated during the call, bytes
    allocated before it) of ``fn()`` on the card."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            base)


def smc_distances(sms, b):
    """SMC's marginals against the BP beliefs ``b`` [N, T1, q]: the largest
    and the mean distance at t=T and at t<T, and how many cells at t=T
    lie outside 6 max(err, 8e-3)."""
    from matrixproductbp_tpu_torch import sampling
    m, err = sampling.marginals_mc(sms)
    d = (m - b.double()).abs()
    bound = 6 * err.clamp(min=TOL_MC_FLOOR)
    return m, {"final_max": float(d[:, -1].max()),
               "final_mean": float(d[:, -1].mean()),
               "final_outside_gate": int((d[:, -1] >= bound[:, -1]).sum()),
               "earlier_max": float(d[:, :-1].max()),
               "earlier_mean": float(d[:, :-1].mean())}


class RoundedSketches:
    """The default sketches (a generator seeded with 17 at every draw),
    drawn in f64 and rounded to the asked type: f32 and f64 calls see the
    same sketches."""

    def draw(self, phi_shape, psi_shape, dtype, device):
        import torch
        from matrixproductbp_tpu_torch.ops.stta import SeededSketches
        a, b = SeededSketches().draw(phi_shape, psi_shape, torch.float64,
                                     device)
        return a.to(dtype), b.to(dtype)


def as_f64(bp):
    """``bp`` with its state and tables in f64."""
    import dataclasses
    import torch
    return dataclasses.replace(
        bp, tables=bp.tables.to(dtype=torch.float64),
        **{k: getattr(bp, k).double() for k in (
            "phi", "psi", "msg_cores", "msg_logz", "bel_cores", "bel_logz",
            "f")})


def inference_tree_run():
    """SIS (lambda=0.2, rho=0.1, gamma=0.3) on ``random_tree(4096,
    default_rng(0))`` (E=8,190, degrees 1-12: buckets K = 1, 2, 4, 8, 12),
    T=15, D=10, f32, sketch: iterate, the soft-margin sampler against BP,
    draw observations, iterate the observed state, then each observable
    timed with its peak memory, ``belief_lognorms(method="sketch")`` on the
    kernels (launches by bucket, plain scans counted) and on the plain
    scans, ``logprob`` of the drawn trajectory, and SMC twice (two
    generators: the spread of its own estimate).  Returns the record;
    :func:`phase_inference_tree` checks it."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import sampling, smc
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    g = tp.random_tree(INFER_N, np.random.default_rng(0))
    bp0 = mpbp_sis(SIS(g, lam=0.2, rho=0.1, T=INFER_T, gamma=0.3),
                   D=INFER_D, dtype=torch.float32, device="cuda")
    trunc = tp.TruncBond(INFER_D)
    res = {"N": g.N, "E": g.E, "T": INFER_T, "D": INFER_D,
           "max_degree": int(g.degree.max())}

    def run_iterate(bp):
        (bp, n, deltas), dt, _, _ = timed_call(lambda: tp.iterate(
            bp, maxiter=INFER_MAXITER, trunc=trunc, tol=INFER_TOL,
            method="sketch"))
        return bp, {"iters": n, "last_delta": deltas[-1],
                    "s_per_sweep": dt / len(deltas), "seconds": dt}

    bp, res["iterate_free"] = run_iterate(bp0)
    b = tp.beliefs(bp)
    gen = torch.Generator(device="cuda")
    sms, dt, peak, _ = timed_call(lambda: sampling.sample(
        bp, INFER_SAMPLES, generator=gen.manual_seed(0)))
    m, err = sampling.marginals_mc(sms)
    d = (m - b.double()).abs()
    res["sampler_vs_bp"] = {
        "samples": INFER_SAMPLES, "seconds": dt, "peak_bytes": peak,
        "max_dist": float(d.max()),
        "max_ratio": float((d / (6 * err.clamp(min=TOL_MC_FLOOR))).max()),
        "cells_outside": int((d >= 6 * err.clamp(min=TOL_MC_FLOOR)).sum())}
    del sms
    bpo, X, obs = sampling.draw_node_observations(
        bp, nobs=INFER_NOBS, rng=np.random.default_rng(1),
        softinf=INFER_SOFTINF, generator=gen.manual_seed(1))
    res["observations"] = {"nobs": len(obs), "softinf": INFER_SOFTINF}
    reset_counts()
    with count_plain_scans() as plain:
        bpo, res["iterate_observed"] = run_iterate(bpo)
    res["iterate_observed"]["plain_scan_calls"] = dict(plain)
    res["iterate_observed"]["launches"] = read_counts()
    bo = tp.beliefs(bpo)
    res["bethe_free_energy"] = float(tp.bethe_free_energy(bpo))

    times, outs = {}, {}

    def observe(name, fn):
        out, dt, peak, base = timed_call(fn)
        times[name] = {"seconds": dt, "peak_bytes": peak,
                       "resident_bytes": base}
        outs[name] = out

    observe("pair_beliefs", lambda: tp.pair_beliefs(bpo))
    observe("pair_lognorms", lambda: tp.pair_lognorms(bpo))
    observe("beliefs_tu", lambda: tp.beliefs_tu(bpo))
    observe("autocovariances", lambda: tp.autocovariances(bpo))
    observe("alternate_marginals", lambda: tp.alternate_marginals(bpo))
    sk = RoundedSketches()
    reset_counts()
    with count_plain_scans() as plain, \
            count_by_bucket("_belief_lognorm_nodes") as buckets:
        observe("belief_lognorms_sketch", lambda: tp.belief_lognorms(
            bpo, trunc=trunc, method="sketch", sketches=sk))
    lognorm_launches = read_counts()
    with plain_scans():
        observe("belief_lognorms_sketch_plain_scans",
                lambda: tp.belief_lognorms(bpo, trunc=trunc,
                                           method="sketch", sketches=sk))
        lz64 = tp.belief_lognorms(as_f64(bpo), trunc=trunc, method="sketch",
                                  sketches=sk)
    observe("bethe_free_energy_pair", lambda: tp.bethe_free_energy_pair(
        bpo, trunc=trunc, method="sketch"))
    observe("logprob", lambda: tp.logprob(bpo, X))

    pb, lzn = outs["pair_beliefs"]
    tu = outs["beliefs_tu"]
    T1 = INFER_T + 1
    upper = torch.ones((T1, T1), dtype=torch.bool, device="cuda").triu(1)
    lz, lzp = (outs["belief_lognorms_sketch"].double(),
               outs["belief_lognorms_sketch_plain_scans"].double())
    deg = torch.as_tensor(g.degree, device="cuda")

    def by_degree(d):
        return {int(k): float(d[deg == k].max())
                for k in torch.unique(deg).tolist()}
    src = torch.as_tensor(g.edge_src, dtype=torch.int64, device="cuda")
    res.update(
        observables=times,
        finite={k: bool(all(torch.isfinite(torch.as_tensor(t)).all()
                            for t in (v if isinstance(v, tuple) else (v,))))
                for k, v in outs.items()},
        sum_err={"pair": float((pb.sum((-2, -1)) - 1).abs().max()),
                 "alternate": float((outs["alternate_marginals"]
                                     .sum((-2, -1)) - 1).abs().max()),
                 "two_time": float((tu.sum((-2, -1))[:, upper] - 1)
                                   .abs().max())},
        pair_vs_beliefs=float((pb.sum(-1) - bo[src]).abs().max()),
        belief_lognorms={"kernels_vs_plain": float((lz - lzp).abs().max()),
                         "kernels_vs_f64": float((lz - lz64).abs().max()),
                         "plain_vs_f64": float((lzp - lz64).abs().max()),
                         "max_abs": float(lz64.abs().max()),
                         "kernels_vs_plain_by_degree": by_degree(
                             (lz - lzp).abs()),
                         "kernels_vs_f64_by_degree": by_degree(
                             (lz - lz64).abs()),
                         "plain_vs_f64_by_degree": by_degree(
                             (lzp - lz64).abs()),
                         "plain_scan_calls": dict(plain),
                         "launches": lognorm_launches,
                         "by_bucket": buckets, "tol": TOL_LOGNORM_PLAIN},
        bethe_free_energy_pair=float(outs["bethe_free_energy_pair"]),
        logprob=outs["logprob"])
    del outs, pb, tu

    smc_runs = []
    for seed in (0, 1):
        sms, dt, peak, _ = timed_call(lambda: smc.smc_sample(
            bpo, INFER_PARTICLES, generator=gen.manual_seed(seed)))
        m, dist = smc_distances(sms, bo)
        smc_runs.append((m, {"seconds": dt, "peak_bytes": peak,
                             "states_valid": bool(
                                 ((sms.X >= 0) & (sms.X < bpo.q)).all()),
                             "log_evidence": sms.log_evidence,
                             "ess_final": float(smc.effective_sample_size(
                                 sms.logw)), **dist}))
        del sms
    spread = (smc_runs[0][0] - smc_runs[1][0]).abs()
    res["smc"] = {"particles": INFER_PARTICLES,
                  "minus_bethe_free_energy": -res["bethe_free_energy"],
                  "runs": [r for _, r in smc_runs],
                  "replica_final_max": float(spread[:, -1].max()),
                  "replica_final_mean": float(spread[:, -1].mean())}
    res["seconds"] = time.perf_counter() - t_phase
    return res


def phase_inference_tree():
    """:func:`inference_tree_run`, then its gates: every output finite;
    pair, alternate and two-time marginals summing to 1 within 1e-5;
    ``pair_beliefs`` peaking under 4 GB; the sampler within 6 max(err,
    8e-3) of BP in every cell; ``belief_lognorms(method="sketch")`` on the
    merge kernels, launched as its buckets want, with no plain scan, within
    1e-3 of its plain-scan twin, or else no further from the same call in
    f64 (the same sketches, rounded) than twice the twin is; the observed
    iterate on the kernels; SMC's states valid, its weights and evidence
    finite.  SMC's distances from BP are reported beside the spread
    between two runs, not gated: with
    256 soft observations on 4,096 nodes its weights collapse onto a few
    lineages each step, and its marginals spread far wider than their
    binomial error says (SMC is held to enumeration in
    :func:`phase_accuracy`)."""
    res = inference_tree_run()
    emit("inference_tree", **res)
    check_inference_tree(res)
    return res


def check_inference_tree(res):
    """The gates of :func:`phase_inference_tree` on its record."""
    check(all(res["finite"].values()), f"inference_tree: not finite: "
                                       f"{res['finite']}")
    check(max(res["sum_err"].values()) <= TOL_SUMS,
          f"inference_tree: marginals do not sum to 1: {res['sum_err']}")
    peak = res["observables"]["pair_beliefs"]["peak_bytes"]
    check(peak < PAIR_PEAK_BYTES, f"inference_tree: pair_beliefs peaked at "
                                  f"{peak} bytes")
    check(res["sampler_vs_bp"]["cells_outside"] == 0,
          f"inference_tree: sampler off BP: {res['sampler_vs_bp']}")
    ln = res["belief_lognorms"]
    check(not any(ln["plain_scan_calls"].values()),
          f"inference_tree: plain scans in belief_lognorms: {ln}")
    total = {}
    for key, got in ln["by_bucket"].items():
        Kb, Yb = (int(v[1:]) for v in key.split("_"))
        want = lognorm_wants(Kb, Yb, 2, INFER_D, got["updates"])
        seen = {k: v for k, v in got.items() if k not in ("updates", "nodes")}
        check(seen == want, f"inference_tree: belief_lognorms bucket {key} "
                            f"launched {seen}, want {want}")
        for k, v in seen.items():
            total[k] = total.get(k, 0) + v
    check(total == {k: v for k, v in ln["launches"].items() if v},
          f"inference_tree: bucket launches {total} != {ln['launches']}")
    # 1e-3; failing that, the kernels no further from the f64 call than
    # twice the plain f32 call is (f32 rounding, not a kernel)
    check(ln["kernels_vs_plain"] <= TOL_LOGNORM_PLAIN
          or ln["kernels_vs_f64"] <= 2 * ln["plain_vs_f64"],
          f"inference_tree: belief_lognorms kernels vs plain: {ln}")
    it = res["iterate_observed"]
    check(not any(it["plain_scan_calls"].values())
          and it["launches"]["merge_f_staged"] > 0,
          f"inference_tree: observed iterate off the kernels: {it}")
    sm = res["smc"]
    check(all(r["states_valid"] and np.isfinite(r["log_evidence"])
              and r["ess_final"] >= 1.0 for r in sm["runs"]),
          f"inference_tree: SMC states, evidence or weights off: {sm}")


def scale_problem(N, T, rng_seed=0):
    """(graph, tables, phi [N, T+1, 2] f32 numpy) of the scale target:
    ``erdos_renyi_gnm(N, 3N/2)``, SIS tables shared by every node
    (``sis_tables``), the t=0 prior as ``phi``."""
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models.sis import sis_tables
    g = tp.erdos_renyi_gnm(N, 3 * N // 2, np.random.default_rng(rng_seed))
    phi = np.ones((N, T + 1, 2), np.float32)
    phi[:, 0] = (1.0 - SCALE_PRIOR_I, SCALE_PRIOR_I)
    return g, sis_tables(g, SCALE_LAM, SCALE_RHO), phi


def exact_isolated(T):
    """P(x_t = I) of a node without neighbours: it only recovers."""
    return SCALE_PRIOR_I * (1.0 - SCALE_RHO) ** np.arange(T + 1)


def phase_scale_er_1e5():
    """SIS (lambda=0.2, rho=0.1, the t=0 prior (0.7, 0.3)) on
    ``erdos_renyi_gnm(100000, 150000, default_rng(0))``, T=50, D=10, f32,
    sketch, tables from ``sis_tables``: ``bigsweep.flat_init`` on the card,
    then ``bp_sweep_flat`` in place (Gauss-Seidel) at a node-slot budget of
    ``SCALE_CHUNK``: a warm-up sweep, then ``TIMED_SWEEPS_SCALE`` timed
    ones, counts set to 0 just before and read just after, by kernel and
    by bucket.  Checks: marginals finite and normalised (1e-5); no plain
    scan and every scan kernel launched; the isolated nodes against their
    exact marginal P(I, t) = 0.3 * 0.9^t, within ``TOL_ISOLATED``; one chunk of the largest bucket re-run through the plain scans,
    beliefs and messages' marginals within ``TOL_SWEEP_BELIEFS``."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import bigsweep
    from matrixproductbp_tpu_torch import bp as tbp
    from matrixproductbp_tpu_torch.ops.tensortrain import TensorTrain, \
        marginals
    torch.cuda.empty_cache()
    T, D, dev = SCALE_T, SCALE_D, torch.device("cuda")
    t0 = time.perf_counter()
    g, tables, phi = scale_problem(SCALE_N, T)
    problem_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = bigsweep.flat_init(g, tables, T, D)
    tables = tables.to(device=dev, dtype=torch.float32)
    phi_d = torch.as_tensor(phi, device=dev)
    trunc = tp.TruncBond(D)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()

    def sweep():
        bigsweep.bp_sweep_flat(g, tables, fs, trunc, T, D, phi=phi_d,
                               chunk=SCALE_CHUNK)

    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_plain_scans() as plain, count_by_bucket() as buckets:
        t0 = time.perf_counter()
        for i in range(TIMED_SWEEPS_SCALE):
            if i == TIMED_SWEEPS_SCALE - 1:
                m_prev = fs.marg.clone()
            sweep()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TIMED_SWEEPS_SCALE
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    m = fs.marg
    finite = bool(torch.isfinite(m).all()) and bool(
        torch.isfinite(fs.f).all())
    norm = float((m.sum(-1) - 1.0).abs().max())
    iso = np.nonzero(g.degree == 0)[0]
    iso_err = float(np.abs(m[torch.as_tensor(iso, device=dev), :, 1]
                           .double().cpu().numpy()
                           - exact_isolated(T)).max())
    # one chunk of the largest bucket through the kernels and the plain
    # scans, from the same (final) messages
    bidx, Kb = max(tbp._degree_buckets(g), key=lambda b: len(b[0]))
    ids = bidx[:max(16, SCALE_CHUNK // Kb)]
    Yb = tbp._bucket_y(tables, Kb)
    ((_, P),) = tbp._pyy_groups(tables, bidx, Kb, Yb)
    sw = tbp._Sweep(tbp.graph_arrays(g, dev), tables, g.E, phi_d, None)
    args = (sw, ids, Kb, Yb, P, (fs.msg_cores, fs.msg_logz), True, trunc,
            trunc, D, D, 0.0, "sketch", None)
    ups = [tbp._update_nodes(*args)]
    with plain_scans():
        ups.append(tbp._update_nodes(*args))
    torch.cuda.synchronize()
    bel = [marginals(TensorTrain(u.bel_c, u.bel_lz, (2,))) for u in ups]
    msg = [msg_marginals(u.out_c, u.out_lz, 2) for u in ups]
    chunk_diff = {"beliefs": float((bel[0] - bel[1]).abs().max()),
                  "msg_marginals": float((msg[0] - msg[1]).abs().max())}
    del ups, bel, msg
    res = {"N": g.N, "E": g.E, "dmax": g.dmax, "isolated_nodes": len(iso),
           "T": T, "D": D, "q": 2, "dtype": "float32", "chunk": SCALE_CHUNK,
           "buckets": [[int(k), len(i)] for i, k in tbp._degree_buckets(g)],
           "problem_s": problem_s, "init_s": init_s, "warm_up_s": warm_s,
           "sweeps": TIMED_SWEEPS_SCALE, "s_per_sweep": dt,
           "edge_updates_per_s": g.E / dt, "resident_bytes": resident,
           "peak_bytes": peak, "peak_reserved_bytes": reserved,
           "last_delta": float((m - m_prev).abs().max()),
           "normalisation_err": norm, "isolated_belief_err": iso_err,
           "tol_isolated": TOL_ISOLATED,
           "largest_bucket": [int(Kb), len(bidx)],
           "chunk_nodes_largest_bucket": len(ids),
           "chunk_vs_plain": chunk_diff, "tol_chunk": TOL_SWEEP_BELIEFS,
           "launches": counts, "by_bucket": buckets,
           "plain_scan_calls": plain}
    emit("scale_er_1e5", **res)
    check(finite, "scale_er_1e5: marginals or f not finite")
    check(norm <= 1e-5, f"scale_er_1e5: marginals not normalised: {norm}")
    check_buckets(res, 2, "scale_er_1e5")
    check(all(counts[k] > 0 for k in ("merge_w_staged", "merge_f_staged",
                                      "mpem3_w_staged", "mpem3_f_staged")),
          f"scale_er_1e5: a scan kernel never launched: {counts}")
    check(iso_err <= TOL_ISOLATED,
          f"scale_er_1e5: isolated nodes off their exact marginal: {iso_err}")
    check(max(chunk_diff.values()) <= TOL_SWEEP_BELIEFS,
          f"scale_er_1e5: a chunk off its plain-scan update: {chunk_diff}")
    return res


def scale_kernel_times(res, reps=3):
    """The four staged scan kernels at the scale sweep's shapes (S=50,
    D=10): the merges of a chunk of its largest bucket ([n, 50], n nodes)
    and both conversions ([Kb * n, 50] messages, [n, 50] beliefs), CUDA
    events over ``reps`` launches beside the bound and the plain scan's
    time; the inputs drawn on the card; launches from the scale sweeps.
    One row a kernel, named ``<kernel>_t50``."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dev = torch.device("cuda")
    S, D = SCALE_T, SCALE_D
    n = res["chunk_nodes_largest_bucket"]
    Kb = res["largest_bucket"][0]
    md = merge_dims(D)
    L1, B1, Th, Pyy, Phi, S_init = merge_inputs(
        n, S, **md, dtype=torch.float32, device=dev, seed=61)
    Ws = fs.merge_wscan(L1, B1, Th)
    cases = [
        ("merge_w_staged", lambda: fs.merge_wscan(L1, B1, Th),
         lambda: fs.merge_wscan_plain(L1, B1, Th),
         work_merge_w(n, S, **md, esize=4), MERGE_W_ROWS["staged"]),
        ("merge_f_staged",
         lambda: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S_init),
         lambda: fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S_init),
         work_merge_f(n, S, **md, esize=4), MERGE_F_ROWS["staged"])]
    rows = []
    for name, kern, plain, (flops, nbytes), (_, src, line) in cases:
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(tuple(out) if isinstance(out, tuple) else out,
                             tuple(ref) if isinstance(ref, tuple) else ref)
        check(err <= TOL_F32_REL * scale,
              f"{name} at the scale shape disagrees with its plain version:"
              f" {err} > {TOL_F32_REL} * {scale}")
        bms, by = bound_ms(flops, nbytes)
        rows.append({
            "name": f"{name}_t50", "route": "cuda",
            "source": "matrixproductbp_tpu_torch/csrc/" + src,
            "replaces": "matrixproductbp_tpu/ops/fused_stta.py" + line,
            "launches": res["launches"][name], "max_abs_err": err,
            "ms": time_cuda(kern, reps), "plain_ms": time_cuda(plain, 1),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "flops": flops, "bytes": nbytes, "D": D, "B": n, "S": S,
            "launches_from": "scale_er_1e5"})
        emit("kernel_time_scale", **rows[-1])
        del out, ref
    del L1, B1, Th, Pyy, Phi, S_init, Ws
    torch.cuda.empty_cache()
    for r in mpem3_kernel_times(res["launches"], D, reps, S=S,
                                batches=(Kb * n, n),
                                launches_from="scale_er_1e5"):
        rows.append({**r, "name": r["name"] + "_t50"})
    return rows


def glauber_kernel_times(gres, reps=10):
    """The merge kernels at the Glauber sweep's K=8 bucket (Y=9, D=10, its
    merge batch): the merge F kernel it takes (the cluster kernel) and
    merge W's first design, on banded inputs, CUDA events over ``reps``
    launches, beside the bound (the band's pairs counted, not Y^2) and the
    plain version's time; launches from the Glauber sweeps at that
    bucket."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    key, Y = "K8_Y9", 9
    bk = gres["by_bucket"][key]
    Bn, S, md = bk["nodes"] // bk["updates"], GLAUBER_T, merge_dims(GLAUBER_D,
                                                                     Y)
    L1, B1, Th, Pyy, Phi, S_init = banded_merge_inputs(Bn, S, **md,
                                                       device="cuda", seed=40)
    Ws = fs.merge_wscan(L1, B1, Th)
    band = band_pairs(Y)
    f_name = fs.merge_f_geometry(*md.values(), torch.float32)[0]
    cases = [
        (MERGE_W_ROWS["base"], "merge_w",
         lambda: fs.merge_wscan(L1, B1, Th),
         lambda: fs.merge_wscan_plain(L1, B1, Th),
         work_merge_w(Bn, S, **md, esize=4, band=band)),
        (MERGE_F_ROWS[f_name], f"merge_f_{f_name}",
         lambda: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S_init),
         lambda: fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S_init),
         work_merge_f(Bn, S, **md, esize=4, band=band))]
    rows = []
    for (name, src, line), count, kern, plain, (flops, nbytes) in cases:
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(tuple(out) if isinstance(out, tuple) else out,
                             tuple(ref) if isinstance(ref, tuple) else ref)
        check(err <= TOL_F32_REL * scale,
              f"{name} at the Glauber Y={Y} bucket disagrees with its plain "
              f"version: {err} > {TOL_F32_REL} * {scale}")
        bms, by = bound_ms(flops, nbytes)
        rows.append({
            "name": f"{name}_glauber_y{Y}", "route": "cuda",
            "source": "matrixproductbp_tpu_torch/csrc/" + src,
            "replaces": "matrixproductbp_tpu/ops/fused_stta.py" + line,
            "launches": bk.get(count, 0), "max_abs_err": err,
            "ms": time_cuda(kern, reps), "plain_ms": time_cuda(plain, 2),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "flops": flops, "bytes": nbytes, "D": GLAUBER_D, "Y": Y,
            "B": Bn, "band_pairs": band,
            "launches_from": f"glauber_er, bucket {key}"})
        emit("kernel_time_glauber", **rows[-1])
        del out, ref
    return rows

# ---------------------------------------------------------------------------
# time-varying tables, periodic trains, infinite graphs
# ---------------------------------------------------------------------------

def tv_lams():
    """lam of each step t = 0..T: the lockdown lowers it at TV_SWITCH."""
    return [TV_LAM if t < TV_SWITCH else TV_LAM_LOCKDOWN
            for t in range(BENCH_T + 1)]


def sis_tables_t(g, lams, rho=0.1):
    """``build_tables_t`` of SIS with one lam a step, every node alike."""
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SISFactorSpec
    specs = [SISFactorSpec(lam=lam, rho=rho) for lam in lams]
    return tp.build_tables_t(g, [specs] * g.N)


def timed_sweeps(bp1, trunc, sweeps):
    """(s a sweep, last state) of ``sweeps`` sketch sweeps from ``bp1``."""
    import torch
    import matrixproductbp_tpu_torch as tp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cur = bp1
    for _ in range(sweeps):
        cur = tp.bp_sweep(cur, trunc, method="sketch")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / sweeps, cur


def phase_tv_sis_rrg():
    """Time-varying SIS on the bench graph (N=4096, T=15, f32, sketch): lam
    0.2 until t=8, then 0.05 (a lockdown); rho 0.1, prior 0.3; tables from
    ``build_tables_t``.  At D=10 (3 timed sweeps) and D=20 (2), each after
    a warm-up, with the launch counts set to 0 just before and read just
    after: every merge F launch a time-varying one (one ``prob_yy`` a step)
    on the staged (D=10) or cluster (D=20) kernel, every merge W and
    conversion on its kernel, no plain-scan call.  One sweep against the
    same sweep on the plain scans (TOL_SWEEP_BELIEFS); tables stacked from
    one spec a step against the constant tables' sweep (TOL_TV_STACKED);
    the constant tables' s/sweep, timed right after on the same graph,
    beside the time-varying one."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, sis_tables
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    g = tp.random_regular_graph(BENCH_N, BENCH_DEG, np.random.default_rng(0))
    phi = SIS(g, lam=TV_LAM, rho=0.1, T=BENCH_T, gamma=0.3).default_phi()
    t0 = time.perf_counter()
    tables = {"tv": sis_tables_t(g, tv_lams()),
              "stacked": sis_tables_t(g, [TV_LAM] * (BENCH_T + 1)),
              "const": sis_tables(g, TV_LAM, 0.1)}
    build_s = time.perf_counter() - t0
    out = {}
    for D in (10, 20):
        torch.cuda.empty_cache()
        trunc = tp.TruncBond(D)
        states = {k: tp.mpbp(g, tb, BENCH_T, D, phi=phi,
                             dtype=torch.float32, device="cuda")
                  for k, tb in tables.items()}
        bp0 = states["tv"]
        bp1 = tp.bp_sweep(bp0, trunc, method="sketch")
        reset_counts()
        with count_plain_scans() as plain_calls:
            dt, cur = timed_sweeps(bp1, trunc, TIMED_SWEEPS_TV[D])
        counts = read_counts()
        tv_counts = dict(fs.merge_fscan.tv_launches)
        n = TIMED_SWEEPS_TV[D]
        per_sweep = {k: v / n for k, v in counts.items()}
        f_kernel = "merge_f_staged" if D == 10 else "merge_f_cluster"
        want = {**merge_w_wants(D), "merge_f": 0, "merge_f_staged": 0,
                "merge_f_cluster": 0, **NO_STREAMED, f_kernel: 3,
                **MPEM3_WANTS,
                "cholqr": 0, "cholqr_staged": 0, "jacobi_eigh": 0}
        b = tp.beliefs(cur)
        with plain_scans():
            bp1p = tp.bp_sweep(bp0, trunc, method="sketch")
        diff_plain = float((tp.beliefs(bp1) - tp.beliefs(bp1p)).abs().max())
        one = {k: tp.bp_sweep(states[k], trunc, method="sketch")
               for k in ("stacked", "const")}
        diff_stacked = float((tp.beliefs(one["stacked"])
                              - tp.beliefs(one["const"])).abs().max())
        c1 = tp.bp_sweep(states["const"], trunc, method="sketch")
        const_dt, _ = timed_sweeps(c1, trunc, n)
        res = {"D": D, "N": BENCH_N, "E": g.E, "T": BENCH_T,
               "lams": tv_lams(), "sweeps": n, "s_per_sweep": dt,
               "const_s_per_sweep": const_dt,
               "tables_build_s": build_s, "launches": counts,
               "launches_per_sweep": per_sweep,
               "merge_f_tv_launches": tv_counts,
               "plain_scan_calls": dict(plain_calls),
               "one_sweep_belief_diff_vs_plain": diff_plain,
               "tol": TOL_SWEEP_BELIEFS,
               "stacked_vs_constant_belief_diff": diff_stacked,
               "tol_stacked": TOL_TV_STACKED}
        emit(f"tv_sis_rrg_d{D}", **res)
        check(per_sweep == want,
              f"time-varying D={D}: launches per sweep {per_sweep}, want "
              f"{want}")
        check(tv_counts[f_kernel[len("merge_f_"):]] == counts[f_kernel]
              and sum(tv_counts.values()) == counts[f_kernel],
              f"time-varying D={D}: merge F launches {counts[f_kernel]}, "
              f"of them with one Pyy a step {tv_counts}")
        check(not any(plain_calls.values()),
              f"time-varying D={D}: plain scans called {plain_calls}")
        check(bool(torch.isfinite(b).all()),
              f"time-varying D={D}: beliefs not finite")
        check(diff_plain <= TOL_SWEEP_BELIEFS,
              f"time-varying D={D}: kernel sweep vs plain: {diff_plain}")
        check(diff_stacked <= TOL_TV_STACKED,
              f"time-varying D={D}: stacked vs constant: {diff_stacked}")
        out[D] = res
        del states, bp0, bp1, bp1p, cur, one, c1
    return out


def periodic_state(N, dtype, device, D=PERIODIC_D):
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, periodic_mpbp_sis
    g = tp.random_regular_graph(N, BENCH_DEG, np.random.default_rng(0))
    return periodic_mpbp_sis(SIS(g, lam=0.2, rho=0.1, T=PERIODIC_T,
                                 gamma=0.3), D=D, dtype=dtype,
                             device=device)


def svd_routes():
    """SVD batches by route (the Jacobi kernel's Gram route, or
    torch.linalg.svd), Jacobi eigen launches and torch.linalg.qr batches
    of the periodic sweep, so far."""
    from matrixproductbp_tpu_torch.ops import smallsvd, tensortrain
    return {**{f"svd_{k}": v for k, v in tensortrain.batched_svd.calls.items()},
            "jacobi_eigh": smallsvd.eigh_desc.launches,
            "qr": tensortrain._right_orth.qr_calls}


def phase_periodic_sis_rrg():
    """``periodic_mpbp_sis`` on random_regular_graph(1024, 3), T=10, D=8,
    f32, ``qr`` (every periodic merge is the Kronecker product compressed
    by the cut-and-rotate sweep, every conversion the periodic SVD sweep):
    a warm-up and 2 timed sweeps, their SVD batches by route and their QR
    batches counted; beliefs finite and summing to 1 (TOL_PERIODIC_SUMS).
    At PERIODIC_CHECK_N nodes, one sweep on the card against the same
    sweep on the host in f32, where every SVD is torch.linalg.svd
    (TOL_SWEEP_BELIEFS), and the distance of the card's f32 sweep from the
    host's f64 one."""
    import torch
    import matrixproductbp_tpu_torch as tp
    torch.cuda.empty_cache()
    trunc = tp.TruncBond(PERIODIC_D)
    bp0 = periodic_state(PERIODIC_N, torch.float32, "cuda")
    t0 = time.perf_counter()
    bp1 = tp.bp_sweep(bp0, trunc, method="qr")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_counts()
    before = svd_routes()
    t0 = time.perf_counter()
    cur = bp1
    for _ in range(TIMED_SWEEPS_PERIODIC):
        cur = tp.bp_sweep(cur, trunc, method="qr")
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED_SWEEPS_PERIODIC
    routes = {k: (v - before[k]) / TIMED_SWEEPS_PERIODIC
              for k, v in svd_routes().items()}
    counts = read_counts()
    b = tp.beliefs(cur)
    sums = float((b.sum(-1) - 1).abs().max())
    # the check at PERIODIC_CHECK_N: card (f32), host f32 (linalg.svd),
    # host f64
    small = {dev_dt: periodic_state(PERIODIC_CHECK_N, dev_dt[1], dev_dt[0])
             for dev_dt in (("cuda", torch.float32), ("cpu", torch.float32),
                            ("cpu", torch.float64))}
    t0 = time.perf_counter()
    swept = {k: tp.beliefs(tp.bp_sweep(v, trunc, method="qr")).double().cpu()
             for k, v in small.items()}
    host_s = time.perf_counter() - t0
    card = swept[("cuda", torch.float32)]
    diff_linalg = float((card - swept[("cpu", torch.float32)]).abs().max())
    diff_f64 = float((card - swept[("cpu", torch.float64)]).abs().max())
    res = {"N": PERIODIC_N, "T": PERIODIC_T, "D": PERIODIC_D,
           "E": bp0.graph.E, "method": "qr", "warmup_s": warm_s,
           "sweeps": TIMED_SWEEPS_PERIODIC, "s_per_sweep": dt,
           "edge_updates_per_s": bp0.graph.E / dt,
           "per_sweep": routes, "scan_launches": counts,
           "belief_sum_err": sums, "tol_sums": TOL_PERIODIC_SUMS,
           "check_N": PERIODIC_CHECK_N, "check_host_s": host_s,
           "one_sweep_vs_linalg_svd_host_f32": diff_linalg,
           "tol": TOL_SWEEP_BELIEFS,
           "one_sweep_f32_vs_f64_host": diff_f64}
    emit("periodic_sis_rrg", **res)
    check(bool(torch.isfinite(b).all()), "periodic: beliefs not finite")
    check(sums <= TOL_PERIODIC_SUMS, f"periodic: beliefs sum off 1 by {sums}")
    check(routes["jacobi_eigh"] > 0 and routes["qr"] == 0,
          f"periodic: SVDs and QRs by route {routes}")
    check(diff_linalg <= TOL_SWEEP_BELIEFS,
          f"periodic: card sweep vs linalg.svd sweep: {diff_linalg}")
    return res


def phase_svd_driver_f32():
    """ROADMAP Queue 3 item 1, f32 SVDs above k=64 on the card: periodic
    SIS (``qr``) at D=10, whose Kronecker merges compress bond-100 trains,
    on random_regular_graph(SVD_DRIVER_N, 3), T=10, SVD_DRIVER_SWEEPS
    sweeps in f32 on the card through the port's route (cuSOLVER's
    default driver above ``smallsvd.MAX_K``), then the same with every
    such SVD on ``gesvd``, each held to the same sweeps on the host in
    f64, and the host's own f32 sweeps (LAPACK) beside them; SVD batches
    by route.  Beliefs finite; the distances reported."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.ops import tensortrain
    trunc = tp.TruncBond(SVD_DRIVER_D)

    def run(dtype, device):
        bp = periodic_state(SVD_DRIVER_N, dtype, device, D=SVD_DRIVER_D)
        t0 = time.perf_counter()
        for _ in range(SVD_DRIVER_SWEEPS):
            bp = tp.bp_sweep(bp, trunc, method="qr")
        b = tp.beliefs(bp).double().cpu()
        return b, time.perf_counter() - t0

    before = dict(tensortrain.batched_svd.calls)
    port, port_s = run(torch.float32, "cuda")
    routes = {k: v - before[k]
              for k, v in tensortrain.batched_svd.calls.items()}
    linalg_svd = torch.linalg.svd

    def gesvd(A, full_matrices=True, *, driver=None, out=None):
        if A.is_cuda and driver is None:
            driver = "gesvd"
        return linalg_svd(A, full_matrices=full_matrices, driver=driver)
    torch.linalg.svd = gesvd
    try:
        forced, forced_s = run(torch.float32, "cuda")
    finally:
        torch.linalg.svd = linalg_svd
    host, host_s = run(torch.float64, "cpu")
    host32, host32_s = run(torch.float32, "cpu")
    res = {"N": SVD_DRIVER_N, "T": PERIODIC_T, "D": SVD_DRIVER_D,
           "sweeps": SVD_DRIVER_SWEEPS, "svd_batches_by_route": routes,
           "port_route_vs_host_f64": float((port - host).abs().max()),
           "gesvd_vs_host_f64": float((forced - host).abs().max()),
           "port_route_vs_gesvd": float((port - forced).abs().max()),
           "host_f32_vs_host_f64": float((host32 - host).abs().max()),
           "port_s": port_s, "gesvd_s": forced_s, "host_f64_s": host_s,
           "host_f32_s": host32_s}
    emit("svd_driver_f32", **res)
    check(bool(torch.isfinite(port).all() and torch.isfinite(forced).all()),
          "svd_driver_f32: beliefs not finite")
    check(routes["linalg"] > 0, f"svd_driver_f32: no SVD above k=64: "
                                f"{routes}")
    return res


def phase_modes_accuracy():
    """On the card: SIS on the infinite 3-regular graph (T=6, D=10, f64) to
    the reference's golden vector (``tests/test_sis_infinite_graph.py``,
    rtol TOL_GOLDEN_RTOL); periodic Glauber on the infinite 3-regular graph
    against periodic K4 from the same message (T=2, D=10, f64, damping 0.2,
    ``tests/test_infinite_and_equilibrium.py:99-129``): both iterates
    converge (tol 1e-12) within INF_K4_MAXITER sweeps and their beliefs and
    pair beliefs agree to TOL_INF_K4; periodic SIS on the observed 3-node
    path of ``tests/test_periodic.py`` (T=2, D=16, f64) against periodic
    enumeration, beliefs and Bethe free energy to TOL_PERIODIC_EXACT, with
    ``TruncThresh(1e-12)``: with ``TruncThresh(0.0)`` the sweep keeps
    noise-level singular directions and its fixed point moves with the
    SVD's rounding (``tools/probe_periodic.py``); the time-varying 4-node
    tree of ``tests/test_time_varying.py`` against enumeration, ``qr`` in
    f64 (TOL_TV_QR) and the sketch in f32 (TOL_TV_SKETCH)."""
    import dataclasses
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import exact
    from matrixproductbp_tpu_torch.models import (
        HomogeneousGlauberFactorSpec, SISFactorSpec, sis_tables)
    golden = np.array([
        [0.9000000001671186, 0.0999999998328814],
        [0.8932690998131098, 0.10673090018689023],
        [0.8899420329322244, 0.11005796706777556],
        [0.8884643888492034, 0.11153561115079656],
        [0.8880305235706524, 0.1119694764293476],
        [0.8882121515614524, 0.11178784843854758],
        [0.8887717202217936, 0.1112282797782064]])
    res = {}
    t0 = time.perf_counter()
    gi = tp.infinite_regular_graph(3)
    phi = np.ones((1, 7, 2))
    phi[0, 0] = [0.9, 0.1]
    bp = tp.mpbp_infinite_graph(3, tp.build_tables(
        gi, [SISFactorSpec(0.1, 0.2)]), 6, D=10, phi=phi, device="cuda")
    bp, it, _ = tp.iterate(bp, maxiter=200, trunc=tp.TruncBond(10),
                           tol=1e-14)
    b = tp.beliefs(bp)[0].cpu().numpy()
    res["golden"] = {"rel_err": float(np.abs(b / golden - 1).max()),
                     "iterations": it, "s": time.perf_counter() - t0}
    # periodic Glauber: the infinite 3-regular graph against K4
    t0 = time.perf_counter()
    spec = HomogeneousGlauberFactorSpec(1.0, 0.0, 1.0)
    phi1 = np.ones((1, 3, 2))
    phi1[0] = [[0.75, 0.25], [0.4, 0.6], [0.95, 0.05]]
    bpi = tp.periodic_mpbp_infinite_graph(
        3, tp.build_tables(tp.infinite_regular_graph(3), [spec]), 2, D=10,
        phi=phi1, device="cuda")
    g4 = tp.graph_from_edges(4, [(i, j) for i in range(4) for j in range(i)])
    bp4 = tp.periodic_mpbp(g4, tp.build_tables(g4, [spec] * 4), 2, D=10,
                           phi=np.broadcast_to(phi1, (4, 3, 2)).copy(),
                           device="cuda")
    bp4 = dataclasses.replace(bp4, msg_cores=bpi.msg_cores.expand(
        (g4.E,) + bpi.msg_cores.shape[1:]).clone())
    its = []
    for st in (bpi, bp4):
        st, it, _ = tp.iterate(st, maxiter=INF_K4_MAXITER,
                               trunc=tp.TruncBond(10), tol=1e-12, damp=0.2)
        its.append((st, it))
    (bpi, it_i), (bp4, it_4) = its
    res["periodic_inf_vs_k4"] = {
        "beliefs": float((tp.beliefs(bpi)[0] - tp.beliefs(bp4)[0])
                         .abs().max()),
        "pair_beliefs": float((tp.pair_beliefs(bpi)[0][0]
                               - tp.pair_beliefs(bp4)[0][0]).abs().max()),
        "iterations": [it_i, it_4], "s": time.perf_counter() - t0}
    # periodic SIS on the observed 3-node path against enumeration
    t0 = time.perf_counter()
    g3 = tp.graph_from_edges(3, [(0, 1), (1, 2)])
    phi3 = np.ones((3, 3, 2))
    phi3[0, 1] = [0.8, 0.2]
    phi3[2, 0] = [0.3, 0.7]
    st = tp.periodic_mpbp(g3, sis_tables(g3, 0.35, 0.25), 2, D=16,
                          phi=phi3, device="cuda")
    st, it, _ = tp.iterate(st, maxiter=12, trunc=tp.TruncThresh(1e-12),
                           tol=1e-13)
    p3, Z3 = exact.exact_prob(st)
    res["periodic_path_vs_exact"] = {
        "beliefs": float(np.abs(tp.beliefs(st).cpu().numpy()
                                - exact.exact_marginals(st, p3)).max()),
        "free_energy": abs(-float(tp.bethe_free_energy(st)) - np.log(Z3)),
        "iterations": it, "s": time.perf_counter() - t0}
    # the time-varying tree against enumeration
    t0 = time.perf_counter()
    g = tp.graph_from_edges(4, [(0, 1), (1, 2), (1, 3)])
    specs = [SISFactorSpec(lam=0.15 + 0.1 * t, rho=0.3 + 0.05 * t)
             for t in range(4)]
    tables = tp.build_tables_t(g, [specs] * 4)
    phi = np.random.default_rng(5).uniform(0.3, 1.0, size=(4, 4, 2))
    ref = tp.mpbp(g, tables, 3, 12, phi=phi, device="cpu")
    p, _ = exact.exact_prob(ref)
    m_ex = exact.exact_marginals(ref, p)
    tv = {}
    for method, dtype in (("qr", torch.float64), ("sketch", torch.float32)):
        st = tp.mpbp(g, tables, 3, 12, phi=phi, dtype=dtype, device="cuda")
        st, _, _ = tp.iterate(st, maxiter=12, trunc=tp.TruncBond(12),
                              tol=1e-13, method=method)
        tv[method] = float(np.abs(tp.beliefs(st).double().cpu().numpy()
                                  - m_ex).max())
    res["tv_tree_vs_exact"] = {**tv, "s": time.perf_counter() - t0}
    emit("modes_accuracy", **res, tol_golden_rtol=TOL_GOLDEN_RTOL,
         tol_inf_k4=TOL_INF_K4, inf_k4_maxiter=INF_K4_MAXITER,
         tol_periodic_exact=TOL_PERIODIC_EXACT,
         tol_tv_qr=TOL_TV_QR, tol_tv_sketch=TOL_TV_SKETCH)
    check(res["golden"]["rel_err"] <= TOL_GOLDEN_RTOL,
          f"golden vector off: {res['golden']}")
    ik = res["periodic_inf_vs_k4"]
    check(max(ik["iterations"]) < INF_K4_MAXITER
          and ik["beliefs"] <= TOL_INF_K4
          and ik["pair_beliefs"] <= TOL_INF_K4,
          f"periodic infinite graph vs K4: {ik}")
    pe = res["periodic_path_vs_exact"]
    check(pe["beliefs"] <= TOL_PERIODIC_EXACT
          and pe["free_energy"] <= TOL_PERIODIC_EXACT,
          f"periodic path vs enumeration: {pe}")
    check(tv["qr"] <= TOL_TV_QR and tv["sketch"] <= TOL_TV_SKETCH,
          f"time-varying tree vs enumeration: {tv}")
    return res


def timed_stationary(sbp, **kw):
    """``iterate_stationary`` on the card: (state, iterations, deltas,
    overlaps, wall seconds, SVD batches by route)."""
    import torch
    from matrixproductbp_tpu_torch import stationary as st
    from matrixproductbp_tpu_torch.ops import tensortrain
    svd0 = dict(tensortrain.batched_svd.calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sbp, it, deltas, overlaps = st.iterate_stationary(sbp, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    svd = {k: v - svd0[k] for k, v in tensortrain.batched_svd.calls.items()}
    return sbp, it, deltas, overlaps, wall, svd


def phase_stationary_modes():
    """The stationary mode on the card, f64: (a) the golden fixed point
    (sweeps, s/sweep; device launches and busy seconds of one profiled
    sweep after the gate); (b) against long-horizon finite-T BP (``qr``)
    at t = T/2;
    (c) the bipartite (3, 3) fixed point against the regular one; (d)
    stationary Glauber (J=0.4, h=0.1, beta=0.7) and SIRS (flat phi: the
    default's phi(R) = 0 at every step leaves only the all-susceptible
    state) on the 3-node path, on the card and on the host."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import stationary as st
    from matrixproductbp_tpu_torch.tools import probe_stationary
    from matrixproductbp_tpu_torch.models import (Glauber, Ising, SIRS,
                                                  SISFactorSpec,
                                                  mpbp_stationary_glauber,
                                                  mpbp_stationary_sirs)
    res = {}
    t0 = time.perf_counter()
    tables = tp.build_tables(tp.infinite_regular_graph(3), [SISFactorSpec(
        STAT_LAM, STAT_RHO, alpha=STAT_ALPHA)])
    gold = st.TruncVUMPS(12)
    reg, it, _, ov, wall, svd = timed_stationary(
        st.mpbp_stationary_infinite_graph(3, tables), maxiter=200,
        trunc=gold, tol=1e-14)
    b_reg = st.beliefs_stationary(reg)
    F = st.bethe_free_energy_stationary(reg)
    res["golden"] = {"sweeps": it, "s": wall, "s_per_sweep": wall / it,
                     "b_S": float(b_reg[0, 0]),
                     "err": abs(float(b_reg[0, 0]) - STAT_GOLDEN_BS),
                     "free_energy": F, "last_overlap": ov[-1],
                     "svd_batches_per_sweep": {k: v / it
                                               for k, v in svd.items()}}
    check(res["golden"]["err"] <= TOL_STAT_GOLDEN and abs(F) < TOL_STAT_F,
          f"stationary golden fixed point: {res['golden']}")
    t1 = time.perf_counter()
    n, busy, top = probe_stationary.device_launches(
        lambda: st.iterate_stationary(reg, maxiter=1, trunc=gold, tol=0.0))
    res["golden"].update(launches_per_sweep=n, device_busy_s=busy,
                         top_launches=top,
                         profile_s=time.perf_counter() - t1)

    t1 = time.perf_counter()
    stat, it, deltas, ov, wall, _ = timed_stationary(
        st.mpbp_stationary_infinite_graph(3, tables), maxiter=120,
        trunc=st.TruncVUMPS(STAT_LONG_D, refine=4), tol=1e-10)
    b_stat = st.beliefs_stationary(stat)[0]
    T = STAT_LONG_T
    phi = np.ones((1, T + 1, 2))
    phi[0, 0] = [0.9, 0.1]
    bp = tp.mpbp_infinite_graph(3, tables, T, D=STAT_LONG_D, phi=phi)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bp, fit, _ = tp.iterate(bp, maxiter=60, trunc=tp.TruncBond(STAT_LONG_D),
                            tol=1e-10)
    b_late = tp.beliefs(bp)[0, T // 2].cpu().numpy()
    fwall = time.perf_counter() - t2
    res["long_horizon"] = {
        "sweeps": it, "s": wall, "s_per_sweep": wall / it,
        "last_delta": deltas[-1], "last_overlap": ov[-1],
        "finite_T_sweeps": fit, "finite_T_s": fwall,
        "err": float(np.abs(b_stat - b_late).max()),
        "phase_s": time.perf_counter() - t1}
    check(res["long_horizon"]["err"] <= TOL_STAT_LONG
          and res["long_horizon"]["last_overlap"] < TOL_STAT_OVERLAP,
          f"stationary vs long-horizon finite T: {res['long_horizon']}")

    bip, it, _, _, wall, _ = timed_stationary(
        st.mpbp_stationary_infinite_bipartite_graph((3, 3), tables),
        maxiter=200, trunc=gold, tol=1e-14)
    res["bipartite"] = {
        "sweeps": it, "s": wall,
        "err": float(np.abs(st.beliefs_stationary(bip) - b_reg).max())}
    check(it < 200 and res["bipartite"]["err"] <= TOL_STAT_BIPARTITE,
          f"stationary bipartite vs regular: {res['bipartite']}")

    path = tp.graph_from_edges(3, [(0, 1), (1, 2)])
    host = {}
    for name, make in (
            ("glauber", lambda dev: mpbp_stationary_glauber(Glauber(Ising(
                path, J=[0.4] * 2, h=[0.1] * 3, beta=0.7), T=0), D=4,
                device=dev)),
            ("sirs", lambda dev: mpbp_stationary_sirs(SIRS(
                path, lam=0.3, rho=0.2, sigma=0.15, T=0, alpha=0.05,
                phi=np.ones((3, 1, 3))), D=4, device=dev))):
        b = {}
        for dev in ("cuda", "cpu"):
            sbp, it, _, _ = st.iterate_stationary(
                make(dev), maxiter=40, trunc=st.TruncVUMPS(6), tol=1e-12)
            b[dev] = st.beliefs_stationary(sbp)
        host[name] = {"sweeps": it, "err": float(np.abs(b["cuda"]
                                                         - b["cpu"]).max())}
    res["card_vs_host"] = host
    res["seconds"] = time.perf_counter() - t0
    emit("stationary_modes", **res)
    check(all(h["err"] <= TOL_STAT_HOST for h in host.values()),
          f"stationary card vs host: {host}")
    return res


def _same_leaves(a, b):
    """Names of the state and table leaves where ``a`` and ``b`` differ."""
    import torch
    from matrixproductbp_tpu_torch import convert
    bad = [n for n in convert._STATE_LEAVES
           if not torch.equal(getattr(a, n), getattr(b, n))]
    bad += [n for n in convert._TABLE_LEAVES
            if not torch.equal(getattr(a.tables, n), getattr(b.tables, n))]
    return bad


def phase_checkpoint_bench():
    """The sketch D=10 bench state after one sweep saved CKPT_SAVES times
    through a ``CheckpointManager`` (keep=CKPT_KEEP) in a temporary
    directory: seconds each ``save`` blocks and each ``wait`` takes, the
    file size, the load seconds; the latest restored bit for bit on the
    card, and one sweep of the restored state and of the original (the
    same seeded sketches) compared.  A small periodic and a small
    time-varying state round-trip through ``save_checkpoint``."""
    import os
    import tempfile
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import (SIS, SISFactorSpec,
                                                  periodic_mpbp_sis)
    t0 = time.perf_counter()
    trunc = tp.TruncBond(10)
    bp = tp.bp_sweep(bench_state(10, torch.float32), trunc, method="sketch")
    torch.cuda.synchronize()
    res = {"state_bytes": sum(getattr(bp, n).nbytes for n in (
        "msg_cores", "msg_logz", "bel_cores", "bel_logz", "f", "phi",
        "psi"))}
    with tempfile.TemporaryDirectory() as d:
        mgr = tp.CheckpointManager(os.path.join(d, "run"), keep=CKPT_KEEP)
        block, wait = [], []
        for step in range(CKPT_SAVES):
            t1 = time.perf_counter()
            mgr.save(step, bp, extra={"sweeps": 1})
            t2 = time.perf_counter()
            mgr.wait()
            block.append(t2 - t1)
            wait.append(time.perf_counter() - t2)
        steps = mgr.all_steps()
        res["file_bytes"] = os.path.getsize(
            os.path.join(mgr.directory, f"ckpt_{steps[-1]}.npz"))
        t1 = time.perf_counter()
        bp2, meta = mgr.restore()
        torch.cuda.synchronize()
        res.update(save_block_s=block, wait_s=wait,
                   load_s=time.perf_counter() - t1, steps_kept=steps)
        check(steps == list(range(CKPT_SAVES))[-CKPT_KEEP:]
              and meta["step"] == CKPT_SAVES - 1
              and meta["extra"] == {"sweeps": 1},
              f"checkpoint manager: steps {steps}, meta {meta}")
        check(bp2.device == bp.device and not _same_leaves(bp, bp2),
              f"restored state differs: {_same_leaves(bp, bp2)}")
        reset_counts()
        a = tp.bp_sweep(bp, trunc, method="sketch")
        b = tp.bp_sweep(bp2, trunc, method="sketch")
        torch.cuda.synchronize()
        res["sweep_launches"] = read_counts()
        res["next_sweep_bit_equal"] = not _same_leaves(a, b)
        res["next_sweep_max_abs"] = {
            n: float((getattr(a, n) - getattr(b, n)).abs().max())
            for n in ("msg_cores", "bel_cores", "f")}
        g = tp.random_regular_graph(64, 3, np.random.default_rng(1))
        small = {
            "periodic": periodic_mpbp_sis(SIS(g, 0.2, 0.1, T=5, gamma=0.3),
                                          D=4, dtype=torch.float32),
            "time_varying": tp.mpbp(g, tp.build_tables_t(g, [[SISFactorSpec(
                0.2 if t < 3 else 0.05, 0.1) for t in range(6)]] * g.N),
                5, 4, phi=SIS(g, 0.2, 0.1, T=5, gamma=0.3).default_phi(),
                dtype=torch.float32)}
        for name, sb in small.items():
            sb = tp.bp_sweep(sb, tp.TruncBond(4), method="qr")
            path = tp.save_checkpoint(os.path.join(d, name), sb, step=1)
            back, _ = tp.load_checkpoint(path)
            check(back.periodic == sb.periodic and not _same_leaves(sb, back),
                  f"{name} state round trip: {_same_leaves(sb, back)}")
    res["seconds"] = time.perf_counter() - t0
    emit("checkpoint_bench", **res)
    check(res["next_sweep_bit_equal"]
          or max(res["next_sweep_max_abs"].values()) <= 1e-6,
          f"restored state's sweep: {res['next_sweep_max_abs']}")
    return res


@contextlib.contextmanager
def one_rank_group(backend):
    """This process as the one rank of a ``backend`` process group."""
    import os
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def halo_sweeps(st, trunc):
    """:data:`HALO_SWEEPS` halo sweeps of ``st``, each timed to a device
    synchronize, with the launch counts set to 0 just before and read
    just after and the plain scans counted: (state, record)."""
    import torch
    from matrixproductbp_tpu_torch.parallel import halo_sweep
    times = []
    reset_counts()
    with count_plain_scans() as plain:
        for _ in range(HALO_SWEEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = halo_sweep(st, trunc, method="sketch")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return st, {"s_per_sweep": times, "launches": read_counts(),
                "plain_scan_calls": dict(plain), "rows_sent": st.rows_sent,
                "cut": st.plan.cut, "Nloc": st.plan.Nloc,
                "Eloc": st.plan.Eloc}


def phase_halo_sis_rrg_1rank():
    """The sketch D=10 bench state swept :data:`HALO_SWEEPS` times by
    ``bp_sweep`` and, from the same state, by ``halo_sweep`` on this
    process as the one rank of an NCCL group (no cut: nothing exchanged),
    each sweep timed; beliefs within 1e-5 and the free energy within 1e-4
    (relative) of the ``bp_sweep``s', the same launches by kernel, no
    plain scan.  Returns the reference beliefs and free energy."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.parallel import (
        halo_beliefs, halo_bethe_free_energy, halo_mpbp)
    t_phase = time.perf_counter()
    trunc = tp.TruncBond(10)
    bp0 = bench_state(10, torch.float32)
    ref, times = bp0, []
    reset_counts()
    for _ in range(HALO_SWEEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = tp.bp_sweep(ref, trunc, method="sketch")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    bp_launches = read_counts()
    b_ref, f_ref = tp.beliefs(ref), float(tp.bethe_free_energy(ref))
    with one_rank_group("nccl"):
        st = halo_mpbp(bp0)
        st, res = halo_sweeps(st, trunc)
        b, f = halo_beliefs(st, bp0.graph), float(halo_bethe_free_energy(st))
    res.update(backend="nccl", ranks=1, sweeps=HALO_SWEEPS,
               bp_sweep_s_per_sweep=times, bp_sweep_launches=bp_launches,
               belief_diff=float((b - b_ref).abs().max()), f=f, f_ref=f_ref,
               f_diff=abs(f - f_ref), seconds=time.perf_counter() - t_phase)
    emit("halo_sis_rrg_1rank", **res)
    check(not any(res["plain_scan_calls"].values())
          and res["launches"] == bp_launches,
          f"halo_sis_rrg_1rank: launches {res['launches']} against "
          f"bp_sweep's {bp_launches}, plain {res['plain_scan_calls']}")
    check(res["belief_diff"] <= TOL_HALO_BELIEFS
          and res["f_diff"] <= TOL_HALO_F_REL * max(1.0, abs(f_ref)),
          f"halo_sis_rrg_1rank: off bp_sweep: {res}")
    return {"beliefs": b_ref.cpu().numpy(), "f": f_ref,
            "launches": bp_launches}


def observed_tree(n=INFER_N, device="cuda"):
    """The observed inference tree of ``inference_tree_run``: the same
    graph, model and 256 soft observations (drawn from the prior with the
    same seeds, so its ``phi`` is that phase's), on the card (``n`` and
    ``device``: a smaller tree elsewhere, for a rehearsal)."""
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import sampling
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    g = tp.random_tree(n, np.random.default_rng(0))
    bp = mpbp_sis(SIS(g, lam=0.2, rho=0.1, T=INFER_T, gamma=0.3),
                  D=INFER_D, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    bpo, _, _ = sampling.draw_node_observations(
        bp, nobs=INFER_NOBS, rng=np.random.default_rng(1),
        softinf=INFER_SOFTINF, generator=gen)
    return bpo


def _digest(X):
    import hashlib
    return hashlib.sha256(X.contiguous().cpu().numpy().tobytes()).hexdigest()


def halo_smc_rank(rank, world, ref_path):
    """One of the gloo ranks of :func:`phase_halo_smc_2rank`: the bench
    state's halo sweeps (BFS partition) held to the single-device
    sweeps' beliefs and free energy, then sharded SMC on the observed tree
    held to the single-device run's rows of this rank; returns the
    record."""
    import torch
    import torch.distributed as dist
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import smc
    from matrixproductbp_tpu_torch.parallel import (
        halo_beliefs, halo_bethe_free_energy, halo_mpbp)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = np.load(ref_path)
    bp0 = bench_state(10, torch.float32)
    g = bp0.graph
    t0 = time.perf_counter()
    st = halo_mpbp(bp0)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    del bp0
    st, res = halo_sweeps(st, tp.TruncBond(10))
    b = halo_beliefs(st, g).cpu().numpy()
    f = float(halo_bethe_free_energy(st))
    cells = st.msg_cores[0].numel() + 1          # cores and logz a row
    res.update(setup_s=setup,
               bytes_sent_per_sweep=st.rows_sent * cells * 4,
               belief_diff=float(np.abs(b - ref["beliefs"]).max()),
               f=f, f_diff=abs(f - float(ref["f"])))
    del st
    torch.cuda.empty_cache()

    bpo = observed_tree()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sms = smc.smc_sample(bpo, INFER_PARTICLES, generator=gen,
                         group=dist.group.WORLD)
    torch.cuda.synchronize()
    rows = smc.particle_range(INFER_PARTICLES, rank, world)
    lw_ref = torch.as_tensor(ref["smc_logw"][rows.start:rows.stop])
    lw = sms.logw.cpu()
    res["smc"] = {
        "seconds": time.perf_counter() - t0, "rows": [rows.start, rows.stop],
        "X_equal": _digest(sms.X) == str(ref["smc_digests"][rank]),
        "rows_differing": int((row_signature(sms.X).cpu().numpy()
                               != ref["smc_rowsig"][rows.start:rows.stop])
                              .sum()),
        "logw_max_rel": float(((lw - lw_ref).abs()
                               / lw_ref.abs().clamp(min=1e-300)).max()),
        "log_evidence": sms.log_evidence}
    return res


def row_signature(X):
    """One int64 a trajectory of ``X [P, N, T1]``: its states against
    fixed random weights (rows differ where the signatures do)."""
    import torch
    w = torch.randint(1, 2 ** 31, X.shape[1:], dtype=torch.int64,
                      generator=torch.Generator().manual_seed(7))
    return (X.long() * w.to(X.device)).sum(dim=(1, 2))


def phase_halo_smc_2rank(ref):
    """``halo_sis_rrg_2rank`` and ``smc_sharded``: two gloo ranks (spawned:
    this process has initialised CUDA) sharing the card.  Each takes its
    block of the bench state by the BFS partition and sweeps it
    :data:`HALO_SWEEPS` times (the cut, the bytes exchanged a sweep, each
    sweep timed), gathered beliefs within 1e-5 and the free energy within
    1e-4 (relative) of the single-device sweeps' (``ref``), each rank's
    launches those of one device, no plain scan.  Then SMC with
    :data:`INFER_PARTICLES` particles on the observed inference tree, split
    over the two ranks, against the same run on one device: ``X`` equal
    (sha256 of each rank's rows; rows by signature), ``logw`` within rtol
    1e-6, the same log-evidence."""
    import os
    import tempfile
    import torch
    from matrixproductbp_tpu_torch import smc
    from matrixproductbp_tpu_torch.parallel import spawn_ranks
    t_phase = time.perf_counter()
    bpo = observed_tree()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sms = smc.smc_sample(bpo, INFER_PARTICLES, generator=gen)
    torch.cuda.synchronize()
    smc_s = time.perf_counter() - t0
    blocks = [smc.particle_range(INFER_PARTICLES, r, 2) for r in range(2)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.npz")
        np.savez(path, beliefs=ref["beliefs"], f=ref["f"],
                 smc_logw=sms.logw.cpu().numpy(),
                 smc_rowsig=row_signature(sms.X).cpu().numpy(),
                 smc_digests=np.array([_digest(sms.X[r.start:r.stop])
                                       for r in blocks]))
        lz_ref = sms.log_evidence
        del sms, bpo
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(halo_smc_rank, 2, (path,), backend="gloo",
                            threads=max(1, (os.cpu_count() or 2) // 2),
                            store_dir=d, timeout=600)
        spawn_s = time.perf_counter() - t0
    halo = {k: [r[k] for r in ranks] for k in ranks[0] if k != "smc"}
    halo.update(backend="gloo", ranks=2, sweeps=HALO_SWEEPS,
                cut=ranks[0]["cut"], f_ref=ref["f"],
                bytes_per_sweep=sum(halo["bytes_sent_per_sweep"]),
                bp_sweep_launches=ref["launches"], spawn_s=spawn_s)
    emit("halo_sis_rrg_2rank", **halo)
    sm = {"particles": INFER_PARTICLES, "ranks": [r["smc"] for r in ranks],
          "single_device_s": smc_s, "log_evidence": lz_ref,
          "tol_rtol": TOL_SMC_SHARDED_RTOL,
          "seconds": time.perf_counter() - t_phase}
    emit("smc_sharded", **sm)
    for r in ranks:
        check(not any(r["plain_scan_calls"].values())
              and r["launches"] == ref["launches"],
              f"halo_sis_rrg_2rank: launches {r['launches']} against one "
              f"device's {ref['launches']}, plain {r['plain_scan_calls']}")
        check(r["belief_diff"] <= TOL_HALO_BELIEFS
              and r["f_diff"] <= TOL_HALO_F_REL * max(1.0, abs(ref["f"])),
              f"halo_sis_rrg_2rank: off bp_sweep: {halo}")
    check(sum(halo["rows_sent"]) == halo["cut"] > 0,
          f"halo_sis_rrg_2rank: rows sent {halo['rows_sent']}, cut "
          f"{halo['cut']}")
    for r in sm["ranks"]:
        check(r["X_equal"] and r["rows_differing"] == 0
              and r["logw_max_rel"] <= TOL_SMC_SHARDED_RTOL
              and abs(r["log_evidence"] - lz_ref)
              <= TOL_SMC_SHARDED_RTOL * max(1.0, abs(lz_ref)),
              f"smc_sharded: off the single-device run: {sm}")


def phase_native_graph():
    """The host build of ``erdos_renyi_gnm(10^5, 1.5 10^5)``'s arrays
    (the scale phase's graph) by the C++ builder and by numpy, in turns
    (native, numpy, numpy, native), beside the time g++ takes to build the
    library (a fresh build into a new directory under ``_build/``: the
    run's own copy was built at its first use); the arrays equal."""
    import os
    import shutil
    import tempfile
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import native
    from matrixproductbp_tpu_torch.ops.build import BUILD_DIR
    check(native.load() is not None,
          "native_graph: the C++ builder did not build")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fresh = tempfile.mkdtemp(prefix="native_timing_", dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        native._compile(os.path.join(fresh, "libgraphbuild.so"))
        build_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(fresh, ignore_errors=True)
    g = tp.erdos_renyi_gnm(NATIVE_N, NATIVE_M, np.random.default_rng(0))
    pairs = np.stack([g.edge_src, g.edge_dst], 1)[g.edge_src < g.edge_dst]
    times, graphs = {True: [], False: []}, {}
    for nat in (True, False, False, True):
        t0 = time.perf_counter()
        graphs[nat] = tp.graph_from_edges(NATIVE_N, pairs, native=nat)
        times[nat].append(time.perf_counter() - t0)
    same = all(np.array_equal(getattr(graphs[True], k),
                              getattr(graphs[False], k))
               for k in ("edge_src", "edge_dst", "rev_edge", "in_edges",
                         "in_mask", "nbr", "degree"))
    res = {"N": NATIVE_N, "E": g.E, "build_s": build_s,
           "native_s": times[True], "numpy_s": times[False],
           "arrays_equal": same}
    emit("native_graph", **res)
    check(same, "native_graph: native and numpy arrays differ")


def phase_roofline():
    """``utils.profiling.roofline_report`` on the sketch D=10 bench state
    (3 timed sweeps): the FLOP model's rate and its share of the H100's
    fp32 peak."""
    import math
    import torch
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.utils.profiling import roofline_report
    rep = roofline_report(bench_state(10, torch.float32), tp.TruncBond(10),
                          method="sketch", reps=3)
    emit("roofline", D=10, **rep)
    check(math.isfinite(rep["h100_f32_utilization"])
          and rep["sweep_seconds"] > 0, f"roofline: {rep}")


def tv_kernel_times(tv, reps=10):
    """The merge F kernels of the time-varying sweeps at their bench shape
    ([8192, 15], one random ``Pyy`` a step): the staged kernel at D=10 and
    the cluster kernel at D=20, against the plain scan on the same inputs,
    CUDA events over ``reps`` launches, beside the bound and the plain
    scan's time; ``launches`` are the time-varying sweeps'."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dev = torch.device("cuda")
    rows = []
    for D, variant, name in ((10, "staged", "merge_f_staged_tv"),
                             (20, "cluster", "merge_f_cluster_tv_d20")):
        md = merge_dims(D)
        S = BENCH_T
        L1, B1, Th, _, Phi, S_init = merge_inputs(
            2 * BENCH_N, S, **md, dtype=torch.float32, device=dev,
            seed=21 + D)
        g = torch.Generator(device="cpu").manual_seed(22 + D)
        Y, q = md["Y"], md["q"]
        Pyy = torch.rand((S, Y, Y, Y, q), generator=g,
                         dtype=torch.float64).to(dev, torch.float32)
        Ws = fs.merge_wscan(L1, B1, Th)
        check(fs.merge_f_geometry(*md.values(), torch.float32, None,
                                  True)[0] == variant,
              f"D={D} time-varying merge F: not the {variant} kernel")

        def kern():
            return fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S_init)

        def plain():
            return fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S_init)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(out, ref)
        check(err <= TOL_F32_REL * scale,
              f"{name} disagrees with its plain version: {err} > "
              f"{TOL_F32_REL} * {scale}")
        flops, nbytes = work_merge_f(2 * BENCH_N, S, **md, esize=4)
        nbytes += 4 * (S - 1) * Y * Y * Y * q      # a Pyy a step
        bms, by = bound_ms(flops, nbytes)
        src, line = MERGE_F_ROWS[variant][1:]
        rows.append({
            "name": name, "route": "cuda",
            "source": "matrixproductbp_tpu_torch/csrc/" + src,
            "replaces": "matrixproductbp_tpu/ops/fused_stta.py" + line,
            "launches": tv[D]["merge_f_tv_launches"][variant],
            "max_abs_err": err, "ms": time_cuda(kern, reps),
            "plain_ms": time_cuda(plain, 2), "bound_ms": bms,
            "bound_by": by, "library_ms": None, "flops": flops,
            "bytes": nbytes, "D": D, "pyy_step": Y * Y * Y * q,
            "launches_from": f"tv_sis_rrg_d{D}"})
        emit(f"kernel_time_tv_d{D}", **rows[-1])
        del out, ref, L1, B1, Th, Phi, S_init, Ws, Pyy
    return rows


def time_cuda(fn, n):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


#: each merge kernel's name in the ``kernels`` record, its source and the
#: TPU body it stands for (the TPU ran the lean merge F body at D=20)
MERGE_F_ROWS = {
    "staged": ("merge_f_staged", "merge_f_staged.cu", ":281"),
    "cluster": ("merge_f_cluster", "merge_f_cluster.cu", ":382"),
    "base": ("merge_f", "stta_scans.cu", ":281"),
    "wide": ("merge_f_wide", "merge_wide.cu", ":382"),
    "streamed": ("merge_f_streamed", "merge_streamed.cu", ":382"),
}
MERGE_W_ROWS = {
    "staged": ("merge_w_staged", "merge_w_staged.cu", ":231"),
    "base": ("merge_w", "stta_scans.cu", ":231"),
    "wide": ("merge_w_wide", "merge_wide.cu", ":231"),
    "streamed": ("merge_w_streamed", "merge_streamed.cu", ":231"),
}


def in_turns(kernels, reps):
    """{variant: [ms, ms]}: the kernels {variant: fn} timed in turns (a, b,
    b, a) on the same inputs."""
    turns = {v: [] for v in kernels}
    for v in list(kernels) + list(kernels)[::-1]:
        turns[v].append(time_cuda(kernels[v], reps))
    return turns


def phase_kernel_times(launches, D=10, reps=10):
    """Each scan kernel at the bench shape of bond D (the 8192-instance merge;
    the MPEM3 kernels by :func:`mpem3_kernel_times`), CUDA events over
    ``reps`` launches, beside its bound and its plain version's time;
    ``launches`` are those of the sketch sweep at that D.
    ``merge_f_kernel`` and the merge F kernel the sweep takes (staged at
    D=10, cluster at D=20) run on the same inputs, timed in turns (picked,
    base, base, picked); so do ``merge_w_kernel`` and the merge W kernel
    the sweep takes."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dev = torch.device("cuda")
    S = BENCH_T
    md = merge_dims(D)
    L1, B1, Th, Pyy, Phi, S_init = merge_inputs(
        2 * BENCH_N, S, **md, dtype=torch.float32, device=dev, seed=11)
    Ws = fs.merge_wscan(L1, B1, Th)
    shape = tuple(md.values())
    w_picked = fs.merge_w_geometry(*shape[:5], torch.float32)[0]
    merge_w = {v: (lambda v=v: fs.merge_wscan(L1, B1, Th, _variant=v))
               for v in dict.fromkeys((w_picked, "base"))}
    cases = [
        (MERGE_W_ROWS[v][0], kern, lambda: fs.merge_wscan_plain(L1, B1, Th),
         work_merge_w(2 * BENCH_N, S, **md, esize=4), MERGE_W_ROWS[v][1],
         MERGE_W_ROWS[v][2]) for v, kern in merge_w.items()]
    picked = fs.merge_f_geometry(*shape, torch.float32)[0]
    merge_f = {v: (lambda v=v: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S_init,
                                              _variant=v))
               for v in (picked, "base")}
    turns = {MERGE_F_ROWS[v][0]: t
             for v, t in in_turns(merge_f, reps).items()}
    turns.update({MERGE_W_ROWS[v][0]: t
                  for v, t in in_turns(merge_w, reps).items()})
    cases[len(merge_w):len(merge_w)] = [
        (MERGE_F_ROWS[v][0], kern,
         lambda: fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S_init),
         work_merge_f(2 * BENCH_N, S, **md, esize=4), MERGE_F_ROWS[v][1],
         MERGE_F_ROWS[v][2]) for v, kern in merge_f.items()]
    rows = []
    for name, kern, plain, (flops, nbytes), src, line in cases:
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(tuple(out) if isinstance(out, tuple) else out,
                             tuple(ref) if isinstance(ref, tuple) else ref)
        check(err <= TOL_F32_REL * scale,
              f"{name} at D={D} disagrees with its plain version: {err} > "
              f"{TOL_F32_REL} * {scale}")
        ms_runs = turns.get(name) or [time_cuda(kern, reps)]
        plain_ms = time_cuda(plain, 2)
        bms, by = bound_ms(flops, nbytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": "matrixproductbp_tpu_torch/csrc/" + src,
            "replaces": "matrixproductbp_tpu/ops/fused_stta.py" + line,
            "launches": launches[name], "max_abs_err": err,
            "ms": sum(ms_runs) / len(ms_runs), "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "flops": flops, "bytes": nbytes, "D": D,
            "launches_from": f"main_d{D}",
            **({"ms_turns": ms_runs} if name in turns else {})})
        emit(f"kernel_time_d{D}", **rows[-1])
        del out, ref
    return rows + mpem3_kernel_times(launches, D, reps)


#: the TPU body each MPEM3 scan stands for
MPEM3_LINES = {"w": ":508", "f": ":545"}


def mpem3_kernel_times(launches, D, reps, qi=2, launches_from=None,
                       S=BENCH_T, batches=(BENCH_N * BENCH_DEG, BENCH_N)):
    """The staged MPEM3 W and F kernels (the sweep's) and the first designs
    (``mpem3_w_kernel``, ``mpem3_f_kernel``) at both conversions of the
    sketch sweep at bond D and q = ``qi`` (2: SIS, 3: SIRS), on the same
    inputs, timed in turns (staged, base, base, staged): the message
    conversion (``batches[0]`` instances, [12288, 15] at the bench shape;
    the row's own numbers) and the belief conversion (``batches[1]``,
    [4096, 15]; under ``beliefs``); each beside its bound and its plain
    version's time.  One row a scan, named after the staged kernel; the
    first design's times as ``base_ms``."""
    import torch
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    dev = torch.device("cuda")
    rows = {}
    for Bn, qj, key in ((batches[0], qi, None), (batches[1], 1, "beliefs")):
        pd = mpem3_dims(D, qi=qi, qj=qj)
        Bm, Psi, PhiM, SiM = mpem3_inputs(Bn, S, **pd, dtype=torch.float32,
                                          device=dev, seed=12 + qj)
        WsM = fs.mpem3_wscan_plain(Bm, Psi)
        scans = {
            "w": ({v: (lambda v=v: fs.mpem3_wscan(Bm, Psi, _variant=v))
                   for v in ("staged", "base")},
                  lambda: fs.mpem3_wscan_plain(Bm, Psi),
                  work_mpem3_w(Bn, S, **pd, esize=4)),
            "f": ({v: (lambda v=v: fs.mpem3_fscan(Bm, PhiM, WsM, SiM,
                                                  _variant=v))
                   for v in ("staged", "base")},
                  lambda: fs.mpem3_fscan_plain(Bm, PhiM, WsM, SiM),
                  work_mpem3_f(Bn, S, **pd, esize=4))}
        for kern, (runs, plain, (flops, nbytes)) in scans.items():
            turns = in_turns(runs, reps)
            out, ref = runs["staged"](), plain()
            base_out = runs["base"]()
            torch.cuda.synchronize()
            err, scale = max_err(out, ref)
            base_err, _ = max_err(base_out, ref)
            check(max(err, base_err) <= TOL_F32_REL * scale,
                  f"MPEM3 {kern} kernels at [{Bn}, {S}], D={D}, q={qi}, "
                  f"qj={qj} disagree with the plain scan: staged {err}, "
                  f"base {base_err} > {TOL_F32_REL} * {scale}")
            bms, by = bound_ms(flops, nbytes)
            ms = {v: sum(t) / len(t) for v, t in turns.items()}
            rec = {"B": Bn, "S": S, "qj": qj, "layout": mpem3_layout_of(qj),
                   "max_abs_err": err, "ms": ms["staged"],
                   "ms_turns": turns["staged"],
                   "plain_ms": time_cuda(plain, 2), "bound_ms": bms,
                   "bound_by": by, "base_ms": ms["base"],
                   "base_ms_turns": turns["base"],
                   "base_max_abs_err": base_err, "flops": flops,
                   "bytes": nbytes}
            if key is None:
                rows[kern] = {
                    "name": f"mpem3_{kern}_staged", "route": "cuda",
                    "source": "matrixproductbp_tpu_torch/csrc/mpem3_staged.cu",
                    "replaces": "matrixproductbp_tpu/ops/fused_stta.py"
                                + MPEM3_LINES[kern],
                    "launches": launches[f"mpem3_{kern}_staged"],
                    "library_ms": None, **rec,
                    "base_source": "matrixproductbp_tpu_torch/csrc/"
                                   "stta_scans.cu",
                    "D": D, "q": qi,
                    "launches_from": launches_from or f"main_d{D}"}
            else:
                rows[kern][key] = rec
            del out, ref, base_out
        del Bm, Psi, PhiM, SiM, WsM
    for r in rows.values():
        emit(f"kernel_time_d{D}", **r)
    return list(rows.values())


def phase_linalg_kernel_times(launches, D=10, reps=10):
    """CholQR at the randomized merge's bench shape ([8192, s*Y*q, s], s =
    2D) and the Jacobi eigensolver at the message conversion's ([12288, k,
    k], k = 2D, the Gram of a Gaussian [2k, k] half of them rank-deficient),
    CUDA events over ``reps`` launches, beside the bound, the plain
    version's time and one PyTorch call's (torch.linalg.qr: the same thin QR
    up to column signs; torch.linalg.eigh: the same eigendecomposition).
    The staged CholQR kernel (the sweep's) and ``cholqr_kernel`` are timed
    in turns on the same inputs (staged, base, base, staged), and beside
    them the composed library route ``kernels.cholqr_reference`` (several
    calls: a batched GEMM, ``torch.linalg.cholesky`` and
    ``solve_triangular``)."""
    import torch
    from matrixproductbp_tpu_torch.ops import kernels, smallsvd
    from matrixproductbp_tpu_torch.ops.smallalg import cholqr_unrolled
    dev = torch.device("cuda")
    s = 2 * D
    g = torch.Generator(device="cpu").manual_seed(13)
    A = torch.randn((2 * BENCH_N, 4 * s, s), generator=g).to(dev)
    Bm = BENCH_N * BENCH_DEG
    G = gram_inputs(Bm, s, dev, 14)
    cq = {v: (lambda v=v: kernels.cholqr(A, _variant=v))
          for v in ("staged", "base")}
    turns = in_turns(cq, reps)
    rows = []
    cases = [
        ("cholqr_staged", cq["staged"], lambda: cholqr_unrolled(A),
         lambda: torch.linalg.qr(A),
         bound_ms(*work_cholqr(2 * BENCH_N, 4 * s, s, 4), FP64_FLOP_PER_S),
         "matrixproductbp_tpu_torch/csrc/cholqr_staged.cu",
         "matrixproductbp_tpu/ops/kernels.py:61",
         {"shape": list(A.shape), "dtype": "float32",
          "ms_turns": turns["staged"],
          "base_ms": sum(turns["base"]) / len(turns["base"]),
          "base_ms_turns": turns["base"],
          "base_source": "matrixproductbp_tpu_torch/csrc/cholqr.cu",
          "composed_ms": time_cuda(
              lambda: kernels.cholqr_reference(A, eps=1e-6), 2)}),
        ("jacobi_eigh", lambda: smallsvd.eigh_desc(G),
         lambda: smallsvd.eigh_desc_plain(G), lambda: torch.linalg.eigh(G),
         bound_ms(*work_eigh(Bm, s), FP64_FLOP_PER_S),
         "matrixproductbp_tpu_torch/csrc/jacobi_eigh.cu",
         "matrixproductbp_tpu/ops/tensortrain.py:420",
         {"shape": list(G.shape), "dtype": "float64"}),
    ]
    for name, kern, plain, lib, (bms, by), src, line, extra in cases:
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if name == "cholqr_staged":
            err, _ = max_err(tuple(out), tuple(ref))
            ms = sum(extra["ms_turns"]) / len(extra["ms_turns"])
        else:   # eigenvectors are fixed up to sign: compare eigenvalues
            err, _ = max_err(out[0], ref[0])
            ms = time_cuda(kern, reps)
        slow = D > 10 and name == "jacobi_eigh"   # k > 32: one per launch
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": time_cuda(plain, 1 if slow else 2),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_cuda(lib, 1 if slow else 2), **extra})
        emit(f"kernel_time_d{D}", **rows[-1])
        del out, ref
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    import matrixproductbp_tpu_torch  # noqa: F401  (fails outside a checkout)
    info = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    phase_kernels()
    phase_accuracy()
    launches, bp_d10 = phase_main_d10()
    phase_profile(bp_d10)
    del bp_d10
    launches_d20, bp_d20 = phase_main_d20()
    phase_profile(bp_d20)
    del bp_d20
    rlaunches, bp_r10 = phase_main_randomized(10, TIMED_RANDOMIZED_D10)
    phase_profile(bp_r10, method="randomized")
    del bp_r10
    rlaunches_d20, bp_r20 = phase_main_randomized(20, TIMED_RANDOMIZED_D20)
    phase_profile(bp_r20, method="randomized")
    del bp_r20
    phase_randomized_vs_plain_d20()
    phase_karate()
    gres = phase_glauber_er()
    gres18 = phase_glauber_er_d18()
    f64_launches = phase_merge_reach_vs_plain(gres18)
    sres = {D: phase_sirs_rrg(D) for D in (10, 20)}
    phase_chunked_vs_monolithic()
    phase_glauber_seidel()
    phase_sis_er_seidel()
    phase_inference_tree()
    tv = phase_tv_sis_rrg()
    phase_periodic_sis_rrg()
    phase_svd_driver_f32()
    phase_modes_accuracy()
    scale = phase_scale_er_1e5()
    phase_stationary_modes()
    phase_checkpoint_bench()
    phase_halo_smc_2rank(phase_halo_sis_rrg_1rank())
    phase_native_graph()
    phase_roofline()
    # the kernels record: every kernel that a main path launches, each at
    # the bench shape of the sweep that launches it (merge_f_kernel, which
    # no main path takes any more, is timed in its phase lines alone)
    rows = [r for r in phase_kernel_times(launches) if r["launches"] > 0]
    rows += phase_linalg_kernel_times(rlaunches)
    # at D=20, the merge kernels the D=20 sweep takes (a second merge W
    # row, named apart from the D=10 one) and the staged MPEM3 kernels (a
    # second row each)
    for r in phase_kernel_times(launches_d20, D=20, reps=3):
        if r["name"] == "merge_f_cluster":
            rows.append(r)
        elif r["name"].startswith(("merge_w", "mpem3")) and r["launches"] > 0:
            rows.append({**r, "name": r["name"] + "_d20"})
    # at D=20, the staged CholQR kernel (a second row)
    rows += [{**r, "name": r["name"] + "_d20"}
             for r in phase_linalg_kernel_times(rlaunches_d20, D=20, reps=3)
             if r["name"] == "cholqr_staged"]
    # the new shapes of the banded and the q = 3 paths: the merge kernels at
    # the Glauber sweep's K=8 bucket (Y=9), and the staged MPEM3 kernels at
    # the SIRS D=10 sweep's conversions (q = 3)
    rows += glauber_kernel_times(gres)
    # the wide and the streamed merge kernels, in turns: the Glauber D=18
    # sweep's K4, K8 and K9 buckets, and the f64 D=20 sketch merge
    rows += streamed_kernel_times(gres18, f64_launches)
    for r in mpem3_kernel_times(sres[10]["launches"], 10, 10, qi=3,
                                launches_from="sirs_rrg_d10"):
        rows.append({**r, "name": r["name"] + "_q3"})
    # the scale sweep's shapes (T=50, a chunk of its largest bucket)
    rows += scale_kernel_times(scale)
    # the merge F kernels at the time-varying sweeps' shapes (one Pyy a
    # step): staged at D=10, cluster at D=20
    rows += tv_kernel_times(tv)
    emit("done", seconds=time.perf_counter() - t0)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
