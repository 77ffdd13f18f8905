"""Roofline accounting for the BP sweep.

Counterpart of ``matrixproductbp_tpu/utils/profiling.py``: an analytic FLOP
model of one synchronous sweep (the cavity merges' contractions and the
sketch or decomposition passes; the same formula as the JAX package's), and
a measured report of the sweep's time and achieved FLOP/s on the state's
device, against the H100's fp32 peak outside the tensor cores.
"""
from __future__ import annotations

import time

import torch

__all__ = ["sweep_flops_estimate", "roofline_report", "H100_F32_FLOPS"]

#: NVIDIA H100 SXM fp32 peak outside the tensor cores (data sheet, 700 W);
#: used only for a utilization
H100_F32_FLOPS = 67e12


def sweep_flops_estimate(bp, method: str = "sketch") -> float:
    """Rough FLOPs of one sweep (contractions only, constants dropped)."""
    g = bp.graph
    N, K, T1 = g.N, g.dmax, bp.T + 1
    D = bp.D
    q = bp.q
    Y = bp.tables.Y
    P = Y * q
    n_merge = max(3 * K - 5, 1)
    if method == "sketch":
        s = D + 4
        # sketch scans: per t, einsums ~ s * D^2 * D * P twice + solves
        per_merge = T1 * (4 * s * D ** 3 * P) + T1 * (2 * s * s * D * P)
        per_pipe = T1 * (4 * s * D ** 2 * q ** 3) + T1 * (2 * s * s * D * q)
    else:
        # deterministic: Kronecker merge (D^4 P) + QR/SVD sweeps O(T D^6 P)
        per_merge = T1 * (2 * D ** 4 * P + 4 * (D * D) ** 2 * (D * D) * P)
        per_pipe = T1 * (8 * (q * D) ** 2 * D * q ** 2)
    return float(N * (n_merge * per_merge + (K + 1) * per_pipe))


def _sync(bp):
    if bp.device.type == "cuda":
        torch.cuda.synchronize(bp.device)


def roofline_report(bp, trunc, method: str = "sketch", reps: int = 3) -> dict:
    """Seconds a sweep takes on the state's device (the mean of ``reps``
    timed sweeps after one untimed one, the device synchronized around
    them) and the FLOP/s that :func:`sweep_flops_estimate` gives at that
    time.  ``h100_f32_utilization`` is against :data:`H100_F32_FLOPS`, and
    only a CUDA state reports it."""
    from ..bp import bp_sweep

    cur = bp_sweep(bp, trunc, method=method)
    _sync(bp)
    t0 = time.perf_counter()
    for _ in range(reps):
        cur = bp_sweep(cur, trunc, method=method)
    _sync(bp)
    dt = (time.perf_counter() - t0) / reps

    flops = sweep_flops_estimate(bp, method)
    return {
        "device": str(bp.device),
        "sweep_seconds": dt,
        "edge_updates_per_s": bp.graph.E / dt,
        "est_flops_per_sweep": flops,
        "achieved_flops_per_s": flops / dt,
        "h100_f32_utilization": (flops / dt / H100_F32_FLOPS
                                 if bp.device.type == "cuda" else None),
    }
