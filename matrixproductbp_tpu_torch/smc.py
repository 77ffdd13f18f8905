"""Sequential Monte Carlo (SMC) for the soft-margin target.

Counterpart of ``matrixproductbp_tpu/smc.py`` on one device.  The soft-
margin sampler draws from the prior dynamics and weights by the
observations (``sampling.py``); under strong observations those weights
degenerate exponentially in N*T.  SMC weights each time step's particles
incrementally (phi and same-time psi factors) and, when the effective sample
size falls below ``ess_frac * P``, resamples the whole population
systematically.  Particles are the leading axis of ``X [P, N, T1]`` on the
state's device; each step draws them as batches through
``factors.transition_probs``.  The ESS is read on the host once a step.

Caveat (standard SMC): after a resampling event the early history of the
surviving trajectories is the degenerate-genealogy smoother; final-time and
recent-time estimates are the good ones.  With no observations it never
resamples and reduces to the prior sampler.

The JAX package shards the particles over a device mesh; the port's sharded
SMC waits for the multi-device work (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import math

import torch

from .bp import MPBP
from .sampling import (SoftMarginSampler, _STEP_CELLS, _default_generator,
                       _draw, _log_prior0, _neighbours, _obs_logw, _prior,
                       _step)

__all__ = ["smc_sample", "systematic_resample_indices",
           "effective_sample_size"]


def effective_sample_size(logw) -> torch.Tensor:
    """Kish ESS = (sum w)^2 / sum w^2, computed stably in log-domain."""
    logw = torch.as_tensor(logw)
    w = torch.exp(logw - logw.max())
    return w.sum() ** 2 / torch.clamp((w * w).sum(), min=1e-300)


def systematic_resample_indices(logw, u) -> torch.Tensor:
    """Systematic (stratified, one-uniform) resampling: P indices with
    counts proportional to the normalized weights; ``u`` uniform in [0, 1)."""
    logw = torch.as_tensor(logw)
    P = logw.shape[0]
    w = torch.exp(logw - logw.max())
    cdf = torch.cumsum(w / w.sum(), dim=0)
    u = torch.as_tensor(u, dtype=w.dtype, device=w.device)
    pts = (u + torch.arange(P, dtype=w.dtype, device=w.device)) / P
    return torch.searchsorted(cdf, pts).clamp(max=P - 1)


def smc_sample(bp: MPBP, nparticles: int, generator=None, mesh=None,
               axis: str = "p", ess_frac: float = 0.5) -> SoftMarginSampler:
    """Draw ``nparticles`` weighted trajectories of the reweighted dynamics
    with adaptive systematic resampling, on the state's device.  Returns a
    :class:`SoftMarginSampler` whose weights are the residual (post-
    resampling) importance weights and whose ``log_evidence`` estimates
    log Z.  ``generator``: a ``torch.Generator`` on the device (default one
    seeded with 0), in place of the JAX package's key."""
    if mesh is not None:
        raise NotImplementedError("sharded SMC over a device mesh is not "
                                  "ported yet (ROADMAP Queue 1 item 9)")
    gen = _default_generator(bp, generator)
    N, T1 = bp.N, bp.T + 1
    P = nparticles
    nbr = _neighbours(bp)
    n = max(1, _STEP_CELLS // N)
    p0 = _prior(bp)
    x = torch.cat([_draw(p0.expand(min(n, P - lo), N, p0.shape[1]), gen)
                   for lo in range(0, P, n)])
    logw = _obs_logw(bp, x, 0) - _log_prior0(bp, x)
    X = torch.zeros((P, N, T1), dtype=torch.int32, device=bp.device)
    X[:, :, 0] = x
    lztot = 0.0
    for t in range(1, T1):
        x = torch.cat([_step(bp, nbr, x[lo:lo + n], gen, t - 1)
                       for lo in range(0, P, n)])
        X[:, :, t] = x
        logw = logw + _obs_logw(bp, x, t)
        if float(effective_sample_size(logw)) < ess_frac * P:
            # absorb the current weights into the running log-evidence
            m = logw.max()
            lztot += float(m + torch.log(torch.exp(logw - m).mean()))
            u = torch.rand((), generator=gen, dtype=logw.dtype,
                           device=logw.device)
            idx = systematic_resample_indices(logw, u)
            X, x = X[idx], x[idx]
            logw = torch.zeros_like(logw)
    sms = SoftMarginSampler(bp, X, logw)
    sms.log_evidence = float(lztot + torch.logsumexp(logw, dim=0)
                             - math.log(P))
    return sms
