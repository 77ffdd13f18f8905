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

With ``group`` (a ``torch.distributed`` process group), the particles are
split over its ranks in contiguous blocks (:func:`particle_range`), where
the JAX package shards them over a device mesh.  Each rank draws every
batch's uniforms from the one generator stream and uses its own particles'
rows, so the ranks together draw what one device draws.  The ESS, the
resampling indices and the log-evidence come from the weights gathered to
every rank (with one shared uniform); a resampling step then sends each
rank only the trajectories it needs (``all_to_all_single`` with split
sizes), never the whole population.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .bp import MPBP
from .sampling import (SoftMarginSampler, _STEP_CELLS, _default_generator,
                       _draw, _log_prior0, _neighbours, _obs_logw, _prior,
                       _step)

__all__ = ["smc_sample", "systematic_resample_indices",
           "effective_sample_size", "particle_range"]


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


def particle_range(nparticles: int, rank: int, world: int) -> range:
    """The particles rank ``rank`` of ``world`` holds in a sharded
    :func:`smc_sample`: a contiguous block of the single-device run's."""
    return range(rank * nparticles // world, (rank + 1) * nparticles // world)


class _Shards:
    """The particle blocks of a group's ranks (one block: no group)."""

    def __init__(self, P: int, group, device):
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        if P < self.world:
            raise ValueError(f"{P} particles cannot be split over "
                             f"{self.world} ranks")
        self.ranges = [particle_range(P, r, self.world)
                       for r in range(self.world)]
        self.mine = self.ranges[self.rank]
        self.starts = torch.tensor([r.start for r in self.ranges],
                                   device=device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x``, in particle order, on every rank."""
        if self.group is None:
            return x
        n = max(len(r) for r in self.ranges)
        pad = x.new_zeros((n,) + x.shape[1:])
        pad[:len(x)] = x
        parts = [torch.empty_like(pad) for _ in range(self.world)]
        dist.all_gather(parts, pad, group=self.group)
        return torch.cat([p[:len(r)] for p, r in zip(parts, self.ranges)])

    def take(self, X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (global particle ids, every rank's) of the particles
        ``X`` the ranks hold, each rank receiving its own block's rows."""
        if self.group is None:
            return X[idx]
        owner = torch.searchsorted(self.starts, idx, right=True) - 1
        dest = torch.searchsorted(
            self.starts, torch.arange(len(idx), device=idx.device),
            right=True) - 1
        send = owner == self.rank                 # rows this rank holds
        send_splits = torch.bincount(dest[send], minlength=self.world)
        mine = slice(self.mine.start, self.mine.stop)
        src = owner[mine]                         # who holds each new row
        recv_splits = torch.bincount(src, minlength=self.world)
        rows = X[idx[send] - self.mine.start].contiguous()
        got = X.new_empty((len(self.mine),) + X.shape[1:])
        dist.all_to_all_single(got, rows, recv_splits.tolist(),
                               send_splits.tolist(), group=self.group)
        out = torch.empty_like(got)
        out[torch.argsort(src, stable=True)] = got
        return out


def smc_sample(bp: MPBP, nparticles: int, generator=None, group=None,
               ess_frac: float = 0.5) -> SoftMarginSampler:
    """Draw ``nparticles`` weighted trajectories of the reweighted dynamics
    with adaptive systematic resampling, on the state's device.  Returns a
    :class:`SoftMarginSampler` whose weights are the residual (post-
    resampling) importance weights and whose ``log_evidence`` estimates
    log Z.  ``generator``: a ``torch.Generator`` on the device (default one
    seeded with 0), in place of the JAX package's key.

    ``group``: a ``torch.distributed`` process group to split the particles
    over (None: this process alone).  Every rank calls with the same state
    and a generator in the same state; each returns a sampler of its own
    particles, the rows :func:`particle_range` names of the single-device
    run's ``X`` and ``logw``, with the same ``log_evidence``."""
    gen = _default_generator(bp, generator)
    N, T1 = bp.N, bp.T + 1
    P = nparticles
    sh = _Shards(P, group, bp.device)
    a, b = sh.mine.start, sh.mine.stop
    nbr = _neighbours(bp)
    n = max(1, _STEP_CELLS // N)
    p0 = _prior(bp)

    def batches(draw):
        """``draw(s0, s1, m, rows)`` for every batch of ``m`` particles:
        this rank's particles ``s0:s1`` of it, the batch's ``rows`` (none
        where the rank holds no particle of the batch: its uniforms are
        drawn all the same)."""
        out = []
        for lo in range(0, P, n):
            m = min(n, P - lo)
            i0 = max(lo, a)
            i1 = max(i0, min(lo + m, b))
            out.append(draw(i0 - a, i1 - a, m, slice(i0 - lo, i1 - lo)))
        return torch.cat(out)

    x = batches(lambda s0, s1, m, rows: _draw(
        p0.expand(s1 - s0, N, p0.shape[1]), gen, m, rows))
    logw = _obs_logw(bp, x, 0) - _log_prior0(bp, x)
    X = torch.zeros((b - a, N, T1), dtype=torch.int32, device=bp.device)
    X[:, :, 0] = x
    lztot = 0.0
    for t in range(1, T1):
        x = batches(lambda s0, s1, m, rows: _step(
            bp, nbr, x[s0:s1], gen, t - 1, m, rows))
        X[:, :, t] = x
        logw = logw + _obs_logw(bp, x, t)
        lw_all = sh.gather(logw)
        if float(effective_sample_size(lw_all)) < ess_frac * P:
            # absorb the current weights into the running log-evidence
            m = lw_all.max()
            lztot += float(m + torch.log(torch.exp(lw_all - m).mean()))
            u = torch.rand((), generator=gen, dtype=logw.dtype,
                           device=logw.device)
            X = sh.take(X, systematic_resample_indices(lw_all, u))
            x = X[:, :, t]
            logw = torch.zeros_like(logw)
    sms = SoftMarginSampler(bp, X, logw)
    sms.log_evidence = float(lztot + torch.logsumexp(sh.gather(logw), dim=0)
                             - math.log(P))
    return sms
