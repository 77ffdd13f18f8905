"""Soft-margin importance sampler, observation generator and Gillespie SIS.

Counterpart of ``matrixproductbp_tpu/sampling.py`` (reference
``sampling.jl``):

* ``sample``: ancestral sampling of the unreweighted dynamics, every
  particle of a batch at once, through the same table fold the sweep is
  built from (``factors.transition_probs``), then importance weights from
  the observations, in float64 log-domain.  Trajectories ``X`` (int32
  ``[S, N, T1]``) and ``logw`` stay on the state's device; batches of
  particles bound the temporaries.
* The estimators run there in torch and return (mean, stderr) tensors, the
  reference's binomial error bars (``sampling.jl:91-113``).
* ``draw_node_observations``: soft clamping of randomly chosen (site, time)
  cells (``sampling.jl:191-210``).
* The event-driven Gillespie SIS simulator stays on the host, in numpy.

Randomness: the JAX package draws from ``jax.random`` keys; the port takes
a ``torch.Generator`` on the state's device (``generator=``, default one
seeded with 0).  The two never give the same draws.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from .bp import MPBP
from .factors import transition_probs

__all__ = ["SoftMarginSampler", "sample", "sample_one", "marginals_mc",
           "pair_marginals_mc", "autocorrelations_mc", "autocovariances_mc",
           "means_mc", "draw_node_observations", "simulate_queue_sis",
           "continuous_sis_sampler"]

#: particle x node cells a batch of the transition step holds, and cells
#: (particle x node or edge x time) a batch of an estimator's gathers holds
_STEP_CELLS = 1 << 22
_GATHER_CELLS = 1 << 24


def _default_generator(bp: MPBP, generator):
    if generator is not None:
        return generator
    return torch.Generator(device=bp.device).manual_seed(0)


def _draw(p: torch.Tensor, generator, batch: int | None = None,
          rows: slice = slice(None)) -> torch.Tensor:
    """One state per row of the (unnormalized) weights ``p [..., q]``, by
    inverse CDF of a uniform.  With ``batch``, ``p`` holds the rows ``rows``
    of a batch of that many: the whole batch's uniforms are drawn, and
    those rows of them used, so a shard draws what the whole batch would."""
    c = p.cumsum(dim=-1)
    shape = (p.shape[:-1] if batch is None else (batch,) + p.shape[1:-1])
    u = torch.rand(shape + (1,), generator=generator, dtype=p.dtype,
                   device=p.device)[rows] * c[..., -1:]
    return (c <= u).sum(dim=-1).clamp(max=p.shape[-1] - 1)


def _neighbours(bp: MPBP) -> torch.Tensor:
    g = bp.graph
    return torch.as_tensor(np.minimum(g.nbr, g.N - 1), dtype=torch.int64,
                           device=bp.device)


def _step(bp: MPBP, nbr, x: torch.Tensor, generator, t: int,
          batch: int | None = None, rows: slice = slice(None)
          ) -> torch.Tensor:
    """x^{t+1} of every particle from x^t [P, N], one transition with the
    tables of step t (``sampling.py:57-62``); ``batch`` and ``rows`` as
    :func:`_draw`'s."""
    p = transition_probs(bp.tables.at_time(t), bp.garrays.in_mask,
                         x[:, nbr], x)
    return _draw(p, generator, batch, rows)


def _obs_logw(bp: MPBP, X: torch.Tensor, t=None) -> torch.Tensor:
    """Observation log-weight [P] of trajectories X [P, N, T1] (or of the
    states X [P, N] at time ``t``): sum log phi + 1/2 sum log psi, float64."""
    g, dev = bp.graph, bp.device
    if t is not None:
        X = X[:, :, None]
    tt = (torch.arange(X.shape[2], device=dev) if t is None
          else torch.full((1,), t, device=dev))
    phi, psi = bp.phi.double(), bp.psi.double()
    ar = torch.arange(g.N, device=dev)
    ae = torch.arange(g.E, device=dev)
    src = torch.as_tensor(g.edge_src, dtype=torch.int64, device=dev)
    dst = torch.as_tensor(g.edge_dst, dtype=torch.int64, device=dev)
    out = []
    n = max(1, _GATHER_CELLS // (max(g.N, g.E) * X.shape[2]))
    for lo in range(0, X.shape[0], n):
        Xc = X[lo:lo + n].long()
        lw = torch.log(phi[ar[:, None], tt[None, :], Xc]).sum(dim=(1, 2))
        lw = lw + 0.5 * torch.log(psi[ae[:, None], tt[None, :], Xc[:, src],
                                      Xc[:, dst]]).sum(dim=(1, 2))
        out.append(lw)
    return torch.cat(out)


def _prior(bp: MPBP) -> torch.Tensor:
    """The t=0 law: phi[:, 0] normalized, [N, q]."""
    p0 = bp.phi[:, 0, :]
    return p0 / p0.sum(dim=1, keepdim=True)


def _log_prior0(bp: MPBP, x0: torch.Tensor) -> torch.Tensor:
    """sum_i log p0_i(x0_i) of states x0 [P, N], float64."""
    ar = torch.arange(bp.N, device=bp.device)
    return torch.log(_prior(bp).double()[ar, x0.long()]).sum(dim=1)


def _sample_trajectories(bp: MPBP, nsamples: int, generator):
    """X[nsamples, N, T1] (int32) and logw[nsamples] (float64): draws from
    the prior dynamics, weighted by the observation likelihood (reference
    ``onesample!``, ``sampling.jl:30-59``)."""
    N, T1 = bp.N, bp.T + 1
    nbr = _neighbours(bp)
    p0 = _prior(bp)
    X = torch.empty((nsamples, N, T1), dtype=torch.int32, device=bp.device)
    n = max(1, _STEP_CELLS // N)
    for lo in range(0, nsamples, n):
        m = min(n, nsamples - lo)
        x = _draw(p0.expand(m, N, p0.shape[1]), generator)
        X[lo:lo + m, :, 0] = x
        for t in range(1, T1):
            x = _step(bp, nbr, x, generator, t - 1)
            X[lo:lo + m, :, t] = x
    # phi[:, 0] is the prior the draw came from: divide it out
    logw = _obs_logw(bp, X) - _log_prior0(bp, X[:, :, 0])
    return X, logw


@dataclasses.dataclass
class SoftMarginSampler:
    """Sample store (reference ``SoftMarginSampler``, ``sampling.jl:6-27``):
    trajectories ``X`` int32 [S, N, T1] and log-weights ``logw`` float64
    [S] on the state's device; ``log_evidence`` is set by ``smc_sample``."""
    bp: MPBP
    X: torch.Tensor
    logw: torch.Tensor
    log_evidence: float | None = None

    @property
    def weights(self) -> torch.Tensor:
        w = torch.exp(self.logw - self.logw.max())
        return w / w.sum()


def sample(bp: MPBP, nsamples: int, generator=None) -> SoftMarginSampler:
    """Draw ``nsamples`` weighted trajectories (reference ``sample``)."""
    X, logw = _sample_trajectories(bp, nsamples,
                                   _default_generator(bp, generator))
    return SoftMarginSampler(bp, X, logw)


def sample_one(bp: MPBP, generator=None):
    """One trajectory [N, T1] and its log-weight."""
    sms = sample(bp, 1, generator)
    return sms.X[0], sms.logw[0]


# ---------------------------------------------------------------------------
# estimators (value, binomial stderr)
# ---------------------------------------------------------------------------

def _weighted_sum(sms: SoftMarginSampler, fn, cells: int) -> torch.Tensor:
    """sum over batches of particles of ``fn(w, X)``, the weights and the
    trajectories of a batch holding about ``_GATHER_CELLS`` of ``cells`` a
    particle."""
    w = sms.weights
    n = max(1, _GATHER_CELLS // max(cells, 1))
    acc = None
    for lo in range(0, sms.X.shape[0], n):
        part = fn(w[lo:lo + n], sms.X[lo:lo + n].long())
        acc = part if acc is None else acc + part
    return acc


def _mean_of(onehot):
    """``fn`` of :func:`_weighted_sum` for sum_s w_s onehot(X_s)."""
    return lambda w, X: torch.tensordot(w, onehot(X), dims=1)


def _stderr(m: torch.Tensor, S: int) -> torch.Tensor:
    return torch.sqrt(torch.clamp(m * (1 - m), min=0.0) / S)


def marginals_mc(sms: SoftMarginSampler):
    """([N, T1, q] mean, [N, T1, q] stderr) (``sampling.jl:91-113``)."""
    q = sms.bp.q
    S, N, T1 = sms.X.shape
    m = _weighted_sum(sms, _mean_of(lambda X: torch.stack(
        [(X == a).double() for a in range(q)], dim=-1)), N * T1 * q)
    return m, _stderr(m, S)


def pair_marginals_mc(sms: SoftMarginSampler):
    """([E, T1, q, q], stderr) per directed edge (``sampling.jl:123-147``)."""
    g, q = sms.bp.graph, sms.bp.q
    S, N, T1 = sms.X.shape
    src = torch.as_tensor(g.edge_src, dtype=torch.int64, device=sms.X.device)
    dst = torch.as_tensor(g.edge_dst, dtype=torch.int64, device=sms.X.device)

    def onehot(X):
        Xi, Xj = X[:, src], X[:, dst]                 # [s, E, T1]
        return torch.stack([torch.stack(
            [((Xi == a) & (Xj == b)).double() for b in range(q)], dim=-1)
            for a in range(q)], dim=-2)
    m = _weighted_sum(sms, _mean_of(onehot), g.E * T1 * q * q)
    return m, _stderr(m, S)


def _values(sms: SoftMarginSampler, values) -> torch.Tensor:
    dev = sms.X.device
    if values is None:
        return torch.arange(sms.bp.q, dtype=torch.float64, device=dev)
    return torch.as_tensor(values, dtype=torch.float64, device=dev)


def means_mc(sms: SoftMarginSampler, values=None):
    """([N, T1] <f(x_i^t)>, stderr)."""
    v = _values(sms, values)
    m, err = marginals_mc(sms)
    return m @ v, torch.sqrt((err ** 2) @ (v ** 2))


def autocorrelations_mc(sms: SoftMarginSampler, values=None, maxdist=None):
    """([N, T1, T1] <f(x^t) f(x^u)> for t < u <= t + maxdist, stderr)
    (``sampling.jl:149-177``)."""
    S, N, T1 = sms.X.shape
    maxdist = T1 if maxdist is None else maxdist
    v = _values(sms, values)

    def moments(w, X):
        fv = v[X]                                     # [s, N, T1]
        wf = fv * w[:, None, None]
        return torch.stack([torch.einsum("snt,snu->ntu", wf, fv),
                            torch.einsum("snt,snu->ntu", wf * fv, fv * fv)])
    r, r2 = _weighted_sum(sms, moments, N * T1)
    t = torch.arange(T1, device=r.device)
    keep = (t[None, :] > t[:, None]) & (t[None, :] - t[:, None] <= maxdist)
    e = torch.sqrt(torch.clamp(r2 - r ** 2, min=0.0) / S)
    return r * keep, e * keep


def autocovariances_mc(sms: SoftMarginSampler, values=None, maxdist=None):
    """Autocorrelations minus the product of means, entries t < u."""
    r, e = autocorrelations_mc(sms, values, maxdist)
    m, _ = means_mc(sms, values)
    T1 = m.shape[1]
    mask = torch.ones((T1, T1), dtype=torch.bool, device=m.device).triu(1)
    return (r - m[:, :, None] * m[:, None, :]) * mask, e


# ---------------------------------------------------------------------------
# observation generator
# ---------------------------------------------------------------------------

def draw_node_observations(bp: MPBP, nobs: int, rng: np.random.Generator,
                           softinf: float = np.inf, last_time: bool = False,
                           generator=None):
    """Sample one trajectory from the prior, observe ``nobs`` random (site,
    time) cells chosen by the numpy ``rng`` through soft indicators, and
    return (new bp, X [N, T1] on the device, the sorted observed cells)
    (reference ``draw_node_observations!``, ``sampling.jl:191-210``)."""
    X, _ = sample_one(bp, generator)
    N, T1 = X.shape
    times = range(T1 - 1, T1) if last_time else range(T1)
    cells = [(i, t) for i in range(N) for t in times]
    idx = rng.choice(len(cells), size=nobs, replace=False)
    observed = sorted(cells[i] for i in idx)
    if np.isinf(softinf):
        softone, softzero = 1.0, 0.0
    else:
        lw = np.log(softinf)
        softone = 1.0 / (1.0 + np.exp(-lw))
        softzero = 1.0 / (1.0 + np.exp(lw))
    dev = bp.device
    ii = torch.as_tensor([c[0] for c in observed], dtype=torch.int64,
                         device=dev)
    tt = torch.as_tensor([c[1] for c in observed], dtype=torch.int64,
                         device=dev)
    hit = torch.arange(bp.q, device=dev)[None, :] == X[ii, tt].long()[:, None]
    ind = torch.where(hit, torch.tensor(softone, dtype=bp.phi.dtype,
                                        device=dev),
                      torch.tensor(softzero, dtype=bp.phi.dtype, device=dev))
    phi = bp.phi.clone()
    phi[ii, tt] = phi[ii, tt] * ind
    zero = (phi[ii, tt] == 0).all(dim=1).cpu().numpy()
    if zero.any():
        i, t = observed[int(np.argmax(zero))]
        raise ValueError(f"observation zeroes out node {i} at time {t}")
    return dataclasses.replace(bp, phi=phi), X, observed


# ---------------------------------------------------------------------------
# continuous-time Gillespie SIS (host-side oracle, numpy)
# ---------------------------------------------------------------------------

def simulate_queue_sis(graph, P0, lam, mu, alpha, T, rng: np.random.Generator,
                       stats=None):
    """Event-driven SIS simulation (reference ``simulate_queue_sis!``,
    ``sampling.jl:218-257``), a lazy-deletion exponential clock queue in
    place of CavityTools.ExponentialQueue."""
    N = graph.N
    x = np.zeros(N, dtype=bool)
    rate = np.zeros(N)
    heap: list = []
    stamp = np.zeros(N, dtype=np.int64)
    t = 0.0

    def set_rate(i, r):
        rate[i] = r
        stamp[i] += 1
        if r > 0:
            if np.isinf(r):
                heapq.heappush(heap, (t, int(i), int(stamp[i])))
            else:
                dt = rng.exponential(1.0 / r)
                heapq.heappush(heap, (t + dt, int(i), int(stamp[i])))

    for i in range(N):
        if rng.random() < P0[i]:
            set_rate(i, np.inf)

    nbrs = [graph.nbr[i][graph.in_mask[i]] for i in range(N)]
    while heap:
        tev, i, s = heapq.heappop(heap)
        if s != stamp[i] or rate[i] == 0:
            continue
        t = tev
        if t > T:
            break
        x[i] = ~x[i]
        if stats is not None:
            stats(t, i, x)
        if x[i]:
            for j in nbrs[i]:
                if not x[j]:
                    set_rate(j, rate[j] + lam)
            set_rate(i, mu)
        else:
            s_i = alpha
            for j in nbrs[i]:
                if not x[j]:
                    set_rate(j, max(rate[j] - lam, 0.0))
                else:
                    s_i += lam
            set_rate(i, s_i)
    return x


def continuous_sis_sampler(sis, T, lam, rho, alpha=0.0, nsamples=10**4,
                           nbins=200, rng=None, discard_dead=False):
    """Time-binned magnetization statistics from Gillespie runs (reference
    ``continuous_sis_sampler``, ``sampling.jl:260-301``)."""
    rng = np.random.default_rng(0) if rng is None else rng
    g = sis.graph
    N = g.N
    dt = T / nbins
    K = nbins + 1
    av = np.zeros((N, K))
    va = np.zeros((N, K))
    P0 = np.broadcast_to(np.asarray(sis.gamma), (N,))
    ndisc = 0
    for _ in range(nsamples):
        ni = np.zeros((N, K), dtype=np.int64)

        def stats(t, i, x):
            k = min(int(np.ceil(t / dt)), K - 1)
            ni[i, k] += 2 * int(x[i]) - 1

        x = simulate_queue_sis(g, P0, lam, rho, alpha, T, rng, stats)
        if discard_dead and not x.any():
            ndisc += 1
            continue
        s = np.cumsum(ni, axis=1)
        av += s
        va += s.astype(float) ** 2
    n = max(nsamples - ndisc, 1)
    av /= n
    va = np.sqrt(np.maximum(va / n - av ** 2, 0.0))
    return av, va
