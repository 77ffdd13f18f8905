"""Where the time of sharded SMC goes: two ranks sharing one card against
the same run on the card alone.

    python3 -m matrixproductbp_tpu_torch.tools.probe_smc [--particles=4096]
        [--ranks=2] [--cpu [--n=512]]

Run from the repository's root.  The state is ``chip_smoke.py``'s observed
inference tree (SIS on a 4,096-node tree, T=15, 256 soft observations), the
run ``smc_sample`` with ``--particles`` particles and the generator seeded
with 0, as ``chip_smoke.py``'s ``smc_sharded`` phase runs it: first on the
card alone, then over ``--ranks`` spawned gloo ranks sharing the card (each
with half the host's threads).  Each side runs twice: once as it is (its
seconds), then with each stage wrapped in a device synchronize and a host
clock: the initial draws (``_draw``), the transitions (``_step``), the
observation weights (``_obs_logw``), the weights gathered to every rank
(``_Shards.gather``) and the resampling (``_Shards.take``), and within it
``all_to_all_single`` (its seconds and the bytes each rank sends).  Prints
one JSON line a side: the seconds, each stage's seconds and calls, the
resampling events, and the card's ``nvidia-smi`` name and power limit.
``--cpu`` rehearses the same on the CPU (a ``--n``-node tree; no timing
meaning).
"""
import json
import os
import sys
import tempfile
import time

import torch


def emit(**kv):
    print(json.dumps(kv), flush=True)


class _Stages:
    """Seconds and calls of each wrapped stage, each call between two
    device synchronizes; :meth:`patch` wraps, :meth:`restore` unwraps."""

    def __init__(self, device):
        self.device = device
        self.seconds, self.calls, self.a2a_bytes = {}, {}, 0
        self._saved = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            if name == "all_to_all_single":
                self.a2a_bytes += args[1].numel() * args[1].element_size()
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self._sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1
            return out
        return timed

    def patch(self):
        from matrixproductbp_tpu_torch import smc
        for owner, attr, name in (
                (smc, "_draw", "draw"), (smc, "_step", "transitions"),
                (smc, "_obs_logw", "obs_logw"),
                (smc._Shards, "gather", "gather"),
                (smc._Shards, "take", "resample_take"),
                (smc.dist, "all_to_all_single", "all_to_all_single")):
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []


def _run(bpo, particles, device, group):
    """``smc_sample`` once as it is, then once with its stages timed."""
    from matrixproductbp_tpu_torch import smc

    def once():
        gen = torch.Generator(device=device).manual_seed(0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sms = smc.smc_sample(bpo, particles, generator=gen, group=group)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return sms, time.perf_counter() - t0

    sms, seconds = once()
    st = _Stages(device)
    st.patch()
    try:
        _, timed = once()
    finally:
        st.restore()
    return {"seconds": seconds, "timed_seconds": timed,
            "stage_seconds": st.seconds, "stage_calls": st.calls,
            "resamplings": st.calls.get("resample_take", 0),
            "all_to_all_bytes_sent": st.a2a_bytes,
            "log_evidence": sms.log_evidence,
            "X_bytes": sms.X.numel() * sms.X.element_size()}


def _rank(rank, world, n, particles, device_type):
    import torch.distributed as dist
    import chip_smoke as smoke
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(device_type)
    bpo = smoke.observed_tree(n, device=device_type)
    return _run(bpo, particles, dev, dist.group.WORLD)


def main(argv):
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    cpu = "cpu" in opts
    particles = int(opts.get("particles", 4096))
    ranks = int(opts.get("ranks", 2))
    import chip_smoke as smoke
    from matrixproductbp_tpu_torch.parallel import spawn_ranks
    dev = torch.device("cpu" if cpu else "cuda")
    n = int(opts.get("n", 512 if cpu else smoke.INFER_N))
    card = "cpu" if cpu else smoke.phase_device()["nvidia_smi"]
    threads = max(1, (os.cpu_count() or 2) // ranks)
    one = _run(smoke.observed_tree(n, device=dev.type), particles, dev, None)
    emit(probe="smc", side="one_device", n=n, particles=particles,
         device=card, **one)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res = spawn_ranks(_rank, ranks, (n, particles, dev.type),
                          backend="gloo", threads=threads, store_dir=d,
                          timeout=900)
        spawn_s = time.perf_counter() - t0
    for r, rec in enumerate(res):
        emit(probe="smc", side="rank", rank=r, ranks=ranks, n=n,
             particles=particles, threads=threads, device=card,
             spawn_s=spawn_s, **rec)


if __name__ == "__main__":
    main(sys.argv[1:])
