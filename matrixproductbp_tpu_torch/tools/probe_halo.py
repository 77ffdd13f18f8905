"""The halo-exchange sweep over several cards against one card.

    python3 -m matrixproductbp_tpu_torch.tools.probe_halo [--ranks=4]
        [--n=4096,16384] [--sweeps=3] [--cpu]

Run from the repository's root.  For each graph size n: SIS (lam 0.2, rho
0.1, prior 0.3) on ``random_regular_graph(n, 3, default_rng(0))``, T=15,
D=10, f32, ``method="sketch"``; one warm-up sweep, then ``--sweeps``
sweeps each timed to a device synchronize, first by ``bp_sweep`` on card
0, then by ``halo_sweep`` over ``--ranks`` spawned NCCL ranks, rank r on
card r, from the same state (the BFS partition; a barrier before the timed
sweeps).  Prints one JSON line a size: each rank's seconds a sweep, the
cut and the bytes exchanged a sweep, the launches by kernel, the plain
scans called (none on the card), and the gathered beliefs' and free
energy's distance from the one-card sweeps'.  Then
``entry.dryrun_multichip(--ranks)``.  Builds the kernels first
(``chip_smoke.phase_build``).  Needs ``--ranks`` cards; ``--cpu``
rehearses the same on the CPU with gloo ranks (no build, no timing
meaning).
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def emit(**kv):
    print(json.dumps(kv), flush=True)


def _state(n, device):
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    g = tp.random_regular_graph(n, 3, np.random.default_rng(0))
    return mpbp_sis(SIS(g, lam=0.2, rho=0.1, T=15, gamma=0.3), D=10,
                    dtype=torch.float32, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(step, state, sweeps, device):
    state = step(state)                            # warm-up
    times = []
    for _ in range(sweeps):
        _sync(device)
        t0 = time.perf_counter()
        state = step(state)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return state, times


def _rank(rank, world, ref_path, sizes, sweeps, device_type):
    import torch.distributed as dist
    import chip_smoke as smoke
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.parallel import (
        halo_beliefs, halo_bethe_free_energy, halo_mpbp, halo_sweep)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device_type)
    ref = np.load(ref_path)
    out = []
    for n in sizes:
        bp0 = _state(n, dev)
        g = bp0.graph
        st = halo_mpbp(bp0, device=dev)
        del bp0
        dist.barrier()
        smoke.reset_counts()
        with smoke.count_plain_scans() as plain:
            st, times = _timed(lambda s: halo_sweep(
                s, tp.TruncBond(10), method="sketch"), st, sweeps, dev)
        b = halo_beliefs(st, g).cpu().numpy()
        f = float(halo_bethe_free_energy(st))
        out.append({
            "n": n, "s_per_sweep": times, "cut": st.plan.cut,
            "rows_sent": st.rows_sent,
            "bytes_sent_per_sweep": st.rows_sent * (
                st.msg_cores[0].numel() + 1) * st.msg_cores.element_size(),
            "launches": smoke.read_counts(), "plain_scan_calls": dict(plain),
            "belief_diff": float(np.abs(b - ref[f"b{n}"]).max()),
            "f_diff": abs(f - float(ref[f"f{n}"]))})
        del st
    return out


def main(argv):
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    ranks = int(opts.get("ranks", 4))
    sizes = [int(v) for v in opts.get("n", "4096,16384").split(",")]
    sweeps = int(opts.get("sweeps", 3))
    cpu = "cpu" in opts
    import chip_smoke as smoke
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.parallel import spawn_ranks
    dev = torch.device("cpu" if cpu else "cuda")
    if not cpu:
        if torch.cuda.device_count() < ranks:
            raise SystemExit(f"probe_halo: {ranks} ranks need {ranks} cards")
        info = smoke.phase_device()
        torch.backends.cuda.matmul.allow_tf32 = False
        smoke.phase_build()
    refs, one_card = {}, {}
    for n in sizes:
        bp, times = _timed(lambda s: tp.bp_sweep(
            s, tp.TruncBond(10), method="sketch"), _state(n, dev), sweeps,
            dev)
        refs[f"b{n}"] = tp.beliefs(bp).cpu().numpy()
        refs[f"f{n}"] = float(tp.bethe_free_energy(bp))
        one_card[n] = times
        del bp
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.npz")
        np.savez(path, **refs)
        t0 = time.perf_counter()
        res = spawn_ranks(_rank, ranks, (path, sizes, sweeps, dev.type),
                          backend="gloo" if cpu else "nccl",
                          threads=1 if cpu else None, store_dir=d,
                          timeout=1200)
        spawn_s = time.perf_counter() - t0
    for i, n in enumerate(sizes):
        per_rank = [r[i] for r in res]
        emit(probe="halo", n=n, ranks=ranks, sweeps=sweeps,
             device="cpu" if cpu else info["nvidia_smi"],
             one_card_s_per_sweep=one_card[n],
             halo_s_per_sweep=[r["s_per_sweep"] for r in per_rank],
             cut=per_rank[0]["cut"],
             bytes_per_sweep=sum(r["bytes_sent_per_sweep"]
                                 for r in per_rank),
             belief_diff=max(r["belief_diff"] for r in per_rank),
             f_diff=max(r["f_diff"] for r in per_rank),
             launches=[r["launches"] for r in per_rank],
             plain_scan_calls=[r["plain_scan_calls"] for r in per_rank],
             spawn_s=spawn_s)
    from matrixproductbp_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    f = dryrun_multichip(ranks, device="cpu" if cpu else None)
    emit(probe="dryrun_multichip", ranks=ranks, f=f,
         seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main(sys.argv[1:])
