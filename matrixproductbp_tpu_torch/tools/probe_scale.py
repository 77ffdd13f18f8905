"""The in-place big-graph sweep at the scale target on the card: device
memory and time a sweep by chunk budget.

    python3 -m matrixproductbp_tpu_torch.tools.probe_scale
        [--budgets=4096,16384,32768,65536] [--n=100000] [--t=50] [--d=10]
        [--profile] [--lone]

Run from the repository's root: the problem (``chip_smoke.scale_problem``:
SIS on ``erdos_renyi_gnm(N, 3N/2, default_rng(0))``, tables from
``sis_tables``, the t=0 prior as ``phi``) and the launch counts by bucket
(``chip_smoke.count_by_bucket``) are the smoke's own.  f32,
``method="sketch"``, swept by ``bigsweep.bp_sweep_flat`` in place
(Gauss-Seidel).  Builds the kernels first (every source and the per-shape
merge and MPEM3 kernels of bond D, one ``nvcc`` each, all at once), makes
the state, then runs one sweep at each node-slot budget, smallest first,
and prints one JSON line each: seconds, ``torch.cuda.max_memory_allocated``
and ``max_memory_reserved``, and the updates by bucket.  Stops at the
first budget that runs out of device memory, then reads the isolated
nodes' marginals against the exact ones (``chip_smoke.exact_isolated``).
``--profile`` adds one sweep at the largest budget that fitted under
``torch.profiler``: the device's busy share and the kernels that took the
most device time.  ``--lone`` first sweeps a lone SIS node at T, D (f32
on the kernels and through the smoke's ``plain_scans``, and f64) with the
sketches of several seeds and prints each one's error against the exact
marginal.  Needs a CUDA card.
"""
import contextlib
import json
import sys
import time

import numpy as np
import torch


def emit(**kv):
    print(json.dumps(kv), flush=True)


def kernel_targets(D):
    """The per-shape builds an f32 SIS sketch sweep of bond D launches: the
    merge F and W kernels the geometries pick and the staged MPEM3 W and F
    kernels of both conversions."""
    from matrixproductbp_tpu_torch.ops import fused_stta as fs
    sr = D
    merge = (D, D, 2, 2, sr, min(sr + 4, D * D), torch.float32)
    out = []
    if fs.merge_f_geometry(*merge)[0] != "base":
        out.append(fs._merge_f_target(fs.merge_f_geometry(*merge)[0], merge))
    if fs.merge_w_geometry(*merge[:5], torch.float32)[0] == "staged":
        out.append(("merge_w_staged",
                    fs.merge_w_staged_macros(*merge[:5], torch.float32)))
    for qj, layout in ((2, "ijrmn"), (1, "mnijr")):
        out += [("mpem3_staged", fs.mpem3_staged_macros(
            D, 2, qj, sr, sl, torch.float32, layout))
                for sl in (None, min(sr + 4, 2 * D))]
    return out


def lone_node_errors(c, T, D, seeds):
    """One sweep of a lone SIS node (beside an edge, so the graph has one)
    with the sketches of each seed: the max-abs error of its marginals
    against ``c.exact_isolated``, f32 on the kernels and on the plain
    scans, and f64."""
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch.models import SIS, mpbp_sis
    sis = SIS(tp.graph_from_edges(3, [(1, 2)]), c.SCALE_LAM, c.SCALE_RHO,
              T=T, gamma=c.SCALE_PRIOR_I)
    out = []
    for seed in seeds:
        row = {"seed": seed}
        for leg, dtype, plain in (("f32", torch.float32, False),
                                  ("f32_plain", torch.float32, True),
                                  ("f64", torch.float64, False)):
            with c.plain_scans() if plain else contextlib.nullcontext():
                bp = tp.bp_sweep(mpbp_sis(sis, D=D, dtype=dtype),
                                 tp.TruncBond(D), method="sketch",
                                 sketches=tp.SeededSketches(seed))
            b = tp.beliefs(bp)[0, :, 1].double().cpu().numpy()
            row[leg] = float(np.abs(b - c.exact_isolated(T)).max())
        out.append(row)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_scale: needs a CUDA card")
    args = dict(a[2:].split("=", 1) for a in sys.argv[1:] if "=" in a)
    N, T, D = (int(args.get(k, v)) for k, v in
               (("n", 100_000), ("t", 50), ("d", 10)))
    budgets = [int(b) for b in
               args.get("budgets", "4096,16384,32768,65536").split(",")]
    sys.path.insert(0, ".")
    import chip_smoke as c
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import bigsweep
    from matrixproductbp_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(device=torch.cuda.get_device_name(0), torch=torch.__version__)
    t0 = time.perf_counter()
    build.build_all(list(build.SOURCES) + kernel_targets(D))
    emit(build_s=time.perf_counter() - t0)
    if "--lone" in sys.argv:
        emit(lone_node=lone_node_errors(c, T, D, seeds=(17, 0, 1, 2, 3, 4)))
    t0 = time.perf_counter()
    g, tables, phi = c.scale_problem(N, T)
    emit(N=g.N, E=g.E, dmax=g.dmax, isolated=int((g.degree == 0).sum()),
         buckets=[[int(k), len(i)] for i, k in tp.bp._degree_buckets(g)],
         problem_s=time.perf_counter() - t0)
    fs = bigsweep.flat_init(g, tables, T, D, dtype=torch.float32)
    tables = tables.to(device="cuda", dtype=torch.float32)
    phi_d = torch.as_tensor(phi, device="cuda")
    trunc = tp.TruncBond(D)
    torch.cuda.synchronize()
    emit(resident_bytes=torch.cuda.memory_allocated())
    fitted = None
    for budget in budgets:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with c.count_by_bucket() as counts:
                bigsweep.bp_sweep_flat(g, tables, fs, trunc, T, D,
                                       phi=phi_d, chunk=budget)
                torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            emit(budget=budget, out_of_memory=str(e).splitlines()[0])
            break
        dt = time.perf_counter() - t0
        fitted = budget
        emit(budget=budget, s_per_sweep=dt, edge_updates_per_s=g.E / dt,
             peak_allocated=torch.cuda.max_memory_allocated(),
             peak_reserved=torch.cuda.max_memory_reserved(), chunks=counts,
             marg_finite=bool(torch.isfinite(fs.marg).all()))
    iso = torch.as_tensor(np.nonzero(g.degree == 0)[0], device="cuda")
    err = (fs.marg[iso, :, 1].double().cpu().numpy()
           - c.exact_isolated(T))
    emit(isolated=len(iso), isolated_err=float(np.abs(err).max()),
         isolated_err_by_t=np.abs(err).max(0)[::5].tolist())
    if "--profile" in sys.argv and fitted is not None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bigsweep.bp_sweep_flat(g, tables, fs, trunc, T, D, phi=phi_d,
                                   chunk=fitted)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((e.self_device_time_total, e.count, e.key[:90])
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
        busy = sum(r[0] for r in rows) / 1e6
        emit(profile_budget=fitted, wall_s=wall, device_busy_s=busy,
             busy_share=busy / wall,
             launches=sum(r[1] for r in rows),
             top=[{"name": k, "device_ms": us / 1e3, "count": n}
                  for us, n, k in rows[:16]])


if __name__ == "__main__":
    main()
