"""Where a stationary sweep's device activities come from, on the card.

    python3 -m matrixproductbp_tpu_torch.tools.probe_stationary [--refine=4]

Iterates stationary SIS (lam 0.1, rho 0.2, alpha 0.05) on the infinite
3-regular graph to tol 1e-14 (``TruncVUMPS(12)``, f64; with ``--refine=r``
``TruncVUMPS(8, refine=r)`` to 1e-10), then profiles one more sweep with
torch.profiler (host and device) and prints, as JSON lines: the iterate's
sweeps and s/sweep; the profiled sweep's device activities, device-busy
seconds (counted as ``chip_smoke.py``'s ``stationary_modes`` counts
them) and wall seconds; and the host operators that start the most
device activities, each with the names of the activities it starts
(kernels, copies, sets; an activity reached from two nested operators
counts under each).  Needs a CUDA card.
"""
import collections
import json
import sys
import time


def device_activities(prof):
    """Device activities (kernels, copies, sets) of a finished
    torch.profiler trace: (count, device seconds, the five most frequent
    names with their counts).  Reads the trace's raw events: building the
    profiler's event tree took ~28 s for the 41,000 of a stationary
    sweep."""
    import torch
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    top = collections.Counter(e.name()[:60] for e in dev).most_common(5)
    return (len(dev), sum(e.duration_ns() for e in dev) / 1e9,
            [{"name": k, "count": c} for k, c in top])


def device_launches(fn):
    """:func:`device_activities` of ``fn``, traced on the device alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_activities(prof)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("probe_stationary: no CUDA device")
    import matrixproductbp_tpu_torch as tp
    from matrixproductbp_tpu_torch import stationary as st
    from matrixproductbp_tpu_torch.models import SISFactorSpec
    refine = next((int(a.split("=", 1)[1]) for a in sys.argv[1:]
                   if a.startswith("--refine=")), 0)
    trunc = st.TruncVUMPS(8, refine=refine) if refine else st.TruncVUMPS(12)
    tables = tp.build_tables(tp.infinite_regular_graph(3),
                             [SISFactorSpec(0.1, 0.2, alpha=0.05)])
    sbp = st.mpbp_stationary_infinite_graph(3, tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sbp, it, _, _ = st.iterate_stationary(sbp, maxiter=200, trunc=trunc,
                                          tol=1e-10 if refine else 1e-14)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"trunc": repr(trunc), "sweeps": it, "s": wall,
                      "s_per_sweep": wall / it}), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st.iterate_stationary(sbp, maxiter=1, trunc=trunc, tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n, busy, _ = device_activities(prof)
    events = prof.events()
    by_op = collections.Counter()
    names = collections.defaultdict(collections.Counter)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        # the outermost aten operator above the launching call
        op = e
        while op.cpu_parent is not None and \
                op.cpu_parent.name.startswith("aten::"):
            op = op.cpu_parent
        by_op[op.name] += len(e.kernels)
        for k in e.kernels:
            names[op.name][k.name[:50]] += 1
    print(json.dumps({
        "profiled_wall_s": wall, "device_activities": n,
        "device_busy_s": busy}), flush=True)
    for op, n in by_op.most_common(12):
        print(json.dumps({"op": op, "activities": n,
                          "names": dict(names[op].most_common(4))}),
              flush=True)


if __name__ == "__main__":
    main()
