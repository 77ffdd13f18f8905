"""The MPEM3 conversion scan kernels on the card: their build reports and
their time per call, side by side on the same inputs.

    python3 -m matrixproductbp_tpu_torch.tools.probe_mpem3 [--attribute]
        [--bonds=10,20] [--gt=64]

One JSON line per reading.  Builds ``stta_scans`` (``mpem3_w_kernel``,
``mpem3_f_kernel``) and ``mpem3_staged`` (its W and F kernels) at both
conversions of a sketch sweep at every bond of ``BONDS`` (``--bonds``
keeps those), all at once, and prints the ptxas report of each build
(registers, spills); then times the first-design kernel and the staged one
with CUDA events on the same f32 inputs, in turns (base, staged, staged,
base), at both launches of a sweep: the message conversion ([12288, 15],
qj = 2, B_t in the time-major ``(i, j, r, m, n)`` rows) and the belief
conversion ([4096, 15], qj = 1, contiguous ``(m, n, i, j, r)``), with
``Db = sr = D`` and ``sl = D + 4``.  ``--gt`` builds the staged kernels
with that many threads an instance instead of the planner's.  Their
agreement with the plain versions is ``tests/test_torch_gpu.py -k mpem3``
(run on the card).

``--attribute`` says where a staged launch's time goes at the bench bonds
(``BENCH``: D=10 and D=20) of those timed: it builds each staged kernel
again with ``M3_CLOCKS=1`` (clock64 read by each block's thread 0 around
every phase of a step, summed over blocks) and prints each phase's share
of the counted cycles: waiting for the step's copies at the block barrier,
issuing the next step's, each product, the rescale and the stores.
Needs a CUDA card.
"""
import ctypes
import subprocess
import sys

import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.tools.probe_merge_f import _ptxas, emit, tcuda

#: bonds timed, and the bench bonds --attribute takes apart
BONDS = tuple(range(4, 21))
BENCH = (10, 20)
#: the two launches of a sketch sweep: (name, instances, qj, B_t layout)
LAUNCHES = (("messages", 12288, 2, "ijrmn"), ("beliefs", 4096, 1, "mnijr"))
#: the clock64 phases of a step, by kernel (M3_TICK indices of
#: mpem3_staged.cu)
PHASES = {"f": ("wait", "issue", "t1", "M", "N", "S2", "rescale", "stores"),
          "w": ("wait", "issue", "t1", None, None, "W2", "reduce",
                "rescale_store")}


def shape(D, qj):
    """(Db, qi, qj, sr, sl) of a sketch sweep's conversion to bond D."""
    sr = min(D, 2 * D)
    return D, 2, qj, sr, min(sr + 4, 2 * D)


def inputs(Bn, S, Db, qi, qj, sr, sl, layout, dev, seed=0):
    """B1 in the sweep's layout, Psi, Phi, S_init; f32, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, device=dev)
    if layout == "ijrmn":
        B1 = r(S + 1, Bn, qi * qj * qi * Db * Db).reshape(
            S + 1, Bn, qi, qj, qi, Db, Db).permute(1, 0, 5, 6, 2, 3, 4)[:, 1:]
    else:
        B1 = r(Bn, S + 1, Db, Db, qi, qj, qi)[:, 1:]
    return B1, r(S, sr, sr, qi, qj), r(S, sl, sl, qi, qj), r(Bn, sl, Db, qi)


def targets(D, qj, layout, gt=None, extra=()):
    """The staged W and F builds of one conversion."""
    Db, qi, qj, sr, sl = shape(D, qj)
    return [("mpem3_staged", fs.mpem3_staged_macros(
        Db, qi, qj, sr, s, torch.float32, layout, gt) + extra)
            for s in (None, sl)]


def _launchers(D, qj, layout, gt):
    """{(kernel, variant): fn(args) -> rc} for the base and staged W and F
    kernels of one conversion, the staged ones built with ``gt``."""
    Db, qi, qj, sr, sl = shape(D, qj)
    base = build.library("stta_scans")
    (_, mw), (_, mf) = targets(D, qj, layout, gt)
    lw, lf = build.library("mpem3_staged", mw), build.library("mpem3_staged",
                                                              mf)
    st = torch.cuda.current_stream().cuda_stream
    geo = {k: {v: fs.mpem3_geometry(Db, qi, qj, sr, s, torch.float32, layout,
                                    v) for v in ("base", "staged")}
           for k, s in (("w", None), ("f", sl))}
    smem_w = (_plan_smem(D, qj, layout, None, gt) if gt
              else geo["w"]["staged"][2])
    smem_f = (_plan_smem(D, qj, layout, sl, gt) if gt
              else geo["f"]["staged"][2])
    return {
        ("w", "base"): lambda a: base.stta_mpem3_w(
            0, *a, geo["w"]["base"][1], geo["w"]["base"][2], st),
        ("w", "staged"): lambda a: lw.mpem3_w_staged(*a, smem_w, st),
        ("f", "base"): lambda a: base.stta_mpem3_f(
            0, *a, geo["f"]["base"][1], geo["f"]["base"][2], st),
        ("f", "staged"): lambda a: lf.mpem3_f_staged(*a, smem_f, st),
    }


def _plan_smem(D, qj, layout, sl, gt):
    Db, qi, qj, sr, _ = shape(D, qj)
    return 4 * fs._mpem3_staged_plan(Db, qi, qj, sr, sl, 4, layout, gt)[4]


def time_both(D, launch, dev, gt=None, S=15, reps=5):
    """Both kernels of both scans of one conversion, in turns; one JSON line
    a scan."""
    name, Bn, qj, layout = launch
    Db, qi, qj, sr, sl = shape(D, qj)
    B1, Psi, Phi, S0 = inputs(Bn, S, Db, qi, qj, sr, sl, layout, dev)
    assert fs.mpem3_layout(B1, Psi, Phi) == layout
    Ws = fs.mpem3_wscan(B1, Psi)
    out_w = torch.empty_like(Ws)
    Ns = B1.new_empty((Bn, S, sl, qi, qj, sr))
    Ms = B1.new_empty((Bn, S, sl, sr))
    run = _launchers(D, qj, layout, gt)
    sB = fs._strides(B1)
    args = {"w": (B1.data_ptr(), sB, Psi.data_ptr(), out_w.data_ptr(), Bn,
                  S, Db, qi, qj, sr),
            "f": (B1.data_ptr(), sB, Phi.data_ptr(), Ws.data_ptr(),
                  S0.data_ptr(), Ns.data_ptr(), Ms.data_ptr(), Bn, S, Db, qi,
                  qj, sr, sl)}
    for kern in ("f", "w"):
        ms, outs = {"base": [], "staged": []}, {}

        def launch_one(v):
            rc = run[(kern, v)](args[kern])
            if rc != 0:
                raise RuntimeError(f"{kern} {v}: CUDA error {rc}")
        for v in ("base", "staged", "staged", "base"):
            ms[v].append(tcuda(lambda: launch_one(v), reps))
            launch_one(v)
            torch.cuda.synchronize()
            outs[v] = (out_w.clone(),) if kern == "w" else (Ns.clone(),
                                                            Ms.clone())
        scale = max(float(o.abs().max()) for o in outs["base"])
        err = max(float((a - b).abs().max())
                  for a, b in zip(outs["staged"], outs["base"]))
        row = {"kernel": f"mpem3_{kern}", "launch": name, "D": D, "Bn": Bn,
               "S": S, "qj": qj, "layout": layout, "gt": gt,
               "picked": fs.mpem3_geometry(
                   Db, qi, qj, sr, None if kern == "w" else sl,
                   torch.float32, layout)[0],
               "macros": targets(D, qj, layout, gt)[kern == "f"][1]}
        for v, t in ms.items():
            row[f"ms_{v}"] = sum(t) / len(t)
            row[f"ms_{v}_runs"] = t
        row["speedup"] = row["ms_base"] / row["ms_staged"]
        row["staged_vs_base_rel"] = err / scale
        emit(**row)
    del B1, Psi, Phi, S0, Ws, Ns, Ms, out_w


def attribute(D, launch, dev, gt=None, S=15):
    """Clock64 shares of each phase of the staged kernels' steps."""
    name, Bn, qj, layout = launch
    Db, qi, qj, sr, sl = shape(D, qj)
    B1, Psi, Phi, S0 = inputs(Bn, S, Db, qi, qj, sr, sl, layout, dev)
    Ws = fs.mpem3_wscan(B1, Psi)
    Ns = B1.new_empty((Bn, S, sl, qi, qj, sr))
    Ms = B1.new_empty((Bn, S, sl, sr))
    st = torch.cuda.current_stream().cuda_stream
    counts = (ctypes.c_ulonglong * 8)()
    for (src, macros), kern in zip(targets(D, qj, layout, gt,
                                           ("M3_CLOCKS=1",)), ("w", "f")):
        lib = build.library(src, macros)
        smem = _plan_smem(D, qj, layout, None if kern == "w" else sl, gt) \
            if gt else fs.mpem3_geometry(
                Db, qi, qj, sr, None if kern == "w" else sl, torch.float32,
                layout, "staged")[2]
        lib.mpem3_staged_clocks(counts)                       # reset
        a = ((B1.data_ptr(), fs._strides(B1), Psi.data_ptr(),
              torch.empty_like(Ws).data_ptr(), Bn, S, Db, qi, qj, sr)
             if kern == "w" else
             (B1.data_ptr(), fs._strides(B1), Phi.data_ptr(), Ws.data_ptr(),
              S0.data_ptr(), Ns.data_ptr(), Ms.data_ptr(), Bn, S, Db, qi, qj,
              sr, sl))
        f = lib.mpem3_w_staged if kern == "w" else lib.mpem3_f_staged
        ms = tcuda(lambda: f(*a, smem, st), 3)
        torch.cuda.synchronize()
        rc = lib.mpem3_staged_clocks(counts)
        if rc != 0:
            raise RuntimeError(f"clock read: CUDA error {rc}")
        total = sum(counts) or 1
        emit(kernel=f"mpem3_{kern}_staged", launch=name, D=D, gt=gt,
             ms_with_clocks=ms,
             shares={p: counts[k] / total
                     for k, p in enumerate(PHASES[kern]) if p})
    del B1, Psi, Phi, S0, Ws, Ns, Ms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_mpem3: no CUDA device")
    dev = torch.device("cuda")
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    bonds = list(BONDS)
    for a in sys.argv:
        if a.startswith("--bonds="):
            bonds = [int(d) for d in a[len("--bonds="):].split(",")]
    gt = next((int(a[len("--gt="):]) for a in sys.argv
               if a.startswith("--gt=")), None)
    attr = "--attribute" in sys.argv
    tg = []
    for D in bonds:
        for _, _, qj, layout in LAUNCHES:
            tg += targets(D, qj, layout, gt)
            if attr and D in BENCH:
                tg += targets(D, qj, layout, gt, ("M3_CLOCKS=1",))
    build.build_all(["stta_scans"] + tg)
    _ptxas(build.build_log("stta_scans"), "mpem3_w_kernelIf")
    _ptxas(build.build_log("stta_scans"), "mpem3_f_kernelIf")
    for name, m in tg:
        if "M3_CLOCKS=1" in m:
            continue
        print(" ".join(m), end=" ", flush=True)
        _ptxas(build.build_log(name, m), "staged_kernel")
    for D in bonds:
        for launch in LAUNCHES:
            time_both(D, launch, dev, gt)
            if attr and D in BENCH:
                attribute(D, launch, dev, gt)


if __name__ == "__main__":
    main()
