"""The merge W kernels on the card: their build reports and their time per
call, side by side on the same inputs.

    python3 -m matrixproductbp_tpu_torch.tools.probe_merge_w [--attribute]
        [--bonds=10,20]

One JSON line per reading.  Builds ``stta_scans`` (``merge_w_kernel``) and
``merge_w_staged`` at every shape of ``SHAPES`` (``--bonds`` keeps the
shapes of those D), all at once, and prints the ptxas report of each merge
W build; then times ``merge_w_kernel`` and ``merge_w_staged_kernel`` with
CUDA events on the same f32 inputs, in turns (base, staged, staged, base),
at [8192, 15] and each shape: the SIS sketch merge at bond D (``DL = DB =
sr = D``, Y = q = 2) and two with ``DL != DB``.  Their agreement with the
plain version is ``tests/test_torch_gpu.py -k merge_w`` (run on the card).

``--attribute`` says where a launch's time goes at the bench shapes of the
shapes timed (``BENCH``: D=10 and D=20): it builds copies of each kernel's
source with one product (or the staging, or the stores) left out (wrong
results, same control flow and barriers; ``VARIANTS``, applied by
``probe_merge_f.variant_sources``; ``tests/test_torch_merge_w_geometry.py``
checks that every line still exists) and times each beside the whole
kernel.  Needs a CUDA card.
"""
import ctypes
import os
import subprocess
import sys

import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.tools.probe_merge_f import (
    CSRC, _ptxas, emit, tcuda, variant_sources)

SOURCE = {"merge_w_kernel": os.path.join(CSRC, "stta_scans.cu"),
          "merge_w_staged_kernel": os.path.join(CSRC, "merge_w_staged.cu")}
#: the bench shapes (DL, DB, Y, q, sr) that --attribute takes apart
BENCH = [(10, 10, 2, 2, 10), (20, 20, 2, 2, 20)]
#: (DL, DB, Y, q, sr) timed
SHAPES = [(D, D, 2, 2, D) for D in (4, 6, 8, 10, 12, 14, 16, 17, 18, 19,
                                    20)] + [(10, 5, 2, 2, 10),
                                            (20, 16, 2, 2, 20)]

_STAGED = "merge_w_staged_kernel"
# variant: (kernel, [(text inside its body, replacement), ...])
VARIANTS = {
    "base_without_t1": ("merge_w_kernel", [(
        "block_gemm<T, false>(Bs + x, Wc, t1, ga);", "")]),
    "base_without_u": ("merge_w_kernel", [(
        "block_gemm<T, false>(t1, Tt + x * Y * Y * sr * sr, u, gb);", "")]),
    "base_without_W2": ("merge_w_kernel", [(
        "block_gemm<T, true>(Ls + x, u, W2, gc);", "")]),
    "staged_without_t1": (_STAGED, [("prod_t1(Bc, W, t1, n0);", "")]),
    "staged_without_u": (_STAGED, [("prod_u(t1, Tc, u);", "")]),
    "staged_without_W2": (_STAGED, [(
        "if (owner) prod_w2(Lc, u, acc, cti, ctj, n0);", "")]),
    "staged_without_staging": (_STAGED, [(
        "if (s > 0) stage_step(s - 1);", "")]),
    "staged_without_stores": (_STAGED, [(
        "if (s < S - 1) store_w(s + 1);", "")]),
}


def read_sources():
    out = {}
    for kernel, path in SOURCE.items():
        with open(path) as fh:
            out[kernel] = fh.read()
    return out


def inputs(Bn, S, DL, DB, Y, q, sr, dev, seed=0):
    """Random f32 merge W inputs as the sweep hands them over (L1, B1
    strided views)."""
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, dtype=torch.float64).to(
            dev, torch.float32)
    return (r(Bn, S + 1, DL, DL, Y, q)[:, 1:],
            r(Bn, S + 1, DB, DB, Y, q)[:, 1:], r(S, sr, sr, Y, Y, q))


def _target(dims):
    return "merge_w_staged", fs.merge_w_staged_macros(*dims, torch.float32)


def time_both(dims, dev, Bn=8192, S=15, reps=5):
    """merge_w_kernel and the staged kernel on the same inputs, in turns;
    one JSON line."""
    args = inputs(Bn, S, *dims, dev, seed=11)
    ms = {"base": [], "staged": []}
    outs = {}
    for variant in ("base", "staged", "staged", "base"):
        run = lambda: fs.merge_wscan(*args, _variant=variant)  # noqa: E731
        ms[variant].append(tcuda(run, reps))
        outs[variant] = run()
    scale = float(outs["base"].abs().max())
    row = {"dims": dict(zip(("DL", "DB", "Y", "q", "sr"), dims)), "Bn": Bn,
           "S": S, "dtype": "float32",
           "smem": fs.merge_w_geometry(*dims, torch.float32, "staged")[2],
           "picked": fs.merge_w_geometry(*dims, torch.float32)[0],
           "macros": _target(dims)[1]}
    for v, t in ms.items():
        row[f"ms_{v}"] = sum(t) / len(t)
        row[f"ms_{v}_runs"] = t
    row["speedup"] = row["ms_base"] / row["ms_staged"]
    row["vs_base_rel"] = float((outs["staged"] - outs["base"]).abs().max()) \
        / scale
    emit(**row)
    return args


def attribute(dev, dims, args, Bn=8192, S=15, reps=10):
    """Time both kernels and their VARIANTS at dims, on the same inputs;
    one JSON line with each variant's time and the share of the whole
    kernel's time that what it leaves out takes."""
    _, macros = _target(dims)
    out_dir = os.path.join(build.BUILD_DIR, "probe_merge_w")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variant_sources(read_sources(), VARIANTS).items():
        cu = os.path.join(out_dir, f"{name}_{dims[0]}x{dims[1]}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        flags = build._flags(() if name.startswith("base") else macros)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *flags, "-I", CSRC, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
    L1, B1, Th = args
    Ws = L1.new_empty((Bn, S, dims[0], dims[1], dims[4]))
    libs = {"base": build.library("stta_scans"),
            "staged": build.library(*_target(dims))}
    libs.update({n: ctypes.CDLL(os.path.join(
        out_dir, f"{n}_{dims[0]}x{dims[1]}.so")) for n in procs})
    row = {"dims": dims, "Bn": Bn, "S": S}
    st = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        variant = name.split("_")[0]
        _, threads, smem = fs.merge_w_geometry(*dims, torch.float32, variant)
        src, fn = (("stta_scans", "stta_merge_w") if variant == "base"
                   else ("merge_w_staged", "merge_w_staged"))
        f = getattr(lib, fn)
        f.argtypes = build._SIGNATURES[src][fn]
        f.restype = ctypes.c_int
        ptrs = (L1.data_ptr(), fs._strides(L1), B1.data_ptr(),
                fs._strides(B1), Th.data_ptr(), Ws.data_ptr(), Bn, S, *dims)

        def launch():
            rc = (f(0, *ptrs, threads, smem, st) if variant == "base"
                  else f(*ptrs, smem, st))
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        row[f"ms_{name}"] = tcuda(launch, reps)
    for name in procs:
        whole_ms = row["ms_" + name.split("_")[0]]
        row[f"share_{name}"] = 1 - row[f"ms_{name}"] / whole_ms
    emit(**row)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_merge_w: no CUDA device")
    dev = torch.device("cuda")
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    shapes = BENCH + [d for d in SHAPES if d not in BENCH]
    bonds = [a[len("--bonds="):] for a in sys.argv if a.startswith("--bonds=")]
    if bonds:
        keep = {int(d) for d in bonds[0].split(",")}
        shapes = [d for d in shapes if d[0] in keep]
    targets = [_target(d) for d in shapes]
    build.build_all(["stta_scans"] + targets)
    _ptxas(build.build_log("stta_scans"), "merge_w_kernelIf")
    for name, m in targets:
        print(" ".join(m), end=" ", flush=True)
        _ptxas(build.build_log(name, m), name)
    for d in shapes:
        args = time_both(d, dev)
        if "--attribute" in sys.argv and d in BENCH:
            attribute(dev, d, args)
        del args


if __name__ == "__main__":
    main()
