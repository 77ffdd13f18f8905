"""The CholQR kernels on the card: their build reports and their time per
call, side by side on the same inputs.

    python3 -m matrixproductbp_tpu_torch.tools.probe_cholqr [--attribute]
        [--bonds=10,20] [--minb=3,4,5,6] [--dmma]

One JSON line per reading.  Builds ``cholqr`` (``cholqr_kernel``) and
``cholqr_staged`` at every shape of ``SHAPES`` (``--bonds`` keeps the
shapes of those D), all at once, and prints the ptxas report of each
build; then times ``cholqr_kernel`` and ``cholqr_staged_kernel`` with CUDA
events on the same float32 inputs, in turns (base, staged, staged, base),
at [8192, 4s, s], s = 2D: the randomized merge's projection at bond D for
D = 4 to 20.  Their agreement with the plain version is
``tests/test_torch_gpu.py -k cholqr`` (run on the card).

``--attribute`` says where a launch's time goes at the bench shapes
(``BENCH``: D=10 and D=20) of the shapes timed: it builds copies of the
staged source with one phase left out (wrong results, same control flow
and barriers; ``VARIANTS``, applied by ``probe_merge_f.variant_sources``;
``tests/test_torch_cholqr_geometry.py`` checks that every line still
exists) and times each beside the whole kernel.  ``--minb`` builds the
staged kernel at the bench shapes with each other register budget given
(``CQ_MINB``, the blocks an SM ``__launch_bounds__`` asks for) and times
each in turns with the one ``cholqr_geometry`` picks, beside its ptxas
report.  ``--dmma`` times the float64 tensor-core shapes the kernel can
use (``mma.m8n8k4`` and ``mma.m16n8k8``, independent accumulators, every
SM busy) and reports their TFLOP/s.  Needs a CUDA card.
"""
import ctypes
import os
import subprocess
import sys

import torch

from matrixproductbp_tpu_torch.ops import build, kernels
from matrixproductbp_tpu_torch.tools.probe_merge_f import (
    CSRC, _ptxas, emit, tcuda, variant_sources)

SOURCE = {"cholqr_staged_kernel": os.path.join(CSRC, "cholqr_staged.cu")}
#: the bench shapes (m, n) that --attribute takes apart
BENCH = [(80, 20), (160, 40)]
#: (m, n) timed: [4s, s], s = 2D, D = 4 to 20
SHAPES = [(8 * D, 2 * D) for D in range(4, 21)]

_STAGED = "cholqr_staged_kernel"
# variant: (kernel, [(text inside its body, replacement), ...])
VARIANTS = {
    "staged_without_staging": (_STAGED, [(
        "__pipeline_memcpy_async(As + r * LDA + col, a + r * N + col, "
        "VW * 4);", "")]),
    "staged_without_gram": (_STAGED, [(
        "dmma(acc[p], f0[2 * P], f0[2 * P + 1], f1[2 * P], f1[2 * P + 1],\n"
        "               f0[J], f1[J]);", "(void)0;")]),
    "staged_without_cholesky": (_STAGED, [
        ("if (k > j) v[k] -= tt * c.x;", ""),
        ("if (k + 1 < N) v[k + 1] -= tt * c.y;", "")]),
    "staged_without_inverse": (_STAGED, [
        ("if (i > jj) v[i] -= c.x * z;", ""),
        ("if (i + 1 < N) v[i + 1] -= c.y * z;", "")]),
    "staged_without_factor": (_STAGED, [
        ("if (k > j) v[k] -= tt * c.x;", ""),
        ("if (k + 1 < N) v[k + 1] -= tt * c.y;", ""),
        ("if (i > jj) v[i] -= c.x * z;", ""),
        ("if (i + 1 < N) v[i + 1] -= c.y * z;", "")]),
    "staged_without_q": (_STAGED, [(
        "dmma(acc[a][J], fa[a][0], fa[a][1], fa[a][2], fa[a][3], b0, b1);",
        "(void)0;")]),
    "staged_without_stores": (_STAGED, [
        ("rr[e] = out;", ""),
        ("store_q(q + row * N + col, acc[a][J][2 * h],\n"
         "                    acc[a][J][2 * h + 1], col + 1 < N);",
         "(void)0;")]),
}


def read_sources():
    out = {}
    for kernel, path in SOURCE.items():
        with open(path) as fh:
            out[kernel] = fh.read()
    return out


def _target(shape):
    return "cholqr_staged", kernels.cholqr_staged_macros(*shape)


def inputs(Bn, m, n, dev, seed=0):
    """Gaussian float32 A [Bn, m, n], every third instance rank 1."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((Bn, m, n), generator=g, dtype=torch.float64)
    A[::3] = A[::3, :, :1] * A[::3, :1, :]
    return A.to(dev, torch.float32)


def time_both(shape, dev, Bn=8192, reps=10):
    """cholqr_kernel and the staged kernel on the same inputs, in turns;
    one JSON line."""
    A = inputs(Bn, *shape, dev, seed=11)
    ms = {"base": [], "staged": []}
    outs = {}
    for variant in ("base", "staged", "staged", "base"):
        run = lambda: kernels.cholqr(A, _variant=variant)  # noqa: E731
        ms[variant].append(tcuda(run, reps))
        outs[variant] = run()
    scale = max(float(t.abs().max()) for t in outs["base"])
    ipb, blocks, qr, threads, smem = kernels._cholqr_staged_plan(*shape)
    row = {"m": shape[0], "n": shape[1], "Bn": Bn, "dtype": "float32",
           "smem": smem, "threads": threads, "instances_a_block": ipb,
           "blocks_an_sm": blocks, "q_tiles_a_pass": qr,
           "picked": kernels.cholqr_geometry(*shape, torch.float32)[0]}
    for v, t in ms.items():
        row[f"ms_{v}"] = sum(t) / len(t)
        row[f"ms_{v}_runs"] = t
    row["speedup"] = row["ms_base"] / row["ms_staged"]
    row["vs_base_rel"] = max(float((a - b).abs().max()) for a, b in zip(
        outs["staged"], outs["base"])) / scale
    emit(**row)
    return A


def attribute(shape, A, reps=20):
    """Time the staged kernel and its VARIANTS at ``shape`` on the same
    inputs; one JSON line with each variant's time and the share of the
    whole kernel's time that what it leaves out takes."""
    _, macros = _target(shape)
    out_dir = os.path.join(build.BUILD_DIR, "probe_cholqr")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variant_sources(read_sources(), VARIANTS).items():
        cu = os.path.join(out_dir, f"{name}_{shape[0]}x{shape[1]}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build._flags(macros), "-I", CSRC, "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
    Bn, (m, n) = A.shape[0], shape
    Q, R = torch.empty_like(A), A.new_empty((Bn, n, n))
    smem = kernels.cholqr_geometry(m, n, torch.float32, "staged")[2]
    libs = {"staged": build.library(*_target(shape))}
    libs.update({k: ctypes.CDLL(os.path.join(
        out_dir, f"{k}_{m}x{n}.so")) for k in procs})
    row = {"m": m, "n": n, "Bn": Bn}
    st = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        f = lib.cholqr_staged
        f.argtypes = build._SIGNATURES["cholqr_staged"]["cholqr_staged"]
        f.restype = ctypes.c_int

        def launch():
            rc = f(A.data_ptr(), Q.data_ptr(), R.data_ptr(), Bn, m, n, 1e-6,
                   smem, st)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        row[f"ms_{name}"] = tcuda(launch, reps)
    for name in procs:
        row[f"share_{name}"] = 1 - row[f"ms_{name}"] / row["ms_staged"]
    emit(**row)


def other_minb(shape, values, A, reps=20):
    """The staged kernel at ``shape`` built with each register budget in
    ``values`` and with the picked one, timed in turns; one JSON line."""
    picked = kernels.cholqr_staged_macros(*shape)
    builds = {int(m.split("=")[1]): ("cholqr_staged", picked)
              for m in picked if m.startswith("CQ_MINB=")}
    for v in values:
        builds.setdefault(v, ("cholqr_staged", tuple(
            m if not m.startswith("CQ_MINB=") else f"CQ_MINB={v}"
            for m in picked)))
    build.build_all(list(builds.values()))
    Bn, (m, n) = A.shape[0], shape
    Q, R = torch.empty_like(A), A.new_empty((Bn, n, n))
    smem = kernels.cholqr_geometry(m, n, torch.float32, "staged")[2]
    st = torch.cuda.current_stream().cuda_stream
    runs, row = {}, {"m": m, "n": n, "Bn": Bn, "picked": picked}
    fns = {v: (lambda lib=build.library(*t): lib.cholqr_staged(
        A.data_ptr(), Q.data_ptr(), R.data_ptr(), Bn, m, n, 1e-6, smem, st))
        for v, t in builds.items()}
    for v in list(fns) + list(fns)[::-1]:
        runs.setdefault(v, []).append(tcuda(fns[v], reps))
    for v, t in builds.items():
        log = build.build_log(*t)
        row[f"minb_{v}"] = {
            "ms": sum(runs[v]) / len(runs[v]), "ms_runs": runs[v],
            "ptxas": " | ".join(x.strip() for x in log.splitlines()
                                if "Used" in x or "spill" in x)}
    emit(**row)


#: the float64 tensor-core rate of two mma shapes: each warp keeps 8
#: independent accumulators and issues 2048 rounds of them
DMMA_SOURCE = r"""
#include <cuda_runtime.h>
template <int SHAPE>
__global__ void rate(double* out) {
  const double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  double d[8][4] = {};
  for (int it = 0; it < 2048; ++it)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (SHAPE == 0)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1}, {%2}, {%3}, {%0,%1};"
                     : "+d"(d[q][0]), "+d"(d[q][1]) : "d"(a), "d"(b));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+d"(d[q][0]), "+d"(d[q][1]), "+d"(d[q][2]),
                       "+d"(d[q][3])
                     : "d"(a), "d"(b), "d"(a), "d"(b), "d"(a), "d"(b));
    }
  double s = 0;
  for (int q = 0; q < 8; ++q) s += d[q][0] + d[q][1] + d[q][2] + d[q][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int dmma_rate(int shape, double* out, int blocks) {
  if (shape == 0) rate<0><<<blocks, 128>>>(out);
  else rate<1><<<blocks, 128>>>(out);
  return (int)cudaGetLastError();
}
"""


def dmma_rates():
    """TFLOP/s of mma.m8n8k4.f64 and mma.m16n8k8.f64 with every SM busy
    (four blocks of four warps an SM); one JSON line."""
    out_dir = os.path.join(build.BUILD_DIR, "probe_cholqr")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "dmma_rate.cu")
    with open(cu, "w") as fh:
        fh.write(DMMA_SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", cu[:-3] + ".so",
                    cu], check=True, capture_output=True)
    lib = ctypes.CDLL(cu[:-3] + ".so")
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 128, dtype=torch.float64, device="cuda")
    row = {}
    for shape, name, fma in ((0, "m8n8k4", 8 * 8 * 4), (1, "m16n8k8",
                                                        16 * 8 * 8)):
        ms = tcuda(lambda: lib.dmma_rate(shape, ctypes.c_void_p(
            out.data_ptr()), blocks), 5)
        mmas = blocks * 4 * 2048 * 8
        row[name] = {"ms": ms, "tflops": 2 * fma * mmas / ms / 1e9}
    emit(dmma=row)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_cholqr: no CUDA device")
    dev = torch.device("cuda")
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    shapes = BENCH + [s for s in SHAPES if s not in BENCH]
    bonds = [a[len("--bonds="):] for a in sys.argv if a.startswith("--bonds=")]
    if bonds:
        keep = {int(d) for d in bonds[0].split(",")}
        shapes = [s for s in shapes if s[1] // 2 in keep]
    targets = [_target(s) for s in shapes]
    build.build_all(["cholqr"] + targets)
    _ptxas(build.build_log("cholqr"), "cholqr_kernelIf")
    for name, m in targets:
        print(" ".join(m), end=" ", flush=True)
        _ptxas(build.build_log(name, m), _STAGED)
    minb = [a[len("--minb="):] for a in sys.argv if a.startswith("--minb=")]
    for s in shapes:
        A = time_both(s, dev)
        if "--attribute" in sys.argv and s in BENCH:
            attribute(s, A)
        if minb and s in BENCH:
            other_minb(s, [int(v) for v in minb[0].split(",")], A)
        del A
    if "--dmma" in sys.argv:
        dmma_rates()


if __name__ == "__main__":
    main()
