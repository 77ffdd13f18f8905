"""Where a wide merge kernel's launch time goes, on the card.

    python3 -m matrixproductbp_tpu_torch.tools.probe_merge_wide [--reps=3]
        [--threads=256,384,512]

One JSON line per shape and kind.  Builds copies of ``merge_wide.cu`` with
one part left out (wrong results, the same launch, clusters and barriers:
``VARIANTS``), at each of ``SHAPES`` (the Glauber D=18 sweep's K4, K8 and
K9 buckets, banded, at their merge batch, and the f64 sketch merge [1024,
15] at D=20), and times each beside the whole kernel with CUDA events; the
share of a part is 1 - variant / whole.  ``--threads`` then builds the
whole kernels with each number of threads a block (``WD_NT``, and the tiles
the geometry picks for it) and times them in turns (first to last, last to
first).  Needs a CUDA card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.tools.probe_merge_streamed import (SHAPES,
                                                                   inputs,
                                                                   tcuda)

SOURCE = os.path.join(os.path.dirname(build.__file__), "..", "csrc",
                      "merge_wide.cu")
#: variant: edits of the source, each (text, replacement, times it occurs)
VARIANTS = {
    # every product returns at once: staging, barriers, the cluster
    # exchange and the rescale remain
    "without_products": [(
        "                                     int n0n, int k0n) {\n"
        "  if constexpr (F64)",
        "                                     int n0n, int k0n) {\n"
        "  if (m0n >= 0) return;\n  if constexpr (F64)", 1)],
    # the FMAs (and the operand loads they read) of the FP32 products
    "without_fmas": [("c[u][v] += av[u] * bv[v];", "c[u][v] += T(0);", 1)],
    # the cp.async copies of the step's operands
    "without_staging": [("__pipeline_memcpy_async(",
                         "if (false) __pipeline_memcpy_async(", None),
                        ("async_copy(Wb, ", "if (false) async_copy(Wb, ",
                         None)],
    # the distributed shared memory reads (each block its own slice)
    "without_exchange": [("v += peer[r][o];", "v += T(0);", 1),
                         ("const T v = peer[rr][", "const T v = peer[rank][",
                          1)],
}


def emit(**kv):
    print(json.dumps(kv), flush=True)


def variant_source(text, edits):
    """The source with ``edits`` applied; raises where a text occurs another
    number of times than the edit says (None: at least once)."""
    for old, new, times in edits:
        n = text.count(old)
        if (times is None and n == 0) or (times is not None and n != times):
            raise RuntimeError(f"merge_wide.cu holds {old!r} {n} times")
        text = text.replace(old, new)
    return text


def _kinds(dims, banded, dtype):
    """(kind, macros) of the wide builds of one shape."""
    off = (0,) if banded else ()
    return [("w", fs.merge_wide_macros("w", *dims[:5], 0, dtype, *off)),
            ("f", fs.merge_wide_macros("f", *dims, dtype, *off))]


def _set_threads(nt):
    fs._WIDE_THREADS = nt
    fs._wide_plan.cache_clear()
    fs.merge_wide_macros.cache_clear()


def time_threads(shapes, nts, dev, reps):
    """The whole kernels at each number of threads a block, in turns."""
    default = fs._WIDE_THREADS
    builds = []
    for nt in nts:
        _set_threads(nt)
        builds += [("merge_wide", m) for _, _, dims, banded, dtype in shapes
                   for _, m in _kinds(dims, banded, dtype)]
    build.build_all(builds)
    try:
        for name, Bn, dims, banded, dtype in shapes:
            L1, B1, Th, Pyy, Phi, S0 = inputs(Bn, dims, banded, dtype, dev)
            Ws = fs.merge_wscan_plain(L1, B1, Th)
            yy = {"yy_off": 0} if banded else {}
            for kind, run in (
                    ("w", lambda: fs.merge_wscan(L1, B1, Th, **yy)),
                    ("f", lambda: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0,
                                                 **yy))):
                turns = {nt: [] for nt in nts}
                for nt in list(nts) + list(nts)[::-1]:
                    _set_threads(nt)
                    turns[nt].append(tcuda(run, reps))
                emit(shape=name, kind=kind, B=Bn, threads_ms_turns=turns)
    finally:
        _set_threads(default)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_merge_wide: no CUDA device")
    dev = torch.device("cuda")
    shapes = [s for s in SHAPES
              if fs.merge_f_geometry(*s[2], s[4], band=s[3])[0] == "wide"]
    out_dir = os.path.join(build.BUILD_DIR, "probe_merge_wide")
    os.makedirs(out_dir, exist_ok=True)
    with open(SOURCE) as fh:
        text = fh.read()
    csrc = os.path.dirname(SOURCE)
    procs, wholes = {}, []
    for name, _, dims, banded, dtype in shapes:
        for kind, macros in _kinds(dims, banded, dtype):
            wholes.append(("merge_wide", macros))
            for v, edits in VARIANTS.items():
                if v == "without_fmas" and dtype == torch.float64:
                    continue
                stem = os.path.join(out_dir, f"{len(procs)}")
                with open(stem + ".cu", "w") as fh:
                    fh.write(variant_source(text, edits))
                procs[(name, kind, v)] = (stem, subprocess.Popen(
                    [build._nvcc(), *build._flags(macros), "-I", csrc,
                     "-o", stem + ".so", stem + ".cu"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
    build.build_all(wholes)
    libs = {}
    for key, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        for fn, argtypes in build._SIGNATURES["merge_wide"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    emit(device=torch.cuda.get_device_name(0), smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    real = build.library
    for name, Bn, dims, banded, dtype in shapes:
        L1, B1, Th, Pyy, Phi, S0 = inputs(Bn, dims, banded, dtype, dev)
        Ws = fs.merge_wscan_plain(L1, B1, Th)
        yy = {"yy_off": 0} if banded else {}
        for kind, run in (
                ("w", lambda: fs.merge_wscan(L1, B1, Th, **yy)),
                ("f", lambda: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0,
                                             **yy))):
            ms = {"whole": tcuda(run, a.reps)}
            for v in VARIANTS:
                lib = libs.get((name, kind, v))
                if lib is None:
                    continue
                build.library = (lambda n, d=(), lib=lib:
                                 lib if n == "merge_wide" else real(n, d))
                try:
                    ms[v] = tcuda(run, a.reps)
                finally:
                    build.library = real
            ms["whole_again"] = tcuda(run, a.reps)
            emit(shape=name, kind=kind, B=Bn, ms=ms, share={
                v: 1 - t / ms["whole"] for v, t in ms.items()
                if v.startswith("without")})
    if a.threads:
        time_threads(shapes, [int(n) for n in a.threads.split(",")], dev,
                     a.reps)


if __name__ == "__main__":
    sys.exit(main())
