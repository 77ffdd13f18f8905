"""The streamed merge kernels on the card: their build report, their time
per call beside the kernel each shape takes otherwise (the wide cluster
kernels at the Glauber D=18 buckets and the f64 D=20 merge), and where a
launch's time goes.

    python3 -m matrixproductbp_tpu_torch.tools.probe_merge_streamed
        [--attribute] [--reps=3]

One JSON line per reading.  Builds ``merge_streamed`` and prints the ptxas
report of its four kernels (merge W and F, f32 and f64); then, at each of
``SHAPES`` (the Glauber D=18 sweep's K4, K8 and K9 buckets, banded, at
their merge batch; the f64 sketch merge [1024, 15] at D=20; and two shapes
that other kernels take, the D=10 bench merge and the Glauber K8 bucket at
D=10), times ``merge_w_streamed_kernel`` and ``merge_f_streamed_kernel``
with CUDA events, and where ``merge_*_geometry`` picks another kernel (for
the banded shapes, told the band), that kernel in turns with them (picked,
streamed, streamed, picked), each beside its error against the plain scan
(relative to the plain output's max-abs); the ptxas report of each wide
build it picks.

``--attribute`` builds copies of ``merge_streamed.cu`` with the operand
gather, the tile products' FMAs, or both left out (wrong results, the same
barriers, tables, epilogues and the work between the products:
``VARIANTS``) and times each beside the whole kernel; the share of each
part is 1 - variant / whole.  Needs a CUDA card.
"""
import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

import torch

from matrixproductbp_tpu_torch.ops import build, sumy
from matrixproductbp_tpu_torch.ops import fused_stta as fs

SOURCE = os.path.join(os.path.dirname(build.__file__), "..", "csrc",
                      "merge_streamed.cu")
#: (name, instances, (DL, DB, Y, q, sr, sl), banded, dtype)
SHAPES = [("glauber K4 D=18", 1708, (18, 18, 5, 2, 18, 22), True,
           torch.float32),
          ("glauber K8 D=18", 592, (18, 18, 9, 2, 18, 22), True,
           torch.float32),
          ("glauber K9 D=18", 3, (18, 18, 10, 2, 18, 22), True,
           torch.float32),
          ("f64 D=20", 1024, (20, 20, 2, 2, 20, 24), False, torch.float64),
          ("bench D=10", 8192, (10, 10, 2, 2, 10, 14), False,
           torch.float32),
          ("glauber K8 D=10", 592, (10, 10, 9, 2, 10, 14), True,
           torch.float32)]
_GATHERS = [
    ("    gather(v, A, B, ra, cb, kA, kB, nra, nrb, k0a, dka, k0b, dkb);",
     "    for (int r = 0; r < PER; ++r) v[r] = T(0);"),
    ("      if (kc + 1 < nk)                // in flight during the "
     "products", "      if (false)")]
_FMAS = [("for (int s = 0; s < 4; ++s) c[r][s] += a[r] * b[s];",
          "for (int s = 0; s < 4; ++s) c[r][s] += T(0);")]
#: variant: edits of the source, each (text found exactly once, replacement)
VARIANTS = {"without_gather": _GATHERS, "without_fmas": _FMAS,
            "without_both": _GATHERS + _FMAS}


def emit(**kv):
    print(json.dumps(kv), flush=True)


def tcuda(fn, n):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def variant_source(text, edits):
    """The source with ``edits`` applied; raises if a text to replace is not
    in it exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"merge_streamed.cu does not hold {old!r} "
                               "exactly once")
        text = text.replace(old, new)
    return text


def inputs(Bn, dims, banded, dtype, dev, S=15, seed=0):
    """L1, B1 (strided views, as the sweep hands them over), Th, Pyy (the
    banded merge's y_expand-ed Th and band indicator where ``banded``), Phi
    and S_init."""
    DL, DB, Y, q, sr, sl = dims
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, dtype=torch.float64,
                           device=dev).to(dtype)
    L1 = r(Bn, S + 1, DL, DL, Y, q)[:, 1:]
    B1 = r(Bn, S + 1, DB, DB, Y, q)[:, 1:]
    if banded:
        Th = sumy.y_expand(r(S, sr, sr, Y, q), 0, axis=3,
                           mode="sum").contiguous()
        Pyy = sumy.band_indicator(Y, 0, q, dtype, dev)
    else:
        Th = r(S, sr, sr, Y, Y, q)
        Pyy = torch.rand((Y, Y, Y, q), generator=g, dtype=torch.float64,
                         device=dev).to(dtype)
    return L1, B1, Th, Pyy, r(S, sl, sl, Y, q), r(Bn, sl, DL, DB)


@contextlib.contextmanager
def streamed_library(lib):
    """Launch the streamed kernels from ``lib`` (a variant's build)."""
    real = build.library

    def library(name, defines=()):
        return lib if name == "merge_streamed" else real(name, defines)
    fs.build.library = library
    try:
        yield
    finally:
        fs.build.library = real


def _rel_err(out, ref):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(out, ref))


def time_shape(name, Bn, dims, banded, dtype, dev, reps):
    L1, B1, Th, Pyy, Phi, S0 = inputs(Bn, dims, banded, dtype, dev)
    Ws = fs.merge_wscan_plain(L1, B1, Th)
    picks = (fs.merge_w_geometry(*dims[:5], dtype, band=banded)[0],
             fs.merge_f_geometry(*dims, dtype, band=banded)[0])
    yy = {"yy_off": 0} if banded else {}
    scans = {
        "w": (lambda v: fs.merge_wscan(L1, B1, Th, _variant=v, **yy),
              fs.merge_wscan_plain(L1, B1, Th)),
        "f": (lambda v: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0,
                                       _variant=v, **yy),
              fs.merge_fscan_plain(L1, B1, Pyy, Phi, Ws, S0))}
    row = {"shape": name, "B": Bn, "dims": dims, "dtype": str(dtype)[6:],
           "picked": picks}
    for (kind, (run, ref)), pick in zip(scans.items(), picks):
        kernels = dict.fromkeys((pick, "streamed"))
        turns = {v: [] for v in kernels}
        for v in list(kernels) + list(kernels)[::-1]:
            turns[v].append(tcuda(lambda v=v: run(v), reps))
        row[kind] = {v: {"ms_turns": t, "rel_err": _rel_err(run(v), ref)}
                     for v, t in turns.items()}
    emit(**row)


def attribute(shapes, dev, reps):
    out_dir = os.path.join(build.BUILD_DIR, "probe_merge_streamed")
    os.makedirs(out_dir, exist_ok=True)
    with open(SOURCE) as fh:
        text = fh.read()
    procs = {}
    for name, edits in VARIANTS.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as fh:
            fh.write(variant_source(text, edits))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build._flags(), "-I",
             os.path.dirname(SOURCE), "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"whole": build.library("merge_streamed")}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        for fn, argtypes in build._SIGNATURES["merge_streamed"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    for name, Bn, dims, banded, dtype in shapes:
        L1, B1, Th, Pyy, Phi, S0 = inputs(Bn, dims, banded, dtype, dev)
        Ws = fs.merge_wscan_plain(L1, B1, Th)
        row = {"shape": name, "B": Bn, "dims": dims}
        for kind, run in (
                ("w", lambda: fs.merge_wscan(L1, B1, Th,
                                             _variant="streamed")),
                ("f", lambda: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0,
                                             _variant="streamed"))):
            ms = {}
            for v, lib in libs.items():
                with streamed_library(lib):
                    ms[v] = tcuda(run, reps)
            row[kind] = {"ms": ms, "share": {
                v: 1 - t / ms["whole"] for v, t in ms.items()
                if v != "whole"}}
        emit(**row)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--attribute", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_merge_streamed: no CUDA device")
    dev = torch.device("cuda")
    build.build_all(["merge_streamed"])
    log = build.build_log("merge_streamed")
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln:
            print("ptxas:", " ".join(x.strip() for x in lines[i:i + 4]
                                     if "Compiling" in x or "Used" in x
                                     or "spill" in x), flush=True)
    emit(device=torch.cuda.get_device_name(0), smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    wide = [(kind, *dims[:6 if kind == "f" else 5],
             *(() if kind == "f" else (0,)), dtype, *((0,) if banded else ()))
            for _, _, dims, banded, dtype in SHAPES for kind in ("w", "f")
            if (fs.merge_f_geometry(*dims, dtype, band=banded) if kind == "f"
                else fs.merge_w_geometry(*dims[:5], dtype,
                                         band=banded))[0] == "wide"]
    fs.build_merge_wide(wide)
    for shape in wide:
        print("ptxas wide", shape[:7], " ".join(
            ln.strip() for ln in build.build_log(
                "merge_wide", fs.merge_wide_macros(*shape)).splitlines()
            if "Used" in ln or "spill" in ln), flush=True)
    for shape in SHAPES:
        time_shape(*shape, dev, a.reps)
    if a.attribute:
        attribute(SHAPES, dev, a.reps)


if __name__ == "__main__":
    sys.exit(main())
