"""The merge F kernels on the card: their build reports and their time per
call, side by side on the same inputs.

    python3 -m matrixproductbp_tpu_torch.tools.probe_merge_f [--attribute]
        [--bonds=16,20]

One JSON line per reading.  Builds ``stta_scans`` (``merge_f_kernel``) and
the per-shape kernel (``merge_f_staged`` up to D=15, ``merge_f_cluster``
from D=16) at every shape of ``SHAPES``, all at once, and prints the ptxas
report of each merge F build; then times ``merge_f_kernel`` and the kernel
``merge_f_geometry`` picks with CUDA events on the same f32 inputs, in
turns (base, picked, picked, base), at [8192, 15] and each shape of
``SHAPES``: the SIS sketch merge at bond D (``DL = DB = sr = D``,
``sl = D + 4``) for D = 4 to 20, and one merge with ``DL != DB`` on each
side of D=15 (``--bonds`` keeps the shapes of those D).  Their agreement
with the plain version is ``tests/test_torch_gpu.py -k merge`` (run on the
card).

``--attribute`` says where a launch's time goes at the bench shapes
(``BENCH``: D=10, where the staged kernel runs, and D=20, the cluster
kernel's), of the shapes timed: it builds copies of each kernel's source
with products left out (wrong results, same control flow and barriers;
``VARIANTS``, made by replacing lines inside that kernel's body,
``variant_sources``; ``tests/test_torch_scans_geometry.py`` checks that
every line still exists) and times each beside the whole kernel.  Needs a
CUDA card.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from matrixproductbp_tpu_torch.ops import build
from matrixproductbp_tpu_torch.ops import fused_stta as fs

CSRC = os.path.join(os.path.dirname(build.__file__), "..", "csrc")
SOURCE = {"merge_f_kernel": os.path.join(CSRC, "stta_scans.cu"),
          "merge_f_staged_kernel": os.path.join(CSRC, "merge_f_staged.cu"),
          "merge_f_cluster_kernel": os.path.join(CSRC, "merge_f_cluster.cu")}
#: the bench shapes (DL, DB, Y, q, sr, sl) that --attribute takes apart,
#: at [8192, 15]
BENCH = [(10, 10, 2, 2, 10, 14), (20, 20, 2, 2, 20, 24)]
#: (DL, DB, Y, q, sr, sl) timed beside the bench shape
SHAPES = [(D, D, 2, 2, D, D + 4) for D in range(4, 21)] + [
    (10, 5, 2, 2, 10, 14), (20, 16, 2, 2, 20, 24)]

_M_BASE = ("block_gemm<T, false>(Sc, Wt, Ms + row * sl * sr, gm);", "")
_N_BASE = ("block_gemm<T, false>(t2, Wt1, Nyx, gn);", "")
_STAGED = "merge_f_staged_kernel"
_CLUSTER = "merge_f_cluster_kernel"
# variant: (kernel, [(text inside its body, replacement), ...])
VARIANTS = {
    "base_without_MN": ("merge_f_kernel", [_M_BASE, _N_BASE]),
    "base_without_t1": ("merge_f_kernel", [(
        "block_gemm<T, false>(Sc, Ls + x, t1, g1);", "")]),
    "base_without_t2": ("merge_f_kernel", [(
        "block_gemm<T, false>(t1, Bp, t2, g2);", "")]),
    "base_without_S2": ("merge_f_kernel", [(
        "block_gemm<T, true>(Fs + y * q + x, t2, S2, gs);", "")]),
    "staged_without_MN": (_STAGED, [
        ("tile_gemm<NT, T, 2, 5, 16, false>(Sb, Wt, Mo, gm);", ""),
        ("tile_gemm<NT, T, 4, 5, 4, false>(t2, Wt1, No, gn);", "")]),
    "staged_without_t1": (_STAGED, [(
        "tile_gemm<NT, T, 2, 10, 1, false>(Sb, Lc, t1, g1);", "")]),
    "staged_without_t2": (_STAGED, [(
        "tile_gemm<NT, T, 4, 5, 2, false>(t1, Bp, t2, g2);", "")]),
    "staged_without_S2": (_STAGED, [(
        "tile_gemm<NT, T, 2, 5, 1, false>(Fc, t2, Sb, gs);", "")]),
    "cluster_without_MN": (_CLUSTER, [
        ("tile_gemm<NT, T, 2, 5, 16, false>(Sb, Wt, Mo, gm);", ""),
        ("tile_gemm<NT, T, 4, 5, 16, false>(t2, Wt1, No + x * sr, gn);",
         "")]),
    "cluster_without_t1": (_CLUSTER, [
        ("tile_gemm<NT, T, 2, 10, 1, false>(Sb, Lc, t1, g1);", ""),
        ("tile_gemm<NT, T, 2, 10, 1, false>(Sb, Lc + x + 1, t1, g1);", "")]),
    "cluster_without_t2": (_CLUSTER, [(
        "tile_gemm<NT, T, 4, 5, 2, false>(t1, Bp + x * Y * nBp, t2, g2);",
        "")]),
    "cluster_without_S2": (_CLUSTER, [(
        "s2_partial(acc, Fc + x * Y * sl * sl, t2, e0, el);", "")]),
    # the peer's partial sums of S2 left unread: what DSMEM costs
    "cluster_without_exchange": (_CLUSTER, [(
        "xr[rr][u][v] = own ? Xs_peer[(u * 10 + v) * S2T + t] : T(0);",
        "xr[rr][u][v] = T(0);")]),
    "cluster_without_Bp": (_CLUSTER, [("Bp[i] = acc;", "")]),
    "cluster_without_stores": (_CLUSTER, [
        ("Ms[row * nM + e0 * sr + i] = Mo[i];", ";"),
        ("Ns[row * nN + e0 * P * sr + i] = No[i];", ";")]),
    "cluster_without_phi_copy": (_CLUSTER, [(
        "__pipeline_memcpy_async(fd + ((x * Y + y) * sl + e) * sl + f,",
        "if (i < 0) __pipeline_memcpy_async(fd + ((x * Y + y) * sl + e) * sl"
        " + f,")]),
}
#: the per-shape kernel and its launcher of each variant's prefix
_LAUNCHER = {"base": ("stta_scans", "stta_merge_f"),
             "staged": ("merge_f_staged", "merge_f_staged"),
             "cluster": ("merge_f_cluster", "merge_f_cluster")}


def _body(text, kernel):
    """(start, end) of one kernel's definition in the source."""
    m = re.search(r"__global__ void (__launch_bounds__\([^)]*\)\s*)?"
                  + kernel + r"\(", text)
    if m is None:
        raise RuntimeError(f"the source holds no kernel {kernel}")
    end = text.find("\n// ----", m.start())
    return m.start(), len(text) if end < 0 else end


def variant_sources(texts, variants=None):
    """{variant: source} from {kernel: the source that holds it}, for
    ``variants`` (``VARIANTS`` unless given); raises if a line to replace
    is not in its kernel's body exactly once."""
    out = {}
    for name, (kernel, edits) in (variants or VARIANTS).items():
        text = texts[kernel]
        a, b = _body(text, kernel)
        body = text[a:b]
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"{name}: {kernel} does not hold {old!r} "
                                   "exactly once")
            body = body.replace(old, new)
        out[name] = text[:a] + body + text[b:]
    return out


def read_sources():
    out = {}
    for kernel, path in SOURCE.items():
        with open(path) as fh:
            out[kernel] = fh.read()
    return out


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


def inputs(Bn, S, DL, DB, Y, q, sr, sl, dtype, dev, seed=0):
    """Random merge F inputs as the sweep hands them over (L1, B1 strided
    views), with Ws from the plain W scan."""
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, dtype=torch.float64).to(dev, dtype)
    L1 = r(Bn, S + 1, DL, DL, Y, q)[:, 1:]
    B1 = r(Bn, S + 1, DB, DB, Y, q)[:, 1:]
    Th = r(S, sr, sr, Y, Y, q)
    Pyy = torch.rand((Y, Y, Y, q), generator=g, dtype=torch.float64) \
        .to(dev, dtype)
    Phi, S0 = r(S, sl, sl, Y, q), r(Bn, sl, DL, DB)
    Ws = fs.merge_wscan_plain(L1, B1, Th)
    return L1, B1, Pyy, Phi, Ws, S0


def _target(dims):
    """(variant, build target) of the per-shape kernel that takes dims."""
    variant, _, _ = fs.merge_f_geometry(*dims, torch.float32)
    return variant, fs._merge_f_target(variant, (*dims, torch.float32))


def time_both(dims, dev, Bn=8192, S=15, reps=5):
    """merge_f_kernel and the picked kernel on the same inputs, in turns;
    one JSON line."""
    args = inputs(Bn, S, *dims, torch.float32, dev, seed=11)
    new, (_, macros) = _target(dims)
    ms = {"base": [], new: []}
    outs = {}
    for variant in ("base", new, new, "base"):
        run = lambda: fs.merge_fscan(*args, _variant=variant)  # noqa: E731
        ms[variant].append(tcuda(run, reps))
        outs[variant] = run()
    scale = max(float(o.abs().max()) for o in outs["base"])
    row = {"dims": dict(zip(("DL", "DB", "Y", "q", "sr", "sl"), dims)),
           "Bn": Bn, "S": S, "dtype": "float32", "kernel": new,
           "smem": fs.merge_f_geometry(*dims, torch.float32, new)[2],
           "macros": macros}
    for v, t in ms.items():
        row[f"ms_{v}"] = sum(t) / len(t)
        row[f"ms_{v}_runs"] = t
    row["speedup"] = row["ms_base"] / row[f"ms_{new}"]
    row["vs_base_rel"] = max(float((a - b).abs().max()) for a, b in
                             zip(outs[new], outs["base"])) / scale
    emit(**row)
    return args


def attribute(dev, dims, args, Bn=8192, S=15, reps=10):
    """Time merge_f_kernel, the kernel merge_f_geometry picks at dims, and
    that pair's VARIANTS, on the same inputs; one JSON line."""
    new, (_, macros) = _target(dims)
    names = ["base", new] + [n for n in VARIANTS
                             if n.split("_")[0] in ("base", new)]
    out_dir = os.path.join(build.BUILD_DIR, "probe_merge_f")
    os.makedirs(out_dir, exist_ok=True)
    texts = read_sources()
    procs = {}
    for name, text in variant_sources(texts).items():
        if name not in names:
            continue
        cu = os.path.join(out_dir, f"{name}_{dims[0]}.cu")
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
    L1, B1, Pyy, Phi, Ws, S0 = args
    Y, q, sr, sl = dims[2:]
    Ns = L1.new_empty((Bn, S, sl, Y, q, sr))
    Ms = L1.new_empty((Bn, S, sl, sr))
    libs = {"base": build.library("stta_scans"),
            new: build.library(*fs._merge_f_target(
                new, (*dims, torch.float32)))}
    libs.update({n: ctypes.CDLL(os.path.join(out_dir, f"{n}_{dims[0]}.so"))
                 for n in procs})
    row = {"dims": dims, "Bn": Bn, "S": S}
    for name, lib in libs.items():
        variant = name.split("_")[0]
        _, threads, smem = fs.merge_f_geometry(*dims, torch.float32, variant)
        src_name, fn_name = _LAUNCHER[variant]
        f = getattr(lib, fn_name)
        f.argtypes = build._SIGNATURES[src_name][fn_name]
        f.restype = ctypes.c_int
        ptrs = (L1.data_ptr(), fs._strides(L1), B1.data_ptr(),
                fs._strides(B1), Pyy.data_ptr(), Phi.data_ptr(),
                Ws.data_ptr(), S0.data_ptr(), Ns.data_ptr(), Ms.data_ptr(),
                Bn, S, *dims)
        st = torch.cuda.current_stream().cuda_stream

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


def _ptxas(log, pattern):
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and pattern in ln:
            print("ptxas:", " ".join(x.strip() for x in lines[i:i + 4]
                                     if "Compiling" in x or "Used" in x
                                     or "spill" in x), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_merge_f: no CUDA device")
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
    targets = [_target(d)[1] for d in shapes]
    build.build_all(["stta_scans"] + targets)
    _ptxas(build.build_log("stta_scans"), "merge_f_kernelIf")
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
