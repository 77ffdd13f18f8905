"""The Jacobi eigen kernel (``csrc/jacobi_eigh.cu``) on the card: its build
report and its time per call, whole and with parts of it left out.

    python3 -m matrixproductbp_tpu_torch.tools.probe_eigh [--attribute]

One JSON line per reading.  The ptxas report of every compiled instance,
then ``eigh_desc`` timed with CUDA events at [12288, 20, 20] and [12288,
40, 40] (the message conversion's Grams at D=10 and D=20).  Its accuracy is
held by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

``--attribute`` says where a launch's time goes: it builds copies of the
kernel that run exactly 6 sweeps, whole (``six_sweeps``), with the update
of A, the update of V or V's register shift left out (wrong results, same
control flow), and with the other home for a thread's block offsets
(``other_offsets``: the shared-memory table up to K = 32, registers above),
and times each at the two shapes.  The copies are made by replacing lines
of the kernel source (``variant_sources``); ``tests/test_torch_eigh.py``
checks that every line still exists.  Needs a CUDA card.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

from matrixproductbp_tpu_torch.ops import build, smallsvd

BATCH = 12288
SHAPES = ((20, 20), (40, 5))        # (k, timed launches)
SOURCE = os.path.join(os.path.dirname(build.__file__), "..", "csrc",
                      "jacobi_eigh.cu")

# the edits of each variant: (text of the kernel source, its replacement);
# every variant runs exactly 6 sweeps
_SIX = ("if (!(off > 1e-28 * fro)) break;", "if (sweep >= 6) break;")
VARIANTS = {
    "six_sweeps": [_SIX],
    "without_A": [_SIX, ("if (t + i * NT < NTAB) update_task(",
                         "if (t + i * NT < 0) update_task("),
                  ("for (int j = t; j < NTAB; j += NT) update_task(",
                   "for (int j = t; j < 0; j += NT) update_task(")],
    "without_V": [_SIX, ("      for (int b = 0; b < NP; ++b) {\n"
                         "        const Rot rb",
                         "      for (int b = 0; b < 0; ++b) {\n"
                         "        const Rot rb")],
    "without_shift": [_SIX, ("for (int a = 1; a < K - 1; ++a) v[a] =",
                             "for (int a = 1; a < 0; ++a) v[a] =")],
    "other_offsets": [_SIX, ("constexpr bool REG_TASKS = K <= 32;",
                             "constexpr bool REG_TASKS = K > 32;")],
}


def variant_sources(text):
    """{variant: kernel source}; raises if a line to replace is gone."""
    out = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source does not hold "
                                   f"{old!r} exactly once")
            src = src.replace(old, new)
        out[name] = src
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


def grams(k, dev):
    """[12288, k, k]: Gram matrices of Gaussian [2k, k] matrices, the first
    half rank-deficient, as ``chip_smoke.py`` times the kernel."""
    g = torch.Generator().manual_seed(14)
    X = torch.randn((BATCH, 2 * k, k), generator=g, dtype=torch.float64)
    X[: BATCH // 2, :, k // 2:] = 0.0
    return (X.transpose(1, 2) @ X).to(dev)


def attribute(dev):
    """Time each variant at [12288, 20, 20] and [12288, 40, 40]."""
    with open(SOURCE) as fh:
        sources = variant_sources(fh.read())
    out_dir = os.path.join(build.BUILD_DIR, "probe_eigh")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        emit(variant=name, ptxas=[ln.split("Used")[1].strip()
                                  for ln in log.splitlines() if "Used" in ln])
    for k, reps in SHAPES:
        G = grams(k, dev)
        K, mpb, smem = smallsvd.eigh_geometry(k)
        # the offsets' table, 16 bytes for each of a round's NP (NP + 1) / 2
        # blocks of each matrix, is in the shared memory above K = 32 only
        table = mpb * 8 * (K // 2) * (K // 2 + 1)
        smem_of = dict.fromkeys(VARIANTS, smem)
        smem_of["other_offsets"] = smem - table if K > 32 else smem + table
        w = G.new_empty(G.shape[:-1])
        V = torch.empty_like(G)
        row = {"shape": [BATCH, k, k], "sweeps": 6}
        for name in VARIANTS:
            f = ctypes.CDLL(os.path.join(out_dir, name + ".so")).jacobi_eigh
            f.argtypes = build._SIGNATURES["jacobi_eigh"]["jacobi_eigh"]
            f.restype = ctypes.c_int

            def launch():
                rc = f(G.data_ptr(), w.data_ptr(), V.data_ptr(), BATCH, k, K,
                       mpb, smem_of[name],
                       torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            row[f"ms_{name}"] = tcuda(launch, reps)
        for name in VARIANTS:
            if name != "six_sweeps":
                row[f"share_{name}"] = 1 - row[f"ms_{name}"] / row[
                    "ms_six_sweeps"]
        emit(**row)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_eigh: no CUDA device")
    dev = torch.device("cuda")
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    if "--attribute" in sys.argv:
        attribute(dev)
        return
    build.build_all(("jacobi_eigh",))
    for ln in build.build_log("jacobi_eigh").splitlines():
        if "Compiling entry" in ln or "Used" in ln or "spill" in ln:
            print("ptxas:", ln.strip(), flush=True)
    for k, reps in SHAPES:
        G = grams(k, dev)
        emit(shape=[BATCH, k, k],
             ms=tcuda(lambda: smallsvd.eigh_desc(G), reps))


if __name__ == "__main__":
    main()
