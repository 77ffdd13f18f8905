"""Time two checkouts of the repo on one card, in turns (A, B, B, A): the
SIS sketch sweeps of ``chip_smoke.py`` at D=10 and D=20 (5 and 3 timed
sweeps) and the merge F and MPEM3 F scan kernels at their bench shapes
(every merge F kernel that fits, and both MPEM3 F kernels; CUDA events over
10 launches), each checkout building and timing its own kernels.

    python3 -m matrixproductbp_tpu_torch.tools.ab_turns PARENT CHANGE

PARENT and CHANGE are roots of unpacked checkouts (``git archive`` into a
directory that ``.gitignore`` lists).  Each turn runs this file in a
subprocess from that root, so the turn imports that checkout's package and
``chip_smoke.py`` helpers.  Prints one line a turn, ``<root> AB {json}``.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def turn():
    """Build and time the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as c
    from matrixproductbp_tpu_torch.ops import build, fused_stta as fs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all(list(build.SOURCES) + c.per_shape_builds())
    out = {}
    for D, sweeps in ((10, 5), (20, 3)):
        _, _, r = c.timed_main_path(D, sweeps)
        out[f"sketch_d{D}_s"] = r["s_per_sweep"]
        md = c.merge_dims(D)
        L1, B1, Th, Pyy, Phi, S0 = c.merge_inputs(
            2 * c.BENCH_N, c.BENCH_T, **md, dtype=torch.float32, device=dev,
            seed=11)
        Ws = fs.merge_wscan(L1, B1, Th)
        for v in c.merge_f_variants(md, torch.float32):
            out[f"merge_f_{v}_d{D}_ms"] = c.time_cuda(
                lambda: fs.merge_fscan(L1, B1, Pyy, Phi, Ws, S0,
                                       _variant=v), 10)
        del L1, B1, Th, Pyy, Phi, S0, Ws
        pd = c.mpem3_dims(D)
        Bm, Psi, PhiM, SiM = c.mpem3_inputs(
            c.BENCH_N * c.BENCH_DEG, c.BENCH_T, **pd, dtype=torch.float32,
            device=dev, seed=14)
        WsM = fs.mpem3_wscan(Bm, Psi)
        for v in ("staged", "base"):
            out[f"mpem3_f_{v}_d{D}_ms"] = c.time_cuda(
                lambda: fs.mpem3_fscan(Bm, PhiM, WsM, SiM, _variant=v), 10)
        del Bm, Psi, PhiM, SiM, WsM
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["--turn"]:
        return turn()
    if len(argv) != 2:
        raise SystemExit(__doc__)
    a, b = argv
    for root in (a, b, b, a):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn"], cwd=root, capture_output=True,
                             text=True, timeout=900)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode or not lines:
            raise SystemExit(f"{root}: turn failed\n{res.stderr[-4000:]}")
        print(root, lines[-1], flush=True)


if __name__ == "__main__":
    main()
