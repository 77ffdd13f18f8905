"""SIS inference with observations on a tree, on the card: the smoke's
``inference_tree`` record and its gates, and its accuracy phase.

    python3 -m matrixproductbp_tpu_torch.tools.probe_inference [--no-accuracy]

Run from the repository's root: the run is ``chip_smoke.inference_tree_run``
(SIS on ``random_tree(4096, default_rng(0))``, T=15, D=10, f32, sketch:
iterate, the sampler against BP, 256 soft observations, iterate again, each
observable timed with its peak memory, ``belief_lognorms`` on the kernels
and the plain scans, ``logprob``, SMC twice) and its gates
``chip_smoke.check_inference_tree``; a failed gate is printed, not raised,
so the whole record comes out.  Builds the kernels of bond 10 first (one
``nvcc`` each, all at once), then runs ``chip_smoke.phase_accuracy`` (the
4-node tree's observables and SMC against enumeration) unless
``--no-accuracy``.  Prints one JSON line per step.  Needs a CUDA card.
"""
import json
import sys
import time


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_inference: no CUDA device")
    import chip_smoke as c
    from matrixproductbp_tpu_torch.ops import build
    from matrixproductbp_tpu_torch.tools.probe_scale import kernel_targets
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all(list(build.SOURCES) + kernel_targets(c.INFER_D))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    if "--no-accuracy" not in sys.argv[1:]:
        c.phase_accuracy()
    res = c.inference_tree_run()
    c.emit("inference_tree", **res)
    try:
        c.check_inference_tree(res)
        gates = "passed"
    except RuntimeError as e:
        gates = str(e)
    print(json.dumps({"gates": gates[:2000]}), flush=True)


if __name__ == "__main__":
    main()
