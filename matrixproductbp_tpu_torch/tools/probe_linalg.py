"""Which batched SVD / eigen / QR routes PyTorch offers on the card for the
port's small matrices, and how fast and accurate each is.

    python3 -m matrixproductbp_tpu_torch.tools.probe_linalg

Kept because its readings are why the port's f32 SVDs on the card go
through ``ops/smallsvd.py`` (PERF.md, "What was hard").  One JSON line per
(shape, input kind, route): time per call (CUDA events), singular values
against float64 on the host, reconstruction, orthonormality.  Routes:
``torch.linalg.svd`` with cuSOLVER's ``gesvda`` in float32 and float64, the
float64 Gram with ``torch.linalg.eigh``, and the default solver where it
batches (<= 32 x 32); then ``torch.linalg.qr`` and ``geqrf`` at the karate
``qr`` merge's shape.  Input kinds: Gaussian, rank 5, and graded singular
values with half of them zero.  Needs a CUDA card.
"""
import json
import subprocess

import torch


def emit(**kv):
    print(json.dumps(kv), flush=True)


def tcuda(fn, n=3):
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


def make(g, B, m, n, kind, dev):
    """float32 [B, m, n] on the card: Gaussian, rank 5, or graded."""
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)  # noqa
    if kind == "gauss":
        M = r(B, m, n)
    elif kind == "lowrank":
        M = r(B, m, 5) @ r(B, 5, n)
    else:  # graded: singular values 1 .. 1e-9, plus zero padding
        U, _ = torch.linalg.qr(r(B, m, m))
        V, _ = torch.linalg.qr(r(B, n, n))
        k = min(m, n)
        s = torch.logspace(0, -9, k, dtype=torch.float64)
        s[k // 2:] = 0.0
        M = U[..., :k] @ torch.diag(s) @ V[..., :k].mT
    return M.to(dev, torch.float32)


def route_gesvda(M, up):
    tall = M.shape[-2] >= M.shape[-1]
    X = M.double() if up else M
    U, S, Vh = torch.linalg.svd(X if tall else X.mT, full_matrices=False,
                                driver="gesvda")
    return (U, S, Vh) if tall else (Vh.mT, S, U.mT)


def route_eigh(M):
    X = M.double()
    tall = X.shape[-2] >= X.shape[-1]
    lam, E = torch.linalg.eigh(X.mT @ X if tall else X @ X.mT)
    lam, E = lam.flip(-1), E.flip(-1)
    S = lam.clamp(min=0).sqrt()
    inv = torch.where(S > 0, 1.0 / S, torch.zeros_like(S))
    if tall:
        return (X @ E) * inv[..., None, :], S, E.mT
    return E, S, inv[..., :, None] * (E.mT @ X)


def accuracy(M, U, S, Vh, nref=32):
    Mc = M[:nref].double().cpu()
    Sr = torch.linalg.svdvals(Mc)
    Sc = S[:nref].double().cpu()
    rec = (U[:nref].double() * S[:nref].double()[..., None, :]) \
        @ Vh[:nref].double()
    big = Sc > 1e-6 * Sc[:, :1]
    Ud = U[:nref].double().cpu()
    UtU = Ud.mT @ Ud
    mask = big[..., :, None] & big[..., None, :]
    eye = torch.eye(UtU.shape[-1], dtype=torch.float64)
    return dict(
        sv_rel=float(((Sc - Sr).abs().amax(-1) / Sr[:, 0]).max()),
        recon_rel=float(((rec.cpu() - Mc).abs().amax((-1, -2))
                         / Mc.abs().amax((-1, -2))).max()),
        orth_big=float(((UtU - eye).abs() * mask).max()),
        nonfinite=int((~torch.isfinite(U)).sum()
                      + (~torch.isfinite(Vh)).sum()))


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    shapes = [(12288, 80, 20), (12288, 20, 40), (4096, 40, 20),
              (4096, 20, 20), (8192, 160, 40), (8192, 40, 80),
              (4096, 80, 40), (4096, 40, 40)]
    for (B, m, n) in shapes:
        for kind in ("gauss", "lowrank", "graded"):
            M = make(g, B, m, n, kind, dev)
            routes = {"gesvda32": lambda: route_gesvda(M, False),
                      "gesvda64": lambda: route_gesvda(M, True)}
            if min(m, n) <= 32:
                routes["eigh64"] = lambda: route_eigh(M)
            if max(m, n) <= 32:
                routes["svd_default"] = lambda: torch.linalg.svd(
                    M, full_matrices=False)
            elif kind == "gauss":   # one matrix per launch: time 256 of them
                X = M[:256].double()
                emit(phase="svd_default_256", m=m, n=n,
                     ms=tcuda(lambda: torch.linalg.svd(
                         M[:256], full_matrices=False), 1),
                     eigh_ms=tcuda(lambda: torch.linalg.eigh(
                         X.mT @ X if m >= n else X @ X.mT), 1))
            for name, fn in routes.items():
                try:
                    out = fn()
                    torch.cuda.synchronize()
                    acc = accuracy(M, *out)
                    ms = tcuda(fn, 2) if kind == "gauss" else None
                    emit(phase="svd", B=B, m=m, n=n, kind=kind, route=name,
                         ms=ms, **acc)
                except Exception as e:
                    emit(phase="svd", B=B, m=m, n=n, kind=kind, route=name,
                         error=repr(e)[:300])
    # karate-sized qr merge pieces
    for B in (16, 64):
        M = torch.randn((B, 400, 100), generator=g).to(dev)
        emit(phase="qr_big", B=B, qr_ms=tcuda(lambda: torch.linalg.qr(M), 2),
             geqrf_ms=tcuda(lambda: torch.geqrf(M), 2))
        W = torch.randn((B, 40, 100), generator=g).to(dev)
        try:
            emit(phase="svd_big", B=B,
                 gesvda64_ms=tcuda(lambda: route_gesvda(W, True), 2),
                 default_ms=tcuda(lambda: torch.linalg.svd(
                     W, full_matrices=False), 1))
        except Exception as e:
            emit(phase="svd_big", error=repr(e)[:300])
    emit(phase="done")


if __name__ == "__main__":
    main()
