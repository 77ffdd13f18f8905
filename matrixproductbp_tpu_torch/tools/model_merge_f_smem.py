"""Shared-memory wavefronts of the merge F kernels' products, counted on the
CPU (no card needed).

    python3 -m matrixproductbp_tpu_torch.tools.model_merge_f_smem [--bond=20]

A model, not a measurement: it replays the task order of ``block_gemm``
(2x2 tiles, one task per thread in turn) and of ``tile_gemm`` (TM x TN
tiles, the K sum split over KS lanes) in ``csrc/stta_scans.cu``,
``csrc/merge_f_staged.cu`` and ``csrc/merge_f_cluster.cu`` for one
instance-step (a block-step of the cluster kernel's first block) at the f32
sketch merge of bond D (``DIMS``, D=10 unless ``--bond`` says otherwise),
and charges each warp-wide shared-memory load the largest number of
distinct 4-byte words that any one of the 32 banks holds (one wavefront
per word, one wavefront per cycle per SM).  One JSON line per product and
a total per kernel: ``merge_f_kernel`` (its products once per (y, x) pair
or per x, as it runs them), ``merge_f_staged_kernel`` (one product per
contraction, padded rows) and ``merge_f_cluster_kernel`` (its products per
x over its own rows e; S2 over all rows f), each where its buffers fit.
The cluster kernel's reads of its peer's shared memory (the exchange of
the S2 partials) are counted apart, as distributed shared-memory loads,
words and 32-byte sectors.  Shuffles, stores, staging, Bp and the rescale
are not counted, and ``merge_f_kernel``'s loads of W, which it reads from
global memory, are counted as if they were shared.
"""
import json
import sys
from collections import defaultdict

import torch

from matrixproductbp_tpu_torch.ops import fused_stta as fs

DIMS = dict(DL=10, DB=10, Y=2, q=2, sr=10, sl=14)
#: the cluster kernel's block (``NT`` in ``merge_f_cluster.cu``)
CLUSTER_THREADS = fs._CLUSTER_THREADS


def sketch_dims(D):
    """The f32 sketch merge at bond D: DL = DB = sr = D, sl = D + 4."""
    return dict(DL=D, DB=D, Y=2, q=2, sr=D, sl=D + 4)


def wavefronts(M, N, K, nb1, nb2, ai, ak, ab1, ab2, bk, bj, bb1, bb2, TM=2,
               TN=2, KS=1, rows_fastest=False):
    """(tasks, warp-wide loads, wavefronts) of one product: every lane's A
    and B loads of each k step, warp by warp, in the kernels' task order
    (output column tile fastest, then row tile, then the batch indices;
    with ``rows_fastest``, the row tile fastest)."""
    mt, nt = -(-M // TM), -(-N // TN)
    tiles = nb1 * nb2 * mt * nt
    tasks = tiles if KS == 1 else -(-tiles * KS // 32) * 32
    loads = waves = 0
    for w0 in range(0, tasks, 32):
        lanes = []
        for t in range(w0, min(w0 + 32, tasks)):
            ks, r = t % KS, t // KS
            r = r if r < tiles else 0
            if rows_fastest:
                ti, r = r % mt, r // mt
                tj, r = r % nt, r // nt
            else:
                tj, r = r % nt, r // nt
                ti, r = r % mt, r // mt
            lanes.append((ks, ti, tj, r // nb2, r % nb2))
        steps = max(len(range(lane[0], K, KS)) for lane in lanes)
        for it in range(steps):
            for operand in range(TM + TN):
                banks = defaultdict(set)
                for ks, ti, tj, b1, b2 in lanes:
                    k = ks + KS * it
                    if k >= K:
                        continue
                    if operand < TM:
                        i = min(TM * ti + operand, M - 1)
                        addr = b1 * ab1 + b2 * ab2 + k * ak + i * ai
                    else:
                        j = min(TN * tj + operand - TM, N - 1)
                        addr = b1 * bb1 + b2 * bb2 + k * bk + j * bj
                    banks[addr % 32].add(addr)
                if banks:
                    loads += 1
                    waves += max(len(v) for v in banks.values())
    return tasks, loads, waves


def base_products(DL, DB, Y, q, sr, sl):
    """merge_f_kernel's products: (name, times a step, Gemm fields)."""
    DLB = DL * DB
    return [
        ("M", 1, (sl, sr, DLB, 1, 1, DLB, 1, 0, 0, sr, 1, 0, 0)),
        ("t1", q, (sl, DL, DL, DB, Y, DLB, DB, 1, 0, DL * Y * q, Y * q, 0,
                   q)),
        ("t2", Y * q, (sl * DL, DB, DB * Y, 1, 1, DB * Y, 1, 0, 0, DB, 1, 0,
                       0)),
        ("N", Y * q, (sl, sr, DLB, 1, 1, DLB, 1, 0, 0, sr, 1, 0, 0)),
        ("S2", Y * q, (sl, DLB, sl, 1, 1, Y * q, sl * Y * q, 0, 0, DLB, 1, 0,
                       0)),
    ], dict(TM=2, TN=2, KS=1)


def staged_products(DL, DB, Y, q, sr, sl):
    """merge_f_staged_kernel's products, with its tiles, K splits and
    padded strides, each once a step: (name, Gemm fields, (TM, TN, KS))."""
    DLB, P = DL * DB, Y * q
    nS, sE, R1, nBp = sl * DLB, DLB | 1, (DB * P) | 1, DB * Y * DB
    return [
        ("M", (sl, sr, DLB, 1, 1, sE, 1, 0, 0, sr, 1, 0, 0), (2, 5, 16)),
        ("t1", (sl, DL, DL, DB, P, sE, DB, 1, 0, DL * P, P, 0, 1),
         (2, 10, 1)),
        ("t2", (sl * DL, DB, DB * Y, q, Y, R1, q, 1, 0, DB, 1, Y * nBp, nBp),
         (4, 5, 2)),
        ("N", (sl, sr, DLB, P, 1, DLB, 1, nS, 0, sr, 1, 0, 0), (4, 5, 4)),
        ("S2", (sl, DLB, P * sl, 1, 1, 1, sl, 0, 0, DLB, 1, 0, 0),
         (2, 5, 1)),
    ]


def cluster_products(DL, DB, Y, q, sr, sl):
    """merge_f_cluster_kernel's products for its first block (E0 = ceil(sl/2)
    rows e), with its tiles and K splits: (name, times a step, Gemm fields,
    (TM, TN, KS)).  S2 is counted once per y (its K sum runs over y and the
    block's rows e; a y offsets every lane alike, so the banks do not
    change)."""
    DLB, P, E0 = DL * DB, Y * q, (sl + 1) // 2
    sE, R1, nBp, T2Y = DLB | 1, (DB * Y) | 1, DB * Y * DB, E0 * DLB
    return [
        ("M", 1, (E0, sr, DLB, 1, 1, sE, 1, 0, 0, sr, 1, 0, 0), (2, 5, 16)),
        ("t1", q, (E0, DL, DL, DB, Y, sE, DB, 1, 0, DL * P, P, 0, q),
         (2, 10, 1)),
        ("t2", q, (E0 * DL, DB, DB * Y, 1, Y, R1, 1, 0, 0, DB, 1, 0, nBp),
         (4, 5, 2)),
        ("N", q, (E0, sr, DLB, Y, 1, DLB, 1, T2Y, 0, sr, 1, 0, 0),
         (4, 5, 16)),
        ("S2", q * Y, (sl, DLB, E0, 1, 1, 1, sl, 0, 0, DLB, 1, 0, 0),
         (2, 10, 1)),
    ]
#: the cluster products whose tasks take the row tile fastest (s2_partial)
CLUSTER_ROWS_FASTEST = ("S2",)


def cluster_exchange(DL, DB, Y, q, sr, sl, NT=CLUSTER_THREADS):
    """(warp-wide loads, words, 32-byte sectors) of the first block's reads
    of its peer's shared memory a step: each output S2[f][n, j] of its own
    rows f, read once from the peer's partial sums by the thread whose 2x10
    tile holds it (row tiles fastest, as in ``s2_partial``), where the peer
    keeps them in thread order (element (u, v) of task t at word
    ``(u*10 + v)*S2T + t``); a warp issues a load wherever one of its lanes
    owns such an output."""
    DLB, E0 = DL * DB, (sl + 1) // 2
    mt = -(-sl // 2)
    tiles = mt * -(-DLB // 10)
    loads = words = sectors = 0
    for w0 in range(0, -(-tiles // NT) * NT, 32):
        for u in range(2):
            for v in range(10):
                hit = set()
                for t in range(w0, min(w0 + 32, tiles)):
                    f, nj = 2 * (t % mt) + u, 10 * (t // mt) + v
                    if f < E0 and nj < DLB:
                        hit.add((u * 10 + v) * tiles + t)
                loads += bool(hit)
                words += len(hit)
                sectors += len({4 * w // 32 for w in hit})
    return loads, words, sectors


def count(dims=DIMS):
    """{kernel: {product: (tasks, loads, wavefronts) a step, 'total':
    wavefronts a step}} for the kernels whose f32 buffers fit ``dims``; the
    cluster kernel's also holds 'dsmem': (loads, words, sectors) of its
    peer's shared memory a block-step."""
    out = {}
    prods, tiling = base_products(**dims)
    base = {}
    for name, times, g in prods:
        t, ld, wv = wavefronts(*g, **tiling)
        base[name] = (t * times, ld * times, wv * times)
    base["total"] = sum(v[2] for v in base.values())
    out["merge_f_kernel"] = base
    shape = tuple(dims[k] for k in ("DL", "DB", "Y", "q", "sr", "sl"))
    if fs._smem_merge_f_staged(*shape, 4) * 4 <= fs.SMEM_LIMIT:
        staged = {}
        for name, g, (TM, TN, KS) in staged_products(**dims):
            staged[name] = wavefronts(*g, TM=TM, TN=TN, KS=KS)
        staged["total"] = sum(v[2] for v in staged.values())
        out["merge_f_staged_kernel"] = staged
    if fs._smem_merge_f_cluster(*shape, 4) * 4 <= fs.SMEM_LIMIT:
        cluster = {}
        for name, times, g, (TM, TN, KS) in cluster_products(**dims):
            t, ld, wv = wavefronts(*g, TM=TM, TN=TN, KS=KS,
                                   rows_fastest=name in CLUSTER_ROWS_FASTEST)
            # S2's tasks run once per x, their y loop inside
            runs = dims["q"] if name == "S2" else times
            cluster[name] = (t * runs, ld * times, wv * times)
        cluster["total"] = sum(v[2] for v in cluster.values())
        cluster["dsmem"] = cluster_exchange(**dims)
        out["merge_f_cluster_kernel"] = cluster
    return out


def main():
    dims = DIMS
    for a in sys.argv[1:]:
        if a.startswith("--bond="):
            dims = sketch_dims(int(a[len("--bond="):]))
    for kernel, rows in count(dims).items():
        for name, row in rows.items():
            if name in ("total", "dsmem"):
                continue
            print(json.dumps({"kernel": kernel, "product": name,
                              "tasks": row[0], "loads": row[1],
                              "wavefronts": row[2],
                              "conflict": round(row[2] / row[1], 2)}))
        extra = (dict(zip(("dsmem_loads", "dsmem_words", "dsmem_sectors"),
                          rows["dsmem"])) if "dsmem" in rows else {})
        print(json.dumps({"kernel": kernel, "wavefronts_per_step":
                          rows["total"], **extra, "dims": dims}))


if __name__ == "__main__":
    main()
