"""Shared-memory wavefronts of the merge F kernels' products, counted on the
CPU (no card needed).

    python3 -m matrixproductbp_tpu_torch.tools.model_merge_f_smem

A model, not a measurement: it replays the task order of ``block_gemm``
(2x2 tiles, one task per thread in turn) and of ``tile_gemm`` (TM x TN
tiles, the K sum split over KS lanes) in ``csrc/stta_scans.cu`` and
``csrc/merge_f_staged.cu`` for one instance-step at the D=10 sketch merge
(f32, 256 threads), and charges each
warp-wide shared-memory load the largest number of distinct 4-byte words
that any one of the 32 banks holds (one wavefront per word, one wavefront
per cycle per SM).  One JSON line per product and a total per kernel:
``merge_f_kernel`` (its products once per (y, x) pair or per x, as it runs
them) and ``merge_f_staged_kernel`` (one product per contraction, padded
rows).  Shuffles, stores, staging, Bp and the rescale are not counted,
and ``merge_f_kernel``'s loads of W, which it reads from global memory,
are counted as if they were shared.
"""
import json
from collections import defaultdict

DIMS = dict(DL=10, DB=10, Y=2, q=2, sr=10, sl=14)


def wavefronts(M, N, K, nb1, nb2, ai, ak, ab1, ab2, bk, bj, bb1, bb2, TM=2,
               TN=2, KS=1):
    """(tasks, warp-wide loads, wavefronts) of one product: every lane's A
    and B loads of each k step, warp by warp, in the kernels' task order
    (output column tile fastest, then row tile, then the batch indices)."""
    mt, nt = -(-M // TM), -(-N // TN)
    tiles = nb1 * nb2 * mt * nt
    tasks = tiles if KS == 1 else -(-tiles * KS // 32) * 32
    loads = waves = 0
    for w0 in range(0, tasks, 32):
        lanes = []
        for t in range(w0, min(w0 + 32, tasks)):
            ks, r = t % KS, t // KS
            r = r if r < tiles else 0
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


def count(dims=DIMS):
    """{kernel: {product: (tasks, loads, wavefronts) a step, 'total':
    wavefronts a step}}."""
    out = {}
    prods, tiling = base_products(**dims)
    base = {}
    for name, times, g in prods:
        t, ld, wv = wavefronts(*g, **tiling)
        base[name] = (t * times, ld * times, wv * times)
    base["total"] = sum(v[2] for v in base.values())
    out["merge_f_kernel"] = base
    staged = {}
    for name, g, (TM, TN, KS) in staged_products(**dims):
        staged[name] = wavefronts(*g, TM=TM, TN=TN, KS=KS)
    staged["total"] = sum(v[2] for v in staged.values())
    out["merge_f_staged_kernel"] = staged
    return out


def main():
    for kernel, rows in count().items():
        for name, row in rows.items():
            if name != "total":
                print(json.dumps({"kernel": kernel, "product": name,
                                  "tasks": row[0], "loads": row[1],
                                  "wavefronts": row[2],
                                  "conflict": round(row[2] / row[1], 2)}))
        print(json.dumps({"kernel": kernel, "wavefronts_per_step":
                          rows["total"], "dims": DIMS}))


if __name__ == "__main__":
    main()
