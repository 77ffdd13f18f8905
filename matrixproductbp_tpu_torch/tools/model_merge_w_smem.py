"""Shared-memory wavefronts of the merge W kernels' products, counted on the
CPU (no card needed).

    python3 -m matrixproductbp_tpu_torch.tools.model_merge_w_smem [--bond=20]

A model, not a measurement, as ``model_merge_f_smem`` (whose charge it
uses: each warp-wide shared-memory access costs the largest number of
distinct 4-byte words that any one of the 32 banks holds).  For one
instance-step of the f32 sketch merge at bond D (``DL = DB = sr = D``,
Y = q = 2; D=20 unless ``--bond`` says otherwise) it replays:

- ``merge_w_kernel`` (``csrc/stta_scans.cu``): its three ``block_gemm``
  products (2x2 tiles) once per x, through ``model_merge_f_smem.wavefronts``;
- ``merge_w_staged_kernel`` (``csrc/merge_w_staged.cu``): t1, u and W2 with
  the tiles, task orders and padded strides of its build at that shape
  (``fused_stta.merge_w_staged_macros``), once per chunk of rows n, and the
  stores of t1 and u apart.

One JSON line per product and a total per kernel.  Staging, the W stores,
the rescale and the register traffic are not counted.
"""
import json
import sys
from collections import defaultdict

import torch

from matrixproductbp_tpu_torch.ops import fused_stta as fs
from matrixproductbp_tpu_torch.tools.model_merge_f_smem import wavefronts


def sketch_dims(D):
    """The f32 sketch merge at bond D: DL = DB = sr = D, Y = q = 2."""
    return dict(DL=D, DB=D, Y=2, q=2, sr=D)


def base_products(DL, DB, Y, q, sr):
    """merge_w_kernel's products: (name, times a step, Gemm fields), as its
    ``ga``, ``gb`` and ``gc``."""
    return [
        ("t1", q, (DB, sr, DB, DL, Y, DB * Y * q, Y * q, 0, q, sr, 1,
                   DB * sr, 0)),
        ("u", q, (DB * DL, sr, Y * sr, Y, 1, Y * sr, 1, 0, 0, sr, 1,
                  Y * sr * sr, 0)),
        ("W2", q, (DL, sr, DL * Y, DB, 1, DL * Y * q, q, 0, 0, sr, 1,
                   DL * Y * sr, 0)),
    ]


def _charge(addrs, width=1):
    """Wavefronts of one warp-wide access of ``width`` neighbouring words a
    lane at these word addresses: the most distinct words one bank holds."""
    banks = defaultdict(set)
    for a in addrs:
        for w in range(width):
            banks[(a + w) % 32].add(a + w)
    return max(len(v) for v in banks.values())


def _scalar(addrs, step):
    """Load specs (address of k, width, every) of scalar loads."""
    return [(lambda k, a=a: a + k * step, 1, 1) for a in addrs]


def _replay(tasks, threads, K, operands, stores=None):
    """(tasks, loads, wavefronts[, store accesses, store wavefronts]) of one
    product: ``operands(t)`` gives task t's loads as (address function of
    k, words a lane, issued every that many k), ``stores(t)`` its output
    addresses (None where not stored); tasks run ``threads`` at a time, 32
    to a warp."""
    loads = waves = st_acc = st_waves = 0
    for r0 in range(0, tasks, threads):
        for w0 in range(r0, min(r0 + threads, tasks), 32):
            lanes = range(w0, min(w0 + 32, r0 + threads, tasks))
            ops = [operands(t) for t in lanes]
            for k in range(K):
                for o, (_, width, every) in enumerate(ops[0]):
                    if k % every:
                        continue
                    loads += 1
                    waves += _charge([op[o][0](k) for op in ops], width)
            if stores is not None:
                outs = [stores(t) for t in lanes]
                for o in range(len(outs[0])):
                    hit = [s[o] for s in outs if s[o] is not None]
                    if hit:
                        st_acc += 1
                        st_waves += _charge(hit)
    return tasks, loads, waves, st_acc, st_waves


def staged_products(DL, DB, Y, q, sr, dtype=torch.float32):
    """merge_w_staged_kernel's products for one chunk of rows n, as the
    build at this shape runs them: {name: (tasks, loads, wavefronts, store
    accesses, store wavefronts)}, and the chunks a step."""
    m = dict(s.split("=") for s in fs.merge_w_staged_macros(
        DL, DB, Y, q, sr, dtype))
    NC, NT = int(m["MW_NC"]), int(m["MW_NT"])
    AM, AN, BM, BN, CM, CN = (int(m["MW_" + k]) for k in
                              ("AM", "AN", "BM", "BN", "CM", "CN"))
    P, NCH = Y * q, -(-DL // NC)
    NP = NCH * NC
    WN, LR, BR = ((DB * sr) | 1) + 1, ((NP * P + 3) // 4 * 4) | 4, (DB * P) | 1
    RT, R1 = Y * sr, (Y * sr) | 1
    XS, RU = (NC * DB * R1) | 1, ((DB * sr) | 1) + 1
    # the kernel's vector loads (A_V2, B_V2, C_KV)
    a_v2 = AN % 2 == 0 and sr % AN == 0
    b_v2 = BN % 2 == 0 and (Y * sr) % BN == 0 and RT % 2 == 0
    c_kv = 4 if dtype == torch.float32 and (NC * P) % 4 == 0 else 1
    out = {}

    mt, ntl = -(-DB // AM), -(-sr // AN)                 # t1

    def t1_dec(t):
        tj, r = t % ntl, t // ntl
        ti, r = r % mt, r // mt
        return tj, ti, r % P, r // P

    def t1_ops(t):
        tj, ti, p, nl = t1_dec(t)
        a = [p + min(AM * ti + i, DB - 1) * BR for i in range(AM)]
        b = [nl * WN + min(AN * tj + w, sr - 1) for w in range(AN)]
        bs = ([(lambda k, x=x: x + k * sr, 2, 1) for x in b[::2]] if a_v2
              else _scalar(b, sr))
        return _scalar(a, P) + bs

    def t1_st(t):
        tj, ti, p, nl = t1_dec(t)
        base = (p % q) * XS + nl * DB * R1 + (p // q) * sr
        return [base + (AM * ti + i) * R1 + AN * tj + w
                if AM * ti + i < DB and AN * tj + w < sr else None
                for i in range(AM) for w in range(AN)]
    out["t1"] = _replay(mt * ntl * P * NC, NT, DB, t1_ops, t1_st)

    K = Y * sr                                           # u
    mt, ntl = -(-DB // BM), -(-K // BN)

    def u_dec(t):
        tj, r = t % ntl, t // ntl
        ti, r = r % mt, r // mt
        return tj, ti, r % NC, r // NC

    def u_ops(t):
        tj, ti, nl, x = u_dec(t)
        a0, b0 = x * XS + nl * DB * R1, x * K * RT
        a = [a0 + min(BM * ti + i, DB - 1) * R1 for i in range(BM)]
        b = [b0 + min(BN * tj + w, K - 1) for w in range(BN)]
        bs = ([(lambda k, y=y: y + k * RT, 2, 1) for y in b[::2]] if b_v2
              else _scalar(b, RT))
        return _scalar(a, 1) + bs

    def u_st(t):
        tj, ti, nl, x = u_dec(t)
        res = []
        for i in range(BM):
            for w in range(BN):
                col = BN * tj + w
                ok = col < K and BM * ti + i < DB
                res.append((nl * P + x) * RU + (col // sr) * q * RU
                           + col % sr + (BM * ti + i) * sr if ok else None)
        return res
    out["u"] = _replay(mt * ntl * NC * q, NT, K, u_ops, u_st)

    mt, ntl = -(-DL // CM), -(-(DB * sr) // CN)          # W2

    def w2_ops(t):
        ti, tj = t // ntl, t % ntl
        a = [min(CM * ti + i, DL - 1) * LR for i in range(CM)]
        b = [min(CN * tj + w, DB * sr - 1) for w in range(CN)]
        return ([(lambda k, y=y: y + k, c_kv, c_kv) for y in a]
                + _scalar(b, RU))
    out["W2"] = _replay(mt * ntl, NT, NC * P, w2_ops)
    return out, NCH


def count(dims=None):
    """{kernel: {product: (tasks, loads, wavefronts) a step, 'total':
    wavefronts a step}}, the staged kernel's stores of t1 and u as the
    products 't1 store' and 'u store' (accesses as loads)."""
    dims = dims or sketch_dims(20)
    out = {}
    base = {}
    for name, times, g in base_products(**dims):
        t, ld, wv = wavefronts(*g, TM=2, TN=2, KS=1)
        base[name] = (t * times, ld * times, wv * times)
    base["total"] = sum(v[2] for v in base.values())
    out["merge_w_kernel"] = base
    shape = tuple(dims[k] for k in ("DL", "DB", "Y", "q", "sr"))
    if fs._merge_w_staged_plan(*shape, 4) is not None:
        prods, chunks = staged_products(*shape)
        staged = {}
        for name, (t, ld, wv, sa, sw) in prods.items():
            staged[name] = (t * chunks, ld * chunks, wv * chunks)
            if sa:
                staged[name + " store"] = (t * chunks, sa * chunks,
                                           sw * chunks)
        staged["total"] = sum(v[2] for v in staged.values())
        out["merge_w_staged_kernel"] = staged
    return out


def main():
    dims = sketch_dims(20)
    for a in sys.argv[1:]:
        if a.startswith("--bond="):
            dims = sketch_dims(int(a[len("--bond="):]))
    for kernel, rows in count(dims).items():
        for name, row in rows.items():
            if name == "total":
                continue
            print(json.dumps({"kernel": kernel, "product": name,
                              "tasks": row[0], "loads": row[1],
                              "wavefronts": row[2],
                              "conflict": round(row[2] / row[1], 2)}))
        print(json.dumps({"kernel": kernel, "wavefronts_per_step":
                          rows["total"], "dims": dims}))


if __name__ == "__main__":
    main()
