// merge W, staged, for Hopper (sm_90a): the reverse merge scan of
// stta_scans.cu's merge_w_kernel for the shapes whose buffers fit in shared
// memory, compiled once per shape.
//
// Replaces, as merge_w_kernel does, the Pallas TPU kernel
// _merge_wstep_kernel of matrixproductbp_tpu/ops/fused_stta.py (:231; grid
// wrapper _merge_wscan :359, pallas_call :365); its plain version is
// matrixproductbp_tpu_torch/ops/stta.py::merge_wscan_plain.  The wrapper
// (fused_stta.py::merge_wscan) picks it where fused_stta.py::merge_w_geometry
// finds an f32 sketch merge (Y = q = 2) whose buffers fit: it ran faster than
// merge_w_kernel at every one timed, from D=4 to D=20 (PERF.md).
//
// A step (time t = s+1) computes, with n, k over DL, m, j over DB, a, b over
// sr, u, v over Y and x over q,
//   t1[m,n,v,x,b] = sum_j B_t[m,j,v,x] W[n,j,b]
//   u[m,n,u,x,a]  = sum_{v,b} Th_t[a,b,u,v,x] t1[m,n,v,x,b]
//   W2[k,m,a]     = sum_{n,u,x} L_t[k,n,u,x] u[m,n,u,x,a]
// and carries W <- W2 / scale (the per-instance max-abs with the _safe_scale
// guard), emitting Ws[:, s] = W; W_{T1} is the one-hot (0, 0, 0).
//
// What bounds it: the operations (5.1 MFLOP an instance-step at D=20, 9.4 ms
// for [8192, 15] at the fp32 peak), and in practice the shared-memory loads
// of the products' operands and the barriers between them.  merge_w_kernel
// spends its time on run-time sizes (a task decode with four div/mods, K
// loops that do not unroll), 2x2 register tiles (one load an FMA), staging
// that the block waits for, and about eleven barriers a step (the three
// products once per x).  This design:
//   - the sizes are compile-time constants (one build per shape), so task
//     decodes, strides and K loops fold into the code;
//   - each contraction is one product a step over all x (t1 and u for all
//     (v, x) and (u, x) pairs at once), with register tiles of up to 40
//     outputs (MW_AM x MW_AN, MW_BM x MW_BN) for t1 and u;
//   - the last product's K sum runs over n, so it is split over chunks of
//     MW_NC rows n: t1 and u are formed one chunk at a time (their buffers
//     for all n need 250 KiB at D=20), and each thread keeps its
//     MW_CM x MW_CN tile of W2 in registers across the chunks.  W2 needs no
//     shared buffer: once scaled it is written over W, whose last reader
//     (the last chunk's t1) has passed a barrier by then.  A step has
//     2 + 2 x chunks block barriers (6 at D=20);
//   - L_t, B_t and Th_t arrive by cp.async a step ahead into double buffers
//     (Th_t, shared by all instances, comes from L2), L_t and B_t with their
//     rows padded, Th_t transposed to Tt[x][(v,b)][(u,a)];
//   - rows are padded against bank conflicts, the pads chosen with
//     tools/model_merge_w_smem.py (a CPU model of the products' shared-memory
//     wavefronts): t1's rows and x blocks and B_t's rows to odd strides, W's
//     and u's rows to 2 mod 4 words, L_t's to 4 mod 8;
//   - where tiles and strides keep them aligned, t1's and u's column operand
//     (W, Tt) is loaded by pairs and W2's row operand (L_t) by fours along
//     K (f32): at D=20 the model counts 26,440 wavefronts an instance-step,
//     against 47,280 for the first layout with scalar loads;
//   - Ws is stored from W coalesced, at the next step's first barrier.
// A step:
//   cp.async step s-1's L, B and Th;  wait for step s's            | barrier
//   store the previous W to Ws
//   for each chunk of n:  t1 (chunk) | barrier | u (chunk) | barrier |
//                         W2 += L_t . u (registers)
//   per-warp max-abs of W2                                         | barrier
//   every thread folds the partials; W <- W2 / scale
// Rows n past DL (the last chunk's padding) are zero in W and L, so they add
// nothing.
//
// Built once per shape.  The sizes, the element type, the chunk MW_NC, the
// threads MW_NT, the blocks an SM should hold MW_MINB (the register budget
// __launch_bounds__ gives ptxas) and the register tiles are macros, which
// fused_stta.py::merge_w_staged_macros computes and ops/build.py passes to
// nvcc at the shape's first use.
//
// Shared memory per block (elements of T, each buffer rounded up to 16
// bytes; fused_stta.py::_smem_merge_w_staged computes the same sum), with
// NP = MW_NC x chunks rows n and P = Y*q: W NP*WN (WN = (DB*sr|1) + 1) +
// L_t 2*DL*LR (LR = NP*P rounded up to 4, |4) + B_t 2*DB*BR (BR = DB*P|1) +
// Tt 2*q*Y*sr*RT (RT = Y*sr) + t1 q*XS (XS = NC*DB*R1|1, R1 = Y*sr|1) + u
// NC*P*RU (RU = WN).  D=20, f32, NC=10: 53,524 floats = 209.1 KiB, one block
// of 416 threads an SM; D=10, NC=10: 12,608 floats = 49.3 KiB, four blocks
// of 128.
// Shared layouts: W [n][j*sr+b]; Ls [2][k][n*P+u*q+x]; Bs [2][m][j*P+v*q+x];
// Tt [2][x][v*sr+b][u*sr+a]; t1 [x][nl][m][v*sr+b]; u [nl*P+u*q+x][m*sr+a]
// (nl = n - n0, the row within the chunk).

#include "stta_common.cuh"

#if !defined(MW_T) || !defined(MW_DL) || !defined(MW_DB) || !defined(MW_Y) || \
    !defined(MW_Q) || !defined(MW_SR) || !defined(MW_NC) ||                   \
    !defined(MW_NT) || !defined(MW_MINB) || !defined(MW_AM) ||                \
    !defined(MW_AN) || !defined(MW_BM) || !defined(MW_BN) ||                  \
    !defined(MW_CM) || !defined(MW_CN)
#error "merge_w_staged.cu is built per shape: define MW_T, MW_DL, MW_DB, MW_Y, MW_Q, MW_SR, MW_NC, MW_NT, MW_MINB and the tiles MW_AM, MW_AN, MW_BM, MW_BN, MW_CM, MW_CN"
#endif

typedef MW_T T;
constexpr int NT = MW_NT;
constexpr int DL = MW_DL, DB = MW_DB, Y = MW_Y, q = MW_Q, sr = MW_SR;
constexpr int NC = MW_NC, P = Y * q;
constexpr int NCH = (DL + NC - 1) / NC, NP = NCH * NC;
constexpr int WN = ((DB * sr) | 1) + 1, LR = ((NP * P + 3) / 4 * 4) | 4;
constexpr int BR = (DB * P) | 1, RT = Y * sr, R1 = (Y * sr) | 1;
constexpr int XS = (NC * DB * R1) | 1, RU = ((DB * sr) | 1) + 1;
// each buffer rounded up to 16 bytes, so that vector loads stay aligned
constexpr int V16 = 16 / sizeof(T);
constexpr int pad16(int n) { return (n + V16 - 1) / V16 * V16; }
constexpr int nW = pad16(NP * WN), nLs = pad16(DL * LR), nBs = pad16(DB * BR);
constexpr int nTt = pad16(q * Y * sr * RT), nT1 = pad16(q * XS);
constexpr int nOut = DL * DB * sr;
// W2's register tiles: one a thread, rows k, columns (m, a)
constexpr int CM = MW_CM, CN = MW_CN;
constexpr int C_MT = (DL + CM - 1) / CM, C_NTL = (DB * sr + CN - 1) / CN;
static_assert(C_MT * C_NTL <= NT, "W2 needs one register tile a thread");
static_assert(NT % 32 == 0, "whole warps");
// vector loads where the tiles and strides keep them aligned: t1's and u's
// column operand (W, Tt) by pairs, W2's row operand (Ls) by fours in f32
constexpr bool A_V2 = MW_AN % 2 == 0 && sr % MW_AN == 0 && WN % 2 == 0;
constexpr bool B_V2 = MW_BN % 2 == 0 && (Y * sr) % MW_BN == 0 && RT % 2 == 0;
constexpr int C_KV = (sizeof(T) == 4 && LR % 4 == 0 && (NC * P) % 4 == 0)
                         ? 4 : 1;

__device__ __forceinline__ void ld2(const T* p, T& x, T& y) {
  if (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x = v.x; y = v.y;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    x = v.x; y = v.y;
  }
}

__device__ __forceinline__ void ld4(const T* p, T (&o)[C_KV]) {
  if (C_KV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1 % C_KV] = v.y; o[2 % C_KV] = v.z; o[3 % C_KV] = v.w;
  } else {
    o[0] = p[0];
  }
}

// t1[x][nl][m][v*sr+b] = sum_j Bs[m][j*P+p] W[n0+nl][j*sr+b], p = v*q + x:
// a [DB x sr] product per (nl, p), K = DB.  Tasks take p fastest among the
// batches, so a warp's lanes share W's rows (broadcasts).
__device__ __forceinline__ void prod_t1(const T* __restrict__ Bc,
                                        const T* __restrict__ W,
                                        T* __restrict__ t1, int n0) {
  constexpr int TM = MW_AM, TN = MW_AN;
  constexpr int mt = (DB + TM - 1) / TM, ntl = (sr + TN - 1) / TN;
  constexpr int tasks = mt * ntl * P * NC;
  for (int t = threadIdx.x; t < tasks; t += NT) {
    int r = t;
    const int tj = r % ntl; r /= ntl;
    const int ti = r % mt; r /= mt;
    const int p = r % P;
    const int nl = r / P;
    const T* a = Bc + p;
    const T* b = W + (n0 + nl) * WN;
    int ia[TM], jb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ia[i] = min(TM * ti + i, DB - 1) * BR;
#pragma unroll
    for (int w = 0; w < TN; ++w) jb[w] = min(TN * tj + w, sr - 1);
    T c[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int w = 0; w < TN; ++w) c[i][w] = T(0);
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      T av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a[ia[i] + j * P];
      if (A_V2) {
#pragma unroll
        for (int w = 0; w < TN; w += 2)
          ld2(b + TN * tj + w + j * sr, bv[w], bv[(w + 1) % TN]);
      } else {
#pragma unroll
        for (int w = 0; w < TN; ++w) bv[w] = b[jb[w] + j * sr];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int w = 0; w < TN; ++w) c[i][w] += av[i] * bv[w];
    }
    const int v = p / q, x = p % q;
    T* cc = t1 + x * XS + nl * DB * R1 + v * sr;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int w = 0; w < TN; ++w)
        if (TM * ti + i < DB && TN * tj + w < sr)
          cc[(TM * ti + i) * R1 + TN * tj + w] = c[i][w];
  }
}

// u[nl*P+u*q+x][m*sr+a] = sum_{k=(v,b)} t1[x][nl][m][k] Tt[x][k][u*sr+a]: a
// [DB x Y*sr] product per (x, nl), K = Y*sr.  Tasks take nl fastest among
// the batches, so a warp's lanes share Tt's rows (broadcasts).
__device__ __forceinline__ void prod_u(const T* __restrict__ t1,
                                       const T* __restrict__ Tc,
                                       T* __restrict__ u) {
  constexpr int TM = MW_BM, TN = MW_BN, K = Y * sr;
  constexpr int mt = (DB + TM - 1) / TM, ntl = (K + TN - 1) / TN;
  constexpr int tasks = mt * ntl * NC * q;
  for (int t = threadIdx.x; t < tasks; t += NT) {
    int r = t;
    const int tj = r % ntl; r /= ntl;
    const int ti = r % mt; r /= mt;
    const int nl = r % NC;
    const int x = r / NC;
    const T* a = t1 + x * XS + nl * DB * R1;
    const T* b = Tc + x * K * RT;
    int ia[TM], jb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ia[i] = min(TM * ti + i, DB - 1) * R1;
#pragma unroll
    for (int w = 0; w < TN; ++w) jb[w] = min(TN * tj + w, K - 1);
    T c[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int w = 0; w < TN; ++w) c[i][w] = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a[ia[i] + k];
      if (B_V2) {
#pragma unroll
        for (int w = 0; w < TN; w += 2)
          ld2(b + k * RT + TN * tj + w, bv[w], bv[(w + 1) % TN]);
      } else {
#pragma unroll
        for (int w = 0; w < TN; ++w) bv[w] = b[k * RT + jb[w]];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int w = 0; w < TN; ++w) c[i][w] += av[i] * bv[w];
    }
    T* cc = u + (nl * P + x) * RU;
#pragma unroll
    for (int w = 0; w < TN; ++w) {
      const int col = TN * tj + w;             // (u, a)
      if (col >= K) continue;
      const int co = (col / sr) * q * RU + col % sr;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (TM * ti + i < DB) cc[co + (TM * ti + i) * sr] = c[i][w];
    }
  }
}

// acc += sum_{K'} Ls[k][n0*P + K'] u[K'][c], K' = (nl, u, x) over the chunk:
// this thread's tile of W2 (rows k, columns c = (m, a)), kept in registers.
__device__ __forceinline__ void prod_w2(const T* __restrict__ Lc,
                                        const T* __restrict__ u,
                                        T (&acc)[CM][CN], int ti, int tj,
                                        int n0) {
  int ia[CM], jb[CN];
#pragma unroll
  for (int i = 0; i < CM; ++i) ia[i] = min(CM * ti + i, DL - 1) * LR + n0 * P;
#pragma unroll
  for (int w = 0; w < CN; ++w) jb[w] = min(CN * tj + w, DB * sr - 1);
#pragma unroll
  for (int k0 = 0; k0 < NC * P; k0 += C_KV) {
    T av[CM][C_KV];
#pragma unroll
    for (int i = 0; i < CM; ++i) ld4(Lc + ia[i] + k0, av[i]);
#pragma unroll
    for (int kk = 0; kk < C_KV; ++kk) {
      T bv[CN];
#pragma unroll
      for (int w = 0; w < CN; ++w) bv[w] = u[(k0 + kk) * RU + jb[w]];
#pragma unroll
      for (int i = 0; i < CM; ++i)
#pragma unroll
        for (int w = 0; w < CN; ++w) acc[i][w] += av[i][kk] * bv[w];
    }
  }
}

__global__ void __launch_bounds__(NT, MW_MINB)
merge_w_staged_kernel(const T* __restrict__ L, Str6 sL,
                      const T* __restrict__ Bm, Str6 sB,
                      const T* __restrict__ Th, T* __restrict__ Ws, int S) {
  constexpr int NWARP = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red_m[NWARP];
  __shared__ int red_b[NWARP];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* W = sm;
  T* Ls = W + nW;
  T* Bs = Ls + 2 * nLs;
  T* Tt = Bs + 2 * nBs;
  T* t1 = Tt + 2 * nTt;
  T* u = t1 + nT1;
  const i64 z = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // issue the copies of step t's L_t, B_t (rows padded) and Th_t
  // (transposed) into buffer t & 1
  auto stage_step = [&](int t) {
    const int buf = t & 1;
    const T* ls = L + z * sL.s[0] + t * sL.s[1];
    const T* bs = Bm + z * sB.s[0] + t * sB.s[1];
    T* ld = Ls + buf * nLs;
    T* bd = Bs + buf * nBs;
    for (int i = tid; i < DL * DL * P; i += NT) {
      const int x = i % q, uu = (i / q) % Y, n = (i / P) % DL;
      const int k = i / (DL * P);
      __pipeline_memcpy_async(
          ld + k * LR + n * P + uu * q + x,
          ls + k * sL.s[2] + n * sL.s[3] + uu * sL.s[4] + x * sL.s[5],
          sizeof(T));
    }
    for (int i = tid; i < DB * DB * P; i += NT) {
      const int x = i % q, v = (i / q) % Y, j = (i / P) % DB, m = i / (DB * P);
      __pipeline_memcpy_async(
          bd + m * BR + j * P + v * q + x,
          bs + m * sB.s[2] + j * sB.s[3] + v * sB.s[4] + x * sB.s[5],
          sizeof(T));
    }
    const T* th = Th + (i64)t * (sr * sr * Y * P);
    T* td = Tt + buf * nTt;
    for (int i = tid; i < sr * sr * Y * P; i += NT) {  // Th_t[a][b][u][v][x]
      const int x = i % q, v = (i / q) % Y, uu = (i / P) % Y;
      const int b = (i / (Y * P)) % sr, a = i / (sr * Y * P);
      __pipeline_memcpy_async(
          td + (x * Y * sr + v * sr + b) * RT + uu * sr + a, th + i,
          sizeof(T));
    }
  };
  // store W (the carry, rows padded) to Ws[:, s], coalesced
  auto store_w = [&](int s) {
    T* out = Ws + (z * S + s) * (i64)nOut;
    for (int i = tid; i < nOut; i += NT)
      out[i] = W[(i / (DB * sr)) * WN + i % (DB * sr)];
  };
  // W2's register tile of this thread (threads past C_MT x C_NTL hold none)
  const bool owner = tid < C_MT * C_NTL;
  const int cti = tid / C_NTL, ctj = tid % C_NTL;

  // zero W (one-hot W_{T1}) and both L buffers (their pads stay 0)
  for (int i = tid; i < nW; i += NT) W[i] = (i == 0) ? T(1) : T(0);
  for (int i = tid; i < 2 * nLs; i += NT) Ls[i] = T(0);
  __syncthreads();
  stage_step(S - 1);
  __pipeline_commit();
  for (int s = S - 1; s >= 0; --s) {
    const T* Lc = Ls + (s & 1) * nLs;
    const T* Bc = Bs + (s & 1) * nBs;
    const T* Tc = Tt + (s & 1) * nTt;
    if (s > 0) stage_step(s - 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);                                  // step s's
    __syncthreads();
    if (s < S - 1) store_w(s + 1);                             // W_{s+2}
    T acc[CM][CN];
#pragma unroll
    for (int i = 0; i < CM; ++i)
#pragma unroll
      for (int w = 0; w < CN; ++w) acc[i][w] = T(0);
    for (int ch = 0; ch < NCH; ++ch) {
      const int n0 = ch * NC;
      prod_t1(Bc, W, t1, n0);                                  // t1 = B_t . W
      __syncthreads();
      prod_u(t1, Tc, u);                                       // u = t1 . Th_t
      __syncthreads();
      if (owner) prod_w2(Lc, u, acc, cti, ctj, n0);            // W2 += L_t . u
    }
    // max-abs of W2 with the _safe_scale guard: per-warp partials, then
    // every thread folds the partials itself (one barrier)
    double mx = 0.0;
    int bad = 0;
    if (owner) {
#pragma unroll
      for (int i = 0; i < CM; ++i)
#pragma unroll
        for (int w = 0; w < CN; ++w)
          if (CM * cti + i < DL && CN * ctj + w < DB * sr) {
            const double v = (double)acc[i][w];
            if (!isfinite(v)) bad = 1; else mx = fmax(mx, fabs(v));
          }
    }
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      bad |= __shfl_xor_sync(0xffffffffu, bad, o);
    }
    if (lane == 0) { red_m[warp] = mx; red_b[warp] = bad; }
    __syncthreads();
    mx = 0.0;
    bad = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      mx = fmax(mx, red_m[w]);
      bad |= red_b[w];
    }
    const T sc = (bad || !(mx > 0.0)) ? T(1) : T(mx);
    if (owner) {
#pragma unroll
      for (int i = 0; i < CM; ++i)
#pragma unroll
        for (int w = 0; w < CN; ++w)
          if (CM * cti + i < DL && CN * ctj + w < DB * sr)
            W[(CM * cti + i) * WN + CN * ctj + w] = acc[i][w] / sc;
    }
  }
  __syncthreads();
  store_w(0);                                                  // W_1
}


// The launcher: returns cudaGetLastError() (or the error of the
// shared-memory attribute call) as an int, and cudaErrorInvalidValue for a
// shape other than the one this library was built for.
extern "C" int merge_w_staged(const void* L, const i64* sL, const void* B,
                              const i64* sB, const void* Th, void* Ws, int Bn,
                              int S, int DL_, int DB_, int Y_, int q_, int sr_,
                              long long smem, void* stream) {
  if (DL_ != DL || DB_ != DB || Y_ != Y || q_ != q || sr_ != sr)
    return (int)cudaErrorInvalidValue;
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  int threads = NT;
  int e = prepare(merge_w_staged_kernel, (size_t)smem, &threads);
  if (e) return e;
  if (threads != NT) return (int)cudaErrorInvalidConfiguration;
  merge_w_staged_kernel<<<Bn, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)L, a, (const T*)B, b, (const T*)Th, (T*)Ws, S);
  return (int)cudaGetLastError();
}
