// MPEM3 -> MPEM2 conversion scans, staged, for Hopper (sm_90a): the forward
// (F) and reverse (W) scans of stta_scans.cu's mpem3_f_kernel and
// mpem3_w_kernel for the f32 shapes whose buffers fit and whose B_t is one
// dense, 16-byte-aligned run per instance-step, compiled once per shape.
//
// Replace, as mpem3_f_kernel and mpem3_w_kernel do, the Pallas TPU kernels
// _mpem3_fstep_kernel (matrixproductbp_tpu/ops/fused_stta.py:545; grid
// wrapper _mpem3_fscan :628, pallas_call :636) and _mpem3_wstep_kernel
// (:508; _mpem3_wscan :605, pallas_call :611).  Their plain versions are
// matrixproductbp_tpu_torch/ops/stta.py::mpem3_fscan_plain and
// mpem3_wscan_plain.  The wrappers (fused_stta.py::mpem3_fscan and
// mpem3_wscan) take them where fused_stta.py::mpem3_geometry picks them.
//
// With m, n over Db, i, r over qi, j over qj, b, c over sr and e, f over sl,
// a step of F (time t = s+1) computes
//   t1[e,n,i,j,r] = sum_m S[e,m,i] B_t[m,n,i,j,r]
//   M[e,b]        = sum_{m,i} S[e,m,i] W_t[m,i,b]
//   N[e,i,j,b]    = sum_{n,r} t1[e,n,i,j,r] W_{t+1}[n,r,b]  (one-hot W at s=S-1)
//   S2[f,n,r]     = sum_{e,i,j} Phi_t[e,f,i,j] t1[e,n,i,j,r];  S <- S2 / scale
// and a step of W (reverse, from the one-hot W_{T1})
//   t1[m,i,j,c]   = sum_{n,r} B_t[m,n,i,j,r] W[n,r,c]
//   W2[m,i,b]     = sum_{j,c} t1[m,i,j,c] Psi_t[b,c,i,j];  W <- W2 / scale
// with the per-instance max-abs scale and the _safe_scale guard (a zero or
// non-finite max gives 1).
//
// What bounds them.  F does ~41k FMAs an instance-step at D=10 (265k at
// D=20), W 12k (96k), against 3.2 KB (12.8 KB) of B_t: at the card's peaks
// F is bound by bytes at D=10 and by operations at D=20, W by bytes at both.
// The first designs ran 9-14x above those bounds: every size a run-time
// integer (each staged element and each product task decoded by / and %),
// synchronous staging behind a block barrier, W_t and W_{t+1} read from
// global memory inside F's k-loops, 2x2 register tiles (one shared load an
// FMA) and six block barriers a step, one 128-thread block an instance.
// This design:
//   - the sizes, the B_t element order, the threads an instance, the
//     instances a block and every product's register tile are macros (one
//     build per shape), so task decodes, strides and K loops fold into the
//     code;
//   - each instance is a group of M3_GT threads, M3_IPB groups a block: one
//     warp, or two where a step does over 90k FMAs (the D=20 message W
//     step, the D=20 F steps; more threads an instance ran slower,
//     tools/probe_mpem3.py --gt); a group synchronises with __syncwarp or
//     its own named barrier, and the block barrier comes once a step, where
//     the operands shared by the block (Phi_t, Psi_t) change buffers;
//   - every streamed operand arrives by cp.async one step ahead, in 16-byte
//     chunks where its rows allow: B_t (one dense run an instance-step, in
//     the order it lies in: the products read either layout through
//     compile-time strides, with no transposing pass) and Phi_t / Psi_t
//     (one copy a block) into two buffers, and in F W_t and W_{t+1} into
//     three rotating ones, so no product reads global memory;
//   - every contraction is one product a step over all its batches, with a
//     register tile and a K split over lanes picked per shape by
//     fused_stta.py::_pick_tile_split; rows of S and t1 are padded to odd
//     strides against bank conflicts;
//   - the max-abs is taken from the last product's registers, reduced by
//     warp shuffles (and one group barrier across a group's warps);
//   - M and N are formed in shared memory and stored with 16-byte stores;
//     W is scaled and stored in one pass.
// fp32 FMAs throughout (no TF32): the scans' outputs feed a solve that
// amplifies round-off.
//
// A step of F (group barriers "|g", the block barrier "|B"):
//   wait for step s's copies                                     |B
//   cp.async B_{t+1}, Phi_{t+1} and W_{t+2}
//   t1 = S . B_t                                                 |g
//   M = S . W_t;  N = t1 . W_{t+1};  S2 = Phi_t . t1 (max-abs)   |g
//   S2 /= scale;  store M and N
// A step of W:
//   wait for step s's copies                                     |B
//   cp.async B_{t-1}, Psi_{t-1}
//   t1 = B_t . W                                                 |g
//   W2 = t1 . Psi_t, over W (max-abs)                            |g
//   W /= scale and store it
//
// Built once per shape.  M3_T, M3_DB, M3_QI, M3_QJ, M3_SR, M3_SL (0 builds
// W, else F), M3_LAYOUT (B_t's element order: 0 for (i, j, r, m, n), the
// message conversion's time-major rows; 1 for (m, n, i, j, r), the belief
// conversion's), M3_GT, M3_IPB, M3_MINB (blocks an SM: the register budget
// __launch_bounds__ gives ptxas) and the tiles M3_Pk_TM, M3_Pk_TN, M3_Pk_KS
// of products k = 0.. come from fused_stta.py::mpem3_staged_macros.
// M3_CLOCKS=1 adds clock64 counters by phase (tools/probe_mpem3.py
// --attribute).
//
// Shared memory (elements of T, each buffer rounded up to 16 bytes;
// fused_stta.py::_smem_mpem3_staged computes the same sums), with
// MI = Db*qi, P = qi*qj, nB = Db^2*P*qi:
//   F, a block: 2*sl^2*P (Phi_t, two steps); an instance: 2*sl*(MI|1)
//     (S and S2) + 2*nB (B_t) + 3*MI*sr (W) + sl*P*(MI|1) (t1) + M and N
//     (sl*sr + sl*P*sr, over the step's B_t buffer where they fit).
//     D=10, qj=2: 1,568 + 3,968 floats an instance (15.5 KiB); D=20:
//     4,608 + 14,704 (57.4 KiB).
//   W, a block: 2*sr^2*P (Psi_t); an instance: MI*sr (W) + 2*nB (B_t) +
//     MI*(qj*sr|1) (t1).  D=10, qj=2: 800 + 2,220 (8.7 KiB); D=20:
//     3,200 + 8,840 (34.5 KiB).
// Shared layouts: F: S [e][m*qi+i] (row SE); t1 [e*P+i*qj+j][n*qi+r] (row
// R1); W [m*qi+i][b]; M [e][b], N [e][i][j][b].  W: W [m*qi+i][c]; t1
// [i*Db+m][j*sr+c] (row R2).

#include <type_traits>

#include "stta_common.cuh"

#if !defined(M3_T) || !defined(M3_DB) || !defined(M3_QI) ||                  \
    !defined(M3_QJ) || !defined(M3_SR) || !defined(M3_SL) ||                 \
    !defined(M3_LAYOUT) || !defined(M3_GT) || !defined(M3_IPB) ||            \
    !defined(M3_MINB) || !defined(M3_P0_TM) || !defined(M3_P0_TN) ||         \
    !defined(M3_P0_KS) || !defined(M3_P1_TM) || !defined(M3_P1_TN) ||        \
    !defined(M3_P1_KS)
#error "mpem3_staged.cu is built per shape: define M3_T, M3_DB, M3_QI, M3_QJ, M3_SR, M3_SL, M3_LAYOUT, M3_GT, M3_IPB, M3_MINB and the tiles M3_Pk_TM, M3_Pk_TN, M3_Pk_KS"
#endif
#ifndef M3_CLOCKS
#define M3_CLOCKS 0
#endif

typedef M3_T T;
constexpr int Db = M3_DB, qi = M3_QI, qj = M3_QJ, sr = M3_SR, sl = M3_SL;
constexpr int P = qi * qj, P3 = P * qi, MI = Db * qi;
constexpr int nB = Db * Db * P3, nW = MI * sr;
constexpr int GT = M3_GT, IPB = M3_IPB, NT = GT * IPB, NWG = GT / 32;
constexpr bool L0 = M3_LAYOUT == 0;
constexpr int V16 = 16 / sizeof(T);
constexpr int pad16(int n) { return (n + V16 - 1) / V16 * V16; }
constexpr int nBp = pad16(nB), nWp = pad16(nW);
static_assert(GT % 32 == 0 && IPB >= 1 && IPB <= 15 && NT <= 1024,
              "whole warps a group, at most 15 groups (named barriers 1-15)");
static_assert(M3_LAYOUT == 0 || M3_LAYOUT == 1, "two B_t layouts");

// 16 bytes of T, and their quotient by a scalar
typedef typename std::conditional<sizeof(T) == 4, float4, double2>::type V16T;
__device__ __forceinline__ float4 vdiv(float4 v, float s) {
  return make_float4(v.x / s, v.y / s, v.z / s, v.w / s);
}
__device__ __forceinline__ double2 vdiv(double2 v, double s) {
  return make_double2(v.x / s, v.y / s);
}

// A group's barrier: its warp, or named barrier 1 + g over its GT threads.
__device__ __forceinline__ void group_sync(int g) {
  if (GT == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(GT) : "memory");
  }
}

// cp.async of N contiguous elements by NTH threads (index tid): 16-byte
// chunks where N elements fill them, else 8- or element-wide.  Both ends
// are aligned to the chunk: shared buffers are rounded up to 16 bytes, and
// the global rows are whole multiples of the chunk from a 16-byte base.
template <int N, int NTH>
__device__ __forceinline__ void acopy(T* dst, const T* src, int tid) {
  constexpr int BY = N * (int)sizeof(T);
  constexpr int W = BY % 16 == 0 ? 16 : BY % 8 == 0 ? 8 : (int)sizeof(T);
  for (int i = tid; i < BY / W; i += NTH)
    __pipeline_memcpy_async(reinterpret_cast<char*>(dst) + W * i,
                            reinterpret_cast<const char*>(src) + W * i, W);
}

// Store N contiguous elements from shared memory, 16 bytes a store where N
// elements fill them.
template <int N>
__device__ __forceinline__ void vstore(T* dst, const T* src, int tid) {
  constexpr int BY = N * (int)sizeof(T);
  if (BY % 16 == 0) {
    for (int i = tid; i < BY / 16; i += GT)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
  } else if (BY % 8 == 0) {
    for (int i = tid; i < BY / 8; i += GT)
      reinterpret_cast<uint2*>(dst)[i] =
          reinterpret_cast<const uint2*>(src)[i];
  } else {
    for (int i = tid; i < N; i += GT) dst[i] = src[i];
  }
}

// One step k1 of a product (all k2): TM + TN shared loads, TM x TN FMAs.
template <class Op>
__device__ __forceinline__ void kstep(const T* __restrict__ A,
                                      const T* __restrict__ B,
                                      const int (&ia)[Op::TM],
                                      const int (&jb)[Op::TN],
                                      T (&c)[Op::TM][Op::TN], int k1) {
#pragma unroll
  for (int k2 = 0; k2 < Op::K2; ++k2) {
    const int oa = k1 * Op::A1 + k2 * Op::A2;
    const int ob = k1 * Op::B1 + k2 * Op::B2;
    T av[Op::TM], bv[Op::TN];
#pragma unroll
    for (int u = 0; u < Op::TM; ++u) av[u] = A[ia[u] + oa];
#pragma unroll
    for (int v = 0; v < Op::TN; ++v) bv[v] = B[jb[v] + ob];
#pragma unroll
    for (int u = 0; u < Op::TM; ++u)
#pragma unroll
      for (int v = 0; v < Op::TN; ++v) c[u][v] += av[u] * bv[v];
  }
}

// One product of a group: for every batch b, C[b](i,j) = sum_k A[b](i,k)
// B[b](k,j), i < M, j < N, k = k1*K2 + k2.  Op gives the sizes, the strides
// of k1 and k2 in A (A1, A2) and in B (B1, B2), the register tile TM x TN,
// the K split KS (over k1, across neighbouring lanes, reduced by shuffles)
// and the offsets ar(b,i) of A's rows, bc(b,j) of B's columns and co(b,i,j)
// of C's entries.  Rows and columns past M, N load the last valid ones and
// store nothing.  With MAX, the max-abs and a non-finite flag of what it
// stores are folded into mx and bad.
template <class Op, bool MAX>
__device__ __forceinline__ void gprod(const T* __restrict__ A,
                                      const T* __restrict__ B,
                                      T* __restrict__ C, int gt, T& mx,
                                      int& bad) {
  constexpr int TM = Op::TM, TN = Op::TN, KS = Op::KS;
  constexpr int mt = (Op::M + TM - 1) / TM, nt = (Op::N + TN - 1) / TN;
  constexpr int tiles = Op::NB * mt * nt;
  constexpr int tasks = KS == 1 ? tiles : (tiles * KS + 31) / 32 * 32;
  static_assert(KS >= 1 && KS <= 32 && (KS & (KS - 1)) == 0, "KS");
  for (int t = gt; t < tasks; t += GT) {
    const int ks = t % KS;
    int r = t / KS;
    const bool live = r < tiles;
    if (!live) r = 0;
    const int tj = r % nt;
    r /= nt;
    const int ti = r % mt;
    const int b = r / mt;
    int ia[TM], jb[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) ia[u] = Op::ar(b, min(TM * ti + u, Op::M - 1));
#pragma unroll
    for (int v = 0; v < TN; ++v) jb[v] = Op::bc(b, min(TN * tj + v, Op::N - 1));
    T c[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) c[u][v] = T(0);
    // k2 always unrolls; k1 too where the whole K is short, once where k2
    // alone gives 8 steps or more (unrolling both let ptxas hoist the loads
    // of many steps and spill), else by 4
    if constexpr (KS == 1 && Op::K1 * Op::K2 <= 48 && Op::K2 < 8) {
#pragma unroll
      for (int k1 = 0; k1 < Op::K1; ++k1) kstep<Op>(A, B, ia, jb, c, k1);
    } else if constexpr (Op::K2 >= 8) {
#pragma unroll 1
      for (int k1 = ks; k1 < Op::K1; k1 += KS) kstep<Op>(A, B, ia, jb, c, k1);
    } else {
#pragma unroll 4
      for (int k1 = ks; k1 < Op::K1; k1 += KS) kstep<Op>(A, B, ia, jb, c, k1);
    }
#pragma unroll
    for (int o = KS >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v)
          c[u][v] += __shfl_xor_sync(0xffffffffu, c[u][v], o);
    if (!live || ks != 0) continue;
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const int i = TM * ti + u, j = TN * tj + v;
        if (i < Op::M && j < Op::N) {
          C[Op::co(b, i, j)] = c[u][v];
          if (MAX) {
            if (!isfinite(c[u][v])) bad = 1;
            else mx = fmax(mx, fabs(c[u][v]));
          }
        }
      }
  }
}

// The group's max-abs with the _safe_scale guard, from each thread's mx and
// bad: warp shuffles, then (several warps a group) the warps' partials in
// red_m / red_b behind the group barrier.  Ends with the group synchronised
// (every store before it visible to the group).
__device__ __forceinline__ T group_scale(T mx, int bad, int g, T* red_m,
                                         int* red_b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
  }
  if (NWG > 1) {
    const int gt = threadIdx.x % GT;
    if ((gt & 31) == 0) {
      red_m[g * NWG + (gt >> 5)] = mx;
      red_b[g * NWG + (gt >> 5)] = bad;
    }
    group_sync(g);
    mx = T(0);
    bad = 0;
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      mx = fmax(mx, red_m[g * NWG + w]);
      bad |= red_b[g * NWG + w];
    }
  } else {
    __syncwarp();
  }
  return (bad || !(mx > T(0))) ? T(1) : mx;
}

#if M3_CLOCKS
// clock64 cycles by phase, summed over every block's thread 0 (probe only)
__device__ unsigned long long m3_clocks[8];
#define M3_TICK(k)                                      \
  do {                                                  \
    const long long now_ = clock64();                   \
    clk[k] += (unsigned long long)(now_ - clk_last);    \
    clk_last = now_;                                    \
  } while (0)
#define M3_CLOCK_INIT                  \
  unsigned long long clk[8] = {};      \
  long long clk_last = clock64();
#define M3_CLOCK_FLUSH                                          \
  if (threadIdx.x == 0)                                         \
    for (int k = 0; k < 8; ++k) atomicAdd(&m3_clocks[k], clk[k]);
extern "C" int mpem3_staged_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, m3_clocks, sizeof(m3_clocks));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(m3_clocks, zero, sizeof(zero));
}
#else
#define M3_TICK(k)
#define M3_CLOCK_INIT
#define M3_CLOCK_FLUSH
#endif

// B_t's element (m, n, i, j, r) in either layout, as a sum of compile-time
// strides: offsets of m, n, (i, j) = b (b = i*qj + j) and r
constexpr int BS_M = L0 ? Db : Db * P3, BS_N = L0 ? 1 : P3;
constexpr int BS_B = L0 ? qi * Db * Db : qi, BS_R = L0 ? Db * Db : 1;

#if M3_SL > 0
// ---------------------------------------------------------------------------
// MPEM3 F
// ---------------------------------------------------------------------------
constexpr int SE = MI | 1, R1 = MI | 1;
constexpr int nF = sl * sl * P, nM = sl * sr, nN = sl * P * sr;
constexpr int nFp = pad16(nF), nSb = pad16(sl * SE), nT1 = pad16(sl * P * R1);
constexpr int oN = pad16(nM), nOb = oN + nN;
constexpr bool OB_IN_B = nOb <= nBp;       // M and N over the step's B_t
constexpr int nInst = 2 * nSb + 2 * nBp + 3 * nWp + nT1 +
                      (OB_IN_B ? 0 : pad16(nOb));

// t1[e*P+b][n*qi+r] = sum_m S[e][m*qi+i] B_t[m,n,i,j,r], b = i*qj + j
struct OpT1 {
  static constexpr int NB = P, M = sl, N = MI, K1 = Db, K2 = 1;
  static constexpr int A1 = qi, A2 = 0, B1 = BS_M, B2 = 0;
  static constexpr int TM = M3_P0_TM, TN = M3_P0_TN, KS = M3_P0_KS;
  static __device__ __forceinline__ int ar(int b, int e) {
    return e * SE + b / qj;
  }
  static __device__ __forceinline__ int bc(int b, int c) {
    return (c / qi) * BS_N + b * BS_B + (c % qi) * BS_R;
  }
  static __device__ __forceinline__ int co(int b, int e, int c) {
    return (e * P + b) * R1 + c;
  }
};
// M[e][b] = sum_{k = m*qi+i} S[e][k] W_t[k][b]
struct OpM {
  static constexpr int NB = 1, M = sl, N = sr, K1 = MI, K2 = 1;
  static constexpr int A1 = 1, A2 = 0, B1 = sr, B2 = 0;
  static constexpr int TM = M3_P1_TM, TN = M3_P1_TN, KS = M3_P1_KS;
  static __device__ __forceinline__ int ar(int, int e) { return e * SE; }
  static __device__ __forceinline__ int bc(int, int c) { return c; }
  static __device__ __forceinline__ int co(int, int e, int c) {
    return e * sr + c;
  }
};
// N[w][b] = sum_{k = n*qi+r} t1[w][k] W_{t+1}[k][b], w = e*P + i*qj + j
struct OpN {
  static constexpr int NB = 1, M = sl * P, N = sr, K1 = MI, K2 = 1;
  static constexpr int A1 = 1, A2 = 0, B1 = sr, B2 = 0;
  static constexpr int TM = M3_P2_TM, TN = M3_P2_TN, KS = M3_P2_KS;
  static __device__ __forceinline__ int ar(int, int w) { return w * R1; }
  static __device__ __forceinline__ int bc(int, int c) { return c; }
  static __device__ __forceinline__ int co(int, int w, int c) {
    return oN + w * sr + c;
  }
};
// S2[f][n*qi+r] = sum_{e, p = i*qj+j} Phi_t[e][f][p] t1[e*P+p][n*qi+r]
struct OpS {
  static constexpr int NB = 1, M = sl, N = MI, K1 = sl, K2 = P;
  static constexpr int A1 = sl * P, A2 = 1, B1 = P * R1, B2 = R1;
  static constexpr int TM = M3_P3_TM, TN = M3_P3_TN, KS = M3_P3_KS;
  static __device__ __forceinline__ int ar(int, int f) { return f * P; }
  static __device__ __forceinline__ int bc(int, int c) { return c; }
  static __device__ __forceinline__ int co(int, int f, int c) {
    return f * SE + c;
  }
};

__global__ void __launch_bounds__(NT, M3_MINB)
mpem3_f_staged_kernel(const T* __restrict__ Bm, i64 sz, i64 st,
                      const T* __restrict__ Phi, const T* __restrict__ Ws,
                      const T* __restrict__ Sinit, T* __restrict__ Ns,
                      T* __restrict__ Ms, int Bn, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_m[IPB * NWG];
  __shared__ int red_b[IPB * NWG];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, g = tid / GT, gt = tid % GT;
  T* Ph = sm;                                   // [2][nFp], the block's
  T* Sb = sm + 2 * nFp + g * nInst;             // [2][nSb]
  T* Bt = Sb + 2 * nSb;                         // [2][nBp]
  T* Wb = Bt + 2 * nBp;                         // [3][nWp]
  T* T1 = Wb + 3 * nWp;                         // [sl*P][R1]
  T* Ox = T1 + nT1;                             // M, N where not over B_t
  const i64 zi = (i64)blockIdx.x * IPB + g;
  const bool live = zi < Bn;
  const i64 z = live ? zi : Bn - 1;             // a ragged block's spare
  const T* Bz = Bm + z * sz;                    // groups redo the last one
  const T* Wz = Ws + z * S * (i64)nW;
  M3_CLOCK_INIT

  auto stage_b = [&](int t) {
    acopy<nB, GT>(Bt + (t & 1) * nBp, Bz + t * st, gt);
  };
  auto stage_phi = [&](int t) {
    acopy<nF, NT>(Ph + (t & 1) * nFp, Phi + (i64)t * nF, tid);
  };
  auto stage_w = [&](int t) {
    acopy<nW, GT>(Wb + (t % 3) * nWp, Wz + (i64)t * nW, gt);
  };

  stage_b(0);
  stage_phi(0);
  stage_w(0);
  if (S > 1) stage_w(1);
  __pipeline_commit();
  for (int i = gt; i < sl * MI; i += GT) {      // S_0, rows padded
    const int e = i / MI, c = i - e * MI;
    Sb[e * SE + c] = Sinit[z * (sl * MI) + i];
  }
  for (int s = 0; s < S; ++s) {
    const T* Sc = Sb + (s & 1) * nSb;
    T* Sn = Sb + ((s + 1) & 1) * nSb;
    const T* Bc = Bt + (s & 1) * nBp;
    const T* Fc = Ph + (s & 1) * nFp;
    const T* Wt = Wb + (s % 3) * nWp;
    const T* Wt1 = Wb + ((s + 1) % 3) * nWp;
    T* Ob = OB_IN_B ? Bt + (s & 1) * nBp : Ox;
    __pipeline_wait_prior(0);                   // step s's copies
    __syncthreads();
    M3_TICK(0);
    if (s + 1 < S) {
      stage_b(s + 1);
      stage_phi(s + 1);
    }
    if (s + 2 < S) stage_w(s + 2);
    __pipeline_commit();
    M3_TICK(1);
    T mx = T(0);
    int bad = 0;
    gprod<OpT1, false>(Sc, Bc, T1, gt, mx, bad);           // t1 = S . B_t
    group_sync(g);
    M3_TICK(2);
    gprod<OpM, false>(Sc, Wt, Ob, gt, mx, bad);            // M = S . W_t
    M3_TICK(3);
    if (s == S - 1) {                           // N = t1 . one-hot
      for (int w = gt; w < sl * P; w += GT)
        onehot_row(T1 + w * R1, MI, Ob + oN + w * sr, sr);
    } else {
      gprod<OpN, false>(T1, Wt1, Ob, gt, mx, bad);         // N = t1 . W_{t+1}
    }
    M3_TICK(4);
    gprod<OpS, true>(Fc, T1, Sn, gt, mx, bad);             // S2 = Phi_t . t1
    M3_TICK(5);
    const T sc = group_scale(mx, bad, g, red_m, red_b);
    for (int i = gt; i < sl * MI; i += GT) {
      const int f = i / MI, c = i - f * MI;
      Sn[f * SE + c] = Sn[f * SE + c] / sc;
    }
    M3_TICK(6);
    if (live) {
      const i64 row = z * S + s;
      vstore<nM>(Ms + row * nM, Ob, gt);
      vstore<nN>(Ns + row * nN, Ob + oN, gt);
    }
    M3_TICK(7);
  }
  M3_CLOCK_FLUSH
}

// The launcher: returns cudaGetLastError() (or the error of the
// shared-memory attribute call) as an int, and cudaErrorInvalidValue for a
// shape or B_t layout other than the one this library was built for.
extern "C" int mpem3_f_staged(const void* B, const i64* sB, const void* Phi,
                              const void* Ws, const void* Sinit, void* Ns,
                              void* Ms, int Bn, int S, int Db_, int qi_,
                              int qj_, int sr_, int sl_, long long smem,
                              void* stream) {
  if (Db_ != Db || qi_ != qi || qj_ != qj || sr_ != sr || sl_ != sl)
    return (int)cudaErrorInvalidValue;
  const i64 inner[5] = {BS_M, BS_N, qj * BS_B, BS_B, BS_R};
  const int dims[5] = {Db, Db, qi, qj, qi};
  for (int a = 0; a < 5; ++a)
    if (dims[a] > 1 && sB[2 + a] != inner[a]) return (int)cudaErrorInvalidValue;
  int threads = NT;
  int e = prepare(mpem3_f_staged_kernel, (size_t)smem, &threads);
  if (e) return e;
  if (threads != NT) return (int)cudaErrorInvalidConfiguration;
  mpem3_f_staged_kernel<<<(Bn + IPB - 1) / IPB, NT, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const T*)B, sB[0], sB[1], (const T*)Phi, (const T*)Ws,
      (const T*)Sinit, (T*)Ns, (T*)Ms, Bn, S);
  return (int)cudaGetLastError();
}

#else
// ---------------------------------------------------------------------------
// MPEM3 W
// ---------------------------------------------------------------------------
constexpr int R2 = (qj * sr) | 1;
constexpr int nPs = sr * sr * P, nPsp = pad16(nPs), nT1 = pad16(MI * R2);
constexpr int nInst = nWp + 2 * nBp + nT1;

// t1[i*Db+m][j*sr+c] = sum_{n,r} B_t[m,n,i,j,r] W[n*qi+r][c], b = i*qj + j;
// k1 and k2 run over B_t's slower and faster axis of (n, r)
struct OpT1 {
  static constexpr int NB = P, M = Db, N = sr;
  static constexpr int K1 = L0 ? qi : Db, K2 = L0 ? Db : qi;
  static constexpr int A1 = L0 ? BS_R : BS_N, A2 = L0 ? BS_N : BS_R;
  static constexpr int B1 = L0 ? sr : qi * sr, B2 = L0 ? qi * sr : sr;
  static constexpr int TM = M3_P0_TM, TN = M3_P0_TN, KS = M3_P0_KS;
  static __device__ __forceinline__ int ar(int b, int m) {
    return m * BS_M + b * BS_B;
  }
  static __device__ __forceinline__ int bc(int, int c) { return c; }
  static __device__ __forceinline__ int co(int b, int m, int c) {
    return ((b / qj) * Db + m) * R2 + (b % qj) * sr + c;
  }
};
// W2[m*qi+i][b] = sum_{j,c} t1[i*Db+m][j*sr+c] Psi_t[b][c][i][j]
struct OpW2 {
  static constexpr int NB = qi, M = Db, N = sr, K1 = qj, K2 = sr;
  static constexpr int A1 = sr, A2 = 1, B1 = 1, B2 = P;
  static constexpr int TM = M3_P1_TM, TN = M3_P1_TN, KS = M3_P1_KS;
  static __device__ __forceinline__ int ar(int i, int m) {
    return (i * Db + m) * R2;
  }
  static __device__ __forceinline__ int bc(int i, int b) {
    return b * sr * P + i * qj;
  }
  static __device__ __forceinline__ int co(int i, int m, int b) {
    return (m * qi + i) * sr + b;
  }
};

__global__ void __launch_bounds__(NT, M3_MINB)
mpem3_w_staged_kernel(const T* __restrict__ Bm, i64 sz, i64 st,
                      const T* __restrict__ Psi, T* __restrict__ Ws, int Bn,
                      int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_m[IPB * NWG];
  __shared__ int red_b[IPB * NWG];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, g = tid / GT, gt = tid % GT;
  T* Ps = sm;                                   // [2][nPsp], the block's
  T* Wc = sm + 2 * nPsp + g * nInst;            // [nWp]
  T* Bt = Wc + nWp;                             // [2][nBp]
  T* T1 = Bt + 2 * nBp;                         // [qi*Db][R2]
  const i64 zi = (i64)blockIdx.x * IPB + g;
  const bool live = zi < Bn;
  const i64 z = live ? zi : Bn - 1;
  const T* Bz = Bm + z * sz;
  M3_CLOCK_INIT

  auto stage = [&](int t) {
    acopy<nB, GT>(Bt + (t & 1) * nBp, Bz + t * st, gt);
    acopy<nPs, NT>(Ps + (t & 1) * nPsp, Psi + (i64)t * nPs, tid);
  };

  stage(S - 1);
  __pipeline_commit();
  for (int i = gt; i < nW; i += GT) Wc[i] = (i == 0) ? T(1) : T(0);
  for (int s = S - 1; s >= 0; --s) {
    const T* Bc = Bt + (s & 1) * nBp;
    const T* Pc = Ps + (s & 1) * nPsp;
    __pipeline_wait_prior(0);                   // step s's copies
    __syncthreads();
    M3_TICK(0);
    if (s > 0) stage(s - 1);
    __pipeline_commit();
    M3_TICK(1);
    T mx = T(0);
    int bad = 0;
    gprod<OpT1, false>(Bc, Wc, T1, gt, mx, bad);           // t1 = B_t . W
    group_sync(g);
    M3_TICK(2);
    gprod<OpW2, true>(T1, Pc, Wc, gt, mx, bad);            // W2 = t1 . Psi_t
    M3_TICK(5);
    const T sc = group_scale(mx, bad, g, red_m, red_b);
    M3_TICK(6);
    // W <- W2 / scale, stored to Ws[:, s] in the same pass
    T* out = Ws + (z * S + s) * (i64)nW;
    constexpr int BY = nW * (int)sizeof(T);
    if (BY % 16 == 0) {
      for (int i = gt; i < BY / 16; i += GT) {
        const V16T v = vdiv(reinterpret_cast<const V16T*>(Wc)[i], sc);
        reinterpret_cast<V16T*>(Wc)[i] = v;
        if (live) reinterpret_cast<V16T*>(out)[i] = v;
      }
    } else {
      for (int i = gt; i < nW; i += GT) {
        const T w = Wc[i] / sc;
        Wc[i] = w;
        if (live) out[i] = w;
      }
    }
    M3_TICK(7);
  }
  M3_CLOCK_FLUSH
}

// The launcher: returns cudaGetLastError() (or the error of the
// shared-memory attribute call) as an int, and cudaErrorInvalidValue for a
// shape or B_t layout other than the one this library was built for.
extern "C" int mpem3_w_staged(const void* B, const i64* sB, const void* Psi,
                              void* Ws, int Bn, int S, int Db_, int qi_,
                              int qj_, int sr_, long long smem,
                              void* stream) {
  if (Db_ != Db || qi_ != qi || qj_ != qj || sr_ != sr)
    return (int)cudaErrorInvalidValue;
  const i64 inner[5] = {BS_M, BS_N, qj * BS_B, BS_B, BS_R};
  const int dims[5] = {Db, Db, qi, qj, qi};
  for (int a = 0; a < 5; ++a)
    if (dims[a] > 1 && sB[2 + a] != inner[a]) return (int)cudaErrorInvalidValue;
  int threads = NT;
  int e = prepare(mpem3_w_staged_kernel, (size_t)smem, &threads);
  if (e) return e;
  if (threads != NT) return (int)cudaErrorInvalidConfiguration;
  mpem3_w_staged_kernel<<<(Bn + IPB - 1) / IPB, NT, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const T*)B, sB[0], sB[1], (const T*)Psi, (T*)Ws, Bn, S);
  return (int)cudaGetLastError();
}
#endif
