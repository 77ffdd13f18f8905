// Wide merge scans for Hopper (sm_90a): merge W and merge F with one
// instance over a thread-block cluster, every intermediate of a step in the
// cluster's shared memory, built once per shape.
//
// Replaces the Pallas TPU kernels of matrixproductbp_tpu/ops/fused_stta.py:
//   merge_w_wide <- _merge_wstep_kernel (fused_stta.py:231, grid wrapper
//                   _merge_wscan :359, pallas_call :365)
//   merge_f_wide <- _merge_fstep_kernel (:281) and _merge_fstep_kernel_lean
//                   (:382), grid wrapper _merge_fscan (:466, pallas_call :477)
// at the shapes whose buffers fit no single block of merge_f_staged.cu,
// merge_f_cluster.cu, merge_w_staged.cu or stta_scans.cu, but fit a cluster
// of up to eight blocks (fused_stta.py::merge_f_geometry / merge_w_geometry
// pick it after those and before merge_streamed.cu: the Glauber merges at
// D=18, Y = 5, 9, 10, the f64 sketch merges from D=16 to D=20 and more).
// Plain versions: matrixproductbp_tpu_torch/ops/stta.py::merge_wscan_plain /
// merge_fscan_plain, with the same arguments and strides.
//
// What bounds them.  An instance-step is a chain of dependent products whose
// operands grow as D^4 Y: at D=18, Y=9, f32, ~13 MFMA a step of merge W
// (the band counted) against ~25 kB of streamed input, so both scans are
// bound by fp32 FMAs off the tensor cores (f64: by the DMMA rate of the
// tensor cores).  merge_streamed.cu ran them at 10-12% of that peak: each
// operand element cost an offset-table lookup and a division (one build
// served every shape), every intermediate went through global memory, each
// block transposed the shared Th_t into its workspace, the band was read
// dense, and one block owned one instance.
//
// Design.  Every extent and stride is a macro of the build
// (fused_stta.py::merge_wide_macros), so each product below is a template
// whose index arithmetic folds to constants: no offset tables, no divisions
// in the inner loops, no per-element bounds tests.  One instance is split
// over a cluster of WD_C blocks (grid WD_C x instances): merge W by the rows
// m of W_t (t1, u and W_t's slice are block-local; after each step the
// blocks all-gather W_t over distributed shared memory), merge F by the
// sketch rows e (t1, t2, M and N are row-local; after each step the blocks
// reduce-scatter the S2 partials over distributed shared memory).  The
// per-instance max-abs rescale, with the _safe_scale guard (a zero or
// non-finite max gives 1), is cluster-wide.  The whole time loop stays in
// one launch.  The step's operands (L_t, B_t, Phi_t, W_{t+1} and the shared
// Th_t) are staged by cp.async into each block's shared memory in the
// layout the products read: banded tables (WD_BAND, the Glauber merges)
// stage Th_t's band as psi[w][b][a] (w = u + v - WD_OFF) and read B_t along
// the band instead of building Bp, and every banded product runs over the
// band's pairs alone (each register tile lies in one column block u or y,
// whose pairs are a contiguous range of the sums).  f32 products run on the
// FP32 FMAs with TM x TN register tiles (up to 8 x 8) and the sums split
// over KS lanes where a product has few outputs; f64 products run on the
// tensor cores (mma.sync m8n8k4 f64, exact fp64 FMAs), each warp a tile of
// 8 WM x 8 WN outputs.  N's last step is the full product with the one-hot
// W, and step 0 reads S_init unscaled, as in the plain scan.
//
// Shared memory, a block (elements of T, each buffer rounded up to 16
// bytes; fused_stta.py::_smem_merge_wide computes the same sums):
//   merge W (MR = ceil(DB / C) rows m a block): W_{t+1} DL*DB*sr, W_t's
//     slice 2 x DL*MR*sr (by step parity: a block's peers may still read
//     the last step's), L_t DL*DL*Y, B_t's rows MR*DB*Y, Th_t Y*sr*sr
//     (band) or Y*Y*sr*sr, t1 MR*Y*DL*sr, u MR*DL*Y*sr.
//   merge F (EL = ceil(sl / C) rows e a block): S's rows EL*DL*DB, the S2
//     partials sl*DL*DB, W_{t+1} DL*DB*sr, L_t DL*DL*Y, B_t DB*DB*Y, Phi_t's
//     rows EL*sl*Y, t1 and t2 EL*DL*DB*Y each, Bp Y*DB*Y*DB (dense only).
// Layouts: t1 [m][v][n][b] and u [m][n][u][a] (W); S [e][k][m], t1
// [e][m][n][u], t2 [e][y][n][j], Bp [u][m][y][j] (F).

#include <cooperative_groups.h>

#include "merge_f_tiles.cuh"

#if !defined(WD_T) || !defined(WD_KIND) || !defined(WD_DL) || \
    !defined(WD_DB) || !defined(WD_Y) || !defined(WD_Q) || !defined(WD_SR) || \
    !defined(WD_SL) || !defined(WD_C) || !defined(WD_BAND) || !defined(WD_OFF)
#error "merge_wide.cu is built per shape: define WD_T, WD_KIND, WD_DL, WD_DB, WD_Y, WD_Q, WD_SR, WD_SL, WD_C, WD_BAND, WD_OFF and the tiles WD_P<i>_TM/TN/KS"
#endif
#ifndef WD_NT
#define WD_NT 384
#endif

namespace cg = cooperative_groups;

typedef WD_T T;
constexpr bool F64 = sizeof(T) == 8;
constexpr int NT = WD_NT;              // threads a block
constexpr int NWARP = NT / 32;
constexpr int C = WD_C;                // blocks a cluster (an instance)
constexpr int DL = WD_DL, DB = WD_DB, Y = WD_Y, q = WD_Q, sr = WD_SR,
              sl = WD_SL;
constexpr bool BAND = WD_BAND;
constexpr int OFF = WD_OFF;
constexpr int DLB = DL * DB;
constexpr int V16 = 16 / (int)sizeof(T);

constexpr int pad16(int n) { return (n + V16 - 1) / V16 * V16; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Cluster barrier of all threads of all blocks: arrive has release and wait
// acquire semantics at cluster scope, so shared-memory writes made before
// arrive are seen by reads (local or remote) made after wait.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One product C[i, j] (+)= sum_k A[i, k] B[k, j], every extent and stride a
// constant: rows i = (i0, i1), i0 < M0 (a run-time count up to it), i1 <
// M1, at A + i0*AM0 + i1*AM1 and C + i0*CM0 + i1*CM1; columns j = (j0, j1),
// j0 < N0 (a run-time count), j1 < N1, at B + j0*BN0 + j1*BN1 and C +
// j0*CN0 + j1*CN1; sums k = (k0, k1), k1 < K1, k0 in [lo(j0), hi(j0)): all
// of [0, K0) (BANDK 0), or the band's pairs of column block j0: merge W's u
// product (BANDK 1, columns (u, a), sums (v, b): 0 <= u + v - OFF < Y) and
// merge F's t2 (BANDK 2, columns (y, j), sums (u, m): 0 <= y + OFF - u < Y).
template <int M0_, int M1_, int AM0_, int AM1_, int CM0_, int CM1_,
          int N0_, int N1_, int BN0_, int BN1_, int CN0_, int CN1_,
          int K0_, int K1_, int AK0_, int AK1_, int BK0_, int BK1_,
          int BANDK_>
struct Prod {
  static constexpr int M0 = M0_, M1 = M1_, AM0 = AM0_, AM1 = AM1_,
                       CM0 = CM0_, CM1 = CM1_;
  static constexpr int N0 = N0_, N1 = N1_, BN0 = BN0_, BN1 = BN1_,
                       CN0 = CN0_, CN1 = CN1_;
  static constexpr int K0 = K0_, K1 = K1_, AK0 = AK0_, AK1 = AK1_,
                       BK0 = BK0_, BK1 = BK1_;
  __device__ __forceinline__ static int lo(int j0) {
    return BANDK_ == 1 ? imax(0, OFF - j0)
         : BANDK_ == 2 ? imax(0, j0 + OFF - Y + 1) : 0;
  }
  __device__ __forceinline__ static int hi(int j0) {
    return BANDK_ == 1 ? imin(Y, Y + OFF - j0)
         : BANDK_ == 2 ? imin(Y, j0 + OFF + 1) : K0;
  }
};

// The product P by the whole block on the FP32 (or FP64) FMAs: each task a
// TM x TN register tile of neighbouring rows and of neighbouring columns of
// one column block j0, its sums k1 split over KS neighbouring lanes (tasks
// padded to whole warps, reduced by shuffles).  Rows and columns past the
// edge read the last one and store nothing.  m0n, n0n: the run-time counts
// of i0 and j0; k0n caps k0.  Every thread calls it; the caller
// synchronises before C is read.
template <class P, int TM, int TN, int KS, bool ACC>
__device__ __forceinline__ void gemm_fma(const T* __restrict__ A,
                                         const T* __restrict__ B,
                                         T* __restrict__ C, int m0n, int n0n,
                                         int k0n) {
  constexpr int NT1 = (P::N1 + TN - 1) / TN;
  const int M = m0n * P::M1;
  const int mt = (M + TM - 1) / TM;
  const int tiles = mt * n0n * NT1;
  const int tasks = KS == 1 ? tiles : (tiles * KS + 31) & ~31;
  for (int t = threadIdx.x; t < tasks; t += NT) {
    const int ks = t % KS;
    int r = t / KS;
    const bool live = r < tiles;
    if (!live) r = 0;
    const int tj = r % NT1;
    r /= NT1;
    const int j0 = r % n0n;
    const int ti = r / n0n;
    int ao[TM], co[TM], bo[TN], cc[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int i = ti * TM + u;
      const int ic = i < M ? i : M - 1;
      const int i0 = ic / P::M1, i1 = ic - i0 * P::M1;
      ao[u] = i0 * P::AM0 + i1 * P::AM1;
      co[u] = i < M ? i0 * P::CM0 + i1 * P::CM1 : -1;
    }
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int j = tj * TN + v;
      const int jc = j < P::N1 ? j : P::N1 - 1;
      bo[v] = j0 * P::BN0 + jc * P::BN1;
      cc[v] = j < P::N1 ? j0 * P::CN0 + j * P::CN1 : -1;
    }
    const int lo = P::lo(j0), hi = imin(P::hi(j0), k0n);
    T c[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) c[u][v] = T(0);
    // this lane's sums k1 = ks + KS * kk: NK steps of a constant count
    // (unrolled, so that each load's offset is an immediate), and one more
    // where KS does not divide K1
    static_assert(KS <= P::K1, "a lane's share of the sums is empty");
    constexpr int NK = P::K1 / KS, NR = P::K1 - NK * KS;
    const auto step = [&](const T* a, const T* b, int k1) {
      T av[TM], bv[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = a[ao[u] + k1 * P::AK1];
#pragma unroll
      for (int v = 0; v < TN; ++v) bv[v] = b[bo[v] + k1 * P::BK1];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) c[u][v] += av[u] * bv[v];
    };
    for (int k0 = lo; k0 < hi; ++k0) {
      const T* a = A + k0 * P::AK0 + ks * P::AK1;
      const T* b = B + k0 * P::BK0 + ks * P::BK1;
#pragma unroll (NK <= 40 ? NK : 8)
      for (int kk = 0; kk < NK; ++kk) step(a, b, kk * KS);
      if (NR > 0 && ks < NR) step(a, b, NK * KS);
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
      for (int v = 0; v < TN; ++v)
        if (co[u] >= 0 && cc[v] >= 0) {
          T* d = C + co[u] + cc[v];
          *d = ACC ? *d + c[u][v] : c[u][v];
        }
  }
}

// D (8 x 8) += A (8 x 4, row) B (4 x 8, col) in fp64 on the tensor cores:
// lane l holds A[l/4][l%4], B[l%4][l/4] and D[l/4][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The product P (f64) by the whole block on the tensor cores: each warp a
// tile of 8 WM rows x 8 WN columns of one column block j0, the sums taken
// four at a time in the order (k0, k1), zero past their end.
template <class P, int WM, int WN, bool ACC>
__device__ __forceinline__ void gemm_dmma(const double* __restrict__ A,
                                          const double* __restrict__ B,
                                          double* __restrict__ C, int m0n,
                                          int n0n, int k0n) {
  constexpr int NT1 = (P::N1 + 8 * WN - 1) / (8 * WN);
  const int M = m0n * P::M1;
  const int mt = (M + 8 * WM - 1) / (8 * WM);
  const int tiles = mt * n0n * NT1;
  const int lane = threadIdx.x & 31, g = lane >> 2, kq = lane & 3;
  for (int t = threadIdx.x >> 5; t < tiles; t += NWARP) {
    int r = t;
    const int tj = r % NT1;
    r /= NT1;
    const int j0 = r % n0n;
    const int ti = r / n0n;
    int ao[WM], bo[WN];
#pragma unroll
    for (int w = 0; w < WM; ++w) {
      const int i = imin(ti * 8 * WM + w * 8 + g, M - 1);
      const int i0 = i / P::M1, i1 = i - i0 * P::M1;
      ao[w] = i0 * P::AM0 + i1 * P::AM1;
    }
#pragma unroll
    for (int w = 0; w < WN; ++w) {
      const int j = imin(tj * 8 * WN + w * 8 + g, P::N1 - 1);
      bo[w] = j0 * P::BN0 + j * P::BN1;
    }
    const int lo = P::lo(j0), hi = imin(P::hi(j0), k0n);
    const int nk = hi > lo ? (hi - lo) * P::K1 : 0;
    double d[WM][WN][2];
#pragma unroll
    for (int u = 0; u < WM; ++u)
#pragma unroll
      for (int v = 0; v < WN; ++v) d[u][v][0] = d[u][v][1] = 0.0;
    for (int kb = 0; kb < nk; kb += 4) {
      const int k = kb + kq;
      const bool in = k < nk;
      const int kk = in ? k : 0;
      const int q0 = kk / P::K1;
      const int k0 = lo + q0, k1 = kk - q0 * P::K1;
      const int oa = k0 * P::AK0 + k1 * P::AK1;
      const int ob = k0 * P::BK0 + k1 * P::BK1;
      double av[WM], bv[WN];
#pragma unroll
      for (int u = 0; u < WM; ++u) av[u] = in ? A[ao[u] + oa] : 0.0;
#pragma unroll
      for (int v = 0; v < WN; ++v) bv[v] = in ? B[bo[v] + ob] : 0.0;
#pragma unroll
      for (int u = 0; u < WM; ++u)
#pragma unroll
        for (int v = 0; v < WN; ++v) dmma(d[u][v], av[u], bv[v]);
    }
#pragma unroll
    for (int u = 0; u < WM; ++u) {
      const int i = ti * 8 * WM + u * 8 + g;
      if (i >= M) continue;
      const int i0 = i / P::M1, i1 = i - i0 * P::M1;
      double* cr = C + i0 * P::CM0 + i1 * P::CM1 + j0 * P::CN0;
#pragma unroll
      for (int v = 0; v < WN; ++v)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = tj * 8 * WN + v * 8 + 2 * kq + h;
          if (j < P::N1) {
            double* dd = cr + j * P::CN1;
            *dd = ACC ? *dd + d[u][v][h] : d[u][v][h];
          }
        }
    }
  }
}

// The product P on the FP32 FMAs (TM x TN tiles, KS lanes a tile) in f32,
// on the tensor cores (TM x TN warp tiles of 8 x 8) in f64.
template <class P, int TM, int TN, int KS, bool ACC>
__device__ __forceinline__ void gemm(const T* A, const T* B, T* Cp, int m0n,
                                     int n0n, int k0n) {
  if constexpr (F64)
    gemm_dmma<P, TM, TN, ACC>((const double*)A, (const double*)B,
                              (double*)Cp, m0n, n0n, k0n);
  else
    gemm_fma<P, TM, TN, KS, ACC>(A, B, Cp, m0n, n0n, k0n);
}

// product I's tiles are the macros WD_P<I>_TM, WD_P<I>_TN and WD_P<I>_KS
#define GEMM(I, P, ACC, A, B, Cp, m0n, n0n, k0n)                             \
  gemm<P, WD_P##I##_TM, WD_P##I##_TN, WD_P##I##_KS, ACC>(A, B, Cp, m0n, n0n, \
                                                          k0n)

// This block's max-abs partial (m, bad) folded over its warps into *bm and
// *bb (thread 0 writes them); every thread calls it.
__device__ __forceinline__ void block_max(double m, int bad, double* bm,
                                          int* bb) {
  __shared__ double wm[NWARP];
  __shared__ int wb[NWARP];
  for (int o = 16; o > 0; o >>= 1) {
    m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
  }
  if ((threadIdx.x & 31) == 0) {
    wm[threadIdx.x >> 5] = m;
    wb[threadIdx.x >> 5] = bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NWARP; ++w) {
      m = fmax(m, wm[w]);
      bad |= wb[w];
    }
    *bm = fmax(m, wm[0]);
    *bb = bad | wb[0];
  }
}

// The cluster-wide scale from every block's partial (bm, bb): the max-abs,
// or 1 where it is zero or not finite (_safe_scale).
__device__ __forceinline__ T cluster_scale(cg::cluster_group& cl, double* bm,
                                           int* bb) {
  double m = 0.0;
  int bad = 0;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    m = fmax(m, *cl.map_shared_rank(bm, r));
    bad |= *cl.map_shared_rank(bb, r);
  }
  return (bad || !(m > 0.0)) ? T(1) : T(m);
}

__device__ __forceinline__ void track(double& m, int& bad, T v) {
  const double w = (double)v;
  if (!isfinite(w)) bad = 1; else m = fmax(m, fabs(w));
}

#if WD_KIND == 0
// ---------------------------------------------------------------------------
// merge W: W_t[k,m,a] = sum_{n,u,x} L_t[k,n,u,x] sum_{v,b} Th_t[a,b,u,v,x]
//                       sum_j B_t[m,j,v,x] W_{t+1}[n,j,b]
// block `rank` owns the rows m in [rank*MR, rank*MR + mr); per x:
//   t1[m,v,n,b] = sum_j B_t[m,j,v] W_{t+1}[n,j,b]              (P0)
//   u[m,n,u,a]  = sum_{v,b} t1[m,v,n,b] Th_t[a,b,u,v]           (P1)
//   W_t[k,m,a] (+)= sum_{n,u} L_t[k,n,u] u[m,n,u,a]            (P2)
// then the cluster-wide rescale, W_t's slice to Ws, and every block's slice
// into W_{t+1} of each block (distributed shared memory).
// ---------------------------------------------------------------------------
constexpr int MR = (DB + C - 1) / C;
constexpr int nWf = pad16(DL * DB * sr), nWa = pad16(DL * MR * sr);
constexpr int nL = pad16(DL * DL * Y), nBx = pad16(MR * DB * Y);
constexpr int nTh = pad16(BAND ? Y * sr * sr : Y * Y * sr * sr);
constexpr int nT1 = pad16(MR * Y * DL * sr), nU = pad16(MR * DL * Y * sr);

typedef Prod<MR, Y, DB * Y, 1, Y * DL * sr, DL * sr,         // rows (m, v)
             DL, sr, DB * sr, 1, sr, 1,                        // cols (n, b)
             1, DB, 0, Y, 0, sr, 0> PW0;                       // sums j
typedef Prod<MR, DL, Y * DL * sr, sr, DL * Y * sr, Y * sr,   // rows (m, n)
             Y, sr, BAND ? sr * sr : Y * sr * sr, 1, sr, 1,    // cols (u, a)
             Y, sr, DL * sr, 1, sr * sr, sr, BAND ? 1 : 0> PW1;  // (v, b)
typedef Prod<DL, 1, DL * Y, 0, MR * sr, 0,                   // rows k
             MR, sr, DL * Y * sr, 1, sr, 1,                    // cols (m, a)
             1, DL * Y, 0, 1, 0, sr, 0> PW2;                   // sums (n, u)

__global__ void __launch_bounds__(NT, 1)
merge_w_wide_kernel(const T* __restrict__ L, Str6 sL,
                    const T* __restrict__ Bm, Str6 sB,
                    const T* __restrict__ Th, T* __restrict__ Ws, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double blk_m[2];
  __shared__ int blk_b[2];
  T* Wf = reinterpret_cast<T*>(smem_raw);
  T* Wa = Wf + nWf;                     // [2][k][MR][a]
  T* Lx = Wa + 2 * nWa;                 // [k][n][u]
  T* Bx = Lx + nL;                      // [m][j][v], own rows
  T* Tx = Bx + nBx;                     // psi [w][b][a] or [u][v][b][a]
  T* t1 = Tx + nTh;
  T* ub = t1 + nT1;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const i64 z = blockIdx.x / C;
  const int m0 = rank * MR, mr = imin(MR, DB - m0);
  const int tid = threadIdx.x;
  constexpr int nW = DL * DB * sr;
  constexpr i64 nThs = (i64)sr * sr * Y * Y * q;
  const T* peer[C];
#pragma unroll
  for (int r = 0; r < C; ++r) peer[r] = cl.map_shared_rank(Wa, r);
  for (int i = tid; i < nW; i += NT) Wf[i] = i == 0 ? T(1) : T(0);
  for (int s = S - 1; s >= 0; --s) {
    const int p = s & 1;
    T* Wacc = Wa + p * nWa;
    for (int x = 0; x < q; ++x) {
      const T* Lt = L + z * sL.s[0] + s * sL.s[1] + x * sL.s[5];
      const T* Bt = Bm + z * sB.s[0] + s * sB.s[1] + x * sB.s[5];
      const T* th = Th + s * nThs + x;
      for (int i = tid; i < DL * DL * Y; i += NT) {
        const int u = i % Y, r = i / Y, n = r % DL, k = r / DL;
        __pipeline_memcpy_async(
            Lx + i, Lt + k * sL.s[2] + n * sL.s[3] + u * sL.s[4], sizeof(T));
      }
      for (int i = tid; i < mr * DB * Y; i += NT) {
        const int v = i % Y, r = i / Y, j = r % DB, m = r / DB;
        __pipeline_memcpy_async(
            Bx + i, Bt + (m0 + m) * sB.s[2] + j * sB.s[3] + v * sB.s[4],
            sizeof(T));
      }
      if (BAND) {
        // psi[w][b][a] = Th_t[a,b,u,v] at one pair u + v - OFF = w
        for (int i = tid; i < Y * sr * sr; i += NT) {
          const int a = i % sr, r = i / sr, b = r % sr, w = r / sr;
          const int uw = imax(0, w + OFF - (Y - 1)), vw = w + OFF - uw;
          if (uw < Y && vw >= 0 && vw < Y)
            __pipeline_memcpy_async(
                Tx + i, th + (((a * sr + b) * Y + uw) * Y + vw) * (i64)q,
                sizeof(T));
          else
            Tx[i] = T(0);
        }
      } else {
        // Th_t as [u][v][b][a]
        for (int i = tid; i < Y * Y * sr * sr; i += NT) {
          const int a = i % sr, r1 = i / sr, b = r1 % sr, r2 = r1 / sr,
                    v = r2 % Y, u = r2 / Y;
          __pipeline_memcpy_async(
              Tx + i, th + (((a * sr + b) * Y + u) * Y + v) * (i64)q,
              sizeof(T));
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      GEMM(0, PW0, false, Bx, Wf, t1, mr, DL, 1);
      __syncthreads();
      GEMM(1, PW1, false, t1, BAND ? Tx - OFF * sr * sr : Tx, ub, mr, Y, Y);
      __syncthreads();
      if (x == 0)
        GEMM(2, PW2, false, Lx, ub, Wacc, DL, mr, 1);
      else
        GEMM(2, PW2, true, Lx, ub, Wacc, DL, mr, 1);
      __syncthreads();
    }
    double mx = 0.0;
    int bad = 0;
    for (int i = tid; i < DL * mr * sr; i += NT) {
      const int a = i % sr, r = i / sr, m = r % mr, k = r / mr;
      track(mx, bad, Wacc[(k * MR + m) * sr + a]);
    }
    block_max(mx, bad, blk_m + p, blk_b + p);
    cluster_sync();                       // every slice and partial is done
    const T sc = cluster_scale(cl, blk_m + p, blk_b + p);
    T* Wo = Ws + (z * S + s) * (i64)nW;
    for (int i = tid; i < nW; i += NT) {  // W_t[k][m][a]
      const int a = i % sr, r = i / sr, m = r % DB, k = r / DB;
      const int rr = m / MR, ml = m - rr * MR;
      const T v = peer[rr][p * nWa + (k * MR + ml) * sr + a] / sc;
      Wf[i] = v;
      if (rr == rank) Wo[i] = v;
    }
    __syncthreads();
  }
  cluster_sync();            // the peers may still read this block's slices
}

#else
// ---------------------------------------------------------------------------
// merge F: step s (time t = s+1); block `rank` owns the rows e in
// [rank*EL, rank*EL + el) of S, M, t1, t2 and N:
//   M[e,a]        = sum_{k,m} S[e,k,m] W_t[k,m,a]                  (P0)
// per x:
//   t1[e,m,n,u]   = sum_k S[e,k,m] L_t[k,n,u]                      (P1)
//   t2[e,y,n,j]   = sum_{u,m} t1[e,m,n,u] Bp[m,u,j,y]              (P2)
//     Bp[m,u,j,y] = sum_v Pyy[y,u,v] B_t[m,j,v], or B_t[m,j,y+OFF-u]
//     along the band
//   N[e,y,x,b]    = sum_{n,j} t2[e,y,n,j] W_{t+1}[n,j,b]           (P3)
//   S2[f,n,j]   (+)= sum_{e,y} Phi_t[e,f,y] t2[e,y,n,j]            (P4)
// then S2's rows f of this block summed over the cluster's partials, the
// cluster-wide rescale, S <- S2 / scale; M of the next step is S . W_{t+1}
// (W_{t+1} is the next step's W_t).  W_{T1} is the one-hot; step 0 reads
// S_init in place.  Pyy is step s's table at Pyy + s * pyy_step (0: one
// table); banded builds do not read it.
// ---------------------------------------------------------------------------
constexpr int EL = (sl + C - 1) / C;
constexpr int nS = pad16(EL * DLB), nS2 = pad16(sl * DLB);
constexpr int nWb = pad16(DLB * sr), nL = pad16(DL * DL * Y);
constexpr int nB = pad16(DB * DB * Y), nPh = pad16(EL * sl * Y);
constexpr int nT1 = pad16(EL * DB * DL * Y), nT2 = pad16(EL * Y * DLB);

typedef Prod<EL, 1, DLB, 0, sr, 0,                            // rows e
             1, sr, 0, 1, 0, 1,                                 // cols a
             1, DLB, 0, 1, 0, sr, 0> PF0;                       // (k, m)
typedef Prod<EL, DB, DLB, 1, DB * DL * Y, DL * Y,            // rows (e, m)
             1, DL * Y, 0, 1, 0, 1,                             // cols (n, u)
             1, DL, 0, DB, 0, DL * Y, 0> PF1;                   // sums k
typedef Prod<EL, DL, DB * DL * Y, Y, Y * DLB, DB,            // rows (e, n)
             Y, DB, BAND ? 1 : DB, BAND ? Y : 1, DLB, 1,        // cols (y, j)
             Y, DB, 1, DL * Y, BAND ? -1 : DB * Y * DB,         // sums (u, m)
             BAND ? DB * Y : Y * DB, BAND ? 2 : 0> PF2;
typedef Prod<EL, Y, Y * DLB, DLB, Y * q * sr, q * sr,        // rows (e, y)
             1, sr, 0, 1, 0, 1,                                 // cols b
             1, DLB, 0, 1, 0, sr, 0> PF3;                       // (n, j)
typedef Prod<sl, 1, Y, 0, DLB, 0,                             // rows f
             1, DLB, 0, 1, 0, 1,                                // cols (n, j)
             EL, Y, sl * Y, 1, Y * DLB, DLB, 0> PF4;            // sums (e, y)

__global__ void __launch_bounds__(NT, 1)
merge_f_wide_kernel(const T* __restrict__ L, Str6 sL,
                    const T* __restrict__ Bm, Str6 sB,
                    const T* __restrict__ Pyy, i64 pyy_step,
                    const T* __restrict__ Phi, const T* __restrict__ Ws,
                    const T* __restrict__ Sinit, T* __restrict__ Ns,
                    T* __restrict__ Ms, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double blk_m;
  __shared__ int blk_b;
  T* Sb = reinterpret_cast<T*>(smem_raw);   // [e][k][m], own rows
  T* S2 = Sb + nS;                          // [f][n][j], every row f
  T* Wb = S2 + nS2;                         // [n][j][b]
  T* Lx = Wb + nWb;                         // [k][n][u]
  T* Bx = Lx + nL;                          // [m][j][v]
  T* Ph = Bx + nB;                          // [e][f][y], own rows e
  T* t1 = Ph + nPh;
  T* t2 = t1 + nT1;
  T* Bp = t2 + nT2;                         // [u][m][y][j] (dense)
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const i64 z = blockIdx.x / C;
  const int e0 = rank * EL, el = imin(EL, sl - e0);
  const int tid = threadIdx.x;
  constexpr i64 nW = (i64)DLB * sr, nN = (i64)sl * Y * q * sr,
                nM = (i64)sl * sr, nF = (i64)sl * sl * Y * q;
  const T* peer[C];
#pragma unroll
  for (int r = 0; r < C; ++r) peer[r] = cl.map_shared_rank(S2, r);
  for (int i = tid; i < EL * DLB; i += NT)   // rows past el stay 0
    Sb[i] = i < el * DLB ? Sinit[(z * sl + e0) * DLB + i] : T(0);
  for (int i = tid; i < nPh; i += NT) Ph[i] = T(0);
  async_copy(Wb, Ws + z * S * nW, (int)nW);                    // W_1
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  GEMM(0, PF0, false, Sb, Wb, Ms + z * S * nM + e0 * sr, el, 1, 1);
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const i64 row = z * S + s;
    const T* Py = Pyy + s * pyy_step;
    for (int x = 0; x < q; ++x) {
      const T* Lt = L + z * sL.s[0] + s * sL.s[1] + x * sL.s[5];
      const T* Bt = Bm + z * sB.s[0] + s * sB.s[1] + x * sB.s[5];
      if (x == 0) {                                            // W_{t+1}
        if (s + 1 < S)
          async_copy(Wb, Ws + (row + 1) * nW, (int)nW);
        else
          for (int i = tid; i < nW; i += NT) Wb[i] = i == 0 ? T(1) : T(0);
      }
      for (int i = tid; i < DL * DL * Y; i += NT) {
        const int u = i % Y, r = i / Y, n = r % DL, k = r / DL;
        __pipeline_memcpy_async(
            Lx + i, Lt + k * sL.s[2] + n * sL.s[3] + u * sL.s[4], sizeof(T));
      }
      for (int i = tid; i < DB * DB * Y; i += NT) {
        const int v = i % Y, r = i / Y, j = r % DB, m = r / DB;
        __pipeline_memcpy_async(
            Bx + i, Bt + m * sB.s[2] + j * sB.s[3] + v * sB.s[4], sizeof(T));
      }
      const T* ph = Phi + s * nF + x;
      for (int i = tid; i < el * sl * Y; i += NT) {
        const int r = i / Y, y = i - r * Y, f = r % sl, e = r / sl;
        __pipeline_memcpy_async(
            Ph + i, ph + (((i64)(e0 + e) * sl + f) * Y + y) * q, sizeof(T));
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (!BAND) {
        for (int i = tid; i < Y * DB * Y * DB; i += NT) {
          const int j = i % DB, r1 = i / DB, y = r1 % Y, r2 = r1 / Y,
                    m = r2 % DB, u = r2 / DB;
          const T* py = Py + ((i64)(y * Y + u) * Y) * q + x;
          const T* bx = Bx + (m * DB + j) * Y;
          T acc = T(0);
#pragma unroll 4
          for (int v = 0; v < Y; ++v) acc += py[v * q] * bx[v];
          Bp[i] = acc;
        }
      }
      GEMM(1, PF1, false, Sb, Lx, t1, el, 1, 1);
      __syncthreads();
      GEMM(2, PF2, false, t1, BAND ? Bx + OFF : Bp, t2, el, Y, Y);
      __syncthreads();
      GEMM(3, PF3, false, t2, Wb, Ns + row * nN + e0 * Y * q * sr + x * sr,
           el, 1, 1);
      if (x == 0)
        GEMM(4, PF4, false, Ph, t2, S2, sl, 1, el);
      else
        GEMM(4, PF4, true, Ph, t2, S2, sl, 1, el);
      __syncthreads();
    }
    cluster_sync();                    // every block's S2 partials are done
    double mx = 0.0;
    int bad = 0;
    for (int i = tid; i < el * DLB; i += NT) {
      const int o = e0 * DLB + i;
      T v = peer[0][o];
#pragma unroll
      for (int r = 1; r < C; ++r) v += peer[r][o];
      Sb[i] = v;
      track(mx, bad, v);
    }
    block_max(mx, bad, &blk_m, &blk_b);
    cluster_sync();        // every partial max is in; S2 is read everywhere
    const T sc = cluster_scale(cl, &blk_m, &blk_b);
    for (int i = tid; i < el * DLB; i += NT) Sb[i] = Sb[i] / sc;
    __syncthreads();
    if (s + 1 < S)
      GEMM(0, PF0, false, Sb, Wb, Ms + (row + 1) * nM + e0 * sr, el, 1, 1);
    __syncthreads();
  }
  cluster_sync();            // the peers may still read this block's maxes
}
#endif

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
#if WD_KIND == 0
#define WD_KERNEL merge_w_wide_kernel
#else
#define WD_KERNEL merge_f_wide_kernel
#endif

// A launch of `blocks` blocks in clusters of C, `smem` bytes of dynamic
// shared memory a block; attr holds the cluster attribute.
static cudaLaunchConfig_t wide_config(int blocks, long long smem,
                                      cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static int wide_prepare(long long smem) {
  int threads = NT;
  const int e = prepare(WD_KERNEL, (size_t)smem, &threads);
  if (e) return e;
  return threads == NT ? 0 : (int)cudaErrorInvalidConfiguration;
}

// The most clusters of this build's kernel that can be resident at once
// with `smem` bytes of dynamic shared memory a block (0: the cluster cannot
// be scheduled), or minus a CUDA error code.
extern "C" int merge_wide_occupancy(long long smem) {
  const int e = wide_prepare(smem);
  if (e) return -e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(C, smem, 0, &attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, WD_KERNEL, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n;
}

// The launchers: a grid of C x Bn blocks in clusters of C.  Each returns
// cudaGetLastError() (or the error of the set-up calls) as an int, and
// cudaErrorInvalidValue for a shape other than this library's.
#if WD_KIND == 0
extern "C" int merge_w_wide(const void* L, const i64* sL, const void* B,
                            const i64* sB, const void* Th, void* Ws, int Bn,
                            int S, int DL_, int DB_, int Y_, int q_, int sr_,
                            long long smem, void* stream) {
  if (DL_ != DL || DB_ != DB || Y_ != Y || q_ != q || sr_ != sr)
    return (int)cudaErrorInvalidValue;
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  const int e = wide_prepare(smem);
  if (e) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wide_config(C * Bn, smem, (cudaStream_t)stream, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, merge_w_wide_kernel, (const T*)L, a,
                         (const T*)B, b, (const T*)Th, (T*)Ws, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#else
extern "C" int merge_f_wide(const void* L, const i64* sL, const void* B,
                            const i64* sB, const void* Pyy,
                            long long pyy_step, const void* Phi,
                            const void* Ws, const void* Sinit, void* Ns,
                            void* Ms, int Bn, int S, int DL_, int DB_, int Y_,
                            int q_, int sr_, int sl_, long long smem,
                            void* stream) {
  if (DL_ != DL || DB_ != DB || Y_ != Y || q_ != q || sr_ != sr ||
      sl_ != sl)
    return (int)cudaErrorInvalidValue;
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  const int e = wide_prepare(smem);
  if (e) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wide_config(C * Bn, smem, (cudaStream_t)stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, merge_f_wide_kernel, (const T*)L, a, (const T*)B, b,
      (const T*)Pyy, (i64)pyy_step, (const T*)Phi, (const T*)Ws,
      (const T*)Sinit, (T*)Ns, (T*)Ms, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif
