// Batched thin QR by Cholesky-QR, staged, for Hopper (sm_90a): the
// function of cholqr.cu's cholqr_kernel for float32 A whose buffers fit,
// compiled once per shape.
//
// Replaces, as cholqr_kernel does, the Pallas TPU kernel
// matrixproductbp_tpu/ops/kernels.py::_cholqr_kernel (kernels.py:61;
// batched entry batched_cholqr :104, pallas_call :120).  Its plain version
// is matrixproductbp_tpu_torch/ops/smallalg.py::cholqr_unrolled; the wrapper
// (ops/kernels.py::batched_cholqr) picks it where
// ops/kernels.py::cholqr_geometry finds a float32 A [m, n] with n <= 40
// (the randomized merge's [4s, s], s = 2D: [80, 20] at D=10, [160, 40] at
// D=20).
//
// For every instance A [m, n], in float64 whatever the storage:
//   G = A^T A + eps * max(tr G, 1e-30) / n * I,  L = chol(G),
//   Q = A L^{-T},  R = L^T,
// with the pivot floor sqrt(max(d, 1e-30)) of kernels.py:68-95 (L_jj >=
// 1e-15, so the divisor floor max(L_jj, 1e-30) never binds).  The caller
// passes the float32 jitter (1e-6): see cholqr.cu for why float32 inputs
// are factored in float64.
//
// What bounds it.  Per instance it reads A once and writes Q and R once
// (57.6 KB at [160, 40]) and does ~m n^2 + n^3/3 float64 FMAs (~270,000 at
// [160, 40]): by bytes, 0.141 ms for [8192, 160, 40] at 3.35 TB/s.
// cholqr_kernel ran at 12.5x that: one block an instance with A staged as
// float64 (three blocks an SM at [160, 40]), a Gram of one 160-long FMA
// chain a thread, two block barriers a Cholesky column, a forward
// substitution of n(n-1)/2 dependent FMAs a row, and run-time sizes.  This
// design:
//   - the sizes are compile-time constants (one build per shape), so every
//     loop unrolls and no index is divided by a run-time n;
//   - A is staged once by cp.async at its storage width (float32; 28 KB at
//     [160, 40] against 51 KB as float64) and converted to float64 in
//     registers;
//   - both products run on the float64 tensor cores (DMMA,
//     mma.m16n8k8.f64; m8n8k4 runs at half its rate on the H100): the
//     Gram's 16x8 tiles on and above the diagonal with its K = m sum split
//     over the instance's warps (two partial Grams, summed where the
//     Cholesky loads them), and Q = A L^{-T} as A times the explicit
//     inverse, skipping L^{-1}'s zero tiles;
//   - the factorisation is right-looking, with one group barrier a column:
//     thread i of the first half keeps row i of G in registers, writes its
//     entry of the pivot column (unscaled) to shared memory (the pivot's
//     row also its 1/sqrt, once), and after the barrier every row updates
//     itself from that column (n independent FMAs a step, no dependent
//     chain of n^2/2).  The second half computes
//     L^{-1} in the same loop, one step behind, by forward substitution:
//     thread k keeps column k of L^{-1} in registers, reads the column of L
//     the first half wrote a step before, and stores each entry as soon as
//     it is final;
//   - several instances share a block where an instance takes 64 threads
//     (n <= 32), each group with a named barrier of its own.
// The inverse route changes the arithmetic's order against cholqr_unrolled
// (the error is ~kappa(L) x 1e-16 in float64; kappa(L) <= ~sqrt(n / eps));
// tests/test_torch_cholqr_geometry.py holds the same order, written in
// plain torch, to cholqr_unrolled and to the JAX kernel.
//
// An instance (NTI = 2 x 32 x ceil(n/32) threads, NW warps):
//   cp.async A -> As (float32, rows padded to LDA, pads zeroed)   | barrier
//   Gram partials by warps (DMMA), summed into Gs and Xs      | NW/2 barriers
//   rows of G to registers, partial traces                        | barrier
//   n + 1 steps: column j of L to Gs (first half)                 | barrier
//                update rows (first half), step j-1 of L^{-1} (second half,
//                its row j-1 to Xs)
//                                                                 | barrier
//   R from Gs; Q = A L^{-1}^T (DMMA) stored from the accumulators
//
// Built once per shape: the sizes CQ_M and CQ_N, the instances a block
// CQ_IPB, the blocks an SM should hold CQ_MINB (the register budget
// __launch_bounds__ gives ptxas) and Q's row tiles a pass CQ_QR are macros,
// which ops/kernels.py::cholqr_staged_macros computes and ops/build.py
// passes to nvcc at the shape's first use.
//
// Shared memory per instance (ops/kernels.py::_smem_cholqr_staged computes
// the same sum), with n8 = n rounded up to 8 and mp = m to 16: Gs [n][LDG]
// and Xs [n8][LDX] float64 (the two partial Grams; then L^T, unscaled, and
// L^{-1}), the pivots' 1/sqrt [n8] and two partial traces, As [mp][LDA]
// float32.  LDA is 4 mod 8 (the Gram's fragments read 4 rows 2 apart, Q's
// 8 rows 1 apart: neither has a bank conflict), LDG 8 mod 16 (the Gram's
// 16-byte fragment stores) and LDX 4 mod 8 (Q's fragment loads of
// L^{-1}).  [160, 40]: 55,376 bytes, three blocks of 128 threads an SM
// (the registers: 168 a thread); [80, 20]: 18,384 bytes, two instances a
// block, five blocks an SM.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#if !defined(CQ_M) || !defined(CQ_N) || !defined(CQ_IPB) || \
    !defined(CQ_MINB) || !defined(CQ_QR)
#error "cholqr_staged.cu is built per shape: define CQ_M, CQ_N, CQ_IPB, CQ_MINB and CQ_QR"
#endif

typedef long long i64;

namespace {

constexpr int M = CQ_M, N = CQ_N, IPB = CQ_IPB, QR = CQ_QR;
constexpr double kFloor = 1e-30;
constexpr int N8 = (N + 7) / 8 * 8, NJ = N8 / 8;   // column tiles of 8
constexpr int MP = (M + 15) / 16 * 16;             // rows, padded to 16
constexpr int MB8 = MP / 8, MB16 = MP / 16;        // row blocks of 8, 16
constexpr int NP = (NJ + 1) / 2;                   // the Gram's 16-row tiles
constexpr int HALF = 32 * ((N + 31) / 32);         // threads a role
constexpr int NTI = 2 * HALF, NW = NTI / 32;       // an instance's threads
constexpr int NT = IPB * NTI;
constexpr int stride(int least, int mod, int rem) {
  return least + ((rem - least) % mod + mod) % mod;
}
constexpr int LDA = stride(N8, 8, 4), LDG = stride(N8, 16, 8);
constexpr int LDX = stride(N8, 8, 4);
constexpr int nG = N * LDG, nX = N8 * LDX, nA = MP * LDA;
constexpr int SMEM_INST = 8 * (nG + nX + N8 + 2) + 4 * nA;
constexpr int NTILE = NP * NJ - NP * (NP - 1);     // tiles (P, J >= 2P)
constexpr int TPW = (MB16 + NW - 1) / NW;          // Q's row tiles a warp
constexpr int NPASS = (TPW + QR - 1) / QR;
static_assert(N >= 1 && N <= 64 && M >= 1, "1 <= n <= 64, m >= 1");
static_assert(NW % 2 == 0, "the Gram partials are summed by pairs of warps");
static_assert((nG + nX + N8) % 2 == 0 && SMEM_INST % 16 == 0,
              "16-byte buffers");

// D (16x8) += A (16x8, row) B (8x8, col) on the float64 tensor cores
// (m16n8k8: twice the rate of m8n8k4 on the H100).  With g = lane / 4 and
// t = lane % 4, a lane holds A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4],
// B[t][g], B[t+4][g], and D[g][2t + {0, 1}], D[g+8][2t + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// A lane's two entries of a row of Q (columns col and col + 1; the second
// only where it is < n, which n even always has: one 8-byte store).
__device__ __forceinline__ void store_q(float* dst, double x, double y,
                                        bool second) {
  if (N % 2 == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2((float)x, (float)y);
  } else {
    dst[0] = (float)x;
    if (second) dst[1] = (float)y;
  }
}

// The instance's barrier: the block's where it holds one instance, else a
// named barrier of the group's NTI threads.  (Immediate barrier ids: with a
// register id ptxas reserves all 16.)
__device__ __forceinline__ void group_sync(int g) {
  static_assert(IPB <= 2, "two groups a block at most");
  if (IPB == 1)
    __syncthreads();
  else if (g == 0)
    asm volatile("bar.sync 1, %0;" ::"n"(NTI) : "memory");
  else
    asm volatile("bar.sync 2, %0;" ::"n"(NTI) : "memory");
}

}  // namespace

__global__ void __launch_bounds__(NT, CQ_MINB)
cholqr_staged_kernel(const float* __restrict__ A, float* __restrict__ Q,
                     float* __restrict__ R, int Bn, double eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = threadIdx.x / NTI, t = threadIdx.x % NTI;
  const i64 inst = (i64)blockIdx.x * IPB + g;
  if (inst >= Bn) return;                  // a ragged last block's group
  double* Gs = reinterpret_cast<double*>(smem_raw + g * SMEM_INST);
  double* Xs = Gs + nG;
  double* rdg = Xs + nX;                   // 1 / sqrt(pivot), a column each
  double* trp = rdg + N8;
  float* As = reinterpret_cast<float*>(trp + 2);
  const int lane = t & 31, w = t >> 5;
  const int lr = lane >> 2, lc = lane & 3;

  // ---- A to shared memory, at its storage width --------------------------
  {
    constexpr int VW = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
    constexpr int CPR = N / VW;            // copies a row
    const float* a = A + inst * (i64)(M * N);
    for (int c = t; c < M * CPR; c += NTI) {
      const int r = c / CPR, col = (c % CPR) * VW;
      __pipeline_memcpy_async(As + r * LDA + col, a + r * N + col, VW * 4);
    }
    __pipeline_commit();
    constexpr int PADC = LDA - N;          // columns N.. of rows < M
    for (int e = t; e < M * PADC; e += NTI)
      As[(e / PADC) * LDA + N + e % PADC] = 0.f;
    for (int e = t; e < (MP - M) * LDA; e += NTI) As[M * LDA + e] = 0.f;
    __pipeline_wait_prior(0);
  }
  group_sync(g);

  // ---- Gram: 16x8 tiles (P, J), J >= 2P (the upper 8x8 tiles and a few
  // below), K = m split over the warps by blocks of 8 rows.  A lane's
  // fragment of column tile T: f0[T] = A[r + 2 lc][8T + lr] (the k-step's
  // rows t), f1[T] = A[r + 2 lc + 1][8T + lr] (rows t + 4): 4 rows 2 apart
  // a load, with LDA 4 mod 8 32 banks.  Column tile NJ (past N8) is zero.
  {
    double acc[NTILE][4];
#pragma unroll
    for (int p = 0; p < NTILE; ++p)
      acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0;
    for (int rb = w; rb < MB8; rb += NW) {
      const float* r0 = As + (rb * 8 + 2 * lc) * LDA + lr;
      double f0[NJ + 1], f1[NJ + 1];
#pragma unroll
      for (int T = 0; T <= NJ; ++T) {
        f0[T] = T < NJ ? (double)r0[T * 8] : 0.0;
        f1[T] = T < NJ ? (double)r0[LDA + T * 8] : 0.0;
      }
      int p = 0;
#pragma unroll
      for (int P = 0; P < NP; ++P)
#pragma unroll
        for (int J = 2 * P; J < NJ; ++J, ++p)
          dmma(acc[p], f0[2 * P], f0[2 * P + 1], f1[2 * P], f1[2 * P + 1],
               f0[J], f1[J]);
    }
    // warps 2r and 2r+1 store (r = 0) or add (r > 0) into Gs and Xs
    // (rows < N only: the Cholesky reads nothing below)
#pragma unroll
    for (int rnd = 0; rnd < NW / 2; ++rnd) {
      if (w / 2 == rnd) {
        double* Pb = (w & 1) ? Xs : Gs;
        const int ld = (w & 1) ? LDX : LDG;
        int p = 0;
#pragma unroll
        for (int P = 0; P < NP; ++P)
#pragma unroll
          for (int J = 2 * P; J < NJ; ++J, ++p)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * P + 8 * h + lr;
              if (r < N) {
                double2* d = reinterpret_cast<double2*>(Pb + r * ld + J * 8 +
                                                        2 * lc);
                double2 v = make_double2(acc[p][2 * h], acc[p][2 * h + 1]);
                if (rnd > 0) {
                  const double2 o = *d;
                  v.x += o.x;
                  v.y += o.y;
                }
                *d = v;
              }
            }
      }
      group_sync(g);
    }
  }

  // ---- Cholesky (first half: row idx of G) and L^{-1} (second half:
  // column idx), one loop, one barrier a step --------------------------------
  const bool chol = t < HALF;
  const int idx = chol ? t : t - HALF;
  double v[N];
  if (chol) {
    // G[idx][k] = G[k][idx], k <= idx, from the upper tiles of both partials
    double dg = 0.0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k] = (k <= idx && idx < N) ? Gs[k * LDG + idx] + Xs[k * LDX + idx]
                                   : 0.0;
      if (k == idx) dg = v[k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dg += __shfl_xor_sync(0xffffffffu, dg, o);
    if (lane == 0) trp[w] = dg;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = (k == idx) ? 1.0 : 0.0;
  }
  group_sync(g);                           // partials read, traces written
  if (chol) {
    const double tr = HALF > 32 ? trp[0] + trp[1] : trp[0];
    const double jit = eps * fmax(tr, kFloor) / N;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k == idx) v[k] += jit;
  } else if (idx < N8) {
#pragma unroll
    for (int i = N; i < N8; ++i) Xs[i * LDX + idx] = 0.0;  // L^{-1}'s pad rows
  }
  // Step j: the first half's rows >= j write column j, unscaled, to Gs[j]
  // (row j of L^T up to its scale), and the pivot's row writes 1/sqrt(max(
  // pivot, floor)) to rdg[j]; after the barrier every row updates itself,
  // a_ik -= a_ij a_kj / pivot, k in (j, idx].  The second half runs step
  // j-1 of L X = I for column idx: x_jj = v[jj] / L_jj, stored to Xs at
  // once (no register holds it after), then x_i -= L_i,jj x_jj, i > jj.
#pragma unroll
  for (int j = 0; j <= N; ++j) {
    if (chol && j < N && idx >= j && idx < N) {
      Gs[j * LDG + idx] = v[j];
      if (idx == j) rdg[j] = rsqrt(fmax(v[j], kFloor));
    }
    group_sync(g);
    if (chol) {
      if (j < N - 1) {
        const double rd = rdg[j];
        const double tt = idx > j ? v[j] * rd * rd : 0.0;
#pragma unroll
        for (int k = (j + 1) & ~1; k < N; k += 2) {
          const double2 c =
              *reinterpret_cast<const double2*>(Gs + j * LDG + k);
          if (k > j) v[k] -= tt * c.x;
          if (k + 1 < N) v[k + 1] -= tt * c.y;
        }
      }
    } else if (j >= 1) {
      const int jj = j - 1;
      const double rd = rdg[jj];
      const double x = v[jj] * rd;
      if (idx < N8) Xs[jj * LDX + idx] = x;
      const double z = x * rd;
#pragma unroll
      for (int i = (jj + 1) & ~1; i < N; i += 2) {
        const double2 c =
            *reinterpret_cast<const double2*>(Gs + jj * LDG + i);
        if (i > jj) v[i] -= c.x * z;
        if (i + 1 < N) v[i + 1] -= c.y * z;
      }
    }
  }
  group_sync(g);                           // L^T and L^{-1} complete

  // ---- R = L^T: R[j][i] = L[i][j] = Gs[j][i] / sqrt(p_j), L_jj =
  // sqrt(p_j) = p_j / sqrt(p_j), p_j = max(Gs[j][j], floor)
  float* rr = R + inst * (i64)(N * N);
  for (int e = t; e < N * N; e += NTI) {
    const int j = e / N, i = e % N;
    float out = 0.f;
    if (i >= j) {
      const double c = i == j ? fmax(Gs[j * LDG + j], kFloor)
                              : Gs[j * LDG + i];
      out = (float)(c * rdg[j]);
    }
    rr[e] = out;
  }

  // ---- Q = A L^{-1}^T: row tiles of 16 by warps, QR tiles a pass, k-steps
  // of 8.  A fragment: A[16 rt + lr (+8)][8 ks + lc (+4)] (8 rows 1 apart,
  // LDA 4 mod 8: 32 banks); B fragment: L^{-1}[8 J + lr][8 ks + lc (+4)],
  // zero for ks > J, so column tiles start at J = ks.
  float* q = Q + inst * (i64)(M * N);
#pragma unroll 1
  for (int pass = 0; pass < NPASS; ++pass) {
    double acc[QR][NJ][4];
#pragma unroll
    for (int a = 0; a < QR; ++a)
#pragma unroll
      for (int J = 0; J < NJ; ++J)
        acc[a][J][0] = acc[a][J][1] = acc[a][J][2] = acc[a][J][3] = 0.0;
#pragma unroll
    for (int ks = 0; ks < NJ; ++ks) {
      double fa[QR][4];
#pragma unroll
      for (int a = 0; a < QR; ++a) {
        const int rt = w + NW * (pass * QR + a);
        const float* src = As + (rt * 16 + lr) * LDA + ks * 8 + lc;
        const bool in = rt < MB16;
        fa[a][0] = in ? (double)src[0] : 0.0;
        fa[a][1] = in ? (double)src[8 * LDA] : 0.0;
        fa[a][2] = in ? (double)src[4] : 0.0;
        fa[a][3] = in ? (double)src[8 * LDA + 4] : 0.0;
      }
#pragma unroll
      for (int J = ks; J < NJ; ++J) {
        const double* xb = Xs + (J * 8 + lr) * LDX + ks * 8 + lc;
        const double b0 = xb[0], b1 = xb[4];
#pragma unroll
        for (int a = 0; a < QR; ++a)
          if (w + NW * (pass * QR + a) < MB16)
            dmma(acc[a][J], fa[a][0], fa[a][1], fa[a][2], fa[a][3], b0, b1);
      }
    }
#pragma unroll
    for (int a = 0; a < QR; ++a)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (w + NW * (pass * QR + a)) * 16 + 8 * h + lr;
        if (row >= M) continue;
#pragma unroll
        for (int J = 0; J < NJ; ++J) {
          const int col = J * 8 + 2 * lc;
          if (col < N)
            store_q(q + row * N + col, acc[a][J][2 * h],
                    acc[a][J][2 * h + 1], col + 1 < N);
        }
      }
  }
}

// The launcher: returns cudaGetLastError() (or the error of the
// shared-memory attribute call) as an int, and cudaErrorInvalidValue for a
// shape or a shared-memory size other than the one this library was built
// for.  A, Q: [Bn, m, n] float32, R: [Bn, n, n] float32, all contiguous, A
// 16-byte aligned.
extern "C" int cholqr_staged(const void* A, void* Q, void* R, int Bn, int m,
                             int n, double eps, long long smem,
                             void* stream) {
  if (m != M || n != N || smem != (long long)IPB * SMEM_INST)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cholqr_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cholqr_staged_kernel<<<(Bn + IPB - 1) / IPB, NT, (size_t)smem,
                         (cudaStream_t)stream>>>(
      (const float*)A, (float*)Q, (float*)R, Bn, eps);
  return (int)cudaGetLastError();
}
