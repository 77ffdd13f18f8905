// Batched thin QR by Cholesky-QR for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces the Pallas TPU kernel matrixproductbp_tpu/ops/kernels.py::
// _cholqr_kernel (kernels.py:61; batched entry batched_cholqr :104, pallas_call
// :120).  Its plain version is matrixproductbp_tpu_torch/ops/smallalg.py::
// cholqr_unrolled; the wrapper is ops/kernels.py::batched_cholqr.
//
// For every instance A [m, n] (m = s*Y*q, n = s: [80, 20] at D=10, [160, 40]
// at D=20 on the randomized merge's path):
//   G = A^T A + eps * max(tr G, 1e-30) / n * I,  L = chol(G),
//   Q = A L^{-T},  R = L^T,
// with the pivot floor sqrt(max(d, 1e-30)) and the divisor floor
// max(L_jj, 1e-30) of kernels.py:68-95.
//
// Precision.  Every instance is factored in float64, whatever the storage
// type; float32 inputs and outputs are converted on load and store.  The
// caller passes the jitter of the storage type (1e-6 for float32).  In
// float32 the Gram of a low-rank A (the early time steps of the randomized
// merge start from a one-hot carry) keeps positive definiteness only
// through the jitter, and float32 rounding of G exceeds it at n = 20: the
// pivots go negative, hit the floor, and Q overflows.  In float64 that
// rounding is ~1e-16 of tr G, far below the jitter.
//
// What bounds it.  Per instance the kernel reads A once and writes Q and R
// once (14.4 KB at [80, 20] in float32) and does ~m*n^2 + m*n^2 + n^3/3
// float64 FLOP (~0.13 MFLOP at [80, 20]): near the ridge of the card's HBM
// rate and its float64 rate (3.35 TB/s, 67 TFLOP/s on the tensor cores),
// bound by bytes.  The factorisation is a
// chain of n dependent column steps.
//
// Design.  On the TPU 128 instances rode the lanes and the column loop was
// unrolled.  Here one thread block owns one instance: A is staged in shared
// memory as float64 with a padded row stride (n + 1) against bank conflicts;
// the Gram's lower triangle is computed by threads over (i, j) pairs; the
// Cholesky-Crout factorisation runs column by column with two block
// barriers per column; Q = A L^{-T} is a forward substitution with one
// thread per row of A, written in place over the staged A, so that the
// stores of Q go out coalesced from shared memory.  Plain FMAs only; packing
// several instances into one block is later work.
//
// Shared memory per block (float64): m*(n+1) (A, then Q) + n*(n+1) (G, then
// L) + n (one column).  [160, 40]: 65,920 bytes; the wrapper refuses shapes
// over the 227 KB a block may use.

#include <cuda_runtime.h>

typedef long long i64;

namespace {

constexpr double kFloor = 1e-30;

template <typename T>
__global__ void cholqr_kernel(const T* __restrict__ A, T* __restrict__ Q,
                              T* __restrict__ R, int m, int n, double eps) {
  extern __shared__ double smem[];
  const int ld = n + 1;
  double* As = smem;                 // [m][ld]: A, then Q
  double* Lm = As + m * ld;          // [n][ld]: G's lower triangle, then L
  double* col = Lm + n * ld;         // [n]: the column being factored
  const i64 inst = blockIdx.x;
  const T* a = A + inst * (i64)m * n;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < m * n; e += nt)
    As[(e / n) * ld + e % n] = (double)a[e];
  __syncthreads();

  // Gram, lower triangle: G[i][j] = sum_r A[r][i] A[r][j], i >= j
  for (int p = tid; p < n * n; p += nt) {
    const int i = p / n, j = p % n;
    if (j > i) continue;
    double s = 0.0;
    for (int r = 0; r < m; ++r) s += As[r * ld + i] * As[r * ld + j];
    Lm[i * ld + j] = s;
  }
  __syncthreads();
  double tr = 0.0;
  for (int i = 0; i < n; ++i) tr += Lm[i * ld + i];
  const double jitter = eps * fmax(tr, kFloor) / n;
  __syncthreads();                   // every thread has read the diagonal

  // Cholesky-Crout in place: column j of L from G's column j and the
  // finished columns k < j
  for (int j = 0; j < n; ++j) {
    for (int i = j + tid; i < n; i += nt) {
      double s = Lm[i * ld + j] + (i == j ? jitter : 0.0);
      for (int k = 0; k < j; ++k) s -= Lm[i * ld + k] * Lm[j * ld + k];
      col[i] = s;
    }
    __syncthreads();
    const double d = sqrt(fmax(col[j], kFloor));
    for (int i = j + tid; i < n; i += nt) Lm[i * ld + j] = col[i] / d;
    __syncthreads();
  }

  // Q = A L^{-T}: row r of Q solves L q = A[r]^T by forward substitution
  for (int r = tid; r < m; r += nt) {
    double* row = As + r * ld;
    for (int j = 0; j < n; ++j) {
      double s = row[j];
      for (int k = 0; k < j; ++k) s -= Lm[j * ld + k] * row[k];
      row[j] = s / fmax(Lm[j * ld + j], kFloor);
    }
  }
  __syncthreads();

  T* q = Q + inst * (i64)m * n;
  for (int e = tid; e < m * n; e += nt)
    q[e] = (T)As[(e / n) * ld + e % n];
  T* rr = R + inst * (i64)n * n;
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e % n;  // R[i][j] = L[j][i], upper triangular
    rr[e] = (T)(i <= j ? Lm[j * ld + i] : 0.0);
  }
}

template <typename T>
int cholqr_launch(const void* A, void* Q, void* R, int Bn, int m, int n,
                  double eps, int threads, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      cholqr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cholqr_kernel<T><<<Bn, threads, smem, st>>>((const T*)A, (T*)Q, (T*)R, m,
                                               n, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64.  A, Q: [Bn, m, n]; R: [Bn, n, n]; all
// contiguous.  Launches on `stream`; returns the CUDA error code (0: none).
int cholqr(int dtype, const void* A, void* Q, void* R, int Bn, int m, int n,
           double eps, int threads, long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
      ? cholqr_launch<float>(A, Q, R, Bn, m, n, eps, threads, (size_t)smem, st)
      : cholqr_launch<double>(A, Q, R, Bn, m, n, eps, threads, (size_t)smem,
                              st);
}

}  // extern "C"
