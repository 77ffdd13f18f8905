// Batched symmetric eigendecomposition by parallel cyclic Jacobi for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// The SVD sweeps of the tensor trains (matrixproductbp_tpu/ops/
// tensortrain.py:420, 445 and ops/mpem.py:47, jnp.linalg.svd on the TPU,
// outside Pallas) decompose thousands of small matrices per time step.  On
// the card the port takes the SVD of a float32 M [m, n] through the Gram
// matrix in float64 (ops/smallsvd.py::svd_by_gram): G = M^T M (or M M^T),
// G = V diag(w) V^T, sigma = sqrt(w).  cuSOLVER's batched Jacobi solvers
// stop at 32 x 32 and its approximate batched SVD (gesvda) refuses
// rank-deficient inputs; above 32 the library runs one matrix per launch.
// This kernel takes any k <= 64 (k = 20 at D=10, 40 at D=20).  Its plain
// version is ops/smallsvd.py::eigh_desc_plain (torch.linalg.eigh).
//
// Algorithm.  Two-sided cyclic Jacobi with the round-robin ("tournament")
// ordering: each of the k-1 rounds of a sweep pairs every index once, the
// k/2 rotations of a round act on disjoint index pairs and are applied
// together (all row rotations, a barrier, all column rotations and the
// rotations of V).  Each rotation zeroes its A_pq (Golub & Van Loan,
// sym.schur2).  Sweeps stop when the squared off-diagonal mass falls below
// 1e-28 of the squared Frobenius norm (above the rounding floor of ~k^2
// eps^2), or after 30 sweeps.  Eigenvalues are
// written in descending order with their eigenvectors as columns.
//
// What bounds it.  Per instance the function reads k^2 and writes k^2 + k
// float64 values and needs ~9 k^3 FLOP (tridiagonalisation and implicit QR
// with vectors, Golub & Van Loan 8.3): at k = 40 about 0.58 MFLOP against
// 26 KB, bound by float64 operations (34 TFLOP/s).  Jacobi does ~6x that
// work (~6 sweeps of (k-1) rounds x k/2 rotations x 18 k FLOP), and the ~3
// barriers per round make it latency-bound per block.
//
// Design.  One thread block owns one instance; A and V live in shared memory
// as float64 with a padded row stride (k + 1).  Plain FMAs only.
//
// Shared memory per block: 2 k (k + 1) float64 values (A, V) and 3 k/2
// values of scratch per round (k = 40: 26,720 bytes; k = 64: 67,328 bytes).

#include <cuda_runtime.h>

typedef long long i64;

namespace {

constexpr int kMaxSweeps = 30;

__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                   // red[] is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  const int nw = (blockDim.x + 31) >> 5;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

// player at tournament position a in round r (kk players, kk even)
__device__ __forceinline__ int player(int a, int r, int kk) {
  return a == 0 ? 0 : 1 + (a - 1 + r) % (kk - 1);
}

__global__ void jacobi_eigh_kernel(const double* __restrict__ G,
                                   double* __restrict__ W,
                                   double* __restrict__ Vout, int k) {
  extern __shared__ double smem[];
  __shared__ double red[32];
  const int ld = k + 1;
  const int kk = k + (k & 1);        // an odd k plays a dummy index k
  const int np = kk / 2;
  double* A = smem;                  // [k][ld]
  double* V = A + k * ld;            // [k][ld]
  double* cs = V + k * ld;           // [np] cosines
  double* sn = cs + np;              // [np] sines
  int* pp = (int*)(sn + np);         // [np] p indices (-1: no rotation)
  int* qq = pp + np;                 // [np] q indices
  const i64 inst = blockIdx.x;
  const double* g = G + inst * (i64)k * k;
  const int tid = threadIdx.x, nt = blockDim.x;

  double fro = 0.0;
  for (int e = tid; e < k * k; e += nt) {
    const int i = e / k, j = e % k;
    const double a = g[e];
    A[i * ld + j] = a;
    V[i * ld + j] = (i == j) ? 1.0 : 0.0;
    fro += a * a;
  }
  fro = block_sum(fro, red);         // also the barrier after the loads

  for (int sweep = 0; sweep < kMaxSweeps && k > 1; ++sweep) {
    double off = 0.0;
    for (int e = tid; e < k * k; e += nt) {
      const int i = e / k, j = e % k;
      if (i != j) off += A[i * ld + j] * A[i * ld + j];
    }
    off = block_sum(off, red);
    if (!(off > 1e-28 * fro)) break;  // converged (or all zero / NaN)
    for (int r = 0; r < kk - 1; ++r) {
      if (tid < np) {
        int p = player(tid, r, kk), q = player(kk - 1 - tid, r, kk);
        double c = 1.0, s = 0.0;
        if (p < k && q < k) {
          const double apq = A[p * ld + q];
          if (apq != 0.0) {
            const double tau = (A[q * ld + q] - A[p * ld + p]) / (2.0 * apq);
            const double t = (tau >= 0.0 ? 1.0 : -1.0)
                             / (fabs(tau) + sqrt(1.0 + tau * tau));
            c = 1.0 / sqrt(1.0 + t * t);
            s = t * c;
          } else {
            p = -1;
          }
        } else {
          p = -1;
        }
        pp[tid] = p; qq[tid] = q; cs[tid] = c; sn[tid] = s;
      }
      __syncthreads();
      // rows: A <- J^T A
      for (int e = tid; e < np * k; e += nt) {
        const int m = e / k, j = e % k, p = pp[m];
        if (p < 0) continue;
        const int q = qq[m];
        const double c = cs[m], s = sn[m];
        const double ap = A[p * ld + j], aq = A[q * ld + j];
        A[p * ld + j] = c * ap - s * aq;
        A[q * ld + j] = s * ap + c * aq;
      }
      __syncthreads();
      // columns: A <- A J, V <- V J
      for (int e = tid; e < np * k; e += nt) {
        const int m = e / k, i = e % k, p = pp[m];
        if (p < 0) continue;
        const int q = qq[m];
        const double c = cs[m], s = sn[m];
        const double ap = A[i * ld + p], aq = A[i * ld + q];
        A[i * ld + p] = c * ap - s * aq;
        A[i * ld + q] = s * ap + c * aq;
        const double vp = V[i * ld + p], vq = V[i * ld + q];
        V[i * ld + p] = c * vp - s * vq;
        V[i * ld + q] = s * vp + c * vq;
      }
      __syncthreads();
    }
  }

  // descending order: eigenvalue i goes to rank = #{j : w_j > w_i, or equal
  // with j < i}
  double* w = W + inst * (i64)k;
  double* v = Vout + inst * (i64)k * k;
  for (int i = tid; i < k; i += nt) {
    const double wi = A[i * ld + i];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const double wj = A[j * ld + j];
      rank += (wj > wi) || (wj == wi && j < i);
    }
    w[rank] = wi;
    for (int r = 0; r < k; ++r) v[r * k + rank] = V[r * ld + i];
  }
}

}  // namespace

extern "C" {

// G: [Bn, k, k] symmetric float64, contiguous -> W [Bn, k] (descending),
// V [Bn, k, k] (eigenvectors as columns).  Returns the CUDA error code.
int jacobi_eigh(const void* G, void* W, void* V, int Bn, int k, int threads,
                long long smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      jacobi_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  jacobi_eigh_kernel<<<Bn, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const double*)G, (double*)W, (double*)V, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
