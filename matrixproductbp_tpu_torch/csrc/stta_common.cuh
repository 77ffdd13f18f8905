// Declarations shared by the STTA scan sources: stta_scans.cu (the first
// designs of the four scan kernels), merge_f_staged.cu and
// merge_f_cluster.cu (the staged and the cluster merge F kernels),
// merge_w_staged.cu and mpem3_staged.cu (the staged merge W and MPEM3 W
// and F kernels), the last four each built once per shape.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

typedef long long i64;

struct Str6 { i64 s[6]; };

// C[b1,b2][i,j] (+)= sum_k A[b1,b2][i,k] B[b1,b2][k,j], all by strides.
struct Gemm {
  int M, N, K, nb1, nb2;
  int ai, ak, ab1, ab2;
  int bk, bj, bb1, bb2;
  int ci, cj, cb1, cb2;
};

// Allow `smem` bytes of dynamic shared memory and cut `threads` to what the
// kernel's register use permits per block.
template <typename K>
static int prepare(K kernel, size_t smem, int* threads) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const int cap = fa.maxThreadsPerBlock & ~31;
  if (*threads > cap) *threads = cap;
  return 0;
}


// One row of N at a forward scan's last step: a row `a` of n entries times
// the one-hot W_{T1}, in full, as the plain scan's product does it:
// a[0] + sum_{c>0} a[c]*0 at b = 0 and sum_c a[c]*0 at every other b, so a
// NaN or inf anywhere in the row reaches each column b, at out[b].
template <typename T>
__device__ __forceinline__ void onehot_row(const T* a, int n, T* out,
                                           int sr) {
  T z = T(0);
  for (int c = 1; c < n; ++c) z += a[c] * T(0);
  out[0] = a[0] + z;
  z += a[0] * T(0);
  for (int b = 1; b < sr; ++b) out[b] = z;
}

// The rows of N at a forward scan's last step, as onehot_row, one warp a
// row (the block's warps in turn; every thread of the block calls it, and
// blockDim.x is a multiple of 32): row r of n entries at src(r), its
// columns b at dst(r)[b].  The zero-sum is a warp reduction, so a long row
// (DL*DB = 400 at D=20) costs each lane n/32 loads, not one thread n.
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void onehot_rows(int rows, int n, int sr, Src src,
                                            Dst dst) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nw) {
    const T* a = src(r);
    T z = T(0);
    for (int c = 1 + lane; c < n; c += 32) z += a[c] * T(0);
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    T* out = dst(r);
    if (lane == 0) out[0] = a[0] + z;
    z += a[0] * T(0);
    for (int b = 1 + lane; b < sr; b += 32) out[b] = z;
  }
}
