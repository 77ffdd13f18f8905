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

