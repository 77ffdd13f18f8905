// Building blocks of the per-shape merge F kernels (merge_f_staged.cu and
// merge_f_cluster.cu): a batched small GEMM with TM x TN register tiles and
// a K sum split over lanes, and asynchronous (cp.async) staging copies.

#pragma once

#include "stta_common.cuh"

// block_gemm for a block of NT threads, with TM x TN register tiles and the
// K sum split over KS neighbouring lanes of a warp (KS a power of two up to
// 32), reduced by warp shuffles.  The tasks (tile, k share) are padded to
// whole warps, so every lane of a warp takes part in the shuffles; a
// padding task computes tile 0 and stores nothing.
template <int NT, typename T, int TM, int TN, int KS, bool ACC>
__device__ __forceinline__ void tile_gemm(const T* __restrict__ A,
                                          const T* __restrict__ B,
                                          T* __restrict__ C, const Gemm& g) {
  const int mt = (g.M + TM - 1) / TM, nt = (g.N + TN - 1) / TN;
  const int tiles = g.nb1 * g.nb2 * mt * nt;
  const int tasks = KS == 1 ? tiles : (tiles * KS + 31) & ~31;
  for (int t = threadIdx.x; t < tasks; t += NT) {
    const int ks = t & (KS - 1);
    int r = t / KS;
    const bool live = r < tiles;
    if (!live) r = 0;
    const int tj = r % nt; r /= nt;
    const int ti = r % mt; r /= mt;
    const int b2 = r % g.nb2;
    const int b1 = r / g.nb2;
    const T* a = A + b1 * g.ab1 + b2 * g.ab2;
    const T* b = B + b1 * g.bb1 + b2 * g.bb2;
    int ia[TM], jb[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) ia[u] = min(TM * ti + u, g.M - 1) * g.ai;
#pragma unroll
    for (int v = 0; v < TN; ++v) jb[v] = min(TN * tj + v, g.N - 1) * g.bj;
    T c[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) c[u][v] = T(0);
    for (int k = ks; k < g.K; k += KS) {
      const T* ak = a + k * g.ak;
      const T* bk = b + k * g.bk;
      T av[TM], bv[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = ak[ia[u]];
#pragma unroll
      for (int v = 0; v < TN; ++v) bv[v] = bk[jb[v]];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) c[u][v] += av[u] * bv[v];
    }
#pragma unroll
    for (int o = KS >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v)
          c[u][v] += __shfl_xor_sync(0xffffffffu, c[u][v], o);
    if (!live || ks != 0) continue;
    T* cc = C + b1 * g.cb1 + b2 * g.cb2 + TM * ti * g.ci + TN * tj * g.cj;
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        if (TM * ti + u < g.M && TN * tj + v < g.N) {
          if (ACC) cc[u * g.ci + v * g.cj] += c[u][v];
          else cc[u * g.ci + v * g.cj] = c[u][v];
        }
  }
}

// Issue asynchronous copies (cp.async) of n contiguous elements from global
// into shared memory: 16-byte chunks when both ends and n allow it, else one
// element per copy.  Every thread must call it; __pipeline_commit groups the
// copies, and __pipeline_wait_prior and a block barrier make them visible.
template <typename T>
__device__ void async_copy(T* dst, const T* src, int n) {
  const bool vec = ((reinterpret_cast<size_t>(dst) |
                     reinterpret_cast<size_t>(src) | (n * sizeof(T))) &
                    15) == 0;
  if (vec) {
    const int nc = n * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < nc; i += blockDim.x)
      __pipeline_memcpy_async(reinterpret_cast<char*>(dst) + 16 * i,
                              reinterpret_cast<const char*>(src) + 16 * i,
                              16);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
  }
}

// stage4 by asynchronous copies: one block copy where the row is contiguous,
// else one copy per element.
template <typename T>
__device__ void async_stage4(T* dst, const T* src, const i64* s, int A, int B,
                             int C, int D) {
  if (s[5] == 1 && s[4] == D && s[3] == (i64)C * D &&
      s[2] == (i64)B * C * D) {
    async_copy(dst, src, A * B * C * D);
    return;
  }
  const int n = A * B * C * D;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = i;
    const int d = r % D; r /= D;
    const int c = r % C; r /= C;
    const int b = r % B;
    const int a = r / B;
    __pipeline_memcpy_async(dst + i,
                            src + a * s[2] + b * s[3] + c * s[4] + d * s[5],
                            sizeof(T));
  }
}
