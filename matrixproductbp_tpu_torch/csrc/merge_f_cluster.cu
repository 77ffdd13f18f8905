// merge F, cluster, for Hopper (sm_90a): the forward merge scan of
// stta_scans.cu's merge_f_kernel for the shapes whose working set does not
// fit in one SM's shared memory (the f32 sketch merges from D=16 to D=20),
// computed by a cluster of two thread blocks per instance, compiled once per
// shape.
//
// Replaces, as merge_f_kernel and merge_f_staged_kernel do, the Pallas TPU
// kernels _merge_fstep_kernel and _merge_fstep_kernel_lean of
// matrixproductbp_tpu/ops/fused_stta.py (:281, :382; grid wrapper
// _merge_fscan :466; at D=20 the TPU ran the lean body); its plain version is
// matrixproductbp_tpu_torch/ops/stta.py::merge_fscan_plain.  The wrapper
// (fused_stta.py::merge_fscan) picks it where fused_stta.py::merge_f_geometry
// finds that the staged kernel's buffers do not fit and this kernel's do.
//
// What bounds it: as for merge_f_staged.cu, shared-memory operand traffic
// and the barriers between a step's dependent products (the operations bound
// at [8192, 15, D=20] is 15.2 ms at the fp32 peak).  The staged design needs
// 459 KiB a block at D=20, twice what a block may have; most of it scales
// with the sketch rows e (S, t1, t2, M).  So a cluster of two blocks on
// neighbouring SMs owns one instance (cluster dims (2,1,1), grid 2 x
// instances, rank = blockIdx.x & 1) and splits the rows e and f: rank 0 owns
// rows [0, E0), rank 1 rows [E0, sl), E0 = ceil(sl/2).  M, t1, t2 and N are
// row-local in e: each block computes them for its own rows from its own
// rows of S.  The one product that mixes rows, S2[f,n,j] = sum_{y,e}
// Phi_t[e,f,y,x] t2[e,n,j,y,x], is split by its K sum instead: each block
// computes the partial sums over its own rows e for every row f, keeps those
// of its own rows f in registers and leaves those of the peer's rows in its
// shared memory (in t1's buffer, dead by then), where the peer adds them
// through distributed shared memory (map_shared_rank): one remote read an
// output and step.  (A first version read the peer's t2 rows inside the S2
// product's K loop; those remote loads took two thirds of the kernel's time,
// PERF.md.)  The per-instance max-abs rescale is cluster-wide: each block
// folds its warps' partials, and both read both blocks' partials, so both
// divide by the same guarded scale.
//
// A step (time t = s+1), x held one at a time (t1 and t2 of one x fit):
//   cp.async W_{t+1}, then step s+1's L, B and Phi (two groups);
//   wait for step s's                                            | block barrier
//   M = S . W_t;  t1 = S . L_t (x = 0);  Bp (all (y, x) pairs)   | block barrier
//   for each x:
//     t2 = t1 . Bp (both y);  (x = 0: wait for W_{t+1})          | block barrier
//     N = t2 . W_{t+1} (both y);  S2 += Phi . t2 (all f, own e)
//     if x < q-1: t1 = S . L_t (x+1)                             | block barrier
//   the peer's rows of S2 to Xs                                  | cluster barrier
//   add the peer's Xs to this block's rows; per-warp max-abs     | cluster barrier
//   both blocks' partials -> scale; S <- S2 / scale; store M, N
//   after the last step                                          | cluster barrier
// The second cluster barrier of a step also keeps a block from writing t1
// (over Xs) before its peer has read Xs; the last keeps a block's shared
// memory alive while its peer may still read it.  S2 stays in registers
// across the x loop (each thread owns at most S2R 2x10 tiles of it), since
// t1 of the next x still reads S; it is written over S once scaled.  From
// merge_f_staged.cu it keeps: one product per contraction (per x),
// 20-output register tiles, the K sum split over lanes for M, t2 and N, S
// and t1 rows padded to odd strides, and every streamed operand by cp.async
// a step ahead (W_t / W_{t+1} in two rotating buffers, each block holding
// the whole W; L_t, B_t, Phi_t double-buffered).
//
// Built once per shape.  The sizes, the element type, the blocks an SM
// should hold and, for time-varying tables, MF_TV=1 are macros (MF_T,
// MF_DL, MF_DB, MF_Y, MF_Q, MF_SR, MF_SL, MF_MINB[, MF_TV]) from
// fused_stta.py::merge_f_cluster_macros, which ops/build.py passes to nvcc
// at the shape's first use.
//
// Shared memory per block (elements of T; fused_stta.py::_smem_merge_f_cluster
// computes the same sum): 2*nWp + 2*nLp + 2*nBq (W_t and W_{t+1}; L_t and B_t
// for two steps; DL*DB*sr, DL^2*Y*q and DB^2*Y*q, each rounded up to 16
// bytes) + E0*sE (S, own rows; sE = DL*DB|1) + max(E0*DL*R1, 20*S2T) (t1
// of one x, R1 = DB*Y|1; Xs, 20 words for each of the S2T tiles of S2,
// reuses it) + Y*E0*DL*DB (t2 of one x, both y) + DB^2*Y*Y*q (Bp, all
// pairs) + 2*sl^2*Y*q (Phi_t for two steps) + Y^3*q (Pyy) + E0*sr (M)
// + E0*Y*q*sr (N) [+ Y^3*q, the odd steps' Pyy where the tables vary:
// a build with MF_TV=1 stages step t's table, pyy_step apart, with Phi_t,
// as merge_f_staged.cu does].  D=20, f32, sl=24, E0=12: 16000 + 3200 + 3200 + 4812
// + 9840 + 9600 + 3200 + 4608 + 16 + 240 + 960 = 55676 floats = 217.5 KiB,
// one block an SM.
// Shared layouts: W [2][nWp], L [2][nLp], B [2][nBq] (16-byte aligned);
// S [e][k][m] (row stride sE); t1 [e][n][m][u] (row (e,n) stride R1);
// t2 [y][e][n][j] (y stride E0*DL*DB in both blocks); Bp [x][y][m][u][j];
// Fs [2][x][y][e][f] (all sl rows e and f); Mo [e][a]; No [e][y][x][b];
// Xs [u*10 + v][task] (in t1).

#include <cooperative_groups.h>

#include "merge_f_tiles.cuh"

#if !defined(MF_T) || !defined(MF_DL) || !defined(MF_DB) || !defined(MF_Y) || \
    !defined(MF_Q) || !defined(MF_SR) || !defined(MF_SL) || !defined(MF_MINB)
#error "merge_f_cluster.cu is built per shape: define MF_T, MF_DL, MF_DB, MF_Y, MF_Q, MF_SR, MF_SL and MF_MINB"
#endif
#ifndef MF_TV
#define MF_TV 0                        // one shared Pyy
#endif

namespace cg = cooperative_groups;

typedef MF_T T;
constexpr int NT = 480;                // threads a block (15 warps)
constexpr bool TV = MF_TV;             // a Pyy a step
constexpr int NWARP = NT / 32;
constexpr int DL = MF_DL, DB = MF_DB, Y = MF_Y, q = MF_Q, sr = MF_SR,
              sl = MF_SL;
constexpr int E0 = (sl + 1) / 2, E1 = sl / 2;   // rows of rank 0 and rank 1
constexpr int DLB = DL * DB, P = Y * q;
// S2 tiles: 2 rows f (of all sl) x 10 columns (n, j), at most S2R a thread,
// the row tile fastest: the lanes of a warp then read a few words of t2
// (broadcast) and neighbouring rows of Phi_t, one wavefront each (with the
// column tile fastest a warp straddles two rows of tiles, and two lanes share
// a bank in every load of t2)
constexpr int S2M = (sl + 1) / 2, S2N = (DLB + 9) / 10, S2T = S2M * S2N;
constexpr int S2R = (S2T + NT - 1) / NT;

// Cluster barriers of all threads of both blocks: arrive has release and
// wait acquire semantics at cluster scope, so shared-memory writes made
// before arrive are seen by reads (local or remote) made after wait.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// This thread's share of S2[f][nj] += sum_{y, e} Fx[y][e0+e][f] t2[y][e][nj]
// over every row f and the el rows e this block owns: 2x10 tiles of all sl
// rows f, the K sum over this block's rows e alone.
__device__ __forceinline__ void s2_partial(T (&acc)[S2R][2][10],
                                           const T* __restrict__ Fx,
                                           const T* __restrict__ t2, int e0,
                                           int el) {
  constexpr int T2Y = E0 * DLB;
#pragma unroll
  for (int rr = 0; rr < S2R; ++rr) {
    const int t = threadIdx.x + rr * NT;
    if (t < S2T) {
      const int ti = t % S2M, tj = t / S2M;
      int ia[2], jb[10];
#pragma unroll
      for (int u = 0; u < 2; ++u) ia[u] = min(2 * ti + u, sl - 1);
#pragma unroll
      for (int v = 0; v < 10; ++v) jb[v] = min(10 * tj + v, DLB - 1);
#pragma unroll
      for (int y = 0; y < Y; ++y) {
        const T* a0 = Fx + (y * sl + e0) * sl;
        const T* b0 = t2 + y * T2Y;
        for (int e = 0; e < el; ++e) {
          const T* a = a0 + e * sl;
          const T* b = b0 + e * DLB;
          T av[2], bv[10];
#pragma unroll
          for (int u = 0; u < 2; ++u) av[u] = a[ia[u]];
#pragma unroll
          for (int v = 0; v < 10; ++v) bv[v] = b[jb[v]];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 10; ++v) acc[rr][u][v] += av[u] * bv[v];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT, MF_MINB)
merge_f_cluster_kernel(const T* __restrict__ L, Str6 sL,
                       const T* __restrict__ Bm, Str6 sB,
                       const T* __restrict__ Pyy, i64 pyy_step,
                       const T* __restrict__ Phi,
                       const T* __restrict__ Ws, const T* __restrict__ Sinit,
                       T* __restrict__ Ns, T* __restrict__ Ms, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red_m[NWARP];
  __shared__ int red_b[NWARP];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int V16 = 16 / sizeof(T);
  constexpr int nS = sl * DLB, nW = DLB * sr;
  constexpr int nL = DL * DL * P, nB = DB * DB * P, nBp = DB * Y * DB;
  constexpr int nWp = (nW + V16 - 1) / V16 * V16;
  constexpr int nLp = (nL + V16 - 1) / V16 * V16;
  constexpr int nBq = (nB + V16 - 1) / V16 * V16;
  constexpr int sE = DLB | 1, R1 = (DB * Y) | 1, T2Y = E0 * DLB;
  constexpr int nT1 = E0 * DL * R1 > 20 * S2T ? E0 * DL * R1 : 20 * S2T;
  constexpr int nF = sl * sl * P, nP = Y * Y * P, nM = sl * sr,
                nN = sl * P * sr;
  T* Wb = sm;
  T* Ls = Wb + 2 * nWp;
  T* Bs = Ls + 2 * nLp;
  T* Sb = Bs + 2 * nBq;
  T* t1 = Sb + E0 * sE;
  T* t2 = t1 + nT1;
  T* Bp = t2 + Y * T2Y;
  T* Fs = Bp + nBp * P;
  T* Ps = Fs + 2 * nF;
  T* Mo = Ps + nP;
  T* No = Mo + E0 * sr;
  T* Ps1 = No + E0 * P * sr;       // the odd steps' Pyy (TV)
  T* Xs = t1;                      // S2 partials for the peer's rows f
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), peer = rank ^ 1;
  const T* Xs_peer = cl.map_shared_rank(Xs, peer);
  const double* red_m_peer = cl.map_shared_rank(red_m, peer);
  const int* red_b_peer = cl.map_shared_rank(red_b, peer);
  const i64 z = blockIdx.x >> 1;
  const int e0 = rank * E0, el = rank ? E1 : E0;
  const int p0 = peer * E0, pl = peer ? E1 : E0;     // the peer's rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // {M, N, K, nb1, nb2,  ai, ak, ab1, ab2,  bk, bj, bb1, bb2,  ci, cj, cb1, cb2}
  const Gemm gm = {el, sr, DLB, 1, 1,   sE, 1, 0, 0,
                   sr, 1, 0, 0,   sr, 1, 0, 0};
  const Gemm g1 = {el, DL, DL, DB, Y,   sE, DB, 1, 0,
                   DL * P, P, 0, q,   DL * R1, R1, Y, 1};
  const Gemm g2 = {el * DL, DB, DB * Y, 1, Y,   R1, 1, 0, 0,
                   DB, 1, 0, nBp,   DB, 1, 0, T2Y};
  const Gemm gn = {el, sr, DLB, Y, 1,   DLB, 1, T2Y, 0,
                   sr, 1, 0, 0,   P * sr, 1, q * sr, 0};
  // issue the copies of step t's L_t, B_t and Phi_t (transposed to
  // Fs[x][y][e][f]), and of its Pyy where the tables vary, into buffer t & 1
  auto stage_step = [&](int t) {
    const int buf = t & 1;
    if (TV) {
      const T* py = Pyy + t * pyy_step;
      T* pd = buf ? Ps1 : Ps;
      for (int i = tid; i < nP; i += NT)
        __pipeline_memcpy_async(pd + i, py + i, sizeof(T));
    }
    async_stage4(Ls + buf * nLp, L + z * sL.s[0] + t * sL.s[1], sL.s, DL, DL,
                 Y, q);
    async_stage4(Bs + buf * nBq, Bm + z * sB.s[0] + t * sB.s[1], sB.s, DB,
                 DB, Y, q);
    const T* ph = Phi + (i64)t * nF;
    T* fd = Fs + buf * nF;
    for (int i = tid; i < nF; i += NT) {
      const int x = i % q, y = (i / q) % Y, f = (i / P) % sl,
                e = i / (P * sl);
      __pipeline_memcpy_async(fd + ((x * Y + y) * sl + e) * sl + f, ph + i,
                              sizeof(T));
    }
  };

  async_copy(Wb, Ws + z * S * (i64)nW, nW);                   // W_1
  stage_step(0);
  __pipeline_commit();
  if (!TV)
    for (int i = tid; i < nP; i += NT) Ps[i] = Pyy[i];
  for (int i = tid; i < el * sE; i += NT) {                   // pads stay 0
    const int e = i / sE, c = i - e * sE;
    Sb[i] = c < DLB ? Sinit[z * nS + (e0 + e) * DLB + c] : T(0);
  }
  for (int s = 0; s < S; ++s) {
    const i64 row = z * S + s;
    const bool last = (s == S - 1);
    const T* Wt = Wb + (s & 1) * nWp;
    T* Wt1 = Wb + ((s + 1) & 1) * nWp;
    const T* Lc = Ls + (s & 1) * nLp;
    const T* Bc = Bs + (s & 1) * nBq;
    const T* Fc = Fs + (s & 1) * nF;
    const T* Pc = (TV && (s & 1)) ? Ps1 : Ps;
    if (!last) async_copy(Wt1, Ws + (row + 1) * nW, nW);       // W_{t+1}
    __pipeline_commit();
    if (!last) stage_step(s + 1);
    __pipeline_commit();
    __pipeline_wait_prior(2);                                  // step s's
    __syncthreads();
    tile_gemm<NT, T, 2, 5, 16, false>(Sb, Wt, Mo, gm);         // M = S . W_t
    tile_gemm<NT, T, 2, 10, 1, false>(Sb, Lc, t1, g1);          // t1, x = 0
    for (int i = tid; i < nBp * P; i += NT) {                  // Bp[x][y][m][u][j]
      int r = i;
      const int j = r % DB; r /= DB;
      const int uu = r % Y; r /= Y;
      const int m = r % DB; r /= DB;
      const int y = r % Y;
      const int x = r / Y;
      T acc = T(0);
      for (int v = 0; v < Y; ++v)
        acc += Pc[((y * Y + uu) * Y + v) * q + x] *
               Bc[((m * DB + j) * Y + v) * q + x];
      Bp[i] = acc;
    }
    __syncthreads();
    T acc[S2R][2][10];
#pragma unroll
    for (int rr = 0; rr < S2R; ++rr)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 10; ++v) acc[rr][u][v] = T(0);
#pragma unroll
    for (int x = 0; x < q; ++x) {
      tile_gemm<NT, T, 4, 5, 2, false>(t1, Bp + x * Y * nBp, t2, g2);
      if (x == 0) __pipeline_wait_prior(1);                    // W_{t+1}
      __syncthreads();
      if (last) {                                              // N = t2 . one-hot
        onehot_rows<T>(el * Y, DLB, sr,
                       [&](int w) { return t2 + w % Y * T2Y + w / Y * DLB; },
                       [&](int w) {
                         return No + (w / Y * P + w % Y * q + x) * sr;
                       });
      } else {
        tile_gemm<NT, T, 4, 5, 16, false>(t2, Wt1, No + x * sr, gn);
      }
      s2_partial(acc, Fc + x * Y * sl * sl, t2, e0, el);
      if (x + 1 < q) {
        tile_gemm<NT, T, 2, 10, 1, false>(Sb, Lc + x + 1, t1, g1);
        __syncthreads();
      }
    }
    // the partials of the peer's rows f go to Xs (t1 is dead), the peer's
    // partials of this block's rows are added from its Xs.  Both blocks tile
    // S2 alike, so the thread that holds an output's partial here holds the
    // same output in the peer: Xs is kept in thread order (element (u, v) of
    // task t at (u*10 + v)*S2T + t), and a warp's remote loads are 128
    // neighbouring bytes
#pragma unroll
    for (int rr = 0; rr < S2R; ++rr) {
      const int t = tid + rr * NT;
      if (t < S2T) {
        const int ti = t % S2M, tj = t / S2M;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 10; ++v) {
            const int f = 2 * ti + u, nj = 10 * tj + v;
            if (f - p0 >= 0 && f - p0 < pl && nj < DLB)
              Xs[(u * 10 + v) * S2T + t] = acc[rr][u][v];
          }
      }
    }
    cluster_sync();                                            // Xs to the peer
    // every remote load first, then their sums: the loads' latencies overlap
    T xr[S2R][2][10];
#pragma unroll
    for (int rr = 0; rr < S2R; ++rr) {
      const int t = tid + rr * NT;
      const int ti = t % S2M, tj = t / S2M;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 10; ++v) {
          const int f = 2 * ti + u, nj = 10 * tj + v;
          const bool own = t < S2T && f - e0 >= 0 && f - e0 < el && nj < DLB;
          xr[rr][u][v] = own ? Xs_peer[(u * 10 + v) * S2T + t] : T(0);
        }
    }
    double mx = 0.0;
    int bad = 0;
#pragma unroll
    for (int rr = 0; rr < S2R; ++rr) {
      const int t = tid + rr * NT;
      if (t < S2T) {
        const int ti = t % S2M, tj = t / S2M;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 10; ++v) {
            const int f = 2 * ti + u, nj = 10 * tj + v;
            if (f - e0 >= 0 && f - e0 < el && nj < DLB) {
              acc[rr][u][v] += xr[rr][u][v];
              // max-abs with the _safe_scale guard
              const double w = (double)acc[rr][u][v];
              if (!isfinite(w)) bad = 1; else mx = fmax(mx, fabs(w));
            }
          }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      bad |= __shfl_xor_sync(0xffffffffu, bad, o);
    }
    if (lane == 0) { red_m[warp] = mx; red_b[warp] = bad; }
    cluster_sync();                                            // partials
    mx = 0.0;
    bad = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      mx = fmax(mx, fmax(red_m[w], red_m_peer[w]));
      bad |= red_b[w] | red_b_peer[w];
    }
    const T sc = (bad || !(mx > 0.0)) ? T(1) : T(mx);
#pragma unroll
    for (int rr = 0; rr < S2R; ++rr) {
      const int t = tid + rr * NT;
      if (t < S2T) {
        const int ti = t % S2M, tj = t / S2M;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 10; ++v) {
            const int f = 2 * ti + u, nj = 10 * tj + v;
            if (f - e0 >= 0 && f - e0 < el && nj < DLB)
              Sb[(f - e0) * sE + nj] = acc[rr][u][v] / sc;
          }
      }
    }
    for (int i = tid; i < el * sr; i += NT)
      Ms[row * nM + e0 * sr + i] = Mo[i];
    for (int i = tid; i < el * P * sr; i += NT)
      Ns[row * nN + e0 * P * sr + i] = No[i];
  }
  cluster_sync();              // the peer may still read red_m and red_b
}


// A launch of `blocks` blocks in clusters of two, with `smem` bytes of
// dynamic shared memory a block; attr holds the cluster attribute.
static cudaLaunchConfig_t cluster_config(int blocks, long long smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
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

// The most clusters of two blocks of this build's kernel that can be
// resident at once with `smem` bytes of dynamic shared memory a block (0:
// the cluster cannot be scheduled), or minus a CUDA error code.
extern "C" int merge_f_cluster_occupancy(long long smem) {
  int threads = NT;
  int e = prepare(merge_f_cluster_kernel, (size_t)smem, &threads);
  if (e) return -e;
  if (threads != NT) return -(int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(2, smem, 0, &attr);
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, merge_f_cluster_kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n;
}

// The launcher: a grid of 2 x Bn blocks in clusters of two.  Returns
// cudaGetLastError() (or the error of the set-up calls) as an int, and
// cudaErrorInvalidValue for a shape (or a pyy_step, 0 or not) other than
// the one this library was built for.
extern "C" int merge_f_cluster(const void* L, const i64* sL, const void* B,
                               const i64* sB, const void* Pyy,
                               long long pyy_step, const void* Phi,
                               const void* Ws,
                               const void* Sinit, void* Ns, void* Ms, int Bn,
                               int S, int DL_, int DB_, int Y_, int q_,
                               int sr_, int sl_, long long smem,
                               void* stream) {
  if (DL_ != DL || DB_ != DB || Y_ != Y || q_ != q || sr_ != sr ||
      sl_ != sl || (pyy_step != 0) != TV)
    return (int)cudaErrorInvalidValue;
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  int threads = NT;
  int e = prepare(merge_f_cluster_kernel, (size_t)smem, &threads);
  if (e) return e;
  if (threads != NT) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(2 * Bn, smem, (cudaStream_t)stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, merge_f_cluster_kernel, (const T*)L, a, (const T*)B, b,
      (const T*)Pyy, (i64)pyy_step, (const T*)Phi, (const T*)Ws,
      (const T*)Sinit, (T*)Ns, (T*)Ms, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
