// merge F, staged, for Hopper (sm_90a): the forward merge scan of
// stta_scans.cu's merge_f_kernel, for every shape whose buffers fit in shared
// memory, compiled once per shape.
//
// Replaces, as merge_f_kernel does, the Pallas TPU kernels
// _merge_fstep_kernel and _merge_fstep_kernel_lean of
// matrixproductbp_tpu/ops/fused_stta.py (:281, :382; grid wrapper
// _merge_fscan :466); its plain version is
// matrixproductbp_tpu_torch/ops/stta.py::merge_fscan_plain.  The wrapper
// (fused_stta.py::merge_fscan) picks this kernel wherever
// fused_stta.py::merge_f_geometry finds that its buffers fit: every f32
// sketch merge up to D=15, measured faster than merge_f_kernel at each D
// from 4 to 15 (PERF.md).
//
// Built once per shape.  The sizes, the element type, the blocks an SM
// should hold and, for time-varying tables, MF_TV=1 are macros (MF_T,
// MF_DL, MF_DB, MF_Y, MF_Q, MF_SR, MF_SL, MF_MINB[, MF_TV]), which
// ops/build.py passes to nvcc at the shape's first use and caches the
// library by; with every size a constant, the products' task decodes,
// strides and K loops fold into the code (with run-time sizes they cost
// about as much as the products themselves; PERF.md).  MF_MINB is the
// number of blocks whose shared memory fits on one SM (at most 3): the
// register budget __launch_bounds__ gives ptxas.
//
// What bounds it: shared-memory operand traffic and the block barriers
// between a step's dependent products (a block owns one instance and runs
// its whole time loop).  What the design does about it: one product per
// contraction and step, five block barriers per step:
//   cp.async W_{t+1}, then step s+1's L, B and Phi (two groups);
//   wait for step s's                                              | barrier
//   M = S . W_t;  t1 = S . L_t (both x);  Bp (all (y,x) pairs)     | barrier
//   t2 = t1 . Bp (all pairs);  wait for W_{t+1}                    | barrier
//   N = t2 . W_{t+1} (all pairs);  S2 = sum_{y,x,e} Phi_t t2        | barrier
//   per-warp max-abs of S2                                         | barrier
//   every thread finishes the max; S <- S2 / scale; store M, N
// Every streamed operand arrives by cp.async one step ahead: W into two
// rotating buffers (the copy of W_{t+1} is issued at the start of step s and
// waited for before N; it is step s+1's W_t), L_t, B_t and Phi_t into double
// buffers (issued a step ahead, waited for at the step's first barrier).
// S2 is written over S: every reader of S has passed a barrier by then.
// The products take 20-output register tiles (2x5 for M and S2, 2x10 for
// t1, 4x5 for t2 and N), and M, t2 and N split their K sum over 16, 2 and 4
// lanes, so that each has work for the whole block.  Rows of S and of t1
// are padded to odd strides, against bank conflicts.  M and N are written to
// shared memory and stored to Ms and Ns coalesced.
//
// Time-varying tables (MF_TV=1; a Pyy a step, pyy_step apart): step t's
// table is staged with Phi_t, by cp.async a step ahead, into the buffer of
// step t's parity: the shared table's buffer for even t, a second one after
// M for odd t.  A build for one shared table (MF_TV undefined, pyy_step =
// 0) loads it once; the time-varying code compiles out, and its macros are
// those of the build before time-varying tables.
//
// Shared memory per block (elements of T; fused_stta.py::_smem_merge_f_staged
// computes the same sum): 2*nWp + 2*nLp + 2*nBq (W_t and W_{t+1}; L_t and B_t
// for two steps; DL*DB*sr, DL^2*Y*q and DB^2*Y*q, each rounded up to 16
// bytes) + sl*sE (S, S2 over it; sE = DL*DB|1) + max(sl*DL*R1, sl*Y*q*sr)
// (t1 for both x, R1 = DB*Y*q|1; N reuses it) + sl*DL*DB*Y*q (t2, all pairs)
// + DB^2*Y*Y*q (Bp, all pairs) + 2*sl^2*Y*q (Phi_t for two steps) + Y^3*q
// + sl*sr (M) [+ Y^3*q, the odd steps' Pyy].  D=10, f32, sl=14: 18878
// floats = 73.7 KiB, 3 blocks an SM; D=15, sl=19: 211.3 KiB, one.
// Shared layouts: W [2][nWp], L [2][nLp], B [2][nBq] (16-byte aligned);
// S [e][k][m] (row stride sE); t1 [e][n][m][u][x] (row (e,n) stride R1);
// t2 [y][x][e][n][j]; Bp [x][y][m][u][j]; Fs [2][y][x][e][f]; Mo [e][a];
// No [e][y][x][b] (in t1).

#include "merge_f_tiles.cuh"

#if !defined(MF_T) || !defined(MF_DL) || !defined(MF_DB) || !defined(MF_Y) || \
    !defined(MF_Q) || !defined(MF_SR) || !defined(MF_SL) || !defined(MF_MINB)
#error "merge_f_staged.cu is built per shape: define MF_T, MF_DL, MF_DB, MF_Y, MF_Q, MF_SR, MF_SL and MF_MINB"
#endif
#ifndef MF_TV
#define MF_TV 0                        // one shared Pyy
#endif

typedef MF_T T;
constexpr int NT = 256;                // threads a block
constexpr bool TV = MF_TV;             // a Pyy a step

__global__ void __launch_bounds__(NT, MF_MINB)
merge_f_staged_kernel(const T* __restrict__ L, Str6 sL,
                      const T* __restrict__ Bm, Str6 sB,
                      const T* __restrict__ Pyy, i64 pyy_step,
                      const T* __restrict__ Phi,
                      const T* __restrict__ Ws, const T* __restrict__ Sinit,
                      T* __restrict__ Ns, T* __restrict__ Ms, int S) {
  constexpr int NWARP = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red_m[NWARP];
  __shared__ int red_b[NWARP];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int V16 = 16 / sizeof(T);
  constexpr int DL = MF_DL, DB = MF_DB, Y = MF_Y, q = MF_Q, sr = MF_SR,
                sl = MF_SL;
  const int DLB = DL * DB, nS = sl * DLB, nW = DLB * sr, P = Y * q;
  const int nL = DL * DL * P, nB = DB * DB * P, nBp = DB * Y * DB;
  const int nWp = (nW + V16 - 1) / V16 * V16;
  const int nLp = (nL + V16 - 1) / V16 * V16, nBq = (nB + V16 - 1) / V16 * V16;
  const int sE = DLB | 1, R1 = (DB * P) | 1;
  const int nSp = sl * sE, nT1 = max(sl * DL * R1, sl * P * sr);
  const int nF = sl * sl * P, nP = Y * Y * P, nM = sl * sr, nN = sl * P * sr;
  T* Wb = sm;
  T* Ls = Wb + 2 * nWp;
  T* Bs = Ls + 2 * nLp;
  T* Sb = Bs + 2 * nBq;
  T* t1 = Sb + nSp;
  T* t2 = t1 + nT1;
  T* Bp = t2 + nS * P;
  T* Fs = Bp + nBp * P;
  T* Ps = Fs + 2 * nF;
  T* Mo = Ps + nP;
  T* Ps1 = Mo + nM;                // the odd steps' Pyy (TV)
  T* No = t1;                      // t1 is dead once t2 is formed
  const i64 z = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // {M, N, K, nb1, nb2,  ai, ak, ab1, ab2,  bk, bj, bb1, bb2,  ci, cj, cb1, cb2}
  const Gemm gm = {sl, sr, DLB, 1, 1,   sE, 1, 0, 0,
                   sr, 1, 0, 0,   sr, 1, 0, 0};
  const Gemm g1 = {sl, DL, DL, DB, P,   sE, DB, 1, 0,
                   DL * P, P, 0, 1,   DL * R1, R1, P, 1};
  const Gemm g2 = {sl * DL, DB, DB * Y, q, Y,   R1, q, 1, 0,
                   DB, 1, Y * nBp, nBp,   DB, 1, nS, q * nS};
  const Gemm gn = {sl, sr, DLB, P, 1,   DLB, 1, nS, 0,
                   sr, 1, 0, 0,   P * sr, 1, sr, 0};
  const Gemm gs = {sl, DLB, P * sl, 1, 1,   1, sl, 0, 0,
                   DLB, 1, 0, 0,   sE, 1, 0, 0};
  // issue the copies of step t's L_t, B_t and Phi_t (transposed to
  // Fs[(y,x)][e][f]), and of its Pyy where the tables vary, into buffer t & 1
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
      const int p = i % P, f = (i / P) % sl, e = i / (P * sl);
      __pipeline_memcpy_async(fd + (p * sl + e) * sl + f, ph + i, sizeof(T));
    }
  };

  async_copy(Wb, Ws + z * S * (i64)nW, nW);                   // W_1
  stage_step(0);
  __pipeline_commit();
  if (!TV)
    for (int i = tid; i < nP; i += NT) Ps[i] = Pyy[i];
  for (int i = tid; i < nSp; i += NT) {                        // pads stay 0
    const int e = i / sE, c = i - e * sE;
    Sb[i] = c < DLB ? Sinit[z * nS + e * DLB + c] : T(0);
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
    tile_gemm<NT, T, 2, 10, 1, false>(Sb, Lc, t1, g1);          // t1 = S . L_t
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
    tile_gemm<NT, T, 4, 5, 2, false>(t1, Bp, t2, g2);          // t2 = t1 . Bp
    __pipeline_wait_prior(1);                                  // W_{t+1}
    __syncthreads();
    if (last) {                                                // N = t2 . one-hot
      // a thread a row: its 100-225 entries cost the block less here than
      // a warp a row's reductions (timed in turns against the parent)
      for (int w = tid; w < sl * P; w += NT)
        onehot_row(t2 + w % P * nS + w / P * DLB, DLB, No + w * sr, sr);
    } else {
      tile_gemm<NT, T, 4, 5, 4, false>(t2, Wt1, No, gn);       // N = t2 . W_{t+1}
    }
    tile_gemm<NT, T, 2, 5, 1, false>(Fc, t2, Sb, gs);          // S2 = Phi . t2
    __syncthreads();
    // max-abs of S2 with the _safe_scale guard: per-warp partials, then
    // every thread folds the partials itself (one barrier)
    double mx = 0.0;
    int bad = 0;
    for (int i = tid; i < nSp; i += NT) {
      const double v = (double)Sb[i];
      if (!isfinite(v)) bad = 1; else mx = fmax(mx, fabs(v));
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
    for (int w = 0; w < NWARP; ++w) { mx = fmax(mx, red_m[w]); bad |= red_b[w]; }
    const T sc = (bad || !(mx > 0.0)) ? T(1) : T(mx);
    for (int i = tid; i < nSp; i += NT) Sb[i] = Sb[i] / sc;
    for (int i = tid; i < nM; i += NT) Ms[row * nM + i] = Mo[i];
    for (int i = tid; i < nN; i += NT) Ns[row * nN + i] = No[i];
  }
}


// The launcher: returns cudaGetLastError() (or the error of the
// shared-memory attribute call) as an int, and cudaErrorInvalidValue for a
// shape (or a pyy_step, 0 or not) other than the one this library was built
// for.
extern "C" int merge_f_staged(const void* L, const i64* sL, const void* B,
                              const i64* sB, const void* Pyy,
                              long long pyy_step, const void* Phi,
                              const void* Ws, const void* Sinit, void* Ns,
                              void* Ms, int Bn, int S, int DL, int DB, int Y,
                              int q, int sr, int sl, long long smem,
                              void* stream) {
  if (DL != MF_DL || DB != MF_DB || Y != MF_Y || q != MF_Q || sr != MF_SR ||
      sl != MF_SL || (pyy_step != 0) != TV)
    return (int)cudaErrorInvalidValue;
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  int threads = NT;
  int e = prepare(merge_f_staged_kernel, (size_t)smem, &threads);
  if (e) return e;
  if (threads != NT) return (int)cudaErrorInvalidConfiguration;
  merge_f_staged_kernel<<<Bn, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)L, a, (const T*)B, b, (const T*)Pyy, (i64)pyy_step,
      (const T*)Phi, (const T*)Ws, (const T*)Sinit, (T*)Ns, (T*)Ms, S);
  return (int)cudaGetLastError();
}
