// STTA sketch scans for Hopper (sm_90a): the time-scan kernels of the
// sketch sweep, written by hand in CUDA C++.  Two more merge F kernels,
// merge_f_staged.cu and merge_f_cluster.cu, a merge W kernel,
// merge_w_staged.cu, and the MPEM3 W and F kernels of mpem3_staged.cu are
// built once per shape.
//
// Replaces the Pallas TPU kernels of matrixproductbp_tpu/ops/fused_stta.py:
//   merge_w_kernel  <- _merge_wstep_kernel (fused_stta.py:231, grid wrapper _merge_wscan :359)
//   merge_f_kernel  <- _merge_fstep_kernel (:281) and _merge_fstep_kernel_lean (:382),
//                      grid wrapper _merge_fscan (:466); it covers both bodies.
//                      The wrapper (fused_stta.py::merge_f_geometry) runs it
//                      only where neither merge_f_staged.cu's kernel (f32
//                      sketch merges up to D=15) nor merge_f_cluster.cu's
//                      (from D=16 to D=20) fits
//   mpem3_w_kernel  <- _mpem3_wstep_kernel (:508, grid wrapper _mpem3_wscan :605)
//   mpem3_f_kernel  <- _mpem3_fstep_kernel (:545, grid wrapper _mpem3_fscan :628)
//                      The wrappers (fused_stta.py::mpem3_geometry) run these
//                      two only where mpem3_staged.cu's kernels do not take
//                      the shape: f64, strided B_t and misfits
// Their plain versions are matrixproductbp_tpu_torch/ops/stta.py::*_plain.
//
// What bounds them.  Each kernel is a sequential loop over S = T1-1 time
// steps of small dependent contractions over one instance (bond <= ~24,
// y/x <= 4, sketch <= ~24).  Per instance-step the work is ~0.3-0.7 MFLOP
// (merges) or ~0.02-0.08 MFLOP (MPEM3) against a few KB of streamed input:
// the merges are bound by operations, the MPEM3 scans by bytes (fp32 peaks).
// In practice both are bound by shared-memory operand traffic and by the
// block barriers between dependent contractions.  Counted for merge F at
// D=10 (tools/model_merge_f_smem.py, a CPU model of the warp-wide loads):
// merge_f_kernel issues ~18,000 shared-memory wavefronts per instance-step,
// with 1.25-1.9x bank conflicts in every product, against ~26k SM-cycles
// measured per instance-step.
//
// Design.  On the TPU 128 instances rode the lanes and the grid's sequential
// axis carried W/S in VMEM.  Here one thread block owns one instance and the
// whole time loop inside one launch: the carry (W or S) lives in shared memory
// across steps, and each step stages its streamed operands (L_t/B_t by the
// caller's strides, so permuted views need no copy; the shared Th_t / Phi_t /
// Psi_t, which stay in L2 across blocks) into shared memory, transposed where
// that makes a contraction a plain strided matrix product.  Every contraction
// is then one call of block_gemm: a batched small GEMM whose threads each
// own a 2x2 register tile of outputs (one shared-memory load per FMA, half
// of the naive two).  The per-instance max-abs rescale is a block reduction
// with the _safe_scale guard: a zero or non-finite max gives scale 1.  The
// grid is the instance count (4096-12288 at the bench shape).  Plain FMAs
// only: wgmma, TMA and packing instances into tensor-core tiles are later
// work.
//
// merge_f_staged.cu goes further for the shapes whose buffers fit: W_t and
// W_{t+1} are staged by cp.async into two rotating buffers (merge_f_kernel
// reads them from global memory inside its k-loops), and so are L_t, B_t and
// Phi_t, a step ahead; every contraction of a step is one product over all
// (y,x) pairs (5 block barriers a step, not 17); the products use 20-output
// register tiles (9-12 shared loads per 20 FMAs, not 20) and split their K
// sum over lanes where the output is small; S and t1 rows are padded to odd
// strides: ~6,400 wavefronts per instance-step at D=10 by the same count.
//
// Shared memory per block (elements of T; the wrapper computes the same sums,
// fused_stta.py::_smem_*, and refuses shapes over 227 KB):
//   merge W : 2*DL*DB*sr (carry, accumulator) + DL^2*Y*q + DB^2*Y*q (L_t, B_t)
//             + sr^2*Y^2*q (Th_t) + 2*DB*DL*Y*sr (t1, u for one x).  The x leg
//             is diagonal until the last sum, so t1/u are held one x at a time.
//             D=20, f32, Y=q=2, sr=20: 54400 floats = 212.5 KiB.
//   merge F : 2*sl*DL*DB (carry S, accumulator S2) + sl*DL*DB*Y (t1 for one x)
//             + sl*DL*DB (t2 for one (y,x), as the lean body) + DL^2*Y*q
//             + DB^2*Y*q + DB^2*Y (B_t premixed with prob_yy) + sl^2*Y*q
//             (Phi_t) + Y^3*q.  D=20, f32, sl=24: 54320 floats = 212.2 KiB.
//             W_t and W_{t+1} are read from global memory.
//   merge F, staged: in merge_f_staged.cu; 73.7 KiB at D=10, f32.
//   merge F, cluster: in merge_f_cluster.cu; 217.5 KiB a block (two blocks
//             an instance) at D=20, f32.
//   MPEM3 W : 2*Db*qi*sr + Db^2*qi*qj*qi + sr^2*qi*qj + Db*qi*qj*sr
//             (fused_stta.py::_smem_mpem3_w); D=20, f32, qj=2: 31.25 KiB
//             (18.75 KiB at qj=1).
//   MPEM3 F : 2*sl*Db*qi + Db^2*qi*qj*qi + sl^2*qi*qj + sl*Db*qi*qj*qi
//             (_smem_mpem3_f); D=20, f32, qj=2, sl=24: 44 KiB (25.75 KiB at
//             qj=1).  W_t and W_{t+1} are read from global memory.
//   MPEM3 W/F, staged: in mpem3_staged.cu.
// f64 instantiations exist so that tests hold each kernel to its plain version
// at 1e-10; they fit only at small shapes.

#include "stta_common.cuh"

// A 5-axis slab copied into shared memory: the axes listed from the source's
// slowest to its fastest stride, so that consecutive threads read
// consecutive source addresses; dst gives each axis' shared-memory stride.
struct Stage5 { int dim[5]; i64 src[5]; int dst[5]; };

// Every thread of the block computes 2x2 output tiles; rows and columns past
// M, N are loaded from the last valid index and never stored.
template <typename T, bool ACC>
__device__ void block_gemm(const T* __restrict__ A, const T* __restrict__ B,
                           T* __restrict__ C, const Gemm& g) {
  const int mt = (g.M + 1) >> 1, nt = (g.N + 1) >> 1;
  const int tasks = g.nb1 * g.nb2 * mt * nt;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    int r = t;
    const int tj = r % nt; r /= nt;
    const int ti = r % mt; r /= mt;
    const int b2 = r % g.nb2;
    const int b1 = r / g.nb2;
    const int i0 = 2 * ti, j0 = 2 * tj;
    const T* a = A + b1 * g.ab1 + b2 * g.ab2;
    const T* b = B + b1 * g.bb1 + b2 * g.bb2;
    const int ia0 = i0 * g.ai, ia1 = min(i0 + 1, g.M - 1) * g.ai;
    const int jb0 = j0 * g.bj, jb1 = min(j0 + 1, g.N - 1) * g.bj;
    T c00 = T(0), c01 = T(0), c10 = T(0), c11 = T(0);
    for (int k = 0; k < g.K; ++k) {
      const T* ak = a + k * g.ak;
      const T* bk = b + k * g.bk;
      const T a0 = ak[ia0], a1 = ak[ia1], x0 = bk[jb0], x1 = bk[jb1];
      c00 += a0 * x0;
      c01 += a0 * x1;
      c10 += a1 * x0;
      c11 += a1 * x1;
    }
    T* c = C + b1 * g.cb1 + b2 * g.cb2 + i0 * g.ci + j0 * g.cj;
    const bool i_ok = i0 + 1 < g.M, j_ok = j0 + 1 < g.N;
    if (ACC) {
      c[0] += c00;
      if (j_ok) c[g.cj] += c01;
      if (i_ok) c[g.ci] += c10;
      if (i_ok && j_ok) c[g.ci + g.cj] += c11;
    } else {
      c[0] = c00;
      if (j_ok) c[g.cj] = c01;
      if (i_ok) c[g.ci] = c10;
      if (i_ok && j_ok) c[g.ci + g.cj] = c11;
    }
  }
}

// Per-block max-abs scale of x[0..n) with the _safe_scale guard.  Every
// thread of the block must call it; it synchronises on entry and exit.
template <typename T>
__device__ T block_scale(const T* x, int n) {
  __shared__ double red_m[32];
  __shared__ int red_b[32];
  double m = 0.0;
  int bad = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double v = (double)x[i];
    if (!isfinite(v)) bad = 1; else m = fmax(m, fabs(v));
  }
  for (int o = 16; o > 0; o >>= 1) {
    m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) { red_m[w] = m; red_b[w] = bad; }
  __syncthreads();
  if (w == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    m = l < nw ? red_m[l] : 0.0;
    bad = l < nw ? red_b[l] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
      bad |= __shfl_xor_sync(0xffffffffu, bad, o);
    }
    if (l == 0) { red_m[0] = m; red_b[0] = bad; }
  }
  __syncthreads();
  const double r = red_m[0];
  const int b = red_b[0];
  __syncthreads();
  return (b || !(r > 0.0)) ? T(1) : T(r);
}

// Stage one time row of a 4-D slab X[a,b,c,d] (strides s[2..5]) into dst.
template <typename T>
__device__ void stage4(T* dst, const T* src, const i64* s, int A, int B, int C,
                       int D) {
  const int n = A * B * C * D;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = i;
    const int d = r % D; r /= D;
    const int c = r % C; r /= C;
    const int b = r % B;
    const int a = r / B;
    dst[i] = src[a * s[2] + b * s[3] + c * s[4] + d * s[5]];
  }
}

template <typename T>
__device__ void stage5(T* dst, const T* src, const Stage5& g) {
  const int n = g.dim[0] * g.dim[1] * g.dim[2] * g.dim[3] * g.dim[4];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = i;
    i64 so = 0;
    int d = 0;
#pragma unroll
    for (int p = 4; p >= 0; --p) {
      const int c = r % g.dim[p];
      r /= g.dim[p];
      so += c * g.src[p];
      d += c * g.dst[p];
    }
    dst[d] = src[so];
  }
}

// Copy a contiguous [P0][P1][P2][P3] shared operand into shared memory with
// axis strides d0..d3 (a transposition).
template <typename T>
__device__ void stage_t4(T* dst, const T* src, int P0, int P1, int P2, int P3,
                         int d0, int d1, int d2, int d3) {
  const int n = P0 * P1 * P2 * P3;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = i;
    const int c3 = r % P3; r /= P3;
    const int c2 = r % P2; r /= P2;
    const int c1 = r % P1;
    const int c0 = r / P1;
    dst[c0 * d0 + c1 * d1 + c2 * d2 + c3 * d3] = src[i];
  }
}

template <typename T>
__device__ void copy_block(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// merge W: reverse sketch scan of the cavity merge.
//   W_t[k,m,a] = sum_{n,u,x} L_t[k,n,u,x] sum_{v,b} Th_t[a,b,u,v,x]
//                sum_j B_t[m,j,v,x] W_{t+1}[n,j,b]
// L [Bn,S,DL,DL,Y,q] and B [Bn,S,DB,DB,Y,q] by strides; Th [S,sr,sr,Y,Y,q];
// Ws [Bn,S,DL,DB,sr] with Ws[:,s] = W_{s+1}; W_{T1} is the one-hot (0,0,0).
// Shared layouts: W, W2 [l][n][b]; Tt [x][u][v][b][a]; t1 [m][l][v][b];
// u [m][l][uu][a].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void merge_w_kernel(const T* __restrict__ L, Str6 sL,
                               const T* __restrict__ Bm, Str6 sB,
                               const T* __restrict__ Th, T* __restrict__ Ws,
                               int S, int DL, int DB, int Y, int q, int sr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nW = DL * DB * sr, nL = DL * DL * Y * q, nB = DB * DB * Y * q;
  const int nTh = sr * sr * Y * Y * q, nT1 = DB * DL * Y * sr;
  T* Wc = sm;
  T* W2 = Wc + nW;
  T* Ls = W2 + nW;
  T* Bs = Ls + nL;
  T* Tt = Bs + nB;
  T* t1 = Tt + nTh;
  T* u = t1 + nT1;
  const i64 z = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Gemm ga_ = {DB, sr, DB, DL, Y,   DB * Y * q, Y * q, 0, q,
                   sr, 1, DB * sr, 0,   DL * Y * sr, 1, Y * sr, sr};
  const Gemm gb_ = {DB * DL, sr, Y * sr, Y, 1,   Y * sr, 1, 0, 0,
                   sr, 1, Y * sr * sr, 0,   Y * sr, 1, sr, 0};
  const Gemm gc_ = {DL, sr, DL * Y, DB, 1,   DL * Y * q, q, 0, 0,
                   sr, 1, DL * Y * sr, 0,   DB * sr, 1, sr, 0};
  __shared__ Gemm gd[3];
  if (tid == 0) {
    gd[0] = ga_;
    gd[1] = gb_;
    gd[2] = gc_;
  }
  const Gemm& ga = gd[0];
  const Gemm& gb = gd[1];
  const Gemm& gc = gd[2];

  for (int i = tid; i < nW; i += nt) Wc[i] = (i == 0) ? T(1) : T(0);
  for (int s = S - 1; s >= 0; --s) {
    stage4(Ls, L + z * sL.s[0] + s * sL.s[1], sL.s, DL, DL, Y, q);
    stage4(Bs, Bm + z * sB.s[0] + s * sB.s[1], sB.s, DB, DB, Y, q);
    // Th_t[a][b][(u,v)][x] -> Tt[x][(u,v)][b][a]
    stage_t4(Tt, Th + (i64)s * nTh, sr, sr, Y * Y, q, 1, sr, sr * sr,
             Y * Y * sr * sr);
    for (int i = tid; i < nW; i += nt) W2[i] = T(0);
    __syncthreads();
    for (int x = 0; x < q; ++x) {
      block_gemm<T, false>(Bs + x, Wc, t1, ga);        // t1 = B_t . W
      __syncthreads();
      block_gemm<T, false>(t1, Tt + x * Y * Y * sr * sr, u, gb);   // u = t1 . Th
      __syncthreads();
      block_gemm<T, true>(Ls + x, u, W2, gc);          // W2 += L_t . u
      __syncthreads();
    }
    const T sc = block_scale(W2, nW);
    T* out = Ws + (z * S + s) * (i64)nW;
    for (int i = tid; i < nW; i += nt) {
      const T w = W2[i] / sc;
      Wc[i] = w;
      out[i] = w;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// merge F: forward scan of the cavity merge.  Step s (time t = s+1):
//   M[e,a]     = sum_{k,m} S[e,k,m] W_t[k,m,a]
//   t1[e,n,m,u]= sum_k S[e,k,m] L_t[k,n,u,x]                (one x at a time)
//   Bp[m,u,j]  = sum_v Pyy[y,u,v,x] B_t[m,j,v,x]            (one (y,x))
//   t2[e,n,j]  = sum_{m,u} t1[e,n,m,u] Bp[m,u,j]
//   N[e,y,x,b] = sum_{n,j} t2[e,n,j] W_{t+1}[n,j,b]          (one-hot at s=S-1)
//   S2[f,n,j] += sum_e Phi_t[e,f,y,x] t2[e,n,j];   S <- S2 / scale
// Pyy is step s's table at Pyy + s * pyy_step (pyy_step = Y^3*q for
// time-varying tables, copied in with the step's other inputs; 0 for one
// shared table, copied in once).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void merge_f_kernel(const T* __restrict__ L, Str6 sL,
                               const T* __restrict__ Bm, Str6 sB,
                               const T* __restrict__ Pyy, i64 pyy_step,
                               const T* __restrict__ Phi,
                               const T* __restrict__ Ws,
                               const T* __restrict__ Sinit,
                               T* __restrict__ Ns, T* __restrict__ Ms,
                               int S, int DL, int DB, int Y, int q, int sr,
                               int sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int DLB = DL * DB, nS = sl * DLB, nW = DLB * sr;
  const int nL = DL * DL * Y * q, nB = DB * DB * Y * q, nBp = DB * DB * Y;
  const int nF = sl * sl * Y * q, nP = Y * Y * Y * q;
  T* Sc = sm;
  T* S2 = Sc + nS;
  T* t1 = S2 + nS;
  T* t2 = t1 + nS * Y;
  T* Ls = t2 + nS;
  T* Bs = Ls + nL;
  T* Bp = Bs + nB;
  T* Fs = Bp + nBp;
  T* Ps = Fs + nF;
  const i64 z = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Gemm gm_ = {sl, sr, DLB, 1, 1,   DLB, 1, 0, 0,
                   sr, 1, 0, 0,   sr, 1, 0, 0};
  const Gemm g1_ = {sl, DL, DL, DB, Y,   DLB, DB, 1, 0,
                   DL * Y * q, Y * q, 0, q,   DLB * Y, DB * Y, Y, 1};
  const Gemm g2_ = {sl * DL, DB, DB * Y, 1, 1,   DB * Y, 1, 0, 0,
                   DB, 1, 0, 0,   DB, 1, 0, 0};
  const Gemm gn_ = {sl, sr, DLB, 1, 1,   DLB, 1, 0, 0,
                   sr, 1, 0, 0,   Y * q * sr, 1, 0, 0};
  const Gemm gs_ = {sl, DLB, sl, 1, 1,   Y * q, sl * Y * q, 0, 0,
                   DLB, 1, 0, 0,   DLB, 1, 0, 0};
  __shared__ Gemm gd[5];
  if (tid == 0) {
    gd[0] = gm_;
    gd[1] = g1_;
    gd[2] = g2_;
    gd[3] = gn_;
    gd[4] = gs_;
  }
  const Gemm& gm = gd[0];
  const Gemm& g1 = gd[1];
  const Gemm& g2 = gd[2];
  const Gemm& gn = gd[3];
  const Gemm& gs = gd[4];


  copy_block(Ps, Pyy, nP);
  copy_block(Sc, Sinit + z * (i64)nS, nS);
  for (int s = 0; s < S; ++s) {
    // every reader of the last step's Ps has passed its final barrier
    if (pyy_step && s) copy_block(Ps, Pyy + s * pyy_step, nP);
    stage4(Ls, L + z * sL.s[0] + s * sL.s[1], sL.s, DL, DL, Y, q);
    stage4(Bs, Bm + z * sB.s[0] + s * sB.s[1], sB.s, DB, DB, Y, q);
    copy_block(Fs, Phi + (i64)s * nF, nF);
    for (int i = tid; i < nS; i += nt) S2[i] = T(0);
    __syncthreads();
    const i64 row = z * S + s;
    const T* Wt = Ws + row * nW;
    const bool last = (s == S - 1);
    const T* Wt1 = Wt + nW;
    block_gemm<T, false>(Sc, Wt, Ms + row * sl * sr, gm);      // M = S . W_t
    for (int x = 0; x < q; ++x) {
      block_gemm<T, false>(Sc, Ls + x, t1, g1);                // t1 = S . L_t
      for (int y = 0; y < Y; ++y) {
        for (int i = tid; i < nBp; i += nt) {                  // Bp[m][uu][j]
          int r = i;
          const int j = r % DB; r /= DB;
          const int uu = r % Y;
          const int m = r / Y;
          T acc = T(0);
          for (int v = 0; v < Y; ++v)
            acc += Ps[((y * Y + uu) * Y + v) * q + x] *
                   Bs[((m * DB + j) * Y + v) * q + x];
          Bp[i] = acc;
        }
        __syncthreads();
        block_gemm<T, false>(t1, Bp, t2, g2);                  // t2 = t1 . Bp
        __syncthreads();
        T* Nyx = Ns + ((row * sl * Y + y) * q + x) * sr;
        if (last) {                                            // N = t2 . one-hot
          onehot_rows<T>(sl, DLB, sr, [&](int e) { return t2 + e * DLB; },
                         [&](int e) { return Nyx + e * Y * q * sr; });
        } else {
          block_gemm<T, false>(t2, Wt1, Nyx, gn);              // N = t2 . W_{t+1}
        }
        block_gemm<T, true>(Fs + y * q + x, t2, S2, gs);       // S2 += Phi . t2
        __syncthreads();
      }
    }
    const T sc = block_scale(S2, nS);
    for (int i = tid; i < nS; i += nt) Sc[i] = S2[i] / sc;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// MPEM3 W: W_t[m,i,b] = sum_{j,c} Psi_t[b,c,i,j] sum_{n,r} B_t[m,n,i,j,r] W_{t+1}[n,r,c]
// B [Bn,S,Db,Db,qi,qj,qi] by strides; Psi [S,sr,sr,qi,qj]; Ws [Bn,S,Db,qi,sr].
// Shared layouts: Bs [i][j][m][n][r]; Pp [i][j][c][b]; t1 [m][i][j][c].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void mpem3_w_kernel(const T* __restrict__ Bm, i64 sz, i64 st,
                               Stage5 gB, const T* __restrict__ Psi,
                               T* __restrict__ Ws, int S, int Db, int qi,
                               int qj, int sr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nW = Db * qi * sr, nB = Db * Db * qi * qj * qi;
  const int nP = sr * sr * qi * qj, nT1 = Db * qi * qj * sr;
  T* Wc = sm;
  T* W2 = Wc + nW;
  T* Bs = W2 + nW;
  T* Pp = Bs + nB;
  T* t1 = Pp + nP;
  const i64 z = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int DDq = Db * Db * qi;
  const Gemm g1_ = {Db, sr, Db * qi, qi, qj,   Db * qi, 1, qj * DDq, DDq,
                   sr, 1, 0, 0,   qi * qj * sr, 1, qj * sr, sr};
  const Gemm g2_ = {Db, sr, qj * sr, qi, 1,   qi * qj * sr, 1, qj * sr, 0,
                   sr, 1, qj * sr * sr, 0,   qi * sr, 1, sr, 0};
  __shared__ Gemm gd[2];
  if (tid == 0) {
    gd[0] = g1_;
    gd[1] = g2_;
  }
  const Gemm& g1 = gd[0];
  const Gemm& g2 = gd[1];


  for (int i = tid; i < nW; i += nt) Wc[i] = (i == 0) ? T(1) : T(0);
  for (int s = S - 1; s >= 0; --s) {
    stage5(Bs, Bm + z * sz + s * st, gB);
    // Psi_t[b][c][i][j] -> Pp[i][j][c][b]
    stage_t4(Pp, Psi + (i64)s * nP, sr, sr, qi, qj, 1, sr, qj * sr * sr,
             sr * sr);
    __syncthreads();
    block_gemm<T, false>(Bs, Wc, t1, g1);                      // t1 = B_t . W
    __syncthreads();
    block_gemm<T, false>(t1, Pp, W2, g2);                      // W2 = t1 . Psi
    __syncthreads();
    const T sc = block_scale(W2, nW);
    T* out = Ws + (z * S + s) * (i64)nW;
    for (int i = tid; i < nW; i += nt) {
      const T w = W2[i] / sc;
      Wc[i] = w;
      out[i] = w;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// MPEM3 F: t1[e,n,i,j,r] = sum_m S[e,m,i] B_t[m,n,i,j,r];
//   M[e,b] = sum_{m,i} S[e,m,i] W_t[m,i,b];
//   N[e,i,j,b] = sum_{n,r} t1[e,n,i,j,r] W_{t+1}[n,r,b]  (one-hot at s=S-1);
//   S2[f,n,r] = sum_{e,i,j} t1[e,n,i,j,r] Phi_t[e,f,i,j];  S <- S2 / scale
// Shared layouts: Bs [i][j][m][n][r]; Fs [i][j][e][f]; t1 [i][j][e][n][r].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void mpem3_f_kernel(const T* __restrict__ Bm, i64 sz, i64 st,
                               Stage5 gB, const T* __restrict__ Phi,
                               const T* __restrict__ Ws,
                               const T* __restrict__ Sinit,
                               T* __restrict__ Ns, T* __restrict__ Ms,
                               int S, int Db, int qi, int qj, int sr, int sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nMI = Db * qi, nS = sl * nMI, nW = nMI * sr;
  const int nB = Db * Db * qi * qj * qi, nF = sl * sl * qi * qj;
  const int nN = sl * qi * qj * sr;
  T* Sc = sm;
  T* S2 = Sc + nS;
  T* Bs = S2 + nS;
  T* Fs = Bs + nB;
  T* t1 = Fs + nF;
  const i64 z = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int DDq = Db * Db * qi;
  const Gemm gm_ = {sl, sr, nMI, 1, 1,   nMI, 1, 0, 0,
                   sr, 1, 0, 0,   sr, 1, 0, 0};
  const Gemm g1_ = {sl, nMI, Db, qi, qj,   nMI, qi, 1, 0,
                   nMI, 1, qj * DDq, DDq,   nMI, 1, qj * nS, nS};
  const Gemm gn_ = {sl, sr, nMI, qi, qj,   nMI, 1, qj * nS, nS,
                   sr, 1, 0, 0,   qi * qj * sr, 1, qj * sr, sr};
  const Gemm gs_ = {sl, nMI, qi * qj * sl, 1, 1,   1, sl, 0, 0,
                   nMI, 1, 0, 0,   nMI, 1, 0, 0};
  __shared__ Gemm gd[4];
  if (tid == 0) {
    gd[0] = gm_;
    gd[1] = g1_;
    gd[2] = gn_;
    gd[3] = gs_;
  }
  const Gemm& gm = gd[0];
  const Gemm& g1 = gd[1];
  const Gemm& gn = gd[2];
  const Gemm& gs = gd[3];


  copy_block(Sc, Sinit + z * (i64)nS, nS);
  for (int s = 0; s < S; ++s) {
    stage5(Bs, Bm + z * sz + s * st, gB);
    // Phi_t[e][f][i][j] -> Fs[i][j][e][f]
    stage_t4(Fs, Phi + (i64)s * nF, sl, sl, qi, qj, sl, 1, qj * sl * sl,
             sl * sl);
    __syncthreads();
    const i64 row = z * S + s;
    const T* Wt = Ws + row * nW;
    const bool last = (s == S - 1);
    const T* Wt1 = Wt + nW;
    block_gemm<T, false>(Sc, Wt, Ms + row * sl * sr, gm);      // M = S . W_t
    block_gemm<T, false>(Sc, Bs, t1, g1);                      // t1 = S . B_t
    __syncthreads();
    if (last) {                                                // N = t1 . one-hot
      const int P = qi * qj;
      onehot_rows<T>(sl * P, nMI, sr,
                     [&](int w) { return t1 + w % P * nS + w / P * nMI; },
                     [&](int w) { return Ns + row * nN + w * sr; });
    } else {
      block_gemm<T, false>(t1, Wt1, Ns + row * nN, gn);        // N = t1 . W_{t+1}
    }
    block_gemm<T, false>(Fs, t1, S2, gs);                      // S2 = Phi . t1
    __syncthreads();
    const T sc = block_scale(S2, nS);
    for (int i = tid; i < nS; i += nt) Sc[i] = S2[i] / sc;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launchers: dtype 0 = float32, 1 = float64.  Each returns cudaGetLastError()
// (or the error of the shared-memory attribute call) as an int.
// ---------------------------------------------------------------------------
// B_t [m,n,i,j,r] (strides sB[2..6]) staged as [i][j][m][n][r], read in the
// order of the source's strides.
static Stage5 mpem3_stage(const i64* sB, int Db, int qi, int qj) {
  const int dims[5] = {Db, Db, qi, qj, qi};
  const int dst[5] = {Db * qi, qi, qj * Db * Db * qi, Db * Db * qi, 1};
  int order[5] = {0, 1, 2, 3, 4};
  for (int a = 1; a < 5; ++a)               // stable sort, largest stride first
    for (int b = a; b > 0 && sB[2 + order[b]] > sB[2 + order[b - 1]]; --b) {
      const int tmp = order[b]; order[b] = order[b - 1]; order[b - 1] = tmp;
    }
  Stage5 g;
  for (int p = 0; p < 5; ++p) {
    g.dim[p] = dims[order[p]];
    g.src[p] = sB[2 + order[p]];
    g.dst[p] = dst[order[p]];
  }
  return g;
}

template <typename T>
static int merge_w_launch(const void* L, const i64* sL, const void* B,
                          const i64* sB, const void* Th, void* Ws, int Bn,
                          int S, int DL, int DB, int Y, int q, int sr,
                          int threads, size_t smem, cudaStream_t st) {
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  int e = prepare(merge_w_kernel<T>, smem, &threads);
  if (e) return e;
  merge_w_kernel<T><<<Bn, threads, smem, st>>>(
      (const T*)L, a, (const T*)B, b, (const T*)Th, (T*)Ws, S, DL, DB, Y, q,
      sr);
  return (int)cudaGetLastError();
}

template <typename T>
static int merge_f_launch(const void* L, const i64* sL, const void* B,
                          const i64* sB, const void* Pyy, i64 pyy_step,
                          const void* Phi,
                          const void* Ws, const void* Sinit, void* Ns,
                          void* Ms, int Bn, int S, int DL, int DB, int Y,
                          int q, int sr, int sl, int threads, size_t smem,
                          cudaStream_t st) {
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  int e = prepare(merge_f_kernel<T>, smem, &threads);
  if (e) return e;
  merge_f_kernel<T><<<Bn, threads, smem, st>>>(
      (const T*)L, a, (const T*)B, b, (const T*)Pyy, pyy_step,
      (const T*)Phi, (const T*)Ws, (const T*)Sinit, (T*)Ns, (T*)Ms, S, DL,
      DB, Y, q, sr, sl);
  return (int)cudaGetLastError();
}

template <typename T>
static int mpem3_w_launch(const void* B, const i64* sB, const void* Psi,
                          void* Ws, int Bn, int S, int Db, int qi, int qj,
                          int sr, int threads, size_t smem, cudaStream_t st) {
  int e = prepare(mpem3_w_kernel<T>, smem, &threads);
  if (e) return e;
  mpem3_w_kernel<T><<<Bn, threads, smem, st>>>(
      (const T*)B, sB[0], sB[1], mpem3_stage(sB, Db, qi, qj), (const T*)Psi,
      (T*)Ws, S, Db, qi, qj, sr);
  return (int)cudaGetLastError();
}

template <typename T>
static int mpem3_f_launch(const void* B, const i64* sB, const void* Phi,
                          const void* Ws, const void* Sinit, void* Ns,
                          void* Ms, int Bn, int S, int Db, int qi, int qj,
                          int sr, int sl, int threads, size_t smem,
                          cudaStream_t st) {
  int e = prepare(mpem3_f_kernel<T>, smem, &threads);
  if (e) return e;
  mpem3_f_kernel<T><<<Bn, threads, smem, st>>>(
      (const T*)B, sB[0], sB[1], mpem3_stage(sB, Db, qi, qj), (const T*)Phi,
      (const T*)Ws, (const T*)Sinit, (T*)Ns, (T*)Ms, S, Db, qi, qj, sr, sl);
  return (int)cudaGetLastError();
}

extern "C" {

int stta_merge_w(int dtype, const void* L, const i64* sL, const void* B,
                 const i64* sB, const void* Th, void* Ws, int Bn, int S,
                 int DL, int DB, int Y, int q, int sr, int threads,
                 long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
      ? merge_w_launch<float>(L, sL, B, sB, Th, Ws, Bn, S, DL, DB, Y, q, sr,
                              threads, (size_t)smem, st)
      : merge_w_launch<double>(L, sL, B, sB, Th, Ws, Bn, S, DL, DB, Y, q, sr,
                               threads, (size_t)smem, st);
}

int stta_merge_f(int dtype, const void* L, const i64* sL, const void* B,
                 const i64* sB, const void* Pyy, long long pyy_step,
                 const void* Phi,
                 const void* Ws, const void* Sinit, void* Ns, void* Ms,
                 int Bn, int S, int DL, int DB, int Y, int q, int sr, int sl,
                 int threads, long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
      ? merge_f_launch<float>(L, sL, B, sB, Pyy, pyy_step, Phi, Ws, Sinit,
                              Ns, Ms, Bn,
                              S, DL, DB, Y, q, sr, sl, threads, (size_t)smem,
                              st)
      : merge_f_launch<double>(L, sL, B, sB, Pyy, pyy_step, Phi, Ws, Sinit,
                               Ns, Ms, Bn,
                               S, DL, DB, Y, q, sr, sl, threads, (size_t)smem,
                               st);
}

int stta_mpem3_w(int dtype, const void* B, const i64* sB, const void* Psi,
                 void* Ws, int Bn, int S, int Db, int qi, int qj, int sr,
                 int threads, long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
      ? mpem3_w_launch<float>(B, sB, Psi, Ws, Bn, S, Db, qi, qj, sr, threads,
                              (size_t)smem, st)
      : mpem3_w_launch<double>(B, sB, Psi, Ws, Bn, S, Db, qi, qj, sr, threads,
                               (size_t)smem, st);
}

int stta_mpem3_f(int dtype, const void* B, const i64* sB, const void* Phi,
                 const void* Ws, const void* Sinit, void* Ns, void* Ms,
                 int Bn, int S, int Db, int qi, int qj, int sr, int sl,
                 int threads, long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
      ? mpem3_f_launch<float>(B, sB, Phi, Ws, Sinit, Ns, Ms, Bn, S, Db, qi,
                              qj, sr, sl, threads, (size_t)smem, st)
      : mpem3_f_launch<double>(B, sB, Phi, Ws, Sinit, Ns, Ms, Bn, S, Db, qi,
                               qj, sr, sl, threads, (size_t)smem, st);
}

}  // extern "C"
