// Streamed merge scans for Hopper (sm_90a): merge W and merge F at every
// shape, their shared memory fixed whatever the bond, sketch or y-axis.
//
// Replaces the Pallas TPU kernels of matrixproductbp_tpu/ops/fused_stta.py:
//   merge_w_streamed <- _merge_wstep_kernel (fused_stta.py:231, grid wrapper
//                       _merge_wscan :359)
//   merge_f_streamed <- _merge_fstep_kernel (:281) and
//                       _merge_fstep_kernel_lean (:382), grid wrapper
//                       _merge_fscan (:466)
// at the shapes none of the other merge kernels takes: the wrapper
// (fused_stta.py::merge_f_geometry / merge_w_geometry) picks them last,
// where the buffers of merge_f_staged.cu, merge_f_cluster.cu,
// merge_w_staged.cu and stta_scans.cu's merge_w_kernel / merge_f_kernel do
// not fit in a block's shared memory (f64 from D=16, f32 Y=2 from D=21,
// the banded Glauber merges from D=11-17 by Y).  Their plain versions are
// matrixproductbp_tpu_torch/ops/stta.py::merge_wscan_plain /
// merge_fscan_plain; they take the same arguments and strides.
//
// What bounds them.  Each instance-step is a chain of dependent products
// whose operands grow as D^4 Y^2 (merge W's u = t1 . Th_t, merge F's
// t2 = t1 . Bp): at D=18, Y=9 ~10 MFMA a step of merge W against ~40 kB
// of streamed input, so both scans are bound by operations (fp32 or fp64
// FMAs off the tensor cores).  In practice they are bound by the
// instructions around the FMAs: each gathered element costs an offset
// lookup and a load, each product tile its offset tables, barriers and
// epilogue, and the padded tiles of these small products (rows and
// columns of 18-400) waste a third of the FMAs.
//
// Design.  One block owns one instance for its whole time loop inside one
// launch, as in every other merge kernel; the grid is persistent (the
// blocks resident on the SMs walk over the instances), so the global
// workspace the wrapper allocates is sized by the blocks, not by the
// instances.  Everything that grows with the shape lives there: merge W's
// t1, u and the step's Th_t transposed (one x at a time), merge F's carry
// S (two buffers, the step's and the next), t1, the Pyy-mixed B_t (Bp)
// and t2 (one x at a time, every y), and a one-hot W that is merge W's
// first carry and merge F's W_{T1} (N's last step is then the full product
// with the one-hot, as the plain scan's).  W_t is read back from the Ws
// output.  Every contraction is one call of tile_product: a product
// C[i, j] (+)= sum_k A[i, k] B[k, j] whose rows, columns and sums are each
// up to two tensor axes read by strides (L_t and B_t straight from the
// caller's views, no copy), computed tile by tile: a TM x TN output tile
// (TM * TN = 4096, TM = 32, 64 or 128 picked per product to waste the
// fewest padded outputs) takes TK = 16 sums a step from shared memory,
// each of the 256 threads keeping a 4 x 4 register tile (neighbouring rows
// and columns, read as 16-byte vectors: two vector loads feed 16 FMAs in
// f32), while the next step's operands are gathered by the products'
// strides into registers (each thread one row of A and one column of B, so
// their offsets are read once a tile), their loads in flight behind the
// products.  So a block's shared memory is the two operand tiles and their
// offset tables: 14.5 kB in f32, 24.5 kB in f64, at every shape.  All
// sizes are run-time arguments: one build per dtype serves every shape.
// Plain FMAs only (no tensor cores, no TMA); the band of the Glauber
// merges is read dense.

#include "stta_common.cuh"

#define MS_NT 256        // threads a block
#define MS_TILE 4096     // outputs of a tile, TM * TN (2^12)
#define MS_SPAN 160      // the most TM + TN (32 + 128)
#define MS_TK 16         // sums a tile takes a step
#define MS_PER (MS_TK * MS_SPAN / MS_NT)   // elements a thread gathers a step
#define MS_TAB (4 * 128 + 4 * MS_TK)       // offset tables (i64)
#define MS_MINB 2        // blocks an SM (fused_stta._STREAMED_BLOCKS_PER_SM)

// One axis of a product: its extent and its strides in the two operands it
// indexes (rows: A and C; columns: B and C; sums: A and B).
struct Ax { int n; i64 s1, s2; };

// C[i, j] (+)= sum_k A[i, k] B[k, j]; each of i, j and k is two axes,
// i = i0 * m1 + i1 (offset i0 * am0 + i1 * am1 in A, i0 * cm0 + i1 * cm1
// in C), and likewise j and k.  TM = 2^lm rows a tile (32, 64 or 128).
// A step of MS_TK sums moves the outer sum index by dq and the inner by dr
// (MS_TK = dq * k1 + dr).
struct Prod {
  int M, N, K, TM, lm;
  int m1, n1, k1, dq, dr;
  i64 am0, am1, cm0, cm1;
  i64 bn0, bn1, cn0, cn1;
  i64 ak0, ak1, bk0, bk1;
};

__device__ __forceinline__ i64 off2(int i, int n1, i64 s0, i64 s1) {
  const int a = i / n1;
  return a * s0 + (i - a * n1) * s1;
}

// Four neighbouring elements of a shared-memory tile row, 16-byte aligned:
// one vector load (two for double).
__device__ __forceinline__ void load4(float (&x)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(double (&x)[4], const double* p) {
  const double2 v = reinterpret_cast<const double2*>(p)[0];
  const double2 w = reinterpret_cast<const double2*>(p)[1];
  x[0] = v.x; x[1] = v.y; x[2] = w.x; x[3] = w.y;
}

// One step's gather into registers.  Thread tid gathers A's elements
// tid + r * MS_NT (r < TM / 16) of its TK x TM tile and B's of its TK x TN
// tile (r < TN / 16): as MS_NT is a multiple of TM and TN, all in one row
// of A (at offset ra, -1 past M) and one column of B (cb), at the sums
// k0a + r * dka and k0b + r * dkb of the step, whose offsets are ka and kb
// (-1 past K).  Zero past the edges.
template <typename T>
__device__ __forceinline__ void gather(T (&v)[MS_PER], const T* A,
                                       const T* B, i64 ra, i64 cb,
                                       const i64* ka, const i64* kb,
                                       int nra, int nrb, int k0a, int dka,
                                       int k0b, int dkb) {
#pragma unroll
  for (int r = 0; r < MS_PER; ++r) {
    T x = T(0);
    if (r < nra) {
      const i64 o = ka[k0a + r * dka];
      if (ra >= 0 && o >= 0) x = A[ra + o];
    } else if (r < nra + nrb) {
      const i64 o = kb[k0b + (r - nra) * dkb];
      if (cb >= 0 && o >= 0) x = B[o + cb];
    }
    v[r] = x;
  }
}

// The product p, by the whole block: every thread calls it.  `tab` holds
// the tile's row and column offsets and two buffers of the sums' offsets;
// `tile` the gathered A (TK x TM) and B (TK x TN).  Each step's operands
// are gathered into registers while the step before is multiplied, then
// stored to the tile.  Synchronises before it starts; the caller
// synchronises before reading C.
template <typename T>
__device__ void tile_product(const Prod& p, const T* __restrict__ A,
                             const T* __restrict__ B, T* C, bool acc,
                             T* tile, i64* tab) {
  constexpr int TK = MS_TK, PER = MS_PER;
  const int TM = p.TM, TN = MS_TILE / TM, lm = p.lm, ln = 12 - lm;
  const int tid = threadIdx.x;
  const int tx = tid & (TN / 4 - 1), ty = tid >> (ln - 2);
  // this thread's share of each step's gather (see gather)
  const int nra = TM / 16, nrb = TN / 16;
  const int k0a = tid >> lm, dka = MS_NT >> lm;
  const int k0b = tid >> ln, dkb = MS_NT >> ln;
  i64* rA = tab;
  i64* rC = tab + 128;
  i64* cB = tab + 256;
  i64* cC = tab + 384;
  i64* kA = tab + 512;
  i64* kB = kA + 2 * TK;
  const T* As = tile;
  const T* Bs = tile + TK * TM;
  const int tm = (p.M + TM - 1) / TM, tn = (p.N + TN - 1) / TN;
  const int nk = (p.K + TK - 1) / TK;
  for (int t = 0; t < tm * tn; ++t) {
    const int i0 = (t / tn) * TM, j0 = (t % tn) * TN;
    __syncthreads();                  // the last tile's readers are done
    for (int i = tid; i < TM; i += MS_NT) {
      const bool ok = i0 + i < p.M;
      rA[i] = ok ? off2(i0 + i, p.m1, p.am0, p.am1) : -1;
      rC[i] = ok ? off2(i0 + i, p.m1, p.cm0, p.cm1) : -1;
    }
    for (int j = tid; j < TN; j += MS_NT) {
      const bool ok = j0 + j < p.N;
      cB[j] = ok ? off2(j0 + j, p.n1, p.bn0, p.bn1) : -1;
      cC[j] = ok ? off2(j0 + j, p.n1, p.cn0, p.cn1) : -1;
    }
    if (tid < 2 * TK) {               // the sums of the first two steps
      kA[tid] = tid < p.K ? off2(tid, p.k1, p.ak0, p.ak1) : -1;
      kB[tid] = tid < p.K ? off2(tid, p.k1, p.bk0, p.bk1) : -1;
    }
    // sum k = kq * k1 + kr that this thread's table entry holds next (the
    // third step's, tid < TK), advanced a step at a time without division
    int kq = (2 * TK + tid) / p.k1, kr = 2 * TK + tid - kq * p.k1;
    __syncthreads();
    const i64 ra = rA[tid & (TM - 1)], cb = cB[tid & (TN - 1)];
    T v[PER];
    gather(v, A, B, ra, cb, kA, kB, nra, nrb, k0a, dka, k0b, dkb);
    T c[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) c[r][s] = T(0);
    for (int kc = 0; kc < nk; ++kc) {
      __syncthreads();                // the last step's products are done
#pragma unroll
      for (int r = 0; r < PER; ++r)
        if (r < nra + nrb) tile[tid + r * MS_NT] = v[r];
      // the sums of step kc + 2, into the buffer step kc's gather read
      if (kc + 2 < nk && tid < TK) {
        const bool in = (kc + 2) * TK + tid < p.K;
        kA[(kc & 1) * TK + tid] = in ? kq * p.ak0 + kr * p.ak1 : -1;
        kB[(kc & 1) * TK + tid] = in ? kq * p.bk0 + kr * p.bk1 : -1;
        kq += p.dq;
        kr += p.dr;
        if (kr >= p.k1) {
          kr -= p.k1;
          ++kq;
        }
      }
      __syncthreads();
      if (kc + 1 < nk)                // in flight during the products
        gather(v, A, B, ra, cb, kA + ((kc + 1) & 1) * TK,
               kB + ((kc + 1) & 1) * TK, nra, nrb, k0a, dka, k0b, dkb);
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        T a[4], b[4];
        load4(a, As + kk * TM + 4 * ty);
        load4(b, Bs + kk * TN + 4 * tx);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) c[r][s] += a[r] * b[s];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const i64 rc = rC[4 * ty + r];
      if (rc < 0) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const i64 cc = cC[4 * tx + s];
        if (cc < 0) continue;
        T* d = C + rc + cc;
        *d = acc ? *d + c[r][s] : c[r][s];
      }
    }
  }
}

// Max-abs scale of x[0..n) with the _safe_scale guard (a zero or
// non-finite max gives 1), by the whole block; synchronises on entry to
// its reduction and on exit.
template <typename T>
__device__ T block_scale_streamed(const T* x, int n) {
  __shared__ double red_m[MS_NT];
  __shared__ int red_b[MS_NT];
  const int tid = threadIdx.x;
  double m = 0.0;
  int bad = 0;
  for (int i = tid; i < n; i += MS_NT) {
    const double v = (double)x[i];
    if (!isfinite(v)) bad = 1; else m = fmax(m, fabs(v));
  }
  red_m[tid] = m;
  red_b[tid] = bad;
  __syncthreads();
  for (int h = MS_NT / 2; h > 0; h >>= 1) {
    if (tid < h) {
      red_m[tid] = fmax(red_m[tid], red_m[tid + h]);
      red_b[tid] |= red_b[tid + h];
    }
    __syncthreads();
  }
  const double r = red_m[0];
  const int b = red_b[0];
  __syncthreads();
  return (b || !(r > 0.0)) ? T(1) : T(r);
}

// x[0..n) /= the block's max-abs scale; synchronises on exit.
template <typename T>
__device__ void rescale_streamed(T* x, int n) {
  const T sc = block_scale_streamed(x, n);
  for (int i = threadIdx.x; i < n; i += MS_NT) x[i] = x[i] / sc;
  __syncthreads();
}

template <typename T>
__device__ void onehot_fill(T* w, int n) {
  for (int i = threadIdx.x; i < n; i += MS_NT) w[i] = i == 0 ? T(1) : T(0);
}

// ---------------------------------------------------------------------------
// merge W: W_t[k,m,a] = sum_{n,u,x} L_t[k,n,u,x] sum_{v,b} Th_t[a,b,u,v,x]
//                       sum_j B_t[m,j,v,x] W_{t+1}[n,j,b]
// per x:  t1[m,v,n,b] = sum_j B_t[m,j,v] W_{t+1}[n,j,b]        (P[0])
//         u[m,n,u,a]  = sum_{v,b} t1[m,v,n,b] ThT[v,b,u,a]      (P[1])
//         W_t[k,m,a] (+)= sum_{n,u} L_t[k,n,u] u[m,n,u,a]      (P[2])
// then W_t is rescaled in place in Ws, where the next step reads it.
// ThT[v,b,u,a] = Th_t[a,b,u,v,x] is copied by the block each step, so that
// P[1] reads each row of it contiguously.
// Workspace a block: one-hot W | t1 | u | ThT.
// ---------------------------------------------------------------------------
struct WProds { Prod p[3]; };
struct FProds { Prod p[5]; };

template <typename T>
__global__ void __launch_bounds__(MS_NT, MS_MINB)
merge_w_streamed_kernel(const T* __restrict__ L, Str6 sL,
                        const T* __restrict__ Bm, Str6 sB,
                        const T* __restrict__ Th, T* __restrict__ Ws,
                        T* __restrict__ work, WProds prods, int Bn, int S,
                        int DL, int DB, int Y, int q, int sr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  i64* tab = reinterpret_cast<i64*>(smem_raw);
  T* tile = reinterpret_cast<T*>(tab + MS_TAB);
  __shared__ WProds pd;
  if (threadIdx.x == 0) pd = prods;
  __syncthreads();
  const i64 nW = (i64)DL * DB * sr, nT = (i64)DB * Y * DL * sr;
  const i64 nTh = (i64)sr * sr * Y * Y * q;
  const int nTT = Y * sr * Y * sr;
  T* one = work + blockIdx.x * (nW + 2 * nT + nTT);
  T* t1 = one + nW;
  T* u = t1 + nT;
  T* ThT = u + nT;
  onehot_fill(one, (int)nW);
  for (int z = blockIdx.x; z < Bn; z += gridDim.x) {
    for (int s = S - 1; s >= 0; --s) {
      const T* Wn = s == S - 1 ? one : Ws + ((i64)z * S + s + 1) * nW;
      T* Wt = Ws + ((i64)z * S + s) * nW;
      for (int x = 0; x < q; ++x) {
        const T* Lt = L + z * sL.s[0] + s * sL.s[1] + x * sL.s[5];
        const T* Bt = Bm + z * sB.s[0] + s * sB.s[1] + x * sB.s[5];
        // ThT[v][b][u][a] = Th_t[a][b][u][v][x], a thread a column (u, a)
        for (int c = threadIdx.x; c < Y * sr; c += MS_NT) {
          const int uu = c / sr, a = c - uu * sr;
          const T* src = Th + s * nTh + x + ((i64)a * sr * Y + uu) * Y * q;
          for (int v = 0; v < Y; ++v)
            for (int b = 0; b < sr; ++b)
              ThT[(v * sr + b) * Y * sr + c] =
                  src[(i64)b * Y * Y * q + v * q];
        }
        tile_product(pd.p[0], Bt, Wn, t1, false, tile, tab);
        __syncthreads();
        tile_product(pd.p[1], t1, ThT, u, false, tile, tab);
        __syncthreads();
        tile_product(pd.p[2], Lt, u, Wt, x > 0, tile, tab);
        __syncthreads();
      }
      rescale_streamed(Wt, (int)nW);
    }
  }
}

// ---------------------------------------------------------------------------
// merge F: step s (time t = s+1):
//   M[e,a]        = sum_{k,m} S[e,k,m] W_t[k,m,a]                  (P[0])
// per x:
//   t1[e,n,m,u]   = sum_k S[e,k,m] L_t[k,n,u]                      (P[1])
//   Bp[m,u,j,y]   = sum_v Pyy[y,u,v] B_t[m,j,v]
//   t2[e,n,j,y]   = sum_{m,u} t1[e,n,m,u] Bp[m,u,j,y]              (P[2])
//   N[e,y,x,b]    = sum_{n,j} t2[e,n,j,y] W_{t+1}[n,j,b]           (P[3])
//   S2[f,n,j]   (+)= sum_{e,y} Phi_t[e,f,y] t2[e,n,j,y]            (P[4])
// then S <- S2 / scale.  W_{T1} is the one-hot; step 0 reads S_init in
// place.  Pyy is step s's table at Pyy + s * pyy_step (0: one table).
// Workspace a block: one-hot W | S (two buffers) | t1 | Bp | t2.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(MS_NT, MS_MINB)
merge_f_streamed_kernel(const T* __restrict__ L, Str6 sL,
                        const T* __restrict__ Bm, Str6 sB,
                        const T* __restrict__ Pyy, i64 pyy_step,
                        const T* __restrict__ Phi, const T* __restrict__ Ws,
                        const T* __restrict__ Sinit, T* __restrict__ Ns,
                        T* __restrict__ Ms, T* __restrict__ work,
                        FProds prods, int Bn, int S, int DL, int DB, int Y,
                        int q, int sr, int sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  i64* tab = reinterpret_cast<i64*>(smem_raw);
  T* tile = reinterpret_cast<T*>(tab + MS_TAB);
  __shared__ FProds pd;
  if (threadIdx.x == 0) pd = prods;
  __syncthreads();
  const int nBp = DB * Y * DB * Y;
  const i64 nW = (i64)DL * DB * sr, nS = (i64)sl * DL * DB;
  const i64 nF = (i64)sl * sl * Y * q, nN = (i64)sl * Y * q * sr;
  T* one = work + blockIdx.x * (nW + 2 * nS + 2 * nS * Y + nBp);
  T* Sbuf[2] = {one + nW, one + nW + nS};
  T* t1 = one + nW + 2 * nS;
  T* Bp = t1 + nS * Y;
  T* t2 = Bp + nBp;
  onehot_fill(one, (int)nW);
  for (int z = blockIdx.x; z < Bn; z += gridDim.x) {
    const T* Sc = Sinit + z * nS;
    for (int s = 0; s < S; ++s) {
      const i64 row = (i64)z * S + s;
      const T* Wt = Ws + row * nW;
      const T* Wn = s == S - 1 ? one : Wt + nW;
      const T* Py = Pyy + s * pyy_step;
      T* Sn = Sbuf[s & 1];
      tile_product(pd.p[0], Sc, Wt, Ms + row * sl * sr, false, tile, tab);
      for (int x = 0; x < q; ++x) {
        const T* Lt = L + z * sL.s[0] + s * sL.s[1] + x * sL.s[5];
        const T* Bt = Bm + z * sB.s[0] + s * sB.s[1] + x * sB.s[5];
        tile_product(pd.p[1], Sc, Lt, t1, false, tile, tab);
        // Bp[m][u][j][y], a thread a row m and column (j, y), all u
        for (int i = threadIdx.x; i < DB * DB * Y; i += MS_NT) {
          const int m = i / (DB * Y), c = i - m * (DB * Y);
          const int j = c / Y, y = c - j * Y;
          const T* py = Py + (i64)y * Y * Y * q + x;
          const T* bt = Bt + m * sB.s[2] + j * sB.s[3];
          for (int uu = 0; uu < Y; ++uu) {
            T a = T(0);
            for (int v = 0; v < Y; ++v)
              a += py[(uu * Y + v) * q] * bt[v * sB.s[4]];
            Bp[(m * Y + uu) * DB * Y + c] = a;
          }
        }
        __syncthreads();
        tile_product(pd.p[2], t1, Bp, t2, false, tile, tab);
        __syncthreads();
        tile_product(pd.p[3], t2, Wn, Ns + row * nN + x * sr, false, tile,
                     tab);
        tile_product(pd.p[4], Phi + s * nF + x, t2, Sn, x > 0, tile, tab);
        __syncthreads();
      }
      rescale_streamed(Sn, (int)nS);
      Sc = Sn;
    }
  }
}

// ---------------------------------------------------------------------------
// products: each axis {extent, stride in one operand, stride in the other}
// ---------------------------------------------------------------------------
static const Ax ONE = {1, 0, 0};

// TM (32, 64 or 128) that wastes the fewest padded outputs of an M x N
// product, the squarer tile on a tie.
static int pick_tm(int M, int N) {
  int best = 64;
  i64 best_area = -1;
  for (int tm = 32; tm <= 128; tm *= 2) {
    const int tn = MS_TILE / tm;
    const i64 area = (i64)((M + tm - 1) / tm) * tm * ((N + tn - 1) / tn) * tn;
    const int d = tm > 64 ? tm / 64 : 64 / tm;
    const int bd = best > 64 ? best / 64 : 64 / best;
    if (best_area < 0 || area < best_area || (area == best_area && d < bd)) {
      best = tm;
      best_area = area;
    }
  }
  return best;
}

// rows (m0, m1), columns (n0, n1), sums (k0, k1); outer axis first
static Prod prod_of(Ax m0, Ax m1, Ax n0, Ax n1, Ax k0, Ax k1) {
  Prod p;
  p.M = m0.n * m1.n;
  p.N = n0.n * n1.n;
  p.K = k0.n * k1.n;
  p.TM = pick_tm(p.M, p.N);
  for (p.lm = 0; (1 << p.lm) < p.TM; ++p.lm) {}
  p.m1 = m1.n; p.am0 = m0.s1; p.am1 = m1.s1; p.cm0 = m0.s2; p.cm1 = m1.s2;
  p.n1 = n1.n; p.bn0 = n0.s1; p.bn1 = n1.s1; p.cn0 = n0.s2; p.cn1 = n1.s2;
  p.k1 = k1.n; p.ak0 = k0.s1; p.ak1 = k1.s1; p.bk0 = k0.s2; p.bk1 = k1.s2;
  p.dq = MS_TK / p.k1;
  p.dr = MS_TK - p.dq * p.k1;
  return p;
}

static WProds merge_w_prods(const i64* sL, const i64* sB, int DL, int DB,
                            int Y, int q, int sr) {
  WProds w;
  // t1[m,v,n,b] = sum_j B_t[m,j,v] W[n,j,b]
  w.p[0] = prod_of(Ax{DB, sB[2], (i64)Y * DL * sr}, Ax{Y, sB[4], (i64)DL * sr},
                   Ax{DL, (i64)DB * sr, sr}, Ax{sr, 1, 1},
                   ONE, Ax{DB, sB[3], sr});
  // u[m,n,u,a] = sum_{v,b} t1[m,v,n,b] ThT[v,b,u,a]
  w.p[1] = prod_of(Ax{DB, (i64)Y * DL * sr, (i64)DL * Y * sr},
                   Ax{DL, sr, (i64)Y * sr},
                   Ax{Y, sr, sr}, Ax{sr, 1, 1},
                   Ax{Y, (i64)DL * sr, (i64)sr * Y * sr},
                   Ax{sr, 1, (i64)Y * sr});
  // W_t[k,m,a] (+)= sum_{n,u} L_t[k,n,u] u[m,n,u,a]
  w.p[2] = prod_of(ONE, Ax{DL, sL[2], (i64)DB * sr},
                   Ax{DB, (i64)DL * Y * sr, sr}, Ax{sr, 1, 1},
                   Ax{DL, sL[3], (i64)Y * sr}, Ax{Y, sL[4], sr});
  return w;
}

static FProds merge_f_prods(const i64* sL, int DL, int DB, int Y, int q,
                            int sr, int sl) {
  const i64 DLB = (i64)DL * DB, P = (i64)DB * Y;
  FProds f;
  // M[e,a] = sum_{(k,m)} S[e,(k,m)] W_t[(k,m),a]
  f.p[0] = prod_of(ONE, Ax{sl, DLB, sr}, ONE, Ax{sr, 1, 1},
                   ONE, Ax{(int)DLB, 1, sr});
  // t1[e,n,m,u] = sum_k S[e,k,m] L_t[k,n,u]
  f.p[1] = prod_of(Ax{sl, DLB, DLB * Y}, Ax{DB, 1, Y},
                   Ax{DL, sL[3], P}, Ax{Y, sL[4], 1},
                   ONE, Ax{DL, DB, sL[2]});
  // t2[(e,n),(j,y)] = sum_{(m,u)} t1[(e,n),(m,u)] Bp[(m,u),(j,y)]
  f.p[2] = prod_of(ONE, Ax{sl * DL, P, P}, ONE, Ax{(int)P, 1, 1},
                   ONE, Ax{(int)P, 1, P});
  // N[e,y,x,b] = sum_{(n,j)} t2[e,(n,j),y] W_{t+1}[(n,j),b]
  f.p[3] = prod_of(Ax{sl, DLB * Y, (i64)Y * q * sr}, Ax{Y, 1, (i64)q * sr},
                   ONE, Ax{sr, 1, 1}, ONE, Ax{(int)DLB, Y, sr});
  // S2[f,(n,j)] (+)= sum_{e,y} Phi_t[e,f,y] t2[e,(n,j),y]
  f.p[4] = prod_of(ONE, Ax{sl, (i64)Y * q, DLB}, ONE, Ax{(int)DLB, Y, 1},
                   Ax{sl, (i64)sl * Y * q, DLB * Y}, Ax{Y, q, 1});
  return f;
}

// ---------------------------------------------------------------------------
// launchers: dtype 0 = float32, 1 = float64; `blocks` resident blocks, each
// with its part of `work` (fused_stta.py::merge_streamed_plan sizes both).
// Each returns cudaGetLastError() (or the attribute call's error) as an int.
// ---------------------------------------------------------------------------
template <typename T>
static int merge_w_streamed_launch(const void* L, const i64* sL,
                                   const void* B, const i64* sB,
                                   const void* Th, void* Ws, void* work,
                                   int Bn, int S, int DL, int DB, int Y,
                                   int q, int sr, int blocks, size_t smem,
                                   cudaStream_t st) {
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  cudaError_t e = cudaFuncSetAttribute(
      merge_w_streamed_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  merge_w_streamed_kernel<T><<<blocks, MS_NT, smem, st>>>(
      (const T*)L, a, (const T*)B, b, (const T*)Th, (T*)Ws, (T*)work,
      merge_w_prods(sL, sB, DL, DB, Y, q, sr), Bn, S, DL, DB, Y, q, sr);
  return (int)cudaGetLastError();
}

template <typename T>
static int merge_f_streamed_launch(const void* L, const i64* sL,
                                   const void* B, const i64* sB,
                                   const void* Pyy, i64 pyy_step,
                                   const void* Phi, const void* Ws,
                                   const void* Sinit, void* Ns, void* Ms,
                                   void* work, int Bn, int S, int DL, int DB,
                                   int Y, int q, int sr, int sl, int blocks,
                                   size_t smem, cudaStream_t st) {
  Str6 a, b;
  for (int i = 0; i < 6; ++i) { a.s[i] = sL[i]; b.s[i] = sB[i]; }
  cudaError_t e = cudaFuncSetAttribute(
      merge_f_streamed_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  merge_f_streamed_kernel<T><<<blocks, MS_NT, smem, st>>>(
      (const T*)L, a, (const T*)B, b, (const T*)Pyy, pyy_step,
      (const T*)Phi, (const T*)Ws, (const T*)Sinit, (T*)Ns, (T*)Ms,
      (T*)work, merge_f_prods(sL, DL, DB, Y, q, sr, sl), Bn, S, DL, DB, Y,
      q, sr, sl);
  return (int)cudaGetLastError();
}

extern "C" {

int merge_w_streamed(int dtype, const void* L, const i64* sL, const void* B,
                     const i64* sB, const void* Th, void* Ws, void* work,
                     int Bn, int S, int DL, int DB, int Y, int q, int sr,
                     int blocks, long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
      ? merge_w_streamed_launch<float>(L, sL, B, sB, Th, Ws, work, Bn, S, DL,
                                       DB, Y, q, sr, blocks, (size_t)smem, st)
      : merge_w_streamed_launch<double>(L, sL, B, sB, Th, Ws, work, Bn, S,
                                        DL, DB, Y, q, sr, blocks,
                                        (size_t)smem, st);
}

int merge_f_streamed(int dtype, const void* L, const i64* sL, const void* B,
                     const i64* sB, const void* Pyy, long long pyy_step,
                     const void* Phi, const void* Ws, const void* Sinit,
                     void* Ns, void* Ms, void* work, int Bn, int S, int DL,
                     int DB, int Y, int q, int sr, int sl, int blocks,
                     long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
      ? merge_f_streamed_launch<float>(L, sL, B, sB, Pyy, pyy_step, Phi, Ws,
                                       Sinit, Ns, Ms, work, Bn, S, DL, DB, Y,
                                       q, sr, sl, blocks, (size_t)smem, st)
      : merge_f_streamed_launch<double>(L, sL, B, sB, Pyy, pyy_step, Phi, Ws,
                                        Sinit, Ns, Ms, work, Bn, S, DL, DB,
                                        Y, q, sr, sl, blocks, (size_t)smem,
                                        st);
}

}  // extern "C"
