// Batched symmetric eigendecomposition by parallel cyclic Jacobi for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// What it replaces.  The SVD sweeps of the tensor trains (matrixproductbp_tpu/
// ops/tensortrain.py:420, 445 and ops/mpem.py:47, jnp.linalg.svd on the TPU,
// outside Pallas) decompose thousands of small matrices per time step.  On
// the card the port takes the SVD of a float32 M [m, n] through the Gram
// matrix in float64 (ops/smallsvd.py::svd_by_gram): G = M^T M (or M M^T),
// G = V diag(w) V^T, sigma = sqrt(w).  cuSOLVER's batched Jacobi solvers
// stop at 32 x 32 and its approximate batched SVD (gesvda) refuses
// rank-deficient inputs; above 32 the library runs one matrix per launch.
// This kernel takes any 1 <= k <= 64 (k = 20 at D=10, 40 at D=20).  Its
// plain version is ops/smallsvd.py::eigh_desc_plain (torch.linalg.eigh).
//
// Algorithm.  Two-sided cyclic Jacobi with the round-robin ("tournament")
// ordering over K players, K the least of 20, 32, 40, 64 that holds k
// (20 and 40 are the sizes of the D=10 and D=20 sweeps); indices k..K-1
// are dummies whose rotations are the identity.  Each of the K-1 rounds of a sweep pairs every index once, and
// the K/2 rotations of a round act on disjoint index pairs.  Each rotation
// is Golub & Van Loan's sym.schur2 for its 2 x 2 diagonal block, computed
// with one sqrt and one rsqrt (see the round loop) on A scaled by a power
// of two near 1 / max|G| (exact).  Sweeps stop when the squared
// off-diagonal mass falls below 1e-28 of the squared Frobenius norm (above
// the rounding floor of ~k^2 eps^2), or after 30 sweeps.  Eigenvalues are
// written in descending order with their eigenvectors as columns.  G's
// lower triangle is read, as torch.linalg.eigh reads it.
//
// What bounds it.  Per instance the function reads k^2 and writes k^2 + k
// float64 values and needs ~9 k^3 FLOP (tridiagonalisation and implicit QR
// with vectors, Golub & Van Loan 8.3): at k = 40 about 0.58 MFLOP against
// 26 KB, bound by float64 operations (67 TFLOP/s on the tensor cores);
// at k = 20, 72 KFLOP against 6.6 KB, by bytes.  Jacobi does ~6x that
// work (~6-7 sweeps of K-1 rounds).  The rounds of one matrix are a chain,
// each needing the previous one's A, so what bounds the kernel is the
// shared-memory traffic and the instructions of a round, over the matrices
// in flight on an SM.  The earlier design (one 128- or 256-thread block per
// matrix, separate row and column passes over A and V in shared memory,
// three block barriers and two f64 divides and square roots a round) spent
// its time in barriers, the rotation's dependent chain and shared-memory
// traffic.  Measured on an H100 (PERF.md): the update of A takes about
// half of this kernel's time, V a sixth to a fifth.
//
// Design.  One warp owns one matrix up to K = 32, several matrices per
// block; above, two warps own it and meet at a named barrier (bar.sync id,
// 64) of their own.  There is no block barrier.  A round is one pass:
//   1. lanes < K/2 compute (c, s) for their pair; sync;
//   2. every thread rewrites its 2 x 2 blocks of A and its row of V; sync.
// J is block-diagonal up to a permutation, so block (a, b) of J^T A J (rows
// {p_a, q_a}, columns {p_b, q_b}) is R_a^T A_ab R_b and reads only the four
// old entries it replaces.  A is symmetric: only its upper triangle is
// kept and only the blocks with b >= a are computed.  A is stored in
// tournament-position order (pair a at positions a and K-1-a), so the
// offsets a thread touches are the same every round, and consecutive
// threads touch consecutive or odd-strided words; each block is written at
// the positions its players take in the next round, into a second buffer.
// A thread's block offsets are computed once: up to K = 32 they stay in its
// registers, above in a table in the matrix's shared memory (measured on an
// H100, PERF.md: the table makes K = 20 13% slower; registers make K = 40
// 5% slower, at 200 registers a thread instead of 159).  Each
// thread keeps one row of V in registers, also in position order: pair b
// touches registers b and K-1-b, and the move to the next round's
// positions is a register shift.  The convergence test is a warp-shuffle
// sum once per sweep; the output is permuted to descending order through
// shared memory and stored coalesced.
//
// Two warps above K = 32 rather than one: a row of V takes 2K registers per
// thread, and one warp would hold two rows at K = 40 (160 registers for V
// alone).
//
// Shared memory per matrix: 8 (3 K/2 + 2 + 2 K (K + 1)) bytes, and above
// K = 32 16 bytes per block pair a <= b (K = 20: 6,976; K = 40: 30,096;
// K = 64: 75,792 bytes).  ops/smallsvd.py::eigh_geometry computes the same
// layout.

#include <cuda_runtime.h>

typedef long long i64;

namespace {

constexpr int kMaxSweeps = 30;

struct Rot { double c, s; };

template <int WPM>
__device__ __forceinline__ void group_sync(int bar) {
  if (WPM == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" :: "r"(bar), "r"(32 * WPM) : "memory");
  }
}

// sum over the group; every thread gets the same bits
template <int WPM>
__device__ double group_sum(double v, double* red, int t, int bar) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (WPM > 1) {
    if ((t & 31) == 0) red[t >> 5] = v;
    group_sync<WPM>(bar);
    v = red[0];
    for (int w = 1; w < WPM; ++w) v += red[w];
    group_sync<WPM>(bar);
  }
  return v;
}

// walks (r, c) over a grid of `cols` columns in row-major order, from
// element `start` in steps of `n`, without a division per step
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int start, int n, int cols_)
      : r(start / cols_), c(start % cols_), dr(n / cols_), dc(n % cols_),
        cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  }
};

// player at tournament position a (0 <= a < K) in round r (0 <= r < K - 1)
template <int K>
__device__ __forceinline__ int player(int a, int r) {
  int x = a - 1 + r;
  x -= (x >= K - 1) ? K - 1 : 0;
  return a == 0 ? 0 : 1 + x;
}

// the position that the player at position a takes in the next round
template <int K>
__device__ __forceinline__ int next_pos(int a) {
  return a == 0 ? 0 : (a == 1 ? K - 1 : a - 1);
}

// offset of entry (i, j) of the symmetric A in its upper-triangle storage
template <int K>
__device__ __forceinline__ int up(int i, int j) {
  return i <= j ? i * (K + 1) + j : j * (K + 1) + i;
}

// block (a, b): the offsets of its four entries in this round's A and in
// the next round's (13 bits each), with a and b in the top bits of .x, .z
template <int K>
__device__ uint4 block_at(int a, int b) {
  const int pa = a, qa = K - 1 - a, pb = b, qb = K - 1 - b;
  const int na = next_pos<K>(pa), ma = next_pos<K>(qa);
  const int nb = next_pos<K>(pb), mb = next_pos<K>(qb);
  return make_uint4(up<K>(pa, pb) | (up<K>(pa, qb) << 13) | (a << 26),
                    up<K>(qa, pb) | (up<K>(qa, qb) << 13),
                    up<K>(na, nb) | (up<K>(na, mb) << 13) | (b << 26),
                    up<K>(ma, nb) | (up<K>(ma, mb) << 13));
}

// a round's task j: block (a, b), a <= b, the j-th in row-major order
template <int K>
__device__ uint4 task_at(int j) {
  constexpr int NP = K / 2;
  int a = 0;
  while (a < NP && j >= NP - a) { j -= NP - a; ++a; }
  return block_at<K>(a, a + j);
}

// block (a, b) of J^T A J, R_a^T A_ab R_b with R = [[c, s], [-s, c]],
// written into B at the next round's positions
__device__ __forceinline__ void update_block(uint4 o, Rot ra, Rot rb,
                                             const double* A, double* B) {
  const double a11 = A[o.x & 0x1fff], a12 = A[(o.x >> 13) & 0x1fff];
  const double a21 = A[o.y & 0x1fff], a22 = A[o.y >> 13];
  const double x11 = rb.c * a11 - rb.s * a12;
  const double x12 = rb.s * a11 + rb.c * a12;
  const double x21 = rb.c * a21 - rb.s * a22;
  const double x22 = rb.s * a21 + rb.c * a22;
  B[o.z & 0x1fff] = ra.c * x11 - ra.s * x21;
  B[(o.z >> 13) & 0x1fff] = ra.c * x12 - ra.s * x22;
  B[o.w & 0x1fff] = ra.s * x11 + ra.c * x21;   // a == b: the same entry as
  B[o.w >> 13] = ra.s * x12 + ra.c * x22;      // the one above, ~0
}

__device__ __forceinline__ void update_task(uint4 o, const Rot* rot,
                                            const double* A, double* B) {
  update_block(o, rot[o.x >> 26], rot[o.z >> 26], A, B);
}

// K: tournament size, even, >= k; indices k..K-1 are dummies whose
// rotations are the identity and whose rows and columns of A stay zero
template <int K>
__global__ void __launch_bounds__(256)
jacobi_eigh_kernel(const double* __restrict__ G, double* __restrict__ W,
                   double* __restrict__ Vout, int Bn, int k, int mpb) {
  constexpr int WPM = K <= 32 ? 1 : 2;
  constexpr int NT = 32 * WPM;
  constexpr int NP = K / 2;
  constexpr int LD = K + 1;
  constexpr int NTAB = NP * (NP + 1) / 2;             // tasks of a round
  constexpr int NTASK = (NTAB + NT - 1) / NT;
  constexpr bool REG_TASKS = K <= 32;
  // doubles per matrix, even: rotations, scratch, permutation, A, B, table
  constexpr int PER = 3 * NP + 2 + 2 * K * LD + (REG_TASKS ? 0 : 2 * NTAB);
  extern __shared__ __align__(16) unsigned char smem[];

  const int grp = threadIdx.x / NT, t = threadIdx.x % NT;
  const i64 inst = (i64)blockIdx.x * mpb + grp;
  if (inst >= Bn) return;
  const int bar = 1 + grp;
  double* base = reinterpret_cast<double*>(smem) + grp * PER;

  Rot* rot = reinterpret_cast<Rot*>(base);            // [NP]
  double* red = base + 2 * NP;                        // [2]
  int* perm = reinterpret_cast<int*>(red + 2);        // [k]
  double* A = red + 2 + NP;                           // [K][LD], upper
  double* B = A + K * LD;                             // the next round's
  // this thread's blocks of every round, tasks t, t + NT, ...: up to K = 32
  // in registers, above in the matrix's table in shared memory (fewer
  // registers, more matrices on an SM: the faster home at each size)
  uint4 task[REG_TASKS ? NTASK : 1];
  uint4* tab = reinterpret_cast<uint4*>(B + K * LD);  // [NTAB] above 32
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    if constexpr (REG_TASKS)
      task[i] = task_at<K>(t + i * NT);
    else if (t + i * NT < NTAB)
      tab[t + i * NT] = task_at<K>(t + i * NT);
  }

  // A = G / sigma, sigma a power of two near max |G| (exact, so the
  // rotations below cannot overflow); G's lower triangle into A's upper
  // one, the dummies' entries zero
  const double* g = G + inst * (i64)k * k;
  double mx = 0.0;
  for (int e = t; e < k * k; e += NT) mx = fmax(mx, fabs(g[e]));
  for (int o = 16; o > 0; o >>= 1)
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (WPM > 1) {
    if ((t & 31) == 0) red[t >> 5] = mx;
    group_sync<WPM>(bar);
    mx = fmax(red[0], red[1]);
    group_sync<WPM>(bar);
  }
  const int lsig = (mx > 0.0 && mx <= 1.7e308) ? ilogb(mx) : 0;
  double fro = 0.0;
  for (Walk w(t, NT, k); w.r < k; w.next()) {
    const double x = ldexp(g[w.r * k + w.c], -lsig);
    fro += x * x;
    if (w.r >= w.c) A[w.c * LD + w.r] = x;
  }
  for (Walk w(t, NT, K); w.r < K; w.next())
    if (w.r <= w.c && w.c >= k) A[w.r * LD + w.c] = 0.0;
  // this thread's row t of V, its columns in tournament order (at the
  // start of every sweep the order is the identity)
  double v[K];
#pragma unroll
  for (int a = 0; a < K; ++a) v[a] = (a == t) ? 1.0 : 0.0;
  group_sync<WPM>(bar);
  fro = group_sum<WPM>(fro, red, t, bar);

  for (int sweep = 0; sweep < kMaxSweeps && k > 1; ++sweep) {
    double off = 0.0;
    for (Walk w(t, NT, k); w.r < k; w.next())
      if (w.r < w.c) off += A[w.r * LD + w.c] * A[w.r * LD + w.c];
    off = 2.0 * group_sum<WPM>(off, red, t, bar);
    if (!(off > 1e-28 * fro)) break;  // converged (or all zero / NaN)
    for (int r = 0; r < K - 1; ++r) {
      // sym.schur2 for the pair at positions (t, K-1-t): with d = a_qq -
      // a_pp, e = 2 a_pq, rr = hypot(d, e), u = |d| + rr, its tau = d / e
      // and tan = sign(tau) |e| / u give c = u / sqrt(2 rr u) and s =
      // sign(tau) |e| / sqrt(2 rr u), since u^2 + e^2 = 2 rr u
      if (t < NP) {
        double c = 1.0, s = 0.0;
        if (player<K>(t, r) < k && player<K>(K - 1 - t, r) < k) {
          const double app = A[t * LD + t];
          const double aqq = A[(K - 1 - t) * LD + K - 1 - t];
          const double apq = A[t * LD + K - 1 - t];
          const double d = aqq - app, e = 2.0 * apq;
          const double rr = sqrt(d * d + e * e), u = fabs(d) + rr;
          const double h = 2.0 * rr * u;
          if (apq != 0.0 && h > 0.0) {
            const double inv = rsqrt(h);
            c = u * inv;
            s = copysign(fabs(e) * inv, (d * e >= 0.0) ? 1.0 : -1.0);
          }
        }
        rot[t] = Rot{c, s};
      }
      group_sync<WPM>(bar);
      // A <- J^T A J, one 2 x 2 block at a time, into the next round's B
      if constexpr (REG_TASKS) {
#pragma unroll
        for (int i = 0; i < NTASK; ++i)
          if (t + i * NT < NTAB) update_task(task[i], rot, A, B);
      } else {
        for (int j = t; j < NTAB; j += NT) update_task(tab[j], rot, A, B);
      }
      // V <- V J on this thread's row: pair b holds positions b and K-1-b;
      // then the next round's positions: a <- a + 1 (1 <= a < K-1), K-1 <- 1
#pragma unroll
      for (int b = 0; b < NP; ++b) {
        const Rot rb = rot[b];
        const double x = v[b], y = v[K - 1 - b];
        v[b] = rb.c * x - rb.s * y;
        v[K - 1 - b] = rb.s * x + rb.c * y;
      }
      const double v1 = v[1];
#pragma unroll
      for (int a = 1; a < K - 1; ++a) v[a] = v[a + 1];
      v[K - 1] = v1;
      double* tmp = A; A = B; B = tmp;
      group_sync<WPM>(bar);
    }
  }

  // descending order: eigenvalue i goes to rank = #{j : w_j > w_i, or equal
  // with j < i}; perm[rank] = i
  for (int i = t; i < k; i += NT) {
    const double wi = A[i * LD + i];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const double wj = A[j * LD + j];
      rank += (wj > wi) || (wj == wi && j < i);
    }
    perm[rank] = i;
  }
  group_sync<WPM>(bar);
  double* w = W + inst * (i64)k;
  for (int c = t; c < k; c += NT)
    w[c] = ldexp(A[perm[c] * LD + perm[c]], lsig);
  // V's rows through the other buffer, then out coalesced in descending
  // order
  if (t < k) {
#pragma unroll
    for (int a = 0; a < K; ++a)
      if (a < k) B[t * LD + a] = v[a];
  }
  group_sync<WPM>(bar);
  double* vo = Vout + inst * (i64)k * k;
  for (Walk e(t, NT, k); e.r < k; e.next())
    vo[e.r * k + e.c] = B[e.r * LD + perm[e.c]];
}

template <int K>
int launch(const void* G, void* W, void* V, int Bn, int k, int mpb,
           long long smem, cudaStream_t stream) {
  constexpr int WPM = K <= 32 ? 1 : 2;
  if (32 * WPM * mpb > 256 || k > K) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      jacobi_eigh_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (Bn + mpb - 1) / mpb;
  jacobi_eigh_kernel<K><<<blocks, 32 * WPM * mpb, (size_t)smem, stream>>>(
      (const double*)G, (double*)W, (double*)V, Bn, k, mpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// G: [Bn, k, k] symmetric float64, contiguous -> W [Bn, k] (descending),
// V [Bn, k, k] (eigenvectors as columns).  K is the tournament size (one
// of 20, 32: one warp per matrix; 40, 64: two), mpb the
// matrices per block (at most 256 threads), smem the block's dynamic
// shared memory.  Returns the CUDA error code.
int jacobi_eigh(const void* G, void* W, void* V, int Bn, int k, int K,
                int mpb, long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || mpb < 1) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 20: return launch<20>(G, W, V, Bn, k, mpb, smem, st);
    case 32: return launch<32>(G, W, V, Bn, k, mpb, smem, st);
    case 40: return launch<40>(G, W, V, Bn, k, mpb, smem, st);
    case 64: return launch<64>(G, W, V, Bn, k, mpb, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
