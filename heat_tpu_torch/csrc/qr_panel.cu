// Fused CholeskyQR panel pass on Hopper (sm_90a).
//
// Replaces the TPU kernel heat_tpu/ops/qr_panel.py::_panel_kernel (K4):
//     G = x^T x,  L = chol(G),  R = L^T,  R^-1 = L^-T
// for an (m, n) f32 panel with m >= n >= 2, in IEEE f32 FMA throughout.
//
// What bounds it.  The Gram is the work: m n (n+1) flops for its upper
// triangle, against 4 m n bytes of panel read once.  At 1e6 x 128 that is
// 1.65e10 flops (0.25 ms at 67 TFLOP/s f32) against 0.51 GB (0.15 ms at
// 3.35 TB/s), so the Gram is bound by operations; the n^3/3 + n^3/3 flops of
// the factorisation and the inverse are few but serial over the n columns.
// The design, in three launches on the caller's stream:
//   1. gram_partial: one block per (128 x 128 tile of the upper triangle of
//      G) x (chunk of at most 16384 rows).  On the TPU the whole Gram
//      accumulated over a sequential grid axis in one scratch; here the rows
//      are split across blocks so that even n = 128 (one tile) fills the
//      card, and every block writes its partial tile to a workspace.  Only
//      tiles with I <= J are computed, and a diagonal tile skips the squares
//      below its diagonal: symmetry halves the Gram's work.  Each thread
//      holds 8 x 8 sums in registers; rows arrive through a 4-stage ring of
//      16-row stages filled with cp.async (16-byte copies where the panel
//      allows them), so the next stages' copies are in flight while the
//      FMAs run.
//   2. gram_reduce: each element of G sums its partials in a fixed order,
//      so R is the same from run to run (float atomics would not be).
//   3. the factorisation, R = chol(G)^T and R^-1:
//      - chol_inv_small (n <= 165): one block of 1024 threads with G and
//        L^-1 in shared memory, two block barriers per column;
//      - chol_inv_blocked (wider panels, up to the 1000- and 1024-wide
//        leaves of the QR path): a cooperative launch of one block per SM,
//        blocked in 64 columns with one grid barrier per block column (see
//        below): a column-by-column loop needs n + 1 grid barriers, and
//        at n = 1024 spent ~6 ms on them and on its rank-1 updates.
// A pivot that is not positive (or NaN) latches, as jnp.linalg.cholesky
// does for a matrix it cannot factor: R comes back NaN on and above its
// diagonal (0 below) and R^-1 NaN throughout, so the caller's finiteness
// check falls back to Householder QR.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;              // edge of a G tile
constexpr int kRowStep = 16;            // rows of x per stage of the ring
constexpr int kStages = 4;              // stages of the cp.async ring
constexpr int kGramThreads = 256;       // 8 warps, two 32 x 32 squares each
constexpr size_t kGramSmem = 2ull * kStages * kRowStep * kTile * sizeof(float);
constexpr long long kMaxChunk = 16384;  // rows one block sums in a row
constexpr int kFactorThreads = 1024;
constexpr int kMaxSmallN = 165;    // 2 n^2 + n floats fit the shared memory a block may use

struct Plan {
  int tiles_per_side;  // T = ceil(n / 128)
  int tiles;           // T (T + 1) / 2 upper tiles
  int splits;          // row chunks
  long long chunk;     // rows per chunk, a multiple of kRowStep
  bool small;          // factor in one block, in shared memory
  size_t smem;         // dynamic shared memory of chol_inv_small
};

// `slots`: Gram blocks the card runs at once
Plan make_plan(long long m, int n, int slots) {
  Plan p;
  p.tiles_per_side = (n + kTile - 1) / kTile;
  p.tiles = p.tiles_per_side * (p.tiles_per_side + 1) / 2;
  // a wave of blocks, and no block sums more than kMaxChunk rows in one
  // running sum (at 5e5 x 1000 four chunks of 125000 rows lost ~6e-6 of
  // R); then as many chunks as fill the last wave
  long long want = slots / p.tiles;
  const long long short_chunks = (m + kMaxChunk - 1) / kMaxChunk;  // >= 1
  if (want < short_chunks) want = short_chunks;
  const long long waves = (want * p.tiles + slots - 1) / slots;
  if (waves * slots / p.tiles > want) want = waves * slots / p.tiles;
  const long long max_splits = (m + kRowStep - 1) / kRowStep;
  const long long splits = want < max_splits ? want : max_splits;
  long long chunk = (m + splits - 1) / splits;
  chunk = (chunk + kRowStep - 1) / kRowStep * kRowStep;
  p.chunk = chunk;
  p.splits = static_cast<int>((m + chunk - 1) / chunk);
  p.small = n <= kMaxSmallN;
  p.smem = p.small ? (2 * static_cast<size_t>(n) * n + n) * sizeof(float) : 0;
  return p;
}

// workspace floats: the partial tiles, then G (n x n), Y (n x n) and the
// blocked kernel's barrier counter and failure flag
size_t workspace_floats(const Plan& p, int n) {
  return static_cast<size_t>(p.splits) * p.tiles * kTile * kTile + 2 * static_cast<size_t>(n) * n + 2;
}

__device__ __forceinline__ void upper_tile(int t, int T, int& I, int& J) {
  int i = 0;
  while (t >= T - i) {
    t -= T - i;
    ++i;
  }
  I = i;
  J = i + t;
}

// cp.async of kBytes (16 or 4) from global to shared; a copy that is not
// `valid` fills zeros and reads nothing
template <int kBytes>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem, bool valid) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const int src = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One stage of kRowStep rows: acc[q][i][j] += a[i] b[j] over the thread's
// rows arow + i and columns bcol + 32 q + (j < 4 ? j : 12 + j), for the
// squares q this warp computes.
template <bool kDo0, bool kDo1>
__device__ __forceinline__ void gram_stage(const float* as, const float* bs, int arow, int bcol,
                                           float (&acc)[2][4][8]) {
#pragma unroll
  for (int k = 0; k < kRowStep; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(as + k * kTile + arow);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 0 ? !kDo0 : !kDo1) continue;
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kTile + bcol + 32 * q);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kTile + bcol + 32 * q + 16);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[q][i][j] = fmaf(a[i], b[j], acc[q][i][j]);
    }
  }
}

// One block per (128 x 128 upper tile of G) x (chunk of at most 16384
// rows); kVec: 16-byte copies (x's base and row pitch 16-byte aligned).
// Each warp owns two 32 x 32 squares (p, 2 h + q), q = 0, 1, of the tile
// (p, h below); lane (ty, tx) = (lane / 4, lane % 4) of a square owns its rows
// 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3, 16 + 4 tx .. 16 + 4 tx + 3.
// A diagonal tile stages its rows once and skips the six squares below
// its diagonal (two warps do nothing, two do one square).
template <bool kVec>
__global__ void __launch_bounds__(kGramThreads, 2)
gram_partial_kernel(const float* __restrict__ x, float* __restrict__ part, long long m, int n, int T,
                    long long chunk) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);  // [stage][A, B][row][128]
  int I, J;
  upper_tile(blockIdx.x, T, I, J);
  const bool diag = I == J;
  const int i0 = I * kTile, j0 = J * kTile;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long r1 = r0 + chunk < m ? r0 + chunk : m;
  const int steps = static_cast<int>((r1 - r0 + kRowStep - 1) / kRowStep);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warp w takes row p and half h of the tile's 4 x 4 squares, item
  // 2 p + h = 0, 1, 3, 5, 2, 7, 4, 6 for w = 0..7: warps w and w + 4 share a
  // scheduler, and in a diagonal tile (items 0..7 hold 2, 2, 1, 2, 0, 2, 0, 1
  // squares) each pair then holds 3 or 2 squares, not 1 to 4
  const int item = (0x64725310 >> (4 * warp)) & 0xf;
  const int p = item / 2, h = item % 2;
  const int arow = 32 * p + 4 * (lane / 4), bcol = 64 * h + 4 * (lane % 4);
  const bool do0 = !(diag && p > 2 * h), do1 = !(diag && p > 2 * h + 1);

  // stage s of the ring: rows r0 + kRowStep s .., tile columns i0 .. (A)
  // and j0 .. (B; a diagonal tile reads A twice).  This thread copies
  // columns c .. (4 with kVec, else 1) of rows kr + kPass u, u < kPasses
  constexpr int kPerRow = kVec ? kTile / 4 : kTile;
  constexpr int kPass = kGramThreads / kPerRow;
  constexpr int kPasses = kRowStep / kPass;
  const int kr = tid / kPerRow, c = (tid % kPerRow) * (kVec ? 4 : 1);
  const bool a_in = i0 + c < n, b_in = j0 + c < n;
  const float* xa = x + (r0 + kr) * n + i0 + c;
  const float* xb = x + (r0 + kr) * n + j0 + c;
  auto load = [&](int s, int buf) {
    float* dst = ring + static_cast<size_t>(buf) * 2 * kRowStep * kTile + kr * kTile + c;
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int k = s * kRowStep + u * kPass;
      const bool row_in = r0 + kr + k < r1;
      const long long off = static_cast<long long>(k) * n;
      cp_async<kVec ? 16 : 4>(dst + u * kPass * kTile, row_in && a_in ? xa + off : x, row_in && a_in);
      if (!diag)
        cp_async<kVec ? 16 : 4>(dst + (kRowStep + u * kPass) * kTile, row_in && b_in ? xb + off : x, row_in && b_in);
    }
  };

  float acc[2][4][8];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[q][i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed, for this thread's copies
    __syncthreads();               // ... and everyone's; stage s - 1 is free
    if (s + kStages - 1 < steps) load(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const float* as = ring + static_cast<size_t>(s % kStages) * 2 * kRowStep * kTile;
    const float* bs = diag ? as : as + kRowStep * kTile;
    if (do0 && do1)
      gram_stage<true, true>(as, bs, arow, bcol, acc);
    else if (do0)
      gram_stage<true, false>(as, bs, arow, bcol, acc);
    else if (do1)
      gram_stage<false, true>(as, bs, arow, bcol, acc);
  }
  cp_async_wait<0>();

  // the squares a diagonal tile skips are never read by gram_reduce
  float* out = part + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kTile * kTile;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q == 0 ? !do0 : !do1) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* o = reinterpret_cast<float4*>(out + (arow + i) * kTile + bcol + 32 * q);
      o[0] = make_float4(acc[q][i][0], acc[q][i][1], acc[q][i][2], acc[q][i][3]);
      o[4] = make_float4(acc[q][i][4], acc[q][i][5], acc[q][i][6], acc[q][i][7]);
    }
  }
}

constexpr int kReduceLanes = 32;   // elements of G a reduce block sums
constexpr int kReduceGroups = 8;   // groups splitting each element's partials

// G[i][j] = the sum over splits of the partial tile holding (min, max) of
// (i, j): group q of a block sums splits q, q + 8, ..., then group 0 adds the
// eight in order, so the sum is the same from run to run.
__global__ void __launch_bounds__(kReduceLanes * kReduceGroups)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ g, int n, int T, int tiles, int splits) {
  __shared__ float sums[kReduceGroups][kReduceLanes];
  const int lane = threadIdx.x % kReduceLanes, grp = threadIdx.x / kReduceLanes;
  const long long idx = static_cast<long long>(blockIdx.x) * kReduceLanes + lane;
  const bool in = idx < static_cast<long long>(n) * n;
  float s = 0.f;
  if (in) {
    const int i = static_cast<int>(idx / n), j = static_cast<int>(idx % n);
    const int a = i < j ? i : j, b = i < j ? j : i;  // (a, b) lies in upper tile (a/128, b/128)
    const int I = a / kTile, J = b / kTile;
    const int t = I * T - I * (I - 1) / 2 + (J - I);
    const float* p = part + static_cast<long long>(t) * kTile * kTile + (a % kTile) * kTile + (b % kTile);
    const long long stride = static_cast<long long>(tiles) * kTile * kTile;
    for (int q = grp; q < splits; q += kReduceGroups) s += p[q * stride];
  }
  sums[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && in) {
    float total = sums[0][lane];
#pragma unroll
    for (int q = 1; q < kReduceGroups; ++q) total += sums[q][lane];
    g[idx] = total;
  }
}

// One block, n <= kMaxSmallN: G and X in shared memory.
__global__ void __launch_bounds__(kFactorThreads)
chol_inv_small_kernel(const float* __restrict__ g, float* __restrict__ r, float* __restrict__ rinv, int n) {
  extern __shared__ float smem[];
  __shared__ int bad;
  const int nn = n * n;
  float* col = smem;        // the current column of L
  float* A = smem + n;      // G, then L in its lower triangle
  float* X = smem + n + nn; // L^-1
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  for (int e = tid; e < nn; e += nt) A[e] = g[e];
  if (tid == 0) bad = 0;
  __syncthreads();

  // right-looking Cholesky on the lower triangle of A, in place
  for (int j = 0; j < n; ++j) {
    const float d = A[j * n + j];
    if (!(d > 0.f)) {  // uniform: every thread read the same pivot
      if (tid == 0) bad = 1;
      break;
    }
    const float s = sqrtf(d);
    for (int i = j + 1 + tid; i < n; i += nt) {
      const float c = A[i * n + j] / s;
      col[i] = c;
      A[i * n + j] = c;
    }
    __syncthreads();
    if (tid == 0) A[j * n + j] = s;
    for (int i = j + 1 + warp; i < n; i += nwarps) {
      const float ci = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32) A[i * n + k] = fmaf(-ci, col[k], A[i * n + k]);
    }
    __syncthreads();
  }
  __syncthreads();

  if (!bad) {
    // X = L^-1 by right-looking forward substitution from X = I: once the
    // rows above j have been applied, row j is final after dividing by
    // L[j][j]; only its columns c <= j are nonzero
    for (int e = tid; e < nn; e += nt) X[e] = (e / n == e % n) ? 1.f : 0.f;
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float ljj = A[j * n + j];
      for (int c = tid; c <= j; c += nt) X[j * n + c] = X[j * n + c] / ljj;
      for (int i = j + 1 + tid; i < n; i += nt) col[i] = A[i * n + j];
      __syncthreads();
      for (int i = j + 1 + warp; i < n; i += nwarps) {
        const float li = col[i];
        for (int c = lane; c <= j; c += 32) X[i * n + c] = fmaf(-li, X[j * n + c], X[i * n + c]);
      }
      __syncthreads();
    }
  }

  const float nan = __int_as_float(0x7fc00000);
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, k = e % n;
    if (bad) {
      r[e] = k >= i ? nan : 0.f;
      rinv[e] = nan;
    } else {
      r[e] = k >= i ? A[k * n + i] : 0.f;
      rinv[e] = k >= i ? X[k * n + i] : 0.f;
    }
  }
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// All blocks of the cooperative launch meet here; `arrived` counts arrivals
// over the whole launch, and barrier k completes at (k + 1) * gridDim.x.
__device__ __forceinline__ void grid_barrier(unsigned int* arrived, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    while (load_acquire(arrived) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The wide factorisation (n > kMaxSmallN): a blocked, right-looking
// Cholesky and inverse in 64-column blocks, one cooperative launch of one
// block per SM, G (A) and the inverse (Y) in the global workspace, which
// the 50 MB L2 holds.  Interval j, between two grid barriers, holds
//   phase 1 of block column j: every block that owns a tile of block row
//     or column j applies the update of column j - 1 to A_jj itself
//     (A_jj - L_j,j-1 L_j,j-1^T) and factors it (factor_diag: the same code
//     on the same data, so all agree bitwise on L_jj, L_jj^-1 and on a
//     failed pivot); then it updates and forms its tile: a panel tile
//     L_ij = (A_ij - L_i,j-1 L_j,j-1^T) L_jj^-T (i > j), or a tile of
//     X = L^-1's block row j, X_jm = L_jj^-1 (B_jm - L_j,j-1 X_j-1,m)
//     (m < j).  The block owning tile j writes R's diagonal block and the
//     failure flag;
//   phase 2 of block column j - 1, on the other blocks first: the rest of
//     its update, A_ik -= L_i,j-1 L_k,j-1^T for j < k <= i and
//     B_im -= L_i,j-1 X_j-1,m for i > j, m < j (the block forward
//     substitution on B = I, which leaves X in Y), one 64^3 product a tile.
// So the launch makes nb = ceil(n / 64) grid barriers (16 at n = 1024,
// against n + 1 of a column-by-column loop), and the update of column j
// overlaps the factorisation of column j + 1.  No value is written by one
// block and read by another within an interval; values another block
// wrote are read with ld.global.cg (L2, not the SM's incoherent L1).
constexpr int kB = 64;                // columns per block of the factorisation
constexpr int kLd = kB + 1;           // padded row of a staged tile: no bank conflicts
constexpr int kBlockedThreads = 256;  // 16 x 16 threads, 4 x 4 of a 64 x 64 tile each

struct BlockedSmem {
  float lp[kB * kLd];     // phase 1: L_j,j-1^T
  float q[kB * kLd];      // phase 1: L_jj^-T after factor_diag
  float p[kB * kLd];      // a staged tile
  float row[2][4 * kB];   // factor_diag: rows k, k + 1 of [G | E], double-buffered
  float piv[kB];          // factor_diag: the pivots
};

// dst[r][c] = src[r0 + r][c0 + c] (kTrans: dst[c][r]) for r < rows, c < cols,
// else 0; src has row pitch n
template <bool kTrans>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int n, int r0, int c0, int rows,
                                           int cols) {
  constexpr int kPer = kB * kB / kBlockedThreads;
  float v[kPer];  // all loads in flight before the first store
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kBlockedThreads, r = e / kB, c = e % kB;
    v[u] = (r < rows && c < cols) ? __ldcg(src + static_cast<long long>(r0 + r) * n + c0 + c) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kBlockedThreads, r = e / kB, c = e % kB;
    dst[kTrans ? c * kLd + r : r * kLd + c] = v[u];
  }
}

// acc[a][b] = sum_k P[k][ty + 16 a] Q[k][tx + 16 b] over staged tiles
__device__ __forceinline__ void tile_product(const float* P, const float* Q, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int k = 0; k < kB; ++k) {
    float pa[4], qb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[a] = P[k * kLd + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < 4; ++b) qb[b] = Q[k * kLd + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(pa[a], qb[b], acc[a][b]);
  }
}

// Factor the diagonal block G, whose elements (ty + 16 a, tx + 16 b) each
// thread holds in g (padded to 64 with the identity), by symmetric
// elimination of [G | I]: step k takes row k of the upper triangle of G's
// Schur complement and of E, and each later row i loses G[k][i] / G[k][k]
// times it.  What is left is G's upper triangle U = D^1/2 L^T and
// E = D^1/2 L^-1, D the pivots, in registers; one block barrier per two
// steps.
// Leaves L^-T in s.q (s.q[c][i] = L^-1[i][c]); with `store`, writes R's
// diagonal block (R = L^T) to r at (j0, j0), bs x bs.  Returns false, in
// every thread, at a pivot that is not positive (or NaN).
__device__ bool factor_diag(float (&g)[4][4], int n, int j0, int bs, BlockedSmem& s, bool store, float* r) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float e[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) e[a][b] = ty + 16 * a == tx + 16 * b ? 1.f : 0.f;
  if (ty < 2)  // rows 0 and 1
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s.row[0][2 * kB * ty + tx + 16 * b] = g[0][b];
      s.row[0][2 * kB * ty + kB + tx + 16 * b] = e[0][b];
    }
  __syncthreads();
  // Two steps per block barrier: the buffer holds rows k and k + 1 as
  // they stand after step k - 1, and every thread applies step k to the
  // values of row k + 1 it needs, with the same operations as row k + 1's
  // owner, so the result is bitwise that of one step per barrier.
  bool ok = true;
  for (int k = 0; k < kB; k += 2) {
    const float* rb = s.row[(k / 2) & 1];
    const float *g0 = rb, *e0 = rb + kB, *g1 = rb + 2 * kB, *e1 = rb + 3 * kB;
    const float d0 = g0[k], p1 = g0[k + 1], q1 = g1[k + 1];
    float g0i[4], g1i[4], g0c[4], e0c[4], g1c[4], e1c[4];  // loaded at once
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      g0i[a] = g0[ty + 16 * a];
      g1i[a] = g1[ty + 16 * a];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      g0c[b] = g0[tx + 16 * b];
      e0c[b] = e0[tx + 16 * b];
      g1c[b] = g1[tx + 16 * b];
      e1c[b] = e1[tx + 16 * b];
    }
    if (!(d0 > 0.f)) {  // uniform: every thread read the same pivot
      ok = false;
      break;
    }
    const float inv0 = __frcp_rn(d0);
    const float m1 = p1 * inv0;  // row k + 1's factor in step k
    const float d1 = fmaf(-m1, p1, q1);
    if (!(d1 > 0.f)) {
      ok = false;
      break;
    }
    if (threadIdx.x == 0) {
      s.piv[k] = d0;
      s.piv[k + 1] = d1;
    }
    const float inv1 = __frcp_rn(d1);
    // step k: row i loses m_i = G[k][i] / G[k][k] times row k; rows and
    // columns up to k are final, and a zero factor leaves them as they are
    // without a branch (E's row k is 0 right of k).  Then step k + 1 with
    // row k + 1 as step k left it.
    float mi0[4], wc0[4], mi1[4], wc1[4], ec1[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      mi0[a] = i > k ? g0i[a] * inv0 : 0.f;
      const float r1 = fmaf(-m1, i > k ? g0i[a] : 0.f, g1i[a]);
      mi1[a] = i > k + 1 ? r1 * inv1 : 0.f;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b;
      wc0[b] = c > k ? g0c[b] : 0.f;
      const float r1 = fmaf(-m1, wc0[b], g1c[b]);
      wc1[b] = c > k + 1 ? r1 : 0.f;
      ec1[b] = fmaf(-m1, e0c[b], e1c[b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        g[a][b] = fmaf(-mi1[a], wc1[b], fmaf(-mi0[a], wc0[b], g[a][b]));
        e[a][b] = fmaf(-mi1[a], ec1[b], fmaf(-mi0[a], e0c[b], e[a][b]));
      }
    if (k + 2 < kB) {
      float* nb = s.row[(k / 2 + 1) & 1];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i == k + 2 || i == k + 3) {
          float* dst = nb + (i - k - 2) * 2 * kB;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            dst[tx + 16 * b] = g[a][b];
            dst[kB + tx + 16 * b] = e[a][b];
          }
        }
      }
    }
    __syncthreads();
  }
  if (!ok) return false;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    const float si = sqrtf(s.piv[i]), inv = 1.f / si;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b;
      s.q[c * kLd + i] = c <= i ? e[a][b] * inv : 0.f;
      if (store && i <= c && c < bs) r[static_cast<long long>(j0 + i) * n + j0 + c] = c == i ? si : g[a][b] * inv;
    }
  }
  __syncthreads();
  return true;
}

// dst[r0 + r][c0 + c] = acc (kSub: dst -= acc) for r < rows, c < cols
template <bool kSub>
__device__ __forceinline__ void put_tile(float* dst, int n, int r0, int c0, int rows, int cols,
                                         const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float old[4][4];  // all loads in flight before the first store
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = ty + 16 * a, c = tx + 16 * b;
      old[a][b] = kSub && r < rows && c < cols ? __ldcg(dst + static_cast<long long>(r0 + r) * n + c0 + c) : 0.f;
    }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = ty + 16 * a, c = tx + 16 * b;
      if (r < rows && c < cols) dst[static_cast<long long>(r0 + r) * n + c0 + c] = kSub ? old[a][b] - acc[a][b] : acc[a][b];
    }
}

__global__ void __launch_bounds__(kBlockedThreads)
chol_inv_blocked_kernel(float* __restrict__ A, float* __restrict__ Y, float* __restrict__ r,
                        float* __restrict__ rinv, unsigned int* __restrict__ sync, int n) {
  extern __shared__ float4 smem4[];
  BlockedSmem& s = *reinterpret_cast<BlockedSmem*>(smem4);
  unsigned int* arrived = sync;      // grid barrier arrivals
  unsigned int* failed = sync + 1;   // set by the block that found a bad pivot
  const int nb = (n + kB - 1) / kB;
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // B = I: Y's lower tiles off the diagonal start at 0 (X_jj is written
  // whole in phase 1 of column j, and nothing reads Y's upper tiles)
  for (int i = blk; i < n; i += nblk)
    for (int c = threadIdx.x; c < i / kB * kB; c += kBlockedThreads) Y[static_cast<long long>(i) * n + c] = 0.f;

  bool bad = false;
  for (int j = 0; j < nb; ++j) {
    const int j0 = j * kB, bs = min(kB, n - j0), p0 = j0 - kB;  // p0: column j - 1
    float acc[4][4];
    // ------------------------------------------------ phase 1, column j
    if (blk < nb) {
      const bool lead = j % nblk == blk;
      if (j > 0) {  // L_j,j-1 L_j,j-1^T
        stage_tile<true>(s.lp, A, n, j0, p0, bs, kB);
        __syncthreads();
        tile_product(s.lp, s.lp, acc);
      }
      float g[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = ty + 16 * a, c = tx + 16 * b;
          g[a][b] = i < bs && c < bs ? __ldcg(A + static_cast<long long>(j0 + i) * n + j0 + c) - (j > 0 ? acc[a][b] : 0.f)
                                     : (i == c ? 1.f : 0.f);
        }
      if (!factor_diag(g, n, j0, bs, s, lead, r)) {
        if (lead && threadIdx.x == 0) *failed = 1u;
      } else {
        for (int t = blk; t < nb; t += nblk) {
          const int t0 = t * kB, rows = min(kB, n - t0);
          if (t > j) {  // panel tile L_tj = (A_tj - L_t,j-1 L_j,j-1^T) L_jj^-T
            if (j > 0) {
              stage_tile<true>(s.p, A, n, t0, p0, rows, kB);
              __syncthreads();
              tile_product(s.p, s.lp, acc);
              __syncthreads();
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) {  // the updated tile, transposed
                const int i = ty + 16 * a, c = tx + 16 * b;
                s.p[c * kLd + i] = i < rows && c < bs
                    ? __ldcg(A + static_cast<long long>(t0 + i) * n + j0 + c) - (j > 0 ? acc[a][b] : 0.f) : 0.f;
              }
            __syncthreads();
            tile_product(s.p, s.q, acc);
            put_tile<false>(A, n, t0, j0, rows, bs, acc);
          } else if (t < j) {  // X_jt = L_jj^-1 (B_jt - L_j,j-1 X_j-1,t)
            stage_tile<false>(s.p, Y, n, p0, t0, kB, kB);
            __syncthreads();
            tile_product(s.lp, s.p, acc);
            __syncthreads();
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) {  // the updated tile
                const int i = ty + 16 * a, c = tx + 16 * b;
                s.p[i * kLd + c] = i < bs ? __ldcg(Y + static_cast<long long>(j0 + i) * n + t0 + c) - acc[a][b] : 0.f;
              }
            __syncthreads();
            tile_product(s.q, s.p, acc);
            put_tile<false>(Y, n, j0, t0, bs, kB, acc);
          } else {  // X_jj = L_jj^-1, written by the lead (the owner of tile j)
            for (int e = threadIdx.x; e < kB * kB; e += kBlockedThreads) {
              const int i = e / kB, c = e % kB;
              if (i < bs && c < bs) Y[static_cast<long long>(j0 + i) * n + j0 + c] = s.q[c * kLd + i];
            }
          }
          __syncthreads();  // s.p is staged anew for the next tile
        }
      }
    }
    // -------------------------------- phase 2, column j - 1, the rest
    if (j > 0) {
      const int rest = nb - j - 1;  // block rows below j
      const int trailing = rest * (rest + 1) / 2;
      const int total = trailing + rest * j;
      // tile w goes to block (w + nb) % nblk: the blocks of phase 1 come last
      for (int w = ((blk - nb) % nblk + nblk) % nblk; w < total; w += nblk) {
        if (w < trailing) {  // A_ik -= L_i,j-1 L_k,j-1^T, j < k <= i
          int i = 0, k = w;
          while (k > i) {
            k -= i + 1;
            ++i;
          }
          const int i0 = (j + 1 + i) * kB, k0 = (j + 1 + k) * kB;
          const int ri = min(kB, n - i0), rk = min(kB, n - k0);
          stage_tile<true>(s.p, A, n, i0, p0, ri, kB);
          stage_tile<true>(s.q, A, n, k0, p0, rk, kB);
          __syncthreads();
          tile_product(s.p, s.q, acc);
          put_tile<true>(A, n, i0, k0, ri, rk, acc);
        } else {  // B_im -= L_i,j-1 X_j-1,m, i > j, m < j
          const int v = w - trailing;
          const int i0 = (j + 1 + v / j) * kB, m0 = (v % j) * kB;
          const int ri = min(kB, n - i0);
          stage_tile<true>(s.p, A, n, i0, p0, ri, kB);
          stage_tile<false>(s.q, Y, n, p0, m0, kB, kB);
          __syncthreads();
          tile_product(s.p, s.q, acc);
          put_tile<true>(Y, n, i0, m0, ri, kB, acc);
        }
        __syncthreads();
      }
    }
    grid_barrier(arrived, static_cast<unsigned int>(j + 1) * nblk);
    if (__ldcg(failed)) {  // uniform over the grid: all read it after the same barrier
      bad = true;
      break;
    }
  }

  // R = L^T and R^-1 = X^T by 64 x 64 tiles through shared memory; R's
  // diagonal blocks on and above the diagonal were written in phase 1
  const float nan = __int_as_float(0x7fc00000);
  for (int w = blk; w < nb * nb; w += nblk) {
    const int I = w / nb, K = w % nb, i0 = I * kB, k0 = K * kB;
    const int ri = min(kB, n - i0), rk = min(kB, n - k0);
    if (!bad && I <= K) {
      stage_tile<false>(s.p, A, n, k0, i0, rk, ri);
      stage_tile<false>(s.q, Y, n, k0, i0, rk, ri);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kB * kB; e += kBlockedThreads) {
      const int a = e / kB, b = e % kB;
      if (a >= ri || b >= rk) continue;
      const int i = i0 + a, k = k0 + b;
      const long long o = static_cast<long long>(i) * n + k;
      if (bad) {
        r[o] = k >= i ? nan : 0.f;
        rinv[o] = nan;
      } else if (k < i) {
        r[o] = 0.f;
        rinv[o] = 0.f;
      } else {
        if (I != K) r[o] = s.p[b * kLd + a];
        rinv[o] = s.q[b * kLd + a];
      }
    }
    __syncthreads();
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms;
}

// Gram blocks the card runs at once (both variants use the same resources)
int gram_slots() {
  int per_sm = 0;
  if (cudaFuncSetAttribute(gram_partial_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kGramSmem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_partial_kernel<true>, kGramThreads, kGramSmem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;  // sizes the plan only: a launch that cannot run reports its error
  return sm_count() * per_sm;
}

}  // namespace

// Plain C entry points, loaded with ctypes.
//
// heat_qr_panel_workspace_f32: floats of workspace the panel pass needs.
extern "C" long long heat_qr_panel_workspace_f32(long long m, int n) {
  return static_cast<long long>(workspace_floats(make_plan(m, n, gram_slots()), n));
}

// heat_qr_panel_f32: x (m, n) contiguous row-major f32, m >= n >= 2; r and
// rinv (n, n); work as sized above.  Returns the first launch error's
// cudaError_t (0 on success).
extern "C" int heat_qr_panel_f32(const float* x, float* r, float* rinv, float* work, long long m, int n,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(m, n, gram_slots());
  float* part = work;
  float* g = part + static_cast<size_t>(p.splits) * p.tiles * kTile * kTile;
  float* y = g + static_cast<size_t>(n) * n;
  unsigned int* sync = reinterpret_cast<unsigned int*>(y + static_cast<size_t>(n) * n);

  // 16-byte copies where x's base and row pitch allow them, 4-byte ones otherwise
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto gram = vec ? gram_partial_kernel<true> : gram_partial_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(gram, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kGramSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gram<<<dim3(p.tiles, p.splits), kGramThreads, kGramSmem, s>>>(x, part, m, n, p.tiles_per_side, p.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long nn = static_cast<long long>(n) * n;
  gram_reduce_kernel<<<static_cast<unsigned int>((nn + kReduceLanes - 1) / kReduceLanes),
                       kReduceLanes * kReduceGroups, 0, s>>>(part, g, n, p.tiles_per_side, p.tiles, p.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (p.small) {
    err = cudaFuncSetAttribute(chol_inv_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_inv_small_kernel<<<1, kFactorThreads, p.smem, s>>>(g, r, rinv, n);
    return static_cast<int>(cudaGetLastError());
  }
  // one block per SM, all co-resident
  constexpr size_t smem = sizeof(BlockedSmem);
  err = cudaFuncSetAttribute(chol_inv_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int occupancy = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, chol_inv_blocked_kernel, kBlockedThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaMemsetAsync(sync, 0, 2 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nint = n;
  void* args[] = {(void*)&g, (void*)&y, (void*)&r, (void*)&rinv, (void*)&sync, (void*)&nint};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chol_inv_blocked_kernel), dim3(sm_count()),
                                    dim3(kBlockedThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
