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
//   1. gram_partial: one block per (64 x 64 tile of the upper triangle of G)
//      x (chunk of at most 16384 rows).  On the TPU the whole Gram accumulated over a
//      sequential grid axis in one scratch; here the rows are split across
//      blocks so that even n = 128 (3 upper tiles) fills the 132 SMs, and
//      every block writes its partial tile to a workspace.  Only tiles with
//      I <= J are computed: symmetry halves the Gram's work.
//   2. gram_reduce: each element of G sums its partials in a fixed order,
//      so R is the same from run to run (float atomics would not be).
//   3. the factorisation, R = chol(G)^T and R^-1, serial over the n columns:
//      - chol_inv_small (n <= 165): one block of 1024 threads with G and
//        L^-1 in shared memory, two block barriers per column;
//      - chol_inv_coop (wider panels, up to the 1000- and 1024-wide leaves
//        of the QR path): a cooperative launch of one block per SM with G in
//        the global workspace, which the 50 MB L2 holds up to n ~ 2500.
//        Each column's rank-1 update of the trailing triangle is spread over
//        the whole card, and the forward substitution for L^-1 runs one
//        column behind the Cholesky in the same interval, so each column
//        costs one grid barrier.  A first version ran this in one block and
//        took 64 ms at n = 1024, bound by one SM's path to L2.
// A pivot that is not positive (or NaN) latches, as jnp.linalg.cholesky
// does for a matrix it cannot factor: R comes back NaN on and above its
// diagonal (0 below) and R^-1 NaN throughout, so the caller's finiteness
// check falls back to Householder QR.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // edge of a G tile
constexpr int kRowStep = 16;       // rows of x staged in shared memory per step
constexpr int kGramThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr long long kMaxChunk = 16384;  // rows one block sums in a row
constexpr int kFactorThreads = 1024;
constexpr int kCoopThreads = 512;
constexpr int kMaxSmallN = 165;    // 2 n^2 + n floats fit the shared memory a block may use
constexpr int kBlocksPerSm = 4;    // Gram blocks to aim for per SM

struct Plan {
  int tiles_per_side;  // T = ceil(n / 64)
  int tiles;           // T (T + 1) / 2 upper tiles
  int splits;          // row chunks
  long long chunk;     // rows per chunk, a multiple of kRowStep
  bool small;          // factor in one block, in shared memory
  size_t smem;         // dynamic shared memory of chol_inv_small
};

Plan make_plan(long long m, int n, int sms) {
  Plan p;
  p.tiles_per_side = (n + kTile - 1) / kTile;
  p.tiles = p.tiles_per_side * (p.tiles_per_side + 1) / 2;
  long long want = (static_cast<long long>(kBlocksPerSm) * sms + p.tiles - 1) / p.tiles;
  // no block sums more than kMaxChunk rows in one running sum: at
  // 5e5 x 1000 four chunks of 125000 rows lost ~6e-6 of R
  const long long short_chunks = (m + kMaxChunk - 1) / kMaxChunk;
  if (want < short_chunks) want = short_chunks;
  long long max_splits = (m + kRowStep - 1) / kRowStep;
  long long splits = want < max_splits ? want : max_splits;
  if (splits < 1) splits = 1;
  long long chunk = (m + splits - 1) / splits;
  chunk = (chunk + kRowStep - 1) / kRowStep * kRowStep;
  p.chunk = chunk;
  p.splits = static_cast<int>((m + chunk - 1) / chunk);
  p.small = n <= kMaxSmallN;
  p.smem = p.small ? (2 * static_cast<size_t>(n) * n + n) * sizeof(float) : 0;
  return p;
}

// workspace floats: the partial tiles, then G (n x n), Y (n x n) and the
// cooperative kernel's barrier counter
size_t workspace_floats(const Plan& p, int n) {
  return static_cast<size_t>(p.splits) * p.tiles * kTile * kTile + 2 * static_cast<size_t>(n) * n + 1;
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

__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const float* __restrict__ x, float* __restrict__ part, long long m, int n, int T,
                    long long chunk) {
  __shared__ float as[kRowStep][kTile];
  __shared__ float bs[kRowStep][kTile];
  int I, J;
  upper_tile(blockIdx.x, T, I, J);
  const int i0 = I * kTile, j0 = J * kTile;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long r1 = r0 + chunk < m ? r0 + chunk : m;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = r0; k0 < r1; k0 += kRowStep) {
    // coalesced: consecutive threads read consecutive columns of one row
#pragma unroll
    for (int e = tid; e < kRowStep * kTile; e += kGramThreads) {
      const int kk = e / kTile, c = e % kTile;
      const long long row = k0 + kk;
      const bool in = row < r1;
      as[kk][c] = (in && i0 + c < n) ? x[row * n + i0 + c] : 0.f;
      bs[kk][c] = (in && j0 + c < n) ? x[row * n + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowStep; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kTile * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(ty + 16 * i) * kTile + tx + 16 * j] = acc[i][j];
}

__global__ void gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ g, int n, int T,
                                   int tiles, int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * n) return;
  const int i = static_cast<int>(idx / n), j = static_cast<int>(idx % n);
  const int a = i < j ? i : j, b = i < j ? j : i;  // (a, b) lies in upper tile (a/64, b/64)
  const int I = a / kTile, J = b / kTile;
  const int t = I * T - I * (I - 1) / 2 + (J - I);
  const float* p = part + static_cast<long long>(t) * kTile * kTile + (a % kTile) * kTile + (b % kTile);
  const long long stride = static_cast<long long>(tiles) * kTile * kTile;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += p[q * stride];
  g[idx] = s;
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

// Every block of the card, n > kMaxSmallN: G (A) and the unscaled inverse
// (Y) in the global workspace.  Step t of the Cholesky works on the upper
// triangle: R's row t is A's row t over sqrt(A[t][t]), and each later row i
// loses R[t][i] times R's row t.  Step t-1 of the forward substitution for
// X = L^-1 (L = R^T) runs in the same interval: row t-1 of Y is final, and
// each later row i loses L[i][t-1] / L[t-1][t-1] times it; X's row j is Y's
// over L[j][j], applied at the end.  No value is both written and read by
// different blocks within an interval, so one grid barrier per step
// suffices.  Shared values are read with ld.global.cg (L2, not the SM's
// incoherent L1).
__global__ void __launch_bounds__(kCoopThreads)
chol_inv_coop_kernel(float* __restrict__ A, float* __restrict__ Y, float* __restrict__ r,
                     float* __restrict__ rinv, unsigned int* __restrict__ arrived, int n) {
  const long long nn = static_cast<long long>(n) * n;
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long GT = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned int phase = 0;

  for (long long e = gt; e < nn; e += GT) Y[e] = (e / n == e % n) ? 1.f : 0.f;
  grid_barrier(arrived, ++phase * gridDim.x);

  bool bad = false;
  for (int t = 0; t <= n; ++t) {
    if (t < n) {
      const float* At = A + static_cast<long long>(t) * n;
      const float d = __ldcg(At + t);
      if (!(d > 0.f)) {  // uniform over the grid: every thread read the same pivot
        bad = true;
        break;
      }
      const float s = sqrtf(d), inv_s = 1.f / s;
      for (long long k = t + gt; k < n; k += GT) r[static_cast<long long>(t) * n + k] = k == t ? s : __ldcg(At + k) * inv_s;
      // rows i > t, columns k >= i of the trailing upper triangle, laid
      // out as an L x L square with the lower half idle
      const long long L = n - t - 1, total = L * L;
      for (long long base = gt; base < total; base += 4 * GT) {
        float ai[4], ak[4], aik[4];
        long long at[4];
        bool live[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long idx = base + u * GT;
          const long long i = t + 1 + idx / (L > 0 ? L : 1), k = t + 1 + idx % (L > 0 ? L : 1);
          live[u] = idx < total && k >= i;
          at[u] = i * n + k;
          if (live[u]) {
            ai[u] = __ldcg(At + i);
            ak[u] = __ldcg(At + k);
            aik[u] = __ldcg(A + at[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (live[u]) A[at[u]] = fmaf(-(ai[u] * inv_s), ak[u] * inv_s, aik[u]);
      }
    }
    if (t >= 1) {
      const int j = t - 1;
      const float* Rj = r + static_cast<long long>(j) * n;
      const float* Yj = Y + static_cast<long long>(j) * n;
      const float rjj = __ldcg(Rj + j);
      // rows i > j, columns c <= j: an (n-j-1) x (j+1) rectangle
      const long long w = j + 1, total = static_cast<long long>(n - j - 1) * w;
      for (long long base = gt; base < total; base += 4 * GT) {
        float f[4], yj[4], yi[4];
        long long at[4];
        bool live[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long idx = base + u * GT;
          const long long i = j + 1 + idx / w, c = idx % w;
          live[u] = idx < total;
          at[u] = i * n + c;
          if (live[u]) {
            f[u] = __ldcg(Rj + i) / rjj;
            yj[u] = __ldcg(Yj + c);
            yi[u] = __ldcg(Y + at[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (live[u]) Y[at[u]] = fmaf(-f[u], yj[u], yi[u]);
      }
    }
    grid_barrier(arrived, ++phase * gridDim.x);
  }

  const float nan = __int_as_float(0x7fc00000);
  for (long long e = gt; e < nn; e += GT) {
    const long long i = e / n, k = e % n;
    if (bad) {
      r[e] = k >= i ? nan : 0.f;
      rinv[e] = nan;
    } else {
      if (k < i) r[e] = 0.f;  // R's upper triangle was written row by row
      rinv[e] = k >= i ? __ldcg(Y + k * n + i) / __ldcg(r + k * n + k) : 0.f;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms;
}

}  // namespace

// Plain C entry points, loaded with ctypes.
//
// heat_qr_panel_workspace_f32: floats of workspace the panel pass needs.
extern "C" long long heat_qr_panel_workspace_f32(long long m, int n) {
  return static_cast<long long>(workspace_floats(make_plan(m, n, sm_count()), n));
}

// heat_qr_panel_f32: x (m, n) contiguous row-major f32, m >= n >= 2; r and
// rinv (n, n); work as sized above.  Returns the first launch error's
// cudaError_t (0 on success).
extern "C" int heat_qr_panel_f32(const float* x, float* r, float* rinv, float* work, long long m, int n,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(m, n, sm_count());
  float* part = work;
  float* g = part + static_cast<size_t>(p.splits) * p.tiles * kTile * kTile;
  float* y = g + static_cast<size_t>(n) * n;
  unsigned int* arrived = reinterpret_cast<unsigned int*>(y + static_cast<size_t>(n) * n);

  gram_partial_kernel<<<dim3(p.tiles, p.splits), kGramThreads, 0, s>>>(x, part, m, n, p.tiles_per_side,
                                                                      p.chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long nn = static_cast<long long>(n) * n;
  gram_reduce_kernel<<<static_cast<unsigned int>((nn + 255) / 256), 256, 0, s>>>(part, g, n, p.tiles_per_side,
                                                                                p.tiles, p.splits);
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
  int occupancy = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, chol_inv_coop_kernel, kCoopThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaMemsetAsync(arrived, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nint = n;
  void* args[] = {(void*)&g, (void*)&y, (void*)&r, (void*)&rinv, (void*)&arrived, (void*)&nint};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chol_inv_coop_kernel), dim3(sm_count()),
                                    dim3(kCoopThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
