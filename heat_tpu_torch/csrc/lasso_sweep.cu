// One coordinate-descent sweep of the Lasso on Hopper (sm_90a).
//
// Replaces the TPU kernel heat_tpu/ops/lasso_sweep.py::_sweep_kernel (K5).
// For j = 0 .. n-1 in order, with the residual r = y - X theta:
//     rho   = x_j . (r + theta_j x_j) / m
//     new   = rho (j = 0, the intercept) or sign(rho) max(|rho| - lam, 0)
//     r    += (theta_j - new) x_j
// in IEEE f32.  X arrives transposed, xt = X^T (n, m) row-major, so each
// coordinate reads one contiguous stretch.
//
// What bounds it.  The sweep must read X once: 4 m n bytes, 0.60 ms at
// 5e5 x 1001 and 3.35 TB/s (the wrapper's r0 = y - X theta GEMV reads it
// once more); its ~5 m n flops (and the block Gram's m n b/2 more) are far
// below the f32 peak.  But coordinates depend on each other,
// and each needs a sum over all m rows, so the card must meet in a grid
// barrier between them.  One barrier per coordinate costs more than the
// column's bytes (~5 us against 0.6 us at 5e5 rows).  So the sweep takes the
// coordinates in blocks B of kB and meets once per block, with the same
// sequential updates:
//     rho_j m = c'_j + sum_{i < j in B} G_ji d_i,   d_i = theta_i - new_i,
//     c'_j    = x_j . (r_B + theta_j x_j),           G_ji = x_j . x_i,
// where r_B is the residual at the block's start.  theta_j x_j is added to r
// element by element, as the classic sweep does: folding it in afterwards as
// theta_j G_jj cancels badly in f32.  One cooperative launch holds one block
// (CTA) per SM; each CTA owns a contiguous range of rows and keeps its slice
// of r (and, where it fits, X_B's values of its rows) in shared memory.
// Per block of coordinates:
//   1. one pass over the CTA's rows: first r += sum_{i in previous B} d_i x_i
//      (x_i from shared memory, or again from L2 where X_B does not fit),
//      then the kB sums c'_j and the kB (kB-1)/2 sums G_ji;
//   2. the CTA's sums: a warp reduce-scatter (each lane ends with kPad/32
//      of them), then the warps added in order; written to a partial slot;
//   3. one grid barrier (the slots are double-buffered by the block's
//      parity, so one barrier per block suffices);
//   4. every CTA adds all CTAs' partials in the same fixed order and solves
//      the kB coordinates in order, so every CTA derives the identical new
//      theta, bit for bit, and reruns are bitwise equal.
// Each thread always touches the same rows, so r needs no barrier of its
// own.  The residual after the last block is not needed and is not formed.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 8;  // coordinates per grid barrier
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowUnroll = 2;  // rows a thread loads before it uses them
constexpr int kValues = kB + kB * (kB - 1) / 2;  // c'_j, then G_ji (i < j)
constexpr int kPad = (kValues + 31) / 32 * 32;
constexpr int kPerLane = kPad / 32;
constexpr size_t kMaxDynamicSmem = 200 * 1024;

__device__ __forceinline__ int gram_at(int j, int i) { return kB + j * (j - 1) / 2 + i; }

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// All blocks of the cooperative launch meet here.  `arrived` counts
// arrivals over the whole launch and is never reset; barrier k completes
// when it reaches (k + 1) * gridDim.x.
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

// One halving step of the reduce-scatter: lanes with `off` set keep the
// upper half of v[0, LEN), the others the lower half, each adding its
// partner's copy.
template <int LEN>
__device__ __forceinline__ void reduce_scatter_step(float* v, bool upper, int off) {
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float send = upper ? v[i] : v[i + LEN / 2];
    const float keep = upper ? v[i + LEN / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Sums v over the warp's 32 lanes: afterwards lane l holds in v[p] the sum
// of value kPerLane * l + p.  A fixed tree, so the same on every run.
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[kPad], int lane) {
  reduce_scatter_step<kPad>(v, lane & 16, 16);
  reduce_scatter_step<kPad / 2>(v, lane & 8, 8);
  reduce_scatter_step<kPad / 4>(v, lane & 4, 4);
  reduce_scatter_step<kPad / 8>(v, lane & 2, 2);
  reduce_scatter_step<kPad / 16>(v, lane & 1, 1);
}

// Sums over the grid's CTAs of the partials of values warp, warp + kWarps,
// ..., each in one fixed order, into tot.  Every load of a round is issued
// before the first add, so one L2 round trip serves up to 256 CTAs.
__device__ __forceinline__ void sum_partials(const float* part, unsigned int nb, int warp, int lane, float* tot) {
  constexpr int kSums = (kValues + kWarps - 1) / kWarps;
  constexpr int kLoads = 8;
  float s[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) s[t] = 0.f;
  for (unsigned int base = 0; base < nb; base += 32 * kLoads) {
    float q[kSums][kLoads];
#pragma unroll
    for (int t = 0; t < kSums; ++t)
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const unsigned int v = warp + t * kWarps, c = base + 32 * u + lane;
        q[t][u] = v < kValues && c < nb ? __ldcg(part + v * nb + c) : 0.f;
      }
#pragma unroll
    for (int t = 0; t < kSums; ++t)
#pragma unroll
      for (int u = 0; u < kLoads; ++u) s[t] += q[t][u];
  }
#pragma unroll
  for (int t = 0; t < kSums; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[t] += __shfl_down_sync(0xffffffffu, s[t], o);
    if (lane == 0 && warp + t * kWarps < kValues) tot[warp + t * kWarps] = s[t];
  }
}

// mode 2: X_B and r in shared memory; 1: r only; 0: neither
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ xt, float* __restrict__ r_global, const float* __restrict__ theta_in,
             float* __restrict__ theta_out, float* __restrict__ work, unsigned int* __restrict__ arrived,
             long long m, int n, float lam, long long rows_per_block, int mode) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps][kPad];
  __shared__ float tot[kValues];
  __shared__ float d_s[kB];
  const unsigned int nb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long rows = m - row0 < rows_per_block ? m - row0 : rows_per_block;
  if (rows < 0) rows = 0;
  const bool x_smem = mode == 2;
  float* xs = smem;
  float* r = mode >= 1 ? smem + (x_smem ? kB * rows_per_block : 0) : r_global + row0;
  if (mode >= 1)
    for (long long i = threadIdx.x; i < rows; i += kThreads) r[i] = r_global[row0 + i];
  const float fm = static_cast<float>(m);
  float* partial = work;  // [2][kValues][nb]
  unsigned int barriers = 0;

  float dprev[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) dprev[k] = 0.f;
  const int steps = (n + kB - 1) / kB;
  for (int step = 0; step < steps; ++step) {
    const int j0 = step * kB;
    const int nbk = n - j0 < kB ? n - j0 : kB;
    const float* xc = xt + static_cast<long long>(j0) * m + row0;
    const float* xp = xc - static_cast<long long>(kB) * m;  // the previous block's columns
    float th[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) th[k] = k < nbk ? __ldg(theta_in + j0 + k) : 0.f;
    float acc[kPad];
#pragma unroll
    for (int v = 0; v < kPad; ++v) acc[v] = 0.f;

    for (long long base = threadIdx.x; base < rows; base += static_cast<long long>(kThreads) * kRowUnroll) {
      float xv[kRowUnroll][kB], rv[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * kThreads;
        const bool ok = i < rows;
#pragma unroll
        for (int k = 0; k < kB; ++k) xv[u][k] = ok && k < nbk ? xc[k * m + i] : 0.f;
        rv[u] = ok ? r[i] : 0.f;
      }
      if (step > 0) {
        // the previous block's updates, in coordinate order
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const long long i = base + static_cast<long long>(u) * kThreads;
          if (i < rows) {
#pragma unroll
            for (int k = 0; k < kB; ++k) rv[u] = fmaf(dprev[k], x_smem ? xs[k * rows_per_block + i] : xp[k * m + i], rv[u]);
            r[i] = rv[u];
          }
        }
      }
      if (x_smem) {
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const long long i = base + static_cast<long long>(u) * kThreads;
          if (i < rows) {
#pragma unroll
            for (int k = 0; k < kB; ++k) xs[k * rows_per_block + i] = xv[u][k];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kB; ++k) acc[k] = fmaf(xv[u][k], rv[u] + th[k] * xv[u][k], acc[k]);
#pragma unroll
        for (int j = 1; j < kB; ++j)
#pragma unroll
          for (int i = 0; i < j; ++i) acc[gram_at(j, i)] = fmaf(xv[u][j], xv[u][i], acc[gram_at(j, i)]);
      }
    }

    // the CTA's sums, in a fixed order
    warp_reduce_scatter(acc, lane);
#pragma unroll
    for (int p = 0; p < kPerLane; ++p) red[warp][kPerLane * lane + p] = acc[p];
    __syncthreads();
    float* part = partial + static_cast<size_t>(step & 1) * kValues * nb;
    if (threadIdx.x < kValues) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
      part[threadIdx.x * nb + blockIdx.x] = s;
    }
    grid_barrier(arrived, nb * ++barriers);
    sum_partials(part, nb, warp, lane, tot);
    __syncthreads();
    if (threadIdx.x == 0) {
      // the block's coordinates in order, each corrected by the earlier
      // ones' changes through the Gram
      float dn[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        dn[j] = 0.f;
        if (j < nbk) {
          float s = tot[j];
#pragma unroll
          for (int i = 0; i < j; ++i) s = fmaf(tot[gram_at(j, i)], dn[i], s);
          const float rho = s / fm;
          float nw = rho;
          if (j0 + j > 0) {
            const float mag = fabsf(rho) - lam;
            nw = mag > 0.f ? copysignf(mag, rho) : 0.f;
          }
          dn[j] = th[j] - nw;
          if (blockIdx.x == 0) theta_out[j0 + j] = nw;
        }
        d_s[j] = dn[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kB; ++k) dprev[k] = d_s[k];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  xt (n, m) contiguous f32 = X^T;
// r (m) holds y - X theta on entry and is overwritten; theta_in (n) is read,
// theta_out (n) written; work holds work_floats floats of scratch (at least
// 2 * kValues * blocks, blocks <= 1024); arrived is one unsigned int
// that must be 0 on entry.  m >= 1, n >= 1.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int heat_lasso_sweep_f32(const float* xt, float* r, const float* theta_in, float* theta_out,
                                    float* work, unsigned int* arrived, long long work_floats, long long m, int n,
                                    float lam, void* stream) {
  int dev = 0, sms = 0, occupancy = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per SM, at most one block per kThreads rows, at most 1024
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > sms) blocks = sms;
  if (blocks > 1024) blocks = 1024;
  if (work_floats < 2LL * kValues * blocks) return static_cast<int>(cudaErrorInvalidValue);
  long long rows_per_block = (m + blocks - 1) / blocks;
  const size_t row_bytes = static_cast<size_t>(rows_per_block) * sizeof(float);
  int mode = 0;
  if ((kB + 1) * row_bytes <= kMaxDynamicSmem)
    mode = 2;
  else if (row_bytes <= kMaxDynamicSmem)
    mode = 1;
  const size_t smem = mode == 2 ? (kB + 1) * row_bytes : (mode == 1 ? row_bytes : 0);
  err = cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxDynamicSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, sweep_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(occupancy) * sms < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {(void*)&xt,      (void*)&r, (void*)&theta_in, (void*)&theta_out, (void*)&work,
                  (void*)&arrived, (void*)&m, (void*)&n,        (void*)&lam,       (void*)&rows_per_block,
                  (void*)&mode};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sweep_kernel), dim3(static_cast<unsigned int>(blocks)),
                                    dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
