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
// 5e5 x 1001 and 3.35 TB/s; its ~5 m n flops are far below the f32 peak.
// But coordinates depend on each other: coordinate j+1 needs the residual
// after coordinate j, and each needs a sum over all m rows.  On the TPU the
// grid walked 128-coordinate column panels in order with the residual in
// VMEM.  Here one cooperative launch holds one block per SM (no more blocks
// than are co-resident), and each block owns a contiguous range of rows and
// keeps its slice of r in shared memory (in global memory when the slice
// outgrows it; every m is taken).  Per coordinate:
//   1. each block sums x_j . (r + theta_j x_j) over its rows;
//   2. one grid barrier (the partial sums are double-buffered by the
//      coordinate's parity, so one barrier per coordinate suffices);
//   3. every block adds all blocks' partials in the same fixed order, so
//      every block derives the identical new theta_j;
//   4. each block updates its own rows of r.
// Each thread always touches the same rows, so r needs no barrier of its
// own.  The ~n grid barriers (a few microseconds each) likely set the pace,
// not the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxResidualSmem = 200 * 1024;

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

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ xt, float* __restrict__ r_global, const float* __restrict__ theta_in,
             float* __restrict__ theta_out, float* __restrict__ partial, unsigned int* __restrict__ arrived,
             long long m, int n, float lam, long long rows_per_block, int residual_in_smem) {
  extern __shared__ float r_smem[];
  __shared__ float red[kWarps];
  __shared__ float new_theta;
  const unsigned int nb = gridDim.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long rows = m - row0 < rows_per_block ? m - row0 : rows_per_block;
  if (rows < 0) rows = 0;
  float* r = residual_in_smem ? r_smem : r_global + row0;
  if (residual_in_smem)
    for (long long i = threadIdx.x; i < rows; i += kThreads) r[i] = r_global[row0 + i];
  const float fm = static_cast<float>(m);

  for (int j = 0; j < n; ++j) {
    const float* xj = xt + static_cast<long long>(j) * m + row0;
    const float thj = theta_in[j];
    float acc = 0.f;
    for (long long i = threadIdx.x; i < rows; i += kThreads) {
      const float xv = xj[i];
      acc = fmaf(xv, r[i] + thj * xv, acc);
    }
    const float block_total = block_sum(acc, red);
    float* slot = partial + (j & 1) * nb;
    if (threadIdx.x == 0) slot[blockIdx.x] = block_total;
    grid_barrier(arrived, nb * static_cast<unsigned int>(j + 1));
    if (threadIdx.x < 32) {
      // the same order in every block: the same rho everywhere
      float p = 0.f;
      for (unsigned int b = threadIdx.x; b < nb; b += 32) p += __ldcg(slot + b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_down_sync(0xffffffffu, p, o);
      if (threadIdx.x == 0) {
        const float rho = p / fm;
        float nw = rho;
        if (j > 0) {
          const float mag = fabsf(rho) - lam;
          nw = mag > 0.f ? copysignf(mag, rho) : 0.f;
        }
        new_theta = nw;
        if (blockIdx.x == 0) theta_out[j] = nw;
      }
    }
    __syncthreads();
    const float delta = thj - new_theta;
    for (long long i = threadIdx.x; i < rows; i += kThreads) r[i] = fmaf(delta, xj[i], r[i]);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  xt (n, m) contiguous f32 = X^T;
// r (m) holds y - X theta on entry and is overwritten; theta_in (n) is read,
// theta_out (n) written; partial holds 2 * 1024 floats; arrived is one
// unsigned int that must be 0 on entry.  m >= 1, n >= 1.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int heat_lasso_sweep_f32(const float* xt, float* r, const float* theta_in, float* theta_out,
                                    float* partial, unsigned int* arrived, long long m, int n, float lam,
                                    void* stream) {
  int dev = 0, sms = 0, occupancy = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per SM, at most one block per kThreads rows, at most 1024
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > sms) blocks = sms;
  if (blocks > 1024) blocks = 1024;
  long long rows_per_block = (m + blocks - 1) / blocks;
  const size_t want = static_cast<size_t>(rows_per_block) * sizeof(float);
  const int in_smem = want <= kMaxResidualSmem ? 1 : 0;
  const size_t smem = in_smem ? want : 0;
  err = cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxResidualSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, sweep_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(occupancy) * sms < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {(void*)&xt,      (void*)&r, (void*)&theta_in, (void*)&theta_out,      (void*)&partial,
                  (void*)&arrived, (void*)&m, (void*)&n,        (void*)&lam,            (void*)&rows_per_block,
                  (void*)&in_smem};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sweep_kernel), dim3(static_cast<unsigned int>(blocks)),
                                    dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
