// Blocked GEMM on Hopper (sm_90a).
//
// Replaces the TPU kernel heat_tpu/ops/matmul.py::_mm_kernel (K2):
//     c = a @ b,   a (m, k), b (k, n), c (m, n) in a's dtype,
// with the k loop innermost and an f32 accumulator, as the Pallas kernel
// carried its (bm, bn) f32 scratch across the sequential k grid axis.
//
// What bounds it.  At the benchmark's 8192^2 the product is 2 * 8192^3 =
// 1.1e12 flops against 3 * 8192^2 values moved: at 67 TFLOP/s f32 outside
// the tensor cores the flops take ~16 ms, the bytes ~0.24 ms.  So it is
// bound by operations, and the design is a register-tiled GEMM that keeps
// the FMA units fed from shared memory:
//   * one block of 256 threads per 128 x 128 tile of c; the k loop runs
//     inside the block over 8-deep slices of a and b staged in shared
//     memory (a stored transposed, rows padded to 132 floats so that its
//     stores do not conflict on banks and its rows stay 16-byte aligned);
//   * each thread keeps an 8 x 8 block of c in registers, rows
//     {4 ty .. 4 ty + 3, 64 + 4 ty ..} and likewise in columns, and reads
//     its operands as float4 from shared memory: 64 FMAs per 4 loads.
// The ragged edges in m, n and k are masked in the kernel (loads past an
// edge read 0, stores past it are skipped) where the JAX wrapper padded the
// operands to block multiples and sliced the result.  f32 is IEEE FMA,
// never TF32; bf16 and f16 are converted to f32 on load and rounded once
// on store (__float2bfloat16_rn, __float2half_rn).  Tensor cores (wgmma for
// bf16), TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, LD = BM + 4, NT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

template <typename T>
__global__ void __launch_bounds__(NT)
mm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[BK][LD];  // a's slice, transposed
  __shared__ __align__(16) float bs[BK][LD];  // b's slice

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, cc = e % BK;
      const long long row = m0 + r;
      const int col = k0 + cc;
      as[cc][r] = (row < m && col < k) ? to_f32(a[row * k + col]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, cc = e % BN;
      const int row = k0 + r;
      const long long col = n0 + cc;
      bs[r][cc] = (row < k && col < n) ? to_f32(b[static_cast<long long>(row) * n + col]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col < n) c[row * n + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mm_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                       static_cast<T*>(c), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  a (m, k), b (k, n) and c (m, n)
// are contiguous row-major, of one dtype (0 f32, 1 bf16, 2 f16), on the
// current device; m, n >= 1, k >= 0, ceil(m/128) <= 65535.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int heat_matmul(const void* a, const void* b, void* c, int m, int n, int k, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(a, b, c, m, n, k, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(a, b, c, m, n, k, s));
    case 2: return static_cast<int>(launch<__half>(a, b, c, m, n, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
