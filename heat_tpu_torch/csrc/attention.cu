// Flash attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel heat_tpu/ops/attention.py::_flash_kernel (K3):
//     o[b, i] = sum_j softmax_j(s[b, i, :]) v[b, j],   s = scale * q[b, i] . k[b, j]
// over (B*H, S, D) tensors, computed as an online softmax over key tiles with
// a running max m, a normaliser l and an f32 accumulator, so the (S, S)
// score matrix never reaches device memory.  The semantics are the JAX
// kernel's, line for line:
//   * masked scores (key padding k >= sk; causal k > q, top-left aligned on
//     absolute indices, also when sq != sk) are set to the finite -1e30;
//   * m starts at -1e30 and l at 0; p = exp(s - m_new), and the running l
//     and accumulator are rescaled by exp(m_old - m_new);
//   * a key tile wholly above the causal diagonal is skipped;
//   * a row whose l stays 0 outputs 0;
//   * all arithmetic is f32; bf16 and f16 inputs are converted on load and
//     the output is rounded to q's dtype on store (__float2bfloat16_rn,
//     __float2half_rn).
//
// What bounds it.  At the benchmark's (16, 4096, 128) a non-causal call does
// 4 * 16 * 4096^2 * 128 = 1.4e11 flops and moves 4 * 16 * 4096 * 128 values:
// at 67 TFLOP/s f32 (no tensor cores here) the flops take ~2 ms, the bytes
// ~0.04 ms.  So it is bound by operations, and the design keeps the
// products on chip:
//   * one block of 256 threads per (batch*head, 64-row query tile), looping
//     over 64-key tiles; the Q tile stays in shared memory for the whole
//     loop, K (stored transposed) and then V pass through one shared buffer;
//   * each thread holds a 4 x 4 block of the score tile in registers (rows
//     ty + 16 i, columns tx + 16 j), so a row's 64 scores sit in one
//     half-warp and its max and sum are butterfly shuffles;
//   * each thread accumulates its 4 rows x DMAX/16 columns of the output in
//     registers; P passes through shared memory between the two products;
//   * the row strides are padded so that neither product's shared-memory
//     reads conflict on banks.
// The TPU's (512, 2048) blocks were sized for VMEM and are not carried over;
// ragged edges in sq, sk and d are masked in the kernel instead of padding
// copies on the host.  Products are IEEE f32 FMAs (no TF32); expf, not
// __expf.  Every row's sums run in a fixed order, so reruns are bitwise
// equal.  Tensor cores (mma.sync / wgmma for bf16), TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

template <int DMAX>
struct Smem {
  static constexpr int QLD = DMAX + 1;  // Q rows
  static constexpr int KLD = BK + 1;    // K^T rows (one per feature)
  static constexpr int VLD = DMAX;      // V rows
  static constexpr int PLD = BK + 1;    // P rows
  static constexpr int Q = BQ * QLD;
  static constexpr int KV = (DMAX * KLD > BK * VLD) ? DMAX * KLD : BK * VLD;
  static constexpr int P = BQ * PLD;
  static constexpr size_t bytes = sizeof(float) * (Q + KV + P);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int sq, int sk, int d, float scale, int causal) {
  using S = Smem<DMAX>;
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kv = qs + S::Q;
  float* ps = kv + S::KV;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long bh = blockIdx.x;
  // the heaviest causal tiles (the last rows) are dispatched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  T* ob = o + bh * sq * d;

  for (int e = tid; e < BQ * DMAX; e += NT) {
    const int r = e / DMAX, c = e % DMAX;
    qs[r * S::QLD + c] = (q0 + r < sq && c < d) ? to_f32(qb[static_cast<long long>(q0 + r) * d + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int ntiles = (sk + BK - 1) / BK;
  if (causal) ntiles = min(ntiles, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P.V is done with kv and ps; Q is loaded
    for (int e = tid; e < BK * DMAX; e += NT) {
      const int r = e / DMAX, c = e % DMAX;
      kv[c * S::KLD + r] = (k0 + r < sk && c < d) ? to_f32(kb[static_cast<long long>(k0 + r) * d + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * S::QLD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kv[c * S::KLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj < sk && (!causal || qi >= kj);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 64 scores live in the 16 lanes of this half-warp
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * S::PLD + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // every thread is done reading K^T

    for (int e = tid; e < BK * DMAX; e += NT) {
      const int r = e / DMAX, c = e % DMAX;
      kv[r * S::VLD + c] = (k0 + r < sk && c < d) ? to_f32(vb[static_cast<long long>(k0 + r) * d + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * S::PLD + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = kv[j * S::VLD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];  // a row with no live key outputs 0
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[static_cast<long long>(row) * d + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   int d, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = Smem<DMAX>::bytes;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DMAX><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                     int d, float scale, int causal, cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  return launch<T, 256>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (bh, sq, d), k and v (bh, sk, d)
// and o (bh, sq, d) are contiguous, of one dtype (0 f32, 1 bf16, 2 f16), on
// the current device; bh >= 1, sq >= 1, 1 <= d <= 256, ceil(sq/64) <= 65535.
// Returns the launch's cudaError_t (0 on success).
extern "C" int heat_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                    int sq, int sk, int d, float scale, int causal, int dtype,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256 || bh < 1 || sq < 1 || sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch<float>(q, k, v, o, bh, sq, sk, d, scale, causal, s));
    case 1: return static_cast<int>(dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, causal, s));
    case 2: return static_cast<int>(dispatch<__half>(q, k, v, o, bh, sq, sk, d, scale, causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
