// Blocked GEMM on Hopper (sm_90a).
//
// Replaces the TPU kernel heat_tpu/ops/matmul.py::_mm_kernel (K2):
//     c = a @ b,   a (m, k), b (k, n), c (m, n) in a's dtype,
// with the k loop innermost and an f32 accumulator, as the Pallas kernel
// carried its (bm, bn) f32 scratch across the sequential k grid axis; the
// output is rounded once to a's dtype (__float2bfloat16_rn, __float2half_rn).
//
// Two kernels behind one entry point, chosen by the dtype.
//
// f32: mm_kernel, IEEE FMAs on the CUDA cores, never TF32.  At the
// benchmark's 8192^2 the product is 2 * 8192^3 = 1.1e12 flops against
// 3 * 8192^2 values moved: at 67 TFLOP/s the flops take ~16 ms, the bytes
// ~0.24 ms.  So it is bound by operations, and the design is a
// register-tiled GEMM that keeps the FMA units fed from shared memory:
//   * one block of 256 threads per 128 x 128 tile of c; the k loop runs
//     inside the block over 8-deep slices of a and b staged in shared
//     memory (a stored transposed, rows padded to 132 floats so that its
//     stores do not conflict on banks and its rows stay 16-byte aligned);
//   * each thread keeps an 8 x 8 block of c in registers, rows
//     {4 ty .. 4 ty + 3, 64 + 4 ty ..} and likewise in columns, and reads
//     its operands as float4 from shared memory: 64 FMAs per 4 loads.
// Ragged edges in m, n and k are masked in the kernel (loads past an edge
// read 0, stores past it are skipped).
//
// bf16 / f16: mm_tc_kernel, on the tensor cores.  At 8192^2 the flops take
// 1.11 ms at the 989 TFLOP/s dense peak and the bytes 0.12 ms: operations
// again.  The design:
//   * one block of 384 threads per 128 x 128 tile of c: warpgroup 0 is the
//     producer and gives its registers to warpgroups 1 and 2 (setmaxnreg
//     40 / 232), the consumers, 64 rows x 128 columns each;
//   * one producer thread keeps a ring of 6 stages full by TMA: a's
//     128 x 64 tile (K-major) and b's 64 x 128 tile as two 64 x 64 boxes
//     (b (k, n) row-major is MN-major: the transpose bit, no transpose on
//     the host), 128-byte swizzle, a "full" and an "empty" mbarrier a stage;
//   * each consumer issues four wgmma m64n128k16 a stage into a fresh f32
//     chunk, waits for them, releases the stage and adds the chunk to its
//     master accumulator with IEEE adds, while the other consumer's
//     products run: the tensor cores truncate as they accumulate, and over
//     k = 8192 (512 chained products) that bias alone exceeds one bf16
//     rounding of small outputs; per 64-deep chunk it is negligible.  The
//     2 x 64 accumulators of a thread are why the tile is 128 x 128 and not
//     128 x 256;
//   * blocks walk the tiles in groups of 16 row tiles, so that the
//     resident blocks share a's and b's tiles in L2;
//   * the epilogue rounds the master once to a's type and stores it from
//     registers, masked at the ragged edges.
// TMA fills the parts of a box past m, n or k with zeros, so a k that is
// not a multiple of 64 needs no mask.  TMA also needs 16-byte aligned bases
// and row strides: the wrapper copies an operand whose base is off 16 bytes
// or whose row (k of a, n of b) is not a multiple of 8 elements into an
// aligned buffer of row stride rounded up to 8 (lda, ldb), as the JAX
// wrapper pads (heat_tpu/ops/matmul.py:57-58); there is no cp.async path.
// Products of two 16-bit values are exact in f32, accumulation is f32, and
// the sum runs in one fixed order, so reruns are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, LD = BM + 4, NT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }

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

// ------------------------------------------------ bf16 / f16: tensor cores

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 6, TC_THREADS = 384;
constexpr int TC_GROUP_M = 16;           // row tiles that sweep the columns together
constexpr int TC_A = TC_BM * TC_BK * 2;  // bytes of a's tile
constexpr int TC_B = TC_BK * TC_BN * 2;  // bytes of b's tile: two 64 x 64 boxes
constexpr int TC_STAGE = TC_A + TC_B;
constexpr int TC_ACC = TC_BN / 2;  // f32 accumulators a thread for 64 x TC_BN
constexpr size_t TC_SMEM = 1024 + TC_STAGES * TC_STAGE + 16 * TC_STAGES;

template <typename T>
__global__ void __launch_bounds__(TC_THREADS, 1)
mm_tc_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb, T* __restrict__ c,
             int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on the 1024-byte period of the 128-byte swizzle
  uint8_t* tiles = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + TC_STAGES * TC_STAGE);
  uint64_t* empty = full + TC_STAGES;
  // grouped raster: TC_GROUP_M row tiles walk the column tiles together, so
  // that the card's resident blocks share their a and b tiles in L2
  const int tiles_m = (m + TC_BM - 1) / TC_BM, tiles_n = (n + TC_BN - 1) / TC_BN;
  const int per_group = TC_GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * TC_GROUP_M;
  const int group_m = min(tiles_m - first_m, TC_GROUP_M);
  const int m0 = (first_m + (blockIdx.x % per_group) % group_m) * TC_BM;
  const int n0 = ((blockIdx.x % per_group) / group_m) * TC_BN;
  const int ktiles = (k + TC_BK - 1) / TC_BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 2 * 128);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && ktiles > 0) {
      hopper::prefetch_tensor_map(&ma);
      hopper::prefetch_tensor_map(&mb);
      int stage = 0, phase = 0;
      for (int t = 0; t < ktiles; ++t) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* at = tiles + stage * TC_STAGE;
        uint8_t* bt = at + TC_A;
        hopper::mbar_arrive_expect_tx(&full[stage], TC_STAGE);
        hopper::tma_load_2d(at, &ma, &full[stage], t * TC_BK, m0);
#pragma unroll
        for (int j = 0; j < TC_BN / 64; ++j)
          hopper::tma_load_2d(bt + j * TC_BK * 128, &mb, &full[stage], n0 + 64 * j, t * TC_BK);
        if (++stage == TC_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    // The tensor cores truncate as they add a product into its accumulator,
    // and over a long k that error builds up in one direction.  So each
    // stage's 64-deep product goes to a fresh chunk accumulator, which is
    // added to the master in IEEE f32 (round to nearest) once its group is
    // done; the other consumer warpgroup keeps the tensor cores busy
    // meanwhile.
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;  // rows m0 + 64 cw .. + 63
    float master[TC_ACC], chunk[TC_ACC];
#pragma unroll
    for (int i = 0; i < TC_ACC; ++i) master[i] = chunk[i] = 0.f;
    int stage = 0, phase = 0;
    for (int t = 0; t < ktiles; ++t) {
      const uint32_t a_base = hopper::smem_u32(tiles + stage * TC_STAGE) + cw * 64 * 128;
      const uint32_t b_base = hopper::smem_u32(tiles + stage * TC_STAGE + TC_A);
      hopper::mbar_wait(&full[stage], phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        // a: K-major, the kk-th slice 32 bytes into each 128-byte row; b:
        // MN-major, 16 k rows (2048 bytes) a slice, boxes TC_BK * 128 apart
        const uint64_t da = hopper::desc_sw128(a_base + 32 * kk, 16, 1024);
        const uint64_t db = hopper::desc_sw128(b_base + 2048 * kk, TC_BK * 128, 1024);
        hopper::wgmma_ss<T, TC_BN, 1>(chunk, da, db, kk > 0);  // the first overwrites the chunk
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&empty[stage]);
      hopper::fence_operands(chunk);
#pragma unroll
      for (int i = 0; i < TC_ACC; ++i) master[i] += chunk[i];
      if (++stage == TC_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // thread l of warp w holds rows 16 w + l/4 (+ 8), columns 8 j + 2 (l % 4) (+ 1)
    const int lane = threadIdx.x % 32;
    const int row0 = m0 + 64 * cw + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
    for (int i = 0; i < TC_ACC; i += 2) {
      const int row = row0 + 8 * ((i / 2) % 2);
      const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
      if (row >= m || col >= n) continue;
      T* dst = c + static_cast<long long>(row) * n + col;
      if (col + 1 < n && n % 2 == 0) {
        *reinterpret_cast<uint32_t*>(dst) = hopper::pack2<T>(master[i], master[i + 1]);
      } else {
        dst[0] = from_f32<T>(master[i]);
        if (col + 1 < n) dst[1] = from_f32<T>(master[i + 1]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_tc(const void* a, const void* b, void* c, int m, int n, int k, int lda, int ldb,
                      cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(mm_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(TC_SMEM));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (lda < k || ldb < n || lda % 8 != 0 || ldb % 8 != 0) return cudaErrorInvalidValue;
  const bool f16 = std::is_same<T, __half>::value;
  // an empty sum (k = 0) loads no tile and writes zeros: its maps stay unset
  CUtensorMap ma = {}, mb = {};
  if (k > 0) {
    const uint64_t da[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
    const uint64_t db[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(k)};
    const uint64_t sa[1] = {2ull * lda}, sb[1] = {2ull * ldb};
    const uint32_t box_a[2] = {TC_BK, TC_BM}, box_b[2] = {64, TC_BK};
    cudaError_t err = hopper::make_tensor_map(&ma, a, f16, 2, da, sa, box_a);
    if (err == cudaSuccess) err = hopper::make_tensor_map(&mb, b, f16, 2, db, sb, box_b);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = static_cast<long long>((m + TC_BM - 1) / TC_BM) * ((n + TC_BN - 1) / TC_BN);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  mm_tc_kernel<T><<<static_cast<unsigned>(blocks), TC_THREADS, TC_SMEM, stream>>>(ma, mb, static_cast<T*>(c), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  a (m, k) and b (k, n) are
// row-major with row strides lda >= k and ldb >= n elements, c (m, n)
// contiguous; one dtype (0 f32, 1 bf16, 2 f16), on the current device;
// m, n >= 1, k >= 0.  f32 takes lda = k, ldb = n and ceil(m/128) <= 65535;
// bf16 and f16 take 16-byte aligned a and b, and lda, ldb multiples of 8.  Returns the launch's cudaError_t (0 on success).
extern "C" int heat_matmul(const void* a, const void* b, void* c, int m, int n, int k, int lda, int ldb, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      if (lda != k || ldb != n) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<float>(a, b, c, m, n, k, s));
    case 1: return static_cast<int>(launch_tc<__nv_bfloat16>(a, b, c, m, n, k, lda, ldb, s));
    case 2: return static_cast<int>(launch_tc<__half>(a, b, c, m, n, k, lda, ldb, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
