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
// register-tiled GEMM that keeps the FMA units fed from shared memory and
// never waits for device memory:
//   * one block of 256 threads per 128 x 128 tile of c, two blocks an SM
//     (at most 128 registers a thread); each thread keeps an 8 x 8 block of
//     c in registers, rows {4 ty .. 4 ty + 3, 64 + 4 ty ..} and likewise in
//     columns;
//   * the k loop runs over 32-deep stages in a ring of 3 in shared memory
//     (102 KB a block), filled by cp.async two stages ahead, so the next
//     stages' reads are in flight while a stage's FMAs run; one block
//     barrier a stage;
//   * b (k, n) row-major arrives in the layout the outer product wants and
//     is copied straight into its stage; a (m, k) row-major is copied by
//     cp.async into a row-major stage whose rows are padded to 36 floats,
//     and read as float4 along k: 8 rows x 4 k of a and 4 k x 8 columns of
//     b, 16 float4 reads for 256 FMAs, with no bank conflict (a warp reads
//     two rows of a, 16 banks apart), and no registers spent on a transpose;
//   * the copies are 16 bytes wide where an operand's base is 16-byte
//     aligned and its row (k of a, n of b) a multiple of 4 floats, else 4
//     bytes wide: a template flag per operand, one kernel;
//   * blocks walk the tiles in groups of 16 row tiles, so that the
//     resident blocks share a's and b's tiles in L2.
// Ragged edges in m, n and k are masked in the kernel: copies past an edge
// fill zeros and read nothing, stores past it are skipped.  Each output is
// one chain of FMAs in k order, so reruns are bitwise equal.
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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// ------------------------------------------------------- f32: CUDA cores

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, NT = 256, GROUP_M = 16;
constexpr int LDA = BK + 4;  // a's stage rows: 16-byte aligned, float4 reads free of bank conflicts
constexpr int A_STAGE = BM * LDA, B_STAGE = BK * BN, STAGE = A_STAGE + B_STAGE;  // floats
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;

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

// kVecA, kVecB: 16-byte copies of a, of b (base 16-byte aligned, row a
// multiple of 4 floats); else 4-byte copies.  vec_c: c's rows take float4
// stores.
template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(NT, 2)
mm_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int m, int n, int k,
          bool vec_c) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);  // [stage][a: BM x LDA, b: BK x BN]
  // grouped raster: GROUP_M row tiles walk the column tiles together
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (blockIdx.x % per_group) % group_m) * BM;
  const int n0 = ((blockIdx.x % per_group) / group_m) * BN;
  const int steps = (k + BK - 1) / BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // This thread's copies: of a, (kVecA ? 4 : 1) floats at column ac of rows
  // ar + A_PASS u; of b, (kVecB ? 4 : 1) floats at column bc of rows
  // br + B_PASS u.  The pointers step one stage at a time.
  constexpr int A_PER_ROW = kVecA ? BK / 4 : BK, A_PASS = NT / A_PER_ROW, A_PASSES = BM / A_PASS;
  constexpr int B_PER_ROW = kVecB ? BN / 4 : BN, B_PASS = NT / B_PER_ROW, B_PASSES = BK / B_PASS;
  const int ar = tid / A_PER_ROW, ac = (tid % A_PER_ROW) * (kVecA ? 4 : 1);
  const int br = tid / B_PER_ROW, bc = (tid % B_PER_ROW) * (kVecB ? 4 : 1);
  const long long a_pass = static_cast<long long>(A_PASS) * k, b_pass = static_cast<long long>(B_PASS) * n;
  const float* pa = a + static_cast<long long>(m0 + ar) * k + ac;
  const float* pb = b + static_cast<long long>(br) * n + n0 + bc;
  const bool b_in = n0 + bc < n;
  const int a_rows = m - m0 - ar;  // copies of rows ar + A_PASS u < a_rows are in a
  float* const sa = ring + ar * LDA + ac;
  float* const sb = ring + A_STAGE + br * BN + bc;
  int kc = 0;  // k of the next stage to copy
  auto load = [&](int buf) {
    const bool a_in = kc + ac < k;
#pragma unroll
    for (int u = 0; u < A_PASSES; ++u) {
      const bool ok = a_in && A_PASS * u < a_rows;
      cp_async<kVecA ? 16 : 4>(sa + buf * STAGE + A_PASS * u * LDA, ok ? pa + u * a_pass : a, ok);
    }
#pragma unroll
    for (int u = 0; u < B_PASSES; ++u) {
      const bool ok = b_in && kc + br + B_PASS * u < k;
      cp_async<kVecB ? 16 : 4>(sb + buf * STAGE + B_PASS * u * BN, ok ? pb + u * b_pass : b, ok);
    }
    pa += BK;
    pb += static_cast<long long>(BK) * n;
    kc += BK;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // stage s has landed, for this thread's copies
    __syncthreads();              // ... and everyone's; stage s - 1 is free
    if (s + STAGES - 1 < steps) load((s + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* as = ring + (s % STAGES) * STAGE + 4 * ty * LDA;
    const float* bs = ring + (s % STAGES) * STAGE + A_STAGE + 4 * tx;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float av[8][4];  // rows i of a at k = kq .. kq + 3
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(av[i]) = *reinterpret_cast<const float4*>(as + (i < 4 ? i : 60 + i) * LDA + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
    if (row >= m) continue;
    float* out = c + static_cast<long long>(row) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      const float* v = acc[i] + 4 * h;
      if (vec_c && col < n) {  // n % 4 == 0: all four are in
        *reinterpret_cast<float4*>(out + col) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) out[col + j] = v[j];
      }
    }
  }
}

template <bool kVecA, bool kVecB>
cudaError_t launch_f32(const float* a, const float* b, float* c, int m, int n, int k, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(mm_kernel<kVecA, kVecB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(SMEM));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks = static_cast<long long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  const bool vec_c = n % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  mm_kernel<kVecA, kVecB><<<static_cast<unsigned>(blocks), NT, SMEM, stream>>>(a, b, c, m, n, k, vec_c);
  return cudaGetLastError();
}

cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  const bool va = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vb = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (va && vb) return launch_f32<true, true>(fa, fb, fc, m, n, k, stream);
  if (va) return launch_f32<true, false>(fa, fb, fc, m, n, k, stream);
  if (vb) return launch_f32<false, true>(fa, fb, fc, m, n, k, stream);
  return launch_f32<false, false>(fa, fb, fc, m, n, k, stream);
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
// m, n >= 1, k >= 0.  f32 takes lda = k and ldb = n;
// bf16 and f16 take 16-byte aligned a and b, and lda, ldb multiples of 8.  Returns the launch's cudaError_t (0 on success).
extern "C" int heat_matmul(const void* a, const void* b, void* c, int m, int n, int k, int lda, int ldb, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      if (lda != k || ldb != n) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch(a, b, c, m, n, k, s));
    case 1: return static_cast<int>(launch_tc<__nv_bfloat16>(a, b, c, m, n, k, lda, ldb, s));
    case 2: return static_cast<int>(launch_tc<__half>(a, b, c, m, n, k, lda, ldb, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
