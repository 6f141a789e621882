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
//   * m, l and the accumulator are f32, and the output is rounded once to
//     q's dtype on store (__float2bfloat16_rn, __float2half_rn).
//
// Two kernels behind one entry point, chosen by the dtype.
//
// f32: flash_fwd_kernel, IEEE FMAs on the CUDA cores (no TF32).  At the
// benchmark's (16, 4096, 128) causal call the flops take ~1 ms at 67 TFLOP/s
// and the bytes ~0.04 ms, so it is bound by operations:
//   * one block of 256 threads per (batch*head, 64-row query tile), looping
//     over 64-key tiles; the Q tile stays in shared memory for the whole
//     loop, K (stored transposed) and then V pass through one shared buffer;
//   * each thread holds a 4 x 4 block of the score tile in registers (rows
//     ty + 16 i, columns tx + 16 j), so a row's 64 scores sit in one
//     half-warp and its max and sum are butterfly shuffles;
//   * each thread accumulates its 4 rows x DMAX/16 columns of the output in
//     registers; P passes through shared memory between the two products;
//   * the row strides are padded so that neither product's shared-memory
//     reads conflict on banks; ragged edges are masked in the kernel.
// expf, not __expf.
//
// bf16 / f16: flash_fwd_kernel_tc, on the tensor cores.  A non-causal
// (16, 4096, 128) call is 1.4e11 flops against 6.7e7 bytes: 0.14 ms at the
// 989 TFLOP/s dense peak, 0.02 ms of bytes, so again operations.  The design
// (warp-specialised, as FlashAttention-3):
//   * one block of 384 threads per (batch*head, 128 query rows): warpgroup
//     0 is the producer, and gives its registers to warpgroups 1 and 2
//     (setmaxnreg 40 / 232), the consumers, 64 query rows each;
//   * one producer thread loads Q once by TMA, then K and V tiles of BK keys
//     into a ring of 2 stages, each with a "full" mbarrier for K, one for V
//     and an "empty" one that all 256 consumer threads arrive on;
//   * S = Q K^T by wgmma with both operands in shared memory (K rows are
//     contiguous in d: K-major, no transpose), f32 accumulators in
//     registers;
//   * the softmax on the accumulator fragment: a row lives in the four
//     threads of a quad, so its max is two shuffles; the running l stays a
//     per-thread partial sum, reduced over the quad once at the end; the
//     rescale of O is applied between the two products;
//   * O += P V by wgmma with P from registers: the S fragment, rounded to
//     the input's 16-bit type, is already the A operand's layout; V is read
//     from shared memory MN-major (the transpose bit of 16-bit types).
// P is rounded to 16 bits before the P V product, as the plain version does
// (p.to(q.dtype), ops/attention.py) and as every tensor-core flash attention
// does; l sums the unrounded p.  Scores are scaled by scale * log2(e) and
// exponentiated by exp2f.  Head dims 1..256 run as 64, 128 or 256 (BK = 128,
// 128, 64 keys a tile, to fit the registers); TMA fills the features past d,
// the rows past sq or sk of each head (a 3-D map: feature, row, head) with
// zeros.  TMA needs a 16-byte aligned base and row stride: the wrapper
// copies q, k, v whose d is not a multiple of 8 or whose base is off 16
// bytes into an aligned buffer of row stride ceil(d / 8) * 8 (there is no
// cp.async path).  Ragged rows and features of o are masked on store.
//
// Both kernels: each row's sums run in one fixed order, so reruns are
// bitwise equal.  The TPU's (512, 2048) blocks were sized for VMEM and are
// not carried over.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_f32(float v) { return v; }

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
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
                     float scale, int causal, cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  return launch<T, 256>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
}

// ------------------------------------------------ bf16 / f16: tensor cores

constexpr int TC_BQ = 128;      // query rows a block: two consumer warpgroups of 64
constexpr int TC_THREADS = 384;  // producer warpgroup + two consumers
constexpr int TC_STAGES = 2;

template <int DH, int BK>
struct TcSmem {
  static constexpr int BOXES = DH / 64;                // 64-feature boxes a row
  static constexpr int Q = TC_BQ * DH * 2;             // bytes
  static constexpr int KV = BK * DH * 2;               // one K or V tile
  static constexpr size_t bytes = 1024 + Q + 2 * TC_STAGES * KV + 8 * (1 + 3 * TC_STAGES);
};

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, T* __restrict__ o, int sq, int sk, int d,
                    float scale_log2, int causal) {
  using S = TcSmem<DH, BK>;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on the 1024-byte period of the 128-byte swizzle
  uint8_t* qs = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + S::Q;
  uint8_t* vs = ks + TC_STAGES * S::KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + TC_STAGES * S::KV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + TC_STAGES;
  uint64_t* empty = v_full + TC_STAGES;

  const int bh = blockIdx.x;
  // the heaviest causal tiles (the last rows) are dispatched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  int ntiles = (sk + BK - 1) / BK;
  if (causal) ntiles = min(ntiles, (q0 + TC_BQ - 1) / BK + 1);  // skip tiles above the diagonal

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < TC_STAGES; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], 2 * 128);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, S::Q);
#pragma unroll
      for (int b = 0; b < S::BOXES; ++b) hopper::tma_load_3d(qs + b * TC_BQ * 128, &mq, q_full, 64 * b, q0, bh);
      int stage = 0, phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kt = ks + stage * S::KV;
        uint8_t* vt = vs + stage * S::KV;
        hopper::mbar_arrive_expect_tx(&k_full[stage], S::KV);
#pragma unroll
        for (int b = 0; b < S::BOXES; ++b) hopper::tma_load_3d(kt + b * BK * 128, &mk, &k_full[stage], 64 * b, t * BK, bh);
        hopper::mbar_arrive_expect_tx(&v_full[stage], S::KV);
#pragma unroll
        for (int b = 0; b < S::BOXES; ++b) hopper::tma_load_3d(vt + b * BK * 128, &mv, &v_full[stage], 64 * b, t * BK, bh);
        if (++stage == TC_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<232>();
    const int cw = wg - 1;  // rows q0 + 64 cw .. + 63
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    // this thread's two rows of the fragment: r0 and r0 + 8
    const int r0 = q0 + 64 * cw + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
    const int first_row = q0 + 64 * cw;

    float acc_o[DH / 2], acc_s[BK / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) acc_s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    const uint32_t q_base = hopper::smem_u32(qs) + cw * 64 * 128;
    hopper::mbar_wait(q_full, 0);
    int stage = 0, phase = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * BK;
      // S = Q K^T: d in 16-deep slices, 4 to a 64-feature box
      const uint32_t k_base = hopper::smem_u32(ks + stage * S::KV);
      hopper::mbar_wait(&k_full[stage], phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = 32 * (kk % 4);
        const uint64_t da = hopper::desc_sw128(q_base + (kk / 4) * TC_BQ * 128 + off, 16, 1024);
        const uint64_t db = hopper::desc_sw128(k_base + (kk / 4) * BK * 128 + off, 16, 1024);
        hopper::wgmma_ss<T, BK, 0>(acc_s, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc_s);

      // scale into the log2 domain and mask: key padding, and the causal
      // diagonal where the tile reaches past this warpgroup's first row
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > first_row);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i / 2) % 2;
        float x = acc_s[i] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + 2 * quad + (i % 2);
          if (col >= sk || (causal && col > r0 + 8 * h)) x = kNegInf;
        }
        acc_s[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i / 2) % 2;
        acc_s[i] = exp2f(acc_s[i] - m[h]);
        sum[h] += acc_s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc_o[i] *= corr[(i / 2) % 2];

      // P in 16 bits: columns 16 c .. 16 c + 15 of the S fragment are the A
      // fragment of the c-th 16-key slice
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[c][j] = hopper::pack2<T>(acc_s[8 * c + 2 * j], acc_s[8 * c + 2 * j + 1]);

      // O += P V: keys in 16-deep slices of 16 rows (2048 bytes); V is
      // MN-major, its 64-feature boxes BK * 128 bytes apart
      const uint32_t v_base = hopper::smem_u32(vs + stage * S::KV);
      hopper::mbar_wait(&v_full[stage], phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        const uint64_t db = hopper::desc_sw128(v_base + c * 2048, BK * 128, 1024);
        hopper::wgmma_rs<T, DH, 1>(acc_o, pa[c], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc_o);
      hopper::mbar_arrive(&empty[stage]);
      if (++stage == TC_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // l over the quad, then o = acc / l (a row with l = 0 outputs 0)
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    }
    T* ob = o + static_cast<long long>(bh) * sq * d;
#pragma unroll
    for (int i = 0; i < DH / 2; i += 2) {
      const int h = (i / 2) % 2;
      const int row = r0 + 8 * h;
      const int col = 8 * (i / 4) + 2 * quad;
      if (row >= sq || col >= d) continue;
      T* dst = ob + static_cast<long long>(row) * d + col;
      const float a0 = acc_o[i] * inv[h], a1 = acc_o[i + 1] * inv[h];
      if (col + 1 < d && d % 2 == 0) {
        const uint32_t pair = hopper::pack2<T>(a0, a1);
        *reinterpret_cast<uint32_t*>(dst) = pair;
      } else {
        dst[0] = from_f32<T>(a0);
        if (col + 1 < d) dst[1] = from_f32<T>(a1);
      }
    }
  }
}

template <typename T, int DH, int BK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d, int ld,
                      float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = TcSmem<DH, BK>::bytes;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_tc<T, DH, BK>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // (feature, row, head) maps over the first d of each ld-wide row; empty
  // k and v (sk = 0) load no tile, and their maps stay unset
  const bool f16 = std::is_same<T, __half>::value;
  CUtensorMap mq = {}, mk = {}, mv = {};
  const uint64_t row_bytes = 2ull * ld;
  const uint64_t dq[3] = {static_cast<uint64_t>(d), static_cast<uint64_t>(sq), static_cast<uint64_t>(bh)};
  const uint64_t dk[3] = {static_cast<uint64_t>(d), static_cast<uint64_t>(sk), static_cast<uint64_t>(bh)};
  const uint64_t sq_str[2] = {row_bytes, row_bytes * sq};
  const uint64_t sk_str[2] = {row_bytes, row_bytes * sk};
  const uint32_t box_q[3] = {64, TC_BQ, 1};
  const uint32_t box_k[3] = {64, BK, 1};
  cudaError_t err = hopper::make_tensor_map(&mq, q, f16, 3, dq, sq_str, box_q);
  if (err == cudaSuccess && sk > 0) err = hopper::make_tensor_map(&mk, k, f16, 3, dk, sk_str, box_k);
  if (err == cudaSuccess && sk > 0) err = hopper::make_tensor_map(&mv, v, f16, 3, dk, sk_str, box_k);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + TC_BQ - 1) / TC_BQ);
  constexpr float kLog2e = 1.4426950408889634f;
  flash_fwd_kernel_tc<T, DH, BK><<<grid, TC_THREADS, bytes, stream>>>(mq, mk, mv, static_cast<T*>(o), sq, sk, d,
                                                                     scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
                        int ld, float scale, int causal, cudaStream_t s) {
  if (ld % 8 != 0 || ld < d) return cudaErrorInvalidValue;  // TMA: 16-byte rows
  if (d <= 64) return launch_tc<T, 64, 128>(q, k, v, o, bh, sq, sk, d, ld, scale, causal, s);
  if (d <= 128) return launch_tc<T, 128, 128>(q, k, v, o, bh, sq, sk, d, ld, scale, causal, s);
  return launch_tc<T, 256, 64>(q, k, v, o, bh, sq, sk, d, ld, scale, causal, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (bh, sq, ld), k and v
// (bh, sk, ld) are contiguous with the head dimension d <= ld in the first d
// of each row, o (bh, sq, d) contiguous; one dtype (0 f32, 1 bf16, 2 f16),
// on the current device; bh >= 1, sq >= 1, 1 <= d <= 256, ceil(sq/64) <=
// 65535.  f32 takes ld = d; bf16 and f16 take ld a multiple of 8 and 16-byte
// aligned q, k, v.  Returns the launch's cudaError_t (0 on success).
extern "C" int heat_flash_attention(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                                    int d, int ld, float scale, int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256 || bh < 1 || sq < 1 || sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      if (ld != d) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch<float>(q, k, v, o, bh, sq, sk, d, scale, causal, s));
    case 1: return static_cast<int>(dispatch_tc<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, ld, scale, causal, s));
    case 2: return static_cast<int>(dispatch_tc<__half>(q, k, v, o, bh, sq, sk, d, ld, scale, causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
