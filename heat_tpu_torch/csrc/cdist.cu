// Fused pairwise squared-Euclidean distance on Hopper (sm_90a).
//
// Replaces the TPU kernel heat_tpu/ops/cdist.py::_cdist_kernel (K1):
//     out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>, 0)   (optionally sqrt)
// with the cross term and both row norms accumulated over d in f32.
//
// What bounds it.  On KMeans's step (x 2e7 x 64 f32, y 8 x 64, k = 8) the
// kernel must read 5.12 GB of x and write 0.64 GB of distances: about 1.7 ms
// at the H100's 3.35 TB/s.  Its 2.0e10 FLOP take about 0.3 ms at 67 TFLOP/s
// f32 outside the tensor cores.  So it is bound by device memory, and the
// design reads every element of x from device memory exactly once:
//   * one block per (BM rows of x) x (BN rows of y) output tile; the loop
//     over d runs inside the block (on the TPU it was the sequential third
//     grid axis carrying the accumulators between grid steps);
//   * each BK-wide slice of the x and y tiles is staged in shared memory by
//     coalesced loads (consecutive threads read consecutive columns), stored
//     transposed with one pad column so neither the stores nor the compute
//     loop's reads conflict on shared-memory banks;
//   * each thread keeps a TM x TN micro-tile of the cross term in registers;
//     row norms are summed once per tile row by one thread each, not once
//     per output;
//   * for y of at most 8 rows (KMeans at k = 8, kmeans++'s single column)
//     a tall tile of 256 x 8 keeps every thread on its own row of x, so no
//     work is spent on columns that do not exist.
// The ragged edges in m, n and d are masked in the kernel, not padded: loads
// past an edge read 0, stores past it are skipped.  There is no lower limit
// on m or n (the TPU's lane padding made it skip n < 128; nothing here pads).
//
// Arithmetic is IEEE f32 FMA on the CUDA cores, never TF32: at near-ties
// TF32 flips KMeans labels.  The tensor cores (wgmma) and TMA are left for a
// later change; at k = 8 they would not move the memory bound.
//
// 16-bit input (cdist16_kernel).  The TPU kernel takes any float input and
// widens each tile to f32 inside the kernel (heat_tpu/ops/cdist.py:41-42),
// so no f32 copy of a bf16 operand exists.  Here x is bf16 or f16 and y has
// x's type or is f32; each tile is widened to f32 as it goes from registers
// to shared memory, and the rest is the f32 kernel's arithmetic.  A bf16 or
// f16 product is exact in f32, so the result differs from the plain version
// (which widens first) only in the order of its sums.  At the north star
// (x 1e8 x 64 bf16, y 8 x 64, KMeans at k = 8) the kernel must read 12.8 GB
// and write 3.2 GB of f32 distances, 4.78 ms at 3.35 TB/s; its 1.0e11 FLOP
// take ~1.5 ms at 67 TFLOP/s, so it is bound by memory.  x's rows are read
// in loads of 16 bytes (8 elements) when its base is 16-byte aligned and d
// is a multiple of 8, else of 4 bytes (2 elements) when the base is 4-byte
// aligned and d even, else of 2 bytes: a vector never straddles a row end,
// so the ragged edge in d is still masked by whole loads.  A thread starts
// its loads of a BK-wide slice (on the 16-byte path; 4 at a time on the
// narrower ones) before it widens and stores any.  y (k
// rows, read by every block from L2) takes 2- or 4-byte loads.  For n <= 8
// each thread owns one row of the tile: it sums that row's norm inside the
// product loop and reads y's 8 values as two float4 from unpadded shared
// rows (shared-memory instructions, not bytes, were what held the first
// version back), and its 8 adjacent columns of output are written in
// 16-byte stores when n is a multiple of 4.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
cdist_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int m, int n, int d, int ldo, int take_sqrt) {
  constexpr int TY = BM / TM;  // threads along the rows of the tile
  constexpr int TX = BN / TN;  // threads along its columns
  constexpr int NT = TY * TX;
  static_assert(NT >= BM && NT >= BN, "one thread per tile row for the norms");

  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN + 1];
  __shared__ float xn_s[BM];
  __shared__ float yn_s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xnorm = 0.f;  // |x|^2 of tile row tid (tid < BM)
  float ynorm = 0.f;  // |y|^2 of tile column tid (tid < BN)

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll 4
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const long long row = m0 + r;
      const int col = k0 + c;
      xs[c][r] = (row < m && col < d) ? x[row * d + col] : 0.f;
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int row = n0 + r;
      const int col = k0 + c;
      ys[c][r] = (row < n && col < d) ? y[static_cast<long long>(row) * d + col] : 0.f;
    }
    __syncthreads();

    if (tid < BM) {
#pragma unroll
      for (int c = 0; c < BK; ++c) xnorm = fmaf(xs[c][tid], xs[c][tid], xnorm);
    }
    if (tid < BN) {
#pragma unroll
      for (int c = 0; c < BK; ++c) ynorm = fmaf(ys[c][tid], ys[c][tid], ynorm);
    }

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) xn_s[tid] = xnorm;
  if (tid < BN) yn_s[tid] = ynorm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY;
    const long long row = m0 + r;
    if (row >= m) continue;
    const float xn = xn_s[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + j * TX;
      const int col = n0 + c;
      if (col >= n) continue;
      float v = fmaxf(xn + yn_s[c] - 2.f * acc[i][j], 0.f);
      if (take_sqrt) v = sqrtf(v);
      out[row * ldo + col] = v;
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const float* x, const float* y, float* out, int m, int n, int d, int ldo,
                   int take_sqrt, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const dim3 block((BM / TM) * (BN / TN));
  cdist_f32_kernel<BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(x, y, out, m, n, d, ldo, take_sqrt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- 16-bit x
struct BF16 {
  using storage = unsigned short;
  static __device__ __forceinline__ float widen(unsigned short b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
};
struct F16 {
  using storage = unsigned short;
  static __device__ __forceinline__ float widen(unsigned short b) { return __half2float(__ushort_as_half(b)); }
};
struct F32 {
  using storage = float;
  static __device__ __forceinline__ float widen(float v) { return v; }
};

// the register word of one load of B bytes
template <int B> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<2> { using type = unsigned short; };

template <class TX, class TY, int VX, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
cdist16_kernel(const typename TX::storage* __restrict__ x, const typename TY::storage* __restrict__ y,
               float* __restrict__ out, int m, int n, int d, int ldo, int take_sqrt) {
  using SX = typename TX::storage;
  using WX = typename Word<VX * sizeof(SX)>::type;
  constexpr int TYN = BM / TM;  // threads along the rows of the tile
  constexpr int TXN = BN / TN;  // threads along its columns
  constexpr int NT = TYN * TXN;
  constexpr int X_PER_ROW = BK / VX;  // loads a row of a BK-wide slice takes
  constexpr int X_LOADS = BM * X_PER_ROW;
  constexpr int X_ITERS = (X_LOADS + NT - 1) / NT;
  constexpr int X_BATCH = X_ITERS < 4 ? X_ITERS : 4;
  static_assert(BK % VX == 0, "a load never straddles a slice");
  static_assert(X_ITERS % X_BATCH == 0, "whole batches");
  static_assert(NT >= BM && NT >= BN, "one thread per tile row for the norms");

  __shared__ float xs[BK][BM + 1];
  constexpr int YP = (TXN == 1 && TN % 4 == 0) ? BN : BN + 1;
  __shared__ __align__(16) float ys[BK][YP];
  __shared__ float xn_s[BM];
  __shared__ float yn_s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xnorm = 0.f;
  float ynorm = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // up to X_BATCH loads in flight before their stores (all of a slice's
    // on the 16-byte path; batches bound the registers of the narrow
    // ones): VX divides d and k0, so a load is wholly inside row and d or
    // wholly out
#pragma unroll 1
    for (int u0 = 0; u0 < X_ITERS; u0 += X_BATCH) {
      WX raw[X_BATCH];
#pragma unroll
      for (int u = 0; u < X_BATCH; ++u) {
        const int e = tid + (u0 + u) * NT;
        const int r = e / X_PER_ROW, c = (e % X_PER_ROW) * VX;
        const long long row = m0 + r;
        const int col = k0 + c;
        raw[u] = WX{};
        if (e < X_LOADS && row < m && col < d) raw[u] = __ldg(reinterpret_cast<const WX*>(x + row * d + col));
      }
#pragma unroll
      for (int u = 0; u < X_BATCH; ++u) {
        const int e = tid + (u0 + u) * NT;
        if (e < X_LOADS) {
          const int r = e / X_PER_ROW, c = (e % X_PER_ROW) * VX;
          SX v[VX];
          memcpy(v, &raw[u], sizeof(WX));
#pragma unroll
          for (int j = 0; j < VX; ++j) xs[c + j][r] = TX::widen(v[j]);
        }
      }
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int row = n0 + r;
      const int col = k0 + c;
      ys[c][r] = (row < n && col < d) ? TY::widen(y[static_cast<long long>(row) * d + col]) : 0.f;
    }
    __syncthreads();

    if (!(TXN == 1 && TM == 1) && tid < BM) {
#pragma unroll
      for (int c = 0; c < BK; ++c) xnorm = fmaf(xs[c][tid], xs[c][tid], xnorm);
    }
    if (tid < BN) {
#pragma unroll
      for (int c = 0; c < BK; ++c) ynorm = fmaf(ys[c][tid], ys[c][tid], ynorm);
    }

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * TYN];
      // the tall tile (a row a thread) sums its row's norm here, and reads
      // y's values as float4 from unpadded rows: fewer shared-memory
      // instructions, the same sums in the same order
      if (TXN == 1 && TM == 1) xnorm = fmaf(a[0], a[0], xnorm);
      if (YP == BN) {
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(&ys[k][j]);
          b[j] = q.x; b[j + 1] = q.y; b[j + 2] = q.z; b[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + j * TXN];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) xn_s[tid] = xnorm;
  if (tid < BN) yn_s[tid] = ynorm;
  __syncthreads();

  // a row's 4-column groups are 16-byte aligned (out may be a column slice
  // of a wider matrix, rows ldo apart) and a group never crosses n
  const bool vec_out = (n & 3) == 0 && (ldo & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TYN;
    const long long row = m0 + r;
    if (row >= m) continue;
    const float xn = xn_s[r];
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + j * TXN;
      v[j] = fmaxf(xn + yn_s[c] - 2.f * acc[i][j], 0.f);
      if (take_sqrt) v[j] = sqrtf(v[j]);
    }
    if (TXN == 1 && TN % 4 == 0 && vec_out) {
      // this thread's columns are adjacent: 16-byte stores
#pragma unroll
      for (int j = 0; j < TN; j += 4)
        if (n0 + j < n)
          *reinterpret_cast<float4*>(out + row * ldo + n0 + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + j * TXN;
        if (col < n) out[row * ldo + col] = v[j];
      }
    }
  }
}

template <class TX, class TY, int VX, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch16(const void* x, const void* y, float* out, int m, int n, int d, int ldo, int take_sqrt,
                     cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const dim3 block((BM / TM) * (BN / TN));
  cdist16_kernel<TX, TY, VX, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const typename TX::storage*>(x), static_cast<const typename TY::storage*>(y), out, m, n, d,
      ldo, take_sqrt);
  return cudaGetLastError();
}

// the tall 256 x 8 tile for n <= 8 (Lloyd at k <= 8, kmeans++'s column),
// the 64 x 64 tile otherwise
template <class TX, class TY, int VX>
cudaError_t tiles16(const void* x, const void* y, float* out, int m, int n, int d, int ldo, int take_sqrt,
                    cudaStream_t s) {
  if (n <= 8) return launch16<TX, TY, VX, 256, 8, 32, 1, 8>(x, y, out, m, n, d, ldo, take_sqrt, s);
  return launch16<TX, TY, VX, 64, 64, 16, 4, 4>(x, y, out, m, n, d, ldo, take_sqrt, s);
}

// the widest load x's base and row pitch allow
template <class TX, class TY>
cudaError_t widths16(const void* x, const void* y, float* out, int m, int n, int d, int ldo, int take_sqrt,
                     cudaStream_t s) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  if (d % 8 == 0 && base % 16 == 0) return tiles16<TX, TY, 8>(x, y, out, m, n, d, ldo, take_sqrt, s);
  if (d % 2 == 0 && base % 4 == 0) return tiles16<TX, TY, 2>(x, y, out, m, n, d, ldo, take_sqrt, s);
  return tiles16<TX, TY, 1>(x, y, out, m, n, d, ldo, take_sqrt, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  x (m, d) and y (n, d) are
// contiguous row-major f32 on the current device; out (m, n) is row-major
// with rows ldo >= n floats apart (a column slice of a wider matrix when
// ldo > n); m, n >= 1.  Returns the launch's cudaError_t (0 on success).
extern "C" int heat_cdist_f32(const float* x, const float* y, float* out, int m, int n,
                              int d, int ldo, int take_sqrt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8) return static_cast<int>(launch<256, 8, 32, 1, 8>(x, y, out, m, n, d, ldo, take_sqrt, s));
  return static_cast<int>(launch<64, 64, 16, 4, 4>(x, y, out, m, n, d, ldo, take_sqrt, s));
}

// The same for 16-bit x: x_type and y_type are 1 for bf16, 2 for f16 and 0
// for f32; x is bf16 or f16, y has x's type or is f32.  out (m, n) is f32,
// rows ldo apart.  Any other pair returns cudaErrorInvalidValue without a
// launch.
extern "C" int heat_cdist_16(const void* x, const void* y, float* out, int m, int n, int d, int ldo,
                             int take_sqrt, int x_type, int y_type, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type == 1 && y_type == 1) return static_cast<int>(widths16<BF16, BF16>(x, y, out, m, n, d, ldo, take_sqrt, s));
  if (x_type == 1 && y_type == 0) return static_cast<int>(widths16<BF16, F32>(x, y, out, m, n, d, ldo, take_sqrt, s));
  if (x_type == 2 && y_type == 2) return static_cast<int>(widths16<F16, F16>(x, y, out, m, n, d, ldo, take_sqrt, s));
  if (x_type == 2 && y_type == 0) return static_cast<int>(widths16<F16, F32>(x, y, out, m, n, d, ldo, take_sqrt, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
