// Sparse matrix times dense vectors over ELL slabs on Hopper (sm_90a).
//
// Replaces the TPU kernel heat_tpu/ops/spmv.py::_spmv_kernel (K6):
//     y[r, c] = sum_j vals[r, j] * x[cols[r, j], c]      (cols < 0: pad, adds 0)
// for the k right-hand sides c = 0 .. k-1 in one launch, in IEEE f32 with
// f32 accumulation.  vals (rows, W) f32 and cols (rows, W) int32 are
// row-major ELL slabs whose width W is a multiple of 32 (one warp; the TPU
// rounded to its 128 lanes); x is row-major (ncols, k) and y (rows, k).
//
// What bounds it.  The product must read each nonzero's value and column
// once (8 bytes), x once and write y once: at the Spectral benchmark's
// 131072^2 matrix of density 0.002 (34.4M nonzeros) that is ~276 MB, about
// 0.08 ms at 3.35 TB/s, against 2 flops per nonzero and right-hand side.
// So it is bound by device memory, and the design streams the slabs once:
//   * a group of TPR consecutive threads owns one row; each thread reads 4
//     consecutive slots of values and columns with one 16-byte load each,
//     so a warp's loads are contiguous (one row per warp for wide slabs;
//     for the narrow slabs of a k-NN graph, W = 32, 4 rows per warp with 8
//     threads each, so no thread idles on slots that do not exist);
//   * x is gathered through the read-only data path (__ldg); at the
//     benchmark's size it is 0.5 MB per right-hand side and stays in L2;
//   * all k right-hand sides of a row are summed from one read of its slots
//     (KC per pass; k beyond KC takes more passes in the grid's y axis).
// The ELL padding (slots past a row's length) is still read: the bytes
// above the bound are the padding's share, which the caller can see.
//
// Determinism.  Each thread sums its slots in a fixed order and the group
// then adds the threads' partials in a fixed butterfly, so a row's sum
// never depends on scheduling: repeated runs are bitwise equal (there are
// no atomics).  On integer-valued data every partial sum is exact, so the
// result equals any other summation order bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int TPR, int KC>
__global__ void __launch_bounds__(kThreads)
spmv_ell_f32_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ y, int rows, int width,
                    int k) {
  static_assert(TPR == 8 || TPR == 16 || TPR == 32, "a row group lies within one warp");
  constexpr int kRowsPerBlock = kThreads / TPR;
  const int lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / TPR;
  const int c0 = blockIdx.y * KC;
  // rows past the end still take part in the shuffles, with nothing to add
  const bool live_row = row < rows;

  float acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = 0.f;

  if (live_row) {
    const float4* vrow = reinterpret_cast<const float4*>(vals + row * width);
    const int4* crow = reinterpret_cast<const int4*>(cols + row * width);
    const int quads = width / 4;
    for (int q = lane; q < quads; q += TPR) {
      const float4 v = __ldg(vrow + q);
      const int4 j = __ldg(crow + q);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const int jj[4] = {j.x, j.y, j.z, j.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (jj[s] < 0) continue;
        const float* xr = x + static_cast<long long>(jj[s]) * k + c0;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c0 + c < k) acc[c] = fmaf(vv[s], __ldg(xr + c), acc[c]);
        }
      }
    }
  }

  // fixed butterfly over the TPR threads of the row; the group's threads
  // are consecutive lanes of one warp, so the xor stays inside the group
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (live_row && lane == 0) {
    float* yr = y + row * k + c0;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c0 + c < k) yr[c] = acc[c];
    }
  }
}

template <int TPR, int KC>
cudaError_t launch(const float* vals, const int* cols, const float* x, float* y, int rows,
                   int width, int k, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, (k + KC - 1) / KC);
  spmv_ell_f32_kernel<TPR, KC><<<grid, kThreads, 0, stream>>>(vals, cols, x, y, rows, width, k);
  return cudaGetLastError();
}

template <int TPR>
cudaError_t launch_k(const float* vals, const int* cols, const float* x, float* y, int rows,
                     int width, int k, cudaStream_t stream) {
  if (k == 1) return launch<TPR, 1>(vals, cols, x, y, rows, width, k, stream);
  return launch<TPR, 4>(vals, cols, x, y, rows, width, k, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  vals (rows, width) f32, cols
// (rows, width) int32, x (ncols, k) f32 and y (rows, k) f32 are contiguous
// row-major on the current device, each 16-byte aligned; rows >= 1,
// k >= 1, width a positive multiple of 32; every column id is < ncols or
// negative.  The grid's y axis takes ceil(k / 4) <= 65535 passes.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int heat_spmv_ell_f32(const float* vals, const int* cols, const float* x, float* y,
                                 int rows, int width, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // threads per row by slab width: every thread has at least one quad of
  // slots to read where the width allows it
  if (width <= 32) return static_cast<int>(launch_k<8>(vals, cols, x, y, rows, width, k, s));
  if (width <= 64) return static_cast<int>(launch_k<16>(vals, cols, x, y, rows, width, k, s));
  return static_cast<int>(launch_k<32>(vals, cols, x, y, rows, width, k, s));
}
