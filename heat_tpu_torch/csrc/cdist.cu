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

#include <cuda_runtime.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
cdist_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int m, int n, int d, int take_sqrt) {
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
      out[row * n + col] = v;
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const float* x, const float* y, float* out, int m, int n, int d,
                   int take_sqrt, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const dim3 block((BM / TM) * (BN / TN));
  cdist_f32_kernel<BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(x, y, out, m, n, d, take_sqrt);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  x (m, d), y (n, d) and out (m, n)
// are contiguous row-major f32 on the current device; m, n >= 1.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int heat_cdist_f32(const float* x, const float* y, float* out, int m, int n,
                              int d, int take_sqrt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8) return static_cast<int>(launch<256, 8, 32, 1, 8>(x, y, out, m, n, d, take_sqrt, s));
  return static_cast<int>(launch<64, 64, 16, 4, 4>(x, y, out, m, n, d, take_sqrt, s));
}
