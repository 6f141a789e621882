// Sparse matrix times dense vectors on Hopper (sm_90a), from a CSR row
// block repacked by column panel.
//
// Replaces the TPU kernel heat_tpu/ops/spmv.py::_spmv_kernel (K6):
//     y[r, c] = sum over row r's entries e of vals[e] * x[cols[e], c]
// for the k right-hand sides c = 0 .. k-1 in one launch, in IEEE f32 with
// f32 accumulation.  The kernel reads the entries as the wrapper repacked
// them once (ops/spmv.py::csr_panels): ordered by column panel of kSubCols
// columns, then by row, then in CSR order, so that row r's entries with a
// column in panel s are the run [off[s * rows + r], off[s * rows + r + 1])
// of pvals / pcols, and the runs of consecutive rows lie next to each
// other.  No pad slot exists.
//
// What bounds it.  The product must read each nonzero's value and column
// once (8 bytes), x once and write y once: at the Spectral benchmark's
// 131072^2 matrix of density 0.002 (34.4M nonzeros) that is ~276 MB, about
// 0.08 ms at 3.35 TB/s, against 2 flops per nonzero and right-hand side.
// Two things kept the first kernel at 3.4x that: it read every pad slot,
// and its 34M gathers of x were random 4- or 16-byte reads of 32-byte
// sectors through L2.  The design:
//   * x from shared memory.  One 1024-thread CTA an SM walks whole tiles
//     of at most kTileRows rows.  For each panel of x (kSubCols rows of
//     KC floats) thread 0 issues one bulk asynchronous copy
//     (cp.async.bulk on an mbarrier) into one of two buffers, so the next
//     panel arrives while this one is used, and x is gathered from shared
//     memory: L2 sees the entry stream and the panel copies only;
//   * entries only, streamed.  A tile's runs in one panel are one
//     contiguous stretch of the repacked arrays, read once, in streaming
//     (evict-first) 16-byte loads of whole quads of entries (a quad at a
//     run's end holds entries of the neighbouring run, which are masked;
//     they count there).  Reading the ELL slabs themselves panel by panel
//     cut each row into 22 pieces of ~50 bytes at k = 4, a pattern device
//     memory serves at a third of its rate;
//   * a lane owns one row of the tile: TPR lanes work on a row's run at
//     once (32 / TPR rows a warp), kUnroll quads a lane loaded before the
//     gathers; their partials meet in a butterfly and the owning lane adds
//     the panel's sum to its accumulator, in registers across the panels;
//     y is written once;
//   * KC right-hand sides a pass (1 for k = 1, else 4 from a
//     (passes, ncols, 4) copy of x); passes are the grid's y axis;
//   * sparse rows gather x from memory.  Where a row holds less than a
//     quad of entries a panel (a k-NN graph's ~1), a panel step an entry
//     would cost a round trip to memory and a barrier each: the wrapper
//     repacks such a matrix as one panel over every column, a run a row,
//     and launches kStaged = false: no copies, no barriers, x through L1.
//
// Determinism.  A row's sum is its runs' sums in panel order; a run's sum
// is the TPR lanes' partials added in a fixed butterfly, lane l's over the
// run's entries in its quads a / 4 + l, a / 4 + l + TPR, ... in order.
// Nothing depends on scheduling and there are no atomics: reruns are
// bitwise equal, and integer-valued data gives the plain version's result
// bitwise (every partial sum is exact).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 1024;       // one CTA an SM
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kThreads;  // a lane owns one row of a tile
constexpr int kSubCols = 6144;       // the repacking's column panel: x rows a buffer holds
constexpr int kUnroll = 2;           // quads a lane loads from a run before its gathers

template <int KC>
constexpr int smem_bytes() {
  return 2 * kSubCols * 4 * KC + 16;  // two x panel buffers and their mbarriers
}

template <int TPR, int KC, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
spmv_panel_kernel(const float* __restrict__ pvals, const int* __restrict__ pcols, const int* __restrict__ off,
                  const float* __restrict__ x, float* __restrict__ y, int rows, int ncols, int k, int ntiles,
                  int tile_rows) {
  static_assert(TPR == 2 || TPR == 4 || TPR == 8 || TPR == 16, "a row group lies within one warp");
  constexpr int kGroups = 32 / TPR;            // rows a warp works on at once
  constexpr int kBufBytes = kSubCols * 4 * KC;  // one x panel buffer
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * kBufBytes);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int l = lane % TPR, g = lane / TPR;
  const int npan = kStaged ? (ncols + kSubCols - 1) / kSubCols : 1;  // runs a row
  const int bx = blockIdx.x, gx = gridDim.x;
  const int my_tiles = bx < ntiles ? (ntiles - 1 - bx) / gx + 1 : 0;
  const int steps = my_tiles * npan;  // (tile, panel) pairs, one buffer fill each
  const int pass = blockIdx.y;
  const float* xp = x + static_cast<long long>(pass) * ncols * KC;

  // step q's panel into buffer q % 2 (thread 0): the 16-byte multiple in
  // one bulk copy, the last 1-3 floats of an odd panel by plain stores
  // (they are visible to the waiting threads through the arrive)
  auto issue = [&](int q) {
    const long long c0 = static_cast<long long>(q % npan) * kSubCols;
    const uint32_t bytes = static_cast<uint32_t>(min(static_cast<long long>(kSubCols), ncols - c0)) * KC * 4;
    const uint32_t bulk = bytes & ~15u;
    float* dst = reinterpret_cast<float*>(smem + (q & 1) * kBufBytes);
    const float* src = xp + c0 * KC;
    for (uint32_t i = bulk / 4; i < bytes / 4; ++i) dst[i] = __ldg(src + i);
    hopper::mbar_arrive_expect_tx(&bar[q & 1], bulk);
    if (bulk) hopper::bulk_load(dst, src, bulk, &bar[q & 1]);
  };

  if constexpr (kStaged) {
    if (threadIdx.x == 0) {
      hopper::mbar_init(&bar[0], 1);
      hopper::mbar_init(&bar[1], 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (steps > 0) issue(0);
      if (steps > 1) issue(1);
    }
  }

  int q = 0;
  for (int t = bx; t < ntiles; t += gx) {
    // the warp's rows of the tile: [tr0 + lo, tr0 + lo + nr), lane j owns tr0 + lo + j
    const long long tr0 = static_cast<long long>(t) * tile_rows;
    const int tn = static_cast<int>(min(static_cast<long long>(tile_rows), rows - tr0));
    const int lo = warp * tn / kWarps, nr = (warp + 1) * tn / kWarps - lo;
    const bool own = lane < nr;
    const long long my_row = tr0 + lo + lane;
    float acc[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = 0.f;
    // the owned row's run in the next panel, loaded a panel ahead; a lane
    // past nr holds empty runs
    int na = 0, nb = 0;
    if (own && npan > 0) {
      na = __ldg(off + my_row);
      nb = __ldg(off + my_row + 1);
    }
    for (int p = 0; p < npan; ++p, ++q) {
      const int a = na, b = nb;
      if (own && p + 1 < npan) {
        na = __ldg(off + static_cast<long long>(p + 1) * rows + my_row);
        nb = __ldg(off + static_cast<long long>(p + 1) * rows + my_row + 1);
      }
      // x's panel p: its buffer (column c at xs[c - c0]), or x itself
      const float* xs = xp;
      int c0 = 0;
      if constexpr (kStaged) {
        hopper::mbar_wait(&bar[q & 1], (q >> 1) & 1);
        xs = reinterpret_cast<const float*>(smem + (q & 1) * kBufBytes);
        c0 = p * kSubCols;
      }
      for (int rr = 0; rr < nr; rr += kGroups) {
        const int i = rr + g;  // < 32: rr + kGroups <= 32
        const int ra = __shfl_sync(0xffffffffu, a, i);
        const int rb = __shfl_sync(0xffffffffu, b, i);
        float part[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) part[c] = 0.f;
        for (int q0 = (ra >> 2) + l; 4 * q0 < rb; q0 += TPR * kUnroll) {
          float4 v[kUnroll];
          int4 jq[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (4 * (q0 + u * TPR) < rb) {
              v[u] = __ldcs(reinterpret_cast<const float4*>(pvals) + q0 + u * TPR);
              jq[u] = __ldcs(reinterpret_cast<const int4*>(pcols) + q0 + u * TPR);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int qd = q0 + u * TPR;
            if (4 * qd >= rb) continue;
            const float vv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
            const int cc[4] = {jq[u].x, jq[u].y, jq[u].z, jq[u].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (4 * qd + e < ra || 4 * qd + e >= rb) continue;
              if constexpr (KC == 1) {
                part[0] = fmaf(vv[e], kStaged ? xs[cc[e] - c0] : __ldg(xs + cc[e]), part[0]);
              } else {
                const float4* xq = reinterpret_cast<const float4*>(xs) + (cc[e] - c0);
                const float4 xv = kStaged ? *xq : __ldg(xq);
                part[0] = fmaf(vv[e], xv.x, part[0]);
                part[1] = fmaf(vv[e], xv.y, part[1]);
                part[2] = fmaf(vv[e], xv.z, part[2]);
                part[3] = fmaf(vv[e], xv.w, part[3]);
              }
            }
          }
        }
        // fixed butterfly over the group's TPR lanes (consecutive lanes,
        // so the xor stays inside the group); every lane ends with the sum
#pragma unroll
        for (int o = TPR / 2; o > 0; o /= 2) {
#pragma unroll
          for (int c = 0; c < KC; ++c) part[c] += __shfl_xor_sync(0xffffffffu, part[c], o);
        }
        // lane rr + g' owns the row group g' summed
        const bool mine = lane >= rr && lane < rr + kGroups;
        const int src = mine ? (lane - rr) * TPR : 0;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const float sum = __shfl_sync(0xffffffffu, part[c], src);
          if (mine) acc[c] += sum;
        }
      }
      if constexpr (kStaged) {
        // every warp is done with this buffer: refill it two steps ahead
        __syncthreads();
        if (threadIdx.x == 0 && q + 2 < steps) issue(q + 2);
      }
    }
    if (own) {
      float* yr = y + my_row * k + pass * KC;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (pass * KC + c < k) yr[c] = acc[c];
      }
    }
  }
}

template <int TPR, int KC, bool kStaged>
cudaError_t launch(const float* pvals, const int* pcols, const int* off, const float* x, float* y, int rows,
                   int ncols, int k, int ntiles, int grid_x, cudaStream_t stream) {
  auto kernel = spmv_panel_kernel<TPR, KC, kStaged>;
  const int smem = kStaged ? smem_bytes<KC>() : 0;  // unstaged: all of it L1
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tile_rows = (rows + ntiles - 1) / ntiles;
  const dim3 grid(grid_x, KC == 1 ? 1 : (k + 3) / 4);
  kernel<<<grid, kThreads, smem, stream>>>(pvals, pcols, off, x, y, rows, ncols, k, ntiles, tile_rows);
  return cudaGetLastError();
}

template <int KC, bool kStaged>
cudaError_t launch_tpr(int tpr, const float* pvals, const int* pcols, const int* off, const float* x, float* y,
                       int rows, int ncols, int k, int ntiles, int grid_x, cudaStream_t s) {
  switch (tpr) {
    case 2: return launch<2, KC, kStaged>(pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s);
    case 4: return launch<4, KC, kStaged>(pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s);
    case 8: return launch<8, KC, kStaged>(pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s);
    case 16: return launch<16, KC, kStaged>(pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KC>
cudaError_t launch_mode(bool staged, int tpr, const float* pvals, const int* pcols, const int* off, const float* x,
                        float* y, int rows, int ncols, int k, int ntiles, int grid_x, cudaStream_t s) {
  if (staged) return launch_tpr<KC, true>(tpr, pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s);
  return launch_tpr<KC, false>(tpr, pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  pvals f32 and pcols int32 hold
// the repacked entries, 16-byte aligned, their length a multiple of 4
// (fillers after the last run); off (ceil(ncols / sub_cols) * rows + 1
// when staged, else rows + 1) int32 the runs' bounds; every column id is
// below ncols.  x is (ncols,)
// f32 for k = 1, else (ceil(k / 4), ncols, 4) f32, 16-byte aligned; y
// (rows, k) f32.  tpr is 2, 4, 8 or 16 threads a row; the grid is grid_x
// CTAs over ntiles tiles of ceil(rows / ntiles) <= 1024 rows, times the
// passes; staged (0 or 1) copies x's panels to shared memory.  sub_cols
// must equal the kernel's kSubCols.  Returns the launch's cudaError_t (0
// on success).
extern "C" int heat_spmv_panels_f32(const float* pvals, const int* pcols, const int* off, const float* x, float* y,
                                    int rows, int ncols, int k, int tpr, int ntiles, int grid_x, int staged,
                                    int sub_cols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sub_cols != kSubCols || rows < 1 || k < 1 || ntiles < 1 || grid_x < 1 || grid_x > ntiles ||
      (rows + ntiles - 1) / ntiles > kTileRows || (k > 1 && (k + 3) / 4 > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 1)
    return static_cast<int>(launch_mode<1>(staged != 0, tpr, pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s));
  return static_cast<int>(launch_mode<4>(staged != 0, tpr, pvals, pcols, off, x, y, rows, ncols, k, ntiles, grid_x, s));
}
