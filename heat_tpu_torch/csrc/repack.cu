// Rechunk repack on Hopper (sm_90a): one destination shard of a
// split-crossing reshape, written in its final shape from the segments of
// the source shards that cover it.
//
// Replaces the TPU kernel heat_tpu/ops/repack.py::_repack_kernel (K7), a
// bit-exact flat.reshape(rows, minor) whose point on the TPU was to write a
// narrow minor dimension without the 128-lane padding.  Hopper has no lane
// padding, so what is left to compute is the rechunk's output itself: the
// destination shard is the concatenation of up to 1 + _MAX_SHIFTS source
// intervals (heat_tpu/parallel/transport.py:1080 and :1149-1153), and its
// row-major reshape is free.  The kernel copies raw bytes, so it is exact
// for every dtype (bool, int8, 16-bit floats, f64, int64, complex).
//
// What bounds it.  Each byte is read once and written once: 2 x bytes over
// 3.35 TB/s, about 0.048 ms for an 80 MB shard.  It does no arithmetic, so
// it is bound by device memory, and the design keeps every access 16 bytes
// wide whatever the alignment of source and destination:
//   * one launch per destination; the segment table (source and
//     destination byte pointers, length, head bytes, 16-byte words, first
//     block) is a __grid_constant__ parameter, so there is no host-to-device
//     copy;
//   * each segment is cut into chunks of kChunkWords 16-byte destination
//     words, one block per chunk, the blocks of all segments in one flat
//     grid; within a chunk each warp moves kUnroll contiguous runs of 32
//     words (kUnroll loads of 16 bytes in flight per thread before its
//     stores), with streaming cache hints;
//   * aligned to the destination: the head up to the destination's first
//     16-byte boundary and the tail (< 16 bytes each) are copied byte by
//     byte; every other store is a whole 16-byte word;
//   * shifted source: output word k is bytes [delta, delta + 16) of the
//     aligned source words (w_k, w_k+1), delta = source mod 16 after the
//     head.  Lane l loads w_k, takes w_k+1 from lane l + 1 by a shuffle
//     (lane 31 from lane 0 of the next run, or one extra load after the
//     last run), and builds its word from 32-bit lanes (delta / 4) by
//     __funnelshift_r of 8 (delta % 4) bits.  So every source byte is read
//     once from device memory at any alignment.  The aligned words read at
//     either end of a segment hold bytes outside it but never outside the
//     16-byte-aligned words that hold its first and last byte;
//   * all offsets and lengths are 64-bit: a shard may exceed 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 8;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;
// runs of kThreads * kUnroll words a block takes in turn
constexpr int kTiles = 1;
constexpr long long kChunkWords = static_cast<long long>(kThreads) * kUnroll * kTiles;  // 8 KB a block

struct Segment {
  const unsigned char* src;  // first source byte
  unsigned char* dst;        // first destination byte
  long long len;             // bytes
  long long head;            // bytes before dst's first 16-byte boundary (<= len)
  long long words;           // whole 16-byte destination words after the head
  long long first_block;     // this segment's first block in the flat grid
};

struct Table {
  Segment seg[kMaxSegments];
  int n;
};

__device__ __forceinline__ uint4 load16(const uint4* p) { return __ldcs(p); }

__device__ __forceinline__ void store16(uint4* p, uint4 v) { __stcs(p, v); }

// the lanes of the next word that output lanes Q .. Q + 3 reach into
template <int Q>
__device__ __forceinline__ uint4 shfl_next(uint4 v, int src_lane, bool down) {
  uint4 o = make_uint4(0u, 0u, 0u, 0u);
  o.x = down ? __shfl_down_sync(0xffffffffu, v.x, 1) : __shfl_sync(0xffffffffu, v.x, src_lane);
  if (Q >= 1) o.y = down ? __shfl_down_sync(0xffffffffu, v.y, 1) : __shfl_sync(0xffffffffu, v.y, src_lane);
  if (Q >= 2) o.z = down ? __shfl_down_sync(0xffffffffu, v.z, 1) : __shfl_sync(0xffffffffu, v.z, src_lane);
  if (Q >= 3) o.w = down ? __shfl_down_sync(0xffffffffu, v.w, 1) : __shfl_sync(0xffffffffu, v.w, src_lane);
  return o;
}

// bytes [4 Q + s / 8, 4 Q + s / 8 + 16) of the 32 bytes a, b (little-endian)
template <int Q>
__device__ __forceinline__ uint4 funnel(uint4 a, uint4 b, unsigned s) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], s), __funnelshift_r(w[Q + 1], w[Q + 2], s),
                    __funnelshift_r(w[Q + 2], w[Q + 3], s), __funnelshift_r(w[Q + 3], w[Q + 4], s));
}

// Destination words [w0, w1) of a segment from source words sa[k] (and
// sa[k + 1] when kShift).  sa[k] may be read for k <= w1 when kShift: the
// caller guarantees that word holds a byte of the segment.
template <int Q, bool kShift>
__device__ __forceinline__ void copy_words(const uint4* __restrict__ sa, uint4* __restrict__ d, long long w0,
                                           long long w1, unsigned s) {
  const int lane = threadIdx.x & 31;
  const long long limit = kShift ? w1 : w1 - 1;  // the last source word a lane loads
  for (long long base = w0 + (threadIdx.x >> 5) * 32LL * kUnroll; base < w1;
       base += static_cast<long long>(kThreads) * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = base + 32 * u + lane;
      v[u] = k <= limit ? load16(sa + k) : make_uint4(0u, 0u, 0u, 0u);
    }
    uint4 extra = make_uint4(0u, 0u, 0u, 0u);
    if (kShift) {
      const long long k = base + 32 * (kUnroll - 1) + 32;
      if (lane == 31 && k <= limit) extra = load16(sa + k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = base + 32 * u + lane;
      uint4 out = v[u];
      if (kShift) {
        uint4 next = shfl_next<Q>(v[u], 0, true);
        if (u + 1 < kUnroll) {
          const uint4 first = shfl_next<Q>(v[u + 1 < kUnroll ? u + 1 : u], 0, false);
          if (lane == 31) next = first;
        } else if (lane == 31) {
          next = extra;
        }
        out = funnel<Q>(v[u], next, s);
      }
      if (k < w1) store16(d + k, out);
    }
  }
}

__global__ void __launch_bounds__(kThreads) repack_kernel(const __grid_constant__ Table t) {
  const long long block = blockIdx.x;
  int k = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i)
    if (i < t.n && t.seg[i].first_block <= block) k = i;
  const Segment& g = t.seg[k];
  const long long chunk = block - g.first_block;
  const long long head = g.head, words = g.words;
  if (chunk == 0) {
    // head and tail, each shorter than 16 bytes
    const long long tail_at = head + 16 * words, tail = g.len - tail_at;
    const int tid = threadIdx.x;
    if (tid < head) g.dst[tid] = g.src[tid];
    if (tid >= 32 && tid - 32 < tail) g.dst[tail_at + tid - 32] = g.src[tail_at + tid - 32];
  }
  const long long w0 = chunk * kChunkWords;
  const long long w1 = w0 + kChunkWords < words ? w0 + kChunkWords : words;
  if (w0 >= w1) return;
  const unsigned char* s = g.src + head;
  const unsigned delta = static_cast<unsigned>(reinterpret_cast<uintptr_t>(s) & 15);
  const uint4* sa = reinterpret_cast<const uint4*>(s - delta);
  uint4* d = reinterpret_cast<uint4*>(g.dst + head);
  const unsigned shift = 8u * (delta & 3u);
  switch (delta == 0 ? -1 : static_cast<int>(delta >> 2)) {
    case -1:
      copy_words<0, false>(sa, d, w0, w1, 0u);
      break;
    case 0:
      copy_words<0, true>(sa, d, w0, w1, shift);
      break;
    case 1:
      copy_words<1, true>(sa, d, w0, w1, shift);
      break;
    case 2:
      copy_words<2, true>(sa, d, w0, w1, shift);
      break;
    default:
      copy_words<3, true>(sa, d, w0, w1, shift);
      break;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Copies n segments (1 <= n <= 8)
// of raw bytes: segment i's len[i] bytes at srcs[i] + src_off[i] go to
// dst + dst_off[i].  The segments must not overlap each other in dst nor
// alias it; every length is > 0.  One launch on `stream`; returns its
// cudaError_t (0 on success).
extern "C" int heat_repack_segments(const void* const* srcs, const long long* src_off,
                                    const long long* dst_off, const long long* len, int n,
                                    void* dst, void* stream) {
  if (n < 1 || n > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.n = n;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (len[i] <= 0 || src_off[i] < 0 || dst_off[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    Segment& g = t.seg[i];
    g.src = static_cast<const unsigned char*>(srcs[i]) + src_off[i];
    g.dst = static_cast<unsigned char*>(dst) + dst_off[i];
    g.len = len[i];
    g.head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(g.dst) & 15)) & 15);
    if (g.head > g.len) g.head = g.len;
    g.words = (g.len - g.head) / 16;
    g.first_block = blocks;
    // at least one block, for the head and the tail
    blocks += g.words > 0 ? (g.words + kChunkWords - 1) / kChunkWords : 1;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  repack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
