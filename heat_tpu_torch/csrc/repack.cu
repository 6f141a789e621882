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
// it is bound by device memory, and the design keeps the copy at the widest
// access both sides allow:
//   * one launch per destination; the segment table (source pointer, source
//     byte offset, destination byte offset, byte length) is a
//     __grid_constant__ parameter, so there is no host-to-device copy;
//   * blockIdx.y picks the segment, blockIdx.x and the thread stride over it
//     (a grid-stride loop; each thread has 64 bytes of loads in flight,
//     4 x 16 bytes or more of a narrower width, before its stores);
//   * within a segment the copy uses 16-byte loads and stores when source
//     and destination share their alignment modulo 16, else the widest
//     common width (8, 4, 2 or 1 bytes); the unaligned head and the tail
//     (< 16 bytes each) are copied byte by byte;
//   * all offsets and lengths are 64-bit: a shard may exceed 2^31 bytes.
// TMA bulk copies (cp.async.bulk) are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 8;
constexpr int kThreads = 256;
// bytes each thread keeps in flight per turn of the loop: 4 loads of 16
// bytes, or more loads of a narrower width, so a misaligned segment keeps
// as much memory traffic outstanding as an aligned one
constexpr int kBytesInFlight = 64;
constexpr int kMinUnroll = 4;
// enough blocks to keep every SM busy with several resident blocks; a
// larger segment takes more turns of the grid-stride loop
constexpr long long kMaxBlocks = 132 * 32;

struct Segment {
  const unsigned char* src;
  long long src_off;  // bytes
  long long dst_off;  // bytes
  long long len;      // bytes
};

struct Table {
  Segment seg[kMaxSegments];
  unsigned char* dst;
  int n;
};

// the widest power of two <= 16 at which a and b share their alignment
__device__ inline int common_width(uintptr_t a, uintptr_t b) {
  const uintptr_t x = a ^ b;
  if ((x & 15) == 0) return 16;
  if ((x & 7) == 0) return 8;
  if ((x & 3) == 0) return 4;
  if ((x & 1) == 0) return 2;
  return 1;
}

template <typename T>
__device__ __forceinline__ void copy_units(const T* __restrict__ s, T* __restrict__ d, long long n) {
  constexpr int kUnroll = kBytesInFlight / sizeof(T) < kMinUnroll ? kMinUnroll
                          : (kBytesInFlight / sizeof(T) > 16 ? 16 : kBytesInFlight / sizeof(T));
  const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads) repack_kernel(const __grid_constant__ Table t) {
  const int k = blockIdx.y;
  if (k >= t.n) return;
  const Segment g = t.seg[k];
  const unsigned char* s = g.src + g.src_off;
  unsigned char* d = t.dst + g.dst_off;
  const long long len = g.len;
  const int w = common_width(reinterpret_cast<uintptr_t>(s), reinterpret_cast<uintptr_t>(d));
  long long head = static_cast<long long>((w - (reinterpret_cast<uintptr_t>(s) & (w - 1))) & (w - 1));
  if (head > len) head = len;
  const long long units = (len - head) / w;
  const long long body_end = head + units * w;
  const long long tail = len - body_end;
  // head and tail are each shorter than w <= 16 bytes: block 0's first
  // threads copy them
  if (blockIdx.x == 0) {
    const long long tid = threadIdx.x;
    if (tid < head) d[tid] = s[tid];
    if (tid >= 32 && tid - 32 < tail) d[body_end + tid - 32] = s[body_end + tid - 32];
  }
  const unsigned char* sb = s + head;
  unsigned char* db = d + head;
  switch (w) {
    case 16:
      copy_units(reinterpret_cast<const uint4*>(sb), reinterpret_cast<uint4*>(db), units);
      break;
    case 8:
      copy_units(reinterpret_cast<const unsigned long long*>(sb), reinterpret_cast<unsigned long long*>(db), units);
      break;
    case 4:
      copy_units(reinterpret_cast<const unsigned int*>(sb), reinterpret_cast<unsigned int*>(db), units);
      break;
    case 2:
      copy_units(reinterpret_cast<const unsigned short*>(sb), reinterpret_cast<unsigned short*>(db), units);
      break;
    default:
      copy_units(sb, db, units);
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
  t.dst = static_cast<unsigned char*>(dst);
  t.n = n;
  long long most = 1;
  for (int i = 0; i < n; ++i) {
    if (len[i] <= 0 || src_off[i] < 0 || dst_off[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.seg[i] = Segment{static_cast<const unsigned char*>(srcs[i]), src_off[i], dst_off[i], len[i]};
    const long long bytes = len[i] + 16;
    if (bytes > most) most = bytes;
  }
  // enough threads that each moves kBytesInFlight per turn of the loop
  long long blocks = (most + kThreads * kBytesInFlight - 1) / (kThreads * kBytesInFlight);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  repack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
