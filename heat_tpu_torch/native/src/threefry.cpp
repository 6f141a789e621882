// Threefry-2x64 counter RNG — host-side twin of the device PRNG.
//
// The reference implements Threefry in torch integer ops so every rank
// draws from a shared counter stream and results are identical for any
// process count (heat/core/random.py:55-201, __threefry64:978).  This
// native stream serves the *host* paths — dataset shuffles and permutation
// generation — and is the host check for a device Threefry.  Multithreaded fill: counter-based RNG is embarrassingly
// parallel in the counter.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kParity = 0x1BD11BDAA9FC1A22ULL;
constexpr int kRot[8] = {16, 42, 12, 31, 16, 32, 24, 21};

inline uint64_t rotl(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

// 20-round Threefry-2x64
inline void threefry2x64(uint64_t k0, uint64_t k1, uint64_t c0, uint64_t c1,
                         uint64_t* o0, uint64_t* o1) {
  uint64_t ks[3] = {k0, k1, kParity ^ k0 ^ k1};
  uint64_t x0 = c0 + ks[0];
  uint64_t x1 = c1 + ks[1];
  for (int round = 0; round < 20; ++round) {
    x0 += x1;
    x1 = rotl(x1, kRot[round % 8]);
    x1 ^= x0;
    if ((round & 3) == 3) {
      int s = round / 4 + 1;
      x0 += ks[s % 3];
      x1 += ks[(s + 1) % 3] + (uint64_t)s;
    }
  }
  *o0 = x0;
  *o1 = x1;
}

}  // namespace

extern "C" {

// Fill out[0..n) with the counter stream [counter, counter+n) under seed.
void ht_threefry_fill_u64(uint64_t seed, uint64_t counter, long n,
                          uint64_t* out, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (n < (1 << 16)) nthreads = 1;
  long per = (n + nthreads - 1) / nthreads;
  std::vector<std::thread> ws;
  for (int t = 0; t < nthreads; ++t) {
    ws.emplace_back([=]() {
      long lo = t * per;
      long hi = lo + per < n ? lo + per : n;
      // pairing is keyed to the ABSOLUTE even counter value so the stream
      // is a pure function of (seed, counter+index) for any thread count
      // AND any segmentation: the element at absolute counter c is always
      // lane (c & 1) of the Threefry block over (c & ~1, c & ~1 | 1)
      for (long i = lo; i < hi;) {
        uint64_t c = counter + (uint64_t)i;
        uint64_t base = c & ~1ULL;
        uint64_t o0, o1;
        threefry2x64(seed, 0, base, base | 1, &o0, &o1);
        if (c == base) {
          out[i] = o0;
          if (i + 1 < hi) out[i + 1] = o1;
          i += 2;
        } else {
          out[i] = o1;
          i += 1;
        }
      }
    });
  }
  for (auto& w : ws) w.join();
}

// Deterministic Fisher–Yates permutation of [0, n) from the seeded stream.
void ht_threefry_permutation(uint64_t seed, long n, int64_t* out) {
  for (long i = 0; i < n; ++i) out[i] = i;
  for (long i = n - 1; i > 0; --i) {
    uint64_t o0, o1;
    threefry2x64(seed, 1, (uint64_t)i, 0, &o0, &o1);
    (void)o1;
    long j = (long)(o0 % (uint64_t)(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

}  // extern "C"
