// T1: Threefry-2x32 counter streams with the uniform, normal and randint
// transforms fused in (heat_tpu_torch/ops/threefry.py).
//
// Replaces no Pallas kernel: the JAX package draws through jax.random, whose
// partitionable Threefry-2x32 XLA lowers to element-wise integer code.  This
// kernel reproduces those streams: element i of a draw of key (k0, k1) hashes
// the 64-bit counter start + i, split into its high and low words, and the
// output is written once in its final type.
//
// Bound: the 20 rounds (an add, a funnel shift and a xor each) and five key
// injections are some 80 32-bit integer operations an element, against 4
// bytes written for f32; at H100 rates the integer pipe, not the 3.35 TB/s of
// device memory, is the limit.  Each thread takes kPer consecutive elements
// of a block's tile, stored with a stride of the block width so that a warp's
// stores are coalesced; the grid walks the range in tiles.
//
// Rounding follows XLA's CPU code, which contracts a multiply and an add into
// one fused multiply-add: the f32 normal's scale to (nextafter(-1, 0), 1) and
// each Horner step of the f32 erf_inv polynomial are fmaf.  The f64 scale and
// erf_inv polynomial take separate multiplies and adds, as the plain version
// does.  A randint element hashes its counter under two keys and combines the
// words modulo the span in unsigned 32- or 64-bit arithmetic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;

enum Kind { kBits32 = 0, kBits64 = 1, kUniform = 2, kNormal = 3, kRandint = 4 };
enum Out { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3, kI32 = 4, kI64 = 5, kI8 = 6, kU8 = 7, kI16 = 8 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
}

// XLA's f32 erf_inv (Giles): two degree-8 polynomials in w = -log1p(-x^2)
__device__ __forceinline__ float erfinv_f32(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f, 0.00021858087f,
                        -0.00125372503f, -0.00417768164f, 0.246640727f,     1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f, 0.00573950773f,
                        -0.0076224613f,   0.00943887047f,  1.00167406f,    2.83297682f};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, w, lt ? lt5[i] : ge5[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.402823466e38f) : __fmul_rn(p, x);
}

// XLA's f64 erf_inv (Giles): 23, 19 and 17 coefficients below 6.25, below 16, above
__device__ double erfinv_f64(double x) {
  const double a[23] = {-3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
                        1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
                        6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
                        2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
                        1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
                        4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
                        0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
                        0.24015818242558962, 1.6536545626831027};
  const double b[19] = {2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
                        1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
                        2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
                        6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
                        0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
                        -0.003751208507569241, 0.005370914553590064, 1.0052589676941592, 3.0838856104922208};
  const double c[17] = {-2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
                        -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
                        2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
                        -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
                        7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
                        1.0103004648645344, 4.849906401408584};
  double w = -log1p(__dmul_rn(-x, x));
  const bool lt625 = w < 6.25, lt16 = w < 16.0;
  w = lt625 ? __dsub_rn(w, 3.125) : __dsub_rn(sqrt(w), lt16 ? 3.25 : 5.0);
  const double* t = lt625 ? a : (lt16 ? b : c);
  const int terms = lt625 ? 23 : (lt16 ? 19 : 17);
  double p = t[0];
  for (int i = 1; i < terms; ++i) p = __dadd_rn(t[i], __dmul_rn(p, w));
  return fabs(x) == 1.0 ? __dmul_rn(x, 1.7976931348623157e308) : __dmul_rn(p, x);
}

// XLA's unsigned remainder: a remainder by 0 leaves its operand
template <typename U>
__device__ __forceinline__ U urem(U x, U m) {
  return m == 0 ? x : x % m;
}

// jax.random.randint's offset: ((h % span) * mult + l % span) % span, wrapping
template <typename U>
__device__ __forceinline__ U randint_offset(U h, U l, U span, U mult) {
  return urem(U(urem(h, span) * mult + urem(l, span)), span);
}

__device__ __forceinline__ void store_int(void* out, int64_t i, int type, int32_t v) {
  if (type == kI32) {
    static_cast<int32_t*>(out)[i] = v;
  } else if (type == kI16) {
    static_cast<int16_t*>(out)[i] = int16_t(v);
  } else if (type == kI8) {
    static_cast<int8_t*>(out)[i] = int8_t(v);
  } else {
    static_cast<uint8_t*>(out)[i] = uint8_t(v);
  }
}

__device__ __forceinline__ void store_float(void* out, int64_t i, int type, float v) {
  if (type == kF32) {
    static_cast<float*>(out)[i] = v;
  } else if (type == kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  }
}

__global__ void __launch_bounds__(kThreads)
    threefry_kernel(uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3, uint64_t start, int64_t n, int kind, int type,
                    uint64_t span, uint64_t mult, uint64_t lo, void* out) {
  const int64_t tile = int64_t(kThreads) * kPer;
  // a normal's uniform u lies on (nextafter(-1, 0), 1)
  const float lo32 = -0.99999994039535522461f, span32 = __fsub_rn(1.0f, lo32);
  const double lo64 = -0.99999999999999988898, span64 = __dsub_rn(1.0, lo64);
  for (int64_t base = int64_t(blockIdx.x) * tile; base < n; base += int64_t(gridDim.x) * tile) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int64_t i = base + int64_t(e) * kThreads + threadIdx.x;
      if (i >= n) break;
      const uint64_t c = start + uint64_t(i);
      uint32_t x0 = uint32_t(c >> 32), x1 = uint32_t(c);
      if (kind == kRandint) {
        uint32_t z0 = x0, z1 = x1;
        threefry2x32(k0, k1, x0, x1);
        threefry2x32(k2, k3, z0, z1);
        if (type == kI64) {
          const uint64_t off = randint_offset<uint64_t>((uint64_t(x0) << 32) | x1, (uint64_t(z0) << 32) | z1, span, mult);
          static_cast<uint64_t*>(out)[i] = lo + off;
        } else {
          const uint32_t off = randint_offset<uint32_t>(x0 ^ x1, z0 ^ z1, uint32_t(span), uint32_t(mult));
          store_int(out, i, type, int32_t(uint32_t(lo) + off));
        }
        continue;
      }
      threefry2x32(k0, k1, x0, x1);
      const uint32_t b32 = x0 ^ x1;
      if (kind == kBits32) {
        static_cast<uint32_t*>(out)[i] = b32;
      } else if (kind == kBits64) {
        static_cast<uint64_t*>(out)[i] = (uint64_t(x0) << 32) | x1;
      } else if (type == kF64) {
        const uint64_t bits = (((uint64_t(x0) << 32) | x1) >> 12) | 0x3FF0000000000000ull;
        const double f = __dsub_rn(__longlong_as_double(int64_t(bits)), 1.0);
        if (kind == kUniform) {
          static_cast<double*>(out)[i] = f;
        } else {
          const double u = fmax(lo64, __dadd_rn(__dmul_rn(f, span64), lo64));
          static_cast<double*>(out)[i] = __dmul_rn(1.4142135623730951, erfinv_f64(u));
        }
      } else if (kind == kUniform && type == kBF16) {
        const uint16_t h = uint16_t(((b32 & 0xFFu) >> 1) | 0x3F80u);
        static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(__fsub_rn(__uint_as_float(uint32_t(h) << 16), 1.0f));
      } else if (kind == kUniform && type == kF16) {
        const uint16_t h = uint16_t(((b32 & 0xFFFFu) >> 6) | 0x3C00u);
        static_cast<__half*>(out)[i] = __float2half_rn(__fsub_rn(__half2float(__ushort_as_half(h)), 1.0f));
      } else {
        const float f = __fsub_rn(__uint_as_float((b32 >> 9) | 0x3F800000u), 1.0f);
        if (kind == kUniform) {
          store_float(out, i, type, f);
        } else {
          const float u = fmaxf(lo32, fmaf(f, span32, lo32));
          store_float(out, i, type, __fmul_rn(1.41421353816986083984375f, erfinv_f32(u)));
        }
      }
    }
  }
}

}  // namespace

// kind and type: the enums above; k2, k3, span, mult and lo (the lower bound's
// bits) serve randint only
extern "C" int heat_threefry(uint32_t k0, uint32_t k1, uint32_t k2, uint32_t k3, uint64_t start, int64_t n, int kind,
                             int type, uint64_t span, uint64_t mult, uint64_t lo, void* out, void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + int64_t(kThreads) * kPer - 1) / (int64_t(kThreads) * kPer);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = int64_t(sms) * 16;
  const unsigned grid = unsigned(tiles < cap ? tiles : cap);
  threefry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(k0, k1, k2, k3, start, n, kind, type,
                                                                            span, mult, lo, out);
  return int(cudaGetLastError());
}
