// Hand-written Hopper (sm_90a) kernel of the masked-noise injection.
//
// It replaces the Pallas TPU kernel of the JAX package:
//   * add_masked_noise <- audiocodec_tpu/ops/pallas_noise.py,
//                         add_masked_noise_pallas (kernel body _noise_kernel)
//
//   out = spectrum + threshold * (sigma_scale * z),   z ~ N(0, 1)
//
// in one pass: spectrum and threshold are read once, out is written once,
// and the normals never go to device memory. The TPU kernel draws its bits
// from the core's hardware generator; here they come from Philox4x32-10
// (Random123's constants, 10 rounds) keyed by (seed, 0), and no bit of a call
// is thrown away: element i = 4j + e belongs to the call with counter
// (j mod 2^32, j div 2^32, 0, 0), whose words (w0, w1) are the uniform pair
// of elements 4j and 4j+1 and (w2, w3) that of 4j+2 and 4j+3. The stream
// does not depend on the launch shape, and ops/philox.py reproduces it bit
// for bit in torch.
//
// Numerics, which the plain torch version in ops/cuda_noise.py shares:
//   * u = 2 - bitcast((bits >> 9) | 0x3F800000), uniform in (0, 1], so that
//     log(u1) is finite (the TPU kernel's map);
//   * Box-Muller on a pair: r = sqrt(-2 log u1), and the even element takes
//     r * cos(a), the odd one r * sin(a), of the one rounded angle
//     a = fl(2 pi u2), in float32 with logf/sqrtf/sincosf of the CUDA math
//     library (no fast math: the plain version stays within a few ulps);
//   * the arithmetic in float32 in the TPU kernel's order, each product and
//     sum rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction), and
//     one rounding to the output type at the store.
//
// What bounds it on an H100: at the main path's shape (32 x 431 x 1024
// elements) it moves 12 bytes an element in float32 (6 in bfloat16), 169
// MB in all, 0.051 ms of the card's 3.35 TB/s (0.025 in bfloat16). The
// generator and Box-Muller run tens of instructions an element, about
// 0.03 ms of the card's instruction rate at that shape, so float32 is bound
// by the bytes and bfloat16 by the instructions (noise_ablation.py times the
// kernel without its loads and without its generator). The design spends
// as few instructions an element as it can and hides them under the loads:
//   * one Philox call and two log/sqrt/sincos a four elements, no random
//     bit thrown away;
//   * a thread takes four float32 or eight bfloat16 elements, one 16-byte
//     load of each operand and one 16-byte store, with streaming cache
//     hints (nothing is read twice); the loads start before the
//     Philox rounds, whose arithmetic hides their latency;
//   * the round keys depend on the seed alone, the same for every thread;
//   * the tail of a count that is not a multiple of 4 (8) and every element
//     of a launch whose pointers are not all 16-byte aligned run a scalar
//     path in the same kernel, four elements (one call) a thread.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float TWO_PI_F = 6.28318530717958647692f;  // float(2 pi)

enum Dtype { F32 = 0, BF16_IN = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Philox4x32-10 of counter (lo, hi, 0, 0) under key (seed, 0): its four
// output words.
__device__ __forceinline__ uint4 philox(uint32_t lo, uint32_t hi,
                                        uint32_t seed) {
  uint32_t c0 = lo, c1 = hi, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float uniform_open01(uint32_t bits) {
  return __fsub_rn(2.f, __uint_as_float((bits >> 9) | 0x3F800000u));
}

// Box-Muller on the words (a, b): z[0] = r cos(2 pi u2), z[1] = r sin.
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b,
                                           float* z) {
  const float radius =
      sqrtf(__fmul_rn(-2.f, logf(uniform_open01(a))));
  float s, c;
  sincosf(__fmul_rn(TWO_PI_F, uniform_open01(b)), &s, &c);
  z[0] = __fmul_rn(radius, c);
  z[1] = __fmul_rn(radius, s);
}

// The normals of elements 4j .. 4j+3.
__device__ __forceinline__ void normals4(size_t j, uint32_t seed, float* z) {
  const uint4 w = philox((uint32_t)j, (uint32_t)(j >> 32), seed);
  box_muller(w.x, w.y, z);
  box_muller(w.z, w.w, z + 2);
}

__device__ __forceinline__ float masked(float spectrum, float threshold,
                                        float z, float sigma_scale) {
  return __fadd_rn(spectrum,
                   __fmul_rn(threshold, __fmul_rn(sigma_scale, z)));
}

// The V = 16 / sizeof(T) results as one 16-byte vector.
__device__ __forceinline__ uint4 pack16(const float (&r)[4]) {
  return make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]),
                    __float_as_uint(r[2]), __float_as_uint(r[3]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ uint4 pack16(const float (&r)[8]) {
  return make_uint4(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]),
                    pack_bf16(r[4], r[5]), pack_bf16(r[6], r[7]));
}

// Grid-stride: first the 16-byte vectors of V = 16 / sizeof(T) elements
// (when `vec`: every pointer 16-byte aligned), then the rest of the count
// four elements a thread, on scalar loads and stores.
template <typename T>
__global__ void __launch_bounds__(THREADS) noise_kernel(
    const T* __restrict__ spectrum, const T* __restrict__ threshold,
    T* __restrict__ out, size_t count, uint32_t seed, float sigma_scale,
    bool vec) {
  constexpr int V = 16 / sizeof(T);
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t tid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t vectors = vec ? count / V : 0;
  for (size_t v = tid; v < vectors; v += stride) {
    const uint4 sv = __ldcs(reinterpret_cast<const uint4*>(spectrum) + v);
    const uint4 tv = __ldcs(reinterpret_cast<const uint4*>(threshold) + v);
    float z[V];
#pragma unroll
    for (int c = 0; c < V / 4; ++c) normals4(v * (V / 4) + c, seed, z + 4 * c);
    const T* se = reinterpret_cast<const T*>(&sv);
    const T* te = reinterpret_cast<const T*>(&tv);
    float r[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      r[e] = masked(to_f(se[e]), to_f(te[e]), z[e], sigma_scale);
    __stcs(reinterpret_cast<uint4*>(out) + v, pack16(r));
  }
  const size_t calls = (count + 3) / 4;
  for (size_t j = vectors * (V / 4) + tid; j < calls; j += stride) {
    float z[4];
    normals4(j, seed, z);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t i = 4 * j + e;
      if (i < count)
        out[i] = from_f<T>(masked(to_f(spectrum[i]), to_f(threshold[i]),
                                  z[e], sigma_scale));
    }
  }
}

// The uniform pairs alone (element i's (u1, u2): elements 2p and 2p+1 share
// pair p), for holding the generator to ops/philox.py bit for bit on the
// card. One call a thread.
__global__ void __launch_bounds__(THREADS) uniforms_kernel(
    float* __restrict__ u1, float* __restrict__ u2, size_t count,
    uint32_t seed) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t j = (size_t)blockIdx.x * THREADS + threadIdx.x;
       j < (count + 3) / 4; j += stride) {
    const uint4 w = philox((uint32_t)j, (uint32_t)(j >> 32), seed);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t i = 4 * j + e;
      if (i < count) {
        u1[i] = uniform_open01(words[e & 2]);
        u2[i] = uniform_open01(words[(e & 2) + 1]);
      }
    }
  }
}

// Enough blocks for `items` threads' work, at most 32 a streaming
// multiprocessor; the grid-stride loops cover the rest.
unsigned grid_for(size_t items) {
  const size_t blocks = (items + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 132 * 32 ? (blocks ? blocks : 1) : 132 * 32);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
void launch_noise(const void* spectrum, const void* threshold, void* out,
                  size_t n, unsigned seed, float sigma_scale,
                  cudaStream_t st) {
  const bool vec =
      aligned16(spectrum) && aligned16(threshold) && aligned16(out);
  constexpr int V = 16 / sizeof(T);
  const size_t items = vec ? n / V + (n % V + 3) / 4 : (n + 3) / 4;
  noise_kernel<T><<<grid_for(items), THREADS, 0, st>>>(
      static_cast<const T*>(spectrum), static_cast<const T*>(threshold),
      static_cast<T*>(out), n, seed, sigma_scale, vec);
}

}  // namespace

extern "C" {

// spectrum, threshold, out: [count] of the dtype (0 float32, 1 bfloat16).
int acx_add_masked_noise(const void* spectrum, const void* threshold,
                         void* out, long long count, unsigned seed, int dtype,
                         float sigma_scale, void* stream) {
  if (count <= 0 || (dtype != F32 && dtype != BF16_IN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    launch_noise<float>(spectrum, threshold, out, (size_t)count, seed,
                        sigma_scale, st);
  else
    launch_noise<bf16>(spectrum, threshold, out, (size_t)count, seed,
                       sigma_scale, st);
  return (int)cudaGetLastError();
}

// u1, u2: float [count], the uniform pairs of elements 0..count-1.
int acx_philox_uniforms(void* u1, void* u2, long long count, unsigned seed,
                        void* stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)count;
  uniforms_kernel<<<grid_for((n + 3) / 4), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(u1), static_cast<float*>(u2), n, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"
