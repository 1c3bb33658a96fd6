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
// from the core's hardware generator; here each element draws them from
// Philox4x32-10 (Random123's constants, 10 rounds), keyed by (seed, 0) with
// the counter (i mod 2^32, i div 2^32, 0, 0) for flat element index i. The
// stream therefore does not depend on the launch shape, and
// ops/philox.py reproduces it bit for bit in torch.
//
// Numerics, which the plain torch version in ops/cuda_noise.py shares:
//   * u = 2 - bitcast((bits >> 9) | 0x3F800000), uniform in (0, 1], so that
//     log(u1) is finite (the TPU kernel's map);
//   * Box-Muller z = sqrt(-2 log u1) * cos(2 pi u2) in float32, with
//     logf/cosf/sqrtf of the CUDA math library (no fast math: the plain
//     version stays within a few ulps);
//   * the arithmetic in float32 in the TPU kernel's order, each product and
//     sum rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction), and
//     one rounding to the output type at the store.
//
// What bounds it on an H100: at the main path's shape (32 x 431 x 1024
// elements) it moves 12 bytes an element in float32 (6 in bfloat16), 169
// MB in all, against ~110 integer and float operations an element for the
// generator and Box-Muller: ~1.5 G operations, a few tens of microseconds
// of the card's integer rate. So it is bound by device memory. The design
// does about that only what it must: one pass, each thread one element per
// grid-stride step, neighbouring threads on neighbouring addresses.
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

// Philox4x32-10 of counter (lo, hi, 0, 0) under key (seed, 0); the first two
// output words.
__device__ __forceinline__ uint2 philox_words(uint32_t lo, uint32_t hi,
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
  return make_uint2(c0, c1);
}

__device__ __forceinline__ float uniform_open01(uint32_t bits) {
  return __fsub_rn(2.f, __uint_as_float((bits >> 9) | 0x3F800000u));
}

__device__ __forceinline__ float2 element_uniforms(size_t i, uint32_t seed) {
  const uint2 w = philox_words((uint32_t)i, (uint32_t)(i >> 32), seed);
  return make_float2(uniform_open01(w.x), uniform_open01(w.y));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) noise_kernel(
    const T* __restrict__ spectrum, const T* __restrict__ threshold,
    T* __restrict__ out, size_t count, uint32_t seed, float sigma_scale) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < count;
       i += stride) {
    const float2 u = element_uniforms(i, seed);
    const float radius = sqrtf(__fmul_rn(-2.f, logf(u.x)));
    const float z = __fmul_rn(radius, cosf(__fmul_rn(TWO_PI_F, u.y)));
    const float noise = __fmul_rn(to_f(threshold[i]), __fmul_rn(sigma_scale, z));
    out[i] = from_f<T>(__fadd_rn(to_f(spectrum[i]), noise));
  }
}

// The uniforms alone, for holding the generator to ops/philox.py bit for
// bit on the card.
__global__ void __launch_bounds__(THREADS) uniforms_kernel(
    float* __restrict__ u1, float* __restrict__ u2, size_t count,
    uint32_t seed) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < count;
       i += stride) {
    const float2 u = element_uniforms(i, seed);
    u1[i] = u.x;
    u2[i] = u.y;
  }
}

// Enough blocks to fill the card several times over; the grid-stride loop
// covers the rest.
unsigned grid_for(size_t count) {
  const size_t blocks = (count + THREADS - 1) / THREADS;
  return (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
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
  const size_t n = (size_t)count;
  if (dtype == F32)
    noise_kernel<float><<<grid_for(n), THREADS, 0, st>>>(
        static_cast<const float*>(spectrum),
        static_cast<const float*>(threshold), static_cast<float*>(out), n,
        seed, sigma_scale);
  else
    noise_kernel<bf16><<<grid_for(n), THREADS, 0, st>>>(
        static_cast<const bf16*>(spectrum),
        static_cast<const bf16*>(threshold), static_cast<bf16*>(out), n, seed,
        sigma_scale);
  return (int)cudaGetLastError();
}

// u1, u2: float [count], the uniforms of elements 0..count-1.
int acx_philox_uniforms(void* u1, void* u2, long long count, unsigned seed,
                        void* stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)count;
  uniforms_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<float*>(u1), static_cast<float*>(u2), n, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"
