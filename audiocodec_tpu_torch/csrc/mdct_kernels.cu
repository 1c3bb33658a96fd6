// Hand-written Hopper (sm_90a) kernels of the MDCT filter bank.
//
// They replace four Pallas TPU kernels of the JAX package:
//   * fold_matmul    <- audiocodec_tpu/ops/pallas_mdct.py, fold_matmul
//                       (kernel body _fwd_kernel, tiers in _mxu)
//   * matmul_scatter <- audiocodec_tpu/ops/pallas_mdct.py, matmul_scatter
//                       (kernel body _inv_kernel, tiers in _mxu)
//   * radix_fold_matmul    <- pallas_mdct.py, radix_fold_matmul
//                             (kernel body _fwd_kernel_radix)
//   * radix_matmul_scatter <- pallas_mdct.py, radix_matmul_scatter
//                             (kernel body _inv_kernel_radix)
//
// The radix design (ops/radix.py) splits the DCT-IV over the pairs
// (f_n, f_{N-1-n}): a per-pair rotation, two [N/2, N/2] products and a
// one-lane-shift butterfly, half the MACs of the mono design's [N, N]
// product. Here it is three passes per direction, each simple: analysis =
// fold_rotate_kernel -> the GEMM templates below on two halves (Geometry)
// -> butterfly_out_kernel; synthesis = butterfly_in_kernel -> the GEMMs ->
// scatter_kernel<.., RADIX>, which applies the transposed rotation as it
// reads. The spectrum is in standard order: the TPU kernels' even/odd-split
// order and its interleave passes are gone. The intermediates go through
// device memory (float between GEMM and butterfly or rotation): at the
// radix path's shapes (rows=32, T=215, N=2048) that is ~0.3 GB a direction,
// ~0.1 ms of the card's bandwidth against ~29 GFLOP of products, so the
// GEMMs bound these kernels as they do the mono ones.
//
// Layout: rows = batch x channels, [rows, T, N] in, [rows, T+1, N] out, the
// natural sample order. The TPU kernels needed a swizzled lane layout
// because Mosaic has no lane reverse; a CUDA thread reads the mirrored
// address directly, so the fold weights are the MDCT's own (wa_r, wb, wc,
// ffr; p, q, r, s_r) and the matrices are the unpermuted scaled DCT-IV.
// The blocks+1 framing is handled with index masks: no padded copy is made.
//
// What bounds them on an H100: at the main path's shapes (rows=32, T=430,
// N=1024) one direction is 2*32*431*1024^2 = 29 GFLOP against ~113 MB of
// device memory traffic in float32 (~55 MB in bfloat16), i.e. ~250
// FLOP/byte. The card needs ~295 bf16 FLOP per byte before its tensor cores
// rather than its memory are the limit, so both kernels are compute bound
// once the matmul runs on the tensor cores, and far more so in FFMA.
//
// What the design does about it: the matmul of the `default` and `int8`
// tiers runs on the tensor cores (WMMA bf16 -> f32 and s8 -> s32 tiles) in
// 128x128 output tiles, so each staged A and B value feeds 128 MACs; the
// fold is an A-operand prologue computed while the tile is staged into
// shared memory, so the folded signal never goes to device memory; the next
// K step's global loads are issued before the current step's MMAs (register
// staging into a double-buffered shared tile). Still missing on the way to
// the card's tensor-core peak: wgmma, TMA/cp.async and a persistent
// schedule. The FFMA tiers keep a plain 64x64 tile.
//
// Numerics, which the plain torch versions in ops/cuda_mdct.py share:
//   * the fold rounds each product and each sum to the input dtype, with
//     __fmul_rn/__fadd_rn so that nvcc cannot contract them into an FMA
//     (dynamic int8 quantization turns a one-ulp change into a whole step);
//   * `default`: operands rounded to bf16 (RNE), float32 accumulation;
//   * `int8`: per-frame scale max|folded| + 1e-12, q = clip(rint(v * (127 /
//     s)), +-127) (round half to even), exact int32 sums, epilogue
//     float(acc) * (s * mat_scale);
//   * `int8g` (synthesis): one scale per frame and 128-column group, each
//     group's int32 sum added as float(acc_g) * s_g in group order, then
//     multiplied by mat_scale;
//   * `highest`/`high`: float32 FFMA.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // frames per output tile
constexpr int BN = 64;   // columns per output tile
constexpr int BK = 32;   // depth of one K step
constexpr int THREADS = 256;
constexpr int GROUP = 128;  // int8g column group

enum Tier { FFMA = 0, BF16 = 1, INT8 = 2 };
enum Dtype { F32 = 0, BF16_IN = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 result to T's precision (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// One element of the folded frame n (closed form of ops/folding.py::fold):
//   k <  h: wa_r[k]*x[n-1, h-1-k] + wb[k]*x[n-1, h+k]
//   k >= h: wc[j]*x[n, j] - ffr[j]*x[n, N-1-j],  j = k - h
// Frames outside [0, T) read as zeros, which gives the blocks+1 framing.
template <typename T>
__device__ __forceinline__ float fold_value(
    const T* __restrict__ xr, const T* __restrict__ wa_r,
    const T* __restrict__ wb, const T* __restrict__ wc,
    const T* __restrict__ ffr, int n, int k, int t_in, int N) {
  const int h = N >> 1;
  if (k < h) {
    const int m = n - 1;
    if (m < 0 || m >= t_in) return 0.f;
    const T* xb = xr + (size_t)m * N;
    const float a = rnd<T>(__fmul_rn(to_f(xb[h - 1 - k]), to_f(wa_r[k])));
    const float b = rnd<T>(__fmul_rn(to_f(xb[h + k]), to_f(wb[k])));
    return rnd<T>(__fadd_rn(a, b));
  }
  const int j = k - h;
  if (n >= t_in) return 0.f;
  const T* xb = xr + (size_t)n * N;
  const float a = rnd<T>(__fmul_rn(to_f(xb[j]), to_f(wc[j])));
  const float b = rnd<T>(__fmul_rn(to_f(xb[N - 1 - j]), to_f(ffr[j])));
  return rnd<T>(__fsub_rn(a, b));
}

// The A operand: the folded signal (analysis) or the spectrum rows
// (synthesis).
template <typename T, bool FOLD>
__device__ __forceinline__ float a_value(
    const T* __restrict__ xr, const T* __restrict__ w0,
    const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w3, int n, int k, int t_in, int N) {
  if constexpr (FOLD) {
    return fold_value<T>(xr, w0, w1, w2, w3, n, k, t_in, N);
  } else {
    return n < t_in ? to_f(xr[(size_t)n * N + k]) : 0.f;
  }
}

__device__ __forceinline__ signed char quant8(float v, float inv) {
  float t = rintf(__fmul_rn(v, inv));
  t = fminf(fmaxf(t, -127.f), 127.f);
  return (signed char)(int)t;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_s8(signed char a, signed char b,
                                            signed char c, signed char d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// int8 pre-pass of the analysis: scales[row, n] = max_k |folded[n, k]| +
// 1e-12. One block per (frame, row).
template <typename T>
__global__ void __launch_bounds__(THREADS) fold_scale_kernel(
    const T* __restrict__ x, const T* __restrict__ wa_r,
    const T* __restrict__ wb, const T* __restrict__ wc,
    const T* __restrict__ ffr, float* __restrict__ scales, int t_in, int N) {
  const int n = blockIdx.x;
  const int row = blockIdx.y;
  const T* xr = x + (size_t)row * t_in * N;
  float m = 0.f;
  for (int k = threadIdx.x; k < N; k += THREADS)
    m = fmaxf(m, fabsf(fold_value<T>(xr, wa_r, wb, wc, ffr, n, k, t_in, N)));
  __shared__ float red[THREADS / 32];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0.f;
    m = warp_max(m);
    if (threadIdx.x == 0)
      scales[(size_t)row * (t_in + 1) + n] = __fadd_rn(m, 1e-12f);
  }
}

// int8g pre-pass of the synthesis: scales[row, n, g] = max over the 128
// columns of group g of |y[row, n]| + 1e-12. One block per (frame, row),
// one warp per group.
template <typename T>
__global__ void __launch_bounds__(THREADS) group_scale_kernel(
    const T* __restrict__ y, float* __restrict__ scales, int t_in, int N) {
  const int n = blockIdx.x;
  const int row = blockIdx.y;
  const int groups = N / GROUP;
  const T* yr = y + ((size_t)row * t_in + n) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < groups; g += THREADS / 32) {
    float m = 0.f;
    for (int c = lane; c < GROUP; c += 32)
      m = fmaxf(m, fabsf(to_f(yr[g * GROUP + c])));
    m = warp_max(m);
    if (lane == 0)
      scales[((size_t)row * t_in + n) * groups + g] = __fadd_rn(m, 1e-12f);
  }
}

// Where a GEMM's operands lie, by the number of HALVES (a template
// constant, so that the mono instances compile as if it were not there).
// The mono design (HALVES = 1) multiplies A [.., N] by one [N, N] matrix.
// The radix design (HALVES = 2) multiplies the two halves of A's columns by
// two [K, K] matrices (K = N/2) stacked in `mat`, into the two halves of the
// output's columns: output column cg belongs to half cg / K, which reads A's
// columns from half * K and the matrix at mat + half * K * K.
template <int HALVES>
struct Geometry {
  int K, half, c0;  // depth; this column tile's half; its column in the half
  __device__ __forceinline__ Geometry(int N, int cg)
      : K(N / HALVES), half(HALVES == 1 ? 0 : cg / (N / HALVES)),
        c0(cg - half * (N / HALVES)) {}
};

// FFMA tiers (`highest`, `high`): one [BM frames x BN columns] tile of
// A @ mat for one row, where A is the folded signal (FOLD) or the rows of
// x. Output frames: T+1 (FOLD) or T. O is the output element type.
template <typename T, bool FOLD, typename O, int HALVES = 1>
__global__ void __launch_bounds__(THREADS) ffma_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w0,
    const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w3, const float* __restrict__ mat,
    O* __restrict__ out, int t_in, int N) {
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BM;
  const int cg = blockIdx.y * BN;  // output column
  const Geometry<HALVES> g(N, cg);
  const int a0 = g.half * g.K;  // first column of A
  const float* matb = mat + (size_t)a0 * g.K;
  const int row = blockIdx.z;
  const int t_out = FOLD ? t_in + 1 : t_in;
  const T* xr = x + (size_t)row * t_in * N;
  O* outr = out + (size_t)row * t_out * N;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int m = idx / BK, kk = idx % BK;
      As[kk][m] = a_value<T, FOLD>(xr, w0, w1, w2, w3, n0 + m,
                                   a0 + k0 + kk, t_in, N);
    }
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN, c = idx % BN;
      Bs[kk][c] = matb[(size_t)(k0 + kk) * g.K + g.c0 + c];
    }
    __syncthreads();
    // Blocked summation: each K step sums into a fresh partial that is
    // then added to the total. A single running sum over K=1024 costs
    // ~10 dB of round-trip SNR in float32 (simulated: 120 dB sequential
    // against 133 dB blocked by 32), and the tier's round trip must
    // reach 130 dB.
    float part[4][4] = {};
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= t_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      outr[(size_t)n * N + cg + tx * 4 + j] = from_f<O>(acc[i][j]);
  }
}

// Sixteen consecutive elements of T, loaded as 16-byte vectors.
template <typename T>
struct Raw16 {
  uint4 v[sizeof(T)];
  __device__ __forceinline__ void load(const T* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < (int)sizeof(T); ++i) v[i] = __ldg(q + i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T); ++i) v[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ float operator[](int i) const {
    return to_f(reinterpret_cast<const T*>(v)[i]);
  }
};

// Tensor-core tiers (`default`: WMMA bf16 -> f32; `int8`: WMMA s8 -> s32,
// per frame for the analysis, per frame and 128-column group for the
// synthesis). One [MM frames x MN columns] tile for one row; 8 warps as
// 2 (frames) x 4 (columns), each warp 64 x 32 = 4 x 2 WMMA tiles.
//
// Staging: each thread stages 16 consecutive K values of one frame (A) and
// of one column (B) per 32-deep K step, into a double-buffered shared
// tile: the next step's global loads are issued before this step's MMAs,
// and folded/quantized/stored after them, so their latency hides behind
// the tensor cores. Shared tiles are [chunk of 16 K][frame or column][16]:
// A row-major and B column-major, every WMMA pointer 32-byte aligned.
constexpr int MM = 128, MN = 128, MK = 32;

// Two blocks share an SM when a kernel fits in 128 registers a thread
// (measured: int8 analysis 0.655 -> 0.495 ms, bf16 analysis 0.51 -> 0.37
// ms at the main path's shapes). The int8g synthesis (per-group float sums)
// and the float32-input analysis (twice the staged bytes) spill under that
// cap and slow down, so they keep one block.
template <typename T>
__host__ __device__ constexpr int blocks_per_sm(int tier, bool fold) {
  return (tier == INT8 && !fold) || (fold && sizeof(T) == 4) ? 1 : 2;
}

template <typename T, int TIER, bool FOLD, typename O, int HALVES = 1>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<T>(TIER, FOLD))
    mma_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w0,
    const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w3, const void* __restrict__ mat_v,
    const float* __restrict__ scales, O* __restrict__ out, int t_in, int N,
    float mat_scale) {
  using AT = typename std::conditional<TIER == BF16, bf16, signed char>::type;
  using AccT = typename std::conditional<TIER == BF16, float, int>::type;
  constexpr bool GROUPED = TIER == INT8 && !FOLD;
  __shared__ __align__(128) AT As[2][MK / 16][MM][16];
  __shared__ __align__(128) AT Bs[2][MK / 16][MN][16];
  __shared__ __align__(128) AccT scr[THREADS / 32][256];  // per-warp tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * MM, row = blockIdx.z;
  const int cg = blockIdx.y * MN;  // output column (see Geometry)
  const Geometry<HALVES> g(N, cg);
  const int a0 = g.half * g.K;
  const size_t b0 = (size_t)a0 * g.K;
  const int h = N >> 1;
  const int t_out = FOLD ? t_in + 1 : t_in;
  const int groups = N / GROUP;
  const T* xr = x + (size_t)row * t_in * N;
  O* outr = out + (size_t)row * t_out * N;

  // this thread's staging slot: frame / column sm, K chunk skc
  const int sm = tid >> 1, skc = tid & 1;
  const int sn = n0 + sm;
  float inv = 0.f;  // 127 / scale of this thread's frame (int8)
  if (TIER == INT8 && FOLD && sn < t_out)
    inv = __fdiv_rn(127.f, scales[(size_t)row * t_out + sn]);

  Raw16<T> ra, rb;  // A raw: (P, Q) for the fold, P for the synthesis
  float bv[16];     // B raw (one column, 16 K)
  const float* matf = static_cast<const float*>(mat_v) + b0;
  const signed char* mati = static_cast<const signed char*>(mat_v) + b0;

  // global loads of K step k0
  auto load = [&](int k0) {
    const int kg = k0 + skc * 16;
    if constexpr (FOLD) {
      const int frame = kg < h ? sn - 1 : sn;
      if (frame >= 0 && frame < t_in) {
        const T* xb = xr + (size_t)frame * N;
        if (kg < h) {
          ra.load(xb + h + kg);       // P = x[n-1, h+k]
          rb.load(xb + h - 16 - kg);  // Q = x[n-1, h-1-k], reversed
        } else {
          ra.load(xb + kg - h);           // P = x[n, j]
          rb.load(xb + N - 16 - (kg - h));  // Q = x[n, N-1-j], reversed
        }
      } else {
        ra.zero();
        rb.zero();
      }
    } else {
      if (sn < t_in) ra.load(xr + (size_t)sn * N + a0 + kg);
      else ra.zero();
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const size_t at = (size_t)(kg + i) * g.K + g.c0 + sm;
      if constexpr (TIER == BF16) bv[i] = matf[at];
      else bv[i] = (float)mati[at];
    }
  };

  // fold / convert / quantize the loaded step into shared stage s
  auto store = [&](int k0, int s) {
    const int kg = k0 + skc * 16;
    float v[16];
    if constexpr (FOLD) {
      if (kg < h) {
        Raw16<T> wa, wb_;
        wa.load(w0 + kg);   // wa_r, pairs with Q
        wb_.load(w1 + kg);  // wb, pairs with P
#pragma unroll
        for (int i = 0; i < 16; ++i)
          v[i] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(rb[15 - i], wa[i])),
                                  rnd<T>(__fmul_rn(ra[i], wb_[i]))));
      } else {
        Raw16<T> wc_, wf;
        wc_.load(w2 + kg - h);  // wc, pairs with P
        wf.load(w3 + kg - h);   // ffr, pairs with Q
#pragma unroll
        for (int i = 0; i < 16; ++i)
          v[i] = rnd<T>(__fsub_rn(rnd<T>(__fmul_rn(ra[i], wc_[i])),
                                  rnd<T>(__fmul_rn(rb[15 - i], wf[i]))));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = ra[i];
    }
    uint4* a = reinterpret_cast<uint4*>(&As[s][skc][sm][0]);
    uint4* b = reinterpret_cast<uint4*>(&Bs[s][skc][sm][0]);
    if constexpr (TIER == BF16) {
      uint32_t pa[8], pb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pa[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
        pb[i] = pack_bf16(bv[2 * i], bv[2 * i + 1]);
      }
      a[0] = make_uint4(pa[0], pa[1], pa[2], pa[3]);
      a[1] = make_uint4(pa[4], pa[5], pa[6], pa[7]);
      b[0] = make_uint4(pb[0], pb[1], pb[2], pb[3]);
      b[1] = make_uint4(pb[4], pb[5], pb[6], pb[7]);
    } else {
      float q = inv;
      if (GROUPED)
        q = sn < t_in ? __fdiv_rn(127.f, scales[((size_t)row * t_in + sn) *
                                                    groups + kg / GROUP])
                      : 0.f;
      uint32_t pa[4], pb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pack_s8(quant8(v[4 * i], q), quant8(v[4 * i + 1], q),
                        quant8(v[4 * i + 2], q), quant8(v[4 * i + 3], q));
        pb[i] = pack_s8((signed char)(int)bv[4 * i],
                        (signed char)(int)bv[4 * i + 1],
                        (signed char)(int)bv[4 * i + 2],
                        (signed char)(int)bv[4 * i + 3]);
      }
      a[0] = make_uint4(pa[0], pa[1], pa[2], pa[3]);
      b[0] = make_uint4(pb[0], pb[1], pb[2], pb[3]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> acc[4][2];
#pragma unroll
  for (int fm = 0; fm < 4; ++fm)
#pragma unroll
    for (int fn = 0; fn < 2; ++fn) wmma::fill_fragment(acc[fm][fn], AccT(0));
  // the synthesis's float sum over 128-column groups (int8g)
  float sum[GROUPED ? 4 : 1][GROUPED ? 2 : 1][8];

  load(0);
  store(0, 0);
  __syncthreads();
  const int steps = g.K / MK;
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1, k0 = st * MK;
    const bool more = st + 1 < steps;
    if (more) load(k0 + MK);
#pragma unroll
    for (int kc = 0; kc < MK / 16; ++kc) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, AT, wmma::col_major> b[2];
#pragma unroll
      for (int fn = 0; fn < 2; ++fn)
        wmma::load_matrix_sync(b[fn], &Bs[cur][kc][wn * 32 + fn * 16][0], 16);
#pragma unroll
      for (int fm = 0; fm < 4; ++fm) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, AT, wmma::row_major> a;
        wmma::load_matrix_sync(a, &As[cur][kc][wm * 64 + fm * 16][0], 16);
#pragma unroll
        for (int fn = 0; fn < 2; ++fn)
          wmma::mma_sync(acc[fm][fn], a, b[fn], acc[fm][fn]);
      }
    }
    if constexpr (GROUPED) {
      if ((k0 + MK) % GROUP == 0) {
        // close group g: sum += float(acc_g) * s_g, in group order
        const int g = k0 / GROUP;
#pragma unroll
        for (int fm = 0; fm < 4; ++fm)
#pragma unroll
          for (int fn = 0; fn < 2; ++fn) {
            wmma::store_matrix_sync(&scr[warp][0], acc[fm][fn], 16,
                                    wmma::mem_row_major);
            __syncwarp();
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int e = lane + 32 * i;
              const int n = n0 + wm * 64 + fm * 16 + (e >> 4);
              const float s =
                  n < t_in ? scales[((size_t)row * t_in + n) * groups + g]
                           : 0.f;
              const float term = __fmul_rn(__int2float_rn(scr[warp][e]), s);
              sum[fm][fn][i] = g == 0 ? term : __fadd_rn(sum[fm][fn][i], term);
            }
            __syncwarp();
            wmma::fill_fragment(acc[fm][fn], 0);
          }
      }
    }
    if (more) store(k0 + MK, cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int fm = 0; fm < 4; ++fm)
#pragma unroll
    for (int fn = 0; fn < 2; ++fn) {
      if constexpr (!GROUPED) {
        wmma::store_matrix_sync(&scr[warp][0], acc[fm][fn], 16,
                                wmma::mem_row_major);
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = lane + 32 * i;
        const int n = n0 + wm * 64 + fm * 16 + (e >> 4);
        const int col = cg + wn * 32 + fn * 16 + (e & 15);
        if (n >= t_out) continue;
        float v;
        if constexpr (GROUPED) {
          v = __fmul_rn(sum[fm][fn][i], mat_scale);
        } else if constexpr (TIER == INT8) {
          v = __fmul_rn(__int2float_rn(scr[warp][e]),
                        __fmul_rn(scales[(size_t)row * t_out + n], mat_scale));
        } else {
          v = scr[warp][e];
        }
        outr[(size_t)n * N + col] = from_f<O>(v);
      }
      if constexpr (!GROUPED) __syncwarp();
    }
}

// The overlap scatter of the synthesis (ops/folding.py::unfold), from the
// matmul's output z [rows, T, N] to out [rows, T+1, N]:
//   out[n, k]   = p[h-1-k]*z[n, h-1-k] + r[k]*z[n-1, h+k]         (k < h)
//   out[n, h+j] = q[j]*z[n, j]         + s_r[j]*z[n-1, N-1-j]     (j < h)
// Mono: z is the matmul's output, and the arithmetic rounds to Z's
// precision per operation. RADIX: the buffer holds the two transposed
// products [rs | ts] in float, and each z value is their transposed
// rotation (radix_z), rounded to O, as is the arithmetic. out is cast to O.
template <typename O>
__device__ __forceinline__ float radix_z(const float* __restrict__ zf,
                                         const O* __restrict__ rot, int i,
                                         int N) {
  //   z[i]       = rs[i] * rotA[i]   + ts[i] * rotB[i]       (i < M)
  //   z[N-1-m]   = rs[m] * rotA[M+m] + ts[m] * rotB[M+m]     (m < M)
  // rot = [rotA; rotB], [2, N]
  const int M = N >> 1;
  const int m = i < M ? i : N - 1 - i;
  const int c = i < M ? i : M + m;
  return rnd<O>(__fadd_rn(__fmul_rn(zf[m], to_f(rot[c])),
                          __fmul_rn(zf[M + m], to_f(rot[N + c]))));
}

template <typename Z, typename O, bool RADIX>
__global__ void __launch_bounds__(THREADS) scatter_kernel(
    const Z* __restrict__ z, const O* __restrict__ p, const O* __restrict__ q,
    const O* __restrict__ r, const O* __restrict__ s_r,
    const O* __restrict__ rot, O* __restrict__ out, int t_in, int N) {
  using R = typename std::conditional<RADIX, O, Z>::type;  // rounding type
  const int n = blockIdx.x;
  const int row = blockIdx.y;
  const int h = N >> 1;
  const Z* zc = z + ((size_t)row * t_in + n) * N;  // valid if n < T
  const Z* zp = zc - N;                             // valid if n >= 1
  const bool has_cur = n < t_in, has_prev = n >= 1;
  O* o = out + ((size_t)row * (t_in + 1) + n) * N;
  auto zv = [&](const Z* zf, int i) -> float {
    if constexpr (RADIX) return radix_z<O>(zf, rot, i, N);
    else return to_f(zf[i]);
  };
  for (int k = threadIdx.x; k < N; k += THREADS) {
    float a = 0.f, b = 0.f;
    if (k < h) {
      if (has_cur) a = rnd<R>(__fmul_rn(zv(zc, h - 1 - k), to_f(p[h - 1 - k])));
      if (has_prev) b = rnd<R>(__fmul_rn(zv(zp, h + k), to_f(r[k])));
    } else {
      const int j = k - h;
      if (has_cur) a = rnd<R>(__fmul_rn(zv(zc, j), to_f(q[j])));
      if (has_prev) b = rnd<R>(__fmul_rn(zv(zp, N - 1 - j), to_f(s_r[j])));
    }
    o[k] = from_f<O>(rnd<R>(__fadd_rn(a, b)));
  }
}

// Radix analysis, first pass: the fold and the per-pair rotation, from x
// [rows, T, N] to rt [rows, T+1, N] = [r | t~]. With a_k = folded[k] and
// b_k = folded[N-1-k] (k < M = N/2) and rot = [rot1; rot2], [2, N]:
//   r_k  = a_k * rot1[k]   + b_k * rot2[k]
//   t~_k = b_k * rot1[M+k] + a_k * rot2[M+k]
// each product and sum rounded to T (ops/radix.py::rotate).
template <typename T>
__global__ void __launch_bounds__(THREADS) fold_rotate_kernel(
    const T* __restrict__ x, const T* __restrict__ wa_r,
    const T* __restrict__ wb, const T* __restrict__ wc,
    const T* __restrict__ ffr, const T* __restrict__ rot, T* __restrict__ rt,
    int t_in, int N) {
  const int n = blockIdx.x;
  const int row = blockIdx.y;
  const int M = N >> 1;
  const T* xr = x + (size_t)row * t_in * N;
  T* o = rt + ((size_t)row * (t_in + 1) + n) * N;
  for (int k = threadIdx.x; k < M; k += THREADS) {
    const float a = fold_value<T>(xr, wa_r, wb, wc, ffr, n, k, t_in, N);
    const float b = fold_value<T>(xr, wa_r, wb, wc, ffr, n, N - 1 - k, t_in, N);
    o[k] = from_f<T>(rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(a, to_f(rot[k]))),
                                      rnd<T>(__fmul_rn(b, to_f(rot[N + k]))))));
    o[M + k] = from_f<T>(
        rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(b, to_f(rot[M + k]))),
                         rnd<T>(__fmul_rn(a, to_f(rot[N + M + k]))))));
  }
}

// Radix analysis, last pass: the one-lane-shift butterfly from the two
// products uv = [U | V2] (float [rows, F, N]) to the spectrum in standard
// order, y[2j] = U[j] + V2[j-1], y[2j+1] = U[j+1] - V2[j], with zero
// beyond the edges, in float and rounded once to T.
template <typename T>
__global__ void __launch_bounds__(THREADS) butterfly_out_kernel(
    const float* __restrict__ uv, T* __restrict__ y, int N) {
  const size_t frame = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int M = N >> 1;
  const float* u = uv + frame * N;
  const float* v = u + M;
  T* o = y + frame * N;
  for (int j = threadIdx.x; j < M; j += THREADS) {
    o[2 * j] = from_f<T>(j > 0 ? __fadd_rn(u[j], v[j - 1]) : u[j]);
    o[2 * j + 1] = from_f<T>(__fsub_rn(j + 1 < M ? u[j + 1] : 0.f, v[j]));
  }
}

// Radix synthesis, first pass: the transposed butterfly from the spectrum y
// [rows, T, N] (standard order) to [us | vs] [rows, T, N] in T:
//   us[j] = y[2j] + y[2j-1],  vs[j] = y[2j+2] - y[2j+1]
// with zero beyond the edges, each sum rounded to T.
template <typename T>
__global__ void __launch_bounds__(THREADS) butterfly_in_kernel(
    const T* __restrict__ y, T* __restrict__ usvs, int N) {
  const size_t frame = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int M = N >> 1;
  const T* yi = y + frame * N;
  T* o = usvs + frame * N;
  for (int j = threadIdx.x; j < M; j += THREADS) {
    o[j] = j > 0 ? from_f<T>(__fadd_rn(to_f(yi[2 * j]), to_f(yi[2 * j - 1])))
                 : yi[0];
    o[M + j] = from_f<T>(__fsub_rn(j + 1 < M ? to_f(yi[2 * j + 2]) : 0.f,
                                   to_f(yi[2 * j + 1])));
  }
}

template <typename T>
void launch_fold_matmul(const void* x, const void* wa_r, const void* wb,
                        const void* wc, const void* ffr, const void* mat,
                        void* scales, void* out, int rows, int t_in, int N,
                        int tier, float mat_scale, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* w0 = static_cast<const T*>(wa_r);
  const T* w1 = static_cast<const T*>(wb);
  const T* w2 = static_cast<const T*>(wc);
  const T* w3 = static_cast<const T*>(ffr);
  T* o = static_cast<T*>(out);
  float* sc = static_cast<float*>(scales);
  const dim3 grid((t_in + 1 + BM - 1) / BM, N / BN, rows);
  const dim3 mgrid((t_in + 1 + MM - 1) / MM, N / MN, rows);
  if (tier == FFMA) {
    ffma_gemm_kernel<T, true, T><<<grid, THREADS, 0, st>>>(
        xt, w0, w1, w2, w3, static_cast<const float*>(mat), o, t_in, N);
  } else if (tier == BF16) {
    mma_gemm_kernel<T, BF16, true, T><<<mgrid, THREADS, 0, st>>>(
        xt, w0, w1, w2, w3, mat, sc, o, t_in, N, mat_scale);
  } else {
    fold_scale_kernel<T><<<dim3(t_in + 1, rows), THREADS, 0, st>>>(
        xt, w0, w1, w2, w3, sc, t_in, N);
    mma_gemm_kernel<T, INT8, true, T><<<mgrid, THREADS, 0, st>>>(
        xt, w0, w1, w2, w3, mat, sc, o, t_in, N, mat_scale);
  }
}

template <typename T>
void launch_matmul_scatter(const void* y, const void* p, const void* q,
                           const void* r, const void* s_r, const void* mat,
                           void* scales, void* z, void* out, int rows,
                           int t_in, int N, int tier, float mat_scale,
                           cudaStream_t st) {
  const T* yt = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(p);
  const T* wq = static_cast<const T*>(q);
  const T* wr = static_cast<const T*>(r);
  const T* ws = static_cast<const T*>(s_r);
  T* o = static_cast<T*>(out);
  float* sc = static_cast<float*>(scales);
  const dim3 grid((t_in + BM - 1) / BM, N / BN, rows);
  const dim3 mgrid((t_in + MM - 1) / MM, N / MN, rows);
  const dim3 sgrid(t_in + 1, rows);
  if (tier == INT8) {
    float* zf = static_cast<float*>(z);
    group_scale_kernel<T><<<dim3(t_in, rows), THREADS, 0, st>>>(yt, sc, t_in,
                                                                 N);
    mma_gemm_kernel<T, INT8, false, float><<<mgrid, THREADS, 0, st>>>(
        yt, nullptr, nullptr, nullptr, nullptr, mat, sc, zf, t_in, N,
        mat_scale);
    scatter_kernel<float, T, false><<<sgrid, THREADS, 0, st>>>(
        zf, wp, wq, wr, ws, nullptr, o, t_in, N);
    return;
  }
  T* zt = static_cast<T*>(z);
  if (tier == FFMA) {
    ffma_gemm_kernel<T, false, T><<<grid, THREADS, 0, st>>>(
        yt, nullptr, nullptr, nullptr, nullptr,
        static_cast<const float*>(mat), zt, t_in, N);
  } else {
    mma_gemm_kernel<T, BF16, false, T><<<mgrid, THREADS, 0, st>>>(
        yt, nullptr, nullptr, nullptr, nullptr, mat, sc, zt, t_in, N,
        mat_scale);
  }
  scatter_kernel<T, T, false><<<sgrid, THREADS, 0, st>>>(
      zt, wp, wq, wr, ws, nullptr, o, t_in, N);
}

// The two [M, M] products of the radix design: a [rows, frames, N] holds
// the two K halves, mats [2, M, M] the two matrices, prod [rows, frames, N]
// (float) gets the two products side by side.
template <typename T>
void launch_radix_products(const T* a, const float* mats, float* prod,
                           int rows, int frames, int N, int tier,
                           cudaStream_t st) {
  if (tier == FFMA) {
    ffma_gemm_kernel<T, false, float, 2>
        <<<dim3((frames + BM - 1) / BM, N / BN, rows), THREADS, 0, st>>>(
            a, nullptr, nullptr, nullptr, nullptr, mats, prod, frames, N);
  } else {
    mma_gemm_kernel<T, BF16, false, float, 2>
        <<<dim3((frames + MM - 1) / MM, N / MN, rows), THREADS, 0, st>>>(
            a, nullptr, nullptr, nullptr, nullptr, mats, nullptr, prod,
            frames, N, 1.f);
  }
}

template <typename T>
void launch_radix_fold_matmul(const void* x, const void* wa_r, const void* wb,
                              const void* wc, const void* ffr,
                              const void* rot, const void* mats, void* rt,
                              void* uv, void* out, int rows, int t_in, int N,
                              int tier, cudaStream_t st) {
  const dim3 fgrid(t_in + 1, rows);
  fold_rotate_kernel<T><<<fgrid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wa_r),
      static_cast<const T*>(wb), static_cast<const T*>(wc),
      static_cast<const T*>(ffr), static_cast<const T*>(rot),
      static_cast<T*>(rt), t_in, N);
  launch_radix_products<T>(static_cast<const T*>(rt),
                           static_cast<const float*>(mats),
                           static_cast<float*>(uv), rows, t_in + 1, N, tier,
                           st);
  butterfly_out_kernel<T><<<fgrid, THREADS, 0, st>>>(
      static_cast<const float*>(uv), static_cast<T*>(out), N);
}

template <typename T>
void launch_radix_matmul_scatter(const void* y, const void* p, const void* q,
                                 const void* r, const void* s_r,
                                 const void* rot, const void* mats,
                                 void* usvs, void* rsts, void* out, int rows,
                                 int t_in, int N, int tier, cudaStream_t st) {
  butterfly_in_kernel<T><<<dim3(t_in, rows), THREADS, 0, st>>>(
      static_cast<const T*>(y), static_cast<T*>(usvs), N);
  launch_radix_products<T>(static_cast<const T*>(usvs),
                           static_cast<const float*>(mats),
                           static_cast<float*>(rsts), rows, t_in, N, tier, st);
  scatter_kernel<float, T, true><<<dim3(t_in + 1, rows), THREADS, 0, st>>>(
      static_cast<const float*>(rsts), static_cast<const T*>(p),
      static_cast<const T*>(q), static_cast<const T*>(r),
      static_cast<const T*>(s_r), static_cast<const T*>(rot),
      static_cast<T*>(out), t_in, N);
}

bool shape_ok(int rows, int t_in, int N, int dtype, int tier) {
  return rows > 0 && t_in > 0 && N > 0 && N % 256 == 0 &&
         (dtype == F32 || dtype == BF16_IN) && tier >= FFMA && tier <= INT8;
}

}  // namespace

extern "C" {

// x [rows, T, N] -> out [rows, T+1, N]; scales: float [rows, T+1] (int8).
int acx_fold_matmul(const void* x, const void* wa_r, const void* wb,
                    const void* wc, const void* ffr, const void* mat,
                    void* scales, void* out, int rows, int t_in, int N,
                    int dtype, int tier, float mat_scale, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    launch_fold_matmul<float>(x, wa_r, wb, wc, ffr, mat, scales, out, rows,
                              t_in, N, tier, mat_scale, st);
  else
    launch_fold_matmul<bf16>(x, wa_r, wb, wc, ffr, mat, scales, out, rows,
                             t_in, N, tier, mat_scale, st);
  return (int)cudaGetLastError();
}

// y [rows, T, N] -> out [rows, T+1, N] through the scratch z [rows, T, N]
// (float at int8, else y's dtype); scales: float [rows, T, N/128] (int8).
int acx_matmul_scatter(const void* y, const void* p, const void* q,
                       const void* r, const void* s_r, const void* mat,
                       void* scales, void* z, void* out, int rows, int t_in,
                       int N, int dtype, int tier, float mat_scale,
                       void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    launch_matmul_scatter<float>(y, p, q, r, s_r, mat, scales, z, out, rows,
                                 t_in, N, tier, mat_scale, st);
  else
    launch_matmul_scatter<bf16>(y, p, q, r, s_r, mat, scales, z, out, rows,
                                t_in, N, tier, mat_scale, st);
  return (int)cudaGetLastError();
}

// Radix analysis: x [rows, T, N] -> out [rows, T+1, N] in standard order,
// through the scratches rt [rows, T+1, N] (x's dtype) and uv [rows, T+1, N]
// (float); rot [2, N] in x's dtype, mats [2, N/2, N/2] float. No int8 tier.
int acx_radix_fold_matmul(const void* x, const void* wa_r, const void* wb,
                          const void* wc, const void* ffr, const void* rot,
                          const void* mats, void* rt, void* uv, void* out,
                          int rows, int t_in, int N, int dtype, int tier,
                          void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier) || tier == INT8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    launch_radix_fold_matmul<float>(x, wa_r, wb, wc, ffr, rot, mats, rt, uv,
                                    out, rows, t_in, N, tier, st);
  else
    launch_radix_fold_matmul<bf16>(x, wa_r, wb, wc, ffr, rot, mats, rt, uv,
                                   out, rows, t_in, N, tier, st);
  return (int)cudaGetLastError();
}

// Radix synthesis: y [rows, T, N] (standard order) -> out [rows, T+1, N],
// through the scratches usvs [rows, T, N] (y's dtype) and rsts [rows, T, N]
// (float); rot [2, N] in y's dtype, mats [2, N/2, N/2] float. No int8 tier.
int acx_radix_matmul_scatter(const void* y, const void* p, const void* q,
                             const void* r, const void* s_r, const void* rot,
                             const void* mats, void* usvs, void* rsts,
                             void* out, int rows, int t_in, int N, int dtype,
                             int tier, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier) || tier == INT8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    launch_radix_matmul_scatter<float>(y, p, q, r, s_r, rot, mats, usvs, rsts,
                                       out, rows, t_in, N, tier, st);
  else
    launch_radix_matmul_scatter<bf16>(y, p, q, r, s_r, rot, mats, usvs, rsts,
                                      out, rows, t_in, N, tier, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
