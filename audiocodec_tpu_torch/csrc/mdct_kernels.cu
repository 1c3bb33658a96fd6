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
// and the four VJPs, each in a transposed mode of the other direction's
// route that reads the cotangent in place: one call, no flip, lane swap or
// crop around it (ops/cuda_mdct.py, "The VJPs"):
//   * the synthesis VJPs pallas_mdct.py _matmul_scatter_bwd and
//     _radix_matmul_scatter_bwd in a transposed-fold mode of the analysis
//     routes (TF below: acx_fold_matmul_t, acx_radix_fold_matmul_t);
//   * the analysis VJPs _fold_matmul_bwd and _radix_fold_matmul_bwd in a
//     transposed-scatter mode of the synthesis routes (TS below:
//     acx_matmul_scatter_t, acx_radix_matmul_scatter_t).
//
// The radix design (ops/radix.py) splits the DCT-IV over the pairs
// (f_n, f_{N-1-n}): a per-pair rotation, two [N/2, N/2] products and a
// one-lane-shift butterfly, half the MACs of the mono design's [N, N]
// product. Here it is three passes per direction, each simple: analysis =
// fold_rotate_kernel (which writes the rotated frames as the bf16 planes
// of the split GEMM's A) -> split_gemm_kernel on two halves (below) ->
// butterfly_out_kernel; synthesis = butterfly_in_kernel (planes likewise)
// -> the same GEMM -> scatter_kernel<.., RADIX>, which applies the
// transposed rotation as it reads. The spectrum is in standard order: the
// TPU kernels' even/odd-split order and its interleave passes are gone.
// The intermediates go through device memory (bf16 planes into the GEMM,
// float out of it): at the radix path's shapes (rows=32, T=215, N=2048)
// that is ~0.25 GB a direction at `highest`, ~0.08 ms of the card's
// bandwidth against 0.176 ms of its six bf16 passes.
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
// rather than its memory are the limit, so the bound is the products' at
// `default` and the bytes' at int8; at `highest` and `high` it is the
// products' of the split tiers' six bf16 passes, 0.175 ms at 989 TF/s,
// where float32 FFMA alone would need 0.432 ms at 67 TF/s.
// What holds tc_kernel back in practice is its note's subject (below).
//
// What the design does about it: the mono design's `default` and `int8`
// tiers run tc_kernel (below): wgmma on Hopper's tensor cores, the matrix
// streamed into shared memory by TMA, the fold (or the spectrum rows)
// built once per frame into a shared A tile, the int8 scales taken in the
// same pass, and the synthesis's overlap scatter in the epilogue, so a
// direction is one launch and nothing but x and the output goes through
// device memory. The split tiers (`highest`, `high`) run split_gemm_kernel
// (below): both operands as bf16 planes of their float32 values, streamed
// by TMA, and the products of the planes on wgmma; the synthesis there
// keeps a z scratch and scatter_kernel. The radix design keeps its three
// passes, its products on split_gemm_kernel at every tier (one pass on one
// plane at `default`).
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
//   * `highest`/`high` (float32 only): the split products below, within
//     the tier's error of the plain versions' float32 products.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 128;  // int8g column group

enum Tier { HIGHEST = 0, BF16 = 1, INT8 = 2, HIGH = 3 };
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

// One element of the transposed fold (ops/folding.py::fold_t): frame n of
// the synthesis VJP's T folded frames, read from the cotangent g [T+1, N]
// in place (w = the unfold VJP weights, ops/cuda_mdct.py):
//   k <  h: wa_r[k]*g[n+1, N-1-k] + wb[k]*g[n+1, k]
//   k >= h: wc[j]*g[n, h+j]       - ffr[j]*g[n, h-1-j],  j = k - h
// fold_value's products, sum and roundings with the same weight on the same
// load: only the addresses differ (the forward value at k, the mirrored one
// at N-1-k, in both halves). It equals fold_value on swap(flipT(g)) at
// frame T-n, bit for bit (flipT reverses the frames, swap exchanges the
// lane halves). Every frame it reads exists (n < T).
template <typename T>
__device__ __forceinline__ float fold_t_value(
    const T* __restrict__ gr, const T* __restrict__ wa_r,
    const T* __restrict__ wb, const T* __restrict__ wc,
    const T* __restrict__ ffr, int n, int k, int N) {
  const int h = N >> 1;
  if (k < h) {
    const T* gb = gr + (size_t)(n + 1) * N;
    const float a = rnd<T>(__fmul_rn(to_f(gb[N - 1 - k]), to_f(wa_r[k])));
    const float b = rnd<T>(__fmul_rn(to_f(gb[k]), to_f(wb[k])));
    return rnd<T>(__fadd_rn(a, b));
  }
  const int j = k - h;
  const T* gb = gr + (size_t)n * N;
  const float a = rnd<T>(__fmul_rn(to_f(gb[k]), to_f(wc[j])));
  const float b = rnd<T>(__fmul_rn(to_f(gb[h - 1 - j]), to_f(ffr[j])));
  return rnd<T>(__fsub_rn(a, b));
}

// The folded frames a row of t_in input frames: T+1 from x [T] (the
// analysis), T from the cotangent g [T+1] in the transposed fold (TF).
__host__ __device__ constexpr int fold_frames(bool tf, int t_in) {
  return tf ? t_in - 1 : t_in + 1;
}

// Element k of folded frame n: the fold of x, or with TF the transposed
// fold of g.
template <typename T, bool TF>
__device__ __forceinline__ float fold_at(
    const T* __restrict__ xr, const T* __restrict__ w0,
    const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w3, int n, int k, int t_in, int N) {
  if constexpr (TF) return fold_t_value<T>(xr, w0, w1, w2, w3, n, k, N);
  else return fold_value<T>(xr, w0, w1, w2, w3, n, k, t_in, N);
}

// The A operand: the folded signal (analysis; with TF the transposed fold
// of the synthesis VJP) or the spectrum rows (synthesis).
template <typename T, bool FOLD, bool TF = false>
__device__ __forceinline__ float a_value(
    const T* __restrict__ xr, const T* __restrict__ w0,
    const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w3, int n, int k, int t_in, int N) {
  if constexpr (FOLD) {
    return fold_at<T, TF>(xr, w0, w1, w2, w3, n, k, t_in, N);
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

// a = s[0] + s[1] + s[2] in bf16 (exact for normal a): each residual is
// exact in float32, and __fsub_rn keeps nvcc from contracting anything.
__device__ __forceinline__ void split3(float a, bf16 (&s)[3]) {
  float r = a;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    s[p] = __float2bfloat16_rn(r);
    r = __fsub_rn(r, __bfloat162float(s[p]));
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The first NP planes of split3(v) at dst, dst + plane, ...
template <int NP>
__device__ __forceinline__ void put_planes(bf16* dst, size_t plane, float v) {
  bf16 s[3];
  split3(v, s);
#pragma unroll
  for (int p = 0; p < NP; ++p) dst[p * plane] = s[p];
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

// TS (the analysis VJP, ops/folding.py::unfold_t): the transposed scatter
// of the product zg [rows, t_in = T+1, N] of the cotangent to out [rows, T,
// N], with the analysis VJP's weights in the same slots (p, q, r, s_r):
//   out[n, k]   = q[k]*zg[n, k]           + s_r[k]*zg[n+1, N-1-k]   (k < h)
//   out[n, h+j] = p[h-1-j]*zg[n, h-1-j]   + r[j]*zg[n+1, h+j]       (j < h)
// the overlap scatter's products, roundings and sum "current + the other
// frame", reading frames n and n+1 (both exist) in place of n and n-1.
template <typename Z, typename O, bool RADIX, bool TS = false>
__global__ void __launch_bounds__(THREADS) scatter_kernel(
    const Z* __restrict__ z, const O* __restrict__ p, const O* __restrict__ q,
    const O* __restrict__ r, const O* __restrict__ s_r,
    const O* __restrict__ rot, O* __restrict__ out, int t_in, int N) {
  using R = typename std::conditional<RADIX, O, Z>::type;  // rounding type
  const int n = blockIdx.x;
  const int row = blockIdx.y;
  const int h = N >> 1;
  if constexpr (TS) {
    const Z* zc = z + ((size_t)row * t_in + n) * N;  // n < T = t_in - 1
    const Z* zn = zc + N;
    O* o = out + ((size_t)row * (t_in - 1) + n) * N;
    auto zv = [&](const Z* zf, int i) -> float {
      if constexpr (RADIX) return radix_z<O>(zf, rot, i, N);
      else return to_f(zf[i]);
    };
    for (int k = threadIdx.x; k < N; k += THREADS) {
      float a, b;
      if (k < h) {
        a = rnd<R>(__fmul_rn(zv(zc, k), to_f(q[k])));
        b = rnd<R>(__fmul_rn(zv(zn, N - 1 - k), to_f(s_r[k])));
      } else {
        const int j = k - h;
        a = rnd<R>(__fmul_rn(zv(zc, h - 1 - j), to_f(p[h - 1 - j])));
        b = rnd<R>(__fmul_rn(zv(zn, h + j), to_f(r[j])));
      }
      o[k] = from_f<O>(rnd<R>(__fadd_rn(a, b)));
    }
    return;
  }
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
// [rows, T, N] to the split GEMM's A planes of rt = [r | t~] ([NP, m_pad,
// N] bf16, row m = row x (T+1) + frame; rows from rows x (T+1) to m_pad are
// zeros). With TF (the synthesis VJP) the fold is the transposed one of the
// cotangent g [rows, t_in = T+1, N], T frames a row. With a_k = folded[k]
// and b_k = folded[N-1-k] (k < M = N/2) and rot = [rot1; rot2], [2, N]:
//   r_k  = a_k * rot1[k]   + b_k * rot2[k]
//   t~_k = b_k * rot1[M+k] + a_k * rot2[M+k]
// each product and sum rounded to T (ops/radix.py::rotate), then split into
// NP planes (split3; a bf16 value is its own plane 0). One block a row of A.
template <typename T, int NP, bool TF>
__global__ void __launch_bounds__(THREADS) fold_rotate_kernel(
    const T* __restrict__ x, const T* __restrict__ wa_r,
    const T* __restrict__ wb, const T* __restrict__ wc,
    const T* __restrict__ ffr, const T* __restrict__ rot,
    bf16* __restrict__ planes, int rows, int t_in, int N, int m_pad) {
  const int m = blockIdx.x;
  const int frames = fold_frames(TF, t_in);
  const bool valid = m < rows * frames;
  const int row = valid ? m / frames : 0;
  const int n = m - row * frames;
  const int M = N >> 1;
  const T* xr = x + (size_t)row * t_in * N;
  bf16* o = planes + (size_t)m * N;
  const size_t plane = (size_t)m_pad * N;
  for (int k = threadIdx.x; k < M; k += THREADS) {
    float r = 0.f, t = 0.f;
    if (valid) {
      const float a = fold_at<T, TF>(xr, wa_r, wb, wc, ffr, n, k, t_in, N);
      const float b =
          fold_at<T, TF>(xr, wa_r, wb, wc, ffr, n, N - 1 - k, t_in, N);
      r = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(a, to_f(rot[k]))),
                           rnd<T>(__fmul_rn(b, to_f(rot[N + k])))));
      t = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(b, to_f(rot[M + k]))),
                           rnd<T>(__fmul_rn(a, to_f(rot[N + M + k])))));
    }
    put_planes<NP>(o + k, plane, r);
    put_planes<NP>(o + M + k, plane, t);
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
// [rows, T, N] (standard order) to the split GEMM's A planes of [us | vs]
// ([NP, m_pad, N] bf16, row m = row x T + frame, zero rows to m_pad):
//   us[j] = y[2j] + y[2j-1],  vs[j] = y[2j+2] - y[2j+1]
// with zero beyond the edges, each sum rounded to T, then split into NP
// planes. One block a row of A.
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS) butterfly_in_kernel(
    const T* __restrict__ y, bf16* __restrict__ planes, int frames, int N,
    int m_pad) {
  const int m = blockIdx.x;
  const bool valid = m < frames;  // frames: rows x T
  const int M = N >> 1;
  const T* yi = y + (size_t)(valid ? m : 0) * N;
  bf16* o = planes + (size_t)m * N;
  const size_t plane = (size_t)m_pad * N;
  for (int j = threadIdx.x; j < M; j += THREADS) {
    float us = 0.f, vs = 0.f;
    if (valid) {
      us = j > 0 ? rnd<T>(__fadd_rn(to_f(yi[2 * j]), to_f(yi[2 * j - 1])))
                 : to_f(yi[0]);
      vs = rnd<T>(__fsub_rn(j + 1 < M ? to_f(yi[2 * j + 2]) : 0.f,
                            to_f(yi[2 * j + 1])));
    }
    put_planes<NP>(o + j, plane, us);
    put_planes<NP>(o + M + j, plane, vs);
  }
}

// ---- The mono design's tensor-core tiers on Hopper -------------------------
//
// One kernel per direction and tier: tc_kernel<T, TIER, FOLD>. A block owns
// a tile of frames of one row and loops over all N output columns itself,
// as the TPU kernels' _fwd_kernel / _inv_kernel do:
//
//   * A, the block's frames as the products' left operand, is built once in
//     shared memory (128-byte-swizzled K-major tiles, hopper.cuh; N <=
//     TC_KA, else see K passes below): the fold of x (analysis) or the rows
//     of y (synthesis), rounded to bf16 or quantized to int8. One warp per
//     frame, so the int8 scales (one per frame in the analysis, one per
//     frame and 128-column group in the synthesis) are warp reductions over
//     values held in registers: no pre-pass, no second read of x or y. A
//     bf16 fold runs on packed bf16 pairs (one rounding an operation, as the
//     float fold rounds).
//   * B, the matrix in its operand form ([N_out, K], K contiguous: bf16 at
//     `default`, int8 codes at int8; the synthesis's output columns in pair
//     order, below), streams through a ring of shared-memory stages by TMA
//     from one producer warp (mbarriers full/empty per stage). The matrix is
//     1-2 MB and stays in L2.
//   * Two consumer warpgroups run wgmma (m64 nW k16 bf16 -> f32, k32 s8 ->
//     s32) on every stage: at `default` they share the block's 64 frames
//     and split the stage's columns (SPLIT_N), at int8 they split the
//     block's 128 frames and share the columns.
//   * Analysis epilogue: float32 sums (times s * mat_scale at int8) rounded
//     to the output dtype and stored from registers (bf16 as 16-byte
//     vectors after an exchange within each quad of lanes).
//   * Synthesis epilogue: the overlap scatter. The operand's columns are in
//     pair order (ops/cuda_mdct.py::pair_permutation): each 64-column block
//     holds z[:, c] for 32 consecutive c < N/2, then z[:, N-1-c] for the
//     same c, which are all that output columns h-1-c and h+c need. The
//     block's z tile, rounded as the plain version rounds z, is staged in
//     shared memory and each output frame n reads z[n] and z[n-1] from it.
//     Frame tiles overlap by that one frame (BM input frames give BM-1
//     output frames), so every output frame is written by one block: no
//     atomics, one summation order.
//   * int8g: each 128-column group is one stage; its four k32 steps run
//     with a fresh int32 sum, and float(sum_g) * s_g joins a float32 sum in
//     group order. That sum reads the group's accumulator, so a warpgroup
//     waits for its products each group (ptxas serializes them anyway when
//     two accumulators take turns, and that variant measured 9% slower);
//     the other warpgroup's products run meanwhile.
//
// Shared memory: A 128 KB (64 frames bf16, 128 frames int8, K up to
// TC_KA) + the ring (3-6 stages, 96/64/80/48 KB) + the synthesis's z tile
// (32 KB) + the int8 scales; one block an SM, 2 + 1/4 warpgroups.
//
// K passes (N > TC_KA): A holds TC_KA columns of K at a time. A chunk runs
// its K tiles pass by pass, and the consumers rebuild A (both warpgroups'
// products done, then the build, between two named barriers) where the
// pass changes. Chunks take the passes in alternate directions, so the
// pass A holds at a chunk's end starts the next (one rebuild a chunk at
// N = 2 TC_KA); int8g keeps the group order (its float sum) and rebuilds
// twice. The int8 analysis first takes each frame's max over all passes
// (a fold that stores nothing), since its one scale covers the frame.
//
// Tiling: 431 analysis frames of a row are 7 tiles of 64 (default) or 4
// of 128 (int8): 224 or 128 blocks for 32 rows against 132 SMs. The
// synthesis's 432 output frames are 7 tiles of 63 or 4 of 127, the same
// counts. A persistent schedule would even out default's second wave (224
// blocks on 132 SMs); it is left for later.

constexpr int TC_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int TC_KA = 1024;      // K columns of an A tile
constexpr int PAIR_BLOCK = 64;   // synthesis operand columns per pair block

template <int TIER, bool FOLD> struct TcCfg;
template <> struct TcCfg<BF16, true> {
  static constexpr int BM = 64, BNW = 128, STAGES = 3;
  static constexpr bool SPLIT_N = true;
};
template <> struct TcCfg<BF16, false> {
  static constexpr int BM = 64, BNW = 64, STAGES = 4;
  static constexpr bool SPLIT_N = true;
};
template <> struct TcCfg<INT8, true> {
  static constexpr int BM = 128, BNW = 128, STAGES = 5;
  static constexpr bool SPLIT_N = false;
};
template <> struct TcCfg<INT8, false> {
  static constexpr int BM = 128, BNW = 64, STAGES = 6;
  static constexpr bool SPLIT_N = false;
};

template <int TIER, bool FOLD>
struct Tc : TcCfg<TIER, FOLD> {
  using C = TcCfg<TIER, FOLD>;
  static constexpr int ESZ = TIER == BF16 ? 2 : 1;  // operand bytes
  static constexpr int KT_ELEMS = 128 / ESZ;        // K of one 128-byte tile
  static constexpr int BN = C::SPLIT_N ? 2 * C::BNW : C::BNW;  // stage rows
  static constexpr int STAGE_BYTES = BN * 128;
  static constexpr int TILE = FOLD ? C::BM : C::BM - 1;  // output frames
  static constexpr bool GROUPED = TIER == INT8 && !FOLD;
  // the synthesis's z tile: per warpgroup [64][BNW] (SPLIT_N) or [BM][BNW]
  static constexpr int ZS_FLOATS =
      FOLD ? 0 : (C::SPLIT_N ? 2 * 64 * C::BNW : C::BM * C::BNW);
  static constexpr int BAR_BYTES = 128;  // full and empty barriers
  static_assert(2 * C::STAGES * 8 <= BAR_BYTES, "barrier space");
  static_assert(FOLD || C::BNW == PAIR_BLOCK, "one pair block a warpgroup");

  __host__ __device__ static size_t a_bytes(int N) {
    return (size_t)C::BM * (N < TC_KA ? N : TC_KA) * ESZ;
  }
  __host__ __device__ static int scale_floats(int N) {
    return TIER != INT8 ? 0 : FOLD ? C::BM : C::BM * (N / GROUP);
  }
  __host__ __device__ static size_t smem_bytes(int N) {  // +1024: aligned by hand
    return 1024 + a_bytes(N) + (size_t)C::STAGES * STAGE_BYTES + BAR_BYTES +
           4 * (size_t)(ZS_FLOATS + scale_floats(N));
  }
};

// Eight consecutive elements of T, loaded raw (one or two 16-byte loads) and
// read as floats.
template <typename T>
struct Raw8 {
  uint4 v[sizeof(T) / 2];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i)
      v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i) v[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ float operator[](int i) const {
    return to_f(reinterpret_cast<const T*>(v)[i]);
  }
};

// Packed bf16 pairs, one rounding per operation: op 0 multiplies, 1 adds,
// 2 subtracts. The explicit .rn keeps ptxas from contracting a product and
// a sum into one fma (one rounding for both). For bf16 operands each equals
// the fold's float operation rounded to bf16: the product of two bf16
// values is exact in float32, and their float32 sum is exact or far from a
// bf16 rounding tie.
__device__ __forceinline__ uint32_t bf2_op(uint32_t a, uint32_t b, int op) {
  uint32_t r;
  if (op == 0)
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  else if (op == 1)
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  else
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Bf16 words 2w, 2w+1 of the fold from raw bf16 chunks (Q reversed).
__device__ __forceinline__ uint32_t fold_word(bool lo, const uint4& p,
                                              const uint4& q, const uint4& w0,
                                              const uint4& w1, int w) {
  const uint32_t qr = __byte_perm(word(q, 3 - w), 0, 0x1032);  // Q[7-e]
  const uint32_t pw = word(p, w);
  return lo ? bf2_op(bf2_op(qr, word(w0, w), 0), bf2_op(pw, word(w1, w), 0), 1)
            : bf2_op(bf2_op(pw, word(w0, w), 0), bf2_op(qr, word(w1, w), 0), 2);
}

// The 16-byte chunk `c` (0-7) of row m of a swizzled A tile.
__device__ __forceinline__ uint4* a_chunk(uint8_t* tile, int m, int c) {
  return reinterpret_cast<uint4*>(tile + m * 128 + ((c ^ (m & 7)) << 4));
}

// Build the block's A, K columns [kb, kb + TC_KA) of it: row m of the
// tile is folded frame tile0 + m (FOLD) or spectrum frame tile0 - 1 + m,
// zero outside the signal. One warp a frame, FR frames a round with every
// load of the round in flight before any arithmetic (the build is bound by
// load latency); the fold weights of a lane's chunks are loaded once. A
// lane holds 8-value chunks lane + 32i (bf16 A, K tiles of 64) or 16-value
// chunks (int8 A, K tiles and int8g groups of 128) of the pass. At int8
// the frame's (FOLD) or each 128-column group's scale max|v| + 1e-12 is a
// warp reduction over the values in registers, written to `scales` ([BM]
// or [BM][N/128]); then v is quantized with 127 / scale as the plain
// version does. A frame wider than TC_KA takes its one scale from `scan`
// builds of every pass first, which store only the running max (and at
// the last pass the scale).
//
// Fold, for k = k0 + e (fold_value's operations and roundings):
//   k0 <  h: v = wa_r[k]*x[n-1, h-1-k] + wb[k]*x[n-1, h+k]
//   k0 >= h: v = wc[j]*x[n, j] - ffr[j]*x[n, N-1-j],  j = k - h
// The chunk P holds the values that meet wb (k0 < h) or wc, Q reversed
// those that meet wa_r or ffr. With TF (the synthesis VJP's transposed fold
// of the cotangent g, fold_t_value) P is g[src, k0..k0+7] and Q g[src,
// N-8-k0..N-1-k0] in both halves, src = n+1 for k0 < h and n above: the
// same pairs of weights and values, so the arithmetic below is shared.
template <typename T, int TIER, bool FOLD, bool TF>
__device__ __forceinline__ void build_a(
    uint8_t* A, float* scales, const T* __restrict__ xr,
    const T* __restrict__ w0, const T* __restrict__ w1,
    const T* __restrict__ w2, const T* __restrict__ w3, int tile0, int t_in,
    int N, int kb, bool scan, int warp, int lane) {
  constexpr int BM = Tc<TIER, FOLD>::BM;
  constexpr int CW = TIER == BF16 ? 8 : 16;  // values a chunk
  constexpr int HW = CW / 8;                 // 8-value halves a chunk
  constexpr int CPL = TC_KA / CW / 32;       // chunks a lane
  constexpr int FR = sizeof(T) == 2 ? 2 : 1;  // frames a round
  const int h = N >> 1;
  const int first = FOLD ? tile0 : tile0 - 1;
  const int chunks = (N - kb < TC_KA ? N - kb : TC_KA) / CW;  // of the pass

  Raw8<T> W0[FOLD ? CPL : 1][HW], W1[FOLD ? CPL : 1][HW];
  if constexpr (FOLD) {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int hf = 0; hf < HW; ++hf) {
        const int k0 = kb + (lane + 32 * i) * CW + 8 * hf;
        if (lane + 32 * i >= chunks) {
          W0[i][hf].zero();
          W1[i][hf].zero();
        } else if (k0 < h) {
          W0[i][hf].load(w0 + k0);      // wa_r
          W1[i][hf].load(w1 + k0);      // wb
        } else {
          W0[i][hf].load(w2 + k0 - h);  // wc
          W1[i][hf].load(w3 + k0 - h);  // ffr
        }
      }
  }

  for (int m0 = warp; m0 < BM; m0 += 8 * FR) {
    Raw8<T> P[FR][CPL][HW], Q[FOLD ? FR : 1][CPL][HW];
#pragma unroll
    for (int f = 0; f < FR; ++f)
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int hf = 0; hf < HW; ++hf) {
          const int ci = lane + 32 * i, k0 = kb + ci * CW + 8 * hf;
          const int n = first + m0 + 8 * f;
          if constexpr (TF) {  // g[n+1] below h, g[n] above
            const int src = k0 < h ? n + 1 : n;
            if (ci < chunks && src < t_in) {
              const T* gb = xr + (size_t)src * N;
              P[f][i][hf].load(gb + k0);
              Q[f][i][hf].load(gb + N - 8 - k0);
            } else {
              P[f][i][hf].zero();
              Q[f][i][hf].zero();
            }
          } else if constexpr (FOLD) {
            const int src = k0 < h ? n - 1 : n;
            if (ci < chunks && src >= 0 && src < t_in) {
              const T* xb = xr + (size_t)src * N;
              P[f][i][hf].load(k0 < h ? xb + h + k0 : xb + k0 - h);
              Q[f][i][hf].load(k0 < h ? xb + h - 8 - k0 : xb + N - 8 - (k0 - h));
            } else {
              P[f][i][hf].zero();
              Q[f][i][hf].zero();
            }
          } else {
            if (ci < chunks && n >= 0 && n < t_in)
              P[f][i][hf].load(xr + (size_t)n * N + k0);
            else
              P[f][i][hf].zero();
          }
        }
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int m = m0 + 8 * f;
      float v[CPL][HW][8];
      uint4 packed[CPL][HW];  // bf16 fold: the values as bf16 pairs
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int hf = 0; hf < HW; ++hf) {
          const int k0 = kb + (lane + 32 * i) * CW + 8 * hf;
          if constexpr (FOLD && sizeof(T) == 2) {
            const uint4 &p = P[f][i][hf].v[0], &q = Q[f][i][hf].v[0];
            const uint4 &a = W0[i][hf].v[0], &b = W1[i][hf].v[0];
            const bool lo = k0 < h;
            packed[i][hf] = make_uint4(fold_word(lo, p, q, a, b, 0),
                                       fold_word(lo, p, q, a, b, 1),
                                       fold_word(lo, p, q, a, b, 2),
                                       fold_word(lo, p, q, a, b, 3));
            const bf16* pb = reinterpret_cast<const bf16*>(&packed[i][hf]);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[i][hf][e] = to_f(pb[e]);
            continue;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if constexpr (FOLD) {
              const Raw8<T>& p = P[f][i][hf];
              const Raw8<T>& q = Q[f][i][hf];
              v[i][hf][e] =
                  k0 < h
                      ? rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(q[7 - e], W0[i][hf][e])),
                                         rnd<T>(__fmul_rn(p[e], W1[i][hf][e]))))
                      : rnd<T>(__fsub_rn(rnd<T>(__fmul_rn(p[e], W0[i][hf][e])),
                                         rnd<T>(__fmul_rn(q[7 - e], W1[i][hf][e]))));
            } else {
              v[i][hf][e] = P[f][i][hf][e];
            }
          }
        }
      if constexpr (TIER == BF16) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int ci = lane + 32 * i;
          if (ci >= chunks) continue;
          const float* u = v[i][0];
          *a_chunk(A + (size_t)(ci >> 3) * BM * 128, m, ci & 7) =
              FOLD && sizeof(T) == 2
                  ? packed[i][0]
                  : make_uint4(pack_bf16(u[0], u[1]), pack_bf16(u[2], u[3]),
                               pack_bf16(u[4], u[5]), pack_bf16(u[6], u[7]));
        }
      } else {
        float gmax[CPL], amax = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          gmax[i] = 0.f;
#pragma unroll
          for (int hf = 0; hf < HW; ++hf)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              gmax[i] = fmaxf(gmax[i], fabsf(v[i][hf][e]));
          amax = fmaxf(amax, gmax[i]);
        }
        float inv[CPL];
        if constexpr (FOLD) {  // one scale for the frame
          float s = warp_max(amax);
          if (N <= TC_KA) {
            s = __fadd_rn(s, 1e-12f);
            if (lane == 0) scales[m] = s;
          } else if (scan) {  // the running max over the passes
            if (kb > 0) s = fmaxf(s, scales[m]);
            if (kb + TC_KA >= N) s = __fadd_rn(s, 1e-12f);
            if (lane == 0) scales[m] = s;
            continue;
          } else {
            s = scales[m];
          }
#pragma unroll
          for (int i = 0; i < CPL; ++i) inv[i] = __fdiv_rn(127.f, s);
        } else {  // one per 128-column group: 8 neighbouring lanes
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            float g = gmax[i];
#pragma unroll
            for (int o = 1; o < 8; o <<= 1)
              g = fmaxf(g, __shfl_xor_sync(0xffffffffu, g, o));
            const float s = __fadd_rn(g, 1e-12f);
            const int ci = lane + 32 * i;
            if ((lane & 7) == 0 && ci < chunks)
              scales[m * (N / GROUP) + kb / GROUP + (ci >> 3)] = s;
            inv[i] = __fdiv_rn(127.f, s);
          }
        }
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int ci = lane + 32 * i;
          if (ci >= chunks) continue;
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* u = &v[i][e >> 1][4 * (e & 1)];
            w[e] = pack_s8(quant8(u[0], inv[i]), quant8(u[1], inv[i]),
                           quant8(u[2], inv[i]), quant8(u[3], inv[i]));
          }
          *a_chunk(A + (size_t)(ci >> 3) * BM * 128, m, ci & 7) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }
}

// a[jj] of lane q of a quad is M[q][jj]; afterwards a[k] = M[k][q]: the
// off-diagonal 2 x 2 blocks swapped between lanes q and q ^ 2, then each
// 2 x 2 block transposed between lanes q and q ^ 1.
template <typename V>
__device__ __forceinline__ void quad_transpose(V (&a)[4], int q) {
  const bool hb = q & 2, lb = q & 1;
  V s0 = hb ? a[0] : a[2], s1 = hb ? a[1] : a[3];
  V r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  V r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hb) {
    a[0] = r0;
    a[1] = r1;
  } else {
    a[2] = r0;
    a[3] = r1;
  }
  s0 = lb ? a[0] : a[1];
  s1 = lb ? a[2] : a[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (lb) {
    a[0] = r0;
    a[2] = r1;
  } else {
    a[1] = r0;
    a[3] = r1;
  }
}

// Four consecutive elements of T at p (8- or 16-byte aligned), rounded.
template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c,
                                       float d) {
  if constexpr (sizeof(T) == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b),
                                              pack_bf16(c, d));
  else
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// x [rows, T, N] -> out [rows, T+1, N]: the analysis (FOLD; w = wa_r, wb,
// wc, ffr) or the synthesis (w = p, q, r, s_r) at a tensor-core tier, the
// operand matrix behind `tmap` (boxes of 128 bytes of K by BN rows). TF
// (with FOLD): the synthesis VJP, the cotangent g [rows, t_in = T+1, N] ->
// out [rows, T, N] through the transposed fold. TS (without FOLD, at
// `default`): the analysis VJP, g [rows, T+1, N] -> out [rows, T, N]
// through the transposed scatter (scatter_kernel's TS).
template <typename T, int TIER, bool FOLD, bool TF = false, bool TS = false>
__global__ void __launch_bounds__(TC_THREADS, 1) tc_kernel(
    const __grid_constant__ CUtensorMap tmap, const T* __restrict__ x,
    const T* __restrict__ w0, const T* __restrict__ w1,
    const T* __restrict__ w2, const T* __restrict__ w3, T* __restrict__ out,
    int t_in, int N, float mat_scale) {
  using Cfg = Tc<TIER, FOLD>;
  using Acc = typename std::conditional<TIER == BF16, float, int>::type;
  constexpr int BM = Cfg::BM, BNW = Cfg::BNW, STAGES = Cfg::STAGES;
  constexpr int NR = BNW / 2;  // accumulator registers a thread
  constexpr bool SPLIT_N = Cfg::SPLIT_N;
  static_assert(FOLD || !TF, "the transposed fold is an analysis mode");
  static_assert(!(FOLD || TIER == INT8) || !TS,
                "the transposed scatter is a synthesis mode at `default`");

  extern __shared__ uint8_t raw_smem[];
  const uint32_t raw = hopper::smem_addr(raw_smem);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = raw_smem + pad;
  const uint32_t sbase = raw + pad;
  const size_t a_bytes = Cfg::a_bytes(N);
  const uint32_t ring = sbase + (uint32_t)a_bytes;
  const uint32_t bars = ring + STAGES * Cfg::STAGE_BYTES;
  float* zs = reinterpret_cast<float*>(smem + (bars - sbase) +
                                       Cfg::BAR_BYTES);
  float* scales = zs + Cfg::ZS_FLOATS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int tile0 = blockIdx.x * Cfg::TILE;  // first output frame
  const int t_out = TF || TS ? t_in - 1 : t_in + 1;
  const int kt_n = N / Cfg::KT_ELEMS;  // K tiles
  const int kt_a = TC_KA / Cfg::KT_ELEMS;  // K tiles of a pass
  const int passes = (kt_n + kt_a - 1) / kt_a;
  const int chunks = N / Cfg::BN;
  // pass pi of a chunk: odd chunks take them backwards, except int8g
  auto pass_of = [&](int chunk, int pi) {
    return !Cfg::GROUPED && (chunk & 1) ? passes - 1 - pi : pi;
  };
  auto pass_end = [&](int p) {  // one past the pass's last K tile
    return (p + 1) * kt_a < kt_n ? (p + 1) * kt_a : kt_n;
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one thread streams B
    if (tid == 256) {
      hopper::prefetch_tmap(&tmap);
      int it = 0;
      for (int chunk = 0; chunk < chunks; ++chunk)
        for (int pi = 0; pi < passes; ++pi) {
          const int p = pass_of(chunk, pi);
          for (int kt = p * kt_a; kt < pass_end(p); ++kt, ++it) {
            const int s = it % STAGES, use = it / STAGES;
            if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);
            hopper::mbar_expect_tx(full(s), Cfg::STAGE_BYTES);
            hopper::tma_load_2d(ring + s * Cfg::STAGE_BYTES, &tmap, full(s),
                                kt * Cfg::KT_ELEMS, chunk * Cfg::BN);
          }
        }
    }
    return;
  }

  // consumers: build A, then the products
  const T* xr = x + (size_t)row * t_in * N;
  // A's rows: spectrum frames from tile0 - 1 (the synthesis: output frame
  // n reads z[n-1]), or from tile0 with TS (it reads zg[n+1])
  auto build = [&](int p, bool scan) {
    build_a<T, TIER, FOLD, TF>(smem, scales, xr, w0, w1, w2, w3,
                               TS ? tile0 + 1 : tile0, t_in, N, p * TC_KA,
                               scan, tid >> 5, tid & 31);
  };
  if (TIER == INT8 && FOLD && passes > 1) {  // the frames' scales first
    for (int p = 0; p < passes; ++p) build(p, true);
    hopper::named_sync(1, 256);
  }
  build(0, false);
  hopper::fence_proxy_async();
  hopper::named_sync(1, 256);
  int held = 0;  // the pass A holds
  // A takes pass p once both warpgroups' products (waited for) are done
  auto hold = [&](int p) {
    hopper::named_sync(1, 256);
    build(p, false);
    hopper::fence_proxy_async();
    hopper::named_sync(1, 256);
    held = p;
  };

  const int wg = tid >> 7, t = tid & 127;
  const int a_row0 = SPLIT_N ? 0 : 64 * wg;  // this warpgroup's A rows
  const uint32_t a_base = sbase + a_row0 * 128;
  const uint32_t b_off = SPLIT_N ? wg * BNW * 128 : 0;
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);  // + 8i: rows of the tile
  const int c0 = 2 * (t & 3);                      // + 8j + c: columns
  const int h = N >> 1;
  T* outr = out + (size_t)row * t_out * N;

  // K tile kt (of the pass A holds) of stage s into acc (scale_d = 0 on
  // the first step if fresh)
  auto mma_step = [&](Acc(&acc)[NR], int s, int kt, bool fresh) {
    const uint32_t a = a_base + (kt - held * kt_a) * BM * 128;
    const uint32_t b = ring + s * Cfg::STAGE_BYTES + b_off;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma(acc, hopper::sw128_desc(a + 32 * kk),
                    hopper::sw128_desc(b + 32 * kk), fresh && kk == 0 ? 0 : 1);
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
  };
  auto release = [&](int it) {
    if (t == 0) hopper::mbar_arrive(empty(it % STAGES));
  };

  int it = 0;  // stage loads consumed so far
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int col0 = chunk * Cfg::BN + (SPLIT_N ? wg * BNW : 0);
    float z[NR];  // the tile's result, before the epilogue's rounding
    if constexpr (Cfg::GROUPED) {
      // int8g: group g = K tile g; sum += float(acc_g) * s_g in group order
      int acc[NR];
      for (int p = 0; p < passes; ++p) {
        if (p != held) hold(p);  // the last group's products are done
        for (int g = p * kt_a; g < pass_end(p); ++g, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(full(s), (it / STAGES) & 1);
          mma_step(acc, s, g, true);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          release(it);
          const float s0 = scales[(a_row0 + r0) * (N / GROUP) + g];
          const float s1 = scales[(a_row0 + r0 + 8) * (N / GROUP) + g];
#pragma unroll
          for (int e = 0; e < NR; ++e) {
            const float term =
                __fmul_rn(__int2float_rn(acc[e]), e & 2 ? s1 : s0);
            z[e] = g == 0 ? term : __fadd_rn(z[e], term);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < NR; ++e) z[e] = __fmul_rn(z[e], mat_scale);
    } else {
      Acc acc[NR];
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[e] = 0;
      int j = 0;  // the chunk's K steps so far
      for (int pi = 0; pi < passes; ++pi) {
        const int p = pass_of(chunk, pi);
        if (p != held) {
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          hold(p);
        }
        for (int kt = p * kt_a; kt < pass_end(p); ++kt, ++it, ++j) {
          const int s = it % STAGES;
          hopper::mbar_wait(full(s), (it / STAGES) & 1);
          mma_step(acc, s, kt, j == 0);
          hopper::wgmma_wait<1>();  // the previous K tile's products are done
          hopper::fence_regs(acc);
          if (j > 0) release(it - 1);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(it - 1);
      if constexpr (TIER == INT8) {  // the analysis: one scale a frame
        const float s0 = __fmul_rn(scales[a_row0 + r0], mat_scale);
        const float s1 = __fmul_rn(scales[a_row0 + r0 + 8], mat_scale);
#pragma unroll
        for (int e = 0; e < NR; ++e)
          z[e] = __fmul_rn(__int2float_rn(acc[e]), e & 2 ? s1 : s0);
      } else {
#pragma unroll
        for (int e = 0; e < NR; ++e) z[e] = acc[e];
      }
    }

    if constexpr (FOLD) {
      // out[tile0 + row of the tile, col] = z, rounded to T. A lane holds
      // columns 2q, 2q+1 of each 8-column group (q = lane % 4): float32
      // pairs fill 32-byte sectors as they are; bf16 pairs go through a
      // 4 x 4 exchange in the quad that gives a lane all 8 columns of group
      // 4J + q, stored as one 16-byte vector (64 contiguous bytes a row).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = tile0 + a_row0 + r0 + 8 * i;
        const bool store = n < t_out;
        T* o = outr + (size_t)n * N + col0;
        if constexpr (sizeof(T) == 2) {
#pragma unroll
          for (int J = 0; J < NR / 16; ++J) {
            uint32_t pr[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              pr[jj] = pack_bf16(z[4 * (4 * J + jj) + 2 * i],
                                 z[4 * (4 * J + jj) + 2 * i + 1]);
            quad_transpose(pr, t & 3);
            if (store)
              *reinterpret_cast<uint4*>(o + 8 * (4 * J + (t & 3))) =
                  make_uint4(pr[0], pr[1], pr[2], pr[3]);
          }
        } else if (store) {
#pragma unroll
          for (int j = 0; j < NR / 4; ++j)
            *reinterpret_cast<float2*>(o + 8 * j + c0) =
                make_float2(z[4 * j + 2 * i], z[4 * j + 2 * i + 1]);
        }
      }
    } else if constexpr (TS) {
      // the transposed scatter of this warpgroup's pair block: zg rounded
      // to T as the plain version rounds it, staged as below, then for
      // output frame n = tile0 + m and pair u: zg[n, c] = zt[m][u] and
      // zg[n+1, N-1-c] = zt[m + 1][32 + u] (both frames exist, n < T) give
      // output columns c (q, s_r) and N-1-c (p, r). A thread takes 4
      // neighbouring pairs.
      float* zt = SPLIT_N ? zs + wg * 64 * BNW : zs;
      auto zat = [&](int r, int col) {
        return zt + r * BNW + (col ^ ((r & 7) << 3));
      };
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NR / 4; ++j)
          *reinterpret_cast<float2*>(zat(r0 + 8 * i, 8 * j + c0)) =
              make_float2(rnd<T>(z[4 * j + 2 * i]),
                          rnd<T>(z[4 * j + 2 * i + 1]));
      hopper::named_sync(2 + wg, 128);
      const int u0 = 4 * (t & 7);
      const int c0p = (col0 / PAIR_BLOCK) * (PAIR_BLOCK / 2) + u0;
      float pc[4], qc[4], rc[4], sc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pc[e] = to_f(w0[c0p + e]);
        qc[e] = to_f(w1[c0p + e]);
        rc[e] = to_f(w2[h - 1 - c0p - e]);
        sc[e] = to_f(w3[c0p + e]);
      }
      for (int m = t >> 3; m < 63; m += 16) {
        const int n = tile0 + m;
        if (n >= t_out) break;
        const float4 zc4 = *reinterpret_cast<const float4*>(zat(m, u0));
        const float4 zn4 = *reinterpret_cast<const float4*>(
            zat(m + 1, PAIR_BLOCK / 2 + u0));
        const float zc[4] = {zc4.x, zc4.y, zc4.z, zc4.w};
        const float zn[4] = {zn4.x, zn4.y, zn4.z, zn4.w};
        float lo[4], hi[4];  // columns N-1-c and c, c = c0p + e
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(zc[e], pc[e])),
                                   rnd<T>(__fmul_rn(zn[e], rc[e]))));
          hi[e] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(zc[e], qc[e])),
                                   rnd<T>(__fmul_rn(zn[e], sc[e]))));
        }
        T* o = outr + (size_t)n * N;
        store4<T>(o + c0p, hi[0], hi[1], hi[2], hi[3]);
        store4<T>(o + N - 4 - c0p, lo[3], lo[2], lo[1], lo[0]);
      }
      hopper::named_sync(2 + wg, 128);  // zt is free for the next chunk
    } else {
      // the overlap scatter of this warpgroup's pair block: z rounded as
      // the plain version rounds it (to T, or float32 at int8g) into the
      // staged tile zt [rows][BNW] (8-float groups of row r at group ^ r % 8,
      // so a quad's float2 stores of 8 rows meet no bank twice), then for
      // output frame n = tile0 + m and pair u: z[n, c] = zt[m + 1][u],
      // z[n-1, N-1-c] = zt[m][32 + u]. A thread takes 4 neighbouring pairs.
      using R = typename std::conditional<TIER == INT8, float, T>::type;
      float* zt = SPLIT_N ? zs + wg * 64 * BNW : zs;
      auto zat = [&](int r, int col) {
        return zt + r * BNW + (col ^ ((r & 7) << 3));
      };
      const int zrow0 = SPLIT_N ? 0 : a_row0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NR / 4; ++j)
          *reinterpret_cast<float2*>(zat(zrow0 + r0 + 8 * i, 8 * j + c0)) =
              make_float2(rnd<R>(z[4 * j + 2 * i]),
                          rnd<R>(z[4 * j + 2 * i + 1]));
      const int bar = SPLIT_N ? 2 + wg : 1;
      const int nthreads = SPLIT_N ? 128 : 256;
      const int me = SPLIT_N ? t : tid;
      const int zrows = SPLIT_N ? 64 : BM;
      hopper::named_sync(bar, nthreads);
      const int u0 = 4 * (me & 7);
      const int c0p = (col0 / PAIR_BLOCK) * (PAIR_BLOCK / 2) + u0;
      float pc[4], qc[4], rc[4], sc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pc[e] = to_f(w0[c0p + e]);
        qc[e] = to_f(w1[c0p + e]);
        rc[e] = to_f(w2[h - 1 - c0p - e]);
        sc[e] = to_f(w3[c0p + e]);
      }
      for (int m = me >> 3; m < zrows - 1; m += nthreads / 8) {
        const int n = tile0 + m;
        if (n >= t_out) break;
        const float4 zc4 = *reinterpret_cast<const float4*>(zat(m + 1, u0));
        const float4 zp4 = *reinterpret_cast<const float4*>(
            zat(m, PAIR_BLOCK / 2 + u0));
        const float zc[4] = {zc4.x, zc4.y, zc4.z, zc4.w};
        const float zp[4] = {zp4.x, zp4.y, zp4.z, zp4.w};
        const bool cur = n < t_in, prev = n >= 1;
        float lo[4], hi[4];  // columns h-1-c and h+c, c = c0p + e
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo_a = cur ? rnd<R>(__fmul_rn(zc[e], pc[e])) : 0.f;
          const float lo_b = prev ? rnd<R>(__fmul_rn(zp[e], rc[e])) : 0.f;
          lo[e] = rnd<R>(__fadd_rn(lo_a, lo_b));
          const float hi_a = cur ? rnd<R>(__fmul_rn(zc[e], qc[e])) : 0.f;
          const float hi_b = prev ? rnd<R>(__fmul_rn(zp[e], sc[e])) : 0.f;
          hi[e] = rnd<R>(__fadd_rn(hi_a, hi_b));
        }
        T* o = outr + (size_t)n * N;
        store4<T>(o + h + c0p, hi[0], hi[1], hi[2], hi[3]);
        store4<T>(o + h - 4 - c0p, lo[3], lo[2], lo[1], lo[0]);
      }
      hopper::named_sync(bar, nthreads);  // zt is free for the next chunk
    }
  }
}

// ---- The split tiers (`highest`, `high`) on Hopper, and the radix products
//
// A float32 operand is the sum of bf16 planes: a0 = bf16(a), a1 = bf16(a -
// a0), a2 = bf16(a - a0 - a1) (split3; each subtraction is exact in
// float32, so a0 + a1 + a2 == a for normal a). The product of two split
// values is a sum of plane products, each exact in float32, which bf16
// wgmma runs at the tensor cores' rate:
//   * `highest`: six passes, a1b1 + a0b2 + a2b0 + a0b1 + a1b0 + a0b0 (the
//     MXU's HIGHEST; what it drops is ~2^-24 of each product);
//   * `high`: HIGH_PASSES (below). Three passes, a0b1 + a1b0 + a0b0 on two
//     planes an operand, are the JAX kernel's recipe (pallas_mdct.py _mxu;
//     they drop ~2^-16), but miss the tier's tolerance here, so six run.
// The small terms come first: the tensor cores' float32 accumulation is not
// round-to-nearest, and its error follows the accumulator's magnitude,
// which is least before the large term joins. The radix design's `default`
// runs the same GEMM on one plane an operand (bf16 RNE, the tier's
// rounding): one pass, a0b0.
//
// A mono direction is two launches (three in the synthesis):
//   * split_kernel: A, the fold of x (analysis) or the rows of y
//     (synthesis), split into NP planes and written to device memory as
//     [NP, M_pad, N] bf16: M = rows x frames flattened, padded with zero
//     rows to a whole number of block tiles. The fold runs once a frame (the
//     FFMA tile this replaces ran it once per column tile), and at
//     [32,431,1024] the planes are 85 MB written and read once, ~0.05 ms of
//     the card's bandwidth against 0.175 ms of products.
//   * split_gemm_kernel: one [SPLIT_BM x SPLIT_BN] tile of out[M, N] = A @
//     B^T with both operands K-major bf16 planes; B is the matrix's
//     operand form [NP, N_out, K], built once on the host. A ring of stages
//     (a K tile of 64: NP planes of A and of B, 128-byte swizzled boxes)
//     comes in by TMA from one producer thread; two consumer warpgroups (64
//     rows each, all SPLIT_BN columns) run the pass chain on each stage into
//     a fresh accumulator, wait for it, release the stage and add it to a
//     float32 total with __fadd_rn. That is the blocked sum of the FFMA tile
//     it replaces (a single running float32 sum over K=1024 cost ~10 dB of
//     round trip there), one block per stage. Only the fresh accumulator is
//     ever a wgmma operand, and it is read after wgmma_wait<0>, so no read
//     meets a product in flight (ptxas would serialize those, C7514). The
//     column tiles of one row tile are neighbours in the grid, so the A
//     planes come from device memory about once and B (6 MB) stays in L2.
//   * the synthesis: the product goes to the z scratch [rows, T, N] and
//     scatter_kernel applies the overlap scatter.
//
// The radix products are the same GEMM on other addresses (gridDim.z = 2
// halves): A's row holds two K halves of K = N/2, half h reads A columns
// [h K, (h+1) K) and factor h of the operand [2, NP, K, K], and writes
// output columns [h K, (h+1) K) of a row N wide. Their A planes come from
// fold_rotate_kernel / butterfly_in_kernel (above), which split the rotated
// or butterflied values as they write them: no split_kernel pass.
//
// Shared memory: NP x (SPLIT_BM + SPLIT_BN) x 128 bytes a stage (96 KB
// with six passes, 64 KB with three, 32 KB with one), two to six stages;
// one block an SM.

constexpr int SPLIT_BM = 128;  // A rows (frames) of a block: 2 warpgroups
constexpr int SPLIT_BN = 128;  // output columns of a block
constexpr int SPLIT_KT = 64;   // K of a stage: one 128-byte row of bf16

template <int PASSES>
struct Split {
  static_assert(PASSES == 6 || PASSES == 3 || PASSES == 1,
                "six, three or one pass");
  static constexpr int NP = PASSES == 6 ? 3 : PASSES == 3 ? 2 : 1;
  static constexpr int A_BYTES = SPLIT_BM * 128;  // one plane of a stage
  static constexpr int B_BYTES = SPLIT_BN * 128;
  static constexpr int STAGE_BYTES = NP * (A_BYTES + B_BYTES);
  static constexpr int STAGES = 200 * 1024 / STAGE_BYTES;
  static constexpr int BAR_BYTES = 128;  // full and empty barriers
  static_assert(STAGES >= 2 && 2 * STAGES * 8 <= BAR_BYTES, "stages");
  static constexpr size_t smem_bytes() {  // +1024: aligned by hand
    return 1024 + (size_t)STAGES * STAGE_BYTES + BAR_BYTES;
  }
};

// The passes of `highest`, small terms first; `high` runs the last three.
// Pass i multiplies A plane pass_plane(i, false) by B plane
// pass_plane(i, true): (1,1) (0,2) (2,0) (0,1) (1,0) (0,0).
__host__ __device__ constexpr int pass_plane(int i, bool b) {
  return b ? (i == 0 ? 1 : i == 1 ? 2 : i == 3 ? 1 : 0)
           : (i == 0 ? 1 : i == 2 ? 2 : i == 4 ? 1 : 0);
}

// The A planes: row m of [rows x frames] (frames = T+1 with FOLD, else T)
// is the fold of frame m % frames of row m / frames (w = wa_r, wb, wc, ffr)
// or that row of y, split into NP planes at planes + p * m_pad * N; rows
// from rows x frames to m_pad are zeros. TF: the transposed fold of the
// cotangent g [rows, t_in = T+1, N], T frames a row. One block a row, 4
// values a thread.
template <bool FOLD, int NP, bool TF = false>
__global__ void __launch_bounds__(THREADS) split_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ w3, bf16* __restrict__ planes, int rows,
    int t_in, int N, int m_pad) {
  const int m = blockIdx.x;
  const int frames = FOLD ? fold_frames(TF, t_in) : t_in;
  const bool valid = m < rows * frames;
  const int row = valid ? m / frames : 0;
  const int n = m - row * frames;
  const float* xr = x + (size_t)row * t_in * N;
  for (int k = 4 * threadIdx.x; k < N; k += 4 * THREADS) {
    bf16 s[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(valid ? a_value<float, FOLD, TF>(xr, w0, w1, w2, w3, n, k + e,
                                              t_in, N)
                   : 0.f,
             s[e]);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint2*>(planes + ((size_t)p * m_pad + m) * N + k) =
          make_uint2(pack2(s[0][p], s[1][p]), pack2(s[2][p], s[3][p]));
  }
}

// The PASSES-pass product of the A planes behind `amap` ([NP x m_pad, H x
// K] bf16) and the B planes behind `bmap` ([H x NP x K, K] bf16, K
// contiguous) in H = gridDim.z halves: out [M, H x K] (float32, row-major)
// columns [h K, (h+1) K) = A columns [h K, (h+1) K) @ factor h. The mono
// design is H = 1 (K = N), the radix one H = 2 (K = N/2). Boxes of 64 K by
// 128 rows.
template <int PASSES>
__global__ void __launch_bounds__(TC_THREADS, 1) split_gemm_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap bmap, float* __restrict__ out, int M,
    int m_pad, int K) {
  using S = Split<PASSES>;
  constexpr int NP = S::NP, STAGES = S::STAGES;
  extern __shared__ uint8_t raw_smem[];
  const uint32_t raw = hopper::smem_addr(raw_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * S::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto a_tile = [&](int s, int p) {
    return ring + s * S::STAGE_BYTES + p * S::A_BYTES;
  };
  auto b_tile = [&](int s, int p) {
    return ring + s * S::STAGE_BYTES + NP * S::A_BYTES + p * S::B_BYTES;
  };

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * SPLIT_BN, m0 = blockIdx.y * SPLIT_BM;
  const int half = blockIdx.z;
  const int kts = K / SPLIT_KT;  // K tiles
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one thread streams A and B
    if (tid == 256) {
      hopper::prefetch_tmap(&amap);
      hopper::prefetch_tmap(&bmap);
      for (int kt = 0; kt < kts; ++kt) {
        const int s = kt % STAGES, use = kt / STAGES;
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);
        hopper::mbar_expect_tx(full(s), S::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_2d(a_tile(s, p), &amap, full(s),
                              half * K + kt * SPLIT_KT, p * m_pad + m0);
          hopper::tma_load_2d(b_tile(s, p), &bmap, full(s), kt * SPLIT_KT,
                              (half * NP + p) * K + n0);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, t = tid & 127;
  float acc[64], total[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) total[e] = 0.f;
  for (int kt = 0; kt < kts; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(full(s), (kt / STAGES) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 6 - PASSES; i < 6; ++i) {
      const uint32_t a = a_tile(s, pass_plane(i, false)) + wg * 64 * 128;
      const uint32_t b = b_tile(s, pass_plane(i, true));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma(acc, hopper::sw128_desc(a + 32 * kk),
                      hopper::sw128_desc(b + 32 * kk),
                      i == 6 - PASSES && kk == 0 ? 0 : 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (t == 0) hopper::mbar_arrive(empty(s));
#pragma unroll
    for (int e = 0; e < 64; ++e) total[e] = __fadd_rn(total[e], acc[e]);
  }

  // thread t holds rows r0 + 8i and columns 8j + c0 + c of its warpgroup's
  // 64 x 128 tile in total[4j + 2i + c]
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);
  const int c0 = 2 * (t & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 64 * wg + r0 + 8 * i;
    if (m >= M) continue;
    float* o = out + (size_t)m * gridDim.z * K + half * K + n0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(o + 8 * j + c0) =
          make_float2(total[4 * j + 2 * i], total[4 * j + 2 * i + 1]);
  }
}

// Launch tc_kernel on the operand matrix `op` ([N, N], K contiguous).
template <typename T, int TIER, bool FOLD, bool TF = false, bool TS = false>
int launch_tc(const void* x, const void* w0, const void* w1, const void* w2,
              const void* w3, const void* op, void* out, int rows, int t_in,
              int N, float mat_scale, cudaStream_t st) {
  using Cfg = Tc<TIER, FOLD>;
  CUtensorMap map;
  int rc = hopper::operand_map(&map, op, TIER == BF16, N, N, Cfg::BN);
  if (rc) return rc;
  auto kernel = tc_kernel<T, TIER, FOLD, TF, TS>;
  static std::atomic<uint64_t> shared_set{0};
  rc = hopper::allow_shared(kernel, shared_set);
  if (rc) return rc;
  const size_t smem = Cfg::smem_bytes(N);
  const int t_out = TF || TS ? t_in - 1 : t_in + 1;  // as tc_kernel's
  const dim3 grid((t_out + Cfg::TILE - 1) / Cfg::TILE, rows);
  kernel<<<grid, TC_THREADS, smem, st>>>(
      map, static_cast<const T*>(x), static_cast<const T*>(w0),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w3), static_cast<T*>(out), t_in, N, mat_scale);
  return 0;
}

// M rows of A rounded up to whole split_gemm_kernel row tiles.
int split_rows(int M) { return (M + SPLIT_BM - 1) / SPLIT_BM * SPLIT_BM; }

// split_gemm_kernel on the A planes `planes` ([NP, m_pad, halves x K] bf16)
// and the operand `op` ([halves, NP, K, K] bf16) into out [M, halves x K].
template <int PASSES>
int split_gemm(void* planes, const void* op, float* out, int M, int m_pad,
               int K, int halves, cudaStream_t st) {
  using S = Split<PASSES>;
  CUtensorMap amap, bmap;
  int rc = hopper::encode_map(&amap, planes, true, (uint64_t)halves * K,
                      (uint64_t)S::NP * m_pad, SPLIT_BM);
  if (!rc)
    rc = hopper::operand_map(&bmap, op, true, K, (uint64_t)halves * S::NP * K,
                     SPLIT_BN);
  if (rc) return rc;
  auto kernel = split_gemm_kernel<PASSES>;
  static std::atomic<uint64_t> shared_set{0};
  rc = hopper::allow_shared(kernel, shared_set);
  if (rc) return rc;
  kernel<<<dim3(K / SPLIT_BN, m_pad / SPLIT_BM, halves), TC_THREADS,
           S::smem_bytes(), st>>>(amap, bmap, out, M, m_pad, K);
  return 0;
}

// The split tiers' product of A (the fold of x with FOLD, w = wa_r, wb,
// wc, ffr, or with TF the transposed fold of the cotangent; else the rows
// of x) and the operand planes `op` ([NP, N, N] bf16) into out [rows x
// frames, N] float, through the A planes' scratch `planes` ([NP, m_pad, N]
// bf16, m_pad = rows x frames rounded up to SPLIT_BM).
template <int PASSES, bool FOLD, bool TF = false>
int launch_split(const float* x, const float* w0, const float* w1,
                 const float* w2, const float* w3, const void* op,
                 void* planes, float* out, int rows, int t_in, int N,
                 cudaStream_t st) {
  const int M = rows * (FOLD ? fold_frames(TF, t_in) : t_in);
  const int m_pad = split_rows(M);
  split_kernel<FOLD, Split<PASSES>::NP, TF><<<m_pad, THREADS, 0, st>>>(
      x, w0, w1, w2, w3, static_cast<bf16*>(planes), rows, t_in, N, m_pad);
  return split_gemm<PASSES>(planes, op, out, M, m_pad, N, 1, st);
}

// `high`'s passes. Three (the JAX kernel's recipe) meet the card tests'
// 1e-6 (forward) and 1e-4 (inverse) against the float32 plain versions,
// but not 1e-5 of the peak on the synthesis at the main path's shapes
// ([32,430,1024]: 1.1e-5 against 7.2e-6 on an H100), so `high` runs
// `highest`'s six. ops/cuda_mdct.py SPLIT_PLANES follows this constant.
constexpr int HIGH_PASSES = 6;

// The analysis at `tier`, or with TF the synthesis VJP's transposed fold
// and product (no int8 instance: the int8 tier's backward runs `default`).
template <typename T, bool TF = false>
int launch_fold_matmul(const void* x, const void* wa_r, const void* wb,
                       const void* wc, const void* ffr, const void* op,
                       void* planes, void* out, int rows, int t_in, int N,
                       int tier, float mat_scale, cudaStream_t st) {
  if (tier == BF16)
    return launch_tc<T, BF16, true, TF>(x, wa_r, wb, wc, ffr, op, out, rows,
                                        t_in, N, mat_scale, st);
  if constexpr (!TF) {
    if (tier == INT8)
      return launch_tc<T, INT8, true>(x, wa_r, wb, wc, ffr, op, out, rows,
                                      t_in, N, mat_scale, st);
  }
  if constexpr (std::is_same<T, float>::value) {  // the split tiers
    const float* w[4] = {static_cast<const float*>(wa_r),
                         static_cast<const float*>(wb),
                         static_cast<const float*>(wc),
                         static_cast<const float*>(ffr)};
    const float* xf = static_cast<const float*>(x);
    float* o = static_cast<float*>(out);
    if (tier == HIGHEST)
      return launch_split<6, true, TF>(xf, w[0], w[1], w[2], w[3], op,
                                       planes, o, rows, t_in, N, st);
    if (tier == HIGH)
      return launch_split<HIGH_PASSES, true, TF>(xf, w[0], w[1], w[2], w[3],
                                                 op, planes, o, rows, t_in,
                                                 N, st);
  }
  return (int)cudaErrorInvalidValue;  // bf16 input at a split tier
}

// The split tiers run the product into the scratch z [rows, T, N] and the
// overlap scatter after it; the one-pass tiers are one kernel. TS: the
// analysis VJP's product of the cotangent and transposed scatter (no int8
// instance: the int8 tier's backward runs `default`).
template <typename T, bool TS = false>
int launch_matmul_scatter(const void* y, const void* p, const void* q,
                          const void* r, const void* s_r, const void* op,
                          void* planes, void* z, void* out, int rows,
                          int t_in, int N, int tier, float mat_scale,
                          cudaStream_t st) {
  if (tier == BF16)
    return launch_tc<T, BF16, false, false, TS>(y, p, q, r, s_r, op, out,
                                                rows, t_in, N, mat_scale, st);
  if constexpr (!TS) {
    if (tier == INT8)
      return launch_tc<T, INT8, false>(y, p, q, r, s_r, op, out, rows, t_in,
                                       N, mat_scale, st);
  }
  if constexpr (std::is_same<T, float>::value) {  // the split tiers
    const float* yf = static_cast<const float*>(y);
    float* zf = static_cast<float*>(z);
    const int rc =
        tier == HIGHEST
            ? launch_split<6, false>(yf, nullptr, nullptr, nullptr, nullptr,
                                     op, planes, zf, rows, t_in, N, st)
            : launch_split<HIGH_PASSES, false>(yf, nullptr, nullptr, nullptr,
                                               nullptr, op, planes, zf, rows,
                                               t_in, N, st);
    if (rc) return rc;
    scatter_kernel<float, float, false, TS>
        <<<dim3(TS ? t_in - 1 : t_in + 1, rows), THREADS, 0, st>>>(
            zf, static_cast<const float*>(p), static_cast<const float*>(q),
            static_cast<const float*>(r), static_cast<const float*>(s_r),
            nullptr, static_cast<float*>(out), t_in, N);
    return 0;
  }
  return (int)cudaErrorInvalidValue;  // bf16 input at a split tier
}

// A radix direction at a tier of PASSES passes (1 at `default`): the pass
// that writes A's planes (fold_rotate_kernel with FOLD, else
// butterfly_in_kernel), the two [N/2, N/2] products on split_gemm_kernel
// (op [2, NP, N/2, N/2]) into the float scratch `prod`, then the pass that
// reads them (butterfly_out_kernel, or scatter_kernel<.., RADIX>). TF (with
// FOLD): the synthesis VJP, the transposed fold of the cotangent [rows,
// t_in, N] into out [rows, t_in - 1, N]. TS (without FOLD): the analysis
// VJP, the cotangent's products and their transposed scatter, likewise.
template <typename T, int PASSES, bool FOLD, bool TF = false, bool TS = false>
int radix(const void* x, const void* const (&w)[4], const void* rot,
          const void* op, void* planes, void* prod, void* out, int rows,
          int t_in, int N, cudaStream_t st) {
  constexpr int NP = Split<PASSES>::NP;
  const T* in = static_cast<const T*>(x);
  const T* w0 = static_cast<const T*>(w[0]);
  const T* w1 = static_cast<const T*>(w[1]);
  const T* w2 = static_cast<const T*>(w[2]);
  const T* w3 = static_cast<const T*>(w[3]);
  const T* rt = static_cast<const T*>(rot);
  bf16* a = static_cast<bf16*>(planes);
  float* pr = static_cast<float*>(prod);
  T* o = static_cast<T*>(out);
  const int frames = FOLD ? fold_frames(TF, t_in) : t_in;  // A's a row
  const int M = rows * frames, m_pad = split_rows(M);
  if constexpr (FOLD)
    fold_rotate_kernel<T, NP, TF><<<m_pad, THREADS, 0, st>>>(
        in, w0, w1, w2, w3, rt, a, rows, t_in, N, m_pad);
  else
    butterfly_in_kernel<T, NP><<<m_pad, THREADS, 0, st>>>(in, a, M, N, m_pad);
  const int rc = split_gemm<PASSES>(planes, op, pr, M, m_pad, N / 2, 2, st);
  if (rc) return rc;
  if constexpr (FOLD)
    butterfly_out_kernel<T><<<dim3(frames, rows), THREADS, 0, st>>>(pr, o, N);
  else
    scatter_kernel<float, T, true, TS>
        <<<dim3(TS ? t_in - 1 : t_in + 1, rows), THREADS, 0, st>>>(
            pr, w0, w1, w2, w3, rt, o, t_in, N);
  return 0;
}

// radix at `tier`: `default` on one plane, the split tiers (float32 input
// only) on their passes.
template <typename T, bool FOLD, bool TF = false, bool TS = false>
int launch_radix(const void* x, const void* const (&w)[4], const void* rot,
                 const void* op, void* planes, void* prod, void* out,
                 int rows, int t_in, int N, int tier, cudaStream_t st) {
  if (tier == BF16)
    return radix<T, 1, FOLD, TF, TS>(x, w, rot, op, planes, prod, out, rows,
                                     t_in, N, st);
  if constexpr (std::is_same<T, float>::value) {
    if (tier == HIGHEST)
      return radix<T, 6, FOLD, TF, TS>(x, w, rot, op, planes, prod, out,
                                       rows, t_in, N, st);
    if (tier == HIGH)
      return radix<T, HIGH_PASSES, FOLD, TF, TS>(x, w, rot, op, planes, prod,
                                                 out, rows, t_in, N, st);
  }
  return (int)cudaErrorInvalidValue;  // int8, or bf16 input at a split tier
}

bool shape_ok(int rows, int t_in, int N, int dtype, int tier) {
  return rows > 0 && t_in > 0 && N > 0 && N % 256 == 0 &&
         (dtype == F32 || dtype == BF16_IN) && tier >= HIGHEST &&
         tier <= HIGH;
}

}  // namespace

extern "C" {

// x [rows, T, N] -> out [rows, T+1, N]. op: the matrix's operand form
// ([N_out, K]: bf16 at `default`, int8 codes at int8; [NP, N_out, K] bf16
// planes at the split tiers); planes: the split tiers' A scratch ([NP,
// m_pad, N] bf16, m_pad = rows x (T+1) rounded up to 128; unused at the
// one-pass tiers). The split tiers take float32 only.
int acx_fold_matmul(const void* x, const void* wa_r, const void* wb,
                    const void* wc, const void* ffr, const void* op,
                    void* planes, void* out, int rows, int t_in, int N,
                    int dtype, int tier, float mat_scale, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == F32
          ? launch_fold_matmul<float>(x, wa_r, wb, wc, ffr, op, planes, out,
                                      rows, t_in, N, tier, mat_scale, st)
          : launch_fold_matmul<bf16>(x, wa_r, wb, wc, ffr, op, planes, out,
                                     rows, t_in, N, tier, mat_scale, st);
  return rc ? rc : (int)cudaGetLastError();
}

// The synthesis VJP in one call: the analysis route in its transposed-fold
// mode, the cotangent g [rows, t_in = T+1, N] (t_in >= 2), read in place,
// -> out [rows, T, N]. w: the unfold VJP weights (ops/cuda_mdct.py
// unfold_vjp_weights); op: the VJP matrix's analysis operand form; planes
// as for acx_fold_matmul, m_pad from rows x T. Tiers `default`, `highest`
// and `high`: the int8 tier's backward is `default` on the dequantized
// matrix, so there is no int8 instance.
int acx_fold_matmul_t(const void* g, const void* wa_r, const void* wb,
                      const void* wc, const void* ffr, const void* op,
                      void* planes, void* out, int rows, int t_in, int N,
                      int dtype, int tier, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier) || t_in < 2 || tier == INT8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == F32
          ? launch_fold_matmul<float, true>(g, wa_r, wb, wc, ffr, op, planes,
                                            out, rows, t_in, N, tier, 1.f, st)
          : launch_fold_matmul<bf16, true>(g, wa_r, wb, wc, ffr, op, planes,
                                           out, rows, t_in, N, tier, 1.f, st);
  return rc ? rc : (int)cudaGetLastError();
}

// y [rows, T, N] -> out [rows, T+1, N]. op as for acx_fold_matmul, the
// one-pass tiers' output columns in pair order; planes likewise (m_pad from
// rows x T); z: the split tiers' float32 scratch [rows, T, N] (unused at
// the one-pass tiers).
int acx_matmul_scatter(const void* y, const void* p, const void* q,
                       const void* r, const void* s_r, const void* op,
                       void* planes, void* z, void* out, int rows, int t_in,
                       int N, int dtype, int tier, float mat_scale,
                       void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == F32
          ? launch_matmul_scatter<float>(y, p, q, r, s_r, op, planes, z, out,
                                         rows, t_in, N, tier, mat_scale, st)
          : launch_matmul_scatter<bf16>(y, p, q, r, s_r, op, planes, z, out,
                                        rows, t_in, N, tier, mat_scale, st);
  return rc ? rc : (int)cudaGetLastError();
}

// The analysis VJP in one call: the synthesis route in its
// transposed-scatter mode, the cotangent g [rows, t_in = T+1, N] (t_in >=
// 2), read in place, -> out [rows, T, N]. w: the fold VJP weights
// (ops/cuda_mdct.py fold_vjp_weights); op: the VJP matrix's synthesis
// operand form (pair order at `default`); planes and z as for
// acx_matmul_scatter, from rows x (T+1). Tiers `default`, `highest` and
// `high` (no int8 instance, as acx_fold_matmul_t).
int acx_matmul_scatter_t(const void* g, const void* p, const void* q,
                         const void* r, const void* s_r, const void* op,
                         void* planes, void* z, void* out, int rows,
                         int t_in, int N, int dtype, int tier, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier) || t_in < 2 || tier == INT8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == F32
          ? launch_matmul_scatter<float, true>(g, p, q, r, s_r, op, planes, z,
                                               out, rows, t_in, N, tier, 1.f,
                                               st)
          : launch_matmul_scatter<bf16, true>(g, p, q, r, s_r, op, planes, z,
                                              out, rows, t_in, N, tier, 1.f,
                                              st);
  return rc ? rc : (int)cudaGetLastError();
}

// The dynamic shared memory a block of the mono design's tensor-core
// kernel takes at N, in bytes: tc_kernel's (tier BF16 or INT8; fold 1 for
// the analysis) or split_gemm_kernel's (HIGHEST or HIGH, either direction).
int acx_tc_shared_bytes(int tier, int fold, int N) {
  if (tier == BF16)
    return (int)(fold ? Tc<BF16, true>::smem_bytes(N)
                      : Tc<BF16, false>::smem_bytes(N));
  if (tier == INT8)
    return (int)(fold ? Tc<INT8, true>::smem_bytes(N)
                      : Tc<INT8, false>::smem_bytes(N));
  if (tier == HIGHEST) return (int)Split<6>::smem_bytes();
  if (tier == HIGH) return (int)Split<HIGH_PASSES>::smem_bytes();
  return -1;
}

// Radix analysis: x [rows, T, N] -> out [rows, T+1, N] in standard order.
// rot [2, N] in x's dtype; op: the two factors' operand form [2, NP, N/2,
// N/2] bf16 (NP = 3 at `highest`/`high`, 1 at `default`); the scratches
// planes [NP, m_pad, N] bf16 (m_pad = rows x (T+1) rounded up to 128) and
// uv [rows, T+1, N] float. No int8 tier; the split tiers take float32 only.
int acx_radix_fold_matmul(const void* x, const void* wa_r, const void* wb,
                          const void* wc, const void* ffr, const void* rot,
                          const void* op, void* planes, void* uv, void* out,
                          int rows, int t_in, int N, int dtype, int tier,
                          void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const w[4] = {wa_r, wb, wc, ffr};
  const int rc =
      dtype == F32
          ? launch_radix<float, true>(x, w, rot, op, planes, uv, out,
                                           rows, t_in, N, tier, st)
          : launch_radix<bf16, true>(x, w, rot, op, planes, uv, out,
                                          rows, t_in, N, tier, st);
  return rc ? rc : (int)cudaGetLastError();
}

// The radix synthesis VJP in one call: the radix analysis route in its
// transposed-fold mode, the cotangent g [rows, t_in = T+1, N] (t_in >= 2)
// -> out [rows, T, N]. rot and op: the VJP's rotation and factors
// (ops/cuda_mdct.py radix_unfold_vjp_residents); the scratches planes
// (m_pad from rows x T) and uv [rows, T, N] float.
int acx_radix_fold_matmul_t(const void* g, const void* wa_r, const void* wb,
                            const void* wc, const void* ffr, const void* rot,
                            const void* op, void* planes, void* uv,
                            void* out, int rows, int t_in, int N, int dtype,
                            int tier, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier) || t_in < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const w[4] = {wa_r, wb, wc, ffr};
  const int rc =
      dtype == F32
          ? launch_radix<float, true, true>(g, w, rot, op, planes, uv, out,
                                            rows, t_in, N, tier, st)
          : launch_radix<bf16, true, true>(g, w, rot, op, planes, uv, out,
                                           rows, t_in, N, tier, st);
  return rc ? rc : (int)cudaGetLastError();
}

// Radix synthesis: y [rows, T, N] (standard order) -> out [rows, T+1, N].
// rot and op as for acx_radix_fold_matmul; the scratches planes (m_pad
// from rows x T) and rsts [rows, T, N] float.
int acx_radix_matmul_scatter(const void* y, const void* p, const void* q,
                             const void* r, const void* s_r, const void* rot,
                             const void* op, void* planes, void* rsts,
                             void* out, int rows, int t_in, int N, int dtype,
                             int tier, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const w[4] = {p, q, r, s_r};
  const int rc =
      dtype == F32
          ? launch_radix<float, false>(y, w, rot, op, planes, rsts, out,
                                             rows, t_in, N, tier, st)
          : launch_radix<bf16, false>(y, w, rot, op, planes, rsts, out,
                                            rows, t_in, N, tier, st);
  return rc ? rc : (int)cudaGetLastError();
}

// The radix analysis VJP in one call: the radix synthesis route in its
// transposed-scatter mode, the cotangent g [rows, t_in = T+1, N] (t_in >=
// 2) -> out [rows, T, N]. rot and op: the VJP's rotation and factors
// (ops/cuda_mdct.py radix_fold_vjp_residents); the scratches planes (m_pad
// from rows x (T+1)) and rsts [rows, T+1, N] float.
int acx_radix_matmul_scatter_t(const void* g, const void* p, const void* q,
                               const void* r, const void* s_r,
                               const void* rot, const void* op, void* planes,
                               void* rsts, void* out, int rows, int t_in,
                               int N, int dtype, int tier, void* stream) {
  if (!shape_ok(rows, t_in, N, dtype, tier) || t_in < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const w[4] = {p, q, r, s_r};
  const int rc =
      dtype == F32
          ? launch_radix<float, false, false, true>(g, w, rot, op, planes,
                                                    rsts, out, rows, t_in, N,
                                                    tier, st)
          : launch_radix<bf16, false, false, true>(g, w, rot, op, planes,
                                                   rsts, out, rows, t_in, N,
                                                   tier, st);
  return rc ? rc : (int)cudaGetLastError();
}

}  // extern "C"
