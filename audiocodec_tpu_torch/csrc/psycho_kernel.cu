// Hand-written Hopper (sm_90a) kernel of the psychoacoustic model and the
// quantizer between the two transforms of the deterministic encode.
//
// It replaces no TPU kernel. The JAX package leaves this chain to XLA, which
// fuses it on a TPU; PyTorch runs it op by op, some 60 kernels a call, each
// one pass over the spectrum. Here one launch does the whole of
// Codec._analyze's psychoacoustic half -> quantize.quantize (->
// quantize.dequantize) for every (batch, frame, channel) row of N bins:
//
//   1. tonality: the spectral flatness of the row, from the block sums of
//      log(max(eps, a^2)) and of a^2 (psycho.tonality);
//   2. the Bark intensities sum_i W[i, j] a_i^2, over each band's nonzero
//      bin range only (the ranges and their values are made once from W by
//      ops/cuda_psycho.py: adding W's exact zeros changes no sum);
//   3. pow(max(eps, .), alpha), the [K, K] spreading product, the
//      tonality-dependent offset factor (with drown), pow(max(eps, .),
//      1 / alpha) and the maximum with the threshold in quiet;
//   4. sum_j B_j W_inv[j, i] over each bin's nonzero band range, then
//      sqrt(max(eps, .)), and in calibrated mode the maximum with the
//      fine-grid quiet floor: the masking threshold;
//   5. delta = max(threshold * rn(1/sqrt 3), 1e-12), code = rint(a / delta).
//
// Two epilogues (template flag ENCODE): the round trip writes code * delta,
// the dequantized spectrum (Codec.round_trip_quantized); the encode writes
// the int32 codes, delta and the threshold (Codec.encode_quantized), from
// the same arithmetic, so that decoding an encode's codes and steps equals
// the round trip bit for bit.
//
// Numerics. The arithmetic is the stagewise path's on the card, step for
// step: logf, expf, powf and sqrtf of the CUDA math library (no fast math:
// the functions torch's elementwise kernels call), IEEE divisions, each
// elementwise product and sum rounded on its own (__fmul_rn, __fadd_rn: no
// FMA contraction where torch runs two kernels), and the float32 constants
// the stagewise path uses, which the wrapper passes in (a division by a host
// scalar is a product with its rounded reciprocal there: 1/-60, 1/10). Only
// the order of the sums differs from torch's reductions and cuBLAS's
// products, so a threshold differs by a few ulps and a code can flip at a
// rounding tie only.
//
// What bounds it on an H100: at the main path's shape (32 x 431 rows of
// 1024 bins, 64 bands) it reads the spectrum once and writes the result
// once, 8 bytes a bin (16 with the encode's three outputs), 113 MB in all,
// 0.034 ms of the card's 3.35 TB/s. Its instructions bind it more: a row
// takes a logf, an IEEE division and a square root a bin, three powf a
// band (some 130 instructions each) and ~2N + K*K FMAs, about 0.06 ms of
// the card's instruction rate. It runs in 0.12-0.13 ms (H100 80GB HBM3,
// 700 W), at about half that rate: the band steps are short chains between
// barriers. The design keeps every intermediate on chip:
//   * a block of 256 threads works R rows at a time (8 at N = 1024; 4, or
//     for rows of more than ~2,300 bins 1, where 8 rows would leave fewer
//     than three blocks a multiprocessor),
//     the row groups of the grid in turn (as many blocks as fit on the card
//     at once, found once a device and size); while it works one group, the
//     next one's amplitudes come into shared memory by 16-byte asynchronous
//     copies (cp.async), so the load's latency hides under the work; every
//     later step reads the rows from shared memory;
//   * a thread takes a band, a spreading column or a bin for the R rows of
//     a group at once: each table value is loaded once and used R times
//     from a register, and the barriers are shared by R rows. (At one row a
//     block, each row read its 33 KB of tables again, through an L1 that
//     the blocks' shared memory leaves small: 0.20 ms. 2, 4 and 8 rows a
//     group took 0.162, 0.144 and 0.133 ms.)
//   * sums in a fixed order (warp butterflies, then a row's warps' sums in
//     warp order), so the result does not depend on timing and both
//     epilogues agree; each bin's band range padded with zeros to the
//     widest one (2 bands at 1024/64), so its loads do not wait on one
//     another;
//   * the constant tables (W's and W_inv's band-sparse values, the
//     spreading matrix) are read through the read-only cache, where every
//     block finds them;
//   * every output bin written once, neighbouring threads on neighbouring
//     addresses.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The model's constant operands, on the device.
struct Tables {
  const int* band_lo;     // [K]: first bin of band j
  const int* band_off;    // [K + 1]: band j's values are band_w[off[j]:off[j+1]]
  const float* band_w;    // W[band_lo[j] + t, j]
  const int* bin_lo;      // [N]: first band of bin i
  const float* bin_w;     // [N, bin_bands]: W_inv[bin_lo[i] + t, i], then 0s
  const float* spreading; // [K, K], row-major
  const float* grid;      // [K]: the Bark grid
  const float* quiet;     // [K]: threshold in quiet, intensities
  const float* quiet_freq;  // [N]: calibrated mode's quiet floor, or null
};

// The float32 constants of the stagewise path.
struct Scalars {
  float eps, alpha, inv_alpha, neg_alpha, ln10;
  float mean_factor;  // torch's mean: the sum times this
  float keep;         // 1 - drown
  float inv_neg60;    // rn(1 / -60)
  float inv_ten;      // rn(1 / 10)
  float rsqrt3;       // rn(1 / sqrt 3)
  float step_floor;   // rn(1e-12)
};

// The rows' layout: row r = (b * F + f) * C + c starts at element
// b * sb + f * sf + c * sc; its bins are contiguous, and every row starts
// 16 bytes aligned (the wrapper refuses other layouts).
struct Layout {
  long long frames, channels, sb, sf, sc;
};

// The shapes of the work: n bins and k bands a row; band_threads (a power
// of 2 up to 32) threads a band; bin_bands, the widest band range of a
// bin; the spreading product in `parts` partial sums of `chunk` bands.
struct Shape {
  int n, k, band_threads, bin_bands, parts, chunk;
};

__device__ __forceinline__ long long row_offset(const Layout& ly,
                                                long long r) {
  const long long c = r % ly.channels, rest = r / ly.channels;
  return (rest / ly.frames) * ly.sb + (rest % ly.frames) * ly.sf + c * ly.sc;
}

// Group g's R rows into `dst` (rows n apart; a row past the last is
// zeros), queued as asynchronous 16-byte copies.
template <int R>
__device__ __forceinline__ void fetch(const float* __restrict__ x,
                                      const Layout& ly, long long g,
                                      long long rows, int n, float* dst) {
  const int v4 = n / 4;
  for (int v = threadIdx.x; v < R * v4; v += THREADS) {
    const int p = v / v4, c = v % v4;
    const long long r = g * R + p;
    float* d = dst + p * n + 4 * c;
    if (r < rows)
      __pipeline_memcpy_async(d, x + row_offset(ly, r) + 4 * c, 16);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __pipeline_commit();
}

template <bool ENCODE, int R>
__global__ void __launch_bounds__(THREADS) psycho_quantize_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    int* __restrict__ codes, float* __restrict__ delta_out,
    float* __restrict__ thr_out, Tables tb, Scalars sc, Layout ly,
    long long rows, Shape sh) {
  constexpr int TPR = THREADS / R;  // threads a row in steps 1 and 5
  constexpr int WPR = TPR / 32;     // warps a row
  extern __shared__ float4 smem4[];
  const int n = sh.n, k = sh.k, kb = k + sh.bin_bands;
  float* buf[2] = {reinterpret_cast<float*>(smem4),
                   reinterpret_cast<float*>(smem4) + R * n};
  long long* soff = reinterpret_cast<long long*>(buf[1] + R * n);  // [R]
  float* red = reinterpret_cast<float*>(soff + R);  // [2 * WARPS]
  float* ston = red + 2 * WARPS;   // [R]: the rows' tonality
  float* sband = ston + R;         // [R, kb]: I^alpha, then the Bark
                                   // intensities, then bin_bands zeros
  float* spart = sband + R * kb;   // [parts, R, k]
  const int tid = threadIdx.x, q = tid / TPR, u = tid % TPR;
  const long long groups = (rows + R - 1) / R;
  for (int j = tid; j < R * sh.bin_bands; j += THREADS)
    sband[(j / sh.bin_bands) * kb + k + j % sh.bin_bands] = 0.f;
  if (blockIdx.x < groups) fetch<R>(x, ly, blockIdx.x, rows, n, buf[0]);

  int cur = 0;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x, cur ^= 1) {
    float* sa = buf[cur];
    __pipeline_wait_prior(0);
    __syncthreads();  // the rows are in; every thread is done with the last
    if (g + gridDim.x < groups)
      fetch<R>(x, ly, g + gridDim.x, rows, n, buf[cur ^ 1]);
    if (tid < R)  // read in step 5, after the barriers between
      soff[tid] = g * R + tid < rows ? row_offset(ly, g * R + tid) : -1;

    // 1. tonality (psycho.tonality), TPR threads a row
    float slog = 0.f, spow = 0.f;
    {
      const float* a = sa + q * n;
      for (int i = u; i < n; i += TPR) {
        const float p = __fmul_rn(a[i], a[i]);
        slog = __fadd_rn(slog, logf(fmaxf(sc.eps, p)));
        spow = __fadd_rn(spow, p);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      slog = __fadd_rn(slog, __shfl_xor_sync(0xffffffffu, slog, o));
      spow = __fadd_rn(spow, __shfl_xor_sync(0xffffffffu, spow, o));
    }
    if (WPR > 1) {  // a row of several warps: their sums in warp order
      if ((tid & 31) == 0) {
        red[tid >> 5] = slog;
        red[WARPS + (tid >> 5)] = spow;
      }
      __syncthreads();
      slog = red[q * WPR];
      spow = red[WARPS + q * WPR];
      for (int w = 1; w < WPR; ++w) {
        slog = __fadd_rn(slog, red[q * WPR + w]);
        spow = __fadd_rn(spow, red[WARPS + q * WPR + w]);
      }
    }
    if (u == 0) {
      const float geo = expf(__fmul_rn(slog, sc.mean_factor));
      const float arith = __fadd_rn(__fmul_rn(spow, sc.mean_factor), sc.eps);
      const float sfm =
          __fdiv_rn(__fmul_rn(10.f, logf(__fdiv_rn(geo, arith))), sc.ln10);
      ston[q] = fminf(__fmul_rn(sfm, sc.inv_neg60), 1.f);
    }

    // 2. the Bark intensities, band_threads threads a band for the R rows,
    // then to the power alpha; the groups never straddle a warp, and every
    // lane of a warp that holds one takes part in its shuffles
    const int bt = sh.band_threads;
    const int items = (k * bt + 31) & ~31;
    for (int w = tid; w < items; w += THREADS) {
      const int j = w / bt, t0 = w % bt;
      float acc[R];
#pragma unroll
      for (int p = 0; p < R; ++p) acc[p] = 0.f;
      if (j < k) {
        const int lo = __ldg(tb.band_lo + j), b0 = __ldg(tb.band_off + j);
        const int len = __ldg(tb.band_off + j + 1) - b0;
        for (int t = t0; t < len; t += bt) {
          const float wt = __ldg(tb.band_w + b0 + t);
#pragma unroll
          for (int p = 0; p < R; ++p) {
            const float v = sa[p * n + lo + t];
            acc[p] = fmaf(__fmul_rn(v, v), wt, acc[p]);
          }
        }
      }
      for (int o = bt >> 1; o; o >>= 1) {
#pragma unroll
        for (int p = 0; p < R; ++p)
          acc[p] = __fadd_rn(acc[p], __shfl_xor_sync(0xffffffffu, acc[p], o));
      }
      if (j < k) {
#pragma unroll
        for (int p = 0; p < R; ++p)
          if (p % bt == t0)
            sband[p * kb + j] = powf(fmaxf(sc.eps, acc[p]), sc.alpha);
      }
    }
    __syncthreads();

    // 3. the spreading product in parts of `chunk` bands, a column for the
    // R rows
    for (int w = tid; w < sh.parts * k; w += THREADS) {
      const int part = w / k, col = w % k;
      const int j0 = part * sh.chunk, j1 = min(k, j0 + sh.chunk);
      float acc[R];
#pragma unroll
      for (int p = 0; p < R; ++p) acc[p] = 0.f;
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const float s = __ldg(tb.spreading + j * k + col);
#pragma unroll
        for (int p = 0; p < R; ++p) acc[p] = fmaf(sband[p * kb + j], s, acc[p]);
      }
#pragma unroll
      for (int p = 0; p < R; ++p) spart[(part * R + p) * k + col] = acc[p];
    }
    __syncthreads();

    // 4. the offset factor, 1 / alpha and the threshold in quiet
    // (global_masking_intensity_in_bark), a (row, band) a thread
    for (int pc = tid; pc < R * k; pc += THREADS) {
      const int p = pc / k, col = pc % k;
      const float ton = ston[p];
      float spread = spart[p * k + col];
      for (int part = 1; part < sh.parts; ++part)
        spread = __fadd_rn(spread, spart[(part * R + p) * k + col]);
      float offset = __fadd_rn(__fmul_rn(ton, __ldg(tb.grid + col)),
                               __fmul_rn(9.f, ton));
      offset = __fmul_rn(__fadd_rn(offset, 5.5f), sc.keep);
      const float factor =
          powf(10.f, __fmul_rn(__fmul_rn(sc.neg_alpha, offset), sc.inv_ten));
      const float masked =
          powf(fmaxf(sc.eps, __fmul_rn(spread, factor)), sc.inv_alpha);
      sband[p * kb + col] = fmaxf(masked, __ldg(tb.quiet + col));
    }
    __syncthreads();

    // 5. back to bins, the threshold, the step and the code of each bin,
    // a bin for the R rows
    for (int i = tid; i < n; i += THREADS) {
      const int lo = __ldg(tb.bin_lo + i);
      const float* bw = tb.bin_w + i * sh.bin_bands;
      float acc[R];
#pragma unroll
      for (int p = 0; p < R; ++p) acc[p] = 0.f;
      for (int t = 0; t < sh.bin_bands; ++t) {
        const float wt = __ldg(bw + t);
#pragma unroll
        for (int p = 0; p < R; ++p)
          acc[p] = fmaf(sband[p * kb + lo + t], wt, acc[p]);
      }
      const float floor = tb.quiet_freq ? __ldg(tb.quiet_freq + i) : 0.f;
#pragma unroll
      for (int p = 0; p < R; ++p) {
        if (soff[p] < 0) continue;
        float thr = sqrtf(fmaxf(sc.eps, acc[p]));
        if (tb.quiet_freq) thr = fmaxf(thr, floor);
        const float delta = fmaxf(__fmul_rn(thr, sc.rsqrt3), sc.step_floor);
        const int code = (int)rintf(__fdiv_rn(sa[p * n + i], delta));
        const long long o = soff[p] + i;
        if (ENCODE) {
          codes[o] = code;
          delta_out[o] = delta;
          thr_out[o] = thr;
        } else {
          out[o] = __fmul_rn((float)code, delta);
        }
      }
    }
  }
}

Shape make_shape(int n, int k, int bin_bands) {
  int bt = 1;
  while (bt < 32 && 2 * bt * k <= THREADS) bt *= 2;
  const int parts = k < THREADS ? THREADS / k : 1;
  return Shape{n, k, bt, bin_bands, parts, (k + parts - 1) / parts};
}

size_t shared_bytes(const Shape& sh, int rows_a_group) {
  const size_t r = rows_a_group;
  return sizeof(long long) * r +
         sizeof(float) * (2 * r * sh.n + 2 * WARPS + r +
                          r * (sh.k + sh.bin_bands) + sh.parts * r * sh.k);
}

constexpr size_t SHARED_MAX = 227 * 1024;
constexpr size_t SHARED_GROUP = 75 * 1024;  // three blocks a multiprocessor

// The blocks of the kernel <ENCODE, R> with `bytes` of shared memory that
// the current device holds at once: queried at the kernel's first launch
// on each device and size, and kept (with the kernel's shared memory limit
// raised to the most a block may have, once a device).
template <bool ENCODE, int R>
cudaError_t resident_blocks(size_t bytes, long long* blocks) {
  auto kernel = psycho_quantize_kernel<ENCODE, R>;
  struct Known {
    int device;
    size_t bytes;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Known> known;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  bool raised = false;
  for (const Known& kn : known) {
    if (kn.device != device) continue;
    raised = true;
    if (kn.bytes == bytes) {
      *blocks = kn.blocks;
      return cudaSuccess;
    }
  }
  if (!raised)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SHARED_MAX);
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, bytes);
  if (e != cudaSuccess) return e;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  known.push_back(Known{device, bytes, *blocks});
  return cudaSuccess;
}

template <bool ENCODE, int R>
int launch(const float* x, float* out, int* codes, float* delta, float* thr,
           const Tables& tb, const Scalars& sc, const Layout& ly,
           long long rows, int n, int k, int bin_bands, cudaStream_t st) {
  const Shape sh = make_shape(n, k, bin_bands);
  const size_t bytes = shared_bytes(sh, R);
  long long resident = 0;
  const cudaError_t e = resident_blocks<ENCODE, R>(bytes, &resident);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (rows + R - 1) / R;
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  psycho_quantize_kernel<ENCODE, R><<<grid, THREADS, bytes, st>>>(
      x, out, codes, delta, thr, tb, sc, ly, rows, sh);
  return (int)cudaGetLastError();
}

// The most rows a group (8 or 4) that leave room for three blocks a
// multiprocessor, else one (rows of more than ~2,300 bins).
template <bool ENCODE>
int launch_rows(const float* x, float* out, int* codes, float* delta,
                float* thr, const Tables& tb, const Scalars& sc,
                const Layout& ly, long long rows, int n, int k, int bin_bands,
                cudaStream_t st) {
  const Shape sh = make_shape(n, k, bin_bands);
  if (shared_bytes(sh, 8) <= SHARED_GROUP)
    return launch<ENCODE, 8>(x, out, codes, delta, thr, tb, sc, ly, rows, n,
                             k, bin_bands, st);
  if (shared_bytes(sh, 4) <= SHARED_GROUP)
    return launch<ENCODE, 4>(x, out, codes, delta, thr, tb, sc, ly, rows, n,
                             k, bin_bands, st);
  return launch<ENCODE, 1>(x, out, codes, delta, thr, tb, sc, ly, rows, n, k,
                           bin_bands, st);
}

}  // namespace

extern "C" {

// x: float32 rows of n bins, laid out by (frames, channels, sb, sf, sc)
// (layout[5], element strides; rows = batches * frames * channels; the
// bins of a row contiguous, every row 16-byte aligned). The outputs share
// x's layout. cudaErrorInvalidValue: a row too long for a block's shared
// memory, or no rows. encode == 0: out0 = the dequantized spectrum
// (float32); encode == 1: out0 = the codes (int32), out1 = the steps, out2
// = the threshold. tables[9]: the Tables pointers in order; scalars[11]:
// the Scalars in order (host memory); bin_bands: bin_w's row length.
int acx_psycho_quantize(const void* x, void* out0, void* out1, void* out2,
                        const void* const* tables, const float* scalars,
                        const long long* layout, long long rows, int n, int k,
                        int bin_bands, int encode, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || bin_bands <= 0 || layout[1] <= 0 ||
      layout[0] <= 0 || shared_bytes(make_shape(n, k, bin_bands), 1) >
      SHARED_MAX)
    return (int)cudaErrorInvalidValue;
  const Tables tb{
      static_cast<const int*>(tables[0]), static_cast<const int*>(tables[1]),
      static_cast<const float*>(tables[2]), static_cast<const int*>(tables[3]),
      static_cast<const float*>(tables[4]), static_cast<const float*>(tables[5]),
      static_cast<const float*>(tables[6]), static_cast<const float*>(tables[7]),
      static_cast<const float*>(tables[8])};
  const Scalars sc{scalars[0], scalars[1], scalars[2], scalars[3],
                   scalars[4], scalars[5], scalars[6], scalars[7],
                   scalars[8], scalars[9], scalars[10]};
  const Layout ly{layout[0], layout[1], layout[2], layout[3], layout[4]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(x);
  if (encode)
    return launch_rows<true>(in, nullptr, static_cast<int*>(out0),
                             static_cast<float*>(out1),
                             static_cast<float*>(out2), tb, sc, ly, rows, n,
                             k, bin_bands, st);
  return launch_rows<false>(in, static_cast<float*>(out0), nullptr, nullptr,
                            nullptr, tb, sc, ly, rows, n, k, bin_bands, st);
}

}  // extern "C"
