// Hand-written Hopper (sm_90a) kernels of the int8 probe's GEMM.
//
// They replace the three bodies of the probe's Pallas TPU kernel:
//   * probe_kernel<BF16>  <- benchmarks/pallas_int8_probe.py, make_call with
//                            bf16_kernel
//   * probe_kernel<INT8>  <- make_call with int8_kernel
//   * probe_kernel<INT8G> <- make_call with int8_grouped_kernel
//
//   out [rows, 1024] float32 = x [rows, 1024] float32 @ M [1024, 1024]
//
// with M in bfloat16 or as int8 codes, read in its operand form op [N, K]
// (K contiguous, ops/cuda_probe.py operand) through a TMA map.
//
// Numerics, which the plain torch versions in ops/cuda_probe.py share:
//   * BF16: x rounded to bf16 (RNE), bf16 products, float32 sums (a fresh
//     tensor-core accumulator per 64 of K, added to a float32 total with
//     __fadd_rn: the tensor cores' own accumulation does not round to
//     nearest);
//   * INT8: per row s = max|x| + 1e-12, q = clip(rint(x * (127 / s)), +-127)
//     (round half to even, a true division), exact int32 sums, out =
//     float(y) * (s * rescale);
//   * INT8G: the same per row and 128-column group g, a fresh int32 sum per
//     group, acc = acc + float(y_g) * s_g in group order, out = acc *
//     rescale.
// Every float epilogue operation is __fmul_rn/__fadd_rn: ptxas would
// contract a product and a sum into one fma, which breaks the int8 tiers'
// bit-equality with the plain versions.
//
// What bounds it on an H100: at the probe's shape (14336 rows) the product
// is 30.1 GFLOP against 119.5 MB (bf16; 118.5 MB int8) of x, M and out
// once each, 0.030 ms of bf16 products at 989 TF/s against 0.036 ms of
// bytes at 3.35 TB/s: the bytes bound both tiers, and at bf16 the products
// come close, so the two have to overlap.
//
// What the design does about it:
//   * A, a CTA's rows of x (up to 128) as bf16 values or int8 codes with
//     their scales, is built once in shared memory (128 KB, 128-byte-swizzled
//     K-major tiles, hopper.cuh) by the two consumer warpgroups, one warp
//     a row, the scales as warp reductions; every column of the output
//     reuses it. The operand streams through a TMA ring from one producer
//     thread, and each warpgroup runs wgmma (m64n128, k16 bf16 -> f32 or
//     k32 s8 -> s32) for its 64 rows on every stage.
//   * The operand's traffic: every operand byte a CTA streams serves its
//     rows of x (up to 128), which holds the operand's L2 reads to one
//     pass per row tile and a CTA's own stream to what an SM can take in.
//     128 bf16 rows of all of K would need 256 KB, so at bf16 two CTAs of
//     a cluster split K: each holds its rows' half of K (128 KB) and
//     streams that half of the operand; of each item, warpgroup r of CTA
//     r sums its 64 rows, adding the partial sums of the other CTA's
//     warpgroup r, which writes them into CTA r's shared memory.
//   * Filling the SMs: the work is items of (a row tile, 128 output
//     columns), split in contiguous ranges over as many CTAs (int8) or
//     clusters (bf16) as the card holds at once; a CTA builds A where its
//     range enters a row tile. At int8 the A build (all of x's 4 KB a row,
//     quantized) costs more than a quarter of the time, so the row tiles
//     are cut to give each CTA whole tiles (109 rows at 14336 rows: one
//     tile a CTA on 132 SMs), every row of x built once; the rows of A
//     past a tile's are zeros, spent products the bytes bound leaves room
//     for. At bf16 the operand's stream costs most (two bytes an element),
//     so the tiles keep all 128 rows and a cluster's range takes 13-14
//     items, crossing into a second tile.
//   * The output is stored from the accumulators' registers (write-back
//     through L2), under the next item's products.
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

constexpr int PK = 1024;      // K and N of the probe
constexpr int THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int BM = 128;       // rows of a CTA: 64 a warpgroup
constexpr int IC = 128;       // output columns of an item
constexpr int GROUPS = 8;     // 128-column groups of INT8G along K
constexpr int A_BYTES = 128 * 1024;  // the shared A tile of every variant
constexpr int STAGE_BYTES = IC * 128;  // a ring stage: 128 bytes of K

enum Variant { BF16 = 0, INT8 = 1, INT8G = 2 };

template <int V> struct Cfg {  // INT8 and INT8G
  static constexpr int ESIZE = 1;   // bytes an operand element
  static constexpr int KSPLIT = 1;  // CTAs of a cluster, splitting K
  static constexpr int STAGES = 5;
};
template <> struct Cfg<BF16> {
  static constexpr int ESIZE = 2;
  static constexpr int KSPLIT = 2;
  static constexpr int STAGES = 4;
};

template <int V> struct Layout : Cfg<V> {
  using C = Cfg<V>;
  static constexpr int KC = PK / C::KSPLIT;         // K of a CTA
  static constexpr int KT_ELEMS = 128 / C::ESIZE;   // K of a 128-byte tile
  static constexpr int KTS = KC / KT_ELEMS;         // K tiles (GROUPS int8)
  static constexpr int CHUNKS = PK / IC;            // items a row tile
  static constexpr int SCALE_FLOATS = V == BF16 ? 0 : BM * GROUPS;
  // the partial sums a warpgroup receives from the other CTA: 64 x IC
  static constexpr int LANDING_FLOATS = C::KSPLIT > 1 ? 64 * IC : 0;
  static constexpr int BAR_BYTES = 128;  // full, empty, landed, freed
  static_assert(BM * KC * C::ESIZE == A_BYTES && KTS == GROUPS, "A tile");
  static_assert((2 * C::STAGES + 2) * 8 <= BAR_BYTES, "barrier space");
  // +1024: aligned by hand
  static constexpr size_t SMEM =
      1024 + A_BYTES + (size_t)C::STAGES * STAGE_BYTES + BAR_BYTES +
      4 * (size_t)(SCALE_FLOATS + LANDING_FLOATS);
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint32_t quant4(float4 v, float inv) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = rintf(__fmul_rn(f[i], inv));
    t = fminf(fmaxf(t, -127.f), 127.f);
    w |= (uint32_t)(uint8_t)(signed char)(int)t << (8 * i);
  }
  return w;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Build A from columns k0 .. k0+KC-1 of rows row0 .. row0+BM-1 of x (rows
// from row0 + tile_rows or from `rows` on as zeros): a warp a row, two
// rows a round with all their loads in flight; lane l holds float4 32j + l
// of the row's KC columns
// (at int8, KC = 1024 and step j is 128-column group j). K tile kt of A is
// [BM rows x 128 bytes] at A + kt x BM x 128, its 16-byte chunk c of row r
// at chunk c ^ (r % 8).
template <int V>
__device__ __forceinline__ void build_a(uint8_t* A, float* scales,
                                        const float* __restrict__ x,
                                        int row0, int rows, int tile_rows,
                                        int k0, int warp, int lane) {
  constexpr int J = Layout<V>::KC / 128, FR = 2;  // float4s a lane
  for (int m0 = warp; m0 < BM; m0 += 8 * FR) {
    float4 v[FR][J];
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int row = row0 + m0 + 8 * f;
      const bool in = m0 + 8 * f < tile_rows && row < rows;
      const float4* xr =
          reinterpret_cast<const float4*>(x + (size_t)row * PK + k0);
#pragma unroll
      for (int j = 0; j < J; ++j)
        v[f][j] = in ? __ldg(xr + j * 32 + lane)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int r = m0 + 8 * f;
      uint8_t* arow = A + r * 128;
      if constexpr (V == BF16) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int q = 32 * j + lane;  // float4 q: K tile q / 16
          const int c = (q & 15) >> 1;  // its 16-byte chunk, half q % 2
          *reinterpret_cast<uint2*>(arow + (q >> 4) * BM * 128 +
                                    ((c ^ (r & 7)) << 4) + (q & 1) * 8) =
              make_uint2(pack_bf16(v[f][j].x, v[f][j].y),
                         pack_bf16(v[f][j].z, v[f][j].w));
        }
      } else {
        float inv[J];
        if constexpr (V == INT8) {
          float m = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) m = fmaxf(m, abs_max4(v[f][j]));
          const float s = __fadd_rn(warp_max(m), 1e-12f);
          const float i = __fdiv_rn(127.f, s);
#pragma unroll
          for (int j = 0; j < J; ++j) inv[j] = i;
          if (lane == 0) scales[r * GROUPS] = s;
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float s = __fadd_rn(warp_max(abs_max4(v[f][j])), 1e-12f);
            inv[j] = __fdiv_rn(127.f, s);
            if (lane == 0) scales[r * GROUPS + j] = s;
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j)  // K tile j, chunk lane / 4
          *reinterpret_cast<uint32_t*>(arow + j * BM * 128 +
                                       (((lane >> 2) ^ (r & 7)) << 4) +
                                       (lane & 3) * 4) = quant4(v[f][j],
                                                                inv[j]);
      }
    }
  }
}

// One CTA (int8) or one of the two CTAs of a cluster (bf16, rank r taking
// K columns [r KC, (r+1) KC)). CTA or cluster g of G takes items [g I / G,
// (g+1) I / G) of the I of (row tile of `tile_rows` <= BM rows, IC-column
// chunk); rows past `rows` read as zeros and are not written.
template <int V>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(
    const __grid_constant__ CUtensorMap tmap, const float* __restrict__ x,
    float* __restrict__ out, int rows, int tile_rows, float rescale) {
  using L = Layout<V>;
  constexpr int STAGES = L::STAGES, KSPLIT = L::KSPLIT;
  using Acc = typename std::conditional<V == BF16, float, int>::type;

  extern __shared__ uint8_t raw_smem[];
  const uint32_t raw = hopper::smem_addr(raw_smem);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = raw_smem + pad;
  const uint32_t sA = raw + pad;
  const uint32_t ring = sA + A_BYTES;
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  float* scales = reinterpret_cast<float*>(smem + (bars - sA) + L::BAR_BYTES);
  float* landing = scales + L::SCALE_FLOATS;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t landed = bars + 16 * STAGES, freed = landed + 8;

  const int tid = threadIdx.x;
  const uint32_t rank = KSPLIT > 1 ? hopper::cluster_rank() : 0;
  const int g = blockIdx.x / KSPLIT, groups = gridDim.x / KSPLIT;
  const int items_all = (rows + tile_rows - 1) / tile_rows * L::CHUNKS;
  const int begin = (int)((long long)g * items_all / groups);
  const int items = (int)((long long)(g + 1) * items_all / groups) - begin;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_init(landed, 128);  // the other CTA's sending warpgroup
    hopper::mbar_init(freed, 128);   // the other CTA's receiving one
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();  // every barrier of the cluster is initialised

  if (tid == 256) {  // the producer: this CTA's K columns of each item
    hopper::prefetch_tmap(&tmap);
    int it = 0;
    for (int i = 0; i < items; ++i) {
      const int chunk = (begin + i) % L::CHUNKS;
      for (int kt = 0; kt < L::KTS; ++kt, ++it) {
        const int s = it % STAGES, use = it / STAGES;
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);
        hopper::mbar_expect_tx(full(s), STAGE_BYTES);
        hopper::tma_load_2d(ring + s * STAGE_BYTES, &tmap, full(s),
                            rank * L::KC + kt * L::KT_ELEMS, chunk * IC);
      }
    }
  } else if (tid < 256) {  // the consumers
    const int wg = tid >> 7, t = tid & 127;
    const uint32_t a_base = sA + 64 * wg * 128;  // this warpgroup's rows
    const int r0 = 16 * (t >> 5) + ((t & 31) >> 2);  // + 8h: rows
    const int c0 = 2 * (t & 3);                      // + 8j + c: columns
    // bf16: warpgroup `rank` keeps its rows, adding the other CTA's
    // partial sums; the other warpgroup sends its own to that CTA, thread
    // t's element e at landing[128 e + t]
    const bool sends = KSPLIT > 1 && wg != (int)rank;
    const uint32_t peer_landing =
        KSPLIT > 1 ? hopper::map_cta(hopper::smem_addr(landing), rank ^ 1)
                   : 0;

    // K tile kt of stage s into acc (scale_d = 0 on its first step if
    // fresh)
    auto mma_step = [&](Acc(&acc)[64], int s, int kt, bool fresh) {
      const uint32_t a = a_base + kt * BM * 128;
      const uint32_t b = ring + s * STAGE_BYTES;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma(acc, hopper::sw128_desc(a + 32 * kk),
                      hopper::sw128_desc(b + 32 * kk),
                      fresh && kk == 0 ? 0 : 1);
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
    };
    auto release = [&](int it) {
      if (t == 0) hopper::mbar_arrive(empty(it % STAGES));
    };

    int it = 0;
    for (int i = 0; i < items; ++i) {
      const int row0 = (begin + i) / L::CHUNKS * tile_rows;
      const int chunk = (begin + i) % L::CHUNKS;
      // a new tile: both warpgroups' products are done with A
      if (i == 0 || chunk == 0) {
        hopper::named_sync(1, 256);
        build_a<V>(smem, scales, x, row0, rows, tile_rows, rank * L::KC,
                   tid >> 5, tid & 31);
        hopper::fence_proxy_async();
        hopper::named_sync(1, 256);
      }
      float z[64];
      Acc acc[64];
      if constexpr (V == INT8) {  // one integer sum over all of K
        for (int kt = 0; kt < L::KTS; ++kt, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(full(s), (it / STAGES) & 1);
          mma_step(acc, s, kt, kt == 0);
          hopper::wgmma_wait<1>();  // the previous K tile's products are done
          hopper::fence_regs(acc);
          if (kt > 0) release(it - 1);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(it - 1);
        const float s0 =
            __fmul_rn(scales[(64 * wg + r0) * GROUPS], rescale);
        const float s1 =
            __fmul_rn(scales[(64 * wg + r0 + 8) * GROUPS], rescale);
#pragma unroll
        for (int e = 0; e < 64; ++e)
          z[e] = __fmul_rn(__int2float_rn(acc[e]), e & 2 ? s1 : s0);
      } else {  // a fresh sum a K tile (BF16) or group (INT8G), in order
        for (int kt = 0; kt < L::KTS; ++kt, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(full(s), (it / STAGES) & 1);
          mma_step(acc, s, kt, true);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          release(it);
          float g0 = 0.f, g1 = 0.f;
          if constexpr (V == INT8G) {
            g0 = scales[(64 * wg + r0) * GROUPS + kt];
            g1 = scales[(64 * wg + r0 + 8) * GROUPS + kt];
          }
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            float term;
            if constexpr (V == BF16)
              term = acc[e];
            else
              term = __fmul_rn(__int2float_rn(acc[e]), e & 2 ? g1 : g0);
            z[e] = kt == 0 ? term : __fadd_rn(z[e], term);
          }
        }
        if constexpr (V == INT8G) {
#pragma unroll
          for (int e = 0; e < 64; ++e) z[e] = __fmul_rn(z[e], rescale);
        }
      }
      if constexpr (KSPLIT > 1) {
        if (sends) {
          if (i > 0) hopper::mbar_wait_cluster(freed, (i - 1) & 1);
#pragma unroll
          for (int e = 0; e < 64; ++e)
            hopper::st_cluster(peer_landing + 4 * (128 * e + t), z[e]);
          hopper::mbar_arrive_cluster(landed, rank ^ 1);
          continue;
        }
        hopper::mbar_wait_cluster(landed, i & 1);
#pragma unroll
        for (int e = 0; e < 64; ++e)
          z[e] = __fadd_rn(z[e], landing[128 * e + t]);
        hopper::mbar_arrive_cluster(freed, rank ^ 1);
      }
      // thread t holds rows r0 + 8h and columns 8j + c0 + c of its
      // warpgroup's 64 x 128 tile in z[4j + 2h + c]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + r0 + 8 * h, row = row0 + r;
        if (r >= tile_rows || row >= rows) continue;
        float* o = out + (size_t)row * PK + chunk * IC;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(o + 8 * j + c0) =
              make_float2(z[4 * j + 2 * h], z[4 * j + 2 * h + 1]);
      }
    }
  }
  // no CTA leaves while its peer may still write to its shared memory or
  // arrive on its barriers
  hopper::cluster_sync();
}

template <int V>
int launch(const float* x, const void* op, float* out, int rows,
           float rescale, cudaStream_t st) {
  using L = Layout<V>;
  CUtensorMap map;
  int rc = hopper::operand_map(&map, op, V == BF16, PK, PK, IC);
  if (rc) return rc;
  auto kernel = probe_kernel<V>;
  static std::atomic<uint64_t> shared_set{0};
  rc = hopper::allow_shared(kernel, shared_set);
  if (rc) return rc;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = L::KSPLIT;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // the clusters the card holds at once, asked once per device
  static std::atomic<int> most_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int most = dev < 64 ? most_of[dev].load() : 0;
  if (most <= 0) {
    cfg.gridDim = dim3(L::KSPLIT);
    e = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (most <= 0) return (int)cudaErrorInvalidConfiguration;
    if (dev < 64) most_of[dev] = most;
  }
  // row tiles: int8, whole ones for each group (CTA), `per` of them,
  // rows / (groups x per) rows each; bf16, 128 rows
  int groups = rows < most ? rows : most;
  int tile_rows = BM;
  if (V != BF16) {
    const int per = ((rows + BM - 1) / BM + groups - 1) / groups;
    tile_rows = (rows + groups * per - 1) / (groups * per);
  }
  const int items = (rows + tile_rows - 1) / tile_rows * L::CHUNKS;
  groups = groups < items ? groups : items;
  cfg.gridDim = dim3(L::KSPLIT * groups);
  return (int)cudaLaunchKernelEx(&cfg, kernel, map, x, out, rows, tile_rows,
                                 rescale);
}

}  // namespace

extern "C" {

// x: [rows, 1024] float32; op: [1024, 1024] (N, K contiguous) bf16 for
// variant 0, int8 codes for 1 (int8) and 2 (int8g); out: [rows, 1024]
// float32.
int acx_probe_gemm(const void* x, const void* op, void* out, int rows,
                   int variant, float rescale, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  int rc;
  switch (variant) {
    case BF16: rc = launch<BF16>(xf, op, o, rows, rescale, st); break;
    case INT8: rc = launch<INT8>(xf, op, o, rows, rescale, st); break;
    case INT8G: rc = launch<INT8G>(xf, op, o, rows, rescale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}

// The dynamic shared memory of a variant's CTA, in bytes.
int acx_probe_shared_bytes(int variant) {
  switch (variant) {
    case BF16: return (int)Layout<BF16>::SMEM;
    case INT8: return (int)Layout<INT8>::SMEM;
    case INT8G: return (int)Layout<INT8G>::SMEM;
    default: return -1;
  }
}

}  // extern "C"
