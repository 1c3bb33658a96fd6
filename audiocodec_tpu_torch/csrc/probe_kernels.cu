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
// (K contiguous, ops/cuda_probe.py operand).
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
// bytes at 3.35 TB/s: the bytes bound both tiers.
//
// What the design does about it, simply: one block of 8 warps per tile of
// rows (64 at BF16, 128 at INT8/INT8G: 128 KB either way) reads its rows of
// x once, takes the row (group) maxima with warp shuffles and writes the
// bf16 values or int8 codes into a shared A tile that every column of the
// output reuses; the operand streams through a two-stage cp.async ring of
// [128 n x 128 bytes] tiles; the products are mma.sync (m16n8k16 bf16,
// m16n8k32 s8) from 32-bit shared loads (rows padded by 16 bytes, so the
// 32 lanes hit 32 banks). The whole operand passes through every block
// (from L2), and no product overlaps the A build: the first design is
// right, not fast.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int PK = 1024;     // K and N of the probe
constexpr int THREADS = 256; // 8 warps
constexpr int BN = 128;      // output columns of a tile
constexpr int GROUPS = 8;    // 128-column groups of INT8G along K
constexpr int PAD = 16;      // bytes after each shared row
constexpr int B_ROW = 128 + PAD;  // a B stage row: 128 bytes of K
constexpr int STAGES = 2;

enum Variant { BF16 = 0, INT8 = 1, INT8G = 2 };

template <int V> struct Cfg {  // INT8 and INT8G
  static constexpr int ESIZE = 1;    // bytes an operand element
  static constexpr int BM = 128;     // rows of a block
  static constexpr int WM = 4;       // warps along the rows
};
template <> struct Cfg<BF16> {
  static constexpr int ESIZE = 2;
  static constexpr int BM = 64;
  static constexpr int WM = 2;
};

template <int V> struct Layout {
  using C = Cfg<V>;
  static constexpr int A_ROW = PK * C::ESIZE + PAD;
  static constexpr int BK = 128 / C::ESIZE;      // K of a B stage
  static constexpr int KCH = PK / BK;            // B stages a column tile
  static constexpr int STEPS = (PK / BN) * KCH;
  static constexpr int WN = 8 / C::WM;           // warps along the columns
  static constexpr int MT = C::BM / C::WM / 16;  // m16 tiles of a warp
  static constexpr int NT = BN / WN / 8;         // n8 tiles of a warp
  static constexpr size_t A_BYTES = (size_t)C::BM * A_ROW;
  static constexpr size_t B_BYTES = (size_t)STAGES * BN * B_ROW;
  static constexpr size_t SMEM = A_BYTES + B_BYTES + C::BM * GROUPS * 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block: rows m0 .. m0+BM-1 of x (those past `rows` read as zeros and
// are not written) times the whole operand.
template <int V>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ op,
    float* __restrict__ out, int rows, float rescale) {
  using C = Cfg<V>;
  using L = Layout<V>;
  using Acc = typename std::conditional<V == BF16, float, int>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = smem + L::A_BYTES;
  float* scales = reinterpret_cast<float*>(Bs + L::B_BYTES);  // [BM][GROUPS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * C::BM;

  // B stage `step`: operand rows n0 .. n0+127, K bytes kc*128 .. +127;
  // 8 vectors of 16 bytes a row, 4 a thread
  auto load_b = [&](int step) {
    const int n0 = step / L::KCH * BN, kc = step % L::KCH;
    uint8_t* dst = Bs + (step % STAGES) * BN * B_ROW;
    for (int v = tid; v < BN * 8; v += THREADS) {
      const int r = v >> 3, c = v & 7;
      cp_async16(dst + r * B_ROW + c * 16,
                 op + (size_t)(n0 + r) * PK * C::ESIZE + kc * 128 + c * 16);
    }
    cp_async_commit();
  };
  load_b(0);

  // A: a warp per row; lane l holds float4 j*32 + l (columns 4(32j + l) ..
  // +3), j < 8, so step j of the loop is exactly 128-column group j
  for (int r = warp; r < C::BM; r += THREADS / 32) {
    const int row = m0 + r;
    float4 v[GROUPS];
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * PK);
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
      v[j] = row < rows ? xr[j * 32 + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
    uint8_t* arow = As + r * L::A_ROW;
    if constexpr (V == BF16) {
#pragma unroll
      for (int j = 0; j < GROUPS; ++j)
        *reinterpret_cast<uint2*>(arow + (j * 32 + lane) * 8) = make_uint2(
            pack_bf16(v[j].x, v[j].y), pack_bf16(v[j].z, v[j].w));
    } else if constexpr (V == INT8) {
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < GROUPS; ++j) m = fmaxf(m, abs_max4(v[j]));
      const float s = __fadd_rn(warp_max(m), 1e-12f);
      const float inv = __fdiv_rn(127.f, s);
#pragma unroll
      for (int j = 0; j < GROUPS; ++j)
        *reinterpret_cast<uint32_t*>(arow + (j * 32 + lane) * 4) =
            quant4(v[j], inv);
      if (lane == 0) scales[r * GROUPS] = s;
    } else {
#pragma unroll
      for (int j = 0; j < GROUPS; ++j) {
        const float s = __fadd_rn(warp_max(abs_max4(v[j])), 1e-12f);
        *reinterpret_cast<uint32_t*>(arow + (j * 32 + lane) * 4) =
            quant4(v[j], __fdiv_rn(127.f, s));
        if (lane == 0) scales[r * GROUPS + j] = s;
      }
    }
  }

  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t = lane & 3;
  Acc acc[L::MT][L::NT][4];
  float tot[L::MT][L::NT][4];  // BF16's total; INT8G's group sum
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0, tot[i][j][e] = 0.f;

  for (int step = 0; step < L::STEPS; ++step) {
    if (step + 1 < L::STEPS) {
      load_b(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the stage (and, at step 0, the A tile) is in place
    const int kc = step % L::KCH;
    const uint8_t* bst = Bs + (step % STAGES) * BN * B_ROW;
    // 32 bytes of K a product: k16 of bf16, k32 of s8
#pragma unroll
    for (int kb = 0; kb < 128; kb += 32) {
      uint32_t a[L::MT][4], b[L::NT][2];
#pragma unroll
      for (int i = 0; i < L::MT; ++i) {
        const uint8_t* r0 =
            As + (wm * (C::BM / C::WM) + i * 16 + g) * L::A_ROW + kc * 128 +
            kb + 4 * t;
        const uint8_t* r1 = r0 + 8 * L::A_ROW;
        a[i][0] = lds32(r0);
        a[i][1] = lds32(r1);
        a[i][2] = lds32(r0 + 16);
        a[i][3] = lds32(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const uint8_t* p =
            bst + (wn * (BN / L::WN) + j * 8 + g) * B_ROW + kb + 4 * t;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int j = 0; j < L::NT; ++j) mma(acc[i][j], a[i], b[j]);
    }
    // a stage's epilogue: BF16 flushes into its total, INT8G closes its
    // group (a stage of 128 K is one group)
    if constexpr (V != INT8) {
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = wm * (C::BM / C::WM) + i * 16 + g + 8 * h;
          const float sg = V == INT8G ? scales[rl * GROUPS + kc] : 0.f;
#pragma unroll
          for (int j = 0; j < L::NT; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              float term;
              if constexpr (V == BF16) {
                term = acc[i][j][e];
              } else {
                term = __fmul_rn(__int2float_rn(acc[i][j][e]), sg);
              }
              tot[i][j][e] = __fadd_rn(tot[i][j][e], term);
              acc[i][j][e] = 0;
            }
        }
    }
    if (kc == L::KCH - 1) {  // the column tile is complete
      const int n0 = step / L::KCH * BN;
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = wm * (C::BM / C::WM) + i * 16 + g + 8 * h;
          const float sr = V == INT8 ? __fmul_rn(scales[rl * GROUPS], rescale)
                                     : 0.f;
#pragma unroll
          for (int j = 0; j < L::NT; ++j) {
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 2 * h + e;
              if constexpr (V == BF16) {
                o[e] = tot[i][j][k];
              } else if constexpr (V == INT8) {
                o[e] = __fmul_rn(__int2float_rn(acc[i][j][k]), sr);
              } else {
                o[e] = __fmul_rn(tot[i][j][k], rescale);
              }
              acc[i][j][k] = 0;
              tot[i][j][k] = 0.f;
            }
            if (m0 + rl < rows)
              *reinterpret_cast<float2*>(
                  out + (size_t)(m0 + rl) * PK + n0 + wn * (BN / L::WN) +
                  j * 8 + 2 * t) = make_float2(o[0], o[1]);
          }
        }
    }
    __syncthreads();  // the stage is refilled two steps on
  }
}

template <int V>
int launch(const float* x, const void* op, float* out, int rows,
           float rescale, cudaStream_t st) {
  auto kernel = probe_kernel<V>;
  static std::atomic<uint64_t> shared_set{0};  // bit d: device d is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(shared_set.load() & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<V>::SMEM);
    if (e != cudaSuccess) return (int)e;
    shared_set |= bit;
  }
  const unsigned grid = (unsigned)((rows + Cfg<V>::BM - 1) / Cfg<V>::BM);
  kernel<<<grid, THREADS, Layout<V>::SMEM, st>>>(
      x, static_cast<const uint8_t*>(op), out, rows, rescale);
  return 0;
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

// The dynamic shared memory of a variant's block, in bytes.
int acx_probe_shared_bytes(int variant) {
  switch (variant) {
    case BF16: return (int)Layout<BF16>::SMEM;
    case INT8: return (int)Layout<INT8>::SMEM;
    case INT8G: return (int)Layout<INT8G>::SMEM;
    default: return -1;
  }
}

}  // extern "C"
