// Hopper (sm_90a) building blocks of the tensor-core kernels, in inline
// PTX: mbarriers (their arrivals and waits across a cluster too), the TMA
// tile load, named and cluster barriers, stores to another CTA's shared
// memory, the wgmma shared-memory descriptor and the asynchronous
// warpgroup products; and on the host, the tensor maps of
// the operands and the shared-memory opt-in.
//
// Operand layout, shared by the TMA loads and the hand-written A tiles:
// K-major tiles whose rows are 128 bytes (64 bf16 or 128 int8 values of K),
// the 16-byte chunks of row r stored at chunk ^ (r % 8) (the 128-byte
// swizzle), 8-row groups 1024 bytes apart, every tile 1024-byte aligned.
// One wgmma step reads 32 bytes of K (k16 bf16, k32 int8); the steps of a
// row advance the descriptor's start address by 32 bytes.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <vector>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA load of a 2-D box at (c0 inner, c1 outer) into shared memory,
// completing `bytes` on the barrier (armed by mbar_expect_tx).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Arrive on the barrier at the shared-memory offset `bar` of CTA `cta` of
// the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 r;\nmapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r];\n}\n" ::
          "r"(bar),
      "r"(cta)
      : "memory");
}

// mbar_wait with cluster-scope acquire: the phase completed on arrivals
// of another CTA of the cluster, whose prior stores to this CTA's shared
// memory become visible here.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The address, in the cluster's shared window, of the shared-memory offset
// `addr` of CTA `cta`.
__device__ __forceinline__ uint32_t map_cta(uint32_t addr, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(cta));
  return r;
}

// A float store to the cluster address `addr` (map_cta).
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
          : "memory");
}

__device__ __forceinline__ void prefetch_tmap(const void* tmap) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(tmap))
               : "memory");
}

// Make this thread's generic-proxy shared-memory stores visible to the
// async proxy (wgmma reads its operands through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15) over `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The descriptor of a 128-byte-swizzled K-major tile starting at `addr`:
// start address >> 4, leading offset 1 (unused by this layout), stride
// 1024 bytes between 8-row groups, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across a wgmma
// launch or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Warpgroup products D (m64 x nN) += A (m64 x K-step) B^T, both operands
// K-major in shared memory; scale_d = 0 overwrites D. The accumulator of
// thread t holds d[4j + 2i + c] at row 16 * (t / 32) + (t % 32) / 4 + 8i,
// column 8j + 2 * (t % 4) + c.
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The product of the accumulator's type and width: bf16 -> f32 (k16) for a
// float accumulator, s8 -> s32 (k32) for an int one; 32 registers are n64,
// 64 are n128.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  wgmma_bf16_n128(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  wgmma_bf16_n64(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db,
                                      int scale_d) {
  wgmma_s8_n128(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da, uint64_t db,
                                      int scale_d) {
  wgmma_s8_n64(d, da, db, scale_d);
}

// ---- Host side: tensor maps and the shared-memory opt-in ------------------

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (no link
// against libcuda).
typedef decltype(&cuTensorMapEncodeTiled) EncodeTiled;

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a K-major matrix at p: `outer` rows of `inner` bf16
// (or int8, bf16 false) values, read in boxes of 128 bytes of K by
// `box_rows` rows with the 128-byte swizzle. Returns a CUDA error code.
inline int encode_map(CUtensorMap* map, const void* p, bool bf16_elems,
               uint64_t inner, uint64_t outer, uint32_t box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const int esz = bf16_elems ? 2 : 1;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esz), box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map,
             bf16_elems ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             2, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// encode_map of a matrix's operand form. The operands are residents built
// once, so each map is encoded once: it holds only the address and the
// geometry, which the key holds too.
inline int operand_map(CUtensorMap* map, const void* op, bool bf16_elems,
                uint64_t inner, uint64_t outer, uint32_t box_rows) {
  struct Entry {
    const void* op;
    bool bf16_elems;
    uint64_t inner, outer;
    uint32_t box_rows;
    CUtensorMap map;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.op == op && e.bf16_elems == bf16_elems && e.inner == inner &&
        e.outer == outer && e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  const int rc = encode_map(map, op, bf16_elems, inner, outer, box_rows);
  if (rc) return rc;
  if (cache.size() == 64) cache.erase(cache.begin());
  cache.push_back(Entry{op, bf16_elems, inner, outer, box_rows, *map});
  return 0;
}

// Let `kernel` take as much dynamic shared memory as a block of the
// current device may, once per device (bit d of `done`).
template <typename K>
inline int allow_shared(K kernel, std::atomic<uint64_t>& done) {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return 0;
  cudaFuncAttributes attr;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)attr.sharedSizeBytes);
  if (e != cudaSuccess) return (int)e;
  done |= bit;
  return 0;
}

}  // namespace hopper
