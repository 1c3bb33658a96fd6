// Hand-written CUDA kernel of the run-length Rice coder of a stream chunk's
// codes: byte for byte the bytes of native/entropy.cpp's
// acx_rrice_encode_idx (no index), so that a chunk coded on the card and
// one coded on the host are the same file.
//
// It replaces no TPU kernel. The JAX package codes on the host, as the
// port did: the .acs encoder copied each chunk's int32 codes (2 MB at 256
// frames x 1024 bins x 2 channels) back to the host and coded them there
// serially, which set the pace of a stream. Here the codes stay on the card
// and only the coded bytes (~0.2 MB) come back.
//
// The wire format (entropy.cpp): the codes, flattened row-major, in groups
// of 256 values (the last may be partial); each group a 4-bit k, a mode bit
// and its values, MSB first, the last byte padded with zeros. Mode 0:
// every value Rice-coded, zigzag(v) at k; mode 1: before every nonzero the
// Elias-gamma code of (zeros before it within the group) + 1, then
// zigzag(v) - 1 Rice-coded at k, and after the last value, if it is zero,
// the gamma code of (the trailing zeros) + 1. A Rice symbol is q = u >> k
// ones, a 0 and u's k low bits; from q = 47 on it is 48 ones, a 0 and u's
// 32 bits. Both k and the mode come from the host's closed forms
// (best_k_from_sum, est_cost), which ignore escapes.
//
// The host writes groups in turn; here a group's place in the stream is
// found first, in three kernels on one stream:
//   1. rrice_cost_kernel: a warp a group, a lane 8 consecutive values,
//      finds the group's k, mode and exact length (escapes included);
//   2. rrice_scan_kernel: one block scans the lengths into each group's
//      first bit and the byte count, and zeroes the one or two words at
//      each group's edges;
//   3. rrice_write_kernel: a warp a group again finds each lane's first bit
//      by a scan over the lanes and ORs every symbol into a copy of the
//      group's words in shared memory; it then stores the words that the
//      group alone covers, and ORs into device memory the edge words it
//      shares with its neighbours.
// A lane's zero runs start from the trailing zeros of the last lane before
// it with a nonzero (a ballot and one shuffle).
//
// What bounds it on an H100: a body chunk's 524,288 codes are 2 MB read
// and its coding 0.04-0.26 MB written, 0.6-0.7 us of the card's 3.35 TB/s
// (the codes are read twice, from L2 the second time). The three kernels
// take 3.5, 1.7 and 7.1 us of device time, and a call 0.04 ms between
// events back to back (H100 80GB HBM3, 700 W): launch latency and the
// scan's one block bound it, far below the host's ~3.5 ms step that it
// hides behind. (One block for all three steps, a warp walking 64 groups
// in turn, took ~1.0 ms: the loads of one block in flight bound it.)
//
// The entry point launches on the caller's stream and returns the first
// launch's error, cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kGroup = 256;  // RICE_GROUP
constexpr int kPerLane = kGroup / 32;
constexpr int kWarps = 8;  // a block of the cost and write kernels
constexpr int kThreads = kWarps * 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxQuotient = 47;  // larger quotients escape to raw
constexpr int kEscapeBits = kMaxQuotient + 1 + 1 + 32;
constexpr int kHeaderBits = 5;
// a group's longest coding: the header and, a value, a gamma token of at
// most 17 bits and an escaped symbol; staged from its first word's bit
// offset (< 32)
constexpr int kStageWords =
    (31 + kHeaderBits + kGroup * (17 + kEscapeBits) + 31) / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t zigzag(int32_t v) {
  return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

__device__ __forceinline__ long long est_cost(unsigned long long sum,
                                              long long count, int k) {
  return count * (k + 1) + static_cast<long long>(sum >> k);
}

__device__ __forceinline__ int best_k(unsigned long long sum,
                                      long long count) {
  int best = 0;
  long long best_cost = LLONG_MAX;
  for (int k = 0; k < 16; ++k) {
    const long long cost = est_cost(sum, count, k);
    if (cost < best_cost) {
      best_cost = cost;
      best = k;
    }
  }
  return best;
}

__device__ __forceinline__ int gamma_bits(uint32_t x) {
  return 2 * (31 - __clz(x)) + 1;
}

__device__ __forceinline__ int rice_bits(uint32_t u, int k) {
  const uint32_t q = u >> k;
  return q >= kMaxQuotient ? kEscapeBits : static_cast<int>(q) + 1 + k;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const T up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// One lane's share of a group and the group's coding choice.
struct Lane {
  uint32_t u[kPerLane];  // zigzagged values, 0 past the group's end
  int valid;             // values of the group this lane holds
  uint32_t run0;         // zeros of the group just before the lane's first
  uint32_t trail;        // the final run token's zeros, or 0 for none
  int k;
  bool rle;
};

// Lane `lane`'s values of group g and, from the whole warp, the group's k
// and mode, as acx_rrice_encode_idx chooses them.
__device__ __forceinline__ Lane plan(const int32_t* __restrict__ codes,
                                     long long n, long long g, int lane) {
  Lane ln;
  const long long start = g * kGroup;
  const long long len = n - start < kGroup ? n - start : kGroup;
  const long long first = start + lane * kPerLane;
  const long long left = len - lane * kPerLane;
  ln.valid = left <= 0 ? 0 : (left < kPerLane ? (int)left : kPerLane);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    ln.u[j] = j < ln.valid ? zigzag(__ldg(codes + first + j)) : 0u;
  // zero runs across the lanes
  int tz = 0;
  bool any = false;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (j >= ln.valid) continue;
    if (ln.u[j]) {
      tz = 0;
      any = true;
    } else {
      ++tz;
    }
  }
  const unsigned before = __ballot_sync(kFull, any) & ((1u << lane) - 1u);
  const int src = before ? 31 - __clz(before) : 0;
  const int tz_src = __shfl_sync(kFull, tz, src);
  ln.run0 = before ? (uint32_t)(tz_src + kPerLane * (lane - 1 - src))
                   : (uint32_t)(kPerLane * lane);
  // the sums of both modes' costs
  unsigned long long plain_sum = 0, nz_sum = 0;
  long long run_cost = 0;
  int nz = 0;
  uint32_t r = ln.run0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (j >= ln.valid) continue;
    const uint32_t u = ln.u[j];
    plain_sum += u;
    if (u == 0) {
      ++r;
      continue;
    }
    run_cost += gamma_bits(r + 1u);
    r = 0;
    ++nz;
    nz_sum += u - 1u;
  }
  // r > 0: the lane's values end in zeros; on the lane that holds the
  // group's last value, they are the final run token's
  const bool last = ln.valid > 0 && lane * kPerLane + ln.valid == len;
  ln.trail = last ? r : 0u;
  if (ln.trail) run_cost += gamma_bits(ln.trail + 1u);
  plain_sum = warp_sum(plain_sum);
  nz_sum = warp_sum(nz_sum);
  run_cost = warp_sum(run_cost);
  nz = warp_sum(nz);
  const int plain_k = best_k(plain_sum, len);
  const int rle_k = nz ? best_k(nz_sum, nz) : 0;
  const long long plain_cost = est_cost(plain_sum, len, plain_k);
  const long long rle_cost =
      run_cost + (nz ? est_cost(nz_sum, nz, rle_k) : 0);
  ln.rle = rle_cost < plain_cost;
  ln.k = ln.rle ? rle_k : plain_k;
  return ln;
}

// The exact bits of the lane's symbols.
__device__ __forceinline__ int lane_bits(const Lane& ln) {
  int bits = 0;
  uint32_t r = ln.run0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (j >= ln.valid) continue;
    const uint32_t u = ln.u[j];
    if (!ln.rle) {
      bits += rice_bits(u, ln.k);
    } else if (u == 0) {
      ++r;
    } else {
      bits += gamma_bits(r + 1u) + rice_bits(u - 1u, ln.k);
      r = 0;
    }
  }
  if (ln.rle && ln.trail) bits += gamma_bits(ln.trail + 1u);
  return bits;
}

// ORs the n <= 64 low bits of v, MSB first, into the staged words at bit
// `pos`, and moves `pos` past them. The words hold the stream's bytes in
// order (a big-endian word, byte-swapped).
__device__ __forceinline__ void put(uint32_t* stage, int& pos,
                                   unsigned long long v, int n) {
  while (n > 0) {
    const int s = pos & 31;
    const int take = n < 32 - s ? n : 32 - s;
    const uint32_t piece = static_cast<uint32_t>(v >> (n - take)) &
                           (take == 32 ? kFull : (1u << take) - 1u);
    if (piece)
      atomicOr(stage + (pos >> 5),
               __byte_perm(piece << (32 - s - take), 0, 0x0123));
    pos += take;
    n -= take;
  }
}

__device__ __forceinline__ void put_gamma(uint32_t* stage, int& pos,
                                          uint32_t x) {
  put(stage, pos, x, 2 * (31 - __clz(x)) + 1);
}

__device__ __forceinline__ void put_rice(uint32_t* stage, int& pos,
                                         uint32_t u, int k) {
  const uint32_t q = u >> k;
  if (q >= kMaxQuotient) {
    put(stage, pos, (1ull << (kMaxQuotient + 1)) - 1ull, kMaxQuotient + 1);
    put(stage, pos, u, 33);  // the stop 0 and 32 raw bits
  } else {
    put(stage, pos,
        (((1ull << q) - 1ull) << (k + 1)) | (u & ((1u << k) - 1u)),
        static_cast<int>(q) + 1 + k);
  }
}

// aux[g] for g < groups: the group's length in bits.
__global__ void __launch_bounds__(kThreads)
    rrice_cost_kernel(const int32_t* __restrict__ codes, long long n,
                      long long* __restrict__ aux) {
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g * kGroup >= n) return;  // the whole warp
  const Lane ln = plan(codes, n, g, lane);
  const int bits = warp_sum(lane_bits(ln));
  if (lane == 0) aux[g] = kHeaderBits + bits;
}

// aux[g]: the group's length -> its first bit; aux[groups]: the stream's
// bytes, or -1 when they exceed `cap`. Zeroes the words of each group's
// first and last bit that lie inside `cap` bytes.
__global__ void __launch_bounds__(kScanThreads)
    rrice_scan_kernel(long long groups, uint32_t* __restrict__ out,
                      long long cap, long long* __restrict__ aux) {
  __shared__ long long warp_total[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < groups; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < groups ? aux[i] : 0;
    const long long x = warp_inclusive(v, lane);
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    if (warp == 0) warp_total[lane] = warp_inclusive(warp_total[lane], lane);
    __syncthreads();
    if (i < groups) {
      const long long first =
          carry + (warp ? warp_total[warp - 1] : 0) + x - v;
      const long long head = first >> 5, tail = (first + v - 1) >> 5;
      aux[i] = first;
      if (head * 4 < cap) out[head] = 0;
      if (tail * 4 < cap) out[tail] = 0;
    }
    carry += warp_total[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const long long bytes = (carry + 7) / 8;
    aux[groups] = bytes > cap ? -1 : bytes;
  }
}

// The symbols, staged a group at a time in the warp's words; nothing when
// aux[groups] is -1.
__global__ void __launch_bounds__(kThreads)
    rrice_write_kernel(const int32_t* __restrict__ codes, long long n,
                       uint32_t* __restrict__ out,
                       const long long* __restrict__ aux) {
  __shared__ uint32_t stages[kWarps][kStageWords];
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long groups = (n + kGroup - 1) / kGroup;
  if (g >= groups || aux[groups] < 0) return;  // the whole warp
  uint32_t* stage = stages[threadIdx.x >> 5];
  const Lane ln = plan(codes, n, g, lane);
  const int bits = lane_bits(ln);
  const int below = warp_inclusive(bits, lane) - bits;
  const int total = __shfl_sync(kFull, below + bits, 31) + kHeaderBits;
  const long long first = aux[g];
  const int s0 = static_cast<int>(first & 31);
  const int words = (s0 + total + 31) >> 5;
  for (int w = lane; w < words; w += 32) stage[w] = 0;
  __syncwarp();
  if (lane == 0) {
    int pos = s0;
    put(stage, pos, (static_cast<uint32_t>(ln.k) << 1) | (ln.rle ? 1u : 0u),
        kHeaderBits);
  }
  int pos = s0 + kHeaderBits + below;
  uint32_t r = ln.run0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (j >= ln.valid) continue;
    const uint32_t u = ln.u[j];
    if (!ln.rle) {
      put_rice(stage, pos, u, ln.k);
    } else if (u == 0) {
      ++r;
    } else {
      put_gamma(stage, pos, r + 1u);
      put_rice(stage, pos, u - 1u, ln.k);
      r = 0;
    }
  }
  if (ln.rle && ln.trail) put_gamma(stage, pos, ln.trail + 1u);
  __syncwarp();
  const long long w0 = first >> 5;
  const bool open = (s0 + total) & 31;  // the last word is shared
  for (int w = lane; w < words; w += 32) {
    const uint32_t word = stage[w];
    if ((w == 0 && s0) || (w == words - 1 && open)) {
      if (word) atomicOr(out + w0 + w, word);
    } else {
      out[w0 + w] = word;
    }
  }
}

}  // namespace

extern "C" {

// codes: n int32 values on the device; out: a device buffer of at least
// cap bytes rounded up to a multiple of 4, 4-byte aligned; aux: groups + 1
// int64 on the device (groups = ceil(n / 256)); aux[groups] receives the
// coded bytes' count (-1: more than cap, out not written).
int acx_rrice_encode_cuda(const void* codes, long long n, void* out,
                          long long cap, void* aux, void* stream) {
  if (n < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int32_t*>(codes);
  auto* words = static_cast<uint32_t*>(out);
  auto* scratch = static_cast<long long*>(aux);
  const long long groups = (n + kGroup - 1) / kGroup;
  const unsigned blocks = static_cast<unsigned>((groups + kWarps - 1) / kWarps);
  if (blocks) rrice_cost_kernel<<<blocks, kThreads, 0, st>>>(in, n, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rrice_scan_kernel<<<1, kScanThreads, 0, st>>>(groups, words, cap, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (blocks) rrice_write_kernel<<<blocks, kThreads, 0, st>>>(in, n, words,
                                                             scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
