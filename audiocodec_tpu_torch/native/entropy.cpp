// Rice/Golomb entropy coder for quantized spectral codes.
//
// The masking-driven quantizer produces near-geometric, zero-heavy code
// distributions — exactly what Rice coding models. Codes are zigzag-mapped
// to unsigned, grouped, and each group gets its own 4-bit Rice parameter k
// chosen to minimize its bit cost; quotients are capped with a raw-value
// escape so adversarial values cannot blow up the stream.
//
// C ABI:
//   acx_rice_encode(codes, n, group, out, cap)  -> bytes written (or <0)
//   acx_rice_decode(in, len, codes, n, group)   -> 0 on success
//   acx_rice_bound(n, group)                    -> worst-case output bytes
//   acx_rrice_encode/decode/bound               -> run-length variant
//
// The run-length variant (rrice): tonal spectra quantize to >99% zeros,
// and plain Rice pays one unary bit per zero. Each group carries a mode
// bit after its 4-bit k: mode 0 is plain Rice (identical to above);
// mode 1 alternates Elias-gamma zero-run lengths with Rice-coded
// nonzero magnitudes (u-1). The encoder costs both and picks per group,
// so rrice is never meaningfully larger than rice and is ~2-6x smaller
// pre-deflate on sparse content (measured).
//
// Performance notes (the wire format is unchanged from the original
// bit-at-a-time version — MSB-first bits, 4-bit k headers, identical
// escape rule; committed golden containers keep decoding):
// * Bit I/O runs through 64-bit accumulators: the writer emits each
//   Rice symbol (unary + stop + remainder, <= 63 bits) in at most three
//   shift-or-flush calls; the reader counts unary runs with one CLZ on
//   the refilled window instead of a per-bit loop.
// * The per-group Rice parameter uses the FLAC-style closed form
//   argmin_k n*(k+1) + sum(u)/2^k from ONE pass over the group
//   (the original looped 16 candidate k's over every value). The
//   estimate ignores escape overflow, which only ever costs a fraction
//   of a percent on heavy-tailed groups; any k decodes identically.
// Measured on this rig: ~6x encode, ~4x decode vs the per-bit version.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxQuotient = 47;  // cap; larger quotients escape to raw
constexpr int kEscape = kMaxQuotient + 1;

struct BitWriter {
  uint8_t* buf;
  int64_t cap;
  int64_t byte_pos = 0;
  uint64_t acc = 0;  // pending bits, LSB-aligned; nbits < 8 between calls
  int nbits = 0;
  bool overflow = false;

  // n <= 56 (with nbits < 8 the shift never drops pending bits)
  inline void put_bits(uint64_t v, int n) {
    if (overflow) return;
    acc = (acc << n) | (v & ((1ull << n) - 1ull));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      if (byte_pos >= cap) {
        overflow = true;
        nbits &= 7;
        return;
      }
      buf[byte_pos++] = static_cast<uint8_t>(acc >> nbits);
    }
  }
  inline void put_ones(int q) {  // q one-bits (no stop bit)
    while (q > 32) {
      put_bits(0xFFFFFFFFull, 32);
      q -= 32;
    }
    if (q > 0) put_bits((1ull << q) - 1ull, q);
  }
  int64_t finish() {
    if (nbits) {
      if (byte_pos >= cap) {
        overflow = true;
      } else {
        buf[byte_pos++] = static_cast<uint8_t>(
            (acc & ((1ull << nbits) - 1ull)) << (8 - nbits));
      }
      nbits = 0;
    }
    if (overflow) return -1;
    return byte_pos;
  }
};

struct BitReader {
  const uint8_t* buf;
  int64_t len;
  int64_t byte_pos = 0;
  uint64_t acc = 0;  // low nbits hold unread bits (stale bits above them)
  int nbits = 0;
  bool underflow = false;

  inline void refill() {
    while (nbits <= 56 && byte_pos < len) {
      acc = (acc << 8) | buf[byte_pos++];
      nbits += 8;
    }
  }
  inline uint64_t get_bits(int n) {  // n <= 56
    if (nbits < n) refill();
    if (nbits < n) {
      underflow = true;
      int have = nbits;
      uint64_t v = have ? (acc & ((1ull << have) - 1ull)) << (n - have) : 0;
      nbits = 0;
      return v;  // zero-padded, matching the per-bit reader's behavior
    }
    nbits -= n;
    return (acc >> nbits) & ((1ull << n) - 1ull);
  }
  // Count leading one-bits up to a stop 0 (consumed); *bad on underflow
  // or a run past `limit` (corrupt stream guard).
  inline uint32_t get_unary_ones(uint32_t limit, bool* bad) {
    uint32_t q = 0;
    for (;;) {
      if (nbits == 0) refill();
      if (nbits == 0) {
        underflow = true;
        *bad = true;
        return 0;
      }
      // valid bits MSB-aligned; below them the window is zero, so a
      // stop bit is always found within the window when present
      uint64_t window = acc << (64 - nbits);
      int ones = ~window ? __builtin_clzll(~window) : 64;
      if (ones >= nbits) {
        q += static_cast<uint32_t>(nbits);
        nbits = 0;
      } else {
        q += static_cast<uint32_t>(ones);
        nbits -= ones + 1;  // consume the run and the stop bit
        if (q > limit) {
          *bad = true;
          return 0;
        }
        return q;
      }
      if (q > limit) {
        *bad = true;
        return 0;
      }
    }
  }
  // Count leading zero-bits up to a stop 1 (consumed) — Elias gamma.
  inline uint32_t get_unary_zeros(uint32_t limit, bool* bad) {
    uint32_t z = 0;
    for (;;) {
      if (nbits == 0) refill();
      if (nbits == 0) {
        underflow = true;
        *bad = true;
        return 0;
      }
      uint64_t window = acc << (64 - nbits);
      int zeros = window ? __builtin_clzll(window) : 64;
      if (zeros >= nbits) {
        z += static_cast<uint32_t>(nbits);
        nbits = 0;
      } else {
        z += static_cast<uint32_t>(zeros);
        nbits -= zeros + 1;  // consume the zeros and the stop 1
        if (z > limit) {
          *bad = true;
          return 0;
        }
        return z;
      }
      if (z > limit) {
        *bad = true;
        return 0;
      }
    }
  }
};

inline uint32_t zigzag(int32_t v) {
  return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}
inline int32_t unzigzag(uint32_t u) {
  return static_cast<int32_t>((u >> 1) ^ (~(u & 1) + 1));
}

// FLAC-style closed-form parameter choice: one pass gave sum(u); pick
// argmin_k count*(k+1) + sum/2^k. Escape overflow is ignored (rare,
// bounded); any k decodes identically.
inline int best_k_from_sum(uint64_t sum, int64_t count) {
  int best_k = 0;
  int64_t best_cost = INT64_MAX;
  for (int k = 0; k < 16; ++k) {
    int64_t cost = count * (k + 1) + static_cast<int64_t>(sum >> k);
    if (cost < best_cost) {
      best_cost = cost;
      best_k = k;
    }
  }
  return best_k;
}

// Estimated group bits at parameter k (same model as best_k_from_sum).
inline int64_t est_cost(uint64_t sum, int64_t count, int k) {
  return count * (k + 1) + static_cast<int64_t>(sum >> k);
}

// Elias gamma bit length of x >= 1.
inline int gamma_bits(uint32_t x) {
  int n = 31 - __builtin_clz(x);
  return 2 * n + 1;
}

inline void put_gamma(BitWriter& w, uint32_t x) {
  int n = 31 - __builtin_clz(x);
  // n zeros then x's n+1 bits MSB-first == x written as 2n+1 bits
  if (2 * n + 1 <= 56) {
    w.put_bits(x, 2 * n + 1);
  } else {
    w.put_bits(0, n);
    w.put_bits(x, n + 1);
  }
}

inline uint32_t get_gamma(BitReader& r, bool* bad) {
  uint32_t n = r.get_unary_zeros(31, bad);
  if (*bad) return 0;
  uint32_t x = 1;
  if (n) x = (1u << n) | static_cast<uint32_t>(r.get_bits(static_cast<int>(n)));
  return x;
}

// Rice code one value at parameter k (shared by both modes).
inline void put_rice(BitWriter& w, uint32_t u, int k) {
  uint32_t q = u >> k;
  if (q >= static_cast<uint32_t>(kMaxQuotient)) {
    w.put_ones(kEscape);
    w.put_bits(static_cast<uint64_t>(u), 33);  // stop 0 + 32 raw bits
  } else {
    w.put_ones(static_cast<int>(q));
    // stop 0 + k remainder bits
    w.put_bits(static_cast<uint64_t>(u) & ((1ull << k) - 1ull), k + 1);
  }
}

inline uint32_t get_rice(BitReader& r, int k, bool* bad) {
  uint32_t q = r.get_unary_ones(static_cast<uint32_t>(kEscape), bad);
  if (*bad) return 0;
  if (q == static_cast<uint32_t>(kEscape))
    return static_cast<uint32_t>(r.get_bits(32));
  return (q << k) | static_cast<uint32_t>(r.get_bits(k));
}

}  // namespace

extern "C" {

int64_t acx_rice_bound(int64_t n, int64_t group) {
  int64_t groups = (n + group - 1) / group;
  // per value worst case: escape = 48 ones + stop bit + 32 raw bits
  int64_t bits = groups * 4 + n * (kEscape + 1 + 32);
  return bits / 8 + 16;
}

// idx_stride/idx_out (both optional — stride 0 / NULL disables): record
// the bit offset of every idx_stride-th value's group header into
// idx_out[i]. Strides must be multiples of `group` so every recorded
// offset lands exactly on a group boundary — that is what makes the
// offsets valid *_decode_at entry points (the decoder resynchronizes on
// a 4-bit k header there). The wire format is UNCHANGED; the index is
// carried out of band (the lossless container's `fidx` member).
int64_t acx_rice_encode_idx(const int32_t* codes, int64_t n, int64_t group,
                            uint8_t* out, int64_t cap, int64_t idx_stride,
                            uint64_t* idx_out) {
  if (idx_stride < 0 || (idx_stride > 0 && idx_stride % group != 0))
    return -3;
  BitWriter w{out, cap};
  for (int64_t g = 0; g < n; g += group) {
    int64_t end = g + group < n ? g + group : n;
    if (idx_out && idx_stride > 0 && g % idx_stride == 0)
      idx_out[g / idx_stride] =
          static_cast<uint64_t>(w.byte_pos) * 8u + w.nbits;
    uint64_t sum = 0;
    for (int64_t i = g; i < end; ++i) sum += zigzag(codes[i]);
    int best_k = best_k_from_sum(sum, end - g);
    w.put_bits(static_cast<uint64_t>(best_k), 4);
    for (int64_t i = g; i < end; ++i) put_rice(w, zigzag(codes[i]), best_k);
  }
  return w.finish();
}

int64_t acx_rice_encode(const int32_t* codes, int64_t n, int64_t group,
                        uint8_t* out, int64_t cap) {
  return acx_rice_encode_idx(codes, n, group, out, cap, 0, nullptr);
}

// Decode n values starting at bit offset start_bit (must be a group
// boundary recorded by the encoder's index; an arbitrary offset decodes
// garbage, which the caller's bounds/CRC checks reject — it can never
// read out of bounds or loop).
int32_t acx_rice_decode_at(const uint8_t* in, int64_t len, uint64_t start_bit,
                           int32_t* codes, int64_t n, int64_t group) {
  if (start_bit > static_cast<uint64_t>(len) * 8u) return -2;
  BitReader r{in, len};
  r.byte_pos = static_cast<int64_t>(start_bit >> 3);
  if (start_bit & 7u) r.get_bits(static_cast<int>(start_bit & 7u));
  bool bad = false;
  for (int64_t g = 0; g < n; g += group) {
    int64_t end = g + group < n ? g + group : n;
    int k = static_cast<int>(r.get_bits(4));
    for (int64_t i = g; i < end; ++i) {
      uint32_t u = get_rice(r, k, &bad);
      if (bad) return -2;
      codes[i] = unzigzag(u);
    }
    if (r.underflow) return -2;
  }
  return 0;
}

int32_t acx_rice_decode(const uint8_t* in, int64_t len, int32_t* codes,
                        int64_t n, int64_t group) {
  return acx_rice_decode_at(in, len, 0, codes, n, group);
}

int64_t acx_rrice_bound(int64_t n, int64_t group) {
  // plain mode is always available per group, so the bound is the rice
  // bound plus one mode bit per group
  int64_t groups = (n + group - 1) / group;
  return acx_rice_bound(n, group) + groups / 8 + 16;
}

int64_t acx_rrice_encode_idx(const int32_t* codes, int64_t n, int64_t group,
                             uint8_t* out, int64_t cap, int64_t idx_stride,
                             uint64_t* idx_out) {
  if (idx_stride < 0 || (idx_stride > 0 && idx_stride % group != 0))
    return -3;
  BitWriter w{out, cap};
  for (int64_t g = 0; g < n; g += group) {
    int64_t end = g + group < n ? g + group : n;
    if (idx_out && idx_stride > 0 && g % idx_stride == 0)
      idx_out[g / idx_stride] =
          static_cast<uint64_t>(w.byte_pos) * 8u + w.nbits;

    // ONE pass: plain-mode zigzag sum, rle-mode gamma run bits + the
    // nonzero magnitudes' (u-1) sum
    uint64_t plain_sum = 0;
    int64_t run_cost = 0;
    int64_t run = 0;
    int64_t nz = 0;
    uint64_t nz_sum = 0;
    for (int64_t i = g; i < end; ++i) {
      uint32_t u = zigzag(codes[i]);
      plain_sum += u;
      if (u == 0) {
        ++run;
        continue;
      }
      run_cost += gamma_bits(static_cast<uint32_t>(run) + 1u);
      run = 0;
      ++nz;
      nz_sum += u - 1u;
    }
    if (run > 0) run_cost += gamma_bits(static_cast<uint32_t>(run) + 1u);

    int plain_k = best_k_from_sum(plain_sum, end - g);
    int rle_k = nz ? best_k_from_sum(nz_sum, nz) : 0;
    int64_t plain_cost = est_cost(plain_sum, end - g, plain_k);
    int64_t rle_cost = run_cost + (nz ? est_cost(nz_sum, nz, rle_k) : 0);

    if (rle_cost < plain_cost) {
      w.put_bits(static_cast<uint64_t>(rle_k), 4);
      w.put_bits(1, 1);
      int64_t i = g;
      while (i < end) {
        int64_t r0 = i;
        while (i < end && codes[i] == 0) ++i;
        put_gamma(w, static_cast<uint32_t>(i - r0) + 1u);
        if (i < end) {
          put_rice(w, zigzag(codes[i]) - 1u, rle_k);
          ++i;
        }
      }
      // alternation invariant: a (possibly zero-length) run token
      // precedes EVERY value and one final run token covers trailing
      // zeros; the decoder stops at the group boundary, so a group
      // ending in a nonzero needs no trailing token
    } else {
      w.put_bits(static_cast<uint64_t>(plain_k), 4);
      w.put_bits(0, 1);
      for (int64_t i = g; i < end; ++i) put_rice(w, zigzag(codes[i]), plain_k);
    }
  }
  return w.finish();
}

int64_t acx_rrice_encode(const int32_t* codes, int64_t n, int64_t group,
                         uint8_t* out, int64_t cap) {
  return acx_rrice_encode_idx(codes, n, group, out, cap, 0, nullptr);
}

// ---- LPC predictor filters (lossless.py level-2 "max" tier) ----------------
//
// FLAC-style quantized-LPC prediction: pred[t] = (sum_j qcoef[j] *
// x[t-1-j]) >> shift with an int64 accumulator (a 15-bit coefficient
// times a 25-bit mid/side sample times order 32 needs ~45 bits — the
// reason this runs in C++ and not in the no-x64 JAX default). The
// first `p` warmup slots store x[0] raw and first differences, so every
// frame remains self-contained (no neighbor context), matching the
// fixed-predictor frames' decode independence.
//
// Batched over frames*channels: x/res are [frames, n, channels] in
// C-order sample-major per frame; qcoef is [frames, p, channels].
// Returns 0, or -1 on invalid args.

static inline int64_t sar64(int64_t v, int s) {
  // arithmetic shift right, defined for negative v
  return v >> s;
}

int32_t acx_lpc_residual(const int32_t* x, int64_t frames, int64_t n,
                         int64_t channels, const int32_t* qcoef, int64_t p,
                         int32_t shift, int32_t* res) {
  if (p < 1 || p > 32 || shift < 0 || shift > 31 || n <= p) return -1;
  for (int64_t f = 0; f < frames; ++f) {
    for (int64_t c = 0; c < channels; ++c) {
      const int32_t* xf = x + (f * n) * channels + c;
      const int32_t* cf = qcoef + (f * p) * channels + c;
      int32_t* rf = res + (f * n) * channels + c;
      rf[0] = xf[0];
      for (int64_t t = 1; t < p; ++t)
        rf[t * channels] = xf[t * channels] - xf[(t - 1) * channels];
      for (int64_t t = p; t < n; ++t) {
        int64_t acc = 0;
        for (int64_t j = 0; j < p; ++j)
          acc += static_cast<int64_t>(cf[j * channels]) *
                 static_cast<int64_t>(xf[(t - 1 - j) * channels]);
        rf[t * channels] = static_cast<int32_t>(
            static_cast<int64_t>(xf[t * channels]) - sar64(acc, shift));
      }
    }
  }
  return 0;
}

int32_t acx_lpc_reconstruct(const int32_t* res, int64_t frames, int64_t n,
                            int64_t channels, const int32_t* qcoef, int64_t p,
                            int32_t shift, int32_t* x) {
  if (p < 1 || p > 32 || shift < 0 || shift > 31 || n <= p) return -1;
  for (int64_t f = 0; f < frames; ++f) {
    for (int64_t c = 0; c < channels; ++c) {
      const int32_t* rf = res + (f * n) * channels + c;
      const int32_t* cf = qcoef + (f * p) * channels + c;
      int32_t* xf = x + (f * n) * channels + c;
      xf[0] = rf[0];
      for (int64_t t = 1; t < p; ++t)
        xf[t * channels] = xf[(t - 1) * channels] + rf[t * channels];
      for (int64_t t = p; t < n; ++t) {
        int64_t acc = 0;
        for (int64_t j = 0; j < p; ++j)
          acc += static_cast<int64_t>(cf[j * channels]) *
                 static_cast<int64_t>(xf[(t - 1 - j) * channels]);
        // int64 sum then cast: tampered coefficients can push the
        // prediction past int32 and a plain int32 add would be UB; the
        // cast wraps and the caller's bit-depth bounds check rejects it
        xf[t * channels] = static_cast<int32_t>(
            static_cast<int64_t>(rf[t * channels]) + sar64(acc, shift));
      }
    }
  }
  return 0;
}

// ---- LPC analysis (lossless.py level-2 order search) ------------------------
//
// The whole FLAC "-8"-class analysis for one file in one call: per
// (frame, channel) it windows the samples (Hann and optionally
// Tukey-0.5), computes the autocorrelation, runs Levinson-Durbin once
// up to max_order harvesting EVERY intermediate order's prediction
// error (the order search is free — each order's error is a recursion
// by-product), scores each order with the same Rice bit model the
// device selector uses plus the 16-bit/coefficient storage cost, then
// quantizes the winning predictor with a per-frame adaptive shift
// (FLAC's qlp precision scheme), derives the EXACT integer residual,
// and only replaces the fixed-ladder wire run when the exact residual's
// estimated bits beat the fixed ladder's by `margin`. Doubles
// throughout the fit; exactness comes from the integer filter, whose
// quantized coefficients ship in the container.
//
// This lives in C++ because on a few-core host the float64 numpy
// version of just the autocorrelation was the entire level-2 encode
// bottleneck (~3x the cost of everything else combined); here the
// windowing + 27-lag autocorrelation vectorizes to a few microseconds
// per frame.

static double rice_bits_from_sum(double sumu, double count) {
  // min_p count*(p+1) + sumu/2^p — the shared order-selection model
  double best = 1e300;
  double scale = 1.0;
  for (int p = 0; p < 18; ++p) {
    double b = count * (p + 1) + sumu * scale;
    if (b < best) best = b;
    scale *= 0.5;
  }
  return best;
}

static void levinson_search(const double* r, int max_order, double n,
                            double wsq, double* best_bits, int* best_m,
                            double* best_a) {
  double a[32], prev[32];
  double e = r[0];
  if (e <= 0.0) return;  // digital silence under this window
  for (int m = 0; m < max_order; ++m) {
    double acc = r[m + 1];
    for (int j = 0; j < m; ++j) acc -= a[j] * r[m - j];
    double k = e > 1e-30 ? acc / e : 0.0;
    if (k > 0.999999) k = 0.999999;
    if (k < -0.999999) k = -0.999999;
    for (int j = 0; j < m; ++j) prev[j] = a[j];
    a[m] = k;
    for (int j = 0; j < m; ++j) a[j] = prev[j] - k * prev[m - 1 - j];
    e *= 1.0 - k * k;
    // expected zigzag sum of a Gaussian residual: 2*E|r|*n with
    // E|r| = sigma*sqrt(2/pi); sigma from the windowed error energy
    double sigma = std::sqrt((e > 0.0 ? e : 0.0) / wsq);
    double est = rice_bits_from_sum(1.5957691216057308 * sigma * n, n) +
                 16.0 * (m + 1) + 16.0;
    if (est < *best_bits) {
      *best_bits = est;
      *best_m = m + 1;
      for (int j = 0; j <= m; ++j) best_a[j] = a[j];
    }
  }
}

// Per-(frame, slot) scratch shared by the level-2 encode loop.
struct LpcWork {
  std::vector<double> d, dw, wbuf, wsq;
  std::vector<int32_t> xi, res, tmp;
  std::vector<int64_t> acc;
  int n_windows = 0;

  void init(int64_t n, int n_win) {
    d.resize(n);
    dw.resize(n);
    xi.resize(n);
    res.resize(n);
    tmp.resize(n);
    acc.resize(n);
    n_windows = n_win;
    const double pi = 3.14159265358979323846;
    wbuf.resize(static_cast<size_t>(n_win) * n);
    wsq.resize(n_win);
    for (int wi = 0; wi < n_win; ++wi) {
      double* w = wbuf.data() + static_cast<size_t>(wi) * n;
      if (wi == 0) {  // Hann (np.hanning's symmetric form)
        for (int64_t i = 0; i < n; ++i)
          w[i] = 0.5 - 0.5 * std::cos(2.0 * pi * i / (n - 1));
      } else {  // Tukey alpha=0.5: cosine taper over n/4 on each side
        int64_t taper = n / 4;
        for (int64_t i = 0; i < n; ++i) w[i] = 1.0;
        for (int64_t i = 0; i < taper; ++i) {
          double v = 0.5 - 0.5 * std::cos(pi * i / taper);
          w[i] = v;
          w[n - 1 - i] = v;
        }
      }
      double s = 0.0;
      for (int64_t i = 0; i < n; ++i) s += w[i] * w[i];
      wsq[wi] = s > 1e-12 ? s : 1e-12;
    }
  }
};

// Fixed-ladder residual with progressive warmup heads: out[j] holds the
// j-th difference's first element for j < k, out[k..] the k-th
// difference body — the exact layout the device selector builds
// (lossless.py _select) and the shared integrator decodes.
static void fixed_residual(const int32_t* xi, int64_t n, int k, int32_t* out,
                           int32_t* tmp) {
  std::memcpy(out, xi, static_cast<size_t>(n) * sizeof(int32_t));
  for (int j = 0; j < k; ++j) {
    // snapshot-subtract (vectorizes; the in-place descending form is a
    // false dependence no compiler untangles)
    std::memcpy(tmp, out, static_cast<size_t>(n) * sizeof(int32_t));
    for (int64_t t = j + 1; t < n; ++t) out[t] = tmp[t] - tmp[t - 1];
  }
}

// Score all five fixed-predictor ladders of one contiguous frame
// EXACTLY (full-frame zigzag sums, not the device selector's sampled
// chunks) with the shared min_p n(p+1)+sum/2^p model.
static void fixed_score_frame(const int32_t* xi, int64_t n, int32_t* tmp,
                              int32_t* tmp2, int* best_k, double* best_bits) {
  std::memcpy(tmp, xi, static_cast<size_t>(n) * sizeof(int32_t));
  double head_acc = 0.0;
  *best_bits = 1e300;
  *best_k = 0;
  for (int k = 0; k <= 4; ++k) {
    if (k) {
      // snapshot-subtract so the diff pass vectorizes
      std::memcpy(tmp2, tmp, static_cast<size_t>(n) * sizeof(int32_t));
      for (int64_t t = k; t < n; ++t) tmp[t] = tmp2[t] - tmp2[t - 1];
    }
    uint64_t s = 0;
    for (int64_t t = k; t < n; ++t) {
      const int64_t v = tmp[t];
      s += static_cast<uint64_t>(v < 0 ? -v : v);
    }
    double bits = rice_bits_from_sum(2.0 * (head_acc + s),
                                     static_cast<double>(n));
    if (bits < *best_bits) {
      *best_bits = bits;
      *best_k = k;
    }
    head_acc += std::fabs(static_cast<double>(tmp[k]));
  }
}

// Fill one contiguous candidate-channel frame. Candidate meaning when
// stereo4: 0 = left, 1 = right, 2 = mid ((l+r)>>1), 3 = side (l-r) —
// the same stored-channel alphabet as the device selector; otherwise
// the candidate IS the channel index.
static void fill_candidate(const int32_t* xf, int64_t n, int64_t channels,
                           int stereo4, int cand, int32_t* xi) {
  if (!stereo4) {
    for (int64_t i = 0; i < n; ++i) xi[i] = xf[i * channels + cand];
    return;
  }
  const int32_t* lp = xf;
  const int32_t* rp = xf + 1;
  switch (cand) {
    case 0:
      for (int64_t i = 0; i < n; ++i) xi[i] = lp[i * 2];
      break;
    case 1:
      for (int64_t i = 0; i < n; ++i) xi[i] = rp[i * 2];
      break;
    case 2:
      for (int64_t i = 0; i < n; ++i) xi[i] = (lp[i * 2] + rp[i * 2]) >> 1;
      break;
    default:
      for (int64_t i = 0; i < n; ++i) xi[i] = lp[i * 2] - rp[i * 2];
      break;
  }
}

// LPC candidate for one frame: windowed autocorrelation (per window),
// Levinson order search, adaptive-shift quantization, exact integer
// residual, exact-bit competition against the fixed residual already
// in `run`. Overwrites `run` and returns true when LPC wins.
static bool lpc_try(int64_t n, int max_order, int precision, double margin,
                    LpcWork& wk, int32_t* run, int32_t* order_out,
                    int32_t* shift_out, int32_t* q_out, double* saved) {
  const int32_t* xi = wk.xi.data();
  for (int64_t i = 0; i < n; ++i) wk.d[i] = static_cast<double>(xi[i]);
  double best_bits = 1e300;
  int best_m = 0;
  double best_a[32], cand_a[32];
  for (int wi = 0; wi < wk.n_windows; ++wi) {
    const double* w = wk.wbuf.data() + static_cast<size_t>(wi) * n;
    for (int64_t i = 0; i < n; ++i) wk.dw[i] = wk.d[i] * w[i];
    double r[33];
    for (int k = 0; k <= max_order; ++k) {
      // 8 independent accumulators: a single-accumulator dot is
      // FMA-latency-bound and GCC won't reassociate FP reductions
      // without fast-math (which would make encode decisions
      // build-flag-dependent); this fixed-order form is exact,
      // deterministic, and vectorizes to one SIMD lane-set
      const double* pa = wk.dw.data() + k;
      const double* pb = wk.dw.data();
      const int64_t m = n - k;
      double s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      double s4 = 0, s5 = 0, s6 = 0, s7 = 0;
      int64_t i = 0;
      for (; i + 8 <= m; i += 8) {
        s0 += pa[i] * pb[i];
        s1 += pa[i + 1] * pb[i + 1];
        s2 += pa[i + 2] * pb[i + 2];
        s3 += pa[i + 3] * pb[i + 3];
        s4 += pa[i + 4] * pb[i + 4];
        s5 += pa[i + 5] * pb[i + 5];
        s6 += pa[i + 6] * pb[i + 6];
        s7 += pa[i + 7] * pb[i + 7];
      }
      double s = ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7));
      for (; i < m; ++i) s += pa[i] * pb[i];
      r[k] = s;
    }
    double cb = 1e300;
    int cm = 0;
    levinson_search(r, max_order, static_cast<double>(n), wk.wsq[wi], &cb,
                    &cm, cand_a);
    if (cb < best_bits) {
      best_bits = cb;
      best_m = cm;
      for (int j = 0; j < cm; ++j) best_a[j] = cand_a[j];
    }
  }
  if (best_m < 1) return false;
  double amax = 0.0;
  for (int j = 0; j < best_m; ++j) {
    double v = std::fabs(best_a[j]);
    if (v > amax) amax = v;
  }
  if (!(amax > 0.0)) return false;
  const int32_t qmax = (1 << precision) - 1;
  int shift = static_cast<int>(std::floor(std::log2(qmax / amax)));
  if (shift > 15) shift = 15;
  if (shift < 0) return false;  // wildly unstable fit: keep the ladder
  const int p = best_m;
  int32_t q[32];
  for (int j = 0; j < p; ++j) {
    long qq = std::lround(best_a[j] * static_cast<double>(1 << shift));
    if (qq > qmax) qq = qmax;
    if (qq < -qmax - 1) qq = -qmax - 1;
    q[j] = static_cast<int32_t>(qq);
  }
  int32_t* res = wk.res.data();
  int64_t* acc = wk.acc.data();
  res[0] = xi[0];
  for (int64_t t = 1; t < p; ++t) res[t] = xi[t] - xi[t - 1];
  // tap-major accumulation: each tap's pass over acc[] is independent
  // per t and vectorizes; the sample-major form is a p-deep serial
  // int64 chain per sample
  std::fill(acc + p, acc + n, static_cast<int64_t>(0));
  for (int j = 0; j < p; ++j) {
    const int64_t qj = q[j];
    const int32_t* src = xi + (p - 1 - j);
    int64_t* dst = acc + p;
    const int64_t m = n - p;
    for (int64_t t = 0; t < m; ++t)
      dst[t] += qj * static_cast<int64_t>(src[t]);
  }
  for (int64_t t = p; t < n; ++t)
    res[t] = static_cast<int32_t>(static_cast<int64_t>(xi[t]) -
                                  sar64(acc[t], shift));
  uint64_t lsum = 0;
  for (int64_t i = 0; i < n; ++i) lsum += zigzag(res[i]);
  const double lpc_bits =
      rice_bits_from_sum(static_cast<double>(lsum), static_cast<double>(n));
  uint64_t fsum = 0;
  for (int64_t i = 0; i < n; ++i) fsum += zigzag(run[i]);
  const double fixed_bits =
      rice_bits_from_sum(static_cast<double>(fsum), static_cast<double>(n));
  const double coef_cost = 16.0 * p + 16.0;
  if (lpc_bits + coef_cost + margin >= fixed_bits) return false;
  std::memcpy(run, res, static_cast<size_t>(n) * sizeof(int32_t));
  *order_out = p;
  *shift_out = shift;
  for (int j = 0; j < p; ++j) q_out[j] = q[j];
  *saved = fixed_bits - lpc_bits - coef_cost;
  return true;
}

// Exact fixed-ladder scores for every candidate channel of every frame.
// Cc = 4 candidates (l, r, mid, side) when stereo4, else `channels`.
int32_t acx_lossless_score(const int32_t* x, int64_t frames, int64_t n,
                           int64_t channels, int32_t stereo4, int32_t* orders,
                           double* bits) {
  if (n < 8 || frames < 0 || channels < 1) return -1;
  if (stereo4 && channels != 2) return -1;
  const int64_t cc = stereo4 ? 4 : channels;
  std::vector<int32_t> xi(n), tmp(n), tmp2(n);
  for (int64_t f = 0; f < frames; ++f) {
    const int32_t* xf = x + (f * n) * channels;
    for (int64_t c = 0; c < cc; ++c) {
      fill_candidate(xf, n, channels, stereo4, static_cast<int>(c),
                     xi.data());
      int bk;
      double bb;
      fixed_score_frame(xi.data(), n, tmp.data(), tmp2.data(), &bk, &bb);
      orders[f * cc + c] = bk;
      bits[f * cc + c] = bb;
    }
  }
  return 0;
}

// Level-2 encode core: build each stored slot's fixed-ladder residual
// at its chosen order directly into the wire layout, then (when do_lpc)
// run the LPC candidate and keep the per-(frame, slot) winner. The
// device selector is not involved at level 2 — the whole analysis is
// an exact, host-bound pass, which is also what makes the level-2
// encode deterministic across devices.
int32_t acx_l2_encode(const int32_t* x, int64_t frames, int64_t n,
                      int64_t channels, int32_t stereo4, const int32_t* idx,
                      const int32_t* fixed_orders, int32_t do_lpc,
                      int32_t max_order, int32_t precision, int32_t n_windows,
                      double margin, int32_t* wire, int32_t* lorders,
                      int32_t* lshifts, int32_t* qcoef, double* savings) {
  if (max_order < 1 || max_order > 32 || n <= max_order + 1 ||
      precision < 2 || precision > 15 || n_windows < 1 || n_windows > 2)
    return -1;
  if (stereo4 && channels != 2) return -1;
  const int64_t slots = stereo4 ? 2 : channels;
  LpcWork wk;
  wk.init(n, n_windows);
  double total_saved = 0.0;
  for (int64_t f = 0; f < frames; ++f) {
    const int32_t* xf = x + (f * n) * channels;
    for (int64_t p = 0; p < slots; ++p) {
      const int cand =
          stereo4 ? static_cast<int>(idx[f * slots + p]) : static_cast<int>(p);
      if (cand < 0 || cand >= (stereo4 ? 4 : channels)) return -1;
      const int k = static_cast<int>(fixed_orders[f * slots + p]);
      if (k < 0 || k > 4) return -1;
      fill_candidate(xf, n, channels, stereo4, cand, wk.xi.data());
      int32_t* run = wire + (f * slots + p) * n;
      fixed_residual(wk.xi.data(), n, k, run, wk.tmp.data());
      lorders[f * slots + p] = 0;
      if (do_lpc) {
        int32_t po = 0, ps = 0, q[32];
        double saved = 0.0;
        if (lpc_try(n, max_order, precision, margin, wk, run, &po, &ps, q,
                    &saved)) {
          lorders[f * slots + p] = po;
          lshifts[f * slots + p] = ps;
          for (int j = 0; j < po; ++j)
            qcoef[(f * max_order + j) * slots + p] = q[j];
          total_saved += saved;
        }
      }
    }
  }
  *savings = total_saved;
  return 0;
}

// Variable-order decode-side filter over the container's wire layout:
// residual run (f, c) is contiguous at wire[(f*C + c)*n]; output is
// sample-major [F*n, C]. Entries with orders == 0 are skipped (the
// device integrator already produced those samples). Returns 0, or -1
// on out-of-range order/shift (the container-validation contract).
int32_t acx_lpc_reconstruct_wire(const int32_t* wire, int64_t frames,
                                 int64_t n, int64_t channels,
                                 const int32_t* orders, const int32_t* shifts,
                                 const int32_t* qcoef, int64_t max_order,
                                 int32_t* x) {
  if (max_order < 1 || max_order > 32 || n <= max_order) return -1;
  std::vector<int32_t> xs(n);
  for (int64_t f = 0; f < frames; ++f) {
    for (int64_t c = 0; c < channels; ++c) {
      const int p = orders[f * channels + c];
      if (p == 0) continue;
      const int shift = shifts[f * channels + c];
      if (p < 1 || p > max_order || shift < 0 || shift > 31) return -1;
      const int32_t* run = wire + (f * channels + c) * n;
      int32_t q[32];
      for (int j = 0; j < p; ++j)
        q[j] = qcoef[(f * max_order + j) * channels + c];
      xs[0] = run[0];
      for (int64_t t = 1; t < p; ++t) xs[t] = xs[t - 1] + run[t];
      for (int64_t t = p; t < n; ++t) {
        int64_t acc = 0;
        for (int j = 0; j < p; ++j)
          acc += static_cast<int64_t>(q[j]) * static_cast<int64_t>(xs[t - 1 - j]);
        // int64 sum then wrapping cast: tampered coefficients cannot hit
        // UB; the caller's bit-depth bounds check rejects the result
        xs[t] = static_cast<int32_t>(static_cast<int64_t>(run[t]) +
                                     sar64(acc, shift));
      }
      int32_t* xo = x + f * n * channels + c;
      for (int64_t t = 0; t < n; ++t) xo[t * channels] = xs[t];
    }
  }
  return 0;
}

int32_t acx_rrice_decode_at(const uint8_t* in, int64_t len,
                            uint64_t start_bit, int32_t* codes, int64_t n,
                            int64_t group) {
  if (start_bit > static_cast<uint64_t>(len) * 8u) return -2;
  BitReader r{in, len};
  r.byte_pos = static_cast<int64_t>(start_bit >> 3);
  if (start_bit & 7u) r.get_bits(static_cast<int>(start_bit & 7u));
  bool bad = false;
  for (int64_t g = 0; g < n; g += group) {
    int64_t end = g + group < n ? g + group : n;
    int k = static_cast<int>(r.get_bits(4));
    uint32_t mode = static_cast<uint32_t>(r.get_bits(1));
    if (r.underflow) return -2;
    if (mode == 0u) {
      for (int64_t i = g; i < end; ++i) {
        uint32_t u = get_rice(r, k, &bad);
        if (bad) return -2;
        codes[i] = unzigzag(u);
      }
    } else {
      int64_t i = g;
      while (i < end) {
        uint32_t runp1 = get_gamma(r, &bad);
        if (bad || runp1 == 0u) return -2;
        int64_t run = static_cast<int64_t>(runp1) - 1;
        if (run > end - i) return -2;
        for (int64_t z = 0; z < run; ++z) codes[i++] = 0;
        if (i < end) {
          uint32_t um1 = get_rice(r, k, &bad);
          if (bad) return -2;
          codes[i++] = unzigzag(um1 + 1u);
        }
      }
    }
    if (r.underflow) return -2;
  }
  return 0;
}

int32_t acx_rrice_decode(const uint8_t* in, int64_t len, int32_t* codes,
                         int64_t n, int64_t group) {
  return acx_rrice_decode_at(in, len, 0, codes, n, group);
}

}  // extern "C"
