// Native WAV decode + corpus framing loader.
//
// The compute path is PyTorch and the hand-written CUDA kernels on the GPU;
// this is the host-side runtime around it: decoding WAV clips into the
// framework's [clips, samples, channels] float32 tensor convention, and
// writing them back, fast enough to keep a card fed. A byte-for-byte copy
// of the JAX package's wavio.cpp, so that both packages read and write the
// same samples; the port builds and binds it on its own.
//
// Exposed C ABI (ctypes):
//   acx_decode_wav(path, out, capacity, &sample_rate, &channels, &samples)
//   acx_load_corpus(paths, n_paths, out, clip_samples, channels, n_threads)
//   acx_write_wav(path, data, samples, channels, sample_rate, width)
//
// Supported formats: PCM 16/24/32-bit and IEEE float32, any channel count.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  const uint8_t* data = nullptr;  // points into file buffer
  size_t data_len = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Parse RIFF/WAVE headers. Returns 0 on success.
int parse_wav(const uint8_t* buf, size_t len, WavInfo* info) {
  if (len < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0) {
    return -2;  // not a wav
  }
  size_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const uint8_t* hdr = buf + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > len) chunk_len = static_cast<uint32_t>(len - pos - 8);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      info->format = rd_u16(body);
      if (info->format == 0xFFFE && chunk_len >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: first two bytes of the SubFormat GUID
        info->format = rd_u16(body + 24);
      }
      info->channels = rd_u16(body + 2);
      info->sample_rate = rd_u32(body + 4);
      info->bits = rd_u16(body + 14);
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      info->data = body;
      info->data_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!have_fmt || info->data == nullptr) return -3;
  if (info->channels == 0 || info->bits == 0) return -3;
  bool ok = (info->format == 1 &&
             (info->bits == 16 || info->bits == 24 || info->bits == 32)) ||
            (info->format == 3 && info->bits == 32);
  return ok ? 0 : -4;  // unsupported encoding
}

// Decode interleaved samples to normalized float32. Returns frames decoded.
int64_t decode_samples(const WavInfo& info, float* out, int64_t max_frames) {
  const int bytes_per = info.bits / 8;
  const int64_t frames_avail =
      static_cast<int64_t>(info.data_len) / (bytes_per * info.channels);
  const int64_t frames = frames_avail < max_frames ? frames_avail : max_frames;
  const int64_t values = frames * info.channels;
  const uint8_t* p = info.data;

  if (info.format == 3) {  // float32
    std::memcpy(out, p, static_cast<size_t>(values) * 4);
    return frames;
  }
  if (info.bits == 16) {
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < values; ++i) {
      int16_t v;
      std::memcpy(&v, p + i * 2, 2);
      out[i] = static_cast<float>(v) * kScale;
    }
  } else if (info.bits == 24) {
    constexpr float kScale = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < values; ++i) {
      const uint8_t* s = p + i * 3;
      int32_t v = static_cast<int32_t>(s[0]) | (static_cast<int32_t>(s[1]) << 8) |
                  (static_cast<int32_t>(s[2]) << 16);
      if (v & 0x800000) v -= 0x1000000;
      out[i] = static_cast<float>(v) * kScale;
    }
  } else {  // 32-bit PCM
    constexpr float kScale = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < values; ++i) {
      int32_t v;
      std::memcpy(&v, p + i * 4, 4);
      out[i] = static_cast<float>(v) * kScale;
    }
  }
  return frames;
}

// Decode interleaved samples straight to int16 wire values (the PCM16
// scale the device-side dequant divides by 32768). For PCM16 sources this
// is a straight copy — no float round trip at all. Wider formats MIRROR
// the float re-quantization path bit-exactly (decode to float32, scale by
// 32768, round half-to-even like np.rint, clip): the same corpus must
// encode to the same bitstream whether or not the C++ library built, and
// identically to the pre-direct-decode releases. All the float32
// intermediates below are exact (power-of-two scalings of <=24-bit
// integers), so only the final nearbyintf rounds — in the default
// to-nearest-even mode, matching np.rint. NaN samples map to 0 (defined,
// where a raw int cast would be UB).
int64_t decode_samples_i16(const WavInfo& info, int16_t* out,
                           int64_t max_frames) {
  const int bytes_per = info.bits / 8;
  const int64_t frames_avail =
      static_cast<int64_t>(info.data_len) / (bytes_per * info.channels);
  const int64_t frames = frames_avail < max_frames ? frames_avail : max_frames;
  const int64_t values = frames * info.channels;
  const uint8_t* p = info.data;

  auto to_i16 = [](float f) -> int16_t {
    float r = std::nearbyintf(f * 32768.0f);
    if (std::isnan(r)) return 0;
    if (r > 32767.0f) return 32767;
    if (r < -32768.0f) return -32768;
    return static_cast<int16_t>(r);
  };

  if (info.format == 3) {  // float32 in [-1, 1]
    for (int64_t i = 0; i < values; ++i) {
      float f;
      std::memcpy(&f, p + i * 4, 4);
      out[i] = to_i16(f);
    }
  } else if (info.bits == 16) {
    std::memcpy(out, p, static_cast<size_t>(values) * 2);
  } else if (info.bits == 24) {
    constexpr float kScale = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < values; ++i) {
      const uint8_t* s = p + i * 3;
      int32_t v = static_cast<int32_t>(s[0]) | (static_cast<int32_t>(s[1]) << 8) |
                  (static_cast<int32_t>(s[2]) << 16);
      if (v & 0x800000) v -= 0x1000000;
      out[i] = to_i16(static_cast<float>(v) * kScale);
    }
  } else {  // 32-bit PCM
    constexpr float kScale = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < values; ++i) {
      int32_t v;
      std::memcpy(&v, p + i * 4, 4);
      out[i] = to_i16(static_cast<float>(v) * kScale);
    }
  }
  return frames;
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(f);
    return -1;
  }
  buf->resize(static_cast<size_t>(size));
  size_t got = std::fread(buf->data(), 1, buf->size(), f);
  std::fclose(f);
  return got == buf->size() ? 0 : -1;
}

// Shared corpus loader over the output sample type: decode n_paths files
// in parallel into out[n_paths, clip_frames, channels] (row-major). Each
// clip is truncated or zero-padded to exactly clip_frames.
template <typename T>
int64_t load_corpus_generic(const char** paths, int64_t n_paths, T* out,
                            int64_t clip_frames, int32_t channels,
                            int32_t n_threads, int32_t* status,
                            int64_t (*decode)(const WavInfo&, T*, int64_t)) {
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<int64_t> next(0), ok_count(0);
  const int64_t clip_values = clip_frames * channels;

  auto worker = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_paths) break;
      T* dst = out + i * clip_values;
      std::memset(dst, 0, static_cast<size_t>(clip_values) * sizeof(T));
      buf.clear();
      if (read_file(paths[i], &buf) != 0) {
        status[i] = -1;
        continue;
      }
      WavInfo info;
      int rc = parse_wav(buf.data(), buf.size(), &info);
      if (rc != 0) {
        status[i] = rc;
        continue;
      }
      if (static_cast<int32_t>(info.channels) != channels) {
        status[i] = -5;  // channel mismatch
        continue;
      }
      decode(info, dst, clip_frames);
      status[i] = 0;
      ok_count.fetch_add(1);
    }
  };

  std::vector<std::thread> pool;
  int32_t threads = n_threads < n_paths ? n_threads
                                        : static_cast<int32_t>(n_paths);
  pool.reserve(static_cast<size_t>(threads));
  for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

}  // namespace

extern "C" {

// Decode one wav file into out[capacity] float32 (interleaved).
// Returns 0 on success; fills sample_rate/channels/frames.
int acx_decode_wav(const char* path, float* out, int64_t capacity_frames,
                   int32_t* sample_rate, int32_t* channels, int64_t* frames) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf) != 0) return -1;
  WavInfo info;
  int rc = parse_wav(buf.data(), buf.size(), &info);
  if (rc != 0) return rc;
  *sample_rate = static_cast<int32_t>(info.sample_rate);
  *channels = static_cast<int32_t>(info.channels);
  *frames = decode_samples(info, out, capacity_frames);
  return 0;
}

// Bulk-load a corpus: decode n_paths files in parallel into
// out[n_paths, clip_frames, channels] (row-major float32). Each clip is
// truncated or zero-padded to exactly clip_frames; channel-count mismatches
// are an error for that clip. status[i] receives 0 on success or a
// negative error code. Returns the number of successfully decoded clips.
int64_t acx_load_corpus(const char** paths, int64_t n_paths, float* out,
                        int64_t clip_frames, int32_t channels,
                        int32_t n_threads, int32_t* status) {
  return load_corpus_generic<float>(paths, n_paths, out, clip_frames,
                                    channels, n_threads, status,
                                    decode_samples);
}

// Same, but decoding straight to the int16 H2D wire (see decode_samples_i16):
// for PCM16 corpora this is memcpy-speed and skips the float round trip
// (decode->float->rint->clip->int16) that bound ingest on 1-core hosts.
int64_t acx_load_corpus_i16(const char** paths, int64_t n_paths, int16_t* out,
                            int64_t clip_frames, int32_t channels,
                            int32_t n_threads, int32_t* status) {
  return load_corpus_generic<int16_t>(paths, n_paths, out, clip_frames,
                                      channels, n_threads, status,
                                      decode_samples_i16);
}

// Write interleaved float32 [-1, 1] as PCM (width 2 or 4 bytes).
int acx_write_wav(const char* path, const float* data, int64_t frames,
                  int32_t channels, int32_t sample_rate, int32_t width) {
  if (width != 2 && width != 4) return -4;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int64_t values = frames * channels;
  const uint32_t data_len = static_cast<uint32_t>(values * width);
  const uint32_t byte_rate = static_cast<uint32_t>(sample_rate) *
                             static_cast<uint32_t>(channels) *
                             static_cast<uint32_t>(width);
  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t riff_len = 36 + data_len;
  std::memcpy(hdr + 4, &riff_len, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_len = 16;
  std::memcpy(hdr + 16, &fmt_len, 4);
  uint16_t fmt = 1, ch = static_cast<uint16_t>(channels);
  std::memcpy(hdr + 20, &fmt, 2);
  std::memcpy(hdr + 22, &ch, 2);
  std::memcpy(hdr + 24, &sample_rate, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  uint16_t block_align = static_cast<uint16_t>(channels * width);
  uint16_t bits = static_cast<uint16_t>(width * 8);
  std::memcpy(hdr + 32, &block_align, 2);
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &data_len, 4);
  std::fwrite(hdr, 1, 44, f);

  std::vector<uint8_t> chunk(1 << 16);
  int64_t i = 0;
  while (i < values) {
    size_t n = 0;
    while (i < values && n + static_cast<size_t>(width) <= chunk.size()) {
      // clamp + scale in double: 2147483647 is not representable in
      // float32 (rounds up to 2^31), whose int32 cast is UB and flips
      // full-scale positive samples to INT32_MIN.
      double v = static_cast<double>(data[i]);
      if (v > 1.0) v = 1.0;
      if (v < -1.0) v = -1.0;
      if (width == 2) {
        int16_t s = static_cast<int16_t>(v * 32767.0);
        std::memcpy(chunk.data() + n, &s, 2);
      } else {
        int32_t s = static_cast<int32_t>(v * 2147483647.0);
        std::memcpy(chunk.data() + n, &s, 4);
      }
      n += static_cast<size_t>(width);
      ++i;
    }
    std::fwrite(chunk.data(), 1, n, f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
