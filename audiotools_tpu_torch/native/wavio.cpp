// Native audio I/O runtime: WAV header parsing, seeked decode, and a
// multithreaded batch decoder.
//
// The original audiotools library leans on libsndfile/ffmpeg for its I/O
// hot path (it loads excerpts per dataset item); this is the package's own
// decode engine instead. It reads integer PCM (8/16/24/32 bits) and IEEE
// float (32/64) and refuses any other format tag or depth; the Python WAV
// codec (io/wav.py) takes those (A-law, mu-law). This library decodes whole
// batches of file excerpts in parallel worker threads with no Python
// involvement.
//
// Exposed C ABI (ctypes):
//   at_wav_info(path, *sr, *frames, *channels) -> 0 on success
//   at_wav_read(path, start_frame, n_frames, out, out_channels) -> frames read
//   at_wav_read_batch(paths, n, starts, counts, outs, channels) -> 0 on success
//
// Built at first use by _build.host_library("wavio").

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint64_t num_frames = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = float
  uint64_t data_offset = 0;
  uint64_t data_size = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char riff[12];
  if (fread(riff, 1, 12, f) != 12) return false;
  if (memcmp(riff, "RIFF", 4) != 0 && memcmp(riff, "RF64", 4) != 0) return false;
  if (memcmp(riff + 8, "WAVE", 4) != 0) return false;

  uint64_t rf64_size = 0;
  bool have_fmt = false, have_data = false;
  while (!have_fmt || !have_data) {
    char hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, hdr + 4, 4);
    if (memcmp(hdr, "ds64", 4) == 0) {
      // a valid ds64 is 28 bytes; need at least the 16 covering riff+data
      // sizes, and reject absurd sizes before allocating
      if (size < 16 || size > (1u << 20)) return false;
      std::vector<char> body(size + (size & 1));
      if (fread(body.data(), 1, body.size(), f) != body.size()) return false;
      memcpy(&rf64_size, body.data() + 8, 8);
    } else if (memcmp(hdr, "fmt ", 4) == 0) {
      // PCM fmt is 16 bytes minimum; fields below read offsets 0..15
      if (size < 16 || size > (1u << 20)) return false;
      std::vector<char> body(size + (size & 1));
      if (fread(body.data(), 1, body.size(), f) != body.size()) return false;
      uint16_t tag;
      memcpy(&tag, body.data(), 2);
      memcpy(&info->channels, body.data() + 2, 2);
      memcpy(&info->sample_rate, body.data() + 4, 4);
      memcpy(&info->bits, body.data() + 14, 2);
      if (tag == 0xFFFE && size >= 40) {
        memcpy(&tag, body.data() + 24, 2);  // GUID head = real tag
      }
      info->format = tag;
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      info->data_offset = static_cast<uint64_t>(ftell(f));
      if (size == 0xFFFFFFFFu && rf64_size == 0) return false;  // RF64 without ds64
      info->data_size = (size == 0xFFFFFFFFu) ? rf64_size : size;
      if (fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR) != 0) {
        // tolerate truncated trailing chunk
      }
      have_data = true;
    } else {
      if (fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR) != 0) break;
    }
  }
  if (!have_fmt || !have_data || info->channels == 0 || info->bits == 0)
    return false;
  // only what decode_to_float decodes: integer PCM at 8/16/24/32 bits and
  // IEEE float at 32/64; anything else (A-law, mu-law, other depths) is
  // refused, and io.load_audio takes it to the numpy codec
  const bool pcm = info->format == 1 &&
                   (info->bits == 8 || info->bits == 16 || info->bits == 24 || info->bits == 32);
  const bool ieee = info->format == 3 && (info->bits == 32 || info->bits == 64);
  if (!(pcm || ieee) || info->sample_rate == 0) return false;
  uint32_t frame_bytes = info->channels * (info->bits / 8);
  info->num_frames = frame_bytes ? info->data_size / frame_bytes : 0;
  return true;
}

// Decode interleaved raw samples into planar float32 (C, out_stride),
// zero-padding each channel's tail when frames < out_stride. The stride
// is the CALLER's buffer width (requested frames), not the decoded
// count — writing at the decoded count would misplace channels 1+ on a
// short read and leave uninitialized tails.
// Per-format strided loops so the compiler auto-vectorizes the common
// PCM16/float32 paths.
void decode_to_float(const uint8_t* raw, int64_t frames, int64_t out_stride,
                     int channels, int bits, int format,
                     float* out /* (C, out_stride) */) {
  const float i16s = 1.0f / 32768.0f;
  const float i24s = 1.0f / 8388608.0f;
  const float i32s = 1.0f / 2147483648.0f;
  for (int c = 0; c < channels; ++c) {
    float* dst = out + static_cast<int64_t>(c) * out_stride;
    if (format == 3 && bits == 32) {
      const float* src = reinterpret_cast<const float*>(raw) + c;
      for (int64_t t = 0; t < frames; ++t) dst[t] = src[t * channels];
    } else if (format == 3 && bits == 64) {  // float64
      const double* src = reinterpret_cast<const double*>(raw) + c;
      for (int64_t t = 0; t < frames; ++t)
        dst[t] = static_cast<float>(src[t * channels]);
    } else if (format == 3) {  // float at a width we don't decode
      for (int64_t t = 0; t < frames; ++t) dst[t] = 0.0f;
    } else if (bits == 16) {
      const int16_t* src = reinterpret_cast<const int16_t*>(raw) + c;
      for (int64_t t = 0; t < frames; ++t) dst[t] = src[t * channels] * i16s;
    } else if (bits == 32) {
      const int32_t* src = reinterpret_cast<const int32_t*>(raw) + c;
      for (int64_t t = 0; t < frames; ++t) dst[t] = src[t * channels] * i32s;
    } else if (bits == 24) {
      const int64_t stride = 3 * channels;
      const uint8_t* src = raw + 3 * c;
      for (int64_t t = 0; t < frames; ++t) {
        const uint8_t* p = src + t * stride;
        int32_t s = p[0] | (p[1] << 8) | (p[2] << 16);
        if (s >= (1 << 23)) s -= (1 << 24);
        dst[t] = s * i24s;
      }
    } else if (bits == 8) {
      const uint8_t* src = raw + c;
      for (int64_t t = 0; t < frames; ++t)
        dst[t] = (static_cast<int>(src[t * channels]) - 128) / 128.0f;
    } else {
      for (int64_t t = 0; t < frames; ++t) dst[t] = 0.0f;
    }
    if (frames < out_stride)
      memset(dst + frames, 0,
             sizeof(float) * static_cast<size_t>(out_stride - frames));
  }
}

int64_t read_one(const char* path, int64_t start_frame, int64_t n_frames,
                 float* out, int out_channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -1;
  }
  if (out_channels != info.channels) {
    fclose(f);
    return -2;
  }
  if (info.channels * (info.bits / 8) == 0) {  // sub-byte widths: no frames
    fclose(f);
    return -1;
  }
  int64_t avail = static_cast<int64_t>(info.num_frames);
  if (start_frame < 0) start_frame = 0;
  if (start_frame > avail) start_frame = avail;
  // out is (channels, n_frames) planar for any non-negative request —
  // even when the file holds fewer frames (the tail is zero-filled)
  int64_t out_stride = n_frames;
  if (n_frames < 0 || start_frame + n_frames > avail)
    n_frames = avail - start_frame;
  if (out_stride < 0) out_stride = n_frames;
  uint32_t frame_bytes = info.channels * (info.bits / 8);
  if (fseek(f,
            static_cast<long>(info.data_offset +
                              static_cast<uint64_t>(start_frame) * frame_bytes),
            SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  std::vector<uint8_t> raw(static_cast<size_t>(n_frames) * frame_bytes);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  int64_t frames = static_cast<int64_t>(got / frame_bytes);
  decode_to_float(raw.data(), frames, out_stride, info.channels, info.bits,
                  info.format, out);
  return frames;
}

}  // namespace

extern "C" {

int at_wav_info(const char* path, int32_t* sample_rate, int64_t* num_frames,
                int32_t* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return -1;
  *sample_rate = static_cast<int32_t>(info.sample_rate);
  *num_frames = static_cast<int64_t>(info.num_frames);
  *channels = static_cast<int32_t>(info.channels);
  return 0;
}

int64_t at_wav_read(const char* path, int64_t start_frame, int64_t n_frames,
                    float* out, int32_t out_channels) {
  return read_one(path, start_frame, n_frames, out, out_channels);
}

// Decode a batch of excerpts in parallel. outs[i] must hold
// channels[i] * counts[i] floats. Returns 0 if every file decoded.
int at_wav_read_batch(const char** paths, int32_t n, const int64_t* starts,
                      const int64_t* counts, float** outs,
                      const int32_t* channels, int32_t n_threads) {
  if (n_threads <= 0) n_threads = static_cast<int32_t>(
      std::thread::hardware_concurrency());
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  std::vector<int> status(n, 0);
  std::vector<std::thread> workers;
  std::vector<int32_t> next(1, 0);
  // simple strided partition: thread k handles items k, k+T, ...
  for (int32_t k = 0; k < n_threads; ++k) {
    workers.emplace_back([&, k]() {
      for (int32_t i = k; i < n; i += n_threads) {
        // read_one writes planar (C, counts[i]) and zero-fills short
        // reads itself, so the buffer is complete on any got >= 0
        int64_t got = read_one(paths[i], starts[i], counts[i], outs[i],
                               channels[i]);
        if (got < 0) status[i] = 1;
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int32_t i = 0; i < n; ++i)
    if (status[i]) return -(i + 1);
  return 0;
}
}
