// Native FLAC codec: a self-contained decoder and encoder for the FLAC
// bitstream format (https://xiph.org/flac/format.html).
//
// The original audiotools library loads FLAC through librosa/soundfile/
// ffmpeg (audiotools/core/audio_signal.py:499-507, core/ffmpeg.py:149-211);
// this package needs none of those, nor libFLAC: the format is implemented
// from the specification:
//
// Decoder: all subframe types (constant, verbatim, fixed orders 0-4,
// LPC orders 1-32), both Rice residual methods (4- and 5-bit parameters,
// escape codes), all stereo decorrelation modes (left/side, right/side,
// mid/side), wasted bits, 8/12/16/20/24-bit sample sizes, UTF-8-coded
// frame/sample numbers, and variable block sizes.
//
// Encoder: fixed-blocksize stream with per-channel best-of
// {constant, fixed predictor order 0-4, verbatim} subframes and
// single-partition Rice residuals — a valid, genuinely compressing
// subset of the spec (a full LPC search is a quality knob, not a
// format-compliance requirement).
//
// Exposed C ABI (ctypes):
//   at_flac_info(path, *sr, *frames, *channels, *bits) -> 0 on success
//   at_flac_read(path, start_frame, n_frames, out, out_channels)
//       -> frames written (decodes from the head; FLAC frames are not
//          byte-indexable without a seektable)
//   at_flac_write(path, interleaved_int32, frames, channels, sr, bits)
//       -> 0 on success
//   at_flac_read_batch(paths, n, starts, counts, outs, channels, threads)
//       -> 0 on success (parallel worker threads, like at_wav_read_batch)
//
// Built at first use by _build.host_library("flacio").

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Bit-level IO (MSB first, as FLAC requires)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool eof() const { return byte_pos >= size; }

  uint32_t read_bit() {
    if (byte_pos >= size) {
      error = true;
      return 0;
    }
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1;
    if (++bit_pos == 8) {
      bit_pos = 0;
      ++byte_pos;
    }
    return b;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n == 0) return 0;
    if (v & (1ull << (n - 1))) v |= ~((1ull << n) - 1);  // sign extend
    return (int64_t)v;
  }

  uint32_t read_unary() {  // count of 0 bits before the terminating 1
    uint32_t n = 0;
    while (!error && read_bit() == 0) ++n;
    return n;
  }

  void align() {
    if (bit_pos) {
      bit_pos = 0;
      ++byte_pos;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint8_t cur = 0;
  int nbits = 0;

  void write_bit(uint32_t b) {
    cur = (uint8_t)((cur << 1) | (b & 1));
    if (++nbits == 8) {
      out.push_back(cur);
      cur = 0;
      nbits = 0;
    }
  }

  void write_bits(uint64_t v, int n) {
    for (int i = n - 1; i >= 0; --i) write_bit((uint32_t)(v >> i));
  }

  void write_unary(uint32_t q) {
    for (uint32_t i = 0; i < q; ++i) write_bit(0);
    write_bit(1);
  }

  void align() {
    while (nbits) write_bit(0);
  }

  size_t bit_length() const { return out.size() * 8 + nbits; }
};

// ---------------------------------------------------------------------------
// CRCs (FLAC: CRC-8 poly 0x07 over the frame header, CRC-16 poly 0x8005
// over the whole frame)
// ---------------------------------------------------------------------------

uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= d[i];
    for (int b = 0; b < 8; ++b)
      crc = (uint8_t)((crc & 0x80) ? (crc << 1) ^ 0x07 : crc << 1);
  }
  return crc;
}

uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= (uint16_t)(d[i] << 8);
    for (int b = 0; b < 8; ++b)
      crc = (uint16_t)((crc & 0x8000) ? (crc << 1) ^ 0x8005 : crc << 1);
  }
  return crc;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits = 0;
  uint64_t total_samples = 0;
  size_t audio_offset = 0;  // first frame byte
};

bool parse_stream_header(const uint8_t* data, size_t size, StreamInfo* si) {
  if (size < 8 || memcmp(data, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool last = false;
  while (!last) {
    if (pos + 4 > size) return false;
    last = (data[pos] & 0x80) != 0;
    uint32_t type = data[pos] & 0x7f;
    uint32_t len = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + len > size) return false;
    if (type == 0) {  // STREAMINFO
      if (len < 34) return false;
      const uint8_t* p = data + pos;
      si->sample_rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      si->channels = ((p[12] >> 1) & 0x7) + 1;
      si->bits = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si->total_samples = ((uint64_t)(p[13] & 0x0f) << 32) | ((uint64_t)p[14] << 24) |
                          (p[15] << 16) | (p[16] << 8) | p[17];
    }
    pos += len;
  }
  si->audio_offset = pos;
  return si->sample_rate != 0 && si->channels >= 1 && si->channels <= 8;
}

// decode one residual partition set into res[pred_order..block_size)
bool decode_residual(BitReader& br, int pred_order, int block_size,
                     std::vector<int64_t>& res) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  uint32_t porder = (uint32_t)br.read_bits(4);
  uint32_t parts = 1u << porder;
  if (block_size % parts != 0) return false;
  int idx = pred_order;
  for (uint32_t p = 0; p < parts; ++p) {
    int n = (int)(block_size >> porder);
    if (p == 0) n -= pred_order;
    if (n < 0) return false;
    uint32_t k = (uint32_t)br.read_bits(plen);
    if (k == escape) {
      uint32_t raw = (uint32_t)br.read_bits(5);
      for (int i = 0; i < n; ++i) res[idx++] = br.read_signed(raw);
    } else {
      for (int i = 0; i < n; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits(k);
        uint64_t u = ((uint64_t)q << k) | r;
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // unzigzag
        if (br.error) return false;
      }
    }
  }
  return !br.error;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.read_bit() != 0) return false;  // padding bit
  uint32_t type = (uint32_t)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + (int)br.read_unary();
  bps -= wasted;

  out.assign(block_size, 0);
  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    if (order > block_size) return false;  // corrupt: warmup would overflow
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t p = 0;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = out[i - 1]; break;
        case 2: p = 2 * out[i - 1] - out[i - 2]; break;
        case 3: p = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4:
          p = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
          break;
      }
      out[i] += p;
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1f) + 1;
    if (order > block_size) return false;  // corrupt: warmup would overflow
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    uint32_t prec = (uint32_t)br.read_bits(4);
    if (prec == 15) return false;
    prec += 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed((int)prec);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) p += coef[j] * out[i - 1 - j];
      out[i] += p >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  return !br.error;
}

// Decode one frame; returns block size, or -1 on error / 0 on EOF.
int decode_frame(BitReader& br, const StreamInfo& si,
                 std::vector<std::vector<int64_t>>& chans) {
  // scan for the sync code (handles byte-aligned streams)
  br.align();
  while (br.byte_pos + 2 <= br.size) {
    if (br.data[br.byte_pos] == 0xff && (br.data[br.byte_pos + 1] & 0xfc) == 0xf8)
      break;
    ++br.byte_pos;
  }
  if (br.byte_pos + 2 > br.size) return 0;

  br.read_bits(14);                 // sync
  br.read_bit();                    // reserved
  br.read_bit();                    // blocking strategy
  uint32_t bs_code = (uint32_t)br.read_bits(4);
  uint32_t sr_code = (uint32_t)br.read_bits(4);
  uint32_t ch_code = (uint32_t)br.read_bits(4);
  uint32_t ss_code = (uint32_t)br.read_bits(3);
  br.read_bit();  // reserved

  // UTF-8 coded frame/sample number: skip (we decode sequentially)
  uint32_t first = (uint32_t)br.read_bits(8);
  int extra = 0;
  for (uint32_t m = 0x80; first & m; m >>= 1) ++extra;
  if (extra > 0) extra -= 1;
  for (int i = 0; i < extra; ++i) br.read_bits(8);

  int block_size;
  switch (bs_code) {
    case 1: block_size = 192; break;
    case 2: case 3: case 4: case 5:
      block_size = 576 << (bs_code - 2); break;
    case 6: block_size = (int)br.read_bits(8) + 1; break;
    case 7: block_size = (int)br.read_bits(16) + 1; break;
    default:
      if (bs_code >= 8) block_size = 256 << (bs_code - 8);
      else return -1;
  }
  if (sr_code == 12) br.read_bits(8);
  else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

  int bps;
  switch (ss_code) {
    case 0: bps = (int)si.bits; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
  }
  br.read_bits(8);  // CRC-8 (not verified; frame CRC-16 would also cover it)

  int nch;
  int mode = 0;  // 0 independent, 1 L/S, 2 R/S, 3 M/S
  if (ch_code < 8) {
    nch = (int)ch_code + 1;
  } else if (ch_code <= 10) {
    nch = 2;
    mode = (int)ch_code - 7;
  } else {
    return -1;
  }
  if (nch != (int)si.channels) return -1;

  chans.assign(nch, {});
  for (int c = 0; c < nch; ++c) {
    int sub_bps = bps;
    if ((mode == 1 && c == 1) || (mode == 2 && c == 0) || (mode == 3 && c == 1))
      sub_bps += 1;  // side channel carries one extra bit
    if (!decode_subframe(br, block_size, sub_bps, chans[c])) return -1;
  }
  br.align();
  br.read_bits(16);  // CRC-16
  if (br.error) return -1;

  if (mode == 1) {  // left/side: R = L - S
    for (int i = 0; i < block_size; ++i)
      chans[1][i] = chans[0][i] - chans[1][i];
  } else if (mode == 2) {  // right/side: L = S + R
    for (int i = 0; i < block_size; ++i)
      chans[0][i] = chans[0][i] + chans[1][i];
  } else if (mode == 3) {  // mid/side
    for (int i = 0; i < block_size; ++i) {
      int64_t side = chans[1][i];
      int64_t mid = (chans[0][i] << 1) | (side & 1);
      chans[0][i] = (mid + side) >> 1;
      chans[1][i] = (mid - side) >> 1;
    }
  }
  return block_size;
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = fopen(path, "rb");
  if (!f) return buf;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n > 0) {
    buf.resize((size_t)n);
    if (fread(buf.data(), 1, (size_t)n, f) != (size_t)n) buf.clear();
  }
  fclose(f);
  return buf;
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// best single Rice parameter for a residual span, and its cost in bits
int best_rice_param(const int64_t* res, int n, int maxk, size_t* cost) {
  uint64_t sum = 0;
  for (int i = 0; i < n; ++i) {
    int64_t v = res[i];
    sum += (uint64_t)((v << 1) ^ (v >> 63));  // zigzag magnitude
  }
  size_t best_cost = SIZE_MAX;
  int best_k = 0;
  // cost(k) ~= n*(k+1) + sum>>k ; evaluate exactly around the estimate
  for (int k = 0; k <= maxk; ++k) {
    size_t c = (size_t)n * (size_t)(k + 1) + (size_t)(sum >> k);
    if (c < best_cost) {
      best_cost = c;
      best_k = k;
    }
  }
  *cost = best_cost;
  return best_k;
}

void write_rice_residual(BitWriter& bw, const int64_t* res, int n, int k) {
  bw.write_bits(0, 2);  // method 0: 4-bit params
  bw.write_bits(0, 4);  // partition order 0
  bw.write_bits((uint64_t)k, 4);
  for (int i = 0; i < n; ++i) {
    uint64_t u = (uint64_t)((res[i] << 1) ^ (res[i] >> 63));
    bw.write_unary((uint32_t)(u >> k));
    bw.write_bits(u & ((1ull << k) - 1), k);
  }
}

void fixed_residual(const int64_t* x, int n, int order, int64_t* res) {
  for (int i = order; i < n; ++i) {
    int64_t p = 0;
    switch (order) {
      case 0: p = 0; break;
      case 1: p = x[i - 1]; break;
      case 2: p = 2 * x[i - 1] - x[i - 2]; break;
      case 3: p = 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3]; break;
      case 4: p = 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4]; break;
    }
    res[i - order] = x[i] - p;
  }
}

void encode_subframe(BitWriter& bw, const int64_t* x, int n, int bps) {
  // constant?
  bool constant = true;
  for (int i = 1; i < n; ++i)
    if (x[i] != x[0]) {
      constant = false;
      break;
    }
  if (constant) {
    bw.write_bit(0);
    bw.write_bits(0, 6);  // type CONSTANT
    bw.write_bit(0);      // no wasted bits
    bw.write_bits((uint64_t)x[0] & ((1ull << bps) - 1), bps);
    return;
  }

  // best fixed order by exact single-partition Rice cost
  std::vector<int64_t> res(n), best_res(n);
  int best_order = 0, best_k = 0;
  size_t best_cost = SIZE_MAX;
  int max_order = n > 4 ? 4 : (n > 0 ? n - 1 : 0);
  for (int order = 0; order <= max_order; ++order) {
    fixed_residual(x, n, order, res.data());
    size_t cost;
    int k = best_rice_param(res.data(), n - order, 14, &cost);
    cost += (size_t)order * (size_t)bps;
    if (cost < best_cost) {
      best_cost = cost;
      best_order = order;
      best_k = k;
      std::copy(res.begin(), res.begin() + (n - order), best_res.begin());
    }
  }

  if (best_k >= 15 || best_cost >= (size_t)n * (size_t)bps) {
    // verbatim beats a degenerate Rice code
    bw.write_bit(0);
    bw.write_bits(1, 6);  // type VERBATIM
    bw.write_bit(0);
    for (int i = 0; i < n; ++i)
      bw.write_bits((uint64_t)x[i] & ((1ull << bps) - 1), bps);
    return;
  }

  bw.write_bit(0);
  bw.write_bits(0x08 | (uint32_t)best_order, 6);  // type FIXED
  bw.write_bit(0);                                // no wasted bits
  for (int i = 0; i < best_order; ++i)
    bw.write_bits((uint64_t)x[i] & ((1ull << bps) - 1), bps);
  write_rice_residual(bw, best_res.data(), n - best_order, best_k);
}

// FLAC's UTF-8-style coded number (extended to 7 bytes / 36 bits):
// b-byte form = header byte with b leading 1s, a 0, then 7-b payload
// bits, followed by b-1 continuation bytes (10xxxxxx); capacity 5b+1 bits.
void utf8_encode(BitWriter& bw, uint64_t v) {
  if (v < 0x80) {
    bw.write_bits(v, 8);
    return;
  }
  int bytes = 2;
  while (bytes < 7 && v >= (1ull << (5 * bytes + 1))) ++bytes;
  int head_payload = 7 - bytes;
  // header: `bytes` ones, one zero, top payload bits
  for (int i = 0; i < bytes; ++i) bw.write_bit(1);
  bw.write_bit(0);
  bw.write_bits(v >> (6 * (bytes - 1)), head_payload);
  for (int i = bytes - 2; i >= 0; --i)
    bw.write_bits(0x80 | ((v >> (6 * i)) & 0x3f), 8);
}

}  // namespace

extern "C" {

int at_flac_info(const char* path, int32_t* sr, int64_t* frames,
                 int32_t* channels, int32_t* bits) {
  auto buf = read_file(path);
  StreamInfo si;
  if (buf.empty() || !parse_stream_header(buf.data(), buf.size(), &si))
    return -1;
  *sr = (int32_t)si.sample_rate;
  *channels = (int32_t)si.channels;
  *bits = (int32_t)si.bits;
  if (si.total_samples) {
    *frames = (int64_t)si.total_samples;
  } else {
    // unknown in STREAMINFO: count by decoding
    BitReader br(buf.data() + si.audio_offset, buf.size() - si.audio_offset);
    std::vector<std::vector<int64_t>> chans;
    int64_t total = 0;
    while (true) {
      int n = decode_frame(br, si, chans);
      if (n <= 0) break;
      total += n;
    }
    *frames = total;
  }
  return 0;
}

// Decode `count` frames starting at `start`; `out` is (channels, count)
// row-major float32. Returns frames written (tail short reads are NOT
// zero-filled; caller handles).
int64_t at_flac_read(const char* path, int64_t start, int64_t count,
                     float* out, int32_t out_channels) {
  auto buf = read_file(path);
  StreamInfo si;
  if (buf.empty() || !parse_stream_header(buf.data(), buf.size(), &si))
    return -1;
  if (out_channels != (int32_t)si.channels) return -1;
  double scale = 1.0 / (double)(1ll << (si.bits - 1));

  BitReader br(buf.data() + si.audio_offset, buf.size() - si.audio_offset);
  std::vector<std::vector<int64_t>> chans;
  int64_t pos = 0;     // absolute sample index of the frame start
  int64_t written = 0;
  while (written < count) {
    int n = decode_frame(br, si, chans);
    if (n < 0) return written > 0 ? written : -1;
    if (n == 0) break;  // EOF
    int64_t lo = start > pos ? start : pos;
    int64_t hi = pos + n < start + count ? pos + n : start + count;
    for (int64_t i = lo; i < hi; ++i) {
      for (int32_t c = 0; c < out_channels; ++c)
        out[(size_t)c * (size_t)count + (size_t)(i - start)] =
            (float)(chans[c][i - pos] * scale);
    }
    if (hi > lo) written += hi - lo;
    pos += n;
    if (pos >= start + count) break;
  }
  return written;
}

// Encode (channels, frames) row-major int32 samples (already quantized to
// `bits`) at the given rate. Block size 4096. Returns 0 on success.
int at_flac_write(const char* path, const int32_t* data, int64_t frames,
                  int32_t channels, int32_t sr, int32_t bits) {
  if (channels < 1 || channels > 8 || bits < 8 || bits > 24 || frames <= 0)
    return -1;
  const int BS = 4096;

  BitWriter bw;
  // "fLaC" + STREAMINFO (last metadata block)
  for (char c : {'f', 'L', 'a', 'C'}) bw.write_bits((uint64_t)c, 8);
  bw.write_bit(1);            // last-metadata-block
  bw.write_bits(0, 7);        // type STREAMINFO
  bw.write_bits(34, 24);      // length
  int last_bs = (int)(frames % BS);
  if (last_bs == 0) last_bs = BS;
  int min_bs = frames > BS ? BS : last_bs;
  bw.write_bits((uint64_t)min_bs, 16);
  bw.write_bits((uint64_t)(frames > BS ? BS : last_bs), 16);
  bw.write_bits(0, 24);       // min framesize unknown
  bw.write_bits(0, 24);       // max framesize unknown
  bw.write_bits((uint64_t)sr, 20);
  bw.write_bits((uint64_t)(channels - 1), 3);
  bw.write_bits((uint64_t)(bits - 1), 5);
  bw.write_bits((uint64_t)frames, 36);
  for (int i = 0; i < 16; ++i) bw.write_bits(0, 8);  // MD5 unknown

  std::vector<int64_t> chan(BS);
  int64_t pos = 0;
  uint64_t frame_no = 0;
  while (pos < frames) {
    int n = (int)(frames - pos < BS ? frames - pos : BS);
    BitWriter fb;  // frame built separately so CRCs can be computed
    fb.write_bits(0x3ffe, 14);  // sync
    fb.write_bit(0);            // reserved
    fb.write_bit(0);            // fixed blocksize stream
    fb.write_bits(7, 4);        // blocksize: 16-bit value-1 follows
    fb.write_bits(0, 4);        // sample rate: from STREAMINFO
    fb.write_bits((uint64_t)(channels - 1), 4);  // independent channels
    uint32_t ss_code = bits == 8 ? 1 : bits == 12 ? 2 : bits == 16 ? 4
                       : bits == 20 ? 5 : 6;
    fb.write_bits(ss_code, 3);
    fb.write_bit(0);  // reserved
    utf8_encode(fb, frame_no);
    fb.write_bits((uint64_t)(n - 1), 16);
    fb.align();
    fb.out.push_back(crc8(fb.out.data(), fb.out.size()));

    for (int32_t c = 0; c < channels; ++c) {
      for (int i = 0; i < n; ++i)
        chan[i] = data[(size_t)c * (size_t)frames + (size_t)(pos + i)];
      encode_subframe(fb, chan.data(), n, bits);
    }
    fb.align();
    uint16_t fc = crc16(fb.out.data(), fb.out.size());
    fb.write_bits(fc, 16);

    bw.out.insert(bw.out.end(), fb.out.begin(), fb.out.end());
    pos += n;
    ++frame_no;
  }

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t wrote = fwrite(bw.out.data(), 1, bw.out.size(), f);
  fclose(f);
  return wrote == bw.out.size() ? 0 : -1;
}

// Decode a batch of excerpts in parallel (same contract as
// at_wav_read_batch in wavio.cpp): outs[i] holds channels[i] * counts[i]
// floats, planar, zero-padded where the file runs short.
int at_flac_read_batch(const char** paths, int32_t n, const int64_t* starts,
                       const int64_t* counts, float** outs,
                       const int32_t* channels, int32_t n_threads) {
  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  std::vector<int> status(n, 0);
  std::vector<std::thread> workers;
  for (int32_t k = 0; k < n_threads; ++k) {
    workers.emplace_back([&, k]() {
      for (int32_t i = k; i < n; i += n_threads) {
        memset(outs[i], 0,
               sizeof(float) * static_cast<size_t>(channels[i]) *
                   static_cast<size_t>(counts[i]));
        int64_t got =
            at_flac_read(paths[i], starts[i], counts[i], outs[i], channels[i]);
        if (got < 0) status[i] = 1;
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int32_t i = 0; i < n; ++i)
    if (status[i]) return -(i + 1);
  return 0;
}

}  // extern "C"
