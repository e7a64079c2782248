// Arbitrary-container audio decode via the system libavformat/libavcodec
// (the libraries ship on most hosts even when the ffmpeg *binary* does
// not). Covers what the original audiotools library reaches through its
// ffmpeg subprocess (audiotools/core/ffmpeg.py:149-211): mp4/m4a/webm/
// mkv/aac/opus/... including audio tracks of video containers.
//
// Deliberately does NOT resample or remix: output is the stream's own
// rate/channel count as interleaved float32 — rate conversion belongs to
// the package's polyphase resampler (on device), not the host decoder.
//
// Built at first use by _build.host_library("avio"), linking -lavformat
// -lavcodec -lavutil.
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/avutil.h>
}

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  int stream_index = -1;

  ~Decoder() {
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) avformat_close_input(&fmt);
  }

  // 0 on success
  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    const AVCodec* dec = nullptr;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (stream_index < 0 || !dec) return -3;
    ctx = avcodec_alloc_context3(dec);
    if (!ctx) return -4;
    if (avcodec_parameters_to_context(
            ctx, fmt->streams[stream_index]->codecpar) < 0)
      return -5;
    if (avcodec_open2(ctx, dec, nullptr) < 0) return -6;
    return 0;
  }

  int channels() const {
#if LIBAVCODEC_VERSION_INT >= AV_VERSION_INT(59, 24, 100)
    return ctx->ch_layout.nb_channels;
#else
    return ctx->channels;
#endif
  }
};

// append one decoded frame's samples as interleaved float32
bool append_frame(const AVFrame* f, int nch, std::vector<float>& out) {
  const int n = f->nb_samples;
  const auto fmt = static_cast<AVSampleFormat>(f->format);
  const bool planar = av_sample_fmt_is_planar(fmt);
  // switch on the packed equivalent; planarity only changes indexing
  const AVSampleFormat base = av_get_packed_sample_fmt(fmt);
  const size_t start = out.size();
  out.resize(start + static_cast<size_t>(n) * nch);
  float* dst = out.data() + start;

  auto sample = [&](int ch, int i) -> double {
    const uint8_t* plane = planar ? f->extended_data[ch] : f->extended_data[0];
    const int idx = planar ? i : i * nch + ch;
    switch (base) {
      case AV_SAMPLE_FMT_U8:
        return (reinterpret_cast<const uint8_t*>(plane)[idx] - 128) / 128.0;
      case AV_SAMPLE_FMT_S16:
        return reinterpret_cast<const int16_t*>(plane)[idx] / 32768.0;
      case AV_SAMPLE_FMT_S32:
        return reinterpret_cast<const int32_t*>(plane)[idx] / 2147483648.0;
      case AV_SAMPLE_FMT_S64:
        return reinterpret_cast<const int64_t*>(plane)[idx] /
               9223372036854775808.0;
      case AV_SAMPLE_FMT_FLT:
        return reinterpret_cast<const float*>(plane)[idx];
      case AV_SAMPLE_FMT_DBL:
        return reinterpret_cast<const double*>(plane)[idx];
      default:
        return 0.0;
    }
  };
  if (base == AV_SAMPLE_FMT_NONE) return false;
  for (int i = 0; i < n; i++)
    for (int ch = 0; ch < nch; ch++)
      *dst++ = static_cast<float>(sample(ch, i));
  return true;
}

}  // namespace

extern "C" {

// Probe best audio stream: 0 on success.
int at_av_info(const char* path, int32_t* sample_rate, int64_t* frames,
               int32_t* channels, char* codec, int32_t codec_len) {
  Decoder d;
  if (d.open(path) != 0) return -1;
  *sample_rate = d.ctx->sample_rate;
  *channels = d.channels();
  const AVStream* st = d.fmt->streams[d.stream_index];
  double secs = 0.0;
  if (st->duration > 0)
    secs = st->duration * av_q2d(st->time_base);
  else if (d.fmt->duration > 0)
    secs = d.fmt->duration / static_cast<double>(AV_TIME_BASE);
  *frames = static_cast<int64_t>(secs * d.ctx->sample_rate + 0.5);
  if (codec && codec_len > 0) {
    const char* name = avcodec_get_name(d.ctx->codec_id);
    std::strncpy(codec, name, codec_len - 1);
    codec[codec_len - 1] = '\0';
  }
  return (*sample_rate > 0 && *channels > 0) ? 0 : -2;
}

// Decode [offset, offset+duration) seconds (duration < 0 reads to EOF)
// into a malloc'd interleaved float32 buffer. Returns frame count, or a
// negative error. Caller frees with at_av_free.
int64_t at_av_read(const char* path, double offset, double duration,
                   float** out, int32_t* channels, int32_t* sample_rate) {
  Decoder d;
  if (d.open(path) != 0) return -1;
  const int nch = d.channels();
  const int sr = d.ctx->sample_rate;
  if (nch <= 0 || sr <= 0) return -2;
  *channels = nch;
  *sample_rate = sr;

  const AVStream* st = d.fmt->streams[d.stream_index];
  int64_t drop = 0;  // samples to discard before the requested offset
  if (offset > 0.0) {
    const int64_t ts = av_rescale_q(
        static_cast<int64_t>(offset * AV_TIME_BASE),
        AVRational{1, AV_TIME_BASE}, st->time_base);
    if (av_seek_frame(d.fmt, d.stream_index, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(d.ctx);
      drop = -1;  // resolved from the first decoded frame's pts
    } else {
      drop = static_cast<int64_t>(offset * sr + 0.5);  // decode-and-drop
    }
  }
  const int64_t want =
      duration < 0 ? -1 : static_cast<int64_t>(duration * sr + 0.5);

  std::vector<float> buf;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  if (!pkt || !frame) return -3;
  int64_t kept = 0;
  bool eof = false, fmt_err = false;

  auto handle_frame = [&]() {
    if (drop == -1) {
      // first frame after the container seek: its pts tells us where
      // the demuxer actually landed (at/before the request)
      double t = 0.0;
      if (frame->pts != AV_NOPTS_VALUE)
        t = frame->pts * av_q2d(st->time_base);
      const double ahead = offset - t;
      drop = ahead > 0 ? static_cast<int64_t>(ahead * sr + 0.5) : 0;
    }
    std::vector<float>& dst = buf;
    const size_t before = dst.size();
    if (!append_frame(frame, nch, dst)) {
      fmt_err = true;
      return;
    }
    int64_t n = frame->nb_samples;
    if (drop > 0) {
      const int64_t cut = n < drop ? n : drop;
      dst.erase(dst.begin() + before, dst.begin() + before + cut * nch);
      drop -= cut;
      n -= cut;
    }
    kept += n;
  };

  while (!eof && !fmt_err && (want < 0 || kept < want)) {
    const int rrc = av_read_frame(d.fmt, pkt);
    if (rrc < 0) {
      eof = true;
      avcodec_send_packet(d.ctx, nullptr);  // enter drain mode
    } else if (pkt->stream_index == d.stream_index) {
      avcodec_send_packet(d.ctx, pkt);
    }
    av_packet_unref(pkt);
    while (!fmt_err) {
      const int rc = avcodec_receive_frame(d.ctx, frame);
      if (rc == AVERROR(EAGAIN)) break;
      if (rc == AVERROR_EOF || rc < 0) {
        if (rc == AVERROR_EOF) eof = true;
        break;
      }
      handle_frame();
      av_frame_unref(frame);
      if (want >= 0 && kept >= want) break;
    }
  }
  av_packet_free(&pkt);
  av_frame_free(&frame);
  if (fmt_err) return -4;

  int64_t n = kept;
  if (want >= 0 && n > want) n = want;
  const size_t bytes = static_cast<size_t>(n) * nch * sizeof(float);
  float* mem = static_cast<float*>(malloc(bytes ? bytes : 1));
  if (!mem) return -5;
  std::memcpy(mem, buf.data(), bytes);
  *out = mem;
  return n;
}

void at_av_free(float* p) { free(p); }

// Encode interleaved float32 (frames x channels) into a container
// chosen from the path's extension, with the codec libav considers the
// container's default audio codec (mp4/m4a -> aac via FFmpeg's native
// encoder). Returns 0 on success.
int at_av_write(const char* path, const float* data, int64_t frames,
                int32_t channels, int32_t sample_rate, int64_t bit_rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 ||
      !fmt)
    return -1;
  int ret = -2;
  AVCodecContext* ctx = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  std::vector<float> plane;

  do {
    const AVCodec* enc =
        avcodec_find_encoder(fmt->oformat->audio_codec);
    if (!enc) break;
    AVStream* st = avformat_new_stream(fmt, nullptr);
    if (!st) break;
    ctx = avcodec_alloc_context3(enc);
    if (!ctx) break;
    ctx->sample_rate = sample_rate;
    ctx->bit_rate = bit_rate > 0 ? bit_rate : 128000;
    ctx->sample_fmt = enc->sample_fmts ? enc->sample_fmts[0]
                                       : AV_SAMPLE_FMT_FLTP;
#if LIBAVCODEC_VERSION_INT >= AV_VERSION_INT(59, 24, 100)
    av_channel_layout_default(&ctx->ch_layout, channels);
#else
    ctx->channels = channels;
    ctx->channel_layout = av_get_default_channel_layout(channels);
#endif
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(ctx, enc, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, ctx) < 0) break;
    st->time_base = AVRational{1, sample_rate};
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
      break;
    if (avformat_write_header(fmt, nullptr) < 0) break;

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) break;
    const int fsz = ctx->frame_size > 0 ? ctx->frame_size : 1024;
    const bool planar = av_sample_fmt_is_planar(ctx->sample_fmt);
    bool fail = false;
    int64_t pos = 0, pts = 0;

    auto drain = [&](bool flush) -> bool {
      if (avcodec_send_frame(ctx, flush ? nullptr : frame) < 0) return false;
      while (true) {
        const int rc = avcodec_receive_packet(ctx, pkt);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return true;
        if (rc < 0) return false;
        av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
      }
    };

    while (pos < frames && !fail) {
      const int n = static_cast<int>(
          frames - pos < fsz ? frames - pos : fsz);
      frame->nb_samples = n;
      frame->format = ctx->sample_fmt;
#if LIBAVCODEC_VERSION_INT >= AV_VERSION_INT(59, 24, 100)
      av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
#else
      frame->channels = channels;
      frame->channel_layout = ctx->channel_layout;
#endif
      frame->sample_rate = sample_rate;
      if (av_frame_get_buffer(frame, 0) < 0) { fail = true; break; }
      const float* src = data + pos * channels;
      if (planar) {
        for (int ch = 0; ch < channels; ch++) {
          float* dst = reinterpret_cast<float*>(frame->extended_data[ch]);
          for (int i = 0; i < n; i++) dst[i] = src[i * channels + ch];
        }
      } else {
        std::memcpy(frame->extended_data[0], src,
                    static_cast<size_t>(n) * channels * sizeof(float));
      }
      frame->pts = pts;
      pts += n;
      if (!drain(false)) fail = true;
      av_frame_unref(frame);
      pos += n;
    }
    if (!fail) fail = !drain(true);
    if (!fail && av_write_trailer(fmt) < 0) fail = true;
    ret = fail ? -3 : 0;
  } while (false);

  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (ctx) avcodec_free_context(&ctx);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
      avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return ret;
}

}  // extern "C"
