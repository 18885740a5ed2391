// freud_audio: native audio decode runtime for the TPU collection pipeline.
//
// The reference implementation shells out to the ffmpeg CLI once per file
// (reference: src/utils/audio_utils.py:21-58 — a fork/exec + pipe per clip).
// Here we link libavformat/libavcodec/libswresample directly and decode
// in-process: open → demux → decode → resample to mono float32 @ target rate,
// with a pooled multi-file API so the Python host thread can hand a whole
// batch of paths to native code and get back one contiguous float buffer
// ready for jax.device_put.
//
// C ABI (ctypes-friendly):
//   fa_decode(path, target_sr, out_ptr*, out_len*)      -> 0 on success
//   fa_decode_into(path, target_sr, buf, cap, written*) -> 0 on success
//   fa_free(ptr)
//   fa_duration(path, target_sr)                        -> seconds (header scan), <0 on error
//   fa_decode_batch(paths[], n, target_sr, frame_len, out_buf, lengths[], n_threads)
//   fa_last_error()                                     -> thread-local message
//   fa_version()

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct DecodeResult {
  std::vector<float> samples;
};

// Decode one file to mono float32 at target_sr. Returns false on error.
// max_samples >= 0 stops the packet loop once that many samples are
// collected (the batch path only consumes one 30-s row — decoding a
// multi-hour file to fill it would cost minutes and gigabytes per worker).
bool decode_file_impl(const char* path, int target_sr, std::vector<float>& out,
                      int64_t max_samples) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) {
    set_error(std::string("cannot open ") + path);
    return false;
  }
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    set_error("no stream info");
    return false;
  }
  const AVCodec* codec = nullptr;
  int stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream_idx < 0 || !codec) {
    avformat_close_input(&fmt);
    set_error("no audio stream");
    return false;
  }
  AVStream* stream = fmt->streams[stream_idx];
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  if (!ctx) {
    avformat_close_input(&fmt);
    set_error("cannot allocate codec context");
    return false;
  }
  if (avcodec_parameters_to_context(ctx, stream->codecpar) < 0) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    set_error("bad codec parameters");
    return false;
  }
  if (avcodec_open2(ctx, codec, nullptr) < 0) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    set_error("cannot open codec");
    return false;
  }

  SwrContext* swr = swr_alloc();
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  // Must be zero-initialized: av_channel_layout_copy() uninits the
  // destination first, which would free a garbage pointer from dirty stack.
  AVChannelLayout in_layout = {};
  if (ctx->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &ctx->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 1);
  }
  av_opt_set_chlayout(swr, "in_chlayout", &in_layout, 0);
  av_opt_set_chlayout(swr, "out_chlayout", &mono, 0);
  av_opt_set_int(swr, "in_sample_rate", ctx->sample_rate, 0);
  av_opt_set_int(swr, "out_sample_rate", target_sr, 0);
  av_opt_set_sample_fmt(swr, "in_sample_fmt", ctx->sample_fmt, 0);
  av_opt_set_sample_fmt(swr, "out_sample_fmt", AV_SAMPLE_FMT_FLT, 0);
  if (swr_init(swr) < 0) {
    swr_free(&swr);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    set_error("swr_init failed");
    return false;
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  std::vector<float> resample_buf;
  out.clear();
  if (stream->duration > 0) {
    double est = av_q2d(stream->time_base) * (double)stream->duration;
    double want = est * target_sr + 4096;
    // cap the header-driven reserve: a malformed duration field must not
    // drive an allocation attempt (bad_alloc in a worker thread would
    // std::terminate the whole process); also no point reserving past an
    // early-stop bound
    double cap = max_samples >= 0 ? (double)max_samples + 8192 : 1e9;
    if (want > cap) want = cap;
    if (want > 0) out.reserve((size_t)want);
  }

  bool swr_failed = false;
  auto drain_frame = [&](AVFrame* f) {
    int64_t delay = swr_get_delay(swr, ctx->sample_rate ? ctx->sample_rate : target_sr);
    int in_n = f ? f->nb_samples : 0;
    int max_out = (int)av_rescale_rnd(delay + in_n, target_sr,
                                      ctx->sample_rate ? ctx->sample_rate : target_sr,
                                      AV_ROUND_UP) + 32;
    resample_buf.resize((size_t)max_out);
    uint8_t* out_planes[1] = {reinterpret_cast<uint8_t*>(resample_buf.data())};
    int n = swr_convert(swr, out_planes, max_out,
                        f ? const_cast<const uint8_t**>(f->extended_data) : nullptr,
                        in_n);
    if (n > 0) out.insert(out.end(), resample_buf.begin(), resample_buf.begin() + n);
    else if (n < 0) swr_failed = true;  // silently dropped chunks would
  };                                    // report corrupt audio as a success

  bool enough = false;
  while (!enough && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == stream_idx) {
      if (avcodec_send_packet(ctx, pkt) >= 0) {
        while (avcodec_receive_frame(ctx, frame) >= 0) drain_frame(frame);
      }
    }
    av_packet_unref(pkt);
    if (max_samples >= 0 && (int64_t)out.size() >= max_samples) enough = true;
  }
  if (!enough) {
    // Flush decoder then resampler (skipped when the cap already filled).
    avcodec_send_packet(ctx, nullptr);
    while (avcodec_receive_frame(ctx, frame) >= 0) drain_frame(frame);
    drain_frame(nullptr);
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  av_channel_layout_uninit(&in_layout);
  avcodec_free_context(&ctx);
  avformat_close_input(&fmt);
  if (swr_failed) {
    set_error("resampler error mid-stream");
    return false;
  }
  return true;
}

// noexcept boundary: an exception escaping a std::thread worker (or the
// extern "C" surface into ctypes) calls std::terminate and kills the whole
// Python process — the per-file degrade contract requires a clean failure.
bool decode_file(const char* path, int target_sr, std::vector<float>& out,
                 int64_t max_samples = -1) noexcept {
  try {
    return decode_file_impl(path, target_sr, out, max_samples);
  } catch (const std::exception& e) {
    set_error(std::string("exception: ") + e.what());
    return false;
  } catch (...) {
    set_error("unknown exception during decode");
    return false;
  }
}

}  // namespace

extern "C" {

const char* fa_version() { return "freud_audio 1.0 (libavformat)"; }

const char* fa_last_error() { return g_error.c_str(); }

int fa_decode(const char* path, int target_sr, float** out_ptr, int64_t* out_len) {
  std::vector<float> samples;
  if (!decode_file(path, target_sr, samples)) return -1;
  float* buf = static_cast<float*>(malloc(samples.size() * sizeof(float)));
  if (!buf) {
    set_error("oom");
    return -1;
  }
  std::memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out_ptr = buf;
  *out_len = static_cast<int64_t>(samples.size());
  return 0;
}

void fa_free(float* ptr) { free(ptr); }

int fa_decode_into(const char* path, int target_sr, float* buf, int64_t capacity,
                   int64_t* written) {
  std::vector<float> samples;
  // stop decoding once the row is full: consumers clamp true lengths to the
  // row anyway (n_frames <= 1500), so a multi-hour file must not cost
  // minutes of decode + gigabytes of RAM to fill a 30-s slot
  if (!decode_file(path, target_sr, samples, capacity)) return -1;
  int64_t n = std::min<int64_t>(capacity, (int64_t)samples.size());
  std::memcpy(buf, samples.data(), (size_t)n * sizeof(float));
  *written = (int64_t)samples.size();  // >= capacity means truncated
  return 0;
}

// Duration in seconds from container metadata (no full decode).
double fa_duration(const char* path) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1.0;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1.0;
  }
  double dur = -1.0;
  int idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (idx >= 0) {
    AVStream* s = fmt->streams[idx];
    if (s->duration > 0)
      dur = av_q2d(s->time_base) * (double)s->duration;
    else if (fmt->duration > 0)
      dur = (double)fmt->duration / AV_TIME_BASE;
  }
  avformat_close_input(&fmt);
  return dur;
}

// Batch decode: n files into out_buf (n x frame_len, zero-padded / truncated),
// true sample counts into lengths[]. A pool of n_threads decodes in parallel —
// this is the host-side producer feeding the TPU collection pipeline.
int fa_decode_batch(const char** paths, int n, int target_sr, int64_t frame_len,
                    float* out_buf, int64_t* lengths, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      float* dst = out_buf + (int64_t)i * frame_len;
      std::memset(dst, 0, (size_t)frame_len * sizeof(float));
      int64_t written = 0;
      if (fa_decode_into(paths[i], target_sr, dst, frame_len, &written) != 0) {
        lengths[i] = -1;
        failures.fetch_add(1);
      } else {
        lengths[i] = written;
      }
    }
  };
  std::vector<std::thread> pool;
  int k = std::min(n_threads, n);
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
