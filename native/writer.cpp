// Native video writer: threaded libav encode (libx264 QP 19 by default)
// plus audio/GPMF stream passthrough from the source container.
//
// Native counterpart of the reference's encode stack: the TS planner
// encodes with `-c:v libx264 -qp 19` ("visually lossless",
// src/render.ts:12-19) and stream-copies the audio and GoPro GPMF
// metadata tracks (src/join.ts:56-82 maps them by handler name). Here the
// Python pipeline hands planar YUV 4:2:0 frames to a ring buffer; a
// dedicated thread encodes and muxes them, interleaving copied packets
// from the source file by timestamp, so the device feed never waits on x264.
//
// C ABI (consumed via ctypes — no pybind11 in this image):
//   void* vaw_open(const char* dest, int w, int h, int fps_num, int fps_den,
//                  const char* encoder, int qp, const char* copy_from,
//                  double trim_start, double trim_end, int ring_frames);
//   int   vaw_write(void* h, const uint8_t* y, const uint8_t* u,
//                   const uint8_t* v);            // 1 ok, <0 err
//   int   vaw_close(void* h);                     // flush+trailer; 0 ok
//   const char* vaw_error(void* h);
// vaw_close always frees the handle (call exactly once).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
}

namespace {

struct WFrame {
    std::vector<uint8_t> y, u, v;
};

struct Writer {
    AVFormatContext* ofmt = nullptr;
    AVCodecContext* enc = nullptr;
    AVStream* vstream = nullptr;

    // Passthrough demuxer state.
    AVFormatContext* ifmt = nullptr;
    std::vector<int> map;  // input stream index -> output stream index (-1 skip)
    double trim_start = 0.0;
    double trim_end = -1.0;  // <0: to the end
    bool copy_done = false;

    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    std::vector<WFrame> ring;
    size_t head = 0, tail = 0, count = 0;
    std::atomic<bool> stop{false};
    std::atomic<bool> flush{false};
    std::atomic<bool> done{false};
    int64_t next_pts = 0;
    int width = 0, height = 0;
    std::string error;
    int status = 0;

    ~Writer() {
        {
            std::lock_guard<std::mutex> g(mu);  // publish to blocked waiters
            stop = true;
        }
        cv_push.notify_all();
        cv_pop.notify_all();
        if (worker.joinable()) worker.join();
        if (enc) avcodec_free_context(&enc);
        if (ifmt) avformat_close_input(&ifmt);
        if (ofmt) {
            if (ofmt->pb) avio_closep(&ofmt->pb);
            avformat_free_context(ofmt);
        }
    }
};

void set_error(Writer* W, const std::string& msg, int code) {
    std::lock_guard<std::mutex> g(W->mu);
    if (W->status == 0) {
        W->error = msg;
        W->status = code ? code : -1;
    }
}

// Copy audio/data packets from the source whose start time is below
// `until_s` (seconds, output timeline). Timestamps are shifted by
// -trim_start so passthrough lines up with the trimmed video.
void pump_passthrough(Writer* W, double until_s) {
    if (!W->ifmt || W->copy_done) return;
    AVPacket* pkt = av_packet_alloc();
    while (true) {
        int r = av_read_frame(W->ifmt, pkt);
        if (r < 0) {
            W->copy_done = true;
            break;
        }
        const int idx = pkt->stream_index;
        if (idx >= (int)W->map.size() || W->map[idx] < 0) {
            av_packet_unref(pkt);
            continue;
        }
        AVStream* ist = W->ifmt->streams[idx];
        const double tb = av_q2d(ist->time_base);
        const int64_t base_ts =
            pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
        const double t =
            base_ts != AV_NOPTS_VALUE ? base_ts * tb - W->trim_start : 0.0;
        if (t < -1e-6) {  // before the trim window
            av_packet_unref(pkt);
            continue;
        }
        if (W->trim_end >= 0 && t > W->trim_end - W->trim_start) {
            // Out of window for THIS stream only: other mapped streams may
            // still have in-window packets later in the interleave — skip,
            // don't stop the pump (a shared stop dropped up to an
            // interleave chunk of audio/GPMF at the clip end).
            av_packet_unref(pkt);
            continue;
        }
        AVStream* ost = W->ofmt->streams[W->map[idx]];
        const int64_t shift = (int64_t)(W->trim_start / tb + 0.5);
        if (pkt->pts != AV_NOPTS_VALUE) pkt->pts -= shift;
        if (pkt->dts != AV_NOPTS_VALUE) pkt->dts -= shift;
        av_packet_rescale_ts(pkt, ist->time_base, ost->time_base);
        pkt->stream_index = W->map[idx];
        pkt->pos = -1;
        if (av_interleaved_write_frame(W->ofmt, pkt) < 0) {
            set_error(W, "passthrough write failed", -5);
            W->copy_done = true;
            break;
        }
        // Stop once this packet reached the current video time; the next
        // pump resumes from the following packet.
        if (until_s >= 0 && t >= until_s) break;
    }
    av_packet_free(&pkt);
}

int drain_encoder(Writer* W) {
    AVPacket* pkt = av_packet_alloc();
    int ret = 0;
    while (true) {
        int r = avcodec_receive_packet(W->enc, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
        if (r < 0) {
            set_error(W, "encode failed", r);
            ret = r;
            break;
        }
        av_packet_rescale_ts(pkt, W->enc->time_base, W->vstream->time_base);
        // One frame per tick of the encoder time base. Without an explicit
        // duration the mov muxer derives it from dts deltas and gives the
        // LAST sample duration 0 — demuxers then drop that frame.
        if (pkt->duration <= 0)
            pkt->duration = av_rescale_q(1, W->enc->time_base,
                                         W->vstream->time_base);
        pkt->stream_index = W->vstream->index;
        const double t = pkt->pts != AV_NOPTS_VALUE
                             ? pkt->pts * av_q2d(W->vstream->time_base)
                             : -1.0;
        r = av_interleaved_write_frame(W->ofmt, pkt);
        if (r < 0) {
            set_error(W, "mux write failed", r);
            ret = r;
            break;
        }
        if (t >= 0) pump_passthrough(W, t);
    }
    av_packet_free(&pkt);
    return ret;
}

void encode_loop(Writer* W) {
    AVFrame* frame = av_frame_alloc();
    frame->format = AV_PIX_FMT_YUV420P;
    frame->width = W->width;
    frame->height = W->height;
    if (av_frame_get_buffer(frame, 0) < 0) {
        set_error(W, "frame alloc failed", -2);
        {
            // Atomic flag, but it must be set under the mutex: a producer
            // between its predicate check and block would otherwise miss
            // the notify forever.
            std::lock_guard<std::mutex> g(W->mu);
            W->done = true;
        }
        W->cv_push.notify_all();
        av_frame_free(&frame);
        return;
    }
    while (true) {
        std::unique_lock<std::mutex> lock(W->mu);
        W->cv_pop.wait(lock, [&] {
            return W->count > 0 || W->flush || W->stop;
        });
        if (W->stop) break;
        if (W->count == 0) {  // flush requested and ring drained
            lock.unlock();
            avcodec_send_frame(W->enc, nullptr);
            drain_encoder(W);
            pump_passthrough(W, -1.0 /* the rest of the trim window */);
            break;
        }
        // Claim the tail slot, then copy the planes OUTSIDE the lock —
        // inside it, every producer vaw_write memcpy waits on a full-
        // frame copy (and vice versa), degrading the ring to lockstep.
        // The producer can't touch this slot while count includes it.
        const size_t t_idx = W->tail;
        lock.unlock();
        WFrame& slot = W->ring[t_idx];
        av_frame_make_writable(frame);
        const int w = W->width, h = W->height;
        av_image_copy_plane(frame->data[0], frame->linesize[0], slot.y.data(),
                            w, w, h);
        av_image_copy_plane(frame->data[1], frame->linesize[1], slot.u.data(),
                            w / 2, w / 2, h / 2);
        av_image_copy_plane(frame->data[2], frame->linesize[2], slot.v.data(),
                            w / 2, w / 2, h / 2);
        {
            std::lock_guard<std::mutex> g(W->mu);
            W->tail = (t_idx + 1) % W->ring.size();
            --W->count;
        }
        W->cv_push.notify_one();
        frame->pts = W->next_pts++;  // only this thread touches next_pts
        if (avcodec_send_frame(W->enc, frame) < 0) {
            set_error(W, "send_frame failed", -3);
            break;
        }
        if (drain_encoder(W) < 0) break;
    }
    av_frame_free(&frame);
    {
        std::lock_guard<std::mutex> g(W->mu);  // see alloc-failure comment
        W->done = true;
    }
    W->cv_push.notify_all();
}

}  // namespace

extern "C" {

void* vaw_open(const char* dest, int w, int h, int fps_num, int fps_den,
               const char* encoder, int qp, const char* copy_from,
               double trim_start, double trim_end, int ring_frames) {
    av_log_set_level(AV_LOG_ERROR);  // x264 stats go through av_log(INFO)
    auto* W = new Writer();
    W->width = w;
    W->height = h;
    W->trim_start = trim_start > 0 ? trim_start : 0.0;
    W->trim_end = trim_end;

    if (avformat_alloc_output_context2(&W->ofmt, nullptr, nullptr, dest) < 0 ||
        !W->ofmt) {
        delete W;
        return nullptr;
    }
    const char* enc_name = (encoder && *encoder) ? encoder : "libx264";
    const AVCodec* codec = avcodec_find_encoder_by_name(enc_name);
    if (!codec) codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) codec = avcodec_find_encoder_by_name("mpeg4");
    if (!codec) {
        delete W;
        return nullptr;
    }
    W->enc = avcodec_alloc_context3(codec);
    W->enc->width = w;
    W->enc->height = h;
    W->enc->pix_fmt = AV_PIX_FMT_YUV420P;
    W->enc->time_base = AVRational{fps_den, fps_num};
    W->enc->framerate = AVRational{fps_num, fps_den};
    W->enc->thread_count = 0;  // auto
    if (W->ofmt->oformat->flags & AVFMT_GLOBALHEADER)
        W->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    AVDictionary* opts = nullptr;
    if (qp >= 0) {
        // The reference's constant-QP 19 "visually lossless" setting
        // (src/render.ts:12-19). x264/x265 take it as the private
        // "qp" option; other encoders (mpeg4 etc.) use the generic
        // constant-quantizer path — without this, mpeg4 fell back to
        // libav's default 200 kbps bit_rate (garbage at 1080p).
        if (std::strstr(codec->name, "x264") ||
            std::strstr(codec->name, "x265")) {
            char buf[16];
            std::snprintf(buf, sizeof(buf), "%d", qp);
            av_dict_set(&opts, "qp", buf, 0);
            av_dict_set(&opts, "preset", "fast", 0);
        } else {
            W->enc->flags |= AV_CODEC_FLAG_QSCALE;
            W->enc->global_quality = FF_QP2LAMBDA * qp;
        }
    }
    if (avcodec_open2(W->enc, codec, &opts) < 0) {
        av_dict_free(&opts);
        delete W;
        return nullptr;
    }
    av_dict_free(&opts);

    W->vstream = avformat_new_stream(W->ofmt, nullptr);
    if (!W->vstream ||
        avcodec_parameters_from_context(W->vstream->codecpar, W->enc) < 0) {
        delete W;
        return nullptr;
    }
    W->vstream->time_base = W->enc->time_base;

    if (copy_from && *copy_from) {
        if (avformat_open_input(&W->ifmt, copy_from, nullptr, nullptr) == 0 &&
            avformat_find_stream_info(W->ifmt, nullptr) >= 0) {
            W->map.assign(W->ifmt->nb_streams, -1);
            for (unsigned i = 0; i < W->ifmt->nb_streams; ++i) {
                AVStream* ist = W->ifmt->streams[i];
                const AVMediaType t = ist->codecpar->codec_type;
                if (t != AVMEDIA_TYPE_AUDIO && t != AVMEDIA_TYPE_DATA)
                    continue;  // video is re-encoded; drop subs/attachments
                AVStream* ost = avformat_new_stream(W->ofmt, nullptr);
                if (!ost ||
                    avcodec_parameters_copy(ost->codecpar, ist->codecpar) <
                        0) {
                    // A half-built stream (empty codecpar) would make
                    // write_header emit a bogus track; fail loudly —
                    // this is OOM territory, not a recoverable skip.
                    delete W;
                    return nullptr;
                }
                // Keep the source tag (GoPro's GPMF data track is 'gpmd');
                // the mov muxer preserves data tracks by tag.
                ost->time_base = ist->time_base;
                W->map[i] = ost->index;
            }
            if (W->trim_start > 0) {
                // Stream-copy analogue of the decode-side trim seek:
                // without it an end-of-file render demuxes (and drops)
                // every prefix packet. Keyframe-backward; the pre-window
                // packets after the landing point are still dropped by
                // pump_passthrough's t < 0 filter, so a failed seek on
                // an unseekable container stays correct, merely slower.
                av_seek_frame(W->ifmt, -1,
                              (int64_t)llround(W->trim_start * AV_TIME_BASE),
                              AVSEEK_FLAG_BACKWARD);
            }
        } else if (W->ifmt) {
            avformat_close_input(&W->ifmt);
        }
    }

    if (!(W->ofmt->oformat->flags & AVFMT_NOFILE)) {
        if (avio_open(&W->ofmt->pb, dest, AVIO_FLAG_WRITE) < 0) {
            delete W;
            return nullptr;
        }
    }
    if (avformat_write_header(W->ofmt, nullptr) < 0) {
        delete W;
        return nullptr;
    }

    const size_t ysz = (size_t)w * h;
    int n = ring_frames > 0 ? ring_frames : 8;
    W->ring.resize(n);
    for (auto& f : W->ring) {
        f.y.resize(ysz);
        f.u.resize(ysz / 4);
        f.v.resize(ysz / 4);
    }
    W->worker = std::thread(encode_loop, W);
    return W;
}

int vaw_write(void* h, const uint8_t* y, const uint8_t* u, const uint8_t* v) {
    auto* W = static_cast<Writer*>(h);
    // Reserve the head slot under the lock, memcpy outside it (see
    // encode_loop), commit with count++. Single producer: head is
    // stable between the reserve and the commit, and the consumer
    // never reads a slot count doesn't cover.
    size_t h_idx;
    {
        std::unique_lock<std::mutex> lock(W->mu);
        W->cv_push.wait(lock,
                        [&] { return W->count < W->ring.size() || W->done; });
        if (W->done) return W->status ? W->status : -1;
        h_idx = W->head;
    }
    WFrame& slot = W->ring[h_idx];
    std::memcpy(slot.y.data(), y, slot.y.size());
    std::memcpy(slot.u.data(), u, slot.u.size());
    std::memcpy(slot.v.data(), v, slot.v.size());
    {
        std::lock_guard<std::mutex> g(W->mu);
        W->head = (h_idx + 1) % W->ring.size();
        ++W->count;
    }
    W->cv_pop.notify_one();
    return 1;
}

int vaw_close(void* h) {
    auto* W = static_cast<Writer*>(h);
    {
        std::lock_guard<std::mutex> g(W->mu);
        W->flush = true;
    }
    W->cv_pop.notify_all();
    if (W->worker.joinable()) W->worker.join();
    int status = W->status;
    if (W->ofmt && status == 0) {
        if (av_write_trailer(W->ofmt) < 0) status = -6;
    }
    delete W;
    return status;
}

const char* vaw_error(void* h) {
    return static_cast<Writer*>(h)->error.c_str();
}

}  // extern "C"
