// Native video loader: threaded libav decode -> planar YUV 4:2:0 ring buffer.
//
// Native counterpart of the reference's decode stack
// (opencv/AvFrameSourceFileVaapi.cpp: demux + decode;
// opencv/AvFrameSourceMapOpenCl.cpp + FrameSourceFfmpegOpenCl.cpp: surface
// transfer into the compute runtime's memory). Here the "device interop" is
// a lock-free-enough pinned ring of host frames that the Python feeder
// overlaps with jax.device_put, and decoding runs on a dedicated thread
// (plus libavcodec's internal frame threading) so the device never waits on
// the demuxer.
//
// C ABI (consumed via ctypes — no pybind11 in this image):
//   void* va_open(const char* path, int ring_frames);
//   void* va_open_seek(const char* path, int ring_frames, long start_frame);
//   long  va_start_frame(void* h);  // index of the first frame va_next yields
//   int   va_meta(void* h, int* w, int* h_, int* fps_num, int* fps_den,
//                 long* nframes);
//   int   va_next(void* h, uint8_t* y, uint8_t* u, uint8_t* v);  // 1 ok, 0 eof, <0 err
//   long  va_frame_index(void* h);
//   void  va_close(void* h);
//   const char* va_error(void* h);
//
// va_open_seek is the ffmpeg `-ss` analogue the reference leans on for its
// trimmed renders (fluent-ffmpeg seek, src/render.ts:1369-1373; concat.sh's
// split stage renders -s/-e windows out of hour-long matches): demuxer-level
// keyframe seek, then decode-and-drop (no sws_scale, no ring traffic) up to
// the exact requested frame. Without it every `render -s N` decodes the
// whole prefix.

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
#include <libswscale/swscale.h>
}

namespace {

struct Frame {
    std::vector<uint8_t> y, u, v;
    bool eof = false;
    bool err = false;  // decode error: va_next returns <0, not clean EOF
};

struct Loader {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwsContext* sws = nullptr;
    int stream_index = -1;
    int width = 0, height = 0;
    AVRational fps{30, 1};
    int64_t nframes = 0;

    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    std::vector<Frame> ring;
    size_t head = 0, tail = 0, count = 0;
    std::atomic<bool> stop{false};
    std::atomic<long> frame_index{-1};
    std::string error;

    // Trim seek: frames before start_frame are decoded (from the seeked-to
    // keyframe) but dropped before sws_scale / the ring. When the demuxer
    // seek failed, decoding starts at frame 0 and the drop window covers
    // the whole prefix — still cheaper than pushing frames Python discards.
    int64_t start_frame = 0;
    int64_t last_idx = -1;      // source index of the last decoded frame
    AVRational time_base{1, 1};
    int64_t stream_start_ts = 0;

    ~Loader() {
        {
            // The flag is atomic, but it must still be SET under the mutex:
            // a waiter that evaluated its predicate false and is between
            // unlock and block would otherwise miss the notify forever.
            std::lock_guard<std::mutex> g(mu);
            stop = true;
        }
        cv_push.notify_all();
        cv_pop.notify_all();
        if (worker.joinable()) worker.join();
        if (sws) sws_freeContext(sws);
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
    }
};

void push_frame(Loader* L, AVFrame* frame, bool err = false) {
    // Reserve the head slot under the lock, but run sws_scale OUTSIDE
    // it: the colorspace conversion is the producer's most expensive
    // per-frame work, and doing it in the critical section serializes
    // it against the consumer's memcpy — the overlap the ring exists
    // to provide. The reserved slot is invisible to the consumer until
    // the count++ commit (single producer, so head is stable).
    size_t slot_idx;
    {
        std::unique_lock<std::mutex> lock(L->mu);
        L->cv_push.wait(lock,
                        [&] { return L->count < L->ring.size() || L->stop; });
        if (L->stop) return;
        slot_idx = L->head;
    }
    Frame& slot = L->ring[slot_idx];
    slot.err = err;
    if (frame == nullptr) {
        slot.eof = true;
    } else {
        slot.eof = false;
        // Dimensions are even-cropped at open; sws scales odd sources
        // down by one pixel so chroma planes are exactly (h/2, w/2).
        const int w = L->width;
        uint8_t* dst[3] = {slot.y.data(), slot.u.data(), slot.v.data()};
        int dst_stride[3] = {w, w / 2, w / 2};
        sws_scale(L->sws, frame->data, frame->linesize, 0, frame->height,
                  dst, dst_stride);
    }
    {
        std::lock_guard<std::mutex> g(L->mu);
        if (L->stop) return;
        L->head = (L->head + 1) % L->ring.size();
        ++L->count;
    }
    L->cv_pop.notify_one();
}

void decode_loop(Loader* L) {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    bool flushing = false;
    while (!L->stop) {
        if (!flushing) {
            int r = av_read_frame(L->fmt, pkt);
            if (r < 0) {
                flushing = true;
                avcodec_send_packet(L->dec, nullptr);
            } else {
                if (pkt->stream_index == L->stream_index) {
                    avcodec_send_packet(L->dec, pkt);
                }
                av_packet_unref(pkt);
            }
        }
        while (!L->stop) {
            int r = avcodec_receive_frame(L->dec, frame);
            if (r == AVERROR(EAGAIN)) break;
            if (r == AVERROR_EOF) {
                push_frame(L, nullptr);
                goto done;
            }
            if (r < 0) {
                {
                    // Scoped: push_frame() locks the same (non-recursive)
                    // mutex — holding it across the call self-deadlocks.
                    std::lock_guard<std::mutex> g(L->mu);
                    char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
                    av_make_error_string(buf, sizeof(buf), r);
                    L->error = std::string("decode error: ") + buf;
                }
                push_frame(L, nullptr, /*err=*/true);
                goto done;
            }
            // Source frame index from the presentation timestamp (the
            // demuxer seek lands on the preceding keyframe, so the drop
            // window must be pts-exact, matching Python's
            // round(start_s * fps) trim arithmetic). Pts-less frames
            // (raw streams) count on from the last known index.
            int64_t bet = frame->best_effort_timestamp;
            int64_t idx;
            if (bet != AV_NOPTS_VALUE) {
                double t = (bet - L->stream_start_ts) * av_q2d(L->time_base);
                idx = llround(t * L->fps.num / (double)L->fps.den);
            } else {
                idx = L->last_idx + 1;
            }
            L->last_idx = idx;
            // Only drop inside an explicit trim window: without a seek,
            // a container whose first pts sits below stream start_time
            // (negative idx) must still deliver every frame.
            if (L->start_frame > 0 && idx < L->start_frame) {
                av_frame_unref(frame);
                continue;
            }
            push_frame(L, frame);
            av_frame_unref(frame);
        }
    }
done:
    av_packet_free(&pkt);
    av_frame_free(&frame);
}

// Decode the first frame synchronously and report whether it carries a
// best-effort timestamp (*idx set from it; 0 otherwise). Returns false
// if nothing could be decoded (empty/corrupt stream) — the worker loop
// will rediscover and report that through the normal error path.
bool probe_first_pts(Loader* L, bool* have_pts, int64_t* idx) {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    *have_pts = false;
    *idx = 0;
    bool decoded = false, input_eof = false;
    while (!decoded) {
        if (!input_eof) {
            int r = av_read_frame(L->fmt, pkt);
            if (r < 0) {
                input_eof = true;
                avcodec_send_packet(L->dec, nullptr);
            } else {
                if (pkt->stream_index == L->stream_index)
                    avcodec_send_packet(L->dec, pkt);
                av_packet_unref(pkt);
            }
        }
        int rr = avcodec_receive_frame(L->dec, frame);
        if (rr == AVERROR(EAGAIN)) {
            if (input_eof) break;
            continue;
        }
        if (rr < 0) break;  // EOF or decode error
        decoded = true;
        int64_t bet = frame->best_effort_timestamp;
        if (bet != AV_NOPTS_VALUE) {
            *have_pts = true;
            double t = (bet - L->stream_start_ts) * av_q2d(L->time_base);
            *idx = llround(t * L->fps.num / (double)L->fps.den);
        }
        av_frame_unref(frame);
    }
    av_packet_free(&pkt);
    av_frame_free(&frame);
    return decoded;
}

void* open_impl(const char* path, int ring_frames, long start_frame) {
    auto* L = new Loader();
    if (avformat_open_input(&L->fmt, path, nullptr, nullptr) < 0) {
        delete L;
        return nullptr;
    }
    if (avformat_find_stream_info(L->fmt, nullptr) < 0) {
        delete L;
        return nullptr;
    }
    const AVCodec* codec = nullptr;
    L->stream_index =
        av_find_best_stream(L->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (L->stream_index < 0 || codec == nullptr) {
        delete L;
        return nullptr;
    }
    AVStream* st = L->fmt->streams[L->stream_index];
    L->dec = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(L->dec, st->codecpar);
    L->dec->thread_count = 0;  // auto frame/slice threading
    if (avcodec_open2(L->dec, codec, nullptr) < 0) {
        delete L;
        return nullptr;
    }
    // Even-crop: 4:2:0 chroma planes must be exactly (h/2, w/2) — odd
    // display dimensions would otherwise overflow the ring slots (sized
    // w*h/4) and the consumer's (h//2, w//2) buffers.
    L->width = L->dec->width & ~1;
    L->height = L->dec->height & ~1;
    if (L->width <= 0 || L->height <= 0) {
        delete L;
        return nullptr;
    }
    L->fps = st->avg_frame_rate.num ? st->avg_frame_rate : AVRational{30, 1};
    L->nframes = st->nb_frames;
    L->time_base = st->time_base.num ? st->time_base : AVRational{1, 1};
    L->stream_start_ts =
        st->start_time != AV_NOPTS_VALUE ? st->start_time : 0;

    if (start_frame > 0) {
        L->start_frame = start_frame;
        L->frame_index = start_frame - 1;
        // The pts drop window can only locate itself after a demuxer
        // seek if frames carry timestamps, so probe the FIRST frame.
        // With timestamps: keyframe-backward seek toward the request;
        // exactness comes from the pts window in decode_loop (a failed
        // seek on an unseekable container just decodes on from the
        // probe through the same window — correct, merely slower).
        // Without timestamps: do NOT seek — the counting fallback
        // numbers frames from last_idx, and counting from a seek point
        // would drop start_frame frames from the KEYFRAME instead of
        // from frame 0 (yielding the wrong section of the video). The
        // probed frame is index 0, pre-window, so it is droppable.
        bool have_pts = false;
        int64_t first_idx = 0;
        const bool decoded = probe_first_pts(L, &have_pts, &first_idx);
        if (decoded && have_pts) {
            double t = start_frame * L->fps.den / (double)L->fps.num;
            int64_t target = L->stream_start_ts +
                             (int64_t)llround(t / av_q2d(L->time_base));
            if (av_seek_frame(L->fmt, L->stream_index, target,
                              AVSEEK_FLAG_BACKWARD) >= 0) {
                avcodec_flush_buffers(L->dec);
            }
        } else if (decoded) {
            L->last_idx = first_idx;  // counting resumes at frame 1
        }
        // decoded == false: empty/corrupt stream; the worker loop will
        // surface EOF/error through the normal path.
    }

    L->sws = sws_getContext(L->dec->width, L->dec->height, L->dec->pix_fmt,
                            L->width, L->height, AV_PIX_FMT_YUV420P,
                            SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!L->sws) {
        delete L;
        return nullptr;
    }

    const size_t ysz = (size_t)L->width * L->height;
    const size_t csz = ysz / 4;
    int n = ring_frames > 0 ? ring_frames : 8;
    L->ring.resize(n);
    for (auto& f : L->ring) {
        f.y.resize(ysz);
        f.u.resize(csz);
        f.v.resize(csz);
    }
    L->worker = std::thread(decode_loop, L);
    return L;
}

}  // namespace

extern "C" {

void* va_open(const char* path, int ring_frames) {
    return open_impl(path, ring_frames, 0);
}

void* va_open_seek(const char* path, int ring_frames, long start_frame) {
    return open_impl(path, ring_frames, start_frame > 0 ? start_frame : 0);
}

long va_start_frame(void* h) {
    return (long)static_cast<Loader*>(h)->start_frame;
}

int va_meta(void* h, int* w, int* ht, int* fps_num, int* fps_den,
            long* nframes) {
    auto* L = static_cast<Loader*>(h);
    *w = L->width;
    *ht = L->height;
    *fps_num = L->fps.num;
    *fps_den = L->fps.den;
    *nframes = (long)L->nframes;
    return 0;
}

int va_next(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
    auto* L = static_cast<Loader*>(h);
    // Mirror of push_frame: claim the tail slot under the lock, memcpy
    // outside it (the consumer's expensive step), commit under the
    // lock. The producer can't touch this slot while count still
    // includes it (head == tail only at count 0 or full, and full
    // blocks the producer).
    size_t t;
    {
        std::unique_lock<std::mutex> lock(L->mu);
        L->cv_pop.wait(lock, [&] { return L->count > 0 || L->stop; });
        if (L->stop && L->count == 0) return 0;
        Frame& slot = L->ring[L->tail];
        if (slot.eof) return slot.err ? -1 : 0;
        t = L->tail;
    }
    Frame& slot = L->ring[t];
    std::memcpy(y, slot.y.data(), slot.y.size());
    std::memcpy(u, slot.u.data(), slot.u.size());
    std::memcpy(v, slot.v.data(), slot.v.size());
    {
        std::lock_guard<std::mutex> g(L->mu);
        L->tail = (t + 1) % L->ring.size();
        --L->count;
    }
    L->frame_index.fetch_add(1);
    L->cv_push.notify_one();
    return 1;
}

long va_frame_index(void* h) {
    return static_cast<Loader*>(h)->frame_index.load();
}

const char* va_error(void* h) {
    return static_cast<Loader*>(h)->error.c_str();
}

void va_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
