// codec_native.cpp — audio codec round-trip + compressed-file decode on top of
// the system FFmpeg libraries (libavcodec/libavformat/libswresample, 5.1 API).
// A copy of the JAX package's csrc/codec_native.cpp; only this comment differs.
//
// Replaces the reference's torchaudio.io.AudioEffector / libavcodec codec
// augmentation path (simulation/simulate_data_from_param.py:296-330 of the
// reference) and its soundfile/librosa mp3/ogg corpus reads, without requiring
// the ffmpeg CLI or torchaudio: only the shared libraries and their headers.
//
// Exported C API (ctypes-friendly, see utils/codec_av.py):
//   cn_roundtrip   — encode mono float PCM into a container+codec in memory,
//                    decode it back, resampled to the input rate.  Mirrors
//                    AudioEffector(format=..., encoder=..., CodecConfig(qscale)).
//   cn_probe_file  — container-level (duration, fs, channels) without decoding.
//   cn_decode_file — full decode of any FFmpeg-readable audio file to
//                    interleaved float32 at native rate/channels.
//
// All functions return >=0 on success and a negative AVERROR on failure.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Pick the encoder sample format: prefer planar/packed float, else first listed.
AVSampleFormat pick_sample_fmt(const AVCodec* codec) {
    if (!codec->sample_fmts) return AV_SAMPLE_FMT_FLTP;
    for (const AVSampleFormat* f = codec->sample_fmts; *f != AV_SAMPLE_FMT_NONE; ++f)
        if (*f == AV_SAMPLE_FMT_FLTP || *f == AV_SAMPLE_FMT_FLT) return *f;
    return codec->sample_fmts[0];
}

int pick_sample_rate(const AVCodec* codec, int want) {
    if (!codec->supported_samplerates) return want;
    int best = 0;
    for (const int* r = codec->supported_samplerates; *r; ++r) {
        if (*r == want) return want;
        // first pass: nearest by absolute distance; second pass below then
        // prefers the smallest rate >= want when one exists (so we only
        // ever downsample if no codec rate reaches `want`)
        if (best == 0 || (std::abs(*r - want) < std::abs(best - want))) best = *r;
    }
    for (const int* r = codec->supported_samplerates; *r; ++r)
        if (*r >= want && (best < want || *r < best)) best = *r;
    return best ? best : want;
}

struct MemReader {
    const uint8_t* data;
    int64_t size;
    int64_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
    MemReader* m = static_cast<MemReader*>(opaque);
    int64_t left = m->size - m->pos;
    if (left <= 0) return AVERROR_EOF;
    int n = static_cast<int>(std::min<int64_t>(buf_size, left));
    memcpy(buf, m->data + m->pos, n);
    m->pos += n;
    return n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
    MemReader* m = static_cast<MemReader*>(opaque);
    if (whence == AVSEEK_SIZE) return m->size;
    whence &= ~AVSEEK_FORCE;
    int64_t target = whence == SEEK_CUR ? m->pos + offset
                   : whence == SEEK_END ? m->size + offset
                                        : offset;
    if (target < 0 || target > m->size) return AVERROR(EINVAL);
    m->pos = target;
    return target;
}

// Encode mono float PCM at in_fs into `bytes` using container fmt_name and
// (optionally named) encoder with AudioEffector-style qscale semantics.
int encode_mono(const float* in, int64_t n, int in_fs, const char* fmt_name,
                const char* enc_name, int qscale, std::vector<uint8_t>& bytes) {
    AVFormatContext* oc = nullptr;
    int ret = avformat_alloc_output_context2(&oc, nullptr, fmt_name, nullptr);
    if (ret < 0) return ret;

    // Candidate encoders, tried in order: FFmpeg's native "vorbis"/"opus"
    // encoders are experimental (vorbis is also stereo-only), so the lib*
    // wrappers with the same bitstream format are kept as fallbacks — the
    // distortion class is what matters for augmentation parity.
    std::vector<const AVCodec*> candidates;
    if (enc_name && enc_name[0]) {
        if (const AVCodec* c = avcodec_find_encoder_by_name(enc_name)) candidates.push_back(c);
        if (!strcmp(enc_name, "vorbis"))
            if (const AVCodec* c = avcodec_find_encoder_by_name("libvorbis")) candidates.push_back(c);
        if (!strcmp(enc_name, "opus"))
            if (const AVCodec* c = avcodec_find_encoder_by_name("libopus")) candidates.push_back(c);
    } else {
        if (const AVCodec* c = avcodec_find_encoder(oc->oformat->audio_codec)) candidates.push_back(c);
        if (oc->oformat->audio_codec == AV_CODEC_ID_VORBIS)
            if (const AVCodec* c = avcodec_find_encoder_by_name("libvorbis")) candidates.push_back(c);
    }
    if (candidates.empty()) { avformat_free_context(oc); return AVERROR_ENCODER_NOT_FOUND; }

    AVCodecContext* ctx = nullptr;
    const AVCodec* codec = nullptr;
    int enc_fs = in_fs;
    ret = AVERROR_ENCODER_NOT_FOUND;
    // expected failures while probing candidates (e.g. native vorbis is
    // stereo-only) would spam stderr from every dataloader worker
    av_log_set_level(AV_LOG_FATAL);
    for (const AVCodec* cand : candidates) {
        ctx = avcodec_alloc_context3(cand);
        if (!ctx) { avformat_free_context(oc); return AVERROR(ENOMEM); }
        enc_fs = pick_sample_rate(cand, in_fs);
        ctx->sample_rate = enc_fs;
        av_channel_layout_default(&ctx->ch_layout, 1);
        ctx->sample_fmt = pick_sample_fmt(cand);
        ctx->time_base = AVRational{1, enc_fs};
        // experimental native encoders (e.g. opus) need this to open
        ctx->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
        if (qscale > -1000) {
            // torchaudio CodecConfig(qscale=q): AV_CODEC_FLAG_QSCALE +
            // global_quality = FF_QP2LAMBDA * q  (lame: VBR -V q; vorbis: -q q)
            ctx->flags |= AV_CODEC_FLAG_QSCALE;
            ctx->global_quality = FF_QP2LAMBDA * qscale;
        }
        if (oc->oformat->flags & AVFMT_GLOBALHEADER)
            ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        ret = avcodec_open2(ctx, cand, nullptr);
        if (ret >= 0) { codec = cand; break; }
        avcodec_free_context(&ctx);
        ctx = nullptr;
    }
    av_log_set_level(AV_LOG_ERROR);
    if (!codec) { avformat_free_context(oc); return ret; }

    SwrContext* swr = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    AVStream* st = nullptr;
    uint8_t* conv = nullptr;
    uint8_t* dyn_buf = nullptr;

    auto fail = [&](int err) {
        if (swr) swr_free(&swr);
        if (frame) av_frame_free(&frame);
        if (pkt) av_packet_free(&pkt);
        if (conv) av_freep(&conv);
        avcodec_free_context(&ctx);
        if (oc) {
            if (oc->pb) {
                int sz = avio_close_dyn_buf(oc->pb, &dyn_buf);
                (void)sz;
                if (dyn_buf) av_free(dyn_buf);
                oc->pb = nullptr;
            }
            avformat_free_context(oc);
        }
        return err;
    };

    st = avformat_new_stream(oc, nullptr);
    if (!st) return fail(AVERROR(ENOMEM));
    st->time_base = ctx->time_base;
    if ((ret = avcodec_parameters_from_context(st->codecpar, ctx)) < 0) return fail(ret);

    // one-shot resample/format-convert the whole mono signal
    AVChannelLayout mono;
    av_channel_layout_default(&mono, 1);
    ret = swr_alloc_set_opts2(&swr, &mono, ctx->sample_fmt, enc_fs,
                              &mono, AV_SAMPLE_FMT_FLT, in_fs, 0, nullptr);
    if (ret < 0 || (ret = swr_init(swr)) < 0) return fail(ret);
    int64_t max_out = av_rescale_rnd(n + 4096, enc_fs, in_fs, AV_ROUND_UP) + 4096;
    int linesize = 0;
    ret = av_samples_alloc(&conv, &linesize, 1, (int)max_out, ctx->sample_fmt, 0);
    if (ret < 0) return fail(ret);
    const uint8_t* in_planes[1] = {reinterpret_cast<const uint8_t*>(in)};
    int n_conv = swr_convert(swr, &conv, (int)max_out, in_planes, (int)n);
    if (n_conv < 0) return fail(n_conv);
    {   // drain the resampler tail into the same buffer
        uint8_t* tail = conv + (int64_t)n_conv * av_get_bytes_per_sample(ctx->sample_fmt);
        int got = swr_convert(swr, &tail, (int)(max_out - n_conv), nullptr, 0);
        if (got > 0) n_conv += got;
    }

    if ((ret = avio_open_dyn_buf(&oc->pb)) < 0) return fail(ret);
    if ((ret = avformat_write_header(oc, nullptr)) < 0) return fail(ret);

    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    if (!frame || !pkt) return fail(AVERROR(ENOMEM));

    int frame_size = ctx->frame_size > 0 ? ctx->frame_size : 4096;
    int bps = av_get_bytes_per_sample(ctx->sample_fmt);
    int64_t pos = 0, pts = 0;

    auto drain = [&](bool flushing) -> int {
        int r = avcodec_send_frame(ctx, flushing ? nullptr : frame);
        if (r < 0 && !(flushing && r == AVERROR_EOF)) return r;
        while (true) {
            r = avcodec_receive_packet(ctx, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
            if (r < 0) return r;
            av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
            pkt->stream_index = st->index;
            r = av_interleaved_write_frame(oc, pkt);
            if (r < 0) return r;
        }
    };

    while (pos < n_conv) {
        int this_n = (int)std::min<int64_t>(frame_size, n_conv - pos);
        frame->nb_samples = this_n;
        frame->format = ctx->sample_fmt;
        av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
        frame->sample_rate = enc_fs;
        if ((ret = av_frame_get_buffer(frame, 0)) < 0) return fail(ret);
        memcpy(frame->data[0], conv + pos * bps, (size_t)this_n * bps);
        frame->pts = pts;
        pts += this_n;
        if ((ret = drain(false)) < 0) return fail(ret);
        av_frame_unref(frame);
        pos += this_n;
    }
    if ((ret = drain(true)) < 0) return fail(ret);
    if ((ret = av_write_trailer(oc)) < 0) return fail(ret);

    int size = avio_close_dyn_buf(oc->pb, &dyn_buf);
    oc->pb = nullptr;
    bytes.assign(dyn_buf, dyn_buf + size);
    av_free(dyn_buf);

    swr_free(&swr);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    av_freep(&conv);
    avcodec_free_context(&ctx);
    avformat_free_context(oc);

    return 0;
}

// Decode an opened AVFormatContext's best audio stream.  If want_fs > 0 the
// output is mono float at want_fs; otherwise interleaved float at the native
// rate/channels (reported via fs_out/ch_out).
int decode_fmt_ctx(AVFormatContext* ic, int want_fs, std::vector<float>& out,
                   int* fs_out, int* ch_out) {
    int ret = avformat_find_stream_info(ic, nullptr);
    if (ret < 0) return ret;
    const AVCodec* dec = nullptr;
    int sidx = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (sidx < 0) return sidx;
    AVStream* st = ic->streams[sidx];
    AVCodecContext* ctx = avcodec_alloc_context3(dec);
    if (!ctx) return AVERROR(ENOMEM);
    ret = avcodec_parameters_to_context(ctx, st->codecpar);
    if (ret < 0) { avcodec_free_context(&ctx); return ret; }
    ctx->pkt_timebase = st->time_base;
    if ((ret = avcodec_open2(ctx, dec, nullptr)) < 0) {
        avcodec_free_context(&ctx);
        return ret;
    }

    SwrContext* swr = nullptr;
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    std::vector<uint8_t> swr_buf;
    int out_ch = 0, out_fs = 0;

    auto cleanup = [&]() {
        if (swr) swr_free(&swr);
        av_packet_free(&pkt);
        av_frame_free(&frame);
        avcodec_free_context(&ctx);
    };
    if (!pkt || !frame) { cleanup(); return AVERROR(ENOMEM); }

    auto push_frame = [&](AVFrame* f) -> int {
        if (!swr) {
            out_fs = want_fs > 0 ? want_fs : f->sample_rate;
            // zero-init: av_channel_layout_copy uninits dst first, which
            // would free a garbage map pointer on an uninitialized struct
            AVChannelLayout out_layout = {};
            if (want_fs > 0) {
                av_channel_layout_default(&out_layout, 1);
                out_ch = 1;
            } else {
                av_channel_layout_copy(&out_layout, &f->ch_layout);
                out_ch = f->ch_layout.nb_channels;
            }
            int r = swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT, out_fs,
                                        &f->ch_layout, (AVSampleFormat)f->format,
                                        f->sample_rate, 0, nullptr);
            av_channel_layout_uninit(&out_layout);  // swr keeps its own copy
            if (r < 0) return r;
            if ((r = swr_init(swr)) < 0) return r;
        }
        int64_t cap = av_rescale_rnd(swr_get_delay(swr, f->sample_rate) + f->nb_samples,
                                     out_fs, f->sample_rate, AV_ROUND_UP) + 256;
        swr_buf.resize((size_t)cap * out_ch * sizeof(float));
        uint8_t* planes[1] = {swr_buf.data()};
        int got = swr_convert(swr, planes, (int)cap,
                              const_cast<const uint8_t**>(f->extended_data), f->nb_samples);
        if (got < 0) return got;
        const float* p = reinterpret_cast<const float*>(swr_buf.data());
        out.insert(out.end(), p, p + (size_t)got * out_ch);
        return 0;
    };

    while ((ret = av_read_frame(ic, pkt)) >= 0) {
        if (pkt->stream_index != sidx) { av_packet_unref(pkt); continue; }
        ret = avcodec_send_packet(ctx, pkt);
        av_packet_unref(pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) { cleanup(); return ret; }
        while ((ret = avcodec_receive_frame(ctx, frame)) >= 0) {
            if ((ret = push_frame(frame)) < 0) { cleanup(); return ret; }
            av_frame_unref(frame);
        }
        if (ret != AVERROR(EAGAIN) && ret != AVERROR_EOF) { cleanup(); return ret; }
    }
    // flush decoder
    avcodec_send_packet(ctx, nullptr);
    while ((ret = avcodec_receive_frame(ctx, frame)) >= 0) {
        if ((ret = push_frame(frame)) < 0) { cleanup(); return ret; }
        av_frame_unref(frame);
    }
    // flush resampler tail
    if (swr) {
        int64_t cap = 4096;
        swr_buf.resize((size_t)cap * out_ch * sizeof(float));
        uint8_t* planes[1] = {swr_buf.data()};
        int got = swr_convert(swr, planes, (int)cap, nullptr, 0);
        if (got > 0) {
            const float* p = reinterpret_cast<const float*>(swr_buf.data());
            out.insert(out.end(), p, p + (size_t)got * out_ch);
        }
    }
    if (fs_out) *fs_out = out_fs;
    if (ch_out) *ch_out = out_ch;
    cleanup();
    return 0;
}

int decode_bytes(const std::vector<uint8_t>& bytes, int want_fs,
                 std::vector<float>& out, int* fs_out, int* ch_out) {
    MemReader reader{bytes.data(), (int64_t)bytes.size(), 0};
    const int buf_sz = 1 << 15;
    uint8_t* avio_buf = static_cast<uint8_t*>(av_malloc(buf_sz));
    if (!avio_buf) return AVERROR(ENOMEM);
    AVIOContext* avio = avio_alloc_context(avio_buf, buf_sz, 0, &reader,
                                           mem_read, nullptr, mem_seek);
    if (!avio) { av_free(avio_buf); return AVERROR(ENOMEM); }
    AVFormatContext* ic = avformat_alloc_context();
    if (!ic) { avio_context_free(&avio); return AVERROR(ENOMEM); }
    ic->pb = avio;
    int ret = avformat_open_input(&ic, nullptr, nullptr, nullptr);
    if (ret < 0) {
        // open_input frees ic on failure but not the AVIO context
        av_freep(&avio->buffer);
        avio_context_free(&avio);
        return ret;
    }
    ret = decode_fmt_ctx(ic, want_fs, out, fs_out, ch_out);
    avformat_close_input(&ic);
    av_freep(&avio->buffer);
    avio_context_free(&avio);
    return ret;
}

}  // namespace

extern "C" {

// Encode+decode round-trip on mono float PCM, AudioEffector semantics
// (reference simulate_data_from_param.py:296-330).  qscale == -1000 leaves the
// encoder at its default rate control.  Writes up to out_cap samples; returns
// the full decoded length (caller re-calls with a larger buffer if needed).
long long cn_roundtrip(const float* in, long long n, int fs, const char* fmt,
                       const char* enc, int qscale, float* out, long long out_cap) {
    av_log_set_level(AV_LOG_ERROR);
    std::vector<uint8_t> bytes;
    int ret = encode_mono(in, n, fs, fmt, enc, qscale, bytes);
    if (ret < 0) return ret;
    std::vector<float> dec;
    dec.reserve((size_t)n + fs);
    ret = decode_bytes(bytes, fs, dec, nullptr, nullptr);
    if (ret < 0) return ret;
    long long m = (long long)dec.size();
    if (out && out_cap > 0)
        memcpy(out, dec.data(), sizeof(float) * (size_t)std::min<long long>(m, out_cap));
    return m;
}

// Container-level probe: *nb_samples is an estimate from the container
// duration (exact for WAV/FLAC, Xing-accurate for LAME mp3).
long long cn_probe_file(const char* path, int* fs_out, int* ch_out) {
    av_log_set_level(AV_LOG_ERROR);
    AVFormatContext* ic = nullptr;
    int ret = avformat_open_input(&ic, path, nullptr, nullptr);
    if (ret < 0) return ret;
    ret = avformat_find_stream_info(ic, nullptr);
    if (ret < 0) { avformat_close_input(&ic); return ret; }
    int sidx = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
    if (sidx < 0) { avformat_close_input(&ic); return sidx; }
    AVStream* st = ic->streams[sidx];
    int fs = st->codecpar->sample_rate;
    if (fs_out) *fs_out = fs;
    if (ch_out) *ch_out = st->codecpar->ch_layout.nb_channels;
    long long n = 0;
    if (st->nb_frames > 0 && st->codecpar->frame_size > 0)
        n = st->nb_frames * st->codecpar->frame_size;
    if (st->duration > 0 && st->duration != AV_NOPTS_VALUE)
        n = av_rescale(st->duration, (int64_t)fs * st->time_base.num, st->time_base.den);
    else if (ic->duration > 0 && ic->duration != AV_NOPTS_VALUE)
        n = av_rescale(ic->duration, fs, AV_TIME_BASE);
    avformat_close_input(&ic);
    return n;
}

// Full decode to interleaved float32 at the file's native rate/channels.
// Returns total floats (samples * channels); fills out up to out_cap floats.
long long cn_decode_file(const char* path, float* out, long long out_cap,
                         int* fs_out, int* ch_out) {
    av_log_set_level(AV_LOG_ERROR);
    AVFormatContext* ic = nullptr;
    int ret = avformat_open_input(&ic, path, nullptr, nullptr);
    if (ret < 0) return ret;
    std::vector<float> dec;
    ret = decode_fmt_ctx(ic, 0, dec, fs_out, ch_out);
    avformat_close_input(&ic);
    if (ret < 0) return ret;
    long long m = (long long)dec.size();
    if (out && out_cap > 0)
        memcpy(out, dec.data(), sizeof(float) * (size_t)std::min<long long>(m, out_cap));
    return m;
}

}  // extern "C"
