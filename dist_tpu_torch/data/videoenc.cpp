// A small mp4 writer: BGR24 frames through libswscale to YUV 4:2:0 and
// libavcodec's MPEG-4 Part 2 encoder (the encoder behind OpenCV's "mp4v"
// fourcc) into an MP4 container by libavformat.
//
// C interface, bound by ctypes (dist_tpu_torch/data/native_encoder.py):
//   dist_video_writer_open(path, width, height, fps, err, errlen) -> handle
//   dist_video_writer_write(handle, bgr)        one width x height x 3 frame
//   dist_video_writer_close(handle)             flush, trailer, free
// Each returns 0 (or a handle) on success; a failure writes its reason
// into `err` (open) or returns a negative code.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct Writer {
  AVFormatContext* oc = nullptr;
  AVCodecContext* c = nullptr;
  AVStream* st = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  int64_t next_pts = 0;
  int width = 0, height = 0;
};

void free_writer(Writer* w) {
  if (!w) return;
  if (w->sws) sws_freeContext(w->sws);
  if (w->frame) av_frame_free(&w->frame);
  if (w->pkt) av_packet_free(&w->pkt);
  if (w->c) avcodec_free_context(&w->c);
  if (w->oc) {
    if (w->oc->pb) avio_closep(&w->oc->pb);
    avformat_free_context(w->oc);
  }
  delete w;
}

void say(char* err, int errlen, const char* what, int rc) {
  if (!err || errlen <= 0) return;
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  if (rc < 0) av_strerror(rc, buf, sizeof(buf));
  std::snprintf(err, errlen, "%s%s%s", what, rc < 0 ? ": " : "", buf);
}

// Send `frame` (nullptr: flush) and write every packet it gives.
int encode(Writer* w, AVFrame* frame) {
  int rc = avcodec_send_frame(w->c, frame);
  if (rc < 0) return rc;
  while (true) {
    rc = avcodec_receive_packet(w->c, w->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    av_packet_rescale_ts(w->pkt, w->c->time_base, w->st->time_base);
    w->pkt->stream_index = w->st->index;
    rc = av_interleaved_write_frame(w->oc, w->pkt);
    if (rc < 0) return rc;
  }
}

}  // namespace

extern "C" {

void* dist_video_writer_open(const char* path, int width, int height,
                             double fps, char* err, int errlen) {
  if (width <= 0 || height <= 0 || (width | height) & 1) {
    say(err, errlen, "width and height must be positive and even", 0);
    return nullptr;
  }
  if (!(fps > 0)) {
    say(err, errlen, "fps must be positive", 0);
    return nullptr;
  }
  Writer* w = new Writer();
  w->width = width;
  w->height = height;
  int rc = avformat_alloc_output_context2(&w->oc, nullptr, "mp4", path);
  if (rc < 0 || !w->oc) {
    say(err, errlen, "no mp4 muxer", rc);
    free_writer(w);
    return nullptr;
  }
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) {
    say(err, errlen, "libavcodec has no mpeg4 encoder", 0);
    free_writer(w);
    return nullptr;
  }
  w->st = avformat_new_stream(w->oc, nullptr);
  w->c = avcodec_alloc_context3(codec);
  w->frame = av_frame_alloc();
  w->pkt = av_packet_alloc();
  if (!w->st || !w->c || !w->frame || !w->pkt) {
    say(err, errlen, "out of memory", 0);
    free_writer(w);
    return nullptr;
  }
  AVRational rate = av_d2q(fps, 1001000);
  w->c->codec_id = AV_CODEC_ID_MPEG4;
  w->c->width = width;
  w->c->height = height;
  w->c->pix_fmt = AV_PIX_FMT_YUV420P;
  w->c->framerate = rate;
  w->c->time_base = av_inv_q(rate);
  w->c->gop_size = 12;
  // a fixed quantizer: quality that does not depend on the content
  w->c->flags |= AV_CODEC_FLAG_QSCALE;
  w->c->global_quality = FF_QP2LAMBDA * 3;
  if (w->oc->oformat->flags & AVFMT_GLOBALHEADER)
    w->c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  rc = avcodec_open2(w->c, codec, nullptr);
  if (rc < 0) {
    say(err, errlen, "could not open the mpeg4 encoder", rc);
    free_writer(w);
    return nullptr;
  }
  rc = avcodec_parameters_from_context(w->st->codecpar, w->c);
  w->st->time_base = w->c->time_base;
  w->st->avg_frame_rate = rate;
  if (rc >= 0) rc = avio_open(&w->oc->pb, path, AVIO_FLAG_WRITE);
  if (rc >= 0) rc = avformat_write_header(w->oc, nullptr);
  if (rc < 0) {
    say(err, errlen, "could not start the file", rc);
    free_writer(w);
    return nullptr;
  }
  w->frame->format = AV_PIX_FMT_YUV420P;
  w->frame->width = width;
  w->frame->height = height;
  rc = av_frame_get_buffer(w->frame, 0);
  w->sws = sws_getContext(width, height, AV_PIX_FMT_BGR24, width, height,
                          AV_PIX_FMT_YUV420P, SWS_BICUBIC, nullptr, nullptr,
                          nullptr);
  if (rc < 0 || !w->sws) {
    say(err, errlen, "could not set up the BGR24 to YUV 4:2:0 conversion",
        rc);
    free_writer(w);
    return nullptr;
  }
  return w;
}

int dist_video_writer_write(void* handle, const uint8_t* bgr) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = av_frame_make_writable(w->frame);
  if (rc < 0) return rc;
  const uint8_t* src[1] = {bgr};
  int stride[1] = {3 * w->width};
  sws_scale(w->sws, src, stride, 0, w->height, w->frame->data,
            w->frame->linesize);
  w->frame->pts = w->next_pts++;
  return encode(w, w->frame);
}

int dist_video_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = encode(w, nullptr);
  int trailer = av_write_trailer(w->oc);
  free_writer(w);
  return rc < 0 ? rc : trailer;
}

}  // extern "C"
