// mjpeg: Motion-JPEG video for the port's host library (compiled with
// csrc/fgpack.cpp, csrc/mpeg4video.cpp, csrc/vp9video.cpp and csrc/avi.cpp
// into one library).  C++17.
//
// A decoder whose planes equal FFmpeg's mjpeg decoder's (mjpegdec.c) on
// x86-64, what cv2.VideoCapture decodes Motion-JPEG with: one JPEG a
// packet, baseline and extended sequential Huffman frames (SOF0/SOF1) of 8
// bits and three components sampled 4:2:0, 4:2:2 or 4:4:4 (FFmpeg's
// yuvj420p, yuvj422p and yuvj444p), interleaved or one scan a component.
// FFmpeg's arithmetic, not libjpeg's: the DC predictors start at 1024 in
// the dequantised domain (the level shift, reset at every RSTn), each
// coefficient is dequantised into 16 bits, blocks go through FFmpeg's
// simple IDCT (mpeg4video.cpp's fgpack_simple_idct_put) and are clipped,
// and the chroma is kept at its sampling, not upsampled.  Quantisation and
// Huffman tables live across packets, as in FFmpeg's context; a stream
// whose frames carry no DHT decodes by the standard tables (AVI1-style
// streams omit them).  The Huffman tables and the bit reader are
// jpeg_huffman.h's, which fgpack.cpp's libjpeg-exact decoder uses too.
//
// Frames come out as swscale converts each yuvj format to BGR24 for cv2,
// with BT.601 full-range coefficients (fgpack.cpp's converters).
//
// Refused by name: progressive (SOF2), lossless and hierarchical (SOF3,
// SOF5-SOF7), arithmetic-coded (SOF9-SOF15, DAC) and 12-bit frames, grey
// (one component) and CMYK/YCCK (four) frames, RGB frames (component ids
// 'R', 'G', 'B' or an Adobe transform 0), other samplings, and a frame
// whose size differs from the stream's first.  Interlaced streams (two
// fields a packet, which FFmpeg detects from the container's height) are
// refused by data_io/video.py from the first frame's header.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "jpeg_huffman.h"

extern "C" void fgpack_simple_idct_put(uint8_t* dst, int64_t stride, int16_t* blk);
extern "C" void fgpack_yuv_to_bgr24(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                                    int64_t ystride, int64_t cstride, int64_t h, int64_t w,
                                    int chroma, const int32_t* c, uint8_t* dst);

namespace {

using namespace fgjpeg;

// the library's status codes for this file (enum Status of fgpack.cpp
// holds 0 .. -31, mpeg4video.cpp -32 .. -40, vp9video.cpp -41 .. -44,
// avi.cpp -45 .. -48)
enum Status {
  kOk = 0,
  kErrArgs = -14,
  kErrCorrupt = -49,    // malformed Motion-JPEG data
  kErrTool = -50,       // a form the decoder refuses (named by fgpack_mjpeg_error)
  kErrSize = -51,       // a frame whose size differs from the stream's first
  kErrTruncated = -52,  // a frame whose data ends before its last MCU
};

// the feature counters (fgpack_mjpeg_stats; data_io/video.py's
// MJPEG_FEATURES): frames by sampling, frames with a restart interval,
// frames decoded by the standard Huffman tables (no DHT of their own), and
// frames converted by each of swscale's paths
enum Stat {
  kStat420 = 0, kStat422, kStat444, kStatRestart, kStatNoDht, kStatUnscaled420,
  kStatUnscaled422, kStatFullChroma, kMjpegStats
};

enum Chroma { k444 = 0, k422 = 1, k420 = 2 };  // log2 of the chroma's subsampling

struct Decoder {
  uint16_t qt[4][64] = {};  // zigzag order, as DQT sends them
  HuffTable dc[4], ac[4];
  // the stream: its first frame's size and sampling
  int width = 0, height = 0, chroma = -1;
  // the frame
  int fw = 0, fh = 0, hs[3] = {}, vs[3] = {}, tq[3] = {}, ids[3] = {};
  int hmax = 1, vmax = 1, mb_w = 0, mb_h = 0, frame_chroma = -1;
  int restart_interval = 0, adobe_transform = -1;
  bool have_frame = false, have_scan = false, dht_seen = false;
  std::vector<uint8_t> plane[3];
  int stride[3] = {}, rows[3] = {};
  // the last frame out
  bool shown = false;
  std::vector<uint8_t> out[3];
  int out_stride[3] = {};
  std::string error;
  int64_t stats[kMjpegStats] = {};

  Decoder() {
    auto load = [](HuffTable* t, const uint8_t* bits, const uint8_t* vals, int n) {
      std::memcpy(t->bits, bits, 17);
      std::memcpy(t->vals, vals, n);
      derive_huffman(t);
    };
    load(&dc[0], kDcLumaBits, kDcVals, 12);
    load(&dc[1], kDcChromaBits, kDcVals, 12);
    load(&ac[0], kAcLumaBits, kAcLumaVals, 162);
    load(&ac[1], kAcChromaBits, kAcChromaVals, 162);
  }

  int fail(int rc, const std::string& what) {
    error = what;
    return rc;
  }
};

inline int rb16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// The next marker at or after *pos (fill bytes skipped); -1 at the end.
int next_marker(const uint8_t* data, size_t n, size_t* pos) {
  size_t p = *pos;
  for (;;) {
    while (p < n && data[p] != 0xFF) ++p;
    while (p < n && data[p] == 0xFF) ++p;
    if (p >= n) {
      *pos = n;
      return -1;
    }
    const int m = data[p++];
    if (m != 0) {
      *pos = p;
      return m;
    }
  }
}

int parse_dqt(Decoder* d, const uint8_t* s, size_t len) {
  size_t i = 0;
  while (i < len) {
    const int pq = s[i] >> 4, tq = s[i] & 15;
    if (pq > 1 || tq > 3) return d->fail(kErrCorrupt, "a DQT segment with precision " +
                                                          std::to_string(pq) + ", table " +
                                                          std::to_string(tq));
    const size_t each = pq ? 128 : 64;
    if (i + 1 + each > len) return d->fail(kErrCorrupt, "a truncated DQT segment");
    for (int k = 0; k < 64; ++k)
      d->qt[tq][k] = static_cast<uint16_t>(pq ? rb16(s + i + 1 + 2 * k) : s[i + 1 + k]);
    i += 1 + each;
  }
  return kOk;
}

int parse_dht(Decoder* d, const uint8_t* s, size_t len) {
  size_t i = 0;
  while (i < len) {
    if (i + 17 > len) return d->fail(kErrCorrupt, "a truncated DHT segment");
    const int tc = s[i] >> 4, th = s[i] & 15;
    if (tc > 1 || th > 3) return d->fail(kErrCorrupt, "a DHT segment of class " +
                                                          std::to_string(tc) + ", table " +
                                                          std::to_string(th));
    HuffTable t;
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += t.bits[l] = s[i + l];
    if (count > 256 || i + 17 + count > len) return d->fail(kErrCorrupt, "a truncated DHT segment");
    std::memcpy(t.vals, s + i + 17, count);
    if (!derive_huffman(&t)) return d->fail(kErrCorrupt, "a malformed DHT segment");
    (tc ? d->ac : d->dc)[th] = t;
    d->dht_seen = true;
    i += 17 + count;
  }
  return kOk;
}

// SOF0/SOF1: the frame's size, components and sampling (FFmpeg's
// ff_mjpeg_decode_sof, for the forms it gives as yuvj420p/422p/444p).
int parse_sof(Decoder* d, const uint8_t* s, size_t len) {
  if (d->have_frame) return d->fail(kErrCorrupt, "a second SOF in one frame");
  if (len < 6) return d->fail(kErrCorrupt, "a truncated SOF segment");
  const int bits = s[0], h = rb16(s + 1), w = rb16(s + 3), nc = s[5];
  if (bits != 8) return d->fail(kErrTool, std::to_string(bits) + "-bit Motion-JPEG");
  if (!w || !h) return d->fail(kErrCorrupt, "a frame of size 0");
  if (nc == 1) return d->fail(kErrTool, "greyscale Motion-JPEG (one component)");
  if (nc == 4) return d->fail(kErrTool, "CMYK/YCCK Motion-JPEG (four components)");
  if (nc != 3 || len < 6 + 3u * nc)
    return d->fail(kErrCorrupt, "a frame of " + std::to_string(nc) + " components");
  for (int i = 0; i < 3; ++i) {
    d->ids[i] = s[6 + 3 * i];
    d->hs[i] = s[7 + 3 * i] >> 4;
    d->vs[i] = s[7 + 3 * i] & 15;
    d->tq[i] = s[8 + 3 * i] & 3;
  }
  if ((d->ids[0] == 'R' && d->ids[1] == 'G' && d->ids[2] == 'B') || d->adobe_transform == 0)
    return d->fail(kErrTool, "RGB Motion-JPEG (component ids 'RGB' or Adobe transform 0)");
  int chroma = -1;
  if (d->hs[1] == 1 && d->vs[1] == 1 && d->hs[2] == 1 && d->vs[2] == 1) {
    if (d->hs[0] == 1 && d->vs[0] == 1) chroma = k444;
    if (d->hs[0] == 2 && d->vs[0] == 1) chroma = k422;
    if (d->hs[0] == 2 && d->vs[0] == 2) chroma = k420;
  }
  if (chroma < 0) {
    std::string f;
    for (int i = 0; i < 3; ++i)
      f += (i ? ", " : "") + std::to_string(d->hs[i]) + "x" + std::to_string(d->vs[i]);
    return d->fail(kErrTool, "Motion-JPEG sampled " + f + " (the port reads 4:2:0, 4:2:2, 4:4:4)");
  }
  if (d->chroma >= 0 && (w != d->width || h != d->height || chroma != d->chroma))
    return d->fail(kErrSize, "a " + std::to_string(w) + "x" + std::to_string(h) +
                                 " frame in a " + std::to_string(d->width) + "x" +
                                 std::to_string(d->height) + " stream");
  d->fw = w;
  d->fh = h;
  d->frame_chroma = chroma;
  d->hmax = d->hs[0];
  d->vmax = d->vs[0];
  d->mb_w = (w + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mb_h = (h + 8 * d->vmax - 1) / (8 * d->vmax);
  for (int i = 0; i < 3; ++i) {
    d->stride[i] = d->mb_w * d->hs[i] * 8;
    d->rows[i] = d->mb_h * d->vs[i] * 8;
    d->plane[i].assign(static_cast<size_t>(d->stride[i]) * d->rows[i], 0);
  }
  d->have_frame = true;
  return kOk;
}

// One block (FFmpeg's decode_block): the DC difference added to the
// predictor in the dequantised domain and clipped to 16 bits, the AC
// coefficients dequantised into 16 bits, then the simple IDCT.
bool decode_block(Decoder* d, BitReader* b, int c, const HuffTable& dct, const HuffTable& act,
                  int* pred, uint8_t* dst) {
  alignas(16) int16_t blk[64] = {};
  const uint16_t* q = d->qt[d->tq[c]];
  const int s = decode_symbol(b, dct);
  if (s < 0 || s > 16) return false;
  const int32_t diff = s ? extend(b->get(s), s) : 0;
  *pred = static_cast<int32_t>(static_cast<uint32_t>(diff) * q[0] + static_cast<uint32_t>(*pred));
  blk[0] = static_cast<int16_t>(std::max(-32768, std::min(32767, *pred)));
  for (int k = 1; k < 64; ++k) {
    const int rs = decode_symbol(b, act);
    if (rs < 0) return false;
    const int r = rs >> 4, sz = rs & 15;
    if (!rs) break;  // EOB
    k += r;
    if (!sz) continue;  // ZRL (and the runs FFmpeg skips like it)
    if (k > 63) return false;
    blk[kNatural[k]] = static_cast<int16_t>(extend(b->get(sz), sz) * q[k]);
  }
  fgpack_simple_idct_put(dst, d->stride[c], blk);
  return true;
}

// SOS and its entropy-coded data, from *pos; leaves *pos at the next marker.
int decode_scan(Decoder* d, const uint8_t* data, size_t n, size_t seg, size_t len, size_t* pos) {
  if (!d->have_frame) return d->fail(kErrCorrupt, "a scan before the frame header");
  if (len < 1) return d->fail(kErrCorrupt, "a truncated SOS segment");
  const int ns = data[seg];
  if (ns < 1 || ns > 3 || len < 4 + 2u * ns) return d->fail(kErrCorrupt, "a malformed SOS");
  int comp[3], td[3], ta[3];
  for (int i = 0; i < ns; ++i) {
    const int id = data[seg + 1 + 2 * i];
    comp[i] = -1;
    for (int c = 0; c < 3; ++c)
      if (d->ids[c] == id) comp[i] = c;
    if (comp[i] < 0) return d->fail(kErrCorrupt, "a scan of an unknown component");
    td[i] = data[seg + 2 + 2 * i] >> 4;
    ta[i] = data[seg + 2 + 2 * i] & 15;
    if (td[i] > 3 || ta[i] > 3 || !d->dc[td[i]].present || !d->ac[ta[i]].present)
      return d->fail(kErrCorrupt, "a scan without its Huffman tables");
  }
  const uint8_t* p = data + seg + 1 + 2 * ns;
  if (p[0] != 0 || p[1] != 63 || p[2] != 0)
    return d->fail(kErrCorrupt, "a sequential scan with a spectral selection or approximation");
  BitReader b{data + seg + len, data + n};
  int pred[3] = {1024, 1024, 1024};
  int mcus_w = d->mb_w, mcus_h = d->mb_h;
  if (ns == 1) {  // a non-interleaved scan covers its component's own blocks
    const int c = comp[0];
    mcus_w = (d->fw * d->hs[c] / d->hmax + 7) / 8;
    mcus_h = (d->fh * d->vs[c] / d->vmax + 7) / 8;
  }
  int left = d->restart_interval;
  for (int my = 0; my < mcus_h; ++my) {
    for (int mx = 0; mx < mcus_w; ++mx) {
      if (d->restart_interval && left == 0) {
        // FFmpeg's handle_rstn: the byte-aligned RSTn, then the predictors
        // start afresh
        if (b.overrun()) return d->fail(kErrTruncated, "a restart interval cut short");
        size_t at = static_cast<size_t>(b.p - data);
        const int mk = next_marker(data, n, &at);
        if (mk < 0xD0 || mk > 0xD7) return d->fail(kErrCorrupt, "a missing RSTn marker");
        b.p = data + at;
        b.reset();
        pred[0] = pred[1] = pred[2] = 1024;
        left = d->restart_interval;
      }
      if (d->restart_interval) --left;
      for (int i = 0; i < ns; ++i) {
        const int c = comp[i];
        const int bh = ns == 1 ? 1 : d->hs[c], bv = ns == 1 ? 1 : d->vs[c];
        for (int y = 0; y < bv; ++y)
          for (int x = 0; x < bh; ++x) {
            const int bx = mx * bh + x, by = my * bv + y;
            uint8_t* dst = d->plane[c].data() + static_cast<size_t>(by) * 8 * d->stride[c] + bx * 8;
            if (!decode_block(d, &b, c, d->dc[td[i]], d->ac[ta[i]], &pred[i], dst))
              return b.overrun() ? d->fail(kErrTruncated, "a frame cut short")
                                 : d->fail(kErrCorrupt, "a malformed Huffman code");
          }
      }
    }
  }
  if (b.overrun()) return d->fail(kErrTruncated, "a frame cut short");
  *pos = static_cast<size_t>(b.p - data);
  d->have_scan = true;
  return kOk;
}

// The markers of one packet's JPEG; `headers_only` stops at the first SOS
// (the frame header read, nothing decoded).
int decode_frame(Decoder* d, const uint8_t* data, size_t n, bool headers_only) {
  d->have_frame = d->have_scan = d->dht_seen = false;
  d->restart_interval = 0;  // FFmpeg clears it at SOI
  d->adobe_transform = -1;
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
    return d->fail(kErrCorrupt, "a packet that is not a JPEG (no SOI)");
  size_t pos = 2;
  bool restarts = false;
  for (;;) {
    const int m = next_marker(data, n, &pos);
    if (m < 0 || m == 0xD9) break;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (pos + 2 > n) return d->fail(kErrTruncated, "a truncated marker segment");
    const size_t len = static_cast<size_t>(rb16(data + pos));
    if (len < 2 || pos + len > n) return d->fail(kErrTruncated, "a truncated marker segment");
    const size_t seg = pos + 2, sl = len - 2;
    const uint8_t* s = data + seg;
    int rc = kOk;
    switch (m) {
      case 0xC0:
      case 0xC1:
        rc = parse_sof(d, s, sl);
        break;
      case 0xC2:
        return d->fail(kErrTool, "progressive Motion-JPEG (SOF2)");
      case 0xC3:
        return d->fail(kErrTool, "lossless Motion-JPEG (SOF3)");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        return d->fail(kErrTool, "hierarchical Motion-JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        return d->fail(kErrTool, "arithmetic-coded Motion-JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xCC:
        return d->fail(kErrTool, "arithmetic-coded Motion-JPEG (DAC)");
      case 0xC4:
        rc = parse_dht(d, s, sl);
        break;
      case 0xDB:
        rc = parse_dqt(d, s, sl);
        break;
      case 0xDD:
        if (sl < 2) return d->fail(kErrCorrupt, "a truncated DRI segment");
        d->restart_interval = rb16(s);
        restarts = restarts || d->restart_interval > 0;
        break;
      case 0xEE:
        if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) d->adobe_transform = s[11];
        break;
      case 0xDA:
        if (headers_only) return d->have_frame ? kOk : d->fail(kErrCorrupt, "a scan before SOF");
        pos = seg;
        rc = decode_scan(d, data, n, seg, sl, &pos);
        if (rc != kOk) return rc;
        continue;
      default:
        break;  // APPn, COM and the rest: skipped
    }
    if (rc != kOk) return rc;
    pos = seg + sl;
  }
  if (!d->have_frame || (!headers_only && !d->have_scan))
    return d->fail(kErrCorrupt, "a JPEG without a frame or a scan");
  if (headers_only) return kOk;
  if (d->chroma < 0) {
    d->width = d->fw;
    d->height = d->fh;
    d->chroma = d->frame_chroma;
  }
  ++d->stats[d->chroma == k420 ? kStat420 : d->chroma == k422 ? kStat422 : kStat444];
  if (restarts) ++d->stats[kStatRestart];
  if (!d->dht_seen) ++d->stats[kStatNoDht];
  for (int i = 0; i < 3; ++i) {
    d->out[i].swap(d->plane[i]);
    d->out_stride[i] = d->stride[i];
  }
  d->shown = true;
  return kOk;
}

}  // namespace

extern "C" {

// A decoder whose tables live across the packets of one stream.
void* fgpack_mjpeg_new() { return new Decoder(); }

// The first packet's frame header, nothing decoded: out gets {width,
// height, chroma (0 4:4:4, 1 4:2:2, 2 4:2:0)}; a refused form's status.
int fgpack_mjpeg_headers(void* handle, const uint8_t* data, int64_t nbytes, int64_t* out) {
  auto* d = static_cast<Decoder*>(handle);
  Decoder probe;
  const int rc = decode_frame(&probe, data, static_cast<size_t>(std::max<int64_t>(nbytes, 0)), true);
  d->error = probe.error;
  out[0] = probe.fw;
  out[1] = probe.fh;
  out[2] = probe.frame_chroma;
  return rc;
}

// Decode one packet (one JPEG; an empty packet gives nothing); out gets
// {shown, width, height, chroma}.
int fgpack_mjpeg_decode(void* handle, const uint8_t* data, int64_t nbytes, int64_t* out) {
  auto* d = static_cast<Decoder*>(handle);
  if (nbytes < 0) return kErrArgs;
  int rc = kOk;
  out[0] = 0;
  if (nbytes > 0) {
    rc = decode_frame(d, data, static_cast<size_t>(nbytes), false);
    out[0] = rc == kOk;
  }
  out[1] = d->width;
  out[2] = d->height;
  out[3] = d->chroma;
  return rc;
}

// The last frame out, cut to its size: y (h, w), u and v at the chroma's
// sampling ((h + vs) >> vs, (w + hs) >> hs).
int fgpack_mjpeg_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  const auto* d = static_cast<const Decoder*>(handle);
  if (!d->shown) return kErrArgs;
  const int hs = d->chroma != k444, vs = d->chroma == k420;
  const int w = d->width, h = d->height, cw = (w + hs) >> hs, ch = (h + vs) >> vs;
  uint8_t* dst[3] = {y, u, v};
  for (int p = 0; p < 3; ++p) {
    const int pw = p ? cw : w, ph = p ? ch : h;
    for (int r = 0; r < ph; ++r)
      std::memcpy(dst[p] + static_cast<size_t>(r) * pw,
                  d->out[p].data() + static_cast<size_t>(r) * d->out_stride[p], pw);
  }
  return kOk;
}

// The last frame out as (h, w, 3) BGR, as cv2's swscale converts its yuvj
// format (BT.601, full range).
int fgpack_mjpeg_bgr(void* handle, uint8_t* dst) {
  auto* d = static_cast<Decoder*>(handle);
  if (!d->shown) return kErrArgs;
  static const int32_t kBt601Full[6] = {8192, 11485, 14516, -2819, -5850, 0};
  fgpack_yuv_to_bgr24(d->out[0].data(), d->out[1].data(), d->out[2].data(), d->out_stride[0],
                      d->out_stride[1], d->height, d->width, d->chroma, kBt601Full, dst);
  ++d->stats[d->chroma == k420 ? kStatUnscaled420 : d->chroma == k422 ? kStatUnscaled422
                                                                        : kStatFullChroma];
  return kOk;
}

// The stream's feature counts so far (the Stat enum), n of them.
int fgpack_mjpeg_stats(void* handle, int64_t* out, int64_t n) {
  const auto* d = static_cast<const Decoder*>(handle);
  for (int64_t i = 0; i < n && i < kMjpegStats; ++i) out[i] = d->stats[i];
  return kMjpegStats;
}

// What the last refusal or corruption named, NUL-terminated.
int fgpack_mjpeg_error(void* handle, char* buf, int64_t cap) {
  const auto* d = static_cast<const Decoder*>(handle);
  if (cap <= 0) return kErrArgs;
  const size_t n = std::min(d->error.size(), static_cast<size_t>(cap - 1));
  std::memcpy(buf, d->error.data(), n);
  buf[n] = 0;
  return kOk;
}

void fgpack_mjpeg_free(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
