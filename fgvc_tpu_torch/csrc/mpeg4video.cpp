// mpeg4video: MPEG-4 Part 2 video in MP4/MOV for the port's host library
// (compiled with csrc/fgpack.cpp into one library).  C++17.
//
//   * An ISO-BMFF (MP4/MOV) demuxer: the first track whose handler is
//     'vide', its sample entry (an mp4v entry's esds: object type and
//     DecoderSpecificInfo), and its sample table from stsz/stz2, stco/co64,
//     stsc chunk runs, stts, ctts, stss and elst, as FFmpeg's mov demuxer
//     builds it (nb_frames and the average frame rate that cv2 reports).
//   * An MPEG-4 Part 2 video decoder (ISO/IEC 14496-2) whose planes equal
//     FFmpeg's mpeg4 decoder (mpeg4videodec.c, h263dec.c, mpegvideo's
//     motion compensation, qpeldsp) on x86-64, what cv2.VideoCapture
//     decodes with: VOS/VO/VOL/GOV/VOP headers and user data, I-, P- and
//     B-VOPs (direct, forward, backward and interpolated macroblocks,
//     display order with FFmpeg's one-frame delay), intra DC/AC
//     prediction, H.263 and MPEG inverse quantisation (default and loaded
//     matrices), half-pel motion compensation with vop_rounding_type (and
//     FFmpeg's x86 averages without rounding), quarter-pel (the 8-tap
//     filters), 4MV with the standard's chroma rounding, unrestricted
//     vectors read past the edge as FFmpeg's edge emulation reads them,
//     skipped and not-coded macroblocks, resync markers and video packets,
//     data partitioning, and FFmpeg's simple IDCT (the one its x86 SSE2
//     build runs: bit for bit the C simple_idct on unpermuted
//     coefficients), and for streams whose user data names XviD or DivX
//     what FFmpeg switches to: XviD's IDCT (its x86 SSE2 form) and the
//     edge, DC-clip and quarter-pel chroma workarounds of old builds.
//     Interlaced VOPs, sprites/GMC, shape coding, N-bit video,
//     scalability, reversible VLC, NEWPRED, reduced resolution, complexity
//     estimation, studio profiles, packed DivX B-frames and old libavcodec
//     builds (FFmpeg turns on workarounds for them) are refused by name.
//
// Frames come out as swscale's unscaled YUV 4:2:0 -> BGR24 of fgpack.cpp
// (fgpack_i420_to_bgr24), the converter the VP8 decoder uses too.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

extern "C" void fgpack_i420_to_bgr24(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                                     int64_t ystride, int64_t cstride, int64_t h, int64_t w,
                                     uint8_t* dst);

namespace {

// the library's status codes for this file (enum Status of fgpack.cpp
// holds 0 .. -31)
enum Status {
  kOk = 0,
  kErrArgs = -14,
  kErrMp4NotMp4 = -32,       // no moov box
  kErrMp4Corrupt = -33,      // a box that overruns its parent, a broken sample table
  kErrMp4NoVideo = -34,      // no track whose handler is 'vide'
  kErrMp4EditList = -35,     // an edit list that drops, delays or repeats samples
  kErrMpeg4Corrupt = -36,    // malformed MPEG-4 Part 2 data
  kErrMpeg4Tool = -37,       // a tool the decoder does not decode (named by fgpack_mpeg4_error)
  kErrMpeg4NoKey = -38,      // a P- or B-VOP before the stream's first I-VOP
  kErrMpeg4NoVol = -39,      // a VOP before any VOL header
  kErrMpeg4Size = -40,       // a VOL that changes the stream's frame size
};

inline uint32_t rb32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}
inline uint64_t rb64(const uint8_t* p) { return (uint64_t(rb32(p)) << 32) | rb32(p + 4); }
inline uint16_t rb16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }
constexpr uint32_t tag(const char* s) {
  return (uint32_t(uint8_t(s[0])) << 24) | (uint32_t(uint8_t(s[1])) << 16) |
         (uint32_t(uint8_t(s[2])) << 8) | uint8_t(s[3]);
}

// ---- ISO-BMFF: the first video track's samples ----------------------------
namespace mp4 {

struct Sample {
  int64_t offset, size, cts;  // cts: the composition time (decode time plus ctts)
  uint8_t key;
};

struct Track {
  std::string entry;  // the sample entry's type ('mp4v', 'avc1', ...)
  int object_type = -1;  // an mp4v entry's esds objectTypeIndication
  std::vector<uint8_t> dsi;  // its DecoderSpecificInfo
  int64_t width = 0, height = 0, timescale = 0;
  int64_t stts_samples = 0, stts_duration = 0;  // FFmpeg's nb_frames, duration_for_fps
  std::vector<Sample> samples;
};

struct Box {
  uint32_t type;
  size_t start, end;  // the payload
};

// The box at pos (its payload within [pos, end)); false where none fits.
bool read_box(const uint8_t* buf, size_t pos, size_t end, Box* b) {
  if (end < pos || end - pos < 8) return false;
  uint64_t size = rb32(buf + pos);
  b->type = rb32(buf + pos + 4);
  size_t head = 8;
  if (size == 1) {
    if (end - pos < 16) return false;
    size = rb64(buf + pos + 8);
    head = 16;
  } else if (size == 0) {
    size = end - pos;
  }
  if (size < head || size > end - pos) return false;
  b->start = pos + head;
  b->end = pos + size;
  return true;
}

// The first child of [start, end) of the given type.
bool child(const uint8_t* buf, size_t start, size_t end, uint32_t type, Box* out) {
  Box b;
  for (size_t pos = start; read_box(buf, pos, end, &b); pos = b.end) {
    if (b.type == type) {
      *out = b;
      return true;
    }
  }
  return false;
}

struct Parser {
  const uint8_t* buf;
  size_t n;

  // An esds box's objectTypeIndication and DecoderSpecificInfo.
  int esds(const Box& e, Track* t) {
    size_t p = e.start + 4;  // version and flags
    auto size = [&](size_t* q) -> int64_t {
      int64_t v = 0;
      for (int i = 0; i < 4; ++i) {
        if (*q >= e.end) return -1;
        const uint8_t c = buf[(*q)++];
        v = (v << 7) | (c & 0x7F);
        if (!(c & 0x80)) return v;
      }
      return v;
    };
    if (p >= e.end || buf[p] != 3) return kErrMp4Corrupt;
    ++p;
    if (size(&p) < 0 || p + 3 > e.end) return kErrMp4Corrupt;
    const uint8_t flags = buf[p + 2];
    p += 3;
    if (flags & 0x80) p += 2;
    if (flags & 0x40) {
      if (p >= e.end) return kErrMp4Corrupt;
      p += 1 + buf[p];
    }
    if (flags & 0x20) p += 2;
    if (p >= e.end || buf[p] != 4) return kErrMp4Corrupt;
    ++p;
    const int64_t dcd = size(&p);
    if (dcd < 13 || p + 13 > e.end) return kErrMp4Corrupt;
    t->object_type = buf[p];
    const size_t dcd_end = std::min<size_t>(e.end, p + dcd);
    p += 13;
    if (p < dcd_end && buf[p] == 5) {
      ++p;
      const int64_t len = size(&p);
      if (len < 0 || p + len > dcd_end) return kErrMp4Corrupt;
      t->dsi.assign(buf + p, buf + p + len);
    }
    return kOk;
  }

  int stbl(const Box& st, Track* t) {
    Box b;
    // stsd: the first sample entry
    if (!child(buf, st.start, st.end, tag("stsd"), &b) || b.end - b.start < 8)
      return kErrMp4Corrupt;
    Box entry;
    if (!read_box(buf, b.start + 8, b.end, &entry)) return kErrMp4Corrupt;
    char fourcc[5] = {0};
    for (int i = 0; i < 4; ++i) fourcc[i] = static_cast<char>((entry.type >> (24 - 8 * i)) & 0xFF);
    t->entry = fourcc;
    if (entry.end - entry.start >= 78) {
      t->width = rb16(buf + entry.start + 24);
      t->height = rb16(buf + entry.start + 26);
      Box e;
      if (child(buf, entry.start + 78, entry.end, tag("esds"), &e)) {
        const int rc = esds(e, t);
        if (rc != kOk) return rc;
      }
    }
    // stts: decode times; FFmpeg's nb_frames and duration_for_fps
    std::vector<std::pair<uint32_t, uint32_t>> stts;
    if (child(buf, st.start, st.end, tag("stts"), &b)) {
      if (b.end - b.start < 8) return kErrMp4Corrupt;
      const uint32_t k = rb32(buf + b.start + 4);
      if (k > (b.end - b.start - 8) / 8) return kErrMp4Corrupt;
      for (uint32_t i = 0; i < k; ++i) {
        const uint8_t* q = buf + b.start + 8 + 8 * i;
        stts.emplace_back(rb32(q), rb32(q + 4));
        t->stts_samples += rb32(q);
        t->stts_duration += int64_t(rb32(q)) * rb32(q + 4);
      }
    }
    // ctts: composition offsets (read as signed, as FFmpeg does)
    std::vector<std::pair<uint32_t, int32_t>> ctts;
    if (child(buf, st.start, st.end, tag("ctts"), &b)) {
      if (b.end - b.start < 8) return kErrMp4Corrupt;
      const uint32_t k = rb32(buf + b.start + 4);
      if (k > (b.end - b.start - 8) / 8) return kErrMp4Corrupt;
      for (uint32_t i = 0; i < k; ++i) {
        const uint8_t* q = buf + b.start + 8 + 8 * i;
        ctts.emplace_back(rb32(q), static_cast<int32_t>(rb32(q + 4)));
      }
    }
    // stss: key samples (every sample where there is no stss)
    std::vector<uint32_t> stss;
    const bool have_stss = child(buf, st.start, st.end, tag("stss"), &b);
    if (have_stss) {
      if (b.end - b.start < 8) return kErrMp4Corrupt;
      const uint32_t k = rb32(buf + b.start + 4);
      if (k > (b.end - b.start - 8) / 4) return kErrMp4Corrupt;
      for (uint32_t i = 0; i < k; ++i) stss.push_back(rb32(buf + b.start + 8 + 4 * i));
    }
    // stsz or stz2: sample sizes
    std::vector<uint32_t> sizes;
    if (child(buf, st.start, st.end, tag("stsz"), &b)) {
      if (b.end - b.start < 12) return kErrMp4Corrupt;
      const uint32_t constant = rb32(buf + b.start + 4), k = rb32(buf + b.start + 8);
      if (constant) {
        sizes.assign(k, constant);
      } else {
        if (k > (b.end - b.start - 12) / 4) return kErrMp4Corrupt;
        for (uint32_t i = 0; i < k; ++i) sizes.push_back(rb32(buf + b.start + 12 + 4 * i));
      }
    } else if (child(buf, st.start, st.end, tag("stz2"), &b)) {
      if (b.end - b.start < 12) return kErrMp4Corrupt;
      const int field = buf[b.start + 7];
      const uint32_t k = rb32(buf + b.start + 8);
      if ((field != 4 && field != 8 && field != 16) ||
          uint64_t(k) * field > uint64_t(b.end - b.start - 12) * 8)
        return kErrMp4Corrupt;
      for (uint32_t i = 0; i < k; ++i) {
        const uint8_t* q = buf + b.start + 12;
        sizes.push_back(field == 16 ? rb16(q + 2 * i)
                        : field == 8 ? q[i]
                                     : ((q[i / 2] >> (i % 2 ? 0 : 4)) & 15));
      }
    } else {
      return kErrMp4Corrupt;
    }
    // stco or co64: chunk offsets
    std::vector<uint64_t> chunks;
    if (child(buf, st.start, st.end, tag("stco"), &b)) {
      if (b.end - b.start < 8) return kErrMp4Corrupt;
      const uint32_t k = rb32(buf + b.start + 4);
      if (k > (b.end - b.start - 8) / 4) return kErrMp4Corrupt;
      for (uint32_t i = 0; i < k; ++i) chunks.push_back(rb32(buf + b.start + 8 + 4 * i));
    } else if (child(buf, st.start, st.end, tag("co64"), &b)) {
      if (b.end - b.start < 8) return kErrMp4Corrupt;
      const uint32_t k = rb32(buf + b.start + 4);
      if (k > (b.end - b.start - 8) / 8) return kErrMp4Corrupt;
      for (uint32_t i = 0; i < k; ++i) chunks.push_back(rb64(buf + b.start + 8 + 8 * i));
    } else {
      return kErrMp4Corrupt;
    }
    // stsc: runs of chunks with the same number of samples
    struct Run {
      uint32_t first, count;
    };
    std::vector<Run> stsc;
    if (!child(buf, st.start, st.end, tag("stsc"), &b) || b.end - b.start < 8)
      return kErrMp4Corrupt;
    {
      const uint32_t k = rb32(buf + b.start + 4);
      if (k > (b.end - b.start - 8) / 12) return kErrMp4Corrupt;
      for (uint32_t i = 0; i < k; ++i) {
        const uint8_t* q = buf + b.start + 8 + 12 * i;
        stsc.push_back({rb32(q), rb32(q + 4)});
      }
    }
    // the samples, chunk by chunk (FFmpeg's mov_build_index)
    size_t run = 0, tt = 0, ct = 0, kk = 0;
    uint32_t tt_left = stts.empty() ? 0 : stts[0].first;
    uint32_t ct_left = ctts.empty() ? 0 : ctts[0].first;
    int64_t dts = 0;
    for (size_t c = 0; c < chunks.size() && !stsc.empty(); ++c) {
      while (run + 1 < stsc.size() && c + 1 == stsc[run + 1].first) ++run;
      uint64_t offset = chunks[c];
      for (uint32_t j = 0; j < stsc[run].count; ++j) {
        const size_t i = t->samples.size();
        if (i >= sizes.size()) break;
        Sample s{};
        s.offset = static_cast<int64_t>(offset);
        s.size = sizes[i];
        if (offset + s.size > n) return kErrMp4Corrupt;
        offset += s.size;
        s.cts = dts;
        while (tt < stts.size() && tt_left == 0 && ++tt < stts.size()) tt_left = stts[tt].first;
        if (tt < stts.size()) {
          dts += stts[tt].second;
          --tt_left;
        }
        while (ct < ctts.size() && ct_left == 0 && ++ct < ctts.size()) ct_left = ctts[ct].first;
        if (ct < ctts.size()) {
          s.cts += ctts[ct].second;
          --ct_left;
        }
        s.key = 1;
        if (have_stss) {
          while (kk < stss.size() && stss[kk] < i + 1) ++kk;
          s.key = kk < stss.size() && stss[kk] == i + 1;
        }
        t->samples.push_back(s);
      }
    }
    return kOk;
  }

  // The track's edit list: samples FFmpeg would drop, delay or repeat are
  // refused (one edit that starts at or before the first sample shown, or
  // an empty edit before it that only shifts the timestamps).
  int elst(const Box& trak, const Track& t) {
    Box edts, el;
    if (!child(buf, trak.start, trak.end, tag("edts"), &edts) ||
        !child(buf, edts.start, edts.end, tag("elst"), &el))
      return kOk;
    if (el.end - el.start < 8) return kErrMp4Corrupt;
    const int version = buf[el.start];
    const uint32_t k = rb32(buf + el.start + 4);
    const size_t each = version == 1 ? 20 : 12;
    if (k > (el.end - el.start - 8) / each) return kErrMp4Corrupt;
    int used = 0;
    int64_t first_cts = INT64_MAX;
    for (const Sample& s : t.samples) first_cts = std::min(first_cts, s.cts);
    for (uint32_t i = 0; i < k; ++i) {
      const uint8_t* q = buf + el.start + 8 + each * i;
      const int64_t media_time =
          version == 1 ? static_cast<int64_t>(rb64(q + 8)) : static_cast<int32_t>(rb32(q + 4));
      const uint32_t rate = rb32(q + (version == 1 ? 16 : 8));
      if (media_time == -1) continue;  // an empty edit
      if (++used > 1 || rate != 0x10000 || (!t.samples.empty() && media_time > first_cts))
        return kErrMp4EditList;
    }
    return kOk;
  }

  int parse(Track* t) {
    Box moov;
    if (!child(buf, 0, n, tag("moov"), &moov)) return kErrMp4NotMp4;
    Box b;
    for (size_t pos = moov.start; read_box(buf, pos, moov.end, &b); pos = b.end) {
      if (b.type != tag("trak")) continue;
      Box mdia, hdlr, mdhd, minf, stbl_box;
      if (!child(buf, b.start, b.end, tag("mdia"), &mdia)) continue;
      if (!child(buf, mdia.start, mdia.end, tag("hdlr"), &hdlr) || hdlr.end - hdlr.start < 12)
        continue;
      if (rb32(buf + hdlr.start + 8) != tag("vide")) continue;
      if (!child(buf, mdia.start, mdia.end, tag("mdhd"), &mdhd) || mdhd.end - mdhd.start < 24)
        return kErrMp4Corrupt;
      t->timescale = rb32(buf + mdhd.start + (buf[mdhd.start] == 1 ? 20 : 12));
      if (!child(buf, mdia.start, mdia.end, tag("minf"), &minf) ||
          !child(buf, minf.start, minf.end, tag("stbl"), &stbl_box))
        return kErrMp4Corrupt;
      int rc = stbl(stbl_box, t);
      if (rc != kOk) return rc;
      return elst(b, *t);
    }
    return kErrMp4NoVideo;
  }
};

}  // namespace mp4

// ---- MPEG-4 Part 2 video ---------------------------------------------------
namespace m4v {

enum { kI = 1, kP = 2, kB = 3, kS = 4 };  // vop_coding_type + 1, FFmpeg's numbering
enum { kSliceOk = 0, kSliceEnd = 1 };
enum { kMvFwd = 1, kMvBwd = 2 };
enum { kMbIntra = 1, kMb8x8 = 2, kMbSkip = 4 };

// counts of the stream features the VOPs used (fgpack_mpeg4_stats)
enum {
  kStatI = 0, kStatP, kStatB, kStatRounding1, kStatNotCoded, kStatIntraMb, kStatIntraMbInP,
  kStatInterMb, kStatSkipMb, kStat4mvMb, kStatAcPredMb, kStatDquantMb, kStatEdgeMb,
  kStatPackets, kStatDirect, kStatForward, kStatBackward, kStatInterpolated, kStatBSkipMb,
  kStatMpegQuant, kStatLoadedMatrix, kStatEscape3, kStatQpel, kStatPartitioned, kStatXvidIdct,
  kMpeg4Stats
};

// Tables of ISO/IEC 14496-2 (Annex B) and H.263, in FFmpeg's order
// (h263data.c, mpeg4data.h): {code, length} without the sign bit.
const uint16_t kInterVlc[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
const int8_t kInterRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2,  1,  2,  1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1,  2,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
};
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  2,  2,  2,  2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9,  10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
};
const uint8_t kMvTab[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12},
};
const uint8_t kCbpyTab[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                                 {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const uint8_t kIntraMcbpcCode[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
const uint8_t kIntraMcbpcBits[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
const uint8_t kInterMcbpcCode[28] = {1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4,
                                     3, 2, 2, 5, 4, 5, 1, 0, 0, 0, 2, 12, 14, 15};
const uint8_t kInterMcbpcBits[28] = {1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9,
                                     9, 9, 3, 7, 7, 8, 9, 0, 0, 0, 11, 13, 13, 13};
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4},  {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5},  {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
// B-VOP mb_type: direct, interpolated, backward, forward
const uint8_t kMbTypeB[4][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};
const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kQuantTab[4] = {-1, -2, 1, 2};
const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                                    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                                    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                                    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                                  41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                                  51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                                  53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const uint16_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint16_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

// ---- bits and prefix codes -------------------------------------------------
struct Bits {
  const uint8_t* p = nullptr;
  int64_t n = 0;    // bytes
  int64_t pos = 0;  // bits read

  // the 64 bits from pos, zeros past the end (FFmpeg's zero padding)
  uint64_t peek64() const {
    const int64_t b = pos >> 3;
    uint64_t w = 0;
    if (b >= 0 && b + 8 <= n) {
      for (int i = 0; i < 8; ++i) w = (w << 8) | p[b + i];
    } else {
      for (int i = 0; i < 8; ++i) w = (w << 8) | (b + i >= 0 && b + i < n ? p[b + i] : 0);
    }
    return w << (pos & 7);
  }
  uint32_t show(int k) const { return k ? static_cast<uint32_t>(peek64() >> (64 - k)) : 0; }
  uint32_t get(int k) {
    const uint32_t v = show(k);
    pos += k;
    return v;
  }
  int get1() { return static_cast<int>(get(1)); }
  void skip(int64_t k) { pos += k; }
  int64_t size() const { return n * 8; }
  int64_t left() const { return n * 8 - pos; }
  void align() { pos = (pos + 7) & ~int64_t(7); }
};

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;

  void add(uint32_t code, int length, int symbol) {
    if (!length) return;
    const uint32_t lo = code << (bits - length), span = 1u << (bits - length);
    for (uint32_t v = lo; v < lo + span; ++v) {
      sym[v] = static_cast<int16_t>(symbol);
      len[v] = static_cast<uint8_t>(length);
    }
  }
  void init(int maxbits) {
    bits = maxbits;
    sym.assign(size_t(1) << bits, -1);
    len.assign(size_t(1) << bits, 0);
  }
  int read(Bits& b) const {
    const uint32_t v = b.show(bits);
    if (!len[v]) return -1;
    b.skip(len[v]);
    return sym[v];
  }
};

struct Rl {  // a TCOEF table with the escape's helpers (FFmpeg's ff_rl_init)
  Vlc vlc;
  int n = 102, last = 0;
  const int8_t* run = nullptr;
  const int8_t* level = nullptr;
  uint8_t max_level[2][65] = {}, max_run[2][65] = {};

  void init(const uint16_t (*codes)[2], const int8_t* r, const int8_t* l, int last_index) {
    run = r;
    level = l;
    last = last_index;
    vlc.init(12);
    for (int i = 0; i <= n; ++i) vlc.add(codes[i][0], codes[i][1], i);
    for (int i = 0; i < n; ++i) {
      const int lst = i >= last;
      max_level[lst][run[i]] = std::max<uint8_t>(max_level[lst][run[i]], level[i]);
      max_run[lst][level[i]] = std::max<uint8_t>(max_run[lst][level[i]], run[i]);
    }
  }
};

struct Tables {
  Rl intra, inter;
  Vlc mv, cbpy, intra_mcbpc, inter_mcbpc, dc_lum, dc_chrom, mb_type_b;
  Tables() {
    intra.init(kIntraVlc, kIntraRun, kIntraLevel, 67);
    inter.init(kInterVlc, kInterRun, kInterLevel, 58);
    mv.init(12);
    for (int i = 0; i < 33; ++i) mv.add(kMvTab[i][0], kMvTab[i][1], i);
    cbpy.init(6);
    for (int i = 0; i < 16; ++i) cbpy.add(kCbpyTab[i][0], kCbpyTab[i][1], i);
    intra_mcbpc.init(9);
    for (int i = 0; i < 9; ++i) intra_mcbpc.add(kIntraMcbpcCode[i], kIntraMcbpcBits[i], i);
    inter_mcbpc.init(13);
    for (int i = 0; i < 28; ++i) inter_mcbpc.add(kInterMcbpcCode[i], kInterMcbpcBits[i], i);
    dc_lum.init(11);
    for (int i = 0; i < 13; ++i) dc_lum.add(kDcLum[i][0], kDcLum[i][1], i);
    dc_chrom.init(12);
    for (int i = 0; i < 13; ++i) dc_chrom.add(kDcChrom[i][0], kDcChrom[i][1], i);
    mb_type_b.init(4);
    for (int i = 0; i < 4; ++i) mb_type_b.add(kMbTypeB[i][0], kMbTypeB[i][1], i);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---- FFmpeg's simple IDCT (simple_idct_template.c, 8 bits) ---------------
// Its x86-64 SSE2 build (simple_idct8 with the transposed permutation)
// gives these values bit for bit on unpermuted coefficients.
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;

inline int16_t i16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void idct_row(int16_t* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    const int16_t v = i16(r[0] * 8);
    for (int i = 0; i < 8; ++i) r[i] = v;
    return;
  }
  uint32_t a0 = uint32_t(W4) * r[0] + (1u << 10), a1 = a0, a2 = a0, a3 = a0;
  a0 += uint32_t(W2) * r[2];
  a1 += uint32_t(W6) * r[2];
  a2 -= uint32_t(W6) * r[2];
  a3 -= uint32_t(W2) * r[2];
  uint32_t b0 = uint32_t(W1) * r[1] + uint32_t(W3) * r[3];
  uint32_t b1 = uint32_t(W3) * r[1] - uint32_t(W7) * r[3];
  uint32_t b2 = uint32_t(W5) * r[1] - uint32_t(W1) * r[3];
  uint32_t b3 = uint32_t(W7) * r[1] - uint32_t(W5) * r[3];
  a0 += uint32_t(W4) * r[4] + uint32_t(W6) * r[6];
  a1 += -uint32_t(W4) * r[4] - uint32_t(W2) * r[6];
  a2 += -uint32_t(W4) * r[4] + uint32_t(W2) * r[6];
  a3 += uint32_t(W4) * r[4] - uint32_t(W6) * r[6];
  b0 += uint32_t(W5) * r[5] + uint32_t(W7) * r[7];
  b1 += -uint32_t(W1) * r[5] - uint32_t(W5) * r[7];
  b2 += uint32_t(W7) * r[5] + uint32_t(W3) * r[7];
  b3 += uint32_t(W3) * r[5] - uint32_t(W1) * r[7];
  r[0] = i16(int(a0 + b0) >> 11);
  r[7] = i16(int(a0 - b0) >> 11);
  r[1] = i16(int(a1 + b1) >> 11);
  r[6] = i16(int(a1 - b1) >> 11);
  r[2] = i16(int(a2 + b2) >> 11);
  r[5] = i16(int(a2 - b2) >> 11);
  r[3] = i16(int(a3 + b3) >> 11);
  r[4] = i16(int(a3 - b3) >> 11);
}

// one column of 8 outputs (row order) from col[0], col[8], ..., col[56]
inline void idct_col(const int16_t* c, int out[8]) {
  uint32_t a0 = uint32_t(W4) * uint32_t(c[0] + ((1 << 19) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += uint32_t(W2) * c[16];
  a1 += uint32_t(W6) * c[16];
  a2 += -uint32_t(W6) * c[16];
  a3 += -uint32_t(W2) * c[16];
  uint32_t b0 = uint32_t(W1) * c[8] + uint32_t(W3) * c[24];
  uint32_t b1 = uint32_t(W3) * c[8] - uint32_t(W7) * c[24];
  uint32_t b2 = uint32_t(W5) * c[8] - uint32_t(W1) * c[24];
  uint32_t b3 = uint32_t(W7) * c[8] - uint32_t(W5) * c[24];
  a0 += uint32_t(W4) * c[32];
  a1 += -uint32_t(W4) * c[32];
  a2 += -uint32_t(W4) * c[32];
  a3 += uint32_t(W4) * c[32];
  b0 += uint32_t(W5) * c[40];
  b1 += -uint32_t(W1) * c[40];
  b2 += uint32_t(W7) * c[40];
  b3 += uint32_t(W3) * c[40];
  a0 += uint32_t(W6) * c[48];
  a1 += -uint32_t(W2) * c[48];
  a2 += uint32_t(W2) * c[48];
  a3 += -uint32_t(W6) * c[48];
  b0 += uint32_t(W7) * c[56];
  b1 += -uint32_t(W5) * c[56];
  b2 += uint32_t(W3) * c[56];
  b3 += -uint32_t(W1) * c[56];
  out[0] = int(a0 + b0) >> 20;
  out[1] = int(a1 + b1) >> 20;
  out[2] = int(a2 + b2) >> 20;
  out[3] = int(a3 + b3) >> 20;
  out[4] = int(a3 - b3) >> 20;
  out[5] = int(a2 - b2) >> 20;
  out[6] = int(a1 - b1) >> 20;
  out[7] = int(a0 - b0) >> 20;
}

void idct_put(uint8_t* dst, int stride, int16_t* blk) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  int out[8];
  for (int c = 0; c < 8; ++c) {
    idct_col(blk + c, out);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip8(out[r]);
  }
}

// ---- XviD's IDCT (FFmpeg's xvididct.c), what FFmpeg runs for XviD streams:
// its x86 SSE2 form, whose high multiplies are signed (the C form's
// unsigned MULT is not), bit for bit on unpermuted coefficients
const int kXvidTab[4][7] = {{22725, 21407, 19266, 16384, 12873, 8867, 4520},
                            {31521, 29692, 26722, 22725, 17855, 12299, 6270},
                            {29692, 27969, 25172, 21407, 16819, 11585, 5906},
                            {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
const int kXvidRowTab[8] = {0, 1, 2, 3, 0, 3, 2, 1};
const int kXvidRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

void xvid_row(int16_t* in, const int* tab, int rnd) {
  const int c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
            c7 = tab[6];
  int a0, a1, a2, a3, b0, b1, b2, b3;
  if (!(in[5] | in[6] | in[7] | in[4])) {
    const int k = c4 * in[0] + rnd;
    if (!(in[1] | in[2] | in[3])) {
      const int v = k >> 11;
      if (v)
        for (int i = 0; i < 8; ++i) in[i] = i16(v);
      return;
    }
    a0 = k + c2 * in[2];
    a1 = k + c6 * in[2];
    a2 = k - c6 * in[2];
    a3 = k - c2 * in[2];
    b0 = c1 * in[1] + c3 * in[3];
    b1 = c3 * in[1] - c7 * in[3];
    b2 = c5 * in[1] - c1 * in[3];
    b3 = c7 * in[1] - c5 * in[3];
  } else {
    a0 = c4 * in[0] + c4 * in[4] + c2 * in[2] + c6 * in[6] + rnd;
    a1 = c4 * in[0] - c4 * in[4] + c6 * in[2] - c2 * in[6] + rnd;
    a2 = c4 * in[0] - c4 * in[4] - c6 * in[2] + c2 * in[6] + rnd;
    a3 = c4 * in[0] + c4 * in[4] - c2 * in[2] - c6 * in[6] + rnd;
    b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
    b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
    b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
    b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
  }
  in[0] = i16((a0 + b0) >> 11);
  in[1] = i16((a1 + b1) >> 11);
  in[2] = i16((a2 + b2) >> 11);
  in[3] = i16((a3 + b3) >> 11);
  in[4] = i16((a3 - b3) >> 11);
  in[5] = i16((a2 - b2) >> 11);
  in[6] = i16((a1 - b1) >> 11);
  in[7] = i16((a0 - b0) >> 11);
}

inline int xvid_mult(int c, int x) { return (c * x) >> 16; }

// one column (stride 8) to eight outputs
void xvid_col(const int16_t* in, int out[8]) {
  constexpr int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;
  int m0 = xvid_mult(kTan1, in[56]) + in[8], m1 = xvid_mult(kTan1, in[8]) - in[56];
  int m2 = xvid_mult(kTan3, in[40]) + in[24], m3 = xvid_mult(kTan3, in[24]) - in[40];
  int m7 = m0 + m2, m4 = m1 - m3;
  m0 -= m2;
  m1 += m3;
  const int m6 = 2 * xvid_mult(kSqrt2, m0 + m1), m5 = 2 * xvid_mult(kSqrt2, m0 - m1);
  m3 = xvid_mult(kTan2, in[48]) + in[16];
  m2 = xvid_mult(kTan2, in[16]) - in[48];
  m0 = in[0] + in[32];
  m1 = in[0] - in[32];
  const int e0 = m0 + m3, e3 = m0 - m3, e1 = m1 + m2, e2 = m1 - m2;
  out[0] = i16((e0 + m7) >> 6);
  out[7] = i16((e0 - m7) >> 6);
  out[3] = i16((e3 + m4) >> 6);
  out[4] = i16((e3 - m4) >> 6);
  out[1] = i16((e1 + m6) >> 6);
  out[6] = i16((e1 - m6) >> 6);
  out[2] = i16((e2 + m5) >> 6);
  out[5] = i16((e2 - m5) >> 6);
}

void xvid_idct(uint8_t* dst, int stride, int16_t* blk, bool add) {
  for (int r = 0; r < 8; ++r) xvid_row(blk + 8 * r, kXvidTab[kXvidRowTab[r]], kXvidRnd[r]);
  int out[8];
  for (int c = 0; c < 8; ++c) {
    xvid_col(blk + c, out);
    for (int r = 0; r < 8; ++r) {
      uint8_t& o = dst[r * stride + c];
      o = clip8(add ? o + out[r] : out[r]);
    }
  }
}

void idct_add(uint8_t* dst, int stride, int16_t* blk) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  int out[8];
  for (int c = 0; c < 8; ++c) {
    idct_col(blk + c, out);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip8(dst[r * stride + c] + out[r]);
  }
}

// ---- the decoder -----------------------------------------------------------
struct Picture {
  std::vector<uint8_t> y, u, v;  // mb_w * 16 by mb_h * 16 (chroma half)
  std::vector<int16_t> mv;       // FFmpeg's motion_val: (x, y) per 8x8 block
  std::vector<uint8_t> mbt;      // kMb* per macroblock (mb_stride layout)
};

struct Decoder {
  const Tables& t = tables();
  // the VOL and what the headers say of the stream
  bool have_vol = false;
  int vo_type = 0, vol_control = 0, low_delay = 0, time_res = 0, time_bits = 0;
  int width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0, b8s = 0, mbs = 0;
  int mpeg_quant = 0, resync_marker = 0, quarter_sample = 0;
  uint16_t intra_matrix[64], inter_matrix[64];
  bool loaded_matrix = false;
  int divx_version = -1, divx_build = -1, xvid_build = -1, lavc_build = -1;
  char codec_tag[4] = {};  // the container's fourcc, upper case (AVI's; none from MP4)
  // what FFmpeg's ff_mpeg4_workaround_bugs turns on for the signing encoder
  bool xvid_idct = false, bug_edge = false, bug_dc_clip = false, bug_qpel_chroma = false,
       bug_qpel_chroma2 = false;
  int64_t picture_number = 0;
  int64_t time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0;
  int pp_time = 0, pb_time = 0;
  // the VOP
  int pict_type = 0, no_rounding = 0, dc_thr = 99, qscale = 1, f_code = 1, b_code = 1;
  int y_dc_scale = 8, c_dc_scale = 8;
  // the macroblock
  int mb_x = 0, mb_y = 0, resync_x = 0, resync_y = 0, first_line = 1;
  int mb_intra = 0, ac_pred = 0, mv_dir = 0, mv_8x8 = 0, mb_skipped = 0;
  int mv[2][4][2] = {}, last_mv[2][2] = {};
  alignas(16) int16_t block[6][64];
  int last_index[6] = {};
  bool edge_hit = false;
  // data partitioning: what partitions A and B leave for the texture
  // (FFmpeg's cbp_table and pred_dir_table; ac_pred beside them)
  int data_partitioning = 0, partitioned = 0, mb_left = 0;
  std::vector<uint8_t> dp_cbp, dp_dir, dp_acpred;
  // prediction state (FFmpeg's dc_val, ac_val, qscale_table layouts)
  std::vector<int16_t> dc_y, dc_c[2], ac_y, ac_c[2];
  std::vector<int8_t> qtab;
  int dcy0 = 0, dcc0 = 0, mv0 = 0;
  std::shared_ptr<Picture> last, next, cur, shown;
  std::string error;
  int64_t stats[kMpeg4Stats] = {};
};

int tool(Decoder* d, const std::string& what) {
  d->error = what;
  return kErrMpeg4Tool;
}

void set_qscale(Decoder* d, int q) {
  q = std::max(1, std::min(31, q));
  d->qscale = q;
  d->y_dc_scale = kYDcScale[q];
  d->c_dc_scale = kCDcScale[q];
}

inline int luma_index(const Decoder* d, int n) {
  return 2 * d->mb_y * d->b8s + (n >> 1) * d->b8s + 2 * d->mb_x + (n & 1);
}

// (re)size the state for the VOL's frame size
void init_size(Decoder* d) {
  d->mb_w = (d->width + 15) / 16;
  d->mb_h = (d->height + 15) / 16;
  d->mb_num = d->mb_w * d->mb_h;
  d->b8s = 2 * d->mb_w + 1;
  d->mbs = d->mb_w + 1;
  const size_t ysz = size_t(d->b8s) * (2 * d->mb_h + 1), csz = size_t(d->mbs) * (d->mb_h + 1);
  d->dcy0 = d->b8s + 1;
  d->dcc0 = d->mbs + 1;
  d->dc_y.assign(ysz, 1024);
  d->ac_y.assign(ysz * 16, 0);
  for (int c = 0; c < 2; ++c) {
    d->dc_c[c].assign(csz, 1024);
    d->ac_c[c].assign(csz * 16, 0);
  }
  d->qtab.assign(size_t(d->mbs) * d->mb_h + 1, 0);
  d->dp_cbp.assign(size_t(d->mbs) * d->mb_h + 2, 0);
  d->dp_dir.assign(d->dp_cbp.size(), 0);
  d->dp_acpred.assign(d->dp_cbp.size(), 0);
  d->mv0 = d->b8s + 4;
  d->last.reset();
  d->next.reset();
  d->shown.reset();
}

std::shared_ptr<Picture> new_picture(const Decoder* d) {
  auto p = std::make_shared<Picture>();
  const size_t w = size_t(d->mb_w) * 16, h = size_t(d->mb_h) * 16;
  p->y.assign(w * h, 0);
  p->u.assign(w * h / 4, 0);
  p->v.assign(w * h / 4, 0);
  p->mv.assign(2 * (size_t(d->b8s) * (2 * d->mb_h + 2) + 8), 0);
  p->mbt.assign(size_t(d->mbs) * d->mb_h + 2, 0);
  return p;
}

// ---- headers ---------------------------------------------------------------
int decode_vol(Decoder* d, Bits& gb) {
  gb.skip(1);  // random_accessible_vol
  d->vo_type = gb.get(8);
  if (d->vo_type == 14 || d->vo_type == 15) return tool(d, "studio profile (video_object_type_indication " + std::to_string(d->vo_type) + ")");
  int ver = 1;
  if (gb.get1()) {
    ver = gb.get(4);
    gb.skip(3);
  }
  if (gb.get(4) == 15) gb.skip(16);  // extended pixel aspect ratio
  d->vol_control = gb.get1();
  if (d->vol_control) {
    const int chroma = gb.get(2);
    if (chroma != 1) return tool(d, "chroma_format " + std::to_string(chroma) + " (not 4:2:0)");
    d->low_delay = gb.get1();
    if (gb.get1()) gb.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);  // vbv parameters
  } else if (d->picture_number == 0) {
    d->low_delay = (d->vo_type == 1 || d->vo_type == 17) ? 1 : 0;
  }
  const int shape = gb.get(2);
  if (shape != 0) return tool(d, "shape coding (video_object_layer_shape " + std::to_string(shape) + ")");
  gb.skip(1);  // marker
  const int res = gb.get(16);
  if (!res) return kErrMpeg4Corrupt;
  d->time_res = res;
  int bits = 0;
  for (int v = res - 1; v; v >>= 1) ++bits;
  d->time_bits = std::max(bits, 1);
  gb.skip(1);  // marker
  if (gb.get1()) gb.skip(d->time_bits);  // fixed_vop_rate, fixed_vop_time_increment
  gb.skip(1);
  const int width = gb.get(13);
  gb.skip(1);
  const int height = gb.get(13);
  gb.skip(1);
  if (gb.get1()) return tool(d, "interlaced video (interlaced = 1 in the VOL)");
  if (!gb.get1()) return tool(d, "overlapped block motion compensation (obmc_disable = 0)");
  const int sprite = ver == 1 ? gb.get1() : gb.get(2);
  if (sprite) return tool(d, sprite == 2 ? "global motion compensation (GMC sprites)" : "sprites (sprite_enable " + std::to_string(sprite) + ")");
  if (gb.get1()) return tool(d, "N-bit video (not_8_bit = 1)");
  d->mpeg_quant = gb.get1();
  d->loaded_matrix = false;
  if (d->mpeg_quant) {
    std::memcpy(d->intra_matrix, kDefaultIntraMatrix, sizeof(d->intra_matrix));
    std::memcpy(d->inter_matrix, kDefaultInterMatrix, sizeof(d->inter_matrix));
    for (uint16_t* m : {d->intra_matrix, d->inter_matrix}) {
      if (!gb.get1()) continue;
      d->loaded_matrix = true;
      int i = 0, last = 0;
      for (; i < 64; ++i) {
        if (gb.left() < 8) return kErrMpeg4Corrupt;
        const int v = gb.get(8);
        if (!v) break;
        last = v;
        m[kZigzag[i]] = static_cast<uint16_t>(v);
      }
      for (; i < 64; ++i) m[kZigzag[i]] = static_cast<uint16_t>(last);
    }
  }
  d->quarter_sample = ver != 1 ? gb.get1() : 0;
  if (gb.left() < 4) return kErrMpeg4Corrupt;
  if (!gb.get1()) return tool(d, "complexity estimation (complexity_estimation_disable = 0)");
  d->resync_marker = !gb.get1();
  d->data_partitioning = gb.get1();
  if (d->data_partitioning && gb.get1()) return tool(d, "reversible VLC (reversible_vlc = 1)");
  if (ver != 1) {
    if (gb.get1()) return tool(d, "NEWPRED (newpred_enable = 1)");
    if (gb.get1()) return tool(d, "reduced resolution VOPs (reduced_resolution_vop_enable = 1)");
  }
  if (gb.get1()) return tool(d, "scalability (scalability = 1)");
  if (width && height) {
    if (d->have_vol && (width != d->width || height != d->height)) return kErrMpeg4Size;
    if (!d->have_vol) {
      d->width = width;
      d->height = height;
      init_size(d);
    }
  }
  if (!d->width || !d->height) return kErrMpeg4Corrupt;
  d->have_vol = true;
  return kOk;
}

// user data: the encoder's signature (FFmpeg's decode_user_data), which
// workaround_bugs below reads.  Packed DivX B-frames and old libavcodec
// builds are refused by name.
int decode_user_data(Decoder* d, Bits& gb) {
  char buf[256];
  int i = 0;
  for (; i < 255 && gb.pos < gb.size(); ++i) {
    if (gb.show(23) == 0) break;
    buf[i] = static_cast<char>(gb.get(8));
  }
  buf[i] = 0;
  int ver = 0, build = 0, ver2 = 0, ver3 = 0;
  char last = 0;
  int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
  if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
  if (e >= 2) {
    if (e == 3 && last == 'p')
      return tool(d, std::string("packed DivX B-frames (user data '") + buf + "')");
    d->divx_version = ver;
    d->divx_build = build;
  }
  if (std::sscanf(buf, "FFmpe%*[^b]b%d", &build) == 1 ||
      std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build) == 4 ||
      std::strcmp(buf, "ffmpeg") == 0)
    return tool(d, std::string("an old libavcodec's stream (user data '") + buf +
                       "'; FFmpeg turns on workarounds for it)");
  if (std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) == 3) {
    build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    d->lavc_build = build;
    if ((build & 0xFF) >= 100 && build > 3621476 && build < 3752552 &&
        (build < 3752037 || build > 3752191))
      return tool(d, std::string("a libavcodec 55-57 stream (user data '") + buf +
                         "'; FFmpeg turns on its intra edge workaround)");
  }
  if (std::sscanf(buf, "XviD%d", &build) == 1) d->xvid_build = build;
  return kOk;
}

// FFmpeg's ff_mpeg4_workaround_bugs, run after each VOP header: a stream
// without a libavcodec, XviD or DivX signature is XviD build 0 under an
// XviD-like codec tag (XVID, XVIX, RMP4, ZMP4, SIPP), and DivX 4.00 under
// 'DIVX' where its VOL has video_object_type_indication 0 and no
// vol_control_parameters; then the workarounds of old XviD and DivX builds
// and XviD's IDCT for XviD streams (the comparisons are FFmpeg's, unsigned
// where its are: -1, no such signature, compares above every build)
void workaround_bugs(Decoder* d) {
  const bool unsigned_stream = d->xvid_build == -1 && d->divx_version == -1 && d->lavc_build == -1;
  auto is = [d](const char* s) { return std::memcmp(d->codec_tag, s, 4) == 0; };
  if (unsigned_stream && (is("XVID") || is("XVIX") || is("RMP4") || is("ZMP4") || is("SIPP")))
    d->xvid_build = 0;
  if (unsigned_stream && is("DIVX") && d->vo_type == 0 && !d->vol_control) d->divx_version = 400;
  if (d->xvid_build >= 0 && d->divx_version >= 0) d->divx_version = d->divx_build = -1;
  const unsigned xvid = static_cast<unsigned>(d->xvid_build);
  const unsigned divx = static_cast<unsigned>(d->divx_version);
  if (d->divx_version >= 500 && d->divx_build < 1814) d->bug_qpel_chroma = true;
  if (d->divx_version > 502 && d->divx_build < 1814) d->bug_qpel_chroma2 = true;
  if (xvid <= 1u) d->bug_qpel_chroma = true;
  if (xvid <= 12u) d->bug_edge = true;
  if (xvid <= 32u) d->bug_dc_clip = true;
  if (divx < 500u) d->bug_edge = true;
  if (d->xvid_build >= 0) d->xvid_idct = true;
}

int decode_visual_object(Decoder* d, Bits& gb) {
  if (gb.get1()) gb.skip(7);  // verid, priority
  const int type = gb.get(4);
  if ((type == 1 || type == 2) && gb.get1()) {  // video_signal_type
    gb.skip(3);
    const int full = gb.get1();
    if (full) return tool(d, "full-range video (video_range = 1)");
    if (gb.get1()) {  // colour_description
      gb.skip(16);
      const int matrix = gb.get(8);
      if (matrix != 1 && matrix != 2 && matrix != 5 && matrix != 6)
        return tool(d, "matrix_coefficients " + std::to_string(matrix));
    }
  }
  return kOk;
}

// Headers up to and through the next VOP's; *vop is set where one was
// read (the bits then stand at its first macroblock).
int decode_headers(Decoder* d, Bits& gb, bool* vop) {
  *vop = false;
  gb.align();
  uint32_t code = 0xff;
  bool vol = false;
  for (;;) {
    if (gb.pos >= gb.size()) return kOk;
    code = ((code << 8) | gb.get(8)) & 0xffffffffu;
    if ((code & 0xFFFFFF00u) != 0x100) continue;
    int rc = kOk;
    if (code >= 0x120 && code <= 0x12F) {
      if (!vol) rc = decode_vol(d, gb);
      vol = true;
    } else if (code == 0x1B2) {
      rc = decode_user_data(d, gb);
    } else if (code == 0x1B3) {  // GOV: the time code in seconds
      if (gb.show(23)) {
        const int hours = gb.get(5), minutes = gb.get(6);
        gb.skip(1);
        const int seconds = gb.get(6);
        d->time_base = seconds + 60 * (minutes + 60 * hours);
        gb.skip(2);
      }
    } else if (code == 0x1B0) {
      const int profile = gb.get(4), level = gb.get(4);
      if (profile == 14 && level > 0 && level < 9) return tool(d, "studio profile (VOS)");
    } else if (code == 0x1B5) {
      rc = decode_visual_object(d, gb);
    } else if (code == 0x1B6) {
      *vop = true;
      return kOk;
    }
    if (rc != kOk) return rc;
    gb.align();
    code = 0xff;
  }
}

enum { kVopDecode = 0, kVopSkipped = 1 };

int decode_vop_header(Decoder* d, Bits& gb, int* what) {
  *what = kVopDecode;
  d->pict_type = static_cast<int>(gb.get(2)) + kI;
  if (d->pict_type == kS) return tool(d, "S-VOPs (sprites / GMC)");
  if (d->pict_type == kB && d->low_delay && !d->vol_control) d->low_delay = 0;
  int incr = 0;
  while (gb.get1()) {
    if (gb.left() <= 0) return kErrMpeg4Corrupt;
    ++incr;
  }
  gb.skip(1);  // marker
  if (!(gb.show(d->time_bits + 1) & 1)) {
    // FFmpeg's search for a time_increment width that fits the bits
    for (d->time_bits = 1; d->time_bits < 16; ++d->time_bits) {
      if (d->pict_type == kP) {
        if ((gb.show(d->time_bits + 6) & 0x37) == 0x30) break;
      } else if ((gb.show(d->time_bits + 5) & 0x1F) == 0x18) {
        break;
      }
    }
  }
  const int inc = gb.get(d->time_bits);
  if (d->pict_type != kB) {
    d->last_time_base = d->time_base;
    d->time_base += incr;
    d->time = d->time_base * d->time_res + inc;
    d->pp_time = static_cast<int>(d->time - d->last_non_b_time);
    d->last_non_b_time = d->time;
  } else {
    d->time = (d->last_time_base + incr) * d->time_res + inc;
    d->pb_time = static_cast<int>(d->pp_time - (d->last_non_b_time - d->time));
    if (d->pp_time <= d->pb_time || d->pp_time <= d->pp_time - d->pb_time || d->pp_time <= 0) {
      *what = kVopSkipped;  // FFmpeg: a B-VOP out of order
      return kOk;
    }
  }
  gb.skip(1);  // marker
  if (gb.get1() != 1) {
    ++d->stats[kStatNotCoded];
    *what = kVopSkipped;
    return kOk;
  }
  d->partitioned = d->data_partitioning && d->pict_type != kB;
  d->no_rounding = d->pict_type == kP ? gb.get1() : 0;
  d->dc_thr = kDcThreshold[gb.get(3)];
  const int q = gb.get(5);
  if (!q) return kErrMpeg4Corrupt;
  set_qscale(d, q);
  d->f_code = 1;
  d->b_code = 1;
  if (d->pict_type != kI) {
    d->f_code = gb.get(3);
    if (!d->f_code) return kErrMpeg4Corrupt;
  }
  if (d->pict_type == kB) {
    d->b_code = gb.get(3);
    if (!d->b_code) return kErrMpeg4Corrupt;
  }
  if (d->vo_type == 0 && !d->vol_control && d->divx_version == -1 && d->picture_number == 0)
    d->low_delay = 1;
  ++d->picture_number;
  return kOk;
}

// ---- prediction ------------------------------------------------------------
inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// FFmpeg's ff_mpeg4_pred_dc: the quantised DC of block n from its
// neighbours' (stored times the DC scale, clipped to 0..2047)
int pred_dc(Decoder* d, int n, int level, int* dir) {
  const int scale = n < 4 ? d->y_dc_scale : d->c_dc_scale;
  int16_t* dc;
  int wrap;
  if (n < 4) {
    dc = &d->dc_y[d->dcy0 + luma_index(d, n)];
    wrap = d->b8s;
  } else {
    dc = &d->dc_c[n - 4][d->dcc0 + d->mb_y * d->mbs + d->mb_x];
    wrap = d->mbs;
  }
  int a = dc[-1], b = dc[-1 - wrap], c = dc[-wrap];
  if (d->first_line && n != 3) {
    if (n != 2) b = c = 1024;
    if (n != 1 && d->mb_x == d->resync_x) b = a = 1024;
  }
  if (d->mb_x == d->resync_x && d->mb_y == d->resync_y + 1 && (n == 0 || n == 4 || n == 5))
    b = 1024;
  int pred;
  if (std::abs(a - b) < std::abs(b - c)) {
    pred = c;
    *dir = 1;
  } else {
    pred = a;
    *dir = 0;
  }
  pred = (pred + (scale >> 1)) / scale;
  level += pred;
  const int ret = level;
  level *= scale;
  if (level & ~2047) {
    if (level < 0)
      level = 0;
    else if (!d->bug_dc_clip)
      level = 2047;
  }
  dc[0] = static_cast<int16_t>(level);
  return ret;
}

inline int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// FFmpeg's ff_mpeg4_pred_ac: add the left column or top row of the
// neighbour the DC chose (rescaled to this macroblock's quantiser) where
// ac_pred is on, and keep this block's for the next
void pred_ac(Decoder* d, int16_t* blk, int n, int dir) {
  int16_t* ac;
  int wrap;
  if (n < 4) {
    ac = &d->ac_y[size_t(d->dcy0 + luma_index(d, n)) * 16];
    wrap = d->b8s;
  } else {
    ac = &d->ac_c[n - 4][size_t(d->dcc0 + d->mb_y * d->mbs + d->mb_x) * 16];
    wrap = d->mbs;
  }
  if (d->ac_pred) {
    if (dir == 0) {
      const int xy = d->mb_x - 1 + d->mb_y * d->mbs;
      const int16_t* left = ac - 16;
      if (d->mb_x == 0 || d->qscale == d->qtab[xy] || n == 1 || n == 3) {
        for (int i = 1; i < 8; ++i) blk[i << 3] = i16(blk[i << 3] + left[i]);
      } else {
        for (int i = 1; i < 8; ++i)
          blk[i << 3] = i16(blk[i << 3] + rounded_div(left[i] * d->qtab[xy], d->qscale));
      }
    } else {
      const int xy = d->mb_x + d->mb_y * d->mbs - d->mbs;
      const int16_t* top = ac - 16 * wrap;
      if (d->mb_y == 0 || d->qscale == d->qtab[xy] || n == 2 || n == 3) {
        for (int i = 1; i < 8; ++i) blk[i] = i16(blk[i] + top[i + 8]);
      } else {
        for (int i = 1; i < 8; ++i)
          blk[i] = i16(blk[i] + rounded_div(top[i + 8] * d->qtab[xy], d->qscale));
      }
    }
  }
  for (int i = 1; i < 8; ++i) ac[i] = blk[i << 3];
  for (int i = 1; i < 8; ++i) ac[8 + i] = blk[i];
}

// FFmpeg's mpeg4_decode_dc: dct_dc_size, the differential and its marker,
// predicted (pred_dc); negative on an error, as FFmpeg takes a negative DC
int decode_dc(Decoder* d, Bits& gb, int n, int* dir) {
  const int size = (n < 4 ? d->t.dc_lum : d->t.dc_chrom).read(gb);
  if (size < 0 || size > 9) return -1;
  int level = 0;
  if (size) {
    const int v = gb.get(size);
    level = (v >> (size - 1)) ? v : v - (1 << size) + 1;
    if (size > 8) gb.skip(1);  // marker
  }
  return pred_dc(d, n, level, dir);
}

// FFmpeg's mpeg4_decode_block (no RVLC); -1 on an error
int decode_block(Decoder* d, Bits& gb, int16_t* blk, int n, int coded, int intra, int dc_vlc) {
  int i, dir = 0, qmul = 1, qadd = 0;
  const Rl* rl;
  const uint8_t* scan = kZigzag;
  if (intra) {
    if (dc_vlc && d->partitioned) {
      // partition A or B decoded the DC: back from its stored value
      const int scale = n < 4 ? d->y_dc_scale : d->c_dc_scale;
      const int stored = n < 4 ? d->dc_y[d->dcy0 + luma_index(d, n)]
                               : d->dc_c[n - 4][d->dcc0 + d->mb_y * d->mbs + d->mb_x];
      blk[0] = i16((stored + (scale >> 1)) / scale);
      dir = (d->dp_dir[d->mb_x + d->mb_y * d->mbs] << n) & 32;
      i = 0;
    } else if (dc_vlc) {
      const int level = decode_dc(d, gb, n, &dir);
      if (level < 0) return -1;
      blk[0] = i16(level);
      i = 0;
    } else {
      i = -1;
      pred_dc(d, n, 0, &dir);
    }
    if (!coded) goto not_coded;
    rl = &d->t.intra;
    if (d->ac_pred) scan = dir == 0 ? kAltVertical : kAltHorizontal;
  } else {
    i = -1;
    if (!coded) {
      d->last_index[n] = -1;
      return 0;
    }
    rl = &d->t.inter;
    if (!d->mpeg_quant) {
      qmul = d->qscale << 1;
      qadd = (d->qscale - 1) | 1;
    }
  }
  for (;;) {
    int sym = rl->vlc.read(gb);
    if (sym < 0) return -1;
    int level, run, last;
    if (sym == rl->n) {
      if (!gb.show(1)) {  // first escape: level offset
        gb.skip(1);
        sym = rl->vlc.read(gb);
        if (sym < 0 || sym == rl->n) return -1;
        run = rl->run[sym];
        last = sym >= rl->last;
        level = (rl->level[sym] + rl->max_level[last][run]) * qmul + qadd;
        if (gb.get1()) level = -level;
      } else if (gb.show(2) == 2) {  // second escape: run offset
        gb.skip(2);
        sym = rl->vlc.read(gb);
        if (sym < 0 || sym == rl->n) return -1;
        last = sym >= rl->last;
        run = rl->run[sym] + rl->max_run[last][rl->level[sym]] + 1;
        level = rl->level[sym] * qmul + qadd;
        if (gb.get1()) level = -level;
      } else {  // third escape: fixed-length
        gb.skip(2);
        last = gb.get1();
        run = gb.get(6);
        if (!gb.get1()) return -1;
        level = static_cast<int>(gb.get(12));
        level = level >= 2048 ? level - 4096 : level;
        if (!gb.get1()) return -1;
        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        if (static_cast<unsigned>(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
        ++d->stats[kStatEscape3];
      }
    } else {
      run = rl->run[sym];
      last = sym >= rl->last;
      level = rl->level[sym] * qmul + qadd;
      if (gb.get1()) level = -level;
    }
    i += run + 1;
    if (last || i > 62) {
      if (i > 63 || (!last && i > 62)) {
        // FFmpeg "ignoring overflow": the coefficient is dropped
        if (gb.left() < 0) return -1;
        i = 63;
        break;
      }
      blk[scan[i]] = i16(level);
      break;
    }
    blk[scan[i]] = i16(level);
  }
not_coded:
  if (intra) {
    if (!dc_vlc) {
      blk[0] = i16(pred_dc(d, n, blk[0], &dir));
      if (i < 0) i = 0;
    }
    pred_ac(d, blk, n, dir);
    if (d->ac_pred) i = 63;
  }
  d->last_index[n] = i;
  return 0;
}

// FFmpeg's ff_h263_pred_motion: the predictor of block `block`'s vector
// and its slot in the picture's motion_val
int16_t* pred_motion(Decoder* d, int block, int* px, int* py) {
  static const int off[4] = {2, 1, 1, -1};
  const int wrap = d->b8s;
  int16_t* mv = d->cur->mv.data() + 2 * (d->mv0 + luma_index(d, block));
  int16_t* A = mv - 2;
  if (d->first_line && block < 3) {
    if (block == 0) {
      if (d->mb_x == d->resync_x) {
        *px = *py = 0;
      } else if (d->mb_x + 1 == d->resync_x) {
        const int16_t* C = mv + 2 * (off[block] - wrap);
        if (d->mb_x == 0) {
          *px = C[0];
          *py = C[1];
        } else {
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        }
      } else {
        *px = A[0];
        *py = A[1];
      }
    } else if (block == 1) {
      if (d->mb_x + 1 == d->resync_x) {
        const int16_t* C = mv + 2 * (off[block] - wrap);
        *px = mid_pred(A[0], 0, C[0]);
        *py = mid_pred(A[1], 0, C[1]);
      } else {
        *px = A[0];
        *py = A[1];
      }
    } else {
      const int16_t* B = mv - 2 * wrap;
      const int16_t* C = mv + 2 * (off[block] - wrap);
      if (d->mb_x == d->resync_x) A[0] = A[1] = 0;
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
  } else {
    const int16_t* B = mv - 2 * wrap;
    const int16_t* C = mv + 2 * (off[block] - wrap);
    *px = mid_pred(A[0], B[0], C[0]);
    *py = mid_pred(A[1], B[1], C[1]);
  }
  return mv;
}

// FFmpeg's ff_h263_decode_motion; 0xffff on an error
int decode_motion(Decoder* d, Bits& gb, int pred, int f_code) {
  const int code = d->t.mv.read(gb);
  if (code == 0) return pred;
  if (code < 0) return 0xffff;
  const int sign = gb.get1();
  const int shift = f_code - 1;
  int val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= static_cast<int>(gb.get(shift));
    ++val;
  }
  if (sign) val = -val;
  val += pred;
  const int bits = 5 + f_code;
  return static_cast<int32_t>(static_cast<uint32_t>(val) << (32 - bits)) >> (32 - bits);
}

// B-VOP direct mode (ff_mpeg4_set_direct_mv): the co-located vectors of
// the next reference scaled by the VOP times, plus the delta
void set_direct_mv(Decoder* d, int mx, int my) {
  const int xy = d->mb_x + d->mb_y * d->mbs;
  const uint16_t pp = static_cast<uint16_t>(d->pp_time), pb = static_cast<uint16_t>(d->pb_time);
  const bool b8 = d->next->mbt[xy] & kMb8x8;
  for (int i = 0; i < (b8 ? 4 : 1); ++i) {
    const int16_t* p = d->next->mv.data() + 2 * (d->mv0 + luma_index(d, i));
    const int delta[2] = {mx, my};
    for (int c = 0; c < 2; ++c) {
      const int pv = p[c];
      d->mv[0][i][c] = pv * pb / pp + delta[c];
      d->mv[1][i][c] = delta[c] ? d->mv[0][i][c] - pv : pv * (pb - pp) / pp;
    }
  }
  if (!b8) {
    for (int i = 1; i < 4; ++i)
      for (int dir = 0; dir < 2; ++dir)
        for (int c = 0; c < 2; ++c) d->mv[dir][i][c] = d->mv[dir][0][c];
  }
  // FFmpeg compensates direct macroblocks as four 8x8 blocks in
  // quarter-pel streams, whatever the co-located macroblock was (its
  // FF_BUG_DIRECT_BLOCKSIZE for DivX is tested on the context's user
  // flags, where autodetection never puts it)
  d->mv_8x8 = b8 || d->quarter_sample;
}

// Is what follows a resync marker, or the VOP's end (FFmpeg's
// mpeg4_is_resync)?  The macroblock number it gives, else 0.
int is_resync(Decoder* d, Bits& gb) {
  int64_t bits_count = gb.pos;
  uint32_t v = gb.show(16);
  while (v <= 0xFF) {
    if (d->pict_type == kB || (v >> (8 - d->pict_type)) != 1 || d->partitioned) break;
    gb.skip(8 + d->pict_type);
    bits_count += 8 + d->pict_type;
    v = gb.show(16);
  }
  if (bits_count + 8 >= gb.size()) {
    v >>= 8;
    v |= 0x7F >> (7 - (bits_count & 7));
    if (v == 0x7F) return d->mb_num;
  } else {
    static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                       0x7000, 0x6000, 0x4000, 0x0000};
    if (v == prefix[bits_count & 7]) {
      Bits look = gb;
      look.skip(1);
      look.align();
      int len = 0;
      for (; len < 32; ++len)
        if (look.get1()) break;
      int mb_bits = 0;
      for (int k = d->mb_num - 1; k; k >>= 1) ++mb_bits;
      int mb_num = look.get(mb_bits);
      if (!mb_num || mb_num > d->mb_num || look.pos + 6 > look.size()) mb_num = -1;
      const int need = d->pict_type == kI   ? 16
                       : d->pict_type == kB ? std::max(std::max(d->f_code, d->b_code), 2) + 15
                                            : d->f_code + 15;
      if (len >= need) return mb_num;
    }
  }
  return 0;
}

// ---- macroblocks -----------------------------------------------------------
// FFmpeg's mpeg4_decode_mb: kSliceOk, kSliceEnd or -1 on an error
int decode_mb(Decoder* d, Bits& gb) {
  const int xy = d->mb_x + d->mb_y * d->mbs;
  Picture& cur = *d->cur;
  int cbpc, cbpy, cbp, dquant;
  std::memset(d->block, 0, sizeof(d->block));
  if (d->pict_type == kP) {
    do {
      if (gb.get1()) {  // not coded: skipped
        d->mb_intra = 0;
        for (int i = 0; i < 6; ++i) d->last_index[i] = -1;
        d->mv_dir = kMvFwd;
        d->mv_8x8 = 0;
        d->mv[0][0][0] = d->mv[0][0][1] = 0;
        d->mb_skipped = 1;
        cur.mbt[xy] = kMbSkip;
        ++d->stats[kStatSkipMb];
        goto end;
      }
      cbpc = d->t.inter_mcbpc.read(gb);
      if (cbpc < 0) return -1;
    } while (cbpc == 20);
    dquant = cbpc & 8;
    d->mb_intra = (cbpc & 4) != 0;
    if (d->mb_intra) {
      ++d->stats[kStatIntraMbInP];
      goto intra;
    }
    cbpy = d->t.cbpy.read(gb);
    if (cbpy < 0) return -1;
    cbp = (cbpc & 3) | ((cbpy ^ 0xF) << 2);
    if (dquant) {
      set_qscale(d, d->qscale + kQuantTab[gb.get(2)]);
      ++d->stats[kStatDquantMb];
    }
    d->mv_dir = kMvFwd;
    ++d->stats[kStatInterMb];
    if (!(cbpc & 16)) {
      int px, py;
      cur.mbt[xy] = 0;
      d->mv_8x8 = 0;
      pred_motion(d, 0, &px, &py);
      const int mx = decode_motion(d, gb, px, d->f_code);
      if (mx >= 0xffff) return -1;
      const int my = decode_motion(d, gb, py, d->f_code);
      if (my >= 0xffff) return -1;
      d->mv[0][0][0] = mx;
      d->mv[0][0][1] = my;
    } else {
      cur.mbt[xy] = kMb8x8;
      d->mv_8x8 = 1;
      ++d->stats[kStat4mvMb];
      for (int i = 0; i < 4; ++i) {
        int px, py;
        int16_t* slot = pred_motion(d, i, &px, &py);
        const int mx = decode_motion(d, gb, px, d->f_code);
        if (mx >= 0xffff) return -1;
        const int my = decode_motion(d, gb, py, d->f_code);
        if (my >= 0xffff) return -1;
        d->mv[0][i][0] = mx;
        d->mv[0][i][1] = my;
        slot[0] = static_cast<int16_t>(mx);
        slot[1] = static_cast<int16_t>(my);
      }
    }
  } else if (d->pict_type == kB) {
    d->mb_intra = 0;
    if (d->mb_x == 0) std::memset(d->last_mv, 0, sizeof(d->last_mv));
    if (d->next->mbt[xy] & kMbSkip) {  // skipped in the next reference: skipped here
      for (int i = 0; i < 6; ++i) d->last_index[i] = -1;
      d->mv_dir = kMvFwd;
      d->mv_8x8 = 0;
      std::memset(d->mv, 0, sizeof(d->mv));
      ++d->stats[kStatBSkipMb];
      goto end;
    }
    int mb_type;  // 0 direct, 1 interpolated, 2 backward, 3 forward
    bool direct_skip = false;
    if (gb.get1()) {  // modb '1': direct, no vectors, no coefficients
      mb_type = 0;
      direct_skip = true;
      cbp = 0;
    } else {
      const int modb2 = gb.get1();
      mb_type = d->t.mb_type_b.read(gb);
      if (mb_type < 0) return -1;
      cbp = modb2 ? 0 : static_cast<int>(gb.get(6));
      if (mb_type != 0 && cbp && gb.get1()) {
        set_qscale(d, d->qscale + static_cast<int>(gb.get1()) * 4 - 2);
        ++d->stats[kStatDquantMb];
      }
      if (mb_type != 0) {
        d->mv_8x8 = 0;
        d->mv_dir = 0;
        if (mb_type == 1 || mb_type == 3) {
          d->mv_dir |= kMvFwd;
          const int mx = decode_motion(d, gb, d->last_mv[0][0], d->f_code);
          const int my = decode_motion(d, gb, d->last_mv[0][1], d->f_code);
          if (mx >= 0xffff || my >= 0xffff) return -1;
          d->last_mv[0][0] = d->mv[0][0][0] = mx;
          d->last_mv[0][1] = d->mv[0][0][1] = my;
        }
        if (mb_type == 1 || mb_type == 2) {
          d->mv_dir |= kMvBwd;
          const int mx = decode_motion(d, gb, d->last_mv[1][0], d->b_code);
          const int my = decode_motion(d, gb, d->last_mv[1][1], d->b_code);
          if (mx >= 0xffff || my >= 0xffff) return -1;
          d->last_mv[1][0] = d->mv[1][0][0] = mx;
          d->last_mv[1][1] = d->mv[1][0][1] = my;
        }
      }
    }
    if (mb_type == 0) {
      int mx = 0, my = 0;
      if (!direct_skip) {
        mx = decode_motion(d, gb, 0, 1);
        my = decode_motion(d, gb, 0, 1);
        if (mx >= 0xffff || my >= 0xffff) return -1;
      }
      d->mv_dir = kMvFwd | kMvBwd;
      set_direct_mv(d, mx, my);
      ++d->stats[kStatDirect];
    } else {
      ++d->stats[mb_type == 1 ? kStatInterpolated : mb_type == 2 ? kStatBackward : kStatForward];
    }
  } else {
    do {
      cbpc = d->t.intra_mcbpc.read(gb);
      if (cbpc < 0) return -1;
    } while (cbpc == 8);
    dquant = cbpc & 4;
    d->mb_intra = 1;
  intra:
    cur.mbt[xy] = kMbIntra;
    d->ac_pred = gb.get1();
    if (d->ac_pred) ++d->stats[kStatAcPredMb];
    ++d->stats[kStatIntraMb];
    cbpy = d->t.cbpy.read(gb);
    if (cbpy < 0) return -1;
    cbp = (cbpc & 3) | (cbpy << 2);
    const int dc_vlc = d->qscale < d->dc_thr;
    if (dquant) {
      set_qscale(d, d->qscale + kQuantTab[gb.get(2)]);
      ++d->stats[kStatDquantMb];
    }
    for (int i = 0; i < 6; ++i) {
      if (decode_block(d, gb, d->block[i], i, cbp & 32, 1, dc_vlc) < 0) return -1;
      cbp += cbp;
    }
    goto end;
  }
  for (int i = 0; i < 6; ++i) {
    if (decode_block(d, gb, d->block[i], i, cbp & 32, 0, 0) < 0) return -1;
    cbp += cbp;
  }
end:
  if (d->resync_marker) {
    const int next = is_resync(d, gb);
    if (next) {
      if (d->mb_x + d->mb_y * d->mb_w + 1 >= next) return kSliceEnd;
      if (d->pict_type == kB) {
        const int delta = d->mb_x + 1 == d->mb_w ? 2 : 1;
        if (d->next->mbt[xy + delta] & kMbSkip) return kSliceOk;
      }
      return kSliceEnd;
    }
  }
  return kSliceOk;
}

// FFmpeg's ff_h263_update_motion_val (after each P or I macroblock)
void update_motion_val(Decoder* d) {
  Picture& cur = *d->cur;
  const int xy = d->mb_x + d->mb_y * d->mbs;
  if (d->mb_skipped) cur.mbt[xy] |= kMbSkip;
  if (!d->mv_8x8) {
    const int mx = d->mb_intra ? 0 : d->mv[0][0][0], my = d->mb_intra ? 0 : d->mv[0][0][1];
    int16_t* mv = cur.mv.data() + 2 * (d->mv0 + luma_index(d, 0));
    for (int k : {0, 1, d->b8s, d->b8s + 1}) {
      mv[2 * k] = static_cast<int16_t>(mx);
      mv[2 * k + 1] = static_cast<int16_t>(my);
    }
  }
}

// ---- motion compensation ---------------------------------------------------
// One block of w x h from a reference plane at (sx, sy) in whole pixels
// plus half-pel flags dxy, reads clamped to the plane's ew x eh (FFmpeg's
// emulated_edge_mc); mode 0 put, 1 put without rounding, 2 average.
void mc(Decoder* d, uint8_t* dst, int ds, const uint8_t* ref, int rs, int ew, int eh, int sx,
        int sy, int dxy, int w, int h, int mode) {
  const int dx = dxy & 1, dy = dxy >> 1;
  const bool inside = sx >= 0 && sy >= 0 && sx + w + dx <= ew && sy + h + dy <= eh;
  if (!inside) d->edge_hit = true;
  auto px = [&](int x, int y) -> int {
    if (!inside) {
      x = x < 0 ? 0 : (x >= ew ? ew - 1 : x);
      y = y < 0 ? 0 : (y >= eh ? eh - 1 : y);
    }
    return ref[size_t(y) * rs + x];
  };
  const int rnd = mode == 1 ? 0 : 1;
  // Without rounding, FFmpeg's x86 build (not in bit-exact mode) averages
  // 8-wide blocks with pavgb after taking one from one side, saturating
  // (put_no_rnd_pixels8_x2 / _y2 of hpeldsp.asm): (a + b) >> 1 except
  // where that side is 0.  The left pixel is that side across, the odd
  // row (counted from the block's first) down; 16-wide blocks are exact.
  const bool inexact = !rnd && w == 8;
  for (int j = 0; j < h; ++j) {
    for (int i = 0; i < w; ++i) {
      const int x = sx + i, y = sy + j;
      int v;
      if (!dx && !dy) {
        v = px(x, y);
      } else if (!dy) {
        v = inexact ? (std::max(px(x, y) - 1, 0) + px(x + 1, y) + 1) >> 1
                    : (px(x, y) + px(x + 1, y) + rnd) >> 1;
      } else if (!dx) {
        if (!inexact)
          v = (px(x, y) + px(x, y + 1) + rnd) >> 1;
        else if (j & 1)
          v = (std::max(px(x, y) - 1, 0) + px(x, y + 1) + 1) >> 1;
        else
          v = (px(x, y) + std::max(px(x, y + 1) - 1, 0) + 1) >> 1;
      } else {
        v = (px(x, y) + px(x + 1, y) + px(x, y + 1) + px(x + 1, y + 1) + 1 + rnd) >> 2;
      }
      uint8_t& o = dst[size_t(j) * ds + i];
      o = static_cast<uint8_t>(mode == 2 ? (o + v + 1) >> 1 : v);
    }
  }
}

inline int round_chroma(int x) {
  static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[x & 0xf] + ((x >> 3) & ~1);
}

// ---- quarter-pel: FFmpeg's qpeldsp (the C functions; its x86 ones agree) --
enum { kPut = 0, kPutNoRnd = 1, kAvg = 2 };

// An (n + 1) x (n + 1) block of a reference plane at (sx, sy), reads
// clamped to ew x eh (what the filters below read of it, emulated edges
// included).
void fetch(Decoder* d, uint8_t* out, int n, const uint8_t* ref, int rs, int ew, int eh, int sx,
           int sy) {
  if (sx < 0 || sy < 0 || sx + n + 1 > ew || sy + n + 1 > eh) d->edge_hit = true;
  for (int j = 0; j <= n; ++j) {
    const int y = std::max(0, std::min(eh - 1, sy + j));
    for (int i = 0; i <= n; ++i) {
      const int x = std::max(0, std::min(ew - 1, sx + i));
      out[j * (n + 1) + i] = ref[size_t(y) * rs + x];
    }
  }
}

// MPEG-4's 8-tap half-sample filter (-1, 3, -6, 20, 20, -6, 3, -1) at
// output k of a line of n + 1 samples, mirrored past either end
inline int lowpass(const uint8_t* s, int step, int k, int n) {
  auto at = [&](int i) { return s[(i < 0 ? -1 - i : (i > n ? 2 * n + 1 - i : i)) * step]; };
  return (at(k) + at(k + 1)) * 20 - (at(k - 1) + at(k + 2)) * 6 + (at(k - 2) + at(k + 3)) * 3 -
         (at(k - 3) + at(k + 4));
}

inline void qstore(uint8_t* o, int v, int op) {
  v = clip8((v + (op == kPutNoRnd ? 15 : 16)) >> 5);
  *o = static_cast<uint8_t>(op == kAvg ? (*o + v + 1) >> 1 : v);
}

// rows x n outputs of the horizontal filter, each row n + 1 samples wide
void h_lowpass(uint8_t* dst, int ds, const uint8_t* src, int ss, int rows, int n, int op) {
  for (int j = 0; j < rows; ++j)
    for (int k = 0; k < n; ++k) qstore(dst + j * ds + k, lowpass(src + j * ss, 1, k, n), op);
}

// n x n outputs of the vertical filter over n + 1 rows
void v_lowpass(uint8_t* dst, int ds, const uint8_t* src, int ss, int n, int op) {
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < n; ++k) qstore(dst + k * ds + i, lowpass(src + i, ss, k, n), op);
}

// the average of two blocks (pixels*_l2): rounded, not rounded, or
// rounded then averaged into dst
void l2(uint8_t* dst, int ds, const uint8_t* a, int as, const uint8_t* b, int bs, int rows, int n,
        int op) {
  for (int j = 0; j < rows; ++j) {
    for (int i = 0; i < n; ++i) {
      const int x = a[j * as + i], y = b[j * bs + i];
      uint8_t& o = dst[j * ds + i];
      if (op == kPutNoRnd)
        o = static_cast<uint8_t>((x + y) >> 1);
      else if (op == kAvg)
        o = static_cast<uint8_t>((o + ((x + y + 1) >> 1) + 1) >> 1);
      else
        o = static_cast<uint8_t>((x + y + 1) >> 1);
    }
  }
}

// FFmpeg's qpel{8,16}_mcXY (qpeldsp.c's QPEL_MC) for dxy = Y << 2 | X on
// an (n + 1)-square block: the half-sample filters, the quarter samples
// their averages with the nearest whole or half ones; intermediates round
// unless op is kPutNoRnd
void qpel_mc(uint8_t* dst, int ds, const uint8_t* src, int n, int dxy, int op) {
  const int ss = n + 1, rnd = op == kPutNoRnd ? kPutNoRnd : kPut;
  const int x = dxy & 3, y = dxy >> 2;
  uint8_t half[17 * 17], hh[17 * 16], hv[16 * 16];
  if (!x && !y) {
    for (int j = 0; j < n; ++j)
      for (int i = 0; i < n; ++i) {
        uint8_t& o = dst[j * ds + i];
        o = static_cast<uint8_t>(op == kAvg ? (o + src[j * ss + i] + 1) >> 1 : src[j * ss + i]);
      }
  } else if (!y) {
    if (x == 2) return h_lowpass(dst, ds, src, ss, n, n, op);
    h_lowpass(half, n, src, ss, n, n, rnd);
    l2(dst, ds, src + (x == 3), ss, half, n, n, n, op);
  } else if (!x) {
    if (y == 2) return v_lowpass(dst, ds, src, ss, n, op);
    v_lowpass(half, n, src, ss, n, rnd);
    l2(dst, ds, src + (y == 3) * ss, ss, half, n, n, n, op);
  } else {
    h_lowpass(hh, n, src, ss, n + 1, n, rnd);
    if (x != 2) l2(hh, n, hh, n, src + (x == 3), ss, n + 1, n, rnd);
    if (y == 2) return v_lowpass(dst, ds, hh, n, n, op);
    v_lowpass(hv, n, hh, n, n, rnd);
    l2(dst, ds, hh + (y == 3) * n, n, hv, n, n, n, op);
  }
}

// FFmpeg's ff_mpv_motion for one direction: 16x16 (mpeg_motion, or
// qpel_motion) or four 8x8 vectors (apply_8x8 with hpel_motion or the
// quarter-pel filters, then chroma_4mv_motion)
void motion(Decoder* d, int dir, const Picture& ref, int mode) {
  Picture& cur = *d->cur;
  const int ls = d->mb_w * 16, cs = d->mb_w * 8;
  // FFmpeg's h_edge_pos, v_edge_pos: the macroblocks' size, or the VOL's
  // for old XviD and DivX (FF_BUG_EDGE)
  const int ew = d->bug_edge ? d->width : d->mb_w * 16, eh = d->bug_edge ? d->height : d->mb_h * 16;
  uint8_t* dy = cur.y.data() + size_t(d->mb_y) * 16 * ls + d->mb_x * 16;
  uint8_t* du = cur.u.data() + size_t(d->mb_y) * 8 * cs + d->mb_x * 8;
  uint8_t* dv = cur.v.data() + size_t(d->mb_y) * 8 * cs + d->mb_x * 8;
  uint8_t block[17 * 17];
  if (!d->mv_8x8) {
    const int mx = d->mv[dir][0][0], my = d->mv[dir][0][1];
    int ux, uy, uvdxy;
    if (d->quarter_sample) {
      const int sx = d->mb_x * 16 + (mx >> 2), sy = d->mb_y * 16 + (my >> 2);
      fetch(d, block, 16, ref.y.data(), ls, ew, eh, sx, sy);
      qpel_mc(dy, ls, block, 16, ((my & 3) << 2) | (mx & 3), mode);
      // qpel_motion's chroma: the half-pel vector of the luma's half,
      // half a pixel where that is not whole
      static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
      int cx, cy;
      if (d->bug_qpel_chroma2) {
        cx = (mx >> 1) + rtab[mx & 7];
        cy = (my >> 1) + rtab[my & 7];
      } else if (d->bug_qpel_chroma) {
        cx = (mx >> 1) | (mx & 1);
        cy = (my >> 1) | (my & 1);
      } else {
        cx = mx / 2;
        cy = my / 2;
      }
      cx = (cx >> 1) | (cx & 1);
      cy = (cy >> 1) | (cy & 1);
      uvdxy = (cx & 1) | ((cy & 1) << 1);
      ux = d->mb_x * 8 + (cx >> 1);
      uy = d->mb_y * 8 + (cy >> 1);
    } else {
      const int dxy = ((my & 1) << 1) | (mx & 1);
      const int sx = d->mb_x * 16 + (mx >> 1), sy = d->mb_y * 16 + (my >> 1);
      // H.263's chroma vector: half a pixel wherever the luma's is not whole
      uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      ux = sx >> 1;
      uy = sy >> 1;
      mc(d, dy, ls, ref.y.data(), ls, ew, eh, sx, sy, dxy, 16, 16, mode);
    }
    mc(d, du, cs, ref.u.data(), cs, ew / 2, eh / 2, ux, uy, uvdxy, 8, 8, mode);
    mc(d, dv, cs, ref.v.data(), cs, ew / 2, eh / 2, ux, uy, uvdxy, 8, 8, mode);
    return;
  }
  int sumx = 0, sumy = 0;
  const int shift = d->quarter_sample ? 2 : 1, frac = (1 << shift) - 1;
  for (int i = 0; i < 4; ++i) {
    const int mx = d->mv[dir][i][0], my = d->mv[dir][i][1];
    int dxy = ((my & frac) << shift) | (mx & frac);
    int sx = d->mb_x * 16 + (i & 1) * 8 + (mx >> shift);
    int sy = d->mb_y * 16 + (i >> 1) * 8 + (my >> shift);
    sx = std::max(-16, std::min(d->width, sx));
    if (sx == d->width) dxy &= ~frac;
    sy = std::max(-16, std::min(d->height, sy));
    if (sy == d->height) dxy &= ~(frac << shift);
    uint8_t* dst = dy + (i & 1) * 8 + (i >> 1) * 8 * ls;
    if (d->quarter_sample) {
      fetch(d, block, 8, ref.y.data(), ls, ew, eh, sx, sy);
      qpel_mc(dst, ls, block, 8, dxy, mode);
      sumx += mx / 2;
      sumy += my / 2;
    } else {
      mc(d, dst, ls, ref.y.data(), ls, ew, eh, sx, sy, dxy, 8, 8, mode);
      sumx += mx;
      sumy += my;
    }
  }
  const int mx = round_chroma(sumx), my = round_chroma(sumy);
  int dxy = ((my & 1) << 1) | (mx & 1);
  int sx = d->mb_x * 8 + (mx >> 1), sy = d->mb_y * 8 + (my >> 1);
  sx = std::max(-8, std::min(d->width >> 1, sx));
  if (sx == (d->width >> 1)) dxy &= ~1;
  sy = std::max(-8, std::min(d->height >> 1, sy));
  if (sy == (d->height >> 1)) dxy &= ~2;
  mc(d, du, cs, ref.u.data(), cs, ew / 2, eh / 2, sx, sy, dxy, 8, 8, mode);
  mc(d, dv, cs, ref.v.data(), cs, ew / 2, eh / 2, sx, sy, dxy, 8, 8, mode);
}

// ---- inverse quantisation (FFmpeg's C dct_unquantize_*) ------------------
void dequant_h263_intra(int16_t* b, int qscale, int dc_scale) {
  const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
  b[0] = i16(b[0] * dc_scale);
  for (int i = 1; i < 64; ++i) {
    const int level = b[i];
    if (level) b[i] = i16(level < 0 ? level * qmul - qadd : level * qmul + qadd);
  }
}

void dequant_mpeg_intra(int16_t* b, int qscale, int dc_scale, const uint16_t* m) {
  const int q = qscale << 1;
  b[0] = i16(b[0] * dc_scale);
  for (int i = 1; i < 64; ++i) {
    const int level = b[i];
    if (!level) continue;
    const int v = (std::abs(level) * q * m[i]) >> 4;
    b[i] = i16(level < 0 ? -v : v);
  }
}

void dequant_mpeg_inter(int16_t* b, int qscale, const uint16_t* m) {
  const int q = qscale << 1;
  int sum = -1;
  for (int i = 0; i < 64; ++i) {
    const int level = b[i];
    if (!level) continue;
    const int v = (((std::abs(level) << 1) + 1) * q * m[i]) >> 5;
    const int out = level < 0 ? -v : v;
    b[i] = i16(out);
    sum += out;
  }
  b[63] = static_cast<int16_t>(b[63] ^ (sum & 1));
}

// the intra predictors of an inter macroblock (ff_clean_intra_table_entries)
void clean_intra(Decoder* d) {
  for (int n = 0; n < 4; ++n) {
    const size_t k = d->dcy0 + luma_index(d, n);
    d->dc_y[k] = 1024;
    std::memset(&d->ac_y[k * 16], 0, 16 * sizeof(int16_t));
  }
  for (int c = 0; c < 2; ++c) {
    const size_t k = d->dcc0 + d->mb_y * d->mbs + d->mb_x;
    d->dc_c[c][k] = 1024;
    std::memset(&d->ac_c[c][k * 16], 0, 16 * sizeof(int16_t));
  }
}

// FFmpeg's ff_mpv_reconstruct_mb for these VOPs
void reconstruct_mb(Decoder* d) {
  Picture& cur = *d->cur;
  const int xy = d->mb_x + d->mb_y * d->mbs;
  d->qtab[xy] = static_cast<int8_t>(d->qscale);
  const int ls = d->mb_w * 16, cs = d->mb_w * 8;
  uint8_t* dest[6];
  uint8_t* y = cur.y.data() + size_t(d->mb_y) * 16 * ls + d->mb_x * 16;
  dest[0] = y;
  dest[1] = y + 8;
  dest[2] = y + 8 * ls;
  dest[3] = y + 8 * ls + 8;
  dest[4] = cur.u.data() + size_t(d->mb_y) * 8 * cs + d->mb_x * 8;
  dest[5] = cur.v.data() + size_t(d->mb_y) * 8 * cs + d->mb_x * 8;
  if (!d->mb_intra) {
    d->edge_hit = false;
    const int rounding = (d->pict_type == kB || !d->no_rounding) ? 0 : 1;
    int mode = rounding;
    if (d->mv_dir & kMvFwd) {
      motion(d, 0, *d->last, mode);
      mode = 2;
    }
    if (d->mv_dir & kMvBwd) motion(d, 1, *d->next, mode);
    if (d->edge_hit) ++d->stats[kStatEdgeMb];
    for (int i = 0; i < 6; ++i) {
      if (d->last_index[i] < 0) continue;
      if (d->mpeg_quant) dequant_mpeg_inter(d->block[i], d->qscale, d->inter_matrix);
      if (d->xvid_idct)
        xvid_idct(dest[i], i < 4 ? ls : cs, d->block[i], true);
      else
        idct_add(dest[i], i < 4 ? ls : cs, d->block[i]);
    }
    clean_intra(d);
  } else {
    for (int i = 0; i < 6; ++i) {
      const int dc_scale = i < 4 ? d->y_dc_scale : d->c_dc_scale;
      if (d->mpeg_quant)
        dequant_mpeg_intra(d->block[i], d->qscale, dc_scale, d->intra_matrix);
      else
        dequant_h263_intra(d->block[i], d->qscale, dc_scale);
      if (d->xvid_idct)
        xvid_idct(dest[i], i < 4 ? ls : cs, d->block[i], false);
      else
        idct_put(dest[i], i < 4 ? ls : cs, d->block[i]);
    }
  }
}

// ---- slices and VOPs -------------------------------------------------------
// FFmpeg's ff_mpeg4_clean_buffers at a video packet's first macroblock
void clean_buffers(Decoder* d) {
  const int lw = d->b8s, cw = d->mbs;
  const int lxy = (2 * d->mb_y - 1) * lw + d->mb_x * 2 - 1;
  const int cxy = (d->mb_y - 1) * cw + d->mb_x - 1;
  std::memset(&d->ac_y[size_t(d->dcy0 + lxy) * 16], 0, size_t(lw * 2 + 1) * 16 * sizeof(int16_t));
  for (int c = 0; c < 2; ++c)
    std::memset(&d->ac_c[c][size_t(d->dcc0 + cxy) * 16], 0, size_t(cw + 1) * 16 * sizeof(int16_t));
  std::memset(d->last_mv, 0, sizeof(d->last_mv));
}

// the video packet header after a resync marker (FFmpeg's
// ff_mpeg4_decode_video_packet_header, reached the way ff_h263_resync
// reaches it)
int video_packet_header(Decoder* d, Bits& gb) {
  gb.skip(1);
  gb.align();
  if (gb.show(16) != 0) return kErrMpeg4Corrupt;
  if (gb.pos > gb.size() - 20) return kErrMpeg4Corrupt;
  int len = 0;
  for (; len < 32; ++len)
    if (gb.get1()) break;
  const int need = d->pict_type == kI   ? 16
                   : d->pict_type == kB ? std::max(std::max(d->f_code, d->b_code), 2) + 15
                                        : d->f_code + 15;
  if (len != need) return kErrMpeg4Corrupt;
  int mb_bits = 0;
  for (int k = d->mb_num - 1; k; k >>= 1) ++mb_bits;
  const int mb_num = gb.get(mb_bits);
  if (mb_num >= d->mb_num || !mb_num) return kErrMpeg4Corrupt;
  d->mb_x = mb_num % d->mb_w;
  d->mb_y = mb_num / d->mb_w;
  const int q = gb.get(5);
  if (q) d->qscale = q;
  if (gb.get1()) {  // header_extension_code
    while (gb.get1()) {
      if (gb.left() <= 0) return kErrMpeg4Corrupt;
    }
    gb.skip(1);
    gb.skip(d->time_bits);
    gb.skip(1);
    gb.skip(2);  // vop_coding_type
    gb.skip(3);  // intra_dc_vlc_thr
    if (d->pict_type != kI) gb.skip(3);
    if (d->pict_type == kB) gb.skip(3);
  }
  ++d->stats[kStatPackets];
  return kOk;
}

// ---- data partitioning ----------------------------------------------------
constexpr uint32_t kDcMarker = 0x6B001, kMotionMarker = 0x1F001;

// FFmpeg's mpeg4_decode_partition_a: up to the marker, each macroblock's
// type and quantiser change with its DCs (I-VOPs) or its vectors
// (P-VOPs); the count, or -1 on an error
int partition_a(Decoder* d, Bits& gb) {
  Picture& cur = *d->cur;
  int mb_num = 0;
  d->first_line = 1;
  for (; d->mb_y < d->mb_h; ++d->mb_y) {
    for (; d->mb_x < d->mb_w; ++d->mb_x) {
      const int xy = d->mb_x + d->mb_y * d->mbs;
      ++mb_num;
      if (d->mb_x == d->resync_x && d->mb_y == d->resync_y + 1) d->first_line = 0;
      int cbpc;
      if (d->pict_type == kI) {
        do {
          if (gb.show(19) == kDcMarker) return mb_num - 1;
          cbpc = d->t.intra_mcbpc.read(gb);
          if (cbpc < 0) return -1;
        } while (cbpc == 8);
        d->dp_cbp[xy] = static_cast<uint8_t>(cbpc & 3);
        cur.mbt[xy] = kMbIntra;
        if (cbpc & 4) {
          set_qscale(d, d->qscale + kQuantTab[gb.get(2)]);
          ++d->stats[kStatDquantMb];
        }
        d->qtab[xy] = static_cast<int8_t>(d->qscale);
        int dir = 0;
        for (int i = 0; i < 6; ++i) {
          int dc_dir;
          if (decode_dc(d, gb, i, &dc_dir) < 0) return -1;
          dir = (dir << 1) | (dc_dir ? 1 : 0);
        }
        d->dp_dir[xy] = static_cast<uint8_t>(dir);
        continue;
      }
      int16_t* mv = cur.mv.data() + 2 * (d->mv0 + luma_index(d, 0));
      auto set4 = [&](int mx, int my) {
        for (int k : {0, 1, d->b8s, d->b8s + 1}) {
          mv[2 * k] = static_cast<int16_t>(mx);
          mv[2 * k + 1] = static_cast<int16_t>(my);
        }
      };
      bool skipped = false;
      for (;;) {
        const uint32_t bits = gb.show(17);
        if (bits == kMotionMarker) return mb_num - 1;
        gb.skip(1);
        if (bits & 0x10000) {
          skipped = true;
          break;
        }
        cbpc = d->t.inter_mcbpc.read(gb);
        if (cbpc < 0) return -1;
        if (cbpc != 20) break;
      }
      if (skipped) {
        cur.mbt[xy] = kMbSkip;
        set4(0, 0);
        clean_intra(d);
        continue;
      }
      d->dp_cbp[xy] = static_cast<uint8_t>(cbpc & (8 + 3));
      if (cbpc & 4) {
        cur.mbt[xy] = kMbIntra;
        set4(0, 0);
        continue;
      }
      clean_intra(d);
      if (!(cbpc & 16)) {
        int px, py;
        cur.mbt[xy] = 0;
        pred_motion(d, 0, &px, &py);
        const int mx = decode_motion(d, gb, px, d->f_code);
        if (mx >= 0xffff) return -1;
        const int my = decode_motion(d, gb, py, d->f_code);
        if (my >= 0xffff) return -1;
        set4(mx, my);
      } else {
        cur.mbt[xy] = kMb8x8;
        for (int i = 0; i < 4; ++i) {
          int px, py;
          int16_t* slot = pred_motion(d, i, &px, &py);
          const int mx = decode_motion(d, gb, px, d->f_code);
          if (mx >= 0xffff) return -1;
          const int my = decode_motion(d, gb, py, d->f_code);
          if (my >= 0xffff) return -1;
          slot[0] = static_cast<int16_t>(mx);
          slot[1] = static_cast<int16_t>(my);
        }
      }
    }
    d->mb_x = 0;
  }
  return mb_num;
}

// FFmpeg's mpeg4_decode_partition_b: the same macroblocks' ac_pred and
// cbpy, the P-VOPs' quantiser changes and intra DCs; -1 on an error
int partition_b(Decoder* d, Bits& gb, int count) {
  const Picture& cur = *d->cur;
  int mb_num = 0;
  d->mb_x = d->resync_x;
  d->first_line = 1;
  for (d->mb_y = d->resync_y; mb_num < count; ++d->mb_y) {
    for (; mb_num < count && d->mb_x < d->mb_w; ++d->mb_x) {
      const int xy = d->mb_x + d->mb_y * d->mbs;
      ++mb_num;
      if (d->mb_x == d->resync_x && d->mb_y == d->resync_y + 1) d->first_line = 0;
      if (cur.mbt[xy] & kMbSkip) {
        d->qtab[xy] = static_cast<int8_t>(d->qscale);
        d->dp_cbp[xy] = 0;
        continue;
      }
      const bool intra = cur.mbt[xy] & kMbIntra;
      if (intra) d->dp_acpred[xy] = static_cast<uint8_t>(gb.get1());
      const int cbpy = d->t.cbpy.read(gb);
      if (cbpy < 0) return -1;
      if (d->pict_type == kI) {
        d->dp_cbp[xy] = static_cast<uint8_t>(d->dp_cbp[xy] | (cbpy << 2));
        continue;
      }
      if (d->dp_cbp[xy] & 8) {
        set_qscale(d, d->qscale + kQuantTab[gb.get(2)]);
        ++d->stats[kStatDquantMb];
      }
      d->qtab[xy] = static_cast<int8_t>(d->qscale);
      if (intra) {
        int dir = 0;
        for (int i = 0; i < 6; ++i) {
          int dc_dir;
          if (decode_dc(d, gb, i, &dc_dir) < 0) return -1;
          dir = (dir << 1) | (dc_dir ? 1 : 0);
        }
        d->dp_dir[xy] = static_cast<uint8_t>(dir);
      }
      d->dp_cbp[xy] = static_cast<uint8_t>((d->dp_cbp[xy] & 3) | ((intra ? cbpy : cbpy ^ 0xF) << 2));
    }
    if (mb_num >= count) return 0;
    d->mb_x = 0;
  }
  return 0;
}

// FFmpeg's ff_mpeg4_decode_partitions: partition A, its marker, partition
// B; the macroblock count, or -1 on an error
int decode_partitions(Decoder* d, Bits& gb) {
  const int n = partition_a(d, gb);
  if (n <= 0 || d->resync_x + d->resync_y * d->mb_w + n > d->mb_num) return -1;
  if (d->pict_type == kI) {
    while (gb.show(9) == 1) gb.skip(9);
    if (gb.get(19) != kDcMarker) return -1;
  } else {
    while (gb.show(10) == 1) gb.skip(10);
    if (gb.get(17) != kMotionMarker) return -1;
  }
  return partition_b(d, gb, n) < 0 ? -1 : n;
}

// FFmpeg's mpeg4_decode_partitioned_mb: one macroblock's texture from
// what the partitions left; kSliceOk, kSliceEnd or -1
int decode_partitioned_mb(Decoder* d, Bits& gb) {
  const int xy = d->mb_x + d->mb_y * d->mbs;
  const int type = d->cur->mbt[xy];
  int cbp = d->dp_cbp[xy];
  const int dc_vlc = d->qscale < d->dc_thr;
  if (d->qtab[xy] != d->qscale) set_qscale(d, d->qtab[xy]);
  std::memset(d->block, 0, sizeof(d->block));
  d->mb_intra = (type & kMbIntra) != 0;
  if (d->pict_type == kP) {
    const int16_t* mv = d->cur->mv.data() + 2 * d->mv0;
    for (int i = 0; i < 4; ++i) {
      d->mv[0][i][0] = mv[2 * luma_index(d, i)];
      d->mv[0][i][1] = mv[2 * luma_index(d, i) + 1];
    }
    if (type & kMbSkip) {
      for (int i = 0; i < 6; ++i) d->last_index[i] = -1;
      d->mv_dir = kMvFwd;
      d->mb_skipped = 1;
      ++d->stats[kStatSkipMb];
    } else if (!d->mb_intra) {
      d->mv_dir = kMvFwd;
      d->mv_8x8 = (type & kMb8x8) != 0;
      ++d->stats[kStatInterMb];
      if (d->mv_8x8) ++d->stats[kStat4mvMb];
    } else {
      ++d->stats[kStatIntraMbInP];
    }
  }
  if (d->mb_intra) {
    d->ac_pred = d->dp_acpred[xy];
    ++d->stats[kStatIntraMb];
    if (d->ac_pred) ++d->stats[kStatAcPredMb];
  }
  if (!(type & kMbSkip)) {
    for (int i = 0; i < 6; ++i) {
      if (decode_block(d, gb, d->block[i], i, cbp & 32, d->mb_intra, dc_vlc) < 0) return -1;
      cbp += cbp;
    }
  }
  if (--d->mb_left <= 0) return is_resync(d, gb) ? kSliceEnd : -1;
  if (is_resync(d, gb)) {
    const int delta = d->mb_x + 1 == d->mb_w ? 2 : 1;
    if (d->dp_cbp[xy + delta]) return kSliceEnd;
  }
  return kSliceOk;
}

// FFmpeg's decode_slice: macroblocks from (mb_x, mb_y) to the slice's end
int decode_slice(Decoder* d, Bits& gb) {
  d->first_line = 1;
  d->resync_x = d->mb_x;
  d->resync_y = d->mb_y;
  set_qscale(d, d->qscale);
  if (d->partitioned) {
    const int q = d->qscale;
    d->mb_left = decode_partitions(d, gb);
    if (d->mb_left < 0) return kErrMpeg4Corrupt;
    d->first_line = 1;
    d->mb_x = d->resync_x;
    d->mb_y = d->resync_y;
    set_qscale(d, q);
  }
  for (; d->mb_y < d->mb_h; ++d->mb_y) {
    for (; d->mb_x < d->mb_w; ++d->mb_x) {
      if (d->resync_x == d->mb_x && d->resync_y + 1 == d->mb_y) d->first_line = 0;
      d->mv_dir = kMvFwd;
      d->mv_8x8 = 0;
      d->mb_skipped = 0;
      const int ret = d->partitioned ? decode_partitioned_mb(d, gb) : decode_mb(d, gb);
      if (ret < 0) return kErrMpeg4Corrupt;
      if (d->pict_type != kB) update_motion_val(d);
      reconstruct_mb(d);
      if (ret == kSliceEnd) {
        if (++d->mb_x >= d->mb_w) {
          d->mb_x = 0;
          ++d->mb_y;
        }
        return kOk;
      }
    }
    d->mb_x = 0;
  }
  return kOk;
}

int decode_vop(Decoder* d, Bits& gb) {
  d->mb_x = d->mb_y = 0;
  int rc = decode_slice(d, gb);
  if (rc != kOk) return rc;
  while (d->mb_y < d->mb_h) {
    rc = video_packet_header(d, gb);
    if (rc != kOk) return rc;
    clean_buffers(d);
    rc = decode_slice(d, gb);
    if (rc != kOk) return rc;
  }
  return kOk;
}

// One packet (n == 0: the end of the stream, which gives the last
// reference where output is delayed).  *shown says whether a frame came out.
int decode_packet(Decoder* d, const uint8_t* data, size_t n, bool* shown) {
  *shown = false;
  if (!n) {
    if (!d->low_delay && d->next) {
      d->shown = d->next;
      d->next.reset();
      *shown = true;
    }
    return kOk;
  }
  Bits gb{data, static_cast<int64_t>(n), 0};
  bool vop = false;
  int rc = decode_headers(d, gb, &vop);
  if (rc != kOk || !vop) return rc;
  if (!d->have_vol) return kErrMpeg4NoVol;
  int what;
  rc = decode_vop_header(d, gb, &what);
  if (rc != kOk || what == kVopSkipped) return rc;
  workaround_bugs(d);
  if (d->pict_type != kI && !d->next) return kErrMpeg4NoKey;
  if (d->pict_type == kB && !d->last) return kOk;  // FFmpeg skips it: no past reference
  d->cur = new_picture(d);
  if (d->pict_type != kB) {
    d->last = d->next;
    d->next = d->cur;
  }
  ++d->stats[d->pict_type == kI ? kStatI : d->pict_type == kP ? kStatP : kStatB];
  if (d->pict_type == kP && d->no_rounding) ++d->stats[kStatRounding1];
  if (d->mpeg_quant) ++d->stats[kStatMpegQuant];
  if (d->loaded_matrix) ++d->stats[kStatLoadedMatrix];
  if (d->quarter_sample) ++d->stats[kStatQpel];
  if (d->partitioned) ++d->stats[kStatPartitioned];
  if (d->xvid_idct) ++d->stats[kStatXvidIdct];
  rc = decode_vop(d, gb);
  if (rc != kOk) return rc;
  if (d->pict_type == kB || d->low_delay) {
    d->shown = d->cur;
    *shown = true;
  } else if (d->last) {
    d->shown = d->last;
    *shown = true;
  }
  return kOk;
}

}  // namespace m4v
}  // namespace

extern "C" {

// ---- MP4 / MOV -------------------------------------------------------------
// Parse an MP4/MOV file held in memory (the caller keeps `buf` alive while
// the handle lives); *status gets 0 or the parse status.  A handle is
// returned where a video track was found, whatever its codec, so that the
// caller can name it; release it with fgpack_mp4_close.
void* fgpack_mp4_open(const uint8_t* buf, int64_t nbytes, int* status) {
  auto* t = new mp4::Track();
  mp4::Parser p{buf, static_cast<size_t>(nbytes)};
  *status = p.parse(t);
  if (t->entry.empty()) {
    delete t;
    return nullptr;
  }
  return t;
}

// {sample-entry width, height, samples, media timescale, stts samples,
// stts duration, esds object type (-1 without one), DecoderSpecificInfo
// bytes} into out[0..7], the sample entry's type (NUL-terminated, cut to
// cap - 1 bytes) into entry.
int fgpack_mp4_info(void* handle, int64_t* out, char* entry, int64_t cap) {
  const auto* t = static_cast<const mp4::Track*>(handle);
  out[0] = t->width;
  out[1] = t->height;
  out[2] = static_cast<int64_t>(t->samples.size());
  out[3] = t->timescale;
  out[4] = t->stts_samples;
  out[5] = t->stts_duration;
  out[6] = t->object_type;
  out[7] = static_cast<int64_t>(t->dsi.size());
  if (cap > 0) {
    const size_t n = std::min(t->entry.size(), static_cast<size_t>(cap - 1));
    std::memcpy(entry, t->entry.data(), n);
    entry[n] = 0;
  }
  return kOk;
}

// The samples in file order: byte offset and size, composition time (media
// timescale) and key flag; the DecoderSpecificInfo into dsi.
int fgpack_mp4_packets(void* handle, int64_t* offsets, int64_t* sizes, int64_t* cts,
                       uint8_t* keys, uint8_t* dsi) {
  const auto* t = static_cast<const mp4::Track*>(handle);
  for (size_t i = 0; i < t->samples.size(); ++i) {
    offsets[i] = t->samples[i].offset;
    sizes[i] = t->samples[i].size;
    cts[i] = t->samples[i].cts;
    keys[i] = t->samples[i].key;
  }
  if (!t->dsi.empty()) std::memcpy(dsi, t->dsi.data(), t->dsi.size());
  return kOk;
}

void fgpack_mp4_close(void* handle) { delete static_cast<mp4::Track*>(handle); }

// ---- MPEG-4 Part 2 ---------------------------------------------------------
// A decoder whose state lives across the packets of one stream.
void* fgpack_mpeg4_new() { return new m4v::Decoder(); }

// The headers before the first packet (an esds's DecoderSpecificInfo: VOS,
// VO, VOL, user data); {width, height} of the VOL into out (0 without one).
int fgpack_mpeg4_headers(void* handle, const uint8_t* data, int64_t nbytes, int64_t* out) {
  auto* d = static_cast<m4v::Decoder*>(handle);
  m4v::Bits gb{data, nbytes, 0};
  bool vop = false;
  const int rc = nbytes > 0 ? m4v::decode_headers(d, gb, &vop) : kOk;
  out[0] = d->have_vol ? d->width : 0;
  out[1] = d->have_vol ? d->height : 0;
  return rc;
}

// The container's codec tag (an AVI stream's fourcc; the rules FFmpeg
// applies to streams without an encoder's signature read it), upper-cased
// as FFmpeg's decoder takes it.
int fgpack_mpeg4_codec_tag(void* handle, const char* fourcc) {
  auto* d = static_cast<m4v::Decoder*>(handle);
  std::memset(d->codec_tag, 0, 4);
  for (int i = 0; i < 4 && fourcc[i]; ++i)
    d->codec_tag[i] = fourcc[i] >= 'a' && fourcc[i] <= 'z' ? fourcc[i] - 32 : fourcc[i];
  return kOk;
}

// Decode one packet (nbytes 0: the end of the stream); out gets {shown,
// width, height, the VOP type decoded (1 I, 2 P, 3 B)}.
int fgpack_mpeg4_decode(void* handle, const uint8_t* data, int64_t nbytes, int64_t* out) {
  auto* d = static_cast<m4v::Decoder*>(handle);
  if (nbytes < 0) return kErrArgs;
  bool shown = false;
  const int rc = m4v::decode_packet(d, data, static_cast<size_t>(nbytes), &shown);
  out[0] = shown;
  out[1] = d->width;
  out[2] = d->height;
  out[3] = d->pict_type;
  return rc;
}

// The last frame out, cut to the VOL's size: y (h, w), u and v
// ((h + 1) / 2, (w + 1) / 2).
int fgpack_mpeg4_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  const auto* d = static_cast<const m4v::Decoder*>(handle);
  if (!d->shown) return kErrArgs;
  const int w = d->width, h = d->height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  const int ys = d->mb_w * 16, cs = d->mb_w * 8;
  for (int r = 0; r < h; ++r) std::memcpy(y + size_t(r) * w, &d->shown->y[size_t(r) * ys], w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + size_t(r) * cw, &d->shown->u[size_t(r) * cs], cw);
    std::memcpy(v + size_t(r) * cw, &d->shown->v[size_t(r) * cs], cw);
  }
  return kOk;
}

// The last frame out as (h, w, 3) BGR, swscale's unscaled conversion.
int fgpack_mpeg4_bgr(void* handle, uint8_t* dst) {
  const auto* d = static_cast<const m4v::Decoder*>(handle);
  if (!d->shown) return kErrArgs;
  fgpack_i420_to_bgr24(d->shown->y.data(), d->shown->u.data(), d->shown->v.data(), d->mb_w * 16,
                       d->mb_w * 8, d->height, d->width, dst);
  return kOk;
}

// The stream's feature counts so far (the kStat enum), n of them.
int fgpack_mpeg4_stats(void* handle, int64_t* out, int64_t n) {
  const auto* d = static_cast<const m4v::Decoder*>(handle);
  for (int64_t i = 0; i < n && i < m4v::kMpeg4Stats; ++i) out[i] = d->stats[i];
  return m4v::kMpeg4Stats;
}

// What the last kErrMpeg4Tool named, NUL-terminated.
int fgpack_mpeg4_error(void* handle, char* buf, int64_t cap) {
  const auto* d = static_cast<const m4v::Decoder*>(handle);
  if (cap <= 0) return kErrArgs;
  const size_t n = std::min(d->error.size(), static_cast<size_t>(cap - 1));
  std::memcpy(buf, d->error.data(), n);
  buf[n] = 0;
  return kOk;
}

void fgpack_mpeg4_free(void* handle) { delete static_cast<m4v::Decoder*>(handle); }

// FFmpeg's simple IDCT of one 8x8 block of natural-order coefficients
// (clobbered), its outputs clipped to 0..255 into dst: what csrc/mjpeg.cpp
// reconstructs Motion-JPEG blocks with.
void fgpack_simple_idct_put(uint8_t* dst, int64_t stride, int16_t* blk) {
  m4v::idct_put(dst, static_cast<int>(stride), blk);
}

}  // extern "C"
