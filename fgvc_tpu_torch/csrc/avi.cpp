// avi: the RIFF/AVI container for the port's host library (compiled with
// csrc/fgpack.cpp into one library).  C++17.
//
// What FFmpeg's avi demuxer (avidec.c) gives cv2.VideoCapture for the
// first video stream of an AVI file: RIFF 'AVI ', LIST 'hdrl' with 'avih'
// and one LIST 'strl' a stream ('strh': the handler, dwScale, dwRate,
// dwLength; 'strf': the BITMAPINFOHEADER's size and compression fourcc, and
// any extradata after it), LIST 'odml', JUNK and INFO lists skipped, and
// LIST 'movi' with the stream's '##dc' / '##db' chunks, padded to even
// sizes (LIST 'rec ' groups inside it read through).  The chunks come in
// idx1's order where the file has one (offsets relative to 'movi' or
// absolute: FFmpeg takes the first entry to be the first chunk and offsets
// them all by the difference; entries of size 0 and repeated positions
// give no packet), else in the order 'movi' holds them (chunks of size 0
// skipped, as FFmpeg's reader discards them).  The frame count is strh's
// dwLength (FFmpeg's nb_frames), the rate dwRate / dwScale.
//
// Refused with a status: an OpenDML file's 'AVIX' RIFF continuation (files
// over 1 GB), more than one video stream, no video stream; a RIFF that is
// not 'AVI ' is not opened (data_io/video.py names it).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// the library's status codes for this file (enum Status of fgpack.cpp
// holds 0 .. -31, mpeg4video.cpp -32 .. -40, vp9video.cpp -41 .. -44,
// mjpeg.cpp -49 .. -52)
enum Status {
  kOk = 0,
  kErrCorrupt = -45,  // a chunk that overruns its parent, no hdrl or movi
  kErrAvix = -46,     // an OpenDML 'AVIX' RIFF continuation
  kErrStreams = -47,  // more than one video stream
  kErrNoVideo = -48,  // no video stream
};

inline uint32_t rl32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}
inline bool is(const uint8_t* p, const char* t) { return std::memcmp(p, t, 4) == 0; }

struct Packet {
  int64_t offset, size;
  uint8_t key;
};

struct Stream {
  int index = -1;  // the video stream's number among the file's streams
  char handler[5] = {}, compression[5] = {};
  int64_t width = 0, height = 0, scale = 0, rate = 0, length = 0;
  std::vector<uint8_t> extradata;
  std::vector<Packet> packets;
};

struct Parser {
  const uint8_t* b;
  size_t n;
  Stream* s;
  int streams = 0;
  size_t movi = 0, movi_end = 0, idx1 = 0, idx1_end = 0;  // 'movi' fourcc, idx1 body

  // the stream number of a '##xx' chunk id, -1 for anything else
  static int chunk_stream(const uint8_t* id) {
    if (id[0] < '0' || id[0] > '9' || id[1] < '0' || id[1] > '9') return -1;
    return (id[0] - '0') * 10 + (id[1] - '0');
  }

  int strl(size_t p, size_t end) {
    bool video = false;
    const int index = streams++;
    while (p + 8 <= end) {
      const size_t sz = rl32(b + p + 4), body = p + 8;
      if (body + sz > end) return kErrCorrupt;
      if (is(b + p, "strh")) {
        if (sz < 36) return kErrCorrupt;
        video = is(b + body, "vids");
        if (video) {
          if (s->index >= 0) return kErrStreams;
          s->index = index;
          std::memcpy(s->handler, b + body + 4, 4);
          s->scale = rl32(b + body + 20);
          s->rate = rl32(b + body + 24);
          s->length = rl32(b + body + 32);
        }
      } else if (is(b + p, "strf") && video) {
        if (sz < 40) return kErrCorrupt;
        s->width = static_cast<int32_t>(rl32(b + body + 4));
        s->height = static_cast<int32_t>(rl32(b + body + 8));
        s->height = s->height < 0 ? -s->height : s->height;  // a top-down bitmap
        std::memcpy(s->compression, b + body + 16, 4);
        s->extradata.assign(b + body + 40, b + body + sz);
      }
      p = body + sz + (sz & 1);
    }
    return kOk;
  }

  int list(size_t p, size_t end) {
    while (p + 8 <= end) {
      const size_t sz = rl32(b + p + 4), body = p + 8;
      if (body + sz > end) {
        if (!is(b + p, "LIST") || end - body < 4 || !is(b + body, "movi")) return kErrCorrupt;
        // a movi list whose size overruns the file (a writer stopped
        // before it patched the sizes): read what is there
        movi = body;
        movi_end = end;
        return kOk;
      }
      if (is(b + p, "LIST") && sz >= 4) {
        if (is(b + body, "hdrl")) {
          const int rc = list(body + 4, body + sz);
          if (rc != kOk) return rc;
        } else if (is(b + body, "strl")) {
          const int rc = strl(body + 4, body + sz);
          if (rc != kOk) return rc;
        } else if (is(b + body, "movi") && !movi) {
          movi = body;
          movi_end = body + sz;
        }
      } else if (is(b + p, "idx1") && !idx1) {
        idx1 = body;
        idx1_end = body + sz;
      }
      p = body + sz + (sz & 1);
    }
    return kOk;
  }

  // The first stream chunk's header in movi (FFmpeg's avi_sync); 0 without one.
  size_t first_chunk(size_t p, size_t end) const {
    while (p + 8 <= end) {
      const size_t sz = rl32(b + p + 4);
      if (is(b + p, "LIST") && p + 12 <= end && is(b + p + 8, "rec ")) {
        const size_t q = first_chunk(p + 12, std::min(end, p + 8 + sz));
        if (q) return q;
      } else if (chunk_stream(b + p) >= 0) {
        return p;
      }
      p += 8 + sz + (sz & 1);
    }
    return 0;
  }

  // movi in order: the video stream's chunks of nonzero size
  void scan(size_t p, size_t end) {
    while (p + 8 <= end) {
      const size_t sz = rl32(b + p + 4);
      if (is(b + p, "LIST") && p + 12 <= end && is(b + p + 8, "rec ")) {
        scan(p + 12, std::min(end, p + 8 + sz));
      } else if (chunk_stream(b + p) == s->index && (b[p + 2] == 'd') && sz) {
        if (p + 8 + sz > n) return;  // a chunk cut off at the end of the file
        s->packets.push_back({static_cast<int64_t>(p + 8), static_cast<int64_t>(sz), 1});
      }
      p += 8 + sz + (sz & 1);
    }
  }

  // idx1's entries of the video stream (FFmpeg's avi_read_idx1)
  int index() {
    const size_t first = first_chunk(movi + 4, movi_end);
    int64_t offset = 0, last = -1;
    bool have_offset = false;
    for (size_t e = idx1; e + 16 <= idx1_end; e += 16) {
      const int st = chunk_stream(b + e);
      if (st < 0 || st >= streams) continue;
      if (b[e + 2] == 'p' && b[e + 3] == 'c') continue;  // palette changes
      int64_t pos = rl32(b + e + 8);
      const uint32_t flags = rl32(b + e + 4), len = rl32(b + e + 12);
      if (!have_offset && first) offset = static_cast<int64_t>(first) - pos;
      have_offset = true;
      pos += offset;
      if (st != s->index || !len || pos == last) continue;
      last = pos;
      if (pos < 0 || static_cast<size_t>(pos) + 8 > n) return kErrCorrupt;
      const size_t sz = rl32(b + pos + 4);
      if (chunk_stream(b + pos) != s->index || static_cast<size_t>(pos) + 8 + sz > n)
        return kErrCorrupt;
      if (sz) s->packets.push_back({pos + 8, static_cast<int64_t>(sz), uint8_t((flags & 0x10) != 0)});
    }
    return kOk;
  }

  int parse() {
    if (n < 12 || !is(b, "RIFF") || !is(b + 8, "AVI ")) return kErrCorrupt;
    const size_t riff_end = std::min(n, size_t(8) + rl32(b + 4));
    int rc = list(12, riff_end);
    if (rc != kOk) return rc;
    // what follows the first RIFF: an OpenDML continuation is refused
    for (size_t p = riff_end + (riff_end & 1); p + 12 <= n;) {
      if (is(b + p, "RIFF") && is(b + p + 8, "AVIX")) return kErrAvix;
      p += 8 + rl32(b + p + 4);
      p += p & 1;
    }
    if (s->index < 0) return kErrNoVideo;
    if (!movi) return kErrCorrupt;
    if (idx1) {
      rc = index();
      if (rc != kOk) return rc;
    } else {
      scan(movi + 4, movi_end);
    }
    return kOk;
  }
};

}  // namespace

extern "C" {

// Parse an AVI file held in memory (the caller keeps `buf` alive while the
// handle lives); *status gets 0 or the parse status.  A handle is returned
// where a video stream was found, whatever its codec, so that the caller
// can name it; release it with fgpack_avi_close.
void* fgpack_avi_open(const uint8_t* buf, int64_t nbytes, int* status) {
  auto* s = new Stream();
  Parser p{buf, static_cast<size_t>(nbytes), s};
  *status = p.parse();
  if (s->index < 0) {
    delete s;
    return nullptr;
  }
  return s;
}

// {width, height, packets, dwRate, dwScale, dwLength, extradata bytes} into
// out[0..6]; strf's compression fourcc and strh's handler (NUL-terminated,
// 5 bytes each) into compression and handler.
int fgpack_avi_info(void* handle, int64_t* out, char* compression, char* handler) {
  const auto* s = static_cast<const Stream*>(handle);
  out[0] = s->width;
  out[1] = s->height;
  out[2] = static_cast<int64_t>(s->packets.size());
  out[3] = s->rate;
  out[4] = s->scale;
  out[5] = s->length;
  out[6] = static_cast<int64_t>(s->extradata.size());
  std::memcpy(compression, s->compression, 5);
  std::memcpy(handler, s->handler, 5);
  return kOk;
}

// The video stream's packets in order: byte offset, size and key flag
// (idx1's AVIIF_KEYFRAME; 1 where the file has no idx1); the extradata.
int fgpack_avi_packets(void* handle, int64_t* offsets, int64_t* sizes, uint8_t* keys,
                       uint8_t* extradata) {
  const auto* s = static_cast<const Stream*>(handle);
  for (size_t i = 0; i < s->packets.size(); ++i) {
    offsets[i] = s->packets[i].offset;
    sizes[i] = s->packets[i].size;
    keys[i] = s->packets[i].key;
  }
  if (!s->extradata.empty()) std::memcpy(extradata, s->extradata.data(), s->extradata.size());
  return kOk;
}

void fgpack_avi_close(void* handle) { delete static_cast<Stream*>(handle); }

}  // extern "C"
