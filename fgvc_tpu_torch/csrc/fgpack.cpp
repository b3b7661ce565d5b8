// fgpack: the port's host library (the JAX package's csrc/fgpack.cpp, with
// its own codecs in place of libjpeg).  C++17, links only pthread.
//
//   * FGPK packs: one flat file of frame records and an index, mmapped, read
//     in batches by a pthread pool (ctypes releases the GIL around a call).
//   * A JPEG decoder whose output equals libjpeg's default decompression
//     to JCS_RGB, JCS_GRAYSCALE or JCS_CMYK: baseline and extended
//     (SOF0/SOF1) and progressive (SOF2, jdphuff's four scan kinds into a
//     whole-image coefficient buffer), 8-bit, 1, 3 or 4 components, every
//     integral sampling (jdsample's h2v1, h2v2 and h1v2 triangle filters
//     and biases, int_upsample's box for the other ratios), DRI/RSTn, 8- and
//     16-bit DQT latched at a component's first scan; the islow integer IDCT
//     (jidctint); libjpeg-turbo's interblock smoothing of progressive files
//     whose scans leave one of the first ten coefficients incomplete
//     (jdcoefct's decompress_smooth_data, the 5 x 5 variant of 2.1 and
//     later); jdcolor's fixed-point YCbCr -> RGB, Y as grey and RGB -> grey.
//     A grey JPEG decodes to three equal channels in RGB.  A 4-component
//     file decodes to its CMYK samples only (the caller converts them);
//     arithmetic, lossless, hierarchical, 12-bit and YCCK files and
//     fractional samplings are refused with a status code.
//   * A baseline JPEG encoder whose bytes equal libjpeg's defaults (what
//     cv2.imencode and PIL write): JFIF APP0, jcparam's quality scaling of
//     the Annex K tables with force_baseline, jccolor's RGB -> YCbCr, 4:2:0
//     by jcsample's h2v2 average with its alternating bias (or 4:4:4,
//     cv2's IMWRITE_JPEG_SAMPLING_FACTOR_444), the islow
//     forward DCT (jfdctint), rounding quantisation (jcdctmgr), the standard
//     Huffman tables.
//   * PNG unfiltering (filters 0-4); inflate stays with the caller.
//   * A WebP decoder whose BGR output equals libwebp's WebPDecodeBGRInto
//     (cv2.imread's colour mode): the RIFF container with its VP8, VP8L and
//     VP8X chunks (ALPH, ICCP, EXIF and XMP skipped; animations refused),
//     lossy VP8 key frames to RFC 6386 with libwebp's fancy upsampling and
//     fixed-point YUV -> RGB, and lossless VP8L (its four transforms, meta
//     prefix codes, colour cache and LZ77 with the distance map).
//   * RGB -> I420 planes, OpenCV's BT.601 fixed point (cv2.COLOR_RGB2YUV_I420
//     bit for bit).
//   * Video: a Matroska/WebM demuxer (the video track's packets, their
//     timestamps and key flags), a VP8 decoder that carries one state across
//     a stream's frames (the key-frame code above plus RFC 6386's inter
//     frames: references, motion vectors, sub-pixel prediction, per-reference
//     loop-filter deltas, saved probabilities, hidden frames), its frames
//     converted to BGR24 by csrc/swscale.cpp (FFmpeg swscale's arithmetic,
//     what cv2.VideoCapture.read gives), which csrc/mpeg4video.cpp,
//     csrc/vp9video.cpp and csrc/mjpeg.cpp (compiled into the same
//     library) share.
//
// Pack file layout (little endian), the JAX package's FGPK v2:
//   [0:4]   magic "FGPK"
//   [4:8]   uint32 version (1 = raw only, 2 = per-record codec)
//   [8:16]  uint64 n_records
//   index:  n_records x {uint64 offset, uint64 nbytes,
//                        uint32 height, uint32 width, uint32 channels,
//                        uint32 codec}    (codec 0 = raw u8 HWC, 1 = JPEG;
//                                          h/w/c are the DECODED dims)
//   data:   record blobs
//
// C ABI (ctypes): see fgvc_tpu_torch/data_io/fgpack.py.  Every function
// returns 0 or a negative status (the Status enum below).

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <utility>
#include <vector>

#include "jpeg_huffman.h"

extern "C" int fgpack_yuv_to_bgr24(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                                   int64_t ystride, int64_t cstride, int64_t h, int64_t w,
                                   int chroma, int matrix, int full_range, int siting,
                                   uint8_t* dst);

namespace {

using namespace fgjpeg;

constexpr uint32_t kCodecRaw = 0;
constexpr uint32_t kCodecJpeg = 1;
constexpr int kLayoutHWC = 0;   // uint8 HWC, as decoded (RGB for JPEG)
constexpr int kLayoutI420 = 1;  // uint8 (h*3/2, w) YUV 4:2:0 planes
constexpr int kLayoutGrey = 2;  // uint8 HW, libjpeg's JCS_GRAYSCALE output
constexpr int kLayoutCmyk = 3;  // uint8 HW4, a CMYK JPEG's samples (JCS_CMYK)

enum Status {
  kOk = 0,
  kErrCorrupt = -1,      // a malformed marker, segment or Huffman code
  kErrTruncated = -2,    // the entropy-coded data ends before the last MCU
  kErrArithmetic = -4,   // SOF9-SOF11 / SOF13-SOF15, DAC
  kErrLossless = -5,     // SOF3 / SOF5-SOF7 (lossless, hierarchical)
  kErrPrecision = -6,    // sample precision other than 8 bits
  kErrComponents = -7,   // not 1, 3 or 4 components
  kErrSampling = -8,     // a fractional sampling ratio
  kErrSize = -9,         // decoded size differs from the expected one
  kErrIndex = -10,       // record index out of range
  kErrLayout = -11,      // I420 of an odd-sized or non-RGB frame
  kErrCodec = -12,       // unknown record codec
  kErrNoImage = -13,     // no SOF, or no scan
  kErrArgs = -14,        // invalid arguments
  kErrFilter = -15,      // PNG filter type above 4
  kErrWebpCorrupt = -16,    // a malformed RIFF container or WebP bitstream
  kErrWebpTruncated = -17,  // the WebP data ends before the image does
  kErrWebpAnimation = -18,  // an animated WebP (ANIM / ANMF)
  kErrWebpAlpha = -19,      // a lossy frame's ALPH plane (not decoded)
  kErrYcck = -20,           // 4 components with an Adobe transform other than 0
  kErrCmykLayout = -21,     // CMYK asked for RGB, grey or I420, or another JPEG for CMYK
  kErrMkvNotMatroska = -22,  // no EBML header with a Segment
  kErrMkvCorrupt = -23,      // an element that overruns its parent, or blocks before Tracks
  kErrMkvLacing = -24,       // a laced block of the video track
  kErrMkvEncoding = -25,     // a ContentEncoding (compressed or encrypted track)
  kErrMkvTracks = -26,       // more than one video track
  kErrMkvNoVideo = -27,      // no video track
  kErrVp8Corrupt = -28,      // a malformed VP8 frame
  kErrVp8Truncated = -29,    // a VP8 frame that ends before its last macroblock
  kErrVp8NoKey = -30,        // an inter frame before the stream's first key frame
  kErrVp8Size = -31,         // a key frame of another size than the stream's first
};

struct RecordMeta {
  uint64_t offset;
  uint64_t nbytes;
  uint32_t height;
  uint32_t width;
  uint32_t channels;
  uint32_t codec;
};

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_records = 0;
  const RecordMeta* index = nullptr;
};

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------- //
// islow DCT constants (jidctint.c / jfdctint.c): FIX(x) at 13 bits

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446;
constexpr int32_t F_0_390180644 = 3196;
constexpr int32_t F_0_541196100 = 4433;
constexpr int32_t F_0_765366865 = 6270;
constexpr int32_t F_0_899976223 = 7373;
constexpr int32_t F_1_175875602 = 9633;
constexpr int32_t F_1_501321110 = 12299;
constexpr int32_t F_1_847759065 = 15137;
constexpr int32_t F_1_961570560 = 16069;
constexpr int32_t F_2_053119869 = 16819;
constexpr int32_t F_2_562915447 = 20995;
constexpr int32_t F_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// Inverse DCT of one dequantized block (natural order) into 8 x 8 samples at
// `out` (row stride `stride`).  jidctint's two passes and its zero-AC
// shortcuts; the result is saturated to [0, 255] after the +128 shift, as
// libjpeg-turbo's SIMD IDCT packs it (the C version's range-limit table
// agrees with it wherever |x| < 512).
void idct_islow(const int32_t* in, uint8_t* out, size_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* ip = in + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      const int32_t dc = ip[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int32_t z2 = ip[16], z3 = ip[48];
    int32_t z1 = (z2 + z3) * F_0_541196100;
    int32_t tmp2 = z1 + z3 * -F_1_847759065;
    int32_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = ip[0];
    z3 = ip[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56];
    tmp1 = ip[40];
    tmp2 = ip[24];
    tmp3 = ip[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    const int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, s);
    wp[56] = descale(tmp10 - tmp3, s);
    wp[8] = descale(tmp11 + tmp2, s);
    wp[48] = descale(tmp11 - tmp2, s);
    wp[16] = descale(tmp12 + tmp1, s);
    wp[40] = descale(tmp12 - tmp1, s);
    wp[24] = descale(tmp13 + tmp0, s);
    wp[32] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t dc = clamp_u8(descale(wp[0], kPass1Bits + 3) + 128);
      std::memset(op, dc, 8);
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * F_0_541196100;
    int32_t tmp2 = z1 + z3 * -F_1_847759065;
    int32_t tmp3 = z1 + z2 * F_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    const int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    op[0] = clamp_u8(descale(tmp10 + tmp3, s) + 128);
    op[7] = clamp_u8(descale(tmp10 - tmp3, s) + 128);
    op[1] = clamp_u8(descale(tmp11 + tmp2, s) + 128);
    op[6] = clamp_u8(descale(tmp11 - tmp2, s) + 128);
    op[2] = clamp_u8(descale(tmp12 + tmp1, s) + 128);
    op[5] = clamp_u8(descale(tmp12 - tmp1, s) + 128);
    op[3] = clamp_u8(descale(tmp13 + tmp0, s) + 128);
    op[4] = clamp_u8(descale(tmp13 - tmp0, s) + 128);
  }
}

// Forward DCT of one block of centred samples, in place (jfdctint.c); the
// output is scaled up by 8, as jcdctmgr's divisors expect.
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    const int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    const int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    const int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    const int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * F_0_541196100;
    constexpr int s = kConstBits - kPass1Bits;
    p[2] = descale(z1 + tmp13 * F_0_765366865, s);
    p[6] = descale(z1 + tmp12 * -F_1_847759065, s);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int32_t z5 = (z3 + z4) * F_1_175875602;
    const int32_t t4 = tmp4 * F_0_298631336, t5 = tmp5 * F_2_053119869;
    const int32_t t6 = tmp6 * F_3_072711026, t7 = tmp7 * F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(t4 + z1 + z3, s);
    p[5] = descale(t5 + z2 + z4, s);
    p[3] = descale(t6 + z2 + z3, s);
    p[1] = descale(t7 + z1 + z4, s);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    const int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    const int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    const int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    const int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, kPass1Bits);
    p[32] = descale(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * F_0_541196100;
    constexpr int s = kConstBits + kPass1Bits;
    p[16] = descale(z1 + tmp13 * F_0_765366865, s);
    p[48] = descale(z1 + tmp12 * -F_1_847759065, s);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int32_t z5 = (z3 + z4) * F_1_175875602;
    const int32_t t4 = tmp4 * F_0_298631336, t5 = tmp5 * F_2_053119869;
    const int32_t t6 = tmp6 * F_3_072711026, t7 = tmp7 * F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(t4 + z1 + z3, s);
    p[40] = descale(t5 + z2 + z4, s);
    p[24] = descale(t6 + z2 + z3, s);
    p[8] = descale(t7 + z1 + z4, s);
  }
}

// ---------------------------------------------------------------------- //
// JPEG decode (the Huffman tables and the bit reader: jpeg_huffman.h)

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int32_t pred = 0;
  // the decoded samples at block-padded size
  std::vector<uint8_t> plane;
  size_t stride = 0;
  int plane_rows = 0;
  int ds_w = 0, ds_h = 0;  // downsampled_width / downsampled_height
  int blocks_w = 0, blocks_h = 0;  // blocks of a non-interleaved scan
  int pad_w = 0, pad_h = 0;        // blocks of the MCU-padded grid
  // the quantization table, latched at the component's first scan
  // (jdinput's latch_quant_tables), natural order
  uint16_t q[64] = {};
  bool latched = false;
  // progressive: the whole image's coefficients (pad_w x pad_h blocks of
  // 64 JCOEF, zigzag-free natural order) and jdphuff's coef_bits per
  // zigzag index (-1 until a scan sends it, then the scan's Al)
  std::vector<int16_t> coef;
  int coef_bits[64];
};

// natural positions of zigzag coefficients 0-9: jdcoefct's Q00..Q30_POS
const uint8_t kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

struct JpegDecoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64] = {};  // natural order
  bool qt_present[4] = {};
  HuffTable dc[4], ac[4];
  Component comp[4];
  int ncomp = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool have_frame = false, have_scan = false;
  bool progressive = false;

  JpegDecoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  // The next marker code at or after pos (libjpeg's next_marker: garbage
  // bytes skipped, then any run of 0xFF); -1 at the end of the data.
  int next_marker() {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      if (pos >= size) return -1;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return -1;
      const int m = data[pos++];
      if (m != 0) return m;
    }
  }

  bool read_u16(size_t at, int* v) const {
    if (at + 2 > size) return false;
    *v = (data[at] << 8) | data[at + 1];
    return true;
  }

  int parse_sof(size_t seg, size_t len) {
    if (len < 8) return kErrCorrupt;
    if (data[seg] != 8) return kErrPrecision;
    height = (data[seg + 1] << 8) | data[seg + 2];
    width = (data[seg + 3] << 8) | data[seg + 4];
    ncomp = data[seg + 5];
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return kErrComponents;
    if (len < 6 + 3 * static_cast<size_t>(ncomp)) return kErrCorrupt;
    if (height == 0 || width == 0) return kErrCorrupt;  // DNL is not supported
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = data[seg + 6 + 3 * i];
      c.h = data[seg + 7 + 3 * i] >> 4;
      c.v = data[seg + 7 + 3 * i] & 15;
      c.tq = data[seg + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kErrCorrupt;
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (ncomp == 1) {
        c.h = c.v = hmax = vmax = 1;  // one component: its factors do not matter
      }
      // jdsample upsamples every integral ratio; "Fractional sampling not
      // implemented" otherwise
      if (hmax % c.h || vmax % c.v) return kErrSampling;
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.ds_w = (width * c.h + hmax - 1) / hmax;
      c.ds_h = (height * c.v + vmax - 1) / vmax;
      c.blocks_w = (c.ds_w + 7) / 8;
      c.blocks_h = (c.ds_h + 7) / 8;
      c.pad_w = mcus_x * c.h > c.blocks_w ? mcus_x * c.h : c.blocks_w;
      c.pad_h = mcus_y * c.v > c.blocks_h ? mcus_y * c.v : c.blocks_h;
      c.stride = static_cast<size_t>(c.pad_w) * 8;
      c.plane_rows = c.pad_h * 8;
      c.plane.assign(c.stride * c.plane_rows, 0);
      if (progressive) {
        c.coef.assign(static_cast<size_t>(c.pad_w) * c.pad_h * 64, 0);
        for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
      }
    }
    have_frame = true;
    return kOk;
  }

  int parse_dqt(size_t seg, size_t len) {
    size_t i = 0;
    while (i < len) {
      const int pq = data[seg + i] >> 4, tq = data[seg + i] & 15;
      if (tq > 3 || pq > 1) return kErrCorrupt;
      const size_t need = 1 + 64 * (pq + 1);
      if (i + need > len) return kErrCorrupt;
      for (int k = 0; k < 64; ++k) {
        const size_t at = seg + i + 1 + k * (pq + 1);
        const int v = pq ? (data[at] << 8) | data[at + 1] : data[at];
        qt[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      qt_present[tq] = true;
      i += need;
    }
    return kOk;
  }

  int parse_dht(size_t seg, size_t len) {
    size_t i = 0;
    while (i < len) {
      if (i + 17 > len) return kErrCorrupt;
      const int tc = data[seg + i] >> 4, th = data[seg + i] & 15;
      if (tc > 1 || th > 3) return kErrCorrupt;
      HuffTable& t = tc ? ac[th] : dc[th];
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        t.bits[l] = data[seg + i + l];
        count += t.bits[l];
      }
      if (count > 256 || i + 17 + count > len) return kErrCorrupt;
      std::memset(t.vals, 0, sizeof(t.vals));
      std::memcpy(t.vals, data + seg + i + 17, count);
      if (!derive_huffman(&t)) return kErrCorrupt;
      i += 17 + count;
    }
    return kOk;
  }

  void decode_block(BitReader* b, Component& c, int bx, int by, int* err) {
    int32_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const HuffTable& dct = dc[c.dc_tbl];
    const HuffTable& act = ac[c.ac_tbl];
    const uint16_t* q = c.q;
    int s = decode_symbol(b, dct);
    if (s < 0 || s > 16) {
      *err = kErrCorrupt;
      return;
    }
    const int32_t diff = s ? extend(b->get(s), s) : 0;
    c.pred += diff;
    // libjpeg keeps coefficients as JCOEF (16 bits)
    coef[0] = static_cast<int16_t>(c.pred) * static_cast<int32_t>(q[0]);
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_symbol(b, act);
      if (rs < 0) {
        *err = kErrCorrupt;
        return;
      }
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        const int32_t v = extend(b->get(s), s);
        const int z = kNatural[k];
        coef[z] = static_cast<int16_t>(v) * static_cast<int32_t>(q[z]);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8,
               c.stride);
  }

  // One progressive scan's work on one block (jdphuff.c's decode_mcu_DC_first,
  // _DC_refine, _AC_first and _AC_refine); `eobrun` carries across blocks.
  void decode_prog_block(BitReader* b, Component& c, int bx, int by, int ss, int se, int ah,
                         int al, int* eobrun, int* err) {
    int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.pad_w + bx) * 64;
    if (ss == 0) {
      if (ah == 0) {
        const int s = decode_symbol(b, dc[c.dc_tbl]);
        if (s < 0 || s > 16) {
          *err = kErrCorrupt;
          return;
        }
        c.pred += s ? extend(b->get(s), s) : 0;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
      } else if (b->get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const HuffTable& act = ac[c.ac_tbl];
    if (ah == 0) {  // AC first
      if (*eobrun > 0) {
        --*eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        const int rs = decode_symbol(b, act);
        if (rs < 0) {
          *err = kErrCorrupt;
          return;
        }
        int r = rs >> 4;
        const int s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] =
              static_cast<int16_t>(static_cast<uint32_t>(extend(b->get(s), s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {  // EOBr: a run of 2^r + r appended bits bands, this one included
          *eobrun = (1 << r) + (r ? b->get(r) : 0) - 1;
          break;
        }
      }
      return;
    }
    // AC refine: one correction bit for each nonzero coefficient passed, a
    // new coefficient of magnitude 1 << al after r zero ones
    const int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (b->get(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = decode_symbol(b, act);
        if (rs < 0) {
          *err = kErrCorrupt;
          return;
        }
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {  // a size other than 1 is only a warning in libjpeg
          s = b->get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = (1 << r) + (r ? b->get(r) : 0);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --*eobrun;
    }
  }

  // One scan's entropy-coded data, from pos; leaves pos at the next marker.
  // Baseline blocks go through the IDCT at once; progressive ones (ss, se,
  // ah, al: the scan's spectral band and successive approximation) update
  // the coefficient buffer.
  int decode_scan(const int* ids, int ns, int ss, int se, int ah, int al) {
    Component* sc[4];
    for (int i = 0; i < ns; ++i) sc[i] = &comp[ids[i]];
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      // jdphuff's start_pass: a DC refinement needs no table, an AC scan no
      // DC table and a DC scan no AC table
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[c.dc_tbl].present) || (need_ac && !ac[c.ac_tbl].present))
        return kErrCorrupt;
      c.pred = 0;
    }
    BitReader b{data + pos, data + size};
    const bool interleaved = ns > 1;
    const int64_t total = interleaved
                              ? static_cast<int64_t>(mcus_x) * mcus_y
                              : static_cast<int64_t>(sc[0]->blocks_w) * sc[0]->blocks_h;
    int err = kOk;
    int eobrun = 0;
    int64_t left = restart_interval;
    auto block = [&](Component& c, int bx, int by) {
      if (progressive)
        decode_prog_block(&b, c, bx, by, ss, se, ah, al, &eobrun, &err);
      else
        decode_block(&b, c, bx, by, &err);
    };
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (left == 0) {
          if (b.overrun()) return kErrTruncated;
          // skip to the RSTn marker, then start afresh
          pos = static_cast<size_t>(b.p - data);
          const int mk = next_marker();
          if (mk < 0xD0 || mk > 0xD7) return mk < 0 ? kErrTruncated : kErrCorrupt;
          b.p = data + pos;
          b.reset();
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          eobrun = 0;
          left = restart_interval;
        }
        --left;
      }
      if (interleaved) {
        const int mx = static_cast<int>(m % mcus_x), my = static_cast<int>(m / mcus_x);
        for (int i = 0; i < ns && err == kOk; ++i) {
          Component& c = *sc[i];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx) block(c, mx * c.h + xx, my * c.v + yy);
        }
      } else {
        Component& c = *sc[0];
        block(c, static_cast<int>(m % c.blocks_w), static_cast<int>(m / c.blocks_w));
      }
      if (err != kOk) return b.overrun() ? kErrTruncated : err;
    }
    if (b.overrun()) return kErrTruncated;
    pos = static_cast<size_t>(b.p - data);
    return kOk;
  }

  // After a progressive file's last scan: dequantize and IDCT every block
  // of each component's own grid, through the interblock smoothing where
  // libjpeg applies it (jdcoefct's smoothing_ok: every component's table
  // latched with its first ten quantizers nonzero, every DC at least partly
  // known, and one of zigzag coefficients 1-9 not yet exact somewhere).
  int finish_progressive() {
    bool smooth = true, useful = false;
    for (int i = 0; i < ncomp && smooth; ++i) {
      const Component& c = comp[i];
      if (!c.latched || c.coef_bits[0] < 0) smooth = false;
      for (int k = 0; k < 10 && smooth; ++k) {
        if (c.q[kSmoothPos[k]] == 0) smooth = false;
        if (k > 0 && c.coef_bits[k] != 0) useful = true;
      }
    }
    int32_t deq[64];
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (smooth && useful) {
        idct_smoothed(c);
        continue;
      }
      for (int by = 0; by < c.blocks_h; ++by)
        for (int bx = 0; bx < c.blocks_w; ++bx) {
          const int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.pad_w + bx) * 64;
          for (int z = 0; z < 64; ++z) deq[z] = blk[z] * static_cast<int32_t>(c.q[z]);
          idct_islow(deq, c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8,
                     c.stride);
        }
    }
    return kOk;
  }

  // jdcoefct's decompress_smooth_data for one component (libjpeg-turbo 2.1
  // and later): each block's zigzag coefficients 1-5 that are still zero
  // and not exact are estimated from the DC values of its 5 x 5 block
  // neighbourhood; where no AC coefficient of the component has arrived
  // at all, coefficients 1-9 and the DC itself are, by a Gaussian-like
  // kernel.  The neighbourhood follows libjpeg's registers: rows clamp at
  // the top and at the iMCU grid's bottom (its dummy rows read), columns
  // slide in from the right and repeat the last one.
  void idct_smoothed(Component& c) {
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    const int64_t q00 = c.q[0];
    auto estimate = [](int64_t num, int64_t q, int al) -> int16_t {
      const int64_t mag = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
      int pred = static_cast<int>(mag);
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return static_cast<int16_t>(num >= 0 ? pred : -pred);
    };
    const int total = mcus_y, v = c.v;
    const int last_rows = c.blocks_h % v ? c.blocks_h % v : v;
    const int last = c.blocks_w - 1;
    int16_t ws[64];
    int32_t deq[64];
    for (int r = 0; r < c.blocks_h; ++r) {
      const int imcu = r / v, b = r - imcu * v;
      const int block_rows = imcu == total - 1 ? last_rows : v;
      const int image_row = imcu * block_rows + b, image_rows = block_rows * total;
      int rows[5];
      rows[2] = r;
      rows[1] = image_row > 0 ? r - 1 : r;
      rows[0] = image_row > 1 ? r - 2 : rows[1];
      rows[3] = image_row < image_rows - 1 ? r + 1 : r;
      rows[4] = image_row < image_rows - 2 ? r + 2 : rows[3];
      auto dc = [&](int row, int col) -> int {
        return c.coef[(static_cast<size_t>(row) * c.pad_w + col) * 64];
      };
      int R[5][5];
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) R[i][j] = dc(rows[i], 0);
      for (int bn = 0; bn <= last; ++bn) {
        if (bn == 0 && bn < last)
          for (int i = 0; i < 5; ++i) R[i][3] = R[i][4] = dc(rows[i], 1);
        if (bn + 1 < last)
          for (int i = 0; i < 5; ++i) R[i][4] = dc(rows[i], bn + 2);
        const int16_t* blk = c.coef.data() + (static_cast<size_t>(r) * c.pad_w + bn) * 64;
        std::memcpy(ws, blk, sizeof(ws));
        // DC01 .. DC25 of jdcoefct, row by row
        const int64_t D01 = R[0][0], D02 = R[0][1], D03 = R[0][2], D04 = R[0][3], D05 = R[0][4];
        const int64_t D06 = R[1][0], D07 = R[1][1], D08 = R[1][2], D09 = R[1][3], D10 = R[1][4];
        const int64_t D11 = R[2][0], D12 = R[2][1], D13 = R[2][2], D14 = R[2][3], D15 = R[2][4];
        const int64_t D16 = R[3][0], D17 = R[3][1], D18 = R[3][2], D19 = R[3][3], D20 = R[3][4];
        const int64_t D21 = R[4][0], D22 = R[4][1], D23 = R[4][2], D24 = R[4][3], D25 = R[4][4];
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {
          const int64_t num = q00 * (change_dc ? (-D01 - D02 + D04 + D05 - 3 * D06 + 13 * D07 -
                                                  13 * D09 + 3 * D10 - 3 * D11 + 38 * D12 -
                                                  38 * D14 + 3 * D15 - 3 * D16 + 13 * D17 -
                                                  13 * D19 + 3 * D20 - D21 - D22 + D24 + D25)
                                               : (-7 * D11 + 50 * D12 - 50 * D14 + 7 * D15));
          ws[1] = estimate(num, c.q[1], al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {
          const int64_t num = q00 * (change_dc ? (-D01 - 3 * D02 - 3 * D03 - 3 * D04 - D05 - D06 +
                                                  13 * D07 + 38 * D08 + 13 * D09 - D10 + D16 -
                                                  13 * D17 - 38 * D18 - 13 * D19 + D20 + D21 +
                                                  3 * D22 + 3 * D23 + 3 * D24 + D25)
                                               : (-7 * D03 + 50 * D08 - 50 * D18 + 7 * D23));
          ws[8] = estimate(num, c.q[8], al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {
          const int64_t num = q00 * (change_dc ? (D03 + 2 * D07 + 7 * D08 + 2 * D09 - 5 * D12 -
                                                  14 * D13 - 5 * D14 + 2 * D17 + 7 * D18 +
                                                  2 * D19 + D23)
                                               : (-D03 + 13 * D08 - 24 * D13 + 13 * D18 - D23));
          ws[16] = estimate(num, c.q[16], al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {
          const int64_t num =
              q00 * (change_dc ? (-D01 + D05 + 9 * D07 - 9 * D09 - 9 * D17 + 9 * D19 + D21 - D25)
                               : (D10 + D16 - 10 * D17 + 10 * D19 - D02 - D20 + D22 - D24 +
                                  D04 - D06 + 10 * D07 - 10 * D09));
          ws[9] = estimate(num, c.q[9], al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {
          const int64_t num = q00 * (change_dc ? (2 * D07 - 5 * D08 + 2 * D09 + D11 + 7 * D12 -
                                                  14 * D13 + 7 * D14 + D15 + 2 * D17 - 5 * D18 +
                                                  2 * D19)
                                               : (-D11 + 13 * D12 - 24 * D13 + 13 * D14 - D15));
          ws[2] = estimate(num, c.q[2], al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = estimate(q00 * (D07 - D09 + 2 * D12 - 2 * D14 + D17 - D19), c.q[3], al);
          if ((al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = estimate(q00 * (D07 - 3 * D08 + D09 - D17 + 3 * D18 - D19), c.q[10], al);
          if ((al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = estimate(q00 * (D07 - D09 - 3 * D12 + 3 * D14 + D17 - D19), c.q[17], al);
          if ((al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = estimate(q00 * (D07 + 2 * D08 + D09 - D17 - 2 * D18 - D19), c.q[24], al);
          const int64_t num =
              q00 * (-2 * D01 - 6 * D02 - 8 * D03 - 6 * D04 - 2 * D05 - 6 * D06 + 6 * D07 +
                     42 * D08 + 6 * D09 - 6 * D10 - 8 * D11 + 42 * D12 + 152 * D13 + 42 * D14 -
                     8 * D15 - 6 * D16 + 6 * D17 + 42 * D18 + 6 * D19 - 6 * D20 - 2 * D21 -
                     6 * D22 - 8 * D23 - 6 * D24 - 2 * D25);
          ws[0] = estimate(num, q00, 0);
        }
        for (int z = 0; z < 64; ++z) deq[z] = ws[z] * static_cast<int32_t>(c.q[z]);
        idct_islow(deq, c.plane.data() + static_cast<size_t>(r) * 8 * c.stride + bn * 8,
                   c.stride);
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 4; ++j) R[i][j] = R[i][j + 1];
      }
    }
  }

  int parse_sos(size_t seg, size_t len) {
    if (!have_frame) return kErrNoImage;
    if (len < 1) return kErrCorrupt;
    const int ns = data[seg];
    if (ns < 1 || ns > ncomp || len < 4 + 2 * static_cast<size_t>(ns)) return kErrCorrupt;
    const size_t sp = seg + 1 + 2 * static_cast<size_t>(ns);
    const int ss = data[sp], se = data[sp + 1], ah = data[sp + 2] >> 4, al = data[sp + 2] & 15;
    int ids[4];
    for (int i = 0; i < ns; ++i) {
      const int cid = data[seg + 1 + 2 * i];
      const int tables = data[seg + 2 + 2 * i];
      int found = -1;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == cid) found = k;
      if (found < 0) return kErrCorrupt;
      comp[found].dc_tbl = tables >> 4;
      comp[found].ac_tbl = tables & 15;
      if (comp[found].dc_tbl > 3 || comp[found].ac_tbl > 3) return kErrCorrupt;
      ids[i] = found;
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += comp[ids[i]].h * comp[ids[i]].v;
      if (blocks > 10) return kErrCorrupt;
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = comp[ids[i]];
      if (c.latched) continue;
      if (!qt_present[c.tq]) return kErrCorrupt;
      std::memcpy(c.q, qt[c.tq], sizeof(c.q));
      c.latched = true;
    }
    if (progressive) {
      // jdphuff's start_pass_phuff_decoder: the scan's parameters, then
      // each coefficient's bit position (an out-of-order progression is
      // only a warning there)
      const bool bad = (ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
                       (ah != 0 && al != ah - 1) || al > 13;
      if (bad) return kErrCorrupt;
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) comp[ids[i]].coef_bits[k] = al;
    }
    pos = seg + len;
    const int rc = decode_scan(ids, ns, ss, se, ah, al);
    if (rc == kOk) have_scan = true;
    return rc;
  }

  // The markers up to EOI (or the end of the data: what was decoded stands,
  // as in libjpeg); a progressive file's blocks are reconstructed at the end.
  int parse() {
    const int rc = parse_markers();
    if (rc != kOk || !progressive) return rc;
    return finish_progressive();
  }

  int parse_markers() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return kErrCorrupt;
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0) return have_scan ? kOk : (have_frame ? kErrTruncated : kErrNoImage);
      if (m == 0xD9) return have_scan ? kOk : kErrNoImage;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      int len = 0;
      if (!read_u16(pos, &len) || len < 2 || pos + len > size) return kErrTruncated;
      const size_t seg = pos + 2;
      const size_t seg_len = static_cast<size_t>(len) - 2;
      int rc = kOk;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          if (have_frame) return kErrCorrupt;
          progressive = m == 0xC2;
          rc = parse_sof(seg, seg_len);
          break;
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return kErrArithmetic;
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
          return kErrLossless;
        case 0xC4:
          rc = parse_dht(seg, seg_len);
          break;
        case 0xCC:
          return kErrArithmetic;  // DAC
        case 0xDB:
          rc = parse_dqt(seg, seg_len);
          break;
        case 0xDD:
          if (seg_len < 2) return kErrCorrupt;
          restart_interval = (data[seg] << 8) | data[seg + 1];
          break;
        case 0xDA:
          rc = parse_sos(seg, seg_len);
          if (rc != kOk) return rc;
          continue;  // pos is at the next marker
        case 0xDC:
          return kErrCorrupt;  // DNL
        case 0xE0:
          if (seg_len >= 14 && std::memcmp(data + seg, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xEE:
          if (seg_len >= 12 && std::memcmp(data + seg, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[seg + 11];
          }
          break;
        default:
          break;  // APPn, COM and others: skipped
      }
      if (rc != kOk) return rc;
      pos = seg + seg_len;
    }
  }

  // jdapimin's default_decompress_parms: is a 3-component image RGB?
  bool is_rgb() const {
    if (ncomp != 3 || saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // The upsampled output row y of component c into out (>= width + 2 bytes
  // of room beyond 2 * ds_w), as jinit_upsampler chooses: the fullsize
  // copy; h2v1 and h2v2 fancy upsampling where downsampled_width > 2; h1v2
  // fancy upsampling; int_upsample's box for every other ratio (h2v1 and
  // h2v2 of a component at most 2 samples wide among them).  The context
  // rows are jdmainct's: the row above row 0 is row 0, the rows past the
  // last are the last.
  void upsample_row(const Component& c, int y, uint8_t* out) const {
    const int hr = hmax / c.h, vr = vmax / c.v;
    if (hr == 1 && vr == 1) {
      std::memcpy(out, c.plane.data() + static_cast<size_t>(y) * c.stride, width);
      return;
    }
    if (hr == 1 && vr == 2) {  // h1v2: bias 1 towards the row above, 2 below
      const int row = y >> 1;
      int far_row = (y & 1) ? row + 1 : row - 1;
      if (far_row < 0) far_row = 0;
      if (far_row > c.ds_h - 1) far_row = c.ds_h - 1;
      const uint8_t* in0 = c.plane.data() + static_cast<size_t>(row) * c.stride;
      const uint8_t* in1 = c.plane.data() + static_cast<size_t>(far_row) * c.stride;
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    const int dw = c.ds_w;
    if (hr != 2 || vr > 2 || dw <= 2) {  // int_upsample, h2v1_upsample, h2v2_upsample
      const uint8_t* in = c.plane.data() + static_cast<size_t>(y / vr) * c.stride;
      for (int x = 0; x < width; ++x) out[x] = in[x / hr];
      return;
    }
    if (vr == 1) {  // h2v1
      const uint8_t* in = c.plane.data() + static_cast<size_t>(y) * c.stride;
      int v = in[0];
      out[0] = static_cast<uint8_t>(v);
      out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      int o = 2;
      int i = 1;
      for (int col = dw - 2; col > 0; --col, ++i) {
        v = in[i] * 3;
        out[o++] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        out[o++] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      v = in[i];
      out[o++] = static_cast<uint8_t>((v * 3 + in[i - 1] + 1) >> 2);
      out[o++] = static_cast<uint8_t>(v);
      return;
    }
    // h2v2
    const int row = y >> 1;
    int far_row = (y & 1) ? row + 1 : row - 1;
    if (far_row < 0) far_row = 0;
    if (far_row > c.ds_h - 1) far_row = c.ds_h - 1;
    const uint8_t* in0 = c.plane.data() + static_cast<size_t>(row) * c.stride;
    const uint8_t* in1 = c.plane.data() + static_cast<size_t>(far_row) * c.stride;
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    int o = 2, i = 2;
    for (int col = dw - 2; col > 0; --col, ++i) {
      next_sum = in0[i] * 3 + in1[i];
      out[o++] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      out[o++] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    out[o++] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[o++] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
  }

  // A 4-component file is YCCK where an Adobe marker says any transform
  // other than 0 (jdapimin's default_decompress_parms), CMYK otherwise.
  bool is_ycck() const { return ncomp == 4 && saw_adobe && adobe_transform != 0; }

  // The decoded rows into dst as `layout` asks: RGB (h * w * 3, jdcolor's
  // ycc_rgb_convert tables; grey replicated), grey (h * w: the Y or only
  // component, grayscale_convert, or rgb_gray_convert of an RGB file) or
  // CMYK (h * w * 4, a 4-component file's samples).
  int emit(uint8_t* dst, int layout) const {
    if ((ncomp == 4) != (layout == kLayoutCmyk)) return kErrCmykLayout;
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    static int cr_r[256], cb_b[256];
    static int32_t cr_g[256], cb_g[256];
    static bool init = [] {
      for (int i = 0; i < 256; ++i) {
        const int x = i - 128;
        cr_r[i] = (static_cast<int32_t>(1.40200 * 65536 + 0.5) * x + kHalf) >> kScale;
        cb_b[i] = (static_cast<int32_t>(1.77200 * 65536 + 0.5) * x + kHalf) >> kScale;
        cr_g[i] = -static_cast<int32_t>(0.71414 * 65536 + 0.5) * x;
        cb_g[i] = -static_cast<int32_t>(0.34414 * 65536 + 0.5) * x + kHalf;
      }
      return true;
    }();
    (void)init;
    // an upsampled row is at most 2 * ds_w <= width + 1 bytes (4 where
    // ds_w is 1, as libjpeg writes it)
    const size_t rs = static_cast<size_t>(width) + 8;
    std::vector<uint8_t> rows(4 * rs);
    uint8_t* r[4] = {rows.data(), rows.data() + rs, rows.data() + 2 * rs, rows.data() + 3 * rs};
    const bool rgb = is_rgb();
    const int out_ch = layout == kLayoutCmyk ? 4 : (layout == kLayoutGrey ? 1 : 3);
    // jdcolor's rgb_gray_convert: FIX(0.299), FIX(0.587), FIX(0.114) + ONE_HALF
    constexpr int32_t kRy = 19595, kGy = 38470, kBy = 7471;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = dst + static_cast<size_t>(y) * width * out_ch;
      const int used = (layout == kLayoutGrey && !rgb) ? 1 : ncomp;
      for (int ci = 0; ci < used; ++ci) upsample_row(comp[ci], y, r[ci]);
      if (layout == kLayoutCmyk) {
        for (int x = 0; x < width; ++x, o += 4)
          for (int ci = 0; ci < 4; ++ci) o[ci] = r[ci][x];
        continue;
      }
      if (layout == kLayoutGrey) {
        if (used == 1) {
          std::memcpy(o, r[0], width);
        } else {
          for (int x = 0; x < width; ++x)
            o[x] = static_cast<uint8_t>((kRy * r[0][x] + kGy * r[1][x] + kBy * r[2][x] + kHalf) >>
                                        kScale);
        }
        continue;
      }
      if (ncomp == 1) {
        for (int x = 0; x < width; ++x, o += 3) o[0] = o[1] = o[2] = r[0][x];
        continue;
      }
      if (rgb) {
        for (int x = 0; x < width; ++x, o += 3) {
          o[0] = r[0][x];
          o[1] = r[1][x];
          o[2] = r[2][x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x, o += 3) {
        const int yy = r[0][x], cb = r[1][x], cr = r[2][x];
        o[0] = clamp_u8(yy + cr_r[cr]);
        o[1] = clamp_u8(yy + ((cb_g[cb] + cr_g[cr]) >> kScale));
        o[2] = clamp_u8(yy + cb_b[cb]);
      }
    }
    return kOk;
  }
};

// {height, width, components, Adobe transform (-1 without an Adobe marker)}
// from the markers before the first scan.
int jpeg_info(const uint8_t* src, size_t nbytes, int64_t* out) {
  if (nbytes < 4 || src[0] != 0xFF || src[1] != 0xD8) return kErrCorrupt;
  JpegDecoder d(src, nbytes);
  d.pos = 2;
  bool have_sof = false;
  out[3] = -1;
  for (;;) {
    const int m = d.next_marker();
    if (m < 0 || m == 0xD9 || m == 0xDA) return have_sof ? kOk : kErrNoImage;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    int len = 0;
    if (!d.read_u16(d.pos, &len) || len < 2 || d.pos + len > nbytes)
      return have_sof ? kOk : kErrTruncated;
    const size_t seg = d.pos + 2;
    if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF)
      return kErrArithmetic;
    if (m == 0xC3 || m == 0xC5 || m == 0xC6 || m == 0xC7) return kErrLossless;
    if ((m == 0xC0 || m == 0xC1 || m == 0xC2) && !have_sof) {
      if (len < 8) return kErrCorrupt;
      if (src[seg] != 8) return kErrPrecision;
      out[0] = (src[seg + 1] << 8) | src[seg + 2];
      out[1] = (src[seg + 3] << 8) | src[seg + 4];
      out[2] = src[seg + 5];
      have_sof = true;
    }
    if (m == 0xEE && len >= 14 && std::memcmp(src + seg, "Adobe", 5) == 0) out[3] = src[seg + 11];
    d.pos = seg + len - 2;
  }
}

// Decode src into dst as `layout` asks (kLayoutHWC RGB, kLayoutGrey or
// kLayoutCmyk); kErrSize where the frame is not h x w.
int decode_jpeg(const uint8_t* src, size_t nbytes, uint8_t* dst, uint32_t h, uint32_t w,
                int layout) {
  JpegDecoder d(src, nbytes);
  const int rc = d.parse();
  if (rc != kOk) return rc;
  if (d.is_ycck()) return kErrYcck;
  if (static_cast<uint32_t>(d.width) != w || static_cast<uint32_t>(d.height) != h)
    return kErrSize;
  return d.emit(dst, layout);
}

// ---------------------------------------------------------------------- //
// JPEG encode (libjpeg's defaults: 4:2:0 YCbCr, JFIF 1.01, standard tables)

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct EncTable {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
};

// jpeg_make_c_derived_tbl
EncTable make_enc_table(const uint8_t* bits, const uint8_t* vals) {
  EncTable t;
  uint32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i) {
      t.code[vals[p]] = static_cast<uint16_t>(code++);
      t.size[vals[p]] = static_cast<uint8_t>(l);
      ++p;
    }
    code <<= 1;
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int n = 0;
  inline void put(uint32_t bits, int size) {
    acc = (acc << size) | (bits & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      const uint8_t c = static_cast<uint8_t>(acc >> (n - 8));
      out->push_back(c);
      if (c == 0xFF) out->push_back(0);
      n -= 8;
    }
    acc &= (1ull << n) - 1;
  }
  void flush() {  // pad with one-bits to a byte boundary
    if (n) put(0x7F, 7);
    acc = 0;
    n = 0;
  }
};

void encode_block(BitWriter* w, const int32_t* q, int32_t* last_dc, const EncTable& dct,
                  const EncTable& act) {
  int32_t temp = q[0] - *last_dc, temp2 = temp;
  *last_dc = q[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  w->put(dct.code[nbits], dct.size[nbits]);
  if (nbits) w->put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = q[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      w->put(act.code[0xF0], act.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    const int i = (r << 4) + nbits;
    w->put(act.code[i], act.size[i]);
    w->put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) w->put(act.code[0], act.size[0]);
}

// Forward DCT and quantisation of the 8 x 8 block at (bx, by) of a plane:
// jcdctmgr's islow path, rounding |x| / (8 q) half up (libjpeg-turbo's
// reciprocal multiply gives the same quotient for every 16-bit x).
void fdct_quant(const uint8_t* plane, size_t stride, int bx, int by, const uint16_t* qtab,
                int32_t* out) {
  int32_t d[64];
  const uint8_t* p = plane + static_cast<size_t>(by) * 8 * stride + bx * 8;
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[8 * r + c] = static_cast<int32_t>(p[r * stride + c]) - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    const int32_t div = static_cast<int32_t>(qtab[i]) << 3;
    int32_t t = d[i];
    if (t < 0) {
      t = -((-t + (div >> 1)) / div);
    } else {
      t = (t + (div >> 1)) / div;
    }
    out[i] = t;
  }
}

void put_u16(std::vector<uint8_t>* o, int v) {
  o->push_back(static_cast<uint8_t>(v >> 8));
  o->push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>* o, int index, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += bits[l];
  o->push_back(0xFF);
  o->push_back(0xC4);
  put_u16(o, 2 + 1 + 16 + count);
  o->push_back(static_cast<uint8_t>(index));
  for (int l = 1; l <= 16; ++l) o->push_back(bits[l]);
  for (int i = 0; i < count; ++i) o->push_back(vals[i]);
}

int encode_jpeg_rgb(const uint8_t* rgb, int h, int w, int quality, bool s444,
                    std::vector<uint8_t>* out) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return kErrArgs;
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  for (int i = 0; i < 64; ++i) {
    for (int t = 0; t < 2; ++t) {
      long v = ((t ? kStdChroma[i] : kStdLuma[i]) * static_cast<long>(scale) + 50) / 100;
      if (v <= 0) v = 1;
      if (v > 255) v = 255;  // force_baseline
      qt[t][i] = static_cast<uint16_t>(v);
    }
  }
  // jccolor's rgb_ycc_convert
  constexpr int kScale = 16;
  constexpr int32_t kHalf = 1 << (kScale - 1);
  constexpr int32_t kCbCrOffset = 128 << kScale;
  auto fix = [](double x) { return static_cast<int32_t>(x * 65536 + 0.5); };
  int32_t tab[8][256];
  for (int i = 0; i < 256; ++i) {
    tab[0][i] = fix(0.29900) * i;
    tab[1][i] = fix(0.58700) * i;
    tab[2][i] = fix(0.11400) * i + kHalf;
    tab[3][i] = -fix(0.16874) * i;
    tab[4][i] = -fix(0.33126) * i;
    tab[5][i] = fix(0.50000) * i + kCbCrOffset + kHalf - 1;  // B -> Cb and R -> Cr
    tab[6][i] = -fix(0.41869) * i;
    tab[7][i] = -fix(0.08131) * i;
  }
  const int mcu = s444 ? 8 : 16;
  const int mcus_x = (w + mcu - 1) / mcu, mcus_y = (h + mcu - 1) / mcu;
  const int wb_y = (w + 7) / 8, hb_y = (h + 7) / 8;
  // Y at (hb_y * 8) x (wb_y * 8), and the full-resolution chroma at
  // (rows to an even count) x (mcus_x * 16) for 4:2:0, at Y's size for
  // 4:4:4, edges replicated
  const int yw = wb_y * 8, yh = hb_y * 8;
  const int cw2 = s444 ? yw : mcus_x * 16, ch2 = s444 ? yh : (h + 1) / 2 * 2;
  std::vector<uint8_t> yp(static_cast<size_t>(yw) * yh);
  std::vector<uint8_t> cbf(static_cast<size_t>(cw2) * ch2), crf(cbf.size());
  for (int r = 0; r < h; ++r) {
    const uint8_t* px = rgb + static_cast<size_t>(r) * w * 3;
    uint8_t* yr = yp.data() + static_cast<size_t>(r) * yw;
    uint8_t* cbr = cbf.data() + static_cast<size_t>(r) * cw2;
    uint8_t* crr = crf.data() + static_cast<size_t>(r) * cw2;
    for (int c = 0; c < w; ++c, px += 3) {
      const int R = px[0], G = px[1], B = px[2];
      yr[c] = static_cast<uint8_t>((tab[0][R] + tab[1][G] + tab[2][B]) >> kScale);
      cbr[c] = static_cast<uint8_t>((tab[3][R] + tab[4][G] + tab[5][B]) >> kScale);
      crr[c] = static_cast<uint8_t>((tab[5][R] + tab[6][G] + tab[7][B]) >> kScale);
    }
    for (int c = w; c < yw; ++c) yr[c] = yr[w - 1];
    for (int c = w; c < cw2; ++c) {
      cbr[c] = cbr[w - 1];
      crr[c] = crr[w - 1];
    }
  }
  for (int r = h; r < yh; ++r)
    std::memcpy(yp.data() + static_cast<size_t>(r) * yw,
                yp.data() + static_cast<size_t>(h - 1) * yw, yw);
  for (int r = h; r < ch2; ++r) {
    std::memcpy(cbf.data() + static_cast<size_t>(r) * cw2,
                cbf.data() + static_cast<size_t>(h - 1) * cw2, cw2);
    std::memcpy(crf.data() + static_cast<size_t>(r) * cw2,
                crf.data() + static_cast<size_t>(h - 1) * cw2, cw2);
  }
  // 4:2:0: jcsample's h2v2_downsample (bias 1, 2, 1, 2, ... along each
  // row), then the last row repeated to whole MCU rows; 4:4:4 keeps them
  const int cw = s444 ? cw2 : mcus_x * 8, chh = mcus_y * 8, cds_h = ch2 / 2;
  std::vector<uint8_t> cb, cr;
  if (s444) {
    cb.swap(cbf);
    cr.swap(crf);
  } else {
    cb.resize(static_cast<size_t>(cw) * chh);
    cr.resize(cb.size());
  }
  for (int t = 0; t < 2 && !s444; ++t) {
    const std::vector<uint8_t>& src = t ? crf : cbf;
    std::vector<uint8_t>& dst = t ? cr : cb;
    for (int r = 0; r < cds_h; ++r) {
      const uint8_t* i0 = src.data() + static_cast<size_t>(2 * r) * cw2;
      const uint8_t* i1 = i0 + cw2;
      uint8_t* o = dst.data() + static_cast<size_t>(r) * cw;
      int bias = 1;
      for (int c = 0; c < cw; ++c) {
        o[c] = static_cast<uint8_t>((i0[2 * c] + i0[2 * c + 1] + i1[2 * c] + i1[2 * c + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int r = cds_h; r < chh; ++r)
      std::memcpy(dst.data() + static_cast<size_t>(r) * cw,
                  dst.data() + static_cast<size_t>(cds_h - 1) * cw, cw);
  }

  // headers, in jcmarker's order
  out->clear();
  out->reserve(static_cast<size_t>(w) * h / 2 + 1024);
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                              0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  out->insert(out->end(), soi_app0, soi_app0 + sizeof(soi_app0));
  for (int t = 0; t < 2; ++t) {
    out->push_back(0xFF);
    out->push_back(0xDB);
    put_u16(out, 67);
    out->push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) out->push_back(static_cast<uint8_t>(qt[t][kNatural[k]]));
  }
  out->push_back(0xFF);
  out->push_back(0xC0);
  put_u16(out, 17);
  out->push_back(8);
  put_u16(out, h);
  put_u16(out, w);
  const uint8_t sof_comps[] = {3, 1, static_cast<uint8_t>(s444 ? 0x11 : 0x22), 0, 2, 0x11, 1,
                               3, 0x11, 1};
  out->insert(out->end(), sof_comps, sof_comps + sizeof(sof_comps));
  put_dht(out, 0x00, kDcLumaBits, kDcVals);
  put_dht(out, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(out, 0x01, kDcChromaBits, kDcVals);
  put_dht(out, 0x11, kAcChromaBits, kAcChromaVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                         0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  out->insert(out->end(), sos, sos + sizeof(sos));

  const EncTable dc_l = make_enc_table(kDcLumaBits, kDcVals);
  const EncTable ac_l = make_enc_table(kAcLumaBits, kAcLumaVals);
  const EncTable dc_c = make_enc_table(kDcChromaBits, kDcVals);
  const EncTable ac_c = make_enc_table(kAcChromaBits, kAcChromaVals);
  BitWriter bw{out};
  int32_t last_dc[3] = {0, 0, 0};
  int32_t blk[4][64], cblk[64];
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (s444) {
        fdct_quant(yp.data(), yw, mx, my, qt[0], blk[0]);
        encode_block(&bw, blk[0], &last_dc[0], dc_l, ac_l);
      }
      // jccoefct's compress_data: dummy blocks past the image's blocks take
      // zero AC and the DC of the block before them in the MCU
      for (int yy = 0; yy < 2 && !s444; ++yy) {
        const int by = my * 2 + yy;
        for (int xx = 0; xx < 2; ++xx) {
          const int bx = mx * 2 + xx;
          int32_t* b = blk[yy * 2 + xx];
          if (by < hb_y && bx < wb_y) {
            fdct_quant(yp.data(), yw, bx, by, qt[0], b);
          } else {
            std::memset(b, 0, sizeof(blk[0]));
            b[0] = blk[yy * 2 + xx - 1][0];
          }
        }
      }
      for (int k = 0; k < 4 && !s444; ++k) encode_block(&bw, blk[k], &last_dc[0], dc_l, ac_l);
      fdct_quant(cb.data(), cw, mx, my, qt[1], cblk);
      encode_block(&bw, cblk, &last_dc[1], dc_c, ac_c);
      fdct_quant(cr.data(), cw, mx, my, qt[1], cblk);
      encode_block(&bw, cblk, &last_dc[2], dc_c, ac_c);
    }
  }
  bw.flush();
  out->push_back(0xFF);
  out->push_back(0xD9);
  return kOk;
}

// ---------------------------------------------------------------------- //
// RGB -> I420 (YUV 4:2:0 planes), bit-exact vs cv2.COLOR_RGB2YUV_I420:
// ITU-R BT.601 studio swing, shift-20 fixed point, round-half-up, chroma
// from the TOP-LEFT pixel of each 2x2 block (OpenCV sites chroma there, it
// does not average).
constexpr int kShift = 20;
constexpr int kHalf20 = 1 << (kShift - 1);

void rgb_to_i420(const uint8_t* rgb, uint8_t* dst, uint32_t h, uint32_t w) {
  uint8_t* yp = dst;
  uint8_t* up = dst + static_cast<size_t>(h) * w;
  uint8_t* vp = up + static_cast<size_t>(h / 2) * (w / 2);
  for (uint32_t r = 0; r < h; ++r) {
    const uint8_t* px = rgb + static_cast<size_t>(r) * w * 3;
    for (uint32_t c = 0; c < w; ++c, px += 3) {
      const int R = px[0], G = px[1], B = px[2];
      yp[static_cast<size_t>(r) * w + c] = clamp_u8(
          (269484 * R + 528482 * G + 102760 * B + (16 << kShift) + kHalf20) >> kShift);
      if ((r & 1) == 0 && (c & 1) == 0) {
        const size_t ci = static_cast<size_t>(r / 2) * (w / 2) + c / 2;
        up[ci] = clamp_u8(
            (-155188 * R - 305135 * G + 460324 * B + (128 << kShift) + kHalf20) >> kShift);
        vp[ci] = clamp_u8(
            (460324 * R - 385875 * G - 74448 * B + (128 << kShift) + kHalf20) >> kShift);
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// batch reads and decodes

inline int64_t out_nbytes(uint32_t h, uint32_t w, uint32_t c, int layout) {
  if (layout == kLayoutI420) return static_cast<int64_t>(h) * w * 3 / 2;
  return static_cast<int64_t>(h) * w * c;
}

// The channels a record decodes to in `layout` (I420's planes aside).
inline uint32_t layout_channels(int layout) {
  return layout == kLayoutGrey ? 1 : (layout == kLayoutCmyk ? 4 : 3);
}

// The first failure of a batch: the smallest failing slot and its status.
struct BatchError {
  pthread_mutex_t mu;
  int64_t index;
  int code;
  void set(int64_t i, int rc) {
    pthread_mutex_lock(&mu);
    if (index < 0 || i < index) {
      index = i;
      code = rc;
    }
    pthread_mutex_unlock(&mu);
  }
};

// Produce one record into `slot` (capacity `stride`).  `scratch` holds
// h*w*3 bytes for decode-then-convert paths; both buffers are caller-owned.
int produce_record(const RecordMeta& m, const uint8_t* blob, uint8_t* slot, int64_t stride,
                   int layout, uint8_t* scratch) {
  if (layout == kLayoutI420 && (m.channels != 3 || (m.height | m.width) & 1))
    return kErrLayout;  // I420 needs even-sized RGB frames
  if (out_nbytes(m.height, m.width, m.channels, layout) > stride) return kErrSize;

  if (m.codec == kCodecRaw) {
    if (layout == kLayoutHWC) {
      std::memcpy(slot, blob, m.nbytes);
      return kOk;
    }
    rgb_to_i420(blob, slot, m.height, m.width);
    return kOk;
  }
  if (m.codec == kCodecJpeg) {
    if (m.channels != layout_channels(layout)) return kErrLayout;
    uint8_t* out = (layout == kLayoutI420) ? scratch : slot;
    const int rc = decode_jpeg(blob, m.nbytes, out, m.height, m.width,
                               layout == kLayoutI420 ? kLayoutHWC : layout);
    if (rc != kOk) return rc;
    if (layout == kLayoutI420) rgb_to_i420(out, slot, m.height, m.width);
    return kOk;
  }
  return kErrCodec;
}

struct ReadTask {
  const Pack* pack;
  const int64_t* indices;
  int64_t n;
  uint8_t* dst;
  int64_t stride;  // bytes between consecutive output slots
  int layout;
  int64_t next;    // shared work counter
  pthread_mutex_t mu;
  BatchError err;
};

void* read_worker(void* arg) {
  ReadTask* t = static_cast<ReadTask*>(arg);
  std::vector<uint8_t> scratch;
  for (;;) {
    pthread_mutex_lock(&t->mu);
    const int64_t i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->n) break;
    const int64_t rec = t->indices[i];
    // an invalid index or a failed record is an error: skipping it would
    // hand uninitialised memory to the caller
    if (rec < 0 || rec >= static_cast<int64_t>(t->pack->n_records)) {
      t->err.set(i, kErrIndex);
      continue;
    }
    const RecordMeta& m = t->pack->index[rec];
    if (t->layout == kLayoutI420 && m.codec == kCodecJpeg)
      scratch.resize(static_cast<size_t>(m.height) * m.width * 3);
    const int rc = produce_record(m, t->pack->base + m.offset, t->dst + i * t->stride,
                                  t->stride, t->layout, scratch.data());
    if (rc != kOk) t->err.set(i, rc);
  }
  return nullptr;
}

// In-memory JPEG batch decode (TAP-Vid pickles hold per-frame JPEG bytes).
struct MemTask {
  const uint8_t* const* bufs;
  const int64_t* sizes;
  int64_t n;
  uint8_t* dst;
  int64_t stride;
  int layout;
  uint32_t h, w;
  int64_t next;
  pthread_mutex_t mu;
  BatchError err;
};

void* mem_worker(void* arg) {
  MemTask* t = static_cast<MemTask*>(arg);
  std::vector<uint8_t> scratch;
  if (t->layout == kLayoutI420) scratch.resize(static_cast<size_t>(t->h) * t->w * 3);
  for (;;) {
    pthread_mutex_lock(&t->mu);
    const int64_t i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->n) break;
    const RecordMeta m{0, static_cast<uint64_t>(t->sizes[i]), t->h, t->w,
                       layout_channels(t->layout), kCodecJpeg};
    const int rc = produce_record(m, t->bufs[i], t->dst + i * t->stride, t->stride,
                                  t->layout, scratch.data());
    if (rc != kOk) t->err.set(i, rc);
  }
  return nullptr;
}

void run_pool(void* (*worker)(void*), void* task, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  if (n_threads == 1) {
    worker(task);
    return;
  }
  pthread_t threads[16];
  int started = 0;
  for (int i = 0; i < n_threads; ++i)
    if (pthread_create(&threads[started], nullptr, worker, task) == 0) ++started;
  if (started == 0) worker(task);
  for (int i = 0; i < started; ++i) pthread_join(threads[i], nullptr);
}

void report(const BatchError& e, int64_t* status) {
  if (status) {
    status[0] = e.index;
    status[1] = e.code;
  }
}

// ---------------------------------------------------------------------- //
// WebP: the RIFF container, lossy VP8 (RFC 6386) and lossless VP8L, decoded
// to what libwebp's WebPDecodeBGRInto gives (cv2.imread's colour mode).
// Lossy frames go through libwebp's default output path: "fancy" 9-3-3-1
// chroma upsampling (UpsampleRgbLinePair) and its 14-bit fixed-point
// YUV -> RGB (VP8YUVToR/G/B).  The tables below are RFC 6386's normative
// ones, in libwebp's order of the 4x4 intra modes (DC, TM, VE, HE, RD, VR,
// LD, VL, HD, HU).

namespace webp {

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// the 4x4 intra mode tree (node i reads prob[i]; a leaf holds -mode)
const int8_t kYModesIntra4[18] = {0,  1, -1, 2, -2, 3, 4,  6,  -3,
                                  5, -4, -5, -6, 7, -7, 8, -8, -9};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// the 10 intra modes, then the DC variants at the frame's top and left edges
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU, DC_NOTOP, DC_NOLEFT,
       DC_NOTOPLEFT };

// The boolean entropy decoder of RFC 6386 section 7, in libwebp's form:
// `range` holds range - 1, and reading past the data feeds one zero byte
// and marks the reader `eof` (libwebp's VP8LoadFinalBytes).
struct BoolReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* s, size_t n) {
    p = s;
    end = s + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      value = (value << 8) | *p++;
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> bits);
    uint32_t r;
    int b;
    if (v > split) {
      r = range - split;
      value -= static_cast<uint64_t>(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  uint32_t literal(int n) {  // n bits, most significant first
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = static_cast<int>(literal(n));
    return bit(0x80) ? -v : v;
  }
  int optional_signed(int n) { return bit(0x80) ? signed_literal(n) : 0; }
};

struct FilterInfo {
  uint8_t limit = 0;   // 2 * level + ilevel (0: no filtering)
  uint8_t ilevel = 0;  // interior limit
  uint8_t inner = 0;   // filter the inner edges
  uint8_t hev = 0;     // high edge variance threshold
};

struct Quant {
  int y1[2], y2[2], uv[2];  // {dc, ac} dequantisation factors
};

struct MacroBlock {
  uint8_t segment = 0;
  uint8_t skip = 0;
  uint8_t is_i4x4 = 0;  // no Y2 block: B_PRED (or, in an inter frame, SPLITMV)
  uint8_t inter = 0;    // predicted from a reference frame
  uint8_t imodes[16];
  uint8_t uvmode = 0;
};

inline int clip(int v, int m) { return v < 0 ? 0 : (v > m ? m : v); }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---- transforms (libwebp's TransformOne / TransformWHT) ---------------
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

constexpr int BPS = 32;  // stride of the reconstruction work buffers

void transform_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction (libwebp dsp/dec.c) -------------------------------
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
#define DST(x, y) dst[(x) + (y) * BPS]

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1 + y * BPS];
    for (int x = 0; x < size; ++x) dst[x + y * BPS] = clip8(top[x] + l - tl);
  }
}

void vertical(uint8_t* dst, int size) {
  for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
}

void horizontal(uint8_t* dst, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[-1 + j * BPS], size);
}

// 16x16 and 8x8 predictions; mode in {B_DC, B_TM, B_VE, B_HE, DC_NOTOP,
// DC_NOLEFT, DC_NOTOPLEFT}
void predict_block(uint8_t* dst, int mode, int size) {
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case B_DC:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, (dc + size) >> (shift + 1), size);
      break;
    case DC_NOTOP:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, (dc + (size >> 1)) >> shift, size);
      break;
    case DC_NOLEFT:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, (dc + (size >> 1)) >> shift, size);
      break;
    case DC_NOTOPLEFT:
      fill(dst, 0x80, size);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      vertical(dst, size);
      break;
    default:  // B_HE
      horizontal(dst, size);
      break;
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {static_cast<uint8_t>(avg3(X, A, B)), static_cast<uint8_t>(avg3(A, B, C)),
                            static_cast<uint8_t>(avg3(B, C, D)), static_cast<uint8_t>(avg3(C, D, E))};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

// ---- loop filters (libwebp dsp/dec.c, on unsigned samples) --------------
inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }      // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter across one edge of `size` samples
void simple_edge(uint8_t* p, int step, int along, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along)
    if (needs_filter(p, step, t2)) do_filter2(p, step);
}

// the normal filter across one edge: 6-tap on macroblock edges, 4-tap inside
void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_thresh))
      do_filter2(p, step);
    else if (mb_edge)
      do_filter6(p, step);
    else
      do_filter4(p, step);
  }
}

// ---- VP8 frames: key frames (WebP and video), inter frames (video) --------
struct Mv {
  int16_t x = 0, y = 0;  // quarter luma pixels
};
inline bool same_mv(Mv a, Mv b) { return a.x == b.x && a.y == b.y; }
inline bool zero_mv(Mv a) { return a.x == 0 && a.y == 0; }

enum { REF_INTRA = 0, REF_LAST, REF_GOLDEN, REF_ALTREF };
// a macroblock's prediction; less one, the index of its loop-filter mode
// delta (MB_I16 has none)
enum { MB_I16 = 0, MB_BPRED, MB_ZERO, MB_MV, MB_SPLIT };
enum { SPLIT_16X8 = 0, SPLIT_8X16, SPLIT_8X8, SPLIT_4X4 };

// what later macroblocks of an inter frame read of one: its reference, mode
// and motion vectors (an intra macroblock has REF_INTRA and zero vectors;
// one without SPLITMV has its vector in all 16 bmv)
struct MbInfo {
  uint8_t ref = REF_INTRA, mode = MB_I16, split = 0;
  Mv mv;
  Mv bmv[16];
};

struct Frame {
  std::vector<uint8_t> y, u, v;  // mb_w * 16 by mb_h * 16 (chroma half)
};

// counts of the stream features the frames used (fgpack_vp8_stats)
enum {
  kStatKey = 0, kStatInter, kStatHidden, kStatIntraMb, kStatIntraBpred, kStatSplitMb,
  kStatSplit4x4, kStatGoldenMb, kStatAltrefMb, kStatLfDeltaFrames, kStatNoRefreshProbs,
  kStatGoldenUpdates, kStatAltrefUpdates, kStatSignBias, kStatEdgeMv, kStatSegmentFrames,
  kStatNoRefreshLast, kStatNewMv, kStatNearMv, kStatNearestMv, kStatZeroMv, kStatBilinear,
  kStatSimpleFilter, kStatNoFilter, kStatGoldenFromLast, kStatGoldenFromAlt, kStatAltFromLast,
  kStatAltFromGolden, kVp8Stats
};

struct Vp8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int siting = 0;  // the container's chroma location (fgpack_yuv_to_bgr24's siting)
  BoolReader br;       // the first partition: header and modes
  BoolReader parts[8];  // the token partitions
  int num_parts = 1;
  bool use_segment = false, update_map = false, absolute_delta = false;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_probs[3] = {255, 255, 255};
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;  // 0 none, 1 simple, 2 normal
  Quant quant[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;

  // planes of mb_w * 16 by mb_h * 16 (chroma half), before cropping
  std::vector<uint8_t> y, u, v;
  int ystride = 0, uvstride = 0;

  // video (one decoder for a stream's frames): FFmpeg's vp8 decoder where
  // RFC 6386 leaves a choice, and libvpx's skip rule for the inner edges
  bool video = false, key_frame = true, show = true;
  int version = 0;
  uint8_t ymode_p[4], uvmode_p[3], mv_p[2][19];
  struct Probs {
    uint8_t proba[4][8][3][11], ymode_p[4], uvmode_p[3], mv_p[2][19];
  } saved;  // the probabilities of a frame with refresh_entropy_probs = 0
  bool refresh_probs = true, refresh_last = true, refresh_golden = true, refresh_alt = true;
  int copy_golden = 0, copy_alt = 0;
  bool sign_bias[4] = {false, false, false, false};
  int prob_intra = 0, prob_last = 0, prob_gf = 0;
  std::vector<uint8_t> seg_map;  // mb_h x mb_w, kept where a frame does not update it
  std::vector<MbInfo> info;      // (mb_h + 1) x (mb_w + 1); row 0, column 0 outside
  std::shared_ptr<Frame> refs[4], shown;
  int64_t stats[kVp8Stats] = {};
};

const uint8_t kYModeProbInter[4] = {112, 86, 140, 37};
const uint8_t kUvModeProbInter[3] = {162, 101, 204};
const uint8_t kBModeProbInter[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const uint8_t kMvDefault[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
const uint8_t kMvUpdate[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};
const uint8_t kModeContexts[6][4] = {{7, 1, 1, 143},   {14, 18, 14, 107},   {135, 64, 57, 68},
                                     {60, 56, 128, 65}, {159, 134, 128, 34}, {234, 188, 128, 28}};
const uint8_t kSubMvProb[5][3] = {
    {147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
const uint8_t kSplits[4][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                                {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const uint8_t kSplitCount[4] = {2, 2, 4, 16};
const uint8_t kSplitFirst[4][16] = {{0, 8},
                                    {0, 2},
                                    {0, 2, 8, 10},
                                    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
// the six-tap filters by eighth pixel (version 0)
const int kSixtap[8][6] = {{0, 0, 128, 0, 0, 0},   {0, -6, 123, 12, -1, 0}, {2, -11, 108, 36, -8, 1},
                           {0, -9, 93, 50, -6, 0},  {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
                           {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0}};

// What a key frame resets: the probabilities, segmentation and loop-filter
// deltas (FFmpeg's keyframe branch of vp8_decode_frame_header).
void reset_key_frame_state(Vp8Decoder* d) {
  std::memcpy(d->proba, kCoeffsProba0, sizeof(d->proba));
  std::memcpy(d->ymode_p, kYModeProbInter, sizeof(d->ymode_p));
  std::memcpy(d->uvmode_p, kUvModeProbInter, sizeof(d->uvmode_p));
  std::memcpy(d->mv_p, kMvDefault, sizeof(d->mv_p));
  d->use_segment = d->update_map = d->absolute_delta = false;
  std::memset(d->quantizer, 0, sizeof(d->quantizer));
  std::memset(d->filter_strength, 0, sizeof(d->filter_strength));
  d->use_lf_delta = false;
  std::memset(d->ref_lf_delta, 0, sizeof(d->ref_lf_delta));
  std::memset(d->mode_lf_delta, 0, sizeof(d->mode_lf_delta));
}

// The loop filter of one macroblock at `lvl` (before clipping to 0..63):
// interior limit from the sharpness, high edge variance threshold by the
// frame type (RFC 6386 section 15.2).
FilterInfo filter_info(const Vp8Decoder& d, int lvl, bool inner) {
  FilterInfo f;
  lvl = clip(lvl, 63);
  if (lvl > 0) {
    int ilevel = lvl;
    if (d.sharpness > 0) {
      ilevel >>= d.sharpness > 4 ? 2 : 1;
      if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
    }
    if (ilevel < 1) ilevel = 1;
    f.ilevel = static_cast<uint8_t>(ilevel);
    f.limit = static_cast<uint8_t>(2 * lvl + ilevel);
    if (d.key_frame)
      f.hev = lvl >= 40 ? 2 : (lvl >= 15 ? 1 : 0);
    else
      f.hev = lvl >= 40 ? 3 : (lvl >= 20 ? 2 : (lvl >= 15 ? 1 : 0));
  }
  f.inner = inner;
  return f;
}

inline int segment_level(const Vp8Decoder& d, int s) {
  if (!d.use_segment) return d.level;
  return d.filter_strength[s] + (d.absolute_delta ? 0 : d.level);
}

// The frame header (RFC 6386 sections 9 and 19.2).  A WebP image is one key
// frame that is shown; a video frame (d->video) may be an inter frame and
// keeps what earlier frames set.
int parse_vp8_header(Vp8Decoder* d, const uint8_t* data, size_t size) {
  if (size < (d->video ? 3u : 10u)) return kErrWebpTruncated;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (profile > 3) return kErrWebpCorrupt;
  if (!d->video && (!key_frame || !show)) return kErrWebpCorrupt;
  d->key_frame = key_frame;
  d->show = show;
  d->version = profile;
  if (key_frame) {
    if (size < 10) return kErrWebpTruncated;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kErrWebpCorrupt;
    const int width = (data[6] | (data[7] << 8)) & 0x3fff;
    const int height = (data[8] | (data[9] << 8)) & 0x3fff;
    if (width == 0 || height == 0) return kErrWebpCorrupt;
    if (d->mb_w && (width != d->width || height != d->height)) return kErrVp8Size;
    d->width = width;
    d->height = height;
    d->mb_w = (width + 15) >> 4;
    d->mb_h = (height + 15) >> 4;
    data += 10;
    size -= 10;
    reset_key_frame_state(d);
  } else {
    if (!d->refs[REF_LAST]) return kErrVp8NoKey;
    data += 3;
    size -= 3;
  }
  if (part0 > size) return kErrWebpTruncated;
  BoolReader& br = d->br;
  br.init(data, part0);
  if (key_frame) {
    br.bit(0x80);  // colour space
    br.bit(0x80);  // clamping type
  }
  d->use_segment = br.bit(0x80);
  d->update_map = false;
  if (d->use_segment) {
    d->update_map = br.bit(0x80);
    if (br.bit(0x80)) {  // update the segment feature data
      d->absolute_delta = br.bit(0x80);
      for (int s = 0; s < 4; ++s) d->quantizer[s] = br.optional_signed(7);
      for (int s = 0; s < 4; ++s) d->filter_strength[s] = br.optional_signed(6);
    }
    if (d->update_map)
      for (int s = 0; s < 3; ++s) d->segment_probs[s] = br.bit(0x80) ? br.literal(8) : 255;
  }
  d->simple = br.bit(0x80);
  d->level = br.literal(6);
  d->sharpness = br.literal(3);
  d->use_lf_delta = br.bit(0x80);
  if (d->use_lf_delta && br.bit(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) d->ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) d->mode_lf_delta[i] = br.signed_literal(6);
  }
  d->filter_type = d->level == 0 ? 0 : (d->simple ? 1 : 2);
  if (br.eof) return kErrWebpTruncated;

  // token partitions: 3-byte sizes, the last takes the rest
  const uint8_t* buf = data + part0;
  size_t left = size - part0;
  d->num_parts = 1 << br.literal(2);
  const size_t last = d->num_parts - 1;
  if (left < 3 * last) return kErrWebpTruncated;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  left -= 3 * last;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    d->parts[p].init(start, psize);
    start += psize;
    left -= psize;
    sz += 3;
  }
  d->parts[last].init(start, left);
  if (left == 0) return kErrWebpTruncated;

  // dequantisation (libwebp's VP8ParseQuant)
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.optional_signed(4), dqy2_dc = br.optional_signed(4);
  const int dqy2_ac = br.optional_signed(4), dquv_dc = br.optional_signed(4);
  const int dquv_ac = br.optional_signed(4);
  for (int s = 0; s < 4; ++s) {
    int q;
    if (d->use_segment) {
      q = d->quantizer[s] + (d->absolute_delta ? 0 : base_q0);
    } else if (s > 0) {
      d->quant[s] = d->quant[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = d->quant[s];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  if (key_frame) {
    d->refresh_probs = br.bit(0x80);
    d->refresh_golden = d->refresh_alt = d->refresh_last = true;
    d->copy_golden = d->copy_alt = 0;
  } else {
    d->refresh_golden = br.bit(0x80);
    d->refresh_alt = br.bit(0x80);
    d->copy_golden = d->refresh_golden ? 0 : static_cast<int>(br.literal(2));
    d->copy_alt = d->refresh_alt ? 0 : static_cast<int>(br.literal(2));
    d->sign_bias[REF_GOLDEN] = br.bit(0x80);
    d->sign_bias[REF_ALTREF] = br.bit(0x80);
    d->refresh_probs = br.bit(0x80);
    d->refresh_last = br.bit(0x80);
  }
  if (!d->refresh_probs) {  // this frame's updates hold for this frame only
    std::memcpy(d->saved.proba, d->proba, sizeof(d->proba));
    std::memcpy(d->saved.ymode_p, d->ymode_p, sizeof(d->ymode_p));
    std::memcpy(d->saved.uvmode_p, d->uvmode_p, sizeof(d->uvmode_p));
    std::memcpy(d->saved.mv_p, d->mv_p, sizeof(d->mv_p));
  }
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          if (br.bit(kCoeffsUpdateProba[t][b][c][p])) d->proba[t][b][c][p] = br.literal(8);
  d->use_skip_proba = br.bit(0x80);
  if (d->use_skip_proba) d->skip_p = br.literal(8);
  if (!key_frame) {
    d->prob_intra = br.literal(8);
    d->prob_last = br.literal(8);
    d->prob_gf = br.literal(8);
    if (br.bit(0x80))
      for (int i = 0; i < 4; ++i) d->ymode_p[i] = br.literal(8);
    if (br.bit(0x80))
      for (int i = 0; i < 3; ++i) d->uvmode_p[i] = br.literal(8);
    for (int c = 0; c < 2; ++c)
      for (int p = 0; p < 19; ++p)
        if (br.bit(kMvUpdate[c][p])) {
          const int x = br.literal(7);
          d->mv_p[c][p] = x ? static_cast<uint8_t>(x << 1) : 1;
        }
  }
  return br.eof ? kErrWebpTruncated : kOk;
}

// the segment id of a macroblock where the frame updates the map
inline int read_segment(Vp8Decoder* d) {
  BoolReader& br = d->br;
  return !br.bit(d->segment_probs[0]) ? br.bit(d->segment_probs[1])
                                      : br.bit(d->segment_probs[2]) + 2;
}

void parse_modes(Vp8Decoder* d, MacroBlock* mb, uint8_t* top, uint8_t* left) {
  BoolReader& br = d->br;
  mb->segment = d->update_map ? read_segment(d) : 0;
  mb->skip = d->use_skip_proba ? br.bit(d->skip_p) : 0;
  mb->is_i4x4 = !br.bit(145);
  if (!mb->is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
    mb->imodes[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  mb->uvmode = !br.bit(142) ? B_DC : (!br.bit(114) ? B_VE : (br.bit(183) ? B_TM : B_HE));
}

// one motion vector component (RFC 6386 section 17.2), quarter pixels
int read_mv_component(BoolReader& br, const uint8_t* p) {
  int x = 0;
  if (br.bit(p[0])) {  // long form: bits 0-2, 9-4, then 3 (implicit below 16)
    for (int i = 0; i < 3; ++i) x += br.bit(p[9 + i]) << i;
    for (int i = 9; i > 3; --i) x += br.bit(p[9 + i]) << i;
    if (!(x & 0xfff0) || br.bit(p[12])) x += 8;
  } else {  // the short tree
    const int b2 = br.bit(p[2]);
    const int b1 = br.bit(p[3 + 3 * b2]);
    x = 4 * b2 + 2 * b1 + br.bit(p[4 + 3 * b2 + b1]);
  }
  return x && br.bit(p[1]) ? -x : x;
}

inline Mv read_mv(Vp8Decoder* d, Mv base) {
  Mv m;
  m.y = static_cast<int16_t>(base.y + read_mv_component(d->br, d->mv_p[0]));
  m.x = static_cast<int16_t>(base.x + read_mv_component(d->br, d->mv_p[1]));
  return m;
}

// a vector clamped to 16 pixels past the frame's macroblocks
inline Mv clamp_mv(const Vp8Decoder& d, Mv m, int mb_x, int mb_y) {
  const int lo_x = -64 * (mb_x + 1), hi_x = 64 * (d.mb_w - mb_x);
  const int lo_y = -64 * (mb_y + 1), hi_y = 64 * (d.mb_h - mb_y);
  m.x = static_cast<int16_t>(m.x < lo_x ? lo_x : (m.x > hi_x ? hi_x : m.x));
  m.y = static_cast<int16_t>(m.y < lo_y ? lo_y : (m.y > hi_y ? hi_y : m.y));
  return m;
}

// SPLITMV: the partitioning, then each partition's vector from the left and
// above sub-block vectors' context (FFmpeg's decode_splitmvs)
void parse_split(Vp8Decoder* d, MbInfo* mi, const MbInfo& left_mb, const MbInfo& above_mb,
                 Mv best) {
  BoolReader& br = d->br;
  int s;
  if (br.bit(110))
    s = br.bit(111) ? SPLIT_16X8 + br.bit(150) : SPLIT_8X8;
  else
    s = SPLIT_4X4;
  mi->split = static_cast<uint8_t>(s);
  for (int n = 0; n < kSplitCount[s]; ++n) {
    const int k = kSplitFirst[s][n];
    const Mv left = (k & 3) ? mi->bmv[k - 1] : left_mb.bmv[k + 3];
    const Mv above = k > 3 ? mi->bmv[k - 4] : above_mb.bmv[k + 12];
    const uint8_t* p;
    if (same_mv(left, above))
      p = kSubMvProb[zero_mv(left) ? 4 : 3];
    else if (zero_mv(above))
      p = kSubMvProb[2];
    else
      p = kSubMvProb[zero_mv(left) ? 1 : 0];
    Mv m;
    if (!br.bit(p[0]))
      m = left;
    else if (!br.bit(p[1]))
      m = above;
    else if (!br.bit(p[2]))
      m = Mv();
    else
      m = read_mv(d, best);
    for (int b = 0; b < 16; ++b)
      if (kSplits[s][b] == n) mi->bmv[b] = m;
  }
  mi->mv = mi->bmv[15];
}

// The modes of one macroblock of an inter frame (RFC 6386 section 16;
// FFmpeg's decode_mb_mode and vp8_decode_mvs).
void parse_inter_modes(Vp8Decoder* d, MacroBlock* mb, int mb_x, int mb_y) {
  BoolReader& br = d->br;
  const int stride = d->mb_w + 1;
  MbInfo* mi = &d->info[(mb_y + 1) * stride + mb_x + 1];
  const MbInfo& above = mi[-stride];
  const MbInfo& left = mi[-1];
  const MbInfo& above_left = mi[-stride - 1];
  uint8_t& seg = d->seg_map[mb_y * d->mb_w + mb_x];
  if (d->update_map) seg = static_cast<uint8_t>(read_segment(d));
  mb->segment = seg;
  mb->skip = d->use_skip_proba ? br.bit(d->skip_p) : 0;
  int64_t* st = d->stats;
  if (!br.bit(d->prob_intra)) {  // an intra macroblock
    *mi = MbInfo();
    mb->inter = 0;
    const uint8_t* p = d->ymode_p;
    int ymode;
    if (!br.bit(p[0]))
      ymode = B_DC;
    else if (!br.bit(p[1]))
      ymode = br.bit(p[2]) ? B_HE : B_VE;
    else
      ymode = br.bit(p[3]) ? -1 : B_TM;
    mb->is_i4x4 = ymode < 0;
    ++st[kStatIntraMb];
    if (mb->is_i4x4) {
      ++st[kStatIntraBpred];
      mi->mode = MB_BPRED;
      for (int n = 0; n < 16; ++n) {
        int i = kYModesIntra4[br.bit(kBModeProbInter[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(kBModeProbInter[i])];
        mb->imodes[n] = static_cast<uint8_t>(-i);
      }
    } else {
      mb->imodes[0] = static_cast<uint8_t>(ymode);
    }
    p = d->uvmode_p;
    mb->uvmode = !br.bit(p[0]) ? B_DC : (!br.bit(p[1]) ? B_VE : (br.bit(p[2]) ? B_TM : B_HE));
    return;
  }
  mb->inter = 1;
  mb->is_i4x4 = 0;
  mi->ref = static_cast<uint8_t>(!br.bit(d->prob_last) ? REF_LAST
                                                       : (br.bit(d->prob_gf) ? REF_ALTREF
                                                                             : REF_GOLDEN));
  if (mi->ref == REF_GOLDEN) ++st[kStatGoldenMb];
  if (mi->ref == REF_ALTREF) ++st[kStatAltrefMb];
  mi->split = 0;

  // the near vectors of the above, left and above-left macroblocks, their
  // sign inverted where that reference's sign bias differs
  const MbInfo* edge[3] = {&above, &left, &above_left};
  Mv near_mv[4];
  int cnt[4] = {0, 0, 0, 0};
  int idx = 0;
  for (int n = 0; n < 3; ++n) {
    const MbInfo& e = *edge[n];
    if (e.ref == REF_INTRA) continue;
    const int weight = n == 2 ? 1 : 2;
    Mv m = e.mv;
    if (zero_mv(m)) {
      cnt[0] += weight;
      continue;
    }
    if (d->sign_bias[e.ref] != d->sign_bias[mi->ref]) {
      m.x = static_cast<int16_t>(-m.x);
      m.y = static_cast<int16_t>(-m.y);
    }
    if (n == 0 || !same_mv(m, near_mv[idx])) near_mv[++idx] = m;
    cnt[idx] += weight;
  }
  if (!br.bit(kModeContexts[cnt[0]][0])) {
    mi->mode = MB_ZERO;
    mi->mv = Mv();
    ++st[kStatZeroMv];
  } else {
    if (cnt[3] && same_mv(near_mv[1], near_mv[3])) cnt[1] += 1;
    if (cnt[2] > cnt[1]) {
      std::swap(cnt[1], cnt[2]);
      std::swap(near_mv[1], near_mv[2]);
    }
    mi->mode = MB_MV;
    if (!br.bit(kModeContexts[cnt[1]][1])) {
      mi->mv = clamp_mv(*d, near_mv[1], mb_x, mb_y);
      ++st[kStatNearestMv];
    } else if (!br.bit(kModeContexts[cnt[2]][2])) {
      mi->mv = clamp_mv(*d, near_mv[2], mb_x, mb_y);
      ++st[kStatNearMv];
    } else {
      const Mv best = clamp_mv(*d, near_mv[cnt[1] >= cnt[0] ? 1 : 0], mb_x, mb_y);
      const int split_ctx = (left.mode == MB_SPLIT) * 2 + (above.mode == MB_SPLIT) * 2 +
                            (above_left.mode == MB_SPLIT);
      if (br.bit(kModeContexts[split_ctx][3])) {
        mi->mode = MB_SPLIT;
        mb->is_i4x4 = 1;  // no Y2 block
        parse_split(d, mi, left, above, best);
        ++st[kStatSplitMb];
        if (mi->split == SPLIT_4X4) ++st[kStatSplit4x4];
        return;
      }
      mi->mv = read_mv(d, best);
      ++st[kStatNewMv];
    }
  }
  for (int b = 0; b < 16; ++b) mi->bmv[b] = mi->mv;
}

int large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// the tokens of one 4x4 block from coefficient n on; returns the position
// after the last non-zero coefficient (libwebp's GetCoeffs)
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*next)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    const int s = br.bit(0x80) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
  }
  return 16;
}

struct NzContext {
  uint8_t nz = 0;     // bits 0-3 luma columns/rows, 4-5 u, 6-7 v
  uint8_t nz_dc = 0;  // the Y2 block had coefficients
};

// The residuals of one macroblock (libwebp's ParseResiduals); returns
// whether any block, the Y2 block included, had a token other than the end
// of block (libvpx's eobtotal, FFmpeg's nnz_total: without one, the inner
// edges of a macroblock with a Y2 block go unfiltered).  A coded block
// always dequantises to a non-zero coefficient, and a coded Y2 block to
// non-zero DCs, so this is also libwebp's non_zero_y | non_zero_uv.
bool parse_residuals(Vp8Decoder* d, const MacroBlock& mb, NzContext* top, NzContext* left,
                     BoolReader& br, int16_t* coeffs) {
  const Quant& q = d->quant[mb.segment];
  int16_t* dst = coeffs;
  std::memset(dst, 0, 384 * sizeof(int16_t));
  bool coded = false;
  int first;
  const uint8_t (*ac_proba)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top->nz_dc + left->nz_dc;
    const int nz = get_coeffs(br, d->proba[1], ctx, q.y2, 0, dc);
    top->nz_dc = left->nz_dc = nz > 0;
    coded = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_proba = d->proba[0];
  } else {
    first = 0;
    ac_proba = d->proba[3];
  }
  uint8_t tnz = top->nz & 0x0f;
  uint8_t lnz = left->nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      coded |= l;
      tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
      dst += 16;
    }
    tnz >>= 4;
    lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    tnz = top->nz >> (4 + ch);
    lnz = left->nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, d->proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        coded |= l;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
        dst += 16;
      }
      tnz >>= 2;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
    }
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xf0) << ch;
  }
  top->nz = static_cast<uint8_t>(out_t);
  left->nz = static_cast<uint8_t>(out_l);
  return coded;
}

bool block_nonzero(const int16_t* c) {
  for (int i = 0; i < 16; ++i)
    if (c[i]) return true;
  return false;
}

void filter_mb(const Vp8Decoder& d, const FilterInfo& f, int mb_x, int mb_y) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* yd = const_cast<uint8_t*>(d.y.data()) + (mb_y * 16) * d.ystride + mb_x * 16;
  const int ys = d.ystride;
  if (d.filter_type == 1) {
    if (mb_x > 0) simple_edge(yd, 1, ys, 16, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4) simple_edge(yd + k, 1, ys, 16, limit);
    if (mb_y > 0) simple_edge(yd, ys, 1, 16, limit + 4);
    if (f.inner)
      for (int k = 4; k < 16; k += 4) simple_edge(yd + k * ys, ys, 1, 16, limit);
    return;
  }
  const int uvs = d.uvstride;
  uint8_t* ud = const_cast<uint8_t*>(d.u.data()) + (mb_y * 8) * uvs + mb_x * 8;
  uint8_t* vd = const_cast<uint8_t*>(d.v.data()) + (mb_y * 8) * uvs + mb_x * 8;
  const int il = f.ilevel, ht = f.hev;
  if (mb_x > 0) {
    normal_edge(yd, 1, ys, 16, limit + 4, il, ht, true);
    normal_edge(ud, 1, uvs, 8, limit + 4, il, ht, true);
    normal_edge(vd, 1, uvs, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4) normal_edge(yd + k, 1, ys, 16, limit, il, ht, false);
    normal_edge(ud + 4, 1, uvs, 8, limit, il, ht, false);
    normal_edge(vd + 4, 1, uvs, 8, limit, il, ht, false);
  }
  if (mb_y > 0) {
    normal_edge(yd, ys, 1, 16, limit + 4, il, ht, true);
    normal_edge(ud, uvs, 1, 8, limit + 4, il, ht, true);
    normal_edge(vd, uvs, 1, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 4; k < 16; k += 4) normal_edge(yd + k * ys, ys, 1, 16, limit, il, ht, false);
    normal_edge(ud + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    normal_edge(vd + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
  }
}

inline int check_dc_mode(int mode, int mb_x, int mb_y) {
  if (mode != B_DC) return mode;
  if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
  return mb_y == 0 ? DC_NOTOP : B_DC;
}

// A (bw, bh) block of a reference plane (w, h, replicated past its edges)
// at full pixel (x, y) and eighth pixel (fx, fy): the six-tap filters
// (version 0) or the bilinear ones, horizontal pass (rounded, clipped)
// first, into dst (stride BPS).
void predict_block_mc(const uint8_t* src, int w, int h, int x, int y, int fx, int fy, int bw,
                      int bh, bool sixtap, uint8_t* dst) {
  uint8_t win[21 * 21], tmp[21 * 16];
  const int ww = bw + 5, wh = bh + 5;
  bool inside = x >= 2 && y >= 2 && x + bw + 3 <= w && y + bh + 3 <= h;
  for (int j = 0; j < wh; ++j) {
    const uint8_t* row = src + static_cast<size_t>(clip(y - 2 + j, h - 1)) * w;
    if (inside) {
      std::memcpy(win + j * ww, row + x - 2, ww);
    } else {
      for (int i = 0; i < ww; ++i) win[j * ww + i] = row[clip(x - 2 + i, w - 1)];
    }
  }
  if (sixtap) {
    const int* fh = kSixtap[fx];
    for (int j = 0; j < wh; ++j) {
      const uint8_t* p = win + j * ww;
      uint8_t* t = tmp + j * bw;
      if (!fx) {
        std::memcpy(t, p + 2, bw);
        continue;
      }
      for (int i = 0; i < bw; ++i)
        t[i] = clip8((fh[0] * p[i] + fh[1] * p[i + 1] + fh[2] * p[i + 2] + fh[3] * p[i + 3] +
                      fh[4] * p[i + 4] + fh[5] * p[i + 5] + 64) >> 7);
    }
    const int* fv = kSixtap[fy];
    for (int j = 0; j < bh; ++j) {
      const uint8_t* t = tmp + j * bw;
      uint8_t* o = dst + j * BPS;
      if (!fy) {
        std::memcpy(o, t + 2 * bw, bw);
        continue;
      }
      for (int i = 0; i < bw; ++i)
        o[i] = clip8((fv[0] * t[i] + fv[1] * t[i + bw] + fv[2] * t[i + 2 * bw] +
                      fv[3] * t[i + 3 * bw] + fv[4] * t[i + 4 * bw] + fv[5] * t[i + 5 * bw] +
                      64) >> 7);
    }
    return;
  }
  for (int j = 0; j <= bh; ++j) {  // rows y .. y + bh
    const uint8_t* p = win + (j + 2) * ww + 2;
    uint8_t* t = tmp + j * bw;
    for (int i = 0; i < bw; ++i) t[i] = fx ? ((8 - fx) * p[i] + fx * p[i + 1] + 4) >> 3 : p[i];
  }
  for (int j = 0; j < bh; ++j) {
    const uint8_t* t = tmp + j * bw;
    uint8_t* o = dst + j * BPS;
    for (int i = 0; i < bw; ++i) o[i] = fy ? ((8 - fy) * t[i] + fy * t[i + bw] + 4) >> 3 : t[i];
  }
}

// The inter prediction of one macroblock into the work buffers: luma by
// quarter pixel, chroma by eighth pixel (full pixel in version 3), a split
// macroblock's chroma 4x4 blocks from the rounded average of their four
// luma vectors (FFmpeg's inter_predict).
void predict_inter(Vp8Decoder* d, const MbInfo& mi, int mb_x, int mb_y, uint8_t* yw, uint8_t* uw,
                   uint8_t* vw) {
  const Frame& ref = *d->refs[mi.ref];
  const int w = d->mb_w * 16, h = d->mb_h * 16;
  const bool sixtap = d->version == 0;
  bool edge = false;
  auto luma = [&](int bx, int by, int bw, int bh, Mv m) {
    const int x = mb_x * 16 + bx + (m.x >> 2), y = mb_y * 16 + by + (m.y >> 2);
    edge |= x < 0 || y < 0 || x + bw > w || y + bh > h;
    predict_block_mc(ref.y.data(), w, h, x, y, (m.x * 2) & 7, (m.y * 2) & 7, bw, bh, sixtap,
                     yw + by * BPS + bx);
  };
  auto chroma = [&](int bx, int by, int bw, int bh, Mv m) {  // m in eighth chroma pixels
    if (d->version == 3) {
      m.x = static_cast<int16_t>(m.x & ~7);
      m.y = static_cast<int16_t>(m.y & ~7);
    }
    const int x = mb_x * 8 + bx + (m.x >> 3), y = mb_y * 8 + by + (m.y >> 3);
    predict_block_mc(ref.u.data(), w / 2, h / 2, x, y, m.x & 7, m.y & 7, bw, bh, sixtap,
                     uw + by * BPS + bx);
    predict_block_mc(ref.v.data(), w / 2, h / 2, x, y, m.x & 7, m.y & 7, bw, bh, sixtap,
                     vw + by * BPS + bx);
  };
  if (mi.mode != MB_SPLIT) {
    luma(0, 0, 16, 16, mi.mv);
    chroma(0, 0, 8, 8, mi.mv);
  } else if (mi.split == SPLIT_4X4) {
    for (int b = 0; b < 16; ++b) luma((b & 3) * 4, (b >> 2) * 4, 4, 4, mi.bmv[b]);
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x) {
        const int b = 8 * y + 2 * x;
        int sx = mi.bmv[b].x + mi.bmv[b + 1].x + mi.bmv[b + 4].x + mi.bmv[b + 5].x;
        int sy = mi.bmv[b].y + mi.bmv[b + 1].y + mi.bmv[b + 4].y + mi.bmv[b + 5].y;
        Mv m;
        m.x = static_cast<int16_t>((sx + 2 - (sx < 0)) >> 2);
        m.y = static_cast<int16_t>((sy + 2 - (sy < 0)) >> 2);
        chroma(4 * x, 4 * y, 4, 4, m);
      }
  } else {
    const int pw = mi.split == SPLIT_16X8 ? 16 : 8, ph = mi.split == SPLIT_8X16 ? 16 : 8;
    for (int b = 0; b < 16; ++b) {
      const int bx = (b & 3) * 4, by = (b >> 2) * 4;
      if (bx % pw || by % ph) continue;  // the first block of each partition
      luma(bx, by, pw, ph, mi.bmv[b]);
      chroma(bx / 2, by / 2, pw / 2, ph / 2, mi.bmv[b]);
    }
  }
  if (edge) ++d->stats[kStatEdgeMv];
}

// Decode one frame into d->y/u/v: per row, the modes and tokens of each
// macroblock, prediction (intra from the unfiltered neighbours, libwebp's
// ReconstructRow work buffers; inter from the reference frames), then the
// row's loop filter.
int decode_vp8_frame(Vp8Decoder* d) {
  const int mb_w = d->mb_w, mb_h = d->mb_h;
  d->ystride = mb_w * 16;
  d->uvstride = mb_w * 8;
  d->y.assign(static_cast<size_t>(d->ystride) * mb_h * 16, 0);
  d->u.assign(static_cast<size_t>(d->uvstride) * mb_h * 8, 0);
  d->v.assign(static_cast<size_t>(d->uvstride) * mb_h * 8, 0);
  if (d->video && d->info.empty()) {
    d->info.assign(static_cast<size_t>(mb_w + 1) * (mb_h + 1), MbInfo());
    d->seg_map.assign(static_cast<size_t>(mb_w) * mb_h, 0);
  }
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<NzContext> nz_top(mb_w);
  std::vector<uint8_t> ytop(16 * mb_w), utop(8 * mb_w), vtop(8 * mb_w);
  std::vector<MacroBlock> row(mb_w);
  std::vector<FilterInfo> finfo(mb_w);
  // work buffers: row -1 holds the top samples (and 4 top-right ones),
  // column -1 the left samples
  uint8_t ybuf[BPS * 17 + 8], ubuf[BPS * 9 + 8], vbuf[BPS * 9 + 8];
  uint8_t* const yw = ybuf + BPS + 8;
  uint8_t* const uw = ubuf + BPS + 8;
  uint8_t* const vw = vbuf + BPS + 8;
  int16_t coeffs[384];

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& tokens = d->parts[mb_y & (d->num_parts - 1)];
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    NzContext nz_left;
    for (int j = 0; j < 16; ++j) yw[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) uw[j * BPS - 1] = vw[j * BPS - 1] = 129;
    if (mb_y > 0) {
      yw[-1 - BPS] = uw[-1 - BPS] = vw[-1 - BPS] = 129;
    } else {
      std::memset(yw - BPS - 1, 127, 16 + 4 + 1);
      std::memset(uw - BPS - 1, 127, 8 + 1);
      std::memset(vw - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MacroBlock& mb = row[mb_x];
      mb.inter = 0;
      if (!d->key_frame) {
        parse_inter_modes(d, &mb, mb_x, mb_y);
      } else {
        parse_modes(d, &mb, &intra_t[4 * mb_x], intra_l);
        if (d->video) {
          uint8_t& seg = d->seg_map[mb_y * mb_w + mb_x];
          if (d->update_map) seg = mb.segment;
          mb.segment = seg;
          d->info[(mb_y + 1) * (mb_w + 1) + mb_x + 1] = MbInfo();
        }
      }
      if (d->br.eof) return kErrWebpTruncated;
      bool coded = false;
      if (!mb.skip) {
        coded = parse_residuals(d, mb, &nz_top[mb_x], &nz_left, tokens, coeffs);
      } else {
        nz_left.nz = nz_top[mb_x].nz = 0;
        if (!mb.is_i4x4) nz_left.nz_dc = nz_top[mb_x].nz_dc = 0;
        std::memset(coeffs, 0, sizeof(coeffs));
      }
      if (tokens.eof) return kErrWebpTruncated;
      if (d->filter_type > 0) {
        // FFmpeg's filter_level_for_mb: the segment's level, the deltas of
        // the reference and of the mode (B_PRED, ZEROMV, other vectors,
        // SPLITMV); inner edges where the macroblock has no Y2 block or a
        // token was coded
        const MbInfo* mi = mb.inter ? &d->info[(mb_y + 1) * (mb_w + 1) + mb_x + 1] : nullptr;
        const int mode = mi ? mi->mode : (mb.is_i4x4 ? MB_BPRED : MB_I16);
        int lvl = segment_level(*d, mb.segment);
        if (d->use_lf_delta) {
          lvl += d->ref_lf_delta[mi ? mi->ref : REF_INTRA];
          if (mode != MB_I16) lvl += d->mode_lf_delta[mode - 1];
        }
        finfo[mb_x] = filter_info(*d, lvl, mb.is_i4x4 || coded);
      }

      // reconstruct: rotate in the left samples, bring in the top ones
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(yw + j * BPS - 4, yw + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(uw + j * BPS - 4, uw + j * BPS + 4, 4);
          std::memcpy(vw + j * BPS - 4, vw + j * BPS + 4, 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(yw - BPS, &ytop[16 * mb_x], 16);
        std::memcpy(uw - BPS, &utop[8 * mb_x], 8);
        std::memcpy(vw - BPS, &vtop[8 * mb_x], 8);
      }
      if (mb.inter) {
        predict_inter(d, d->info[(mb_y + 1) * (mb_w + 1) + mb_x + 1], mb_x, mb_y, yw, uw, vw);
        for (int n = 0; n < 16; ++n)
          if (block_nonzero(coeffs + 16 * n))
            transform_add(coeffs + 16 * n, yw + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      } else if (mb.is_i4x4) {
        uint8_t* top_right = yw - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            std::memset(top_right, ytop[16 * mb_x + 15], 4);
          else
            std::memcpy(top_right, &ytop[16 * (mb_x + 1)], 4);
        }
        for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = yw + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, mb.imodes[n]);
          if (block_nonzero(coeffs + 16 * n)) transform_add(coeffs + 16 * n, dst);
        }
      } else {
        predict_block(yw, check_dc_mode(mb.imodes[0], mb_x, mb_y), 16);
        for (int n = 0; n < 16; ++n)
          if (block_nonzero(coeffs + 16 * n))
            transform_add(coeffs + 16 * n, yw + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      if (!mb.inter) {
        const int uvmode = check_dc_mode(mb.uvmode, mb_x, mb_y);
        predict_block(uw, uvmode, 8);
        predict_block(vw, uvmode, 8);
      }
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        if (block_nonzero(coeffs + 256 + 16 * n)) transform_add(coeffs + 256 + 16 * n, uw + off);
        if (block_nonzero(coeffs + 320 + 16 * n)) transform_add(coeffs + 320 + 16 * n, vw + off);
      }
      std::memcpy(&ytop[16 * mb_x], yw + 15 * BPS, 16);
      std::memcpy(&utop[8 * mb_x], uw + 7 * BPS, 8);
      std::memcpy(&vtop[8 * mb_x], vw + 7 * BPS, 8);
      for (int j = 0; j < 16; ++j)
        std::memcpy(&d->y[(mb_y * 16 + j) * d->ystride + mb_x * 16], yw + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&d->u[(mb_y * 8 + j) * d->uvstride + mb_x * 8], uw + j * BPS, 8);
        std::memcpy(&d->v[(mb_y * 8 + j) * d->uvstride + mb_x * 8], vw + j * BPS, 8);
      }
    }
    if (d->filter_type > 0)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(*d, finfo[mb_x], mb_x, mb_y);
  }
  return kOk;
}

// One packet of a VP8 stream: decode it, then update the references as
// FFmpeg does (golden and altref from the references before this frame,
// then last) and restore the probabilities of a frame that did not refresh
// them.  d->shown is the decoded frame; d->show tells whether it is shown.
int decode_vp8_packet(Vp8Decoder* d, const uint8_t* data, size_t size) {
  d->video = true;
  int rc = parse_vp8_header(d, data, size);
  if (rc == kOk) rc = decode_vp8_frame(d);
  if (rc == kErrWebpCorrupt) return kErrVp8Corrupt;
  if (rc == kErrWebpTruncated) return kErrVp8Truncated;
  if (rc != kOk) return rc;
  auto cur = std::make_shared<Frame>();
  cur->y.swap(d->y);
  cur->u.swap(d->u);
  cur->v.swap(d->v);
  int64_t* st = d->stats;
  ++st[d->key_frame ? kStatKey : kStatInter];
  if (!d->show) ++st[kStatHidden];
  if (!d->refresh_probs) ++st[kStatNoRefreshProbs];
  if (!d->refresh_last) ++st[kStatNoRefreshLast];
  if (d->use_segment) ++st[kStatSegmentFrames];
  if (d->version) ++st[kStatBilinear];
  if (d->filter_type == 1) ++st[kStatSimpleFilter];
  if (d->filter_type == 0) ++st[kStatNoFilter];
  if (!d->key_frame) {
    bool deltas = false;
    for (int i = 0; i < 4; ++i) deltas |= d->ref_lf_delta[i] != 0 || d->mode_lf_delta[i] != 0;
    if (d->use_lf_delta && deltas && d->filter_type) ++st[kStatLfDeltaFrames];
    if (d->refresh_golden || d->copy_golden) ++st[kStatGoldenUpdates];
    if (d->refresh_alt || d->copy_alt) ++st[kStatAltrefUpdates];
    if (d->sign_bias[REF_GOLDEN] || d->sign_bias[REF_ALTREF]) ++st[kStatSignBias];
  }
  const std::shared_ptr<Frame> old_last = d->refs[REF_LAST], old_golden = d->refs[REF_GOLDEN],
                               old_alt = d->refs[REF_ALTREF];
  if (d->refresh_golden) {
    d->refs[REF_GOLDEN] = cur;
  } else if (d->copy_golden == 1 || d->copy_golden == 2) {  // 3 is reserved: no copy
    d->refs[REF_GOLDEN] = d->copy_golden == 1 ? old_last : old_alt;
    ++st[d->copy_golden == 1 ? kStatGoldenFromLast : kStatGoldenFromAlt];
  }
  if (d->refresh_alt) {
    d->refs[REF_ALTREF] = cur;
  } else if (d->copy_alt == 1 || d->copy_alt == 2) {
    d->refs[REF_ALTREF] = d->copy_alt == 1 ? old_last : old_golden;
    ++st[d->copy_alt == 1 ? kStatAltFromLast : kStatAltFromGolden];
  }
  if (d->refresh_last) d->refs[REF_LAST] = cur;
  if (!d->refresh_probs) {
    std::memcpy(d->proba, d->saved.proba, sizeof(d->proba));
    std::memcpy(d->ymode_p, d->saved.ymode_p, sizeof(d->ymode_p));
    std::memcpy(d->uvmode_p, d->saved.uvmode_p, sizeof(d->uvmode_p));
    std::memcpy(d->mv_p, d->saved.mv_p, sizeof(d->mv_p));
  }
  d->shown = cur;
  return kOk;
}

// ---- YUV 4:2:0 -> BGR: libwebp's fancy upsampler and VP8YuvToBgr --------
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6) : (v < 0 ? 0 : 255));
}
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  const int yy = mult_hi(y, 19077);
  bgr[2] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  bgr[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[0] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// one output row from luma row `ty` and the chroma rows `tu/tv` (the near
// one, weight 3) and `cu/cv` (the far one, weight 1): UpsampleRgbLinePair's
// arithmetic on one of its two lines
void upsample_line(const uint8_t* ty, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                   const uint8_t* fv, uint8_t* dst, int len, int ch) {
  const int last_pair = (len - 1) >> 1;
  int nl_u = nu[0], fl_u = fu[0], nl_v = nv[0], fl_v = fv[0];
  yuv_to_bgr(ty[0], (3 * nl_u + fl_u + 2) >> 2, (3 * nl_v + fl_v + 2) >> 2, dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int nr_u = nu[x], fr_u = fu[x], nr_v = nv[x], fr_v = fv[x];
    // libwebp: avg = tl + t + l + c + 8; diag_12 = (avg + 2 (t + l)) >> 3;
    // diag_03 = (avg + 2 (tl + c)) >> 3, with (tl, t) the top row's left and
    // right samples and (l, c) the bottom row's
    const int avg_u = nl_u + nr_u + fl_u + fr_u + 8;
    const int avg_v = nl_v + nr_v + fl_v + fr_v + 8;
    // for the near row as "top": d12 = (avg + 2 (nr + fl)) >> 3, left pixel
    // (d12 + nl) >> 1, right pixel (d03 + nr) >> 1, d03 = (avg + 2 (nl + fr)) >> 3
    const int d12_u = (avg_u + 2 * (nr_u + fl_u)) >> 3, d03_u = (avg_u + 2 * (nl_u + fr_u)) >> 3;
    const int d12_v = (avg_v + 2 * (nr_v + fl_v)) >> 3, d03_v = (avg_v + 2 * (nl_v + fr_v)) >> 3;
    yuv_to_bgr(ty[2 * x - 1], (d12_u + nl_u) >> 1, (d12_v + nl_v) >> 1, dst + (2 * x - 1) * ch);
    yuv_to_bgr(ty[2 * x], (d03_u + nr_u) >> 1, (d03_v + nr_v) >> 1, dst + (2 * x) * ch);
    nl_u = nr_u;
    fl_u = fr_u;
    nl_v = nr_v;
    fl_v = fr_v;
  }
  if (!(len & 1))
    yuv_to_bgr(ty[len - 1], (3 * nl_u + fl_u + 2) >> 2, (3 * nl_v + fl_v + 2) >> 2,
               dst + (len - 1) * ch);
}

// the cropped frame (h, w) as BGR (ch 3) or BGR plus an opaque alpha (ch 4)
void yuv_to_bgr_image(const Vp8Decoder& d, int h, int w, uint8_t* out, int ch) {
  const int uv_h = (h + 1) / 2;
  for (int y = 0; y < h; ++y) {
    // row 0 mirrors the chroma; row 2k-1 is the top of pair k (near chroma
    // row k-1), row 2k its bottom (near chroma row k)
    int near_r, far_r;
    if (y == 0) {
      near_r = far_r = 0;
    } else if (y & 1) {
      near_r = (y - 1) >> 1;
      far_r = near_r + 1 < uv_h ? near_r + 1 : near_r;
    } else {
      near_r = y >> 1;
      far_r = near_r - 1;
    }
    const uint8_t* nu = &d.u[near_r * d.uvstride];
    const uint8_t* nv = &d.v[near_r * d.uvstride];
    const uint8_t* fu = &d.u[far_r * d.uvstride];
    const uint8_t* fv = &d.v[far_r * d.uvstride];
    uint8_t* dst = out + static_cast<size_t>(y) * w * ch;
    upsample_line(&d.y[y * d.ystride], nu, nv, fu, fv, dst, w, ch);
    if (ch == 4)
      for (int x = 0; x < w; ++x) dst[4 * x + 3] = 255;
  }
}

// ---- VP8L: the lossless bitstream ------------------------------------------
struct LBitReader {
  const uint8_t* p = nullptr;
  size_t n = 0, pos = 0;
  uint64_t val = 0;
  int nbits = 0;
  uint64_t consumed = 0;  // bits read; past 8 n the stream ended early

  void init(const uint8_t* s, size_t len) {
    p = s;
    n = len;
    pos = 0;
    val = 0;
    nbits = 0;
    consumed = 0;
  }
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = pos < n ? p[pos] : 0;
      ++pos;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int k) {
    if (nbits < k) fill();
    return static_cast<uint32_t>(val & ((uint64_t{1} << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    nbits -= k;
    consumed += k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool eos() const { return consumed > 8 * static_cast<uint64_t>(n); }
};

// a canonical prefix code: an 8-bit first-level table, counts beyond it
struct Huffman {
  int single = -1;                  // the one symbol of a zero-bit code
  uint16_t fast[256];               // (length << 12) | symbol, 0 past 8 bits
  uint16_t count[16];
  std::vector<uint16_t> symbols;    // by (length, symbol)

  bool build(const int* lengths, int n) {
    std::memset(count, 0, sizeof(count));
    std::memset(fast, 0, sizeof(fast));
    int used = 0, last = -1;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] < 0 || lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++used;
        last = s;
      }
    }
    if (used == 0) return false;
    if (used == 1) {
      single = last;
      return true;
    }
    single = -1;
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) return false;  // over-subscribed
    }
    if (left != 0) return false;   // incomplete
    uint16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    symbols.assign(used, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbols[offs[lengths[s]]++] = static_cast<uint16_t>(s);
    // first-level table: the canonical code of each symbol, bit-reversed
    int code = 0, k = 0;
    for (int len = 1; len <= 8; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int r = rev; r < 256; r += 1 << len)
          fast[r] = static_cast<uint16_t>((len << 12) | symbols[k]);
      }
      code <<= 1;
    }
    return true;
  }

  int decode(LBitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(15);
    const uint16_t e = fast[bits & 0xff];
    if (e) {
      br.skip(e >> 12);
      return e & 0xfff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int c = count[len];
      if (code - first < c) {
        br.skip(len);
        return symbols[index + code - first];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return -1;
  }
};

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct HuffGroup {
  Huffman h[5];  // green (+ lengths, cache), red, blue, alpha, distance
};

struct VP8LDecoder {
  LBitReader br;
  int status = kOk;
  unsigned transforms_seen = 0;
  struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
  };
  std::vector<Transform> transforms;

  bool fail(int code = kErrWebpCorrupt) {
    if (status == kOk) status = code;
    return false;
  }

  bool read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    Huffman cl;
    if (!cl.build(cl_lengths, 19)) return fail();
    int max_symbol = num_symbols;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(length_nbits));
      if (max_symbol > num_symbols) return fail();
    }
    int prev = 8, symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const int code_len = cl.decode(br);
      if (code_len < 0) return fail();
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len) prev = code_len;
      } else {
        const int slot = code_len - 16;
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int repeat = static_cast<int>(br.read(kExtra[slot])) + kOffset[slot];
        if (symbol + repeat > num_symbols) return fail();
        const int v = code_len == 16 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
      }
    }
    return true;
  }

  bool read_code(int alphabet, Huffman* out) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple: one or two symbols
      const int num = static_cast<int>(br.read(1)) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      int s = static_cast<int>(br.read(first_bits));
      if (s >= alphabet) return fail();
      lengths[s] = 1;
      if (num == 2) {
        s = static_cast<int>(br.read(8));
        if (s >= alphabet) return fail();
        lengths[s] = 1;
      }
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = static_cast<int>(br.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = br.read(3);
      if (!read_code_lengths(cl_lengths, alphabet, lengths.data())) return false;
    }
    if (br.eos()) return fail(kErrWebpTruncated);
    if (!out->build(lengths.data(), alphabet)) return fail();
    return true;
  }

  // one image stream (the spec's "entropy-coded image"); level 0 reads the
  // transforms and may use a meta prefix-code image
  bool decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
    int width = xsize;
    if (level0) {
      while (br.read(1)) {
        if (!read_transform(&width, ysize)) return false;
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = static_cast<int>(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) return fail();
    }
    int huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> meta;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      huff_bits = static_cast<int>(br.read(3)) + 2;
      huff_xsize = (width + (1 << huff_bits) - 1) >> huff_bits;
      const int huff_ysize = (ysize + (1 << huff_bits) - 1) >> huff_bits;
      if (!decode_stream(huff_xsize, huff_ysize, false, &meta)) return false;
      for (auto& m : meta) {
        m = (m >> 8) & 0xffff;
        if (static_cast<int>(m) + 1 > num_groups) num_groups = static_cast<int>(m) + 1;
      }
    }
    if (br.eos()) return fail(kErrWebpTruncated);
    std::vector<HuffGroup> groups(num_groups);
    const int alphabets[5] = {kNumLiteral + kNumLength + (cache_bits ? 1 << cache_bits : 0),
                              kNumLiteral, kNumLiteral, kNumLiteral, kNumDistance};
    for (auto& g : groups)
      for (int j = 0; j < 5; ++j)
        if (!read_code(alphabets[j], &g.h[j])) return false;
    out->assign(static_cast<size_t>(width) * ysize, 0);
    if (!decode_pixels(width, ysize, groups, meta, huff_bits, huff_xsize, cache_bits, out->data()))
      return false;
    if (level0) {  // the inverse transforms, last read first
      for (int i = static_cast<int>(transforms.size()) - 1; i >= 0; --i)
        apply_inverse(transforms[i], out);
    }
    return true;
  }

  bool read_transform(int* xsize, int ysize) {
    const int type = static_cast<int>(br.read(2));
    if (transforms_seen & (1u << type)) return fail();
    transforms_seen |= 1u << type;
    Transform t{type, 0, *xsize, ysize, {}};
    if (type == 0 || type == 1) {  // predictor, cross colour
      t.bits = static_cast<int>(br.read(3)) + 2;
      const int bw = (t.xsize + (1 << t.bits) - 1) >> t.bits;
      const int bh = (ysize + (1 << t.bits) - 1) >> t.bits;
      if (!decode_stream(bw, bh, false, &t.data)) return false;
    } else if (type == 3) {  // colour indexing
      const int num_colors = static_cast<int>(br.read(8)) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = (t.xsize + (1 << t.bits) - 1) >> t.bits;
      std::vector<uint32_t> pal;
      if (!decode_stream(num_colors, 1, false, &pal)) return false;
      const int final_num = 1 << (8 >> t.bits);
      t.data.assign(final_num, 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num_colors; ++i) {  // delta-coded, byte by byte
        uint32_t a = pal[i], b = t.data[i - 1];
        t.data[i] = (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
                    (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
      }
    }
    transforms.push_back(std::move(t));
    return true;
  }

  bool decode_pixels(int width, int height, const std::vector<HuffGroup>& groups,
                     const std::vector<uint32_t>& meta, int huff_bits, int huff_xsize,
                     int cache_bits, uint32_t* data) {
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0, 0);
    const int cache_shift = 32 - cache_bits;
    const size_t total = static_cast<size_t>(width) * height;
    size_t pos = 0, cached = 0;
    auto insert = [&](size_t upto) {
      if (!cache_bits) return;
      for (; cached < upto; ++cached) {
        const uint32_t argb = data[cached];
        cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
      }
    };
    auto group_at = [&](size_t p) -> const HuffGroup& {
      if (meta.empty()) return groups[0];
      const int x = static_cast<int>(p % width), y = static_cast<int>(p / width);
      return groups[meta[(y >> huff_bits) * huff_xsize + (x >> huff_bits)]];
    };
    while (pos < total) {
      const HuffGroup& g = group_at(pos);
      const int code = g.h[0].decode(br);
      if (code < 0) return fail();
      if (code < kNumLiteral) {
        const int red = g.h[1].decode(br), blue = g.h[2].decode(br), alpha = g.h[3].decode(br);
        if (red < 0 || blue < 0 || alpha < 0) return fail();
        data[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
      } else if (code < kNumLiteral + kNumLength) {
        const int length = prefix_value(code - kNumLiteral);
        const int dist_symbol = g.h[4].decode(br);
        if (dist_symbol < 0) return fail();
        const int dist = plane_distance(width, prefix_value(dist_symbol));
        if (br.eos()) return fail(kErrWebpTruncated);
        if (static_cast<size_t>(dist) > pos || total - pos < static_cast<size_t>(length))
          return fail();
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      } else {
        const int key = code - (kNumLiteral + kNumLength);
        if (key >= static_cast<int>(cache.size())) return fail();
        insert(pos);
        data[pos++] = cache[key];
      }
      if (br.eos()) return fail(kErrWebpTruncated);
    }
    return true;
  }

  int prefix_value(int symbol) {  // lengths and distances: prefix + extra bits
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  static int plane_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  static void apply_inverse(const Transform& t, std::vector<uint32_t>* img);
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : (a > 255 ? 255 : a); }
inline uint32_t clamped_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
                  static_cast<int>((c2 >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(v)) << s;
  }
  return out;
}
inline uint32_t clamped_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((ave >> s) & 0xff), b = static_cast<int>((c2 >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ai = (a >> s) & 0xff, bi = (b >> s) & 0xff, ci = (c >> s) & 0xff;
    pa_minus_pb += std::abs(bi - ci) - std::abs(ai - ci);
  }
  return pa_minus_pb <= 0 ? a : b;
}

// the 14 predictors; `top` points at the pixel above, `left` is the one on
// the left (mode 0: opaque black; 14 and 15 as 0, libwebp's sentinels)
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return clamped_add_sub_full(left, top[0], top[-1]);
    case 13: return clamped_add_sub_half(left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

void VP8LDecoder::apply_inverse(const Transform& t, std::vector<uint32_t>* img) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 0) {  // predictor: in place, row by row
    uint32_t* px = img->data();
    px[0] = add_pixels(px[0], 0xff000000u);
    for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
    const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
    for (int y = 1; y < h; ++y) {
      uint32_t* row = px + static_cast<size_t>(y) * w;
      const uint32_t* modes = t.data.data() + (y >> t.bits) * tiles;
      row[0] = add_pixels(row[0], row[-w]);
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add_pixels(row[x], predict(mode, row[x - 1], row + x - w));
      }
    }
  } else if (t.type == 1) {  // cross colour
    const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
    for (int y = 0; y < h; ++y) {
      uint32_t* row = img->data() + static_cast<size_t>(y) * w;
      const uint32_t* codes = t.data.data() + (y >> t.bits) * tiles;
      for (int x = 0; x < w; ++x) {
        const uint32_t cc = codes[x >> t.bits];
        const int8_t g2r = static_cast<int8_t>(cc & 0xff);
        const int8_t g2b = static_cast<int8_t>((cc >> 8) & 0xff);
        const int8_t r2b = static_cast<int8_t>((cc >> 16) & 0xff);
        const uint32_t argb = row[x];
        const int8_t green = static_cast<int8_t>(argb >> 8);
        int new_red = (argb >> 16) & 0xff;
        int new_blue = argb & 0xff;
        new_red += (static_cast<int>(g2r) * green) >> 5;
        new_red &= 0xff;
        new_blue += (static_cast<int>(g2b) * green) >> 5;
        new_blue += (static_cast<int>(r2b) * static_cast<int8_t>(new_red)) >> 5;
        new_blue &= 0xff;
        row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) |
                 static_cast<uint32_t>(new_blue);
      }
    }
  } else if (t.type == 2) {  // subtract green
    for (auto& argb : *img) {
      const uint32_t green = (argb >> 8) & 0xff;
      uint32_t rb = argb & 0x00ff00ffu;
      rb += (green << 16) | green;
      argb = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
    }
  } else {  // colour indexing: unpack the bundled indices to width w
    const int packed_w = (w + (1 << t.bits) - 1) >> t.bits;
    std::vector<uint32_t> out(static_cast<size_t>(w) * h);
    const int bits_per_pixel = 8 >> t.bits;
    const uint32_t mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = img->data() + static_cast<size_t>(y) * packed_w;
      uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = (src[x >> t.bits] >> 8) & 0xff;
        const uint32_t idx = (packed >> ((x & ((1 << t.bits) - 1)) * bits_per_pixel)) & mask;
        dst[x] = idx < t.data.size() ? t.data[idx] : 0;
      }
    }
    img->swap(out);
  }
}

int decode_vp8l(const uint8_t* data, size_t size, int* width, int* height, bool* alpha,
                std::vector<uint32_t>* argb) {
  if (size < 5) return kErrWebpTruncated;
  if (data[0] != 0x2f) return kErrWebpCorrupt;
  VP8LDecoder d;
  d.br.init(data + 1, size - 1);
  *width = static_cast<int>(d.br.read(14)) + 1;
  *height = static_cast<int>(d.br.read(14)) + 1;
  *alpha = d.br.read(1);
  if (d.br.read(3) != 0) return kErrWebpCorrupt;  // version
  if (!argb) return kOk;
  if (!d.decode_stream(*width, *height, true, argb)) return d.status;
  if (d.br.eos()) return kErrWebpTruncated;
  return kOk;
}

// ---- the RIFF container ------------------------------------------------------
struct WebpInfo {
  bool lossless = false;
  bool has_alpha = false;
  bool lossy_alpha = false;  // an ALPH chunk beside a VP8 frame
  int width = 0, height = 0;
  const uint8_t* image = nullptr;
  size_t image_size = 0;
  int64_t exif_offset = -1;
  int64_t exif_size = 0;
};

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

int parse_container(const uint8_t* buf, size_t n, WebpInfo* info) {
  if (n < 12 || std::memcmp(buf, "RIFF", 4) != 0 || std::memcmp(buf + 8, "WEBP", 4) != 0)
    return kErrWebpCorrupt;
  const size_t riff = le32(buf + 4);
  if (riff < 12) return kErrWebpCorrupt;
  if (riff > n - 8) return kErrWebpTruncated;
  const size_t end = 8 + riff;
  size_t pos = 12;
  bool vp8x = false, exif_flag = false;
  int canvas_w = 0, canvas_h = 0;
  while (pos + 8 <= end) {
    const uint8_t* tag = buf + pos;
    const size_t size = le32(buf + pos + 4);
    if (size > end - pos - 8) return kErrWebpTruncated;
    const uint8_t* body = buf + pos + 8;
    if (pos == 12 && std::memcmp(tag, "VP8X", 4) == 0) {
      if (size != 10) return kErrWebpCorrupt;
      vp8x = true;
      if (body[0] & 0x02) return kErrWebpAnimation;
      exif_flag = body[0] & 0x08;
      canvas_w = 1 + (body[4] | (body[5] << 8) | (body[6] << 16));
      canvas_h = 1 + (body[7] | (body[8] << 8) | (body[9] << 16));
    } else if (std::memcmp(tag, "ANIM", 4) == 0 || std::memcmp(tag, "ANMF", 4) == 0) {
      return kErrWebpAnimation;
    } else if (std::memcmp(tag, "ALPH", 4) == 0) {
      if (!info->image) info->lossy_alpha = true;
    } else if (std::memcmp(tag, "EXIF", 4) == 0) {
      // cv2 reads it only where VP8X flags it, as a bare TIFF header
      if (exif_flag && info->exif_offset < 0) {
        info->exif_offset = static_cast<int64_t>(pos + 8);
        info->exif_size = static_cast<int64_t>(size);
      }
    } else if (std::memcmp(tag, "VP8 ", 4) == 0 || std::memcmp(tag, "VP8L", 4) == 0) {
      if (info->image) return kErrWebpCorrupt;
      info->lossless = tag[3] == 'L';
      info->image = body;
      info->image_size = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!info->image) return pos >= end ? kErrWebpCorrupt : kErrWebpTruncated;
  if (info->lossless) {
    bool alpha = false;
    const int rc = decode_vp8l(info->image, info->image_size, &info->width, &info->height,
                               &alpha, nullptr);
    if (rc != kOk) return rc;
    info->has_alpha = alpha;
    info->lossy_alpha = false;
  } else {
    if (info->image_size < 10) return kErrWebpTruncated;
    const uint8_t* d = info->image;
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return kErrWebpCorrupt;
    info->width = (d[6] | (d[7] << 8)) & 0x3fff;
    info->height = (d[8] | (d[9] << 8)) & 0x3fff;
    info->has_alpha = info->lossy_alpha;
  }
  if (vp8x && (canvas_w != info->width || canvas_h != info->height)) return kErrWebpCorrupt;
  if (info->width <= 0 || info->height <= 0) return kErrWebpCorrupt;
  return kOk;
}

// Decode into (h, w, ch) BGR (ch 3) or BGRA (ch 4; an opaque alpha for a
// frame without one); a lossy frame's ALPH plane is not decoded, so ch 4 of
// such a file is refused.
int decode_webp(const uint8_t* buf, size_t n, uint8_t* dst, int h, int w, int ch) {
  WebpInfo info;
  int rc = parse_container(buf, n, &info);
  if (rc != kOk) return rc;
  if (info.height != h || info.width != w) return kErrSize;
  if (ch == 4 && info.lossy_alpha) return kErrWebpAlpha;
  if (info.lossless) {
    std::vector<uint32_t> argb;
    int iw, ih;
    bool alpha;
    rc = decode_vp8l(info.image, info.image_size, &iw, &ih, &alpha, &argb);
    if (rc != kOk) return rc;
    const size_t total = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < total; ++i) {
      const uint32_t p = argb[i];
      uint8_t* o = dst + i * ch;
      o[0] = p & 0xff;
      o[1] = (p >> 8) & 0xff;
      o[2] = (p >> 16) & 0xff;
      if (ch == 4) o[3] = p >> 24;
    }
    return kOk;
  }
  Vp8Decoder d;
  rc = parse_vp8_header(&d, info.image, info.image_size);
  if (rc != kOk) return rc;
  rc = decode_vp8_frame(&d);
  if (rc != kOk) return rc;
  yuv_to_bgr_image(d, h, w, dst, ch);
  return kOk;
}

}  // namespace webp

// ---- Matroska / WebM: the video track's packets ----------------------------
namespace mkv {

constexpr uint32_t kEbml = 0x1A45DFA3, kSegment = 0x18538067, kInfo = 0x1549A966,
                   kTracks = 0x1654AE6B, kCluster = 0x1F43B675, kCues = 0x1C53BB6B,
                   kTags = 0x1254C367, kSeekHead = 0x114D9B74, kChapters = 0x1043A770,
                   kAttachments = 0x1941A469, kTimecodeScale = 0x2AD7B1, kDuration = 0x4489,
                   kTrackEntry = 0xAE, kTrackNumber = 0xD7, kTrackType = 0x83, kCodecId = 0x86,
                   kDefaultDuration = 0x23E383, kVideo = 0xE0, kPixelWidth = 0xB0,
                   kPixelHeight = 0xBA, kColour = 0x55B0, kChromaSitingHorz = 0x55B7,
                   kChromaSitingVert = 0x55B8, kTransferCharacteristics = 0x55BA,
                   kPrimaries = 0x55BB, kContentEncodings = 0x6D80, kTimecode = 0xE7,
                   kSimpleBlock = 0xA3, kBlockGroup = 0xA0, kBlock = 0xA1, kReferenceBlock = 0xFB;
constexpr uint64_t kUnknown = ~0ull;

struct Packet {
  int64_t offset, size, pts;  // pts in nanoseconds
  uint8_t key;
};

struct Stream {
  std::string codec;
  int64_t width = 0, height = 0, default_duration = 0, timecode_scale = 1000000;
  // the Colour element's chroma siting as matroskadec maps it to an
  // AVChromaLocation (0 unspecified, 1 left, 2 center, 3 topleft, 4 top),
  // and its Primaries and TransferCharacteristics (2, unspecified, where
  // it states none)
  int64_t chroma_location = 0, primaries = 2, transfer = 2;
  double duration = -1;  // the Segment's Duration in TimecodeScale units, -1 without one
  uint64_t track = 0;
  std::vector<Packet> packets;
};

struct Parser {
  const uint8_t* b;
  size_t n;
  Stream* s;
  bool have_track = false;

  // an element's ID (1-4 bytes, the length marker kept)
  bool id(size_t& pos, uint32_t& out) const {
    if (pos >= n) return false;
    const uint8_t c = b[pos];
    int len = c & 0x80 ? 1 : c & 0x40 ? 2 : c & 0x20 ? 3 : c & 0x10 ? 4 : 0;
    if (!len || pos + len > n) return false;
    out = 0;
    for (int i = 0; i < len; ++i) out = (out << 8) | b[pos + i];
    pos += len;
    return true;
  }
  // a variable-length integer (1-8 bytes, the marker dropped); all ones is
  // kUnknown where `size` is set
  bool vint(size_t& pos, uint64_t& out, bool size) const {
    if (pos >= n) return false;
    const uint8_t c = b[pos];
    int len = 1;
    while (len <= 8 && !(c & (0x100 >> len))) ++len;
    if (len > 8 || pos + len > n) return false;
    uint64_t v = c & (0xff >> len);
    bool ones = v == (0xffu >> len);
    for (int i = 1; i < len; ++i) {
      v = (v << 8) | b[pos + i];
      ones &= b[pos + i] == 0xff;
    }
    pos += len;
    out = size && ones ? kUnknown : v;
    return true;
  }
  // the next element's ID and its data range [a, e); a range past the end
  // of the data is cut to it, an unknown size ends at `limit`
  bool element(size_t& pos, size_t limit, uint32_t& eid, size_t& a, size_t& e,
               bool& unknown) const {
    uint64_t size;
    if (!id(pos, eid) || !vint(pos, size, true)) return false;
    a = pos;
    unknown = size == kUnknown;
    e = unknown || size > limit - a ? limit : a + size;
    return true;
  }
  uint64_t uint_at(size_t a, size_t e) const {
    uint64_t v = 0;
    for (size_t i = a; i < e && i < a + 8; ++i) v = (v << 8) | b[i];
    return v;
  }
  double float_at(size_t a, size_t e) const {
    if (e - a == 4) {
      uint32_t u = static_cast<uint32_t>(uint_at(a, e));
      float f;
      std::memcpy(&f, &u, 4);
      return f;
    }
    if (e - a == 8) {
      uint64_t u = uint_at(a, e);
      double f;
      std::memcpy(&f, &u, 8);
      return f;
    }
    return 0.0;
  }

  int info(size_t pos, size_t end) {
    uint32_t eid;
    size_t a, e;
    bool unknown;
    while (pos < end && element(pos, end, eid, a, e, unknown)) {
      if (eid == kTimecodeScale) s->timecode_scale = static_cast<int64_t>(uint_at(a, e));
      if (eid == kDuration) s->duration = float_at(a, e);
      pos = e;
    }
    return kOk;
  }

  int tracks(size_t pos, size_t end) {
    uint32_t eid;
    size_t a, e;
    bool unknown;
    while (pos < end && element(pos, end, eid, a, e, unknown)) {
      if (eid == kTrackEntry) {
        uint64_t number = 0, type = 0, dd = 0, w = 0, h = 0, horz = 0, vert = 0, prim = 2,
                 trc = 2;
        bool encoded = false;
        std::string codec;
        size_t p = a, ca, ce;
        uint32_t cid;
        while (p < e && element(p, e, cid, ca, ce, unknown)) {
          if (cid == kTrackNumber) number = uint_at(ca, ce);
          if (cid == kTrackType) type = uint_at(ca, ce);
          if (cid == kCodecId) codec.assign(reinterpret_cast<const char*>(b + ca), ce - ca);
          if (cid == kDefaultDuration) dd = uint_at(ca, ce);
          if (cid == kContentEncodings) encoded = true;
          if (cid == kVideo) {
            size_t q = ca, va, ve;
            uint32_t vid;
            while (q < ce && element(q, ce, vid, va, ve, unknown)) {
              if (vid == kPixelWidth) w = uint_at(va, ve);
              if (vid == kPixelHeight) h = uint_at(va, ve);
              if (vid == kColour) {
                size_t r = va, ka, ke;
                uint32_t kid;
                while (r < ve && element(r, ve, kid, ka, ke, unknown)) {
                  if (kid == kChromaSitingHorz) horz = uint_at(ka, ke);
                  if (kid == kChromaSitingVert) vert = uint_at(ka, ke);
                  if (kid == kPrimaries) prim = uint_at(ka, ke);
                  if (kid == kTransferCharacteristics) trc = uint_at(ka, ke);
                  r = ke;
                }
              }
              q = ve;
            }
          }
          p = ce;
        }
        if (type == 1) {
          if (have_track) return kErrMkvTracks;
          have_track = true;
          while (!codec.empty() && codec.back() == '\0') codec.pop_back();
          s->codec = codec;
          s->track = number;
          s->default_duration = static_cast<int64_t>(dd);
          s->width = static_cast<int64_t>(w);
          s->height = static_cast<int64_t>(h);
          // av_chroma_location_pos_to_enum(((horz - 1) << 7, (vert - 1) << 7):
          // 1 is left or top, 2 half-way; 0 (undetermined) or past 2 leaves
          // the location unspecified
          if (horz >= 1 && horz <= 2 && vert >= 1 && vert <= 2)
            s->chroma_location = vert == 2 ? (horz == 1 ? 1 : 2) : (horz == 1 ? 3 : 4);
          s->primaries = static_cast<int64_t>(std::min<uint64_t>(prim, 255));
          s->transfer = static_cast<int64_t>(std::min<uint64_t>(trc, 255));
          if (encoded) return kErrMkvEncoding;
        }
      }
      pos = e;
    }
    return kOk;
  }

  // one Block or SimpleBlock of the video track (a block of another track
  // is passed over)
  int block(size_t a, size_t e, int64_t cluster_tc, bool simple, bool has_ref) {
    size_t p = a;
    uint64_t track;
    if (!vint(p, track, false) || p + 3 > e) return kErrMkvCorrupt;
    if (!have_track) return kErrMkvCorrupt;
    if (track != s->track) return kOk;
    const int16_t rel = static_cast<int16_t>((b[p] << 8) | b[p + 1]);
    const uint8_t flags = b[p + 2];
    p += 3;
    if (flags & 0x06) return kErrMkvLacing;
    Packet pk;
    pk.offset = static_cast<int64_t>(p);
    pk.size = static_cast<int64_t>(e - p);
    pk.pts = (cluster_tc + rel) * s->timecode_scale;
    pk.key = simple ? (flags & 0x80) != 0 : !has_ref;
    s->packets.push_back(pk);
    return kOk;
  }

  bool top_level(uint32_t eid) const {
    return eid == kCluster || eid == kCues || eid == kTags || eid == kInfo || eid == kTracks ||
           eid == kSeekHead || eid == kChapters || eid == kAttachments;
  }

  // a Cluster from `pos`; with an unknown size it ends before the next
  // top-level element; returns the position after it
  int cluster(size_t& pos, size_t end, bool unknown_size) {
    int64_t tc = 0;
    uint32_t eid;
    size_t a, e;
    bool unknown;
    while (pos < end) {
      size_t peek = pos;
      uint32_t next;
      if (!id(peek, next)) break;
      if (unknown_size && top_level(next)) break;
      if (!element(pos, end, eid, a, e, unknown)) break;
      int rc = kOk;
      if (eid == kTimecode) tc = static_cast<int64_t>(uint_at(a, e));
      if (eid == kSimpleBlock) rc = block(a, e, tc, true, false);
      if (eid == kBlockGroup) {
        size_t p = a, ba = 0, be = 0, ca, ce;
        uint32_t cid;
        bool has_ref = false, have_block = false;
        while (p < e && element(p, e, cid, ca, ce, unknown)) {
          if (cid == kBlock) {
            ba = ca;
            be = ce;
            have_block = true;
          }
          if (cid == kReferenceBlock) has_ref = true;
          p = ce;
        }
        if (have_block) rc = block(ba, be, tc, false, has_ref);
      }
      if (rc != kOk) return rc;
      pos = e;
    }
    return kOk;
  }

  int parse() {
    size_t pos = 0, a, e;
    uint32_t eid;
    bool unknown;
    if (!element(pos, n, eid, a, e, unknown) || eid != kEbml) return kErrMkvNotMatroska;
    pos = e;
    while (true) {  // the Segment, after anything else at the top level
      if (pos >= n || !element(pos, n, eid, a, e, unknown)) return kErrMkvNotMatroska;
      if (eid == kSegment) break;
      pos = e;
    }
    const size_t seg_end = e;
    pos = a;
    while (pos < seg_end) {
      if (!element(pos, seg_end, eid, a, e, unknown)) break;
      int rc = kOk;
      if (eid == kInfo) rc = info(a, e);
      if (eid == kTracks) rc = tracks(a, e);
      if (eid == kCluster) {
        size_t p = a;
        rc = cluster(p, e, unknown);
        e = p;
      }
      if (rc != kOk) return rc;
      pos = e;
    }
    return have_track ? kOk : kErrMkvNoVideo;
  }
};

}  // namespace mkv


}  // namespace

extern "C" {

void* fgpack_open(const char* path) {
  Pack* p = new Pack();
  p->fd = ::open(path, O_RDONLY);
  if (p->fd < 0) {
    delete p;
    return nullptr;
  }
  struct stat st;
  if (fstat(p->fd, &st) != 0 || st.st_size < 16) {
    ::close(p->fd);
    delete p;
    return nullptr;
  }
  p->size = static_cast<size_t>(st.st_size);
  void* mem = mmap(nullptr, p->size, PROT_READ, MAP_SHARED, p->fd, 0);
  if (mem == MAP_FAILED) {
    ::close(p->fd);
    delete p;
    return nullptr;
  }
  p->base = static_cast<const uint8_t*>(mem);
  uint32_t version = 0;
  std::memcpy(&version, p->base + 4, 4);
  std::memcpy(&p->n_records, p->base + 8, 8);
  // refuse other files, unknown versions and files too short for the index
  // (a truncated copy would otherwise fault on the first record read)
  bool ok = std::memcmp(p->base, "FGPK", 4) == 0 && (version == 1 || version == 2) &&
            p->n_records <= (p->size - 16) / sizeof(RecordMeta);
  if (ok) {
    p->index = reinterpret_cast<const RecordMeta*>(p->base + 16);
    for (uint64_t i = 0; i < p->n_records && ok; ++i) {
      const RecordMeta& m = p->index[i];
      ok = m.offset <= p->size && m.nbytes <= p->size - m.offset &&
           !(version == 1 && m.codec != kCodecRaw) &&
           !(m.codec == kCodecRaw &&
             m.nbytes != static_cast<uint64_t>(m.height) * m.width * m.channels);
    }
  }
  if (!ok) {
    munmap(mem, p->size);
    ::close(p->fd);
    delete p;
    return nullptr;
  }
  return p;
}

int64_t fgpack_count(void* handle) {
  return handle ? static_cast<int64_t>(static_cast<Pack*>(handle)->n_records)
                : static_cast<int64_t>(kErrArgs);
}

// Writes {height, width, channels, stored_nbytes, codec} into out[0..4].
int fgpack_record_info(void* handle, int64_t i, int64_t* out) {
  Pack* p = static_cast<Pack*>(handle);
  if (!p || i < 0 || i >= static_cast<int64_t>(p->n_records)) return kErrIndex;
  const RecordMeta& m = p->index[i];
  out[0] = m.height;
  out[1] = m.width;
  out[2] = m.channels;
  out[3] = static_cast<int64_t>(m.nbytes);
  out[4] = m.codec;
  return kOk;
}

// Parallel batch read/decode: record indices[i] lands at dst + i*stride.
// layout 0 = decoded HWC uint8; layout 1 = I420 planes (h*3/2, w).  On
// failure status[0] is the first failing slot, status[1] its status.
int fgpack_read_batch(void* handle, const int64_t* indices, int64_t n, uint8_t* dst,
                      int64_t stride, int n_threads, int layout, int64_t* status) {
  Pack* p = static_cast<Pack*>(handle);
  if (!p || n <= 0 || (layout != kLayoutHWC && layout != kLayoutI420)) return kErrArgs;
  ReadTask task{p, indices, n, dst, stride, layout, 0, PTHREAD_MUTEX_INITIALIZER,
                {PTHREAD_MUTEX_INITIALIZER, -1, kOk}};
  run_pool(read_worker, &task, n_threads);
  report(task.err, status);
  return task.err.code;
}

// {height, width, components, Adobe transform or -1} of a JPEG from its
// markers before the first scan.
int fgpack_jpeg_info(const uint8_t* buf, int64_t nbytes, int64_t* out) {
  if (!buf || nbytes <= 0 || !out) return kErrArgs;
  return jpeg_info(buf, static_cast<size_t>(nbytes), out);
}

// Decode n in-memory JPEG buffers (bufs[i], sizes[i] bytes) of one decoded
// size (h, w) into dst slots: RGB or I420 planes as in fgpack_read_batch,
// grey (kLayoutGrey) or a CMYK file's samples (kLayoutCmyk).
int fgpack_decode_jpeg_batch(const uint8_t* const* bufs, const int64_t* sizes, int64_t n,
                             int64_t h, int64_t w, uint8_t* dst, int64_t stride,
                             int n_threads, int layout, int64_t* status) {
  if (!bufs || n <= 0 || h <= 0 || w <= 0 || layout < kLayoutHWC || layout > kLayoutCmyk)
    return kErrArgs;
  MemTask task{bufs, sizes, n, dst, stride, layout, static_cast<uint32_t>(h),
               static_cast<uint32_t>(w), 0, PTHREAD_MUTEX_INITIALIZER,
               {PTHREAD_MUTEX_INITIALIZER, -1, kOk}};
  run_pool(mem_worker, &task, n_threads);
  report(task.err, status);
  return task.err.code;
}

// Encode an (h, w, 3) RGB frame as baseline JPEG at `quality`, its chroma
// at 4:2:0 (s444 0) or 4:4:4 (s444 1); *out is malloc'ed (release it with
// fgpack_free), *nbytes its length.
int fgpack_encode_jpeg(const uint8_t* rgb, int64_t h, int64_t w, int quality, int s444,
                       uint8_t** out, int64_t* nbytes) {
  if (!rgb || !out || !nbytes) return kErrArgs;
  std::vector<uint8_t> buf;
  const int rc = encode_jpeg_rgb(rgb, static_cast<int>(h), static_cast<int>(w), quality,
                                 s444 != 0, &buf);
  if (rc != kOk) return rc;
  *out = static_cast<uint8_t*>(std::malloc(buf.size()));
  if (!*out) return kErrArgs;
  std::memcpy(*out, buf.data(), buf.size());
  *nbytes = static_cast<int64_t>(buf.size());
  return kOk;
}

void fgpack_free(void* ptr) { std::free(ptr); }

// RGB -> I420 batch conversion (n frames, h x w x 3 each), bit-exact vs
// cv2.COLOR_RGB2YUV_I420.
int fgpack_rgb_to_i420_batch(const uint8_t* rgb, int64_t n, int64_t h, int64_t w,
                             uint8_t* dst) {
  if (!rgb || !dst || n <= 0 || h <= 0 || w <= 0 || ((h | w) & 1)) return kErrArgs;
  const size_t in_stride = static_cast<size_t>(h) * w * 3;
  const size_t out_stride = static_cast<size_t>(h) * w * 3 / 2;
  for (int64_t i = 0; i < n; ++i)
    rgb_to_i420(rgb + i * in_stride, dst + i * out_stride, static_cast<uint32_t>(h),
                static_cast<uint32_t>(w));
  return kOk;
}

// PNG unfiltering: src holds h rows of a filter byte and `rowbytes` bytes;
// dst gets h x rowbytes.  bpp is the filter's byte distance (bytes a pixel,
// at least 1).
int fgpack_png_unfilter(const uint8_t* src, int64_t h, int64_t rowbytes, int bpp,
                        uint8_t* dst) {
  if (!src || !dst || h <= 0 || rowbytes <= 0 || bpp < 1 || bpp > 8) return kErrArgs;
  std::vector<uint8_t> zero(static_cast<size_t>(rowbytes), 0);
  const uint8_t* prev = zero.data();
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* in = src + r * (rowbytes + 1);
    uint8_t* out = dst + r * rowbytes;
    const int f = in[0];
    ++in;
    switch (f) {
      case 0:
        std::memcpy(out, in, static_cast<size_t>(rowbytes));
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) out[i] = static_cast<uint8_t>(in[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev[i];
          const int c = i >= bpp ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return kErrFilter;
    }
    prev = out;
  }
  return kOk;
}

// Hint the kernel to page-in a record range ahead of use.
int fgpack_prefetch(void* handle, int64_t lo, int64_t hi) {
  Pack* p = static_cast<Pack*>(handle);
  if (!p || lo < 0 || hi > static_cast<int64_t>(p->n_records) || lo >= hi) return kErrArgs;
  const uint64_t start = p->index[lo].offset;
  const uint64_t end = p->index[hi - 1].offset + p->index[hi - 1].nbytes;
  const long page = sysconf(_SC_PAGESIZE);
  const uint64_t astart = start & ~static_cast<uint64_t>(page - 1);
  if (end <= astart) return kOk;
  return madvise(const_cast<uint8_t*>(p->base) + astart, end - astart, MADV_WILLNEED);
}

void fgpack_close(void* handle) {
  Pack* p = static_cast<Pack*>(handle);
  if (!p) return;
  if (p->base) munmap(const_cast<uint8_t*>(p->base), p->size);
  if (p->fd >= 0) ::close(p->fd);
  delete p;
}


// {height, width, has_alpha, lossless, exif_offset, exif_size} of a WebP
// file (exif_offset -1 without an EXIF chunk).
int fgpack_webp_info(const uint8_t* buf, int64_t nbytes, int64_t* out) {
  if (!buf || nbytes <= 0 || !out) return kErrArgs;
  webp::WebpInfo info;
  const int rc = webp::parse_container(buf, static_cast<size_t>(nbytes), &info);
  if (rc != kOk) return rc;
  out[0] = info.height;
  out[1] = info.width;
  out[2] = info.has_alpha;
  out[3] = info.lossless;
  out[4] = info.exif_offset;
  out[5] = info.exif_size;
  return kOk;
}

// Decode a WebP file into dst, (h, w, channels) uint8: BGR (channels 3, what
// cv2.imread gives in colour mode, before any EXIF orientation) or BGRA
// (channels 4).
int fgpack_decode_webp(const uint8_t* buf, int64_t nbytes, uint8_t* dst, int64_t h, int64_t w,
                       int channels) {
  if (!buf || nbytes <= 0 || !dst || h <= 0 || w <= 0 || (channels != 3 && channels != 4))
    return kErrArgs;
  return webp::decode_webp(buf, static_cast<size_t>(nbytes), dst, static_cast<int>(h),
                           static_cast<int>(w), channels);
}

// ---- video: a Matroska/WebM file's packets, a VP8 stream's frames -------

// Parse a Matroska/WebM file held in memory (the caller keeps `buf` alive
// while the handle lives); *status gets 0 or the parse status.  A handle is
// returned where the file has one video track, whatever its codec, so that
// the caller can name the codec; release it with fgpack_webm_close.
void* fgpack_webm_open(const uint8_t* buf, int64_t nbytes, int* status) {
  auto* s = new mkv::Stream();
  mkv::Parser p{buf, static_cast<size_t>(nbytes), s};
  *status = p.parse();
  if (!p.have_track) {
    delete s;
    return nullptr;
  }
  return s;
}

// {width, height, packets, DefaultDuration (ns, 0 without one),
// TimecodeScale (ns), the Colour element's chroma location (an
// AVChromaLocation), Primaries, TransferCharacteristics} into out[0..7],
// the Segment's Duration (TimecodeScale units, -1 without one) into
// *duration and the CodecID (NUL-terminated, cut to cap - 1 bytes) into
// codec.
int fgpack_webm_info(void* handle, int64_t* out, double* duration, char* codec, int64_t cap) {
  const auto* s = static_cast<const mkv::Stream*>(handle);
  out[0] = s->width;
  out[1] = s->height;
  out[2] = static_cast<int64_t>(s->packets.size());
  out[3] = s->default_duration;
  out[4] = s->timecode_scale;
  out[5] = s->chroma_location;
  out[6] = s->primaries;
  out[7] = s->transfer;
  *duration = s->duration;
  if (cap > 0) {
    const size_t n = std::min(s->codec.size(), static_cast<size_t>(cap - 1));
    std::memcpy(codec, s->codec.data(), n);
    codec[n] = 0;
  }
  return kOk;
}

// The packets in file order: byte offset and size in the file, timestamp
// (ns) and key flag.
int fgpack_webm_packets(void* handle, int64_t* offsets, int64_t* sizes, int64_t* pts,
                        uint8_t* keys) {
  const auto* s = static_cast<const mkv::Stream*>(handle);
  for (size_t i = 0; i < s->packets.size(); ++i) {
    offsets[i] = s->packets[i].offset;
    sizes[i] = s->packets[i].size;
    pts[i] = s->packets[i].pts;
    keys[i] = s->packets[i].key;
  }
  return kOk;
}

void fgpack_webm_close(void* handle) { delete static_cast<mkv::Stream*>(handle); }

// A VP8 decoder whose state lives across the packets of one stream.
void* fgpack_vp8_new() { return new webp::Vp8Decoder(); }

// The chroma location the container states (an AVChromaLocation), which
// the conversion of an odd-height frame reads.
int fgpack_vp8_siting(void* handle, int siting) {
  if (siting < 0 || siting > 6) return kErrArgs;
  static_cast<webp::Vp8Decoder*>(handle)->siting = siting;
  return kOk;
}

// Decode one packet; out gets {shown, width, height, key frame}.
int fgpack_vp8_decode(void* handle, const uint8_t* data, int64_t nbytes, int64_t* out) {
  auto* d = static_cast<webp::Vp8Decoder*>(handle);
  const int rc = webp::decode_vp8_packet(d, data, static_cast<size_t>(nbytes));
  if (rc != kOk) return rc;
  out[0] = d->show;
  out[1] = d->width;
  out[2] = d->height;
  out[3] = d->key_frame;
  return kOk;
}

// The last decoded frame's planes cut to its size: y (h, w), u and v
// ((h + 1) / 2, (w + 1) / 2).
int fgpack_vp8_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  const auto* d = static_cast<const webp::Vp8Decoder*>(handle);
  if (!d->shown) return kErrArgs;
  const int w = d->width, h = d->height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  const int ys = d->mb_w * 16, uvs = d->mb_w * 8;
  for (int r = 0; r < h; ++r) std::memcpy(y + r * w, &d->shown->y[r * ys], w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + r * cw, &d->shown->u[r * uvs], cw);
    std::memcpy(v + r * cw, &d->shown->v[r * uvs], cw);
  }
  return kOk;
}

// The last decoded frame as (h, w, 3) BGR, as swscale converts it for cv2
// (csrc/swscale.cpp; BT.601, limited range).
int fgpack_vp8_bgr(void* handle, uint8_t* dst) {
  const auto* d = static_cast<const webp::Vp8Decoder*>(handle);
  if (!d->shown) return kErrArgs;
  const int rc = fgpack_yuv_to_bgr24(d->shown->y.data(), d->shown->u.data(), d->shown->v.data(),
                                     d->mb_w * 16, d->mb_w * 8, d->height, d->width, 2, 0, 0,
                                     d->siting, dst);
  return rc < 0 ? rc : kOk;
}

// The stream's feature counts so far (the kStat enum), n of them.
int fgpack_vp8_stats(void* handle, int64_t* out, int64_t n) {
  const auto* d = static_cast<const webp::Vp8Decoder*>(handle);
  for (int64_t i = 0; i < n && i < webp::kVp8Stats; ++i) out[i] = d->stats[i];
  return webp::kVp8Stats;
}

void fgpack_vp8_free(void* handle) { delete static_cast<webp::Vp8Decoder*>(handle); }

}  // extern "C"
