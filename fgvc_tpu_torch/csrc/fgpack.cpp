// fgpack: the port's host library (the JAX package's csrc/fgpack.cpp, with
// its own codecs in place of libjpeg).  C++17, links only pthread.
//
//   * FGPK packs: one flat file of frame records and an index, mmapped, read
//     in batches by a pthread pool (ctypes releases the GIL around a call).
//   * A JPEG decoder whose output equals libjpeg's default decompression
//     to JCS_RGB: baseline and extended (SOF0/SOF1) and progressive (SOF2,
//     jdphuff's four scan kinds into a whole-image coefficient buffer),
//     8-bit, 1 or 3 components, every integral sampling (jdsample's h2v1,
//     h2v2 and h1v2 triangle filters and biases, int_upsample's box for
//     the other ratios), DRI/RSTn, 8- and 16-bit DQT latched at a
//     component's first scan; the islow integer IDCT (jidctint),
//     jdcolor's fixed-point YCbCr -> RGB.  A grey JPEG decodes to three
//     equal channels.  Arithmetic, lossless, hierarchical, 12-bit and
//     4-component files, fractional samplings, and progressive files whose
//     scans leave one of the first ten coefficients incomplete (libjpeg
//     smooths those blocks, jdcoefct's smoothing_ok) are refused with a
//     status code.
//   * A baseline JPEG encoder whose bytes equal libjpeg's defaults (what
//     cv2.imencode and PIL write): JFIF APP0, jcparam's quality scaling of
//     the Annex K tables with force_baseline, jccolor's RGB -> YCbCr, 4:2:0
//     by jcsample's h2v2 average with its alternating bias, the islow
//     forward DCT (jfdctint), rounding quantisation (jcdctmgr), the standard
//     Huffman tables.
//   * PNG unfiltering (filters 0-4); inflate stays with the caller.
//   * RGB -> I420 planes, OpenCV's BT.601 fixed point (cv2.COLOR_RGB2YUV_I420
//     bit for bit).
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

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kCodecRaw = 0;
constexpr uint32_t kCodecJpeg = 1;
constexpr int kLayoutHWC = 0;   // uint8 HWC, as decoded (RGB for JPEG)
constexpr int kLayoutI420 = 1;  // uint8 (h*3/2, w) YUV 4:2:0 planes

enum Status {
  kOk = 0,
  kErrCorrupt = -1,      // a malformed marker, segment or Huffman code
  kErrTruncated = -2,    // the entropy-coded data ends before the last MCU
  kErrIncomplete = -3,   // progressive scans leave coefficients 1-9 incomplete
  kErrArithmetic = -4,   // SOF9-SOF11 / SOF13-SOF15, DAC
  kErrLossless = -5,     // SOF3 / SOF5-SOF7 (lossless, hierarchical)
  kErrPrecision = -6,    // sample precision other than 8 bits
  kErrComponents = -7,   // not 1 or 3 components (CMYK, YCCK)
  kErrSampling = -8,     // a fractional sampling ratio
  kErrSize = -9,         // decoded size differs from the expected one
  kErrIndex = -10,       // record index out of range
  kErrLayout = -11,      // I420 of an odd-sized or non-RGB frame
  kErrCodec = -12,       // unknown record codec
  kErrNoImage = -13,     // no SOF, or no scan
  kErrArgs = -14,        // invalid arguments
  kErrFilter = -15,      // PNG filter type above 4
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

// zigzag position -> natural (row-major) position; 16 extra entries keep a
// corrupt run length inside the block, as jpeg_natural_order does
const uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

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
// JPEG decode

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {};    // bits[l]: the number of codes of length l
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};  // the largest code of length l, -1 if none
  int32_t valoffset[18] = {};
  uint16_t look[512] = {};   // 9-bit lookahead: (length << 8) | symbol; 0 = longer
};

// jpeg_make_d_derived_tbl: canonical codes from the bit counts.
bool derive_huffman(HuffTable* t) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += t->bits[l];
  if (count > 256) return false;
  uint16_t codes[256];
  uint8_t sizes[256];
  int p = 0;
  uint32_t code = 0;
  for (int l = 1; l <= 16; ++l) {
    t->valoffset[l] = p - static_cast<int32_t>(code);
    for (int i = 0; i < t->bits[l]; ++i) {
      sizes[p] = static_cast<uint8_t>(l);
      codes[p++] = static_cast<uint16_t>(code++);
    }
    if (code > (1u << l)) return false;  // more codes than fit in l bits
    t->maxcode[l] = t->bits[l] ? static_cast<int32_t>(code - 1) : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  std::memset(t->look, 0, sizeof(t->look));
  for (int i = 0; i < p; ++i) {
    if (sizes[i] > 9) continue;
    const int shift = 9 - sizes[i];
    const uint32_t base = static_cast<uint32_t>(codes[i]) << shift;
    for (uint32_t j = 0; j < (1u << shift); ++j)
      t->look[base + j] = static_cast<uint16_t>((sizes[i] << 8) | t->vals[i]);
  }
  t->present = true;
  return true;
}

// Entropy-coded bits, MSB first.  At a marker (or the end of the data) the
// reader feeds zero bits and counts them, as libjpeg's fill_bit_buffer
// does; the scan fails as truncated where it consumed any of those.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // left-aligned
  int n = 0;
  int fake = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t c = 0;
      if (!at_marker && p < end) {
        c = *p++;
        if (c == 0xFF) {
          const uint8_t* q = p;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0) {
            p = q + 1;  // a stuffed 0xFF data byte
          } else {
            at_marker = true;
            p = p - 1;  // leave the marker for the parser
            c = 0;
            fake += 8;
          }
        }
      } else {
        fake += 8;
      }
      buf |= static_cast<uint64_t>(c) << (56 - n);
      n += 8;
    }
  }
  inline uint32_t peek(int k) const { return static_cast<uint32_t>(buf >> (64 - k)); }
  inline void skip(int k) {
    buf <<= k;
    n -= k;
  }
  inline int32_t get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    const uint32_t v = peek(k);
    skip(k);
    return static_cast<int32_t>(v);
  }
  bool overrun() const { return fake > n; }
  void reset() {
    buf = 0;
    n = 0;
    fake = 0;
    at_marker = false;
  }
};

inline int decode_symbol(BitReader* b, const HuffTable& t) {
  if (b->n < 16) b->fill();
  const uint16_t e = t.look[b->peek(9)];
  if (e) {
    b->skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 10; l <= 16; ++l) {
    const int32_t code = static_cast<int32_t>(b->peek(l));
    if (code <= t.maxcode[l]) {
      b->skip(l);
      return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
  }
  return -1;
}

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

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
  Component comp[3];
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
    if (ncomp != 1 && ncomp != 3) return kErrComponents;
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

  // After a progressive file's last scan: refuse where libjpeg would smooth
  // blocks (jdcoefct's smoothing_ok: every component's DC known and one of
  // zigzag coefficients 1-9 incomplete somewhere), else dequantize and
  // IDCT every block of each component's own grid.
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
    if (smooth && useful) return kErrIncomplete;
    int32_t deq[64];
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
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

  // RGB rows into dst (h * w * 3), jdcolor's ycc_rgb_convert tables.
  void emit_rgb(uint8_t* dst) const {
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
    std::vector<uint8_t> rows(3 * rs);
    uint8_t* r0 = rows.data();
    uint8_t* r1 = r0 + rs;
    uint8_t* r2 = r1 + rs;
    const bool rgb = is_rgb();
    for (int y = 0; y < height; ++y) {
      uint8_t* o = dst + static_cast<size_t>(y) * width * 3;
      upsample_row(comp[0], y, r0);
      if (ncomp == 1) {
        for (int x = 0; x < width; ++x, o += 3) o[0] = o[1] = o[2] = r0[x];
        continue;
      }
      upsample_row(comp[1], y, r1);
      upsample_row(comp[2], y, r2);
      if (rgb) {
        for (int x = 0; x < width; ++x, o += 3) {
          o[0] = r0[x];
          o[1] = r1[x];
          o[2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x, o += 3) {
        const int yy = r0[x], cb = r1[x], cr = r2[x];
        o[0] = clamp_u8(yy + cr_r[cr]);
        o[1] = clamp_u8(yy + ((cb_g[cb] + cr_g[cr]) >> kScale));
        o[2] = clamp_u8(yy + cb_b[cb]);
      }
    }
  }
};

// Frame size and component count from the markers up to SOF.
int jpeg_info(const uint8_t* src, size_t nbytes, int64_t* out) {
  if (nbytes < 4 || src[0] != 0xFF || src[1] != 0xD8) return kErrCorrupt;
  JpegDecoder d(src, nbytes);
  d.pos = 2;
  for (;;) {
    const int m = d.next_marker();
    if (m < 0 || m == 0xD9 || m == 0xDA) return kErrNoImage;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    int len = 0;
    if (!d.read_u16(d.pos, &len) || len < 2 || d.pos + len > nbytes) return kErrTruncated;
    const size_t seg = d.pos + 2;
    if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF)
      return kErrArithmetic;
    if (m == 0xC3 || m == 0xC5 || m == 0xC6 || m == 0xC7) return kErrLossless;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (len < 8) return kErrCorrupt;
      if (src[seg] != 8) return kErrPrecision;
      out[0] = (src[seg + 1] << 8) | src[seg + 2];
      out[1] = (src[seg + 3] << 8) | src[seg + 4];
      out[2] = src[seg + 5];
      return kOk;
    }
    d.pos = seg + len - 2;
  }
}

// Decode src into dst (h * w * 3 RGB); kErrSize where the frame is not h x w.
int decode_jpeg_rgb(const uint8_t* src, size_t nbytes, uint8_t* dst, uint32_t h,
                    uint32_t w) {
  JpegDecoder d(src, nbytes);
  const int rc = d.parse();
  if (rc != kOk) return rc;
  if (static_cast<uint32_t>(d.width) != w || static_cast<uint32_t>(d.height) != h)
    return kErrSize;
  d.emit_rgb(dst);
  return kOk;
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

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

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

int encode_jpeg_rgb(const uint8_t* rgb, int h, int w, int quality, std::vector<uint8_t>* out) {
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
  const int mcus_x = (w + 15) / 16, mcus_y = (h + 15) / 16;
  const int wb_y = (w + 7) / 8, hb_y = (h + 7) / 8;
  // Y at (hb_y * 8) x (wb_y * 8), and the full-resolution chroma at
  // (rows to an even count) x (mcus_x * 16), edges replicated
  const int yw = wb_y * 8, yh = hb_y * 8;
  const int cw2 = mcus_x * 16, ch2 = (h + 1) / 2 * 2;
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
  // jcsample's h2v2_downsample (bias 1, 2, 1, 2, ... along each row), then
  // the last row repeated to whole MCU rows
  const int cw = mcus_x * 8, chh = mcus_y * 8, cds_h = ch2 / 2;
  std::vector<uint8_t> cb(static_cast<size_t>(cw) * chh), cr(cb.size());
  for (int t = 0; t < 2; ++t) {
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
  const uint8_t sof_comps[] = {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
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
      // jccoefct's compress_data: dummy blocks past the image's blocks take
      // zero AC and the DC of the block before them in the MCU
      for (int yy = 0; yy < 2; ++yy) {
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
      for (int k = 0; k < 4; ++k) encode_block(&bw, blk[k], &last_dc[0], dc_l, ac_l);
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
    if (m.channels != 3) return kErrLayout;
    uint8_t* rgb = (layout == kLayoutHWC) ? slot : scratch;
    const int rc = decode_jpeg_rgb(blob, m.nbytes, rgb, m.height, m.width);
    if (rc != kOk) return rc;
    if (layout == kLayoutI420) rgb_to_i420(rgb, slot, m.height, m.width);
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
    const RecordMeta m{0, static_cast<uint64_t>(t->sizes[i]), t->h, t->w, 3, kCodecJpeg};
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

// {height, width, components} of a JPEG from its SOF marker.
int fgpack_jpeg_info(const uint8_t* buf, int64_t nbytes, int64_t* out) {
  if (!buf || nbytes <= 0 || !out) return kErrArgs;
  return jpeg_info(buf, static_cast<size_t>(nbytes), out);
}

// Decode n in-memory JPEG buffers (bufs[i], sizes[i] bytes) of one decoded
// size (h, w) into dst slots, RGB or I420 planes as in fgpack_read_batch.
int fgpack_decode_jpeg_batch(const uint8_t* const* bufs, const int64_t* sizes, int64_t n,
                             int64_t h, int64_t w, uint8_t* dst, int64_t stride,
                             int n_threads, int layout, int64_t* status) {
  if (!bufs || n <= 0 || h <= 0 || w <= 0 || (layout != kLayoutHWC && layout != kLayoutI420))
    return kErrArgs;
  MemTask task{bufs, sizes, n, dst, stride, layout, static_cast<uint32_t>(h),
               static_cast<uint32_t>(w), 0, PTHREAD_MUTEX_INITIALIZER,
               {PTHREAD_MUTEX_INITIALIZER, -1, kOk}};
  run_pool(mem_worker, &task, n_threads);
  report(task.err, status);
  return task.err.code;
}

// Encode an (h, w, 3) RGB frame as baseline JPEG at `quality`; *out is
// malloc'ed (release it with fgpack_free), *nbytes its length.
int fgpack_encode_jpeg(const uint8_t* rgb, int64_t h, int64_t w, int quality, uint8_t** out,
                       int64_t* nbytes) {
  if (!rgb || !out || !nbytes) return kErrArgs;
  std::vector<uint8_t> buf;
  const int rc = encode_jpeg_rgb(rgb, static_cast<int>(h), static_cast<int>(w), quality, &buf);
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

}  // extern "C"
