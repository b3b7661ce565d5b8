// jpeg_huffman.h: what the port's two JPEG decoders share (fgpack.cpp's,
// whose pixels are libjpeg's, and mjpeg.cpp's, whose pixels are FFmpeg's
// mjpeg decoder's): the zigzag order, Huffman tables derived from their
// bit counts (jpeg_make_d_derived_tbl), the entropy-coded bit reader with
// its marker handling, symbol decoding, and the standard Annex K tables
// (the encoder writes them; FFmpeg decodes frames without DHT by them).
#pragma once

#include <cstdint>
#include <cstring>

namespace fgjpeg {

// zigzag position -> natural (row-major) position; 16 extra entries keep a
// corrupt run length inside the block, as jpeg_natural_order does
inline const uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {};    // bits[l]: the number of codes of length l
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};  // the largest code of length l, -1 if none
  int32_t valoffset[18] = {};
  uint16_t look[512] = {};   // 9-bit lookahead: (length << 8) | symbol; 0 = longer
};

// jpeg_make_d_derived_tbl: canonical codes from the bit counts.
inline bool derive_huffman(HuffTable* t) {
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

// the standard Huffman tables (ITU-T T.81 Annex K.3)
inline const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
inline const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
inline const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
inline const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
inline const uint8_t kAcLumaVals[162] = {
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
inline const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
inline const uint8_t kAcChromaVals[162] = {
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

}  // namespace fgjpeg
