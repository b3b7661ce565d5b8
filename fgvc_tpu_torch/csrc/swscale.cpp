// swscale: YUV -> BGR24 for the port's host library (compiled with
// csrc/fgpack.cpp into one library), as FFmpeg's libswscale converts a
// decoded frame for cv2.VideoCapture.read: sws_getContext at the frame's
// own size with SWS_BICUBIC, BGR24 out, on x86-64.  C++17.
//
// fgpack_yuv_to_bgr24 takes 4:2:0, 4:2:2 or 4:4:4 planes, a row of
// ff_yuv2rgb_coeffs (BT.601, BT.709, SMPTE-240M, BT.2020), the range and
// the chroma siting (an AVChromaLocation), and takes the path swscale
// takes:
//
// * unscaled (swscale_unscaled.c's yuv2rgb): 4:2:0 and 4:2:2 at an even
//   height, in its x86 SIMD form (yuv_2_rgb.asm): luma and chroma times 8
//   and offset, 13-bit coefficients keeping the high 16 bits of each
//   product (pmulhw), sums saturated to 0..255; each chroma sample serves
//   two pixels of a row.
// * scaling (the generic scaler at scale 1): every other frame, that is
//   4:4:4, and 4:2:0 or 4:2:2 at an odd height.
//   - Samples go to 15 bits through the horizontal filters and rows through
//     the vertical ones: initFilter's bicubic (B = 0, C = 0.6) between the
//     sample positions (the siting's), 14-bit horizontal and 12-bit vertical
//     coefficients, cut, folded at the borders and normalised as initFilter
//     does.  At scale 1 the luma filters, and a chroma filter between equal
//     sizes and positions, are the identity: only 4:2:0's chroma rows
//     ((h + 1) / 2 -> h) and the subsampled chroma's columns at an odd
//     width ((w + 1) / 2 -> w) or sited left are filtered.
//   - An odd width, or chroma that is not subsampled, forces full
//     horizontal chroma (yuv2rgb_full_*: 30-bit sums clipped, the top 8
//     bits); else each chroma sample serves two pixels.
//   - A row whose chroma filter has one tap, or two that sum to 4096, goes
//     through yuv2packed1 (two taps blend by the second's weight), any other
//     through yuv2packedX.  Every row of half-width chroma but the last two
//     takes the MMXEXT forms (swscale_template.c: the vertical filter by
//     pmulhw from a rounder of 4, then the unscaled path's arithmetic;
//     yuv2packed1 keeps the first row alone under a weight of 2048 and
//     averages the two above it); the last two rows and every full-chroma
//     row take the C forms (output.c: sums rounded at 19 or 10 bits, and
//     half-width chroma through ff_yuv2rgb_c_init_tables' lookup tables).
//
// None of this is normative: it was read from cv2's frames and is held,
// frame for frame, to cv2.VideoCapture and, plane for plane, to the
// libswscale that cv2 ships (tests/test_torch_port_video_odd_height.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <mutex>
#include <vector>

namespace {

constexpr int kErrArgs = -14;  // enum Status of fgpack.cpp
enum Chroma { k444 = 0, k422 = 1, k420 = 2 };  // log2 of the chroma's subsampling
enum Path { kUnscaled = 0, kScaled = 1, kFullChroma = 2 };

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int mulhi16(int a, int b) { return (a * b) >> 16; }  // pmulhw

// ff_yuv2rgb_coeffs rows {crv, cbu, cgu, cgv} (without their signs)
constexpr int64_t kRows[4][4] = {{104597, 132201, 25675, 53279},   // BT.601
                                 {117489, 138438, 13975, 34925},   // BT.709
                                 {117579, 136230, 16907, 35559},   // SMPTE-240M
                                 {110013, 140363, 12277, 42626}};  // BT.2020

constexpr int kHeadroom = 512;  // YUVRGB_TABLE_HEADROOM and _LUMA_HEADROOM
constexpr int kTable = 256 + 2 * kHeadroom;

// One colour space and range, as sws_setColorspaceDetails and
// ff_yuv2rgb_c_init_tables (bpp 24) set it up.
struct Coeffs {
  // roundToInt16(x << 13) of the luma gain and the chroma terms, and the
  // luma offset 16 << 3 (0 in full range): the x86 forms' pmulhw operands
  // and yuv2rgb_full_*'s coefficients
  int y, vr, ub, ug, vg, yoff;
  uint8_t ytab[1024 + 2 * kHeadroom];   // the C forms' clipped luma ramp
  int rv[kTable], gu[kTable], bu[kTable], gv[kTable];  // offsets into it by V or U
};

void init_coeffs(int matrix, bool full, Coeffs* k) {
  const int64_t* t = kRows[matrix];
  int64_t crv = t[0], cbu = t[1], cgu = -t[2], cgv = -t[3];
  int64_t cy = 1 << 16, oy = 0;
  if (full) {
    crv = crv * 224 / 255;  // truncated toward 0, as in C
    cbu = cbu * 224 / 255;
    cgu = cgu * 224 / 255;
    cgv = cgv * 224 / 255;
  } else {
    cy = cy * 255 / 219;
    oy = 16 << 16;
  }
  auto round16 = [](int64_t x) { return static_cast<int>((x + 0x8000) >> 16); };
  k->y = round16(cy << 13);
  k->vr = round16(crv << 13);
  k->ub = round16(cbu << 13);
  k->ug = round16(cgu * (1 << 13));
  k->vg = round16(cgv * (1 << 13));
  k->yoff = round16(oy << 3);
  // the C tables: chroma terms scaled by 1 / cy, a luma ramp with headroom
  crv = ((crv << 16) + 0x8000) / cy;
  cbu = ((cbu << 16) + 0x8000) / cy;
  cgu = (cgu * (1 << 16) + 0x8000) / cy;
  cgv = (cgv * (1 << 16) + 0x8000) / cy;
  const int yoffs = (full ? 384 : 326) + kHeadroom;
  int64_t yb = -(int64_t{384} << 16) - kHeadroom * cy - oy;
  for (int i = 0; i < 1024 + 2 * kHeadroom; ++i, yb += cy)
    k->ytab[i] = clip8(static_cast<int>((yb + 0x8000) >> 16));
  for (int i = 0; i < kTable; ++i) {
    const int64_t c = clip8(i - kHeadroom);
    k->rv[i] = static_cast<int>(yoffs - (crv >> 9) + ((c * crv) >> 16));
    k->gu[i] = static_cast<int>(yoffs - (cgu >> 9) + ((c * cgu) >> 16));
    k->bu[i] = static_cast<int>(yoffs - (cbu >> 9) + ((c * cbu) >> 16));
    k->gv[i] = static_cast<int>(-(cgv >> 9) + ((c * cgv) >> 16));
  }
}

const Coeffs& coeffs(int matrix, bool full) {
  static Coeffs table[8];
  static std::once_flag once;
  std::call_once(once, [] {
    for (int i = 0; i < 8; ++i) init_coeffs(i >> 1, i & 1, &table[i]);
  });
  return table[matrix * 2 + full];
}

// A scaler's filter: dst taps from src samples, size taps a destination
// sample from pos[i], coefficients summing to `one`.
struct Filter {
  int size = 1;
  std::vector<int> pos;
  std::vector<int> coef;
};

// initFilter (utils.c) for SWS_BICUBIC at the default parameters, between
// src <= dst samples (scale 1 or up) whose first samples sit at src_pos and
// dst_pos (get_local_pos: in 1/256 of a sample, 128 its centre).
Filter init_filter(int src, int dst, int align, int one, int src_pos, int dst_pos) {
  Filter f;
  const int64_t xinc = ((int64_t{src} << 16) + (dst >> 1)) / dst;
  const int64_t fone = int64_t{1} << 54;  // upscaling: av_log2(src / dst) is 0
  std::vector<int64_t> taps;
  int size;
  f.pos.resize(dst);
  if (std::llabs(xinc - 0x10000) < 10 && src_pos == dst_pos) {  // unscaled
    size = 1;
    taps.assign(dst, fone);
    for (int i = 0; i < dst; ++i) f.pos[i] = i;
  } else {
    size = std::max(std::min(1 + 4, src - 2), 1);  // bicubic's size factor 4
    taps.assign(static_cast<size_t>(dst) * size, 0);
    const int64_t B = 0, C = static_cast<int64_t>(0.6 * (1 << 24));
    int64_t x_dst_in_src = ((dst_pos * xinc) >> 7) - ((src_pos * int64_t{0x10000}) >> 7);
    for (int i = 0; i < dst; ++i, x_dst_in_src += 2 * xinc) {
      int xx = static_cast<int>((x_dst_in_src - (size - 2) * (int64_t{1} << 16)) / (1 << 17));
      f.pos[i] = xx;
      for (int j = 0; j < size; ++j, ++xx) {
        const int64_t d = std::llabs(int64_t{xx} * (1 << 17) - x_dst_in_src) << 13;
        int64_t coeff = 0;
        if (d < int64_t{1} << 31) {
          const int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
          if (d < int64_t{1} << 30)
            coeff = (12 * (1 << 24) - 9 * B - 6 * C) * ddd +
                    (-18 * (1 << 24) + 12 * B + 6 * C) * dd + (6 * (1 << 24) - 2 * B) * (1 << 30);
          else
            coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd + (-12 * B - 48 * C) * d +
                    (8 * B + 24 * C) * (1 << 30);
        }
        taps[static_cast<size_t>(i) * size + j] = coeff;  // / ((1 << 54) / fone) = 1
      }
    }
  }
  // cut near-zero taps from the left (keeping pos monotonic) and count them
  // on the right (SWS_MAX_REDUCE_CUTOFF)
  int min_size = 0;
  for (int i = dst - 1; i >= 0; --i) {
    int64_t* t = &taps[static_cast<size_t>(i) * size];
    int keep = size;
    int64_t cut = 0;
    for (int j = 0; j < size; ++j) {
      cut += std::llabs(t[0]);
      if (cut > 0.002 * fone) break;
      if (i < dst - 1 && f.pos[i] >= f.pos[i + 1]) break;
      for (int k = 1; k < size; ++k) t[k - 1] = t[k];
      t[size - 1] = 0;
      ++f.pos[i];
    }
    cut = 0;
    for (int j = size - 1; j > 0; --j) {
      cut += std::llabs(t[j]);
      if (cut > 0.002 * fone) break;
      --keep;
    }
    min_size = std::max(min_size, keep);
  }
  if (min_size == 1 && align == 2) align = 1;  // x86: unscaled vertical filtering
  f.size = (min_size + align - 1) & ~(align - 1);
  std::vector<int64_t> out(static_cast<size_t>(dst) * f.size, 0);
  for (int i = 0; i < dst; ++i)
    for (int j = 0; j < std::min(f.size, size); ++j)
      out[static_cast<size_t>(i) * f.size + j] = taps[static_cast<size_t>(i) * size + j];
  // fold taps outside the source into its first and last samples
  for (int i = 0; i < dst; ++i) {
    int64_t* t = &out[static_cast<size_t>(i) * f.size];
    if (f.pos[i] < 0) {
      for (int j = 1; j < f.size; ++j) {
        const int left = std::max(j + f.pos[i], 0);
        t[left] += t[j];
        t[j] = 0;
      }
      f.pos[i] = 0;
    }
    if (f.pos[i] + f.size > src) {
      const int shift = f.pos[i] + std::min(f.size - src, 0);
      int64_t acc = 0;
      for (int j = f.size - 1; j >= 0; --j)
        if (f.pos[i] + j >= src) {
          acc += t[j];
          t[j] = 0;
        }
      for (int j = f.size - 1; j >= 0; --j) t[j] = j < shift ? 0 : t[j - shift];
      f.pos[i] -= shift;
      t[src - 1 - f.pos[i]] += acc;
    }
  }
  // normalise to `one`, carrying each tap's rounding error to the next
  f.coef.resize(out.size());
  for (int i = 0; i < dst; ++i) {
    const int64_t* t = &out[static_cast<size_t>(i) * f.size];
    int64_t sum = 0, error = 0;
    for (int j = 0; j < f.size; ++j) sum += t[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < f.size; ++j) {
      const int64_t v = t[j] + error;
      const int64_t q = (v >= 0 ? v + (sum >> 1) : v - (sum >> 1)) / sum;  // ROUNDED_DIV
      f.coef[static_cast<size_t>(i) * f.size + j] = static_cast<int>(q);
      error = v - q * sum;
    }
  }
  return f;
}

void unscaled(const uint8_t* y, const uint8_t* u, const uint8_t* v, int64_t ystride,
              int64_t cstride, int64_t h, int64_t w, int vs, const Coeffs& k, uint8_t* dst) {
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* py = y + r * ystride;
    const uint8_t* pu = u + (r >> vs) * cstride;
    const uint8_t* pv = v + (r >> vs) * cstride;
    uint8_t* o = dst + r * w * 3;
    for (int64_t x = 0; x < w; ++x, o += 3) {
      const int cu = pu[x >> 1] * 8 - 1024, cv = pv[x >> 1] * 8 - 1024;
      const int yy = mulhi16(py[x] * 8 - k.yoff, k.y);
      o[0] = clip8(yy + mulhi16(cu, k.ub));
      o[1] = clip8(yy + mulhi16(cu, k.ug) + mulhi16(cv, k.vg));
      o[2] = clip8(yy + mulhi16(cv, k.vr));
    }
  }
}

// yuv2rgb_write_full: Y, U and V at 2^9 a level (U, V centred on 0)
inline void write_full(const Coeffs& k, int yv, int uv, int vv, uint8_t* o) {
  const uint32_t yy = static_cast<uint32_t>((yv - (k.yoff << 6)) * k.y + (1 << 21));
  const uint32_t rgb[3] = {yy + static_cast<uint32_t>(uv) * static_cast<uint32_t>(k.ub),
                           yy + static_cast<uint32_t>(vv) * static_cast<uint32_t>(k.vg) +
                               static_cast<uint32_t>(uv) * static_cast<uint32_t>(k.ug),
                           yy + static_cast<uint32_t>(vv) * static_cast<uint32_t>(k.vr)};
  for (int c = 0; c < 3; ++c) {
    const int32_t s = static_cast<int32_t>(rgb[c]);
    o[c] = static_cast<uint8_t>((s < 0 ? 0 : s > 0x3FFFFFFF ? 0x3FFFFFFF : s) >> 22);
  }
}

// AVChromaLocation's {xpos, ypos} (av_chroma_location_enum_to_pos), 0 to 6:
// unspecified (swscale's default, centred), left, center, topleft, top,
// bottomleft, bottom; in 1/256 of a luma sample
constexpr int kSiting[7][2] = {{128, 128}, {0, 128}, {128, 128}, {0, 0},
                               {128, 0},   {0, 256}, {128, 256}};

int scaled(const uint8_t* y, const uint8_t* u, const uint8_t* v, int64_t ystride,
           int64_t cstride, int h, int w, int chroma, int siting, const Coeffs& k,
           uint8_t* dst) {
  const int hs = chroma == k444 ? 0 : 1, vs = chroma == k420 ? 1 : 0;
  const bool full = (w & 1) || chroma == k444;
  const int cw = (w + hs) >> hs, ch = (h + vs) >> vs;  // the source chroma
  const int dw = full ? w : (w + 1) >> 1;             // chroma samples a row out
  // horizontal: chroma to 15 bits at the output's chroma width (x86 aligns
  // the taps to 4).  A sample sits at get_local_pos, (pos + 128) >> sub: 128
  // for centred chroma and the output's, 64 for subsampled chroma co-sited
  // left (src_h_chr_pos 0) or top, 192 bottom; the siting moves only a
  // subsampled axis
  const int src_pos = hs ? (kSiting[siting][0] + 128) >> 1 : 128;
  const int src_vpos = vs ? (kSiting[siting][1] + 128) >> 1 : 128;
  const bool identity = cw == dw && src_pos == 128;
  const Filter fh = init_filter(cw, dw, 4, 1 << 14, src_pos, 128);
  std::vector<int> u15(static_cast<size_t>(ch) * dw), v15(u15.size());
  for (int r = 0; r < ch; ++r) {
    const uint8_t* pu = u + r * cstride;
    const uint8_t* pv = v + r * cstride;
    for (int x = 0; x < dw; ++x) {
      if (identity) {
        u15[static_cast<size_t>(r) * dw + x] = pu[x] << 7;
        v15[static_cast<size_t>(r) * dw + x] = pv[x] << 7;
        continue;
      }
      int su = 0, sv = 0;
      for (int j = 0; j < fh.size; ++j) {
        const int at = std::min(fh.pos[x] + j, cw - 1), c = fh.coef[x * fh.size + j];
        su += pu[at] * c;
        sv += pv[at] * c;
      }
      u15[static_cast<size_t>(r) * dw + x] = std::min(su >> 7, 32767);
      v15[static_cast<size_t>(r) * dw + x] = std::min(sv >> 7, 32767);
    }
  }
  // vertical: the chroma rows (luma is the identity; x86 aligns the taps to
  // 2, or 1 where one is enough)
  const Filter fv = init_filter(ch, h, 2, 1 << 12, src_vpos, 128);
  std::vector<int> ur(dw), vr(dw);
  for (int r = 0; r < h; ++r) {
    const uint8_t* py = y + static_cast<int64_t>(r) * ystride;
    uint8_t* o = dst + static_cast<int64_t>(r) * w * 3;
    const int* c = &fv.coef[static_cast<size_t>(r) * fv.size];
    const int p = fv.pos[r];
    const int* u0 = &u15[static_cast<size_t>(p) * dw];
    const int* v0 = &v15[static_cast<size_t>(p) * dw];
    const int* u1 = &u15[static_cast<size_t>(std::min(p + 1, ch - 1)) * dw];
    const int* v1 = &v15[static_cast<size_t>(std::min(p + 1, ch - 1)) * dw];
    const bool one_tap = fv.size == 1 || (fv.size == 2 && c[0] + c[1] == 4096 &&
                                          static_cast<unsigned>(c[1]) <= 4096u);
    const int alpha = fv.size == 1 ? 0 : c[1];
    auto sum_taps = [&](const std::vector<int>& s, int x, int64_t acc, bool mmx) {
      for (int j = 0; j < fv.size; ++j) {
        const int at = (p + j) * dw + x;
        acc += mmx ? mulhi16(s[at], c[j]) : s[at] * c[j];
      }
      return acc;
    };
    if (full) {  // yuv2rgb_full_1 / _X (C): 2^9 a level
      for (int x = 0; x < w; ++x, o += 3) {
        int uv, vv;
        if (one_tap && alpha == 0) {
          uv = (u0[x] - (128 << 7)) * 4;
          vv = (v0[x] - (128 << 7)) * 4;
        } else if (one_tap) {
          uv = (u0[x] * (4096 - alpha) + u1[x] * alpha - (128 << 19)) >> 10;
          vv = (v0[x] * (4096 - alpha) + v1[x] * alpha - (128 << 19)) >> 10;
        } else {
          uv = static_cast<int>(sum_taps(u15, x, (1 << 9) - (128 << 19), false) >> 10);
          vv = static_cast<int>(sum_taps(v15, x, (1 << 9) - (128 << 19), false) >> 10);
        }
        write_full(k, py[x] << 9, uv, vv, o);
      }
      continue;
    }
    // half-width chroma: U, V by chroma sample, then two pixels each
    if (r < h - 2) {  // MMXEXT: levels times 8
      for (int x = 0; x < dw; ++x) {
        if (one_tap && alpha < 2048) {
          ur[x] = u0[x] >> 4;
          vr[x] = v0[x] >> 4;
        } else if (one_tap) {
          ur[x] = (u0[x] + u1[x]) >> 5;
          vr[x] = (v0[x] + v1[x]) >> 5;
        } else {
          ur[x] = static_cast<int>(sum_taps(u15, x, 4, true));
          vr[x] = static_cast<int>(sum_taps(v15, x, 4, true));
        }
      }
      const int yround = one_tap ? 0 : 4;
      for (int x = 0; x < w; ++x, o += 3) {
        const int cu = ur[x >> 1] - 1024, cv = vr[x >> 1] - 1024;
        const int yy = mulhi16(py[x] * 8 + yround - k.yoff, k.y);
        o[0] = clip8(yy + mulhi16(cu, k.ub));
        o[1] = clip8(yy + mulhi16(cu, k.ug) + mulhi16(cv, k.vg));
        o[2] = clip8(yy + mulhi16(cv, k.vr));
      }
      continue;
    }
    for (int x = 0; x < dw; ++x) {  // C: 8-bit levels through the tables
      if (one_tap && alpha == 0) {
        ur[x] = (u0[x] + 64) >> 7;
        vr[x] = (v0[x] + 64) >> 7;
      } else if (one_tap) {
        ur[x] = (u0[x] * (4096 - alpha) + u1[x] * alpha + (128 << 11)) >> 19;
        vr[x] = (v0[x] * (4096 - alpha) + v1[x] * alpha + (128 << 11)) >> 19;
      } else {
        ur[x] = static_cast<int>(sum_taps(u15, x, 1 << 18, false) >> 19);
        vr[x] = static_cast<int>(sum_taps(v15, x, 1 << 18, false) >> 19);
      }
    }
    for (int x = 0; x < w; ++x, o += 3) {
      const int iu = std::clamp(ur[x >> 1] + kHeadroom, 0, kTable - 1);
      const int iv = std::clamp(vr[x >> 1] + kHeadroom, 0, kTable - 1);
      o[0] = k.ytab[k.bu[iu] + py[x]];
      o[1] = k.ytab[k.gu[iu] + k.gv[iv] + py[x]];
      o[2] = k.ytab[k.rv[iv] + py[x]];
    }
  }
  return full ? kFullChroma : kScaled;
}

}  // namespace

extern "C" {

// Planes of a decoded frame (luma stride ystride, both chroma planes
// cstride; chroma 2 4:2:0, 1 4:2:2, 0 4:4:4) to (h, w, 3) BGR as cv2 gets
// them from swscale, in the colour space of ff_yuv2rgb_coeffs row `matrix`
// (0 BT.601, 1 BT.709, 2 SMPTE-240M, 3 BT.2020), the range (full_range
// 1: the yuvj formats' and JPEG-range streams') and the chroma's siting
// as an AVChromaLocation (0 unspecified, which is centred, 1 left, as
// FFmpeg's MPEG-4 Part 2 decoder reports it, 2 center, 3 topleft, 4 top,
// as a Matroska track may state them, 5 bottomleft, 6 bottom; only the
// scaling path reads it).  Returns the path taken: 0 unscaled, 1 scaled
// with a chroma sample for two pixels, 2 scaled with full horizontal
// chroma.
int fgpack_yuv_to_bgr24(const uint8_t* y, const uint8_t* u, const uint8_t* v, int64_t ystride,
                        int64_t cstride, int64_t h, int64_t w, int chroma, int matrix,
                        int full_range, int siting, uint8_t* dst) {
  if (!y || !u || !v || !dst || h <= 0 || w <= 0 || h > (1 << 16) || w > (1 << 16) ||
      chroma < k444 || chroma > k420 || matrix < 0 || matrix > 3 || siting < 0 || siting > 6)
    return kErrArgs;
  const Coeffs& k = coeffs(matrix, full_range != 0);
  if (chroma != k444 && !(h & 1)) {
    unscaled(y, u, v, ystride, cstride, h, w, chroma == k420, k, dst);
    return kUnscaled;
  }
  return scaled(y, u, v, ystride, cstride, static_cast<int>(h), static_cast<int>(w), chroma,
                siting, k, dst);
}

// cv2 converts through swscale's frame API, which reads a frame's colour
// properties: its colour space picks the row, and primaries or a transfer
// other than these (read from cv2's frames: up to SMPTE 240M; no log, PQ,
// HLG or unnamed curve) send it through swscale's colour management to
// another gamut or curve, which the port does not reproduce.

// The kRows row (fgpack_yuv_to_bgr24's matrix) swscale takes for an
// AVColorSpace, -1 for FCC and the spaces swscale refuses (reserved, YCgCo,
// BT.2020 constant luminance and later).
int fgpack_sws_matrix_row(int colorspace) {
  switch (colorspace) {
    case 0: case 2: case 5: case 6: return 0;  // RGB, unspecified, BT.470BG, SMPTE 170M
    case 1: return 1;                          // BT.709
    case 7: return 2;                          // SMPTE 240M
    case 9: return 3;                          // BT.2020 non-constant luminance
    default: return -1;
  }
}

// 1 where a frame's AVColorPrimaries or AVColorTransferCharacteristic send
// it through swscale's colour management, else 0.
int fgpack_sws_colour_managed(int primaries, int transfer) {
  const bool prim = primaries >= 0 && primaries <= 7;
  const bool trc = (transfer >= 0 && transfer <= 8) || (transfer >= 11 && transfer <= 15) ||
                   transfer == 17;
  return prim && trc ? 0 : 1;
}

}  // extern "C"
