// gif: GIF output and input for the port's host library (compiled with
// csrc/fgpack.cpp into one library).  C++17.
//
// Writing (data_io/gif.py holds the file's layout, as PIL's GifImagePlugin
// lays it out):
//
// * fgpack_gif_quantize: what PIL's Image.convert("P",
//   palette=Palette.ADAPTIVE) gives for an RGB image (ImagingQuantize,
//   method 0: median cut, no k-means, no dither).  The distinct colours go
//   through PIL's pixel hash (QuantHash.c: chained buckets kept in hash
//   order, colours equal when their hash values are); while more than
//   65,536 hash values are in it, the low bit of every channel is dropped
//   (the scale grows by one) and the table rehashed.  The median cut takes
//   the box of most pixels from PIL's heap (QuantHeap.c), skipping boxes of
//   one colour, 255 times; it splits along the axis of the largest range
//   weighted 77 / 150 / 29 (the first on ties), after the colour at which the
//   pixels counted from the top of that axis pass half of the box, every
//   pixel of that colour with them (the last colour goes right where nothing
//   would).  The palette is the boxes' leaves from the high side, each the
//   rounded mean of the pixels that hash into it; a pixel takes its box's
//   entry unless another one is strictly nearer, searched in the order of
//   the entries' distances from the box's own (a stable sort) up to four
//   times the first distance.
// * fgpack_gif_lzw: PIL's GIF LZW encoder (GifEncode.c) at the minimum
//   code size of 8 that PIL writes every image with: a clear code first,
//   codes from 9 bits wide, one bit wider once the code just assigned
//   passes the width's largest, a clear code (and a fresh table) where the
//   table would pass 4,095; the rows in interlaced order (0 mod 8, 4 mod 8,
//   2 mod 4, 1 mod 2) when asked; packed least significant bit first into
//   sub-blocks of 255 bytes, each encoder buffer (PIL's ImageFile.MAXBLOCK
//   or four bytes a row, the larger) holding as many as fit.
//
// Reading, as cv2.VideoCapture gets frames from FFmpeg's gif demuxer,
// parser and decoder:
//
// * fgpack_gif_open: the file's blocks.  The frame count is every image
//   descriptor (the demuxer's nb_frames), the duration every graphic
//   control extension's delay, 0 read as 10 hundredths (its default).  The
//   packets are the gif parser's: a packet ends before an extension that
//   follows an image, and before an image that follows one once any
//   extension has been seen; the images before the file's first extension
//   go into the first packet, whose decoding shows only the first of them.
// * fgpack_gif_decode: one packet as FFmpeg's gif decoder draws it on its
//   BGRA canvas: the logical screen's global table and background, local
//   tables (256-entry tables whose entries past the table's size keep what
//   the last table of the kind left), the graphic control extension's
//   transparency index and disposal (none, in place, background: the
//   transparent colour where that image had a transparent index, else the
//   background colour; previous: the rectangle as it was before the image),
//   images clipped to the screen, interlaced rows; the first packet's canvas
//   is filled with the background colour, or transparent white (0x00ffffff)
//   where the first image has a transparent index or the file has no global
//   table.  LZW codes from the image's minimum code size + 1 bits (1 to 11),
//   the table growing to 4,096 codes; a row the stream ends in (an end code
//   or a code past the table) is not drawn, nor are the rows after it.
//   fgpack_gif_bgr drops the alpha byte, as swscale's BGRA -> BGR24 does.
//
// Refused with a status: a file that is not GIF87a / GIF89a, blocks that
// overrun the file, an image placed past the screen's right or bottom edge,
// an image without a colour table, a minimum code size outside 1 to 11, LZW
// data that runs past its sub-blocks.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// the library's status codes for this file (enum Status of fgpack.cpp
// holds 0 .. -31, mpeg4video.cpp -32 .. -40, vp9video.cpp -41 .. -44,
// avi.cpp -45 .. -48, mjpeg.cpp -49 .. -52)
enum Status {
  kOk = 0,
  kErrArgs = -14,
  kErrCorrupt = -53,    // not a GIF, or blocks that overrun the file
  kErrTruncated = -54,  // LZW data that runs past its sub-blocks
  kErrForm = -55,       // an image past the screen, no colour table, code size
};

// ------------------------------------------------------------------ //
// the median-cut quantiser (PIL's Quant.c, QuantHash.c, QuantHeap.c)

constexpr uint32_t kMaxHashEntries = 65536;

inline uint32_t pixel_hash(uint32_t r, uint32_t g, uint32_t b) {
  return (r * 463u) ^ ((g << 8) * 10069u) ^ ((b << 16) * 64997u);
}

// QuantHash.c's table with Quant.c's pixel_hash / pixel_cmp: a key is a
// colour (r | g << 8 | b << 16), two keys are equal when the hashes of
// their channels shifted right by `scale` are.
struct PixelHash {
  struct Node {
    int next;
    uint32_t key, value;
  };
  std::vector<int> table;
  std::vector<Node> nodes;  // a node merged away at a rehash is left unused
  uint32_t length = 11, count = 0;
  int scale = 0;

  PixelHash() : table(11, -1) {}

  uint32_t hash(uint32_t key) const {
    return pixel_hash((key & 255) >> scale, ((key >> 8) & 255) >> scale,
                      ((key >> 16) & 255) >> scale);
  }

  static uint32_t find_prime(uint32_t start, int dir) {
    // _findPrime: its trial division tests (!start) % t, which is never
    // true, so the first start whose low four bits are 1, 3, 7, 9, 11 or
    // 15 is taken
    static const int unit[16] = {0, 1, 0, 1, 0, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 1};
    while (start > 1 && !unit[start & 15]) start += dir;
    return start;
  }

  // _hashtable_insert_node: a colliding node's key and (with `add`) value
  // go into the node already there
  void insert_node(int n, bool add) {
    const uint32_t h = hash(nodes[n].key);
    int* link = &table[h % length];
    while (*link >= 0) {
      Node& nv = nodes[*link];
      const uint32_t hv = hash(nv.key);
      if (hv == h) {
        nv.key = nodes[n].key;
        nv.value = add ? nv.value + nodes[n].value : nodes[n].value;
        return;
      }
      if (hv > h) break;
      link = &nv.next;
    }
    nodes[n].next = *link;
    *link = n;
    count++;
  }

  void rehash(uint32_t new_length, bool add) {
    std::vector<int> old;
    old.swap(table);
    table.assign(new_length, -1);
    length = new_length;
    count = 0;
    for (int head : old) {
      for (int n = head; n >= 0;) {
        const int next = nodes[n].next;
        insert_node(n, add);
        n = next;
      }
    }
  }

  void resize() {
    uint32_t size = length;
    if (count * 3 < length) {
      size = find_prime(length / 2 - 1, -1);
    } else if (length * 3 < count) {
      size = find_prime(length * 2 + 1, +1);
    }
    if (size < 11) size = length;
    if (size != length) rehash(size, false);
  }

  // hashtable_insert_or_update_computed with new_count_func /
  // exists_count_func: the colour replaces the key and counts once more
  void count_pixel(uint32_t key) {
    const uint32_t h = hash(key);
    const uint32_t bucket = h % length;
    int prev = -1;
    for (int at = table[bucket]; at >= 0; prev = at, at = nodes[at].next) {
      Node& nv = nodes[at];
      const uint32_t hv = hash(nv.key);
      if (hv == h) {
        nv.key = key;
        nv.value++;
        return;
      }
      if (hv > h) break;
    }
    const int n = int(nodes.size());
    nodes.push_back({});
    int& link = prev < 0 ? table[bucket] : nodes[prev].next;
    nodes[n] = {link, key, 1};
    link = n;
    count++;
    resize();
  }
};

struct Entry {
  uint8_t v[3];  // the colour shifted right by the scale
  uint32_t count;
};

struct Box {
  std::vector<int> items;
  uint32_t pixels = 0;
  int volume = -1;
  int l = -1, r = -1;
  uint8_t lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
};

// QuantHeap.c with box_heap_cmp (pixel counts): a max-heap from 1
struct BoxHeap {
  std::vector<int> heap{-1};
  const std::vector<Box>* boxes;
  int cmp(int a, int b) const {
    return int((*boxes)[a].pixels - (*boxes)[b].pixels);
  }
  void add(int v) {
    heap.push_back(v);
    size_t k = heap.size() - 1;
    while (k != 1) {
      if (cmp(v, heap[k / 2]) <= 0) break;
      heap[k] = heap[k / 2];
      k >>= 1;
    }
    heap[k] = v;
  }
  bool remove(int* out) {
    if (heap.size() <= 1) return false;
    *out = heap[1];
    const int v = heap.back();
    heap.pop_back();
    const size_t count = heap.size() - 1;
    size_t k = 1, l;
    for (; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && cmp(heap[l], heap[l + 1]) < 0) l++;
      if (cmp(v, heap[l]) > 0) break;
      heap[k] = heap[l];
    }
    if (count) heap[k] = v;
    return true;
  }
};

void box_bounds(Box& b, const std::vector<Entry>& entries) {
  for (int i : b.items) {
    for (int c = 0; c < 3; c++) {
      b.lo[c] = std::min(b.lo[c], entries[i].v[c]);
      b.hi[c] = std::max(b.hi[c], entries[i].v[c]);
    }
  }
}

int box_volume(Box& b) {
  if (b.volume < 0) {
    b.volume = b.items.empty() ? 0
                               : (b.hi[0] - b.lo[0] + 1) * (b.hi[1] - b.lo[1] + 1) *
                                     (b.hi[2] - b.lo[2] + 1);
  }
  return b.volume;
}

// split() and splitlists(): the left box takes the high values
void split_box(std::vector<Box>& boxes, int at, const std::vector<Entry>& entries) {
  Box& node = boxes[at];
  const int f[3] = {(node.hi[0] - node.lo[0]) * 77, (node.hi[1] - node.lo[1]) * 150,
                    (node.hi[2] - node.lo[2]) * 29};
  int axis = 0;
  for (int i = 1; i < 3; i++) {
    if (f[axis] < f[i]) axis = i;
  }
  std::vector<int> items = std::move(node.items);
  std::stable_sort(items.begin(), items.end(), [&](int a, int b) {
    return entries[a].v[axis] > entries[b].v[axis];
  });
  const size_t n = items.size();
  uint32_t left = 0;
  size_t cut = 0;
  while (cut < n) {
    left += entries[items[cut]].count;
    cut++;
    if (uint32_t(left * 2) > node.pixels) break;
  }
  if (cut < n) {
    const uint8_t value = entries[items[cut - 1]].v[axis];
    while (cut < n && entries[items[cut]].v[axis] == value) cut++;
  }
  if (cut == n) {
    const uint8_t value = entries[items[n - 1]].v[axis];
    while (cut > 0 && entries[items[cut - 1]].v[axis] == value) cut--;
  }
  Box lb, rb;
  lb.items.assign(items.begin(), items.begin() + cut);
  rb.items.assign(items.begin() + cut, items.end());
  for (int i : lb.items) lb.pixels += entries[i].count;
  for (int i : rb.items) rb.pixels += entries[i].count;
  box_bounds(lb, entries);
  box_bounds(rb, entries);
  const int li = int(boxes.size());
  boxes.push_back(std::move(lb));
  boxes.push_back(std::move(rb));
  boxes[at].l = li;
  boxes[at].r = li + 1;
}

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
  const int dr = int(a[0]) - int(b[0]), dg = int(a[1]) - int(b[1]), db = int(a[2]) - int(b[2]);
  return uint32_t(dr * dr + dg * dg + db * db);
}

// open addressing from a 24-bit colour to its palette entry: the memo of
// the nearest-entry search (Quant.c keeps one in an unshifted hash table);
// kept at most half full, colours past that searched each time
struct ColourMemo {
  std::vector<uint32_t> keys;
  std::vector<uint8_t> vals;
  uint32_t mask;
  size_t used = 0;
  explicit ColourMemo(int64_t n) {
    size_t cap = 1024;
    while (cap < size_t(std::min<int64_t>(n, 1 << 22)) * 2) cap <<= 1;
    keys.assign(cap, 0xFFFFFFFFu);
    vals.assign(cap, 0);
    mask = uint32_t(cap - 1);
  }
  // the slot of `key`; *found tells whether it holds it already
  size_t slot(uint32_t key, bool* found) const {
    size_t i = (key * 2654435761u) & mask;
    while (keys[i] != 0xFFFFFFFFu && keys[i] != key) i = (i + 1) & mask;
    *found = keys[i] == key;
    return i;
  }
  void put(size_t s, uint32_t key, uint8_t value) {
    if (2 * used >= keys.size()) return;
    keys[s] = key;
    vals[s] = value;
    used++;
  }
};

int quantize(const uint8_t* rgb, int64_t n_pixels, uint8_t* palette_out, int64_t* n_out,
             uint8_t* index_out) {
  PixelHash hash;
  for (int64_t i = 0; i < n_pixels; i++) {
    const uint8_t* p = rgb + 3 * i;
    hash.count_pixel(uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16));
    while (hash.count > kMaxHashEntries) {
      hash.scale++;
      hash.rehash(hash.length, true);
    }
  }
  const int scale = hash.scale;
  std::vector<Entry> entries;
  entries.reserve(hash.count);
  for (int head : hash.table) {
    for (int nd = head; nd >= 0; nd = hash.nodes[nd].next) {
      const uint32_t key = hash.nodes[nd].key;
      entries.push_back({{uint8_t((key & 255) >> scale), uint8_t(((key >> 8) & 255) >> scale),
                          uint8_t(((key >> 16) & 255) >> scale)},
                         hash.nodes[nd].value});
    }
  }
  std::vector<Box> boxes(1);
  boxes.reserve(520);
  boxes[0].items.resize(entries.size());
  for (size_t i = 0; i < entries.size(); i++) boxes[0].items[i] = int(i);
  boxes[0].pixels = uint32_t(n_pixels);
  box_bounds(boxes[0], entries);
  BoxHeap heap;
  heap.boxes = &boxes;
  heap.add(0);
  for (int left = 255; left > 0; left--) {
    int at;
    bool got;
    do {
      got = heap.remove(&at);
    } while (got && box_volume(boxes[at]) == 1);
    if (!got) break;
    split_box(boxes, at, entries);
    heap.add(boxes[at].l);
    heap.add(boxes[at].r);
  }
  // annotate_hash_table: the leaves from the left (high) side
  std::unordered_map<uint32_t, uint32_t> box_of;
  box_of.reserve(entries.size() * 2);
  uint32_t n_entries = 0;
  std::vector<int> stack{0};
  while (!stack.empty()) {
    const int at = stack.back();
    stack.pop_back();
    const Box& b = boxes[at];
    if (b.l >= 0) {
      stack.push_back(b.r);
      stack.push_back(b.l);
      continue;
    }
    if (b.items.empty()) continue;
    for (int i : b.items) {
      box_of[pixel_hash(entries[i].v[0], entries[i].v[1], entries[i].v[2])] = n_entries;
    }
    n_entries++;
  }
  // compute_palette_from_median_cut
  std::vector<uint64_t> sum(3 * n_entries, 0), count(n_entries, 0);
  std::vector<uint32_t> pixel_box(n_pixels);
  for (int64_t i = 0; i < n_pixels; i++) {
    const uint8_t* p = rgb + 3 * i;
    const uint32_t b = box_of[pixel_hash(p[0] >> scale, p[1] >> scale, p[2] >> scale)];
    pixel_box[i] = b;
    sum[3 * b] += p[0];
    sum[3 * b + 1] += p[1];
    sum[3 * b + 2] += p[2];
    count[b]++;
  }
  std::vector<uint8_t> pal(3 * n_entries);
  for (uint32_t b = 0; b < n_entries; b++) {
    for (int c = 0; c < 3; c++) {
      pal[3 * b + c] = uint8_t(int(.5 + double(sum[3 * b + c]) / double(count[b])));
    }
  }
  // build_distance_tables: each row's entries in order of distance
  std::vector<uint32_t> dist(size_t(n_entries) * n_entries);
  std::vector<uint16_t> order(size_t(n_entries) * n_entries);
  for (uint32_t i = 0; i < n_entries; i++) {
    for (uint32_t j = 0; j <= i; j++) {
      dist[size_t(i) * n_entries + j] = dist[size_t(j) * n_entries + i] =
          dist2(&pal[3 * i], &pal[3 * j]);
    }
  }
  for (uint32_t i = 0; i < n_entries; i++) {
    uint16_t* row = &order[size_t(i) * n_entries];
    const uint32_t* d = &dist[size_t(i) * n_entries];
    for (uint32_t j = 0; j < n_entries; j++) row[j] = uint16_t(j);
    std::stable_sort(row, row + n_entries, [d](uint16_t a, uint16_t b) { return d[a] < d[b]; });
  }
  // map_image_pixels_from_median_box
  ColourMemo memo(n_pixels);
  for (int64_t i = 0; i < n_pixels; i++) {
    const uint8_t* p = rgb + 3 * i;
    const uint32_t key = uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
    bool found;
    const size_t s = memo.slot(key, &found);
    if (found) {
      index_out[i] = memo.vals[s];
      continue;
    }
    const uint32_t b = pixel_box[i];
    uint32_t best = dist2(&pal[3 * b], p), match = b;
    const uint32_t limit = best << 2;
    const uint16_t* row = &order[size_t(b) * n_entries];
    const uint32_t* d = &dist[size_t(b) * n_entries];
    for (uint32_t j = 0; j < n_entries; j++) {
      const uint32_t e = row[j];
      if (d[e] > limit) break;
      const uint32_t dd = dist2(&pal[3 * e], p);
      if (dd < best) {
        best = dd;
        match = e;
      }
    }
    index_out[i] = uint8_t(match);
    memo.put(s, key, uint8_t(match));
  }
  std::memcpy(palette_out, pal.data(), pal.size());
  *n_out = n_entries;
  return kOk;
}

// ------------------------------------------------------------------ //
// the LZW encoder (PIL's GifEncode.c)

struct BitSink {
  std::vector<uint8_t> bytes;
  uint32_t buffer = 0;
  int bits = 0;
  void put(uint32_t code, int width) {
    buffer |= code << bits;
    bits += width;
    while (bits >= 8) {
      bytes.push_back(uint8_t(buffer));
      buffer >>= 8;
      bits -= 8;
    }
  }
  void flush() {
    if (bits > 0) bytes.push_back(uint8_t(buffer));
    buffer = 0;
    bits = 0;
  }
};

// the minimum code size PIL writes every GIF image with, and its
// ImageFile.MAXBLOCK (the encoder's buffer, which its sub-blocks fill)
constexpr int kLzwBits = 8;
constexpr int64_t kMaxBlock = 65536;

std::vector<uint8_t> lzw_codes(const uint8_t* idx, int64_t w, int64_t h, bool interlace) {
  constexpr int bits = kLzwBits;
  const uint32_t clear = 1u << bits, end = clear + 1;
  constexpr uint32_t kLimit = 4096;
  // code -> its extension by each byte (0: none); rows cleared at a reset
  std::vector<uint16_t> next(size_t(kLimit) * 256, 0);
  uint32_t next_code = 0, max_code = 0;
  int width = 0;
  auto reset = [&]() {
    if (next_code) std::memset(next.data(), 0, sizeof(uint16_t) * 256 * next_code);
    next_code = end + 1;
    max_code = 2 * clear - 1;
    width = bits + 1;
  };
  BitSink sink;
  sink.bytes.reserve(size_t(w * h) + 16);
  reset();
  sink.put(clear, width);
  std::vector<int64_t> rows;
  rows.reserve(h);
  if (interlace) {
    for (int64_t y = 0; y < h; y += 8) rows.push_back(y);
    for (int64_t y = 4; y < h; y += 8) rows.push_back(y);
    for (int64_t y = 2; y < h; y += 4) rows.push_back(y);
    for (int64_t y = 1; y < h; y += 2) rows.push_back(y);
  } else {
    for (int64_t y = 0; y < h; y++) rows.push_back(y);
  }
  bool have_head = false;
  uint32_t head = 0;
  for (int64_t y : rows) {
    const uint8_t* row = idx + y * w;
    int64_t x = 0;
    if (!have_head) {
      head = row[0];
      have_head = true;
      x = 1;
    }
    for (; x < w; x++) {
      const uint32_t tail = row[x];
      const uint16_t code = next[size_t(head) * 256 + tail];
      if (code) {
        head = code;
        continue;
      }
      sink.put(head, width);
      if (next_code < kLimit) {
        next[size_t(head) * 256 + tail] = uint16_t(next_code);
        if (next_code > max_code) {
          max_code = max_code * 2 + 1;
          width++;
        }
        next_code++;
      } else {
        sink.put(clear, width);
        reset();
      }
      head = tail;
    }
  }
  if (have_head) sink.put(head, width);
  sink.put(end, width);
  sink.flush();
  return std::move(sink.bytes);
}

// ImagingGifEncode's sub-blocks: each call fills a buffer of `bufsize`
// bytes with blocks of at most 255 bytes (a block needs two bytes free)
std::vector<uint8_t> sub_blocks(const std::vector<uint8_t>& data, int64_t bufsize) {
  std::vector<uint8_t> out;
  out.reserve(data.size() + data.size() / 255 + 2);
  size_t at = 0;
  int64_t room = bufsize;
  while (at < data.size()) {
    if (room < 2) room = bufsize;
    const size_t n = std::min<size_t>({255, size_t(room - 1), data.size() - at});
    out.push_back(uint8_t(n));
    out.insert(out.end(), data.begin() + at, data.begin() + at + n);
    at += n;
    room -= int64_t(n) + 1;
  }
  return out;
}

// ------------------------------------------------------------------ //
// the reader (FFmpeg's gif demuxer, parser and decoder, as cv2 uses them)

inline int rl16(const uint8_t* p) { return p[0] | (p[1] << 8); }

constexpr int kDefaultDelay = 10;

struct GifFile {
  int64_t width = 0, height = 0, images = 0, duration = 0;
  std::vector<int64_t> offsets, sizes;
};

// the sub-blocks from `at`: the position after their terminator, -1 past
// the end
int64_t skip_sub_blocks(const uint8_t* b, int64_t n, int64_t at) {
  while (at < n) {
    const int len = b[at];
    at += 1 + len;
    if (!len) return at <= n ? at : -1;
  }
  return -1;
}

int scan(const uint8_t* b, int64_t n, GifFile* f) {
  if (n < 13 || (std::memcmp(b, "GIF87a", 6) && std::memcmp(b, "GIF89a", 6))) {
    return kErrCorrupt;
  }
  f->width = rl16(b + 6);
  f->height = rl16(b + 8);
  if (!f->width || !f->height) return kErrCorrupt;
  int64_t at = 13;
  if (b[10] & 0x80) at += 3 * (int64_t(1) << ((b[10] & 7) + 1));
  if (at > n) return kErrCorrupt;
  // the parser's state: found_start (an extension seen), found_end (an
  // image ended in the packet)
  bool seen_extension = false, image_in_packet = false;
  int64_t packet_start = 0, last_image_end = -1;
  auto cut = [&](int64_t where) {
    f->offsets.push_back(packet_start);
    f->sizes.push_back(where - packet_start);
    packet_start = where;
    image_in_packet = false;
  };
  while (at < n) {
    const uint8_t label = b[at];
    if (label == 0x3B) break;  // the trailer
    if (label == 0x21) {
      if (image_in_packet) cut(at);
      seen_extension = true;
      if (at + 2 > n) return kErrCorrupt;
      const uint8_t kind = b[at + 1];
      int64_t p = at + 2;
      if (kind == 0xF9 && p < n && b[p] == 4) {
        if (p + 5 > n) return kErrCorrupt;
        const int delay = rl16(b + p + 2);
        f->duration += delay < 1 ? kDefaultDelay : delay;
      }
      at = skip_sub_blocks(b, n, p);
      if (at < 0) return kErrCorrupt;
    } else if (label == 0x2C) {
      if (image_in_packet && seen_extension) cut(at);
      if (at + 10 > n) return kErrCorrupt;
      const uint8_t flags = b[at + 9];
      int64_t p = at + 10;
      if (flags & 0x80) p += 3 * (int64_t(1) << ((flags & 7) + 1));
      if (p + 1 > n) return kErrCorrupt;
      if (b[p] < 1) return kErrForm;  // the demuxer's minimum code size check
      at = skip_sub_blocks(b, n, p + 1);
      if (at < 0) return kErrCorrupt;
      f->images++;
      image_in_packet = true;
      last_image_end = at;
    } else {
      return kErrCorrupt;
    }
  }
  if (last_image_end > packet_start) cut(last_image_end);
  return kOk;
}

// FFmpeg's lzw.c in its GIF mode
struct Lzw {
  const uint8_t* b = nullptr;
  int64_t n = 0, at = 0;
  int block = 0;  // bytes left in the sub-block
  bool past = false;
  uint32_t bbuf = 0;
  int bbits = 0;
  int codesize = 0, cursize = 0, curmask = 0, clear_code = 0, end_code = 0;
  int newcodes = 0, top_slot = 0, slot = 0, oc = -1, fc = -1;
  uint8_t stack[4096 + 8];
  uint8_t suffix[4096];
  uint16_t prefix[4096];
  int sp = 0;

  int init(const uint8_t* data, int64_t size, int csize) {
    if (csize < 1 || csize >= 12) return kErrForm;
    b = data;
    n = size;
    at = 0;
    block = 0;
    past = false;
    bbuf = 0;
    bbits = 0;
    codesize = csize;
    cursize = codesize + 1;
    curmask = (1 << cursize) - 1;
    top_slot = 1 << cursize;
    clear_code = 1 << codesize;
    end_code = clear_code + 1;
    slot = newcodes = clear_code + 2;
    oc = fc = -1;
    sp = 0;
    return kOk;
  }
  int byte() {
    if (at >= n) {
      past = true;
      return 0;
    }
    return b[at++];
  }
  int get_code() {
    while (bbits < cursize) {
      if (!block) {
        block = byte();
        if (!block) past = true;  // past the terminator: FFmpeg reads on
      }
      bbuf |= uint32_t(byte()) << bbits;
      bbits += 8;
      block--;
    }
    const int c = int(bbuf & uint32_t(curmask));
    bbuf >>= cursize;
    bbits -= cursize;
    return c;
  }
  // up to `len` indices into buf; fewer where the stream ends
  int decode(uint8_t* buf, int len) {
    if (end_code < 0) return 0;
    int l = len;
    for (;;) {
      while (sp > 0) {
        *buf++ = stack[--sp];
        if (--l == 0) return len;
      }
      const int c = get_code();
      if (past) return -1;
      if (c == end_code) break;
      if (c == clear_code) {
        cursize = codesize + 1;
        curmask = (1 << cursize) - 1;
        slot = newcodes;
        top_slot = 1 << cursize;
        fc = oc = -1;
        continue;
      }
      int code = c;
      if (code == slot && fc >= 0) {
        stack[sp++] = uint8_t(fc);
        code = oc;
      } else if (code >= slot) {
        break;
      }
      while (code >= newcodes) {
        stack[sp++] = suffix[code];
        code = prefix[code];
      }
      stack[sp++] = uint8_t(code);
      if (slot < top_slot && oc >= 0) {
        suffix[slot] = uint8_t(code);
        prefix[slot++] = uint16_t(oc);
      }
      fc = code;
      oc = c;
      if (slot >= top_slot && cursize < 12) {
        top_slot <<= 1;
        curmask = (1 << ++cursize) - 1;
      }
    }
    end_code = -1;
    return len - l;
  }
};

constexpr uint32_t kTransparent = 0x00FFFFFFu;  // GIF_TRANSPARENT_COLOR

// the counters of fgpack_gif_stats, in order (data_io/video.py's GIF_FEATURES)
enum Feature {
  kImages, kInterlaced, kLocalTables, kTransparentImages, kPartialImages, kDisposeNone,
  kDisposeInPlace, kDisposeBackground, kDisposePrevious, kShortImages, kFeatures
};

struct GifDecoder {
  int64_t screen_w = 0, screen_h = 0;
  bool have_header = false, has_global = false;
  uint32_t global_palette[256] = {}, local_palette[256] = {};
  uint32_t bg_color = 0;
  int transparent = -1, disposal = 0, prev_disposal = 0;
  int64_t dl = 0, dt = 0, dw = 0, dh = 0;
  uint32_t stored_bg = 0;
  std::vector<uint32_t> canvas, stored;
  std::vector<uint8_t> line;
  Lzw lzw;
  int64_t stats[kFeatures] = {};
  std::string error;

  int fail(int status, const std::string& why) {
    error = why;
    return status;
  }

  void fill_rect(uint32_t color, int64_t l, int64_t t, int64_t w, int64_t h) {
    for (int64_t y = t; y < t + h; y++) {
      std::fill(canvas.begin() + y * screen_w + l, canvas.begin() + y * screen_w + l + w, color);
    }
  }
  static void copy_rect(const std::vector<uint32_t>& src, std::vector<uint32_t>& dst,
                        int64_t stride, int64_t l, int64_t t, int64_t w, int64_t h) {
    for (int64_t y = t; y < t + h; y++) {
      std::copy(src.begin() + y * stride + l, src.begin() + y * stride + l + w,
                dst.begin() + y * stride + l);
    }
  }

  void read_palette(const uint8_t* p, uint32_t* pal, int count) {
    for (int i = 0; i < count; i++, p += 3) {
      pal[i] = 0xFF000000u | (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
    }
  }

  int header(const uint8_t* b, int64_t n, int64_t* at) {
    if (n < 13) return fail(kErrCorrupt, "a GIF header of fewer than 13 bytes");
    transparent = -1;
    screen_w = rl16(b + 6);
    screen_h = rl16(b + 8);
    const int v = b[10];
    has_global = v & 0x80;
    const int bpp = (v & 7) + 1;
    const int bg_index = b[11];
    *at = 13;
    if (has_global) {
      const int count = 1 << bpp;
      if (n - *at < 3 * count) return fail(kErrCorrupt, "a global colour table past the data");
      read_palette(b + *at, global_palette, count);
      *at += 3 * count;
      bg_color = global_palette[bg_index];
    }
    canvas.assign(size_t(screen_w * screen_h), 0);
    line.assign(size_t(screen_w), 0);
    prev_disposal = 0;
    have_header = true;
    return kOk;
  }

  int extension(const uint8_t* b, int64_t n, int64_t* at) {
    if (n - *at < 2) return fail(kErrCorrupt, "an extension past the data");
    const int code = b[*at], len0 = b[*at + 1];
    *at += 2;
    int len = len0;
    if (code == 0xF9 && len == 4) {
      if (n - *at < 5) return fail(kErrCorrupt, "a graphic control extension past the data");
      const int flags = b[*at];
      const int index = b[*at + 3];
      transparent = (flags & 1) ? index : -1;
      disposal = (flags >> 2) & 7;
      if (disposal > 3) disposal = 0;
      len = b[*at + 4];
      *at += 5;
    }
    while (len) {
      if (n - *at < len + 1) return fail(kErrCorrupt, "an extension's sub-blocks past the data");
      *at += len;
      len = b[(*at)++];
    }
    return kOk;
  }

  int image(const uint8_t* b, int64_t n, int64_t* at, bool keyframe) {
    if (n - *at < 9) return fail(kErrCorrupt, "an image descriptor past the data");
    const uint8_t* d = b + *at;
    const int64_t left = rl16(d), top = rl16(d + 2);
    int64_t width = rl16(d + 4), height = rl16(d + 6);
    const int flags = d[8];
    *at += 9;
    const bool interlaced = flags & 0x40;
    const uint32_t* pal;
    if (flags & 0x80) {
      const int count = 1 << ((flags & 7) + 1);
      if (n - *at < 3 * count) return fail(kErrCorrupt, "a local colour table past the data");
      read_palette(b + *at, local_palette, count);
      *at += 3 * count;
      pal = local_palette;
      stats[kLocalTables]++;
    } else {
      if (!has_global) return fail(kErrForm, "an image without a global or local colour table");
      pal = global_palette;
    }
    if (keyframe) {
      const uint32_t fill = (transparent == -1 && has_global) ? bg_color : kTransparent;
      std::fill(canvas.begin(), canvas.end(), fill);
    }
    if (!width || width > screen_w) width = screen_w;
    if (left >= screen_w) {
      return fail(kErrForm, "an image left of " + std::to_string(left) + " on a screen " +
                                std::to_string(screen_w) + " wide");
    }
    if (!height || height > screen_h) height = screen_h;
    if (top >= screen_h) {
      return fail(kErrForm, "an image top of " + std::to_string(top) + " on a screen " +
                                std::to_string(screen_h) + " high");
    }
    const int64_t pw = left + width > screen_w ? screen_w - left : width;
    if (top + height > screen_h) height = screen_h - top;
    if (prev_disposal == 2) {
      fill_rect(stored_bg, dl, dt, dw, dh);
    } else if (prev_disposal == 3) {
      copy_rect(stored, canvas, screen_w, dl, dt, dw, dh);
    }
    prev_disposal = disposal;
    if (disposal != 0) {
      dl = left;
      dt = top;
      dw = pw;
      dh = height;
      if (disposal == 2) {
        stored_bg = transparent >= 0 ? kTransparent : bg_color;
      } else if (disposal == 3) {
        stored.resize(canvas.size());
        copy_rect(canvas, stored, screen_w, left, top, pw, height);
      }
    }
    stats[kImages]++;
    stats[kInterlaced] += interlaced;
    stats[kTransparentImages] += transparent >= 0;
    stats[kPartialImages] += !(left == 0 && top == 0 && pw == screen_w && height == screen_h);
    stats[kDisposeNone + disposal]++;
    if (n - *at < 2) return fail(kErrCorrupt, "image data past the end of the data");
    const int code_size = b[(*at)++];
    if (lzw.init(b + *at, n - *at, code_size) != kOk) {
      return fail(kErrForm, "an LZW minimum code size of " + std::to_string(code_size));
    }
    if (line.size() < size_t(width)) line.resize(size_t(width));
    int64_t y1 = 0, pass = 0;
    for (int64_t y = 0; y < height; y++) {
      const int count = lzw.decode(line.data(), int(width));
      if (count < 0) return fail(kErrTruncated, "LZW data past the image's sub-blocks");
      if (count != width) {
        stats[kShortImages]++;
        break;
      }
      uint32_t* px = canvas.data() + (top + y1) * screen_w + left;
      for (int64_t x = 0; x < pw; x++) {
        if (line[x] != transparent) px[x] = pal[line[x]];
      }
      if (interlaced) {
        y1 += pass <= 1 ? 8 : pass == 2 ? 4 : 2;
        while (y1 >= height) {
          y1 = 4 >> pass;
          pass++;
        }
      } else {
        y1++;
      }
    }
    transparent = -1;
    disposal = 0;
    return kOk;
  }

  // one parser packet: its blocks up to and including its first image
  int decode(const uint8_t* b, int64_t n, int64_t* out) {
    out[0] = 0;
    int64_t at = 0;
    const bool keyframe = n >= 6 && (!std::memcmp(b, "GIF87a", 6) || !std::memcmp(b, "GIF89a", 6));
    if (keyframe) {
      const int rc = header(b, n, &at);
      if (rc != kOk) return rc;
    } else if (!have_header) {
      return fail(kErrCorrupt, "a packet before the GIF header");
    }
    while (at < n) {
      const int label = b[at++];
      if (label == 0x2C) {
        const int rc = image(b, n, &at, keyframe);
        if (rc != kOk) return rc;
        out[0] = 1;
        out[1] = screen_w;
        out[2] = screen_h;
        return kOk;
      }
      if (label == 0x21) {
        const int rc = extension(b, n, &at);
        if (rc != kOk) return rc;
      } else if (label == 0x3B) {
        return kOk;
      } else {
        return fail(kErrCorrupt, "an unknown block label");
      }
    }
    return kOk;
  }
};

}  // namespace

extern "C" {

// the palette (3 * *n_colors bytes of the 768 given) and index image of an
// RGB image of n_pixels pixels, as PIL's convert("P", palette=ADAPTIVE)
int fgpack_gif_quantize(const uint8_t* rgb, int64_t n_pixels, uint8_t* palette,
                        int64_t* n_colors, uint8_t* index) {
  if (!rgb || !palette || !n_colors || !index || n_pixels <= 0 || n_pixels > (int64_t(1) << 30)) {
    return kErrArgs;
  }
  return quantize(rgb, n_pixels, palette, n_colors, index);
}

// an h x w index image's GIF image data: the minimum code size byte, the
// LZW codes in sub-blocks and the terminator; *out is malloc'd (free with
// fgpack_free)
int fgpack_gif_lzw(const uint8_t* idx, int64_t w, int64_t h, int interlace, uint8_t** out,
                   int64_t* nbytes) {
  if (!idx || !out || !nbytes || w <= 0 || h <= 0) return kErrArgs;
  std::vector<uint8_t> data{uint8_t(kLzwBits)};
  const std::vector<uint8_t> blocks =
      sub_blocks(lzw_codes(idx, w, h, interlace != 0), std::max(kMaxBlock, 4 * w));
  data.insert(data.end(), blocks.begin(), blocks.end());
  data.push_back(0);
  *out = static_cast<uint8_t*>(std::malloc(data.size()));
  if (!*out) return kErrArgs;
  std::memcpy(*out, data.data(), data.size());
  *nbytes = int64_t(data.size());
  return kOk;
}

void* fgpack_gif_open(const uint8_t* data, int64_t n, int* status) {
  auto* f = new GifFile;
  const int rc = scan(data, n, f);
  if (status) *status = rc;
  if (rc != kOk) {
    delete f;
    return nullptr;
  }
  return f;
}

// info: screen width, height, images (nb_frames), duration in hundredths,
// packets
int fgpack_gif_info(void* h, int64_t* info) {
  const auto* f = static_cast<GifFile*>(h);
  info[0] = f->width;
  info[1] = f->height;
  info[2] = f->images;
  info[3] = f->duration;
  info[4] = int64_t(f->offsets.size());
  return kOk;
}

int fgpack_gif_packets(void* h, int64_t* offsets, int64_t* sizes) {
  const auto* f = static_cast<GifFile*>(h);
  std::copy(f->offsets.begin(), f->offsets.end(), offsets);
  std::copy(f->sizes.begin(), f->sizes.end(), sizes);
  return kOk;
}

void fgpack_gif_close(void* h) { delete static_cast<GifFile*>(h); }

void* fgpack_gif_new() { return new GifDecoder; }

// out: [frame shown, width, height, 0]
int fgpack_gif_decode(void* h, const uint8_t* data, int64_t n, int64_t* out) {
  return static_cast<GifDecoder*>(h)->decode(data, n, out);
}

// the canvas as cv2 reads it with CAP_PROP_CONVERT_RGB = 0: H x W x 4 BGRA
int fgpack_gif_planes(void* h, uint8_t* bgra) {
  const auto* d = static_cast<GifDecoder*>(h);
  if (d->canvas.empty()) return kErrArgs;
  for (size_t i = 0; i < d->canvas.size(); i++) {
    const uint32_t v = d->canvas[i];
    bgra[4 * i] = uint8_t(v);
    bgra[4 * i + 1] = uint8_t(v >> 8);
    bgra[4 * i + 2] = uint8_t(v >> 16);
    bgra[4 * i + 3] = uint8_t(v >> 24);
  }
  return kOk;
}

// the canvas as BGR24 (swscale's BGRA -> BGR24 drops the alpha byte)
int fgpack_gif_bgr(void* h, uint8_t* bgr) {
  const auto* d = static_cast<GifDecoder*>(h);
  if (d->canvas.empty()) return kErrArgs;
  for (size_t i = 0; i < d->canvas.size(); i++) {
    const uint32_t v = d->canvas[i];
    bgr[3 * i] = uint8_t(v);
    bgr[3 * i + 1] = uint8_t(v >> 8);
    bgr[3 * i + 2] = uint8_t(v >> 16);
  }
  return kOk;
}

int fgpack_gif_stats(void* h, int64_t* out, int64_t n) {
  const auto* d = static_cast<GifDecoder*>(h);
  for (int64_t i = 0; i < n && i < kFeatures; i++) out[i] = d->stats[i];
  return kOk;
}

int fgpack_gif_error(void* h, char* buf, int64_t n) {
  const auto* d = static_cast<GifDecoder*>(h);
  if (n <= 0) return kErrArgs;
  std::snprintf(buf, size_t(n), "%s", d->error.c_str());
  return kOk;
}

void fgpack_gif_free(void* h) { delete static_cast<GifDecoder*>(h); }

}  // extern "C"
