// WebP's host decoders: lossless WebP (VP8L, RFC 9649) whole, and the
// entropy stage of lossy WebP (VP8 key frames, RFC 6386), whose pixel
// stage runs on the card (csrc/vp8_pixels.cu, kernels W1-W3).
//
// No TPU kernel is replaced: the JAX package reads images with PIL on the
// host (superviseddescent_tpu/ops/patches.py::load_gray_image), and PIL
// reads WebP with libwebp. The plain twin is io/webp.py::decode_vp8l; the
// container (RIFF, VP8X, the first ANMF frame) is parsed in io/webp.py,
// which hands this decoder the VP8L chunk's payload.
//
// The decoding is bit-serial, as libwebp's: the header; the transforms as
// the stream lists them (each one's sub-image decoded on the way); the
// main image through its meta prefix codes (the entropy image names the
// group of five prefix codes of each block), literals, LZ77 backward
// references (the 120-entry distance map) and the colour cache; then the
// transforms undone in reverse order (predictor, cross-colour,
// subtract-green, colour indexing with pixel bundling). Prefix codes
// decode through a 10-bit lookup table, longer codes by the canonical
// code's counts. Host code only, with a plain C interface: nvcc builds it
// with the kernels (ops/_build.py), and g++ builds the same file.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8_tables.h"

namespace {

enum Error {
  kOk = 0,
  kTruncated = 1,
  kBadHeader = 2,
  kTransformTwice = 3,
  kBadCode = 4,
  kBadReference = 5,
  kBadCache = 6,
  kTooLarge = 7
};

constexpr int kLengthCodes = 24, kDistanceCodes = 40, kMaxLength = 15;
constexpr int kRootBits = 10;
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
// RFC 9649 5.2.2: (x, y) of distance codes 1..120
constexpr int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

// Least significant bit first, a 64-bit window refilled a byte at a time.
struct Bits {
  const uint8_t* data;
  long len, pos = 0;  // pos: the next byte to load
  uint64_t window = 0;
  int have = 0;       // valid bits in the window
  long consumed = 0;  // bits taken

  void fill() {
    while (have <= 56) {
      const uint64_t b = pos < len ? data[pos] : 0;
      ++pos;
      window |= b << have;
      have += 8;
    }
  }
  uint32_t peek(int n) {
    if (have < n) fill();
    return (uint32_t)(window & ((1ull << n) - 1));
  }
  void skip(int n) {
    window >>= n;
    have -= n;
    consumed += n;
    if (consumed > 8 * len) throw (int)kTruncated;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

// A canonical prefix code: a kRootBits lookup (symbol, length) for codes
// up to that length, the canonical counts for longer ones; one used
// symbol takes no bits.
struct Code {
  int single = -1;
  int max_len = 0;
  std::vector<int32_t> root;  // symbol << 8 | length, 0: a longer code
  int count[kMaxLength + 1] = {0};
  std::vector<int> sorted;    // symbols by (length, symbol)

  int read(Bits& br) const {
    if (single >= 0) return single;
    const int rb = max_len < kRootBits ? max_len : kRootBits;
    const uint32_t e = root[br.peek(rb)];
    if (e) {
      br.skip(e & 0xFF);
      return (int)(e >> 8);
    }
    int code = 0, first = 0, index = 0;  // canonical decode, bit by bit
    for (int n = 1; n <= max_len; ++n) {
      code |= (int)br.read(1);
      const int c = count[n];
      if (code - first < c) return sorted[index + code - first];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    throw (int)kBadCode;
  }
};

uint32_t reverse_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1u) << (n - 1 - i);
  return r;
}

void build(const std::vector<int>& lengths, Code& c) {
  int used = 0, last = -1;
  for (size_t s = 0; s < lengths.size(); ++s)
    if (lengths[s]) {
      ++used;
      last = (int)s;
    }
  if (used == 0) throw (int)kBadCode;
  if (used == 1) {
    c.single = last;
    return;
  }
  // complete: the lengths' Kraft sum is exactly one
  uint64_t kraft = 0;
  for (int l : lengths)
    if (l) {
      kraft += 1ull << (kMaxLength - l);
      c.count[l]++;
      if (l > c.max_len) c.max_len = l;
    }
  if (kraft != 1ull << kMaxLength) throw (int)kBadCode;
  for (int n = 1; n <= kMaxLength; ++n)
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s] == n) c.sorted.push_back((int)s);
  const int rb = c.max_len < kRootBits ? c.max_len : kRootBits;
  c.root.assign(1u << rb, 0);
  int code = 0, k = 0;
  for (int n = 1; n <= c.max_len; ++n) {
    for (int i = 0; i < c.count[n]; ++i, ++k, ++code) {
      if (n > rb) continue;
      const uint32_t rev = reverse_bits((uint32_t)code, n);
      for (uint32_t j = rev; j < (1u << rb); j += 1u << n)
        c.root[j] = (uint32_t)c.sorted[k] << 8 | (uint32_t)n;
    }
    code <<= 1;
  }
}

void read_code(Bits& br, int alphabet, Code& c) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple
    const int n = (int)br.read(1) + 1;
    const int first = (int)br.read(1 + 7 * (int)br.read(1));
    if (first >= alphabet) throw (int)kBadCode;
    lengths[first] = 1;
    if (n == 2) {
      const int second = (int)br.read(8);
      if (second >= alphabet) throw (int)kBadCode;
      lengths[second] = 1;
    }
    build(lengths, c);
    return;
  }
  const int n = (int)br.read(4) + 4;
  std::vector<int> cl(19, 0);
  for (int i = 0; i < n; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
  Code lc;
  build(cl, lc);
  int max_symbol = alphabet;
  if (br.read(1)) {
    max_symbol = 2 + (int)br.read(2 + 2 * (int)br.read(3));
    if (max_symbol > alphabet) throw (int)kBadCode;
  }
  int symbol = 0, prev = 8;
  while (symbol < alphabet) {
    if (max_symbol-- == 0) break;
    const int v = lc.read(br);
    if (v < 16) {
      lengths[symbol++] = v;
      if (v) prev = v;
      continue;
    }
    static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
    const int repeat = (int)br.read(kExtra[v - 16]) + kOffset[v - 16];
    if (symbol + repeat > alphabet) throw (int)kBadCode;
    for (int i = 0; i < repeat; ++i) lengths[symbol++] = v == 16 ? prev : 0;
  }
  build(lengths, c);
}

int prefixed(Bits& br, int code) {
  if (code < 4) return code + 1;
  const int extra = (code - 2) >> 1;
  return ((2 + (code & 1)) << extra) + (int)br.read(extra) + 1;
}

int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// An entropy-coded image (with its meta prefix image where `meta`) ->
// width x height ARGB.
std::vector<uint32_t> entropy_image(Bits& br, int width, int height,
                                    bool meta) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) throw (int)kBadCache;
  }
  int prefix_bits = 0, groups_wide = 0;
  std::vector<uint32_t> groups_image;
  int n_groups = 1;
  if (meta && br.read(1)) {
    prefix_bits = (int)br.read(3) + 2;
    groups_wide = sub_size(width, prefix_bits);
    groups_image = entropy_image(br, groups_wide,
                                 sub_size(height, prefix_bits), false);
    for (uint32_t& g : groups_image) {
      g = (g >> 8) & 0xFFFF;
      if ((int)g + 1 > n_groups) n_groups = (int)g + 1;
    }
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<Code> codes((size_t)n_groups * 5);
  for (int g = 0; g < n_groups; ++g) {
    const int alphabets[5] = {256 + kLengthCodes + cache_size, 256, 256, 256,
                              kDistanceCodes};
    for (int k = 0; k < 5; ++k) read_code(br, alphabets[k], codes[g * 5 + k]);
  }
  const long total = (long)width * height;
  std::vector<uint32_t> out(total);
  std::vector<uint32_t> cache(cache_size);
  long at = 0, cached = 0;
  while (at < total) {
    const Code* g = codes.data();
    if (!groups_image.empty()) {
      const long y = at / width, x = at - y * width;
      g += (size_t)groups_image[(y >> prefix_bits) * groups_wide +
                                (x >> prefix_bits)] * 5;
    }
    const int s = g[0].read(br);
    if (s < 256) {
      const uint32_t r = (uint32_t)g[1].read(br);
      const uint32_t b = (uint32_t)g[2].read(br);
      const uint32_t a = (uint32_t)g[3].read(br);
      out[at++] = a << 24 | r << 16 | (uint32_t)s << 8 | b;
    } else if (s < 256 + kLengthCodes) {
      const int length = prefixed(br, s - 256);
      const int dcode = prefixed(br, g[4].read(br));
      long dist;
      if (dcode > 120) {
        dist = dcode - 120;
      } else {
        dist = kDistanceMap[dcode - 1][0] +
               (long)kDistanceMap[dcode - 1][1] * width;
        if (dist < 1) dist = 1;
      }
      if (dist > at || at + length > total) throw (int)kBadReference;
      for (int k = 0; k < length; ++k, ++at) out[at] = out[at - dist];
    } else {
      out[at] = cache[s - 256 - kLengthCodes];
      ++at;
    }
    if (cache_size)
      for (; cached < at; ++cached)
        cache[(0x1E35A7BDu * out[cached]) >> (32 - cache_bits)] = out[cached];
  }
  return out;
}

inline uint32_t average(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
}
inline int channel(uint32_t v, int shift) { return (int)((v >> shift) & 0xFF); }
inline int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t select(uint32_t left, uint32_t top, uint32_t top_left) {
  int pl = 0, pt = 0;  // distances of the estimate L + T - TL to L and T
  for (int s = 0; s < 32; s += 8) {
    pl += abs(channel(top, s) - channel(top_left, s));
    pt += abs(channel(left, s) - channel(top_left, s));
  }
  return pl < pt ? left : top;
}

uint32_t add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clamp255(channel(a, s) + channel(b, s) -
                              channel(c, s)) << s;
  return out;
}

uint32_t add_subtract_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = channel(a, s);
    out |= (uint32_t)clamp255(x + (x - channel(b, s)) / 2) << s;
  }
  return out;
}

uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tr,
                 uint32_t tl) {
  switch (mode) {
    case 1: return l;
    case 2: return t;
    case 3: return tr;
    case 4: return tl;
    case 5: return average(average(l, tr), t);
    case 6: return average(l, tl);
    case 7: return average(l, t);
    case 8: return average(tl, t);
    case 9: return average(t, tr);
    case 10: return average(average(l, tl), average(t, tr));
    case 11: return select(l, t, tl);
    case 12: return add_subtract_full(l, t, tl);
    case 13: return add_subtract_half(average(l, t), tl);
    default: return 0xFF000000u;  // 0, and 14 / 15 as libwebp
  }
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xFF00FF00u) + (b & 0xFF00FF00u);
  const uint32_t rb = (a & 0x00FF00FFu) + (b & 0x00FF00FFu);
  return (ag & 0xFF00FF00u) | (rb & 0x00FF00FFu);
}

void inverse_predictor(std::vector<uint32_t>& px, int w, int h, int bits,
                       const std::vector<uint32_t>& modes) {
  const int bw = sub_size(w, bits);
  for (int y = 0; y < h; ++y) {
    uint32_t* row = px.data() + (size_t)y * w;
    const uint32_t* up = row - w;
    for (int x = 0; x < w; ++x) {
      uint32_t pred;
      if (y == 0) {
        pred = x == 0 ? 0xFF000000u : row[x - 1];
      } else if (x == 0) {
        pred = up[0];
      } else {
        const int mode = (int)((modes[(y >> bits) * bw + (x >> bits)] >> 8) &
                               0xF);
        const uint32_t tr = x + 1 < w ? up[x + 1] : row[0];
        pred = predict(mode, row[x - 1], up[x], tr, up[x - 1]);
      }
      row[x] = add_pixels(row[x], pred);
    }
  }
}

inline int delta(int8_t t, int8_t c) { return ((int)t * (int)c) >> 5; }

void inverse_cross_colour(std::vector<uint32_t>& px, int w, int h, int bits,
                          const std::vector<uint32_t>& m) {
  const int bw = sub_size(w, bits);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const uint32_t e = m[(y >> bits) * bw + (x >> bits)];
      const int8_t g2r = (int8_t)(e & 0xFF), g2b = (int8_t)((e >> 8) & 0xFF),
                   r2b = (int8_t)((e >> 16) & 0xFF);
      uint32_t& p = px[(size_t)y * w + x];
      const int8_t green = (int8_t)((p >> 8) & 0xFF);
      int red = channel(p, 16), blue = channel(p, 0);
      red = (red + delta(g2r, green)) & 0xFF;
      blue = (blue + delta(g2b, green) + delta(r2b, (int8_t)red)) & 0xFF;
      p = (p & 0xFF00FF00u) | (uint32_t)red << 16 | (uint32_t)blue;
    }
}

void inverse_subtract_green(std::vector<uint32_t>& px) {
  for (uint32_t& p : px) {
    const uint32_t g = (p >> 8) & 0xFF;
    const uint32_t rb = ((p & 0x00FF00FFu) + (g << 16 | g)) & 0x00FF00FFu;
    p = (p & 0xFF00FF00u) | rb;
  }
}

std::vector<uint32_t> inverse_indexing(const std::vector<uint32_t>& px,
                                       int packed_w, int w, int h, int bits,
                                       const std::vector<uint32_t>& table) {
  uint32_t full[256] = {0};
  for (size_t i = 0; i < table.size(); ++i) full[i] = table[i];
  std::vector<uint32_t> out((size_t)w * h);
  const int depth = 8 >> bits, per = 1 << bits, mask = (1 << depth) - 1;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int g = (int)((px[(size_t)y * packed_w + (x >> bits)] >> 8) &
                          0xFF);
      out[(size_t)y * w + x] = full[(g >> ((x & (per - 1)) * depth)) & mask];
    }
  return out;
}

struct Transform {
  int kind, xsize, bits;
  std::vector<uint32_t> data;
};

}  // namespace

// A VP8L bitstream (the chunk's payload, `len` bytes) of width x height
// (the caller reads them from the header) -> out (width x height ARGB,
// host memory). Returns 0 or an io/webp.py ERRORS code.
extern "C" int webp_decode_vp8l(const uint8_t* data, int len, int width,
                                int height, uint32_t* out) {
  try {
    if (width < 1 || height < 1 || (long)width * height > (1l << 30))
      throw (int)kTooLarge;
    Bits br{data, len};
    if (br.read(8) != 0x2F) throw (int)kBadHeader;
    const int w = (int)br.read(14) + 1, h = (int)br.read(14) + 1;
    br.read(1);  // alpha hint
    if (br.read(3) != 0 || w != width || h != height) throw (int)kBadHeader;
    std::vector<Transform> transforms;
    int seen = 0, xsize = w;
    while (br.read(1)) {
      const int kind = (int)br.read(2);
      if (seen & (1 << kind)) throw (int)kTransformTwice;
      seen |= 1 << kind;
      Transform t{kind, xsize, 0, {}};
      if (kind == 0 || kind == 1) {
        t.bits = (int)br.read(3) + 2;
        t.data = entropy_image(br, sub_size(xsize, t.bits),
                               sub_size(h, t.bits), false);
      } else if (kind == 3) {
        const int size = (int)br.read(8) + 1;
        t.data = entropy_image(br, size, 1, false);
        for (int i = 1; i < size; ++i)
          t.data[i] = add_pixels(t.data[i], t.data[i - 1]);
        t.bits = size <= 2 ? 3 : size <= 4 ? 2 : size <= 16 ? 1 : 0;
        xsize = sub_size(xsize, t.bits);
      }
      transforms.push_back(std::move(t));
    }
    std::vector<uint32_t> px = entropy_image(br, xsize, h, true);
    for (int i = (int)transforms.size() - 1; i >= 0; --i) {
      const Transform& t = transforms[i];
      if (t.kind == 0) {
        inverse_predictor(px, t.xsize, h, t.bits, t.data);
      } else if (t.kind == 1) {
        inverse_cross_colour(px, t.xsize, h, t.bits, t.data);
      } else if (t.kind == 2) {
        inverse_subtract_green(px);
      } else {
        px = inverse_indexing(px, sub_size(t.xsize, t.bits), t.xsize, h,
                              t.bits, t.data);
      }
    }
    memcpy(out, px.data(), px.size() * sizeof(uint32_t));
  } catch (int err) {
    return err;
  } catch (...) {
    return kTooLarge;  // std::bad_alloc
  }
  return kOk;
}

// ---------------------------------------------------------------------
// VP8 key frames: the entropy stage. The plain twin is io/vp8.py's
// decode_vp8, which this follows step for step (libwebp's vp8_dec.c,
// tree_dec.c and quant_dec.c): the frame header, segmentation, the filter
// header, the token partitions, the quantisers, the coefficient
// probabilities, then per macroblock row its modes from the first
// partition and its tokens from partition (row & (partitions - 1)).
// Output, host memory: coeffs (MBs, 25, 16) int16, dequantised, raster
// order (Y2, 16 Y, 4 U, 4 V); modes (MBs, 20) uint8 (is 4x4, 16x16 mode,
// 16 sub-block modes, chroma mode, segment); filters (MBs, 4) uint8
// (limit, interior limit, hev threshold, inner edges); info int32[16] in
// io/vp8.py's INFO order. Returns 0 or an io/vp8.py ERRORS code.
// ---------------------------------------------------------------------
namespace {

enum Vp8Error {
  kVp8TruncatedHeader = 1,
  kVp8BadStartCode = 2,
  kVp8InterFrame = 3,
  kVp8BadFrameHeader = 4,
  kVp8BadPartitionLength = 5,
  kVp8HeaderEof = 6,
  kVp8NoPartitions = 7,
  kVp8ModesEof = 8,
  kVp8TokensEof = 9,
  kVp8TooLarge = 10
};

// RFC 6386's boolean decoder in libwebp's form: range kept less one, a
// byte loaded whenever fewer than 8 bits are left, eof once a decode
// needs a byte past the end.
struct BoolDecoder {
  const uint8_t* data = nullptr;
  long n = 0, pos = 0;
  uint64_t value = 0;
  int range = 254, bits = -8;
  bool eof = false;

  void init(const uint8_t* d, long len) {
    data = d;
    n = len;
    pos = 0;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (pos < n) {
      bits += 8;
      value = (value << 8) | data[pos++];
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
    int rng = range;
    const int split = (rng * prob) >> 8;
    int b;
    if ((int)(value >> bits) > split) {
      rng -= split;
      value -= (uint64_t)(split + 1) << bits;
      b = 1;
    } else {
      rng = split + 1;
      b = 0;
    }
    int shift = 0;
    while ((rng << shift) < 128) ++shift;
    bits -= shift;
    range = (rng << shift) - 1;
    return b;
  }
  int value_bits(int count) {
    int v = 0;
    while (count-- > 0) v = (v << 1) | bit(0x80);
    return v;
  }
  int signed_bits(int count) {
    const int v = value_bits(count);
    return bit(0x80) ? -v : v;
  }
  int optional_signed(int count) { return bit(0x80) ? signed_bits(count) : 0; }
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

Quant dequant(int q, const int dq[5]) {
  Quant m;
  m.y1[0] = vp8::kDcTable[clip_q(q + dq[0], 127)];
  m.y1[1] = vp8::kAcTable[clip_q(q, 127)];
  m.y2[0] = vp8::kDcTable[clip_q(q + dq[1], 127)] * 2;
  m.y2[1] = (vp8::kAcTable[clip_q(q + dq[2], 127)] * 101581) >> 16;
  if (m.y2[1] < 8) m.y2[1] = 8;
  m.uv[0] = vp8::kDcTable[clip_q(q + dq[3], 117)];
  m.uv[1] = vp8::kAcTable[clip_q(q + dq[4], 127)];
  return m;
}

using Band = const uint8_t (*)[11];  // one band's [context][node]

int large_value(BoolDecoder& br, const uint8_t* p) {
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) return 2;
    return 3 + br.bit(p[5]);
  }
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    const int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int bit0 = br.bit(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  static const uint8_t* const kCats[4] = {vp8::kCat3, vp8::kCat4, vp8::kCat5,
                                          vp8::kCat6};
  int v = 0;
  for (const uint8_t* tab = kCats[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

// One block's tokens from position n (libwebp's GetCoeffs); returns the
// count libwebp returns.
int block_coeffs(BoolDecoder& br, const Band* bands, int ctx,
                 const int dq[2], int n, int16_t* out) {
  const uint8_t* p = bands[n][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[++n][0];
      if (n == 16) return 16;
    }
    const Band next = bands[n + 1];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    if (br.bit(0x80)) v = -v;
    out[vp8::kZigzag[n]] = (int16_t)(v * dq[n > 0]);
  }
  return 16;
}

// libwebp's TransformWHT: does any of the Y blocks' DCs come out non-zero?
bool wht_nonzero(const int16_t* in) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    const int v[4] = {a0 + a1, a3 + a2, a0 - a1, a3 - a2};
    for (int k = 0; k < 4; ++k)
      if ((int16_t)(v[k] >> 3) != 0) return true;
  }
  return false;
}

}  // namespace

extern "C" int webp_decode_vp8(const uint8_t* data, int len, int mb_w,
                               int mb_h, int16_t* coeffs, uint8_t* modes,
                               uint8_t* filters, int32_t* info) {
  if (len < 10) return kVp8TruncatedHeader;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    return kVp8BadStartCode;
  const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
  if (tag & 1) return kVp8InterFrame;
  const int width = (data[6] | (data[7] << 8)) & 0x3FFF;
  const int height = (data[8] | (data[9] << 8)) & 0x3FFF;
  const long part0 = tag >> 5;
  if (((tag >> 1) & 7) > 3 || !((tag >> 4) & 1) || width == 0 ||
      height == 0 || part0 >= len)
    return kVp8BadFrameHeader;
  if (part0 > len - 10) return kVp8BadPartitionLength;
  if (mb_w != (width + 15) >> 4 || mb_h != (height + 15) >> 4 ||
      (long)mb_w * mb_h > (1l << 20))
    return kVp8TooLarge;
  BoolDecoder br;
  br.init(data + 10, part0);
  const uint8_t* rest = data + 10 + part0;
  const long rest_len = len - 10 - part0;
  const int colorspace = br.bit(0x80), clamp_type = br.bit(0x80);
  // segment header
  const int use_segment = br.bit(0x80);
  int update_map = 0, absolute = 1;
  int seg_q[4] = {0, 0, 0, 0}, seg_f[4] = {0, 0, 0, 0};
  int seg_proba[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      absolute = br.bit(0x80);
      for (int s = 0; s < 4; ++s) seg_q[s] = br.optional_signed(7);
      for (int s = 0; s < 4; ++s) seg_f[s] = br.optional_signed(6);
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        seg_proba[s] = br.bit(0x80) ? br.value_bits(8) : 255;
  }
  if (br.eof) return kVp8HeaderEof;
  // filter header
  const int simple = br.bit(0x80);
  const int level = br.value_bits(6);
  const int sharpness = br.value_bits(3);
  const int use_lf_delta = br.bit(0x80);
  int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.bit(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) ref_delta[i] = br.signed_bits(6);
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) mode_delta[i] = br.signed_bits(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return kVp8HeaderEof;
  // token partitions
  const int last = (1 << br.value_bits(2)) - 1;
  if (rest_len < 3 * last) return kVp8NoPartitions;
  BoolDecoder parts[8];
  long start = 3 * last, left = rest_len - 3 * last;
  for (int p = 0; p < last; ++p) {
    long size = rest[3 * p] | (rest[3 * p + 1] << 8) | (rest[3 * p + 2] << 16);
    if (size > left) size = left;
    parts[p].init(rest + start, size);
    start += size;
    left -= size;
  }
  parts[last].init(rest + start, rest_len - start);
  if (start >= rest_len) return kVp8NoPartitions;
  // quantisers
  const int base_q = br.value_bits(7);
  int dq[5];
  for (int i = 0; i < 5; ++i) dq[i] = br.optional_signed(4);
  Quant segq[4];
  for (int s = 0; s < 4; ++s)
    segq[s] = dequant(use_segment ? seg_q[s] + (absolute ? 0 : base_q)
                                  : base_q, dq);
  br.bit(0x80);  // update_proba: ignored
  uint8_t proba[4][8][3][11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = br.bit(vp8::kCoeffsUpdateProba[t][b][c][p])
                                  ? (uint8_t)br.value_bits(8)
                                  : vp8::kCoeffsProba0[t][b][c][p];
  Band bands[4][17];
  for (int t = 0; t < 4; ++t)
    for (int n = 0; n < 17; ++n) bands[t][n] = proba[t][vp8::kBands[n]];
  const int use_skip = br.bit(0x80);
  const int skip_p = use_skip ? br.value_bits(8) : 0;
  // filter strengths [segment][is 4x4]: limit, interior limit, hev
  int strength[4][2][3];
  for (int s = 0; s < 4; ++s) {
    const int base = use_segment ? seg_f[s] + (absolute ? 0 : level) : level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int lv = base;
      if (use_lf_delta) lv += ref_delta[0] + (i4 ? mode_delta[0] : 0);
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      int* out = strength[s][i4];
      if (lv == 0) {
        out[0] = out[1] = out[2] = 0;
        continue;
      }
      int ilevel = lv;
      if (sharpness > 0) {
        ilevel >>= sharpness > 4 ? 2 : 1;
        if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
      }
      if (ilevel < 1) ilevel = 1;
      out[0] = 2 * lv + ilevel;
      out[1] = ilevel;
      out[2] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
    }
  }
  const int32_t header[16] = {width, height, mb_w, mb_h, filter_type,
                              last + 1, use_segment, update_map, absolute,
                              use_skip, colorspace, clamp_type, data[7] >> 6,
                              data[9] >> 6, sharpness, use_lf_delta};
  memcpy(info, header, sizeof(header));
  const long n_mb = (long)mb_w * mb_h;
  memset(coeffs, 0, n_mb * 25 * 16 * sizeof(int16_t));
  memset(modes, 0, n_mb * 20);
  memset(filters, 0, n_mb * 4);
  std::vector<uint8_t> intra_t(4 * mb_w, 0), nz_top(mb_w, 0),
      nz_dc_top(mb_w, 0), skips(mb_w, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // the row's modes, from the first partition
    uint8_t intra_l[4] = {0, 0, 0, 0};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      uint8_t* m = modes + ((long)mb_y * mb_w + mb_x) * 20;
      int segment = 0;
      if (update_map)
        segment = !br.bit(seg_proba[0]) ? br.bit(seg_proba[1])
                                        : br.bit(seg_proba[2]) + 2;
      skips[mb_x] = use_skip ? br.bit(skip_p) : 0;
      const int is4 = !br.bit(145);
      uint8_t* top = &intra_t[4 * mb_x];
      if (!is4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? 1 : 3)
                                      : (br.bit(163) ? 2 : 0);
        m[1] = (uint8_t)ymode;
        for (int k = 0; k < 16; ++k) m[2 + k] = (uint8_t)ymode;
        for (int k = 0; k < 4; ++k) top[k] = intra_l[k] = (uint8_t)ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = vp8::kBModesProba[top[x]][ymode];
            int i = vp8::kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = vp8::kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            top[x] = (uint8_t)ymode;
          }
          memcpy(m + 2 + 4 * y, top, 4);
          intra_l[y] = (uint8_t)ymode;
        }
      }
      m[0] = (uint8_t)is4;
      m[18] = !br.bit(142) ? 0 : !br.bit(114) ? 2 : br.bit(183) ? 1 : 3;
      m[19] = (uint8_t)segment;
    }
    if (br.eof) return kVp8ModesEof;
    // the row's tokens, from its partition
    BoolDecoder& tbr = parts[mb_y & last];
    uint32_t nz_left = 0, nz_dc_left = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const long i = (long)mb_y * mb_w + mb_x;
      const uint8_t* m = modes + i * 20;
      const int is4 = m[0], segment = m[19];
      int inner = 0;
      if (!skips[mb_x]) {
        const Quant& q = segq[segment];
        int16_t* out = coeffs + i * 400;
        int first;
        const Band* ac;
        if (!is4) {
          const int ctx = nz_dc_top[mb_x] + nz_dc_left;
          const int nz = block_coeffs(tbr, bands[1], ctx, q.y2, 0, out);
          nz_dc_top[mb_x] = nz_dc_left = nz > 0;
          first = 1;
          ac = bands[0];
        } else {
          first = 0;
          ac = bands[3];
        }
        // coded: a count past 1 or a non-zero DC in any block (a 16x16
        // macroblock's DCs from its WHT), libwebp's non_zero_y / _uv
        bool coded = !is4 && wht_nonzero(out);
        uint32_t tnz = nz_top[mb_x] & 0x0F, lnz = nz_left & 0x0F;
        for (int y = 0; y < 4; ++y) {
          uint32_t l = lnz & 1;
          for (int x = 0; x < 4; ++x) {
            int16_t* o = out + 16 * (1 + 4 * y + x);
            const int nz = block_coeffs(tbr, ac, l + (tnz & 1), q.y1, first,
                                        o);
            l = nz > first;
            tnz = (tnz >> 1) | (l << 7);
            coded |= nz > 1 || o[0] != 0;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = nz_top[mb_x] >> (4 + ch);
          lnz = nz_left >> (4 + ch);
          for (int y = 0; y < 2; ++y) {
            uint32_t l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              int16_t* o = out + 16 * (17 + 2 * ch + 2 * y + x);
              const int nz = block_coeffs(tbr, bands[2], l + (tnz & 1), q.uv,
                                          0, o);
              l = nz > 0;
              tnz = (tnz >> 1) | (l << 3);
              coded |= nz > 1 || o[0] != 0;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          out_t |= (tnz << 4) << ch;
          out_l |= (lnz & 0xF0) << ch;
        }
        nz_top[mb_x] = (uint8_t)out_t;
        nz_left = out_l;
        inner = coded;
      } else {
        nz_top[mb_x] = 0;
        nz_left = 0;
        if (!is4) nz_dc_top[mb_x] = nz_dc_left = 0;
      }
      if (filter_type) {
        const int* st = strength[segment][is4];
        uint8_t* f = filters + i * 4;
        f[0] = (uint8_t)st[0];
        f[1] = (uint8_t)st[1];
        f[2] = (uint8_t)st[2];
        f[3] = (uint8_t)(is4 ? 1 : inner);
      }
    }
    if (tbr.eof) return kVp8TokensEof;
  }
  return kOk;
}
