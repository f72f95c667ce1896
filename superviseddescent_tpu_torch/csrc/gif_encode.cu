// GIF writing's pixel work on the host, as PIL 12.1 does it: libImaging's
// median-cut quantiser (Quant.c, method 0, 256 colours, no k-means) and
// its LZW coder (GifEncode.c, minimum code size 8).
//
// No TPU kernel is replaced: the JAX package writes images with PIL on the
// host (superviseddescent_tpu/apps/rcr_detect.py saves its drawing through
// Image.save). The plain twins are io/gif_quant.py::quantize and
// io/gif_write.py::lzw_codes / pack_codes; io/gif_write.py keeps the
// palette optimisation and the header and drives this file
// (encode_gif(..., native=True)).
//
// gif_quantize: the distinct colours, their count held at 65,536 by
// dropping low bits of every channel; the median cut over the scaled
// colours with a max-heap by pixel count, 255 splits along the axis of the
// largest range weighted 77 / 150 / 29; each leaf's entry the rounded mean
// of its original pixels; each distinct colour mapped to the nearest entry
// through the sorted distance tables, its own leaf's entry kept on a tie.
// gif_lzw_encode: 12-bit LZW, LSB first, a Clear first and where the table
// would pass 4,095 codes, rows in interlaced order where asked, packed in
// sub-blocks of 255 bytes with the terminator. Host code only, with a
// plain C interface: nvcc builds it with the kernels (ops/_build.py), and
// g++ builds the same file.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxHashEntries = 65536;
constexpr int kColours = 256;
constexpr int kMinCodeSize = 8;
constexpr int kMaxCodes = 4096;

struct Box {
  std::vector<uint32_t> members;  // indices of scaled colours
  uint64_t count = 0;
  int volume = 0;
  int left = -1, right = -1;
};

inline uint32_t channel(uint32_t c, int k) {
  return (c >> (16 - 8 * k)) & 255;
}

int volume_of(const std::vector<uint32_t>& members,
              const std::vector<uint32_t>& scaled) {
  int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
  for (uint32_t m : members)
    for (int k = 0; k < 3; ++k) {
      int v = channel(scaled[m], k);
      lo[k] = std::min(lo[k], v);
      hi[k] = std::max(hi[k], v);
    }
  return (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
}

// libImaging's ImagingQuantHeapAdd / Remove: 1-based, max by pixel count
struct Heap {
  std::vector<int> a{-1};
  const std::vector<Box>* boxes;
  long long cmp(int x, int y) const {
    return (long long)(*boxes)[x].count - (long long)(*boxes)[y].count;
  }
  void add(int b) {
    a.push_back(-1);
    size_t k = a.size() - 1;
    while (k != 1) {
      if (cmp(b, a[k / 2]) <= 0) break;
      a[k] = a[k / 2];
      k >>= 1;
    }
    a[k] = b;
  }
  int remove() {
    if (a.size() == 1) return -1;
    int top = a[1];
    int v = a.back();
    a.pop_back();
    size_t n = a.size() - 1;
    if (n == 0) return top;
    size_t k = 1;
    while (k * 2 <= n) {
      size_t c = k * 2;
      if (c < n && cmp(a[c], a[c + 1]) < 0) ++c;
      if (cmp(v, a[c]) > 0) break;
      a[k] = a[c];
      k = c;
    }
    a[k] = v;
    return top;
  }
};

void split(std::vector<Box>& boxes, int b, const std::vector<uint32_t>& scaled,
           const std::vector<uint64_t>& counts) {
  std::vector<uint32_t> m = boxes[b].members;
  int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
  for (uint32_t i : m)
    for (int k = 0; k < 3; ++k) {
      int v = channel(scaled[i], k);
      lo[k] = std::min(lo[k], v);
      hi[k] = std::max(hi[k], v);
    }
  const int weight[3] = {77, 150, 29};
  int axis = 0, best = (hi[0] - lo[0]) * weight[0];
  for (int k = 1; k < 3; ++k)
    if (best < (hi[k] - lo[k]) * weight[k]) {
      best = (hi[k] - lo[k]) * weight[k];
      axis = k;
    }
  std::stable_sort(m.begin(), m.end(), [&](uint32_t x, uint32_t y) {
    return channel(scaled[x], axis) > channel(scaled[y], axis);
  });
  const uint64_t total = boxes[b].count;
  size_t n = m.size(), k = 0;
  uint64_t left = 0;
  for (; k < n; ++k) {
    left += counts[m[k]];
    if (left * 2 > total) break;
  }
  if (k == n) k = n - 1;
  uint32_t v = channel(scaled[m[k]], axis);
  size_t n_left = k + 1;
  while (n_left < n && channel(scaled[m[n_left]], axis) == v) ++n_left;
  if (n_left == n) {  // nothing on the right: the smallest values go there
    uint32_t t = channel(scaled[m[n - 1]], axis);
    while (n_left > 0 && channel(scaled[m[n_left - 1]], axis) == t) --n_left;
  }
  Box l, r;
  l.members.assign(m.begin(), m.begin() + n_left);
  r.members.assign(m.begin() + n_left, m.end());
  for (uint32_t i : l.members) l.count += counts[i];
  for (uint32_t i : r.members) r.count += counts[i];
  l.volume = volume_of(l.members, scaled);
  r.volume = volume_of(r.members, scaled);
  boxes[b].left = (int)boxes.size();
  boxes[b].right = (int)boxes.size() + 1;
  boxes.push_back(std::move(l));
  boxes.push_back(std::move(r));
}

inline uint32_t dist(const uint8_t* a, const uint8_t* b) {
  int d0 = (int)a[0] - b[0], d1 = (int)a[1] - b[1], d2 = (int)a[2] - b[2];
  return (uint32_t)(d0 * d0 + d1 * d1 + d2 * d2);
}

struct BitSink {
  std::vector<uint8_t> raw;
  uint32_t acc = 0;
  int nbits = 0;
  void put(int code, int width) {
    acc |= (uint32_t)code << nbits;
    nbits += width;
    while (nbits >= 8) {
      raw.push_back(acc & 0xFF);
      acc >>= 8;
      nbits -= 8;
    }
  }
};

}  // namespace

extern "C" {

// rgb: n packed pixels (3 bytes each). Writes the palette (3 bytes an
// entry, at most 256) and each pixel's index; returns the entry count.
int gif_quantize(const uint8_t* rgb, int64_t n, uint8_t* palette,
                 uint8_t* index) {
  if (n <= 0) return 0;
  std::vector<uint32_t> packed(n);
  for (int64_t i = 0; i < n; ++i)
    packed[i] = (uint32_t)rgb[3 * i] << 16 | (uint32_t)rgb[3 * i + 1] << 8 |
                rgb[3 * i + 2];
  std::vector<uint32_t> distinct(packed);
  std::sort(distinct.begin(), distinct.end());
  distinct.erase(std::unique(distinct.begin(), distinct.end()),
                 distinct.end());
  const size_t nd = distinct.size();
  std::vector<uint32_t> of_pixel(n);
  std::vector<uint64_t> pix_count(nd, 0);
  for (int64_t i = 0; i < n; ++i) {
    of_pixel[i] = (uint32_t)(std::lower_bound(distinct.begin(),
                                              distinct.end(), packed[i]) -
                             distinct.begin());
    ++pix_count[of_pixel[i]];
  }
  // the scale: bits dropped until at most 65,536 colours remain
  auto scaled_of = [](uint32_t c, int s) {
    return ((c >> 16 & 255) >> s) << 16 | ((c >> 8 & 255) >> s) << 8 |
           ((c & 255) >> s);
  };
  int s = 0;
  std::vector<uint32_t> scaled;
  for (;; ++s) {
    scaled.clear();
    for (uint32_t c : distinct) scaled.push_back(scaled_of(c, s));
    std::sort(scaled.begin(), scaled.end());
    scaled.erase(std::unique(scaled.begin(), scaled.end()), scaled.end());
    if (scaled.size() <= (size_t)kMaxHashEntries) break;
  }
  std::vector<uint32_t> cls(nd);
  std::vector<uint64_t> counts(scaled.size(), 0);
  for (size_t i = 0; i < nd; ++i) {
    cls[i] = (uint32_t)(std::lower_bound(scaled.begin(), scaled.end(),
                                         scaled_of(distinct[i], s)) -
                        scaled.begin());
    counts[cls[i]] += pix_count[i];
  }
  // median cut
  std::vector<Box> boxes;
  boxes.reserve(2 * kColours);
  Box root;
  root.members.resize(scaled.size());
  for (size_t i = 0; i < scaled.size(); ++i) root.members[i] = (uint32_t)i;
  root.count = (uint64_t)n;
  root.volume = volume_of(root.members, scaled);
  boxes.push_back(std::move(root));
  Heap heap;
  heap.boxes = &boxes;
  heap.add(0);
  for (int step = 0; step < kColours - 1; ++step) {
    int b;
    do {
      b = heap.remove();
    } while (b >= 0 && boxes[b].volume == 1);
    if (b < 0) break;
    split(boxes, b, scaled, counts);
    heap.add(boxes[b].left);
    heap.add(boxes[b].right);
  }
  std::vector<int> leaf_of(scaled.size());
  int entries = 0;
  std::vector<int> stack{0};
  while (!stack.empty()) {
    int b = stack.back();
    stack.pop_back();
    if (boxes[b].left < 0) {
      for (uint32_t m : boxes[b].members) leaf_of[m] = entries;
      ++entries;
    } else {
      stack.push_back(boxes[b].right);
      stack.push_back(boxes[b].left);
    }
  }
  // each entry: the rounded mean of its original pixels
  std::vector<uint32_t> sum(3 * entries, 0), num(entries, 0);
  for (size_t i = 0; i < nd; ++i) {
    int e = leaf_of[cls[i]];
    for (int k = 0; k < 3; ++k)
      sum[3 * e + k] += (uint32_t)(channel(distinct[i], k) * pix_count[i]);
    num[e] += (uint32_t)pix_count[i];
  }
  for (int e = 0; e < entries; ++e)
    for (int k = 0; k < 3; ++k)
      palette[3 * e + k] =
          (uint8_t)(int)(.5 + (double)sum[3 * e + k] / (double)num[e]);
  // the distance tables, each row sorted by distance then index
  std::vector<uint32_t> between((size_t)entries * entries);
  std::vector<uint16_t> order((size_t)entries * entries);
  for (int i = 0; i < entries; ++i)
    for (int j = 0; j < entries; ++j)
      between[(size_t)i * entries + j] = dist(palette + 3 * i,
                                              palette + 3 * j);
  for (int i = 0; i < entries; ++i) {
    uint16_t* row = &order[(size_t)i * entries];
    const uint32_t* d = &between[(size_t)i * entries];
    for (int j = 0; j < entries; ++j) row[j] = (uint16_t)j;
    std::stable_sort(row, row + entries,
                     [d](uint16_t x, uint16_t y) { return d[x] < d[y]; });
  }
  std::vector<uint8_t> of_distinct(nd);
  for (size_t i = 0; i < nd; ++i) {
    const uint8_t c[3] = {(uint8_t)channel(distinct[i], 0),
                          (uint8_t)channel(distinct[i], 1),
                          (uint8_t)channel(distinct[i], 2)};
    int own = leaf_of[cls[i]];
    uint32_t best = dist(palette + 3 * own, c), reach = best << 2;
    int match = own;
    const uint16_t* row = &order[(size_t)own * entries];
    const uint32_t* d = &between[(size_t)own * entries];
    for (int j = 0; j < entries; ++j) {
      if (d[row[j]] > reach) break;
      uint32_t e = dist(palette + 3 * row[j], c);
      if (e < best) {
        best = e;
        match = row[j];
      }
    }
    of_distinct[i] = (uint8_t)match;
  }
  for (int64_t i = 0; i < n; ++i) index[i] = of_distinct[of_pixel[i]];
  return entries;
}

// index: h x w palette indices. Writes the LZW data as sub-blocks with
// the terminator; returns its length, or -1 when cap is too small.
int gif_lzw_encode(const uint8_t* index, int h, int w, int interlace,
                   uint8_t* out, int64_t cap) {
  std::vector<int> rows;
  if (interlace) {
    const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; ++p)
      for (int y = start[p]; y < h; y += step[p]) rows.push_back(y);
  } else {
    for (int y = 0; y < h; ++y) rows.push_back(y);
  }
  const int clear = 1 << kMinCodeSize, first = clear + 2;
  // the table: (prefix code << 8 | byte) -> code, valid in its generation
  std::vector<uint16_t> code_of((size_t)kMaxCodes << 8);
  std::vector<uint32_t> gen_of((size_t)kMaxCodes << 8, 0);
  uint32_t gen = 1;
  int width = kMinCodeSize + 1, limit = 1 << width, next = first;
  BitSink sink;
  sink.raw.reserve((size_t)h * w + 64);
  sink.put(clear, width);
  const int64_t total = (int64_t)h * w;
  if (total == 0) {
    sink.put(clear + 1, width);
  } else {
    int head = index[(size_t)rows[0] * w];
    for (int64_t i = 1; i < total; ++i) {
      const int tail = index[(size_t)rows[i / w] * w + i % w];
      const size_t key = (size_t)head << 8 | tail;
      if (gen_of[key] == gen) {
        head = code_of[key];
        continue;
      }
      sink.put(head, width);
      if (next < kMaxCodes) {
        gen_of[key] = gen;
        code_of[key] = (uint16_t)next;
        if (next >= limit) {
          ++width;
          limit <<= 1;
        }
        ++next;
      } else {
        sink.put(clear, width);
        ++gen;
        width = kMinCodeSize + 1;
        limit = 1 << width;
        next = first;
      }
      head = tail;
    }
    sink.put(head, width);
    sink.put(clear + 1, width);
  }
  if (sink.nbits) sink.raw.push_back(sink.acc & 0xFF);
  const size_t nraw = sink.raw.size();
  const int64_t need = (int64_t)nraw + (int64_t)(nraw + 254) / 255 + 1;
  if (need > cap) return -1;
  int64_t o = 0;
  for (size_t i = 0; i < nraw; i += 255) {
    const size_t len = std::min<size_t>(255, nraw - i);
    out[o++] = (uint8_t)len;
    std::memcpy(out + o, sink.raw.data() + i, len);
    o += (int64_t)len;
  }
  out[o++] = 0;
  return (int)o;
}

}  // extern "C"
