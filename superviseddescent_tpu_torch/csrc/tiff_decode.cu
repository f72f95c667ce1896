// TIFF's host decoders of CCITT bilevel coding (compressions 2, 3 and 4:
// modified Huffman, T.4 and T.6) and of Zstandard (compression 50000, RFC
// 8878 frames), as libtiff decodes them for PIL.
//
// No TPU kernel is replaced: the JAX package reads images with PIL on the
// host (superviseddescent_tpu/ops/patches.py::load_gray_image), and PIL
// reads TIFF with libtiff. The plain twins are io/ccitt.py::decode_ccitt
// and io/zstd.py::read_strip; io/tiff.py parses the file and hands these
// decoders one strip or tile at a time (its bytes already in fill order
// 1), then unpacks the samples as it does for the other compressions.
//
// CCITT: rows of bits, ones black, each row's runs read through 13-bit
// lookups (7-bit for the two-dimensional modes) and its changes coded
// against the row above. Zstandard: one frame (or one skippable frame)
// from the start of the strip, as one pass of libtiff's
// ZSTD_decompressStream reads it: FSE and Huffman tables, literals and
// sequences, the repeat offsets carried across the frame's blocks, the
// blocks read until the strip is full, and a frame read whole held to its
// content size and XXH64 checksum. Both are bit-serial. Host code only, with a
// plain C interface: nvcc builds it with the kernels (ops/_build.py), and
// g++ builds the same file.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- CCITT
enum CcittError {
  kCcittTruncated = 1,
  kCcittBadRun = 2,
  kCcittBadMode = 3,
  kCcittPastWidth = 4,
  kCcittLeftOfBefore = 5,
  kCcittNoEol = 6,
  kCcittUncompressed = 7,
  kCcittEolInRow = 8,
  kCcittBadKind = 9
};

// T.4 tables 2 and 3 (as io/ccitt.py): run length -> code, by colour
const char* const kWhiteCodes[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",
    "1110",     "1111",     "10011",    "10100",    "00111",    "01000",
    "001000",   "000011",   "110100",   "110101",   "101010",   "101011",
    "0100111",  "0001100",  "0001000",  "0010111",  "0000011",  "0000100",
    "0101000",  "0101011",  "0010011",  "0100100",  "0011000",  "00000010",
    "00000011", "00011010", "00011011", "00010010", "00010011", "00010100",
    "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100",
    "00100101", "01011000", "01011001", "01011010", "01011011", "01001010",
    "01001011", "00110010", "00110011", "00110100"};
const char* const kWhiteMakeup[27] = {
    "11011",     "10010",     "010111",    "0110111",   "00110110",
    "00110111",  "01100100",  "01100101",  "01101000",  "01100111",
    "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001",
    "011011010", "011011011", "010011000", "010011001", "010011010",
    "011000",    "010011011"};
const char* const kBlackCodes[64] = {
    "0000110111",   "010",          "11",           "10",
    "011",          "0011",         "0010",         "00011",
    "000101",       "000100",       "0000100",      "0000101",
    "0000111",      "00000100",     "00000111",     "000011000",
    "0000010111",   "0000011000",   "0000001000",   "00001100111",
    "00001101000",  "00001101100",  "00000110111",  "00000101000",
    "00000010111",  "00000011000",  "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001",
    "000001101010", "000001101011", "000011010010", "000011010011",
    "000011010100", "000011010101", "000011010110", "000011010111",
    "000001101100", "000001101101", "000011011010", "000011011011",
    "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011",
    "000000100100", "000000110111", "000000111000", "000000100111",
    "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
const char* const kBlackMakeup[27] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",
    "000000110011",  "000000110100",  "000000110101",  "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtendedMakeup[13] = {
    "00000001000",  "00000001100",  "00000001101",  "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};
const char* const kEol = "000000000001";
constexpr int kRunBits = 13, kModeBits = 7;
constexpr int kTerminating = 0, kMakeup = 1, kEolCode = 2;
constexpr int kPass = 100, kHorizontal = 101, kExtension = 102;

struct RunEntry {
  uint8_t used, kind;
  uint16_t run;
};
struct ModeEntry {
  uint8_t used;
  int8_t mode;
};

struct CcittTables {
  RunEntry runs[2][1 << kRunBits];
  ModeEntry modes[1 << kModeBits];

  static void put(RunEntry* table, const char* code, int kind, int run) {
    const int n = (int)strlen(code);
    const int lo = (int)strtol(code, nullptr, 2) << (kRunBits - n);
    for (int i = 0; i < (1 << (kRunBits - n)); ++i)
      table[lo + i] = RunEntry{(uint8_t)n, (uint8_t)kind, (uint16_t)run};
  }
  CcittTables() {
    memset(runs, 0, sizeof(runs));
    memset(modes, 0, sizeof(modes));
    for (int c = 0; c < 2; ++c) {
      const char* const* codes = c ? kBlackCodes : kWhiteCodes;
      const char* const* makeup = c ? kBlackMakeup : kWhiteMakeup;
      for (int r = 0; r < 64; ++r) put(runs[c], codes[r], kTerminating, r);
      for (int i = 0; i < 27; ++i) put(runs[c], makeup[i], kMakeup, 64 * (i + 1));
      for (int i = 0; i < 13; ++i)
        put(runs[c], kExtendedMakeup[i], kMakeup, 1792 + 64 * i);
      put(runs[c], kEol, kEolCode, 0);
    }
    const struct {
      const char* code;
      int mode;
    } mode_codes[10] = {{"1", 0},         {"011", 1},   {"000011", 2},
                        {"0000011", 3},   {"010", -1},  {"000010", -2},
                        {"0000010", -3},  {"0001", kPass - 128},
                        {"001", kHorizontal - 128},
                        {"0000001", kExtension - 128}};
    for (const auto& m : mode_codes) {
      const int n = (int)strlen(m.code);
      const int lo = (int)strtol(m.code, nullptr, 2) << (kModeBits - n);
      for (int i = 0; i < (1 << (kModeBits - n)); ++i)
        modes[lo + i] = ModeEntry{(uint8_t)n, (int8_t)m.mode};
    }
  }
};

const CcittTables& ccitt_tables() {
  static const CcittTables tables;
  return tables;
}

// most significant bit of each byte first; peeks past the end read zeros
struct MsbBits {
  const uint8_t* data;
  int64_t len, pos = 0, end;
  MsbBits(const uint8_t* d, int64_t n) : data(d), len(n), end(8 * n) {}
  uint32_t peek(int n) const {
    uint32_t v = 0;
    const int64_t byte = pos >> 3;
    for (int k = 0; k < 4; ++k)
      v = (v << 8) | (byte + k < len ? data[byte + k] : 0u);
    return (v >> (32 - (pos & 7) - n)) & ((1u << n) - 1);
  }
  void skip(int n) {
    pos += n;
    if (pos > end) throw (int)kCcittTruncated;
  }
};

int read_run(MsbBits& bits, int colour) {
  const RunEntry* table = ccitt_tables().runs[colour];
  int total = 0;
  for (;;) {
    const RunEntry& e = table[bits.peek(kRunBits)];
    if (!e.used) throw (int)(bits.pos < bits.end ? kCcittBadRun : kCcittTruncated);
    if (e.kind == kEolCode) throw (int)kCcittEolInRow;
    bits.skip(e.used);
    total += e.run;
    if (e.kind == kTerminating) return total;
  }
}

void row_1d(MsbBits& bits, int width, std::vector<int>& changes) {
  int a0 = 0, colour = 0;
  while (a0 < width) {
    a0 += read_run(bits, colour);
    if (a0 > width) throw (int)kCcittPastWidth;
    changes.push_back(a0);
    colour ^= 1;
  }
}

// ref: the row above's changes, ending in three at width
void row_2d(MsbBits& bits, int width, const std::vector<int>& ref,
            std::vector<int>& changes) {
  const ModeEntry* modes = ccitt_tables().modes;
  int a0 = -1, colour = 0;
  size_t i = 0;
  while (a0 < width) {
    while (ref[i] <= a0 || (int)(i & 1) != colour) ++i;
    const int b1 = ref[i], b2 = ref[i + 1];
    const ModeEntry& e = modes[bits.peek(kModeBits)];
    if (!e.used) throw (int)(bits.pos < bits.end ? kCcittBadMode : kCcittTruncated);
    bits.skip(e.used);
    const int m = e.mode;
    if (m == kPass - 128) {
      a0 = b2;
    } else if (m == kHorizontal - 128) {
      const int start = a0 > 0 ? a0 : 0;
      const int a1 = start + read_run(bits, colour);
      const int a2 = a1 + read_run(bits, colour ^ 1);
      if (a2 > width) throw (int)kCcittPastWidth;
      changes.push_back(a1);
      changes.push_back(a2);
      a0 = a2;
    } else if (m == kExtension - 128) {
      throw (int)kCcittUncompressed;
    } else {
      const int a1 = b1 + m, lo = a0 > 0 ? a0 : 0;
      if (a1 < lo || a1 > width)
        throw (int)(a1 < lo ? kCcittLeftOfBefore : kCcittPastWidth);
      changes.push_back(a1);
      a0 = a1;
      colour ^= 1;
      if (i > 0) --i;
    }
  }
}

// libtiff's SYNC_EOL; false (nothing read) where the data holds no eleven
// zeros
bool find_eol(MsbBits& bits) {
  const int64_t start = bits.pos;
  while (bits.peek(11) != 0) {
    if (bits.pos + 12 > bits.end) {
      bits.pos = start;
      return false;
    }
    ++bits.pos;
  }
  while (bits.peek(1) == 0) bits.skip(1);
  bits.skip(1);
  return true;
}

// ------------------------------------------------------------ Zstandard
enum ZstdError {
  kZTruncated = 1,
  kZBadHeader = 2,
  kZDictionary = 3,
  kZBadBlock = 4,
  kZBadLiterals = 5,
  kZBadHuffman = 6,
  kZBadFse = 7,
  kZBadSequences = 8,
  kZOffsetBeforeFrame = 9,
  kZChecksum = 10,
  kZNoFrame = 11,
  kZContentSize = 12
};

constexpr uint32_t kMagic = 0xFD2FB528u, kSkippable = 0x184D2A50u;
constexpr int64_t kMaxBlock = 1 << 17;
constexpr int kMaxHuffmanBits = 11;
// RFC 8878 3.1.1.3.2.1.1: (baseline, extra bits) of each code
constexpr uint32_t kLlBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLlBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMlBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMlBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
// RFC 8878 3.1.1.3.2.2: the predefined distributions
constexpr int16_t kLlDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMlDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOfDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, -1, -1, -1, -1, -1};
// (largest symbol, largest accuracy log) of LL, OF, ML and Huffman weights
constexpr int kLimits[4][2] = {{35, 9}, {31, 8}, {52, 9}, {255, 6}};

// little-endian, read from the first byte (FSE table descriptions)
struct ForwardBits {
  const uint8_t* data;
  int64_t len, bit;
  uint32_t peek(int n) const {
    uint32_t v = 0;
    const int64_t byte = bit >> 3;
    for (int k = 3; k >= 0; --k)
      v = (v << 8) | (byte + k < len ? data[byte + k] : 0u);
    return (v >> (bit & 7)) & ((1u << n) - 1);
  }
};

// read from the last bit toward the first after the start marker; reads
// past the start give zeros (pos below 0: overflowed)
struct BackwardBits {
  const uint8_t* data;
  int64_t len, pos;
  BackwardBits(const uint8_t* d, int64_t n) : data(d), len(n) {
    if (n <= 0) throw (int)kZBadBlock;
    if (d[n - 1] == 0) throw (int)kZBadSequences;
    int top = 7;
    while (!((d[n - 1] >> top) & 1)) --top;
    pos = 8 * n - 8 + top;
  }
  uint64_t peek(int n) const {
    const int64_t lo = pos - n;
    if (pos <= 0) return 0;
    // the bytes holding bits [max(lo, 0), pos)
    const int64_t first = lo > 0 ? lo >> 3 : 0, last = (pos - 1) >> 3;
    uint64_t v = 0;
    for (int64_t k = last; k >= first; --k) v = (v << 8) | data[k];
    if (lo >= 0) return (v >> (lo & 7)) & ((1ull << n) - 1);
    return (v & ((1ull << pos) - 1)) << -lo;
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    const uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

struct Fse {
  int log = 0;
  std::vector<uint16_t> symbol, base;
  std::vector<uint8_t> bits;

  void rle(int s) {
    log = 0;
    symbol.assign(1, (uint16_t)s);
    base.assign(1, 0);
    bits.assign(1, 0);
  }
  void build(int accuracy, const std::vector<int>& counts) {
    const int size = 1 << accuracy;
    log = accuracy;
    symbol.assign(size, 0);
    base.assign(size, 0);
    bits.assign(size, 0);
    std::vector<int> next(counts);
    int high = size - 1;
    for (size_t s = 0; s < counts.size(); ++s)
      if (counts[s] == -1) {
        symbol[high--] = (uint16_t)s;
        next[s] = 1;
      }
    const int step = (size >> 1) + (size >> 3) + 3;
    int pos = 0;
    for (size_t s = 0; s < counts.size(); ++s)
      for (int k = 0; k < counts[s]; ++k) {
        symbol[pos] = (uint16_t)s;
        pos = (pos + step) & (size - 1);
        while (pos > high) pos = (pos + step) & (size - 1);
      }
    if (pos != 0) throw (int)kZBadFse;
    for (int u = 0; u < size; ++u) {
      const int s = symbol[u];
      const int n = next[s]++;
      int top = 31;
      while (!((n >> top) & 1)) --top;
      const int b = accuracy - top;
      bits[u] = (uint8_t)b;
      base[u] = (uint16_t)((n << b) - size);
    }
  }
};

// zstd's FSE_readNCount: returns the bytes used
int64_t read_counts(const uint8_t* data, int64_t len, int which, int* log,
                    std::vector<int>& counts) {
  const int max_symbol = kLimits[which][0], max_log = kLimits[which][1];
  ForwardBits bits{data, len, 0};
  const int64_t end = 8 * len;
  *log = (int)bits.peek(4) + 5;
  bits.bit += 4;
  if (*log > max_log) throw (int)kZBadFse;
  int remaining = (1 << *log) + 1, threshold = 1 << *log, nb = *log + 1;
  bool previous0 = false;
  counts.clear();
  while (remaining > 1 && (int)counts.size() <= max_symbol) {
    if (previous0) {
      int n = 0;
      while (bits.peek(2) == 3) {
        n += 3;
        bits.bit += 2;
      }
      n += (int)bits.peek(2);
      bits.bit += 2;
      counts.insert(counts.end(), n, 0);
      if ((int)counts.size() > max_symbol + 1) throw (int)kZBadFse;
      if ((int)counts.size() > max_symbol) break;
    }
    const int top = 2 * threshold - 1 - remaining;
    const int v = (int)bits.peek(nb);
    int count;
    if ((v & (threshold - 1)) < top) {
      count = v & (threshold - 1);
      bits.bit += nb - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= top;
      bits.bit += nb;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    counts.push_back(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
    if (bits.bit > end) throw (int)kZTruncated;
  }
  if (remaining != 1 || (int)counts.size() > max_symbol + 1) throw (int)kZBadFse;
  return (bits.bit + 7) / 8;
}

struct Huffman {
  int bits = 0;
  std::vector<uint8_t> symbol, length;

  void build(std::vector<int> weights) {
    int64_t total = 0;
    int top = 0;
    for (int w : weights) {
      if (w) total += 1ll << (w - 1);
      if (w > top) top = w;
    }
    if (!total || total > (1 << kMaxHuffmanBits) || top > kMaxHuffmanBits)
      throw (int)kZBadHuffman;
    int b = 0;
    while ((1ll << b) <= total) ++b;  // total's bit length
    const int64_t left = (1ll << b) - total;
    if (left & (left - 1)) throw (int)kZBadHuffman;
    int last = 0;
    while ((1ll << last) <= left) ++last;
    weights.push_back(last);
    if (b > kMaxHuffmanBits || weights.size() > 256) throw (int)kZBadHuffman;
    bits = b;
    symbol.assign(1 << b, 0);
    length.assign(1 << b, 0);
    int pos = 0;
    for (int w = 1; w <= b; ++w)
      for (size_t s = 0; s < weights.size(); ++s)
        if (weights[s] == w) {
          const int span = 1 << (w - 1);
          for (int k = 0; k < span; ++k) {
            symbol[pos + k] = (uint8_t)s;
            length[pos + k] = (uint8_t)(b + 1 - w);
          }
          pos += span;
        }
  }
  void decode(const uint8_t* stream, int64_t n, uint8_t* out,
              int64_t count) const {
    BackwardBits br(stream, n);
    for (int64_t i = 0; i < count; ++i) {
      const uint64_t v = br.peek(bits);
      out[i] = symbol[v];
      br.pos -= length[v];
    }
    if (br.pos != 0) throw (int)kZBadLiterals;
  }
};

// a Huffman tree description: fills the weights, returns the bytes used
int64_t read_weights(const uint8_t* data, int64_t len,
                     std::vector<int>& out) {
  if (len < 1) throw (int)kZTruncated;
  const int head = data[0];
  out.clear();
  if (head >= 128) {
    const int n = head - 127, used = (n + 1) / 2;
    if (1 + used > len) throw (int)kZTruncated;
    for (int i = 0; i < n; ++i)
      out.push_back((data[1 + i / 2] >> ((i & 1) ? 0 : 4)) & 15);
    return 1 + used;
  }
  if (1 + head > len || head == 0)
    throw (int)(1 + head > len ? kZTruncated : kZBadHuffman);
  const uint8_t* body = data + 1;
  int log;
  std::vector<int> counts;
  const int64_t used = read_counts(body, head, 3, &log, counts);
  Fse table;
  table.build(log, counts);
  BackwardBits br(body + used, head - used);
  int states[2] = {(int)br.read(log), (int)br.read(log)};
  int k = 0;
  for (;;) {
    const int s = states[k];
    out.push_back(table.symbol[s]);
    states[k] = table.base[s] + (int)br.read(table.bits[s]);
    if (br.pos < 0) {
      out.push_back(table.symbol[states[k ^ 1]]);
      break;
    }
    k ^= 1;
    if (out.size() > 255) throw (int)kZBadHuffman;
  }
  return 1 + head;
}

struct FrameState {
  Huffman huffman;
  bool has_huffman = false;
  Fse tables[3];  // LL, OF, ML
  bool has_table[3] = {false, false, false};
  uint64_t reps[3] = {1, 4, 8};
};

// the literals section: fills lits, returns the bytes used
int64_t read_literals(const uint8_t* block, int64_t len, FrameState& st,
                      std::vector<uint8_t>& lits) {
  const int b0 = block[0], kind = b0 & 3, fmt = (b0 >> 2) & 3;
  const int need[4] = {1, 2, 1, 3};
  if (len < need[fmt] + (kind == 1)) throw (int)kZTruncated;
  if (kind < 2) {
    int64_t size;
    int head;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      head = 1;
    } else if (fmt == 1) {
      size = (b0 >> 4) + (block[1] << 4);
      head = 2;
    } else {
      size = (b0 >> 4) + (block[1] << 4) + ((int64_t)block[2] << 12);
      head = 3;
    }
    if (size > kMaxBlock) throw (int)kZBadLiterals;
    if (kind == 0) {
      if (head + size > len) throw (int)kZTruncated;
      lits.assign(block + head, block + head + size);
      return head + size;
    }
    if (head >= len) throw (int)kZTruncated;
    lits.assign(size, block[head]);
    return head + 1;
  }
  const int heads[4] = {3, 3, 4, 5}, widths[4] = {10, 10, 14, 18};
  const int head = heads[fmt], width = widths[fmt];
  if (len < head) throw (int)kZTruncated;
  uint64_t h = 0;
  for (int k = head - 1; k >= 0; --k) h = (h << 8) | block[k];
  const int64_t size = (int64_t)((h >> 4) & ((1ull << width) - 1));
  const int64_t comp = (int64_t)((h >> (4 + width)) & ((1ull << width) - 1));
  const int streams = fmt == 0 ? 1 : 4;
  if (size > kMaxBlock || head + comp > len)
    throw (int)(size > kMaxBlock ? kZBadLiterals : kZTruncated);
  const uint8_t* body = block + head;
  int64_t used = 0;
  if (kind == 2) {
    std::vector<int> weights;
    used = read_weights(body, comp, weights);
    st.huffman.build(weights);
    st.has_huffman = true;
  } else if (!st.has_huffman) {
    throw (int)kZBadLiterals;
  }
  body += used;
  const int64_t n = comp - used;
  lits.assign(size, 0);
  if (streams == 1) {
    st.huffman.decode(body, n, lits.data(), size);
    return head + comp;
  }
  if (n < 6) throw (int)kZTruncated;
  const int64_t s1 = body[0] | (body[1] << 8), s2 = body[2] | (body[3] << 8),
                s3 = body[4] | (body[5] << 8);
  const int64_t rest = n - 6 - s1 - s2 - s3;
  if (rest < 0) throw (int)kZBadLiterals;
  const int64_t part = (size + 3) / 4;
  if (3 * part > size) throw (int)kZBadLiterals;
  const int64_t sizes[4] = {s1, s2, s3, rest};
  int64_t at = 6, o = 0;
  for (int k = 0; k < 4; ++k) {
    const int64_t count = k < 3 ? part : size - 3 * part;
    st.huffman.decode(body + at, sizes[k], lits.data() + o, count);
    at += sizes[k];
    o += count;
  }
  return head + comp;
}

int64_t read_table(const uint8_t* block, int64_t len, int64_t pos, int mode,
                   int which, FrameState& st) {
  // which: 0 LL, 1 OF, 2 ML
  if (mode == 0) {
    const int16_t* def = which == 0 ? kLlDefault : which == 1 ? kOfDefault : kMlDefault;
    const int n = which == 0 ? 36 : which == 1 ? 29 : 53;
    st.tables[which].build(which == 1 ? 5 : 6, std::vector<int>(def, def + n));
  } else if (mode == 1) {
    if (pos >= len) throw (int)kZTruncated;
    if (block[pos] > kLimits[which][0]) throw (int)kZBadSequences;
    st.tables[which].rle(block[pos]);
    ++pos;
  } else if (mode == 2) {
    int log;
    std::vector<int> counts;
    pos += read_counts(block + pos, len - pos, which, &log, counts);
    st.tables[which].build(log, counts);
  } else if (!st.has_table[which]) {
    throw (int)kZBadSequences;
  }
  st.has_table[which] = true;
  return pos;
}

struct Sequence {
  uint32_t lit, match;
  uint64_t offset;
};

void read_sequences(const uint8_t* block, int64_t len, int64_t pos,
                    FrameState& st, std::vector<Sequence>& out) {
  out.clear();
  if (pos >= len) throw (int)kZTruncated;
  const int b0 = block[pos];
  int64_t n;
  if (b0 == 0) {
    if (pos + 1 != len) throw (int)kZBadSequences;
    return;
  }
  if (b0 < 128) {
    n = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 1 >= len) throw (int)kZTruncated;
    n = ((b0 - 128) << 8) + block[pos + 1];
    pos += 2;
  } else {
    if (pos + 2 >= len) throw (int)kZTruncated;
    n = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  if (pos >= len) throw (int)kZTruncated;
  const int modes = block[pos++];
  if (modes & 3) throw (int)kZBadSequences;
  pos = read_table(block, len, pos, (modes >> 6) & 3, 0, st);
  pos = read_table(block, len, pos, (modes >> 4) & 3, 1, st);
  pos = read_table(block, len, pos, (modes >> 2) & 3, 2, st);
  const Fse &ll = st.tables[0], &of = st.tables[1], &ml = st.tables[2];
  BackwardBits br(block + pos, len - pos);
  int s_ll = (int)br.read(ll.log), s_of = (int)br.read(of.log),
      s_ml = (int)br.read(ml.log);
  for (int64_t i = 0; i < n; ++i) {
    const int code_of = of.symbol[s_of], code_ll = ll.symbol[s_ll],
              code_ml = ml.symbol[s_ml];
    if (code_of > 31) throw (int)kZBadSequences;
    Sequence q;
    q.offset = (1ull << code_of) + br.read(code_of);
    q.match = kMlBase[code_ml] + (uint32_t)br.read(kMlBits[code_ml]);
    q.lit = kLlBase[code_ll] + (uint32_t)br.read(kLlBits[code_ll]);
    out.push_back(q);
    if (i + 1 < n) {
      s_ll = ll.base[s_ll] + (int)br.read(ll.bits[s_ll]);
      s_ml = ml.base[s_ml] + (int)br.read(ml.bits[s_ml]);
      s_of = of.base[s_of] + (int)br.read(of.bits[s_of]);
    }
    if (br.pos < 0) throw (int)kZBadSequences;
  }
  if (br.pos != 0) throw (int)kZBadSequences;
}

// fails before a block grows past kMaxBlock bytes
void execute(std::vector<uint8_t>& out, size_t frame_start,
             const std::vector<uint8_t>& lits,
             const std::vector<Sequence>& seqs, FrameState& st) {
  uint64_t* reps = st.reps;
  size_t at = 0;
  const size_t end = out.size() + kMaxBlock;
  for (const Sequence& q : seqs) {
    if (at + q.lit > lits.size()) throw (int)kZBadSequences;
    if (out.size() + q.lit + q.match > end) throw (int)kZBadBlock;
    out.insert(out.end(), lits.begin() + at, lits.begin() + at + q.lit);
    at += q.lit;
    uint64_t offset;
    if (q.offset > 3) {
      offset = q.offset - 3;
      reps[2] = reps[1];
      reps[1] = reps[0];
      reps[0] = offset;
    } else {
      const int k = (int)q.offset - (q.lit != 0);
      if (k == 0) {
        offset = reps[0];
      } else if (k == 1) {
        offset = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      } else if (k == 2) {
        offset = reps[2];
        reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      } else {
        offset = reps[0] - 1;
        if (offset == 0) throw (int)kZBadSequences;
        reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      }
    }
    if (offset > out.size() - frame_start) throw (int)kZOffsetBeforeFrame;
    const size_t start = out.size() - offset;
    for (uint32_t j = 0; j < q.match; ++j) out.push_back(out[start + j]);
  }
  out.insert(out.end(), lits.begin() + at, lits.end());
}

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t p1 = 0x9E3779B185EBCA87ull, p2 = 0xC2B2AE3D27D4EB4Full,
                 p3 = 0x165667B19E3779F9ull, p4 = 0x85EBCA77C2B2AE63ull,
                 p5 = 0x27D4EB2F165667C5ull;
  auto lane = [&](size_t i) {
    uint64_t v;
    memcpy(&v, p + i, 8);
    return v;
  };
  auto round = [&](uint64_t acc, uint64_t input) {
    return rotl(acc + input * p2, 31) * p1;
  };
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {p1 + p2, p2, 0, 0 - p1};
    for (; i + 32 <= n; i += 32)
      for (int k = 0; k < 4; ++k) v[k] = round(v[k], lane(i + 8 * k));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int k = 0; k < 4; ++k) h = (h ^ round(0, v[k])) * p1 + p4;
  } else {
    h = p5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) h = rotl(h ^ round(0, lane(i)), 27) * p1 + p4;
  if (i + 4 <= n) {
    uint32_t k;
    memcpy(&k, p + i, 4);
    h = rotl(h ^ (k * p1), 23) * p2 + p3;
    i += 4;
  }
  for (; i < n; ++i) h = rotl(h ^ (p[i] * p5), 11) * p1;
  h ^= h >> 33;
  h *= p2;
  h ^= h >> 29;
  h *= p3;
  return h ^ (h >> 32);
}

uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// one frame after its magic at data[pos], appended to out; its blocks
// stop once they hold `limit` bytes (the rest unread), as libtiff's pass
// stops with its strip full
void read_frame(const uint8_t* data, int64_t len, int64_t pos,
                std::vector<uint8_t>& out, int64_t limit) {
  if (pos >= len) throw (int)kZTruncated;
  const int fhd = data[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) throw (int)kZBadHeader;
  if (dict_flag) throw (int)kZDictionary;
  if (!single) {
    if (pos >= len) throw (int)kZTruncated;
    const int log = 10 + (data[pos++] >> 3);
    if (log > 41) throw (int)kZBadHeader;
  }
  const int fcs_sizes[4] = {single ? 1 : 0, 2, 4, 8};
  const int fcs_size = fcs_sizes[fcs_flag];
  if (pos + fcs_size > len) throw (int)kZTruncated;
  uint64_t fcs = 0;
  for (int k = fcs_size - 1; k >= 0; --k) fcs = (fcs << 8) | data[pos + k];
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;
  const size_t start = out.size();
  FrameState st;
  std::vector<uint8_t> lits;
  std::vector<Sequence> seqs;
  for (;;) {
    if (pos + 3 > len) throw (int)kZTruncated;
    const uint32_t h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16);
    pos += 3;
    const int last = h & 1, kind = (h >> 1) & 3;
    const int64_t size = h >> 3;
    if (kind == 3) throw (int)kZBadBlock;
    if (kind == 1) {
      if (pos >= len) throw (int)kZTruncated;
      if (size > kMaxBlock) throw (int)kZBadBlock;
      out.insert(out.end(), size, data[pos]);
      ++pos;
    } else {
      if (size > kMaxBlock || pos + size > len)
        throw (int)(size > kMaxBlock ? kZBadBlock : kZTruncated);
      const uint8_t* block = data + pos;
      pos += size;
      if (kind == 0) {
        out.insert(out.end(), block, block + size);
      } else {
        if (size == 0) throw (int)kZBadBlock;
        const size_t before = out.size();
        const int64_t used = read_literals(block, size, st, lits);
        read_sequences(block, size, used, st, seqs);
        execute(out, start, lits, seqs, st);
        if ((int64_t)(out.size() - before) > kMaxBlock) throw (int)kZBadBlock;
      }
    }
    if (last) break;
    if ((int64_t)(out.size() - start) >= limit) return;
  }
  if (fcs_size && out.size() - start != fcs) throw (int)kZContentSize;
  if (checksum) {
    if (pos + 4 > len) throw (int)kZTruncated;
    if ((uint32_t)xxh64(out.data() + start, out.size() - start) !=
        le32(data + pos))
      throw (int)kZChecksum;
  }
}

}  // namespace

// One strip or tile of CCITT compression `kind` (2, 3 or 4; bytes in fill
// order 1) -> `rows` rows of (width + 7) / 8 bytes, ones black. `options`:
// T4Options (compression 3) or T6Options. 0, or an error code of
// io/ccitt.py's ERRORS.
extern "C" int tiff_ccitt_decode(const uint8_t* data, int64_t len, int kind,
                                 int options, int width, int rows,
                                 uint8_t* out) {
  try {
    if (width < 1 || rows < 0 || kind < 2 || kind > 4) throw (int)kCcittBadKind;
    const int64_t row_bytes = (width + 7) / 8;
    memset(out, 0, (size_t)(row_bytes * rows));
    MsbBits bits(data, len);
    std::vector<int> ref(3, width), changes;
    bool eols = true;
    for (int y = 0; y < rows; ++y) {
      changes.clear();
      if (kind == 2) {
        row_1d(bits, width, changes);
        bits.pos = (bits.pos + 7) / 8 * 8;
      } else if (kind == 3) {
        if ((y == 0 || eols) && !find_eol(bits)) {
          if (y) throw (int)kCcittNoEol;
          eols = false;
        }
        bool one_d = true;
        if (options & 1) {
          one_d = bits.peek(1) != 0;
          bits.skip(1);
        }
        if (one_d)
          row_1d(bits, width, changes);
        else
          row_2d(bits, width, ref, changes);
      } else {
        row_2d(bits, width, ref, changes);
      }
      if (changes.size() & 1) changes.push_back(width);
      uint8_t* row = out + row_bytes * y;
      for (size_t k = 0; k + 1 < changes.size(); k += 2) {
        const int end = changes[k + 1] < width ? changes[k + 1] : width;
        for (int x = changes[k]; x < end; ++x)
          row[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
      }
      ref.clear();
      for (int c : changes)
        if (c < width) ref.push_back(c);
      ref.insert(ref.end(), 3, width);
    }
    return 0;
  } catch (int e) {
    return e;
  }
}

// A strip or tile's first Zstandard frame (or skippable frame) -> its
// first `size` bytes in `out`; `produced` the frame's whole content
// length. 0, or an error code of io/zstd.py's ERRORS.
extern "C" int tiff_zstd_decode(const uint8_t* data, int64_t len,
                                uint8_t* out, int64_t size,
                                int64_t* produced) {
  try {
    *produced = 0;
    if (len < 4) throw (int)kZNoFrame;
    const uint32_t magic = le32(data);
    std::vector<uint8_t> content;
    if (magic == kMagic) {
      read_frame(data, len, 4, content, size);
    } else if ((magic & 0xFFFFFFF0u) == kSkippable) {
      if (len < 8) throw (int)kZTruncated;
      if (8 + (int64_t)le32(data + 4) > len) throw (int)kZTruncated;
    } else {
      throw (int)kZNoFrame;
    }
    const int64_t n = (int64_t)content.size();
    memcpy(out, content.data(), (size_t)(n < size ? n : size));
    *produced = n;
    return 0;
  } catch (int e) {
    return e;
  }
}
