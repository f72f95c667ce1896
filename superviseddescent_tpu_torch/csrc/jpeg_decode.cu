// JPEG decoding: the host entropy decoder and kernel J1, the pixel stage on
// the card.
//
// No TPU kernel is replaced: the JAX package reads images with PIL on the
// host (superviseddescent_tpu/ops/patches.py::load_gray_image). This is
// the port's own decoder, for frames that are decoded where they are used.
// The plain twins are io/jpeg.py::entropy_decode (the entropy decoder) and
// io/jpeg.py::pixels_reference (J1); the wrapper is ops/jpeg.py.
//
// Entropy decoding is bit-serial and stays on the host, as libjpeg does
// it: jpeg_entropy_decode takes every scan of a file in one call (a
// sequential frame's one or more scans, or a progressive frame's scans),
// splits each at its restart markers, removes the byte stuffing and
// decodes each interval by the scan's procedure: sequential, or T.81 Annex
// G's DC first, DC refinement, AC first and AC refinement, with Huffman
// codes (a 9-bit lookahead table and the canonical slow path; EOB runs,
// correction bits) or arithmetic codes (Annex D's decoder and libjpeg's
// jdarith.c procedures, statistics per table, DAC's conditioning). Every
// scan writes into one array of int16 coefficients in natural order, the
// caller's (pinned) buffer, zeroed once; a progressive frame left
// unrefined is then block-smoothed as libjpeg-turbo 3.x smooths it. A
// lossless (SOF3) frame's differences are undifferenced as jddiffct.c
// does it, into uint8 samples in the same 8 x 8 block layout. Built with
// -DJPEG_DECODE_HOST_ONLY, the source is this host half alone (g++ builds
// it for the CPU tests).
//
// J1 is one launch of jpeg_pixels_kernel (jpeg_pixels_launch), one
// instantiation per colour space and source (coefficients, or a lossless
// frame's samples through jpeg_samples_launch, which skip the quantisers
// and the IDCT): one CTA per tile of MCUs (ops/jpeg.
// J1_TILE: MCU rows and columns, threads), a row of the grid per image
// where a batch of images of one geometry and one table set comes in one
// launch (a JPEG-compressed TIFF's strips), nothing between the phases
// leaving shared memory:
//   1. the components' quantisers into shared memory (cp.async through the
//      L1: every CTA reads the same 1 KB, which from the L2 alone would
//      be a hot spot);
//   2. transform: each component's tile with one block of halo on each
//      side its triangle filter reads across (h2v1, h2v2: left and right;
//      h1v2, h2v2: above and below), in one list of blocks. Each group of
//      eight threads walks its blocks of the list: each thread loads one
//      16-byte row of the group's next block while the group transforms
//      the current one from its slot in shared memory, so a CTA's loads
//      stream under its transforms rather than come first as one burst;
//      dequantise one column each (int32 products, the component's latched
//      table), libjpeg's jidctint islow pass 1 on it into shared memory,
//      pass 2 on one row, the range_limit lookup (values wrapped by
//      RANGE_MASK, not clamped) and one 8-byte store into the component's
//      plane in shared memory. (A shortcut for blocks whose AC coefficients
//      are all 0, 38% of luma and 85% of chroma blocks in the 768 x 1024
//      test clip, measured no faster: the loads, not the passes, set the
//      time.) The halo's blocks are loaded and
//      transformed again by each tile that reads them: at a tile of 2 x 4
//      MCUs of 4:2:0, 4 x 6 blocks of each chroma component for its 8, 80
//      blocks in all for 48 (a thread-block cluster that takes the rows
//      above and below from its neighbours' shared memory read fewer bytes
//      but was slower on the card: the clusters start up to 1 us apart and
//      wait for each other, PERF.md);
//   3. colour: a thread per eight neighbouring output pixels of a row reads
//      each of the up to four components as libjpeg-turbo's jdsample.c
//      upsamples it (as it is; h2v1 / h2v2 triangle filters with their
//      +1/+2 and +8/+7 biases where the component is more than two samples
//      wide; the h1v2 filter with +1/+2; else replication by whole ratios;
//      edge samples replicated), the eight pixels sharing their samples,
//      converts the colour (YCbCr -> RGB with jdcolor.c's fixed-point
//      factors; RGB as it is; CMYK and YCCK as PIL reads them, inverted,
//      then PIL's CMYK -> RGB) and writes RGB or OpenCV's grey of it (a
//      1-component image: Y itself) into the tile staged in shared memory;
//   4. stores: the tile's rows go out in 16-byte stores where the image's
//      rows are 16-byte aligned (8- or 4-byte, else bytes).
// Measurement builds: -DJPEG_DECODE_LAUNCH_ONLY returns at once,
// -DJPEG_DECODE_STAGE_ONLY only loads the blocks (phase 2 without its
// transform, then stops), -DJPEG_DECODE_SKIP_STORE leaves out phase 4 (both
// keep the work they do), -DJPEG_DECODE_TIMELINE records each CTA's phases
// on the global timer.
//
// What bounds J1 on this card: bytes (the int16 coefficients read once,
// 2.4 MB at 1024 x 768 4:2:0, and the output written once); its operations
// are ~1 k integer operations per block and ~40 per pixel. Tensor cores do
// not fit: islow rounds between its passes (and descales each output on
// its own), which a matrix product cannot do, and the dequantised int16
// products overflow int8 operands. Everything is integer, so the kernel's
// bits equal the twin's and libjpeg-turbo's.

#ifndef JPEG_DECODE_HOST_ONLY
#include <cuda_runtime.h>
#endif
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

namespace {

// ----------------------------------------------------------------- host
enum Error {
  kOk = 0,
  kTruncated = 1,
  kBadCode = 2,
  kBadRestart = 3,
  kStrayMarker = 4,
  kBadIndex = 5,
  kEobRun = 6,
  kBadProgression = 7,
  kBadLosslessRestart = 8,
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookahead = 9;
constexpr int kPad = 8;  // zero bytes after each interval's data
constexpr int kMaxComps = 4;
constexpr int kHeader = 12;      // see jpeg_entropy_decode
constexpr int kCompParams = 32;
constexpr int kScanParams = 32;
constexpr int kSmoothCoefs = 10;  // libjpeg smooths the first ten

struct HuffTable {
  uint16_t fast[1 << kLookahead];  // length << 8 | symbol, 0: slow path
  int32_t maxcode[17];             // largest code of each length, -1: none
  int32_t valoffset[17];
  uint8_t vals[256];
};

// bits[16], vals[256] as DHT holds them (validated by io/jpeg.py)
void build_table(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
  memset(t, 0, sizeof(*t));
  memcpy(t->vals, vals, 256);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    const int n = bits[len - 1];
    t->valoffset[len] = k - code;
    for (int i = 0; i < n; ++i, ++code, ++k) {
      if (len <= kLookahead) {
        const int lo = code << (kLookahead - len);
        for (int j = 0; j < (1 << (kLookahead - len)); ++j)
          t->fast[lo + j] = (uint16_t)(len << 8 | vals[k]);
      }
    }
    t->maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
}

// MSB-first bits of one un-stuffed restart interval, refilled to more
// than 56 bits whenever fewer than 32 are left (as io/jpeg.py's _Bits).
// Errors are thrown as their code and caught by jpeg_entropy_decode.
struct Bits {
  const uint8_t* data;
  long len, pos = 0;
  uint64_t buf = 0;
  int nbits = 0;
  // reads zeros past the interval's end; throws once it would pass kPad
  // of them: the interval is truncated
  void fill() {
    if (nbits >= 32) return;
    while (nbits <= 56) {
      if (pos >= len + kPad) throw (int)kTruncated;
      buf = (buf << 8) | (pos < len ? data[pos] : 0);
      ++pos;
      nbits += 8;
    }
  }
  int symbol(const HuffTable& t) {
    fill();
    const int p = (int)((buf >> (nbits - 16)) & 0xFFFF);
    const int e = t.fast[p >> (16 - kLookahead)];
    if (e) {
      nbits -= e >> 8;
      return e & 0xFF;
    }
    for (int len = kLookahead + 1; len <= 16; ++len) {
      const int code = p >> (16 - len);
      if (code <= t.maxcode[len]) {
        nbits -= len;
        return t.vals[code + t.valoffset[len]];
      }
    }
    throw (int)kBadCode;
  }
  int get(int s) {  // s (0..16) raw bits
    fill();
    nbits -= s;
    return (int)((buf >> nbits) & ((1u << s) - 1));
  }
  int extended(int s) {  // HUFF_EXTEND of s raw bits
    const int v = get(s);
    return s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  long consumed() const { return 8 * pos - nbits; }
};

inline int16_t wrap16(long long v) { return (int16_t)(uint16_t)(v & 0xFFFF); }

struct Scan {
  int ns, ss, se, ah, al, restart;
  int comp[kMaxComps];
};

struct Unit {  // one block of an MCU
  int k, base, v, h, nbx;
  const HuffTable* dc;
  const HuffTable* ac;
};

// a correction bit for a nonzero coefficient (AC refinement)
inline void refine(int16_t& c, int p1, int m1, Bits& br) {
  if (br.get(1) && !(c & p1)) c = wrap16(c + (c >= 0 ? p1 : m1));
}

// the MCUs [first, last) of one restart interval; returns the EOB run left
long decode_interval(Bits& br, bool progressive, const Scan& s, long first,
                     long last, long mcux, const std::vector<Unit>& units,
                     int16_t* coef) {
  long long pred[kMaxComps] = {0, 0, 0, 0};
  long eobrun = 0;
  const int p1 = 1 << s.al, m1 = -(1 << s.al);
  for (long mcu = first; mcu < last; ++mcu) {
    const long my = mcu / mcux, mx = mcu % mcux;
    for (const Unit& u : units) {
      int16_t* blk = coef + (u.base + my * u.v * u.nbx + mx * u.h) * 64;
      if (!progressive || (s.ss == 0 && s.ah == 0)) {  // a DC value
        const int t = br.symbol(*u.dc);
        pred[u.k] += t ? br.extended(t) : 0;
        blk[0] = wrap16(pred[u.k] * (1LL << s.al));
        if (progressive) continue;
        for (int k = 1; k < 64;) {
          const int rs = br.symbol(*u.ac);
          const int r = rs >> 4, z = rs & 15;
          if (z) {
            k += r;
            if (k > 63) throw (int)kBadIndex;
            blk[kZigzag[k]] = (int16_t)br.extended(z);
            ++k;
          } else if (r == 15) {
            k += 16;
          } else {
            break;
          }
        }
      } else if (s.ss == 0) {  // DC refinement
        if (br.get(1)) blk[0] = (int16_t)(blk[0] | p1);
      } else if (s.ah == 0) {  // AC first
        if (eobrun) {
          --eobrun;
          continue;
        }
        for (int k = s.ss; k <= s.se; ++k) {
          const int rs = br.symbol(*u.ac);
          const int r = rs >> 4, z = rs & 15;
          if (z) {
            k += r;
            if (k > s.se) throw (int)kBadIndex;
            blk[kZigzag[k]] = wrap16((long long)br.extended(z) * (1 << s.al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1L << r) + (r ? br.get(r) : 0) - 1;
            break;
          }
        }
      } else {  // AC refinement
        int k = s.ss;
        if (!eobrun) {
          for (; k <= s.se; ++k) {
            const int rs = br.symbol(*u.ac);
            int r = rs >> 4, z = rs & 15;
            if (z) {
              if (z != 1) throw (int)kBadCode;
              z = br.get(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = (1L << r) + (r ? br.get(r) : 0);
              break;
            }
            // pass r zero coefficients, and every nonzero one on the way,
            // which takes a correction bit
            for (; k <= s.se; ++k) {
              int16_t& c = blk[kZigzag[k]];
              if (c) {
                refine(c, p1, m1, br);
              } else if (r == 0) {
                break;
              } else {
                --r;
              }
            }
            if (z) {
              if (k > s.se) throw (int)kBadIndex;
              blk[kZigzag[k]] = (int16_t)z;
            }
          }
        }
        if (eobrun) {
          for (; k <= s.se; ++k) {
            int16_t& c = blk[kZigzag[k]];
            if (c) refine(c, p1, m1, br);
          }
          --eobrun;
        }
      }
    }
  }
  return eobrun;
}

// split a scan's data at its restart markers, un-stuffing each interval
void split(const uint8_t* scan, long len, std::vector<uint8_t>& data,
           std::vector<long>& starts) {
  data.clear();
  starts.assign(1, 0);
  int expect = 0;
  for (long i = 0; i < len;) {
    if (scan[i] != 0xFF) {
      data.push_back(scan[i++]);
      continue;
    }
    const long run = i;
    while (i < len && scan[i] == 0xFF) ++i;
    if (i < len && scan[i] == 0x00 && i == run + 1) {
      data.push_back(0xFF);
      ++i;
      continue;
    }
    if (i >= len || scan[i] < 0xD0 || scan[i] > 0xD7) throw (int)kStrayMarker;
    if (scan[i] != 0xD0 + expect) throw (int)kBadRestart;
    expect = (expect + 1) & 7;
    ++i;
    starts.push_back((long)data.size());
  }
}

// libjpeg's coef_bits: the last Al of each component's coefficient (zig-zag
// order), -1 for none; throws on a progressive scan out of order
void advance(int (&bits)[kMaxComps][64], const Scan& s) {
  for (int i = 0; i < s.ns; ++i) {
    int* b = bits[s.comp[i]];
    if (s.ss > 0 && b[0] < 0) throw (int)kBadProgression;
    for (int k = s.ss; k <= s.se; ++k) {
      if (s.ah != (b[k] < 0 ? 0 : b[k])) throw (int)kBadProgression;
      b[k] = s.al;
    }
  }
}

// ------------------------------------------------------ arithmetic coding
// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | next state
// after an MPS << 8 | switch << 7 | next state after an LPS (io/jpeg.py's
// ARITAB); state 113 is the fixed probability 0.5
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171
};
constexpr int kFixedState = 113;

// libjpeg's error state (its ct = -1): a magnitude or index out of range;
// nothing more is decoded until the next restart marker
struct Broken {};

// T.81 Annex D's decoder as jdarith.c runs it on one un-stuffed restart
// interval, reading zeros once its bytes are spent (io/jpeg.py's _Arith)
struct Arith {
  const uint8_t* data;
  long len, pos = 0;
  long long c = 0;
  long a = 0;
  int ct = -16;
  bool broken = false;
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | (pos < len ? data[pos] : 0);
        ++pos;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const uint32_t e = kAritab[sv & 0x7F];
    const long qe = (long)(e >> 16);
    const int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    a -= qe;
    const long long temp = (long long)a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // F.23: the magnitude category from bin i, then the X bins from x1 on;
  // i becomes the last X bin read
  int magnitude(uint8_t* st, int& i, int x1) {
    int m = decode(st + i);
    if (m) {
      i = x1;
      while (decode(st + i)) {
        if ((m <<= 1) == 0x8000) throw Broken();
        ++i;
      }
    }
    return m;
  }
  // F.24: the magnitude bits (bin i + 14) and the sign -> the value
  int value(uint8_t* st, int m, int i, int sign) {
    int v = m;
    i += 14;
    while (m >>= 1)
      if (decode(st + i)) v |= m;
    return sign ? -(v + 1) : v + 1;
  }
};

// Figure F.20: AC coefficients ss..se of one block
void arith_ac(Arith& d, uint8_t* st, int kx, int16_t* blk, int ss, int se,
              int al) {
  uint8_t fixed = kFixedState;
  for (int k = ss; k <= se; ++k) {
    int i = 3 * (k - 1);
    if (d.decode(st + i)) return;  // end of block
    while (!d.decode(st + i + 1)) {
      i += 3;
      if (++k > se) throw Broken();
    }
    const int sign = d.decode(&fixed);
    i += 2;
    int m = d.decode(st + i);
    if (m && d.decode(st + i)) {
      m = 2;
      i = k <= kx ? 189 : 217;
      while (d.decode(st + i)) {
        if ((m <<= 1) == 0x8000) throw Broken();
        ++i;
      }
    }
    blk[kZigzag[k]] = wrap16((long long)d.value(st, m, i, sign) * (1 << al));
  }
}

// decode_mcu_AC_refine
void arith_ac_refine(Arith& d, uint8_t* st, int16_t* blk, int ss, int se,
                     int al) {
  uint8_t fixed = kFixedState;
  const int p1 = 1 << al, m1 = -(1 << al);
  int kex = se;
  while (kex > 0 && !blk[kZigzag[kex]]) --kex;
  for (int k = ss; k <= se; ++k) {
    int i = 3 * (k - 1);
    if (k > kex && d.decode(st + i)) return;
    for (;;) {
      int16_t& c = blk[kZigzag[k]];
      if (c) {
        if (d.decode(st + i + 2)) c = wrap16(c + (c < 0 ? m1 : p1));
        break;
      }
      if (d.decode(st + i + 1)) {
        c = (int16_t)(d.decode(&fixed) ? m1 : p1);
        break;
      }
      i += 3;
      if (++k > se) throw Broken();
    }
  }
}

struct ArithCond {
  int lo[kMaxComps], hi[kMaxComps], kx[kMaxComps];
};

// one restart interval of an arithmetic-coded scan (io/jpeg.py's
// _arith_interval): statistics per table and DC predictions from zero
void arith_interval(Arith& d, bool progressive, const Scan& s,
                    const ArithCond& cond, const int* dct, const int* act,
                    long first, long last, long mcux,
                    const std::vector<Unit>& units, int16_t* coef) {
  uint8_t dc_stats[16][64], ac_stats[16][256];
  for (int i = 0; i < s.ns; ++i) {
    memset(dc_stats[dct[i]], 0, 64);
    memset(ac_stats[act[i]], 0, 256);
  }
  int last_dc[kMaxComps] = {0, 0, 0, 0}, ctx[kMaxComps] = {0, 0, 0, 0};
  uint8_t fixed = kFixedState;
  const bool dc_first = !progressive || (s.ss == 0 && s.ah == 0);
  for (long mcu = first; mcu < last; ++mcu) {
    if (d.broken && !(progressive && s.ss == 0 && s.ah)) continue;
    const long my = mcu / mcux, mx = mcu % mcux;
    try {
      for (const Unit& u : units) {
        int16_t* blk = coef + (u.base + my * u.v * u.nbx + mx * u.h) * 64;
        uint8_t* acs = ac_stats[act[u.k]];
        if (dc_first) {
          uint8_t* st = dc_stats[dct[u.k]];
          const int s0 = ctx[u.k];
          if (!d.decode(st + s0)) {
            ctx[u.k] = 0;
          } else {
            const int sign = d.decode(st + s0 + 1);
            int i = s0 + 2 + sign;
            const int m = d.magnitude(st, i, 20);
            ctx[u.k] = m < ((1 << cond.lo[u.k]) >> 1)   ? 0
                       : m > ((1 << cond.hi[u.k]) >> 1) ? 12 + 4 * sign
                                                        : 4 + 4 * sign;
            last_dc[u.k] = (last_dc[u.k] + d.value(st, m, i, sign)) & 0xFFFF;
          }
          blk[0] = wrap16((long long)last_dc[u.k] * (1 << s.al));
          if (!progressive) arith_ac(d, acs, cond.kx[u.k], blk, 1, 63, 0);
        } else if (s.ss == 0) {  // DC refinement
          if (d.decode(&fixed)) blk[0] = (int16_t)(blk[0] | (1 << s.al));
        } else if (s.ah == 0) {  // AC first
          arith_ac(d, acs, cond.kx[u.k], blk, s.ss, s.se, s.al);
        } else {  // AC refinement
          arith_ac_refine(d, acs, blk, s.ss, s.se, s.al);
        }
      }
    } catch (Broken&) {
      d.broken = true;
    }
  }
}

// ----------------------------------------------------------- lossless
struct CompGeom {  // a component's parameters (see jpeg_entropy_decode)
  int h, v, nbx, offset, bw, bh, nby, dw, dh, sh, sv;
  int bits[kSmoothCoefs], q[kSmoothCoefs];
};

CompGeom comp_geom(const int32_t* p) {
  CompGeom c;
  c.h = p[0];
  c.v = p[1];
  c.nbx = p[2];
  c.offset = p[3];
  c.bw = p[4];
  c.bh = p[5];
  c.nby = p[6];
  c.dw = p[7];
  c.dh = p[8];
  c.sh = p[9];
  c.sv = p[10];
  for (int k = 0; k < kSmoothCoefs; ++k) {
    c.bits[k] = p[12 + k];
    c.q[k] = p[22 + k];
  }
  return c;
}

inline int predict(int psv, int ra, int rb, int rc) {
  switch (psv) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;
  }
}

// one lossless scan (io/jpeg.py's _lossless_scan): every difference of the
// scan, then each iMCU row undifferenced as jddiffct.c does it, the
// samples shifted by Pt into the 8 x 8 blocks of `out`
void lossless_scan(const Scan& s, const CompGeom* comps, int width,
                   int height, int hmax, int vmax, const HuffTable* const* dc,
                   const uint8_t* data, const std::vector<long>& starts,
                   uint8_t* out) {
  const int ns = s.ns;
  const long n_imcu = (height + vmax - 1) / vmax;
  long mcux, mcu_rows;
  struct Sample {
    int k, y, x, h, v;
  };
  std::vector<Sample> units;
  std::vector<long> per_imcu;
  int full[kMaxComps], tail[kMaxComps];
  if (ns == 1) {
    const CompGeom& c = comps[s.comp[0]];
    units.push_back(Sample{0, 0, 0, 1, 1});
    mcux = c.dw;
    mcu_rows = c.dh;
    per_imcu.assign(n_imcu, c.sv);
    per_imcu.back() = c.dh - (n_imcu - 1) * c.sv;
    full[0] = c.sv;
    tail[0] = (int)per_imcu.back();
  } else {
    for (int k = 0; k < ns; ++k) {
      const CompGeom& c = comps[s.comp[k]];
      for (int y = 0; y < c.v; ++y)
        for (int x = 0; x < c.h; ++x)
          units.push_back(Sample{k, y, x, c.h, c.v});
      full[k] = c.v;
      tail[k] = (int)(c.dh - (n_imcu - 1) * c.v);
    }
    mcux = (width + hmax - 1) / hmax;
    mcu_rows = n_imcu;
    per_imcu.assign(n_imcu, 1);
  }
  const long n_mcu = mcux * mcu_rows;
  const long per = s.restart ? s.restart : n_mcu;
  if ((long)starts.size() - 1 != (n_mcu + per - 1) / per)
    throw (int)kBadRestart;
  if (per % mcux) throw (int)kBadLosslessRestart;
  std::vector<std::vector<int>> diff(ns);
  long gw[kMaxComps];
  for (int k = 0; k < ns; ++k) {
    const CompGeom& c = comps[s.comp[k]];
    gw[k] = mcux * (ns == 1 ? 1 : c.h);
    diff[k].assign(gw[k] * mcu_rows * (ns == 1 ? 1 : c.v), 0);
  }
  for (long seg = 0; seg + 1 < (long)starts.size(); ++seg) {
    Bits br{data + starts[seg], starts[seg + 1] - starts[seg]};
    const long last = (seg + 1) * per < n_mcu ? (seg + 1) * per : n_mcu;
    for (long mcu = seg * per; mcu < last; ++mcu) {
      const long my = mcu / mcux, mx = mcu % mcux;
      for (const Sample& u : units) {
        const int t = br.symbol(*dc[u.k]);
        const int d = t == 16 ? 32768 : t ? br.extended(t) : 0;
        diff[u.k][(my * u.v + u.y) * gw[u.k] + mx * u.h + u.x] = d;
      }
    }
    if (br.consumed() > 8 * br.len) throw (int)kTruncated;
  }
  const long rows_per_seg = per / mcux;
  bool first[kMaxComps];
  std::vector<std::vector<int>> prev(ns), row(ns);
  for (int k = 0; k < ns; ++k) {
    first[k] = true;
    prev[k].assign(comps[s.comp[k]].dw, 0);
    row[k].assign(comps[s.comp[k]].dw, 0);
  }
  const int psv = s.ss, pt = s.al;
  long mcu_row = 0;
  for (long j = 0; j < n_imcu; ++j) {
    for (long y = 0; y < per_imcu[j]; ++y)
      if ((mcu_row + y) % rows_per_seg == 0 && mcu_row + y)
        for (int k = 0; k < ns; ++k) first[k] = true;  // a restart's reset
    mcu_row += per_imcu[j];
    for (int k = 0; k < ns; ++k) {
      const CompGeom& c = comps[s.comp[k]];
      const long r0 = j * full[k];
      const long r1 = r0 + (j == n_imcu - 1 ? tail[k] : full[k]);
      for (long r = r0; r < r1; ++r) {
        const int* d = diff[k].data() + r * gw[k];
        std::vector<int>& now = row[k];
        if (first[k]) {
          int ra = 1 << (7 - pt);
          for (int x = 0; x < c.dw; ++x) now[x] = ra = (d[x] + ra) & 0xFFFF;
          first[k] = false;
        } else {
          const std::vector<int>& up = prev[k];
          int ra = now[0] = (d[0] + up[0]) & 0xFFFF;
          for (int x = 1; x < c.dw; ++x)
            now[x] = ra = (d[x] + predict(psv, ra, up[x], up[x - 1])) & 0xFFFF;
        }
        uint8_t* dst = out + ((size_t)c.offset + (r >> 3) * c.nbx) * 64 +
                       (r & 7) * 8;
        for (int x = 0; x < c.dw; ++x)
          dst[(x >> 3) * 64 + (x & 7)] = (uint8_t)(now[x] << pt);
        std::swap(prev[k], row[k]);
      }
    }
  }
}

// ------------------------------------------------------ block smoothing
// libjpeg-turbo's weights of the 5 x 5 DC values (jdcoefct.c's
// decompress_smooth_data; io/jpeg.py's SMOOTH_WEIGHTS): per zig-zag
// coefficient 0-9, with DC interpolation, then without
const int16_t kSmoothWeights[kSmoothCoefs][2][25] = {
    {{ -2,  -6,  -8,  -6,  -2,  // DC
       -6,   6,  42,   6,  -6,
       -8,  42, 152,  42,  -8,
       -6,   6,  42,   6,  -6,
       -2,  -6,  -8,  -6,  -2},
     { -2,  -6,  -8,  -6,  -2,
       -6,   6,  42,   6,  -6,
       -8,  42, 152,  42,  -8,
       -6,   6,  42,   6,  -6,
       -2,  -6,  -8,  -6,  -2}},
    {{ -1,  -1,   0,   1,   1,  // AC01
       -3,  13,   0, -13,   3,
       -3,  38,   0, -38,   3,
       -3,  13,   0, -13,   3,
       -1,  -1,   0,   1,   1},
     {  0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
       -7,  50,   0, -50,   7,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0}},
    {{ -1,  -3,  -3,  -3,  -1,  // AC10
       -1,  13,  38,  13,  -1,
        0,   0,   0,   0,   0,
        1, -13, -38, -13,   1,
        1,   3,   3,   3,   1},
     {  0,   0,  -7,   0,   0,
        0,   0,  50,   0,   0,
        0,   0,   0,   0,   0,
        0,   0, -50,   0,   0,
        0,   0,   7,   0,   0}},
    {{  0,   0,   1,   0,   0,  // AC20
        0,   2,   7,   2,   0,
        0,  -5, -14,  -5,   0,
        0,   2,   7,   2,   0,
        0,   0,   1,   0,   0},
     {  0,   0,  -1,   0,   0,
        0,   0,  13,   0,   0,
        0,   0, -24,   0,   0,
        0,   0,  13,   0,   0,
        0,   0,  -1,   0,   0}},
    {{ -1,   0,   0,   0,   1,  // AC11
        0,   9,   0,  -9,   0,
        0,   0,   0,   0,   0,
        0,  -9,   0,   9,   0,
        1,   0,   0,   0,  -1},
     {  0,  -1,   0,   1,   0,
       -1,  10,   0, -10,   1,
        0,   0,   0,   0,   0,
        1, -10,   0,  10,  -1,
        0,   1,   0,  -1,   0}},
    {{  0,   0,   0,   0,   0,  // AC02
        0,   2,  -5,   2,   0,
        1,   7, -14,   7,   1,
        0,   2,  -5,   2,   0,
        0,   0,   0,   0,   0},
     {  0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
       -1,  13, -24,  13,  -1,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0}},
    {{  0,   0,   0,   0,   0,  // AC03
        0,   1,   0,  -1,   0,
        0,   2,   0,  -2,   0,
        0,   1,   0,  -1,   0,
        0,   0,   0,   0,   0},
     {  0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0}},
    {{  0,   0,   0,   0,   0,  // AC12
        0,   1,  -3,   1,   0,
        0,   0,   0,   0,   0,
        0,  -1,   3,  -1,   0,
        0,   0,   0,   0,   0},
     {  0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0}},
    {{  0,   0,   0,   0,   0,  // AC21
        0,   1,   0,  -1,   0,
        0,  -3,   0,   3,   0,
        0,   1,   0,  -1,   0,
        0,   0,   0,   0,   0},
     {  0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0}},
    {{  0,   0,   0,   0,   0,  // AC30
        0,   1,   2,   1,   0,
        0,   0,   0,   0,   0,
        0,  -1,  -2,  -1,   0,
        0,   0,   0,   0,   0},
     {  0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0,
        0,   0,   0,   0,   0}}};

// io/jpeg.py's smooth_blocks on one component: each of the first ten
// coefficients still zero and not known to the last bit estimated from the
// 5 x 5 DC values around its block, which libjpeg reads through sliding
// registers (edge values repeated as they repeat there)
void smooth_component(const CompGeom& c, int height, int vmax,
                      int16_t* coef) {
  bool change_dc = true;
  for (int k = 1; k < kSmoothCoefs; ++k) change_dc &= c.bits[k] == -1;
  const int mode = change_dc ? 0 : 1, n = change_dc ? kSmoothCoefs : 6;
  const int total = (height + 8 * vmax - 1) / (8 * vmax), v = c.sv;
  std::vector<int> dc((size_t)c.nbx * c.nby);  // the DC values, unchanged
  for (size_t b = 0; b < dc.size(); ++b)
    dc[b] = coef[((size_t)c.offset + b) * 64];
  const int last_col = c.bw - 1;
  for (int imcu = 0; imcu < total; ++imcu) {
    const int block_rows =
        imcu < total - 1 ? v : (c.bh % v ? c.bh % v : v);
    const int image_rows = block_rows * total;
    for (int br = 0; br < block_rows; ++br) {
      const int row = imcu * block_rows + br, cur = imcu * v + br;
      if (cur >= c.nby) continue;
      int rows[5];
      rows[2] = cur;
      rows[1] = row > 0 ? cur - 1 : cur;
      rows[0] = row > 1 ? cur - 2 : rows[1];
      rows[3] = row < image_rows - 1 ? cur + 1 : cur;
      rows[4] = row < image_rows - 2 ? cur + 2 : rows[3];
      auto at = [&](int j, int x) {
        return rows[j] < c.nby ? dc[(size_t)rows[j] * c.nbx + x] : 0;
      };
      int reg[5][5];
      for (int j = 0; j < 5; ++j)
        for (int i = 0; i < 5; ++i) reg[j][i] = at(j, 0);
      for (int bn = 0; bn < c.bw; ++bn) {
        if (bn == 0 && bn < last_col)
          for (int j = 0; j < 5; ++j) reg[j][3] = reg[j][4] = at(j, 1);
        if (bn + 1 < last_col)
          for (int j = 0; j < 5; ++j) reg[j][4] = at(j, bn + 2);
        int16_t* blk =
            coef + ((size_t)c.offset + (size_t)cur * c.nbx + bn) * 64;
        for (int k = change_dc ? 0 : 1; k < n; ++k) {
          const int al = c.bits[k];
          if (k && (al == 0 || blk[kZigzag[k]])) continue;
          long long sum = 0;
          for (int i = 0; i < 25; ++i)
            sum += kSmoothWeights[k][mode][i] * reg[i / 5][i % 5];
          const long long num = (long long)c.q[0] * sum, q = c.q[k];
          long long pred = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
          if (k && al > 0 && pred >= (1LL << al)) pred = (1LL << al) - 1;
          blk[kZigzag[k]] = wrap16(num < 0 ? -pred : pred);
        }
        for (int j = 0; j < 5; ++j)
          for (int i = 0; i < 4; ++i) reg[j][i] = reg[j][i + 1];
      }
    }
  }
}

#ifndef JPEG_DECODE_HOST_ONLY
// ----------------------------------------------------------------- J1
// colour spaces and upsampling filters (io/jpeg.py's COLOR_* and UP_*)
constexpr int kGrey = 0, kYcc = 1, kRgb = 2, kCmyk = 3, kYcck = 4;
constexpr int kUpFull = 0, kUpBox = 1, kUpH2V1 = 2, kUpH1V2 = 3,
              kUpH2V2 = 4;
constexpr int kMaxThreads = 512;
constexpr int kGeomParams = 10;  // per component, see jpeg_pixels_launch
constexpr int kBlockBytes = 144;  // a staged block, padded against conflicts

struct Geometry {
  int ncomp, width, height, color, channels, total_blocks;
  int mcux, mcuy, hmax, vmax, tile_rows, tile_cols, threads, batch;
  int nbx[kMaxComps], nby[kMaxComps], offset[kMaxComps], dw[kMaxComps],
      dh[kMaxComps], up[kMaxComps], hexp[kMaxComps], vexp[kMaxComps],
      h[kMaxComps], v[kMaxComps];
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Each component's tile of blocks grows by one block on each side that
// its triangle filter reads across (h2v1, h2v2: left and right; h1v2,
// h2v2: above and below).
__host__ __device__ inline int ext_rows(const Geometry& g, int c) {
  return g.tile_rows * g.v[c] + 2 * (g.up[c] == kUpH1V2 || g.up[c] == kUpH2V2);
}
__host__ __device__ inline int ext_cols(const Geometry& g, int c) {
  return g.tile_cols * g.h[c] + 2 * (g.up[c] == kUpH2V1 || g.up[c] == kUpH2V2);
}
// a plane's rows 16 bytes apart modulo 128: the eight rows of a block
// that the lanes of a group write at once fall in different banks
__host__ __device__ inline int plane_stride(const Geometry& g, int c) {
  return round_up(ext_cols(g, c) * 8, 128) + 16;
}

// A CTA's shared memory, in bytes from its start (the same on the host,
// which sizes the launch, and on the card): the quantisers (int32), every
// component's plane, per group of eight threads a staged block and the
// IDCT workspace, the staged output tile, the components' CompTiles.
struct Smem {
  int planes, slots, ws, stage, stage_stride, rows, cols, tiles, bytes;
};

__host__ __device__ inline Smem smem_layout(const Geometry& g) {
  Smem s;
  s.planes = kMaxComps * 64 * 4;
  s.slots = s.planes;
  for (int c = 0; c < g.ncomp; ++c)
    s.slots += ext_rows(g, c) * 8 * plane_stride(g, c);
  s.ws = s.slots + (g.threads / 8) * kBlockBytes;
  s.rows = g.tile_rows * 8 * g.vmax;
  s.cols = g.tile_cols * 8 * g.hmax;
  s.stage_stride = round_up(s.cols * g.channels, 16);
  s.stage = s.ws + (g.threads / 8) * 72 * 4;
  s.tiles = s.stage + s.rows * s.stage_stride;
  s.bytes = s.tiles + kMaxComps * 32;
  return s;
}

// One component's part of a CTA: where its plane lies in shared memory,
// and which blocks it holds. Kept in shared memory, so that no thread
// holds an array indexed by component.
struct CompTile {
  int plane, stride;         // byte offset, row pitch
  int rows, cols;            // blocks, halo included
  int first_row, first_col;  // the halo's first block row and column
};

__device__ __forceinline__ CompTile comp_tile(const Geometry& g,
                                              const Smem& L, int c, int my0,
                                              int mx0) {
  CompTile t;
  t.plane = L.planes;
  for (int k = 0; k < c; ++k)
    t.plane += ext_rows(g, k) * 8 * plane_stride(g, k);
  t.stride = plane_stride(g, c);
  t.rows = ext_rows(g, c);
  t.cols = ext_cols(g, c);
  t.first_row = my0 * g.v[c] - (t.rows - g.tile_rows * g.v[c]) / 2;
  t.first_col = mx0 * g.h[c] - (t.cols - g.tile_cols * g.h[c]) / 2;
  return t;
}

// Block b of the CTA's list (every component's tile and halo in turn, row
// by row): its component, its row and column in the tile, and its index in
// the coefficients, -1 where it lies past the image's blocks.
__device__ __forceinline__ int locate(const CompTile* tiles,
                                      const Geometry& g, int b, int& c,
                                      int& r, int& q) {
  c = 0;
  while (b >= tiles[c].rows * tiles[c].cols) {
    b -= tiles[c].rows * tiles[c].cols;
    ++c;
  }
  r = b / tiles[c].cols;
  q = b - r * tiles[c].cols;
  const int by = tiles[c].first_row + r, bx = tiles[c].first_col + q;
  if (by < 0 || by >= g.nby[c] || bx < 0 || bx >= g.nbx[c]) return -1;
  return g.offset[c] + by * g.nbx[c] + bx;
}

// a copy of 16 bytes from device memory into shared memory that skips
// the registers, through the SM's L1: every CTA reads the same tables, and
// the CTAs of one SM then fetch them from the L2 once
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

constexpr int kConstBits = 13, kPass1Bits = 2;

// jidctint's butterfly on one row or column; results DESCALE'd by `shift`
__device__ __forceinline__ void idct_1d(const int (&x)[8], int (&o)[8],
                                        int shift) {
  int z2 = x[2], z3 = x[6];
  int z1 = (z2 + z3) * 4433;
  const int tmp2 = z1 + z3 * -15137;
  const int tmp3 = z1 + z2 * 6270;
  const int tmp0 = (x[0] + x[4]) * (1 << kConstBits);
  const int tmp1 = (x[0] - x[4]) * (1 << kConstBits);
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int z4 = t1 + t3;
  const int z5 = (z3 + z4) * 9633;
  t0 = t0 * 2446;
  t1 = t1 * 16819;
  t2 = t2 * 25172;
  t3 = t3 * 12299;
  z1 = z1 * -7373;
  z2 = z2 * -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int half = 1 << (shift - 1);
  o[0] = (tmp10 + t3 + half) >> shift;
  o[7] = (tmp10 - t3 + half) >> shift;
  o[1] = (tmp11 + t2 + half) >> shift;
  o[6] = (tmp11 - t2 + half) >> shift;
  o[2] = (tmp12 + t1 + half) >> shift;
  o[5] = (tmp12 - t1 + half) >> shift;
  o[3] = (tmp13 + t0 + half) >> shift;
  o[4] = (tmp13 - t0 + half) >> shift;
}

// libjpeg's range_limit[x & RANGE_MASK] after the level shift
__device__ __forceinline__ uint32_t range_limit(int x) {
  const int wrapped = ((x + 512) & 1023) - 512 + 128;
  return (uint32_t)min(max(wrapped, 0), 255);
}

// A component's sample (i, j) in its plane in shared memory, whose first
// row and column are the halo's (past the image's top or left edge that
// halo is never read).
__device__ __forceinline__ const uint8_t* sample_at(const uint8_t* smem,
                                                    const CompTile& t, int i,
                                                    int j) {
  return smem + t.plane + (i - t.first_row * 8) * t.stride +
         (j - t.first_col * 8);
}

// the six samples j0 - 1 .. j0 + 4 of row i, clamped to the component's
// extent as the triangle filters clamp their neighbours (j0 a multiple of
// four: one 4-byte read and two bytes away from the edges)
__device__ __forceinline__ void row6(const uint8_t* smem, const CompTile& t,
                                     int i, int j0, int last, int (&s)[6]) {
  const uint8_t* p = sample_at(smem, t, i, j0);
  if (j0 > 0 && j0 + 4 <= last) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    s[0] = p[-1];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k + 1] = (w >> (8 * k)) & 0xFF;
    s[5] = p[4];
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k)
      s[k] = *sample_at(smem, t, i, min(max(j0 - 1 + k, 0), last));
  }
}

// component c at output pixels (y, x .. x + 7), x a multiple of 8,
// upsampled as libjpeg-turbo's jdsample.c does: as it is, by replication
// (whole ratios), or the h2v1 / h1v2 / h2v2 triangle filters with their
// biases, edge samples replicated. Eight neighbouring pixels share their
// samples: h2v2 reads two rows of six for them.
__device__ __forceinline__ void samples8(const uint8_t* smem,
                                         const CompTile& t, const Geometry& g,
                                         int c, int y, int x, int (&o)[8]) {
  const int up = g.up[c];
  if (up == kUpFull || up == kUpH1V2) {
    const uint2 a = *reinterpret_cast<const uint2*>(
        sample_at(smem, t, up == kUpFull ? y : y >> 1, x));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = ((k < 4 ? a.x : a.y) >> (8 * (k & 3))) & 0xFF;
    if (up == kUpH1V2) {
      const int i = y >> 1, odd = y & 1;
      const int i2 = odd ? min(i + 1, g.dh[c] - 1) : max(i - 1, 0);
      const uint2 b =
          *reinterpret_cast<const uint2*>(sample_at(smem, t, i2, x));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = (3 * o[k] + (((k < 4 ? b.x : b.y) >> (8 * (k & 3))) & 0xFF) +
                1 + odd) >> 2;
    }
  } else if (up == kUpBox) {
    const int i = y / g.vexp[c];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = *sample_at(smem, t, i, (x + k) / g.hexp[c]);
  } else {
    // pixel x + 2k + e reads sample j0 + k and its neighbour j0 + k - 1
    // (e = 0) or j0 + k + 1 (e = 1): s[m] is sample j0 - 1 + m
    const int j0 = x >> 1, last = g.dw[c] - 1;
    int s[6];
    row6(smem, t, up == kUpH2V1 ? y : y >> 1, j0, last, s);
    if (up == kUpH2V1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[2 * k] = (3 * s[k + 1] + s[k] + 1) >> 2;
        o[2 * k + 1] = (3 * s[k + 1] + s[k + 2] + 2) >> 2;
      }
    } else {  // h2v2: column sums of the near and far rows
      const int i = y >> 1;
      const int i2 = (y & 1) ? min(i + 1, g.dh[c] - 1) : max(i - 1, 0);
      int far[6];
      row6(smem, t, i2, j0, last, far);
#pragma unroll
      for (int m = 0; m < 6; ++m) s[m] = 3 * s[m] + far[m];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[2 * k] = (3 * s[k + 1] + s[k] + 8) >> 4;
        o[2 * k + 1] = (3 * s[k + 1] + s[k + 2] + 7) >> 4;
      }
    }
  }
}

// jdcolor.c's ycc_rgb_convert
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, int& r,
                                        int& g, int& b) {
  const int u = cb - 128, v = cr - 128;
  r = min(max(y + ((91881 * v + 32768) >> 16), 0), 255);
  g = min(max(y + ((-22554 * u + 32768 - 46802 * v) >> 16), 0), 255);
  b = min(max(y + ((116130 * u + 32768) >> 16), 0), 255);
}

// PIL's CMYK -> RGB of one inverted channel c (255 - C) under the stream's
// K sample k (255 - K): nk - MULDIV255(c, nk) with nk = k
__device__ __forceinline__ int cmyk_rgb(int c, int k) {
  const int t = c * k + 128;
  return k - (((t >> 8) + t) >> 8);
}

#ifdef JPEG_DECODE_TIMELINE
// the measurement build's clock: thread 0 of each CTA writes the global
// timer (ns) at the start and after each phase into out[4 * CTA + k],
// 64 bits each, and the stores are left out
#define TIMELINE(k)                                                      \
  do {                                                                   \
    unsigned long long now;                                              \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));              \
    if (threadIdx.x == 0)                                                \
      reinterpret_cast<unsigned long long*>(out)[blockIdx.x * 4 + (k)] = \
          now;                                                           \
  } while (0)
#else
#define TIMELINE(k) \
  do {              \
  } while (0)
#endif

// One CTA per tile of tile_rows x tile_cols MCUs (fewer at the image's
// right and bottom edges): the phases of the header above. Samples: the
// input is a lossless frame's uint8 samples in the same blocks, which
// phase 2 copies into the planes as they are (no quantisers, no IDCT).
template <int Color, bool Samples>
__global__ void __launch_bounds__(kMaxThreads)
    jpeg_pixels_kernel(const void* __restrict__ in,
                       const int32_t* __restrict__ tables,
                       uint8_t* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the image of the batch: its coefficients (samples) and its output
  const int16_t* coef = static_cast<const int16_t*>(in) +
                        (size_t)blockIdx.y * g.total_blocks * 64;
  const uint8_t* samples = static_cast<const uint8_t*>(in) +
                           (size_t)blockIdx.y * g.total_blocks * 64;
  out += (size_t)blockIdx.y * g.height * g.width * g.channels;
#ifdef JPEG_DECODE_LAUNCH_ONLY
  return;  // the launch's own time: grid, threads and shared memory
#endif
  TIMELINE(0);
  const Smem L = smem_layout(g);
  const int* quant = reinterpret_cast<const int*>(smem);
  CompTile* tiles = reinterpret_cast<CompTile*>(smem + L.tiles);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tiles_x = (g.mcux + g.tile_cols - 1) / g.tile_cols;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int my0 = ty * g.tile_rows, mx0 = tx * g.tile_cols;

  // 1. the components' quantisers (int32) and tiles; each group's first
  // block is on its way before the quantisers are waited for
  if (!Samples)
    for (int i = tid; i < g.ncomp * 64 * 4 / 16; i += nthreads)
      copy_async16(smem + i * 16, tables + i * 4);
  if (tid < g.ncomp) tiles[tid] = comp_tile(g, L, tid, my0, mx0);
  __syncthreads();
  const int groups = nthreads >> 3, lane = tid & 7;
  int total = 0;
  for (int c = 0; c < g.ncomp; ++c) total += tiles[c].rows * tiles[c].cols;
  int c, r, q, at = -1;
  uint4 next = make_uint4(0, 0, 0, 0);
  uint2 next8 = make_uint2(0, 0);
  if (tid >> 3 < total) {
    at = locate(tiles, g, tid >> 3, c, r, q);
    if (at >= 0) {
      if (Samples)
        next8 = reinterpret_cast<const uint2*>(samples + (size_t)at * 64)[lane];
      else
        next = reinterpret_cast<const uint4*>(coef + (size_t)at * 64)[lane];
    }
  }
  copy_async_wait();
  __syncthreads();
  TIMELINE(1);

  if constexpr (Samples) {
    // 2. samples: row `lane` of each block (8 bytes) into its plane; the
    // next block's row is in flight meanwhile
    for (int b = tid >> 3; b < total; b += groups) {
      const int cb = c, rb = r, qb = q, here = at;
      const uint2 row = next8;
      if (b + groups < total) {
        at = locate(tiles, g, b + groups, c, r, q);
        if (at >= 0)
          next8 =
              reinterpret_cast<const uint2*>(samples + (size_t)at * 64)[lane];
      }
      if (here < 0) continue;
      const CompTile& t = tiles[cb];
      *reinterpret_cast<uint2*>(smem + t.plane + (rb * 8 + lane) * t.stride +
                                qb * 8) = row;
    }
  } else {

  // 2. transform, a group of eight threads per block, `groups` blocks
  // apart; row `lane` of the next block is in flight meanwhile
  const unsigned gmask = 0xFFu << (tid & 24);
  int* ws = reinterpret_cast<int*>(smem + L.ws) + (tid >> 3) * 72;
  unsigned char* slot = smem + L.slots + (tid >> 3) * kBlockBytes;
  for (int b = tid >> 3; b < total; b += groups) {
    const int cb = c, rb = r, qb = q, here = at;
    const uint4 row = next;
    if (b + groups < total) {
      at = locate(tiles, g, b + groups, c, r, q);
      if (at >= 0)
        next = reinterpret_cast<const uint4*>(coef + (size_t)at * 64)[lane];
    }
    if (here < 0) continue;
    reinterpret_cast<uint4*>(slot)[lane] = row;
#ifndef JPEG_DECODE_STAGE_ONLY
    __syncwarp(gmask);
    const CompTile& t = tiles[cb];
    const int* qt = quant + cb * 64;
    const int16_t* src = reinterpret_cast<const int16_t*>(slot);
    int x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = (int)src[k * 8 + lane] * qt[k * 8 + lane];
    idct_1d(x, o, kConstBits - kPass1Bits);  // column `lane`
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[k * 9 + lane] = o[k];
    __syncwarp(gmask);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = ws[lane * 9 + k];
    __syncwarp(gmask);  // the slot and `ws` are free for the next block
    idct_1d(x, o, kConstBits + kPass1Bits + 3);  // row `lane`
    uint2 word;
    word.x = range_limit(o[0]) | range_limit(o[1]) << 8 |
             range_limit(o[2]) << 16 | range_limit(o[3]) << 24;
    word.y = range_limit(o[4]) | range_limit(o[5]) << 8 |
             range_limit(o[6]) << 16 | range_limit(o[7]) << 24;
    *reinterpret_cast<uint2*>(smem + t.plane + (rb * 8 + lane) * t.stride +
                              qb * 8) = word;
#endif
  }
  }  // Samples
  __syncthreads();
  TIMELINE(2);
#ifdef JPEG_DECODE_STAGE_ONLY
  if (g.total_blocks < 0) out[tid] = smem[tid];  // never: keeps the work
#else

  // 3. colour, eight pixels a thread, into the staged output tile
  const int y0 = my0 * 8 * g.vmax, x0 = mx0 * 8 * g.hmax;
  const int rows = min(L.rows, g.height - y0);
  const int cols = min(L.cols, g.width - x0);
  const int octets = (cols + 7) / 8;
  for (int i = tid; i < rows * octets; i += nthreads) {
    const int r = i / octets, x = x0 + 8 * (i - r * octets), y = y0 + r;
    int s0[8], s1[8], s2[8], s3[8];
    samples8(smem, tiles[0], g, 0, y, x, s0);
    if (Color != kGrey) {
      samples8(smem, tiles[1], g, 1, y, x, s1);
      samples8(smem, tiles[2], g, 2, y, x, s2);
    }
    if (Color == kCmyk || Color == kYcck)
      samples8(smem, tiles[3], g, 3, y, x, s3);
    uint32_t word[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int rr, gg, bb;
      if (Color == kGrey) {
        rr = gg = bb = s0[k];
      } else if (Color == kRgb) {
        rr = s0[k];
        gg = s1[k];
        bb = s2[k];
      } else if (Color == kCmyk) {  // PIL inverts the samples
        rr = 255 - s0[k];
        gg = 255 - s1[k];
        bb = 255 - s2[k];
      } else {
        ycc_rgb(s0[k], s1[k], s2[k], rr, gg, bb);
      }
      if (Color == kCmyk || Color == kYcck) {
        // libjpeg's ycck_cmyk_convert writes 255 - R, G, B, which PIL's
        // inversion undoes
        rr = cmyk_rgb(rr, s3[k]);
        gg = cmyk_rgb(gg, s3[k]);
        bb = cmyk_rgb(bb, s3[k]);
      }
      if (g.channels == 3) {
        const uint32_t px[3] = {(uint32_t)rr, (uint32_t)gg, (uint32_t)bb};
#pragma unroll
        for (int e = 0; e < 3; ++e)
          word[(3 * k + e) >> 2] |= px[e] << (8 * ((3 * k + e) & 3));
      } else {
        const uint32_t grey =
            Color == kGrey ? (uint32_t)rr
                           : (uint32_t)((rr * 4899 + gg * 9617 + bb * 1868 +
                                         8192) >> 14);
        word[k >> 2] |= grey << (8 * (k & 3));
      }
    }
    // 8-byte stores: a row of the stage starts 16-byte aligned, and eight
    // pixels take 8 or 24 bytes
    uint2* d = reinterpret_cast<uint2*>(smem + L.stage + r * L.stage_stride +
                                        (x - x0) * g.channels);
    d[0] = make_uint2(word[0], word[1]);
    if (g.channels == 3) {
      d[1] = make_uint2(word[2], word[3]);
      d[2] = make_uint2(word[4], word[5]);
    }
  }
  __syncthreads();
  TIMELINE(3);

  // 4. stores: each row's bytes, in words of 16 (8, 4) bytes where the
  // image's rows and the tile's first column allow it, the rest bytewise
  const int row_bytes = cols * g.channels;
  const size_t image_row = (size_t)g.width * g.channels;
  int vec = 16;
  while (vec > 1 && (image_row % vec || (x0 * g.channels) % vec ||
                     reinterpret_cast<uintptr_t>(out) % vec))
    vec >>= 1;
  if (vec == 2) vec = 1;
  const int words = row_bytes / vec, tail = row_bytes - words * vec;
  const int per_row = words + tail;
  uint8_t* dst0 = out + (size_t)y0 * image_row + (size_t)x0 * g.channels;
#if defined(JPEG_DECODE_SKIP_STORE) || defined(JPEG_DECODE_TIMELINE)
  if (g.total_blocks < 0)  // never: the stores are left out, not the work
#endif
    for (int i = tid; i < rows * per_row; i += nthreads) {
      const int r = i / per_row, k = i - r * per_row;
      const uint8_t* s = smem + L.stage + r * L.stage_stride;
      uint8_t* d = dst0 + r * image_row;
      if (k >= words) {
        const int at = words * vec + k - words;
        d[at] = s[at];
      } else if (vec == 16) {
        reinterpret_cast<uint4*>(d)[k] =
            reinterpret_cast<const uint4*>(s)[k];
      } else if (vec == 8) {
        reinterpret_cast<uint2*>(d)[k] = reinterpret_cast<const uint2*>(s)[k];
      } else if (vec == 4) {
        reinterpret_cast<uint32_t*>(d)[k] =
            reinterpret_cast<const uint32_t*>(s)[k];
      } else {
        d[k] = s[k];
      }
    }
#endif  // JPEG_DECODE_STAGE_ONLY
}

template <int Color, bool Samples>
cudaError_t launch_pixels(const Geometry& g, int ctas, int bytes,
                          cudaStream_t s, const void* in,
                          const int32_t* tables, uint8_t* out) {
  if (bytes > 48 * 1024) {  // above the default, asked for
    const cudaError_t err = cudaFuncSetAttribute(
        jpeg_pixels_kernel<Color, Samples>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  jpeg_pixels_kernel<Color, Samples>
      <<<dim3(ctas, g.batch), g.threads, bytes, s>>>(in, tables, out, g);
  return cudaGetLastError();
}

// the launch of jpeg_pixels_launch / jpeg_samples_launch
template <bool Samples>
int launch_j1(const void* in, void* out, const int32_t* geom,
              const void* tables, void* stream) {
  Geometry g;
  g.ncomp = geom[0];
  g.width = geom[1];
  g.height = geom[2];
  g.color = geom[3];
  g.channels = geom[4];
  g.total_blocks = geom[5];
  g.mcux = geom[6];
  g.mcuy = geom[7];
  g.hmax = geom[8];
  g.vmax = geom[9];
  g.tile_rows = geom[10];
  g.tile_cols = geom[11];
  g.threads = geom[12];
  g.batch = geom[13 + kGeomParams * kMaxComps];
  for (int c = 0; c < kMaxComps; ++c) {
    const int32_t* p = geom + 13 + kGeomParams * c;
    g.nbx[c] = p[0];
    g.nby[c] = p[1];
    g.offset[c] = p[2];
    g.dw[c] = p[3];
    g.dh[c] = p[4];
    g.up[c] = p[5];
    g.hexp[c] = p[6];
    g.vexp[c] = p[7];
    g.h[c] = p[8];
    g.v[c] = p[9];
  }
  if (g.tile_rows < 1 || g.tile_cols < 1 || g.threads < 32 ||
      g.threads > kMaxThreads || g.threads % 32 || g.batch < 1 ||
      g.batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_layout(g).bytes;
  const int ctas = ((g.mcuy + g.tile_rows - 1) / g.tile_rows) *
                   ((g.mcux + g.tile_cols - 1) / g.tile_cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* q = static_cast<const int32_t*>(tables);
  uint8_t* dst = static_cast<uint8_t*>(out);
  switch (g.color) {
    case kGrey:
      return (int)launch_pixels<kGrey, Samples>(g, ctas, bytes, s, in, q, dst);
    case kYcc:
      return (int)launch_pixels<kYcc, Samples>(g, ctas, bytes, s, in, q, dst);
    case kRgb:
      return (int)launch_pixels<kRgb, Samples>(g, ctas, bytes, s, in, q, dst);
    case kCmyk:
      return (int)launch_pixels<kCmyk, Samples>(g, ctas, bytes, s, in, q,
                                                dst);
    case kYcck:
      return (int)launch_pixels<kYcck, Samples>(g, ctas, bytes, s, in, q,
                                                dst);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#endif  // JPEG_DECODE_HOST_ONLY

}  // namespace

// Every scan's entropy-coded bytes (restart markers and stuffing included,
// the scans one after another in `data`) -> (blocks, 64) int16
// coefficients in natural order, block-smoothed where libjpeg smooths
// them; a lossless frame's uint8 samples in the same block layout.
// params: the header (kHeader): ncomp, mcux, mcuy, total blocks, scans,
// progressive, arithmetic, lossless, smooth, width, height, 0; then per
// component (4, kCompParams) h, v (as the MCU uses them), nbx, first
// block, bw, bh (the blocks a scan of that component alone walks), nby,
// dw, dh (its samples), the SOF's h and v, 0, the last Al of each of the
// first ten zig-zag coefficients (-1: never sent; smoothing only) and
// their quantisers; then per scan (kScanParams) its offset and length in
// `data`, ns, Ss, Se, Ah, Al, restart interval, and per scan component (4)
// the component, its DC table and its AC table (Huffman: rows of `huff`,
// -1 none; arithmetic: table numbers), its DC table's L, U and its AC
// table's Kx. huff: tables of 16 length counts and 256 symbols. Returns 0
// or an io/jpeg.py ERRORS code.
extern "C" int jpeg_entropy_decode(const uint8_t* data, int len,
                                   const int32_t* params, const uint8_t* huff,
                                   void* out) {
  const int ncomp = params[0], mcux = params[1];
  const int nscans = params[4];
  const bool progressive = params[5] != 0, arithmetic = params[6] != 0;
  const bool lossless = params[7] != 0, smooth = params[8] != 0;
  const int width = params[9], height = params[10];
  CompGeom comps[kMaxComps];
  int hmax = 1, vmax = 1;  // the SOF's
  for (int c = 0; c < ncomp; ++c) {
    comps[c] = comp_geom(params + kHeader + c * kCompParams);
    hmax = comps[c].sh > hmax ? comps[c].sh : hmax;
    vmax = comps[c].sv > vmax ? comps[c].sv : vmax;
  }
  const int32_t* scans = params + kHeader + kMaxComps * kCompParams;
  int16_t* coef = static_cast<int16_t*>(out);
  memset(out, 0, (size_t)params[3] * 64 * (lossless ? 1 : sizeof(int16_t)));
  int ntables = 0;
  for (int s = 0; s < nscans && !arithmetic; ++s)
    for (int i = 0; i < 8; ++i) {
      const int t = scans[s * kScanParams + 12 + i];
      ntables = t + 1 > ntables ? t + 1 : ntables;
    }
  std::vector<HuffTable> tables(ntables);
  for (int t = 0; t < ntables; ++t)
    build_table(huff + t * 272, huff + t * 272 + 16, &tables[t]);
  int bits[kMaxComps][64];
  for (int c = 0; c < kMaxComps; ++c)
    for (int k = 0; k < 64; ++k) bits[c][k] = -1;
  std::vector<uint8_t> buf;
  std::vector<long> starts;
  try {
    for (int si = 0; si < nscans; ++si) {
      const int32_t* p = scans + si * kScanParams;
      if (p[0] < 0 || p[1] < 0 || (long)p[0] + p[1] > len)
        throw (int)kTruncated;
      Scan s{p[2], p[3], p[4], p[5], p[6], p[7], {0, 0, 0, 0}};
      for (int i = 0; i < s.ns; ++i) s.comp[i] = p[8 + i];
      split(data + p[0], p[1], buf, starts);
      starts.push_back((long)buf.size());
      if (lossless) {
        const HuffTable* dc[kMaxComps];
        for (int i = 0; i < s.ns; ++i) dc[i] = &tables[p[12 + i]];
        lossless_scan(s, comps, width, height, hmax, vmax, dc, buf.data(),
                      starts, static_cast<uint8_t*>(out));
        continue;
      }
      if (progressive) advance(bits, s);
      std::vector<Unit> units;
      long smcux = mcux, smcuy = params[2];
      ArithCond cond;
      int dct[kMaxComps], act[kMaxComps];
      for (int i = 0; i < s.ns; ++i) {
        const CompGeom& c = comps[s.comp[i]];
        const HuffTable* dc = nullptr;
        const HuffTable* ac = nullptr;
        if (arithmetic) {
          dct[i] = p[12 + i];
          act[i] = p[16 + i];
          cond.lo[i] = p[20 + i];
          cond.hi[i] = p[24 + i];
          cond.kx[i] = p[28 + i];
        } else {
          dc = p[12 + i] >= 0 ? &tables[p[12 + i]] : nullptr;
          ac = p[16 + i] >= 0 ? &tables[p[16 + i]] : nullptr;
        }
        if (s.ns == 1) {  // the component's own blocks, one an MCU
          smcux = c.bw;
          smcuy = c.bh;
          units.push_back(Unit{0, c.offset, 1, 1, c.nbx, dc, ac});
        } else {
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx)
              units.push_back(Unit{i, c.offset + by * c.nbx + bx, c.v, c.h,
                                   c.nbx, dc, ac});
        }
      }
      const long n_mcu = smcux * smcuy;
      const long per = s.restart ? s.restart : n_mcu;
      const long intervals = (long)starts.size() - 1;
      if (intervals != (n_mcu + per - 1) / per) throw (int)kBadRestart;
      for (long k = 0; k < intervals; ++k) {
        const long first = k * per;
        const long last = first + per < n_mcu ? first + per : n_mcu;
        if (arithmetic) {
          Arith d{buf.data() + starts[k], starts[k + 1] - starts[k]};
          arith_interval(d, progressive, s, cond, dct, act, first, last,
                         smcux, units, coef);
          continue;
        }
        Bits br{buf.data() + starts[k], starts[k + 1] - starts[k]};
        const long eobrun = decode_interval(br, progressive, s, first, last,
                                            smcux, units, coef);
        if (br.consumed() > 8 * br.len) throw (int)kTruncated;
        if (eobrun) throw (int)kEobRun;
      }
    }
  } catch (int err) {
    return err;
  }
  if (smooth)
    for (int c = 0; c < ncomp; ++c)
      smooth_component(comps[c], height, vmax, coef);
  return kOk;
}

#ifndef JPEG_DECODE_HOST_ONLY
// J1: coefficients (device, batch x blocks x 64 int16, each image's
// components' blocks row by row) -> out (device, batch x height x width x
// channels uint8), one launch for the batch (images of one geometry and
// one table set: the strips or tiles of a JPEG-compressed TIFF).
// geom: ncomp, width, height, colour, channels, total blocks, the MCUs
// that cover the image across and down, the MCU's largest sampling
// factors, the launch plan (a CTA's tile in MCU rows and columns, its
// threads), then per component (4) nbx, nby, first block, dw, dh,
// upsampling filter, its horizontal and vertical ratios, its sampling
// factors h and v, and last the batch (a grid row of CTAs per image).
// tables (device): 4 x 64 quantisers (int16 values as int32), natural
// order (ops/jpeg.quant_on_card).
extern "C" int jpeg_pixels_launch(const void* coef, void* out,
                                  const int32_t* geom, const void* tables,
                                  void* stream) {
  return launch_j1<false>(coef, out, geom, tables, stream);
}

// J1's samples source: a lossless frame's uint8 samples (device, batch x
// blocks x 64, each 8 x 8 block of a component's plane in the
// coefficients' layout) -> out, as jpeg_pixels_launch; `tables` is not
// read.
extern "C" int jpeg_samples_launch(const void* samples, void* out,
                                   const int32_t* geom, const void* tables,
                                   void* stream) {
  return launch_j1<true>(samples, out, geom, tables, stream);
}
#endif  // JPEG_DECODE_HOST_ONLY
