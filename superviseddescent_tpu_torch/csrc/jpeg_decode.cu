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
// decodes each interval with a 9-bit lookahead table and the canonical
// slow path, by the scan's procedure: sequential, or T.81 Annex G's DC
// first, DC refinement, AC first and AC refinement (EOB runs, correction
// bits). Every scan writes into one array of int16 coefficients in natural
// order, the caller's (pinned) buffer, zeroed once.
//
// J1 is two launches on one stream, one call of jpeg_pixels_launch:
//   1. jpeg_idct_kernel: eight threads per 8x8 block, 32 blocks per CUDA
//      block, which copies only its blocks' components' quantisers into
//      shared memory. Each thread dequantises one column (int32 products,
//      the component's latched table) and runs libjpeg's jidctint islow
//      pass 1 on it into shared memory, then pass 2 on one row, the
//      range_limit lookup (values wrapped by RANGE_MASK, not clamped) and
//      one 8-byte store into the component's plane.
//   2. jpeg_color_kernel, one instantiation per colour space: a thread per
//      four neighbouring output pixels of a row (one 4-byte store of grey,
//      three of RGB, where the width is a multiple of four) reads each of
//      the up to four components as libjpeg-turbo's jdsample.c upsamples
//      it (as it is; h2v1 / h2v2 triangle filters with their +1/+2 and
//      +8/+7 biases where the component is more than two samples wide; the
//      h1v2 filter with +1/+2; else replication by whole ratios; edge
//      samples replicated), converts the colour (YCbCr -> RGB with jdcolor.c's
//      fixed-point factors; RGB as it is; CMYK and YCCK as PIL reads them,
//      inverted, then PIL's CMYK -> RGB) and writes RGB or OpenCV's grey of
//      it (a 1-component image: Y itself). A component's filter is the
//      same for every thread, so the branches do not diverge in a warp.
// Two launches, because each chroma sample feeds up to four output pixels
// of its neighbours' MCUs: one block per MCU would recompute the chroma
// halo's IDCTs (up to 9 blocks a component), while the planes between the
// launches are 1.2 MB at 1024 x 768 4:2:0 and stay in the L2.
//
// What bounds J1 on this card: bytes (the int16 coefficients read once,
// 2.4 MB at 1024 x 768 4:2:0, and the output written once); its operations
// are ~1 k integer operations per block. Everything is integer, so the
// kernel's bits equal the twin's and libjpeg-turbo's.

#include <cuda_runtime.h>
#include <stdint.h>
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
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookahead = 9;
constexpr int kPad = 8;  // zero bytes after each interval's data
constexpr int kMaxComps = 4;
constexpr int kCompParams = 6;   // h, v, nbx, first block, bw, bh
constexpr int kScanParams = 20;  // see jpeg_entropy_decode

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

// ----------------------------------------------------------------- J1
// colour spaces and upsampling filters (io/jpeg.py's COLOR_* and UP_*)
constexpr int kGrey = 0, kYcc = 1, kRgb = 2, kCmyk = 3, kYcck = 4;
constexpr int kUpFull = 0, kUpBox = 1, kUpH2V1 = 2, kUpH1V2 = 3,
              kUpH2V2 = 4;
constexpr int kBlocksPerCta = 32;  // 8 threads a block, 256 threads
constexpr int kColorThreads = 256;
constexpr int kPixels = 4;  // output pixels a thread of the colour kernel
constexpr int kGeomParams = 9;  // per component, see jpeg_pixels_launch

struct Geometry {
  int ncomp, width, height, color, channels, total_blocks;
  int nbx[kMaxComps], nby[kMaxComps], offset[kMaxComps],
      plane_off[kMaxComps], dw[kMaxComps], dh[kMaxComps], up[kMaxComps],
      hexp[kMaxComps], vexp[kMaxComps];
  int16_t quant[kMaxComps][64];
};

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

// the component that block b belongs to
__device__ __forceinline__ int component_of(const Geometry& g, int b) {
  int c = 0;
#pragma unroll
  for (int k = 1; k < kMaxComps; ++k) c += k < g.ncomp && b >= g.offset[k];
  return c;
}

__global__ void __launch_bounds__(kBlocksPerCta * 8)
    jpeg_idct_kernel(const int16_t* __restrict__ coef,
                     uint8_t* __restrict__ planes, const Geometry g) {
  __shared__ int16_t quant[kMaxComps][64];
  __shared__ int ws[kBlocksPerCta][8 * 9];  // rows padded against conflicts
  // the quantisers of the components of this CTA's blocks only (one, or
  // two at a boundary): each thread's copy from the kernel's parameters is
  // a constant-bank read of its own address
  const int first = blockIdx.x * kBlocksPerCta;
  const int c0 = component_of(g, first);
  const int c1 = component_of(g, min(first + kBlocksPerCta,
                                     g.total_blocks) - 1);
  for (int i = threadIdx.x; i < (c1 - c0 + 1) * 64; i += blockDim.x)
    quant[c0 + i / 64][i % 64] = g.quant[c0 + i / 64][i % 64];
  __syncthreads();
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int b = first + local;
  if (b >= g.total_blocks) return;  // whole groups of eight leave together
  const unsigned group = 0xFFu << (threadIdx.x & 24);
  const int c = component_of(g, b);
  const int16_t* src = coef + (size_t)b * 64;
  int x[8], o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    x[k] = (int)src[k * 8 + lane] * (int)quant[c][k * 8 + lane];
  idct_1d(x, o, kConstBits - kPass1Bits);  // column `lane`
#pragma unroll
  for (int k = 0; k < 8; ++k) ws[local][k * 9 + lane] = o[k];
  __syncwarp(group);
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = ws[local][lane * 9 + k];
  idct_1d(x, o, kConstBits + kPass1Bits + 3);  // row `lane`
  uint2 word;
  word.x = range_limit(o[0]) | range_limit(o[1]) << 8 |
           range_limit(o[2]) << 16 | range_limit(o[3]) << 24;
  word.y = range_limit(o[4]) | range_limit(o[5]) << 8 |
           range_limit(o[6]) << 16 | range_limit(o[7]) << 24;
  const int bi = b - g.offset[c];
  const int by = bi / g.nbx[c], bx = bi - by * g.nbx[c];
  const size_t stride = (size_t)g.nbx[c] * 8;
  *reinterpret_cast<uint2*>(planes + g.plane_off[c] +
                            (size_t)(by * 8 + lane) * stride + bx * 8) = word;
}

// component c at output pixel (x, y), upsampled as libjpeg-turbo does
__device__ __forceinline__ int sample(const uint8_t* __restrict__ planes,
                                      const Geometry& g, int c, int x,
                                      int y) {
  const uint8_t* p = planes + g.plane_off[c];
  const int stride = g.nbx[c] * 8, up = g.up[c];
  if (up == kUpFull) return p[y * stride + x];
  if (up == kUpBox) return p[(y / g.vexp[c]) * stride + x / g.hexp[c]];
  if (up == kUpH1V2) {
    const int i = y >> 1, odd_y = y & 1;
    const int i2 = odd_y ? min(i + 1, g.dh[c] - 1) : max(i - 1, 0);
    return (3 * p[i * stride + x] + p[i2 * stride + x] + 1 + odd_y) >> 2;
  }
  const int j = x >> 1, odd_x = x & 1;
  const int j2 = odd_x ? min(j + 1, g.dw[c] - 1) : max(j - 1, 0);
  if (up == kUpH2V1)
    return (3 * p[y * stride + j] + p[y * stride + j2] + 1 + odd_x) >> 2;
  const int i = y >> 1;
  const int i2 = (y & 1) ? min(i + 1, g.dh[c] - 1) : max(i - 1, 0);
  const int near = 3 * p[i * stride + j] + p[i2 * stride + j];
  const int far = 3 * p[i * stride + j2] + p[i2 * stride + j2];
  return (3 * near + far + 8 - odd_x) >> 4;
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

// the RGB of output pixel (x, y) in colour space Color
template <int Color>
__device__ __forceinline__ void pixel_rgb(const uint8_t* __restrict__ planes,
                                          const Geometry& g, int x, int y,
                                          int& r, int& gg, int& b) {
  const int v0 = sample(planes, g, 0, x, y);
  if (Color == kGrey) {
    r = gg = b = v0;
    return;
  }
  const int v1 = sample(planes, g, 1, x, y), v2 = sample(planes, g, 2, x, y);
  if (Color == kRgb) {
    r = v0;
    gg = v1;
    b = v2;
  } else if (Color == kCmyk) {  // PIL inverts the samples
    r = 255 - v0;
    gg = 255 - v1;
    b = 255 - v2;
  } else {
    ycc_rgb(v0, v1, v2, r, gg, b);
  }
  if (Color == kCmyk || Color == kYcck) {
    // libjpeg's ycck_cmyk_convert writes 255 - R, G, B, which PIL's
    // inversion undoes
    const int k = sample(planes, g, 3, x, y);
    r = cmyk_rgb(r, k);
    gg = cmyk_rgb(gg, k);
    b = cmyk_rgb(b, k);
  }
}

// a thread per kPixels neighbouring pixels of a row: one 4-byte store of
// grey, or three of RGB, where the row's width is a multiple of kPixels
template <int Color>
__global__ void __launch_bounds__(kColorThreads)
    jpeg_color_kernel(const uint8_t* __restrict__ planes,
                      uint8_t* __restrict__ out, const Geometry g) {
  const int x0 = (blockIdx.x * kColorThreads + threadIdx.x) * kPixels;
  const int y = blockIdx.y;
  if (x0 >= g.width) return;
  uint8_t px[kPixels * 3];
  const int n = min(kPixels, g.width - x0);
#pragma unroll
  for (int i = 0; i < kPixels; ++i) {
    if (i >= n) break;
    int r, gg, b;
    pixel_rgb<Color>(planes, g, x0 + i, y, r, gg, b);
    if (g.channels == 3) {
      px[3 * i] = (uint8_t)r;
      px[3 * i + 1] = (uint8_t)gg;
      px[3 * i + 2] = (uint8_t)b;
    } else {
      px[i] = Color == kGrey ? (uint8_t)r
                             : (uint8_t)((r * 4899 + gg * 9617 + b * 1868 +
                                          8192) >> 14);
    }
  }
  const int bytes = n * g.channels;
  uint8_t* dst = out + ((size_t)y * g.width + x0) * g.channels;
  if (n == kPixels && g.width % kPixels == 0) {  // 4-byte aligned words
#pragma unroll
    for (int w = 0; w < 3; ++w)
      if (w * 4 < bytes)
        reinterpret_cast<uint32_t*>(dst)[w] =
            px[4 * w] | px[4 * w + 1] << 8 | px[4 * w + 2] << 16 |
            (uint32_t)px[4 * w + 3] << 24;
  } else {
#pragma unroll
    for (int i = 0; i < kPixels * 3; ++i)
      if (i < bytes) dst[i] = px[i];
  }
}

}  // namespace

// Every scan's entropy-coded bytes (restart markers and stuffing included,
// the scans one after another in `data`) -> (blocks, 64) int16
// coefficients in natural order.
// params: ncomp, mcux, mcuy, total blocks, scans, progressive; then per
// component (4) h, v, nbx, first block, bw, bh (the blocks a scan of that
// component alone walks); then per scan its offset and length in `data`,
// ns, Ss, Se, Ah, Al, restart interval, and per scan component (4) the
// component, its DC table and its AC table (rows of `huff`, -1: none).
// huff: tables of 16 length counts and 256 symbols. Returns 0 or an
// io/jpeg.py ERRORS code.
extern "C" int jpeg_entropy_decode(const uint8_t* data, int len,
                                   const int32_t* params, const uint8_t* huff,
                                   int16_t* coef) {
  const int ncomp = params[0], mcux = params[1], mcuy = params[2];
  const int nscans = params[4];
  const bool progressive = params[5] != 0;
  const int32_t* comp = params + 6;
  const int32_t* scans = comp + kMaxComps * kCompParams;
  memset(coef, 0, (size_t)params[3] * 64 * sizeof(int16_t));
  int ntables = 0;
  for (int s = 0; s < nscans; ++s)
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
      if (progressive) advance(bits, s);
      std::vector<Unit> units;
      long smcux = mcux, smcuy = mcuy;
      for (int i = 0; i < s.ns; ++i) {
        const int32_t* c = comp + s.comp[i] * kCompParams;
        const HuffTable* dc = p[12 + i] >= 0 ? &tables[p[12 + i]] : nullptr;
        const HuffTable* ac = p[16 + i] >= 0 ? &tables[p[16 + i]] : nullptr;
        if (s.ns == 1) {  // the component's own blocks, one an MCU
          smcux = c[4];
          smcuy = c[5];
          units.push_back(Unit{0, c[3], 1, 1, c[2], dc, ac});
        } else {
          for (int by = 0; by < c[1]; ++by)
            for (int bx = 0; bx < c[0]; ++bx)
              units.push_back(
                  Unit{i, c[3] + by * c[2] + bx, c[1], c[0], c[2], dc, ac});
        }
      }
      split(data + p[0], p[1], buf, starts);
      const long n_mcu = smcux * smcuy;
      const long per = s.restart ? s.restart : n_mcu;
      const long intervals = (long)starts.size();
      if (intervals != (n_mcu + per - 1) / per) throw (int)kBadRestart;
      starts.push_back((long)buf.size());
      for (long k = 0; k < intervals; ++k) {
        const long first = k * per;
        const long last = first + per < n_mcu ? first + per : n_mcu;
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
  return kOk;
}

// J1: coefficients (device) -> planes (device scratch, the components'
// block-padded planes) -> out (device, height x width x channels uint8).
// geom: ncomp, width, height, colour, channels, total blocks, then per
// component (4) nbx, nby, first block, plane offset, dw, dh, upsampling
// filter, its horizontal and vertical ratios.
// quant: 4 x 64 quantisers (int16 values), natural order.
extern "C" int jpeg_pixels_launch(const void* coef, void* planes, void* out,
                                  const int32_t* geom, const int32_t* quant,
                                  void* stream) {
  Geometry g;
  g.ncomp = geom[0];
  g.width = geom[1];
  g.height = geom[2];
  g.color = geom[3];
  g.channels = geom[4];
  g.total_blocks = geom[5];
  for (int c = 0; c < kMaxComps; ++c) {
    const int32_t* p = geom + 6 + kGeomParams * c;
    g.nbx[c] = p[0];
    g.nby[c] = p[1];
    g.offset[c] = p[2];
    g.plane_off[c] = p[3];
    g.dw[c] = p[4];
    g.dh[c] = p[5];
    g.up[c] = p[6];
    g.hexp[c] = p[7];
    g.vexp[c] = p[8];
    for (int k = 0; k < 64; ++k) g.quant[c][k] = (int16_t)quant[c * 64 + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = (g.total_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  jpeg_idct_kernel<<<ctas, kBlocksPerCta * 8, 0, s>>>(
      static_cast<const int16_t*>(coef), static_cast<uint8_t*>(planes), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int quads = (g.width + kPixels - 1) / kPixels;
  const dim3 grid((quads + kColorThreads - 1) / kColorThreads, g.height);
  const uint8_t* in = static_cast<const uint8_t*>(planes);
  uint8_t* dst = static_cast<uint8_t*>(out);
  switch (g.color) {
    case kGrey:
      jpeg_color_kernel<kGrey><<<grid, kColorThreads, 0, s>>>(in, dst, g);
      break;
    case kYcc:
      jpeg_color_kernel<kYcc><<<grid, kColorThreads, 0, s>>>(in, dst, g);
      break;
    case kRgb:
      jpeg_color_kernel<kRgb><<<grid, kColorThreads, 0, s>>>(in, dst, g);
      break;
    case kCmyk:
      jpeg_color_kernel<kCmyk><<<grid, kColorThreads, 0, s>>>(in, dst, g);
      break;
    case kYcck:
      jpeg_color_kernel<kYcck><<<grid, kColorThreads, 0, s>>>(in, dst, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
