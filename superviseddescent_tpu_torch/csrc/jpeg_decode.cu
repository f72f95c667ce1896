// Baseline JPEG decoding: the host entropy decoder and kernel J1, the pixel
// stage on the card.
//
// No TPU kernel is replaced: the JAX package reads images with PIL on the
// host (superviseddescent_tpu/ops/patches.py::load_gray_image). This is
// the port's own decoder, for frames that are decoded where they are used.
// The plain twins are io/jpeg.py::entropy_decode (the entropy decoder) and
// io/jpeg.py::pixels_reference (J1); the wrapper is ops/jpeg.py.
//
// Entropy decoding is bit-serial and stays on the host, as libjpeg does
// it: jpeg_entropy_decode splits the scan at its restart markers, removes
// the byte stuffing and decodes each interval with a 9-bit lookahead table
// and the canonical slow path, writing int16 coefficients in natural order
// into the caller's (pinned) buffer.
//
// J1 is two launches on one stream, one call of jpeg_pixels_launch:
//   1. jpeg_idct_kernel: eight threads per 8x8 block, 32 blocks per CUDA
//      block. Each thread dequantises one column (int32 products) and runs
//      libjpeg's jidctint islow pass 1 on it into shared memory, then pass 2
//      on one row, the range_limit lookup (values wrapped by RANGE_MASK, not
//      clamped) and one 8-byte store into the component's plane.
//   2. jpeg_color_kernel: a thread per output pixel reads the luma sample
//      and the chroma samples its fancy upsampling needs (libjpeg-turbo's
//      h2v1 / h2v2 triangle filters with their +1/+2 and +8/+7 biases, edge
//      samples replicated; box upsampling where the chroma is at most two
//      samples wide), converts YCbCr to RGB with jdcolor.c's fixed-point
//      factors (an Adobe transform of 0 means RGB, converted by nothing) and
//      writes RGB or OpenCV's grey of it (a 1-component image: Y itself).
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
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookahead = 9;
constexpr int kPad = 8;  // zero bytes after each interval's data

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

struct BitReader {
  const uint8_t* data;
  long len, pos;
  uint64_t buf;
  int nbits;
  // reads zeros past the interval's end; false once it would pass kPad of
  // them (io/jpeg.py's IndexError): the interval is truncated
  bool fill() {
    while (nbits <= 56) {
      if (pos >= len + kPad) return false;
      buf = (buf << 8) | (pos < len ? data[pos] : 0);
      ++pos;
      nbits += 8;
    }
    return true;
  }
  int peek16() const { return (int)((buf >> (nbits - 16)) & 0xFFFF); }
  int bits(int s) {
    nbits -= s;
    return (int)((buf >> nbits) & ((1u << s) - 1));
  }
};

// one Huffman symbol, or -1 for an invalid code
int decode_symbol(BitReader& br, const HuffTable& t) {
  const int p = br.peek16();
  const int e = t.fast[p >> (16 - kLookahead)];
  if (e) {
    br.nbits -= e >> 8;
    return e & 0xFF;
  }
  for (int len = kLookahead + 1; len <= 16; ++len) {
    const int code = p >> (16 - len);
    if (code <= t.maxcode[len]) {
      br.nbits -= len;
      return t.vals[code + t.valoffset[len]];
    }
  }
  return -1;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Unit {  // one block of an MCU
  int comp, dc, ac, base, v, h, nbx;
};

int decode_interval(const uint8_t* data, long len, long first, long last,
                    int mcux, const std::vector<Unit>& units,
                    const HuffTable* tables, int16_t* coef) {
  BitReader br{data, len, 0, 0, 0};
  int pred[3] = {0, 0, 0};
  for (long mcu = first; mcu < last; ++mcu) {
    const long my = mcu / mcux, mx = mcu % mcux;
    for (const Unit& u : units) {
      int16_t* blk = coef + (u.base + my * u.v * u.nbx + mx * u.h) * 64;
      if (br.nbits < 32 && !br.fill()) return kTruncated;
      int s = decode_symbol(br, tables[u.dc]);
      if (s < 0) return kBadCode;
      const int diff = s ? extend(br.bits(s), s) : 0;
      pred[u.comp] += diff;
      blk[0] = (int16_t)pred[u.comp];
      for (int k = 1; k < 64;) {
        if (br.nbits < 32 && !br.fill()) return kTruncated;
        const int rs = decode_symbol(br, tables[u.ac]);
        if (rs < 0) return kBadCode;
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) return kBadIndex;
          blk[kZigzag[k]] = (int16_t)extend(br.bits(s), s);
          ++k;
        } else if (r == 15) {
          k += 16;
        } else {
          break;
        }
      }
    }
  }
  return 8 * br.pos - br.nbits > 8 * len ? kTruncated : kOk;
}

// ----------------------------------------------------------------- J1
constexpr int kModeGrey = 0, kMode444 = 1, kModeH2V1 = 2, kModeH2V2 = 3;
constexpr int kBlocksPerCta = 32;  // 8 threads a block, 256 threads
constexpr int kColorThreads = 256;

struct Geometry {
  int ncomp, width, height, mode, rgb_input, channels, total_blocks;
  int nbx[3], nby[3], offset[3], plane_off[3], dw[3], dh[3];
  int16_t quant[3][64];
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

__global__ void __launch_bounds__(kBlocksPerCta * 8)
    jpeg_idct_kernel(const int16_t* __restrict__ coef,
                     uint8_t* __restrict__ planes, const Geometry g) {
  __shared__ int16_t quant[3][64];
  __shared__ int ws[kBlocksPerCta][8 * 9];  // rows padded against conflicts
  for (int i = threadIdx.x; i < 3 * 64; i += blockDim.x)
    quant[i / 64][i % 64] = g.quant[i / 64][i % 64];
  __syncthreads();
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int b = blockIdx.x * kBlocksPerCta + local;
  if (b >= g.total_blocks) return;  // whole groups of eight leave together
  const unsigned group = 0xFFu << (threadIdx.x & 24);
  const int c = (g.ncomp > 1 && b >= g.offset[1])
                    ? ((g.ncomp > 2 && b >= g.offset[2]) ? 2 : 1)
                    : 0;
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

// chroma component c at output pixel (x, y), upsampled as libjpeg-turbo
__device__ __forceinline__ int chroma(const uint8_t* __restrict__ planes,
                                      const Geometry& g, int c, int x,
                                      int y) {
  const uint8_t* p = planes + g.plane_off[c];
  const int stride = g.nbx[c] * 8, dw = g.dw[c], dh = g.dh[c];
  if (g.mode == kMode444) return p[y * stride + x];
  const int j = x >> 1, odd_x = x & 1;
  const int i = g.mode == kModeH2V2 ? y >> 1 : y;
  if (dw <= 2) return p[i * stride + j];  // box upsampling
  const int j2 = odd_x ? min(j + 1, dw - 1) : max(j - 1, 0);
  if (g.mode == kModeH2V1)
    return (3 * p[i * stride + j] + p[i * stride + j2] + 1 + odd_x) >> 2;
  const int i2 = (y & 1) ? min(i + 1, dh - 1) : max(i - 1, 0);
  const int near = 3 * p[i * stride + j] + p[i2 * stride + j];
  const int far = 3 * p[i * stride + j2] + p[i2 * stride + j2];
  return (3 * near + far + 8 - odd_x) >> 4;
}

__global__ void __launch_bounds__(kColorThreads)
    jpeg_color_kernel(const uint8_t* __restrict__ planes,
                      uint8_t* __restrict__ out, const Geometry g) {
  const int x = blockIdx.x * kColorThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= g.width) return;
  const size_t at = (size_t)y * g.width + x;
  int r = planes[g.plane_off[0] + y * g.nbx[0] * 8 + x], gg = r, b = r;
  if (g.mode != kModeGrey) {
    const int cb = chroma(planes, g, 1, x, y);
    const int cr = chroma(planes, g, 2, x, y);
    if (g.rgb_input) {
      gg = cb;
      b = cr;
    } else {
      const int y0 = r, u = cb - 128, v = cr - 128;
      r = min(max(y0 + ((91881 * v + 32768) >> 16), 0), 255);
      gg = min(max(y0 + ((-22554 * u + 32768 - 46802 * v) >> 16), 0), 255);
      b = min(max(y0 + ((116130 * u + 32768) >> 16), 0), 255);
    }
  }
  if (g.channels == 3) {
    out[at * 3] = (uint8_t)r;
    out[at * 3 + 1] = (uint8_t)gg;
    out[at * 3 + 2] = (uint8_t)b;
  } else {
    out[at] = g.mode == kModeGrey
                  ? (uint8_t)r
                  : (uint8_t)((r * 4899 + gg * 9617 + b * 1868 + 8192) >> 14);
  }
}

}  // namespace

// The scan's entropy-coded bytes (restart markers and stuffing included)
// -> (blocks, 64) int16 coefficients in natural order.
// params: ncomp, mcux, mcuy, restart interval, total blocks, then per
// component h, v, nbx, first block, DC table, AC table. huff: 8 tables of
// 16 length counts and 256 symbols (0-3 DC, 4-7 AC). Returns 0 or an
// io/jpeg.py ERRORS code.
extern "C" int jpeg_entropy_decode(const uint8_t* scan, int len,
                                   const int32_t* params, const uint8_t* huff,
                                   int16_t* coef) {
  const int ncomp = params[0], mcux = params[1], mcuy = params[2];
  const long n_mcu = (long)mcux * mcuy;
  const long per = params[3] ? params[3] : n_mcu;
  memset(coef, 0, (size_t)params[4] * 64 * sizeof(int16_t));
  std::vector<HuffTable> tables(8);
  for (int t = 0; t < 8; ++t)
    build_table(huff + t * 272, huff + t * 272 + 16, &tables[t]);
  std::vector<Unit> units;
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* p = params + 5 + 6 * c;
    for (int by = 0; by < p[1]; ++by)
      for (int bx = 0; bx < p[0]; ++bx)
        units.push_back(
            Unit{c, p[4], 4 + p[5], p[3] + by * p[2] + bx, p[1], p[0], p[2]});
  }
  // split at the restart markers, un-stuffing each interval
  std::vector<uint8_t> data;
  data.reserve(len);
  std::vector<long> starts{0};
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
    if (i >= len || scan[i] < 0xD0 || scan[i] > 0xD7) return kStrayMarker;
    if (scan[i] != 0xD0 + expect) return kBadRestart;
    expect = (expect + 1) & 7;
    ++i;
    starts.push_back((long)data.size());
  }
  const long intervals = (long)starts.size();
  if (intervals != (n_mcu + per - 1) / per) return kBadRestart;
  starts.push_back((long)data.size());
  for (long k = 0; k < intervals; ++k) {
    const long first = k * per;
    const long last = first + per < n_mcu ? first + per : n_mcu;
    const int err = decode_interval(data.data() + starts[k],
                                    starts[k + 1] - starts[k], first, last,
                                    mcux, units, tables.data(), coef);
    if (err) return err;
  }
  return kOk;
}

// J1: coefficients (device) -> planes (device scratch, the components'
// block-padded planes) -> out (device, height x width x channels uint8).
// geom: ncomp, width, height, mode, rgb_input, channels, total blocks, then
// per component (3) nbx, nby, first block, plane offset, dw, dh.
// quant: 3 x 64 quantisers (int16 values), natural order.
extern "C" int jpeg_pixels_launch(const void* coef, void* planes, void* out,
                                  const int32_t* geom, const int32_t* quant,
                                  void* stream) {
  Geometry g;
  g.ncomp = geom[0];
  g.width = geom[1];
  g.height = geom[2];
  g.mode = geom[3];
  g.rgb_input = geom[4];
  g.channels = geom[5];
  g.total_blocks = geom[6];
  for (int c = 0; c < 3; ++c) {
    const int32_t* p = geom + 7 + 6 * c;
    g.nbx[c] = p[0];
    g.nby[c] = p[1];
    g.offset[c] = p[2];
    g.plane_off[c] = p[3];
    g.dw[c] = p[4];
    g.dh[c] = p[5];
    for (int k = 0; k < 64; ++k) g.quant[c][k] = (int16_t)quant[c * 64 + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = (g.total_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  jpeg_idct_kernel<<<ctas, kBlocksPerCta * 8, 0, s>>>(
      static_cast<const int16_t*>(coef), static_cast<uint8_t*>(planes), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.width + kColorThreads - 1) / kColorThreads, g.height);
  jpeg_color_kernel<<<grid, kColorThreads, 0, s>>>(
      static_cast<const uint8_t*>(planes), static_cast<uint8_t*>(out), g);
  return (int)cudaGetLastError();
}
