// JPEG encoding: kernel J2, the forward pixel stage on the card, and the
// host Huffman coder.
//
// No TPU kernel is replaced: the JAX package writes its annotated images
// with PIL on the host (superviseddescent_tpu/apps/rcr_detect.py and
// rcr_track.py, Image.save). This is the port's own encoder, for frames
// that are decoded (kernel J1, jpeg_decode.cu), drawn and written without
// leaving the card until their coefficients are coded. The plain twins are
// io/jpeg_write.py::coefficients_reference (J2) and
// io/jpeg_write.py::entropy_encode (the coder); the wrapper is ops/jpeg.py.
//
// J2 (jpeg_coefficients_launch, one launch): eight threads per 8x8 block,
// 32 blocks per CUDA block, the blocks in the order the coder walks them
// (MCU after MCU, within one the components in order, each component's
// blocks row by row). Thread r of a block computes row r of its samples
// straight from the uint8 pixels: libjpeg's jccolor.c rgb_ycc_convert
// (SCALEBITS 16) of each full-resolution pixel it needs, the image's last
// column and row replicated (jcsample.c expand_right_edge, jcprepct.c's
// row group), h2v2 / h2v1 downsampling with their alternating biases, the
// component's last downsampled row repeated to the iMCU height; then the
// level shift and pass 1 of jfdctint.c jpeg_fdct_islow on its row into
// shared memory, and pass 2 on column r, quantised by q << 3 with
// jcdctmgr.c's rounding (half away from zero), eight int16 stores. A dummy
// block of an interleaved MCU (right of width_in_blocks, or below
// height_in_blocks: jccoefct.c compress_data) transforms its source block
// and keeps only the DC.
//
// What bounds J2 on this card: bytes (the pixels read once, 2.4 MB for a
// 1024 x 768 RGB frame, and the int16 coefficients written once, 2.4 MB at
// 4:2:0); its operations are ~1.3 k integer operations per block for the
// transform and quantisation and ~20 per pixel sample for the colour
// conversion and downsampling, each chroma sample recomputing the colour
// of the four pixels it averages. Everything is integer, so the kernel's
// bits equal the twin's and libjpeg-turbo's (PIL's).
//
// The coder (jpeg_huffman_encode) is bit-serial and stays on the host, as
// libjpeg's jchuff.c: encode_one_block per block with the DC predicted per
// component, the bits gathered MSB first in a 64-bit buffer, every 0xFF
// byte followed by 0x00, the last byte padded with 1-bits.
//
// Built with -DJPEG_ENCODE_HOST_ONLY by a C++ compiler, the file is the
// coder alone (the CPU tests build it with g++).

#include <stdint.h>
#include <string.h>

#ifndef JPEG_ENCODE_HOST_ONLY
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kMaxComps = 3;
constexpr int kTables = 2;

// ----------------------------------------------------------------- host
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct CodeTable {  // jpeg_make_c_derived_tbl: code and length by symbol
  uint32_t code[256];
  uint8_t size[256];
};

// bits[16], vals[256] as DHT holds them
void derive(const uint8_t* bits, const uint8_t* vals, CodeTable* t) {
  memset(t, 0, sizeof(*t));
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      t->code[vals[k]] = code;
      t->size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

struct Writer {
  uint8_t* out;
  long cap, pos = 0;
  uint64_t buf = 0;  // the low `nbits` bits are pending, MSB first
  int nbits = 0;
  bool overflow = false;
  void byte(uint8_t b) {
    if (pos + 2 > cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
    if (b == 0xFF) out[pos++] = 0;
  }
  void put(uint32_t code, int size) {  // size 0..27
    buf = (buf << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      byte((uint8_t)(buf >> nbits));
    }
  }
  void flush() {  // pad with 1-bits to a whole byte
    if (nbits) put(0x7F, 8 - nbits);
  }
};

inline int category(int v) {  // bit length of |v|
  unsigned a = (unsigned)(v < 0 ? -v : v);
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

// jchuff.c encode_one_block
void encode_block(Writer& w, const int16_t* blk, int& last_dc,
                  const CodeTable& dc, const CodeTable& ac) {
  int diff = blk[0] - last_dc;
  last_dc = blk[0];
  int n = category(diff);
  w.put(dc.code[n], dc.size[n]);
  if (n) w.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = blk[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = category(v);
    const int s = (run << 4) | n;
    w.put(ac.code[s], ac.size[s]);
    w.put((uint32_t)(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) w.put(ac.code[0], ac.size[0]);
}

#ifndef JPEG_ENCODE_HOST_ONLY
// ----------------------------------------------------------------- J2
constexpr int kBlocksPerCta = 32;  // 8 threads a block, 256 threads
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int kCompParams = 9;  // see jpeg_coefficients_launch

struct Geometry {
  int ncomp, width, height, channels, mcux, mcuy, per_mcu, total_blocks;
  int h[kMaxComps], v[kMaxComps], wib[kMaxComps], hib[kMaxComps],
      hexp[kMaxComps], vexp[kMaxComps], last_row[kMaxComps],
      first[kMaxComps], tq[kMaxComps];
  int16_t quant[kTables][64];
};

// component c (0 Y, 1 Cb, 2 Cr; a grey image's only one: the grey) of the
// pixel at (y, x), both already inside the image
__device__ __forceinline__ int component(const uint8_t* __restrict__ px,
                                         const Geometry& g, int c, int y,
                                         int x) {
  const size_t at = ((size_t)y * g.width + x) * g.channels;
  if (g.channels == 1) return px[at];
  const int r = px[at], gg = px[at + 1], b = px[at + 2];
  if (c == 0) return (19595 * r + 38470 * gg + 7471 * b + 32768) >> 16;
  if (c == 1)
    return (-11059 * r - 21709 * gg + 32768 * b + (128 << 16) + 32767) >> 16;
  return (32768 * r - 27439 * gg - 5329 * b + (128 << 16) + 32767) >> 16;
}

// jfdctint's butterfly on one row (pass 1) or column (pass 2)
__device__ __forceinline__ void fdct_1d(const int (&d)[8], int (&o)[8],
                                        bool pass1) {
  const int tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  const int tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  const int tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  const int tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int shift = pass1 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
  const int half = 1 << (shift - 1);
  if (pass1) {
    o[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    o[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
  } else {
    o[0] = (tmp10 + tmp11 + (1 << (kPass1Bits - 1))) >> kPass1Bits;
    o[4] = (tmp10 - tmp11 + (1 << (kPass1Bits - 1))) >> kPass1Bits;
  }
  int z1 = (tmp12 + tmp13) * 4433;
  o[2] = (z1 + tmp13 * 6270 + half) >> shift;
  o[6] = (z1 + tmp12 * -15137 + half) >> shift;
  z1 = tmp4 + tmp7;
  int z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int z5 = (z3 + z4) * 9633;
  const int t4 = tmp4 * 2446, t5 = tmp5 * 16819, t6 = tmp6 * 25172,
            t7 = tmp7 * 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  o[7] = (t4 + z1 + z3 + half) >> shift;
  o[5] = (t5 + z2 + z4 + half) >> shift;
  o[3] = (t6 + z2 + z3 + half) >> shift;
  o[1] = (t7 + z1 + z4 + half) >> shift;
}

__global__ void __launch_bounds__(kBlocksPerCta * 8)
    jpeg_coefficients_kernel(const uint8_t* __restrict__ px,
                             int16_t* __restrict__ out, const Geometry g) {
  __shared__ int ws[kBlocksPerCta][8 * 9];  // rows padded against conflicts
  const int local = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int b = blockIdx.x * kBlocksPerCta + local;
  if (b >= g.total_blocks) return;  // whole groups of eight leave together
  const unsigned group = 0xFFu << (threadIdx.x & 24);
  const int mcu = b / g.per_mcu, u = b - mcu * g.per_mcu;
  int c = 0;
#pragma unroll
  for (int k = 1; k < kMaxComps; ++k) c += k < g.ncomp && u >= g.first[k];
  const int h = g.h[c], in_mcu = u - g.first[c];
  const int my = mcu / g.mcux, mx = mcu - my * g.mcux;
  const int by = my * g.v[c] + in_mcu / h, bx = mx * h + in_mcu % h;
  // a dummy block transforms its source block and keeps the DC
  int sy = by, sx = bx;
  if (by >= g.hib[c]) {
    sy = g.hib[c] - 1;
    sx = min(mx * h + h - 1, g.wib[c] - 1);
  } else if (bx >= g.wib[c]) {
    sx = g.wib[c] - 1;
  }
  const bool dummy = sy != by || sx != bx;
  // row `lane` of the source block's samples
  const int hexp = g.hexp[c], vexp = g.vexp[c];
  const int i = min(sy * 8 + lane, g.last_row[c]);
  int x[8], o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = sx * 8 + k;
    int sum = 0;
    for (int dy = 0; dy < vexp; ++dy) {
      const int yy = min(i * vexp + dy, g.height - 1);
      for (int dx = 0; dx < hexp; ++dx)
        sum += component(px, g, c, yy, min(j * hexp + dx, g.width - 1));
    }
    const int n = hexp * vexp;
    const int s = n == 1 ? sum
                : n == 2 ? (sum + (j & 1)) >> 1
                         : (sum + 1 + (j & 1)) >> 2;
    x[k] = s - 128;
  }
  fdct_1d(x, o, true);
#pragma unroll
  for (int k = 0; k < 8; ++k) ws[local][lane * 9 + k] = o[k];
  __syncwarp(group);
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = ws[local][k * 9 + lane];
  fdct_1d(x, o, false);  // column `lane`
  const int16_t* q = g.quant[g.tq[c]];
  int16_t* dst = out + (size_t)b * 64;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int d = q[k * 8 + lane] << 3;
    const int a = o[k] < 0 ? -o[k] : o[k];
    const int v = (a + (d >> 1)) / d;
    dst[k * 8 + lane] =
        (int16_t)(dummy && (k | lane) ? 0 : (o[k] < 0 ? -v : v));
  }
}
#endif  // JPEG_ENCODE_HOST_ONLY

}  // namespace

// (blocks, 64) int16 coefficients in natural order, the blocks in the
// coder's order -> the scan's entropy-coded bytes in `out` (at most `cap`).
// params: ncomp, blocks per MCU, then per component (3) its blocks in an
// MCU and its table (0 or 1). huff: DC 0, AC 0, DC 1, AC 1 as 16 length
// counts and 256 symbols each. Returns the bytes written, or -1 when `cap`
// is too small.
extern "C" int jpeg_huffman_encode(const int16_t* coef, int blocks,
                                   const int32_t* params, const uint8_t* huff,
                                   uint8_t* out, int cap) {
  const int ncomp = params[0], per_mcu = params[1];
  CodeTable tables[2 * kTables];
  for (int t = 0; t < 2 * kTables; ++t)
    derive(huff + t * 272, huff + t * 272 + 16, &tables[t]);
  int unit[16], last_dc[kMaxComps] = {0, 0, 0};
  for (int c = 0, k = 0; c < ncomp; ++c)
    for (int n = 0; n < params[2 + 2 * c]; ++n) unit[k++] = c;
  Writer w{out, cap};
  for (int b = 0; b < blocks; ++b) {
    const int c = unit[b % per_mcu], t = params[3 + 2 * c];
    encode_block(w, coef + (size_t)b * 64, last_dc[c], tables[2 * t],
                 tables[2 * t + 1]);
  }
  w.flush();
  return w.overflow ? -1 : (int)w.pos;
}

#ifndef JPEG_ENCODE_HOST_ONLY
// J2: pixels (device, height x width x channels uint8) -> out (device,
// blocks x 64 int16, the coder's order, natural order within a block).
// geom: ncomp, width, height, channels, mcux, mcuy, blocks per MCU, total
// blocks, then per component (3) h, v, width_in_blocks, height_in_blocks,
// its horizontal and vertical expansion, its last downsampled row, its
// first block in an MCU and its table.
// quant: 2 x 64 quantisers, natural order.
extern "C" int jpeg_coefficients_launch(const void* pixels, void* out,
                                        const int32_t* geom,
                                        const int32_t* quant, void* stream) {
  Geometry g;
  g.ncomp = geom[0];
  g.width = geom[1];
  g.height = geom[2];
  g.channels = geom[3];
  g.mcux = geom[4];
  g.mcuy = geom[5];
  g.per_mcu = geom[6];
  g.total_blocks = geom[7];
  for (int c = 0; c < kMaxComps; ++c) {
    const int32_t* p = geom + 8 + kCompParams * c;
    g.h[c] = p[0];
    g.v[c] = p[1];
    g.wib[c] = p[2];
    g.hib[c] = p[3];
    g.hexp[c] = p[4];
    g.vexp[c] = p[5];
    g.last_row[c] = p[6];
    g.first[c] = p[7];
    g.tq[c] = p[8];
  }
  for (int t = 0; t < kTables; ++t)
    for (int k = 0; k < 64; ++k) g.quant[t][k] = (int16_t)quant[t * 64 + k];
  const int ctas = (g.total_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  jpeg_coefficients_kernel<<<ctas, kBlocksPerCta * 8, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pixels), static_cast<int16_t*>(out), g);
  return (int)cudaGetLastError();
}
#endif  // JPEG_ENCODE_HOST_ONLY
