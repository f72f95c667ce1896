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
// J2 (jpeg_coefficients_launch, one launch): one CTA per strip of MCUs,
// one MCU row high and `strip` MCUs wide (ops/jpeg.J2_STRIP, by blocks per
// MCU), whose blocks are one contiguous range of the output in the coder's
// order (MCU after MCU, within one the components in order, each
// component's blocks row by row). In four phases, all in shared memory:
//   1. staging: the strip's 8 x vmax pixel rows, the image's last row
//      repeated (jcprepct.c's row group) and, past its right edge, its last
//      column (jcsample.c expand_right_edge), copied with 16-byte cp.async
//      where the rows allow it (8- or 4-byte, else byte by byte at the
//      image's right edge), and the quantisers with their magics (1 KB
//      from ops/jpeg.quant_on_card, through the L1, which every CTA
//      reads);
//   2. colour: each pixel converted once (jccolor.c rgb_ycc_convert,
//      SCALEBITS 16) into full-resolution Y, Cb and Cr planes, four pixels a
//      thread (a grey image is staged straight into its plane);
//   3. transform: eight threads a block. Thread r forms row r of its
//      block's samples from the planes (h2v2 / h2v1 downsampling with their
//      alternating biases, the component's last downsampled row repeated to
//      the iMCU height), runs pass 1 of jfdctint.c jpeg_fdct_islow on it
//      into shared memory and pass 2 on column r, and quantises by d =
//      q << 3 with jcdctmgr.c's rounding (half away from zero) as one
//      __umulhi by the divisor's magic reciprocal (ops/jpeg.quant_magic,
//      equal to the division for every value the transform can give). A
//      dummy block of an interleaved MCU (right of width_in_blocks, or
//      below height_in_blocks: jccoefct.c compress_data) transforms its
//      source block, which lies in the same MCU, and keeps only the DC;
//   4. stores: the strip's blocks, gathered in shared memory, go out in
//      16-byte coalesced stores.
// Measurement builds: -DJPEG_ENCODE_LAUNCH_ONLY returns at once,
// -DJPEG_ENCODE_STAGE_ONLY stops after phase 2, -DJPEG_ENCODE_SKIP_STORE
// leaves out phase 4 (both keep the work they do), -DJPEG_ENCODE_TIMELINE
// records each CTA's phases on the global timer.
//
// What bounds J2 on this card: bytes (the pixels read once, 2.4 MB for a
// 1024 x 768 RGB frame, and the int16 coefficients written once, 2.4 MB at
// 4:2:0); its operations are ~1.2 k integer operations per block and ~30
// per pixel. Tensor cores do not fit: islow rounds between its two passes
// (and descales each output on its own), which a matrix product cannot do,
// and its products of up to 16-bit constants overflow int8 operands.
// Everything is integer, so the kernel's bits equal the twin's and
// libjpeg-turbo's (PIL's).
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
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int kCompParams = 9;  // see jpeg_coefficients_launch
constexpr int kMaxThreads = 512;

struct Geometry {
  int ncomp, width, height, channels, mcux, mcuy, per_mcu, total_blocks;
  int strip, threads, hmax, vmax;  // MCUs a CTA takes, its threads
  int h[kMaxComps], v[kMaxComps], wib[kMaxComps], hib[kMaxComps],
      hexp[kMaxComps], vexp[kMaxComps], last_row[kMaxComps],
      first[kMaxComps], tq[kMaxComps];
};

// A CTA's shared memory, in bytes from its start (the same on the host,
// which sizes the launch, and on the card)
struct Smem {
  int rows, cols;        // the strip's full-resolution pixels
  int plane_stride;      // a Y / Cb / Cr plane's row, padded
  int pix_stride;        // a staged RGB row
  int quant, planes, pix, ws, stage, bytes;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline Smem smem_layout(const Geometry& g) {
  Smem s;
  s.rows = 8 * g.vmax;
  s.cols = 8 * g.hmax * g.strip;
  // rows 16 bytes apart modulo 128: the eight rows of a block that the
  // lanes of a group read at once fall in different banks
  s.plane_stride = round_up(s.cols, 128) + 16;
  s.pix_stride = round_up(s.cols * 3, 16);
  s.quant = 0;  // the quantisers, then their magics (int32 each)
  s.planes = s.quant + kTables * 64 * 8;
  s.pix = s.planes + g.ncomp * s.rows * s.plane_stride;
  s.ws = s.pix + (g.channels == 3 ? s.rows * s.pix_stride : 0);
  s.stage = s.ws + (g.threads / 8) * 72 * 4;
  s.bytes = s.stage + g.strip * g.per_mcu * 128;
  return s;
}

// a copy of `bytes` (4, 8 or 16) from device memory into shared memory
// that skips the registers
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// the same for 16 bytes, through the SM's L1
__device__ __forceinline__ void copy_async_l1(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// jccolor.c rgb_ycc_convert of one pixel
__device__ __forceinline__ void rgb_ycc(int r, int g, int b, uint32_t& y,
                                        uint32_t& cb, uint32_t& cr) {
  y = (uint32_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
  cb = (uint32_t)((-11059 * r - 21709 * g + 32768 * b + (128 << 16) +
                   32767) >> 16);
  cr = (uint32_t)((32768 * r - 27439 * g - 5329 * b + (128 << 16) +
                   32767) >> 16);
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

__device__ __forceinline__ int byte_of(uint32_t w, int k) {
  return (int)((w >> (8 * k)) & 0xFF);
}

#ifdef JPEG_ENCODE_TIMELINE
// the measurement build's clock: thread 0 of each CTA writes the global
// timer (ns) at the start and after each phase into the output's first
// 64-bit words (4 a CTA), and the stores are left out
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

// One CTA per strip of g.strip MCUs of one MCU row (fewer at the right
// edge): the strip's blocks are one contiguous range of the output.
__global__ void __launch_bounds__(kMaxThreads)
    jpeg_coefficients_kernel(const uint8_t* __restrict__ px,
                             const int32_t* __restrict__ tables,
                             int16_t* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
#ifdef JPEG_ENCODE_LAUNCH_ONLY
  return;  // the launch's own time: grid, threads and shared memory
#endif
  TIMELINE(0);
  const Smem L = smem_layout(g);
  const int* quant = reinterpret_cast<const int*>(smem + L.quant);
  uint8_t* planes = smem + L.planes;
  int* ws = reinterpret_cast<int*>(smem + L.ws);
  int16_t* stage = reinterpret_cast<int16_t*>(smem + L.stage);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int strips = (g.mcux + g.strip - 1) / g.strip;
  const int my = blockIdx.x / strips;
  const int mx0 = (blockIdx.x - my * strips) * g.strip;
  const int mcus = min(g.strip, g.mcux - mx0);
  const int rows = L.rows, cols = mcus * 8 * g.hmax;
  const int x0 = mx0 * 8 * g.hmax, y0 = my * 8 * g.vmax;
  const int ch = g.channels;
  // the quantisers and their magics, 1 KB, beside the pixels (through the
  // SM's L1: every CTA reads the same table, and the CTAs of one SM then
  // fetch it from the L2 once)
  for (int i = tid; i < kTables * 64 * 8 / 16; i += nthreads)
    copy_async_l1(smem + L.quant + i * 16, tables + i * 4);

  // 1. the strip's pixel rows into shared memory, the image's last row
  // and column replicated (jcprepct.c, jcsample.c expand_right_edge): a
  // grey image straight into its plane, RGB interleaved
  uint8_t* dst0 = ch == 1 ? planes : smem + L.pix;
  const int dstride = ch == 1 ? L.plane_stride : L.pix_stride;
  const int row_bytes = cols * ch;
  const size_t image_row = (size_t)g.width * ch;
  int vec = 16;
  while (vec >= 4 &&
         (image_row % vec || row_bytes % vec || (x0 * ch) % vec ||
          reinterpret_cast<uintptr_t>(px) % vec))
    vec >>= 1;
  if (x0 + cols <= g.width && vec >= 4) {
    const int per_row = row_bytes / vec;
    for (int i = tid; i < rows * per_row; i += nthreads) {
      const int r = i / per_row, k = i - r * per_row;
      const int y = min(y0 + r, g.height - 1);
      copy_async(dst0 + r * dstride + k * vec,
                 px + y * image_row + (size_t)x0 * ch + k * vec, vec);
    }
  } else {
    for (int i = tid; i < rows * row_bytes; i += nthreads) {
      const int r = i / row_bytes, k = i - r * row_bytes;
      const int t = k / ch, c = k - t * ch;
      const int y = min(y0 + r, g.height - 1), x = min(x0 + t, g.width - 1);
      dst0[r * dstride + k] = px[((size_t)y * g.width + x) * ch + c];
    }
  }
  copy_async_wait();
  __syncthreads();
  TIMELINE(1);

  // 2. each pixel's colour once, four pixels a thread: three 4-byte reads
  // of R G B, one 4-byte store into each of the Y, Cb and Cr planes
  const int plane_bytes = rows * L.plane_stride;
  if (ch == 3) {
    const int quads = cols / 4;
    for (int i = tid; i < rows * quads; i += nthreads) {
      const int r = i / quads, q = i - r * quads;
      const uint32_t* s = reinterpret_cast<const uint32_t*>(
          smem + L.pix + r * L.pix_stride + q * 12);
      const uint32_t w[3] = {s[0], s[1], s[2]};
      uint32_t yw = 0, cbw = 0, crw = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int at = 3 * p;
        uint32_t y, cb, cr;
        rgb_ycc(byte_of(w[at >> 2], at & 3),
                byte_of(w[(at + 1) >> 2], (at + 1) & 3),
                byte_of(w[(at + 2) >> 2], (at + 2) & 3), y, cb, cr);
        yw |= y << (8 * p);
        cbw |= cb << (8 * p);
        crw |= cr << (8 * p);
      }
      uint8_t* d = planes + r * L.plane_stride + q * 4;
      *reinterpret_cast<uint32_t*>(d) = yw;
      *reinterpret_cast<uint32_t*>(d + plane_bytes) = cbw;
      *reinterpret_cast<uint32_t*>(d + 2 * plane_bytes) = crw;
    }
    __syncthreads();
  }
  TIMELINE(2);

#ifndef JPEG_ENCODE_STAGE_ONLY
  // 3. eight threads a block, the blocks in the coder's order: thread r
  // forms row r of its block's samples (downsampling from the planes),
  // pass 1 on it into `ws`, then pass 2 on column r, quantised into
  // `stage`
  const int nb = mcus * g.per_mcu;
  const int group = tid >> 3, lane = tid & 7;
  const unsigned gmask = 0xFFu << (tid & 24);
  int* w = ws + group * 72;  // rows padded against bank conflicts
  for (int lb = group; lb < nb; lb += nthreads >> 3) {
    const int m = lb / g.per_mcu, u = lb - m * g.per_mcu;
    int c = 0;
#pragma unroll
    for (int k = 1; k < kMaxComps; ++k) c += k < g.ncomp && u >= g.first[k];
    const int h = g.h[c], v = g.v[c], in_mcu = u - g.first[c];
    const int mx = mx0 + m;
    const int by = my * v + in_mcu / h, bx = mx * h + in_mcu % h;
    // a dummy block (jccoefct.c compress_data) transforms its source
    // block, which lies in the same MCU, and keeps the DC
    int sy = by, sx = bx;
    if (by >= g.hib[c]) {
      sy = g.hib[c] - 1;
      sx = min(mx * h + h - 1, g.wib[c] - 1);
    } else if (bx >= g.wib[c]) {
      sx = g.wib[c] - 1;
    }
    const bool dummy = sy != by || sx != bx;
    // row `lane` of the source block in the strip's samples: rows below
    // the component's last downsampled row repeat it
    const int li = min(sy * 8 + lane, g.last_row[c]) - my * v * 8;
    const int lj = (sx - mx0 * h) * 8;
    const uint8_t* plane = planes + c * plane_bytes;
    int x[8], o[8];
    if (g.hexp[c] == 1) {  // the component as it is
      const uint2 a = *reinterpret_cast<const uint2*>(
          plane + li * L.plane_stride + lj);
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = byte_of(k < 4 ? a.x : a.y, k & 3);
    } else {  // h2v1 (bias 0, 1) or h2v2 (bias 1, 2) along the row
      const int v2 = g.vexp[c] == 2;
      const uint8_t* r0 = plane + (li << v2) * L.plane_stride + 2 * lj;
      const uint4 a = *reinterpret_cast<const uint4*>(r0);
      const uint4 b = *reinterpret_cast<const uint4*>(
          r0 + v2 * L.plane_stride);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int s0 = byte_of(aw[k >> 1], 2 * (k & 1)) +
                       byte_of(aw[k >> 1], 2 * (k & 1) + 1);
        const int s1 = byte_of(bw[k >> 1], 2 * (k & 1)) +
                       byte_of(bw[k >> 1], 2 * (k & 1) + 1);
        x[k] = v2 ? (s0 + s1 + 1 + (k & 1)) >> 2 : (s0 + (k & 1)) >> 1;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] -= 128;
    fdct_1d(x, o, true);
#pragma unroll
    for (int k = 0; k < 8; ++k) w[lane * 9 + k] = o[k];
    __syncwarp(gmask);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = w[k * 9 + lane];
    __syncwarp(gmask);  // `w` is free for the group's next block
    fdct_1d(x, o, false);  // column `lane`
    // jcdctmgr.c: (|o| + d / 2) / d by d = q << 3, rounded half away
    // from zero, as one multiply by the divisor's magic reciprocal
    const int* qt = quant + g.tq[c] * 64;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int d = qt[k * 8 + lane] << 3;
      const int a = o[k] < 0 ? -o[k] : o[k];
      const int q = (int)__umulhi((uint32_t)(a + (d >> 1)),
                                  (uint32_t)qt[kTables * 64 + k * 8 + lane]);
      stage[lb * 64 + k * 8 + lane] =
          (int16_t)(dummy && (k | lane) ? 0 : (o[k] < 0 ? -q : q));
    }
  }
  __syncthreads();
  TIMELINE(3);

  // 4. the strip's blocks, contiguous in the output, in 16-byte stores
  const uint4* src = reinterpret_cast<const uint4*>(stage);
  uint4* dst = reinterpret_cast<uint4*>(
      out + (size_t)(my * g.mcux + mx0) * g.per_mcu * 64);
#if defined(JPEG_ENCODE_SKIP_STORE) || defined(JPEG_ENCODE_TIMELINE)
  if (g.total_blocks < 0)  // never: the stores are left out, not the work
#endif
    for (int i = tid; i < nb * 8; i += nthreads) dst[i] = src[i];
#else
  if (g.total_blocks < 0) out[tid] = planes[tid];  // never: keeps the work
#endif  // JPEG_ENCODE_STAGE_ONLY
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
// first block in an MCU and its table; then the launch plan (MCUs a CTA
// takes, its threads) and the MCU's largest sampling factors.
// tables (device): 2 x 64 quantisers, then their 2 x 64 magic
// reciprocals, natural order, int32 (ops/jpeg.quant_on_card).
extern "C" int jpeg_coefficients_launch(const void* pixels, void* out,
                                        const int32_t* geom,
                                        const void* tables, void* stream) {
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
  const int32_t* plan = geom + 8 + kCompParams * kMaxComps;
  g.strip = plan[0];
  g.threads = plan[1];
  g.hmax = plan[2];
  g.vmax = plan[3];
  if (g.strip < 1 || g.threads < 32 || g.threads > kMaxThreads ||
      g.threads % 32)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_layout(g).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jpeg_coefficients_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int ctas = g.mcuy * ((g.mcux + g.strip - 1) / g.strip);
  jpeg_coefficients_kernel<<<ctas, g.threads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pixels),
      static_cast<const int32_t*>(tables), static_cast<int16_t*>(out), g);
  return (int)cudaGetLastError();
}
#endif  // JPEG_ENCODE_HOST_ONLY
