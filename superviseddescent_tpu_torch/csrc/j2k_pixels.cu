// Kernels D1 and M1: the pixel stage of JPEG 2000 reading (ops/j2k.py).
//
// No TPU kernel is replaced: the JAX package reads images with PIL on the
// host (superviseddescent_tpu/ops/patches.py::load_gray_image), and PIL
// reads JPEG 2000 with OpenJPEG. The host C++ stage (csrc/j2k_decode.cu)
// writes every tile-component's plane of coefficients in OpenJPEG's band
// layout; these two kernels turn them into PIL's pixels.
//
// D1 (j2k_idwt_launch): OpenJPEG's inverse wavelet transform of every
// tile-component, level by level from the coarsest, rows then columns
// (opj_dwt_decode_tile / opj_dwt_decode_real). 5/3 is OpenJPEG's integer
// lifting, 9/7 its float32 lifting in opj_v8dwt_decode's order and
// constants (low samples times K, high ones times its 2 / K of
// 1.625732422, then delta, gamma, beta and alpha, each (left + right) * c
// added; -fmad=false keeps every rounding apart). A line of one sample is
// left as it is, but halved toward zero for 5/3 at an odd origin, as
// OpenJPEG does. A level reads 4 bytes a sample and writes 4: a 768 x 1024
// frame of 5 levels moves 18.9 MB (5.6 us at 3.35 TB/s). What bounds it on
// this card is the chain of dependent levels, each a launch whose CTAs
// load, lift rows, lift columns and store, and the instructions of the
// lifting (-fmad=false keeps 9/7's three operations a tap apart). The
// plan (ops/j2k.idwt_plan, one table uploaded once a read) takes one
// launch of j2k_idwt_tile_kernel a level, every tile-component's at once
// (on an H100 a CTA a tile-component's small levels in shared memory, in
// one launch, took longer at 1 to 24 tile-components, 1% less at 36): a
// CTA a tile of the level's output (64 x 32 by default, at most 64 x 64),
// staged with a halo of 2 samples each side for 5/3 and 4 for 9/7 from the
// four bands that feed it: each row of the window is two runs of consecutive
// samples (its low and its high columns), read in 16-byte pieces where
// aligned and lanes on consecutive addresses, four pieces in flight a
// thread. The halo's rows and columns are lifted again by every CTA that
// needs them, with the same operations in the same order, so the bits are
// the same; the k-th lifting step spoils k samples in from a cut edge of
// the window, and the halo covers the steps. A level never writes in
// place: it reads its LL band from the buffer the last level wrote and its
// detail bands from the planes, and writes the other of two buffers (the
// output and a scratch plane; the last level writes the output). A plane
// with no levels is copied, a tile a CTA, in the first launch. A thread
// lifts 8 outputs of a line and their halo in registers (lift_pass), so no
// barrier separates the lifting steps; the tile's columns go out with a
// warp's lanes on consecutive columns: each row of it in whole sectors. No
// pass reads or writes device memory at a row's stride, no line has to
// fit in shared memory, and a read takes one launch a level.
//
// M1 (j2k_colour_launch): the synthesised planes to PIL's pixels: the
// sample Pillow's unpacker reads for each channel (its rows of w / dx
// samples, the tile's data as OpenJPEG lays it out, zero past its end), the
// inverse RCT or ICT where the tile has one, the DC level shift and the
// clamp to the precision (a 9/7 sample rounded half to even, as lrintf),
// the sample's bytes as OpenJPEG hands them to PIL, Pillow's shift to 8
// (or 16) bits, then grey, P / PA through the palette, I;16 clipped, sRGB,
// sYCC through PIL's YCbCr tables or CMYK through PIL's cmyk2rgb, and for
// one channel L as it is or OpenCV's grey. It reads 4 bytes a sample and
// writes 3 a pixel. A CTA takes a band of output rows inside one tile
// (ops/j2k.colour_launch's grid); it reads the tile's geometry and the
// components' precision, sign, subsampling and plane offsets once, and
// all its index arithmetic is 32-bit. Two paths of one kernel, chosen by
// the plan:
//
// * common (every channel's component unsubsampled, so channel c reads
//   component c at the pixel's own place): a thread takes 4 adjacent
//   pixels, reads each component's samples once (16 bytes where aligned),
//   applies the component transform once for all three channels;
// * general (Pillow's subsampled unpacking): a thread takes 4 adjacent
//   pixels and finds each channel's sample as Pillow's unpacker does.
//
// Either way the band's bytes are staged in shared memory and leave in
// 16-byte stores, only each row's ragged head and tail byte by byte.
//
// Measurement builds, never entry points (chip_smoke.py's
// j2k_kernel_times): -DJ2K_IDWT_NO_LIFT stages and writes back with no
// lifting step; -DJ2K_COLOUR_NO_STORE keeps M1's global stores only behind
// a run-time test that never passes; -DJ2K_EMPTY returns at once from
// every kernel on the same grids (the launch floor).
//
// Every entry point returns cudaGetLastError(), or the error of a plan it
// refuses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ops/j2k.py's table layouts
constexpr int kLevelCols = 16, kTileCtaCols = 2 + kLevelCols;
enum { kHost = 0, kOut = 1, kScratch = 2 };
// a tiled launch's threads (on an H100, 128 took the 9/7 clip frame from
// 0.0411-0.0417 ms to 0.0433-0.0441 and the 5/3 one from 0.0335-0.0336 to
// 0.0323-0.0325)
constexpr int kTileThreads = 256;
// the largest tile and halo (ops/j2k.IDWT_MAX_TILE, IDWT_MAX_HALO)
constexpr int kMaxTileW = 64, kMaxTileH = 64, kMaxHalo = 4;
constexpr int kWinW = kMaxTileW + 2 * kMaxHalo;
constexpr int kWinH = kMaxTileH + 2 * kMaxHalo;

constexpr float kK = 1.230174105f, kTwoInvK = 1.625732422f;

// OpenJPEG's four 9/7 lifting steps, each (left + right) * c added
__device__ __forceinline__ float step97(int s) {
  return s == 0 ? -0.443506852f
                : s == 1 ? -0.882911075f : s == 2 ? 0.052980118f : 1.586134342f;
}

struct Level {
  int off, W, rw, rh, snh, snv, cash, casv, rev, src, dst, tiles_x, tw, th,
      halo, copy;
};

__device__ __forceinline__ Level level_from(const int32_t* p) {
  Level L;
  L.off = p[0];
  L.W = p[1];
  L.rw = p[2];
  L.rh = p[3];
  L.snh = p[4];
  L.snv = p[5];
  L.cash = p[6];
  L.casv = p[7];
  L.rev = p[8];
  L.src = p[9];
  L.dst = p[10];
  L.tiles_x = p[11];
  L.tw = p[12];
  L.th = p[13];
  L.halo = p[14];
  L.copy = p[15];
  return L;
}

// f(o, i) for o < outer, i < inner: item o * inner + i to thread item %
// threads, the thread's row and column stepped (one division a call)
template <typename F>
__device__ __forceinline__ void for_each_2d(int outer, int inner, F f) {
  if (outer <= 0 || inner <= 0) return;
  const int T = blockDim.x;
  const int dq = T / inner, dr = T - dq * inner;
  int o = (int)threadIdx.x / inner, i = (int)threadIdx.x - o * inner;
  while (o < outer) {
    f(o, i);
    i += dr;
    o += dq;
    if (i >= inner) {
      i -= inner;
      ++o;
    }
  }
}

// 9/7's scaling of a sample of a line longer than one: K for a low sample,
// 2 / K for a high one
__device__ __forceinline__ int32_t scaled(int32_t v, bool high) {
  return __float_as_int(__int_as_float(v) * (high ? kTwoInvK : kK));
}

// a thread lifts kSeg output samples of a line at a time in registers: the
// segment and Taps::H samples each side (the halo of the steps: the k-th
// step spoils k samples in from where the samples it was given end), one
// more where the segment's first position has the other parity than the
// line's low samples, so that even k are low samples and odd k high ones
constexpr int kSeg = 8;
template <bool rev>
struct Taps {
  static constexpr int H = rev ? 2 : 4;
  static constexpr int N = kSeg + 2 * H + 1;
};

// position q of a line of n >= 2 samples extended by whole-sample symmetry:
// lifting the extended line gives OpenJPEG's mirrored neighbours at its ends
// (one reflection at each end, more only for lines shorter than the halo)
__device__ __forceinline__ int reflect(int q, int n) {
  if (q < 0) q = -q;
  if (q >= n) q = 2 * (n - 1) - q;
  if (q >= 0 && q < n) return q;
  const int period = 2 * (n - 1);
  q %= period;
  if (q < 0) q += period;
  return q < n ? q : period - q;
}

// OpenJPEG's synthesis of x (even k low samples, odd k high ones): 9/7's
// scaling where ``scale`` (else its caller staged the samples scaled), then
// the lifting steps, each over the positions with both neighbours in x
template <bool rev>
__device__ __forceinline__ void lift(int32_t (&x)[Taps<rev>::N], bool scale) {
#ifdef J2K_IDWT_NO_LIFT
  return;
#endif
  constexpr int N = Taps<rev>::N;
  if (rev) {
#pragma unroll
    for (int k = 2; k < N - 1; k += 2) x[k] -= (x[k - 1] + x[k + 1] + 2) >> 2;
#pragma unroll
    for (int k = 1; k < N - 1; k += 2) x[k] += (x[k - 1] + x[k + 1]) >> 1;
  } else {
    float f[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      f[k] = __int_as_float(x[k]);
      if (scale) f[k] = f[k] * ((k & 1) ? kTwoInvK : kK);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float c = step97(s);
#pragma unroll
      for (int k = (s & 1) ? 1 : 2; k < N - 1; k += 2) {
        float t = f[k - 1] + f[k + 1];
        t = t * c;
        f[k] = f[k] + t;
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = __float_as_int(f[k]);
  }
}

// one pass (a level's rows or its columns) over lines of interleaved
// samples in shared memory: line i's position q (of a line of n, present
// for q in [lo, hi)) at in[i * in_line + (q - lo) * pos], pos = POS where
// it is known at compile time (else POS 0 and the argument in_pos); its
// output positions [o0, o1) handed to put(i, q, value). A thread takes a
// segment of kSeg outputs of a line (consecutive threads on consecutive
// lines), gathers the segment and its halo, lifts them in registers and
// hands on the segment: no barrier between steps. A line of one sample is
// left as it is, but halved toward zero for 5/3 at an odd origin (cas).
template <bool rev, int POS, typename Put>
__device__ __forceinline__ void lift_pass(const int32_t* in, int in_line,
                                          int in_pos, int lines, int n,
                                          int lo, int hi, int o0, int o1,
                                          int cas, bool scale, Put put) {
  constexpr int H = Taps<rev>::H, N = Taps<rev>::N;
  const int pos = POS ? POS : in_pos;
  if (n == 1) {
    for (int i = threadIdx.x; i < lines; i += blockDim.x) {
      int32_t v = in[i * in_line];
      if (rev && cas) v /= 2;
      put(i, 0, v);
    }
    return;
  }
  const int segs = (o1 - o0 + kSeg - 1) / kSeg;
  for_each_2d(segs, lines, [&](int s, int i) {
    const int s0 = o0 + s * kSeg;
    const int q0 = s0 - H - ((s0 - H - cas) & 1);  // q0 = cas (mod 2)
    int32_t x[N];
    if (q0 >= lo && q0 + N <= hi) {
      const int32_t* p = in + i * in_line + (q0 - lo) * pos;
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = p[k * pos];
    } else {
      // past a true end the line's reflection; past a cut end of [lo, hi)
      // the last sample there (its results lie outside the tile)
      const int32_t* line = in + i * in_line;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        int q = q0 + k;
        if (q < 0 || q >= n) q = reflect(q, n);
        q = min(max(q, lo), hi - 1);
        x[k] = line[(q - lo) * pos];
      }
    }
    lift<rev>(x, scale);
    const bool shifted = s0 - q0 != H;
    if (s0 + kSeg <= o1) {
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
        put(i, s0 + j, shifted ? x[H + 1 + j] : x[H + j]);
    } else {
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
        if (s0 + j < o1) put(i, s0 + j, shifted ? x[H + 1 + j] : x[H + j]);
    }
  });
}

// 4-sample pieces a run of n samples spans, their boundaries on 16-byte
// addresses: piece q holds the run's samples e0 .. e0 + 3 (e0 = 4 q - the
// run's misalignment), read whole where it lies inside the run
__device__ __forceinline__ int misalignment(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// a tiled launch: a CTA a tile of one level's output; its row holds the
// level's (one round trip for both)
constexpr int kWinPitch = kWinW + 1, kRowPitch = kMaxTileW + 1;
__global__ void __launch_bounds__(kTileThreads)
    j2k_idwt_tile_kernel(const int32_t* __restrict__ host, int32_t* out,
                         int32_t* scratch, const int32_t* __restrict__ table,
                         int start) {
#ifdef J2K_EMPTY
  return;
#endif
  // the window (the tile and its halo, interleaved), and its rows lifted
  // at the tile's columns
  extern __shared__ int32_t tsmem[];
  int32_t* S = tsmem;
  int32_t* B = tsmem + kWinH * kWinPitch;
  const int32_t* me = table + start + blockIdx.x * kTileCtaCols;
  const Level L = level_from(me + 2);
  const int ty = me[1] / L.tiles_x, tx = me[1] - ty * L.tiles_x;
  const int X0 = tx * L.tw, Y0 = ty * L.th;
  const int X1 = min(X0 + L.tw, L.rw), Y1 = min(Y0 + L.th, L.rh);
  if (L.copy) {  // a plane with no levels: the tile copied, in rows
    int32_t* dst = L.dst == kOut ? out : scratch;
    for_each_2d(Y1 - Y0, X1 - X0, [&](int i, int c) {
      const int at = L.off + (Y0 + i) * L.W + X0 + c;
      dst[at] = __ldg(host + at);
    });
    return;
  }
  const int h = L.halo;
  // the window, cut at the level's edges
  const int ca = max(X0 - h, 0), cb = min(X1 + h, L.rw);
  const int ra = max(Y0 - h, 0), rb = min(Y1 + h, L.rh);
  const int32_t* ll = L.src == kHost ? host : L.src == kOut ? out : scratch;
  int32_t* dst = L.dst == kOut ? out : scratch;
  // the window's low columns are low-band samples jl0 .. jl1 - 1, its high
  // ones high-band samples jh0 .. jh1 - 1: each a run in a band row, read
  // in 16-byte pieces where aligned, a thread's pieces all in flight
  const int jl0 = (ca - L.cash + 1) >> 1, jl1 = (cb - L.cash + 1) >> 1;
  const int jh0 = (ca + L.cash) >> 1, jh1 = (cb + L.cash) >> 1;
  const int pieces = (((cb - ca + 1) >> 1) + 3) / 4 + 1;
  const int items = (rb - ra) * 2 * pieces;
  const bool scale = !L.rev && L.rw > 1;
  constexpr int kBatch = 4;
  for (int base = threadIdx.x; base < items; base += kBatch * kTileThreads) {
    int4 v[kBatch];
    int at[kBatch], e0[kBatch], n[kBatch];
    bool high[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int item = base + u * kTileThreads;
      const int i = item / (2 * pieces), q = item - i * 2 * pieces;
      const int r = ra + i;
      const bool low_row = ((r ^ L.casv) & 1) == 0;
      const int R = low_row ? (r - L.casv) >> 1
                            : L.snv + ((r - 1 + L.casv) >> 1);
      high[u] = q >= pieces;
      const int j0 = high[u] ? jh0 : jl0;
      n[u] = item < items ? (high[u] ? jh1 : jl1) - j0 : 0;
      const int32_t* run = (low_row && !high[u] ? ll : host) + L.off +
                           R * L.W + (high[u] ? L.snh : 0) + j0;
      e0[u] = 4 * (high[u] ? q - pieces : q) - misalignment(run);
      // sample j of the run at the window's column 2 j + its parity
      at[u] = i * kWinPitch + 2 * j0 + (high[u] ? 1 - L.cash : L.cash) - ca;
      if (e0[u] >= 0 && e0[u] + 4 <= n[u]) {
        v[u] = __ldg(reinterpret_cast<const int4*>(run + e0[u]));
      } else {
        const int e = e0[u];
        v[u].x = (e >= 0 && e < n[u]) ? __ldg(run + e) : 0;
        v[u].y = (e + 1 >= 0 && e + 1 < n[u]) ? __ldg(run + e + 1) : 0;
        v[u].z = (e + 2 >= 0 && e + 2 < n[u]) ? __ldg(run + e + 2) : 0;
        v[u].w = (e + 3 >= 0 && e + 3 < n[u]) ? __ldg(run + e + 3) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = e0[u] + t;
        if (e >= 0 && e < n[u])
          S[at[u] + 2 * e] = scale ? scaled(w[t], high[u]) : w[t];
      }
    }
  }
  __syncthreads();
  // rows of the window at the tile's columns into B, then the tile's
  // columns out to device memory, a warp's lanes on consecutive columns
  auto rows_out = [&](int i, int c, int32_t v) { B[i * kRowPitch + c - X0] = v; };
  auto cols_out = [&](int i, int r, int32_t v) {
    dst[L.off + r * L.W + X0 + i] = v;
  };
  if (L.rev) {
    lift_pass<true, 1>(S, kWinPitch, 1, rb - ra, L.rw, ca, cb, X0, X1,
                       L.cash, false, rows_out);
    __syncthreads();
    lift_pass<true, kRowPitch>(B, 1, kRowPitch, X1 - X0, L.rh, ra, rb, Y0,
                               Y1, L.casv, false, cols_out);
  } else {
    lift_pass<false, 1>(S, kWinPitch, 1, rb - ra, L.rw, ca, cb, X0, X1,
                        L.cash, false, rows_out);
    __syncthreads();
    lift_pass<false, kRowPitch>(B, 1, kRowPitch, X1 - X0, L.rh, ra, rb, Y0,
                                Y1, L.casv, true, cols_out);
  }
}

// M1's table (ops/j2k.colour_launch): a header of 16 ints, the components
// (4 of 4 ints: precision, signed, dx, dy), the palette (256 x 3), PIL's
// four YCbCr tables (4 x 256), then the CTAs (kColourCtaCols ints each:
// the tile, the band's first output row and rows, its first and end
// output columns, then the tile's row of kTileRow ints: its origin on the
// reference grid, its width and height, the component transform, per
// component its plane's offset, its samples and 5/3 or 9/7)
enum {
  kHW, kHH, kHX0, kHY0, kHNcomp, kHKind, kHModeL, kHPaletted, kHWanted,
  kHBits
};
constexpr int kCompsAt = 16, kPaletteAt = 32, kYccAt = 32 + 768,
              kColourCtasAt = 32 + 768 + 1024, kTileRow = 20,
              kColourCtaCols = 5 + kTileRow;
// the CTAs an SM must hold at once (the register budget: four keep it at
// 64 registers; on an H100 one let it take 104, and a 768 x 1024 RGB frame
// took 0.0146 ms against 0.0106; six took 0.0117)
constexpr int kColourThreads = 256, kColourMinBlocks = 4, kParams = 64;
// a tile row: origin, size, transform, then per component
enum { kTX0, kTY0, kTW, kTH, kTMct, kTOff = 5, kTSize = 9, kTRev = 13 };

// a sample after the DC level shift and the clamp to the precision (a 9/7
// sample rounded half to even), as the bytes OpenJPEG hands to PIL
__device__ __forceinline__ uint32_t to_word(bool rev, int32_t vi, float vf,
                                            int prec, int sgnd) {
  const int lo = sgnd ? -(1 << (prec - 1)) : 0;
  const int hi = sgnd ? (1 << (prec - 1)) - 1 : (1 << prec) - 1;
  const int shift = sgnd ? 0 : 1 << (prec - 1);
  int v;
  if (rev) {
    v = min(max(vi, lo - shift), hi - shift) + shift;
  } else if (vf > 2147483647.0f) {
    v = hi;
  } else if (vf < -2147483648.0f) {
    v = lo;
  } else {
    v = min(max(__float2int_rn(vf), lo - shift), hi - shift) + shift;
  }
  const int bytes = (prec + 7) >> 3;
  return (uint32_t)v & (bytes >= 4 ? 0xffffffffu : (1u << (8 * bytes)) - 1);
}

// Pillow's shift of a channel's word to ``bits``
__device__ __forceinline__ uint32_t pillow(uint32_t word, int prec, int sgnd,
                                           int bits) {
  const int sh = bits - prec;
  uint32_t off = sgnd ? 1u << (prec - 1) : 0u;
  uint32_t v;
  if (sh < 0) {
    off += 1u << (-sh - 1);
    v = (off + word) >> (-sh);
  } else {
    v = (off + word) << sh;
  }
  return v & ((1u << bits) - 1);
}

// the inverse RCT or ICT of component m of (a, b, c)
__device__ __forceinline__ void transform(bool rev, int m, int32_t a,
                                          int32_t b, int32_t c, int32_t& vi,
                                          float& vf) {
  if (rev) {
    const int32_t g = a - ((b + c) >> 2);
    vi = m == 0 ? c + g : m == 1 ? g : b + g;
  } else {
    const float y = __int_as_float(a), u = __int_as_float(b),
                v = __int_as_float(c);
    if (m == 0) {
      vf = y + v * 1.402f;
    } else if (m == 1) {
      const float t = y - u * 0.34413f;
      vf = t - v * 0.71414f;
    } else {
      vf = y + u * 1.772f;
    }
  }
}

// the pixel's output bytes from its channels: RGB (3) or grey (1)
template <int channels>
__device__ __forceinline__ uint32_t colour(const int32_t* P,
                                           const int32_t* __restrict__ table,
                                           const uint32_t chan[4]) {
  const int kind = P[kHKind];
  int r, g, b;
  if (kind == 0) {
    if (P[kHPaletted]) {
      const int32_t* pal = table + kPaletteAt + 3 * chan[0];
      r = __ldg(pal);
      g = __ldg(pal + 1);
      b = __ldg(pal + 2);
    } else {
      r = g = b = (int)chan[0];
    }
  } else if (kind == 1) {
    r = g = b = chan[0] > 255 ? 255 : (int)chan[0];
  } else if (kind == 2) {
    r = chan[0];
    g = chan[1];
    b = chan[2];
  } else if (kind == 3) {
    const int32_t* ycc = table + kYccAt;
    const int yy = chan[0], cb = chan[1], cr = chan[2];
    r = yy + (__ldg(ycc + cr) >> 6);
    g = yy + ((__ldg(ycc + 256 + cb) + __ldg(ycc + 512 + cr)) >> 6);
    b = yy + (__ldg(ycc + 768 + cb) >> 6);
    r = r < 0 ? 0 : r > 255 ? 255 : r;
    g = g < 0 ? 0 : g > 255 ? 255 : g;
    b = b < 0 ? 0 : b > 255 ? 255 : b;
  } else {
    const int nk = 255 - (int)chan[3];
    int tt = (int)chan[0] * nk + 128;
    r = nk - (((tt >> 8) + tt) >> 8);
    tt = (int)chan[1] * nk + 128;
    g = nk - (((tt >> 8) + tt) >> 8);
    tt = (int)chan[2] * nk + 128;
    b = nk - (((tt >> 8) + tt) >> 8);
  }
  if (channels == 3) return (uint32_t)(r & 255) | (uint32_t)(g & 255) << 8 |
                            (uint32_t)(b & 255) << 16;
  if (P[kHModeL]) return chan[0] & 255;
  return (uint32_t)((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14) & 255;
}

template <bool common, int channels>
__global__ void __launch_bounds__(kColourThreads, kColourMinBlocks)
    j2k_colour_kernel(const int32_t* __restrict__ coeffs,
                      const int32_t* __restrict__ table,
                      uint8_t* __restrict__ out) {
#ifdef J2K_EMPTY
  return;
#endif
  // the header, the components and the tile, apart from the staged bytes
  // (so that no store to those makes the compiler read them again)
  __shared__ int32_t P[kParams];
  extern __shared__ __align__(16) uint8_t staged[];
  const int32_t* cta = table + kColourCtasAt + blockIdx.x * kColourCtaCols;
  const int Y0 = cta[1], rows = cta[2], Xs = cta[3], Xe = cta[4];
  if (threadIdx.x < 32) {
    P[threadIdx.x] = table[threadIdx.x];
  } else if (threadIdx.x < 32 + kTileRow) {
    P[threadIdx.x] = cta[5 + threadIdx.x - 32];
  }
  __syncthreads();
  const int32_t* T = P + 32;
  const int W = P[kHW], ncomp = P[kHNcomp], wanted = P[kHWanted],
            bits = P[kHBits];
  const int w = T[kTW], h = T[kTH];
  const bool mct = T[kTMct] && ncomp >= 3;
  const int x_at = Xs + P[kHX0] - T[kTX0];   // the span's first x in the tile
  const int y_at = Y0 + P[kHY0] - T[kTY0];
  const int n = Xe - Xs;
  const int pitch = (n * channels + 15 + 15) & ~15;
  const int gx0 = x_at & ~3;
  const int groups = (x_at + n - gx0 + 3) >> 2;
  // the tile's data as Pillow indexes it (general path): each component's
  // samples after the last's (components m from cum_m), each channel's
  // rows of w / dx
  const int cum1 = T[kTSize], cum2 = cum1 + (ncomp > 1 ? T[kTSize + 1] : 0);
  const int cum3 = cum2 + (ncomp > 2 ? T[kTSize + 2] : 0);
  const int total = cum3 + (ncomp > 3 ? T[kTSize + 3] : 0);
  for_each_2d(rows, groups, [&](int i, int g) {
    const int y = y_at + i;
    const int xg = gx0 + 4 * g;
    uint32_t px[4];
    if (common) {
      // channel c reads component c at the pixel's place (y w + x)
      int32_t v[4][4];
      const int loads = mct ? max(wanted, 3) : wanted;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m >= loads) break;
        const int32_t* p = coeffs + T[kTOff + m] + y * w + xg;
        if (xg >= x_at && xg + 4 <= x_at + n && misalignment(p) == 0) {
          const int4 q = __ldg(reinterpret_cast<const int4*>(p));
          v[m][0] = q.x;
          v[m][1] = q.y;
          v[m][2] = q.z;
          v[m][3] = q.w;
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int x = xg + t;
            v[m][t] = (x >= x_at && x < x_at + n) ? __ldg(p + t) : 0;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t chan[4] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= wanted) break;
          int32_t vi = v[c][t];
          float vf = __int_as_float(vi);
          if (mct && c < 3) transform(T[kTRev], c, v[0][t], v[1][t], v[2][t],
                                      vi, vf);
          const int32_t* cp = P + kCompsAt + 4 * c;
          chan[c] = pillow(to_word(T[kTRev + c], vi, vf, cp[0], cp[1]), cp[0],
                           cp[1], bits);
        }
        px[t] = colour<channels>(P, table, chan);
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int x = xg + t;
        uint32_t chan[4] = {0, 0, 0, 0};
        if (x >= x_at && x < x_at + n) {
          int start = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c >= wanted) break;
            const int32_t* cp = P + kCompsAt + 4 * c;
            const int dx = cp[2], dy = cp[3];
            const int k = start + (y / dy) * (w / dx) + x / dx;
            uint32_t word = 0;
            if (k < total) {
              const int m = (ncomp > 1 && k >= cum1) + (ncomp > 2 && k >= cum2)
                            + (ncomp > 3 && k >= cum3);
              const int j = k - (m == 0 ? 0 : m == 1 ? cum1 : m == 2 ? cum2
                                                                     : cum3);
              auto at = [&](int q) {
                const int size = T[kTSize + q];
                return __ldg(coeffs + T[kTOff + q] + (j < size ? j : size - 1));
              };
              int32_t vi = at(m);
              float vf = __int_as_float(vi);
              if (mct && m < 3) transform(T[kTRev + m], m, at(0), at(1), at(2),
                                          vi, vf);
              const int32_t* mp = P + kCompsAt + 4 * m;
              word = to_word(T[kTRev + m], vi, vf, mp[0], mp[1]);
            }
            chan[c] = pillow(word, cp[0], cp[1], bits);
            start += (h / dy) * (w / dx);
          }
        }
        px[t] = colour<channels>(P, table, chan);
      }
    }
    // into the staged row: byte b of the row's output at staged + i pitch
    // + its address's misalignment + b, words where the item is whole
    const uint8_t* d = out + ((Y0 + i) * W + Xs) * channels;
    const int mis = (int)(reinterpret_cast<uintptr_t>(d) & 15);
    const int b0 = (xg - x_at) * channels;
    uint8_t* s = staged + i * pitch + mis + b0;
    if (xg >= x_at && xg + 4 <= x_at + n && ((mis + b0) & 3) == 0) {
      if (channels == 3) {
        uint32_t* s32 = reinterpret_cast<uint32_t*>(s);
        s32[0] = px[0] | px[1] << 24;
        s32[1] = px[1] >> 8 | px[2] << 16;
        s32[2] = px[2] >> 16 | px[3] << 8;
      } else {
        *reinterpret_cast<uint32_t*>(s) =
            px[0] | px[1] << 8 | px[2] << 16 | px[3] << 24;
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int x = xg + t;
        if (x < x_at || x >= x_at + n) continue;
#pragma unroll
        for (int c = 0; c < channels; ++c)
          s[t * channels + c] = (uint8_t)(px[t] >> (8 * c));
      }
    }
  });
  __syncthreads();
  // each row out: the ragged head byte by byte, 16-byte stores from its
  // first 16-byte-aligned address to its last, the ragged tail byte by byte
  const int bytes = n * channels;
  for (int i = 0; i < rows; ++i) {
    uint8_t* d = out + ((Y0 + i) * W + Xs) * channels;
    const int mis = (int)(reinterpret_cast<uintptr_t>(d) & 15);
    const uint8_t* s = staged + i * pitch + mis;
    const int head = min((16 - mis) & 15, bytes);
    const int words = (bytes - head) >> 4, tail = head + 16 * words;
#ifdef J2K_COLOUR_NO_STORE
    if (bytes > 0) return;  // always: built, never run
#endif
    for (int q = threadIdx.x; q < words; q += kColourThreads)
      *reinterpret_cast<uint4*>(d + head + 16 * q) =
          *reinterpret_cast<const uint4*>(s + head + 16 * q);
    const int t = threadIdx.x;
    if (t < head + (bytes - tail)) {
      const int b = t < head ? t : tail + t - head;
      d[b] = s[b];
    }
  }
}

template <bool common, int channels>
cudaError_t colour_launch(const void* coeffs, const void* table, int ctas,
                          int shared, void* out, cudaStream_t stream) {
  auto kernel = j2k_colour_kernel<common, channels>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kColourThreads, shared, stream>>>(
      (const int32_t*)coeffs, (const int32_t*)table, (uint8_t*)out);
  return cudaGetLastError();
}

}  // namespace

// D1: one launch of the plan (ops/j2k.IdwtPlan), its ``ctas`` CTA rows
// from int ``start`` of the table
extern "C" int j2k_idwt_launch(const void* host, void* out, void* scratch,
                               const void* table, int start, int ctas,
                               void* stream) {
  if (ctas <= 0) return 0;
  const int bytes = (kWinH * kWinPitch + kWinH * kRowPitch) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      j2k_idwt_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  j2k_idwt_tile_kernel<<<ctas, kTileThreads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)host, (int32_t*)out, (int32_t*)scratch,
      (const int32_t*)table, start);
  return (int)cudaGetLastError();
}

// M1: ``ctas`` CTAs of the table's grid, the common or the general path,
// RGB (3) or grey (1), ``shared`` bytes of shared memory
extern "C" int j2k_colour_launch(const void* coeffs, const void* table,
                                 int ctas, int common, int channels,
                                 int shared, void* out, void* stream) {
  if (ctas <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (common) {
    err = channels == 3
              ? colour_launch<true, 3>(coeffs, table, ctas, shared, out, s)
              : colour_launch<true, 1>(coeffs, table, ctas, shared, out, s);
  } else {
    err = channels == 3
              ? colour_launch<false, 3>(coeffs, table, ctas, shared, out, s)
              : colour_launch<false, 1>(coeffs, table, ctas, shared, out, s);
  }
  return (int)err;
}
