// The fused RCR kernels' shared pieces: the window sources, the level's IED
// and patch half, K2's taps, the cell tent supports and a cell's block
// factors and Uoctti channels (used by the cascade kernels K3 / K4,
// cascade_fused.cu, and the feature extractors K5 / K6, features_fused.cu),
// and the per-landmark body of K5 / K6: for one
// landmark, sampling -> gradients -> separable cell splat -> block energies
// -> Uoctti channels, with float32 buffers. The caller says where the
// 16 * C * C channel values go and as what type. See ops/cascade_fused.py
// for the numerics.
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do. Both splat contractions sum
// in increasing pixel order, as the plain twins do, so partials and cell
// histograms equal the twins' bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused {

constexpr int kThreads = 256;
constexpr int kOrient = 4;             // sector binning: 8 directed bins
constexpr int kBins = 2 * kOrient;
constexpr int kDims = 3 * kOrient + 4;  // Uoctti channels
constexpr int kLevelInts = 5;          // S, W, WX, cell size, tent offset

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_pixel(const uint8_t* p, int64_t i) {
  return (float)p[i];
}
__device__ __forceinline__ float load_pixel(const __nv_bfloat16* p,
                                            int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_channel(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_channel(float* p, float v) { *p = v; }

// K3's and K5's source: per-face windows inside the uint8 frame stack.
struct FramesSource {
  using pixel_t = uint8_t;
  const uint8_t* frames;
  const int* idx;
  const int* oy;
  const int* ox;
  int n_img, h, w;
  // face n's window and its row stride, or nullptr when the frame index or
  // the origin lies outside the stack (the face then gets a row of NaN)
  __device__ const uint8_t* window(int64_t n, int ry, int rx,
                                   int64_t* stride) const {
    const int i = idx[n], y = oy[n], x = ox[n];
    *stride = w;
    if (i < 0 || i >= n_img || y < 0 || y > h - ry || x < 0 || x > w - rx)
      return nullptr;
    return frames + ((int64_t)i * h + y) * w + x;
  }
};

// K4's and K6's source: (N, RY, RX) bf16 windows.
struct WindowsSource {
  using pixel_t = __nv_bfloat16;
  const __nv_bfloat16* windows;
  __device__ const __nv_bfloat16* window(int64_t n, int ry, int rx,
                                         int64_t* stride) const {
    *stride = rx;
    return windows + n * (int64_t)ry * rx;
  }
};

__host__ __device__ inline int take(int* at, int bytes) {
  int here = *at;
  *at += (bytes + 15) / 16 * 16;
  return here;
}

// Shared buffers of one landmark's body, each 16-byte aligned, laid out
// from byte offset `at` on; the wrappers' _shared_bytes counts the same.
struct BodyLayout {
  int ytap, xtap, yw0, yw1, xw0, xw1, tent, img, mag, part, cells, energy,
      bin;
  __host__ __device__ BodyLayout(int* at, int c, int s) {
    ytap = take(at, s * 4);
    xtap = take(at, s * 4);
    yw0 = take(at, s * 4);
    yw1 = take(at, s * 4);
    xw0 = take(at, s * 4);
    xw1 = take(at, s * 4);
    tent = take(at, s * c * 4);
    img = take(at, s * s * 4);
    mag = take(at, s * s * 4);
    part = take(at, kBins * c * s * 4);
    cells = take(at, kBins * c * c * 4);
    energy = take(at, c * c * 4);
    bin = take(at, s * s);
  }
};

struct BodyBuffers {
  int* ytap;
  int* xtap;
  float* yw0;
  float* yw1;
  float* xw0;
  float* xw1;
  float* tent;
  float* img;
  float* mag;
  float* part;
  float* cells;
  float* energy;
  int8_t* bin;
  __device__ BodyBuffers(unsigned char* smem, const BodyLayout& lay)
      : ytap(reinterpret_cast<int*>(smem + lay.ytap)),
        xtap(reinterpret_cast<int*>(smem + lay.xtap)),
        yw0(reinterpret_cast<float*>(smem + lay.yw0)),
        yw1(reinterpret_cast<float*>(smem + lay.yw1)),
        xw0(reinterpret_cast<float*>(smem + lay.xw0)),
        xw1(reinterpret_cast<float*>(smem + lay.xw1)),
        tent(reinterpret_cast<float*>(smem + lay.tent)),
        img(reinterpret_cast<float*>(smem + lay.img)),
        mag(reinterpret_cast<float*>(smem + lay.mag)),
        part(reinterpret_cast<float*>(smem + lay.part)),
        cells(reinterpret_cast<float*>(smem + lay.cells)),
        energy(reinterpret_cast<float*>(smem + lay.energy)),
        bin(reinterpret_cast<int8_t*>(smem + lay.bin)) {}
};

// One level's static configuration and the scalars of one face's row.
struct LevelGeometry {
  int s, w, wx, cs;   // patch side, row / column sub-window, cell size
  int ry, rx, c;      // window shape, cells per side
  int quantize;
  float phw, st, hi, src0;  // patch half, resize step, last source, first
  __device__ void set_patch_half(float half) {
    phw = half;
    st = 2.f * phw / (float)s;
    hi = 2.f * phw - 1.f;
    src0 = fminf(fmaxf(0.5f * st - 0.5f, 0.f), hi);
  }
};

// IED of a landmark row [x..., y...] (each eye the mean of its landmarks)
// and the level's patch half: round(rel * IED / 2) half up, at least 1,
// capped by what the sub-windows cover after their origins floor to 8 rows
// and 128 columns (max_patch_half, max_patch_half_x). One thread runs it.
// ied_out may be null where the caller needs the patch half only.
__device__ inline void level_ied_patch_half(const float* xs, int l,
                                            const int* eyes, float rel, int w,
                                            int wx, int rx, float* ied_out,
                                            float* phw_out) {
  const int nr = eyes[0], nl = eyes[1];
  float rex = 0.f, rey = 0.f, lex = 0.f, ley = 0.f;
  for (int i = 0; i < nr; ++i) {
    rex = rex + xs[eyes[2 + i]];
    rey = rey + xs[eyes[2 + i] + l];
  }
  for (int i = 0; i < nl; ++i) {
    lex = lex + xs[eyes[2 + nr + i]];
    ley = ley + xs[eyes[2 + nr + i] + l];
  }
  rex = rex / (float)nr;
  rey = rey / (float)nr;
  lex = lex / (float)nl;
  ley = ley / (float)nl;
  const float dx = rex - lex, dy = rey - ley;
  const float ied = sqrtf(dx * dx + dy * dy);
  float phw = fmaxf(floorf(rel * ied / 2.f + 0.5f), 1.f);
  phw = fminf(phw, (float)(w - 8 - 2) / 2.f);
  if (wx != rx) phw = fminf(phw, (float)(wx - 128 - 2) / 2.f);
  if (ied_out != nullptr) *ied_out = ied;
  *phw_out = phw;
}

// Taps of one axis, as K2: first tap index in the sub-window and the two
// bf16-rounded tent weights, zeroed where the tap lies outside [0, span).
__device__ __forceinline__ void tap(float start, float src, float origin,
                                    int span, int* i0, float* t0,
                                    float* t1) {
  float coord = (start + src) - origin;
  float u0 = floorf(coord);
  float a = round_bf16(fmaxf(1.f - fabsf(coord - u0), 0.f));
  float b = round_bf16(fmaxf(1.f - fabsf(coord - (u0 + 1.f)), 0.f));
  int u = (int)u0;
  *i0 = u;
  *t0 = (u >= 0 && u < span) ? a : 0.f;
  *t1 = (u + 1 >= 0 && u + 1 < span) ? b : 0.f;
}

// Tent support [lo, hi] of cell c along one axis: the interior pixels p with
// |(p + 0.5)/cs - 0.5 - c| < 1 (every other tent weight is 0).
__device__ __forceinline__ void support(int c, int cs, int s, int* lo,
                                        int* hi) {
  int a = (2 * c - 1) * cs - 1;
  int b = (2 * c + 3) * cs - 1;
  int l = a >= 0 ? a / 2 + 1 : 0;
  int h = (b - 1) / 2;
  *lo = max(l, 1);
  *hi = min(h, s - 2);
}

// The block factors and the 16 Uoctti channels of cell q = cx * C + cy:
// cells holds the (2O, C, C) histograms, energy(cell) a cell's energy (its
// O terms summed in order). Stores dst[d * C * C + q]. K3 / K4 and K5 / K6
// both run it, so their channels are one arithmetic.
template <typename Energy, typename Out>
__device__ __forceinline__ void cell_channels(int q, int c,
                                              const float* cells,
                                              Energy energy, Out* dst) {
  const int cc = c * c;
  const int ccx = q / c, ccy = q - ccx * c;
  float factor[4];
  for (int i = 0; i < 4; ++i) {
    // factor i: blocks at x offset (i & 1) - 1, y offset (i >> 1) - 1;
    // the x pair at each y first, then the two y sums
    const int ax = (i & 1) - 1, ay = (i >> 1) - 1;
    const int xa = min(max(ccx + ax, 0), c - 1);
    const int xb = min(max(ccx + ax + 1, 0), c - 1);
    const int ya = min(max(ccy + ay, 0), c - 1);
    const int yb = min(max(ccy + ay + 1, 0), c - 1);
    const float total = (energy(xa * c + ya) + energy(xb * c + ya)) +
                        (energy(xa * c + yb) + energy(xb * c + yb));
    factor[i] = 1.f / sqrtf(total + 1e-4f);
  }
  float t_acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int o = 0; o < kOrient; ++o) {
    const float ha = cells[o * cc + q];
    const float hb = cells[(o + kOrient) * cc + q];
    float ha_s = 0.f, hb_s = 0.f, hc_s = 0.f;
    for (int i = 0; i < 4; ++i) {
      const float hai = factor[i] * ha;
      const float hbi = factor[i] * hb;
      const float hci = fminf(hai + hbi, 0.2f);
      ha_s = ha_s + fminf(hai, 0.2f);
      hb_s = hb_s + fminf(hbi, 0.2f);
      hc_s = hc_s + hci;
      t_acc[i] = t_acc[i] + hci;
    }
    store_channel(dst + o * cc + q, 0.5f * ha_s);
    store_channel(dst + (o + kOrient) * cc + q, 0.5f * hb_s);
    store_channel(dst + (o + 2 * kOrient) * cc + q, 0.5f * hc_s);
  }
  const float scale_t = 1.f / sqrtf(18.f);  // computed in float32
  for (int i = 0; i < 4; ++i)
    store_channel(dst + (3 * kOrient + i) * cc + q, t_acc[i] * scale_t);
}

// The body of one landmark at (cx, cy) in window coordinates: the whole
// block samples the S x S patch from `win`, then computes its Uoctti
// channels and stores them at dst[d * C * C + cx * C + cy]. k.tent holds
// the level's (S, C) tent. Ends without a barrier after the channel stores:
// a following call first rewrites the taps, which nothing here reads any
// more, and rewrites cells and energy only after three more barriers.
template <typename Pixel, typename Out>
__device__ void landmark_channels(const Pixel* win, int64_t stride, float cx,
                                  float cy, const LevelGeometry& g,
                                  const BodyBuffers& k, Out* dst) {
  const int s = g.s, w = g.w, wx = g.wx, c = g.c, cs = g.cs;
  const int cc = c * c;
  // ---- sub-window origins and taps (K2's tap plan) ----
  const float by = rintf(cy) - g.phw;
  const float bx = rintf(cx) - g.phw;
  int oyw = (int)fminf(fmaxf(floorf(by + g.src0), 0.f), (float)(g.ry - w));
  oyw = (oyw / 8) * 8;
  int oxw = 0;
  if (wx != g.rx) {
    oxw = (int)fminf(fmaxf(floorf(bx + g.src0), 0.f), (float)(g.rx - wx));
    oxw = (oxw / 128) * 128;
  }
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    float sj = fminf(fmaxf(((float)j + 0.5f) * g.st - 0.5f, 0.f), g.hi);
    tap(by, sj, (float)oyw, w, &k.ytap[j], &k.yw0[j], &k.yw1[j]);
    tap(bx, sj, (float)oxw, wx, &k.xtap[j], &k.xw0[j], &k.xw1[j]);
  }
  __syncthreads();

  // ---- sampling: the x pass first, its partials rounded to bf16 ----
  const Pixel* sub = win + oyw * stride + oxw;
  for (int p = threadIdx.x; p < s * s; p += blockDim.x) {
    const int j = p / s, i = p % s;  // y, x
    const int v = k.ytap[j], u = k.xtap[i];
    const float ty0 = k.yw0[j], ty1 = k.yw1[j];
    const float tx0 = k.xw0[i], tx1 = k.xw1[i];
    // a pixel is read only where its weight is non-zero: a zero-weight
    // tap may lie outside the window
    const int64_t r0 = (int64_t)v * stride, r1 = r0 + stride;
    float p00 = ty0 * tx0 != 0.f ? load_pixel(sub, r0 + u) : 0.f;
    float p01 = ty0 * tx1 != 0.f ? load_pixel(sub, r0 + u + 1) : 0.f;
    float p10 = ty1 * tx0 != 0.f ? load_pixel(sub, r1 + u) : 0.f;
    float p11 = ty1 * tx1 != 0.f ? load_pixel(sub, r1 + u + 1) : 0.f;
    float q0 = round_bf16(tx0 * p00 + tx1 * p01);
    float q1 = round_bf16(tx0 * p10 + tx1 * p11);
    float val = q0 * ty0 + q1 * ty1;
    if (g.quantize) val = fminf(fmaxf(floorf(val + 0.5f), 0.f), 255.f);
    k.img[p] = val;  // (y, x)
  }
  __syncthreads();

  // ---- gradients, bf16 magnitudes and sector bins (interior) ----
  for (int p = threadIdx.x; p < s * s; p += blockDim.x) {
    const int y = p / s, x = p % s;
    float m = 0.f;
    int b = -1;
    if (y >= 1 && y <= s - 2 && x >= 1 && x <= s - 2) {
      const float gx = k.img[p + 1] - k.img[p - 1];
      const float gy = k.img[p + s] - k.img[p - s];
      m = round_bf16(sqrtf(gx * gx + gy * gy));
      const float ax = fabsf(gx), ay = fabsf(gy);
      const bool px = gx >= 0.f, py = gy >= 0.f;
      if (ay < ax * 0.41421356237f) {
        b = px ? 0 : 4;
      } else if (ay > ax * 2.41421356237f) {
        b = py ? 2 : 6;
      } else {
        b = (px == py) ? (px ? 1 : 5) : (py ? 3 : 7);
      }
    }
    k.mag[p] = m;
    k.bin[p] = (int8_t)b;
  }
  __syncthreads();

  // ---- x contraction: part[bin][cx][y], summed in increasing x ----
  for (int t = threadIdx.x; t < c * s; t += blockDim.x) {
    const int ccx = t / s, y = t % s;
    int lo, hi_x;
    support(ccx, cs, s, &lo, &hi_x);
    float acc[kBins];
#pragma unroll
    for (int o = 0; o < kBins; ++o) acc[o] = 0.f;
    for (int x = lo; x <= hi_x; ++x) {
      const int p = y * s + x;
      const int b = k.bin[p];
      const float v = k.tent[x * c + ccx] * k.mag[p];
#pragma unroll
      for (int o = 0; o < kBins; ++o)
        if (o == b) acc[o] = acc[o] + v;
    }
#pragma unroll
    for (int o = 0; o < kBins; ++o)
      k.part[(o * c + ccx) * s + y] = round_bf16(acc[o]);
  }
  __syncthreads();

  // ---- y contraction: cells[bin][cx][cy], summed in increasing y ----
  for (int t = threadIdx.x; t < kBins * cc; t += blockDim.x) {
    const int row = t / c, ccy = t % c;  // row = bin * C + cx
    int lo, hi_y;
    support(ccy, cs, s, &lo, &hi_y);
    const float* a = k.part + row * s;
    float acc = 0.f;
    for (int y = lo; y <= hi_y; ++y) acc = acc + a[y] * k.tent[y * c + ccy];
    k.cells[t] = acc;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < cc; t += blockDim.x) {
    float e = 0.f;
    for (int q = 0; q < kOrient; ++q) {
      const float f = k.cells[q * cc + t] + k.cells[(q + kOrient) * cc + t];
      e = e + f * f;
    }
    k.energy[t] = e;
  }
  __syncthreads();

  // ---- block factors and Uoctti channels ----
  for (int t = threadIdx.x; t < cc; t += blockDim.x)
    cell_channels(t, c, k.cells, [&](int cell) { return k.energy[cell]; },
                  dst);
}

}  // namespace fused
