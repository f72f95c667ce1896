// The fused RCR kernels' shared pieces: the window sources, the level's IED
// and patch half, K2's taps, the cell tent supports and a cell's block
// factors and Uoctti channels, used by the cascade kernels K3 / K4
// (cascade_fused.cu) and the feature extractors K5 / K6
// (features_fused.cu). See ops/cascade_fused.py for the numerics.
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused {

constexpr int kOrient = 4;             // sector binning: 8 directed bins
constexpr int kBins = 2 * kOrient;
constexpr int kDims = 3 * kOrient + 4;  // Uoctti channels
constexpr int kLevelInts = 5;          // S, W, WX, cell size, tent offset

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

}  // namespace fused
