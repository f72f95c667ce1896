// K3 / K4: the whole RCR cascade of one face in one thread block.
//
// Replaces superviseddescent_tpu/ops/cascade_pallas.py::
// detect_cascade_fused_frames (K3, _cascade_frames_kernel) and
// detect_cascade_fused (K4, _cascade_kernel). See ops/cascade_fused.py for
// the contract, the numerics, the plain PyTorch twin, and what bounds the
// kernels on the H100.
//
// One block per face loops over the levels; per landmark it samples the
// S x S patch (K2's fast, transposed two-tap sampling), computes gradient
// magnitudes and sector bins, the x partials of the separable cell splat,
// the cell histograms and the Uoctti channels, and writes them into the
// face's bf16 feature row in shared memory. Then each warp takes output
// rows of the level's regressor (a GEMV over bf16 weights, f32 sums, a fixed
// shuffle tree) and the landmark row is updated in shared memory. The window
// source is a template: K3 reads uint8 pixels straight from the frame stack
// at per-face (frame, row, column) origins, K4 reads bf16 windows.
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do. Both splat contractions sum
// in increasing pixel order, as the twin does, so partials and cell
// histograms equal the twin's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// K3's source: per-face windows inside the uint8 frame stack.
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

// K4's source: (N, RY, RX) bf16 windows.
struct WindowsSource {
  using pixel_t = __nv_bfloat16;
  const __nv_bfloat16* windows;
  __device__ const __nv_bfloat16* window(int64_t n, int ry, int rx,
                                         int64_t* stride) const {
    *stride = rx;
    return windows + n * (int64_t)ry * rx;
  }
};

// Byte offsets of the block's shared buffers, each 16-byte aligned; the
// wrapper's _shared_bytes lays them out the same way.
struct Layout {
  int feat, xs, upd, scal, ytap, xtap, yw0, yw1, xw0, xw1, tent, img, mag,
      part, cells, energy, bin, total;
  __host__ __device__ static int take(int* at, int bytes) {
    int here = *at;
    *at += (bytes + 15) / 16 * 16;
    return here;
  }
  __host__ __device__ Layout(int l, int c, int fp, int s) {
    int at = 0;
    feat = take(&at, fp * 2);
    xs = take(&at, 2 * l * 4);
    upd = take(&at, 2 * l * 4);
    scal = take(&at, 4 * 4);
    ytap = take(&at, s * 4);
    xtap = take(&at, s * 4);
    yw0 = take(&at, s * 4);
    yw1 = take(&at, s * 4);
    xw0 = take(&at, s * 4);
    xw1 = take(&at, s * 4);
    tent = take(&at, s * c * 4);
    img = take(&at, s * s * 4);
    mag = take(&at, s * s * 4);
    part = take(&at, kBins * c * s * 4);
    cells = take(&at, kBins * c * c * 4);
    energy = take(&at, c * c * 4);
    bin = take(&at, s * s);
    total = at;
  }
};

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

template <typename Source>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(Source src, const float* __restrict__ x0,
               float* __restrict__ out,
               const __nv_bfloat16* __restrict__ weights,
               const int* __restrict__ level_i,
               const float* __restrict__ level_rel,
               const float* __restrict__ tents, const int* __restrict__ eyes,
               int n_levels, int l, int c, int ry, int rx, int fp,
               int quantize, int s_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(l, c, fp, s_max);
  __nv_bfloat16* feat = reinterpret_cast<__nv_bfloat16*>(smem + lay.feat);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* upd = reinterpret_cast<float*>(smem + lay.upd);
  float* scal = reinterpret_cast<float*>(smem + lay.scal);
  int* ytap = reinterpret_cast<int*>(smem + lay.ytap);
  int* xtap = reinterpret_cast<int*>(smem + lay.xtap);
  float* yw0 = reinterpret_cast<float*>(smem + lay.yw0);
  float* yw1 = reinterpret_cast<float*>(smem + lay.yw1);
  float* xw0 = reinterpret_cast<float*>(smem + lay.xw0);
  float* xw1 = reinterpret_cast<float*>(smem + lay.xw1);
  float* tent = reinterpret_cast<float*>(smem + lay.tent);
  float* img = reinterpret_cast<float*>(smem + lay.img);
  float* mag = reinterpret_cast<float*>(smem + lay.mag);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* cells = reinterpret_cast<float*>(smem + lay.cells);
  float* energy = reinterpret_cast<float*>(smem + lay.energy);
  int8_t* bin = reinterpret_cast<int8_t*>(smem + lay.bin);

  const int64_t face = blockIdx.x;
  const int l2 = 2 * l;
  const int cc = c * c;
  const int nfeat = l * kDims * cc + 1;
  int64_t stride;
  const typename Source::pixel_t* win = src.window(face, ry, rx, &stride);
  if (win == nullptr) {
    for (int k = threadIdx.x; k < l2; k += blockDim.x)
      out[face * l2 + k] = __int_as_float(0x7fc00000);
    return;
  }
  for (int k = threadIdx.x; k < l2; k += blockDim.x)
    xs[k] = x0[face * l2 + k];
  // bias 1 and zero padding; every other entry is rewritten per level
  for (int k = nfeat - 1 + threadIdx.x; k < fp; k += blockDim.x)
    feat[k] = __float2bfloat16_rn(k == nfeat - 1 ? 1.f : 0.f);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;

  for (int li = 0; li < n_levels; ++li) {
    const int s = level_i[li * kLevelInts + 0];
    const int w = level_i[li * kLevelInts + 1];
    const int wx = level_i[li * kLevelInts + 2];
    const int cs = level_i[li * kLevelInts + 3];
    const float* level_tent = tents + level_i[li * kLevelInts + 4];
    for (int k = threadIdx.x; k < s * c; k += blockDim.x)
      tent[k] = level_tent[k];
    __syncthreads();  // xs of the previous level's update
    if (threadIdx.x == 0) {
      // IED of the row before this level's update: each eye the mean of
      // its landmarks
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
      float phw = fmaxf(floorf(level_rel[li] * ied / 2.f + 0.5f), 1.f);
      // what the sub-windows cover after their origins floor to 8 rows and
      // 128 columns (max_patch_half, max_patch_half_x)
      phw = fminf(phw, (float)(w - 8 - 2) / 2.f);
      if (wx != rx) phw = fminf(phw, (float)(wx - 128 - 2) / 2.f);
      scal[0] = ied;
      scal[1] = phw;
    }
    __syncthreads();
    const float ied = scal[0], phw = scal[1];
    const float st = 2.f * phw / (float)s;
    const float hi = 2.f * phw - 1.f;
    const float src0 = fminf(fmaxf(0.5f * st - 0.5f, 0.f), hi);

    for (int lm = 0; lm < l; ++lm) {
      // ---- sub-window origins and taps (K2's tap plan) ----
      const float by = rintf(xs[lm + l]) - phw;
      const float bx = rintf(xs[lm]) - phw;
      int oyw = (int)fminf(fmaxf(floorf(by + src0), 0.f), (float)(ry - w));
      oyw = (oyw / 8) * 8;
      int oxw = 0;
      if (wx != rx) {
        oxw = (int)fminf(fmaxf(floorf(bx + src0), 0.f), (float)(rx - wx));
        oxw = (oxw / 128) * 128;
      }
      for (int j = threadIdx.x; j < s; j += blockDim.x) {
        float sj = fminf(fmaxf(((float)j + 0.5f) * st - 0.5f, 0.f), hi);
        tap(by, sj, (float)oyw, w, &ytap[j], &yw0[j], &yw1[j]);
        tap(bx, sj, (float)oxw, wx, &xtap[j], &xw0[j], &xw1[j]);
      }
      __syncthreads();

      // ---- sampling: the x pass first, its partials rounded to bf16 ----
      const typename Source::pixel_t* sub = win + oyw * stride + oxw;
      for (int p = threadIdx.x; p < s * s; p += blockDim.x) {
        const int j = p / s, i = p % s;  // y, x
        const int v = ytap[j], u = xtap[i];
        const float ty0 = yw0[j], ty1 = yw1[j], tx0 = xw0[i], tx1 = xw1[i];
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
        if (quantize) val = fminf(fmaxf(floorf(val + 0.5f), 0.f), 255.f);
        img[p] = val;  // (y, x)
      }
      __syncthreads();

      // ---- gradients, bf16 magnitudes and sector bins (interior) ----
      for (int p = threadIdx.x; p < s * s; p += blockDim.x) {
        const int y = p / s, x = p % s;
        float g = 0.f;
        int b = -1;
        if (y >= 1 && y <= s - 2 && x >= 1 && x <= s - 2) {
          const float gx = img[p + 1] - img[p - 1];
          const float gy = img[p + s] - img[p - s];
          g = round_bf16(sqrtf(gx * gx + gy * gy));
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
        mag[p] = g;
        bin[p] = (int8_t)b;
      }
      __syncthreads();

      // ---- x contraction: part[bin][cx][y], summed in increasing x ----
      for (int t = threadIdx.x; t < c * s; t += blockDim.x) {
        const int cx = t / s, y = t % s;
        int lo, hi_x;
        support(cx, cs, s, &lo, &hi_x);
        float acc[kBins];
#pragma unroll
        for (int o = 0; o < kBins; ++o) acc[o] = 0.f;
        for (int x = lo; x <= hi_x; ++x) {
          const int p = y * s + x;
          const int b = bin[p];
          const float v = tent[x * c + cx] * mag[p];
#pragma unroll
          for (int o = 0; o < kBins; ++o)
            if (o == b) acc[o] = acc[o] + v;
        }
#pragma unroll
        for (int o = 0; o < kBins; ++o)
          part[(o * c + cx) * s + y] = round_bf16(acc[o]);
      }
      __syncthreads();

      // ---- y contraction: cells[bin][cx][cy], summed in increasing y ----
      for (int t = threadIdx.x; t < kBins * cc; t += blockDim.x) {
        const int row = t / c, cy = t % c;  // row = bin * C + cx
        int lo, hi_y;
        support(cy, cs, s, &lo, &hi_y);
        const float* a = part + row * s;
        float acc = 0.f;
        for (int y = lo; y <= hi_y; ++y) acc = acc + a[y] * tent[y * c + cy];
        cells[t] = acc;
      }
      __syncthreads();

      for (int t = threadIdx.x; t < cc; t += blockDim.x) {
        float e = 0.f;
        for (int k = 0; k < kOrient; ++k) {
          const float f = cells[k * cc + t] + cells[(k + kOrient) * cc + t];
          e = e + f * f;
        }
        energy[t] = e;
      }
      __syncthreads();

      // ---- block factors and Uoctti channels into the feature row ----
      __nv_bfloat16* dst = feat + lm * kDims * cc;
      for (int t = threadIdx.x; t < cc; t += blockDim.x) {
        const int cx = t / c, cy = t % c;
        float factor[4];
        for (int i = 0; i < 4; ++i) {
          // factor i: blocks at x offset (i & 1) - 1, y offset (i >> 1) - 1;
          // the x pair at each y first, then the two y sums
          const int ax = (i & 1) - 1, ay = (i >> 1) - 1;
          const int xa = min(max(cx + ax, 0), c - 1);
          const int xb = min(max(cx + ax + 1, 0), c - 1);
          const int ya = min(max(cy + ay, 0), c - 1);
          const int yb = min(max(cy + ay + 1, 0), c - 1);
          const float total = (energy[xa * c + ya] + energy[xb * c + ya]) +
                              (energy[xa * c + yb] + energy[xb * c + yb]);
          factor[i] = 1.f / sqrtf(total + 1e-4f);
        }
        float t_acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < kOrient; ++k) {
          const float ha = cells[k * cc + t];
          const float hb = cells[(k + kOrient) * cc + t];
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
          dst[k * cc + t] = __float2bfloat16_rn(0.5f * ha_s);
          dst[(k + kOrient) * cc + t] = __float2bfloat16_rn(0.5f * hb_s);
          dst[(k + 2 * kOrient) * cc + t] = __float2bfloat16_rn(0.5f * hc_s);
        }
        const float scale_t = 1.f / sqrtf(18.f);  // computed in float32
        for (int i = 0; i < 4; ++i)
          dst[(3 * kOrient + i) * cc + t] =
              __float2bfloat16_rn(t_acc[i] * scale_t);
      }
      // the next landmark first rewrites the taps, which nothing here reads;
      // cells and energy are rewritten only after three more barriers
    }
    __syncthreads();

    // ---- regressor: one warp per output, 8 bf16 pairs per 16-byte load ----
    const __nv_bfloat16* wl = weights + (int64_t)li * l2 * fp;
    const uint4* frow = reinterpret_cast<const uint4*>(feat);
    for (int k = warp; k < l2; k += nwarps) {
      const uint4* wrow = reinterpret_cast<const uint4*>(wl + (int64_t)k * fp);
      float acc = 0.f;
      for (int q = lane; q < fp / 8; q += 32) {
        const uint4 wv = __ldg(wrow + q);
        const uint4 fv = frow[q];
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&wv);
        const __nv_bfloat162* f2 = reinterpret_cast<const __nv_bfloat162*>(&fv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(f2[e]);
          const float2 b = __bfloat1622float2(w2[e]);
          acc = acc + a.x * b.x;
          acc = acc + a.y * b.y;
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) upd[k] = acc;
    }
    __syncthreads();
    // norm is 1/IED: dividing the update by it multiplies by the IED
    for (int k = threadIdx.x; k < l2; k += blockDim.x)
      xs[k] = xs[k] - upd[k] * ied;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < l2; k += blockDim.x)
    out[face * l2 + k] = xs[k];
}

template <typename Source>
cudaError_t launch(const Source& src, const void* x0, void* out,
                   const void* weights, const void* level_i,
                   const void* level_rel, const void* tents,
                   const void* eyes, int n, int n_levels, int l, int c,
                   int ry, int rx, int fp, int quantize, int s_max,
                   cudaStream_t stream) {
  const Layout lay(l, c, fp, s_max);
  cudaError_t err = cudaFuncSetAttribute(
      cascade_kernel<Source>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.total);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  cascade_kernel<Source><<<n, kThreads, lay.total, stream>>>(
      src, static_cast<const float*>(x0), static_cast<float*>(out),
      static_cast<const __nv_bfloat16*>(weights),
      static_cast<const int*>(level_i), static_cast<const float*>(level_rel),
      static_cast<const float*>(tents), static_cast<const int*>(eyes),
      n_levels, l, c, ry, rx, fp, quantize, s_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cascade_fused_frames_launch(
    const void* frames, const void* idx, const void* oy, const void* ox,
    int n_img, int h, int w, const void* x0, void* out, const void* weights,
    const void* level_i, const void* level_rel, const void* tents,
    const void* eyes, int n, int n_levels, int l, int c, int ry, int rx,
    int fp, int quantize, int s_max, void* stream) {
  FramesSource src{static_cast<const uint8_t*>(frames),
                   static_cast<const int*>(idx), static_cast<const int*>(oy),
                   static_cast<const int*>(ox), n_img, h, w};
  return (int)launch(src, x0, out, weights, level_i, level_rel, tents, eyes,
                     n, n_levels, l, c, ry, rx, fp, quantize, s_max,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int cascade_fused_launch(
    const void* windows, const void* x0, void* out, const void* weights,
    const void* level_i, const void* level_rel, const void* tents,
    const void* eyes, int n, int n_levels, int l, int c, int ry, int rx,
    int fp, int quantize, int s_max, void* stream) {
  WindowsSource src{static_cast<const __nv_bfloat16*>(windows)};
  return (int)launch(src, x0, out, weights, level_i, level_rel, tents, eyes,
                     n, n_levels, l, c, ry, rx, fp, quantize, s_max,
                     static_cast<cudaStream_t>(stream));
}
