// K1: VLFeat HOG of flattened S x S patches, several patches per block.
//
// Replaces superviseddescent_tpu/ops/hog_pallas_flat.py::
// hog_descriptor_pallas_flat (_flat_kernel). See ops/hog_flat.py for the
// contract, the plain PyTorch twin, and what bounds the kernel on the H100
// (memory: each patch is read once and each descriptor written once; every
// intermediate stays in shared memory).
//
// A block takes P consecutive patches (ops/hog_flat.py::launch_plan), which
// lie contiguous in memory:
//   1. staging: the (S, C) float64 tents and the P patches, read with
//      16-byte loads, as float32 in the input's own layout (a transposed
//      patch is not un-transposed: the kernel works in storage coordinates,
//      rows a of stride S and columns b of stride 1);
//   2. gradients, magnitudes and bins, one thread per pixel, two pixels per
//      thread in flight, the pixel's coordinates stepped along without a
//      division;
//   3. splat. Exact mode, in two separable float32 passes over float32
//      tents (within K1's tolerance of the twin's 2-D weights, with half
//      the pairs of pixel and cell): one thread per (patch, cell row ca,
//      column b) sums the pixels of bin o times Wa down ca's support into
//      its own per-bin slots, then one thread per (patch, bin, cell) sums
//      those times Wb along cb's support. Fast mode (whose contract rounds
//      each 2-D weight to bf16), and exact mode where the separable
//      buffers exceed a block (the host picks the form,
//      ops/hog_flat.py::separable): a warp per cell, the same cell of all P
//      patches at once; the lanes walk the cell's tent support and form
//      each weight in registers as float32(Wa * Wb) from the float64
//      tents, the bits of the twin's table (_flat_weights), read the bins
//      and magnitudes of two pixels of all P patches, then add into their
//      own slots of a per-warp (patch, bin, lane) table, summed in a fixed
//      order (eight lanes at a time, then the four parts);
//   4. energies and block factors, one thread per cell and patch;
//   5. channels, one thread per output value: the block's P descriptors are
//      one contiguous run of the output.
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do, so gradients, magnitudes
// and bins are bit-equal to the twin's (and the 2-D splat's weights too);
// only the splat's sums differ. Sums run in a fixed order (no atomics), the
// same for every P, so a patch's descriptor does not depend on the plan.
//
// Measurement builds (chip_smoke.py's k12_split, never an entry point):
// -DHOG_SKIP_SPLAT leaves the cell histograms at zero, -DHOG_PHASE_CLOCKS
// sums thread 0's cycles per phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = 4;  // a bin's 32 lane slots: 4 parts of 8 lanes
constexpr int kMaxPerBlock = 3;  // patches per block
// independent work in flight per thread: a slot's update must wait for the
// one before it (the compiler cannot tell slots apart), so the reads of the
// next pixels are issued first; a sweep of 2 to 8 on the H100 found 2 best
constexpr int kPairs = 2;   // splat pairs (pixel, weight) per lane and turn
constexpr int kPixels = 2;  // gradient pixels per thread and turn

#ifdef HOG_PHASE_CLOCKS
// thread 0's cycles from one barrier to the next, summed over the blocks:
// staging, gradients and bins, splat, energy, channels
constexpr int kPhases = 5;
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE_END(k)                                                     \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0) {                                              \
      const long long now = clock64();                                   \
      atomicAdd(&g_phase_cycles[k], (unsigned long long)(now - stamp));  \
      stamp = now;                                                       \
    }                                                                    \
  } while (0)
#else
#define PHASE_END(k) __syncthreads()
#endif

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Tent support [lo, hi] of cell c along one axis: the pixels p with
// |(p + 0.5)/cs - 0.5 - c| < 1, interior pixels only (border weights are 0).
__device__ __forceinline__ void support(int c, int cs, int s, int* lo,
                                        int* hi) {
  int a = (2 * c - 1) * cs - 1;  // 2p > a  <=>  (p+0.5)/cs - 0.5 > c - 1
  int b = (2 * c + 3) * cs - 1;  // 2p < b  <=>  (p+0.5)/cs - 0.5 < c + 1
  int l = a >= 0 ? a / 2 + 1 : 0;
  int h = (b - 1) / 2;
  *lo = max(l, 1);
  *hi = min(h, s - 2);
}

__host__ __device__ inline int take(int* at, int bytes) {
  int here = *at;
  *at += (bytes + 15) / 16 * 16;
  return here;
}

// Shared buffers of a block of P patches, each 16-byte aligned;
// ops/hog_flat.py::_shared_bytes counts the same. The splat's buffers
// differ by its form: the separable one keeps per-thread bin slots and the
// first pass's (patch, bin, ca, b) sums, the 2-D one per-warp (patch, bin,
// lane) slots and their parts.
struct Layout {
  int tent, tentf, ov, img, mag, acc, part, cells, energy, factor, bin, bytes;
  __host__ __device__ Layout(int s, int c, int n_orient, int p, int sep) {
    const int fast = !sep;
    const int two_o = 2 * n_orient;
    int at = 0;
    tent = take(&at, s * c * 8);                  // (S, C) float64
    tentf = take(&at, fast ? 0 : s * c * 4);      // the same in float32
    ov = take(&at, two_o * 4);                    // (cos, sin)(k pi / O)
    img = take(&at, p * s * s * 4);               // patches, float32
    mag = take(&at, p * s * s * 4);               // gradient magnitudes
    acc = take(&at, fast ? kWarps * p * two_o * 32 * 4 : kThreads * two_o * 4);
    part = take(&at, fast ? kWarps * p * two_o * kParts * 4
                          : p * two_o * c * s * 4);
    cells = take(&at, p * two_o * c * c * 4);     // (patch, bin, cell)
    energy = take(&at, p * c * c * 4);
    factor = take(&at, p * 4 * c * c * 4);        // (patch, factor, cell)
    bin = take(&at, p * s * s);                   // int8, -1: no bin
    bytes = at;
  }
};

// The directed bin of gradient (gx, gy) among 2O: argmax of |score| over
// the orientation vectors (ovc, ovs), first maximum wins, k + O for a
// negative score; -1 for a zero gradient.
__device__ __forceinline__ int best_bin(float gx, float gy, const float* ovc,
                                        const float* ovs, int n_orient) {
  float best = 0.f;
  int bn = -1;
  for (int k = 0; k < n_orient; ++k) {
    const float sc = gx * ovc[k] + gy * ovs[k];
    const float m = fabsf(sc);
    if (m > best) {
      best = m;
      bn = sc < 0.f ? k + n_orient : k;
    }
  }
  return bn;
}

template <typename T>
struct Pack;  // one 16-byte load of T, unpacked to float
template <>
struct Pack<float> {
  static constexpr int kCount = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kCount = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// n contiguous elements from src into dst as float32: scalar loads up to
// the first 16-byte boundary and after the last, 16-byte loads between.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int n) {
  constexpr int V = Pack<T>::kCount;
  const int mis = (int)(reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T);
  const int head = min(n, mis == 0 ? 0 : V - mis);
  const int nvec = (n - head) / V;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  float* vdst = dst + head;
#pragma unroll 4
  for (int k = threadIdx.x; k < nvec; k += kThreads) {
    const uint4 v = __ldg(vsrc + k);
    float f[V];
    Pack<T>::unpack(v, f);
#pragma unroll
    for (int e = 0; e < V; ++e) vdst[k * V + e] = f[e];
  }
  for (int k = threadIdx.x; k < head; k += kThreads)
    dst[k] = Pack<T>::one(src + k);
  for (int k = head + nvec * V + threadIdx.x; k < n; k += kThreads)
    dst[k] = Pack<T>::one(src + k);
}

// Fast: fast mode; Sep: the separable splat (exact mode, where its
// buffers fit), else the 2-D one; kP: patches per block
template <typename T, bool Fast, bool Sep, int kP>
__global__ void __launch_bounds__(kThreads)
hog_flat_kernel(const T* __restrict__ patches, float* __restrict__ out,
                const double* __restrict__ tent_g,
                const float* __restrict__ ov_g, int batch, int s, int cs,
                int n_orient, int uoctti, int transposed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = (s + cs / 2) / cs;
  const int cc = c * c;
  const int ss = s * s;
  const int two_o = 2 * n_orient;
  const Layout lay(s, c, n_orient, kP, Sep);
  double* tent = reinterpret_cast<double*>(smem + lay.tent);
  float* tentf = reinterpret_cast<float*>(smem + lay.tentf);
  float* ov = reinterpret_cast<float*>(smem + lay.ov);
  float* img = reinterpret_cast<float*>(smem + lay.img);
  float* mag = reinterpret_cast<float*>(smem + lay.mag);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* cells = reinterpret_cast<float*>(smem + lay.cells);
  float* energy = reinterpret_cast<float*>(smem + lay.energy);
  float* factor = reinterpret_cast<float*>(smem + lay.factor);
  int8_t* bin = reinterpret_cast<int8_t*>(smem + lay.bin);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#ifdef HOG_PHASE_CLOCKS
  long long stamp = clock64();
#endif

  const int64_t first = (int64_t)blockIdx.x * kP;
  const int np = (int)min((int64_t)kP, (int64_t)batch - first);
  const int npx = np * ss;

  // ---- 1. staging ----
  for (int t = tid; t < s * c; t += kThreads) {
    tent[t] = tent_g[t];
    if (Sep) tentf[t] = __double2float_rn(tent_g[t]);
  }
  for (int t = tid; t < two_o; t += kThreads) ov[t] = ov_g[t];
  const int slots = Sep ? kThreads * two_o : kWarps * kP * two_o * 32;
  for (int t = tid; t < slots; t += kThreads) acc[t] = 0.f;
  stage(patches + first * ss, img, npx);
  PHASE_END(0);

  // ---- 2. gradients, magnitudes, bins (storage coordinates a, b) ----
  {
    // four orientations (every model) keep their vectors in registers
    float ov4c[4], ov4s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ov4c[k] = k < n_orient ? ov[k] : 0.f;
      ov4s[k] = k < n_orient ? ov[n_orient + k] : 0.f;
    }
    // the pixel at storage index q (row a, column b): magnitude and bin
    // (border pixels compute at an interior one, without a branch, and
    // are then zeroed)
    auto gradient = [&](int q, int a, int b, float* g_out, int* bn_out) {
      const bool inside = a >= 1 && a <= s - 2 && b >= 1 && b <= s - 2;
      if (!inside) q = s + 1;
      float g;
      int bn = -1;
      {
        const float g_in = img[q + 1] - img[q - 1];   // along b
        const float g_ab = img[q + s] - img[q - s];   // along a
        const float gx = transposed ? g_ab : g_in;
        const float gy = transposed ? g_in : g_ab;
        g = sqrtf(gx * gx + gy * gy);
        if (Fast && n_orient == 4) {
          // nearest multiple of pi/4: two slope compares pick the axis
          const float ax = fabsf(gx), ay = fabsf(gy);
          const bool px = gx >= 0.f, py = gy >= 0.f;
          if (ay < ax * 0.41421356237f) {
            bn = px ? 0 : 4;
          } else if (ay > ax * 2.41421356237f) {
            bn = py ? 2 : 6;
          } else {
            bn = (px == py) ? (px ? 1 : 5) : (py ? 3 : 7);
          }
        } else if (n_orient == 4) {
          bn = best_bin(gx, gy, ov4c, ov4s, 4);
        } else {
          bn = best_bin(gx, gy, ov, ov + n_orient, n_orient);
        }
        if (Fast) g = round_bf16(g);
      }
      *g_out = inside ? g : 0.f;
      *bn_out = inside ? bn : -1;
    };
    // kPixels pixels per turn, all stored after all are computed
    const int da = kThreads / s, db = kThreads % s;
    int a = (tid / s) % s, b = tid % s;
    auto step = [&]() {
      b += db;
      a += da;
      if (b >= s) {
        b -= s;
        ++a;
      }
      while (a >= s) a -= s;
    };
    for (int q = tid; q < npx; q += kPixels * kThreads) {
      float g[kPixels];
      int bn[kPixels];
#pragma unroll
      for (int k = 0; k < kPixels; ++k) {
        g[k] = 0.f;
        bn[k] = -1;
        if (q + k * kThreads < npx) gradient(q + k * kThreads, a, b, &g[k],
                                             &bn[k]);
        step();
      }
#pragma unroll
      for (int k = 0; k < kPixels; ++k)
        if (q + k * kThreads < npx) {
          mag[q + k * kThreads] = g[k];
          bin[q + k * kThreads] = (int8_t)bn[k];
        }
    }
  }
  PHASE_END(1);

  // ---- 3. splat ----
#ifdef HOG_SKIP_SPLAT
  for (int t = tid; t < np * two_o * cc; t += kThreads) cells[t] = 0.f;
  (void)part;
  (void)warp;
  (void)lane;
#else
  if (Sep) {
    // exact mode, in two float32 passes over the float32 tents (within
    // K1's tolerance of the twin's 2-D weights; ops/hog_flat.py's
    // separable_cells is the same arithmetic in plain PyTorch). First,
    // along a: part[patch][o][ca][b] = sum over a in ca's support, in
    // increasing a, of the magnitudes of bin o times Wa; one thread per
    // (patch, ca, b), neighbouring threads at neighbouring b, each adding
    // into its own slot of each bin, two rows read before either update
    float* slot = acc + tid;  // bin o's slot: slot[o * kThreads]
    for (int t = tid; t < np * c * s; t += kThreads) {
      const int pp = t / (c * s), r = t - pp * (c * s);
      const int ca = r / s, b = r - ca * s;
      int a0, a1;
      support(ca, cs, s, &a0, &a1);
      const float* mg = mag + pp * ss + b;
      const int8_t* bn = bin + pp * ss + b;
      int a = a0;
      for (; a < a1; a += 2) {
        const int o0 = bn[a * s], o1 = bn[(a + 1) * s];
        const float v0 = mg[a * s] * tentf[a * c + ca];
        const float v1 = mg[(a + 1) * s] * tentf[(a + 1) * c + ca];
        if (o0 >= 0) slot[o0 * kThreads] = slot[o0 * kThreads] + v0;
        if (o1 >= 0) slot[o1 * kThreads] = slot[o1 * kThreads] + v1;
      }
      if (a == a1) {
        const int o0 = bn[a * s];
        const float v0 = mg[a * s] * tentf[a * c + ca];
        if (o0 >= 0) slot[o0 * kThreads] = slot[o0 * kThreads] + v0;
      }
      float* dst = part + (pp * two_o * c + ca) * s + b;
      for (int o = 0; o < two_o; ++o) {
        dst[o * c * s] = slot[o * kThreads];
        slot[o * kThreads] = 0.f;
      }
    }
    __syncthreads();
    // then along b: cells[patch][o][cell] = sum over b in cb's support, in
    // increasing b, of Wb times the first pass's sums
    for (int t = tid; t < np * two_o * cc; t += kThreads) {
      const int r = t / cc, q = t - r * cc;  // r = patch * 2O + o
      const int ca = q / c, cb = q - ca * c;
      int b0, b1;
      support(cb, cs, s, &b0, &b1);
      const float* src = part + (r * c + ca) * s;
      float sum = 0.f;
      for (int b = b0; b <= b1; ++b) sum = sum + src[b] * tentf[b * c + cb];
      cells[r * cc + (transposed ? ca * c + cb : cb * c + ca)] = sum;
    }
  } else {
    float* wacc = acc + warp * kP * two_o * 32;
    float* wpart = part + warp * kP * two_o * kParts;
    const int rows = np * two_o;  // (patch, bin) rows of 32 lane slots
    for (int cell = warp; cell < cc; cell += kWarps) {
      const int cx = cell / c, cy = cell - cx * c;  // cx-major cells
      const int ca = transposed ? cx : cy;  // cell along a (stride S)
      const int cb = transposed ? cy : cx;  // cell along b (stride 1)
      int a0, a1, b0, b1;
      support(ca, cs, s, &a0, &a1);
      support(cb, cs, s, &b0, &b1);
      const int na = a1 - a0 + 1, nb = b1 - b0 + 1;
      if (na > 0 && nb > 0) {
        // lane k of the support's row-major order, stepped by 32; kPairs
        // pairs (pixel, weight) per turn, the bins and magnitudes of all of
        // them and of all kP patches read before any slot is updated
        const int da = 32 / nb, db = 32 - da * nb;
        int ia = lane / nb, ib = lane - (lane / nb) * nb;
        auto next = [&](int* q, float* w) -> bool {
          const bool on = ia < na;
          const int a = a0 + (on ? ia : 0), b = b0 + ib;
          float wt = __double2float_rn(tent[a * c + ca] * tent[b * c + cb]);
          if (Fast) wt = round_bf16(wt);
          *q = a * s + b;
          *w = wt;
          ib += db;
          ia += da;
          if (ib >= nb) {
            ib -= nb;
            ++ia;
          }
          return on;
        };
        const int turns = (na * nb + 32 * kPairs - 1) / (32 * kPairs);
        for (int t = 0; t < turns; ++t) {
          int q[kPairs];
          float w[kPairs];
          bool on[kPairs];
#pragma unroll
          for (int k = 0; k < kPairs; ++k) on[k] = next(&q[k], &w[k]);
          int bn[kPairs][kP];
          float mg[kPairs][kP];
#pragma unroll
          for (int k = 0; k < kPairs; ++k)
#pragma unroll
            for (int pp = 0; pp < kP; ++pp) {
              bn[k][pp] = on[k] && pp < np ? (int)bin[pp * ss + q[k]] : -1;
              mg[k][pp] = mag[pp * ss + q[k]];
            }
#pragma unroll
          for (int k = 0; k < kPairs; ++k)
#pragma unroll
            for (int pp = 0; pp < kP; ++pp)
              if (bn[k][pp] >= 0) {
                float* slot = wacc + (pp * two_o + bn[k][pp]) * 32 + lane;
                *slot = *slot + mg[k][pp] * w[k];
              }
        }
      }
      __syncwarp();
      // part k of a row: its lanes 8k..8k+7 in order; the slots are zeroed
      // for the next cell
      for (int t = lane; t < rows * kParts; t += 32) {
        float4* slot = reinterpret_cast<float4*>(wacc + t * 8);
        const float4 u = slot[0], v = slot[1];
        wpart[t] = ((((((u.x + u.y) + u.z) + u.w) + v.x) + v.y) + v.z) + v.w;
        slot[0] = make_float4(0.f, 0.f, 0.f, 0.f);
        slot[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncwarp();
      for (int r = lane; r < rows; r += 32) {
        const float* pr = wpart + r * kParts;
        cells[r * cc + cell] = ((pr[0] + pr[1]) + pr[2]) + pr[3];
      }
      __syncwarp();
    }
  }
#endif
  PHASE_END(2);

  // ---- 4. energies, then the four block factors of every cell ----
  for (int t = tid; t < np * cc; t += kThreads) {
    const int pp = t / cc, cell = t - pp * cc;
    const float* h = cells + pp * two_o * cc;
    float e = 0.f;
    for (int k = 0; k < n_orient; ++k) {
      const float f = h[k * cc + cell] + h[(k + n_orient) * cc + cell];
      e = e + f * f;
    }
    energy[t] = e;
  }
  __syncthreads();
  for (int t = tid; t < np * cc; t += kThreads) {
    const int pp = t / cc, cell = t - pp * cc;
    const int cx = cell / c, cy = cell - cx * c;
    const float* en = energy + pp * cc;
    // 2x2 block factors 1..4 (UL, UR, LL, LR) over clamped neighbours
    const int blocks[4][4][2] = {{{-1, -1}, {0, -1}, {-1, 0}, {0, 0}},
                                 {{0, -1}, {1, -1}, {0, 0}, {1, 0}},
                                 {{-1, 0}, {0, 0}, {-1, 1}, {0, 1}},
                                 {{0, 0}, {1, 0}, {0, 1}, {1, 1}}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float total = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nx = min(max(cx + blocks[i][j][0], 0), c - 1);
        const int ny = min(max(cy + blocks[i][j][1], 0), c - 1);
        const float n = en[nx * c + ny];
        total = j == 0 ? n : total + n;
      }
      factor[(pp * 4 + i) * cc + cell] = 1.f / sqrtf(total + 1e-4f);
    }
  }
  PHASE_END(3);

  // ---- 5. channels: one thread per output value, contiguous stores ----
  const int dims = uoctti ? 3 * n_orient + 4 : 4 * n_orient;
  const int dcc = dims * cc;
  float* dst = out + first * dcc;
  const float scale_t = 1.f / sqrtf(18.f);  // computed in float32
  for (int t = tid; t < np * dcc; t += kThreads) {
    const int pp = t / dcc, r = t - pp * dcc;
    const int d = r / cc, cell = r - d * cc;
    const float* h = cells + pp * two_o * cc + cell;
    const float* f = factor + pp * 4 * cc + cell;
    float v;
    if (uoctti) {
      if (d < two_o) {
        // 0.5 x the sum of the clamped normalised copies of bin d
        const float hd = h[d * cc];
        float sum = 0.f;
        for (int i = 0; i < 4; ++i) sum = sum + fminf(f[i * cc] * hd, 0.2f);
        v = 0.5f * sum;
      } else if (d < 3 * n_orient) {
        const int k = d - two_o;
        const float ha = h[k * cc], hb = h[(k + n_orient) * cc];
        float sum = 0.f;
        for (int i = 0; i < 4; ++i) {
          const float hai = f[i * cc] * ha;
          const float hbi = f[i * cc] * hb;
          sum = sum + fminf(hai + hbi, 0.2f);
        }
        v = 0.5f * sum;
      } else {
        // texture channel i: the undirected copies of factor i, all bins
        const float fi = f[(d - 3 * n_orient) * cc];
        float sum = 0.f;
        for (int k = 0; k < n_orient; ++k) {
          const float hai = fi * h[k * cc];
          const float hbi = fi * h[(k + n_orient) * cc];
          sum = sum + fminf(hai + hbi, 0.2f);
        }
        v = sum * scale_t;
      }
    } else {
      const int i = d / n_orient, k = d - i * n_orient;
      const float hk = h[k * cc] + h[(k + n_orient) * cc];
      v = fminf(f[i * cc] * hk, 0.2f);
    }
    dst[t] = v;
  }
#ifdef HOG_PHASE_CLOCKS
  PHASE_END(4);
#endif
}

template <typename T, bool Fast, bool Sep, int kP>
cudaError_t launch_plan(const void* patches, void* out, const void* tent,
                        const void* ov, int batch, int s, int cs,
                        int n_orient, int uoctti, int transposed,
                        cudaStream_t stream) {
  const int c = (s + cs / 2) / cs;
  const Layout lay(s, c, n_orient, kP, Sep);
  cudaError_t err = cudaFuncSetAttribute(
      hog_flat_kernel<T, Fast, Sep, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + kP - 1) / kP;
  hog_flat_kernel<T, Fast, Sep, kP><<<blocks, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(patches), static_cast<float*>(out),
      static_cast<const double*>(tent), static_cast<const float*>(ov), batch,
      s, cs, n_orient, uoctti, transposed);
  return cudaGetLastError();
}

template <typename T, bool Fast, bool Sep>
cudaError_t launch_form(const void* patches, void* out, const void* tent,
                        const void* ov, int batch, int s, int cs,
                        int n_orient, int uoctti, int transposed,
                        int per_block, cudaStream_t stream) {
  switch (per_block) {
    case 1:
      return launch_plan<T, Fast, Sep, 1>(patches, out, tent, ov, batch, s,
                                          cs, n_orient, uoctti, transposed,
                                          stream);
    case 2:
      return launch_plan<T, Fast, Sep, 2>(patches, out, tent, ov, batch, s,
                                          cs, n_orient, uoctti, transposed,
                                          stream);
    case kMaxPerBlock:
      return launch_plan<T, Fast, Sep, kMaxPerBlock>(
          patches, out, tent, ov, batch, s, cs, n_orient, uoctti, transposed,
          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* patches, void* out, const void* tent,
                   const void* ov, int batch, int s, int cs, int n_orient,
                   int uoctti, int fast, int transposed, int per_block,
                   int separable, cudaStream_t stream) {
  // the host picks the splat's form (ops/hog_flat.py::separable): the
  // separable passes in exact mode where their buffers fit a block, else
  // the 2-D form; fast mode's contract rounds each 2-D weight, so it is
  // never separable
  if (fast && separable) return cudaErrorInvalidValue;
  auto form = fast ? launch_form<T, true, false>
                   : (separable ? launch_form<T, false, true>
                                : launch_form<T, false, false>);
  return form(patches, out, tent, ov, batch, s, cs, n_orient, uoctti,
              transposed, per_block, stream);
}

}  // namespace

#ifdef HOG_PHASE_CLOCKS
// the phase cycles summed since the last call (kPhases values), then zero
extern "C" int hog_phase_cycles(void* host) {
  static const unsigned long long zero[kPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

extern "C" int hog_flat_launch(const void* patches, int bf16_input,
                               void* out, const void* tent, const void* ov,
                               int batch, int s, int cs, int n_orient,
                               int uoctti, int fast, int transposed,
                               int per_block, int separable, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_input)
    return (int)launch<__nv_bfloat16>(patches, out, tent, ov, batch, s, cs,
                                      n_orient, uoctti, fast, transposed,
                                      per_block, separable, st);
  return (int)launch<float>(patches, out, tent, ov, batch, s, cs, n_orient,
                            uoctti, fast, transposed, per_block, separable,
                            st);
}
