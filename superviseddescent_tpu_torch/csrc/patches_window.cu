// K2: window patch sampler, several (face, landmark) patches per block.
//
// Replaces superviseddescent_tpu/ops/patches_pallas.py::
// sample_patches_window (_sampler_kernel). See ops/patches_window.py for the
// contract, the plain PyTorch twin, and what bounds the kernel on the H100
// (memory: the S x S output stream; the window reads are a few KB per
// patch).
//
// A block takes G consecutive patches (ops/patches_window.py::launch_plan),
// whose outputs lie contiguous in memory:
//   1. taps: one thread per (patch, output row), which computes the patch's
//      sub-window origin and the row's and the column's bilinear taps into
//      shared memory;
//   2. samples: each thread computes V consecutive outputs in (y, x) order
//      (V = 4 float32 or 8 bfloat16, one 16-byte word of output), so
//      neighbouring threads read neighbouring window columns and each has
//      4 V independent window reads in flight; a (y, x)-major output goes
//      straight out as 16-byte stores on 16-byte boundaries of the whole
//      output, and a transposed one is written into a shared-memory tile in
//      (x, y) order,
//   3. which then goes out as 16-byte stores.
// Only the transposed output takes the tile; both take dynamic shared
// memory for G patches' taps and origins only.
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do, so the output equals the
// twin's bit for bit, for every G.
//
// Measurement builds (chip_smoke.py's k12_split, never an entry point):
// -DPATCHES_SKIP_STORE computes every output pixel but stores none,
// -DPATCHES_PHASE_CLOCKS sums thread 0's cycles per phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampler_taps.cuh"  // round_bf16, tap

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSize = 96;  // largest output side S

#ifdef PATCHES_PHASE_CLOCKS
// thread 0's cycles from one barrier to the next, summed over the blocks:
// taps, sampling, write-out (transposed output)
constexpr int kPhases = 3;
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

#ifdef PATCHES_SKIP_STORE
// no value the sampler computes has these bits: every store is skipped, and
// the compiler still computes every value
#define STORE_GUARD(v) if (__float_as_uint(v) == 0xffffffffu)
#else
#define STORE_GUARD(v)
#endif

template <typename T>
__device__ __forceinline__ float load(const T* p, int64_t i);
template <>
__device__ __forceinline__ float load<uint8_t>(const uint8_t* p, int64_t i) {
  return (float)p[i];
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     int64_t i) {
  return __bfloat162float(p[i]);
}
template <>
__device__ __forceinline__ float load<float>(const float* p, int64_t i) {
  return p[i];
}

// One 16-byte word of output: V values of Tout.
template <typename Tout>
struct Word;
template <>
struct Word<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static float cast(float v) { return v; }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ __forceinline__ static uint32_t raw(float v) {
    return __float_as_uint(v);
  }
  __device__ __forceinline__ static uint4 gather(const float* t) {
    return make_uint4(__float_as_uint(t[0]), __float_as_uint(t[1]),
                      __float_as_uint(t[2]), __float_as_uint(t[3]));
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static __nv_bfloat16 cast(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static uint32_t bits(float v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(bits(v[0]) | bits(v[1]) << 16,
                      bits(v[2]) | bits(v[3]) << 16,
                      bits(v[4]) | bits(v[5]) << 16,
                      bits(v[6]) | bits(v[7]) << 16);
  }
  __device__ __forceinline__ static uint32_t raw(__nv_bfloat16 v) {
    return (uint32_t)__bfloat16_as_ushort(v);
  }
  __device__ __forceinline__ static uint4 gather(const __nv_bfloat16* t) {
    return make_uint4(raw(t[0]) | raw(t[1]) << 16, raw(t[2]) | raw(t[3]) << 16,
                      raw(t[4]) | raw(t[5]) << 16, raw(t[6]) | raw(t[7]) << 16);
  }
};

__host__ __device__ inline int take(int* at, int bytes) {
  int here = *at;
  *at += (bytes + 15) / 16 * 16;
  return here;
}

// Values per column of the transposed tile: whole 16-byte words of V
// values, an odd number of them, so that the strips of neighbouring columns
// fall on different banks.
__host__ __device__ inline int tile_pitch(int s, int v) {
  const int words = (s + v - 1) / v;
  return (words % 2 == 0 ? words + 1 : words) * v;
}

// Dynamic shared memory of a block of G patches, each buffer 16-byte
// aligned; ops/patches_window.py::_shared_bytes counts the same.
struct Layout {
  int ytap, xtap, yw0, yw1, xw0, xw1, base, tile, bytes;
  __host__ __device__ Layout(int s, int g, int transposed, int out_bytes) {
    int at = 0;
    ytap = take(&at, g * s * 4);
    xtap = take(&at, g * s * 4);
    yw0 = take(&at, g * s * 4);
    yw1 = take(&at, g * s * 4);
    xw0 = take(&at, g * s * 4);
    xw1 = take(&at, g * s * 4);
    base = take(&at, g * 8);  // each patch's sub-window in the windows
    tile = take(&at, transposed ? g * s * tile_pitch(s, 16 / out_bytes) *
                                      out_bytes : 0);
    bytes = at;
  }
};

template <typename Tin, typename Tout, bool Transposed>
__global__ void __launch_bounds__(kThreads)
patches_window_kernel(const Tin* __restrict__ windows,
                      const float* __restrict__ oxy,
                      const float* __restrict__ sp, Tout* __restrict__ out,
                      int nl, int l, int ry, int rx, int s, int w, int wx,
                      int quantize, int fast, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Word<Tout>::V;
  const Layout lay(s, per_block, Transposed, sizeof(Tout));
  int* y_tap = reinterpret_cast<int*>(smem + lay.ytap);
  int* x_tap = reinterpret_cast<int*>(smem + lay.xtap);
  float* y_w0 = reinterpret_cast<float*>(smem + lay.yw0);
  float* y_w1 = reinterpret_cast<float*>(smem + lay.yw1);
  float* x_w0 = reinterpret_cast<float*>(smem + lay.xw0);
  float* x_w1 = reinterpret_cast<float*>(smem + lay.xw1);
  int64_t* base = reinterpret_cast<int64_t*>(smem + lay.base);
  Tout* tile = reinterpret_cast<Tout*>(smem + lay.tile);
  const int tid = threadIdx.x;
#ifdef PATCHES_PHASE_CLOCKS
  long long stamp = clock64();
#endif

  const int64_t first = (int64_t)blockIdx.x * per_block;
  const int np = (int)min((int64_t)per_block, (int64_t)nl - first);
  const int ss = s * s;

  // ---- 1. taps of every (patch, row), sub-window origins ----
  for (int t = tid; t < np * s; t += kThreads) {
    const int g = t / s, j = t - g * s;
    const int64_t patch = first + g;
    const int64_t face = patch / l;
    const int lm = (int)(patch - face * l);
    const float by = oxy[face * 2 * l + lm];
    const float bx = oxy[face * 2 * l + l + lm];
    const float st = sp[face * 2];
    const float ph = sp[face * 2 + 1];
    const float hi = 2.f * ph - 1.f;
    // cv::resize source grid within the crop, clamped to the crop
    const float src0 = fminf(fmaxf((0.f + 0.5f) * st - 0.5f, 0.f), hi);
    int oy = (int)fminf(fmaxf(floorf(by + src0), 0.f), (float)(ry - w));
    oy = (oy / 8) * 8;
    int ox = 0;
    if (wx != rx) {
      ox = (int)fminf(fmaxf(floorf(bx + src0), 0.f), (float)(rx - wx));
      ox = (ox / 128) * 128;
    }
    const float src = fminf(fmaxf(((float)j + 0.5f) * st - 0.5f, 0.f), hi);
    tap(by, src, (float)oy, w, quantize, fast, &y_tap[t], &y_w0[t],
        &y_w1[t]);
    tap(bx, src, (float)ox, wx, quantize, fast, &x_tap[t], &x_w0[t],
        &x_w1[t]);
    if (j == 0) base[g] = (face * ry + oy) * (int64_t)rx + ox;
  }
  PHASE_END(0);

  // the output pixel at row j, column i of patch g from the row taps
  // (v, ty0, ty1) and the column taps (u, tx0, tx1); a window pixel is read
  // only where its weight is non-zero (a zero-weight tap may lie outside
  // the window)
  auto sample = [&](const Tin* win, int v, float ty0, float ty1, int u,
                    float tx0, float tx1) -> float {
    const int64_t r0 = (int64_t)v * rx + u, r1 = r0 + rx;
    const float p00 = ty0 * tx0 != 0.f ? load<Tin>(win, r0) : 0.f;
    const float p01 = ty0 * tx1 != 0.f ? load<Tin>(win, r0 + 1) : 0.f;
    const float p10 = ty1 * tx0 != 0.f ? load<Tin>(win, r1) : 0.f;
    const float p11 = ty1 * tx1 != 0.f ? load<Tin>(win, r1 + 1) : 0.f;
    float patch;
    if (Transposed) {
      float q0 = tx0 * p00 + tx1 * p01;  // x pass first
      float q1 = tx0 * p10 + tx1 * p11;
      if (fast) {
        q0 = round_bf16(q0);
        q1 = round_bf16(q1);
      }
      patch = q0 * ty0 + q1 * ty1;
    } else {
      float r0v = ty0 * p00 + ty1 * p10;  // y pass first
      float r1v = ty0 * p01 + ty1 * p11;
      if (fast) {
        r0v = round_bf16(r0v);
        r1v = round_bf16(r1v);
      }
      patch = r0v * tx0 + r1v * tx1;
    }
    if (quantize) patch = fminf(fmaxf(floorf(patch + 0.5f), 0.f), 255.f);
    return patch;
  };
  auto sample_at = [&](int g, int j, int i) -> float {
    const int gj = g * s + j, gi = g * s + i;
    return sample(windows + base[g], y_tap[gj], y_w0[gj], y_w1[gj],
                  x_tap[gi], x_w0[gi], x_w1[gi]);
  };

  const int total = np * ss;
  const int64_t origin = first * ss;  // the block's first output element
  // output words (V values) on 16-byte boundaries of the whole output: the
  // block's first and last word may be shared with its neighbours, each
  // block writing its own values
  const int lead = (int)(origin % V);
  const int words = (lead + total + V - 1) / V;
  if (!Transposed) {
    // ---- 2. samples: each thread one word of V consecutive (y, x)
    // outputs, its V values (and their window reads) first, then one
    // 16-byte store ----
    for (int k = tid; k < words; k += kThreads) {
      const int e0 = k * V - lead;  // block element of the word's first
      const int lo = max(e0, 0), hi_e = min(e0 + V, total);
      int g = lo / ss;
      const int r = lo - g * ss;
      int j = r / s, i = r - j * s;
      // the row's taps, read again only where the word passes a row's end
      const Tin* win = windows + base[g];
      int gj = g * s + j;
      int v = y_tap[gj];
      float ty0 = y_w0[gj], ty1 = y_w1[gj];
      float vals[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        vals[e] = 0.f;
        if (e0 + e >= lo && e0 + e < hi_e) {
          if (i == s) {
            i = 0;
            if (++j == s) {
              j = 0;
              win = windows + base[++g];
            }
            gj = g * s + j;
            v = y_tap[gj];
            ty0 = y_w0[gj];
            ty1 = y_w1[gj];
          }
          const int gi = g * s + i;
          vals[e] = sample(win, v, ty0, ty1, x_tap[gi], x_w0[gi], x_w1[gi]);
          ++i;
        }
      }
      Tout* dst = out + origin + e0;
      if (lo == e0 && hi_e == e0 + V) {
        STORE_GUARD(vals[0])
        *reinterpret_cast<uint4*>(dst) = Word<Tout>::pack(vals);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (e0 + e >= lo && e0 + e < hi_e) {
            STORE_GUARD(vals[e]) dst[e] = Word<Tout>::cast(vals[e]);
          }
      }
    }
    PHASE_END(1);
  } else {
    // ---- 2. samples: each thread a strip of V rows j of one column i,
    // neighbouring threads neighbouring columns (coalesced window reads);
    // the strip is one 16-byte word of the tile, which holds patch[x, y]
    // with a pitch of tp values per column ----
    const int tp = tile_pitch(s, V);
    const int strips = (s + V - 1) / V;
    for (int t = tid; t < np * strips * s; t += kThreads) {
      const int g = t / (strips * s);
      const int r = t - g * (strips * s);
      const int strip = r / s, i = r - strip * s;
      float vals[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = strip * V + e;
        vals[e] = j < s ? sample_at(g, j, i) : 0.f;
      }
      *reinterpret_cast<uint4*>(tile + (g * s + i) * tp + strip * V) =
          Word<Tout>::pack(vals);
    }
    PHASE_END(1);

    // ---- 3. the tile out as 16-byte words of patch[x, y] ----
    for (int k = tid; k < words; k += kThreads) {
      const int e0 = k * V - lead;
      const int lo = max(e0, 0), hi_e = min(e0 + V, total);
      int g = lo / ss;
      const int r = lo - g * ss;
      int i = r / s, j = r - i * s;
      Tout vals[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (e0 + e >= lo && e0 + e < hi_e) {
          vals[e] = tile[(g * s + i) * tp + j];
          if (++j == s) {
            j = 0;
            if (++i == s) {
              i = 0;
              ++g;
            }
          }
        }
      }
      Tout* dst = out + origin + e0;
      if (lo == e0 && hi_e == e0 + V) {
        const uint4 word = Word<Tout>::gather(vals);
        STORE_GUARD(__uint_as_float(word.x))
        *reinterpret_cast<uint4*>(dst) = word;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (e0 + e >= lo && e0 + e < hi_e) {
            STORE_GUARD(__uint_as_float(Word<Tout>::raw(vals[e])))
            dst[e] = vals[e];
          }
      }
    }
  }
#ifdef PATCHES_PHASE_CLOCKS
  PHASE_END(2);
#endif
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* windows, const void* oxy, const void* sp,
                   void* out, int n, int l, int ry, int rx, int s, int w,
                   int wx, int quantize, int fast, int transposed,
                   int per_block, cudaStream_t stream) {
  if (s > kMaxSize || per_block < 1) return cudaErrorInvalidValue;
  const Layout lay(s, per_block, transposed, sizeof(Tout));
  const int64_t nl = (int64_t)n * l;
  const int64_t blocks = (nl + per_block - 1) / per_block;
  auto kernel = transposed ? patches_window_kernel<Tin, Tout, true>
                           : patches_window_kernel<Tin, Tout, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, lay.bytes, stream>>>(
      static_cast<const Tin*>(windows), static_cast<const float*>(oxy),
      static_cast<const float*>(sp), static_cast<Tout*>(out), (int)nl, l, ry,
      rx, s, w, wx, quantize, fast, per_block);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_out(int bf16_out, const void* windows, const void* oxy,
                       const void* sp, void* out, int n, int l, int ry,
                       int rx, int s, int w, int wx, int quantize, int fast,
                       int transposed, int per_block, cudaStream_t stream) {
  if (bf16_out)
    return launch<Tin, __nv_bfloat16>(windows, oxy, sp, out, n, l, ry, rx, s,
                                      w, wx, quantize, fast, transposed,
                                      per_block, stream);
  return launch<Tin, float>(windows, oxy, sp, out, n, l, ry, rx, s, w, wx,
                            quantize, fast, transposed, per_block, stream);
}

}  // namespace

#ifdef PATCHES_PHASE_CLOCKS
// the phase cycles summed since the last call (kPhases values), then zero
extern "C" int patches_phase_cycles(void* host) {
  static const unsigned long long zero[kPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

// window_dtype: 0 uint8, 1 bfloat16, 2 float32
extern "C" int patches_window_launch(const void* windows, int window_dtype,
                                     const void* oxy, const void* sp,
                                     void* out, int bf16_out, int n, int l,
                                     int ry, int rx, int s, int w, int wx,
                                     int quantize, int fast, int transposed,
                                     int per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (window_dtype) {
    case 0:
      return (int)launch_out<uint8_t>(bf16_out, windows, oxy, sp, out, n, l,
                                      ry, rx, s, w, wx, quantize, fast,
                                      transposed, per_block, st);
    case 1:
      return (int)launch_out<__nv_bfloat16>(bf16_out, windows, oxy, sp, out,
                                            n, l, ry, rx, s, w, wx, quantize,
                                            fast, transposed, per_block, st);
    case 2:
      return (int)launch_out<float>(bf16_out, windows, oxy, sp, out, n, l,
                                    ry, rx, s, w, wx, quantize, fast,
                                    transposed, per_block, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
