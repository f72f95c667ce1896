// P1-P3: the window-sampler probes, one templated kernel.
//
// Replaces the three probe kernels scripts/probe_sampler.py (variants full,
// shared, nodot), scripts/probe_sampler_g.py (G faces per grid step) and
// scripts/probe_sampler_pre.py (sub-window origins read from an int32 input
// or computed in the kernel). See probes/sampler.py for the contract, the
// launch plan and the plain PyTorch twin.
//
// What each asks on this card: where the sampler's time goes (tap tables,
// window reads, products, the transposed output stream), whether fewer,
// longer blocks (G faces per block) beat more blocks across the SMs, and
// whether forming the sub-window origins in the kernel costs more than a
// load of precomputed origins.
// What bounds it: memory, the bf16 output stream (N * L * S * S * 2 bytes)
// and the union of each face's window taps. What holds it back: the window
// reads, four 2-byte gathers an output. A face's patches overlap, so a
// face's window is read from L2 many times over; with many faces in flight
// their windows leave L2. So a block takes few faces and keeps many of
// their patches in flight, and two blocks share an SM.
//
// A block takes the G * L patches of G faces, whose outputs lie contiguous
// in memory, face by face in groups of up to `group` patches of one face
// (probes/sampler.py::launch_plan: a face in the fewest rounds of at most
// 1,024 threads, two blocks an SM; blocks of up to 768 threads take the
// build with 40 registers a thread, larger ones 32), and runs each group
// phase by phase with one barrier per phase:
//   1. tables: one thread per (patch, output row), which forms the patch's
//      sub-window origin (or loads it, pre) and the row's and the column's
//      taps: the read offset of a tap pair that lies inside the sub-window
//      and its two bf16 weights, in one 16-byte entry;
//   2. samples: one thread per (patch, output column) walks down the
//      column, the next row's four window reads in flight while a row's
//      sums run; each row's taps are one broadcast read, neighbouring
//      threads read neighbouring window columns; the values (integers
//      0-255, which bf16 holds exactly) go into a bf16 tile that holds the
//      group's outputs as they lie in the output;
//   3. stores: the tile goes out as 16-byte words on 16-byte boundaries of
//      the whole output (the first and last word of a group, which its
//      neighbours share, value by value).
// No output index is divided: a thread finds its patch and column once.
// An output reads four pixels at one address and three fixed steps from it
// (one column, one window row, both).
//
// Built with -fmad=false: every float operation rounds on its own; every
// float32 sum has at most two non-zero terms of exact bf16 products, so the
// output equals the twin's bit for bit, for every plan.
//
// Measurement builds (chip_smoke.py's probe_split and probe_sweep, never an
// entry point): -DPROBE_SKIP_STORE computes every output but stores none,
// -DPROBE_NO_GATHER takes each pixel from its offset instead of the window
// (no window read), -DPROBE_PHASE_CLOCKS sums thread 0's cycles per phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampler_taps.cuh"  // round_bf16, tap

namespace {

constexpr int kMaxSize = 96;      // largest output side S
constexpr int kMaxThreads = 1024;  // largest block of a plan
// blocks of up to this many threads take the build with up to 40
// registers a thread, larger ones the build with 32 (two blocks an SM)
constexpr int kWideThreads = 768;
constexpr int kWord = 8;          // bf16 values per 16-byte word
enum Variant { kFull = 0, kShared = 1, kNoDot = 2 };

#ifdef PROBE_PHASE_CLOCKS
// thread 0's cycles from one barrier to the next, summed over the blocks:
// origins and tables, taps products and tile, stores
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

#ifdef PROBE_SKIP_STORE
// no output word has these bits: every store is skipped, and the compiler
// still computes every value
#define STORE_GUARD(bits) if ((bits) == 0xffffffffu)
#else
#define STORE_GUARD(bits)
#endif

__host__ __device__ inline int take(int* at, int bytes) {
  int here = *at;
  *at += (bytes + 15) / 16 * 16;
  return here;
}

// Dynamic shared memory of a block of `group` patches, each buffer 16-byte
// aligned; probes/sampler.py::shared_bytes counts the same.
struct Layout {
  int ytab, xtab, base, tile, bytes;
  __host__ __device__ Layout(int s, int group) {
    int at = 0;
    ytab = take(&at, group * s * 16);
    xtab = take(&at, group * s * 16);
    base = take(&at, group * 8);  // each patch's sub-window in the windows
    // the group's outputs as they lie in the output, from the 16-byte
    // boundary before the first
    tile = take(&at, (group * s * s + 2 * kWord) * 2);
    bytes = at;
  }
};

// n / d for 0 <= n < 2^22 from d's float reciprocal: the product is within
// one of the quotient, and one step corrects it
__device__ __forceinline__ int div_small(int n, int d, float inv_d) {
  int q = (int)((float)n * inv_d);
  const int r = n - q * d;
  return r < 0 ? q - 1 : (r >= d ? q + 1 : q);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}
__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// the raw bf16 bits of the pixel `at` elements past p (p at `offset` in
// the face's window)
__device__ __forceinline__ uint32_t pixel(const __nv_bfloat16* p, int offset,
                                          int at) {
#ifdef PROBE_NO_GATHER
  (void)p;
  return __float_as_uint((float)((offset + at) & 255)) >> 16;
#else
  (void)offset;
  return __bfloat16_as_ushort(p[at]);
#endif
}

// one output's row weights and its four raw pixels, read ahead of its sums
struct Quad {
  uint32_t ty, p00, p01, p10, p11;
};

// A tap entry (16 bytes): the first read offset (a row offset in elements
// of the window, or a column) and the bf16 weights of the pair it starts,
// the pair moved inside the sub-window where it reaches out of it (a tap
// outside has weight 0, so the weight that stays moves to the other slot:
// each two-term sum keeps its value, and every read lies in the window);
// then the first tap's index and its two weights as `tap` gives them.
__device__ __forceinline__ uint4 tap_entry(float start, float src,
                                           float origin, int span,
                                           int stride) {
  int i0;
  float t0, t1;
  tap(start, src, origin, span, 0, 1, &i0, &t0, &t1);
  int a = i0;
  float w0 = t0, w1 = t1;
  if (i0 < 0) {
    a = 0;
    w0 = i0 == -1 ? t1 : 0.f;
    w1 = 0.f;
  } else if (i0 > span - 2) {
    a = span - 2;
    w0 = 0.f;
    w1 = i0 == span - 1 ? t0 : 0.f;
  }
  return make_uint4((uint32_t)(a * stride), pack_bf16(w0, w1), (uint32_t)i0,
                    pack_bf16(t0, t1));
}

// two blocks of up to MaxThreads threads an SM
template <int V, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads, 2)
probe_sampler_kernel(const __nv_bfloat16* __restrict__ windows,
                     const float* __restrict__ oxy,
                     const float* __restrict__ sp,
                     const int* __restrict__ oo,
                     __nv_bfloat16* __restrict__ out, int l, int ry, int rx,
                     int s, int w, int wx, int faces, int pre, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(s, group);
  uint4* ytab = reinterpret_cast<uint4*>(smem + lay.ytab);
  uint4* xtab = reinterpret_cast<uint4*>(smem + lay.xtab);
  int64_t* base = reinterpret_cast<int64_t*>(smem + lay.base);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem + lay.tile);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const float inv_s = 1.f / (float)s;
  const int ss = s * s;
  // the block's patches, contiguous in the output, face by face
  const int64_t block_first = (int64_t)blockIdx.x * faces * l;
#ifdef PROBE_PHASE_CLOCKS
  long long stamp = clock64();
#endif

  // a group never spans two faces: the last of a face may be shorter
  for (int gi = 0, np = 0; gi < faces * l; gi += np) {
    np = min(group, l - gi % l);
    const int64_t first = block_first + gi;
    const int64_t origin = first * ss;  // the group's first output element
    const int lead = (int)(origin % kWord);

    // ---- 1. origins and tap tables of every (patch, row) ----
    for (int t = tid; t < np * s; t += nthreads) {
      const int g = div_small(t, s, inv_s), j = t - g * s;
      const int64_t patch = first + g;
      const int64_t face = patch / l;
      const int lm = (int)(patch - face * l);
      const float by = oxy[face * 2 * l + lm];
      const float bx = oxy[face * 2 * l + l + lm];
      const float st = sp[face * 2];
      const float ph = sp[face * 2 + 1];
      const float hi = 2.f * ph - 1.f;
      int oy, ox;
      if (pre) {
        // origins from the int32 input, kept inside the window
        oy = min(max(oo[face * 2 * l + lm], 0), ry - w);
        ox = min(max(oo[face * 2 * l + l + lm], 0), rx - wx);
      } else {
        const float src0 = fminf(fmaxf((0.f + 0.5f) * st - 0.5f, 0.f), hi);
        oy = (int)fminf(fmaxf(floorf(by + src0), 0.f), (float)(ry - w));
        ox = (int)fminf(fmaxf(floorf(bx + src0), 0.f), (float)(rx - wx));
        oy = (oy / 8) * 8;
        ox = (ox / 128) * 128;
      }
      const float src = fminf(fmaxf(((float)j + 0.5f) * st - 0.5f, 0.f), hi);
      if (V == kShared) {
        // one base tent for every landmark: the crop-space grid itself
        ytab[t] = tap_entry(0.f, src, 0.f, w, rx);
        xtab[t] = tap_entry(0.f, src, 0.f, wx, 1);
      } else {
        ytab[t] = tap_entry(by, src, (float)oy, w, rx);
        xtab[t] = tap_entry(bx, src, (float)ox, wx, 1);
      }
      if (j == 0) base[g] = (face * ry + oy) * (int64_t)rx + ox;
    }
    PHASE_END(0);

    // ---- 2. samples: one thread per (patch, column i), down the column
    // eight rows j at a time, into the tile at (patch, i, j): neighbouring
    // threads S values apart ----
    for (int col = tid; col < np * s; col += nthreads) {
      const int g = div_small(col, s, inv_s);  // column i = col - g * s
      const uint4 xt = xtab[col];
      const float tx0 = lo_bf16(xt.y), tx1 = hi_bf16(xt.y);
      const __nv_bfloat16* win = windows + base[g] + xt.x;
      const uint4* yrow = ytab + g * s;
      __nv_bfloat16* dst = tile + lead + g * ss + (col - g * s) * s;
      // output (i, j): the quantised sample at row j of this column, its
      // reads (fetch) apart from its sums (finish), so that the next row's
      // reads are in flight while this row's sums run
      auto fetch = [&](int j) -> Quad {
        const uint4 yt = yrow[j];  // the same for the whole warp
        const __nv_bfloat16* p = win + yt.x;
        const int at = (int)(yt.x + xt.x);
        return Quad{yt.y, pixel(p, at, 0), pixel(p, at, 1), pixel(p, at, rx),
                    pixel(p, at, rx + 1)};
      };
      auto finish = [&](int j, const Quad& q) -> __nv_bfloat16 {
        float patch;
        if (V == kNoDot) {
          // tents built, products replaced: patch[a, b] = ty[a, b] +
          // tx[a, b] over the first S columns of the dense tents, with
          // a = i (this thread's tables) and b = j, a bf16 sum
          const uint4 yt = ytab[col];
          const int vy = (int)yt.z, vx = (int)xt.z;
          const float ty = j == vy ? lo_bf16(yt.w)
                                   : (j == vy + 1 ? hi_bf16(yt.w) : 0.f);
          const float tx = j == vx ? lo_bf16(xt.w)
                                   : (j == vx + 1 ? hi_bf16(xt.w) : 0.f);
          patch = round_bf16(ty + tx);
        } else {
          const float q0 = round_bf16(tx0 * lo_bf16(q.p00) +
                                      tx1 * lo_bf16(q.p01));  // x first
          const float q1 = round_bf16(tx0 * lo_bf16(q.p10) +
                                      tx1 * lo_bf16(q.p11));
          patch = q0 * lo_bf16(q.ty) + q1 * hi_bf16(q.ty);
        }
        patch = fminf(fmaxf(floorf(patch + 0.5f), 0.f), 255.f);
        // a whole number 0-255: its bf16 bits are the float's upper half
        return __ushort_as_bfloat16((uint16_t)(__float_as_uint(patch) >> 16));
      };
      if (V == kNoDot) {
        for (int j = 0; j < s; ++j) dst[j] = finish(j, Quad{});
      } else {
        Quad cur = fetch(0);
        int j = 0;
        for (; j + kWord <= s; j += kWord) {
          // eight rows without a branch; the last fetch of the column reads
          // its last row again
#pragma unroll
          for (int e = 0; e < kWord; ++e) {
            const Quad next = fetch(min(j + e + 1, s - 1));
            dst[j + e] = finish(j + e, cur);
            cur = next;
          }
        }
        for (; j < s; ++j) {
          const Quad next = fetch(min(j + 1, s - 1));
          dst[j] = finish(j, cur);
          cur = next;
        }
      }
    }
    PHASE_END(1);

    // ---- 3. the tile out as 16-byte words, word k of the tile at the
    // k-th 16-byte boundary from the group's first output; the first and
    // last word, which the neighbouring groups share, value by value. The
    // next group's tables are written before the barrier that precedes its
    // samples ----
    const int end = lead + np * ss;
    const int words = (end + kWord - 1) / kWord;
    __nv_bfloat16* out0 = out + (origin - lead);
    for (int k = tid; k < words; k += nthreads) {
      const uint4 word = reinterpret_cast<const uint4*>(tile)[k];
      if (k * kWord >= lead && k * kWord + kWord <= end) {
        STORE_GUARD(word.x)
        reinterpret_cast<uint4*>(out0)[k] = word;
      } else {
        const uint32_t v[4] = {word.x, word.y, word.z, word.w};
#pragma unroll
        for (int e = 0; e < kWord; ++e) {
          const int at = k * kWord + e;
          const uint32_t bits = (v[e / 2] >> (16 * (e % 2))) & 0xffffu;
          if (at >= lead && at < end) {
            STORE_GUARD(bits) out0[at] = __ushort_as_bfloat16((uint16_t)bits);
          }
        }
      }
    }
#ifdef PROBE_PHASE_CLOCKS
    PHASE_END(2);
#endif
  }
}

template <int V>
cudaError_t launch(const void* windows, const void* oxy, const void* sp,
                   const void* oo, void* out, int n, int l, int ry, int rx,
                   int s, int w, int wx, int g, int pre, int group,
                   int threads, cudaStream_t stream) {
  const Layout lay(s, group);
  auto kernel = threads <= kWideThreads
                    ? probe_sampler_kernel<V, kWideThreads>
                    : probe_sampler_kernel<V, kMaxThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<n / g, threads, lay.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(windows),
      static_cast<const float*>(oxy), static_cast<const float*>(sp),
      static_cast<const int*>(oo), static_cast<__nv_bfloat16*>(out), l, ry,
      rx, s, w, wx, g, pre, group);
  return cudaGetLastError();
}

}  // namespace

#ifdef PROBE_PHASE_CLOCKS
// the phase cycles summed since the last call (kPhases values), then zero
extern "C" int probe_phase_cycles(void* host) {
  static const unsigned long long zero[kPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

// variant: 0 full, 1 shared, 2 nodot. g: faces per block (n a multiple of
// g). pre: origins read from oo. group, threads: the launch plan
// (probes/sampler.py::launch_plan): group <= l patches of a face in
// flight, a thread per output column.
extern "C" int probe_sampler_launch(const void* windows, const void* oxy,
                                    const void* sp, const void* oo, void* out,
                                    int n, int l, int ry, int rx, int s,
                                    int w, int wx, int variant, int g,
                                    int pre, int group, int threads,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > kMaxSize || s > w || s > wx || w > ry || wx > rx ||
      g < 1 || n % g != 0 || group < 1 || group > l || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (int64_t)group * s * s >= (1 << 22))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kFull:
      return (int)launch<kFull>(windows, oxy, sp, oo, out, n, l, ry, rx, s, w,
                                wx, g, pre, group, threads, st);
    case kShared:
      return (int)launch<kShared>(windows, oxy, sp, oo, out, n, l, ry, rx, s,
                                  w, wx, g, pre, group, threads, st);
    case kNoDot:
      return (int)launch<kNoDot>(windows, oxy, sp, oo, out, n, l, ry, rx, s,
                                 w, wx, g, pre, group, threads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
