// P1-P3: the window-sampler probes, one templated kernel.
//
// Replaces the three probe kernels scripts/probe_sampler.py (variants full,
// shared, nodot), scripts/probe_sampler_g.py (G faces per grid step) and
// scripts/probe_sampler_pre.py (sub-window origins read from an int32 input
// or computed in the kernel). See probes/sampler.py for the contract and the
// plain PyTorch twin.
//
// What each asks on this card: where K2's time goes (tap tables against the
// contraction and the output stream), whether fewer, longer blocks (G faces
// per block) beat more blocks across the SMs, and whether one thread's
// float-to-int origin chain plus a block barrier costs more than a load of
// precomputed origins. One block takes G faces and loops over their
// landmarks; per landmark it forms the origin, fills the per-row and
// per-column tap tables in shared memory, evaluates the two-tap bilinear sum
// per output pixel (a tent row holds at most two non-zero taps, so this is
// the dense bf16 tent product of the TPU kernel term for term), stages the
// transposed patch in shared memory and writes it out contiguously.
// What bounds it: memory, the bf16 output stream (N * L * S * S * 2 bytes);
// the window reads are the few KB under each patch.
//
// Built with -fmad=false: every float operation rounds on its own, so the
// output equals the twin's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampler_taps.cuh"  // round_bf16, tap

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSize = 96;  // largest output side S the tables hold
enum Variant { kFull = 0, kShared = 1, kNoDot = 2 };

template <int V, int G, bool Pre>
__global__ void __launch_bounds__(kThreads)
probe_sampler_kernel(const __nv_bfloat16* __restrict__ windows,
                     const float* __restrict__ oxy,
                     const float* __restrict__ sp,
                     const int* __restrict__ oo,
                     __nv_bfloat16* __restrict__ out, int l, int ry, int rx,
                     int s, int w, int wx) {
  __shared__ int y_tap[kMaxSize], x_tap[kMaxSize];
  __shared__ float y_w0[kMaxSize], y_w1[kMaxSize];
  __shared__ float x_w0[kMaxSize], x_w1[kMaxSize];
  __shared__ float tile[kMaxSize * kMaxSize];  // transposed output staging
  __shared__ int origin[2];

  for (int fi = 0; fi < G; ++fi) {
    const int64_t face = (int64_t)blockIdx.x * G + fi;
    const float st = sp[face * 2];
    const float ph = sp[face * 2 + 1];
    const float hi = 2.f * ph - 1.f;
    const float src0 = fminf(fmaxf((0.f + 0.5f) * st - 0.5f, 0.f), hi);
    const __nv_bfloat16* win = windows + face * (int64_t)ry * rx;

    for (int lm = 0; lm < l; ++lm) {
      const float by = oxy[face * 2 * l + lm];
      const float bx = oxy[face * 2 * l + l + lm];
      int oy, ox;
      if (Pre) {
        // origins from the int32 input, kept inside the window
        oy = min(max(oo[face * 2 * l + lm], 0), ry - w);
        ox = min(max(oo[face * 2 * l + l + lm], 0), rx - wx);
      } else {
        // one thread's scalar chain, then a barrier
        if (threadIdx.x == 0) {
          int y = (int)fminf(fmaxf(floorf(by + src0), 0.f), (float)(ry - w));
          int x = (int)fminf(fmaxf(floorf(bx + src0), 0.f), (float)(rx - wx));
          origin[0] = (y / 8) * 8;
          origin[1] = (x / 128) * 128;
        }
        __syncthreads();
        oy = origin[0];
        ox = origin[1];
      }
      for (int j = threadIdx.x; j < s; j += blockDim.x) {
        float src = fminf(fmaxf(((float)j + 0.5f) * st - 0.5f, 0.f), hi);
        if (V == kShared) {
          // one base tent for every landmark: the crop-space grid itself
          tap(0.f, src, 0.f, w, 0, 1, &y_tap[j], &y_w0[j], &y_w1[j]);
          tap(0.f, src, 0.f, wx, 0, 1, &x_tap[j], &x_w0[j], &x_w1[j]);
        } else {
          tap(by, src, (float)oy, w, 0, 1, &y_tap[j], &y_w0[j], &y_w1[j]);
          tap(bx, src, (float)ox, wx, 0, 1, &x_tap[j], &x_w0[j], &x_w1[j]);
        }
      }
      __syncthreads();

      auto pix = [&](int v, int u, float weight) -> float {
        return weight != 0.f
                   ? __bfloat162float(win[(int64_t)(oy + v) * rx + (ox + u)])
                   : 0.f;
      };
      for (int o = threadIdx.x; o < s * s; o += blockDim.x) {
        float patch;
        if (V == kNoDot) {
          // tents built, products replaced: patch[a, b] = ty[a, b] + tx[a, b]
          // over the first S columns of the dense tents, a bf16 sum
          int a = o / s, b = o % s;
          float ty = b == y_tap[a] ? y_w0[a]
                                   : (b == y_tap[a] + 1 ? y_w1[a] : 0.f);
          float tx = b == x_tap[a] ? x_w0[a]
                                   : (b == x_tap[a] + 1 ? x_w1[a] : 0.f);
          patch = round_bf16(ty + tx);
          patch = fminf(fmaxf(floorf(patch + 0.5f), 0.f), 255.f);
          tile[o] = patch;
        } else {
          // neighbouring threads take neighbouring columns: coalesced reads
          int j = o / s;  // y (row) index
          int i = o % s;  // x (column) index
          int v = y_tap[j], u = x_tap[i];
          float ty0 = y_w0[j], ty1 = y_w1[j], tx0 = x_w0[i], tx1 = x_w1[i];
          float p00 = pix(v, u, ty0 * tx0), p01 = pix(v, u + 1, ty0 * tx1);
          float p10 = pix(v + 1, u, ty1 * tx0);
          float p11 = pix(v + 1, u + 1, ty1 * tx1);
          float q0 = round_bf16(tx0 * p00 + tx1 * p01);  // x pass first
          float q1 = round_bf16(tx0 * p10 + tx1 * p11);
          patch = q0 * ty0 + q1 * ty1;
          patch = fminf(fmaxf(floorf(patch + 0.5f), 0.f), 255.f);
          tile[i * s + j] = patch;  // patch[x, y]
        }
      }
      __syncthreads();
      __nv_bfloat16* dst = out + (face * l + lm) * (int64_t)s * s;
      for (int o = threadIdx.x; o < s * s; o += blockDim.x)
        dst[o] = __float2bfloat16_rn(tile[o]);
      // the next landmark's tables and tile are written only after the
      // barriers above; this one keeps its tile until every thread has read
      __syncthreads();
    }
  }
}

template <int V, int G, bool Pre>
cudaError_t launch(const void* windows, const void* oxy, const void* sp,
                   const void* oo, void* out, int n, int l, int ry, int rx,
                   int s, int w, int wx, cudaStream_t stream) {
  probe_sampler_kernel<V, G, Pre><<<n / G, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(windows),
      static_cast<const float*>(oxy), static_cast<const float*>(sp),
      static_cast<const int*>(oo), static_cast<__nv_bfloat16*>(out), l, ry,
      rx, s, w, wx);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 full, 1 shared, 2 nodot (G = 1, origins computed). g: faces per
// block, 1, 2 or 4 (variant full; n a multiple of g). pre: origins read
// from oo (variant full, g = 1).
extern "C" int probe_sampler_launch(const void* windows, const void* oxy,
                                    const void* sp, const void* oo, void* out,
                                    int n, int l, int ry, int rx, int s,
                                    int w, int wx, int variant, int g,
                                    int pre, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s > kMaxSize || s > w || s > wx || g < 1 || n % g != 0)
    return (int)cudaErrorInvalidValue;
#define PROBE_LAUNCH(V, G, P)                                              \
  return (int)launch<V, G, P>(windows, oxy, sp, oo, out, n, l, ry, rx, s, \
                              w, wx, st)
  if (variant == kFull && g == 1 && !pre) PROBE_LAUNCH(kFull, 1, false);
  if (variant == kShared && g == 1 && !pre) PROBE_LAUNCH(kShared, 1, false);
  if (variant == kNoDot && g == 1 && !pre) PROBE_LAUNCH(kNoDot, 1, false);
  if (variant == kFull && g == 2 && !pre) PROBE_LAUNCH(kFull, 2, false);
  if (variant == kFull && g == 4 && !pre) PROBE_LAUNCH(kFull, 4, false);
  if (variant == kFull && g == 1 && pre) PROBE_LAUNCH(kFull, 1, true);
#undef PROBE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
