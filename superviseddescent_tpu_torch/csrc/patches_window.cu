// K2: window patch sampler, one block per (face, landmark).
//
// Replaces superviseddescent_tpu/ops/patches_pallas.py::
// sample_patches_window (_sampler_kernel). See ops/patches_window.py for the
// contract, the plain PyTorch twin, and what bounds the kernel on the H100
// (memory: the S x S output stream; the window reads are a few KB per
// patch).
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do, so the output equals the
// twin's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampler_taps.cuh"  // round_bf16, tap

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSize = 96;  // largest output side S the tables hold

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

template <typename T>
__device__ __forceinline__ void store(T* p, int64_t i, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, int64_t i, float v) {
  p[i] = v;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
patches_window_kernel(const Tin* __restrict__ windows,
                      const float* __restrict__ oxy,
                      const float* __restrict__ sp, Tout* __restrict__ out,
                      int l, int ry, int rx, int s, int w, int wx,
                      int quantize, int fast, int transposed) {
  __shared__ int y_tap[kMaxSize], x_tap[kMaxSize];
  __shared__ float y_w0[kMaxSize], y_w1[kMaxSize];
  __shared__ float x_w0[kMaxSize], x_w1[kMaxSize];
  __shared__ float tile[kMaxSize * kMaxSize];  // transposed output staging

  const int64_t face = blockIdx.x / l;
  const int lm = blockIdx.x % l;
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
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    float src = fminf(fmaxf(((float)j + 0.5f) * st - 0.5f, 0.f), hi);
    tap(by, src, (float)oy, w, quantize, fast, &y_tap[j], &y_w0[j],
        &y_w1[j]);
    tap(bx, src, (float)ox, wx, quantize, fast, &x_tap[j], &x_w0[j],
        &x_w1[j]);
  }
  __syncthreads();

  const Tin* win = windows + face * (int64_t)ry * rx;
  // pixel at sub-window row v, column u; only read where the weight is
  // non-zero (a zero-weight tap may lie outside the window)
  auto pix = [&](int v, int u, float weight) -> float {
    return weight != 0.f ? load<Tin>(win, (int64_t)(oy + v) * rx + (ox + u))
                         : 0.f;
  };
  Tout* dst = out + (int64_t)blockIdx.x * s * s;
  for (int o = threadIdx.x; o < s * s; o += blockDim.x) {
    // neighbouring threads take neighbouring columns, so window reads
    // coalesce in both output orders
    int j = o / s;  // y (row) index
    int i = o % s;  // x (column) index
    int v = y_tap[j], u = x_tap[i];
    float ty0 = y_w0[j], ty1 = y_w1[j], tx0 = x_w0[i], tx1 = x_w1[i];
    float p00 = pix(v, u, ty0 * tx0), p01 = pix(v, u + 1, ty0 * tx1);
    float p10 = pix(v + 1, u, ty1 * tx0), p11 = pix(v + 1, u + 1, ty1 * tx1);
    float patch;
    if (transposed) {
      float q0 = tx0 * p00 + tx1 * p01;  // x pass first
      float q1 = tx0 * p10 + tx1 * p11;
      if (fast) {
        q0 = round_bf16(q0);
        q1 = round_bf16(q1);
      }
      patch = q0 * ty0 + q1 * ty1;
    } else {
      float r0 = ty0 * p00 + ty1 * p10;  // y pass first
      float r1 = ty0 * p01 + ty1 * p11;
      if (fast) {
        r0 = round_bf16(r0);
        r1 = round_bf16(r1);
      }
      patch = r0 * tx0 + r1 * tx1;
    }
    if (quantize) patch = fminf(fmaxf(floorf(patch + 0.5f), 0.f), 255.f);
    if (transposed) {
      tile[i * s + j] = patch;  // patch[x, y], written out below
    } else {
      store<Tout>(dst, o, patch);
    }
  }
  if (transposed) {
    __syncthreads();
    for (int o = threadIdx.x; o < s * s; o += blockDim.x)
      store<Tout>(dst, o, tile[o]);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* windows, const void* oxy, const void* sp,
                   void* out, int n, int l, int ry, int rx, int s, int w,
                   int wx, int quantize, int fast, int transposed,
                   cudaStream_t stream) {
  if (s > kMaxSize) return cudaErrorInvalidValue;
  patches_window_kernel<Tin, Tout><<<n * l, kThreads, 0, stream>>>(
      static_cast<const Tin*>(windows), static_cast<const float*>(oxy),
      static_cast<const float*>(sp), static_cast<Tout*>(out), l, ry, rx, s,
      w, wx, quantize, fast, transposed);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_out(int bf16_out, const void* windows, const void* oxy,
                       const void* sp, void* out, int n, int l, int ry,
                       int rx, int s, int w, int wx, int quantize, int fast,
                       int transposed, cudaStream_t stream) {
  if (bf16_out)
    return launch<Tin, __nv_bfloat16>(windows, oxy, sp, out, n, l, ry, rx, s,
                                      w, wx, quantize, fast, transposed,
                                      stream);
  return launch<Tin, float>(windows, oxy, sp, out, n, l, ry, rx, s, w, wx,
                            quantize, fast, transposed, stream);
}

}  // namespace

// window_dtype: 0 uint8, 1 bfloat16, 2 float32
extern "C" int patches_window_launch(const void* windows, int window_dtype,
                                     const void* oxy, const void* sp,
                                     void* out, int bf16_out, int n, int l,
                                     int ry, int rx, int s, int w, int wx,
                                     int quantize, int fast, int transposed,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (window_dtype) {
    case 0:
      return (int)launch_out<uint8_t>(bf16_out, windows, oxy, sp, out, n, l,
                                      ry, rx, s, w, wx, quantize, fast,
                                      transposed, st);
    case 1:
      return (int)launch_out<__nv_bfloat16>(bf16_out, windows, oxy, sp, out,
                                            n, l, ry, rx, s, w, wx, quantize,
                                            fast, transposed, st);
    case 2:
      return (int)launch_out<float>(bf16_out, windows, oxy, sp, out, n, l,
                                    ry, rx, s, w, wx, quantize, fast,
                                    transposed, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
