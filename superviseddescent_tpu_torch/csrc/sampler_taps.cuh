// Bilinear taps of the window samplers (K2 and the sampler probes).
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Taps of one axis: first tap index in the sub-window and the two weights,
// zeroed where the tap lies outside [0, span).
__device__ __forceinline__ void tap(float start, float src, float origin,
                                    int span, int quantize, int fast,
                                    int* i0, float* t0, float* t1) {
  float coord = (start + src) - origin;
  float u0 = floorf(coord);
  float a = fmaxf(1.f - fabsf(coord - u0), 0.f);
  float b = fmaxf(1.f - fabsf(coord - (u0 + 1.f)), 0.f);
  if (quantize && !fast) {
    a = rintf(a * 2048.f) * (1.f / 2048.f);
    b = rintf(b * 2048.f) * (1.f / 2048.f);
  }
  if (fast) {
    a = round_bf16(a);
    b = round_bf16(b);
  }
  int u = (int)u0;
  *i0 = u;
  *t0 = (u >= 0 && u < span) ? a : 0.f;
  *t1 = (u + 1 >= 0 && u + 1 < span) ? b : 0.f;
}
