// P4: 2 * x with each (S, S) tile written as one flat S*S row.
//
// Replaces the probe kernel of scripts/probe_flatout.py, which asked whether
// the TPU compiler can reshape an (S, S) tile to one (1, S*S) row inside a
// kernel. On this card the reshape is free (the two layouts are the same
// bytes); what is left to measure is the store pattern of the samplers'
// flat output: one block per tile stages the doubled tile in shared memory,
// row by row, and writes it out as one contiguous S*S-float row. What bounds
// it: memory, 2 * N * S * S * 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSize = 96;

__global__ void __launch_bounds__(kThreads)
probe_flatout_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int s) {
  __shared__ float tile[kMaxSize][kMaxSize + 1];
  const float* src = x + (int64_t)blockIdx.x * s * s;
  for (int o = threadIdx.x; o < s * s; o += blockDim.x)
    tile[o / s][o % s] = src[o] * 2.0f;
  __syncthreads();
  float* dst = out + (int64_t)blockIdx.x * s * s;
  for (int o = threadIdx.x; o < s * s; o += blockDim.x)
    dst[o] = tile[o / s][o % s];
}

}  // namespace

extern "C" int probe_flatout_launch(const void* x, void* out, int n, int s,
                                    void* stream) {
  if (s < 1 || s > kMaxSize) return (int)cudaErrorInvalidValue;
  probe_flatout_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}
