// P4: 2 * x with each (S, S) tile written as one flat S*S row.
//
// Replaces the probe kernel of scripts/probe_flatout.py, which asked whether
// the TPU compiler can reshape an (S, S) tile to one (1, S*S) row inside a
// kernel. On this card the (S, S) tile and the flat row are the same bytes,
// so the function is 2 * x over N * S * S contiguous floats: one pass with
// two 16-byte loads and stores a thread, and scalar loads and stores for the
// elements before the first 16-byte boundary of the input and after the
// last whole 16-byte word (every element when input and output are not
// aligned alike). What bounds it: memory, 2 * N * S * S * 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 2;  // 16-byte words a thread, both loaded first
constexpr int kMaxSize = 96;

// two 16-byte words a thread, a block's words contiguous (a grid of
// N*S*S / 1,024 blocks fills the 132 SMs many times over), then the scalar
// elements: [0, head) and [head + 4 * words, total)
__global__ void __launch_bounds__(kThreads)
probe_flatout_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int64_t total, int64_t head, int64_t words) {
  const int64_t i = (int64_t)blockIdx.x * kThreads * kWords + threadIdx.x;
  float4 v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    if (i + k * kThreads < words)
      v[k] = reinterpret_cast<const float4*>(x + head)[i + k * kThreads];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (i + k * kThreads >= words) continue;
    v[k].x = v[k].x * 2.0f;
    v[k].y = v[k].y * 2.0f;
    v[k].z = v[k].z * 2.0f;
    v[k].w = v[k].w * 2.0f;
    reinterpret_cast<float4*>(out + head)[i + k * kThreads] = v[k];
  }
  const int64_t tail = head + 4 * words;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int64_t j = i + k * kThreads;
    if (j < head + total - tail) {
      const int64_t e = j < head ? j : tail + (j - head);
      out[e] = x[e] * 2.0f;
    }
  }
}

}  // namespace

extern "C" int probe_flatout_launch(const void* x, void* out, int n, int s,
                                    void* stream) {
  if (s < 1 || s > kMaxSize) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t total = (int64_t)n * s * s;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  // floats before the input's first 16-byte boundary; the output must
  // reach its boundary after as many, or no element moves as a word
  int64_t head = (int64_t)(((16 - (xa & 15)) & 15) / 4);
  if ((xa & 3) != 0 || ((oa + 4 * head) & 15) != 0 || head > total)
    head = total;
  const int64_t words = (total - head) / 4;
  const int64_t scalars = total - 4 * words;
  const int64_t threads = words > scalars ? words : scalars;
  const int64_t per_block = kThreads * kWords;
  const int64_t blocks = (threads + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  probe_flatout_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), total, head,
      words);
  return (int)cudaGetLastError();
}
