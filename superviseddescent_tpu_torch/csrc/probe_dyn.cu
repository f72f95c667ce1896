// P5: the dynamic-indexing probes, three small kernels.
//
// Replaces scripts/probe_dyn.py::probe_abde (kernel_abde), probe_c
// (kernel_c) and probe_c4 (kernel_c4), which asked the TPU compiler for
// dynamic first-axis loads, dynamic aligned sub-slices, dynamic stores and a
// slice offset derived from a loaded value. On this card each is an indexed
// access; the probes' worth here is that they compute the same numbers. See
// probes/dyn.py for the contracts and the plain PyTorch twins. What bounds
// them: nothing of the card's (a few hundred KB and MFLOP); their time is
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ABDE: one block per face. Per landmark lm (a run-time loop index): the
// scalars x[g, lm] and x[g, lm + L] picked from the face's row, truncated to
// int, clamped and floored to an (8, 128)-aligned origin; the (W, WX)
// sub-window at that origin; q = tx . subT and patch = bf16(q) . tyT with
// constant bf16 tents of 0.01, f32 sums in increasing index order; the
// (S, SEG) patch stored in bf16 at pwide[lm]. Then pscr[:, lm*S:(lm+1)*S] =
// pwide[lm, :, 0:S] and the column sums of pscr, of which [0, 2L) leave.
__global__ void __launch_bounds__(kThreads)
probe_abde_kernel(const float* __restrict__ x,
                  const __nv_bfloat16* __restrict__ win,
                  float* __restrict__ out, int ry, int rx, int s, int w,
                  int wx, int l, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);                   // (S, W)
  __nv_bfloat16* tx = reinterpret_cast<__nv_bfloat16*>(q + s * w);  // (S, WX)
  __nv_bfloat16* ty = tx + s * wx;                             // (SEG, W)
  __nv_bfloat16* pwide = ty + seg * w;                         // (L, S, SEG)
  __nv_bfloat16* pscr = pwide + l * s * seg;                   // (S, L*S)
  __shared__ int origin[2];

  const int g = blockIdx.x;
  const float* row = x + (int64_t)g * 2 * l;
  const __nv_bfloat16* face = win + (int64_t)g * ry * rx;
  const __nv_bfloat16 tent = __float2bfloat16_rn(0.01f);
  for (int i = threadIdx.x; i < s * wx; i += blockDim.x) tx[i] = tent;
  for (int i = threadIdx.x; i < seg * w; i += blockDim.x) ty[i] = tent;

  for (int lm = 0; lm < l; ++lm) {
    if (threadIdx.x == 0) {
      int oy = min(max((int)row[lm + l], 0), ry - w);
      int ox = min(max((int)row[lm], 0), rx - wx);
      origin[0] = (oy / 8) * 8;
      origin[1] = (ox / 128) * 128;
    }
    __syncthreads();
    const __nv_bfloat16* sub = face + (int64_t)origin[0] * rx + origin[1];
    for (int o = threadIdx.x; o < s * w; o += blockDim.x) {
      int a = o / w, r = o % w;
      float acc = 0.f;
      for (int c = 0; c < wx; ++c)
        acc += __bfloat162float(tx[a * wx + c]) *
               __bfloat162float(sub[(int64_t)r * rx + c]);
      q[o] = round_bf16(acc);
    }
    __syncthreads();
    for (int o = threadIdx.x; o < s * seg; o += blockDim.x) {
      int a = o / seg, j = o % seg;
      float acc = 0.f;
      for (int r = 0; r < w; ++r)
        acc += q[a * w + r] * __bfloat162float(ty[j * w + r]);
      pwide[(lm * s + a) * seg + j] = __float2bfloat16_rn(acc);
    }
    __syncthreads();
  }
  for (int o = threadIdx.x; o < s * l * s; o += blockDim.x) {
    int a = o / (l * s), col = o % (l * s);
    pscr[o] = pwide[((col / s) * s + a) * seg + col % s];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < 2 * l; col += blockDim.x) {
    float acc = 0.f;
    for (int a = 0; a < s; ++a)
      acc += __bfloat162float(pscr[a * l * s + col]);
    out[(int64_t)g * 2 * l + col] = acc;
  }
}

// C: for every face g and k in {0, 1}, rows v[0:4] + g + 10 k stored at row
// offset k * G * BR + g * BR of a (2 * G * BR, SEG) scratch, then the
// scratch copied out. Rows never stored are zero.
__global__ void __launch_bounds__(kThreads)
probe_c_kernel(const float* __restrict__ v, float* __restrict__ out, int g_n,
               int br, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bscr = reinterpret_cast<float*>(smem);         // (2 * G * BR, SEG)
  const int gb = g_n * br;
  for (int i = threadIdx.x; i < 2 * gb * seg; i += blockDim.x) bscr[i] = 0.f;
  __syncthreads();
  for (int g = 0; g < g_n; ++g)
    for (int k = 0; k < 2; ++k) {
      int off = k * gb + g * br;
      for (int i = threadIdx.x; i < 4 * seg; i += blockDim.x)
        bscr[off * seg + i] = (v[i] + (float)g) + 10.0f * (float)k;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * gb * seg; i += blockDim.x)
    out[i] = bscr[i];
}

// C4: the same rows stored at [k, g, 0:4, :] of a (2, G, BR, SEG) scratch,
// read back block by block as (G * BR, SEG).
__global__ void __launch_bounds__(kThreads)
probe_c4_kernel(const float* __restrict__ v, float* __restrict__ out,
                int g_n, int br, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bscr4 = reinterpret_cast<float*>(smem);        // (2, G, BR, SEG)
  const int gb = g_n * br;
  auto at = [&](int k, int g, int r, int c) -> float& {
    return bscr4[((k * g_n + g) * br + r) * seg + c];
  };
  for (int i = threadIdx.x; i < 2 * gb * seg; i += blockDim.x) bscr4[i] = 0.f;
  __syncthreads();
  for (int g = 0; g < g_n; ++g)
    for (int k = 0; k < 2; ++k)
      for (int i = threadIdx.x; i < 4 * seg; i += blockDim.x)
        at(k, g, i / seg, i % seg) = (v[i] + (float)g) + 10.0f * (float)k;
  __syncthreads();
  for (int k = 0; k < 2; ++k)
    for (int i = threadIdx.x; i < gb * seg; i += blockDim.x) {
      int row = i / seg;
      out[(int64_t)(k * gb + row) * seg + i % seg] =
          at(k, row / br, row % br, i % seg);
    }
}

}  // namespace

extern "C" int probe_abde_launch(const void* x, const void* win, void* out,
                                 int g, int ry, int rx, int s, int w, int wx,
                                 int l, int seg, void* stream) {
  size_t bytes = (size_t)s * w * 4 +
                 2 * ((size_t)s * wx + (size_t)seg * w +
                      (size_t)l * s * seg + (size_t)s * l * s);
  if (bytes > 48 * 1024 || s > seg || 2 * l > l * s || w > ry || wx > rx)
    return (int)cudaErrorInvalidValue;
  probe_abde_kernel<<<g, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(win),
      static_cast<float*>(out), ry, rx, s, w, wx, l, seg);
  return (int)cudaGetLastError();
}

extern "C" int probe_c_launch(const void* v, void* out, int four_d, int g,
                              int br, int seg, void* stream) {
  size_t bytes = (size_t)2 * g * br * seg * 4;
  if (bytes > 48 * 1024 || br < 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (four_d)
    probe_c4_kernel<<<1, kThreads, bytes, st>>>(
        static_cast<const float*>(v), static_cast<float*>(out), g, br, seg);
  else
    probe_c_kernel<<<1, kThreads, bytes, st>>>(
        static_cast<const float*>(v), static_cast<float*>(out), g, br, seg);
  return (int)cudaGetLastError();
}
