// K1: VLFeat HOG of flattened S x S patches, one block per patch.
//
// Replaces superviseddescent_tpu/ops/hog_pallas_flat.py::
// hog_descriptor_pallas_flat (_flat_kernel). See ops/hog_flat.py for the
// contract, the plain PyTorch twin, and what bounds the kernel on the H100
// (memory: each patch is read once and each descriptor written once; every
// intermediate stays in shared memory).
//
// Built with -fmad=false: every float operation rounds on its own, as
// PyTorch's separate elementwise operations do, so gradients, magnitudes and
// bins are bit-equal to the twin's. Sums run in a fixed order (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ float load(const T* p, int64_t i);
template <>
__device__ __forceinline__ float load<float>(const float* p, int64_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hog_flat_kernel(const T* __restrict__ patches, float* __restrict__ out,
                const float* __restrict__ w2t, const float* __restrict__ ov,
                int s, int cs, int n_orient,
                int uoctti, int fast, int transposed) {
  extern __shared__ float smem[];
  const int p_count = s * s;
  const int c = (s + cs / 2) / cs;
  const int cc = c * c;
  const int two_o = 2 * n_orient;
  float* img = smem;                      // (S*S) patch, row-major (y, x)
  float* mag = img + p_count;             // (S*S) gradient magnitude
  float* cells = mag + p_count;           // (2O, CC) cell histograms
  float* energy = cells + two_o * cc;     // (CC)
  float* lanes = energy + cc;             // (warps, 2O, 32) partial sums
  int8_t* bin =
      reinterpret_cast<int8_t*>(lanes + kThreads / 32 * two_o * 32);  // S*S

  const int64_t row = blockIdx.x;
  const T* src = patches + row * p_count;
  for (int p = threadIdx.x; p < p_count; p += blockDim.x) {
    // transposed input is (x, y)-major: un-transpose while staging
    int q = transposed ? (p % s) * s + p / s : p;
    img[q] = load<T>(src, p);
  }
  __syncthreads();

  for (int p = threadIdx.x; p < p_count; p += blockDim.x) {
    int y = p / s, x = p % s;
    float g = 0.f;
    int b = -1;
    if (y >= 1 && y <= s - 2 && x >= 1 && x <= s - 2) {
      float gx = img[p + 1] - img[p - 1];
      float gy = img[p + s] - img[p - s];
      g = sqrtf(gx * gx + gy * gy);
      if (fast && n_orient == 4) {
        // nearest multiple of pi/4: two slope compares pick the axis
        float ax = fabsf(gx), ay = fabsf(gy);
        bool px = gx >= 0.f, py = gy >= 0.f;
        if (ay < ax * 0.41421356237f) {
          b = px ? 0 : 4;
        } else if (ay > ax * 2.41421356237f) {
          b = py ? 2 : 6;
        } else {
          b = (px == py) ? (px ? 1 : 5) : (py ? 3 : 7);
        }
      } else {
        // argmax of |score|, first maximum wins; k + O for a negative score
        float best = 0.f;
        for (int k = 0; k < n_orient; ++k) {
          float sc = gx * ov[k] + gy * ov[n_orient + k];
          float a = fabsf(sc);
          if (a > best) {
            best = a;
            b = sc < 0.f ? k + n_orient : k;
          }
        }
      }
      if (fast) g = round_bf16(g);
    }
    mag[p] = g;
    bin[p] = (int8_t)b;
  }
  __syncthreads();

  // one warp per cell: the lanes stride over the cell's tent support, each
  // adding into its own slot of a per-warp (bin, lane) table (no atomics),
  // then a fixed shuffle tree sums the 32 lanes of every bin
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* acc = lanes + warp * two_o * 32;
  for (int cell = warp; cell < cc; cell += blockDim.x / 32) {
    for (int o = 0; o < two_o; ++o) acc[o * 32 + lane] = 0.f;
    __syncwarp();
    int cx = cell / c, cy = cell % c;  // cx-major cells
    int y0, y1, x0, x1;
    support(cy, cs, s, &y0, &y1);
    support(cx, cs, s, &x0, &x1);
    const int nx = x1 - x0 + 1;
    const int count = (y1 - y0 + 1) * nx;
    const float* wcell = w2t + (int64_t)cell * p_count;
    for (int k = lane; k < count; k += 32) {
      int p = (y0 + k / nx) * s + x0 + k % nx;
      int b = bin[p];
      if (b >= 0) {
        float w = __ldg(wcell + p);
        if (fast) w = round_bf16(w);
        acc[b * 32 + lane] += mag[p] * w;
      }
    }
    __syncwarp();
    for (int o = 0; o < two_o; ++o) {
      float v = acc[o * 32 + lane];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) cells[o * cc + cell] = v;
    }
    __syncwarp();
  }
  __syncthreads();

  for (int cell = threadIdx.x; cell < cc; cell += blockDim.x) {
    float e = 0.f;
    for (int k = 0; k < n_orient; ++k) {
      float f = cells[k * cc + cell] + cells[(k + n_orient) * cc + cell];
      e = e + f * f;
    }
    energy[cell] = e;
  }
  __syncthreads();

  const int dims = uoctti ? 3 * n_orient + 4 : 4 * n_orient;
  float* dst = out + row * (int64_t)(dims * cc);
  for (int cell = threadIdx.x; cell < cc; cell += blockDim.x) {
    int cx = cell / c, cy = cell % c;
    // 2x2 block factors 1..4 (UL, UR, LL, LR) over clamped neighbours
    const int blocks[4][4][2] = {{{-1, -1}, {0, -1}, {-1, 0}, {0, 0}},
                                 {{0, -1}, {1, -1}, {0, 0}, {1, 0}},
                                 {{-1, 0}, {0, 0}, {-1, 1}, {0, 1}},
                                 {{0, 0}, {1, 0}, {0, 1}, {1, 1}}};
    float factor[4];
    for (int i = 0; i < 4; ++i) {
      float total = 0.f;
      for (int j = 0; j < 4; ++j) {
        int nx = min(max(cx + blocks[i][j][0], 0), c - 1);
        int ny = min(max(cy + blocks[i][j][1], 0), c - 1);
        float n = energy[nx * c + ny];
        total = j == 0 ? n : total + n;
      }
      factor[i] = 1.f / sqrtf(total + 1e-4f);
    }
    if (uoctti) {
      float t_acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n_orient; ++k) {
        float ha = cells[k * cc + cell];
        float hb = cells[(k + n_orient) * cc + cell];
        float ha_s = 0.f, hb_s = 0.f, hc_s = 0.f;
        for (int i = 0; i < 4; ++i) {
          float hai = factor[i] * ha;
          float hbi = factor[i] * hb;
          float hci = fminf(hai + hbi, 0.2f);
          ha_s = ha_s + fminf(hai, 0.2f);
          hb_s = hb_s + fminf(hbi, 0.2f);
          hc_s = hc_s + hci;
          t_acc[i] = t_acc[i] + hci;
        }
        dst[k * cc + cell] = 0.5f * ha_s;
        dst[(k + n_orient) * cc + cell] = 0.5f * hb_s;
        dst[(k + 2 * n_orient) * cc + cell] = 0.5f * hc_s;
      }
      const float scale_t = 1.f / sqrtf(18.f);  // computed in float32
      for (int i = 0; i < 4; ++i)
        dst[(3 * n_orient + i) * cc + cell] = t_acc[i] * scale_t;
    } else {
      for (int i = 0; i < 4; ++i) {
        for (int k = 0; k < n_orient; ++k) {
          float h = cells[k * cc + cell] + cells[(k + n_orient) * cc + cell];
          dst[(i * n_orient + k) * cc + cell] = fminf(factor[i] * h, 0.2f);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* patches, void* out, const void* w2t,
                   const void* ov, int batch,
                   int s, int cs, int n_orient, int uoctti, int fast,
                   int transposed, cudaStream_t stream) {
  int c = (s + cs / 2) / cs;
  size_t smem = sizeof(float) * (2 * s * s + (2 * n_orient + 1) * c * c +
                                 kThreads / 32 * 2 * n_orient * 32) +
                s * s;
  cudaError_t err = cudaFuncSetAttribute(
      hog_flat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  hog_flat_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(patches), static_cast<float*>(out),
      static_cast<const float*>(w2t), static_cast<const float*>(ov), s, cs,
      n_orient, uoctti, fast,
      transposed);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hog_flat_launch(const void* patches, int bf16_input,
                               void* out, const void* w2t, const void* ov,
                               int batch, int s,
                               int cs, int n_orient, int uoctti, int fast,
                               int transposed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_input)
    return (int)launch<__nv_bfloat16>(patches, out, w2t, ov, batch, s, cs,
                                      n_orient, uoctti, fast, transposed, st);
  return (int)launch<float>(patches, out, w2t, ov, batch, s, cs, n_orient,
                            uoctti, fast, transposed, st);
}
