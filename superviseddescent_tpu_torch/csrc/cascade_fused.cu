// K3 / K4: the whole RCR cascade of one face in one thread block.
//
// Replaces superviseddescent_tpu/ops/cascade_pallas.py::
// detect_cascade_fused_frames (K3, _cascade_frames_kernel) and
// detect_cascade_fused (K4, _cascade_kernel). See ops/cascade_fused.py for
// the contract, the numerics, the plain PyTorch twin, and what bounds the
// kernels on the H100.
//
// One block per face loops over the levels; per landmark it samples the
// S x S patch (K2's fast, transposed two-tap sampling), computes gradient
// magnitudes and sector bins, the x partials of the separable cell splat,
// the cell histograms and the Uoctti channels (cascade_body.cuh, shared
// with the feature extractors K5 / K6), and writes them into the face's
// bf16 feature row in shared memory. Then each warp takes output rows of the
// level's regressor (a GEMV over bf16 weights, f32 sums, a fixed shuffle
// tree) and the landmark row is updated in shared memory. The window source
// is a template: K3 reads uint8 pixels straight from the frame stack at
// per-face (frame, row, column) origins, K4 reads bf16 windows.

#include "cascade_body.cuh"

namespace {

using namespace fused;

// Byte offsets of the block's shared buffers, each 16-byte aligned; the
// wrapper's _shared_bytes lays them out the same way.
struct Layout {
  int feat, xs, upd, scal, body, total;
  __host__ __device__ Layout(int l, int c, int fp, int s) {
    int at = 0;
    feat = take(&at, fp * 2);
    xs = take(&at, 2 * l * 4);
    upd = take(&at, 2 * l * 4);
    scal = take(&at, 4 * 4);
    body = at;
    const BodyLayout body_layout(&at, c, s);
    (void)body_layout;
    total = at;
  }
};

template <typename Source>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(Source src, const float* __restrict__ x0,
               float* __restrict__ out,
               const __nv_bfloat16* __restrict__ weights,
               const int* __restrict__ level_i,
               const float* __restrict__ level_rel,
               const float* __restrict__ tents, const int* __restrict__ eyes,
               int n_levels, int l, int c, int ry, int rx, int fp,
               int quantize, int s_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(l, c, fp, s_max);
  int body_at = lay.body;
  const BodyBuffers k(smem, BodyLayout(&body_at, c, s_max));
  __nv_bfloat16* feat = reinterpret_cast<__nv_bfloat16*>(smem + lay.feat);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* upd = reinterpret_cast<float*>(smem + lay.upd);
  float* scal = reinterpret_cast<float*>(smem + lay.scal);

  const int64_t face = blockIdx.x;
  const int l2 = 2 * l;
  const int cc = c * c;
  const int nfeat = l * kDims * cc + 1;
  int64_t stride;
  const typename Source::pixel_t* win = src.window(face, ry, rx, &stride);
  if (win == nullptr) {
    for (int j = threadIdx.x; j < l2; j += blockDim.x)
      out[face * l2 + j] = __int_as_float(0x7fc00000);
    return;
  }
  for (int j = threadIdx.x; j < l2; j += blockDim.x)
    xs[j] = x0[face * l2 + j];
  // bias 1 and zero padding; every other entry is rewritten per level
  for (int j = nfeat - 1 + threadIdx.x; j < fp; j += blockDim.x)
    feat[j] = __float2bfloat16_rn(j == nfeat - 1 ? 1.f : 0.f);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;

  LevelGeometry g;
  g.ry = ry;
  g.rx = rx;
  g.c = c;
  g.quantize = quantize;
  for (int li = 0; li < n_levels; ++li) {
    g.s = level_i[li * kLevelInts + 0];
    g.w = level_i[li * kLevelInts + 1];
    g.wx = level_i[li * kLevelInts + 2];
    g.cs = level_i[li * kLevelInts + 3];
    const float* level_tent = tents + level_i[li * kLevelInts + 4];
    for (int j = threadIdx.x; j < g.s * c; j += blockDim.x)
      k.tent[j] = level_tent[j];
    __syncthreads();  // xs of the previous level's update
    if (threadIdx.x == 0)
      // the IED of the row before this level's update
      level_ied_patch_half(xs, l, eyes, level_rel[li], g.w, g.wx, rx,
                           &scal[0], &scal[1]);
    __syncthreads();
    const float ied = scal[0];
    g.set_patch_half(scal[1]);

    for (int lm = 0; lm < l; ++lm)
      landmark_channels(win, stride, xs[lm], xs[lm + l], g, k,
                        feat + lm * kDims * cc);
    __syncthreads();

    // ---- regressor: one warp per output, 8 bf16 pairs per 16-byte load ----
    const __nv_bfloat16* wl = weights + (int64_t)li * l2 * fp;
    const uint4* frow = reinterpret_cast<const uint4*>(feat);
    for (int j = warp; j < l2; j += nwarps) {
      const uint4* wrow = reinterpret_cast<const uint4*>(wl + (int64_t)j * fp);
      float acc = 0.f;
      for (int q = lane; q < fp / 8; q += 32) {
        const uint4 wv = __ldg(wrow + q);
        const uint4 fv = frow[q];
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&wv);
        const __nv_bfloat162* f2 = reinterpret_cast<const __nv_bfloat162*>(&fv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(f2[e]);
          const float2 b = __bfloat1622float2(w2[e]);
          acc = acc + a.x * b.x;
          acc = acc + a.y * b.y;
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) upd[j] = acc;
    }
    __syncthreads();
    // norm is 1/IED: dividing the update by it multiplies by the IED
    for (int j = threadIdx.x; j < l2; j += blockDim.x)
      xs[j] = xs[j] - upd[j] * ied;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < l2; j += blockDim.x)
    out[face * l2 + j] = xs[j];
}

template <typename Source>
cudaError_t launch(const Source& src, const void* x0, void* out,
                   const void* weights, const void* level_i,
                   const void* level_rel, const void* tents,
                   const void* eyes, int n, int n_levels, int l, int c,
                   int ry, int rx, int fp, int quantize, int s_max,
                   cudaStream_t stream) {
  const Layout lay(l, c, fp, s_max);
  cudaError_t err = cudaFuncSetAttribute(
      cascade_kernel<Source>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.total);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  cascade_kernel<Source><<<n, kThreads, lay.total, stream>>>(
      src, static_cast<const float*>(x0), static_cast<float*>(out),
      static_cast<const __nv_bfloat16*>(weights),
      static_cast<const int*>(level_i), static_cast<const float*>(level_rel),
      static_cast<const float*>(tents), static_cast<const int*>(eyes),
      n_levels, l, c, ry, rx, fp, quantize, s_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cascade_fused_frames_launch(
    const void* frames, const void* idx, const void* oy, const void* ox,
    int n_img, int h, int w, const void* x0, void* out, const void* weights,
    const void* level_i, const void* level_rel, const void* tents,
    const void* eyes, int n, int n_levels, int l, int c, int ry, int rx,
    int fp, int quantize, int s_max, void* stream) {
  FramesSource src{static_cast<const uint8_t*>(frames),
                   static_cast<const int*>(idx), static_cast<const int*>(oy),
                   static_cast<const int*>(ox), n_img, h, w};
  return (int)launch(src, x0, out, weights, level_i, level_rel, tents, eyes,
                     n, n_levels, l, c, ry, rx, fp, quantize, s_max,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int cascade_fused_launch(
    const void* windows, const void* x0, void* out, const void* weights,
    const void* level_i, const void* level_rel, const void* tents,
    const void* eyes, int n, int n_levels, int l, int c, int ry, int rx,
    int fp, int quantize, int s_max, void* stream) {
  WindowsSource src{static_cast<const __nv_bfloat16*>(windows)};
  return (int)launch(src, x0, out, weights, level_i, level_rel, tents, eyes,
                     n, n_levels, l, c, ry, rx, fp, quantize, s_max,
                     static_cast<cudaStream_t>(stream));
}
