// Kernels D1 and M1: the pixel stage of JPEG 2000 reading (ops/j2k.py).
//
// D1 (j2k_idwt_launch) synthesises one level of the inverse wavelet
// transform, its rows (vertical = 0) or its columns (vertical = 1), of
// every tile-component that has the level, in one launch: a CTA a line.
// The table holds a row of 11 ints a tile-component (ops/j2k.idwt_jobs:
// plane offset, stride, the level's width and height, the low band's
// width and height, the parities of the level's origin, 5/3 or 9/7, an
// unused word, the first line's number); the CTA finds its row by binary
// search over the first lines, stages the line in shared memory
// interleaved (low samples at the origin's parity), runs the lifting
// steps with a barrier between them and writes the line back. 5/3 is
// OpenJPEG's integer lifting (opj_idwt53_h / _v), 9/7 its float32 lifting
// in opj_v8dwt_decode's order and constants (low samples times K, high
// ones times its 2 / K of 1.625732422, then delta, gamma, beta and alpha,
// each (left + right) * c added; -fmad=false keeps every rounding apart).
// A line of one sample is left as it is, but halved toward zero for 5/3
// at an odd origin, as OpenJPEG does.
//
// M1 (j2k_colour_launch) turns the synthesised planes into PIL's pixels, a
// thread an output pixel: the tile the pixel lies in, the sample Pillow's
// unpacker reads for each channel (its rows of w / dx samples, the tile's
// data as OpenJPEG lays it out, zero past its end), the inverse RCT or ICT
// where the tile has one, the DC level shift and the clamp to the
// precision (a 9/7 sample rounded half to even, as lrintf), the sample's
// bytes as OpenJPEG hands them to PIL, Pillow's shift to 8 (or 16) bits,
// then grey, P / PA through the palette, I;16 clipped, sRGB, sYCC
// through PIL's YCbCr tables or CMYK through PIL's cmyk2rgb, and for one
// channel L as it is or OpenCV's grey. Its table: 16 ints of parameters
// (ops/j2k.j2k_colour), the components (4 ints each), the palette (256 x
// 3), PIL's four YCbCr tables (4 x 256), the tiles and the
// tile-components.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IDWT_THREADS = 256;
constexpr int COLOUR_THREADS = 256;
constexpr int JOB_COLS = 11;

__device__ __forceinline__ int mirror_left(int p) { return p > 0 ? p - 1 : p + 1; }
__device__ __forceinline__ int mirror_right(int p, int n) {
  return p < n - 1 ? p + 1 : p - 1;
}

__global__ void j2k_idwt_kernel(int32_t* __restrict__ coeffs,
                                const int32_t* __restrict__ jobs, int njobs,
                                int vertical) {
  extern __shared__ int32_t line[];
  float* fline = reinterpret_cast<float*>(line);
  const int block = blockIdx.x;
  int lo = 0, hi = njobs - 1;
  while (lo < hi) {                      // the last job whose first line <= block
    int mid = (lo + hi + 1) >> 1;
    if (jobs[mid * JOB_COLS + 10] <= block) lo = mid;
    else hi = mid - 1;
  }
  const int32_t* job = jobs + lo * JOB_COLS;
  const int li = block - job[10];
  const int64_t off = job[0], stride = job[1];
  const int n = vertical ? job[3] : job[2];
  const int sn = vertical ? job[5] : job[4];
  const int cas = vertical ? job[7] : job[6];
  const bool rev = job[8] != 0;
  const int64_t base = vertical ? off + li : off + (int64_t)li * stride;
  const int64_t step = vertical ? stride : 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int pos = i < sn ? 2 * i + cas : 2 * (i - sn) + 1 - cas;
    line[pos] = coeffs[base + i * step];
  }
  __syncthreads();
  if (n == 1) {
    if (threadIdx.x == 0 && rev && cas) coeffs[base] = line[0] / 2;
    return;
  }
  if (rev) {
    for (int p = cas + 2 * threadIdx.x; p < n; p += 2 * blockDim.x)
      line[p] -= (line[mirror_left(p)] + line[mirror_right(p, n)] + 2) >> 2;
    __syncthreads();
    for (int p = 1 - cas + 2 * threadIdx.x; p < n; p += 2 * blockDim.x)
      line[p] += (line[mirror_left(p)] + line[mirror_right(p, n)]) >> 1;
    __syncthreads();
  } else {
    for (int p = threadIdx.x; p < n; p += blockDim.x)
      fline[p] = fline[p] * (((p ^ cas) & 1) ? 1.625732422f : 1.230174105f);
    __syncthreads();
    const float steps[4] = {-0.443506852f, -0.882911075f, 0.052980118f,
                            1.586134342f};
    for (int s = 0; s < 4; ++s) {
      const int parity = (s & 1) ? 1 - cas : cas;   // low, high, low, high
      for (int p = parity + 2 * threadIdx.x; p < n; p += 2 * blockDim.x) {
        float t = fline[mirror_left(p)] + fline[mirror_right(p, n)];
        t = t * steps[s];
        fline[p] = fline[p] + t;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    coeffs[base + i * step] = line[i];
}

struct Params {
  int W, H, x0, y0, tx0, ty0, tdx, tdy, ncomp, kind, mode_l, paletted,
      channels, tc_cols, tile_cols, unused;
};

// component m's sample at flat index i of its tile-component, after the
// component transform, the DC level shift and the clamp, as the word the
// tile's data holds
__device__ uint32_t sample(const int32_t* __restrict__ coeffs,
                           const int32_t* __restrict__ tcs,
                           const int32_t* __restrict__ comps, int tc_cols,
                           int first, int m, int64_t i, int mct, int ncomp) {
  const int32_t* row = tcs + (int64_t)(first + m) * tc_cols;
  const bool rev = row[6] != 0;
  auto at = [&](int k) {
    const int32_t* r = tcs + (int64_t)(first + k) * tc_cols;
    int64_t size = (int64_t)r[1] * r[2];
    return coeffs[r[0] + (i < size ? i : size - 1)];
  };
  int32_t vi = at(m);
  float vf = __int_as_float(vi);
  if (mct && ncomp >= 3 && m < 3) {
    int32_t a = at(0), b = at(1), c = at(2);
    if (rev) {
      int32_t g = a - ((b + c) >> 2);
      vi = m == 0 ? c + g : m == 1 ? g : b + g;
    } else {
      float y = __int_as_float(a), u = __int_as_float(b), v = __int_as_float(c);
      if (m == 0) {
        vf = y + v * 1.402f;
      } else if (m == 1) {
        float t = y - u * 0.34413f;
        vf = t - v * 0.71414f;
      } else {
        vf = y + u * 1.772f;
      }
    }
  }
  const int prec = comps[4 * m], sgnd = comps[4 * m + 1];
  const int64_t lo = sgnd ? -(1ll << (prec - 1)) : 0;
  const int64_t hi = sgnd ? (1ll << (prec - 1)) - 1 : (1ll << prec) - 1;
  const int64_t shift = sgnd ? 0 : 1ll << (prec - 1);
  int64_t v;
  if (rev) {
    v = (int64_t)vi + shift;
  } else if (vf > 2147483647.0f) {
    v = hi;
  } else if (vf < -2147483648.0f) {
    v = lo;
  } else {
    v = (int64_t)__float2int_rn(vf) + shift;
  }
  v = v < lo ? lo : v > hi ? hi : v;
  const int size = (prec + 7) >> 3;
  return (uint32_t)(v & ((1ll << (8 * size)) - 1));
}

__global__ void j2k_colour_kernel(const int32_t* __restrict__ coeffs,
                                  const int32_t* __restrict__ table,
                                  int ntiles, uint8_t* __restrict__ out) {
  const Params P = *reinterpret_cast<const Params*>(table);
  const int64_t pixel = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= (int64_t)P.W * P.H) return;
  const int32_t* comps = table + 16;
  const int32_t* palette = comps + 4 * P.ncomp;
  const int32_t* ycc = palette + 256 * 3;
  const int32_t* tiles = ycc + 4 * 256;
  const int32_t* tcs = tiles + (int64_t)ntiles * P.tile_cols;
  const int X = (int)(pixel % P.W), Y = (int)(pixel / P.W);
  const int64_t gx = (int64_t)X + P.x0, gy = (int64_t)Y + P.y0;
  const int64_t across = ((int64_t)P.x0 + P.W - P.tx0 + P.tdx - 1) / P.tdx;
  const int64_t t = ((gy - P.ty0) / P.tdy) * across + (gx - P.tx0) / P.tdx;
  const int32_t* tile = tiles + t * P.tile_cols;
  const int64_t x = gx - tile[0], y = gy - tile[1];
  const int64_t w = tile[2] - tile[0], h = tile[3] - tile[1];
  const int mct = tile[4], first = tile[5];
  const int wanted = P.kind <= 1 ? 1 : P.kind == 4 ? 4 : 3;
  const int bits = P.kind == 1 ? 16 : 8;
  int64_t total = 0;
  for (int m = 0; m < P.ncomp; ++m) {
    const int32_t* r = tcs + (int64_t)(first + m) * P.tc_cols;
    total += (int64_t)r[1] * r[2];
  }
  uint32_t chan[4] = {0, 0, 0, 0};
  int64_t start = 0;
  for (int c = 0; c < wanted; ++c) {
    const int dx = comps[4 * c + 2], dy = comps[4 * c + 3];
    const int64_t k = start + (y / dy) * (w / dx) + x / dx;
    uint32_t word = 0;
    if (k < total) {
      int64_t cum = 0;
      int m = 0;
      for (; m < P.ncomp; ++m) {
        const int32_t* r = tcs + (int64_t)(first + m) * P.tc_cols;
        int64_t size = (int64_t)r[1] * r[2];
        if (k < cum + size) break;
        cum += size;
      }
      word = sample(coeffs, tcs, comps, P.tc_cols, first, m, k - cum, mct,
                    P.ncomp);
    }
    const int prec = comps[4 * c], sgnd = comps[4 * c + 1];
    const int sh = bits - prec;
    uint32_t off = sgnd ? 1u << (prec - 1) : 0u;
    uint32_t v;
    if (sh < 0) {
      off += 1u << (-sh - 1);
      v = (off + word) >> (-sh);
    } else {
      v = (off + word) << sh;
    }
    chan[c] = v & ((1u << bits) - 1);
    start += (h / dy) * (w / dx);
  }
  int r, g, b;
  if (P.kind == 0) {
    if (P.paletted) {
      r = palette[3 * chan[0]];
      g = palette[3 * chan[0] + 1];
      b = palette[3 * chan[0] + 2];
    } else {
      r = g = b = (int)chan[0];
    }
  } else if (P.kind == 1) {
    r = g = b = chan[0] > 255 ? 255 : (int)chan[0];
  } else if (P.kind == 2) {
    r = chan[0]; g = chan[1]; b = chan[2];
  } else if (P.kind == 3) {
    const int yy = chan[0], cb = chan[1], cr = chan[2];
    r = yy + (ycc[cr] >> 6);
    g = yy + ((ycc[256 + cb] + ycc[512 + cr]) >> 6);
    b = yy + (ycc[768 + cb] >> 6);
    r = r < 0 ? 0 : r > 255 ? 255 : r;
    g = g < 0 ? 0 : g > 255 ? 255 : g;
    b = b < 0 ? 0 : b > 255 ? 255 : b;
  } else {
    const int nk = 255 - (int)chan[3];
    int tt = (int)chan[0] * nk + 128;
    r = nk - (((tt >> 8) + tt) >> 8);
    tt = (int)chan[1] * nk + 128;
    g = nk - (((tt >> 8) + tt) >> 8);
    tt = (int)chan[2] * nk + 128;
    b = nk - (((tt >> 8) + tt) >> 8);
  }
  if (P.channels == 3) {
    out[3 * pixel] = (uint8_t)r;
    out[3 * pixel + 1] = (uint8_t)g;
    out[3 * pixel + 2] = (uint8_t)b;
  } else if (P.mode_l) {
    out[pixel] = (uint8_t)chan[0];
  } else {
    out[pixel] = (uint8_t)((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14);
  }
}

}  // namespace

extern "C" int j2k_idwt_launch(void* coeffs, const void* jobs, int njobs,
                               int nlines, int vertical, int longest,
                               void* stream) {
  if (nlines <= 0) return 0;
  size_t shared = (size_t)longest * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      j2k_idwt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (err != cudaSuccess) return (int)err;
  j2k_idwt_kernel<<<nlines, IDWT_THREADS, shared, (cudaStream_t)stream>>>(
      (int32_t*)coeffs, (const int32_t*)jobs, njobs, vertical);
  return (int)cudaGetLastError();
}

extern "C" int j2k_colour_launch(const void* coeffs, const void* table,
                                 int ntiles, int pixels, void* out,
                                 void* stream) {
  if (pixels <= 0) return 0;
  int64_t grid = (pixels + COLOUR_THREADS - 1) / COLOUR_THREADS;
  j2k_colour_kernel<<<(unsigned)grid, COLOUR_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)coeffs, (const int32_t*)table, ntiles, (uint8_t*)out);
  return (int)cudaGetLastError();
}
