// Kernels W1, W2 and W3: the pixel stage of lossy WebP (VP8 key frames).
//
// No TPU kernel is replaced: the JAX package reads images with PIL on the
// host (superviseddescent_tpu/ops/patches.py::load_gray_image), and PIL
// reads WebP with libwebp. The host C++ entropy stage (csrc/webp_decode.cu,
// webp_decode_vp8) hands these kernels what io/vp8.py describes: int16
// coefficients (MBs, 25, 16), mode bytes (MBs, 20) and filter bytes (MBs,
// 4). The plain twins are ops/webp.py's reconstruct_reference,
// filter_reference and colour_reference.
//
// W1 (vp8_reconstruct): per macroblock the inverse WHT of Y2 into the Y
// DCs, the inverse DCT of the 24 blocks, and prediction as libwebp's
// src/dsp/dec.c predicts (16x16 DC with its edge variants, TM, V, H; the
// ten 4x4 B_PRED modes in raster order of the sub-blocks; the chroma
// modes), into the unfiltered Y / U / V planes, padded to whole
// macroblocks. W2 (vp8_filter): libwebp's loop filter in place on them
// (normal: macroblock and inner edges of luma and chroma; simple: luma
// only), macroblock by macroblock as DoFilter orders it: the left edge, the
// inner vertical edges, the top edge, the inner horizontal edges.
//
// W1 and W2 are wavefronts: macroblock (r, c) reads (r, c - 1), (r - 1, c)
// and (r - 1, c + 1) (W1: the left samples, the top and top-right ones;
// W2: the left edge filter of (r - 1, c + 1) changes samples that the top
// edge filter of (r, c) reads). One CTA takes macroblock rows r =
// blockIdx.x + k gridDim.x in order, the grid no larger than the card
// holds resident, so every row it waits on is running or done. A row
// publishes the macroblocks it has finished in progress[r] (st.release
// after every thread's writes and a fence) and waits, thread 0 spinning
// with ld.acquire, until progress[r - 1] reaches c + 2 (or the row's end).
// Samples another CTA wrote are read through L2 (ld.global.cg). The
// counters start at 0 for every frame (the host zeroes them).
//
// W3 (vp8_colour): one thread an output sample: libwebp's fancy upsampling
// of 4:2:0 chroma (UpsampleRgbLinePair) and VP8YUVToR/G/B (src/dsp/yuv.h),
// cropped to the frame, writing RGB, or the grey OpenCV's formula gives of
// that RGB ((4899 r + 9617 g + 1868 b + 8192) >> 14).
//
// Every entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // W1 and W2: a thread a luma sample
constexpr int kColourThreads = 256;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// a wait that outlasts this many cycles (some seconds) is a fault: the
// kernel traps rather than hang the card
constexpr long long kWaitCycles = 1ll << 34;

// thread 0 waits until row r - 1 has finished `need` macroblocks
__device__ void wait_row_above(const int* progress, int r, int need) {
  if (threadIdx.x == 0 && r > 0) {
    const long long start = clock64();
    while (ld_acquire(progress + r - 1) < need) {
      __nanosleep(64);
      if (clock64() - start > kWaitCycles) __trap();
    }
  }
  __syncthreads();
}

// every thread's writes, then row r's count
__device__ void publish(int* progress, int r, int done) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(progress + r, done);
}

__device__ __forceinline__ int ld(const uint8_t* p) { return __ldcg(p); }

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : v > 255 ? 255 : v;
}

// ---------------------------------------------------------------- W1 --
__device__ __forceinline__ int mul1(int a) { return ((a * 20091) >> 16) + a; }
__device__ __forceinline__ int mul2(int a) { return (a * 35468) >> 16; }

// libwebp's TransformOne without the add: residuals v >> 3
__device__ void inverse_dct(const int* in, int* res) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    res[4 * i + 0] = (a + d) >> 3;
    res[4 * i + 1] = (b + c) >> 3;
    res[4 * i + 2] = (b - c) >> 3;
    res[4 * i + 3] = (a - d) >> 3;
  }
}

// libwebp's TransformWHT: Y2 -> the 16 Y blocks' DCs
__device__ void inverse_wht(const int* in, int* dc_out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    dc_out[4 * i + 0] = (int16_t)((a0 + a1) >> 3);
    dc_out[4 * i + 1] = (int16_t)((a3 + a2) >> 3);
    dc_out[4 * i + 2] = (int16_t)((a0 - a1) >> 3);
    dc_out[4 * i + 3] = (int16_t)((a3 - a2) >> 3);
  }
}

__device__ __forceinline__ int avg3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}
__device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }

// a 4x4 sub-block's prediction (libwebp's DC4 .. HU4) from its context
// I J K L (left, down), X (top-left), A..H (top and top-right): out[4y + x]
__device__ void predict4(int mode, const int* ctx, int* out) {
  const int I = ctx[0], J = ctx[1], K = ctx[2], L = ctx[3], X = ctx[4];
  const int A = ctx[5], B = ctx[6], C = ctx[7], D = ctx[8];
  const int E = ctx[9], F = ctx[10], G = ctx[11], H = ctx[12];
#define DST(x, y) out[4 * (y) + (x)]
  switch (mode) {
    case 0: {  // DC
      const int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int i = 0; i < 16; ++i) out[i] = dc;
      break;
    }
    case 1: {  // TM
      const int top[4] = {A, B, C, D}, left[4] = {I, J, K, L};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip255(top[x] + left[y] - X);
      break;
    }
    case 2: {  // VE
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                        avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
      break;
    }
    case 3: {  // HE
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                        avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
      break;
    }
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // 9: HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
      break;
  }
#undef DST
}

// a 16x16 luma or 8x8 chroma prediction of one sample (libwebp's DC16 ..
// TM16 and the chroma twins; DC's variants at the frame's top and left)
__device__ int predict_large(int size, int mode, const int* top,
                             const int* left, int corner, int r, int c,
                             int y, int x) {
  switch (mode) {
    case 1:
      return clip255(top[x] + left[y] - corner);
    case 2:
      return top[x];
    case 3:
      return left[y];
    default: {
      const int shift = size == 16 ? 5 : 4;
      int st = 0, sl = 0;
      for (int i = 0; i < size; ++i) {
        st += top[i];
        sl += left[i];
      }
      if (r == 0 && c == 0) return 128;
      if (r == 0) return (sl + size / 2) >> (shift - 1);
      if (c == 0) return (st + size / 2) >> (shift - 1);
      return (st + sl + size) >> shift;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    vp8_reconstruct(const int16_t* __restrict__ coeffs,
                    const uint8_t* __restrict__ modes, uint8_t* y_plane,
                    uint8_t* u_plane, uint8_t* v_plane, int* progress,
                    int mb_w, int mb_h) {
  __shared__ int s_coef[25 * 16];
  __shared__ int s_res[24 * 16];
  __shared__ int s_mode[20];
  // luma work area: row 0 the corner, the samples above and top-right;
  // column 0 the left samples; rows 4, 8, 12 carry the top-right again
  __shared__ int s_wb[17][21];
  __shared__ int s_ctop[2][9], s_cleft[2][8];
  const int t = threadIdx.x;
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  for (int r = blockIdx.x; r < mb_h; r += gridDim.x) {
    for (int c = 0; c < mb_w; ++c) {
      wait_row_above(progress, r, c + 2 < mb_w ? c + 2 : mb_w);
      const long mb = (long)r * mb_w + c;
      for (int i = t; i < 400; i += kThreads) s_coef[i] = coeffs[mb * 400 + i];
      if (t < 20) s_mode[t] = modes[mb * 20 + t];
      // the context: 127 above the frame (its corner too), 129 left of it
      if (t < 21) {
        int v;
        if (r == 0) {
          v = 127;
        } else if (t == 0) {
          v = c == 0 ? 129 : ld(y_plane + (long)(16 * r - 1) * W + 16 * c - 1);
        } else if (t > 16 && c == mb_w - 1) {
          v = ld(y_plane + (long)(16 * r - 1) * W + 16 * c + 15);
        } else {
          v = ld(y_plane + (long)(16 * r - 1) * W + 16 * c + t - 1);
        }
        s_wb[0][t] = v;
      } else if (t < 37) {
        const int k = t - 21;
        s_wb[1 + k][0] =
            c == 0 ? 129 : ld(y_plane + (long)(16 * r + k) * W + 16 * c - 1);
      } else if (t < 55) {
        const int p = (t - 37) / 9, k = (t - 37) % 9;
        const uint8_t* plane = p ? v_plane : u_plane;
        int v;
        if (r == 0) {
          v = 127;
        } else if (k == 0 && c == 0) {
          v = 129;
        } else {
          v = ld(plane + (long)(8 * r - 1) * Wc + 8 * c + k - 1);
        }
        s_ctop[p][k] = v;
      } else if (t < 71) {
        const int p = (t - 55) / 8, k = (t - 55) % 8;
        const uint8_t* plane = p ? v_plane : u_plane;
        s_cleft[p][k] = c == 0 ? 129 : ld(plane + (long)(8 * r + k) * Wc +
                                          8 * c - 1);
      }
      __syncthreads();
      const int is4 = s_mode[0];
      if (t == 0 && !is4) {
        int dc[16];
        inverse_wht(s_coef, dc);
        for (int b = 0; b < 16; ++b) s_coef[16 * (1 + b)] = dc[b];
      }
      __syncthreads();
      if (t < 24) inverse_dct(s_coef + 16 * (1 + t), s_res + 16 * t);
      if (t >= 32 && t < 44 && is4) {  // top-right on rows 4, 8, 12
        const int k = t - 32;
        s_wb[4 + 4 * (k / 4)][17 + k % 4] = s_wb[0][17 + k % 4];
      }
      __syncthreads();
      if (!is4) {
        const int y = t >> 4, x = t & 15;
        int top[16], left[16];
        for (int i = 0; i < 16; ++i) {
          top[i] = s_wb[0][1 + i];
          left[i] = s_wb[1 + i][0];
        }
        const int pred = predict_large(16, s_mode[1], top, left, s_wb[0][0],
                                       r, c, y, x);
        const int b = 4 * (y >> 2) + (x >> 2);
        y_plane[(long)(16 * r + y) * W + 16 * c + x] =
            (uint8_t)clip255(pred + s_res[16 * b + 4 * (y & 3) + (x & 3)]);
      } else {
        for (int n = 0; n < 16; ++n) {
          const int by = 4 * (n >> 2), bx = 4 * (n & 3);
          if (t < 16) {
            int ctx[13], pred[16];
            for (int k = 0; k < 4; ++k) ctx[k] = s_wb[by + 1 + k][bx];
            for (int k = 0; k < 9; ++k) ctx[4 + k] = s_wb[by][bx + k];
            predict4(s_mode[2 + n], ctx, pred);
            const int y = t >> 2, x = t & 3;
            s_wb[by + 1 + y][bx + 1 + x] =
                clip255(pred[t] + s_res[16 * n + t]);
          }
          __syncthreads();
        }
        const int y = t >> 4, x = t & 15;
        y_plane[(long)(16 * r + y) * W + 16 * c + x] =
            (uint8_t)s_wb[1 + y][1 + x];
      }
      if (t < 128) {
        const int p = t >> 6, y = (t >> 3) & 7, x = t & 7;
        const int pred = predict_large(8, s_mode[18], s_ctop[p] + 1,
                                       s_cleft[p], s_ctop[p][0], r, c, y, x);
        const int b = 16 + 4 * p + 2 * (y >> 2) + (x >> 2);
        uint8_t* plane = p ? v_plane : u_plane;
        plane[(long)(8 * r + y) * Wc + 8 * c + x] =
            (uint8_t)clip255(pred + s_res[16 * b + 4 * (y & 3) + (x & 3)]);
      }
      publish(progress, r, c + 1);
    }
  }
}

// ---------------------------------------------------------------- W2 --
__device__ __forceinline__ int sclip1(int v) {
  return v < -128 ? -128 : v > 127 ? 127 : v;
}
__device__ __forceinline__ int sclip2(int v) {
  return v < -16 ? -16 : v > 15 ? 15 : v;
}
__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// one line across an edge at p (the first sample past it), samples `step`
// apart: kind 6 a macroblock edge (FilterLoop26), 4 an inner edge
// (FilterLoop24), 2 the simple filter; thresh the edge limit
__device__ void filter_line(uint8_t* p, long step, int kind, int thresh,
                            int ilevel, int hev_thresh) {
  const int p1 = ld(p - 2 * step), p0 = ld(p - step);
  const int q0 = ld(p), q1 = ld(p + step);
  const int thresh2 = 2 * thresh + 1;
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > thresh2) return;
  bool hev = true;
  int p3 = 0, p2 = 0, q2 = 0, q3 = 0;
  if (kind != 2) {
    p3 = ld(p - 4 * step);
    p2 = ld(p - 3 * step);
    q2 = ld(p + 2 * step);
    q3 = ld(p + 3 * step);
    if (iabs(p3 - p2) > ilevel || iabs(p2 - p1) > ilevel ||
        iabs(p1 - p0) > ilevel || iabs(q3 - q2) > ilevel ||
        iabs(q2 - q1) > ilevel || iabs(q1 - q0) > ilevel)
      return;
    hev = iabs(p1 - p0) > hev_thresh || iabs(q1 - q0) > hev_thresh;
  }
  if (hev) {  // DoFilter2
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = (uint8_t)clip255(p0 + a2);
    p[0] = (uint8_t)clip255(q0 - a1);
  } else if (kind == 4) {  // DoFilter4
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = (uint8_t)clip255(p1 + a3);
    p[-step] = (uint8_t)clip255(p0 + a2);
    p[0] = (uint8_t)clip255(q0 - a1);
    p[step] = (uint8_t)clip255(q1 - a3);
  } else {  // DoFilter6
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = (uint8_t)clip255(p2 + a3);
    p[-2 * step] = (uint8_t)clip255(p1 + a2);
    p[-step] = (uint8_t)clip255(p0 + a1);
    p[0] = (uint8_t)clip255(q0 - a1);
    p[step] = (uint8_t)clip255(q1 - a2);
    p[2 * step] = (uint8_t)clip255(q2 - a3);
  }
}

// the lines of one edge: threads 0-15 luma, 16-23 U, 24-31 V (normal
// filter); `vertical` an edge between columns, at `at` samples into the
// macroblock
__device__ void filter_edge(uint8_t* y_plane, uint8_t* u_plane,
                            uint8_t* v_plane, int W, int Wc, int r, int c,
                            bool vertical, int at, bool chroma, int kind,
                            int thresh, int ilevel, int hev) {
  const int t = threadIdx.x;
  if (t < 16) {
    uint8_t* p = vertical ? y_plane + (long)(16 * r + t) * W + 16 * c + at
                          : y_plane + (long)(16 * r + at) * W + 16 * c + t;
    filter_line(p, vertical ? 1 : W, kind, thresh, ilevel, hev);
  } else if (chroma && t < 32) {
    const int k = t & 7;
    uint8_t* plane = t < 24 ? u_plane : v_plane;
    uint8_t* p = vertical ? plane + (long)(8 * r + k) * Wc + 8 * c + at
                          : plane + (long)(8 * r + at) * Wc + 8 * c + k;
    filter_line(p, vertical ? 1 : Wc, kind, thresh, ilevel, hev);
  }
  __threadfence();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    vp8_filter(uint8_t* y_plane, uint8_t* u_plane, uint8_t* v_plane,
               const uint8_t* __restrict__ filters, int* progress, int mb_w,
               int mb_h, int filter_type) {
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  const bool normal = filter_type == 2;
  const int mb_kind = normal ? 6 : 2, in_kind = normal ? 4 : 2;
  for (int r = blockIdx.x; r < mb_h; r += gridDim.x) {
    for (int c = 0; c < mb_w; ++c) {
      wait_row_above(progress, r, c + 2 < mb_w ? c + 2 : mb_w);
      const uint8_t* f = filters + ((long)r * mb_w + c) * 4;
      const int limit = f[0], ilevel = f[1], hev = f[2], inner = f[3];
      if (limit > 0) {
        if (c > 0)
          filter_edge(y_plane, u_plane, v_plane, W, Wc, r, c, true, 0,
                      normal, mb_kind, limit + 4, ilevel, hev);
        if (inner)
          for (int e = 4; e < 16; e += 4)
            filter_edge(y_plane, u_plane, v_plane, W, Wc, r, c, true, e,
                        normal && e == 4, in_kind, limit, ilevel, hev);
        if (r > 0)
          filter_edge(y_plane, u_plane, v_plane, W, Wc, r, c, false, 0,
                      normal, mb_kind, limit + 4, ilevel, hev);
        if (inner)
          for (int e = 4; e < 16; e += 4)
            filter_edge(y_plane, u_plane, v_plane, W, Wc, r, c, false, e,
                        normal && e == 4, in_kind, limit, ilevel, hev);
      }
      publish(progress, r, c + 1);
    }
  }
}

// ---------------------------------------------------------------- W3 --
__device__ __forceinline__ int clip8(int v) {
  return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}

__global__ void __launch_bounds__(kColourThreads)
    vp8_colour(const uint8_t* __restrict__ y_plane,
               const uint8_t* __restrict__ u_plane,
               const uint8_t* __restrict__ v_plane, uint8_t* out, int width,
               int height, int W, int Wc, int channels) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)width * height) return;
  const int y = (int)(i / width), x = (int)(i % width);
  const int uw = (width + 1) / 2, uh = (height + 1) / 2;
  const int nr = y >> 1, nc = x >> 1;
  int fr = (y & 1) ? nr + 1 : nr - 1, fc = (x & 1) ? nc + 1 : nc - 1;
  fr = fr < 0 ? 0 : fr > uh - 1 ? uh - 1 : fr;
  fc = fc < 0 ? 0 : fc > uw - 1 ? uw - 1 : fc;
  const bool edge = x == 0 || (x == width - 1 && !(width & 1));
  int uv[2];
  for (int p = 0; p < 2; ++p) {
    const uint8_t* C = p ? v_plane : u_plane;
    const int nn = C[(long)nr * Wc + nc], fn = C[(long)fr * Wc + nc];
    if (edge) {
      uv[p] = (3 * nn + fn + 2) >> 2;
    } else {
      const int nf = C[(long)nr * Wc + fc], ff = C[(long)fr * Wc + fc];
      uv[p] = (((nn + 3 * nf + 3 * fn + ff + 8) >> 3) + nn) >> 1;
    }
  }
  const int yy = (y_plane[(long)y * W + x] * 19077) >> 8;
  const int u = uv[0], v = uv[1];
  const int R = clip8(yy + ((v * 26149) >> 8) - 14234);
  const int G = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708);
  const int B = clip8(yy + ((u * 33050) >> 8) - 17685);
  if (channels == 1) {
    out[i] = (uint8_t)((R * 4899 + G * 9617 + B * 1868 + 8192) >> 14);
  } else {
    out[3 * i + 0] = (uint8_t)R;
    out[3 * i + 1] = (uint8_t)G;
    out[3 * i + 2] = (uint8_t)B;
  }
}

// the persistent rows' grid: no more CTAs than the card holds at once,
// nor than `limit` where it is positive (to run several rows a CTA)
template <typename Kernel>
int rows_grid(Kernel kernel, int mb_h, int limit) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (limit > 0 && limit < grid) grid = limit;
  return mb_h < grid ? mb_h : grid;
}

}  // namespace

// W1: coeffs (MBs, 25, 16) int16 and modes (MBs, 20) uint8 on the card ->
// the unfiltered planes (16 mb_h x 16 mb_w luma, 8 mb_h x 8 mb_w chroma);
// progress: mb_h int32 zeros; grid_limit: 0, or at most that many CTAs.
extern "C" int vp8_reconstruct_launch(const int16_t* coeffs,
                                      const uint8_t* modes, uint8_t* y,
                                      uint8_t* u, uint8_t* v, int* progress,
                                      int mb_w, int mb_h, int grid_limit,
                                      cudaStream_t stream) {
  const int grid = rows_grid(vp8_reconstruct, mb_h, grid_limit);
  vp8_reconstruct<<<grid, kThreads, 0, stream>>>(coeffs, modes, y, u, v,
                                                  progress, mb_w, mb_h);
  return (int)cudaGetLastError();
}

// W2: the loop filter in place; filters (MBs, 4) uint8; filter_type 1
// simple, 2 normal; progress: mb_h int32 zeros; grid_limit as W1's.
extern "C" int vp8_filter_launch(uint8_t* y, uint8_t* u, uint8_t* v,
                                 const uint8_t* filters, int* progress,
                                 int mb_w, int mb_h, int filter_type,
                                 int grid_limit, cudaStream_t stream) {
  const int grid = rows_grid(vp8_filter, mb_h, grid_limit);
  vp8_filter<<<grid, kThreads, 0, stream>>>(y, u, v, filters, progress, mb_w,
                                             mb_h, filter_type);
  return (int)cudaGetLastError();
}

// W3: the filtered planes -> out, height x width x 3 RGB or height x
// width grey (channels 1).
extern "C" int vp8_colour_launch(const uint8_t* y, const uint8_t* u,
                                 const uint8_t* v, uint8_t* out, int width,
                                 int height, int mb_w, int channels,
                                 cudaStream_t stream) {
  const long n = (long)width * height;
  const int grid = (int)((n + kColourThreads - 1) / kColourThreads);
  vp8_colour<<<grid, kColourThreads, 0, stream>>>(y, u, v, out, width, height,
                                                   16 * mb_w, 8 * mb_w,
                                                   channels);
  return (int)cudaGetLastError();
}
