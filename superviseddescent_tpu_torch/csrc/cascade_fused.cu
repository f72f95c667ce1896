// K3 / K4: the whole RCR cascade, F faces and F x GL landmark bodies in
// flight per thread block.
//
// Replaces superviseddescent_tpu/ops/cascade_pallas.py::
// detect_cascade_fused_frames (K3, _cascade_frames_kernel) and
// detect_cascade_fused (K4, _cascade_kernel). See ops/cascade_fused.py for
// the contract, the numerics, the plain PyTorch twin, the launch plan (F, GL
// and the block size per family and batch) and what bounds the kernels on
// the H100.
//
// A block holds F faces and loops over the levels. Within a level the
// landmarks are independent (the rows change only after the GEMV), so the
// block takes them in groups of GL and runs the bodies of the F x GL
// (face, landmark) pairs of a group together, each phase over all of them:
// taps -> sampling -> gradients -> x contraction -> y contraction ->
// Uoctti channels, one barrier after each. The small phases then fill the
// block, and a level has 6 * ceil(L / GL) barriers instead of 6 * L. After
// the channels the threads take (output row, slice) tasks over the group's
// weight words and add their products with the F faces' new features to
// the tasks' partial sums: each 16-byte weight load serves F faces,
// the L2 weight traffic falls F-fold, and no feature row is kept (a body
// holds its own 16 * C * C bf16 features only). The update adds the bias
// weight and the slices' sums at the end of the level.
//
// Buffers are compact and exact: the sampled patch is uint8 when it is
// quantised (integers 0..255) and float32 otherwise, the gradient
// magnitudes and the x partials are bf16 (both rounded to bf16 before they
// are stored), and the partials reuse the patch's bytes, the cell
// histograms the magnitudes', the x contraction's accumulators the taps'.
// Per-pixel loops deal a patch's pixels round the block in row-major order
// and step each thread's (row, column) without a division. The x
// contraction runs one task per (cell column, row) and adds each pixel to
// its bin's accumulator in shared memory: the same f32 sums in increasing x
// as the twin, without a predicated add per bin. The y contraction takes a
// bin pair per task; a cell's energy is summed from its four terms in
// order where the channels need it.
//
// Built with -fmad=false: every float operation of the body rounds on its
// own, as the twin's separate operations do, and both splat contractions
// sum in increasing pixel order, so the bf16 features equal the twin's bit
// for bit. Only the regressor sums are ordered otherwise (per slice, then
// bias and slices; bf16 x bf16 products are exact in f32, so a fused
// multiply-add rounds as a separate add would).
//
// Measurement builds (chip_smoke.py's K3 split and --k3-batches, never an
// entry point):
// -DCASCADE_SKIP_GEMV leaves the update at zero, -DCASCADE_SKIP_BODY runs
// no landmark body, -DCASCADE_PHASE_CLOCKS sums thread 0's cycles per phase,
// -DCASCADE_GEMV_SLICES=k cuts every weight row into k slices.

#include "cascade_body.cuh"

namespace {

using namespace fused;

constexpr int kMaxFaces = 2;  // faces per block: the GEMV's accumulators

#ifdef CASCADE_PHASE_CLOCKS
// thread 0's cycles from one barrier to the next, summed over the blocks:
// IED and bias, taps, sampling, gradients, x contraction, y contraction,
// channels, GEMV (behind a barrier of its own in this build), row update
// and the next level's tent
constexpr int kPhases = 9;
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE_END(k)                                                     \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0) {                                              \
      const long long now = clock64();                                   \
      atomicAdd(&g_phase_cycles[k], (unsigned long long)(now - stamp));  \
      stamp = now;                                                       \
    }                                                                    \
  } while (0)
#else
#define PHASE_END(k) __syncthreads()
#endif

// The GEMV's slices of a weight row: slice k takes every fifth 16-byte word
// pair of a landmark's features from pair k on, and each (output row,
// slice) is one task. Five slices read fastest of 3 to 23 on the H100 for
// every family and batch (chip_smoke.py --k3-batches --slices). The same
// for every launch plan, so a face's regressor sums, and its rows, do not
// depend on the batch it comes in.
#ifndef CASCADE_GEMV_SLICES
#define CASCADE_GEMV_SLICES 5
#endif
constexpr int kGemvSlices = CASCADE_GEMV_SLICES;

// Byte offsets of the block's shared buffers, each 16-byte aligned; the
// wrapper's _shared_bytes lays them out the same way. Per-body buffers are
// at body + b * body_bytes, offsets relative to that.
struct Layout {
  int tent, xs, upd, fscal, fwin, fstride, origin, taps, total;
  int tap_bytes, ytap, xtap, yw0, yw1, xw0, xw1;       // within one body's taps
  int body, body_bytes, img, mag, energy, bin, feat;   // within one body
  __host__ __device__ Layout(int l, int c, int s, int nf, int nb,
                             int pixel_bytes, int threads) {
    const int cc = c * c;
    int at = 0;
    tent = take(&at, s * c * 4);
    xs = take(&at, nf * 2 * l * 4);
    // the GEMV's partial sums: per slice of the weight words, per face,
    // per output row
    upd = take(&at, kGemvSlices * nf * 2 * l * 4);
    fscal = take(&at, nf * 2 * 4);
    fwin = take(&at, nf * 8);
    fstride = take(&at, nf * 8);
    origin = take(&at, nb * 2 * 4);
    int t = 0;
    ytap = take(&t, s * 4);
    xtap = take(&t, s * 4);
    yw0 = take(&t, s * 4);
    yw1 = take(&t, s * 4);
    xw0 = take(&t, s * 4);
    xw1 = take(&t, s * 4);
    tap_bytes = t;
    // the taps of the bodies in flight; after sampling, the x
    // contraction's accumulators (kBins per thread)
    const int scratch = kBins * threads * 4;
    taps = take(&at, nb * tap_bytes > scratch ? nb * tap_bytes : scratch);
    int b = 0;
    const int patch = s * s * pixel_bytes, part = kBins * c * s * 2;
    img = take(&b, patch > part ? patch : part);  // patch, then x partials
    int cells_bytes = 0;
    take(&cells_bytes, kBins * cc * 4);
    energy = cells_bytes;
    take(&cells_bytes, kOrient * cc * 4);
    mag = take(&b, s * s * 2 > cells_bytes ? s * s * 2 : cells_bytes);
    energy += mag;  // magnitudes, then cell histograms and energy terms
    bin = take(&b, s * s);
    feat = take(&b, kDims * cc * 2);
    body_bytes = b;
    body = take(&at, nb * body_bytes);
    total = at;
  }
};

// The window source's pixels, read through the read-only data path: the
// pointer stems from the kernel's argument, so the loads can pass the
// block's shared-memory stores.
__device__ __forceinline__ const uint8_t* source_base(const FramesSource& s) {
  return s.frames;
}
__device__ __forceinline__ const __nv_bfloat16* source_base(
    const WindowsSource& s) {
  return s.windows;
}
__device__ __forceinline__ float ldg_pixel(const uint8_t* p, int64_t i) {
  return (float)__ldg(p + i);
}
__device__ __forceinline__ float ldg_pixel(const __nv_bfloat16* p,
                                           int64_t i) {
  return __bfloat162float(__ldg(p + i));
}

__device__ __forceinline__ float load_img(const uint8_t* p, int i) {
  return (float)p[i];
}
__device__ __forceinline__ float load_img(const float* p, int i) {
  return p[i];
}

// 256 threads: four blocks an SM (64 registers a thread); 1,024: one
template <typename Source, typename Img, int Threads>
__global__ void __launch_bounds__(Threads, Threads >= 1024 ? 1 : 4)
cascade_kernel(Source src, const float* __restrict__ x0,
               float* __restrict__ out,
               const __nv_bfloat16* __restrict__ weights,
               const int* __restrict__ level_i,
               const float* __restrict__ level_rel,
               const float* __restrict__ tents, const int* __restrict__ eyes,
               int n, int n_levels, int l, int c, int ry, int rx, int fp,
               int s_max, int nf, int gl) {
  using Pixel = typename Source::pixel_t;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = nf * gl;
  const Layout lay(l, c, s_max, nf, nb, (int)sizeof(Img), Threads);
  float* tent = reinterpret_cast<float*>(smem + lay.tent);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* upd = reinterpret_cast<float*>(smem + lay.upd);
  float* fscal = reinterpret_cast<float*>(smem + lay.fscal);  // ied, phw
  // each face's window as an offset from the source's first pixel, and its
  // row stride; offset -1: no window
  int64_t* fwin = reinterpret_cast<int64_t*>(smem + lay.fwin);
  int64_t* fstride = reinterpret_cast<int64_t*>(smem + lay.fstride);
  const Pixel* base = source_base(src);
  int* origin = reinterpret_cast<int*>(smem + lay.origin);
  float* scratch = reinterpret_cast<float*>(smem + lay.taps);
  unsigned char* bodies = smem + lay.body;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = Threads / 32;
  const int l2 = 2 * l;
  const int cc = c * c;
  const int dcc = kDims * cc;            // features of one landmark
  const int nfeat = l * dcc + 1;
  const int64_t face0 = (int64_t)blockIdx.x * nf;
  constexpr int nslice = kGemvSlices;
#ifdef CASCADE_PHASE_CLOCKS
  long long stamp = clock64();
#endif

  // faces past N and faces whose frame index or origin lies outside the
  // stack have no window: their bodies are skipped (no reads), and the
  // second get a row of NaN
  for (int f = tid; f < nf; f += Threads) {
    const Pixel* win = nullptr;
    int64_t stride = 0;
    if (face0 + f < n) win = src.window(face0 + f, ry, rx, &stride);
    fwin[f] = win != nullptr ? win - base : -1;
    fstride[f] = stride;
  }
  for (int j = tid; j < nf * l2; j += Threads) {
    const int64_t face = face0 + j / l2;
    xs[j] = face < n ? x0[face * l2 + j % l2] : 0.f;
  }

  LevelGeometry g;
  g.ry = ry;
  g.rx = rx;
  g.c = c;
  g.quantize = sizeof(Img) == 1;
  for (int li = 0; li < n_levels; ++li) {
    g.s = level_i[li * kLevelInts + 0];
    g.w = level_i[li * kLevelInts + 1];
    g.wx = level_i[li * kLevelInts + 2];
    g.cs = level_i[li * kLevelInts + 3];
    const int s = g.s, cs = g.cs;
    const float* level_tent = tents + level_i[li * kLevelInts + 4];
    for (int j = tid; j < s * c; j += Threads) tent[j] = level_tent[j];
    const __nv_bfloat16* wl = weights + (int64_t)li * l2 * fp;
    PHASE_END(8);  // fwin, xs: the setup or the previous level's update
    for (int f = tid; f < nf; f += Threads)
      if (fwin[f] >= 0)
        // the IED of the row before this level's update
        level_ied_patch_half(xs + f * l2, l, eyes, level_rel[li], g.w, g.wx,
                             rx, &fscal[2 * f], &fscal[2 * f + 1]);
    // each thread's partial sums of the GEMV start at zero
    for (int t = tid; t < nslice * nf * l2; t += Threads) upd[t] = 0.f;
    PHASE_END(0);

    for (int lm0 = 0; lm0 < l; lm0 += gl) {
      const int ng = min(gl, l - lm0);  // landmarks in this group
#ifndef CASCADE_SKIP_BODY
      // ---- taps of every body: sub-window origins, then K2's taps ----
      for (int t = tid; t < nb * s; t += Threads) {
        const int b = t / s, j = t - b * s;
        const int f = b / gl, lm = lm0 + (b - f * gl);
        if (lm >= l || fwin[f] < 0) continue;
        LevelGeometry gf = g;
        gf.set_patch_half(fscal[2 * f + 1]);
        const float by = rintf(xs[f * l2 + l + lm]) - gf.phw;
        const float bx = rintf(xs[f * l2 + lm]) - gf.phw;
        int oyw = (int)fminf(fmaxf(floorf(by + gf.src0), 0.f),
                             (float)(ry - gf.w));
        oyw = (oyw / 8) * 8;
        int oxw = 0;
        if (gf.wx != rx) {
          oxw = (int)fminf(fmaxf(floorf(bx + gf.src0), 0.f),
                           (float)(rx - gf.wx));
          oxw = (oxw / 128) * 128;
        }
        if (j == 0) {
          origin[2 * b] = oyw;
          origin[2 * b + 1] = oxw;
        }
        unsigned char* tp = smem + lay.taps + b * lay.tap_bytes;
        const float sj =
            fminf(fmaxf(((float)j + 0.5f) * gf.st - 0.5f, 0.f), gf.hi);
        tap(by, sj, (float)oyw, gf.w,
            reinterpret_cast<int*>(tp + lay.ytap) + j,
            reinterpret_cast<float*>(tp + lay.yw0) + j,
            reinterpret_cast<float*>(tp + lay.yw1) + j);
        tap(bx, sj, (float)oxw, gf.wx,
            reinterpret_cast<int*>(tp + lay.xtap) + j,
            reinterpret_cast<float*>(tp + lay.xw0) + j,
            reinterpret_cast<float*>(tp + lay.xw1) + j);
      }
      PHASE_END(1);

      // ---- sampling, then gradients: per body, the S x S pixels dealt
      // round the block's threads in row-major order; a thread steps its
      // (row, column) by the block size with one division per body ----
      const int step_y = Threads / s, step_x = Threads - step_y * s;
      for (int b = 0; b < nb; ++b) {
        const int f = b / gl;
        if (lm0 + (b - f * gl) >= l || fwin[f] < 0) continue;
        const unsigned char* tp = smem + lay.taps + b * lay.tap_bytes;
        const int* ytap = reinterpret_cast<const int*>(tp + lay.ytap);
        const int* xtap = reinterpret_cast<const int*>(tp + lay.xtap);
        const float* yw0 = reinterpret_cast<const float*>(tp + lay.yw0);
        const float* yw1 = reinterpret_cast<const float*>(tp + lay.yw1);
        const float* xw0 = reinterpret_cast<const float*>(tp + lay.xw0);
        const float* xw1 = reinterpret_cast<const float*>(tp + lay.xw1);
        const int64_t stride = fstride[f];
        const Pixel* sub =
            base + fwin[f] + origin[2 * b] * stride + origin[2 * b + 1];
        Img* img = reinterpret_cast<Img*>(bodies + b * lay.body_bytes +
                                          lay.img);
        int y = tid / s, x = tid - (tid / s) * s;
        for (int p = tid; p < s * s; p += Threads) {
          const int u = xtap[x];
          const float ty0 = yw0[y], ty1 = yw1[y];
          const float tx0 = xw0[x], tx1 = xw1[x];
          const Pixel* row0 = sub + (int64_t)ytap[y] * stride + u;
          const Pixel* row1 = row0 + stride;
          // a pixel is read only where its weight is non-zero: a
          // zero-weight tap may lie outside the window
          const float p00 = ty0 * tx0 != 0.f ? ldg_pixel(row0, 0) : 0.f;
          const float p01 = ty0 * tx1 != 0.f ? ldg_pixel(row0, 1) : 0.f;
          const float p10 = ty1 * tx0 != 0.f ? ldg_pixel(row1, 0) : 0.f;
          const float p11 = ty1 * tx1 != 0.f ? ldg_pixel(row1, 1) : 0.f;
          const float q0 = round_bf16(tx0 * p00 + tx1 * p01);
          const float q1 = round_bf16(tx0 * p10 + tx1 * p11);
          float val = q0 * ty0 + q1 * ty1;
          if (g.quantize) val = fminf(fmaxf(floorf(val + 0.5f), 0.f), 255.f);
          img[p] = (Img)val;  // (y, x); quantised values are 0..255
          y += step_y;
          x += step_x;
          if (x >= s) {
            x -= s;
            ++y;
          }
        }
      }
      PHASE_END(2);

      for (int b = 0; b < nb; ++b) {
        const int f = b / gl;
        if (lm0 + (b - f * gl) >= l || fwin[f] < 0) continue;
        unsigned char* body = bodies + b * lay.body_bytes;
        const Img* img = reinterpret_cast<const Img*>(body + lay.img);
        __nv_bfloat16* mag = reinterpret_cast<__nv_bfloat16*>(body + lay.mag);
        int8_t* bin = reinterpret_cast<int8_t*>(body + lay.bin);
        int y = tid / s, x = tid - (tid / s) * s;
        for (int p = tid; p < s * s; p += Threads) {
          float m = 0.f;
          int bn = -1;
          if (y >= 1 && y <= s - 2 && x >= 1 && x <= s - 2) {
            const float gx = load_img(img, p + 1) - load_img(img, p - 1);
            const float gy = load_img(img, p + s) - load_img(img, p - s);
            m = round_bf16(sqrtf(gx * gx + gy * gy));
            // the sector: along x, along y or diagonal, without branches
            const float ax = fabsf(gx), ay = fabsf(gy);
            const bool px = gx >= 0.f, py = gy >= 0.f;
            const int along_x = px ? 0 : 4, along_y = py ? 2 : 6;
            const int diagonal = px == py ? (px ? 1 : 5) : (py ? 3 : 7);
            bn = ay < ax * 0.41421356237f
                     ? along_x
                     : (ay > ax * 2.41421356237f ? along_y : diagonal);
          }
          mag[p] = __float2bfloat16_rn(m);  // m is a bf16 value already
          bin[p] = (int8_t)bn;
          y += step_y;
          x += step_x;
          if (x >= s) {
            x -= s;
            ++y;
          }
        }
      }
      PHASE_END(3);

      // ---- x contraction: part[bin][cx][y], summed in increasing x; one
      // task per (body, cell column, row), rows over lanes ----
      {
        const int ny = (s + 31) / 32;
        float* acc = scratch + tid;  // kBins accumulators, stride Threads
        for (int u = warp; u < nb * c * ny; u += kWarps) {
          const int b = u / (c * ny), rem = u - b * (c * ny);
          const int ccx = rem / ny, y = (rem - ccx * ny) * 32 + lane;
          const int f = b / gl;
          if (lm0 + (b - f * gl) >= l || fwin[f] < 0 || y >= s)
            continue;
          unsigned char* body = bodies + b * lay.body_bytes;
          __nv_bfloat16* part =
              reinterpret_cast<__nv_bfloat16*>(body + lay.img);
#pragma unroll
          for (int o = 0; o < kBins; ++o) acc[o * Threads] = 0.f;
          if (y >= 1 && y <= s - 2) {  // border rows hold no bins
            const __nv_bfloat16* mag =
                reinterpret_cast<const __nv_bfloat16*>(body + lay.mag) +
                y * s;
            const int8_t* bin =
                reinterpret_cast<const int8_t*>(body + lay.bin) + y * s;
            int lo, hi_x;
            support(ccx, cs, s, &lo, &hi_x);
            // the support is interior, where every pixel has a bin
            for (int x = lo; x <= hi_x; ++x) {
              const float v = tent[x * c + ccx] * __bfloat162float(mag[x]);
              float* a = acc + bin[x] * Threads;
              *a = *a + v;
            }
          }
#pragma unroll
          for (int o = 0; o < kBins; ++o)
            part[(o * c + ccx) * s + y] = __float2bfloat16_rn(acc[o * Threads]);
        }
      }
      PHASE_END(4);

      // ---- y contraction: cells[bin][cx][cy], summed in increasing y;
      // a task takes the bin pair (o, o + 4) of one cell and keeps the
      // square of their sum, the cell's energy term o ----
      for (int t = tid; t < nb * kOrient * cc; t += Threads) {
        const int b = t / (kOrient * cc), r = t - b * (kOrient * cc);
        const int o = r / cc, q = r - o * cc;
        const int f = b / gl;
        if (lm0 + (b - f * gl) >= l || fwin[f] < 0) continue;
        unsigned char* body = bodies + b * lay.body_bytes;
        const __nv_bfloat16* part =
            reinterpret_cast<const __nv_bfloat16*>(body + lay.img);
        float* cells = reinterpret_cast<float*>(body + lay.mag);
        const int ccx = q / c, ccy = q - ccx * c;
        int lo, hi_y;
        support(ccy, cs, s, &lo, &hi_y);
        const __nv_bfloat16* pa = part + (o * c + ccx) * s;
        const __nv_bfloat16* pb = part + ((o + kOrient) * c + ccx) * s;
        float ha = 0.f, hb = 0.f;
        for (int y = lo; y <= hi_y; ++y) {
          const float w = tent[y * c + ccy];
          ha = ha + __bfloat162float(pa[y]) * w;
          hb = hb + __bfloat162float(pb[y]) * w;
        }
        cells[o * cc + q] = ha;
        cells[(o + kOrient) * cc + q] = hb;
        const float fo = ha + hb;
        reinterpret_cast<float*>(body + lay.energy)[o * cc + q] = fo * fo;
      }
      PHASE_END(5);

      // ---- block factors and Uoctti channels, as bf16 features ----
      for (int t = tid; t < nb * cc; t += Threads) {
        const int b = t / cc, q = t - b * cc;
        const int f = b / gl;
        if (lm0 + (b - f * gl) >= l || fwin[f] < 0) continue;
        unsigned char* body = bodies + b * lay.body_bytes;
        const float* cells = reinterpret_cast<const float*>(body + lay.mag);
        // a cell's energy: its four terms summed in order, from zero
        const float* terms =
            reinterpret_cast<const float*>(body + lay.energy);
        const auto energy_at = [&](int cell) {
          float e = 0.f;
#pragma unroll
          for (int o = 0; o < kOrient; ++o) e = e + terms[o * cc + cell];
          return e;
        };
        cell_channels(q, c, cells, energy_at,
                      reinterpret_cast<__nv_bfloat16*>(body + lay.feat));
      }
      PHASE_END(6);
#endif  // CASCADE_SKIP_BODY

#ifndef CASCADE_SKIP_GEMV
      // ---- the group's share of the regressor: a task is one output row
      // and one slice of its weight words (pairs of 16-byte words, 8 bf16
      // each, dealt round the slices) and keeps the F faces' partial sums
      // over the level's groups. No barrier after it: the next group
      // rewrites the features only after five more. ----
      const int pairs = dcc / 16;  // 16-byte word pairs of one landmark
      for (int t = tid; t < nslice * l2; t += Threads) {
        const int sl = t / l2, jr = t - sl * l2;
        const uint4* wrow = reinterpret_cast<const uint4*>(
            wl + (int64_t)jr * fp + (int64_t)lm0 * dcc);
        float* part = upd + (sl * nf) * l2 + jr;
        float acc[kMaxFaces];
#pragma unroll
        for (int f = 0; f < kMaxFaces; ++f)
          acc[f] = f < nf ? part[f * l2] : 0.f;
        // this slice's word pairs of the group, landmark by landmark; the
        // next pair's weights are loaded before this pair's products
        const int cnt = sl < pairs ? (pairs - sl + nslice - 1) / nslice : 0;
        const int total = ng * cnt;
        int gi = 0, qi = 0;
        uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
        if (total > 0) {
          w0 = __ldg(wrow + 2 * sl);
          w1 = __ldg(wrow + 2 * sl + 1);
        }
        for (int j = 0; j < total; ++j) {
          int ngi = gi, nqi = qi + 1;
          if (nqi == cnt) {
            nqi = 0;
            ++ngi;
          }
          uint4 n0 = w0, n1 = w1;
          if (j + 1 < total) {
            const uint4* np = wrow + ngi * 2 * pairs + 2 * (sl + nqi * nslice);
            n0 = __ldg(np);
            n1 = __ldg(np + 1);
          }
          const int q = sl + qi * nslice;
#pragma unroll
          for (int f = 0; f < kMaxFaces; ++f) {
            if (f >= nf) continue;
            const uint4* feat = reinterpret_cast<const uint4*>(
                bodies + (f * gl + gi) * lay.body_bytes + lay.feat);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 fv = feat[2 * q + h];
              const uint4 wv = h == 0 ? w0 : w1;
              const __nv_bfloat162* f2 =
                  reinterpret_cast<const __nv_bfloat162*>(&fv);
              const __nv_bfloat162* w2 =
                  reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 a = __bfloat1622float2(f2[e]);
                const float2 w = __bfloat1622float2(w2[e]);
                acc[f] = __fmaf_rn(a.x, w.x, acc[f]);
                acc[f] = __fmaf_rn(a.y, w.y, acc[f]);
              }
            }
          }
          w0 = n0;
          w1 = n1;
          gi = ngi;
          qi = nqi;
        }
#pragma unroll
        for (int f = 0; f < kMaxFaces; ++f)
          if (f < nf) part[f * l2] = acc[f];
      }
#endif  // CASCADE_SKIP_GEMV
#ifdef CASCADE_PHASE_CLOCKS
      PHASE_END(7);
#endif
    }
    __syncthreads();
    // the update: the bias weight (the bias feature is 1), then the
    // slices' partial sums; norm is 1/IED: dividing the update by it
    // multiplies by the IED
    for (int j = tid; j < nf * l2; j += Threads) {
      if (fwin[j / l2] < 0) continue;
#ifdef CASCADE_SKIP_GEMV
      const float u = 0.f;
#else
      float u = __bfloat162float(wl[(int64_t)(j % l2) * fp + nfeat - 1]);
      for (int sl = 0; sl < nslice; ++sl) u = u + upd[sl * nf * l2 + j];
#endif
      xs[j] = xs[j] - u * fscal[2 * (j / l2)];
    }
  }
  __syncthreads();
  for (int j = tid; j < nf * l2; j += Threads) {
    const int64_t face = face0 + j / l2;
    if (face < n)
      out[face * l2 + j % l2] =
          fwin[j / l2] >= 0 ? xs[j] : __int_as_float(0x7fc00000);
  }
}

template <typename Source, typename Img, int Threads>
cudaError_t launch_as(const Source& src, const void* x0, void* out,
                      const void* weights, const void* level_i,
                      const void* level_rel, const void* tents,
                      const void* eyes, int n, int n_levels, int l, int c,
                      int ry, int rx, int fp, int s_max, int nf, int gl,
                      cudaStream_t stream) {
  const Layout lay(l, c, s_max, nf, nf * gl, (int)sizeof(Img), Threads);
  cudaError_t err = cudaFuncSetAttribute(
      cascade_kernel<Source, Img, Threads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int blocks = (n + nf - 1) / nf;
  cascade_kernel<Source, Img, Threads><<<blocks, Threads, lay.total,
                                          stream>>>(
      src, static_cast<const float*>(x0), static_cast<float*>(out),
      static_cast<const __nv_bfloat16*>(weights),
      static_cast<const int*>(level_i), static_cast<const float*>(level_rel),
      static_cast<const float*>(tents), static_cast<const int*>(eyes), n,
      n_levels, l, c, ry, rx, fp, s_max, nf, gl);
  return cudaGetLastError();
}

// threads: 256 (blocks that share an SM) or 1024 (one block alone on an
// SM, as at batch 1); quantize selects the uint8 patch
template <typename Source>
cudaError_t launch(const Source& src, const void* x0, void* out,
                   const void* weights, const void* level_i,
                   const void* level_rel, const void* tents,
                   const void* eyes, int n, int n_levels, int l, int c,
                   int ry, int rx, int fp, int quantize, int s_max, int nf,
                   int gl, int threads, cudaStream_t stream) {
  if (nf < 1 || nf > kMaxFaces || gl < 1) return cudaErrorInvalidValue;
#define CASCADE_LAUNCH(IMG, THREADS)                                        \
  return launch_as<Source, IMG, THREADS>(src, x0, out, weights, level_i,    \
                                         level_rel, tents, eyes, n,         \
                                         n_levels, l, c, ry, rx, fp, s_max, \
                                         nf, gl, stream)
  if (threads == 256) {
    if (quantize) CASCADE_LAUNCH(uint8_t, 256);
    CASCADE_LAUNCH(float, 256);
  }
  if (threads == 1024) {
    if (quantize) CASCADE_LAUNCH(uint8_t, 1024);
    CASCADE_LAUNCH(float, 1024);
  }
#undef CASCADE_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

#ifdef CASCADE_PHASE_CLOCKS
// the phase cycles summed since the last call (kPhases values), then zero
extern "C" int cascade_phase_cycles(void* host) {
  static const unsigned long long zero[kPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

extern "C" int cascade_fused_frames_launch(
    const void* frames, const void* idx, const void* oy, const void* ox,
    int n_img, int h, int w, const void* x0, void* out, const void* weights,
    const void* level_i, const void* level_rel, const void* tents,
    const void* eyes, int n, int n_levels, int l, int c, int ry, int rx,
    int fp, int quantize, int s_max, int nf, int gl, int threads,
    void* stream) {
  FramesSource src{static_cast<const uint8_t*>(frames),
                   static_cast<const int*>(idx), static_cast<const int*>(oy),
                   static_cast<const int*>(ox), n_img, h, w};
  return (int)launch(src, x0, out, weights, level_i, level_rel, tents, eyes,
                     n, n_levels, l, c, ry, rx, fp, quantize, s_max, nf, gl,
                     threads, static_cast<cudaStream_t>(stream));
}

extern "C" int cascade_fused_launch(
    const void* windows, const void* x0, void* out, const void* weights,
    const void* level_i, const void* level_rel, const void* tents,
    const void* eyes, int n, int n_levels, int l, int c, int ry, int rx,
    int fp, int quantize, int s_max, int nf, int gl, int threads,
    void* stream) {
  WindowsSource src{static_cast<const __nv_bfloat16*>(windows)};
  return (int)launch(src, x0, out, weights, level_i, level_rel, tents, eyes,
                     n, n_levels, l, c, ry, rx, fp, quantize, s_max, nf, gl,
                     threads, static_cast<cudaStream_t>(stream));
}
