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
// ten 4x4 B_PRED modes; the chroma modes), into the unfiltered Y / U / V
// planes, padded to whole macroblocks. W2 (vp8_filter): libwebp's loop
// filter in place on them (normal: macroblock and inner edges of luma and
// chroma; simple: luma only), macroblock by macroblock as DoFilter orders
// it: the left edge, the inner vertical edges, the top edge, the inner
// horizontal edges.
//
// W1 and W2 are wavefronts: macroblock (r, c) reads (r, c - 1), (r - 1, c)
// and (r - 1, c + 1) (W1: the left samples, the top and top-right ones;
// W2: the left edge filter of (r - 1, c + 1) changes samples that the top
// edge filter of (r, c) reads), so a frame is a chain of mb_w + 2 (mb_h -
// 1) dependent macroblock steps and no byte bound is within reach: what
// bounds them on this card is the time of one step, a warp's chain of
// dependent instructions. The design keeps a step short and inside an SM:
//
// * A warp owns a macroblock row (W1: a pair of warps) and takes its
//   macroblocks in order. Row r runs on CTA (r / rows) % ctas as the
//   CTA's row r % rows (ops/webp.py's vp8_launch_plan chooses rows a CTA
//   and CTAs: few warps to an SM), which takes rows r, r + rows ctas, ...
// * The hand-off between rows is a count of macroblocks done: in shared
//   memory under a .cta fence / acquire where the row above runs on the
//   same CTA, in global memory under .gpu where it runs on another (one
//   row in `rows`). Row r waits until row r - 1 has done c + 2 macroblocks
//   (or its end). The samples it needs from that row come from the planes:
//   plain loads after a .cta acquire (the SM's own L1), L2 loads after a
//   .gpu one. Every CTA of the plan must be
//   resident at once: the launcher refuses a plan the occupancy API does
//   not hold. A wait that never ends traps.
// * W1: the residual warp of a row loads a macroblock's 400 coefficients
//   and 20 mode bytes with cp.async a macroblock ahead, runs the inverse
//   WHT (a lane a Y block's DC) and the 24 inverse DCTs (a lane a block)
//   and hands the residuals to the prediction warp through two slots. The
//   prediction warp, after the wait, loads the samples above (a word a
//   lane, one load) and runs the 4x4 B_PRED blocks in their own wavefront,
//   block (i, j) at step j + 2 i: 10 steps of at most two blocks, a lane a
//   sample, each prediction but TM a dot product (__dp4a) of the 13
//   context samples with weights in eighths from a table in shared memory.
//   16x16 and chroma predictions take 8 and 4 samples a lane, with no
//   branch on the lane.
// * W2 keeps the macroblock with 4 rows above and 4 columns to the left
//   in shared memory (luma 20 x 20, chroma 12 x 12 a plane). The 32 lanes
//   are the 16 luma and 8 + 8 chroma lines of an edge: a lane filters its
//   row across the vertical edges from registers before the wait (they
//   need only the warp's own previous macroblock, the left margin already
//   in shared memory), then, after the wait and the 4 rows above, its
//   column across the horizontal edges. Each line's filter computes every
//   case and selects: no branch, no divergence; __syncwarp between the
//   passes, no CTA barrier or fence between edges; the tile is written
//   back once.
//
// Measurement builds, never entry points (chip_smoke.py's webp_times):
// -DVP8_HANDOFF_ONLY runs the waits and publishes without the work;
// -DVP8_WORK_ONLY the work without waits or publishes, every row at once
// (its planes are wrong).
//
// W3 (vp8_colour): libwebp's fancy upsampling of 4:2:0 chroma
// (UpsampleRgbLinePair) and VP8YUVToR/G/B (src/dsp/yuv.h), cropped to the
// frame, writing RGB, or the grey OpenCV's formula gives of that RGB
// ((4899 r + 9617 g + 1868 b + 8192) >> 14). No chain here: each output
// byte is written once from bytes read once (3.5 MB a 768 x 1024 RGB
// frame); on this card what bounds it is the launch, one round trip of
// staging and ~40 integer instructions a sample. The design:
//
// * A CTA takes a band of full-width output rows, an even number (ops/
//   webp.py's vp8_colour_plan: two bands an SM, each within the shared
//   memory a CTA may take). Output rows 2k - 1 and 2k read the same two
//   chroma rows, and a band's output is one contiguous byte range.
// * Staging: the band's Y rows and the U / V rows they read (y0 / 2 - 1 to
//   (y1 - 1) / 2 + 1, clamped to the frame) go to shared memory by
//   cp.async, a warp a row, in 16-byte pieces (8 where an odd mb_w puts
//   chroma rows off 16 bytes); each input byte is read once a CTA.
// * Compute: a thread takes 8 adjacent samples of a row at a time, its row
//   and column stepped from threadIdx (no division an item or a sample):
//   one 8-byte load of Y and, per chroma row, one word and two bytes of U
//   and of V. U and V are upsampled together, packed in the two halves of
//   a word as libwebp packs them; output columns 2j and 2j + 1 share chroma
//   column j. Each (x * c) >> 8 is the high word of (x << 24) * c, the
//   clip one min-and-relu. The item's RGB or grey bytes go to the band's
//   output in shared memory, as words where they fall on words.
// * Writing: the band's bytes leave in 16-byte stores from its first
//   16-byte-aligned address to its last; only the ragged head and tail
//   (under 16 bytes each) are stored byte by byte.
//
// Measurement builds of W3, never entry points (chip_smoke.py's
// webp_times): -DVP8_COLOUR_NO_STORE keeps the global stores only behind a
// run-time test that never passes (staging and compute only);
// -DVP8_COLOUR_NO_LOAD stores values made from the coordinates (no loads,
// no compute); -DVP8_COLOUR_EMPTY returns at once on the same grid (the
// launch floor).
//
// Every entry point returns cudaGetLastError(), or the error of a plan it
// refuses.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 16;  // W1, W2: rows a CTA (W1 a pair of warps a row)
constexpr int kColourThreads = 256;

// a wait that outlasts this many cycles (some seconds) is a fault: the
// kernel traps rather than hang the card
constexpr long long kWaitCycles = 1ll << 34;

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed_gpu(int* p, int v) {
  asm volatile("st.relaxed.gpu.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed_cta(int* p, int v) {
  asm volatile("st.relaxed.cta.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// a fence and a relaxed store after it make a release
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void fence_cta() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// a wait spins on the count (a wait is a fraction of a step), and traps
// when it outlasts kWaitCycles
__device__ __forceinline__ void backoff(long long start) {
  if (clock64() - start > kWaitCycles) __trap();
}

// The rows' hand-off, worked out once a row. A count is the macroblocks a
// row has done: in shared memory, done[k] for the k-th row of the CTA's
// `rows` (its warp, or pair of warps) over all its rows
// (pass p of a row counts from p mb_w); in global memory, progress[r] for a
// row r whose next row runs on another CTA (zeros at launch). A publish
// orders every lane's stores before the count by the __syncwarp and lane
// 0's fence and store (the fence covers the warp's stores).
struct RowLink {
  const int* above = nullptr;  // the row above's count (none in row 0)
  int above_base = 0;          // ... at the start of that row
  bool above_far = false;      // ... in global memory
  int* count;                  // this row's count in shared memory
  int base;
  int* far_count = nullptr;    // and in global memory, for another CTA

  __device__ RowLink(int* progress, int* done, int r, int rows, int mb_w,
                     int mb_h) {
    const int stride = rows * gridDim.x;
    count = done + r % rows;
    base = r / stride * mb_w;
    if (r > 0) {
      above_far = gridDim.x > 1 && r % rows == 0;
      above = above_far ? progress + r - 1 : done + (r - 1) % rows;
      above_base = above_far ? 0 : (r - 1) / stride * mb_w;
    }
    if (r + 1 < mb_h && gridDim.x > 1 && (r + 1) % rows == 0)
      far_count = progress + r;
  }

  // every lane waits until the row above has done `need` macroblocks
  __device__ void wait(int need) const {
    if (above) {
      const long long start = clock64();
      const int target = above_base + need;
      if (above_far) {
        while (ld_acquire_gpu(above) < target) backoff(start);
      } else {
        while (ld_acquire_cta(above) < target) backoff(start);
      }
    }
    __syncwarp();
  }

  // macroblocks 0 .. c done; and, behind the same fence, `also` = value
  __device__ void publish(int c, int* also = nullptr, int value = 0) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      if (far_count) {
        fence_gpu();
        st_relaxed_gpu(far_count, c + 1);
      } else {
        fence_cta();
      }
      st_relaxed_cta(count, base + c + 1);
      if (also) st_relaxed_cta(also, value);
    }
  }
};

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : v > 255 ? 255 : v;
}

// samples another CTA wrote: past L1
__device__ __forceinline__ uint32_t ld_word(const uint8_t* p, bool far) {
  return far ? __ldcg((const unsigned*)p) : *(const uint32_t*)p;
}
__device__ __forceinline__ uint2 ld_pair(const uint8_t* p, bool far) {
  return far ? __ldcg((const uint2*)p) : *(const uint2*)p;
}

// ---------------------------------------------------------------- W1 --
__device__ __forceinline__ int mul1(int a) { return ((a * 20091) >> 16) + a; }
__device__ __forceinline__ int mul2(int a) { return (a * 35468) >> 16; }

// libwebp's TransformOne without the add: residuals v >> 3
__device__ __forceinline__ void inverse_dct(const int (&in)[16],
                                            int (&res)[16]) {
  int tmp[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
#pragma unroll
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

// libwebp's TransformWHT, output b only: Y2 -> the DC of Y block b
__device__ __forceinline__ int wht_dc(const int (&in)[16], int b) {
  const int i = b >> 2, k = b & 3;
  int t[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int a0 = in[m] + in[12 + m], a1 = in[4 + m] + in[8 + m];
    const int a2 = in[4 + m] - in[8 + m], a3 = in[m] - in[12 + m];
    t[m] = i == 0 ? a0 + a1 : i == 1 ? a3 + a2 : i == 2 ? a0 - a1 : a3 - a2;
  }
  const int dc = t[0] + 3;
  const int a0 = dc + t[3], a1 = t[1] + t[2];
  const int a2 = t[1] - t[2], a3 = dc - t[3];
  const int v = k == 0 ? a0 + a1 : k == 1 ? a3 + a2 : k == 2 ? a0 - a1
                                                             : a3 - a2;
  return (int16_t)(v >> 3);
}

// The 4x4 predictions other than TM (libwebp's DC4 .. HU4) as weights in
// eighths over the 13 context samples I J K L (left, down), X (top-left),
// A..H (top and top-right): pixel = (w . ctx + 4) >> 3, exact for AVG3 (a +
// 2b + c + 2) >> 2, AVG2 (a + b + 1) >> 1 and copies. A (mode, pixel) is 16
// weight bytes in the order of the context's words, I..L, A..D, E..H, X, for
// three __dp4a and one product. ops/webp.py::MODE_WEIGHTS holds the same
// numbers.
struct alignas(16) ModeWeights {
  uint8_t w[10 * 16][16];

  __host__ __device__ constexpr void add(int mode, int x, int y, int tap,
                                         int weight) {
    // taps I..L, X, A..H (0-12) -> bytes 0-3, 12, 4-11
    w[16 * mode + 4 * y + x][tap < 4 ? tap : tap == 4 ? 12 : tap - 1] +=
        weight;
  }
  // AVG3 of three taps, AVG2 of two, a copy of one
  __host__ __device__ constexpr void put(int mode, int x, int y, int a,
                                         int b = -1, int c = -1) {
    if (c >= 0) {
      add(mode, x, y, a, 2);
      add(mode, x, y, b, 4);
      add(mode, x, y, c, 2);
    } else if (b >= 0) {
      add(mode, x, y, a, 4);
      add(mode, x, y, b, 4);
    } else {
      add(mode, x, y, a, 8);
    }
  }
};

__host__ __device__ constexpr ModeWeights mode_weights() {
  enum { I, J, K, L, X, A, B, C, D, E, F, G, H };
  ModeWeights t{};
  const int dc_taps[8] = {I, J, K, L, A, B, C, D};
  for (int p = 0; p < 16; ++p)
    for (int k = 0; k < 8; ++k) t.add(0, p % 4, p / 4, dc_taps[k], 1);
  for (int y = 0; y < 4; ++y) {  // VE4, HE4
    t.put(2, 0, y, X, A, B);
    t.put(2, 1, y, A, B, C);
    t.put(2, 2, y, B, C, D);
    t.put(2, 3, y, C, D, E);
    t.put(3, y, 0, X, I, J);
    t.put(3, y, 1, I, J, K);
    t.put(3, y, 2, J, K, L);
    t.put(3, y, 3, K, L, L);
  }
  // RD4
  t.put(4, 0, 3, J, K, L);
  t.put(4, 1, 3, I, J, K);
  t.put(4, 0, 2, I, J, K);
  t.put(4, 2, 3, X, I, J);
  t.put(4, 1, 2, X, I, J);
  t.put(4, 0, 1, X, I, J);
  t.put(4, 3, 3, A, X, I);
  t.put(4, 2, 2, A, X, I);
  t.put(4, 1, 1, A, X, I);
  t.put(4, 0, 0, A, X, I);
  t.put(4, 3, 2, B, A, X);
  t.put(4, 2, 1, B, A, X);
  t.put(4, 1, 0, B, A, X);
  t.put(4, 3, 1, C, B, A);
  t.put(4, 2, 0, C, B, A);
  t.put(4, 3, 0, D, C, B);
  // VR4
  t.put(5, 0, 0, X, A);
  t.put(5, 1, 2, X, A);
  t.put(5, 1, 0, A, B);
  t.put(5, 2, 2, A, B);
  t.put(5, 2, 0, B, C);
  t.put(5, 3, 2, B, C);
  t.put(5, 3, 0, C, D);
  t.put(5, 0, 3, K, J, I);
  t.put(5, 0, 2, J, I, X);
  t.put(5, 0, 1, I, X, A);
  t.put(5, 1, 3, I, X, A);
  t.put(5, 1, 1, X, A, B);
  t.put(5, 2, 3, X, A, B);
  t.put(5, 2, 1, A, B, C);
  t.put(5, 3, 3, A, B, C);
  t.put(5, 3, 1, B, C, D);
  // LD4
  t.put(6, 0, 0, A, B, C);
  t.put(6, 1, 0, B, C, D);
  t.put(6, 0, 1, B, C, D);
  t.put(6, 2, 0, C, D, E);
  t.put(6, 1, 1, C, D, E);
  t.put(6, 0, 2, C, D, E);
  t.put(6, 3, 0, D, E, F);
  t.put(6, 2, 1, D, E, F);
  t.put(6, 1, 2, D, E, F);
  t.put(6, 0, 3, D, E, F);
  t.put(6, 3, 1, E, F, G);
  t.put(6, 2, 2, E, F, G);
  t.put(6, 1, 3, E, F, G);
  t.put(6, 3, 2, F, G, H);
  t.put(6, 2, 3, F, G, H);
  t.put(6, 3, 3, G, H, H);
  // VL4
  t.put(7, 0, 0, A, B);
  t.put(7, 1, 0, B, C);
  t.put(7, 0, 2, B, C);
  t.put(7, 2, 0, C, D);
  t.put(7, 1, 2, C, D);
  t.put(7, 3, 0, D, E);
  t.put(7, 2, 2, D, E);
  t.put(7, 0, 1, A, B, C);
  t.put(7, 1, 1, B, C, D);
  t.put(7, 0, 3, B, C, D);
  t.put(7, 2, 1, C, D, E);
  t.put(7, 1, 3, C, D, E);
  t.put(7, 3, 1, D, E, F);
  t.put(7, 2, 3, D, E, F);
  t.put(7, 3, 2, E, F, G);
  t.put(7, 3, 3, F, G, H);
  // HD4
  t.put(8, 0, 0, I, X);
  t.put(8, 2, 1, I, X);
  t.put(8, 0, 1, J, I);
  t.put(8, 2, 2, J, I);
  t.put(8, 0, 2, K, J);
  t.put(8, 2, 3, K, J);
  t.put(8, 0, 3, L, K);
  t.put(8, 3, 0, A, B, C);
  t.put(8, 2, 0, X, A, B);
  t.put(8, 1, 0, I, X, A);
  t.put(8, 3, 1, I, X, A);
  t.put(8, 1, 1, J, I, X);
  t.put(8, 3, 2, J, I, X);
  t.put(8, 1, 2, K, J, I);
  t.put(8, 3, 3, K, J, I);
  t.put(8, 1, 3, L, K, J);
  // HU4
  t.put(9, 0, 0, I, J);
  t.put(9, 2, 0, J, K);
  t.put(9, 0, 1, J, K);
  t.put(9, 2, 1, K, L);
  t.put(9, 0, 2, K, L);
  t.put(9, 1, 0, I, J, K);
  t.put(9, 3, 0, J, K, L);
  t.put(9, 1, 1, J, K, L);
  t.put(9, 3, 1, K, L, L);
  t.put(9, 1, 2, K, L, L);
  t.put(9, 3, 2, L);
  t.put(9, 2, 2, L);
  t.put(9, 0, 3, L);
  t.put(9, 1, 3, L);
  t.put(9, 2, 3, L);
  t.put(9, 3, 3, L);
  return t;
}

__device__ const ModeWeights kModeWeights = mode_weights();

// a block's 16 coefficients from shared memory
__device__ __forceinline__ void load_block(int (&out)[16],
                                           const int16_t* src) {
  const uint4 w0 = *(const uint4*)src, w1 = *(const uint4*)(src + 8);
  const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out[2 * k] = (int16_t)(w[k] & 0xffff);
    out[2 * k + 1] = (int16_t)(w[k] >> 16);
  }
}

// four samples of a 16x16 luma or 8x8 chroma prediction (libwebp's DC16 ..
// TM16 and the chroma twins; DC's variants at the frame's top and left)
// plus their residuals, packed: `top` the word of the 4 samples above them,
// `left` the sample left of their row, st / sl the sums of all `size`
// samples above / to the left (DC only)
__device__ __forceinline__ uint32_t predict_run(int size, int mode,
                                                uint32_t top, int left,
                                                int corner, int st, int sl,
                                                int r, int c, int4 res) {
  int dc = 128;
  if (mode == 0) {
    const int shift = size == 16 ? 5 : 4;
    if (r == 0 && c > 0) dc = (sl + size / 2) >> (shift - 1);
    if (r > 0 && c == 0) dc = (st + size / 2) >> (shift - 1);
    if (r > 0 && c > 0) dc = (st + sl + size) >> shift;
  }
  const int rs[4] = {res.x, res.y, res.z, res.w};
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = (top >> (8 * k)) & 255;
    const int pred = mode == 1   ? clip255(t + left - corner)
                     : mode == 2 ? t
                     : mode == 3 ? left
                                 : dc;
    out |= (uint32_t)clip255(pred + rs[k]) << (8 * k);
  }
  return out;
}

// a row's shared memory in W1, its two warps': the residual warp's
// cp.async buffers and the residuals it hands to the prediction warp (two
// slots), the prediction warp's work area
struct alignas(16) W1Row {
  int res[2][24][16];    // the 24 blocks' residuals, raster within a block
  int16_t coef[25][16];  // the next macroblock's coefficients (cp.async)
  uint8_t y[17][48];     // row 0 the samples above: col 15 the corner, 16-31
                         // the top, 32-35 the top-right; rows 1-16 the
                         // macroblock's rows: col 15 the left sample, 16-31
                         // the samples, 32-35 on rows 4, 8, 12 the top-right
  uint8_t uv[2][9][16];  // U, V: row 0 above (col 7 the corner, 8-15), rows
                         // 1-8: col 7 the left sample, 8-15 the samples
  uint8_t mode[2][32];    // the 20 mode bytes of each slot
  uint8_t next_mode[32];  // the next macroblock's (cp.async)
  int ready, used;  // macroblocks whose residuals are in, and predicted
  int pad[2];
};
constexpr int kW1Head = 10 * 16 * 16 + kMaxRows * 4;  // weights, counts

// the coefficients and modes of macroblock mb into the row's buffers
__device__ __forceinline__ void fetch_macroblock(W1Row& s,
                                                 const int16_t* coeffs,
                                                 const uint8_t* modes,
                                                 long mb, int lane) {
  if (lane < 25) {
    const int16_t* src = coeffs + mb * 400 + 16 * lane;
    cp_async16(&s.coef[lane][0], src);
    cp_async16(&s.coef[lane][8], src + 8);
  }
  if (lane < 5) cp_async4(&s.next_mode[4 * lane], modes + mb * 20 + 4 * lane);
}

// a macroblock's samples into the planes: a lane a row, luma 0-15, U 16-23,
// V 24-31
__device__ __forceinline__ void store_macroblock(const W1Row& s,
                                                 uint8_t* y_plane,
                                                 uint8_t* u_plane,
                                                 uint8_t* v_plane, int r,
                                                 int c, int W, int Wc,
                                                 int lane) {
  if (lane < 16) {
    *(uint4*)(y_plane + (long)(16 * r + lane) * W + 16 * c) =
        *(const uint4*)&s.y[1 + lane][16];
  } else {
    const int p = (lane >> 3) & 1, k = lane & 7;
    uint8_t* plane = p ? v_plane : u_plane;
    *(uint2*)(plane + (long)(8 * r + k) * Wc + 8 * c) =
        *(const uint2*)&s.uv[p][1 + k][8];
  }
}

// the residual warp of a row: every macroblock of the rows r = first,
// first + stride, ... in order, its residuals into slot m % 2 (m counts
// the row's macroblocks) once the prediction warp has used what was there
__device__ void make_residuals(W1Row& s, const int16_t* coeffs,
                               const uint8_t* modes, int first, int stride,
                               int mb_w, int mb_h, int lane) {
  if (first < mb_h) fetch_macroblock(s, coeffs, modes, (long)first * mb_w,
                                     lane);
  int m = 0;
  for (int r = first; r < mb_h; r += stride) {
    for (int c = 0; c < mb_w; ++c, ++m) {
      if (m >= 2) {
        const long long start = clock64();
        while (ld_acquire_cta(&s.used) < m - 1) backoff(start);
      }
      cp_async_wait_all();
      __syncwarp();
      const int slot = m & 1;
      const bool is4 = s.next_mode[0] != 0;
      if (lane < 5)
        ((uint32_t*)s.mode[slot])[lane] =
            ((const uint32_t*)s.next_mode)[lane];
      int in[16];
      load_block(in, s.coef[lane < 24 ? lane + 1 : 0]);
      if (lane < 16 && !is4) {  // the Y DCs from Y2
        int y2[16];
        load_block(y2, s.coef[0]);
        in[0] = wht_dc(y2, lane);
      }
      __syncwarp();
      {
        int nr = r, nc = c + 1;
        if (nc == mb_w) {
          nr += stride;
          nc = 0;
        }
        if (nr < mb_h)
          fetch_macroblock(s, coeffs, modes, (long)nr * mb_w + nc, lane);
      }
      if (lane < 24) {  // a lane a block (luma 0-15, U 16-19, V 20-23)
        int res[16];
        inverse_dct(in, res);
        int4* dst = (int4*)s.res[slot][lane];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[k] = make_int4(res[4 * k], res[4 * k + 1], res[4 * k + 2],
                             res[4 * k + 3]);
      }
      __syncwarp();
      if (lane == 0) st_release_cta(&s.ready, m + 1);
    }
  }
}

// A row is a pair of warps: the first predicts (and hands off to the next
// row), the second makes the residuals a macroblock ahead (make_residuals).
__global__ void __launch_bounds__(64 * kMaxRows)
    vp8_reconstruct(const int16_t* __restrict__ coeffs,
                    const uint8_t* __restrict__ modes, uint8_t* y_plane,
                    uint8_t* u_plane, uint8_t* v_plane, int* progress,
                    int mb_w, int mb_h) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x >> 6, row = threadIdx.x >> 6;
  const int lane = threadIdx.x & 31;
  uint4* weights = (uint4*)smem;
  int* done = (int*)(smem + 10 * 16 * 16);
  W1Row& s = ((W1Row*)(smem + kW1Head))[row];
  const int stride = rows * gridDim.x;
  for (int i = threadIdx.x; i < 160; i += blockDim.x)
    weights[i] = *(const uint4*)kModeWeights.w[i];
  if (threadIdx.x < kMaxRows) done[threadIdx.x] = 0;
  if ((threadIdx.x & 63) == 0) s.ready = s.used = 0;
  __syncthreads();
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  int r = blockIdx.x * rows + row;
  if (threadIdx.x & 32) {
#ifndef VP8_HANDOFF_ONLY
    make_residuals(s, coeffs, modes, r, stride, mb_w, mb_h, lane);
#endif
    return;
  }
  int m = 0;  // the row's macroblocks so far
  for (; r < mb_h; r += stride) {
    const RowLink link(progress, done, r, rows, mb_w, mb_h);
    const bool far = link.above_far;
    // the row above's last samples (Y, U, V rows from x = 0)
    const uint8_t *up_y = y_plane, *up_u = u_plane, *up_v = v_plane;
    if (r > 0) {
      up_y = y_plane + (long)(16 * r - 1) * W;
      up_u = u_plane + (long)(8 * r - 1) * Wc;
      up_v = v_plane + (long)(8 * r - 1) * Wc;
    }
    for (int c = 0; c < mb_w; ++c, ++m) {
#ifndef VP8_HANDOFF_ONLY
      // this macroblock's residuals and modes from the residual warp
      {
        const long long start = clock64();
        while (ld_acquire_cta(&s.ready) < m + 1) backoff(start);
      }
      __syncwarp();
      const int(*res)[16] = s.res[m & 1];
      const uint8_t* mb_mode = s.mode[m & 1];
      const bool is4 = mb_mode[0] != 0;
      // the left samples: the warp's previous macroblock, 129 left of the
      // frame
      if (lane < 16) {
        s.y[1 + lane][15] = c == 0 ? 129 : s.y[1 + lane][31];
      } else {
        const int p = (lane >> 3) & 1, k = lane & 7;
        s.uv[p][1 + k][7] = c == 0 ? 129 : s.uv[p][1 + k][15];
      }
#endif
#ifndef VP8_WORK_ONLY
#ifndef VP8_HANDOFF_ONLY
      link.wait(c + 1);  // the macroblock above (B_PRED waits for more)
#else
      link.wait(c + 2 < mb_w ? c + 2 : mb_w);
#endif
#endif
#ifndef VP8_HANDOFF_ONLY
      // the samples above, a word a lane, all by one load so that no lane
      // waits on another's: lanes 0-3 Y's 16, 4-5 U's and 6-7 V's 8. The
      // corner is the last sample above the macroblock before (its lane
      // keeps it before its word replaces it). 127 above the frame (its
      // corner too), 129 for the corner left of it.
      if (lane < 8) {
        const int q = lane < 4 ? 0 : lane < 6 ? 1 : 2;
        const int k = lane - (q == 0 ? 0 : q == 1 ? 4 : 6);
        uint8_t* above = q == 0 ? &s.y[0][16] : &s.uv[q - 1][0][8];
        uint32_t v = 0x7f7f7f7fu;
        const uint8_t* src =
            q == 0 ? up_y + 16 * c : (q == 1 ? up_u : up_v) + 8 * c;
        if (r > 0) v = ld_word(src + 4 * k, far);
        if (k == (q == 0 ? 3 : 1))
          above[-1] = r == 0 ? 127 : c == 0 ? 129 : above[4 * k + 3];
        *(uint32_t*)(above + 4 * k) = v;
      }
      __syncwarp();
      // chroma: four samples a lane (plane lane / 16, row (lane / 2) % 8),
      // kept in a register while the luma runs; DC's sums over 8-lane
      // groups (U top, U left, V top, V left)
      const int cm = mb_mode[18];
      const int cp = lane >> 4, cy = (lane >> 1) & 7, cx = 4 * (lane & 1);
      int cst = 0, csl = 0;
      if (cm == 0) {
        int part = (lane & 8) ? s.uv[cp][1 + (lane & 7)][7]
                              : s.uv[cp][0][8 + (lane & 7)];
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        cst = __shfl_sync(0xffffffffu, part, 16 * cp);
        csl = __shfl_sync(0xffffffffu, part, 16 * cp + 8);
      }
      const uint32_t chroma = predict_run(
          8, cm, *(const uint32_t*)&s.uv[cp][0][8 + cx], s.uv[cp][1 + cy][7],
          s.uv[cp][0][7], cst, csl, r, c,
          *(const int4*)&res[16 + 4 * cp + 2 * (cy >> 2) + (cx >> 2)]
                              [4 * (cy & 3)]);
      if (!is4) {  // 16x16: eight samples a lane, row lane / 2
        const int lm = mb_mode[1];
        int st = 0, sl = 0;
        if (lm == 0) {
          int part = lane < 16 ? s.y[0][16 + lane] : s.y[1 + (lane & 15)][15];
          part += __shfl_xor_sync(0xffffffffu, part, 8);
          part += __shfl_xor_sync(0xffffffffu, part, 4);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          st = __shfl_sync(0xffffffffu, part, 0);
          sl = __shfl_sync(0xffffffffu, part, 16);
        }
        const int y = lane >> 1, x = 8 * (lane & 1);
        const int left = s.y[1 + y][15], corner = s.y[0][15];
        const int b = 4 * (y >> 2) + (x >> 2), k = 4 * (y & 3);
        const uint32_t lo = predict_run(
            16, lm, *(const uint32_t*)&s.y[0][16 + x], left, corner, st, sl,
            r, c, *(const int4*)&res[b][k]);
        const uint32_t hi = predict_run(
            16, lm, *(const uint32_t*)&s.y[0][20 + x], left, corner, st, sl,
            r, c, *(const int4*)&res[b + 1][k]);
        *(uint2*)&s.y[1 + y][16 + x] = make_uint2(lo, hi);
      } else {  // B_PRED: block (i, j) at step j + 2 i, a half-warp a block
        const int h = lane >> 4, p = lane & 15, px = p & 3, py = p >> 2;
        int mode[10];  // this lane's block's mode at each step (-1: none)
#pragma unroll
        for (int step = 0; step < 10; ++step) {
          const int i = (step > 3 ? (step - 2) >> 1 : 0) + h;
          const int j = step - 2 * i;
          mode[step] = i <= 3 && j >= 0 ? mb_mode[2 + 4 * i + j] : -1;
        }
#pragma unroll
        for (int step = 0; step < 10; ++step) {
          if (step == 3) {
            // the top-right, first needed here (block (0, 3)), from the
            // row above's next macroblock: its own wait; on rows 0, 4, 8,
            // 12 (the last column's blocks take the macroblock's)
#ifndef VP8_WORK_ONLY
            if (c + 1 < mb_w) link.wait(c + 2);
#endif
            if (lane == 0) {
              uint32_t v = 0x7f7f7f7fu;
              if (r > 0)
                v = c + 1 < mb_w ? ld_word(up_y + 16 * c + 16, far)
                                 : 0x01010101u * s.y[0][31];
#pragma unroll
              for (int k = 0; k < 4; ++k) *(uint32_t*)&s.y[4 * k][32] = v;
            }
            __syncwarp();
          }
          const int i = (step > 3 ? (step - 2) >> 1 : 0) + h;
          const int j = step - 2 * i;
          if (mode[step] >= 0) {
            // the context as words: I..L, A..D, E..H (the top-right, on
            // rows 0, 4, 8, 12 of the last column the copies), and X
            const int by = 4 * i, bx = 16 + 4 * j;  // row 0 of y is above
            const uint4 w = weights[16 * mode[step] + p];
            const int rv = res[4 * i + j][p];
            const uint32_t left = s.y[1 + by][bx - 1] |
                                  s.y[2 + by][bx - 1] << 8 |
                                  s.y[3 + by][bx - 1] << 16 |
                                  (uint32_t)s.y[4 + by][bx - 1] << 24;
            const uint32_t top = *(const uint32_t*)&s.y[by][bx];
            const uint32_t right = *(const uint32_t*)&s.y[by][bx + 4];
            const int X = s.y[by][bx - 1];
            const int sum = (int)__dp4a(
                left, w.x, __dp4a(top, w.y, __dp4a(right, w.z,
                                                   X * w.w + 4u)));
            const int tm = clip255((int)((top >> (8 * px)) & 255) +
                                   (int)((left >> (8 * py)) & 255) - X);
            s.y[1 + by + py][bx + px] =
                clip255((mode[step] == 1 ? tm : sum >> 3) + rv);
          }
          __syncwarp();
        }
      }
      *(uint32_t*)&s.uv[cp][1 + cy][8 + cx] = chroma;
      __syncwarp();
      // the planes, before the count: the next row reads them there
      store_macroblock(s, y_plane, u_plane, v_plane, r, c, W, Wc, lane);
#endif
      // the count, and that the residuals' slot is free again
#ifndef VP8_WORK_ONLY
#ifndef VP8_HANDOFF_ONLY
      link.publish(c, &s.used, m + 1);
#else
      link.publish(c);
#endif
#else
      __syncwarp();
      if (lane == 0) st_release_cta(&s.used, m + 1);
#endif
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

// one line across the edge between v[P - 1] and v[P], where `on`: KIND 6
// a macroblock edge (FilterLoop26), 4 an inner edge (FilterLoop24), 2 the
// simple filter; thresh2 = 2 x the edge limit + 1. Every lane computes
// every case and selects: no branch, no divergence.
template <int P, int KIND>
__device__ __forceinline__ void filter_at(int (&v)[20], bool on, int thresh2,
                                          int ilevel, int hev_thresh) {
  const int p3 = v[P - 4], p2 = v[P - 3], p1 = v[P - 2], p0 = v[P - 1];
  const int q0 = v[P], q1 = v[P + 1], q2 = v[P + 2], q3 = v[P + 3];
  const int d_p = iabs(p1 - p0), d_q = iabs(q1 - q0);
  on = on && 4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2;
  bool hev = true;
  if (KIND != 2) {
    const int interior = max(max(max(iabs(p3 - p2), iabs(p2 - p1)), d_p),
                             max(max(iabs(q3 - q2), iabs(q2 - q1)), d_q));
    on = on && interior <= ilevel;
    hev = max(d_p, d_q) > hev_thresh;
  }
  // DoFilter2
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int n_p2 = p2, n_p1 = p1, n_q1 = q1, n_q2 = q2;
  int n_p0 = clip255(p0 + sclip2((a + 3) >> 3));
  int n_q0 = clip255(q0 - sclip2((a + 4) >> 3));
  if (KIND == 4) {  // DoFilter4 where not hev
    const int b = 3 * (q0 - p0);
    const int b1 = sclip2((b + 4) >> 3), b2 = sclip2((b + 3) >> 3);
    const int b3 = (b1 + 1) >> 1;
    n_p1 = hev ? n_p1 : clip255(p1 + b3);
    n_p0 = hev ? n_p0 : clip255(p0 + b2);
    n_q0 = hev ? n_q0 : clip255(q0 - b1);
    n_q1 = hev ? n_q1 : clip255(q1 - b3);
  }
  if (KIND == 6) {  // DoFilter6 where not hev
    const int b = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int b1 = (27 * b + 63) >> 7, b2 = (18 * b + 63) >> 7;
    const int b3 = (9 * b + 63) >> 7;
    n_p2 = hev ? n_p2 : clip255(p2 + b3);
    n_p1 = hev ? n_p1 : clip255(p1 + b2);
    n_p0 = hev ? n_p0 : clip255(p0 + b1);
    n_q0 = hev ? n_q0 : clip255(q0 - b1);
    n_q1 = hev ? n_q1 : clip255(q1 - b2);
    n_q2 = hev ? n_q2 : clip255(q2 - b3);
  }
  v[P - 3] = on ? n_p2 : p2;
  v[P - 2] = on ? n_p1 : p1;
  v[P - 1] = on ? n_p0 : p0;
  v[P] = on ? n_q0 : q0;
  v[P + 1] = on ? n_q1 : q1;
  v[P + 2] = on ? n_q2 : q2;
}

// a lane's line through the macroblock, 4 samples before it (v[4] the
// first of the macroblock): the edge at 0 (`first`: the macroblock edge)
// and, with `inner`, those at 4 and (luma) 8 and 12, in order; NORMAL the
// normal filter, else the simple one
template <bool NORMAL>
__device__ __forceinline__ void filter_line(int (&v)[20], bool first,
                                            bool inner, bool luma, int limit,
                                            int ilevel, int hev) {
  constexpr int kEdge = NORMAL ? 6 : 2, kInner = NORMAL ? 4 : 2;
  const int mb_thresh = 2 * (limit + 4) + 1, thresh = 2 * limit + 1;
  if (first) filter_at<4, kEdge>(v, true, mb_thresh, ilevel, hev);
  if (inner) {  // first and inner are the warp's, luma a lane's
    filter_at<8, kInner>(v, true, thresh, ilevel, hev);
    filter_at<12, kInner>(v, luma, thresh, ilevel, hev);
    filter_at<16, kInner>(v, luma, thresh, ilevel, hev);
  }
}

__device__ __forceinline__ void load_line(int (&v)[20], const uint8_t* p,
                                          int step, int n) {
#pragma unroll
  for (int i = 0; i < 20; ++i)
    if (i < n) v[i] = p[i * step];
}

__device__ __forceinline__ void store_line(const int (&v)[20], uint8_t* p,
                                           int step, int n) {
#pragma unroll
  for (int i = 1; i < 20; ++i)
    if (i < n) p[i * step] = (uint8_t)v[i];
}

// a warp's shared memory in W2: the macroblock with 4 rows above and 4
// columns to the left
struct alignas(16) W2Warp {
  uint8_t y[20][32];      // rows -4..15; cols -4..15 at 12..31
  uint8_t uv[2][12][16];  // rows -4..7; cols -4..7 at 4..15
};
constexpr int kW2Head = kMaxRows * 4;  // counts

__global__ void __launch_bounds__(32 * kMaxRows)
    vp8_filter(uint8_t* y_plane, uint8_t* u_plane, uint8_t* v_plane,
               const uint8_t* __restrict__ filters, int* progress, int mb_w,
               int mb_h, int filter_type) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* done = (int*)smem;
  W2Warp& s = ((W2Warp*)(smem + kW2Head))[warp];
  const int stride = warps * gridDim.x;
  if (threadIdx.x < kMaxRows) done[threadIdx.x] = 0;
  __syncthreads();
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  const bool normal = filter_type == 2;
  // this lane's line: luma row / column `lane` (lanes 0-15), U (16-23) or
  // V (24-31) row / column lane & 7; chroma lines filter only when normal
  const bool luma = lane < 16;
  const int p = (lane >> 3) & 1, line = luma ? lane : lane & 7;
  const int size = luma ? 16 : 8, pitch = luma ? W : Wc;
  uint8_t* plane = luma ? y_plane : p ? v_plane : u_plane;
  uint8_t* row = luma ? &s.y[4 + lane][12] : &s.uv[p][4 + line][4];
  uint8_t* col = luma ? &s.y[0][16 + lane] : &s.uv[p][0][8 + line];
  const int n = luma ? 20 : 12, col_step = luma ? 32 : 16;
  const bool active = luma || normal;
  int r = blockIdx.x * warps + warp;
  uint4 next = make_uint4(0, 0, 0, 0);
  uint32_t next_f = 0;
  // this lane's row of macroblock (r, c) and the macroblock's filter bytes
  auto fetch = [&](int fr, int fc) {
    const uint8_t* src = plane + (long)(size * fr + line) * pitch + size * fc;
    if (luma) {
      next = *(const uint4*)src;
    } else {
      const uint2 h = *(const uint2*)src;
      next = make_uint4(h.x, h.y, 0, 0);
    }
    next_f = *(const uint32_t*)(filters + ((long)fr * mb_w + fc) * 4);
  };
#ifndef VP8_HANDOFF_ONLY
  if (r < mb_h) fetch(r, 0);
#endif
  for (; r < mb_h; r += stride) {
    const RowLink link(progress, done, r, warps, mb_w, mb_h);
    const bool far = link.above_far;
    for (int c = 0; c < mb_w; ++c) {
#ifndef VP8_HANDOFF_ONLY
      const uint4 cur = next;
      const uint32_t f = next_f;
      {
        int nr = r, nc = c + 1;
        if (nc == mb_w) {
          nr += stride;
          nc = 0;
        }
        if (nr < mb_h) fetch(nr, nc);
      }
      const int limit = f & 255, ilevel = (f >> 8) & 255;
      const int hev = (f >> 16) & 255;
      const bool inner = (f >> 24) != 0, on = limit > 0;
      // the left margin (the previous macroblock's last 4 columns), then
      // this macroblock's samples
      uint32_t* words = (uint32_t*)row;
      if (luma) {
        words[0] = words[4];
        *(uint4*)(row + 4) = cur;
      } else {
        words[0] = words[2];
        *(uint2*)(row + 4) = make_uint2(cur.x, cur.y);
      }
      int v[20];
      if (on && active) {  // the vertical edges: a lane a row
        load_line(v, row, 1, n);
        if (normal) {
          filter_line<true>(v, c > 0, inner, luma, limit, ilevel, hev);
        } else {
          filter_line<false>(v, c > 0, inner, luma, limit, ilevel, hev);
        }
        store_line(v, row, 1, n);
      }
#endif
#ifndef VP8_WORK_ONLY
      link.wait(c + 2 < mb_w ? c + 2 : mb_w);
#endif
#ifndef VP8_HANDOFF_ONLY
      if (on) {
        // the 4 rows above, 8 bytes a lane by one load: lanes 0-7 Y's
        // (row lane / 2, half lane % 2), 8-15 U's and V's (normal filter)
        if (r > 0 && lane < (normal ? 16 : 8)) {
          const int q = lane < 8 ? 0 : lane < 12 ? 1 : 2;
          const int k = q == 0 ? lane >> 1 : lane & 3;
          const int half = q == 0 ? lane & 1 : 0;
          const int qs = q == 0 ? 16 : 8, qpitch = q == 0 ? W : Wc;
          const uint8_t* src = (q == 0 ? y_plane : q == 1 ? u_plane : v_plane) +
                               (long)(qs * r - 4 + k) * qpitch;
          *(uint2*)((q == 0 ? &s.y[k][16] : &s.uv[q - 1][k][8]) + 8 * half) =
              ld_pair(src + qs * c + 8 * half, far);
        }
        __syncwarp();
        if (active) {  // the horizontal edges: a lane a column
          load_line(v, col, col_step, n);
          if (normal) {
            filter_line<true>(v, r > 0, inner, luma, limit, ilevel, hev);
          } else {
            filter_line<false>(v, r > 0, inner, luma, limit, ilevel, hev);
          }
          store_line(v, col, col_step, n);
        }
        __syncwarp();
        // back to the planes: the macroblock's rows with the 4 columns to
        // the left, then the 3 rows above it that the top edge changed
        if (active) {
          uint8_t* dst = plane + (long)(size * r + line) * pitch + size * c;
          if (c > 0) *(uint32_t*)(dst - 4) = *(const uint32_t*)row;
          if (luma) {
            *(uint4*)dst = *(const uint4*)(row + 4);
          } else {
            *(uint2*)dst = *(const uint2*)(row + 4);
          }
        }
        if (r > 0 && lane < (normal ? 9 : 3)) {
          const int q = lane < 3 ? 0 : 1 + (lane - 3) / 3;  // Y, U, V
          const int y = (lane < 3 ? lane : (lane - 3) % 3) - 3;
          if (q == 0) {
            *(uint4*)(y_plane + (long)(16 * r + y) * W + 16 * c) =
                *(const uint4*)&s.y[4 + y][16];
          } else {
            uint8_t* cp = q == 2 ? v_plane : u_plane;
            *(uint2*)(cp + (long)(8 * r + y) * Wc + 8 * c) =
                *(const uint2*)&s.uv[q - 1][4 + y][8];
          }
        }
      }
#endif
#ifndef VP8_WORK_ONLY
      link.publish(c);
#else
      __syncwarp();
#endif
    }
  }
}

// ---------------------------------------------------------------- W3 --
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// a band's shared memory (ops/webp.py's colour_smem): `rows` Y rows, the
// rows / 2 + 2 U and V rows they read, then the band's output bytes from
// its first byte's 16-byte residue on
struct ColourLayout {
  int y_pitch, c_pitch, c_rows, u_off, v_off, out_off, bytes;
  __host__ __device__ ColourLayout(int rows, int width, int channels)
      : y_pitch(round16(width)),
        c_pitch(round16((width + 1) / 2)),
        c_rows(rows / 2 + 2),
        u_off(rows * y_pitch),
        v_off(u_off + c_rows * c_pitch),
        out_off(v_off + c_rows * c_pitch),
        bytes(out_off + round16(rows * width * channels + 15)) {}
};

// libwebp's VP8Clip8 of a 6-bit fixed-point value
__device__ __forceinline__ int clip8(int v) {
  return __vimin_s32_relu(v, 16383) >> 6;
}

// the fancy upsampler on U and V at once, packed u | v << 16 (libwebp's
// trick): (((nn + 3 nf + 3 fn + ff + 8) >> 3) + nn) >> 1 in each half,
// and the edge columns' (3 nn + fn + 2) >> 2; every sum stays below 2^16,
// the bits a shift carries down from the high half are masked or land
// above the low byte
__device__ __forceinline__ uint32_t fancy(uint32_t nn, uint32_t nf,
                                          uint32_t fn, uint32_t ff) {
  const uint32_t t = ((nn + 3 * nf + 3 * fn + ff + 0x00080008u) >> 3) &
                     0x01ff01ffu;
  return (t + nn) >> 1;
}

__device__ __forceinline__ uint32_t edge(uint32_t nn, uint32_t fn) {
  return (3 * nn + fn + 0x00020002u) >> 2;
}

// a chroma row's columns j0 - 1 .. j0 + 4 (clamped to the row) of U and V,
// packed: one word of each plane and two bytes
__device__ __forceinline__ void chroma6(const uint8_t* u, const uint8_t* v,
                                        int j0, int jl, int jr,
                                        uint32_t (&c)[6]) {
  const uint32_t uw = *(const uint32_t*)(u + j0);
  const uint32_t vw = *(const uint32_t*)(v + j0);
  c[0] = u[jl] | (uint32_t)v[jl] << 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[1 + i] = __byte_perm(uw, vw, 0x0400 | (0x0101 * i)) & 0x00ff00ffu;
  }
  c[5] = u[jr] | (uint32_t)v[jr] << 16;
}

// a band in shared memory and where its rows come from
struct ColourBand {
  const uint8_t *y_plane, *u_plane, *v_plane;
  int W, Wc, width, y0, n, c0, c1, uw, uh;
  int yb, cb, piece_y, piece_c;  // a Y / chroma row's bytes staged, pieces
  uint8_t *sy, *su, *sv, *so;
};

// the band's Y rows and the chroma rows they read into shared memory, a
// warp a row: cp.async in pieces of 16, 8 or 4 bytes, plain loads where
// the planes allow no piece of 4
__device__ __forceinline__ void stage(const ColourBand& b,
                                      const ColourLayout& L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ny = b.n, nc = b.c1 - b.c0 + 1;
  for (int k = warp; k < ny + 2 * nc; k += kColourThreads / 32) {
    uint8_t* d;
    const uint8_t* src;
    int size, piece;
    if (k < ny) {
      d = b.sy + k * L.y_pitch;
      src = b.y_plane + (long)(b.y0 + k) * b.W;
      size = b.yb;
      piece = b.piece_y;
    } else {
      const int q = k - ny < nc ? k - ny : k - ny - nc;
      d = (k - ny < nc ? b.su : b.sv) + q * L.c_pitch;
      src = (k - ny < nc ? b.u_plane : b.v_plane) + (long)(b.c0 + q) * b.Wc;
      size = b.cb;
      piece = b.piece_c;
    }
    for (int q = lane * piece; q < size; q += 32 * piece) {
      if (piece == 16) {
        cp_async16(d + q, src + q);
      } else if (piece == 8) {
        cp_async8(d + q, src + q);
      } else if (piece == 4) {
        cp_async4(d + q, src + q);
      } else {
        d[q] = src[q];
      }
    }
  }
}

// the band's rows from shared memory into its staged output: a thread's
// item is 8 adjacent samples of a row, x0 = 8 g .. x0 + 7, from chroma
// columns 4 g - 1 .. 4 g + 4; output columns 2 j and 2 j + 1 share chroma
// column j as their nearest
template <int channels>
__device__ __forceinline__ void colour_rows(const ColourBand& b,
                                            const ColourLayout& L, int mis) {
  const int width = b.width;
  const int groups = (width + 7) >> 3;
  // the last column of an even width takes the edge rule, as the first
  const int last = (width & 1) ? -1 : width - 1;
  // items tid, tid + threads, ...: row and group stepped, no division
  const int dr = kColourThreads / groups, dg = kColourThreads - dr * groups;
  int r = (int)threadIdx.x / groups;
  int g = (int)threadIdx.x - r * groups;
  while (r < b.n) {
    const int y = b.y0 + r, nr = y >> 1;
    const int fr = min(max((y & 1) ? nr + 1 : nr - 1, 0), b.uh - 1);
    const int j0 = 4 * g, jl = max(j0 - 1, 0), jr = min(j0 + 4, b.uw - 1);
    uint32_t nc[6], fc[6];
    chroma6(b.su + (nr - b.c0) * L.c_pitch, b.sv + (nr - b.c0) * L.c_pitch,
            j0, jl, jr, nc);
    chroma6(b.su + (fr - b.c0) * L.c_pitch, b.sv + (fr - b.c0) * L.c_pitch,
            j0, jl, jr, fc);
    const uint2 yw = *(const uint2*)(b.sy + r * L.y_pitch + 8 * g);
    const int x0 = 8 * g;
    uint32_t uv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uv[2 * i] = fancy(nc[1 + i], nc[i], fc[1 + i], fc[i]);
      uv[2 * i + 1] = fancy(nc[1 + i], nc[2 + i], fc[1 + i], fc[2 + i]);
    }
    if (g == 0) uv[0] = edge(nc[1], fc[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (x0 + 2 * i + 1 == last) uv[2 * i + 1] = edge(nc[1 + i], fc[1 + i]);
    }
    uint32_t w[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      // (x * c) >> 8 of a byte x as the high word of (x << 24) * c
      const uint32_t y24 =
          __byte_perm(s < 4 ? yw.x : yw.y, 0, 0x0444 | ((s & 3) << 12));
      const uint32_t u24 = uv[s] << 24, v24 = (uv[s] << 8) & 0xff000000u;
      const int yy = (int)__umulhi(y24, 19077);
      const int R = clip8(yy + (int)__umulhi(v24, 26149) - 14234);
      const int G = clip8(yy - (int)__umulhi(u24, 6419) -
                          (int)__umulhi(v24, 13320) + 8708);
      const int B = clip8(yy + (int)__umulhi(u24, 33050) - 17685);
      if (channels == 1) {
        w[s >> 2] |= (uint32_t)((R * 4899 + G * 9617 + B * 1868 + 8192) >> 14)
                     << (8 * (s & 3));
      } else {
        w[(3 * s) >> 2] |= (uint32_t)R << (8 * ((3 * s) & 3));
        w[(3 * s + 1) >> 2] |= (uint32_t)G << (8 * ((3 * s + 1) & 3));
        w[(3 * s + 2) >> 2] |= (uint32_t)B << (8 * ((3 * s + 2) & 3));
      }
    }
    // into the staged band: whole words where the item is whole and its
    // bytes fall on a word, else byte by byte
    const int off = (r * width + x0) * channels;
    uint8_t* p = b.so + off;
    const int nb = min(8, width - x0) * channels;
    const int a = (mis + off) & 7;
    if (nb == 8 * channels && a == 0) {
      *(uint2*)p = make_uint2(w[0], w[1]);
      if (channels == 3) {
        *(uint2*)(p + 8) = make_uint2(w[2], w[3]);
        *(uint2*)(p + 16) = make_uint2(w[4], w[5]);
      }
    } else if (nb == 8 * channels && (a & 3) == 0) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        if (q < 2 * channels) *(uint32_t*)(p + 4 * q) = w[q];
      }
    } else {
#pragma unroll
      for (int q = 0; q < 24; ++q) {
        if (q < nb) p[q] = (uint8_t)(w[q >> 2] >> (8 * (q & 3)));
      }
    }
    g += dg;
    r += dr;
    if (g >= groups) {
      g -= groups;
      ++r;
    }
  }
}

// the band's bytes out of the staged band: the ragged head byte by byte,
// 16-byte stores from the first 16-byte-aligned address to the last, the
// ragged tail byte by byte
__device__ __forceinline__ void write_out(uint8_t* dst, const uint8_t* so,
                                          int mis, int bytes) {
  const int head = min((16 - mis) & 15, bytes);
  const int words = (bytes - head) >> 4, tail = head + 16 * words;
#ifdef VP8_COLOUR_NO_STORE
  if (bytes > 0) return;  // always: built, never run
#endif
  for (int k = threadIdx.x; k < words; k += kColourThreads) {
#ifdef VP8_COLOUR_NO_LOAD
    *(uint4*)(dst + head + 16 * k) = make_uint4(k, bytes, k ^ bytes, head);
#else
    *(uint4*)(dst + head + 16 * k) = *(const uint4*)(so + head + 16 * k);
#endif
  }
  const int t = threadIdx.x;
  if (t < head + (bytes - tail)) {
    const int i = t < head ? t : tail + t - head;
#ifdef VP8_COLOUR_NO_LOAD
    dst[i] = (uint8_t)(i + bytes);
#else
    dst[i] = so[i];
#endif
  }
}

template <int channels>
__global__ void __launch_bounds__(kColourThreads)
    vp8_colour(const uint8_t* __restrict__ y_plane,
               const uint8_t* __restrict__ u_plane,
               const uint8_t* __restrict__ v_plane,
               uint8_t* __restrict__ out, int width, int height, int W,
               int Wc, int rows, int piece_y, int piece_c) {
#ifdef VP8_COLOUR_EMPTY
  return;
#endif
  extern __shared__ __align__(16) uint8_t smem[];
  const ColourLayout L(rows, width, channels);
  ColourBand b;
  b.y_plane = y_plane;
  b.u_plane = u_plane;
  b.v_plane = v_plane;
  b.W = W;
  b.Wc = Wc;
  b.width = width;
  b.y0 = blockIdx.x * rows;
  b.n = min(rows, height - b.y0);  // the band's rows
  b.uw = (width + 1) >> 1;
  b.uh = (height + 1) >> 1;
  // the chroma rows the band reads, clamped as the twin clamps them
  b.c0 = max((b.y0 >> 1) - 1, 0);
  b.c1 = min(((b.y0 + b.n - 1) >> 1) + 1, b.uh - 1);
  b.piece_y = piece_y;
  b.piece_c = piece_c;
  b.yb = (width + piece_y - 1) / piece_y * piece_y;
  b.cb = (b.uw + piece_c - 1) / piece_c * piece_c;
  b.sy = smem;
  b.su = smem + L.u_off;
  b.sv = smem + L.v_off;
  const int bytes = b.n * width * channels;
  uint8_t* dst = out + (long)b.y0 * width * channels;
  const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  // the staged output: byte i of the band at smem[out_off + mis + i], so
  // that a 16-byte-aligned address of the band is one in shared memory
  b.so = smem + L.out_off + mis;
#ifndef VP8_COLOUR_NO_LOAD
  stage(b, L);
  cp_async_wait_all();
  __syncthreads();
  colour_rows<channels>(b, L, mis);
  __syncthreads();
#endif
  write_out(dst, b.so, mis, bytes);
}

// the plan's CTAs must all be resident at once: row r waits on row r - 1,
// which may run on any other CTA of the grid. Returns the launch's shared
// memory.
template <typename Kernel>
cudaError_t plan_launch(Kernel kernel, int rows, int ctas, int threads,
                        int head, int row_bytes, int& smem) {
  if (rows < 1 || rows > kMaxRows || ctas < 1) return cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  smem = head + rows * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  return ctas <= sms * per_sm ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// W1: coeffs (MBs, 25, 16) int16 and modes (MBs, 20) uint8 on the card ->
// the unfiltered planes (16 mb_h x 16 mb_w luma, 8 mb_h x 8 mb_w chroma);
// progress: mb_h int32 zeros; the plan (ops/webp.py's vp8_launch_plan):
// `rows` rows a CTA, `ctas` CTAs.
extern "C" int vp8_reconstruct_launch(const int16_t* coeffs,
                                      const uint8_t* modes, uint8_t* y,
                                      uint8_t* u, uint8_t* v, int* progress,
                                      int mb_w, int mb_h, int rows, int ctas,
                                      cudaStream_t stream) {
  int smem = 0;
  const cudaError_t err =
      plan_launch(vp8_reconstruct, rows, ctas, 64 * rows, kW1Head,
                  (int)sizeof(W1Row), smem);
  if (err != cudaSuccess) return (int)err;
  vp8_reconstruct<<<ctas, 64 * rows, smem, stream>>>(
      coeffs, modes, y, u, v, progress, mb_w, mb_h);
  return (int)cudaGetLastError();
}

// W2: the loop filter in place; filters (MBs, 4) uint8; filter_type 1
// simple, 2 normal; progress: mb_h int32 zeros; the plan as W1's.
extern "C" int vp8_filter_launch(uint8_t* y, uint8_t* u, uint8_t* v,
                                 const uint8_t* filters, int* progress,
                                 int mb_w, int mb_h, int filter_type,
                                 int rows, int ctas, cudaStream_t stream) {
  int smem = 0;
  const cudaError_t err =
      plan_launch(vp8_filter, rows, ctas, 32 * rows, kW2Head,
                  (int)sizeof(W2Warp), smem);
  if (err != cudaSuccess) return (int)err;
  vp8_filter<<<ctas, 32 * rows, smem, stream>>>(
      y, u, v, filters, progress, mb_w, mb_h, filter_type);
  return (int)cudaGetLastError();
}

// the largest cp.async piece (16, 8 or 4 bytes; else 1: plain loads) that
// every row of a plane at `p`, `pitch` bytes apart, starts on
static int piece_of(const void* p, int pitch) {
  const unsigned a = (unsigned)(reinterpret_cast<uintptr_t>(p) | pitch);
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 1;
}

// W3: the filtered planes -> out, height x width x 3 RGB or height x
// width grey (channels 1); a CTA a band of `rows` output rows (even; ops/
// webp.py's vp8_colour_plan). A band whose shared memory the card cannot
// give is refused.
extern "C" int vp8_colour_launch(const uint8_t* y, const uint8_t* u,
                                 const uint8_t* v, uint8_t* out, int width,
                                 int height, int mb_w, int channels, int rows,
                                 cudaStream_t stream) {
  if (rows < 2 || (rows & 1) || rows > 16384 || width < 1 || height < 1 ||
      (channels != 1 && channels != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = ColourLayout(rows, width, channels).bytes;
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > limit) return (int)cudaErrorInvalidConfiguration;
  const auto kernel = channels == 1 ? vp8_colour<1> : vp8_colour<3>;
  // above the 48 KB any kernel may take, once for each build of the kernel
  static int granted[2] = {48 << 10, 48 << 10};
  int& mine = granted[channels == 1 ? 0 : 1];
  if (smem > mine) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    mine = smem;
  }
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  const int pu = piece_of(u, Wc), pv = piece_of(v, Wc);
  kernel<<<(height + rows - 1) / rows, kColourThreads, smem, stream>>>(
      y, u, v, out, width, height, W, Wc, rows, piece_of(y, W),
      pu < pv ? pu : pv);
  return (int)cudaGetLastError();
}
