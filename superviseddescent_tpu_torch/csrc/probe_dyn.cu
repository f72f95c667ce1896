// P5: the dynamic-indexing probes, two small kernels (C and C4 share one).
//
// Replaces scripts/probe_dyn.py::probe_abde (kernel_abde), probe_c
// (kernel_c) and probe_c4 (kernel_c4), which asked the TPU compiler for
// dynamic first-axis loads, dynamic aligned sub-slices, dynamic stores and a
// slice offset derived from a loaded value. On this card each is an indexed
// access; the probes' worth here is that they compute the same numbers. See
// probes/dyn.py for the contracts and the plain PyTorch twins. What bounds
// them: nothing of the card's (a few hundred KB and MFLOP); their time is
// the launch and, for ABDE, one chain of dependent tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAbdeMaxWarps = 16;  // landmarks of a block in flight
constexpr int kAbdeMaxRows = 128;  // sub-window rows a warp holds: q's
                                   // fragments of the second product
constexpr int kAbdePad = 8;        // bf16 after each staged sub-window row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// d += a . b on the tensor cores: a 16 x 16 bf16 tile (row-major
// fragment), b 16 x 8 (column-major), float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(src));
}

// Shared memory of an ABDE block of `warps` warps (probes/dyn.py::
// abde_shared_bytes): each warp's staged (rows, WX + 8) slice of its
// sub-window, then each warp's S column sums.
__host__ __device__ inline size_t abde_slice_bytes(int rows, int wx) {
  return (size_t)rows * (wx + kAbdePad) * 2;
}
__host__ __device__ inline size_t abde_bytes(int s, int wx, int warps,
                                             int rows) {
  return (size_t)warps * (abde_slice_bytes(rows, wx) + (size_t)s * 4);
}

// ABDE: one block per face, its landmarks side by side, one warp each
// (warp k takes landmarks k, k + warps, ...), no block barrier. For a
// landmark lm: the scalars x[g, lm] (column) and x[g, lm + L] (row),
// truncated to int, clamped and floored to an (8, 128)-aligned origin; its
// (W, WX) sub-window staged in shared memory `rows` rows at a time (all of
// it at once where W <= rows), by 16-byte cp.async copies where the rows
// lie on 16-byte boundaries (rows padded by 16 bytes, so that the fragment
// reads below fall on 32 banks); q = tx . subT and patch = bf16(q) . tyT on
// the tensor cores (m16n8k16, bf16 in, float32 sums) with the constant bf16
// tents of 0.01 as fragments in registers; q rounded to bf16 goes from the
// first product's accumulators straight into the second's A fragments; the
// (S, SEG) patch rounded to bf16. The first S columns of every landmark's
// patch lie side by side as (S, L*S) and the column sums of the first 2L
// leave: column lm*S + c is the sum of the landmark's column c, so each
// warp sums its own columns over the rows (within each fragment, across the
// lanes of a column, then across row tiles) and writes them. Every
// landmark's sub-window is read and its q formed, as in the TPU kernel;
// the second product runs for the patch columns that leave, cols =
// min(S, 2L - lm*S) of them, four n-tiles (32 columns) a pass. Where W >
// rows, the second product's sum over W runs slice by slice in the same
// accumulators, each slice staged again for each pass.
__global__ void __launch_bounds__(kAbdeMaxWarps * 32)
probe_abde_kernel(const float* __restrict__ x,
                  const __nv_bfloat16* __restrict__ win,
                  float* __restrict__ out, int ry, int rx, int s, int w,
                  int wx, int l, int rows, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.x;
  const int pitch = wx + kAbdePad;
  __nv_bfloat16* sub = reinterpret_cast<__nv_bfloat16*>(
      smem + warp * abde_slice_bytes(rows, wx));
  float* colsum = reinterpret_cast<float*>(
                      smem + warps * abde_slice_bytes(rows, wx)) +
                  warp * s;
  const uint32_t tent =
      (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(0.01f)) * 0x10001u;
  const uint32_t a_tent[4] = {tent, tent, tent, tent};
  const float* row = x + (int64_t)g * 2 * l;
  const int chunks = wx / 8;  // 16-byte words of a sub-window row

  for (int lm = warp; lm < l; lm += warps) {
    const int oy = min(max((int)row[lm + l], 0), ry - w) / 8 * 8;
    const int ox = min(max((int)row[lm], 0), rx - wx) / 128 * 128;
    const __nv_bfloat16* src = win + ((int64_t)g * ry + oy) * rx + ox;
    // output columns lm * S + c, c < cols
    const int cols = min(s, max(0, 2 * l - lm * s));
    for (int c = lane; c < cols; c += 32) colsum[c] = 0.f;
    // sub-window rows r0 .. r0 + nr - 1 into the warp's slice
    auto stage = [&](int r0, int nr) {
      __syncwarp();  // every lane is done with the slice before
      if (aligned) {
        for (int c = lane; c < nr * chunks; c += 32) {
          const int r = c / chunks, k = c - r * chunks;
          cp_async16(sub + r * pitch + k * 8,
                     src + (int64_t)(r0 + r) * rx + k * 8);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      } else {
        for (int c = lane; c < nr * wx; c += 32) {
          const int r = c / wx, k = c - r * wx;
          sub[r * pitch + k] = src[(int64_t)(r0 + r) * rx + k];
        }
      }
      __syncwarp();
    };
    // q for patch rows m0..m0+15 and the nr staged sub-window rows, 16 of
    // them (two n-tiles) a step, as the A fragments of the second
    // product's k-steps (rows past nr give q = 0)
    uint32_t qa[kAbdeMaxRows / 16][4];
    auto q_frags = [&](int nr) {
#pragma unroll
      for (int kk = 0; kk < kAbdeMaxRows / 16; ++kk) {
        if (kk * 16 < nr) {
          float acc[2][4] = {};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n0 = kk * 16 + h * 8;  // staged row of the n-tile
            if (n0 < nr) {
              const __nv_bfloat16* b = sub + (n0 + gid) * pitch + tig * 2;
              for (int k0 = 0; k0 < wx; k0 += 16)
                mma_bf16(acc[h], a_tent,
                         *reinterpret_cast<const uint32_t*>(b + k0),
                         *reinterpret_cast<const uint32_t*>(b + k0 + 8));
            }
          }
          qa[kk][0] = pack_bf16(acc[0][0], acc[0][1]);  // row gid, k tig*2
          qa[kk][1] = pack_bf16(acc[0][2], acc[0][3]);  // row gid + 8
          qa[kk][2] = pack_bf16(acc[1][0], acc[1][1]);  // row gid, k + 8
          qa[kk][3] = pack_bf16(acc[1][2], acc[1][3]);  // row gid + 8, k + 8
        }
      }
    };
    const bool whole = w <= rows;  // the sub-window staged once
    if (whole) stage(0, w);
    for (int m0 = 0; m0 < s; m0 += 16) {
      if (whole) q_frags(w);
      int p0 = 0;
      do {
        // patch rows m0..m0+15, columns p0..p0+31 (the n-tiles below cols)
        float acc[4][4] = {};
        for (int r0 = 0; r0 < w; r0 += rows) {
          const int nr = min(rows, w - r0);
          if (!whole) {
            stage(r0, nr);
            q_frags(nr);
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (p0 + t * 8 < cols) {
#pragma unroll
              for (int kk = 0; kk < kAbdeMaxRows / 16; ++kk)
                if (kk * 16 < nr) mma_bf16(acc[t], qa[kk], tent, tent);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int n0 = p0 + t * 8;
          if (n0 >= cols) break;
          const bool lo = m0 + gid < s, hi = m0 + gid + 8 < s;
          float v0 = (lo ? round_bf16(acc[t][0]) : 0.f) +
                     (hi ? round_bf16(acc[t][2]) : 0.f);
          float v1 = (lo ? round_bf16(acc[t][1]) : 0.f) +
                     (hi ? round_bf16(acc[t][3]) : 0.f);
#pragma unroll
          for (int sh = 4; sh < 32; sh <<= 1) {
            v0 += __shfl_xor_sync(0xffffffffu, v0, sh);
            v1 += __shfl_xor_sync(0xffffffffu, v1, sh);
          }
          const int c = n0 + tig * 2;
          if (gid == 0) {
            if (c < cols) colsum[c] += v0;
            if (c + 1 < cols) colsum[c + 1] += v1;
          }
        }
        p0 += 32;
      } while (p0 < cols);
      __syncwarp();
    }
    for (int c = lane; c < cols; c += 32)
      out[(int64_t)g * 2 * l + lm * s + c] = colsum[c];
    __syncwarp();  // colsum and the slice are free for the next landmark
  }
}

// C and C4: for every face g < G and k in {0, 1}, rows v[0:4] + g + 10 k at
// rows k * G * BR + g * BR + [0, 4) of the (2 * G * BR, SEG) output, every
// other row zero. The TPU kernels stored the rows into a 2-D (C) or 4-D (C4)
// scratch and copied it out; the function is the same, so both entry points
// launch this kernel. Nothing is staged: each thread works out one 16-byte
// word of the output from its position alone (the row of its first value,
// and for each row which k, g and i it belongs to, a stored row or a zero
// row), reads the v values it needs (none for a zero row) and writes one
// float4; a scalar head reaches the first 16-byte boundary of `out` and a
// scalar tail ends it. No shared memory, no barrier. What bounds it: the
// launch (16 blocks write 32 KB at the probe script's shape).
constexpr int kCThreads = 128;

__device__ __forceinline__ float c_value(const float* __restrict__ v, int seg,
                                         int gb, int br, int row, int col) {
  const int k = row >= gb;  // row < 2 * G * BR
  const int r = row - k * gb;
  const int g = r / br;
  const int i = r - g * br;
  return i < 4 ? (v[i * seg + col] + (float)g) + 10.0f * (float)k : 0.f;
}

__global__ void __launch_bounds__(kCThreads)
probe_c_kernel(const float* __restrict__ v, float* __restrict__ out, int gb,
               int br, int seg, int head, long long words, int tail) {
  const long long t = (long long)blockIdx.x * kCThreads + threadIdx.x;
  if (t < words) {
    const long long e = head + 4 * t;  // the word's first value
    int row = (int)(e / seg);
    int col = (int)(e - (long long)row * seg);
    float q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = c_value(v, seg, gb, br, row, col);
      if (++col == seg) {
        col = 0;
        ++row;
      }
    }
    reinterpret_cast<float4*>(out + head)[t] =
        make_float4(q[0], q[1], q[2], q[3]);
  } else if (t < words + head + tail) {
    const long long j = t - words;
    const long long e = j < head ? j : 4 * words + j;
    const int row = (int)(e / seg);
    out[e] = c_value(v, seg, gb, br, row, (int)(e - (long long)row * seg));
  }
}

// Nothing: the device time of a launch that does no work, the floor under
// C and C4 (chip_smoke.py times it; no entry point launches it).
__global__ void __launch_bounds__(kThreads) probe_empty_kernel() {}

}  // namespace

extern "C" int probe_empty_launch(void* stream) {
  probe_empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// The contract (checked here, cudaErrorInvalidValue otherwise; probes/
// dyn.py::abde_check raises the same by name): S <= SEG, 2L <= L*S, W a
// multiple of 8 up to RY, WX a multiple of 128 up to RX. The plan
// (probes/dyn.py::abde_plan): 1 <= warps <= min(L, 16) landmarks in flight,
// a warp's slice of 8 to 128 sub-window rows (a multiple of 8), and the
// block's shared memory within what the card gives one block. Rows on
// 16-byte boundaries (RX a multiple of 8, win 16-byte aligned) are staged
// by cp.async, others value by value.
extern "C" int probe_abde_launch(const void* x, const void* win, void* out,
                                 int g, int ry, int rx, int s, int w, int wx,
                                 int l, int seg, int warps, int rows,
                                 void* stream) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = abde_bytes(s, wx, warps, rows);
  if (l < 1 || s > seg || 2 * l > l * s || w < 0 || w % 8 || w > ry ||
      wx < 0 || wx % 128 || wx > rx || warps < 1 ||
      warps > (l < kAbdeMaxWarps ? l : kAbdeMaxWarps) || rows < 8 ||
      rows % 8 || rows > kAbdeMaxRows || bytes > (size_t)most)
    return (int)cudaErrorInvalidValue;
  const int aligned =
      rx % 8 == 0 && reinterpret_cast<uintptr_t>(win) % 16 == 0;
  err = cudaFuncSetAttribute(probe_abde_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  probe_abde_kernel<<<g, warps * 32, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(win),
      static_cast<float*>(out), ry, rx, s, w, wx, l, rows, aligned);
  return (int)cudaGetLastError();
}

// The contract (checked here, cudaErrorInvalidValue otherwise; probes/
// dyn.py::c_check raises the same by name): G >= 1, BR >= 4, SEG >= 1 and
// 2 * G * BR * SEG within int32; v holds at least 4 rows of SEG values.
extern "C" int probe_c_launch(const void* v, void* out, int g, int br,
                              int seg, void* stream) {
  const long long n = 2LL * g * br * seg;
  if (g < 1 || br < 4 || seg < 1 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // values before the first 16-byte boundary of out (out is float-aligned)
  const int lead =
      (int)((16 - reinterpret_cast<uintptr_t>(out) % 16) % 16 / 4);
  const int head = lead < n ? lead : (int)n;
  const long long words = (n - head) / 4;
  const int tail = (int)(n - head - 4 * words);
  const long long items = words + head + tail;
  probe_c_kernel<<<(unsigned)((items + kCThreads - 1) / kCThreads), kCThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(out), g * br, br, seg,
      head, words, tail);
  return (int)cudaGetLastError();
}
