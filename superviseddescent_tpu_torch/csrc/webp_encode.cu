// Lossy WebP writing on the host, as PIL 12.1 writes it: libwebp 1.6.0's
// VP8 encoder at PIL's settings (quality 80, method 4, 4 segments,
// sns_strength 50, filter_strength 60, sharpness 0, one partition).
//
// No TPU kernel is replaced: the JAX package writes images with PIL on the
// host (superviseddescent_tpu/apps/rcr_detect.py saves its drawing through
// Image.save). The plain twin is io/vp8_write.py, and this file follows it
// function for function: the RGB -> YUV 4:2:0 conversion with libwebp's
// gamma-compressed chroma average; the analysis (DC / TM histograms ->
// alpha, k-means into segments); the segment quantisers, filter strengths
// and matrices; the macroblock loop at RD_OPT_BASIC (16x16, 4x4 and chroma
// modes by distortion plus lambda times rate, the chroma DC error
// diffusion, the level costs refreshed from the token statistics); the
// token statistics -> probabilities; the filter adjustment; the boolean
// coder and the RIFF container. Host code only, with a plain C interface:
// nvcc builds it with the kernels (ops/_build.py), and g++ builds the same
// file.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8_enc_tables.h"
#include "vp8_tables.h"

namespace {

using vp8::kCoeffsProba0;
using vp8::kCoeffsUpdateProba;
using vp8::kZigzag;
using namespace vp8enc;

constexpr int kQuality = 80, kSns = 50, kFilterStrength = 60;
constexpr int kSharpness = 0, kSegments = 4;
constexpr int kMaxAlpha = 255, kAlphaScale = 510, kMaxCoeffThresh = 31;
constexpr int kQfix = 17, kMaxLevel = 2047, kMaxVariableLevel = 67;
constexpr int kFlatPenalty = 140, kMinCount = 96, kAnalysisModes = 2;
constexpr int kNumProbas = 11;
constexpr int64_t kMaxCost = (int64_t)1 << 62;
enum { kErrTooLarge = -1, kErrOutput = -2 };

inline int clip(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// ---------------------------------------------------------------- dsp
void ftransform(const int* src, const int* ref, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int d0 = src[4 * i] - ref[4 * i];
    const int d1 = src[4 * i + 1] - ref[4 * i + 1];
    const int d2 = src[4 * i + 2] - ref[4 * i + 2];
    const int d3 = src[4 * i + 3] - ref[4 * i + 3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[4 * i] = (a0 + a1) * 8;
    tmp[4 * i + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[4 * i + 2] = (a0 - a1) * 8;
    tmp[4 * i + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[i] - tmp[12 + i];
    out[i] = (a0 + a1 + 7) >> 4;
    out[4 + i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0);
    out[8 + i] = (a0 - a1 + 7) >> 4;
    out[12 + i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
  }
}

void fwht(const int* dcs, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int b0 = dcs[4 * i], b1 = dcs[4 * i + 1], b2 = dcs[4 * i + 2];
    const int b3 = dcs[4 * i + 3];
    const int a0 = b0 + b2, a1 = b1 + b3, a2 = b1 - b3, a3 = b0 - b2;
    tmp[4 * i] = a0 + a1;
    tmp[4 * i + 1] = a3 + a2;
    tmp[4 * i + 2] = a3 - a2;
    tmp[4 * i + 3] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[i] - tmp[8 + i];
    out[i] = (a0 + a1) >> 1;
    out[4 + i] = (a3 + a2) >> 1;
    out[8 + i] = (a3 - a2) >> 1;
    out[12 + i] = (a0 - a1) >> 1;
  }
}

// libwebp's TransformWHT: the Y2 block -> the 16 blocks' DCs (int16)
void iwht(const int* in, int* out) {
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
    out[4 * i] = (int16_t)((a0 + a1) >> 3);
    out[4 * i + 1] = (int16_t)((a3 + a2) >> 3);
    out[4 * i + 2] = (int16_t)((a0 - a1) >> 3);
    out[4 * i + 3] = (int16_t)((a3 - a2) >> 3);
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void itransform(const int* ref, const int* in, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    const int v[4] = {a + d, b + c, b - c, a - d};
    for (int x = 0; x < 4; ++x)
      out[4 * i + x] = clip(ref[4 * i + x] + (v[x] >> 3), 0, 255);
  }
}

int sse16(const int* a, const int* b) {
  int s = 0;
  for (int i = 0; i < 16; ++i) s += (a[i] - b[i]) * (a[i] - b[i]);
  return s;
}

int ttransform(const int* in, const uint16_t* w) {
  int tmp[16], sum = 0;
  for (int i = 0; i < 4; ++i) {
    const int* r = in + 4 * i;
    const int a0 = r[0] + r[2], a1 = r[1] + r[3];
    const int a2 = r[1] - r[3], a3 = r[0] - r[2];
    tmp[4 * i] = a0 + a1;
    tmp[4 * i + 1] = a3 + a2;
    tmp[4 * i + 2] = a3 - a2;
    tmp[4 * i + 3] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[i] - tmp[8 + i];
    sum += w[i] * std::abs(a0 + a1) + w[4 + i] * std::abs(a3 + a2) +
           w[8 + i] * std::abs(a3 - a2) + w[12 + i] * std::abs(a0 - a1);
  }
  return sum;
}

int tdisto(const int* a, const int* b) {
  return std::abs(ttransform(b, kWeightY) - ttransform(a, kWeightY)) >> 5;
}

inline int mult_8b(int a, int b) { return (a * b + 128) >> 8; }

struct Matrix {
  int q[16], iq[16], bias[16], zthresh[16], sharpen[16];
  int average;
  void init(int q_dc, int q_ac, int kind) {
    int sum = 0;
    for (int i = 0; i < 16; ++i) {
      q[i] = i ? q_ac : q_dc;
      iq[i] = (1 << kQfix) / q[i];
      bias[i] = kBiasMatrices[kind][i > 0] << (kQfix - 8);
      zthresh[i] = ((1 << kQfix) - 1 - bias[i]) / iq[i];
      sharpen[i] = kind == 0 ? (kFreqSharpening[i] * q[i]) >> 11 : 0;
      sum += q[i];
    }
    average = (sum + 8) >> 4;
  }
};

// QuantizeBlock_C: coeffs (raster) to their dequantised values; levels in
// zigzag order; returns whether any level is non-zero
bool quantize_block(int* coeffs, int* levels, const Matrix& m) {
  bool nz = false;
  for (int n = 0; n < 16; ++n) {
    const int j = kZigzag[n], v = coeffs[j];
    const int coeff = (v < 0 ? -v : v) + m.sharpen[j];
    if (coeff > m.zthresh[j]) {
      int level = std::min((coeff * m.iq[j] + m.bias[j]) >> kQfix, kMaxLevel);
      if (v < 0) level = -level;
      coeffs[j] = level * m.q[j];
      levels[n] = level;
      nz |= level != 0;
    } else {
      coeffs[j] = 0;
      levels[n] = 0;
    }
  }
  return nz;
}

int quantize_single(int* coeffs, const Matrix& m) {
  const int v = coeffs[0], a = v < 0 ? -v : v;
  if (a > m.zthresh[0]) {
    const int qv = ((a * m.iq[0] + m.bias[0]) >> kQfix) * m.q[0];
    const int err = a - qv;
    coeffs[0] = v < 0 ? -qv : qv;
    return (v < 0 ? -err : err) >> 1;
  }
  coeffs[0] = 0;
  return (v < 0 ? -a : a) >> 1;
}

bool is_flat(const int* levels, int blocks, int thresh) {
  int score = 0;
  for (int b = 0; b < blocks; ++b)
    for (int i = 1; i < 16; ++i) {
      score += levels[16 * b + i] != 0;
      if (score > thresh) return false;
    }
  return true;
}

// ------------------------------------------------------------ predictions
// the four predictions of an n x n block by mode DC, TM, V, H; left / top
// null where the macroblock has none
void preds_of(const int* left, const int* top, int corner, int n, int shift,
              int* out /* 4 x n x n */) {
  int dc;
  if (top) {
    dc = 0;
    for (int i = 0; i < n; ++i) dc += top[i];
    if (left) {
      for (int i = 0; i < n; ++i) dc += left[i];
    } else {
      dc += dc;
    }
    dc = (dc + (1 << (shift - 1))) >> shift;
  } else if (left) {
    dc = 0;
    for (int i = 0; i < n; ++i) dc += left[i];
    dc = (2 * dc + (1 << (shift - 1))) >> shift;
  } else {
    dc = 0x80;
  }
  int* p_dc = out;
  int* p_tm = out + n * n;
  int* p_v = out + 2 * n * n;
  int* p_h = out + 3 * n * n;
  for (int y = 0; y < n; ++y)
    for (int x = 0; x < n; ++x) {
      p_dc[y * n + x] = dc;
      p_v[y * n + x] = top ? top[x] : 127;
      p_h[y * n + x] = left ? left[y] : 129;
      int tm;
      if (left) {
        tm = top ? clip(top[x] + left[y] - corner, 0, 255) : left[y];
      } else {
        tm = top ? top[x] : 129;
      }
      p_tm[y * n + x] = tm;
    }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// a 4x4 prediction from the boundary ring, the block's top at ring[at]
void pred4(int mode, const int* ring, int at, int* d) {
  const int X = ring[at - 1], I = ring[at - 2], J = ring[at - 3];
  const int K = ring[at - 4], L = ring[at - 5];
  const int A = ring[at], B = ring[at + 1], C = ring[at + 2], D = ring[at + 3];
  const int E = ring[at + 4], F = ring[at + 5], G = ring[at + 6];
  const int H = ring[at + 7];
#define P(x, y) d[(x) + 4 * (y)]
  switch (mode) {
    case 0: {  // DC
      const int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int i = 0; i < 16; ++i) d[i] = dc;
      break;
    }
    case 1:  // TM
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          P(x, y) = clip(ring[at + x] + ring[at - 2 - y] - X, 0, 255);
      break;
    case 2: {  // VE
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                        avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) P(x, y) = v[x];
      break;
    }
    case 3: {  // HE
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                        avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) P(x, y) = v[y];
      break;
    }
    case 4: {  // RD
      const int v[7] = {avg3(J, K, L), avg3(I, J, K), avg3(X, I, J),
                        avg3(A, X, I), avg3(B, A, X), avg3(C, B, A),
                        avg3(D, C, B)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) P(x, y) = v[3 + x - y];
      break;
    }
    case 6: {  // LD
      const int v[7] = {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E),
                        avg3(D, E, F), avg3(E, F, G), avg3(F, G, H),
                        avg3(G, H, H)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) P(x, y) = v[x + y];
      break;
    }
    case 5:  // VR
      P(0, 0) = P(1, 2) = avg2(X, A);
      P(1, 0) = P(2, 2) = avg2(A, B);
      P(2, 0) = P(3, 2) = avg2(B, C);
      P(3, 0) = avg2(C, D);
      P(0, 3) = avg3(K, J, I);
      P(0, 2) = avg3(J, I, X);
      P(0, 1) = P(1, 3) = avg3(I, X, A);
      P(1, 1) = P(2, 3) = avg3(X, A, B);
      P(2, 1) = P(3, 3) = avg3(A, B, C);
      P(3, 1) = avg3(B, C, D);
      break;
    case 7:  // VL
      P(0, 0) = avg2(A, B);
      P(1, 0) = P(0, 2) = avg2(B, C);
      P(2, 0) = P(1, 2) = avg2(C, D);
      P(3, 0) = P(2, 2) = avg2(D, E);
      P(0, 1) = avg3(A, B, C);
      P(1, 1) = P(0, 3) = avg3(B, C, D);
      P(2, 1) = P(1, 3) = avg3(C, D, E);
      P(3, 1) = P(2, 3) = avg3(D, E, F);
      P(3, 2) = avg3(E, F, G);
      P(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      P(0, 0) = P(2, 1) = avg2(I, X);
      P(0, 1) = P(2, 2) = avg2(J, I);
      P(0, 2) = P(2, 3) = avg2(K, J);
      P(0, 3) = avg2(L, K);
      P(3, 0) = avg3(A, B, C);
      P(2, 0) = avg3(X, A, B);
      P(1, 0) = P(3, 1) = avg3(I, X, A);
      P(1, 1) = P(3, 2) = avg3(J, I, X);
      P(1, 2) = P(3, 3) = avg3(K, J, I);
      P(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      P(0, 0) = avg2(I, J);
      P(2, 0) = P(0, 1) = avg2(J, K);
      P(2, 1) = P(0, 2) = avg2(K, L);
      P(1, 0) = avg3(I, J, K);
      P(3, 0) = P(1, 1) = avg3(J, K, L);
      P(3, 1) = P(1, 2) = avg3(K, L, L);
      P(3, 2) = P(2, 2) = P(0, 3) = P(1, 3) = P(2, 3) = P(3, 3) = L;
      break;
  }
#undef P
}

// an n x n array (row-major) -> its 4x4 blocks in raster order
void blocks_of(const int* rows, int n, int* out) {
  const int nb = n / 4;
  for (int by = 0; by < nb; ++by)
    for (int bx = 0; bx < nb; ++bx)
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          out[16 * (by * nb + bx) + 4 * y + x] =
              rows[(4 * by + y) * n + 4 * bx + x];
}

// ---------------------------------------------------------------- costs
inline int bit_cost(int bit, int proba) {
  return bit ? kEntropyCost[255 - proba] : kEntropyCost[proba];
}

struct Proba {
  uint8_t coeffs[4][8][3][kNumProbas];
  uint32_t stats[4][8][3][kNumProbas];
  uint16_t level_cost[4][8][3][kMaxVariableLevel + 1];
  bool dirty = true;

  Proba() {
    std::memcpy(coeffs, kCoeffsProba0, sizeof(coeffs));
    std::memset(stats, 0, sizeof(stats));
    calculate_level_costs();
  }
  void calculate_level_costs() {
    if (!dirty) return;
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c) {
          const uint8_t* p = coeffs[t][b][c];
          const int cost0 = c > 0 ? bit_cost(1, p[0]) : 0;
          const int base = bit_cost(1, p[1]) + cost0;
          uint16_t* table = level_cost[t][b][c];
          table[0] = (uint16_t)(bit_cost(0, p[1]) + cost0);
          for (int v = 1; v <= kMaxVariableLevel; ++v) {
            int pattern = kLevelCodes[v - 1][0], bits = kLevelCodes[v - 1][1];
            int cost = 0;
            for (int i = 2; pattern; ++i) {
              if (pattern & 1) cost += bit_cost(bits & 1, p[i]);
              bits >>= 1;
              pattern >>= 1;
            }
            table[v] = (uint16_t)(base + cost);
          }
        }
    dirty = false;
  }
  void finalize() {
    bool changed = false;
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < kNumProbas; ++p) {
            const uint32_t s = stats[t][b][c][p];
            const int nb = s & 0xFFFF, total = (s >> 16) & 0xFFFF;
            const int upd = kCoeffsUpdateProba[t][b][c][p];
            const int old = kCoeffsProba0[t][b][c][p];
            const int nw = nb ? 255 - nb * 255 / total : 255;
            const int old_cost = nb * bit_cost(1, old) +
                                 (total - nb) * bit_cost(0, old) +
                                 bit_cost(0, upd);
            const int new_cost = nb * bit_cost(1, nw) +
                                 (total - nb) * bit_cost(0, nw) +
                                 bit_cost(1, upd) + 8 * 256;
            if (old_cost > new_cost) {
              coeffs[t][b][c][p] = (uint8_t)nw;
              changed |= nw != old;
            } else {
              coeffs[t][b][c][p] = (uint8_t)old;
            }
          }
    dirty = changed;
  }
};

inline int record_stat(uint32_t* stats, int p, int bit) {
  uint32_t s = stats[p];
  if (s >= 0xFFFE0000u) s = ((s + 1u) >> 1) & 0x7FFF7FFFu;
  stats[p] = s + 0x00010000u + (uint32_t)bit;
  return bit;
}

int last_of(const int* levels) {
  for (int n = 15; n >= 0; --n)
    if (levels[n]) return n;
  return -1;
}

int residual_cost(const Proba& pr, int ctype, int first, int ctx0,
                  const int* levels) {
  const int last = last_of(levels);
  const int p0 = pr.coeffs[ctype][first][ctx0][0];
  if (last < 0) return bit_cost(0, p0);
  int cost = ctx0 == 0 ? bit_cost(1, p0) : 0;
  const uint16_t* t = pr.level_cost[ctype][kEncBands[first]][ctx0];
  int n = first;
  for (; n < last; ++n) {
    const int v = std::abs(levels[n]);
    cost += kLevelFixedCosts[v] + t[std::min(v, kMaxVariableLevel)];
    t = pr.level_cost[ctype][kEncBands[n + 1]][std::min(v, 2)];
  }
  const int v = std::abs(levels[n]);
  cost += kLevelFixedCosts[v] + t[std::min(v, kMaxVariableLevel)];
  if (n < 15)
    cost += bit_cost(0, pr.coeffs[ctype][kEncBands[n + 1]][v == 1 ? 1 : 2][0]);
  return cost;
}

// tokens: bit 15 the bit, bit 14 a constant probability (low byte), else
// the index of the coefficient probability (t, band, ctx, node)
struct Tokens {
  std::vector<uint16_t> v;
  Proba* pr;
  uint32_t* s;
  int base;
  int add(int bit, int node, int stat_node) {
    v.push_back((uint16_t)(bit << 15 | (base + node)));
    record_stat(s, stat_node, bit);
    return bit;
  }
  int add(int bit, int node) { return add(bit, node, node); }
  void constant(int bit, int p) {
    v.push_back((uint16_t)(bit << 15 | 1 << 14 | p));
  }
  void at(int ctype, int band, int ctx) {
    base = ((ctype * 8 + band) * 3 + ctx) * kNumProbas;
    s = pr->stats[ctype][band][ctx];
  }
  // VP8RecordCoeffTokens
  int record(int ctype, int first, int ctx, const int* levels) {
    const int last = last_of(levels);
    int n = first;
    at(ctype, n, ctx);
    if (!add(last >= 0, 0)) return 0;
    while (n < 16) {
      const int c = levels[n++];
      const int v = c < 0 ? -c : c;
      if (!add(v != 0, 1)) {
        at(ctype, kEncBands[n], 0);
        continue;
      }
      if (!add(v > 1, 2)) {
        at(ctype, kEncBands[n], 1);
      } else {
        if (!add(v > 4, 3)) {
          if (add(v != 2, 4)) add(v == 4, 5);
        } else if (!add(v > 10, 6)) {
          if (!add(v > 6, 7)) {
            constant(v == 6, 159);
          } else {
            constant(v >= 9, 165);
            constant(!(v & 1), 145);
          }
        } else {
          int residue = v - 3, mask;
          const uint8_t* tab;
          if (residue < (8 << 1)) {
            add(0, 8);
            add(0, 9);
            residue -= 8 << 0;
            mask = 1 << 2;
            tab = vp8::kCat3;
          } else if (residue < (8 << 2)) {
            add(0, 8);
            add(1, 9);
            residue -= 8 << 1;
            mask = 1 << 3;
            tab = vp8::kCat4;
          } else if (residue < (8 << 3)) {
            add(1, 8);
            add(0, 10, 9);
            residue -= 8 << 2;
            mask = 1 << 4;
            tab = vp8::kCat5;
          } else {
            add(1, 8);
            add(1, 10, 9);
            residue -= 8 << 3;
            mask = 1 << 10;
            tab = vp8::kCat6;
          }
          while (mask) {
            constant(!!(residue & mask), *tab++);
            mask >>= 1;
          }
        }
        at(ctype, kEncBands[n], 2);
      }
      constant(c < 0, 128);
      if (n == 16 || !add(n <= last, 0)) return 1;
    }
    return 1;
  }
};

// ------------------------------------------------------------ bit writer
struct BitWriter {
  int32_t range = 254, value = 0;
  int run = 0, nb_bits = -8;
  std::vector<uint8_t> buf;

  void flush() {
    const int s = 8 + nb_bits;
    const int32_t bits = value >> s;
    value -= bits << s;
    nb_bits -= 8;
    if ((bits & 0xff) != 0xff) {
      if ((bits & 0x100) && !buf.empty()) buf.back()++;
      for (; run > 0; --run) buf.push_back((bits & 0x100) ? 0x00 : 0xff);
      buf.push_back(bits & 0xff);
    } else {
      ++run;
    }
  }
  void renorm(int shift) {
    range = ((range + 1) << shift) - 1;
    value <<= shift;
    nb_bits += shift;
    if (nb_bits > 0) flush();
  }
  int put(int bit, int prob) {
    const int split = (range * prob) >> 8;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    if (range < 127) {
      int b = 0;
      for (int r = range + 1; r; r >>= 1) ++b;
      renorm(8 - b);
    }
    return bit;
  }
  int uniform(int bit) {
    const int split = range >> 1;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    if (range < 127) renorm(1);
    return bit;
  }
  void value_bits(int v, int n) {
    for (int k = n - 1; k >= 0; --k) uniform((v >> k) & 1);
  }
  void signed_bits(int v, int n) {
    if (!uniform(v != 0)) return;
    value_bits(v < 0 ? (-v << 1) | 1 : v << 1, n + 1);
  }
  void finish() {
    value_bits(0, 9 - nb_bits);
    nb_bits = 0;
    flush();
  }
};

// ------------------------------------------------------------- encoder
int alpha_of(const int* src_blocks, const int* pred_blocks, int nblocks) {
  int dist[kMaxCoeffThresh + 1] = {0};
  int out[16];
  for (int b = 0; b < nblocks; ++b) {
    ftransform(src_blocks + 16 * b, pred_blocks + 16 * b, out);
    for (int k = 0; k < 16; ++k)
      ++dist[std::min(std::abs(out[k]) >> 3, kMaxCoeffThresh)];
  }
  int max_value = 0, last_non_zero = 1;
  for (int k = 0; k <= kMaxCoeffThresh; ++k)
    if (dist[k] > 0) {
      max_value = std::max(max_value, dist[k]);
      last_non_zero = k;
    }
  return max_value > 1 ? kAlphaScale * last_non_zero / max_value : 0;
}

struct Segment {
  int alpha = 0, beta = 0, quant = 0, fstrength = 0, max_edge = 0;
  bool has_matrices = false;
  Matrix y1, y2, uv;
  int lambda_i4 = 0, lambda_i16 = 0, lambda_uv = 0, lambda_mode = 0;
  int tlambda = 0, min_disto = 0;
};

struct MBInfo {
  int alpha = 0, segment = 0, ymode = 0, uvmode = 0;
  bool is_i16 = true;
  int modes[16] = {0};
};

struct Score {
  int64_t D = 0, SD = 0, H = 0, R = 0, score = kMaxCost;
  uint32_t nz = 0;
  void set(int lam) { score = (R + H) * lam + 256 * (D + SD); }
  void add(const Score& o) {
    D += o.D;
    SD += o.SD;
    H += o.H;
    R += o.R;
    nz |= o.nz;
    score += o.score;
  }
};

struct Decision {  // one macroblock's choice
  Score sc;
  int dc_levels[16];
  int ac_levels[16][16];
  int uv_levels[8][16];
  int recon_y[16][16];   // 16 blocks of 16
  int recon_uv[8][16];   // 4 U blocks, 4 V blocks
};

struct Encoder {
  int w, h, mb_w, mb_h, y_h, y_w, uv_h, uv_w;
  std::vector<uint8_t> Y, U, V;  // macroblock-padded planes
  int ys, uvs;                   // their strides
  std::vector<MBInfo> mbs;
  Segment seg[4];
  int num_segments = kSegments, base_quant = 0, dq_uv_dc = 0, dq_uv_ac = 0;
  int uv_alpha = 0, filter_level = 0;
  bool update_map = true;
  int segment_probas[3] = {255, 255, 255};
  Proba proba;
  Tokens tokens;
  std::vector<uint8_t> preds;  // (4 mb_h) x (4 mb_w) sub-block modes
  // the macroblock loop's boundary state
  std::vector<int> y_top, uv_top, top_nz, top_derr;
  int y_left[16], u_left[8], v_left[8], y_corner, u_corner, v_corner;
  int left_nz[9], left_derr[2][2];

  void convert(const uint8_t* rgb) {
    static int lin[256], tab[33];
    static bool ready = false;
    if (!ready) {
      for (int v = 0; v < 256; ++v)
        lin[v] = (int)(std::pow((1.0 / 255.0) * v, 0.80) * 4095 + .5);
      for (int v = 0; v <= 32; ++v)
        tab[v] = (int)(255.0 * std::pow((128.0 / 4095) * v, 1.0 / 0.80) + .5);
      ready = true;
    }
    ys = 16 * mb_w;
    uvs = 8 * mb_w;
    Y.assign((size_t)ys * 16 * mb_h, 0);
    U.assign((size_t)uvs * 8 * mb_h, 0);
    V.assign((size_t)uvs * 8 * mb_h, 0);
    for (int y = 0; y < 16 * mb_h; ++y)
      for (int x = 0; x < 16 * mb_w; ++x) {
        const uint8_t* p =
            rgb + 3 * ((size_t)std::min(y, h - 1) * w + std::min(x, w - 1));
        Y[(size_t)y * ys + x] = (uint8_t)(
            (16839 * p[0] + 33059 * p[1] + 6420 * p[2] + (1 << 15) +
             (16 << 16)) >> 16);
      }
    for (int y = 0; y < 8 * mb_h; ++y)
      for (int x = 0; x < 8 * mb_w; ++x) {
        const int cy = std::min(y, uv_h - 1), cx = std::min(x, uv_w - 1);
        int sum[3] = {0, 0, 0};
        for (int dy = 0; dy < 2; ++dy)
          for (int dx = 0; dx < 2; ++dx) {
            const int py = std::min(2 * cy + dy, h - 1);
            const int px = std::min(2 * cx + dx, w - 1);
            const uint8_t* p = rgb + 3 * ((size_t)py * w + px);
            for (int k = 0; k < 3; ++k) sum[k] += lin[p[k]];
          }
        int g[3];
        for (int k = 0; k < 3; ++k) {
          const int pos = sum[k] >> 9, fx = sum[k] & 511;
          const int yv = tab[pos + 1] * fx + tab[pos] * (512 - fx);
          g[k] = (yv + 64) >> 7;
        }
        const int u = -9719 * g[0] - 19081 * g[1] + 28800 * g[2];
        const int v = 28800 * g[0] - 24116 * g[1] - 4684 * g[2];
        const int half = (1 << 17) + (128 << 18);
        U[(size_t)y * uvs + x] = (uint8_t)clip((u + half) >> 18, 0, 255);
        V[(size_t)y * uvs + x] = (uint8_t)clip((v + half) >> 18, 0, 255);
      }
  }

  // a macroblock's source: sy 16 x 16, su and sv 8 x 8
  void src_of(int x, int y, int* sy, int* su, int* sv) const {
    for (int j = 0; j < 16; ++j)
      for (int i = 0; i < 16; ++i)
        sy[16 * j + i] = Y[(size_t)(16 * y + j) * ys + 16 * x + i];
    for (int j = 0; j < 8; ++j)
      for (int i = 0; i < 8; ++i) {
        su[8 * j + i] = U[(size_t)(8 * y + j) * uvs + 8 * x + i];
        sv[8 * j + i] = V[(size_t)(8 * y + j) * uvs + 8 * x + i];
      }
  }

  // VP8IteratorImport's edges from the source; returns (has left, has top)
  void source_edges(const std::vector<uint8_t>& plane, int stride, int size,
                    int x, int y, int h_true, int w_true, int* left, int* top,
                    int* corner, bool* has_left, bool* has_top) const {
    *has_left = x > 0;
    *has_top = y > 0;
    *corner = 127;
    if (x > 0) {
      const int rows = std::min(size, h_true - size * y);
      for (int i = 0; i < size; ++i)
        left[i] = plane[(size_t)(size * y + std::min(i, rows - 1)) * stride +
                        size * x - 1];
      if (y > 0)
        *corner = plane[(size_t)(size * y - 1) * stride + size * x - 1];
    }
    if (y > 0) {
      const int cols = std::min(size, w_true - size * x);
      for (int i = 0; i < size; ++i)
        top[i] = plane[(size_t)(size * y - 1) * stride + size * x +
                       std::min(i, cols - 1)];
    }
  }

  void analyze() {
    int alphas[kMaxAlpha + 1] = {0};
    int64_t uv_sum = 0;
    int sy[256], su[64], sv[64], sb[256], sub[128];
    int pred[4 * 256], pu[4 * 64], pv[4 * 64], pb[256], puvb[128];
    for (int y = 0; y < mb_h; ++y)
      for (int x = 0; x < mb_w; ++x) {
        src_of(x, y, sy, su, sv);
        int left[16], top[16], corner;
        bool hl, ht;
        source_edges(Y, ys, 16, x, y, y_h, y_w, left, top, &corner, &hl, &ht);
        preds_of(hl ? left : nullptr, ht ? top : nullptr, corner, 16, 5, pred);
        blocks_of(sy, 16, sb);
        int best_alpha = -1;
        for (int mode = 0; mode < kAnalysisModes; ++mode) {
          blocks_of(pred + 256 * mode, 16, pb);
          best_alpha = std::max(best_alpha, alpha_of(sb, pb, 16));
        }
        int ul[8], ut[8], uc, vl[8], vt[8], vc;
        source_edges(U, uvs, 8, x, y, uv_h, uv_w, ul, ut, &uc, &hl, &ht);
        source_edges(V, uvs, 8, x, y, uv_h, uv_w, vl, vt, &vc, &hl, &ht);
        preds_of(hl ? ul : nullptr, ht ? ut : nullptr, uc, 8, 4, pu);
        preds_of(hl ? vl : nullptr, ht ? vt : nullptr, vc, 8, 4, pv);
        blocks_of(su, 8, sub);
        blocks_of(sv, 8, sub + 64);
        int best_uv = -1;
        for (int mode = 0; mode < kAnalysisModes; ++mode) {
          blocks_of(pu + 64 * mode, 8, puvb);
          blocks_of(pv + 64 * mode, 8, puvb + 64);
          best_uv = std::max(best_uv, alpha_of(sub, puvb, 8));
        }
        int alpha = (3 * best_alpha + best_uv + 2) >> 2;
        alpha = clip(kMaxAlpha - alpha, 0, kMaxAlpha);
        ++alphas[alpha];
        mbs[(size_t)y * mb_w + x].alpha = alpha;
        uv_sum += best_uv;
      }
    uv_alpha = (int)(uv_sum / ((int64_t)mb_w * mb_h));
    assign_segments(alphas);
  }

  void assign_segments(const int* alphas) {
    const int nb = kSegments;
    int min_a = 0, max_a;
    while (min_a < kMaxAlpha && !alphas[min_a]) ++min_a;
    max_a = kMaxAlpha;
    while (max_a > min_a && !alphas[max_a]) --max_a;
    const int range_a = max_a - min_a;
    int centers[kSegments], amap[kMaxAlpha + 1] = {0}, weighted = 0;
    for (int k = 0, n = 1; k < nb; ++k, n += 2)
      centers[k] = min_a + (n * range_a) / (2 * nb);
    for (int it = 0; it < 6; ++it) {
      int accum[kSegments] = {0}, dist[kSegments] = {0};
      int n = 0;
      for (int a = min_a; a <= max_a; ++a)
        if (alphas[a]) {
          while (n + 1 < nb &&
                 std::abs(a - centers[n + 1]) < std::abs(a - centers[n]))
            ++n;
          amap[a] = n;
          dist[n] += a * alphas[a];
          accum[n] += alphas[a];
        }
      int displaced = 0, total = 0;
      weighted = 0;
      for (n = 0; n < nb; ++n)
        if (accum[n]) {
          const int c = (dist[n] + accum[n] / 2) / accum[n];
          displaced += std::abs(centers[n] - c);
          centers[n] = c;
          weighted += c * accum[n];
          total += accum[n];
        }
      weighted = (weighted + total / 2) / total;
      if (displaced < 5) break;
    }
    for (MBInfo& mb : mbs) {
      mb.segment = amap[mb.alpha];
      mb.alpha = centers[amap[mb.alpha]];
    }
    int lo = centers[0], hi = centers[0];
    for (int n = 0; n < nb; ++n) {
      lo = std::min(lo, centers[n]);
      hi = std::max(hi, centers[n]);
    }
    if (hi == lo) hi = lo + 1;
    for (int n = 0; n < nb; ++n) {
      seg[n].alpha =
          clip(255 * (centers[n] - weighted) / (hi - lo), -127, 127);
      seg[n].beta = clip(255 * (centers[n] - lo) / (hi - lo), 0, 255);
    }
  }

  static int filter_level_of(int delta) {
    return kLevelsFromDelta[kSharpness][std::min(delta, 63)];
  }

  void set_segment_params() {
    const double amp = 0.9 * kSns / 100.0 / 128.0;
    const double q = (double)(float)kQuality / 100.0;
    const double linear = q < 0.75 ? q * (2.0 / 3.0) : 2.0 * q - 1.0;
    const double c_base = std::pow(linear, 1 / 3.0);
    for (int i = 0; i < num_segments; ++i) {
      const double expn = 1.0 - amp * seg[i].alpha;
      seg[i].quant =
          clip((int)(127.0 * (1.0 - std::pow(c_base, expn))), 0, 127);
    }
    base_quant = seg[0].quant;
    int dq = (uv_alpha - 64) * (6 - (-4)) / (100 - 30);
    dq_uv_ac = clip(dq * kSns / 100, -4, 6);
    dq_uv_dc = clip(-4 * kSns / 100, -15, 15);
    const int level0 = 5 * kFilterStrength;
    for (Segment& s : seg) {
      const int qstep = vp8::kAcTable[clip(s.quant, 0, 127)] >> 2;
      const int f = filter_level_of(qstep) * level0 / (256 + s.beta);
      s.fstrength = f < 2 ? 0 : std::min(f, 63);
    }
    if (num_segments > 1) simplify_segments();
    setup_matrices();
  }

  void simplify_segments() {
    int amap[4] = {0, 1, 2, 3}, final = 1;
    for (int s1 = 1; s1 < num_segments; ++s1) {
      int found = -1;
      for (int s2 = 0; s2 < final; ++s2)
        if (seg[s1].quant == seg[s2].quant &&
            seg[s1].fstrength == seg[s2].fstrength) {
          found = s2;
          break;
        }
      amap[s1] = found >= 0 ? found : final;
      if (found < 0) {
        if (final != s1) seg[final] = seg[s1];
        ++final;
      }
    }
    if (final < num_segments) {
      for (MBInfo& mb : mbs) mb.segment = amap[mb.segment];
      for (int i = final; i < num_segments; ++i) seg[i] = seg[final - 1];
      num_segments = final;
    }
  }

  void setup_matrices() {
    for (int i = 0; i < num_segments; ++i) {
      Segment& s = seg[i];
      const int q = s.quant;
      const int qc = clip(q, 0, 127);
      s.y1.init(vp8::kDcTable[qc], vp8::kAcTable[qc], 0);
      s.y2.init(vp8::kDcTable[qc] * 2, kAcTable2[qc], 1);
      s.uv.init(vp8::kDcTable[clip(q + dq_uv_dc, 0, 117)],
                vp8::kAcTable[clip(q + dq_uv_ac, 0, 127)], 2);
      const int q_i4 = s.y1.average, q_i16 = s.y2.average, q_uv = s.uv.average;
      s.lambda_i4 = std::max(1, (3 * q_i4 * q_i4) >> 7);
      s.lambda_i16 = std::max(1, 3 * q_i16 * q_i16);
      s.lambda_uv = std::max(1, (3 * q_uv * q_uv) >> 6);
      s.lambda_mode = std::max(1, (q_i4 * q_i4) >> 7);
      s.tlambda = std::max(1, (kSns * q_i4) >> 5);
      s.min_disto = 20 * s.y1.q[0];
      s.max_edge = 0;
      s.has_matrices = true;
    }
  }

  void set_segment_probas() {
    int p[4] = {0, 0, 0, 0};
    for (const MBInfo& mb : mbs) ++p[mb.segment];
    if (num_segments > 1) {
      auto get = [](int a, int b) {
        return a + b == 0 ? 255 : (255 * a + (a + b) / 2) / (a + b);
      };
      segment_probas[0] = get(p[0] + p[1], p[2] + p[3]);
      segment_probas[1] = get(p[0], p[1]);
      segment_probas[2] = get(p[2], p[3]);
      update_map = segment_probas[0] != 255 || segment_probas[1] != 255 ||
                   segment_probas[2] != 255;
      if (!update_map)
        for (MBInfo& mb : mbs) mb.segment = 0;
    } else {
      update_map = false;
    }
  }

  int pred_at(int row, int col) const {
    if (row < 0 || col < 0) return 0;
    return preds[(size_t)row * 4 * mb_w + col];
  }
  void set_preds(int x, int y, const int* modes) {
    for (int j = 0; j < 4; ++j)
      for (int i = 0; i < 4; ++i)
        preds[(size_t)(4 * y + j) * 4 * mb_w + 4 * x + i] =
            (uint8_t)modes[4 * j + i];
  }

  void encode_macroblocks() {
    y_top.assign((size_t)16 * mb_w, 127);
    uv_top.assign((size_t)16 * mb_w, 127);
    top_nz.assign((size_t)9 * mb_w, 0);
    top_derr.assign((size_t)4 * mb_w, 0);
    tokens.pr = &proba;
    const int max_count = std::max((mb_w * mb_h) >> 3, kMinCount);
    int cnt = max_count;
    for (int y = 0; y < mb_h; ++y) {
      const int corner = y > 0 ? 129 : 127;
      for (int i = 0; i < 16; ++i) y_left[i] = 129;
      for (int i = 0; i < 8; ++i) u_left[i] = v_left[i] = 129;
      y_corner = u_corner = v_corner = corner;
      std::memset(left_nz, 0, sizeof(left_nz));
      std::memset(left_derr, 0, sizeof(left_derr));
      for (int x = 0; x < mb_w; ++x) {
        if (--cnt < 0) {
          proba.finalize();
          proba.calculate_level_costs();
          cnt = max_count;
        }
        decimate(x, y);
      }
    }
    proba.finalize();
    adjust_filter_strength();
  }

  void decimate(int x, int y) {
    MBInfo& mb = mbs[(size_t)y * mb_w + x];
    Segment& s = seg[mb.segment];
    int sy[256], su[64], sv[64];
    src_of(x, y, sy, su, sv);
    int tnz[9], lnz[9];
    std::memcpy(tnz, &top_nz[(size_t)9 * x], sizeof(tnz));
    std::memcpy(lnz, left_nz, sizeof(lnz));
    Decision d;
    pick_best_intra16(mb, s, sy, x, y, tnz, lnz, d);
    pick_best_intra4(mb, s, sy, x, y, tnz, lnz, d);
    pick_best_uv(mb, s, su, sv, x, y, tnz, lnz, d);
    record(mb, d, x);
    save_boundary(d, x, y);
  }

  int cost_luma16(const int* dc_levels, const int ac_levels[16][16],
                  const int* tnz0, const int* lnz0) {
    int top[9], left[9];
    std::memcpy(top, tnz0, sizeof(top));
    std::memcpy(left, lnz0, sizeof(left));
    int r = residual_cost(proba, 1, 0, top[8] + left[8], dc_levels);
    for (int n = 0; n < 16; ++n) {
      const int bx = n & 3, by = n >> 2;
      r += residual_cost(proba, 0, 1, top[bx] + left[by], ac_levels[n]);
      top[bx] = left[by] = last_of(ac_levels[n]) >= 0;
    }
    return r;
  }

  void pick_best_intra16(MBInfo& mb, Segment& s, const int* sy, int x, int y,
                         const int* tnz, const int* lnz, Decision& d) {
    int src_blocks[256], pred[4 * 256], pb[256];
    blocks_of(sy, 16, src_blocks);
    bool flat = true;
    for (int i = 0; i < 256; ++i) flat &= sy[i] == sy[0];
    preds_of(x > 0 ? y_left : nullptr,
             y > 0 ? &y_top[(size_t)16 * x] : nullptr, y_corner, 16, 5, pred);
    int best_mode = -1;
    for (int mode = 0; mode < 4; ++mode) {
      blocks_of(pred + 256 * mode, 16, pb);
      int tmp[16][16], dcs[16], dc[16], dc_levels[16];
      int ac_levels[16][16], recon[16][16];
      for (int n = 0; n < 16; ++n) {
        ftransform(src_blocks + 16 * n, pb + 16 * n, tmp[n]);
        dcs[n] = tmp[n][0];
      }
      fwht(dcs, dc);
      Score sc;
      sc.nz = (uint32_t)quantize_block(dc, dc_levels, s.y2) << 24;
      for (int n = 0; n < 16; ++n) {
        tmp[n][0] = 0;
        sc.nz |= (uint32_t)quantize_block(tmp[n], ac_levels[n], s.y1) << n;
      }
      int back[16];
      iwht(dc, back);
      int64_t D = 0;
      int td = 0;
      for (int n = 0; n < 16; ++n) {
        tmp[n][0] = back[n];
        itransform(pb + 16 * n, tmp[n], recon[n]);
        D += sse16(src_blocks + 16 * n, recon[n]);
        td += tdisto(src_blocks + 16 * n, recon[n]);
      }
      sc.D = D;
      sc.SD = mult_8b(s.tlambda, td);
      sc.H = kFixedCostsI16[mode];
      sc.R = cost_luma16(dc_levels, ac_levels, tnz, lnz);
      if (flat) {
        flat = is_flat(&ac_levels[0][0], 16, 0);
        if (flat) {
          sc.D *= 2;
          sc.SD *= 2;
        }
      }
      sc.set(s.lambda_i16);
      if (mode == 0 || sc.score < d.sc.score) {
        best_mode = mode;
        d.sc = sc;
        std::memcpy(d.dc_levels, dc_levels, sizeof(dc_levels));
        std::memcpy(d.ac_levels, ac_levels, sizeof(ac_levels));
        std::memcpy(d.recon_y, recon, sizeof(recon));
      }
    }
    d.sc.set(s.lambda_mode);
    mb.is_i16 = true;
    mb.ymode = best_mode;
    int modes[16];
    for (int i = 0; i < 16; ++i) modes[i] = best_mode;
    set_preds(x, y, modes);
    if ((d.sc.nz & 0x100FFFF) == 0x1000000 && d.sc.D > s.min_disto) {
      const int v = std::max({std::abs(d.dc_levels[1]),
                              std::abs(d.dc_levels[2]),
                              std::abs(d.dc_levels[4])});
      s.max_edge = std::max(s.max_edge, v);
    }
  }

  void pick_best_intra4(MBInfo& mb, Segment& s, const int* sy, int x, int y,
                        const int* tnz0, const int* lnz0, Decision& d) {
    int src_blocks[256];
    blocks_of(sy, 16, src_blocks);
    int top_nz_[9], left_nz_[9];
    std::memcpy(top_nz_, tnz0, sizeof(top_nz_));
    std::memcpy(left_nz_, lnz0, sizeof(left_nz_));
    int ring[37];
    for (int i = 0; i < 16; ++i) ring[i] = y_left[15 - i];
    ring[16] = y_corner;
    for (int i = 0; i < 16; ++i) ring[17 + i] = y_top[(size_t)16 * x + i];
    for (int i = 0; i < 4; ++i)
      ring[33 + i] = x < mb_w - 1 ? y_top[(size_t)16 * (x + 1) + i] : ring[32];
    Score best;
    best.H = 211;
    best.set(s.lambda_mode);
    int modes[16], levels_all[16][16], recon[16][16];
    for (int i4 = 0; i4 < 16; ++i4) {
      const int bx = i4 & 3, by = i4 >> 2, at = kTopLeftI4[i4];
      const int* src = src_blocks + 16 * i4;
      const int left_m =
          bx == 0 ? pred_at(4 * y + by, 4 * x - 1) : modes[i4 - 1];
      const int top_m =
          by == 0 ? pred_at(4 * y - 1, 4 * x + bx) : modes[i4 - 4];
      const uint16_t* costs = kFixedCostsI4[top_m][left_m];
      Score bsc;
      int bmode = -1, blevels[16], brec[16];
      for (int mode = 0; mode < 10; ++mode) {
        int pred[16], coeffs[16], levels[16], rec[16];
        pred4(mode, ring, at, pred);
        ftransform(src, pred, coeffs);
        const bool nz = quantize_block(coeffs, levels, s.y1);
        itransform(pred, coeffs, rec);
        Score sc;
        sc.nz = (uint32_t)nz << i4;
        sc.D = sse16(src, rec);
        sc.SD = mult_8b(s.tlambda, tdisto(src, rec));
        sc.H = costs[mode];
        sc.R = (mode > 0 && is_flat(levels, 1, 3)) ? kFlatPenalty : 0;
        sc.set(s.lambda_i4);
        if (bmode >= 0 && sc.score >= bsc.score) continue;
        sc.R += residual_cost(proba, 3, 0, top_nz_[bx] + left_nz_[by], levels);
        sc.set(s.lambda_i4);
        if (bmode < 0 || sc.score < bsc.score) {
          bsc = sc;
          bmode = mode;
          std::memcpy(blevels, levels, sizeof(blevels));
          std::memcpy(brec, rec, sizeof(brec));
        }
      }
      bsc.set(s.lambda_mode);
      best.add(bsc);
      if (best.score >= d.sc.score) return;
      modes[i4] = bmode;
      std::memcpy(levels_all[i4], blevels, sizeof(blevels));
      std::memcpy(recon[i4], brec, sizeof(brec));
      top_nz_[bx] = left_nz_[by] = bsc.nz != 0;
      // VP8IteratorRotateI4
      for (int i = 0; i < 4; ++i) ring[at - 4 + i] = brec[12 + i];
      if (bx != 3) {
        for (int i = 0; i < 3; ++i) ring[at + i] = brec[3 + 4 * (2 - i)];
      } else {
        for (int i = 0; i < 4; ++i) ring[at + i] = ring[at + i + 4];
      }
    }
    d.sc = best;
    std::memcpy(d.ac_levels, levels_all, sizeof(levels_all));
    std::memcpy(d.recon_y, recon, sizeof(recon));
    mb.is_i16 = false;
    std::memcpy(mb.modes, modes, sizeof(modes));
    set_preds(x, y, modes);
  }

  int cost_uv(const int levels[8][16], const int* tnz0, const int* lnz0) {
    int top[9], left[9];
    std::memcpy(top, tnz0, sizeof(top));
    std::memcpy(left, lnz0, sizeof(left));
    int r = 0;
    for (int ch = 0; ch <= 2; ch += 2)
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          const int* lv = levels[2 * ch + 2 * by + bx];
          r += residual_cost(proba, 2, 0,
                             top[4 + ch + bx] + left[4 + ch + by], lv);
          top[4 + ch + bx] = left[4 + ch + by] = last_of(lv) >= 0;
        }
    return r;
  }

  void pick_best_uv(MBInfo& mb, Segment& s, const int* su, const int* sv,
                    int x, int y, const int* tnz, const int* lnz,
                    Decision& d) {
    int pu[4 * 64], pv[4 * 64], src[128], pb[128];
    blocks_of(su, 8, src);
    blocks_of(sv, 8, src + 64);
    const int* utop = y > 0 ? &uv_top[(size_t)16 * x] : nullptr;
    const int* vtop = y > 0 ? &uv_top[(size_t)16 * x + 8] : nullptr;
    preds_of(x > 0 ? u_left : nullptr, utop, u_corner, 8, 4, pu);
    preds_of(x > 0 ? v_left : nullptr, vtop, v_corner, 8, 4, pv);
    Score bsc;
    int bmode = -1, bderr[2][3] = {{0}};
    for (int mode = 0; mode < 4; ++mode) {
      blocks_of(pu + 64 * mode, 8, pb);
      blocks_of(pv + 64 * mode, 8, pb + 64);
      int tmp[8][16], levels[8][16], recon[8][16], derr[2][3];
      for (int n = 0; n < 8; ++n)
        ftransform(src + 16 * n, pb + 16 * n, tmp[n]);
      for (int ch = 0; ch < 2; ++ch) {  // CorrectDCValues
        const int* top = &top_derr[(size_t)4 * x + 2 * ch];
        const int* left = left_derr[ch];
        int (*c)[16] = &tmp[4 * ch];
        c[0][0] += (7 * top[0] + 8 * left[0]) >> 3;
        const int e0 = quantize_single(c[0], s.uv);
        c[1][0] += (7 * top[1] + 8 * e0) >> 3;
        const int e1 = quantize_single(c[1], s.uv);
        c[2][0] += (7 * e0 + 8 * left[1]) >> 3;
        const int e2 = quantize_single(c[2], s.uv);
        c[3][0] += (7 * e1 + 8 * e2) >> 3;
        const int e3 = quantize_single(c[3], s.uv);
        derr[ch][0] = e1;
        derr[ch][1] = e2;
        derr[ch][2] = e3;
      }
      Score sc;
      for (int n = 0; n < 8; ++n)
        sc.nz |= (uint32_t)quantize_block(tmp[n], levels[n], s.uv) << n;
      sc.nz <<= 16;
      int64_t D = 0;
      for (int n = 0; n < 8; ++n) {
        itransform(pb + 16 * n, tmp[n], recon[n]);
        D += sse16(src + 16 * n, recon[n]);
      }
      sc.D = D;
      sc.H = kFixedCostsUV[mode];
      sc.R = cost_uv(levels, tnz, lnz);
      if (mode > 0 && is_flat(&levels[0][0], 8, 2)) sc.R += kFlatPenalty * 8;
      sc.set(s.lambda_uv);
      if (mode == 0 || sc.score < bsc.score) {
        bsc = sc;
        bmode = mode;
        std::memcpy(d.uv_levels, levels, sizeof(levels));
        std::memcpy(d.recon_uv, recon, sizeof(recon));
        std::memcpy(bderr, derr, sizeof(derr));
      }
    }
    mb.uvmode = bmode;
    d.sc.add(bsc);
    for (int ch = 0; ch < 2; ++ch) {
      int* top = &top_derr[(size_t)4 * x + 2 * ch];
      int* left = left_derr[ch];
      left[0] = bderr[ch][0];
      left[1] = (3 * bderr[ch][2]) >> 2;
      top[0] = bderr[ch][1];
      top[1] = bderr[ch][2] - left[1];
    }
  }

  void record(const MBInfo& mb, const Decision& d, int x) {
    int* top = &top_nz[(size_t)9 * x];
    int* left = left_nz;
    int ctype, first;
    if (mb.is_i16) {
      top[8] = left[8] = tokens.record(1, 0, top[8] + left[8], d.dc_levels);
      ctype = 0;
      first = 1;
    } else {
      ctype = 3;
      first = 0;
    }
    for (int n = 0; n < 16; ++n) {
      const int bx = n & 3, by = n >> 2;
      top[bx] = left[by] =
          tokens.record(ctype, first, top[bx] + left[by], d.ac_levels[n]);
    }
    for (int ch = 0; ch <= 2; ch += 2)
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx)
          top[4 + ch + bx] = left[4 + ch + by] =
              tokens.record(2, 0, top[4 + ch + bx] + left[4 + ch + by],
                            d.uv_levels[2 * ch + 2 * by + bx]);
  }

  void save_boundary(const Decision& d, int x, int y) {
    if (x < mb_w - 1) {
      for (int i = 0; i < 16; ++i)
        y_left[i] = d.recon_y[4 * (i >> 2) + 3][4 * (i & 3) + 3];
      for (int i = 0; i < 8; ++i) {
        u_left[i] = d.recon_uv[2 * (i >> 2) + 1][4 * (i & 3) + 3];
        v_left[i] = d.recon_uv[4 + 2 * (i >> 2) + 1][4 * (i & 3) + 3];
      }
      y_corner = y_top[(size_t)16 * x + 15];
      u_corner = uv_top[(size_t)16 * x + 7];
      v_corner = uv_top[(size_t)16 * x + 15];
    }
    if (y < mb_h - 1) {
      for (int i = 0; i < 16; ++i)
        y_top[(size_t)16 * x + i] = d.recon_y[12 + (i >> 2)][12 + (i & 3)];
      for (int i = 0; i < 8; ++i) {
        uv_top[(size_t)16 * x + i] = d.recon_uv[2 + (i >> 2)][12 + (i & 3)];
        uv_top[(size_t)16 * x + 8 + i] =
            d.recon_uv[6 + (i >> 2)][12 + (i & 3)];
      }
    }
  }

  void adjust_filter_strength() {
    int max_level = 0;
    for (Segment& s : seg) {
      if (s.has_matrices) {
        const int level = filter_level_of((s.max_edge * s.y2.q[1]) >> 3);
        s.fstrength = std::max(s.fstrength, level);
      }
      max_level = std::max(max_level, s.fstrength);
    }
    filter_level = max_level;
  }

  static void put_i4_mode(BitWriter& bw, int mode, const uint8_t* prob) {
    if (bw.put(mode != 0, prob[0]))
      if (bw.put(mode != 1, prob[1]))
        if (bw.put(mode != 2, prob[2])) {
          if (!bw.put(mode >= 6, prob[3])) {
            if (bw.put(mode != 3, prob[4])) bw.put(mode != 4, prob[5]);
          } else if (bw.put(mode != 6, prob[6])) {
            if (bw.put(mode != 7, prob[7])) bw.put(mode != 8, prob[8]);
          }
        }
  }

  void partition0(BitWriter& bw) {
    bw.uniform(0);
    bw.uniform(0);
    if (bw.uniform(num_segments > 1)) {
      bw.uniform(update_map);
      if (bw.uniform(1)) {
        bw.uniform(1);
        for (const Segment& s : seg) bw.signed_bits(s.quant, 7);
        for (const Segment& s : seg) bw.signed_bits(s.fstrength, 6);
      }
      if (update_map)
        for (int p : segment_probas)
          if (bw.uniform(p != 255)) bw.value_bits(p, 8);
    }
    bw.uniform(0);
    bw.value_bits(filter_level, 6);
    bw.value_bits(kSharpness, 3);
    bw.uniform(0);
    bw.value_bits(0, 2);
    bw.value_bits(base_quant, 7);
    const int dqs[5] = {0, 0, 0, dq_uv_dc, dq_uv_ac};
    for (int dq : dqs) bw.signed_bits(dq, 4);
    bw.uniform(0);
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < kNumProbas; ++p) {
            const int v = proba.coeffs[t][b][c][p];
            if (bw.put(v != kCoeffsProba0[t][b][c][p],
                       kCoeffsUpdateProba[t][b][c][p]))
              bw.value_bits(v, 8);
          }
    bw.uniform(0);
    for (int i = 0; i < mb_w * mb_h; ++i) {
      const MBInfo& mb = mbs[i];
      const int x = i % mb_w, y = i / mb_w;
      if (update_map) {
        if (bw.put(mb.segment >= 2, segment_probas[0]))
          bw.put(mb.segment & 1, segment_probas[2]);
        else
          bw.put(mb.segment & 1, segment_probas[1]);
      }
      if (bw.put(mb.is_i16, 145)) {
        const int m = mb.ymode;
        if (bw.put(m == 1 || m == 3, 156))
          bw.put(m == 1, 128);
        else
          bw.put(m == 2, 163);
      } else {
        for (int j = 0; j < 16; ++j) {
          const int bx = j & 3, by = j >> 2;
          const int top = pred_at(4 * y + by - 1, 4 * x + bx);
          const int left = pred_at(4 * y + by, 4 * x + bx - 1);
          put_i4_mode(bw, mb.modes[j], vp8::kBModesProba[top][left]);
        }
      }
      const int u = mb.uvmode;
      if (bw.put(u != 0, 142))
        if (bw.put(u != 2, 114)) bw.put(u != 3, 183);
    }
    bw.finish();
  }

  void token_partition(BitWriter& bw) {
    const uint8_t* flat = &proba.coeffs[0][0][0][0];
    for (uint16_t t : tokens.v) {
      const int bit = t >> 15;
      if (t & (1 << 14))
        bw.put(bit, t & 0xFF);
      else
        bw.put(bit, flat[t & 0x3FFF]);
    }
    bw.finish();
  }
};

}  // namespace

extern "C" {

// rgb: h x w packed RGB. Writes the WebP file to out; returns its length,
// or a negative error: -1 too large, -2 out too small.
int webp_encode_vp8(const uint8_t* rgb, int h, int w, uint8_t* out,
                    int64_t cap) {
  if (w <= 0 || h <= 0 || w > 16383 || h > 16383) return kErrTooLarge;
  Encoder enc;
  enc.w = w;
  enc.h = h;
  enc.mb_w = (w + 15) >> 4;
  enc.mb_h = (h + 15) >> 4;
  enc.y_h = h;
  enc.y_w = w;
  enc.uv_h = (h + 1) >> 1;
  enc.uv_w = (w + 1) >> 1;
  enc.mbs.assign((size_t)enc.mb_w * enc.mb_h, MBInfo());
  enc.preds.assign((size_t)16 * enc.mb_w * enc.mb_h, 0);
  enc.convert(rgb);
  enc.analyze();
  enc.set_segment_params();
  enc.set_segment_probas();
  enc.encode_macroblocks();
  BitWriter p0, p1;
  enc.partition0(p0);
  enc.token_partition(p1);
  if (p0.buf.size() >= (1u << 19)) return kErrTooLarge;
  size_t vp8 = 10 + p0.buf.size() + p1.buf.size();
  const size_t pad = vp8 & 1;
  vp8 += pad;
  const int64_t total = 20 + (int64_t)vp8;
  if (total > cap) return kErrOutput;
  auto le32 = [](uint8_t* p, uint32_t v) {
    for (int i = 0; i < 4; ++i) p[i] = (uint8_t)(v >> (8 * i));
  };
  std::memcpy(out, "RIFF", 4);
  le32(out + 4, (uint32_t)(12 + vp8));
  std::memcpy(out + 8, "WEBPVP8 ", 8);
  le32(out + 16, (uint32_t)vp8);
  const uint32_t bits = (1u << 4) | ((uint32_t)p0.buf.size() << 5);
  uint8_t* f = out + 20;
  f[0] = bits & 0xff;
  f[1] = (bits >> 8) & 0xff;
  f[2] = (bits >> 16) & 0xff;
  f[3] = 0x9d;
  f[4] = 0x01;
  f[5] = 0x2a;
  f[6] = w & 0xff;
  f[7] = w >> 8;
  f[8] = h & 0xff;
  f[9] = h >> 8;
  std::memcpy(f + 10, p0.buf.data(), p0.buf.size());
  std::memcpy(f + 10 + p0.buf.size(), p1.buf.data(), p1.buf.size());
  if (pad) f[vp8 - 1] = 0;
  return (int)total;
}

}  // extern "C"
