"""Lossy WebP writing as PIL 12.1 writes it (the Python twin): libwebp
1.6.0's VP8 encoder at PIL's settings.

PIL's ``WebPImagePlugin._save`` calls ``WebPEncode`` with quality 80,
method 4, ``exact`` 0 and the rest of ``WebPConfig``'s defaults: 4
segments, ``sns_strength`` 50, ``filter_strength`` 60, sharpness 0, the
normal loop filter, one token partition, one pass. The picture is RGB (a
grey image is converted first). In libwebp's order:

* colour (``picture_csp_enc.c``): each Y by ``VP8RGBToY``; U and V from
  each 2 x 2 block's gamma-compressed mean (``kGammaToLinearTab`` /
  ``kLinearToGammaTab``, gamma 0.8, edges replicated) by ``VP8RGBToU`` /
  ``VP8RGBToV``; macroblocks past the picture's edge replicate its last
  row and column;
* analysis (``analysis_enc.c``): per macroblock, over the source with its
  own neighbours as the prediction's edges, the DCT histograms of the DC
  and TM predictions of luma and of chroma give a susceptibility "alpha";
  a k-means of the alphas makes the 4 segments and their alphas;
* quantisers (``quant_enc.c::VP8SetSegmentParams``): each segment's index
  from quality 80 modulated by its alpha, the chroma deltas from the
  chroma alpha, each segment's filter strength, equal segments merged;
  the quantiser matrices with their sharpening, bias and zero thresholds
  and the rate-distortion lambdas;
* the macroblocks in raster order (``VP8EncTokenLoop``, ``VP8Decimate``
  at ``RD_OPT_BASIC``): the best 16x16 mode by distortion (SSE, and the
  weighted Hadamard distortion ``TDisto``) plus lambda times rate, then
  4x4 modes block by block against it, then the chroma mode with libwebp's
  diffusion of the chroma DC's quantisation error; rates from the level
  cost tables of the current coefficient probabilities, which are
  refreshed from the tokens' statistics every ``max(MBs / 8, 96)``
  macroblocks; the reconstruction feeds the next macroblock's prediction;
* the tokens of every macroblock (no skip flag), the coefficient
  probabilities each kept only where it pays, each segment's filter level
  raised for blocky 16x16 macroblocks (``VP8AdjustFilterStrength``);
* output: the frame header, partition 0 (segment map, modes) and the token
  partition through the boolean coder (``VP8BitWriter``), in a RIFF
  container with one ``VP8 `` chunk padded to even.

``csrc/webp_encode.cu`` holds the same encoder in C++ for the card's path.
"""

from __future__ import annotations

import ctypes
import math
import struct

import numpy as np

from superviseddescent_tpu_torch.io import vp8_enc_tables as E
from superviseddescent_tpu_torch.io import vp8_tables as T
from superviseddescent_tpu_torch.io.vp8 import wht

# PIL's settings and libwebp's defaults under them
QUALITY, SNS_STRENGTH, FILTER_STRENGTH, SHARPNESS, SEGMENTS = 80, 50, 60, 0, 4
MAX_ALPHA, ALPHA_SCALE, MAX_COEFF_THRESH = 255, 510, 31
MID_ALPHA, LOW_ALPHA, HIGH_ALPHA = 64, 30, 100
MIN_DQ_UV, MAX_DQ_UV, SNS_TO_DQ = -4, 6, 0.9
MAX_ITERS_K_MEANS, FSTRENGTH_CUTOFF = 6, 2
ANALYSIS_MODES = 2            # the analysis tries DC and TM only
QFIX, MAX_LEVEL, MAX_VARIABLE_LEVEL = 17, 2047, 67
FLATNESS_LIMIT_I4, FLATNESS_LIMIT_UV, FLATNESS_PENALTY = 3, 2, 140
I4_HEADER_BASE = 211          # VP8BitCost(0, 145): the "is 4x4" bit
MIN_COUNT = 96                # fewest macroblocks between cost refreshes
DSCALE, C1, C2, DSHIFT = 1, 7, 8, 4   # chroma DC error diffusion
NUM_TYPES, NUM_BANDS, NUM_CTX, NUM_PROBAS = 4, 8, 3, 11
# gamma tables of the chroma average (picture_csp_enc.c's InitGammaTables)
GAMMA, GAMMA_FIX, GAMMA_TAB_FIX = 0.80, 12, 7
GAMMA_TO_LINEAR = tuple(
    int(math.pow((1.0 / 255.0) * v, GAMMA) * ((1 << GAMMA_FIX) - 1) + .5)
    for v in range(256))
LINEAR_TO_GAMMA = tuple(
    int(255.0 * math.pow((float(1 << GAMMA_TAB_FIX) / ((1 << GAMMA_FIX) - 1))
                         * v, 1.0 / GAMMA) + .5)
    for v in range((1 << (GAMMA_FIX - GAMMA_TAB_FIX)) + 1))


def cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


# ---------------------------------------------------------------- colour
def rgb_to_yuv420(rgb: np.ndarray):
    """libwebp's ``ImportYUVAFromRGBA`` without alpha or dithering: uint8
    Y (H, W), U and V ((H + 1) / 2, (W + 1) / 2)."""
    c = rgb.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16
    h, w = r.shape
    pad = ((0, h & 1), (0, w & 1))
    lin = np.asarray(GAMMA_TO_LINEAR, np.int64)
    tab = np.asarray(LINEAR_TO_GAMMA, np.int64)

    def sum4(ch):
        p = lin[np.pad(ch, pad, mode="edge")]
        v = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        pos, x = v >> (GAMMA_TAB_FIX + 2), v & ((1 << (GAMMA_TAB_FIX + 2))
                                                - 1)
        out = tab[pos + 1] * x + tab[pos] * ((1 << (GAMMA_TAB_FIX + 2)) - x)
        return (out + (1 << (GAMMA_TAB_FIX - 1))) >> GAMMA_TAB_FIX
    r4, g4, b4 = sum4(r), sum4(g), sum4(b)

    def clip_uv(v):
        v = (v + (1 << 17) + (128 << 18)) >> 18
        return np.clip(v, 0, 255)
    u = clip_uv(-9719 * r4 - 19081 * g4 + 28800 * b4)
    v = clip_uv(28800 * r4 - 24116 * g4 - 4684 * b4)
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


def _macroblock_planes(plane: np.ndarray, size: int, mb_w: int, mb_h: int):
    """The plane replicated past its edges to whole macroblocks
    (``ImportBlock``)."""
    h, w = plane.shape
    return np.pad(plane, ((0, mb_h * size - h), (0, mb_w * size - w)),
                  mode="edge")


# ---------------------------------------------------------------- dsp
def ftransform(src, ref):
    """``FTransform_C`` of one 4x4 block (16 values each, raster)."""
    tmp = [0] * 16
    for i in range(4):
        d0 = src[4 * i] - ref[4 * i]
        d1 = src[4 * i + 1] - ref[4 * i + 1]
        d2 = src[4 * i + 2] - ref[4 * i + 2]
        d3 = src[4 * i + 3] - ref[4 * i + 3]
        a0, a1, a2, a3 = d0 + d3, d1 + d2, d1 - d2, d0 - d3
        tmp[4 * i] = (a0 + a1) * 8
        tmp[4 * i + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9
        tmp[4 * i + 2] = (a0 - a1) * 8
        tmp[4 * i + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9
    out = [0] * 16
    for i in range(4):
        a0 = tmp[i] + tmp[12 + i]
        a1 = tmp[4 + i] + tmp[8 + i]
        a2 = tmp[4 + i] - tmp[8 + i]
        a3 = tmp[i] - tmp[12 + i]
        out[i] = (a0 + a1 + 7) >> 4
        out[4 + i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0)
        out[8 + i] = (a0 - a1 + 7) >> 4
        out[12 + i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return out


def fwht(dcs):
    """``FTransformWHT_C``: the 16 blocks' DCs (raster) -> the Y2 block."""
    tmp = [0] * 16
    for i in range(4):
        b0, b1, b2, b3 = dcs[4 * i:4 * i + 4]
        a0, a1, a2, a3 = b0 + b2, b1 + b3, b1 - b3, b0 - b2
        tmp[4 * i], tmp[4 * i + 1] = a0 + a1, a3 + a2
        tmp[4 * i + 2], tmp[4 * i + 3] = a3 - a2, a0 - a1
    out = [0] * 16
    for i in range(4):
        a0 = tmp[i] + tmp[8 + i]
        a1 = tmp[4 + i] + tmp[12 + i]
        a2 = tmp[4 + i] - tmp[12 + i]
        a3 = tmp[i] - tmp[8 + i]
        out[i], out[4 + i] = (a0 + a1) >> 1, (a3 + a2) >> 1
        out[8 + i], out[12 + i] = (a3 - a2) >> 1, (a0 - a1) >> 1
    return out


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def itransform(ref, coeffs):
    """``ITransformOne``: the reconstruction of one 4x4 block."""
    tmp = [0] * 16
    for i in range(4):
        a = coeffs[i] + coeffs[8 + i]
        b = coeffs[i] - coeffs[8 + i]
        c = _mul2(coeffs[4 + i]) - _mul1(coeffs[12 + i])
        d = _mul1(coeffs[4 + i]) + _mul2(coeffs[12 + i])
        tmp[4 * i:4 * i + 4] = a + d, b + c, b - c, a - d
    out = [0] * 16
    for i in range(4):
        dc = tmp[i] + 4
        a = dc + tmp[8 + i]
        b = dc - tmp[8 + i]
        c = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        for x, v in enumerate((a + d, b + c, b - c, a - d)):
            out[4 * i + x] = clip(ref[4 * i + x] + (v >> 3), 0, 255)
    return out


def sse(a, b):
    return sum((x - y) * (x - y) for x, y in zip(a, b))


def _ttransform(blk, w):
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = blk[4 * i] + blk[4 * i + 2], blk[4 * i + 1] + blk[4 * i + 3]
        a2, a3 = blk[4 * i + 1] - blk[4 * i + 3], blk[4 * i] - blk[4 * i + 2]
        tmp[4 * i:4 * i + 4] = a0 + a1, a3 + a2, a3 - a2, a0 - a1
    s = 0
    for i in range(4):
        a0, a1 = tmp[i] + tmp[8 + i], tmp[4 + i] + tmp[12 + i]
        a2, a3 = tmp[4 + i] - tmp[12 + i], tmp[i] - tmp[8 + i]
        s += (w[i] * abs(a0 + a1) + w[4 + i] * abs(a3 + a2)
              + w[8 + i] * abs(a3 - a2) + w[12 + i] * abs(a0 - a1))
    return s


def tdisto(a, b):
    """``Disto4x4_C`` with ``kWeightY``."""
    return abs(_ttransform(b, E.WEIGHT_Y) - _ttransform(a, E.WEIGHT_Y)) >> 5


def mult_8b(a, b):
    return (a * b + 128) >> 8


class Matrix:
    """libwebp's ``VP8Matrix`` of one quantiser pair (``ExpandMatrix``)."""

    def __init__(self, q_dc: int, q_ac: int, kind: int):
        self.q = [q_dc] + [q_ac] * 15
        self.iq = [(1 << QFIX) // q for q in self.q]
        self.bias = [E.BIAS_MATRICES[2 * kind + (i > 0)] << (QFIX - 8)
                     for i in range(16)]
        self.zthresh = [((1 << QFIX) - 1 - b) // iq
                        for b, iq in zip(self.bias, self.iq)]
        self.sharpen = [(E.FREQ_SHARPENING[i] * self.q[i]) >> 11
                        if kind == 0 else 0 for i in range(16)]
        self.average = (sum(self.q) + 8) >> 4


def quantize_block(coeffs, m: Matrix):
    """``QuantizeBlock_C``: ``coeffs`` (raster) quantised in place to their
    dequantised values; returns the levels in zigzag order and whether any
    is non-zero."""
    levels = [0] * 16
    nz = False
    for n in range(16):
        j = T.ZIGZAG[n]
        v = coeffs[j]
        coeff = (-v if v < 0 else v) + m.sharpen[j]
        if coeff > m.zthresh[j]:
            level = min((coeff * m.iq[j] + m.bias[j]) >> QFIX, MAX_LEVEL)
            if v < 0:
                level = -level
            coeffs[j] = level * m.q[j]
            levels[n] = level
            nz |= level != 0
        else:
            coeffs[j] = 0
    return levels, nz


def _quantize_single(coeffs, m: Matrix):
    """``QuantizeSingle``: the DC alone; returns its error >> DSCALE."""
    v = coeffs[0]
    a = -v if v < 0 else v
    if a > m.zthresh[0]:
        qv = ((a * m.iq[0] + m.bias[0]) >> QFIX) * m.q[0]
        err = a - qv
        coeffs[0] = -qv if v < 0 else qv
        return (-err if v < 0 else err) >> DSCALE
    coeffs[0] = 0
    return (-a if v < 0 else a) >> DSCALE


def is_flat(levels_list, thresh: int) -> bool:
    score = 0
    for levels in levels_list:
        for i in range(1, 16):
            score += levels[i] != 0
            if score > thresh:
                return False
    return True


# ------------------------------------------------------------ predictions
def _fill(v, n):
    return [[v] * n for _ in range(n)]


def pred_dc(left, top, n, shift):
    if top is not None:
        dc = sum(top) + (sum(left) if left is not None else sum(top))
        dc = (dc + (1 << (shift - 1))) >> shift
    elif left is not None:
        dc = (2 * sum(left) + (1 << (shift - 1))) >> shift
    else:
        dc = 0x80
    return _fill(dc, n)


def pred_v(top, n):
    return [list(top) for _ in range(n)] if top is not None else _fill(127, n)


def pred_h(left, n):
    return [[v] * n for v in left] if left is not None else _fill(129, n)


def pred_tm(left, top, corner, n):
    if left is not None:
        if top is not None:
            return [[clip(t + l - corner, 0, 255) for t in top]
                    for l in left]
        return pred_h(left, n)
    return pred_v(top, n) if top is not None else _fill(129, n)


def preds_of(left, top, corner, n, shift):
    """The four 16x16 (or 8x8) predictions by mode DC, TM, V, H
    (``Intra16Preds_C`` / ``IntraChromaPreds_C``); ``left`` / ``top`` None
    where the macroblock has none."""
    return [pred_dc(left, top, n, shift), pred_tm(left, top, corner, n),
            pred_v(top, n), pred_h(left, n)]


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def pred4(mode: int, ring, at: int):
    """A 4x4 prediction (``Intra4Preds_C``) from the boundary ring, the
    block's top samples starting at ``ring[at]``: ``ring[at - 1]`` the
    corner, ``ring[at - 2 - i]`` the left column, ``ring[at + 4..7]`` the
    top-right. Raster order."""
    X = ring[at - 1]
    I, J, K, L = ring[at - 2], ring[at - 3], ring[at - 4], ring[at - 5]
    A, B, C, D, E_, F, G, H = ring[at:at + 8]
    d = [0] * 16

    def put(x, y, v):
        d[x + 4 * y] = v
    if mode == T.B_DC_PRED:
        dc = (sum(ring[at:at + 4]) + I + J + K + L + 4) >> 3
        return [dc] * 16
    if mode == T.B_TM_PRED:
        return [clip(ring[at + x] + ring[at - 2 - y] - X, 0, 255)
                for y in range(4) for x in range(4)]
    if mode == T.B_VE_PRED:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
               _avg3(C, D, E_)]
        return row * 4
    if mode == T.B_HE_PRED:
        return [v for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                            _avg3(K, L, L)) for _ in range(4)]
    if mode == T.B_RD_PRED:
        for x, y, v in ((0, 3, _avg3(J, K, L)), (0, 2, _avg3(I, J, K)),
                        (0, 1, _avg3(X, I, J)), (0, 0, _avg3(A, X, I)),
                        (1, 0, _avg3(B, A, X)), (2, 0, _avg3(C, B, A)),
                        (3, 0, _avg3(D, C, B))):
            for k in range(4):
                if x + k < 4 and y + k < 4:
                    put(x + k, y + k, v)
        return d
    if mode == T.B_LD_PRED:
        vals = (_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E_),
                _avg3(D, E_, F), _avg3(E_, F, G), _avg3(F, G, H),
                _avg3(G, H, H))
        return [vals[x + y] for y in range(4) for x in range(4)]
    if mode == T.B_VR_PRED:
        for (x, y), v in (((0, 0), _avg2(X, A)), ((1, 2), _avg2(X, A)),
                          ((1, 0), _avg2(A, B)), ((2, 2), _avg2(A, B)),
                          ((2, 0), _avg2(B, C)), ((3, 2), _avg2(B, C)),
                          ((3, 0), _avg2(C, D)),
                          ((0, 3), _avg3(K, J, I)), ((0, 2), _avg3(J, I, X)),
                          ((0, 1), _avg3(I, X, A)), ((1, 3), _avg3(I, X, A)),
                          ((1, 1), _avg3(X, A, B)), ((2, 3), _avg3(X, A, B)),
                          ((2, 1), _avg3(A, B, C)), ((3, 3), _avg3(A, B, C)),
                          ((3, 1), _avg3(B, C, D))):
            put(x, y, v)
        return d
    if mode == T.B_VL_PRED:
        for (x, y), v in (((0, 0), _avg2(A, B)), ((1, 0), _avg2(B, C)),
                          ((0, 2), _avg2(B, C)), ((2, 0), _avg2(C, D)),
                          ((1, 2), _avg2(C, D)), ((3, 0), _avg2(D, E_)),
                          ((2, 2), _avg2(D, E_)),
                          ((0, 1), _avg3(A, B, C)), ((1, 1), _avg3(B, C, D)),
                          ((0, 3), _avg3(B, C, D)), ((2, 1), _avg3(C, D, E_)),
                          ((1, 3), _avg3(C, D, E_)), ((3, 1), _avg3(D, E_, F)),
                          ((2, 3), _avg3(D, E_, F)), ((3, 2), _avg3(E_, F, G)),
                          ((3, 3), _avg3(F, G, H))):
            put(x, y, v)
        return d
    if mode == T.B_HD_PRED:
        for (x, y), v in (((0, 0), _avg2(I, X)), ((2, 1), _avg2(I, X)),
                          ((0, 1), _avg2(J, I)), ((2, 2), _avg2(J, I)),
                          ((0, 2), _avg2(K, J)), ((2, 3), _avg2(K, J)),
                          ((0, 3), _avg2(L, K)),
                          ((3, 0), _avg3(A, B, C)), ((2, 0), _avg3(X, A, B)),
                          ((1, 0), _avg3(I, X, A)), ((3, 1), _avg3(I, X, A)),
                          ((1, 1), _avg3(J, I, X)), ((3, 2), _avg3(J, I, X)),
                          ((1, 2), _avg3(K, J, I)), ((3, 3), _avg3(K, J, I)),
                          ((1, 3), _avg3(L, K, J))):
            put(x, y, v)
        return d
    # B_HU_PRED
    for (x, y), v in (((0, 0), _avg2(I, J)), ((2, 0), _avg2(J, K)),
                      ((0, 1), _avg2(J, K)), ((2, 1), _avg2(K, L)),
                      ((0, 2), _avg2(K, L)), ((1, 0), _avg3(I, J, K)),
                      ((3, 0), _avg3(J, K, L)), ((1, 1), _avg3(J, K, L)),
                      ((3, 1), _avg3(K, L, L)), ((1, 2), _avg3(K, L, L)),
                      ((3, 2), L), ((2, 2), L), ((0, 3), L), ((1, 3), L),
                      ((2, 3), L), ((3, 3), L)):
        put(x, y, v)
    return d


def blocks_of(rows, n: int):
    """An n x n array (list of rows) -> its 4x4 blocks in raster order,
    each 16 values in raster order."""
    return [[rows[4 * by + y][4 * bx + x] for y in range(4) for x in range(4)]
            for by in range(n // 4) for bx in range(n // 4)]


# ---------------------------------------------------------------- costs
def bit_cost(bit: int, proba: int) -> int:
    return E.ENTROPY_COST[255 - proba] if bit else E.ENTROPY_COST[proba]


def _variable_level_cost(level: int, p) -> int:
    pattern, bits = E.LEVEL_CODES[2 * (level - 1)], E.LEVEL_CODES[
        2 * (level - 1) + 1]
    cost, i = 0, 2
    while pattern:
        if pattern & 1:
            cost += bit_cost(bits & 1, p[i])
        bits >>= 1
        pattern >>= 1
        i += 1
    return cost


class Proba:
    """The coefficient probabilities, their statistics and level costs
    (libwebp's ``VP8EncProba``)."""

    def __init__(self):
        self.coeffs = [[[list(T.COEFFS_PROBA0[t][b][c]) for c in range(3)]
                        for b in range(8)] for t in range(4)]
        self.stats = [[[[0] * NUM_PROBAS for c in range(3)]
                       for b in range(8)] for t in range(4)]
        self.dirty = True
        self.level_cost = None
        self.calculate_level_costs()

    def calculate_level_costs(self):
        """``VP8CalculateLevelCosts``: [type][position][ctx] -> costs of
        levels 0..67 (nothing is done unless the probabilities moved)."""
        if not self.dirty:
            return
        cost = []
        for t in range(NUM_TYPES):
            bands = []
            for b in range(NUM_BANDS):
                ctxs = []
                for c in range(NUM_CTX):
                    p = self.coeffs[t][b][c]
                    cost0 = bit_cost(1, p[0]) if c > 0 else 0
                    base = bit_cost(1, p[1]) + cost0
                    ctxs.append([bit_cost(0, p[1]) + cost0] + [
                        base + _variable_level_cost(v, p)
                        for v in range(1, MAX_VARIABLE_LEVEL + 1)])
                bands.append(ctxs)
            cost.append([bands[E.ENC_BANDS[n]] for n in range(16)])
        self.level_cost = cost
        self.dirty = False

    def finalize(self) -> None:
        """``FinalizeTokenProbas``: each probability from its statistics
        where that pays for its update, else the default."""
        changed = False
        for t in range(NUM_TYPES):
            for b in range(NUM_BANDS):
                for c in range(NUM_CTX):
                    for p in range(NUM_PROBAS):
                        s = self.stats[t][b][c][p]
                        nb, total = s & 0xFFFF, (s >> 16) & 0xFFFF
                        upd = T.COEFFS_UPDATE_PROBA[t][b][c][p]
                        old = T.COEFFS_PROBA0[t][b][c][p]
                        new = 255 - nb * 255 // total if nb else 255
                        old_cost = (nb * bit_cost(1, old) + (total - nb)
                                    * bit_cost(0, old) + bit_cost(0, upd))
                        new_cost = (nb * bit_cost(1, new) + (total - nb)
                                    * bit_cost(0, new) + bit_cost(1, upd)
                                    + 8 * 256)
                        if old_cost > new_cost:
                            self.coeffs[t][b][c][p] = new
                            changed |= new != old
                        else:
                            self.coeffs[t][b][c][p] = old
        self.dirty = changed


def record_stat(stats, p: int, bit: int) -> int:
    """``VP8RecordStats`` (16-bit counters halved before they overflow)."""
    s = stats[p]
    if s >= 0xFFFE0000:
        s = ((s + 1) >> 1) & 0x7FFF7FFF
    stats[p] = s + 0x00010000 + bit
    return bit


def residual_cost(proba: Proba, ctype: int, first: int, ctx0: int,
                  levels) -> int:
    """``GetResidualCost_C`` of one block's levels (zigzag order)."""
    last = -1
    for n in range(15, -1, -1):
        if levels[n]:
            last = n
            break
    prob = proba.coeffs[ctype]
    p0 = prob[first][ctx0][0]
    if last < 0:
        return bit_cost(0, p0)
    costs = proba.level_cost[ctype]
    cost = bit_cost(1, p0) if ctx0 == 0 else 0
    t = costs[first][ctx0]
    n = first
    while n < last:
        v = abs(levels[n])
        cost += E.LEVEL_FIXED_COSTS[v] + t[min(v, MAX_VARIABLE_LEVEL)]
        t = costs[n + 1][min(v, 2)]
        n += 1
    v = abs(levels[n])
    cost += E.LEVEL_FIXED_COSTS[v] + t[min(v, MAX_VARIABLE_LEVEL)]
    if n < 15:
        cost += bit_cost(0, prob[E.ENC_BANDS[n + 1]][1 if v == 1 else 2][0])
    return cost


def record_tokens(proba: Proba, ctype: int, first: int, ctx: int, levels,
                  tokens: list) -> int:
    """``VP8RecordCoeffTokens``: the block's tokens appended to ``tokens``
    as (bit, probability index or -constant), the statistics updated;
    returns whether the block has a non-zero level."""
    last = -1
    for n in range(15, -1, -1):
        if levels[n]:
            last = n
            break
    stats = proba.stats[ctype]
    base = (ctype, first, ctx)
    n = first
    s = stats[n][ctx]

    def add(bit, node, stat_node=None):
        tokens.append((bit, base + (node,)))
        record_stat(s, node if stat_node is None else stat_node, bit)
        return bit

    def const(bit, p):
        tokens.append((bit, p))
    if not add(int(last >= 0), 0):
        return 0
    while n < 16:
        c = levels[n]
        n += 1
        v = -c if c < 0 else c
        if not add(int(v != 0), 1):
            base = (ctype, E.ENC_BANDS[n], 0)
            s = stats[E.ENC_BANDS[n]][0]
            continue
        if not add(int(v > 1), 2):
            base = (ctype, E.ENC_BANDS[n], 1)
            s = stats[E.ENC_BANDS[n]][1]
        else:
            if not add(int(v > 4), 3):
                if add(int(v != 2), 4):
                    add(int(v == 4), 5)
            elif not add(int(v > 10), 6):
                if not add(int(v > 6), 7):
                    const(int(v == 6), 159)
                else:
                    const(int(v >= 9), 165)
                    const(int(not v & 1), 145)
            else:
                residue = v - 3
                if residue < (8 << 1):
                    add(0, 8)
                    add(0, 9)
                    residue -= 8 << 0
                    mask, tab = 1 << 2, T.CAT3
                elif residue < (8 << 2):
                    add(0, 8)
                    add(1, 9)
                    residue -= 8 << 1
                    mask, tab = 1 << 3, T.CAT4
                elif residue < (8 << 3):
                    add(1, 8)
                    add(0, 10, 9)
                    residue -= 8 << 2
                    mask, tab = 1 << 4, T.CAT5
                else:
                    add(1, 8)
                    add(1, 10, 9)
                    residue -= 8 << 3
                    mask, tab = 1 << 10, T.CAT6
                k = 0
                while mask:
                    const(int(bool(residue & mask)), tab[k])
                    k += 1
                    mask >>= 1
            base = (ctype, E.ENC_BANDS[n], 2)
            s = stats[E.ENC_BANDS[n]][2]
        const(int(c < 0), 128)
        if n == 16 or not add(int(n <= last), 0):
            return 1
    return 1


# ------------------------------------------------------------ bit writer
class BitWriter:
    """libwebp's ``VP8BitWriter``: range kept less one, 0xff bytes held
    back until a carry is known."""

    def __init__(self):
        self.range, self.value, self.run, self.nb_bits = 254, 0, 0, -8
        self.buf = bytearray()

    def _flush(self):
        s = 8 + self.nb_bits
        bits = self.value >> s
        self.value -= bits << s
        self.nb_bits -= 8
        if (bits & 0xFF) != 0xFF:
            if bits & 0x100 and self.buf:
                self.buf[-1] = (self.buf[-1] + 1) & 0xFF
            if self.run:
                self.buf += bytes([0x00 if bits & 0x100 else 0xFF]) * self.run
                self.run = 0
            self.buf.append(bits & 0xFF)
        else:
            self.run += 1

    def put(self, bit: int, prob: int) -> int:
        split = (self.range * prob) >> 8
        if bit:
            self.value += split + 1
            self.range -= split + 1
        else:
            self.range = split
        if self.range < 127:
            shift = 7 - (self.range + 1).bit_length() + 1
            self.range = ((self.range + 1) << shift) - 1
            self.value <<= shift
            self.nb_bits += shift
            if self.nb_bits > 0:
                self._flush()
        return bit

    def uniform(self, bit: int) -> int:
        split = self.range >> 1
        if bit:
            self.value += split + 1
            self.range -= split + 1
        else:
            self.range = split
        if self.range < 127:
            self.range = ((self.range + 1) << 1) - 1
            self.value <<= 1
            self.nb_bits += 1
            if self.nb_bits > 0:
                self._flush()
        return bit

    def value_bits(self, value: int, n: int):
        for k in range(n - 1, -1, -1):
            self.uniform((value >> k) & 1)

    def signed(self, value: int, n: int):
        if not self.uniform(int(value != 0)):
            return
        self.value_bits((-value << 1) | 1 if value < 0 else value << 1, n + 1)

    def finish(self) -> bytes:
        self.value_bits(0, 9 - self.nb_bits)
        self.nb_bits = 0
        self._flush()
        return bytes(self.buf)


# ------------------------------------------------------------- analysis
def _alpha(blocks_src, blocks_pred) -> int:
    """``CollectHistogram`` + ``GetAlpha`` over the given 4x4 blocks."""
    dist = [0] * (MAX_COEFF_THRESH + 1)
    for s, p in zip(blocks_src, blocks_pred):
        for v in ftransform(s, p):
            dist[min(abs(v) >> 3, MAX_COEFF_THRESH)] += 1
    max_value, last_non_zero = 0, 1
    for k, v in enumerate(dist):
        if v > 0:
            max_value = max(max_value, v)
            last_non_zero = k
    return ALPHA_SCALE * last_non_zero // max_value if max_value > 1 else 0


class Segment:
    """One segment's parameters (libwebp's ``VP8SegmentInfo``)."""

    def __init__(self):
        self.alpha = self.beta = self.quant = self.fstrength = 0
        self.max_edge = 0
        self.y1 = self.y2 = self.uv = None

    def copy(self):
        s = Segment()
        s.__dict__.update(self.__dict__)
        return s


class MB:
    __slots__ = ("alpha", "segment", "is_i16", "ymode", "modes", "uvmode")

    def __init__(self):
        self.alpha = self.segment = 0
        self.is_i16, self.ymode, self.modes, self.uvmode = True, 0, None, 0


class Score:
    """A rate-distortion score (libwebp's ``VP8ModeScore``)."""

    def __init__(self):
        self.D = self.SD = self.H = self.R = self.nz = 0
        self.score = 1 << 62

    def set(self, lam):
        self.score = (self.R + self.H) * lam + 256 * (self.D + self.SD)

    def copy_from(self, o):
        self.D, self.SD, self.H, self.R = o.D, o.SD, o.H, o.R
        self.nz, self.score = o.nz, o.score

    def add(self, o):
        self.D += o.D
        self.SD += o.SD
        self.H += o.H
        self.R += o.R
        self.nz |= o.nz
        self.score += o.score


class Encoder:
    """libwebp's ``VP8Encoder`` for one picture at PIL's settings."""

    def __init__(self, rgb: np.ndarray):
        self.h, self.w = rgb.shape[:2]
        self.mb_w, self.mb_h = (self.w + 15) >> 4, (self.h + 15) >> 4
        y, u, v = rgb_to_yuv420(rgb)
        self.Y = _macroblock_planes(y, 16, self.mb_w, self.mb_h).tolist()
        self.U = _macroblock_planes(u, 8, self.mb_w, self.mb_h).tolist()
        self.V = _macroblock_planes(v, 8, self.mb_w, self.mb_h).tolist()
        # the source's true extent, for the analysis's edges
        self.y_h, self.y_w = y.shape
        self.uv_h, self.uv_w = u.shape
        self.mbs = [MB() for _ in range(self.mb_w * self.mb_h)]
        self.seg = [Segment() for _ in range(4)]
        self.num_segments = SEGMENTS
        self.update_map = True
        self.segment_probas = [255, 255, 255]
        self.proba = Proba()
        self.preds = [[0] * (4 * self.mb_w) for _ in range(4 * self.mb_h)]

    # the source block of a macroblock
    def src(self, x, y):
        ys = [row[16 * x:16 * x + 16] for row in self.Y[16 * y:16 * y + 16]]
        us = [row[8 * x:8 * x + 8] for row in self.U[8 * y:8 * y + 8]]
        vs = [row[8 * x:8 * x + 8] for row in self.V[8 * y:8 * y + 8]]
        return ys, us, vs

    # ---- analysis ----
    def _source_edges(self, plane, size, x, y, h_true, w_true):
        """``VP8IteratorImport``'s edges from the source: (left, top,
        corner), None where the macroblock has none."""
        left = top = None
        corner = 127
        if x > 0:
            rows = min(size, h_true - size * y)
            left = [plane[size * y + min(i, rows - 1)][size * x - 1]
                    for i in range(size)]
            corner = plane[size * y - 1][size * x - 1] if y > 0 else 127
        if y > 0:
            cols = min(size, w_true - size * x)
            top = [plane[size * y - 1][size * x + min(i, cols - 1)]
                   for i in range(size)]
        return left, top, corner

    def analyze(self):
        alphas = [0] * (MAX_ALPHA + 1)
        uv_sum = 0
        for y in range(self.mb_h):
            for x in range(self.mb_w):
                ys, us, vs = self.src(x, y)
                left, top, corner = self._source_edges(
                    self.Y, 16, x, y, self.y_h, self.y_w)
                sb = blocks_of(ys, 16)
                best_alpha = -1
                for pred in preds_of(left, top, corner, 16,
                                     5)[:ANALYSIS_MODES]:
                    a = _alpha(sb, blocks_of(pred, 16))
                    if a > best_alpha:
                        best_alpha = a
                ul, ut, uc = self._source_edges(self.U, 8, x, y, self.uv_h,
                                                self.uv_w)
                vl, vt, vc = self._source_edges(self.V, 8, x, y, self.uv_h,
                                                self.uv_w)
                best_uv, smallest = -1, 0
                ub, vb = blocks_of(us, 8), blocks_of(vs, 8)
                for mode, (pu, pv) in enumerate(zip(
                        preds_of(ul, ut, uc, 8, 4)[:ANALYSIS_MODES],
                        preds_of(vl, vt, vc, 8, 4)[:ANALYSIS_MODES])):
                    a = _alpha(ub + vb, blocks_of(pu, 8) + blocks_of(pv, 8))
                    best_uv = max(best_uv, a)
                    if mode == 0 or a < smallest:
                        smallest = a
                alpha = (3 * best_alpha + best_uv + 2) >> 2
                alpha = clip(MAX_ALPHA - alpha, 0, MAX_ALPHA)
                alphas[alpha] += 1
                self.mbs[y * self.mb_w + x].alpha = alpha
                uv_sum += best_uv
        total = self.mb_w * self.mb_h
        self.uv_alpha = uv_sum // total
        self.assign_segments(alphas)

    def assign_segments(self, alphas):
        nb = SEGMENTS
        min_a = next(n for n in range(MAX_ALPHA + 1) if alphas[n])
        max_a = next(n for n in range(MAX_ALPHA, min_a - 1, -1)
                     if alphas[n] or n == min_a)
        range_a = max_a - min_a
        centers = [min_a + (n * range_a) // (2 * nb)
                   for n in range(1, 2 * nb, 2)]
        amap = [0] * (MAX_ALPHA + 1)
        weighted = 0
        for _ in range(MAX_ITERS_K_MEANS):
            accum, dist = [0] * nb, [0] * nb
            n = 0
            for a in range(min_a, max_a + 1):
                if alphas[a]:
                    while n + 1 < nb and abs(a - centers[n + 1]) < abs(
                            a - centers[n]):
                        n += 1
                    amap[a] = n
                    dist[n] += a * alphas[a]
                    accum[n] += alphas[a]
            displaced = weighted = total_w = 0
            for n in range(nb):
                if accum[n]:
                    c = (dist[n] + accum[n] // 2) // accum[n]
                    displaced += abs(centers[n] - c)
                    centers[n] = c
                    weighted += c * accum[n]
                    total_w += accum[n]
            weighted = (weighted + total_w // 2) // total_w
            if displaced < 5:
                break
        for mb in self.mbs:
            mb.segment = amap[mb.alpha]
            mb.alpha = centers[amap[mb.alpha]]
        lo, hi = min(centers), max(centers)
        if hi == lo:
            hi = lo + 1
        for n in range(nb):
            self.seg[n].alpha = clip(cdiv(255 * (centers[n] - weighted),
                                          hi - lo), -127, 127)
            self.seg[n].beta = clip(cdiv(255 * (centers[n] - lo), hi - lo),
                                    0, 255)

    # ---- quantisers ----
    def set_segment_params(self):
        amp = SNS_TO_DQ * SNS_STRENGTH / 100.0 / 128.0
        q = float(np.float32(QUALITY)) / 100.0
        linear = q * (2.0 / 3.0) if q < 0.75 else 2.0 * q - 1.0
        c_base = math.pow(linear, 1 / 3.0)
        for s in self.seg[:self.num_segments]:
            expn = 1.0 - amp * s.alpha
            s.quant = clip(int(127.0 * (1.0 - math.pow(c_base, expn))), 0,
                           127)
        self.base_quant = self.seg[0].quant
        dq_uv_ac = cdiv((self.uv_alpha - MID_ALPHA) * (MAX_DQ_UV - MIN_DQ_UV),
                        HIGH_ALPHA - LOW_ALPHA)
        dq_uv_ac = clip(cdiv(dq_uv_ac * SNS_STRENGTH, 100), MIN_DQ_UV,
                        MAX_DQ_UV)
        self.dq_uv_dc = clip(cdiv(-4 * SNS_STRENGTH, 100), -15, 15)
        self.dq_uv_ac = dq_uv_ac
        level0 = 5 * FILTER_STRENGTH
        for s in self.seg:
            qstep = T.AC_TABLE[clip(s.quant, 0, 127)] >> 2
            base = filter_level(SHARPNESS, qstep)
            f = base * level0 // (256 + s.beta)
            s.fstrength = 0 if f < FSTRENGTH_CUTOFF else min(f, 63)
        if self.num_segments > 1:
            self.simplify_segments()
        self.setup_matrices()

    def simplify_segments(self):
        amap = [0, 1, 2, 3]
        final = 1
        for s1 in range(1, self.num_segments):
            found = None
            for s2 in range(final):
                if (self.seg[s1].quant == self.seg[s2].quant
                        and self.seg[s1].fstrength == self.seg[s2].fstrength):
                    found = s2
                    break
            amap[s1] = found if found is not None else final
            if found is None:
                if final != s1:
                    self.seg[final] = self.seg[s1].copy()
                final += 1
        if final < self.num_segments:
            for mb in self.mbs:
                mb.segment = amap[mb.segment]
            for i in range(final, self.num_segments):
                self.seg[i] = self.seg[final - 1].copy()
            self.num_segments = final

    def setup_matrices(self):
        for s in self.seg[:self.num_segments]:
            q = s.quant
            s.y1 = Matrix(T.DC_TABLE[clip(q, 0, 127)],
                          T.AC_TABLE[clip(q, 0, 127)], 0)
            s.y2 = Matrix(T.DC_TABLE[clip(q, 0, 127)] * 2,
                          E.AC_TABLE2[clip(q, 0, 127)], 1)
            s.uv = Matrix(T.DC_TABLE[clip(q + self.dq_uv_dc, 0, 117)],
                          T.AC_TABLE[clip(q + self.dq_uv_ac, 0, 127)], 2)
            q_i4, q_i16, q_uv = s.y1.average, s.y2.average, s.uv.average
            s.lambda_i4 = max(1, (3 * q_i4 * q_i4) >> 7)
            s.lambda_i16 = max(1, 3 * q_i16 * q_i16)
            s.lambda_uv = max(1, (3 * q_uv * q_uv) >> 6)
            s.lambda_mode = max(1, (1 * q_i4 * q_i4) >> 7)
            s.tlambda = max(1, (SNS_STRENGTH * q_i4) >> 5)
            s.min_disto = 20 * s.y1.q[0]
            s.max_edge = 0

    def set_segment_probas(self):
        p = [0] * 4
        for mb in self.mbs:
            p[mb.segment] += 1
        if self.num_segments > 1:
            def get(a, b):
                return 255 if a + b == 0 else (255 * a + (a + b) // 2) // (
                    a + b)
            pr = [get(p[0] + p[1], p[2] + p[3]), get(p[0], p[1]),
                  get(p[2], p[3])]
            self.segment_probas = pr
            self.update_map = any(v != 255 for v in pr)
            if not self.update_map:
                for mb in self.mbs:
                    mb.segment = 0
        else:
            self.update_map = False

    # ---- the macroblock loop ----
    def encode_macroblocks(self):
        mb_w, mb_h = self.mb_w, self.mb_h
        self.y_top = [[127] * 16 for _ in range(mb_w)]
        self.uv_top = [[127] * 16 for _ in range(mb_w)]
        self.top_nz = [[0] * 9 for _ in range(mb_w)]
        self.top_derr = [[[0, 0], [0, 0]] for _ in range(mb_w)]
        self.tokens = []
        max_count = max((mb_w * mb_h) >> 3, MIN_COUNT)
        cnt = max_count
        for y in range(mb_h):
            # InitLeft
            corner = 129 if y > 0 else 127
            self.y_left, self.u_left, self.v_left = [129] * 16, [129] * 8, \
                [129] * 8
            self.y_corner = self.u_corner = self.v_corner = corner
            self.left_nz = [0] * 9
            self.left_derr = [[0, 0], [0, 0]]
            for x in range(mb_w):
                cnt -= 1
                if cnt < 0:
                    self.proba.finalize()
                    self.proba.calculate_level_costs()
                    cnt = max_count
                self.decimate(x, y)
        self.proba.finalize()
        self.adjust_filter_strength()

    def decimate(self, x, y):
        mb = self.mbs[y * self.mb_w + x]
        seg = self.seg[mb.segment]
        ys, us, vs = self.src(x, y)
        left = self.y_left if x > 0 else None
        top = self.y_top[x] if y > 0 else None
        nz0 = (list(self.top_nz[x]), list(self.left_nz))
        rd = self.pick_best_intra16(mb, seg, ys, left, top, nz0, x, y)
        self.pick_best_intra4(mb, seg, ys, rd, nz0, x, y)
        self.pick_best_uv(mb, seg, us, vs, rd, nz0, x, y)
        self.record(mb, rd, x)
        self.save_boundary(rd, x, y)

    def pick_best_intra16(self, mb, seg, ys, left, top, nz0, x, y):
        src_blocks = blocks_of(ys, 16)
        flat = all(v == ys[0][0] for row in ys for v in row)
        best = None
        for mode, pred in enumerate(preds_of(left, top, self.y_corner, 16,
                                             5)):
            pb = blocks_of(pred, 16)
            tmp = [ftransform(s, p) for s, p in zip(src_blocks, pb)]
            dc = fwht([t[0] for t in tmp])
            dc_levels, nz_dc = quantize_block(dc, seg.y2)
            nz = int(nz_dc) << 24
            ac_levels = []
            for n in range(16):
                tmp[n][0] = 0
                lv, nzn = quantize_block(tmp[n], seg.y1)
                ac_levels.append(lv)
                nz |= int(nzn) << n
            dcs = wht(dc)
            recon = []
            for n in range(16):
                tmp[n][0] = dcs[n]
                recon.append(itransform(pb[n], tmp[n]))
            sc = Score()
            sc.nz = nz
            sc.D = sum(sse(s, r) for s, r in zip(src_blocks, recon))
            sc.SD = mult_8b(seg.tlambda, sum(
                tdisto(s, r) for s, r in zip(src_blocks, recon)))
            sc.H = E.FIXED_COSTS_I16[mode]
            sc.R = self.cost_luma16(dc_levels, ac_levels, nz0)
            if flat:
                flat = is_flat(ac_levels, 0)
                if flat:
                    sc.D *= 2
                    sc.SD *= 2
            sc.set(seg.lambda_i16)
            if mode == 0 or sc.score < best[0].score:
                best = (sc, mode, dc_levels, ac_levels, recon)
        sc, mode, dc_levels, ac_levels, recon = best
        sc.set(seg.lambda_mode)
        mb.is_i16, mb.ymode = True, mode
        self._set_preds(x, y, [mode] * 16)
        if (sc.nz & 0x100FFFF) == 0x1000000 and sc.D > seg.min_disto:
            seg.max_edge = max(seg.max_edge, abs(dc_levels[1]),
                               abs(dc_levels[2]), abs(dc_levels[4]))
        rd = sc
        rd.dc_levels, rd.ac_levels, rd.recon_y = dc_levels, ac_levels, recon
        return rd

    def _set_preds(self, x, y, modes):
        for j in range(4):
            self.preds[4 * y + j][4 * x:4 * x + 4] = modes[4 * j:4 * j + 4]

    def _pred_at(self, row, col):
        if row < 0 or col < 0:
            return 0
        return self.preds[row][col]

    def cost_luma16(self, dc_levels, ac_levels, nz0):
        top, left = list(nz0[0]), list(nz0[1])
        r = residual_cost(self.proba, 1, 0, top[8] + left[8], dc_levels)
        for n in range(16):
            bx, by = n & 3, n >> 2
            r += residual_cost(self.proba, 0, 1, top[bx] + left[by],
                               ac_levels[n])
            top[bx] = left[by] = int(any(ac_levels[n]))
        return r

    def pick_best_intra4(self, mb, seg, ys, rd, nz0, x, y):
        src_blocks = blocks_of(ys, 16)
        top_nz, left_nz = list(nz0[0]), list(nz0[1])
        # the boundary ring (VP8IteratorStartI4)
        ring = [0] * 37
        for i in range(16):
            ring[i] = self.y_left[15 - i]
        ring[16] = self.y_corner
        ring[17:33] = self.y_top[x]
        if x < self.mb_w - 1:
            ring[33:37] = self.y_top[x + 1][:4]
        else:
            ring[33:37] = [ring[32]] * 4
        best_sc = Score()
        best_sc.H = I4_HEADER_BASE
        best_sc.set(seg.lambda_mode)
        modes, levels_all, recon = [0] * 16, [None] * 16, [None] * 16
        for i4 in range(16):
            bx, by = i4 & 3, i4 >> 2
            at = E.TOP_LEFT_I4[i4]
            src = src_blocks[i4]
            left_m = self._pred_at(4 * y + by, 4 * x - 1) if bx == 0 \
                else modes[i4 - 1]
            top_m = self._pred_at(4 * y - 1, 4 * x + bx) if by == 0 \
                else modes[i4 - 4]
            costs = E.FIXED_COSTS_I4[100 * top_m + 10 * left_m:
                                     100 * top_m + 10 * left_m + 10]
            best = None
            for mode in range(10):
                pred = pred4(mode, ring, at)
                coeffs = ftransform(src, pred)
                levels, nz = quantize_block(coeffs, seg.y1)
                rec = itransform(pred, coeffs)
                sc = Score()
                sc.nz = int(nz) << i4
                sc.D = sse(src, rec)
                sc.SD = mult_8b(seg.tlambda, tdisto(src, rec))
                sc.H = costs[mode]
                sc.R = FLATNESS_PENALTY if mode > 0 and is_flat(
                    [levels], FLATNESS_LIMIT_I4) else 0
                sc.set(seg.lambda_i4)
                if best is not None and sc.score >= best[0].score:
                    continue
                sc.R += residual_cost(self.proba, 3, 0,
                                      top_nz[bx] + left_nz[by], levels)
                sc.set(seg.lambda_i4)
                if best is None or sc.score < best[0].score:
                    best = (sc, mode, levels, rec)
            sc, mode, levels, rec = best
            sc.set(seg.lambda_mode)
            best_sc.add(sc)
            if best_sc.score >= rd.score:
                return
            modes[i4], levels_all[i4], recon[i4] = mode, levels, rec
            top_nz[bx] = left_nz[by] = int(sc.nz != 0)
            # VP8IteratorRotateI4
            top = at
            for i in range(4):
                ring[top - 4 + i] = rec[12 + i]
            if bx != 3:
                for i in range(3):
                    ring[top + i] = rec[3 + 4 * (2 - i)]
            else:
                for i in range(4):
                    ring[top + i] = ring[top + i + 4]
        rd.copy_from(best_sc)
        rd.ac_levels, rd.recon_y = levels_all, recon
        mb.is_i16, mb.modes = False, modes
        self._set_preds(x, y, modes)

    def pick_best_uv(self, mb, seg, us, vs, rd, nz0, x, y):
        left_u = self.u_left if x > 0 else None
        left_v = self.v_left if x > 0 else None
        top_u = self.uv_top[x][:8] if y > 0 else None
        top_v = self.uv_top[x][8:] if y > 0 else None
        src = blocks_of(us, 8) + blocks_of(vs, 8)
        best = None
        for mode, (pu, pv) in enumerate(zip(
                preds_of(left_u, top_u, self.u_corner, 8, 4),
                preds_of(left_v, top_v, self.v_corner, 8, 4))):
            pb = blocks_of(pu, 8) + blocks_of(pv, 8)
            tmp = [ftransform(s, p) for s, p in zip(src, pb)]
            derr = self.correct_dc(tmp, seg.uv, x)
            levels, nz = [], 0
            for n in range(8):
                lv, nzn = quantize_block(tmp[n], seg.uv)
                levels.append(lv)
                nz |= int(nzn) << n
            recon = [itransform(p, t) for p, t in zip(pb, tmp)]
            sc = Score()
            sc.nz = nz << 16
            sc.D = sum(sse(s, r) for s, r in zip(src, recon))
            sc.H = E.FIXED_COSTS_UV[mode]
            sc.R = self.cost_uv(levels, nz0)
            if mode > 0 and is_flat(levels, FLATNESS_LIMIT_UV):
                sc.R += FLATNESS_PENALTY * 8
            sc.set(seg.lambda_uv)
            if mode == 0 or sc.score < best[0].score:
                best = (sc, mode, levels, recon, derr)
        sc, mode, levels, recon, derr = best
        mb.uvmode = mode
        rd.add(sc)
        rd.uv_levels, rd.recon_uv = levels, recon
        for ch in range(2):
            top, left = self.top_derr[x][ch], self.left_derr[ch]
            left[0] = derr[ch][0]
            left[1] = (3 * derr[ch][2]) >> 2
            top[0] = derr[ch][1]
            top[1] = derr[ch][2] - left[1]

    def correct_dc(self, tmp, m, x):
        """``CorrectDCValues``: the chroma DCs quantised with the error
        diffused from the blocks above and to the left."""
        derr = []
        for ch in range(2):
            top, left = self.top_derr[x][ch], self.left_derr[ch]
            c = tmp[4 * ch:4 * ch + 4]
            shift = DSHIFT - DSCALE
            c[0][0] += (C1 * top[0] + C2 * left[0]) >> shift
            e0 = _quantize_single(c[0], m)
            c[1][0] += (C1 * top[1] + C2 * e0) >> shift
            e1 = _quantize_single(c[1], m)
            c[2][0] += (C1 * e0 + C2 * left[1]) >> shift
            e2 = _quantize_single(c[2], m)
            c[3][0] += (C1 * e1 + C2 * e2) >> shift
            e3 = _quantize_single(c[3], m)
            derr.append((e1, e2, e3))
        return derr

    def cost_uv(self, levels, nz0):
        top, left = list(nz0[0]), list(nz0[1])
        r = 0
        for ch in (0, 2):
            for by in range(2):
                for bx in range(2):
                    lv = levels[2 * ch + 2 * by + bx]
                    r += residual_cost(self.proba, 2, 0,
                                       top[4 + ch + bx] + left[4 + ch + by],
                                       lv)
                    top[4 + ch + bx] = left[4 + ch + by] = int(any(lv))
        return r

    def record(self, mb, rd, x):
        """``RecordTokens``: the macroblock's tokens and statistics; the
        non-zero contexts carried on."""
        top, left = self.top_nz[x], self.left_nz
        p, toks = self.proba, self.tokens
        if mb.is_i16:
            top[8] = left[8] = record_tokens(p, 1, 0, top[8] + left[8],
                                             rd.dc_levels, toks)
            ctype, first = 0, 1
        else:
            ctype, first = 3, 0
        for n in range(16):
            bx, by = n & 3, n >> 2
            top[bx] = left[by] = record_tokens(
                p, ctype, first, top[bx] + left[by], rd.ac_levels[n], toks)
        for ch in (0, 2):
            for by in range(2):
                for bx in range(2):
                    top[4 + ch + bx] = left[4 + ch + by] = record_tokens(
                        p, 2, 0, top[4 + ch + bx] + left[4 + ch + by],
                        rd.uv_levels[2 * ch + 2 * by + bx], toks)

    def save_boundary(self, rd, x, y):
        """``VP8IteratorSaveBoundary``: the reconstruction's right column
        and bottom row for the next macroblocks."""
        ry, ru, rv = rd.recon_y, rd.recon_uv[:4], rd.recon_uv[4:]
        if x < self.mb_w - 1:
            self.y_left = [ry[4 * (i >> 2) + 3][4 * (i & 3) + 3]
                           for i in range(16)]
            self.u_left = [ru[2 * (i >> 2) + 1][4 * (i & 3) + 3]
                           for i in range(8)]
            self.v_left = [rv[2 * (i >> 2) + 1][4 * (i & 3) + 3]
                           for i in range(8)]
            self.y_corner = self.y_top[x][15]
            self.u_corner = self.uv_top[x][7]
            self.v_corner = self.uv_top[x][15]
        if y < self.mb_h - 1:
            self.y_top[x] = [ry[12 + (i >> 2)][12 + (i & 3)]
                             for i in range(16)]
            self.uv_top[x] = [ru[2 + (i >> 2)][12 + (i & 3)]
                              for i in range(8)] + [
                rv[2 + (i >> 2)][12 + (i & 3)] for i in range(8)]

    def adjust_filter_strength(self):
        max_level = 0
        for s in self.seg:
            if s.y2 is not None:
                level = filter_level(SHARPNESS,
                                     (s.max_edge * s.y2.q[1]) >> 3)
                s.fstrength = max(s.fstrength, level)
            max_level = max(max_level, s.fstrength)
        self.filter_level = max_level

    # ---- output ----
    def partition0(self) -> bytes:
        bw = BitWriter()
        bw.uniform(0)                                   # colour space
        bw.uniform(0)                                   # clamping type
        if bw.uniform(int(self.num_segments > 1)):
            bw.uniform(int(self.update_map))
            if bw.uniform(1):                           # update data
                bw.uniform(1)                           # absolute values
                for s in self.seg:
                    bw.signed(s.quant, 7)
                for s in self.seg:
                    bw.signed(s.fstrength, 6)
            if self.update_map:
                for p in self.segment_probas:
                    if bw.uniform(int(p != 255)):
                        bw.value_bits(p, 8)
        bw.uniform(0)                                   # normal filter
        bw.value_bits(self.filter_level, 6)
        bw.value_bits(SHARPNESS, 3)
        bw.uniform(0)                                   # no lf deltas
        bw.value_bits(0, 2)                             # one partition
        bw.value_bits(self.base_quant, 7)
        for dq in (0, 0, 0, self.dq_uv_dc, self.dq_uv_ac):
            bw.signed(dq, 4)
        bw.uniform(0)                                   # no proba update
        for t in range(NUM_TYPES):
            for b in range(NUM_BANDS):
                for c in range(NUM_CTX):
                    for p in range(NUM_PROBAS):
                        v = self.proba.coeffs[t][b][c][p]
                        if bw.put(int(v != T.COEFFS_PROBA0[t][b][c][p]),
                                  T.COEFFS_UPDATE_PROBA[t][b][c][p]):
                            bw.value_bits(v, 8)
        bw.uniform(0)                                   # no skip proba
        for i, mb in enumerate(self.mbs):
            x, y = i % self.mb_w, i // self.mb_w
            if self.update_map:
                s, p = mb.segment, self.segment_probas
                if bw.put(int(s >= 2), p[0]):
                    bw.put(s & 1, p[2])
                else:
                    bw.put(s & 1, p[1])
            if bw.put(int(mb.is_i16), T.BLOCK_SIZE_PROBA):
                m = mb.ymode
                if bw.put(int(m in (T.TM_PRED, T.H_PRED)), T.Y16_PROBA[0]):
                    bw.put(int(m == T.TM_PRED), T.Y16_PROBA[1])
                else:
                    bw.put(int(m == T.V_PRED), T.Y16_PROBA[2])
            else:
                for j in range(16):
                    bx, by = j & 3, j >> 2
                    top = self._pred_at(4 * y + by - 1, 4 * x + bx)
                    left = self._pred_at(4 * y + by, 4 * x + bx - 1)
                    put_i4_mode(bw, mb.modes[j], T.BMODES_PROBA[top][left])
            u = mb.uvmode
            if bw.put(int(u != T.DC_PRED), T.UV_PROBA[0]):
                if bw.put(int(u != T.V_PRED), T.UV_PROBA[1]):
                    bw.put(int(u != T.H_PRED), T.UV_PROBA[2])
        return bw.finish()

    def token_partition(self) -> bytes:
        bw = BitWriter()
        coeffs = self.proba.coeffs
        for bit, p in self.tokens:
            if isinstance(p, tuple):
                t, b, c, node = p
                bw.put(bit, coeffs[t][b][c][node])
            else:
                bw.put(bit, p)
        return bw.finish()

    def encode(self) -> bytes:
        self.analyze()
        self.set_segment_params()
        self.set_segment_probas()
        self.encode_macroblocks()
        part0 = self.partition0()
        part1 = self.token_partition()
        return frame(self.w, self.h, part0, part1)


def put_i4_mode(bw: BitWriter, mode: int, prob) -> None:
    if bw.put(int(mode != T.B_DC_PRED), prob[0]):
        if bw.put(int(mode != T.B_TM_PRED), prob[1]):
            if bw.put(int(mode != T.B_VE_PRED), prob[2]):
                if not bw.put(int(mode >= T.B_LD_PRED), prob[3]):
                    if bw.put(int(mode != T.B_HE_PRED), prob[4]):
                        bw.put(int(mode != T.B_RD_PRED), prob[5])
                elif bw.put(int(mode != T.B_LD_PRED), prob[6]):
                    if bw.put(int(mode != T.B_VL_PRED), prob[7]):
                        bw.put(int(mode != T.B_HD_PRED), prob[8])


def filter_level(sharpness: int, delta: int) -> int:
    """``VP8FilterStrengthFromDelta``."""
    return E.LEVELS_FROM_DELTA[64 * sharpness + min(delta, 63)]


def frame(width: int, height: int, part0: bytes, part1: bytes) -> bytes:
    """The RIFF container around a key frame of one token partition."""
    bits = 0 | (0 << 1) | (1 << 4) | (len(part0) << 5)
    vp8 = (bytes([bits & 0xFF, (bits >> 8) & 0xFF, (bits >> 16) & 0xFF])
           + b"\x9d\x01\x2a" + struct.pack("<HH", width, height)
           + part0 + part1)
    vp8 += b"\0" * (len(vp8) & 1)
    return (b"RIFF" + struct.pack("<I", 12 + len(vp8)) + b"WEBP" + b"VP8 "
            + struct.pack("<I", len(vp8)) + vp8)


def encode_webp(pixels: np.ndarray, native: bool = False,
                library=None) -> bytes:
    """uint8 grey (H, W) or RGB (H, W, 3) -> the lossy WebP file PIL
    writes. ``native``: the C++ encoder of ``csrc/webp_encode.cu``
    (``library``, a loaded build, else ``ops/_build``'s) in place of this
    module's Python."""
    pixels = np.asarray(pixels, np.uint8)
    if pixels.ndim == 2:
        pixels = np.repeat(pixels[..., None], 3, axis=2)
    pixels = np.ascontiguousarray(pixels)
    if not native:
        return Encoder(pixels).encode()
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("webp_encode")
    h, w = pixels.shape[:2]
    cap = 4 * h * w + 4096
    out = np.empty(cap, np.uint8)
    n = library.webp_encode_vp8(ctypes.c_void_p(pixels.ctypes.data), h, w,
                                ctypes.c_void_p(out.ctypes.data), cap)
    if n < 0:
        raise ValueError(f"WebP: a {w} x {h} picture is past VP8's limits"
                         if n == -1 else "WebP encoder: the output buffer "
                         "is too small")
    return out[:n].tobytes()
