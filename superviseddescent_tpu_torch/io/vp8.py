"""VP8 key frames (lossy WebP): the plain Python twin of the entropy stage.

``decode_vp8`` reads a ``VP8 `` chunk's payload as libwebp's decoder does
(``src/dec/vp8_dec.c``, ``tree_dec.c``, ``quant_dec.c``, RFC 6386): the
frame tag and key-frame header (start code, 14-bit sizes with their scale
bits, colour space and clamping bits), segmentation (update map and data,
absolute or delta), the filter header (type, level, sharpness, the
reference and mode deltas), 1, 2, 4 or 8 token partitions, the quantiser
indices and deltas, the coefficient probability updates and the skip
probability; then per macroblock its segment, skip bit and modes (16x16
luma, the sixteen 4x4 ``B_PRED`` modes read under their above and left
contexts, chroma) from the first partition, and its tokens from partition
``row & (partitions - 1)`` under the non-zero contexts, dequantised by
segment as libwebp does (Y2 DC x2, Y2 AC x155/100 floored at 8, chroma DC
index clamped at 117).

What it returns is what the pixel stage reads (``ops/webp.py``):

* ``coeffs``: int16 ``(MBs, 25, 16)``, the dequantised coefficients in
  raster order: the Y2 block, the 16 Y blocks (a 16x16 macroblock's Y
  DCs are left 0 for the inverse WHT of its Y2 to fill), 4 U and 4 V;
* ``modes``: uint8 ``(MBs, 20)``: is-4x4, the 16x16 luma mode, the 16
  sub-block modes (raster order; the 16x16 mode repeated for a 16x16
  macroblock), the chroma mode, the segment;
* ``filters``: uint8 ``(MBs, 4)``: the edge limit (0: not filtered; a
  macroblock edge adds 4), the interior limit, the high-edge-variance
  threshold, and whether inner edges are filtered (``B_PRED``, or a
  non-zero token count: libwebp's ``f_inner_``).

The host C++ decoder (``csrc/webp_decode.cu``, ``webp_decode_vp8``)
returns the same arrays. An inter frame, or a frame libwebp refuses
(a bad start code, a profile past 3, a hidden frame, a partition that
runs out), raises ``ValueError`` by name.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from superviseddescent_tpu_torch.io import vp8_tables as T

# the C++ decoder's error codes (csrc/webp_decode.cu), by name
ERRORS = {1: "VP8: truncated header", 2: "VP8: bad start code",
          3: "VP8: not a key frame (an inter frame)",
          4: "VP8: bad frame header (profile, hidden frame or zero size)",
          5: "VP8: bad partition length",
          6: "VP8: first partition ends early (header)",
          7: "VP8: token partitions missing",
          8: "VP8: first partition ends early (modes)",
          9: "VP8: a token partition ends early",
          10: "VP8: image too large"}
# info's entries (the C++ decoder's int32 ``info``)
INFO = ("width", "height", "mb_w", "mb_h", "filter_type", "partitions",
        "use_segment", "update_map", "absolute_delta", "use_skip",
        "colorspace", "clamp_type", "xscale", "yscale", "sharpness",
        "use_lf_delta")
MAX_MBS = 1 << 20


def _error(code: int):
    return ValueError(ERRORS[code])


class BoolDecoder:
    """RFC 6386's boolean decoder in libwebp's form: ``range`` kept less
    one, bytes loaded as the decoder runs short, and ``eof`` set once a
    decode needs a byte past the end (libwebp then refuses the frame)."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.n = data, 0, len(data)
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False
        self._load()

    def _load(self):
        if self.pos < self.n:
            self.bits += 8
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        rng = self.range
        split = (rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng -= split
            self.value -= (split + 1) << self.bits
            b = 1
        else:
            rng = split + 1
            b = 0
        shift = 8 - rng.bit_length()
        self.bits -= shift
        self.range = (rng << shift) - 1
        return b

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed_bits(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v

    def optional_signed(self, n: int) -> int:
        return self.signed_bits(n) if self.bit(0x80) else 0


@dataclass
class Vp8Frame:
    """A decoded key frame's entropy stage (see the module docstring)."""
    info: dict
    coeffs: np.ndarray
    modes: np.ndarray
    filters: np.ndarray

    @property
    def width(self):
        return self.info["width"]

    @property
    def height(self):
        return self.info["height"]

    @property
    def mb_w(self):
        return self.info["mb_w"]

    @property
    def mb_h(self):
        return self.info["mb_h"]

    @property
    def filter_type(self):
        return self.info["filter_type"]


def frame_size(data: bytes):
    """(width, height, partition 0 length) from the frame header, checked
    as libwebp's ``VP8GetInfo`` and ``VP8GetHeaders`` check it."""
    if len(data) < 10:
        raise _error(1)
    if data[3:6] != b"\x9d\x01\x2a":
        raise _error(2)
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise _error(3)
    w = (data[6] | (data[7] << 8)) & 0x3FFF
    h = (data[8] | (data[9] << 8)) & 0x3FFF
    part0 = bits >> 5
    if ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or w == 0 or h == 0 \
            or part0 >= len(data):
        raise _error(4)
    if part0 > len(data) - 10:
        raise _error(5)
    if ((w + 15) >> 4) * ((h + 15) >> 4) > MAX_MBS:
        raise _error(10)
    return w, h, part0


def _filter_strengths(seg_filter, use_segment, absolute, level, sharpness,
                      use_lf_delta, ref_delta0, mode_delta0):
    """libwebp's ``PrecomputeFilterStrengths``: [segment][is 4x4] ->
    (limit, interior limit, hev threshold)."""
    out = []
    for s in range(T.NUM_SEGMENTS):
        base = seg_filter[s] + (0 if absolute else level) if use_segment \
            else level
        row = []
        for i4x4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_delta0
                if i4x4:
                    lv += mode_delta0
            lv = min(max(lv, 0), 63)
            if lv == 0:
                row.append((0, 0, 0))
                continue
            ilevel = lv
            if sharpness > 0:
                ilevel >>= 2 if sharpness > 4 else 1
                ilevel = min(ilevel, 9 - sharpness)
            ilevel = max(ilevel, 1)
            hev = next((v for at, v in T.HEV_LEVELS if lv >= at), 0)
            row.append((2 * lv + ilevel, ilevel, hev))
        out.append(row)
    return out


def _dequant(q, dq):
    """libwebp's ``VP8ParseQuant`` for one segment's index ``q``: the
    (DC, AC) factors of Y1, Y2 and chroma."""
    def clip(v, m):
        return min(max(v, 0), m)
    dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = dq
    y2_ac = (T.AC_TABLE[clip(q + dqy2_ac, T.Q_MAX)] * 101581) >> 16
    return ((T.DC_TABLE[clip(q + dqy1_dc, T.Q_MAX)],
             T.AC_TABLE[clip(q, T.Q_MAX)]),
            (T.DC_TABLE[clip(q + dqy2_dc, T.Q_MAX)] * 2, max(y2_ac, 8)),
            (T.DC_TABLE[clip(q + dquv_dc, T.UV_DC_Q_MAX)],
             T.AC_TABLE[clip(q + dquv_ac, T.Q_MAX)]))


def _large_value(br, p):
    """A token's value past 1 (libwebp's ``GetLargeValue``)."""
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(T.CAT1_PROBA)
        v = 7 + 2 * br.bit(T.CAT2_PROBA[0])
        return v + br.bit(T.CAT2_PROBA[1])
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in (T.CAT3, T.CAT4, T.CAT5, T.CAT6)[cat][:-1]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br, bands, ctx, dq, n, out):
    """One block's tokens from position ``n`` (libwebp's ``GetCoeffs``):
    dequantised into ``out`` (16 int16, raster order); returns the count
    libwebp returns (past the last non-zero token, or 16 after a run of
    zeros to the end)."""
    p = bands[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        nxt = bands[n + 1]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large_value(br, p)
            p = nxt[2]
        v = -v if br.bit(0x80) else v
        q = v * dq[n > 0]
        out[T.ZIGZAG[n]] = ((q + 0x8000) & 0xFFFF) - 0x8000   # int16
        n += 1
    return 16


def _modes(br, update_map, seg_proba, skip_p, top, left, stats):
    """One macroblock's segment, skip bit and modes (libwebp's
    ``ParseIntraMode``): (segment, skip, is 4x4, 16x16 mode, the 16
    sub-block modes, chroma mode). ``top`` and ``left`` are the 4x4 mode
    contexts above and to the left, updated in place."""
    segment = 0
    if update_map:
        segment = (br.bit(seg_proba[1]) if not br.bit(seg_proba[0])
                   else br.bit(seg_proba[2]) + 2)
    skip = br.bit(skip_p) if skip_p is not None else 0
    is4 = not br.bit(T.BLOCK_SIZE_PROBA)
    if not is4:
        if br.bit(T.Y16_PROBA[0]):
            ymode = T.TM_PRED if br.bit(T.Y16_PROBA[1]) else T.H_PRED
        else:
            ymode = T.V_PRED if br.bit(T.Y16_PROBA[2]) else T.DC_PRED
        top[:] = left[:] = [ymode] * 4
        sub = [ymode] * 16
        stats["y16_modes"].add(ymode)
    else:
        ymode, sub = T.B_DC_PRED, []
        for y in range(4):
            m = left[y]
            for x in range(4):
                prob = T.BMODES_PROBA[top[x]][m]
                i = T.YMODES_INTRA4[br.bit(prob[0])]
                while i > 0:
                    i = T.YMODES_INTRA4[2 * i + br.bit(prob[i])]
                m = top[x] = -i
            sub += top
            left[y] = m
        stats["b_modes"].update(sub)
    if not br.bit(T.UV_PROBA[0]):
        uvmode = T.DC_PRED
    elif not br.bit(T.UV_PROBA[1]):
        uvmode = T.V_PRED
    else:
        uvmode = T.TM_PRED if br.bit(T.UV_PROBA[2]) else T.H_PRED
    stats["uv_modes"].add(uvmode)
    stats["segments"].add(segment)
    return segment, skip, is4, ymode, sub, uvmode


class _Contexts:
    """The non-zero contexts of the token trees (libwebp's ``nz_`` and
    ``nz_dc_`` bits): per macroblock column above, and to the left."""

    def __init__(self, mb_w):
        self.top, self.top_dc = [0] * mb_w, [0] * mb_w
        self.left = self.left_dc = 0


def _residuals(br, bands, q, is4, nz: _Contexts, mb_x, out) -> bool:
    """One macroblock's tokens into ``out`` (25 lists of 16; libwebp's
    ``ParseResiduals``), the contexts updated. Returns whether any block
    is coded: a count past 1, or a non-zero DC (a 16x16 macroblock's from
    its WHT), which makes libwebp filter the inner edges."""
    y1q, y2q, uvq = q
    coded = False
    if not is4:
        n = _coeffs(br, bands[1], nz.top_dc[mb_x] + nz.left_dc, y2q, 0,
                    out[0])
        nz.top_dc[mb_x] = nz.left_dc = int(n > 0)
        first, ac = 1, bands[0]
        coded = any(out[0]) and any(wht(out[0]))
    else:
        first, ac = 0, bands[3]
    tnz, lnz = nz.top[mb_x] & 0x0F, nz.left & 0x0F
    for y in range(4):
        lb = lnz & 1
        for x in range(4):
            o = out[1 + 4 * y + x]
            n = _coeffs(br, ac, lb + (tnz & 1), y1q, first, o)
            lb = int(n > first)
            tnz = (tnz >> 1) | (lb << 7)
            coded |= n > 1 or o[0] != 0
        tnz >>= 4
        lnz = (lnz >> 1) | (lb << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz, lnz = nz.top[mb_x] >> (4 + ch), nz.left >> (4 + ch)
        for y in range(2):
            lb = lnz & 1
            for x in range(2):
                o = out[17 + 2 * ch + 2 * y + x]
                n = _coeffs(br, bands[2], lb + (tnz & 1), uvq, 0, o)
                lb = int(n > 0)
                tnz = (tnz >> 1) | (lb << 3)
                coded |= n > 1 or o[0] != 0
            tnz >>= 2
            lnz = (lnz >> 1) | (lb << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    nz.top[mb_x], nz.left = out_t, out_l
    return coded


def decode_vp8(data: bytes, stats=None) -> Vp8Frame:
    """A ``VP8 `` chunk's payload -> ``Vp8Frame``. ``stats``, a dict,
    collects what the frame used (modes, filter, partitions, segments)."""
    if stats is None:
        stats = {}
    w, h, part0 = frame_size(data)
    info = dict(width=w, height=h, mb_w=(w + 15) >> 4, mb_h=(h + 15) >> 4,
                xscale=data[7] >> 6, yscale=data[9] >> 6)
    br = BoolDecoder(data[10:10 + part0])
    rest = data[10 + part0:]
    info["colorspace"] = br.bit(0x80)
    info["clamp_type"] = br.bit(0x80)
    # segment header
    use_segment = br.bit(0x80)
    update_map, absolute = 0, 1
    seg_q, seg_f = [0] * 4, [0] * 4
    seg_proba = [T.SEGMENT_PROBA_DEFAULT] * 3
    if use_segment:
        update_map = br.bit(0x80)
        if br.bit(0x80):
            absolute = br.bit(0x80)
            seg_q = [br.optional_signed(7) for _ in range(4)]
            seg_f = [br.optional_signed(6) for _ in range(4)]
        if update_map:
            seg_proba = [br.value_bits(8) if br.bit(0x80)
                         else T.SEGMENT_PROBA_DEFAULT for _ in range(3)]
    if br.eof:
        raise _error(6)
    # filter header
    simple = br.bit(0x80)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    use_lf_delta = br.bit(0x80)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    if use_lf_delta and br.bit(0x80):
        for d in (ref_delta, mode_delta):
            for i in range(4):
                if br.bit(0x80):
                    d[i] = br.signed_bits(6)
    filter_type = 0 if level == 0 else 1 if simple else 2
    if br.eof:
        raise _error(6)
    # token partitions
    last = (1 << br.value_bits(2)) - 1
    if len(rest) < 3 * last:
        raise _error(7)
    parts, start, left = [], 3 * last, len(rest) - 3 * last
    for p in range(last):
        size = min(int.from_bytes(rest[3 * p:3 * p + 3], "little"), left)
        parts.append(BoolDecoder(rest[start:start + size]))
        start += size
        left -= size
    parts.append(BoolDecoder(rest[start:]))
    if start >= len(rest):
        raise _error(7)
    # quantisers
    base_q = br.value_bits(7)
    dq = [br.optional_signed(4) for _ in range(5)]
    if use_segment:
        segq = [_dequant(seg_q[s] + (0 if absolute else base_q), dq)
                for s in range(4)]
    else:
        segq = [_dequant(base_q, dq)] * 4
    br.bit(0x80)                                     # update_proba: ignored
    # coefficient probabilities: [type][band][ctx][node], and by position
    proba = [[[[br.value_bits(8) if br.bit(T.COEFFS_UPDATE_PROBA[t][b][c][p])
                else T.COEFFS_PROBA0[t][b][c][p] for p in range(11)]
               for c in range(3)] for b in range(8)] for t in range(4)]
    bands = [[proba[t][T.BANDS[n]] for n in range(17)] for t in range(4)]
    use_skip = br.bit(0x80)
    skip_p = br.value_bits(8) if use_skip else None
    info.update(filter_type=filter_type, partitions=last + 1,
                use_segment=use_segment, update_map=update_map,
                absolute_delta=absolute, use_skip=use_skip,
                sharpness=sharpness, use_lf_delta=use_lf_delta)
    strengths = _filter_strengths(seg_f, use_segment, absolute, level,
                                  sharpness, use_lf_delta, ref_delta[0],
                                  mode_delta[0])
    for k in ("y16_modes", "b_modes", "uv_modes", "segments"):
        stats.setdefault(k, set())
    for k, v in (("filter_types", filter_type), ("partitions", last + 1),
                 ("sharpness", sharpness)):
        stats.setdefault(k, set()).add(v)
    if use_segment:
        stats.setdefault("segment_modes", set()).add(
            "absolute" if absolute else "delta")
    for key, used in (("skip_proba", use_skip), ("lf_deltas", use_lf_delta)):
        stats[key] = stats.get(key, 0) + int(used)

    mb_w, mb_h = info["mb_w"], info["mb_h"]
    coeffs = np.zeros((mb_w * mb_h, 25, 16), np.int16)
    modes = np.zeros((mb_w * mb_h, 20), np.uint8)
    filters = np.zeros((mb_w * mb_h, 4), np.uint8)
    intra_t = [[T.B_DC_PRED] * 4 for _ in range(mb_w)]
    nz = _Contexts(mb_w)
    for mb_y in range(mb_h):
        # the row's modes, from the first partition
        intra_l = [T.B_DC_PRED] * 4
        row = [_modes(br, update_map, seg_proba, skip_p, intra_t[mb_x],
                      intra_l, stats) for mb_x in range(mb_w)]
        if br.eof:
            raise _error(8)
        # the row's tokens, from its partition
        tbr = parts[mb_y & last]
        nz.left = nz.left_dc = 0
        for mb_x, (segment, skip, is4, ymode, sub, uvmode) in enumerate(row):
            i = mb_y * mb_w + mb_x
            modes[i] = [is4, ymode, *sub, uvmode, segment]
            if not skip:
                out = [[0] * 16 for _ in range(25)]
                inner = _residuals(tbr, bands, segq[segment], is4, nz, mb_x,
                                   out)
                coeffs[i] = out
            else:
                nz.top[mb_x] = nz.left = 0
                if not is4:
                    nz.top_dc[mb_x] = nz.left_dc = 0
                inner = False
            if filter_type:
                lim, ilev, hev = strengths[segment][int(is4)]
                filters[i] = (lim, ilev, hev, int(is4 or inner))
        if tbr.eof:
            raise _error(9)
    return Vp8Frame(info=info, coeffs=coeffs, modes=modes, filters=filters)


def wht(y2) -> list:
    """libwebp's ``TransformWHT``: the Y2 block (16 ints, raster) -> the
    16 Y blocks' DCs (raster order of the blocks), int16."""
    tmp = [0] * 16
    for i in range(4):
        a0 = y2[i] + y2[12 + i]
        a1 = y2[4 + i] + y2[8 + i]
        a2 = y2[4 + i] - y2[8 + i]
        a3 = y2[i] - y2[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = tmp[4 * i] + 3
        a0 = dc + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = dc - tmp[4 * i + 3]
        for k, v in ((0, a0 + a1), (1, a3 + a2), (2, a0 - a1), (3, a3 - a2)):
            out[4 * i + k] = (((v >> 3) + 0x8000) & 0xFFFF) - 0x8000
    return out


def decode_vp8_native(data: bytes, library=None, pinned: bool = False
                      ) -> Vp8Frame:
    """The host C++ entropy stage (``csrc/webp_decode.cu``,
    ``webp_decode_vp8``) on the same payload: a ``Vp8Frame`` whose arrays
    are CPU tensors (in pinned memory where ``pinned``), equal to
    ``decode_vp8``'s. ``library``: a loaded build (the tests build it with
    g++)."""
    import ctypes

    import torch
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("webp_decode")
    w, h, _ = frame_size(data)
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    n = mb_w * mb_h

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=pinned)
    coeffs = empty((n, 25, 16), torch.int16)
    modes = empty((n, 20), torch.uint8)
    filters = empty((n, 4), torch.uint8)
    info = np.zeros(len(INFO), np.int32)
    buf = np.frombuffer(data, np.uint8)
    err = library.webp_decode_vp8(
        ctypes.c_void_p(buf.ctypes.data), len(buf), mb_w, mb_h,
        ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_void_p(modes.data_ptr()),
        ctypes.c_void_p(filters.data_ptr()), ctypes.c_void_p(info.ctypes.data))
    if err:
        raise _error(err) if err in ERRORS else ValueError(
            f"VP8: error {err}")
    return Vp8Frame(info=dict(zip(INFO, info.tolist())), coeffs=coeffs,
                    modes=modes, filters=filters)
