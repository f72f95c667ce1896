"""JPEG 2000 tier-1 (ITU-T T.800 Annexes C and D) as OpenJPEG 2.5.4
decodes it, and a tile's code-blocks placed in its planes: the Python
twin of the host C++ decoder (``csrc/j2k_decode.cu``).

``MQ`` is the arithmetic decoder of Annex C (``opj_mqc``, with its 0xFF
0xFF sentinel after each segment) and its raw reading for the bypassed
passes. ``decode_block`` runs a code-block's passes from its most
significant bit-plane: significance propagation, magnitude refinement and
clean-up with the contexts of Annex D (zero coding by band orientation,
sign coding, refinement; run-length and uniform contexts in the clean-up),
every code-block style flag (BYPASS: raw significance and refinement
passes after the first four bit-planes; RESET: contexts reset after each
arithmetic-coded pass; TERMALL: a segment a pass; VSC: the next stripe
seen as insignificant; PTERM: nothing to do when reading; SEGSYM: four
uniform symbols after each clean-up pass), and the ROI max-shift. Values
carry OpenJPEG's extra bit: a coefficient found significant at bit-plane
p is 3 * 2^(p - 1), refined by +-2^(p - 1).

``tile_planes`` places each code-block in its tile-component's plane in
OpenJPEG's band layout (the low band at the top left of each level, HL to
its right, LH below, HH diagonal): the value halved toward zero for 5/3,
times half the band's float32 step for 9/7 (``opj_t1_clbl_decode_
processor``).
"""

from __future__ import annotations

import numpy as np

from superviseddescent_tpu_torch.io.j2k import (
    Codestream, J2kError, Tile, band_step)

# Table C.2: Qe, next state on MPS, next state on LPS, switch
QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
      0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
      0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
      0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
      0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
      0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
        20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
        17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
        33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32
# contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run, 18 uniform
CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 9, 14, 17, 18
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
MASK32 = 0xFFFFFFFF


def _zc_table(orient: int) -> list:
    """Table D.1: the zero-coding context of (h, v, d) significant
    neighbours, at index 9 h + 3 v... as h * 15 + v * 5 + d."""
    out = [0] * 45
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if orient == 3:                              # HH
                    hv = h + v
                    n = (8 if d >= 3 else (7 if hv else 6) if d == 2
                         else (5 if hv >= 2 else 4 if hv else 3) if d == 1
                         else (2 if hv >= 2 else hv))
                else:
                    a, b = (v, h) if orient == 1 else (h, v)  # HL swaps
                    if a == 2:
                        n = 8
                    elif a == 1:
                        n = 7 if b else (6 if d else 5)
                    else:
                        n = (4 if b == 2 else 3 if b == 1 else
                             2 if d >= 2 else d)
                out[h * 15 + v * 5 + d] = n
    return out


ZC = [_zc_table(o) for o in range(4)]
# Table D.3: (sign context, XOR bit) of the horizontal and vertical
# contributions, at (h + 1) * 3 + (v + 1)
SC = [(13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0),
      (12, 0), (13, 0)]


class MQ:
    """The MQ decoder (``opj_mqc``) over one segment and its raw form."""

    __slots__ = ("data", "pos", "a", "c", "ct", "state", "mps")

    def __init__(self):
        self.state = [0] * 19
        self.mps = [0] * 19
        self.reset()

    def reset(self):
        st, mps = self.state, self.mps
        for i in range(19):
            st[i] = 0
            mps[i] = 0
        st[CTX_UNI], st[CTX_AGG], st[0] = 46, 3, 4

    def start(self, seg: bytes):
        self.data = seg + b"\xff\xff"
        self.pos = 0
        self.c = (0xFF << 16) if not seg else seg[0] << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & MASK32
        self.ct -= 7
        self.a = 0x8000

    def start_raw(self, seg: bytes):
        self.data = seg + b"\xff\xff"
        self.pos = 0
        self.c = self.ct = 0

    def _bytein(self):
        d, p = self.data, self.pos
        if d[p] == 0xFF:
            if d[p + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.pos = p + 1
                self.c += d[p + 1] << 9
                self.ct = 7
        else:
            self.pos = p + 1
            self.c += d[p + 1] << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        s = self.state[cx]
        qe = QE[s]
        a = self.a - qe
        c = self.c
        if (c >> 16) < qe:
            if a < qe:
                d = self.mps[cx]
                self.state[cx] = NMPS[s]
            else:
                d = 1 - self.mps[cx]
                if SWITCH[s]:
                    self.mps[cx] = d
                self.state[cx] = NLPS[s]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return self.mps[cx]
            if a < qe:
                d = 1 - self.mps[cx]
                if SWITCH[s]:
                    self.mps[cx] = d
                self.state[cx] = NLPS[s]
            else:
                d = self.mps[cx]
                self.state[cx] = NMPS[s]
        ct = self.ct
        while True:
            if ct == 0:
                self.c = c
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & MASK32
            ct -= 1
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.data[self.pos] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c = self.data[self.pos]
                    self.pos += 1
                    self.ct = 7
            else:
                self.c = self.data[self.pos]
                self.pos += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


def decode_block(w: int, h: int, orient: int, segments, numbps: int,
                 roishift: int, style: int) -> np.ndarray:
    """A code-block's int32 values (h, w), OpenJPEG's t1 data before the
    ROI shift is undone and before the halving or the step."""
    S = w + 2
    size = S * (h + 2)
    sig = [0] * size
    neg = [0] * size
    vis = [0] * size
    mu = [0] * size
    val = [0] * size
    if w == 0 or h == 0 or not segments:
        return np.zeros((h, w), np.int32)
    bpno = roishift + numbps
    if bpno >= 31:
        raise J2kError(f"a code-block of {bpno} bit-planes")
    zc = ZC[orient]
    vsc = bool(style & VSC)
    order = []                      # (p, south seen) in stripe order
    for y0 in range(0, h, 4):
        rows = min(4, h - y0)
        for x in range(w):
            col = []
            for y in range(y0, y0 + rows):
                col.append(((y + 1) * S + x + 1,
                            not (vsc and (y & 3) == 3)))
            order.append((rows, col))
    mq = MQ()
    passtype = 2

    def zc_ctx(p, south):
        h_ = sig[p - 1] + sig[p + 1]
        v_ = sig[p - S]
        d_ = sig[p - S - 1] + sig[p - S + 1]
        if south:
            v_ += sig[p + S]
            d_ += sig[p + S - 1] + sig[p + S + 1]
        return zc[h_ * 15 + v_ * 5 + d_]

    def sign(p, south, raw):
        if raw:
            return mq.raw()
        hc = ((sig[p - 1] and (-1 if neg[p - 1] else 1))
              + (sig[p + 1] and (-1 if neg[p + 1] else 1)))
        vc = sig[p - S] and (-1 if neg[p - S] else 1)
        if south:
            vc += sig[p + S] and (-1 if neg[p + S] else 1)
        hc = 1 if hc > 0 else -1 if hc < 0 else 0
        vc = 1 if vc > 0 else -1 if vc < 0 else 0
        cx, xor = SC[(hc + 1) * 3 + vc + 1]
        return mq.decode(cx) ^ xor

    def neighbours(p, south):
        if (sig[p - 1] or sig[p + 1] or sig[p - S] or sig[p - S - 1]
                or sig[p - S + 1]):
            return True
        return south and (sig[p + S] or sig[p + S - 1] or sig[p + S + 1])

    for passes, seg in segments:
        raw = (style & BYPASS and passtype < 2 and bpno <= numbps - 4)
        if raw:
            mq.start_raw(seg)
        else:
            mq.start(seg)
        for _ in range(passes):
            if bpno < 1:
                break
            one = 1 << bpno
            half = one >> 1
            oph = one | half
            if passtype == 0:                       # significance
                for rows, col in order:
                    for p, south in col:
                        if sig[p] or not neighbours(p, south):
                            continue
                        v = mq.raw() if raw else mq.decode(zc_ctx(p, south))
                        if v:
                            s = sign(p, south, raw)
                            val[p] = -oph if s else oph
                            sig[p], neg[p] = 1, s
                        vis[p] = 1
            elif passtype == 1:                     # refinement
                for rows, col in order:
                    for p, south in col:
                        if not sig[p] or vis[p]:
                            continue
                        if raw:
                            v = mq.raw()
                        else:
                            cx = (CTX_MAG + 2 if mu[p] else CTX_MAG + 1
                                  if neighbours(p, south) else CTX_MAG)
                            v = mq.decode(cx)
                        val[p] += half if v ^ (val[p] < 0) else -half
                        mu[p] = 1
            else:                                   # clean-up
                for rows, col in order:
                    k = 0
                    if rows == 4 and not any(
                            sig[p] or vis[p] or neighbours(p, south)
                            for p, south in col):
                        if not mq.decode(CTX_AGG):
                            continue
                        k = mq.decode(CTX_UNI) << 1
                        k |= mq.decode(CTX_UNI)
                        p, south = col[k]
                        s = sign(p, south, False)
                        val[p] = -oph if s else oph
                        sig[p], neg[p] = 1, s
                        k += 1
                    for p, south in col[k:]:
                        if sig[p] or vis[p]:
                            continue
                        if mq.decode(zc_ctx(p, south)):
                            s = sign(p, south, False)
                            val[p] = -oph if s else oph
                            sig[p], neg[p] = 1, s
                    for p, _ in col:
                        vis[p] = 0
                if style & SEGSYM:
                    for _ in range(4):
                        mq.decode(CTX_UNI)
            if style & RESET and not raw:
                mq.reset()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = np.asarray(val, np.int64).reshape(h + 2, S)[1:-1, 1:-1]
    return out.astype(np.int32)


def _roi(values: np.ndarray, shift: int) -> np.ndarray:
    if not shift:
        return values
    if shift >= 31:
        return np.zeros_like(values)
    mag = np.abs(values.astype(np.int64))
    big = mag >= (1 << shift)
    mag = np.where(big, mag >> shift, mag)
    return np.where(values < 0, -mag, mag).astype(np.int32)


def place(plane: np.ndarray, res_list, r: int, band, blk_rect, values,
          reversible: bool, step: float):
    """A decoded code-block into its tile-component plane."""
    x0, y0, x1, y1 = blk_rect
    x, y = x0 - band.x0, y0 - band.y0
    if band.number & 1:
        prev = res_list[r - 1]
        x += prev.x1 - prev.x0
    if band.number & 2:
        prev = res_list[r - 1]
        y += prev.y1 - prev.y0
    if reversible:
        v = values.astype(np.int32)
        plane[y:y + y1 - y0, x:x + x1 - x0] = np.where(
            v < 0, -((-v) >> 1), v >> 1)
    else:
        plane[y:y + y1 - y0, x:x + x1 - x0] = values.astype(
            np.float32) * np.float32(0.5 * step)


def tile_planes(cs: Codestream, tile: Tile, geometry, precincts) -> list:
    """Each tile-component's plane of coefficients: int32 for 5/3,
    float32 for 9/7, (height, width) of the tile-component."""
    planes = []
    for c, tc in enumerate(geometry):
        coding = tile.comps[c]
        plane = np.zeros((tc.y1 - tc.y0, tc.x1 - tc.x0),
                         np.int32 if coding.reversible else np.float32)
        planes.append(plane)
    for (c, r, p), prc in precincts.items():
        coding = tile.comps[c]
        res_list = geometry[c].resolutions
        for band, _, _, blocks in prc.bands:
            step = (0.0 if coding.reversible
                    else band_step(cs.comps[c], band))
            for blk in blocks:
                x0, y0, x1, y1 = blk.rect
                if x1 <= x0 or y1 <= y0 or not blk.numsegs:
                    continue
                values = decode_block(x1 - x0, y1 - y0, band.number,
                                      blk.segments(), blk.numbps,
                                      coding.roishift, coding.style)
                values = _roi(values, coding.roishift)
                place(planes[c], res_list, r, band, blk.rect, values,
                      coding.reversible, step)
    return planes
