"""A JPEG 2000 codestream's markers and geometry (ITU-T T.800 Annexes A
and B), as OpenJPEG 2.5.4, the library PIL 12.1 runs, reads them.

``parse`` reads the main header (SIZ; COD / COC, QCD / QCC, RGN, POC, PPM,
TLM / PLM, CRG and COM) and the tile-parts (SOT; COD / COC, QCD / QCC,
RGN, POC, PPT, PLT and COM; SOD and the data), and gives each tile its
coding parameters by the standard's precedence (a tile's COC over its
COD over the main COC over the main COD; the same for QCC / QCD) and the
bytes of its tile-parts joined. HTJ2K (Part 15: a CAP marker, or the HT
bit of a code-block style) is refused by name.

``tile_geometry`` is Annex B's rectangles for one tile, with OpenJPEG's
integer arithmetic (``opj_tcd_init_tile``): the tile on the reference
grid, each tile-component, its resolutions, their bands, precincts and
code-blocks, at any origin. Band numbers are OpenJPEG's: 0 LL, 1 HL, 2
LH, 3 HH. ``band_step`` is the band's dequantisation step for the 9/7
transform as OpenJPEG computes it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, CAP, COD, COC, TLM, PLM, PLT, QCD, QCC = (
    0xFF51, 0xFF50, 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58, 0xFF5C, 0xFF5D)
RGN, POC, PPM, PPT, CRG, COM, CPF = (
    0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF63, 0xFF64, 0xFF59)
HT_STYLE = 0x40
MAX_LEVELS = 32


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def ceildivpow2(a: int, b: int) -> int:
    return -((-a) >> b)


class J2kError(ValueError):
    pass


@dataclass
class Component:
    prec: int
    signed: bool
    dx: int
    dy: int


@dataclass
class Coding:
    """One tile-component's coding: COD / COC's SPcod and QCD / QCC."""
    levels: int = 0
    cbw: int = 6               # code-block width exponent
    cbh: int = 6
    style: int = 0             # code-block style flags
    reversible: bool = True    # 5/3 (qmfbid 1) or 9/7
    precincts: list = field(default_factory=list)   # (ppx, ppy) a level
    qstyle: int = 0            # 0 none, 1 scalar derived, 2 expounded
    guard: int = 2
    steps: list = field(default_factory=list)       # (expn, mant) a band
    roishift: int = 0

    def step(self, band: int) -> tuple:
        """(expn, mant) of band number ``band`` (0 the LL band, then HL,
        LH, HH of each level from the coarsest), as OpenJPEG reads them."""
        if self.qstyle == 1:
            e0, m0 = self.steps[0]
            return (max(e0 - (band - 1) // 3, 0) if band else e0), m0
        if band >= len(self.steps):
            raise J2kError("a QCD / QCC marker has fewer bands than the "
                           "decomposition")
        return self.steps[band]


@dataclass
class Tile:
    index: int
    order: int = 0
    layers: int = 1
    mct: int = 0
    sop: bool = False
    eph: bool = False
    comps: list = field(default_factory=list)     # Coding a component
    pocs: list = field(default_factory=list)
    data: bytearray = field(default_factory=bytearray)
    ppt: list = field(default_factory=list)       # (Zppt, bytes)
    parts: int = 0


@dataclass
class Codestream:
    x0: int
    y0: int
    x1: int
    y1: int
    tx0: int
    ty0: int
    tdx: int
    tdy: int
    comps: list
    tiles: dict
    ppm: bytes = None

    @property
    def tiles_across(self) -> int:
        return ceildiv(self.x1 - self.tx0, self.tdx)

    @property
    def tiles_down(self) -> int:
        return ceildiv(self.y1 - self.ty0, self.tdy)


def _u16(b, i):
    return (b[i] << 8) | b[i + 1]


def _u32(b, i):
    return struct.unpack(">I", b[i:i + 4])[0]


def _spcod(seg: bytes, at: int, coding: Coding, precincts: bool):
    if len(seg) < at + 5:
        raise J2kError("a COD / COC marker cut short")
    coding.levels = seg[at]
    coding.cbw, coding.cbh = seg[at + 1] + 2, seg[at + 2] + 2
    coding.style = seg[at + 3]
    coding.reversible = seg[at + 4] == 1
    if coding.levels > MAX_LEVELS:
        raise J2kError(f"{coding.levels} decomposition levels")
    if coding.cbw > 10 or coding.cbh > 10 or coding.cbw + coding.cbh > 12:
        raise J2kError("a code-block size past the standard's")
    if seg[at + 4] > 1:
        raise J2kError(f"wavelet transform {seg[at + 4]} is not Part 1's")
    if coding.style & HT_STYLE:
        raise J2kError("HTJ2K (Part 15) is not ported")
    if coding.style & 0x80:
        raise J2kError("a code-block style of Part 2 is not ported")
    at += 5
    if precincts:
        if len(seg) < at + coding.levels + 1:
            raise J2kError("a COD / COC marker cut short")
        coding.precincts = [(b & 15, b >> 4)
                            for b in seg[at:at + coding.levels + 1]]
        for r, (px, py) in enumerate(coding.precincts):
            if r and (px == 0 or py == 0):
                raise J2kError("a precinct of one sample below resolution "
                               "0 (OpenJPEG cannot read it)")
    else:
        coding.precincts = [(15, 15)] * (coding.levels + 1)


def _sqcd(seg: bytes, at: int, coding: Coding):
    if len(seg) < at + 1:
        raise J2kError("a QCD / QCC marker cut short")
    sq = seg[at]
    coding.qstyle, coding.guard = sq & 0x1F, sq >> 5
    at += 1
    if coding.qstyle == 0:
        coding.steps = [(b >> 3, 0) for b in seg[at:]]
    elif coding.qstyle in (1, 2):
        n = (len(seg) - at) // 2
        if coding.qstyle == 1:
            n = min(n, 1)
        coding.steps = [(_u16(seg, at + 2 * i) >> 11,
                         _u16(seg, at + 2 * i) & 0x7FF) for i in range(n)]
    else:
        raise J2kError(f"quantisation style {coding.qstyle}")
    if not coding.steps:
        raise J2kError("a QCD / QCC marker without steps")


class _Defaults:
    """The parameters of a header: COD, COC per component, QCD, QCC per
    component, RGN per component, POC."""

    def __init__(self):
        self.cod = None       # (order, layers, mct, sop, eph, Coding)
        self.coc = {}
        self.qcd = None
        self.qcc = {}
        self.rgn = {}
        self.pocs = []


def _coding_for(c: int, layers) -> Coding:
    """A component's Coding through the precedence of ``layers`` (the
    tile's _Defaults, then the main header's): in each, the component's
    COC / QCC over the COD / QCD."""
    out = Coding()
    cod = next((d.coc.get(c) or (d.cod and d.cod[5]) for d in layers
                if c in d.coc or d.cod), None)
    if cod is None:
        raise J2kError("no COD marker")
    q = next((d.qcc.get(c) or d.qcd for d in layers
              if c in d.qcc or d.qcd), None)
    if q is None:
        raise J2kError("no QCD marker")
    for name in ("levels", "cbw", "cbh", "style", "reversible", "precincts"):
        setattr(out, name, getattr(cod, name))
    for name in ("qstyle", "guard", "steps"):
        setattr(out, name, getattr(q, name))
    out.roishift = next((d.rgn[c] for d in layers if c in d.rgn), 0)
    return out


def _marker_segment(cs: bytes, i: int):
    if i + 4 > len(cs):
        raise J2kError("the codestream is cut inside a marker")
    m = _u16(cs, i)
    if m < 0xFF30:
        raise J2kError(f"expected a marker at byte {i}, found {m:04X}")
    n = _u16(cs, i + 2)
    if n < 2 or i + 2 + n > len(cs):
        raise J2kError(f"a marker segment {m:04X} past the end of the "
                       "codestream")
    return m, cs[i + 4:i + 2 + n], i + 2 + n


def _header_marker(m: int, seg: bytes, d: _Defaults, ncomp: int,
                   main: bool, tile: Tile = None, ppm: list = None):
    room = 1 if ncomp < 257 else 2

    def comp_at(at):
        c = seg[at] if room == 1 else _u16(seg, at)
        if c >= ncomp:
            raise J2kError(f"a marker names component {c} of {ncomp}")
        return c
    if m == COD:
        if len(seg) < 5:
            raise J2kError("a COD marker cut short")
        coding = Coding()
        _spcod(seg, 5, coding, bool(seg[0] & 1))
        if seg[1] > 4:
            raise J2kError(f"unknown progression order {seg[1]}")
        layers = _u16(seg, 2)
        if layers == 0:
            raise J2kError("a COD marker of no layers")
        d.cod = (seg[1], layers, seg[4], bool(seg[0] & 2), bool(seg[0] & 4),
                 coding)
        if seg[4] > 1:
            raise J2kError("a custom multiple component transform (Part 2) "
                           "is not ported")
    elif m == COC:
        c = comp_at(0)
        coding = Coding()
        _spcod(seg, room + 1, coding, bool(seg[room] & 1))
        d.coc[c] = coding
    elif m == QCD:
        coding = Coding()
        _sqcd(seg, 0, coding)
        d.qcd = coding
    elif m == QCC:
        c = comp_at(0)
        coding = Coding()
        _sqcd(seg, room, coding)
        d.qcc[c] = coding
    elif m == RGN:
        c = comp_at(0)
        if seg[room] != 0:
            raise J2kError(f"ROI style {seg[room]} is not Part 1's")
        d.rgn[c] = seg[room + 1]
    elif m == POC:
        step = 5 + 2 * room
        if len(seg) % step or not seg:
            raise J2kError("a POC marker of a wrong length")
        for at in range(0, len(seg), step):
            r0 = seg[at]
            c0 = seg[at + 1] if room == 1 else _u16(seg, at + 1)
            l1 = _u16(seg, at + 1 + room)
            r1 = seg[at + 3 + room]
            c1 = seg[at + 4 + room] if room == 1 else _u16(
                seg, at + 4 + room)
            prg = seg[at + 4 + 2 * room]
            if prg > 4:
                raise J2kError(f"unknown progression order {prg}")
            d.pocs.append((r0, c0, l1, r1, min(c1, ncomp), prg))
    elif m == PPM and main:
        ppm.append((seg[0], seg[1:]))
    elif m == PPT and not main:
        tile.ppt.append((seg[0], seg[1:]))
    elif m == CAP:
        raise J2kError("HTJ2K (Part 15) is not ported")
    elif m in (TLM, PLM, PLT, CRG, COM, CPF):
        pass
    else:
        raise J2kError(f"marker {m:04X} is not allowed in this header")


def parse(cs: bytes) -> Codestream:
    """The codestream's main header, and each tile's parameters and data."""
    if cs[:4] != b"\xff\x4f\xff\x51":
        raise J2kError("not a JPEG 2000 codestream")
    m, seg, i = _marker_segment(cs, 2)
    if len(seg) < 36:
        raise J2kError("a SIZ marker cut short")
    rsiz = _u16(seg, 0)
    if rsiz & 0x4000:
        raise J2kError("HTJ2K (Part 15) is not ported")
    x1, y1, x0, y0, tdx, tdy, tx0, ty0 = struct.unpack(">8I", seg[2:34])
    ncomp = _u16(seg, 34)
    if not 1 <= ncomp <= 16384 or len(seg) < 36 + 3 * ncomp:
        raise J2kError("a SIZ marker of a wrong length")
    comps = []
    for c in range(ncomp):
        s, dx, dy = seg[36 + 3 * c:39 + 3 * c]
        prec = (s & 0x7F) + 1
        if not (1 <= prec <= 16):
            raise J2kError(f"a precision of {prec} bits is not ported")
        if dx == 0 or dy == 0:
            raise J2kError("a subsampling of 0")
        comps.append(Component(prec, bool(s & 0x80), dx, dy))
    if not (x0 < x1 and y0 < y1 and tdx and tdy and tx0 <= x0 and ty0 <= y0
            and tx0 + tdx > x0 and ty0 + tdy > y0):
        raise J2kError("a SIZ marker of an impossible image or tile grid")
    main = _Defaults()
    ppm = []
    while True:
        if i + 2 > len(cs):
            raise J2kError("the codestream ends in its main header")
        if _u16(cs, i) == SOT:
            break
        m, seg, i = _marker_segment(cs, i)
        _header_marker(m, seg, main, ncomp, True, ppm=ppm)
    if main.cod is None or main.qcd is None:
        raise J2kError("the main header lacks COD or QCD")
    out = Codestream(x0, y0, x1, y1, tx0, ty0, tdx, tdy, comps, {})
    ntiles = out.tiles_across * out.tiles_down
    tile_defaults = {}
    while True:
        if i + 2 > len(cs):
            raise J2kError("the codestream does not end with EOC")
        m = _u16(cs, i)
        if m == EOC:
            break
        if m != SOT:
            raise J2kError(f"expected SOT at byte {i}, found {m:04X}")
        start = i
        m, seg, i = _marker_segment(cs, i)
        if len(seg) != 8:
            raise J2kError("a SOT marker of a wrong length")
        isot, psot = _u16(seg, 0), _u32(seg, 2)
        if isot >= ntiles:
            raise J2kError(f"tile {isot} of {ntiles}")
        end = start + psot if psot else len(cs) - 2
        if end > len(cs) or end < i:
            raise J2kError("a tile-part runs past the end of the codestream")
        tile = out.tiles.get(isot)
        if tile is None:
            tile = out.tiles[isot] = Tile(isot)
            tile_defaults[isot] = _Defaults()
        d = tile_defaults[isot]
        while True:
            if i + 2 > end:
                raise J2kError("a tile-part header without SOD")
            if _u16(cs, i) == SOD:
                i += 2
                break
            m, seg, i = _marker_segment(cs, i)
            if m in (COD, COC, QCD, QCC, RGN) and tile.parts:
                raise J2kError("a COD / COC / QCD / QCC / RGN marker after "
                               "a tile's first tile-part")
            _header_marker(m, seg, d, ncomp, False, tile=tile)
        tile.data += cs[i:end]
        tile.parts += 1
        i = end
    if ppm:
        out.ppm = _merge_ppm(ppm)
    for index, tile in out.tiles.items():
        d = tile_defaults[index]
        cod = d.cod or main.cod
        tile.order, tile.layers, tile.mct, tile.sop, tile.eph = cod[:5]
        tile.comps = [_coding_for(c, (d, main)) for c in range(ncomp)]
        tile.pocs = d.pocs or main.pocs
        if tile.mct and ncomp < 3:
            raise J2kError("a component transform over fewer than three "
                           "components")
        if out.ppm is not None and tile.ppt:
            raise J2kError("both PPM and PPT markers")
    if len(out.tiles) != ntiles:
        raise J2kError(f"{ntiles - len(out.tiles)} of {ntiles} tiles are "
                       "missing")
    return out


def _merge_ppm(ppm: list) -> list:
    """The PPM markers' packet headers as one list of each tile-part's
    bytes (the Nppm lengths removed), in Zppm order; a tile-part's headers
    may run on into the next marker."""
    ppm.sort(key=lambda z: z[0])
    if [z for z, _ in ppm] != list(range(len(ppm))):
        raise J2kError("PPM markers out of sequence")
    parts, remaining = [], 0
    for _, data in ppm:
        at = 0
        while at < len(data):
            if remaining:
                take = min(remaining, len(data) - at)
                parts[-1] += data[at:at + take]
                remaining -= take
                at += take
                continue
            if at + 4 > len(data):
                raise J2kError("Not enough bytes to read Nppm")
            remaining = _u32(data, at)
            parts.append(b"")
            at += 4
    if remaining:
        raise J2kError("a PPM marker cut short")
    return parts


# ---------------------------------------------------------------- #
# geometry
# ---------------------------------------------------------------- #
@dataclass
class Band:
    number: int          # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    expn: int = 0
    mant: int = 0
    numbps: int = 0      # Mb: guard bits + exponent - 1
    precincts: list = field(default_factory=list)   # Precinct a precinct

    @property
    def empty(self) -> bool:
        return self.x0 >= self.x1 or self.y0 >= self.y1


@dataclass
class Precinct:
    x0: int
    y0: int
    x1: int
    y1: int
    cw: int
    ch: int
    blocks: list         # (x0, y0, x1, y1) a code-block, in raster order


@dataclass
class Resolution:
    x0: int
    y0: int
    x1: int
    y1: int
    pdx: int
    pdy: int
    pw: int
    ph: int
    bands: list


@dataclass
class TileComponent:
    x0: int
    y0: int
    x1: int
    y1: int
    resolutions: list


def tile_rect(cs: Codestream, index: int) -> tuple:
    p, q = index % cs.tiles_across, index // cs.tiles_across
    return (max(cs.tx0 + p * cs.tdx, cs.x0), max(cs.ty0 + q * cs.tdy, cs.y0),
            min(cs.tx0 + (p + 1) * cs.tdx, cs.x1),
            min(cs.ty0 + (q + 1) * cs.tdy, cs.y1))


def tile_geometry(cs: Codestream, tile: Tile) -> list:
    """TileComponent a component of the tile (opj_tcd_init_tile)."""
    tx0, ty0, tx1, ty1 = tile_rect(cs, tile.index)
    out = []
    for comp, coding in zip(cs.comps, tile.comps):
        cx0, cy0 = ceildiv(tx0, comp.dx), ceildiv(ty0, comp.dy)
        cx1, cy1 = ceildiv(tx1, comp.dx), ceildiv(ty1, comp.dy)
        nres = coding.levels + 1
        if (cx1 - cx0) < 1 or (cy1 - cy0) < 1:
            raise J2kError("an empty tile-component")
        resolutions = []
        for r in range(nres):
            level = nres - 1 - r
            rx0, ry0 = ceildivpow2(cx0, level), ceildivpow2(cy0, level)
            rx1, ry1 = ceildivpow2(cx1, level), ceildivpow2(cy1, level)
            pdx, pdy = coding.precincts[r]
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            px1 = ceildivpow2(rx1, pdx) << pdx
            py1 = ceildivpow2(ry1, pdy) << pdy
            pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
            ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
            if r == 0:
                gx0, gy0, gw, gh = px0, py0, pdx, pdy
                numbers = (0,)
            else:
                gx0, gy0 = ceildivpow2(px0, 1), ceildivpow2(py0, 1)
                gw, gh = pdx - 1, pdy - 1
                numbers = (1, 2, 3)
            cbw, cbh = min(coding.cbw, gw), min(coding.cbh, gh)
            bands = []
            for number in numbers:
                if r == 0:
                    b = Band(0, ceildivpow2(cx0, level),
                             ceildivpow2(cy0, level),
                             ceildivpow2(cx1, level),
                             ceildivpow2(cy1, level))
                    index = 0
                else:
                    xb, yb = number & 1, number >> 1
                    b = Band(number,
                             ceildivpow2(cx0 - (xb << level), level + 1),
                             ceildivpow2(cy0 - (yb << level), level + 1),
                             ceildivpow2(cx1 - (xb << level), level + 1),
                             ceildivpow2(cy1 - (yb << level), level + 1))
                    index = 3 * (r - 1) + number
                b.expn, b.mant = coding.step(index)
                b.numbps = b.expn + coding.guard - 1
                for k in range(pw * ph):
                    sx = gx0 + (k % pw) * (1 << gw)
                    sy = gy0 + (k // pw) * (1 << gh)
                    p0x, p0y = max(sx, b.x0), max(sy, b.y0)
                    p1x = min(sx + (1 << gw), b.x1)
                    p1y = min(sy + (1 << gh), b.y1)
                    bx0, by0 = (p0x >> cbw) << cbw, (p0y >> cbh) << cbh
                    bx1 = ceildivpow2(p1x, cbw) << cbw
                    by1 = ceildivpow2(p1y, cbh) << cbh
                    cw, ch = max((bx1 - bx0) >> cbw, 0), max(
                        (by1 - by0) >> cbh, 0)
                    blocks = []
                    for j in range(cw * ch):
                        sbx = bx0 + (j % cw) * (1 << cbw)
                        sby = by0 + (j // cw) * (1 << cbh)
                        blocks.append((max(sbx, p0x), max(sby, p0y),
                                       min(sbx + (1 << cbw), p1x),
                                       min(sby + (1 << cbh), p1y)))
                    b.precincts.append(Precinct(p0x, p0y, p1x, p1y, cw, ch,
                                                blocks))
                bands.append(b)
            resolutions.append(Resolution(rx0, ry0, rx1, ry1, pdx, pdy, pw,
                                          ph, bands))
        out.append(TileComponent(cx0, cy0, cx1, cy1, resolutions))
    return out


def band_step(cs_comp: Component, band: Band) -> float:
    """OpenJPEG's float32 step of a 9/7 band (``opj_tcd_init_tile``: the
    gain is taken as 0 for every band of an irreversible decode)."""
    return float(np.float32((1.0 + band.mant / 2048.0)
                            * 2.0 ** (cs_comp.prec - band.expn)))
