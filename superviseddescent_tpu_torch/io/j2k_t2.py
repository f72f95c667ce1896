"""JPEG 2000 tier-2 (ITU-T T.800 B.9-B.10, B.12), as OpenJPEG 2.5.4 reads
it: the order of the packets, and each packet's header and body.

``packet_order`` is OpenJPEG's packet iterator (``pi.c``): the five
progression orders (LRCP, RLCP, RPCL, PCRL, CPRL) over the tile, or the
progression changes of its POC markers, each packet once (a packet a
change has given is not given again); the position orders step over the
reference grid by the smallest precinct as ``opj_pi_next_rpcl`` and its
siblings do. ``read_packets`` reads every packet of a tile: the header
(the empty-packet bit, inclusion and zero bit-plane tag trees, the
number of passes, ``Lblock`` and the segment lengths, with bit
stuffing), from the tile's data or from PPM / PPT markers, SOP and EPH
checked, then the code-block bytes. A missing SOP or EPH marker, which
OpenJPEG passes with a warning, and any read past the data raise.

Each code-block ends as a ``Block``: its zero bit-planes (``numbps``) and
its segments, each (passes, bytes), in the order OpenJPEG's tier-1 reads
them (``opj_t2_init_seg``: one segment for every pass under TERMALL, ten
passes then alternating two raw and one arithmetic-coded under BYPASS,
else one).
"""

from __future__ import annotations

from superviseddescent_tpu_torch.io.j2k import (
    Codestream, J2kError, Tile, ceildiv, tile_rect)

TERMALL, BYPASS = 4, 1


class Bits:
    """OpenJPEG's ``opj_bio`` reader: MSB first, after a 0xFF byte the
    next gives seven bits; past the end it reads zeros."""

    __slots__ = ("data", "pos", "end", "buf", "ct")

    def __init__(self, data, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < self.end:
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        """``opj_bio_inalign``: a stuffed byte after 0xFF is skipped."""
        if (self.buf & 0xFF) == 0xFF:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < self.end:
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct = 0


class TagTree:
    """``opj_tgt``: a quad tree over a grid of leaves."""

    __slots__ = ("parent", "value", "low")

    def __init__(self, w: int, h: int):
        parent, levels = [], []
        n = 0
        while True:
            levels.append((w, h, n))
            n += w * h
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        parent = [-1] * n
        for k in range(len(levels) - 1):
            lw, lh, base = levels[k]
            pw, _, pbase = levels[k + 1]
            for j in range(lh):
                for i in range(lw):
                    parent[base + j * lw + i] = pbase + (j >> 1) * pw + (
                        i >> 1)
        self.parent = parent
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio: Bits, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if value[node] < threshold else 0


class Block:
    """A code-block's state across the packets."""

    __slots__ = ("rect", "numbps", "numlenbits", "segs", "numsegs", "data")

    def __init__(self, rect):
        self.rect = rect
        self.numbps = self.numsegs = 0
        self.numlenbits = 3
        self.segs = []          # [maxpasses, numpasses, length]
        self.data = bytearray()

    def segments(self):
        """[(passes, bytes)] of the segments, as tier-1 reads them."""
        out, at = [], 0
        for maxp, passes, length in self.segs[:self.numsegs]:
            out.append((passes, bytes(self.data[at:at + length])))
            at += length
        return out


def _init_seg(blk: Block, index: int, style: int, first: bool):
    while len(blk.segs) <= index:
        blk.segs.append([0, 0, 0])
    if style & TERMALL:
        maxp = 1
    elif style & BYPASS:
        if first:
            maxp = 10
        else:
            prev = blk.segs[index - 1][0]
            maxp = 2 if prev in (1, 10) else 1
    else:
        maxp = 109
    blk.segs[index] = [maxp, 0, 0]


def _floorlog2(n: int) -> int:
    return n.bit_length() - 1


def _passes(bio: Bits) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.bits(2)
    if n != 3:
        return 3 + n
    n = bio.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bio.bits(7)


class _Precinct:
    """The tag trees and blocks of one precinct of one resolution of one
    component: bands [(band, tree_incl, tree_msb, blocks)]."""

    __slots__ = ("bands",)

    def __init__(self, res, p: int):
        self.bands = []
        for band in res.bands:
            if band.empty:
                continue
            prc = band.precincts[p]
            blocks = [Block(rect) for rect in prc.blocks]
            n = prc.cw * prc.ch
            self.bands.append((band, TagTree(prc.cw, prc.ch) if n else None,
                               TagTree(prc.cw, prc.ch) if n else None,
                               blocks))


def _position_ok(v, t0, tr0, comp_d, level, rp):
    """OpenJPEG's test that grid position v starts a precinct of the
    resolution (B.12.1.3)."""
    return (v % (comp_d << rp) == 0) or (v == t0 and (
        (tr0 << level) % (1 << rp)) != 0)


def packet_order(cs: Codestream, tile: Tile, geometry) -> list:
    """[(layer, resolution, component, precinct)] in the tile's order."""
    tx0, ty0, tx1, ty1 = tile_rect(cs, tile.index)
    ncomp = len(cs.comps)
    nres = [c.levels + 1 for c in tile.comps]
    if tile.pocs:
        changes = [(r0, c0, min(l1, tile.layers), r1, min(c1, ncomp), prg)
                   for r0, c0, l1, r1, c1, prg in tile.pocs]
    else:
        changes = [(0, 0, tile.layers, max(nres), ncomp, tile.order)]
    dx = dy = 0
    for c, comp in enumerate(cs.comps):
        for r, res in enumerate(geometry[c].resolutions):
            level = nres[c] - 1 - r
            if res.pdx + level < 32:
                v = comp.dx * (1 << (res.pdx + level))
                dx = v if not dx else min(dx, v)
            if res.pdy + level < 32:
                v = comp.dy * (1 << (res.pdy + level))
                dy = v if not dy else min(dy, v)
    seen = set()
    out = []

    def emit(layers, r, c, p):
        for layer in layers:
            key = (layer, r, c, p)
            if key not in seen:
                seen.add(key)
                out.append(key)

    def precinct_at(c, r, x, y):
        """The precinct of (c, r) that starts at grid (x, y), or None."""
        if r >= nres[c]:
            return None
        comp = cs.comps[c]
        res = geometry[c].resolutions[r]
        level = nres[c] - 1 - r
        trx0, try0 = ceildiv(tx0, comp.dx << level), ceildiv(
            ty0, comp.dy << level)
        trx1, try1 = ceildiv(tx1, comp.dx << level), ceildiv(
            ty1, comp.dy << level)
        rpx, rpy = res.pdx + level, res.pdy + level
        if rpx >= 31 or rpy >= 31:
            return None
        if not _position_ok(y, ty0, try0, comp.dy, level, rpy):
            return None
        if not _position_ok(x, tx0, trx0, comp.dx, level, rpx):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (ceildiv(x, comp.dx << level) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (ceildiv(y, comp.dy << level) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def positions(sx, sy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += sx - (x % sx)
            y += sy - (y % sy)

    for r0, c0, l1, r1, c1, prg in changes:
        layers = range(0, l1)
        if prg == 0:                                   # LRCP
            for layer in layers:
                for r in range(r0, r1):
                    for c in range(c0, c1):
                        if r < nres[c]:
                            res = geometry[c].resolutions[r]
                            for p in range(res.pw * res.ph):
                                emit((layer,), r, c, p)
        elif prg == 1:                                 # RLCP
            for r in range(r0, r1):
                for layer in layers:
                    for c in range(c0, c1):
                        if r < nres[c]:
                            res = geometry[c].resolutions[r]
                            for p in range(res.pw * res.ph):
                                emit((layer,), r, c, p)
        elif prg == 2:                                 # RPCL
            if not dx or not dy:
                raise J2kError("no precinct step for the position orders")
            for r in range(r0, r1):
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        p = precinct_at(c, r, x, y)
                        if p is not None:
                            emit(layers, r, c, p)
        elif prg == 3:                                 # PCRL
            if not dx or not dy:
                raise J2kError("no precinct step for the position orders")
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, r1):
                        p = precinct_at(c, r, x, y)
                        if p is not None:
                            emit(layers, r, c, p)
        else:                                          # CPRL
            for c in range(c0, c1):
                comp = cs.comps[c]
                cdx = cdy = 0
                for r, res in enumerate(geometry[c].resolutions):
                    level = nres[c] - 1 - r
                    if res.pdx + level < 32:
                        v = comp.dx * (1 << (res.pdx + level))
                        cdx = v if not cdx else min(cdx, v)
                    if res.pdy + level < 32:
                        v = comp.dy * (1 << (res.pdy + level))
                        cdy = v if not cdy else min(cdy, v)
                if not cdx or not cdy:
                    raise J2kError("no precinct step for CPRL")
                for x, y in positions(cdx, cdy):
                    for r in range(r0, min(r1, nres[c])):
                        p = precinct_at(c, r, x, y)
                        if p is not None:
                            emit(layers, r, c, p)
    return out


class HeaderSource:
    """Where a tile's packet headers come from: its data, or PPM / PPT."""

    def __init__(self, data, pos=0):
        self.data, self.pos = data, pos


def read_packets(cs: Codestream, tile: Tile, geometry, ppm: HeaderSource
                 = None) -> dict:
    """Every packet of the tile: {(component, resolution, precinct):
    _Precinct} with each block's segments filled."""
    data = bytes(tile.data)
    end = len(data)
    pos = 0
    if ppm is not None:
        heads = ppm
    elif tile.ppt:
        parts = sorted(tile.ppt, key=lambda z: z[0])
        heads = HeaderSource(b"".join(p for _, p in parts))
    else:
        heads = None
    precincts = {}
    for layer, r, c, p in packet_order(cs, tile, geometry):
        key = (c, r, p)
        prc = precincts.get(key)
        if prc is None:
            prc = precincts[key] = _Precinct(
                geometry[c].resolutions[r], p)
        coding = tile.comps[c]
        if tile.sop:
            if end - pos < 6 or data[pos:pos + 2] != b"\xff\x91":
                raise J2kError("a damaged codestream: a SOP marker is "
                               "missing (OpenJPEG warns and reads on)")
            pos += 6
        if heads is None:
            src, hpos, hend = data, pos, end
        else:
            src, hpos, hend = heads.data, heads.pos, len(heads.data)
        bio = Bits(src, hpos, hend)
        included = []
        if bio.bit():
            for band, incl, msb, blocks in prc.bands:
                for k, blk in enumerate(blocks):
                    if not blk.numsegs:
                        inc = incl.decode(bio, k, layer + 1)
                    else:
                        inc = bio.bit()
                    if not inc:
                        continue
                    if not blk.numsegs:
                        i = 0
                        while not msb.decode(bio, k, i):
                            i += 1
                        blk.numbps = band.numbps + 1 - i
                        blk.numlenbits = 3
                    n = _passes(bio)
                    while bio.bit():
                        blk.numlenbits += 1
                    if not blk.numsegs:
                        segno = 0
                        _init_seg(blk, 0, coding.style, True)
                    else:
                        segno = blk.numsegs - 1
                        if blk.segs[segno][1] == blk.segs[segno][0]:
                            segno += 1
                            _init_seg(blk, segno, coding.style, False)
                    news = []
                    while True:
                        seg = blk.segs[segno]
                        take = min(seg[0] - seg[1], n)
                        nbits = blk.numlenbits + _floorlog2(take)
                        if nbits > 32:
                            raise J2kError("a segment length of more than "
                                           "32 bits")
                        news.append((segno, take, bio.bits(nbits)))
                        n -= take
                        if n <= 0:
                            break
                        segno += 1
                        _init_seg(blk, segno, coding.style, False)
                    included.append((blk, news))
        bio.align()
        hpos = bio.pos
        if tile.eph:
            if hend - hpos < 2 or src[hpos:hpos + 2] != b"\xff\x92":
                raise J2kError("a damaged codestream: an EPH marker is "
                               "missing (OpenJPEG warns and reads on)")
            hpos += 2
        if heads is None:
            pos = hpos
        else:
            heads.pos = hpos
        for blk, news in included:
            for segno, take, length in news:
                if pos + length > end:
                    raise J2kError("a damaged codestream: a code-block's "
                                   "bytes run past its tile's data")
                blk.data += data[pos:pos + length]
                pos += length
                seg = blk.segs[segno]
                seg[1] += take
                seg[2] += length
                blk.numsegs = max(blk.numsegs, segno + 1)
    return precincts
