"""Baseline JPEG: the parser, the entropy decoder's plain Python twin and
the pixel stage's plain PyTorch twin (no PIL, no OpenCV).

Decodes what PIL and cameras write: SOF0 / SOF1 (8-bit Huffman), 1
component (grey) or 3 (YCbCr, or RGB under an Adobe transform of 0) with
luma sampling 1x1, 2x1 or 2x2 over 1x1 chroma (4:4:4, 4:2:2, 4:2:0), one
interleaved scan, restart intervals. Everything else raises a
``ValueError`` naming the marker or the field: progressive (SOF2),
lossless (SOF3), differential and arithmetic frames, DAC, 12-bit
samples, 4-component CMYK / YCCK, other sampling factors, scans that do
not hold every component, DNL. Nothing is decoded approximately.

The pixels equal libjpeg-turbo's default decompression (PIL's) bit for
bit: dequantisation in int32 products with the quantiser taken as int16
(libjpeg's ISLOW_MULT_TYPE), the ``jidctint`` islow IDCT in int32 with
its ``range_limit`` lookup (``& RANGE_MASK``: values outside [-512, 511]
before the level shift wrap, they do not saturate), fancy upsampling
(``jdsample.c``: h2v1 and h2v2 triangle filters, edge samples replicated;
box upsampling where the chroma is at most two samples wide) and the
fixed-point YCbCr -> RGB tables of ``jdcolor.c``. The int32 products hold
libjpeg's 64-bit sums exactly for every stream an 8-bit encoder writes
(dequantised coefficients within the DCT's range).

The card runs the same two stages as ``csrc/jpeg_decode.cu`` (the host
entropy decoder and kernel J1, through ``ops/jpeg.py``); the functions
here are their plain twins, used on the CPU and by the tests.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch

EOI, SOS, DQT, DHT, DRI = 0xD9, 0xDA, 0xDB, 0xC4, 0xDD
# natural (row-major) index of the k-th coefficient in zig-zag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)
_REFUSED_SOF = {0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
                0xC5: "SOF5 (differential)", 0xC6: "SOF6 (differential "
                "progressive)", 0xC7: "SOF7 (differential lossless)",
                0xC9: "SOF9 (arithmetic coding)", 0xCA: "SOF10 (arithmetic "
                "progressive)", 0xCB: "SOF11 (arithmetic lossless)",
                0xCD: "SOF13 (arithmetic differential)", 0xCE: "SOF14 "
                "(arithmetic differential progressive)", 0xCF: "SOF15 "
                "(arithmetic differential lossless)",
                0xCC: "DAC (arithmetic coding)", 0xDC: "DNL (the height "
                "defined after the scan)"}
# pixel-stage modes: how the chroma reaches the luma grid
MODE_GREY, MODE_444, MODE_H2V1, MODE_H2V2 = 0, 1, 2, 3
_MODES = {(1, 1): MODE_444, (2, 1): MODE_H2V1, (2, 2): MODE_H2V2}
# entropy decoder errors (the host C++ decoder returns the same codes)
ERRORS = {1: "truncated entropy-coded data",
          2: "invalid Huffman code",
          3: "missing or out-of-order restart marker",
          4: "unexpected marker inside the entropy-coded data",
          5: "AC coefficient index beyond 63"}


@dataclass
class Component:
    ident: int
    h: int              # sampling factors as the MCU layout uses them
    v: int
    tq: int             # quantisation table
    td: int = 0         # DC and AC Huffman tables of the scan
    ta: int = 0
    nbx: int = 0        # blocks per row and rows of blocks (MCU-padded)
    nby: int = 0
    offset: int = 0     # first block in the coefficient array
    dw: int = 0         # samples per row and rows (libjpeg's downsampled
    dh: int = 0         # width and height)


@dataclass
class JpegFrame:
    """A parsed baseline JPEG: geometry, tables and the scan's bytes."""
    width: int
    height: int
    components: list
    qtables: dict                   # id -> (64,) int natural order
    huffman: dict = field(default_factory=dict)  # (class, id) -> bits, vals
    restart_interval: int = 0
    jfif: bool = False
    adobe_transform: int | None = None
    mcux: int = 0
    mcuy: int = 0
    mode: int = MODE_GREY
    scan: bytes = b""

    @property
    def blocks(self) -> int:
        return sum(c.nbx * c.nby for c in self.components)

    @property
    def rgb_input(self) -> bool:
        """True when three components are R, G, B (no colour transform),
        decided as libjpeg does: JFIF, then Adobe's transform, then the
        component ids 'R', 'G', 'B'."""
        if len(self.components) != 3 or self.jfif:
            return False
        if self.adobe_transform is not None:
            return self.adobe_transform == 0
        return [c.ident for c in self.components] == [82, 71, 66]

    def quant(self) -> np.ndarray:
        """(components, 64) int32 quantisers, natural order, each taken as
        int16 as libjpeg's ISLOW_MULT_TYPE holds it."""
        q = np.stack([self.qtables[c.tq] for c in self.components])
        return q.astype(np.uint16).view(np.int16).astype(np.int32)


def _segments(data: bytes):
    """(marker, payload offset, payload) of each marker segment, EOI
    last; after SOS's segment, (None, offset of the next marker, b"")
    marks the end of the entropy-coded data."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        if pos >= len(data):
            raise ValueError("JPEG stream ends before EOI")
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1                               # fill bytes
        if pos >= len(data):
            raise ValueError("JPEG stream ends before EOI")
        marker = data[pos]
        pos += 1
        if marker == EOI:
            yield marker, pos, b""
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                               # standalone markers
        if pos + 2 > len(data):
            raise ValueError("JPEG stream ends inside a marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2 or pos + length > len(data):
            raise ValueError(f"JPEG marker 0x{marker:02X} segment runs past "
                             "the end of the stream")
        yield marker, pos + 2, data[pos + 2:pos + length]
        pos += length
        if marker == SOS:
            pos = _scan_end(data, pos)
            yield None, pos, b""


def _scan_end(data: bytes, pos: int) -> int:
    """Offset of the first marker after entropy-coded data that starts at
    ``pos`` (stuffed 0xFF00 and restart markers belong to the data)."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            raise ValueError("JPEG stream ends inside the entropy-coded "
                             "data (truncated)")
        nxt = data[pos + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            pos += 1
            continue
        return pos


def _parse_sof(marker: int, body: bytes):
    if len(body) < 6:
        raise ValueError("JPEG SOF segment too short")
    precision, height, width, nf = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"JPEG SOF{marker - 0xC0}: {precision}-bit samples "
                         "(12-bit and other precisions are not supported)")
    if nf == 4:
        raise ValueError("JPEG SOF: 4-component CMYK / YCCK is not "
                         "supported")
    if nf not in (1, 3):
        raise ValueError(f"JPEG SOF: {nf} components (1 or 3 only)")
    if height == 0:
        raise ValueError("JPEG SOF: height 0, DNL (the height defined after "
                         "the scan) is not supported")
    if width == 0:
        raise ValueError("JPEG SOF: width 0")
    if len(body) < 6 + 3 * nf:
        raise ValueError("JPEG SOF segment too short")
    comps = []
    for i in range(nf):
        ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
        if tq > 3:
            raise ValueError(f"JPEG SOF: quantisation table {tq}")
        comps.append(Component(ident, hv >> 4, hv & 15, tq))
    if nf == 1:
        comps[0].h = comps[0].v = 1         # one block per MCU, any factors
    else:
        factors = [(c.h, c.v) for c in comps]
        if factors[0] not in _MODES or factors[1:] != [(1, 1), (1, 1)]:
            raise ValueError(
                "JPEG SOF: sampling factors " + " ".join(
                    f"{h}x{v}" for h, v in factors) + " are not supported "
                "(luma 1x1, 2x1 or 2x2 over 1x1 chroma only: 4:4:4, 4:2:2, "
                "4:2:0; not 4:4:0 or 4:1:1)")
    return width, height, comps


def _parse_dqt(body: bytes, tables: dict):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        n = 64 * (pq + 1)
        if pq > 1 or tq > 3 or pos + 1 + n > len(body):
            raise ValueError("JPEG DQT: bad table")
        raw = np.frombuffer(body[pos + 1:pos + 1 + n],
                            ">u2" if pq else np.uint8).astype(np.int64)
        table = np.zeros(64, np.int64)
        table[ZIGZAG] = raw
        tables[tq] = table
        pos += 1 + n


def _parse_dht(body: bytes, tables: dict):
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise ValueError("JPEG DHT: bad table")
        tc, th = body[pos] >> 4, body[pos] & 15
        bits = list(body[pos + 1:pos + 17])
        n = sum(bits)
        if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
            raise ValueError("JPEG DHT: bad table")
        vals = list(body[pos + 17:pos + 17 + n])
        if tc == 0 and max(vals, default=0) > 15:
            raise ValueError("JPEG DHT: DC symbol above 15")
        huffman_codes(bits, vals)                   # validates the lengths
        tables[(tc, th)] = (bits, vals)
        pos += 17 + n


def parse_jpeg(data: bytes) -> JpegFrame:
    """Parse a baseline JPEG's markers; raises ``ValueError`` naming what
    it does not support."""
    qtables, huffman = {}, {}
    frame = None
    restart = 0
    jfif, adobe = False, None
    scan_start = scan = None
    for marker, pos, body in _segments(data):
        if marker is None:                          # end of the scan's data
            scan = data[scan_start:pos]
            continue
        if scan is not None and marker != EOI:
            if marker == SOS:
                raise ValueError("JPEG: more than one scan (non-interleaved "
                                 "or multi-scan baseline) is not supported")
            if marker in (DHT, DQT, DRI):
                raise ValueError("JPEG: tables after the scan (multi-scan "
                                 "streams are not supported)")
            continue
        if marker in (0xC0, 0xC1):
            frame = _parse_sof(marker, body)
        elif marker in _REFUSED_SOF:
            raise ValueError(f"JPEG {_REFUSED_SOF[marker]} is not supported "
                             "(baseline SOF0 / SOF1 only)")
        elif marker == DQT:
            _parse_dqt(body, qtables)
        elif marker == DHT:
            _parse_dht(body, huffman)
        elif marker == DRI:
            if len(body) < 2:
                raise ValueError("JPEG DRI segment too short")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == SOS:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            _parse_sos(body, frame[2])
            scan_start = pos + len(body)
        elif marker == EOI:
            break
        elif 0xC0 <= marker <= 0xCF or marker in (0xDE, 0xDF):
            raise ValueError(f"JPEG marker 0x{marker:02X} is not supported")
        # APPn, COM and the rest carry nothing the pixels depend on
    if frame is None or scan is None:
        raise ValueError("JPEG: no frame or no scan before EOI")
    width, height, comps = frame
    for c in comps:
        if c.tq not in qtables:
            raise ValueError(f"JPEG: quantisation table {c.tq} not defined")
        for key in ((0, c.td), (1, c.ta)):
            if key not in huffman:
                raise ValueError(f"JPEG: Huffman table {key} not defined")
    out = JpegFrame(width, height, comps, qtables, huffman, restart, jfif,
                    adobe, scan=scan)
    _layout(out)
    return out


def _parse_sos(body: bytes, comps) -> None:
    ns = body[0] if body else 0
    if len(body) < 4 + 2 * ns:
        raise ValueError("JPEG SOS segment too short")
    if ns != len(comps):
        raise ValueError(f"JPEG SOS: a scan of {ns} of {len(comps)} "
                         "components (non-interleaved scans are not "
                         "supported)")
    for i, comp in enumerate(comps):
        cs, t = body[1 + 2 * i], body[2 + 2 * i]
        if cs != comp.ident:
            raise ValueError("JPEG SOS: components out of frame order")
        comp.td, comp.ta = t >> 4, t & 15
        if comp.td > 3 or comp.ta > 3:
            raise ValueError("JPEG SOS: bad Huffman table selector")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, a) != (0, 63, 0):
        raise ValueError(f"JPEG SOS: spectral selection {ss}-{se}, "
                         f"approximation {a} (a progressive scan)")


def _layout(f: JpegFrame) -> None:
    """The MCU grid, each component's block grid (MCU-padded, as libjpeg's
    coefficient arrays) and its real sample extent."""
    hmax = max(c.h for c in f.components)
    vmax = max(c.v for c in f.components)
    f.mcux = -(-f.width // (8 * hmax))
    f.mcuy = -(-f.height // (8 * vmax))
    offset = 0
    for c in f.components:
        c.nbx, c.nby = f.mcux * c.h, f.mcuy * c.v
        c.dw = -(-f.width * c.h // hmax)
        c.dh = -(-f.height * c.v // vmax)
        c.offset = offset
        offset += c.nbx * c.nby
    if len(f.components) == 3:
        f.mode = _MODES[(hmax, vmax)]


def huffman_codes(bits, vals):
    """Canonical codes (JPEG Annex C): [(length, code, symbol)]."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((length, code, vals[k]))
            code += 1
            k += 1
        if code >= (1 << length) and bits[length - 1]:
            raise ValueError("JPEG DHT: bad code lengths")
        code <<= 1
    return out


def _lookup16(bits, vals) -> list:
    """A 16-bit lookahead table: entry = length << 8 | symbol (0: no code
    starts with these bits)."""
    table = np.zeros(1 << 16, np.int32)
    for length, code, sym in huffman_codes(bits, vals):
        lo = code << (16 - length)
        table[lo:lo + (1 << (16 - length))] = (length << 8) | sym
    return table.tolist()


def _restart_segments(f: JpegFrame):
    """The scan split at its restart markers, each un-stuffed. Raises on a
    restart marker out of order or a stray marker."""
    data = f.scan
    segs, start, expect = [], 0, 0
    pos = 0
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            break
        end = pos
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        nxt = data[pos] if pos < len(data) else None
        if nxt == 0x00 and pos == end + 1:
            pos += 1
            continue
        if nxt is None or not 0xD0 <= nxt <= 0xD7:
            raise ValueError(f"JPEG: {ERRORS[4]}")
        if nxt != 0xD0 + expect:
            raise ValueError(f"JPEG: {ERRORS[3]}")
        expect = (expect + 1) % 8
        segs.append(data[start:end])
        pos += 1
        start = pos
    segs.append(data[start:])
    return [s.replace(b"\xff\x00", b"\xff") for s in segs]


def entropy_decode(f: JpegFrame) -> np.ndarray:
    """The scan's coefficients: (blocks, 64) int16, natural order, each
    component's blocks in raster order from ``Component.offset``. The
    plain twin of the host C++ decoder in ``csrc/jpeg_decode.cu``."""
    coef = np.zeros((f.blocks, 64), np.int16)
    tables = {key: _lookup16(*hv) for key, hv in f.huffman.items()}
    # the blocks of one MCU: (component index, DC table, AC table, the
    # block's index in MCU 0, the component)
    units = [(ci, tables[(0, c.td)], tables[(1, c.ta)],
              c.offset + by * c.nbx + bx, c)
             for ci, c in enumerate(f.components)
             for by in range(c.v) for bx in range(c.h)]
    n_mcu = f.mcux * f.mcuy
    per_seg = f.restart_interval or n_mcu
    segs = _restart_segments(f)
    if len(segs) != -(-n_mcu // per_seg):
        raise ValueError(f"JPEG: {ERRORS[3]}")
    for si, seg in enumerate(segs):
        mcus = range(si * per_seg, min((si + 1) * per_seg, n_mcu))
        try:
            consumed = _decode_segment(seg + b"\x00" * 8, mcus, f.mcux,
                                       units, coef.reshape(-1))
        except IndexError:
            consumed = 8 * len(seg) + 1      # read past the zero padding
        if consumed > 8 * len(seg):
            raise ValueError(f"JPEG: {ERRORS[1]}")
    return coef


def _decode_segment(data: bytes, mcus, mcux: int, units, flat) -> int:
    """Decode the MCUs ``mcus`` of one restart interval from un-stuffed
    ``data`` into ``flat``; returns the bits consumed. Codes are looked up
    16 bits at a time (``_lookup16``), so no code needs a slow path."""
    zz = ZIGZAG.tolist()
    buf = nbits = pos = 0
    pred = [0] * (units[-1][0] + 1)
    for mcu in mcus:
        my, mx = divmod(mcu, mcux)
        for ci, dc, ac, base, c in units:
            blk = (base + my * c.v * c.nbx + mx * c.h) * 64
            if nbits < 32:
                while nbits <= 56:
                    buf = ((buf & ((1 << nbits) - 1)) << 8) | data[pos]
                    pos += 1
                    nbits += 8
            e = dc[(buf >> (nbits - 16)) & 0xFFFF]
            if not e:
                raise ValueError(f"JPEG: {ERRORS[2]}")
            nbits -= e >> 8
            s = e & 0xFF
            diff = 0
            if s:
                diff = (buf >> (nbits - s)) & ((1 << s) - 1)
                nbits -= s
                if diff < (1 << (s - 1)):
                    diff -= (1 << s) - 1
            pred[ci] += diff
            flat[blk] = ((pred[ci] + 32768) & 0xFFFF) - 32768
            k = 1
            while k < 64:
                if nbits < 32:
                    while nbits <= 56:
                        buf = ((buf & ((1 << nbits) - 1)) << 8) | data[pos]
                        pos += 1
                        nbits += 8
                e = ac[(buf >> (nbits - 16)) & 0xFFFF]
                if not e:
                    raise ValueError(f"JPEG: {ERRORS[2]}")
                nbits -= e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError(f"JPEG: {ERRORS[5]}")
                    v = (buf >> (nbits - s)) & ((1 << s) - 1)
                    nbits -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    flat[blk + zz[k]] = v
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
    return 8 * pos - nbits


# ----------------------------------------------------------- pixel stage
CONST_BITS, PASS1_BITS = 13, 2
FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
           f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
           f2562=20995, f3072=25172)
# jdcolor.c's fixed-point YCbCr -> RGB factors (SCALEBITS 16)
CR_R, CB_B, CR_G, CB_G = 91881, 116130, 46802, 22554


def _idct_1d(x, shift):
    """libjpeg's jidctint butterfly on eight int32 tensors x[0..7] (one
    row or column of every block); outputs DESCALE'd by ``shift``."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX["f0541"]
    tmp2 = z1 + z3 * -FIX["f1847"]
    tmp3 = z1 + z2 * FIX["f0765"]
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX["f1175"]
    t0 = t0 * FIX["f0298"]
    t1 = t1 * FIX["f2053"]
    t2 = t2 * FIX["f3072"]
    t3 = t3 * FIX["f1501"]
    z1 = z1 * -FIX["f0899"]
    z2 = z2 * -FIX["f2562"]
    z3 = z3 * -FIX["f1961"] + z5
    z4 = z4 * -FIX["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def range_limit(x: torch.Tensor) -> torch.Tensor:
    """libjpeg's post-IDCT ``range_limit[x & RANGE_MASK]``: the level shift
    and a clamp to [0, 255] of x wrapped into [-512, 511]."""
    wrapped = ((x + 512) & 1023) - 512
    return torch.clamp(wrapped + 128, 0, 255)


def idct_blocks(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """(B, 64) int16 coefficients and (64,) int32 quantisers -> (B, 8, 8)
    int32 samples in [0, 255] (libjpeg's islow IDCT)."""
    d = (coef.to(torch.int32) * quant).reshape(-1, 8, 8)
    ws = _idct_1d([d[:, k, :] for k in range(8)],
                  CONST_BITS - PASS1_BITS)              # columns
    ws = torch.stack(ws, dim=1)                          # (B, row, col)
    out = _idct_1d([ws[:, :, k] for k in range(8)],
                   CONST_BITS + PASS1_BITS + 3)          # rows
    return range_limit(torch.stack(out, dim=2))


def _plane(coef, quant, c: Component) -> torch.Tensor:
    blocks = idct_blocks(coef[c.offset:c.offset + c.nbx * c.nby], quant)
    return blocks.reshape(c.nby, c.nbx, 8, 8).permute(0, 2, 1, 3).reshape(
        c.nby * 8, c.nbx * 8)


def _neighbours(n_out: int, n_in: int, device):
    """Per output sample: its input sample, the next-nearest one (edges
    replicated) and whether it is the right / lower one of its pair."""
    o = torch.arange(n_out, device=device)
    i = o >> 1
    odd = (o & 1).bool()
    j = torch.where(odd, torch.clamp(i + 1, max=n_in - 1),
                    torch.clamp(i - 1, min=0))
    return i, j, odd


def upsample(plane: torch.Tensor, c: Component, mode: int, width: int,
             height: int) -> torch.Tensor:
    """A chroma plane on the (height, width) luma grid, as libjpeg-turbo's
    fancy upsampler (box where the chroma is at most 2 samples wide)."""
    dev = plane.device
    plane = plane[:c.dh, :c.dw]
    if mode == MODE_444:
        return plane[:height, :width]
    fancy = c.dw > 2
    xi, xj, xodd = _neighbours(width, c.dw, dev)
    if mode == MODE_H2V1:
        rows = plane[:height]
        if not fancy:
            return rows[:, xi]
        return (3 * rows[:, xi] + rows[:, xj]
                + torch.where(xodd, 2, 1)) >> 2
    yi, yj, _ = _neighbours(height, c.dh, dev)
    if not fancy:
        return plane[yi][:, xi]
    colsum = 3 * plane[yi] + plane[yj]                   # (height, dw)
    return (3 * colsum[:, xi] + colsum[:, xj]
            + torch.where(xodd, 7, 8)) >> 4


def ycc_to_rgb(y, cb, cr) -> torch.Tensor:
    """jdcolor.c's ycc_rgb_convert on int32 tensors -> (..., 3) int32."""
    cb, cr = cb - 128, cr - 128
    r = y + ((CR_R * cr + 32768) >> 16)
    g = y + ((-CB_G * cb + 32768 - CR_G * cr) >> 16)
    b = y + ((CB_B * cb + 32768) >> 16)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255)


def gray_from_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """OpenCV-parity grey of int32 RGB (``ops/patches.rgb_to_gray_u8``)."""
    return (rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868
            + 8192) >> 14


def pixels_reference(coef: torch.Tensor, f: JpegFrame,
                     channels: int = 1) -> torch.Tensor:
    """The plain twin of kernel J1: (blocks, 64) int16 coefficients ->
    uint8 (H, W) grey by OpenCV's formula (Y itself for a 1-component
    image) or (H, W, 3) RGB, on the coefficients' device."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    quant = torch.as_tensor(f.quant(), device=coef.device)
    w, h = f.width, f.height
    planes = [_plane(coef, quant[i], c)
              for i, c in enumerate(f.components)]
    if f.mode == MODE_GREY:
        y = planes[0][:h, :w]
        out = y if channels == 1 else y[..., None].expand(h, w, 3)
        return out.to(torch.uint8).contiguous()
    y = planes[0][:h, :w]
    cb, cr = (upsample(p, c, f.mode, w, h)
              for p, c in zip(planes[1:], f.components[1:]))
    if f.rgb_input:
        rgb = torch.stack([y, cb, cr], dim=-1)
    else:
        rgb = ycc_to_rgb(y, cb, cr)
    out = rgb if channels == 3 else gray_from_rgb(rgb)
    return out.to(torch.uint8).contiguous()
