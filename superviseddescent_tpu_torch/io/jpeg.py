"""JPEG: the parser, the entropy decoder's plain Python twin and the pixel
stage's plain PyTorch twin (no PIL, no OpenCV).

Decodes every 8-bit Huffman-coded stream that libjpeg-turbo reads for PIL:
sequential SOF0 / SOF1 and progressive SOF2 frames, in one scan or many
(a scan over any subset of the components, DHT, DQT and DRI between
scans); 1 component (grey), 3 (YCbCr, or RGB as libjpeg decides it) or 4
(CMYK, or YCCK under an Adobe transform other than 0); sampling factors
1..4 whose ratios to the largest are whole; restart intervals; the
standard Huffman tables where a stream defines none (motion-JPEG frames).
Everything else raises a ``ValueError`` naming the marker or the field:
lossless (SOF3), differential and arithmetic frames, DAC, 12-bit
samples, fractional sampling, DNL, progressive scans out of order, and
progressive streams whose first ten coefficients are not all refined to
the last bit (libjpeg smooths those blocks; that smoothing is not ported).
Nothing is decoded approximately.

The pixels equal libjpeg-turbo's default decompression (PIL's) bit for
bit: a component's quantisation table latched at its first scan, as
``jdinput.c`` does; dequantisation in int32 products with the quantiser
taken as int16 (libjpeg's ISLOW_MULT_TYPE), the ``jidctint`` islow IDCT
in int32 with its ``range_limit`` lookup (``& RANGE_MASK``: values
outside [-512, 511] before the level shift wrap, they do not saturate),
each component upsampled as ``jdsample.c`` chooses (h2v1 and h2v2
triangle filters where the component is more than two samples wide, the
h1v2 triangle filter, else replication by whole ratios; edge samples
replicated), the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` and,
for four components, PIL's inverted CMYK (``CMYK;I``) and its CMYK -> RGB.
The int32 products hold libjpeg's 64-bit sums exactly for every stream an
8-bit encoder writes (dequantised coefficients within the DCT's range).

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
_REFUSED_SOF = {0xC3: "SOF3 (lossless)",
                0xC5: "SOF5 (differential)", 0xC6: "SOF6 (differential "
                "progressive)", 0xC7: "SOF7 (differential lossless)",
                0xC9: "SOF9 (arithmetic coding)", 0xCA: "SOF10 (arithmetic "
                "progressive)", 0xCB: "SOF11 (arithmetic lossless)",
                0xCD: "SOF13 (arithmetic differential)", 0xCE: "SOF14 "
                "(arithmetic differential progressive)", 0xCF: "SOF15 "
                "(arithmetic differential lossless)",
                0xCC: "DAC (arithmetic coding)", 0xDC: "DNL (the height "
                "defined after the scan)"}
# the colour of the components, as libjpeg decides it
COLOR_GREY, COLOR_YCC, COLOR_RGB, COLOR_CMYK, COLOR_YCCK = range(5)
# how a component reaches the output grid (``jdsample.c``): as it is, by
# replication (hexp x vexp), or by one of the triangle filters
UP_FULL, UP_BOX, UP_H2V1, UP_H1V2, UP_H2V2 = range(5)
# the most blocks an interleaved scan's MCU may hold (D_MAX_BLOCKS_IN_MCU)
MAX_BLOCKS_IN_MCU = 10
# libjpeg's block smoothing looks at the first ten zig-zag coefficients
SMOOTHING_COEFS = 10
# entropy decoder errors (the host C++ decoder returns the same codes)
ERRORS = {1: "truncated entropy-coded data",
          2: "invalid Huffman code",
          3: "missing or out-of-order restart marker",
          4: "unexpected marker inside the entropy-coded data",
          5: "AC coefficient index past the end of the scan's band (Se)",
          6: "an EOB run past the last block of the scan or restart "
             "interval",
          7: "a progressive scan out of order (Ah is not the band's last "
             "Al, or an AC scan before the component's first DC scan)"}
# libjpeg-turbo's tables for a stream that defines none (jstdhuff.c,
# JPEG Annex K.3): (class, id) -> 16 length counts, symbols
STD_HUFFMAN = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552"
             "d1f02433627282090a161718191a25262728292a3435363738393a434445"
             "464748494a535455565758595a636465666768696a737475767778797a83"
             "8485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
             "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8"
             "e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c1092333"
             "52f0156272d10a162434e125f11718191a262728292a35363738393a4344"
             "45464748494a535455565758595a636465666768696a737475767778797a"
             "82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
             "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7"
             "e8e9eaf2f3f4f5f6f7f8f9fa")}


@dataclass
class Component:
    ident: int
    h: int              # sampling factors as the MCU layout uses them
    v: int
    tq: int             # quantisation table
    quant: np.ndarray | None = None  # (64,) latched at its first scan
    nbx: int = 0        # blocks per row and rows of blocks (MCU-padded)
    nby: int = 0
    offset: int = 0     # first block in the coefficient array
    dw: int = 0         # samples per row and rows (libjpeg's downsampled
    dh: int = 0         # width and height)
    bw: int = 0         # the blocks a scan of this component alone walks:
    bh: int = 0         # ceil(dw / 8) x ceil(dh / 8)
    up: int = UP_FULL   # upsampling to the output grid, and its ratios
    hexp: int = 1
    vexp: int = 1


@dataclass
class Scan:
    """One scan: its components (indices into the frame's, in the scan's
    order), spectral selection and successive approximation, the Huffman
    tables in force for each component ((bits, symbols) or None where the
    scan needs none), the restart interval in force and its bytes."""
    comps: list
    ss: int
    se: int
    ah: int
    al: int
    dc: list
    ac: list
    restart: int = 0
    data: bytes = b""


@dataclass
class JpegFrame:
    """A parsed JPEG: geometry, latched quantisers and the scans."""
    width: int
    height: int
    components: list
    scans: list = field(default_factory=list)
    progressive: bool = False
    jfif: bool = False
    adobe_transform: int | None = None
    mcux: int = 0
    mcuy: int = 0
    # the colour space a container sets (a TIFF's photometric), over what
    # the markers say
    container_color: int | None = None

    @property
    def blocks(self) -> int:
        return sum(c.nbx * c.nby for c in self.components)

    @property
    def color(self) -> int:
        """The components' colour space: the container's where it sets
        one (``container_color``), else decided as libjpeg does: for
        three, JFIF, then Adobe's transform (0: RGB), then the component
        ids 'R', 'G', 'B'; for four, Adobe's transform (none or 0: CMYK,
        any other: YCCK)."""
        if self.container_color is not None:
            return self.container_color
        n = len(self.components)
        if n == 1:
            return COLOR_GREY
        if n == 4:
            return COLOR_YCCK if self.adobe_transform else COLOR_CMYK
        if self.jfif:
            return COLOR_YCC
        if self.adobe_transform is not None:
            return COLOR_RGB if self.adobe_transform == 0 else COLOR_YCC
        return (COLOR_RGB if [c.ident for c in self.components] == [82, 71,
                                                                   66]
                else COLOR_YCC)

    def quant(self) -> np.ndarray:
        """(components, 64) int32 quantisers, natural order, each taken as
        int16 as libjpeg's ISLOW_MULT_TYPE holds it."""
        q = np.stack([c.quant for c in self.components])
        return q.astype(np.uint16).view(np.int16).astype(np.int32)


def _segments(data: bytes):
    """(marker, payload offset, payload) of each marker segment, EOI
    last; after each SOS's segment, (None, offset of the next marker, b"")
    marks the end of that scan's entropy-coded data."""
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


def _parse_sof(marker: int, body: bytes) -> JpegFrame:
    if len(body) < 6:
        raise ValueError("JPEG SOF segment too short")
    precision, height, width, nf = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"JPEG SOF{marker - 0xC0}: {precision}-bit samples "
                         "(12-bit and other precisions are not supported)")
    if nf not in (1, 3, 4):
        raise ValueError(f"JPEG SOF: {nf} components (1, 3 or 4 only)")
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
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
            raise ValueError(f"JPEG SOF: sampling factors {hv >> 4}x"
                             f"{hv & 15} (1 to 4 only)")
        if any(c.ident == ident for c in comps):
            raise ValueError(f"JPEG SOF: component id {ident} twice")
        comps.append(Component(ident, hv >> 4, hv & 15, tq))
    if nf == 1:
        comps[0].h = comps[0].v = 1         # one block per MCU, any factors
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if any(hmax % c.h or vmax % c.v for c in comps):
        raise ValueError("JPEG SOF: sampling factors " + " ".join(
            f"{c.h}x{c.v}" for c in comps) + ": fractional sampling not "
            "implemented (libjpeg refuses it too)")
    frame = JpegFrame(width, height, comps, progressive=marker == 0xC2)
    _layout(frame)
    return frame


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
    """Parse a JPEG's markers and split its scans; raises ``ValueError``
    naming what it does not support."""
    qtables, huffman = {}, {}
    frame = None
    restart = 0
    jfif, adobe = False, None
    scan_start = None
    for marker, pos, body in _segments(data):
        if marker is None:                          # end of a scan's data
            frame.scans[-1].data = data[scan_start:pos]
            continue
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG: a second SOF (one frame only)")
            frame = _parse_sof(marker, body)
        elif marker in _REFUSED_SOF:
            raise ValueError(f"JPEG {_REFUSED_SOF[marker]} is not supported "
                             "(Huffman-coded SOF0 / SOF1 / SOF2 only)")
        elif marker == DQT:
            _parse_dqt(body, qtables)
        elif marker == DHT:
            _parse_dht(body, huffman)
        elif marker == DRI:
            if len(body) < 2:
                raise ValueError("JPEG DRI segment too short")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == SOS:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            if not frame.scans:
                for key, (bits, vals) in STD_HUFFMAN.items():
                    huffman.setdefault(key, (list(bytes.fromhex(bits)),
                                             list(bytes.fromhex(vals))))
            frame.scans.append(_parse_sos(body, frame, huffman, qtables,
                                          restart))
            scan_start = pos + len(body)
        elif marker == EOI:
            break
        elif 0xC0 <= marker <= 0xCF or marker in (0xDE, 0xDF):
            raise ValueError(f"JPEG marker 0x{marker:02X} is not supported")
        elif frame is None or not frame.scans:
            # libjpeg settles the colour space at the first scan
            if marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
                jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                adobe = body[11]
        # APPn, COM and the rest carry nothing the pixels depend on
    if frame is None or not frame.scans:
        raise ValueError("JPEG: no frame or no scan before EOI")
    frame.jfif, frame.adobe_transform = jfif, adobe
    _check_progression(frame)
    return frame


def _parse_sos(body: bytes, f: JpegFrame, huffman: dict, qtables: dict,
               restart: int) -> Scan:
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise ValueError(f"JPEG SOS: bad segment ({ns} components in "
                         f"{len(body)} bytes)")
    comps, selectors = [], []
    for i in range(ns):
        cs, t = body[1 + 2 * i], body[2 + 2 * i]
        ci = [k for k, c in enumerate(f.components) if c.ident == cs]
        if not ci:
            raise ValueError(f"JPEG SOS: component id {cs} is not in the "
                             "frame")
        if ci[0] in comps:
            raise ValueError(f"JPEG SOS: component id {cs} twice in a scan")
        if t >> 4 > 3 or t & 15 > 3:
            raise ValueError("JPEG SOS: bad Huffman table selector")
        comps.append(ci[0])
        selectors.append((t >> 4, t & 15))
    if comps != sorted(comps):
        raise ValueError("JPEG SOS: components out of frame order")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if not f.progressive:
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise ValueError(f"JPEG SOS: spectral selection {ss}-{se}, "
                             f"approximation {ah}/{al} in a sequential "
                             "frame (a progressive scan)")
    elif ss == 0 and se != 0:
        raise ValueError(f"JPEG SOS: a DC scan with Se={se} (progressive "
                         "DC scans have Ss = Se = 0)")
    elif ss > 0 and (se < ss or se > 63):
        raise ValueError(f"JPEG SOS: an AC scan with Ss={ss}, Se={se} "
                         "(1 <= Ss <= Se <= 63)")
    elif ss > 0 and ns != 1:
        raise ValueError(f"JPEG SOS: an AC scan of {ns} components "
                         "(progressive AC scans hold one)")
    elif ah and al != ah - 1:
        raise ValueError(f"JPEG SOS: a refinement with Ah={ah}, Al={al} "
                         "(Al must be Ah - 1)")
    elif al > 13:
        raise ValueError(f"JPEG SOS: Al={al} (13 at most)")
    if ns > 1 and sum(f.components[ci].h * f.components[ci].v
                      for ci in comps) > MAX_BLOCKS_IN_MCU:
        raise ValueError(f"JPEG SOS: more than {MAX_BLOCKS_IN_MCU} blocks "
                         "in an MCU")
    need_dc = not f.progressive or (ss == 0 and ah == 0)
    need_ac = not f.progressive or ss > 0
    dc, ac = [], []
    for ci, (td, ta) in zip(comps, selectors):
        c = f.components[ci]
        if c.quant is None:                   # latched at its first scan
            if c.tq not in qtables:
                raise ValueError(f"JPEG: quantisation table {c.tq} not "
                                 "defined")
            c.quant = qtables[c.tq].copy()
        for need, key, out in ((need_dc, (0, td), dc), (need_ac, (1, ta),
                                                        ac)):
            if need and key not in huffman:
                raise ValueError(f"JPEG: Huffman table {key} not defined")
            out.append(huffman[key] if need else None)
    return Scan(comps, ss, se, ah, al, dc, ac, restart)


def _advance(bits: np.ndarray, scan: Scan):
    """Update ``bits`` ((components, 64) zig-zag: the last Al received, -1
    for none) with a progressive scan, as libjpeg's coef_bits; returns
    what is out of order in it, or None."""
    for ci in scan.comps:
        if scan.ss > 0 and bits[ci, 0] < 0:
            return (f"an AC scan of component {ci} before its first DC "
                    "scan")
        for k in range(scan.ss, scan.se + 1):
            if scan.ah != max(bits[ci, k], 0):
                return (f"component {ci}, coefficient {k}: Ah={scan.ah} "
                        f"but the last scan left Al={bits[ci, k]}")
            bits[ci, k] = scan.al
    return None


def _check_progression(f: JpegFrame) -> None:
    """Every component scanned; a progressive stream's scans in order and
    its first coefficients refined to the last bit, as libjpeg's
    ``smoothing_ok`` needs for it not to smooth the blocks."""
    seen = {ci for s in f.scans for ci in s.comps}
    for ci, c in enumerate(f.components):
        if ci not in seen:
            raise ValueError(f"JPEG: component {ci} (id {c.ident}) has no "
                             "scan")
    if not f.progressive:
        if len(seen) != sum(len(s.comps) for s in f.scans):
            raise ValueError("JPEG: a component in two scans of a "
                             "sequential frame")
        return
    bits = np.full((len(f.components), 64), -1, np.int64)
    for scan in f.scans:
        fault = _advance(bits, scan)
        if fault:
            raise ValueError(f"JPEG SOS: progressive scans out of order: "
                             f"{fault}")
    firsts = ZIGZAG[:SMOOTHING_COEFS]
    if all(bits[ci, 0] >= 0 and (c.quant[firsts] != 0).all()
           for ci, c in enumerate(f.components)) and (
               bits[:, 1:SMOOTHING_COEFS] != 0).any():
        raise ValueError("JPEG: a progressive stream whose coefficients "
                         "are not fully refined; libjpeg's block smoothing "
                         "is not ported")


def _layout(f: JpegFrame) -> None:
    """The MCU grid and each component's block grid (MCU-padded, as
    libjpeg's coefficient arrays), then ``sample_extents``."""
    hmax = max(c.h for c in f.components)
    vmax = max(c.v for c in f.components)
    f.mcux = -(-f.width // (8 * hmax))
    f.mcuy = -(-f.height // (8 * vmax))
    offset = 0
    for c in f.components:
        c.nbx, c.nby = f.mcux * c.h, f.mcuy * c.v
        c.offset = offset
        offset += c.nbx * c.nby
    sample_extents(f)


def sample_extents(f: JpegFrame) -> None:
    """Each component's real sample extent at the frame's width and height
    and its upsampling, as ``jdsample.c`` chooses it."""
    hmax = max(c.h for c in f.components)
    vmax = max(c.v for c in f.components)
    for c in f.components:
        c.dw = -(-f.width * c.h // hmax)
        c.dh = -(-f.height * c.v // vmax)
        c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
        c.hexp, c.vexp = hmax // c.h, vmax // c.v
        fancy = c.dw > 2
        c.up = {(1, 1): UP_FULL, (2, 1): UP_H2V1 if fancy else UP_BOX,
                (1, 2): UP_H1V2,
                (2, 2): UP_H2V2 if fancy else UP_BOX}.get(
                    (c.hexp, c.vexp), UP_BOX)


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


def _restart_segments(data: bytes):
    """A scan's data split at its restart markers, each un-stuffed. Raises
    on a restart marker out of order or a stray marker."""
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


class _Corrupt(Exception):
    """An entropy decoder error: ``args[0]`` is its code in ERRORS."""


PAD = 8       # zero bytes read past an interval's data before it counts
              # as truncated (the C++ decoder's kPad)


class _Bits:
    """MSB-first bits of one un-stuffed restart interval, refilled to more
    than 56 bits whenever fewer than 32 are left (as the C++ reader)."""
    __slots__ = ("data", "end", "pos", "buf", "nbits")

    def __init__(self, data: bytes):
        self.data = data + b"\x00" * PAD
        self.end = len(self.data)
        self.pos = self.buf = self.nbits = 0

    def fill(self):
        if self.nbits < 32:
            while self.nbits <= 56:
                if self.pos >= self.end:
                    raise _Corrupt(1)
                self.buf = ((self.buf & ((1 << self.nbits) - 1)) << 8) | \
                    self.data[self.pos]
                self.pos += 1
                self.nbits += 8

    def symbol(self, table) -> int:
        self.fill()
        e = table[(self.buf >> (self.nbits - 16)) & 0xFFFF]
        if not e:
            raise _Corrupt(2)
        self.nbits -= e >> 8
        return e & 0xFF

    def get(self, s: int) -> int:
        """``s`` (0..16) raw bits."""
        self.fill()
        self.nbits -= s
        return (self.buf >> self.nbits) & ((1 << s) - 1)

    def signed(self, s: int) -> int:
        """HUFF_EXTEND of ``s`` raw bits."""
        v = self.get(s)
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v

    def consumed(self) -> int:
        return 8 * self.pos - self.nbits


def _wrap16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _units(f: JpegFrame, scan: Scan, tables: dict):
    """The scan's MCU grid and the blocks of one MCU: (scan component,
    DC table, AC table, the block's index in MCU 0, rows and columns of
    blocks an MCU spans, the component's blocks per row). A scan of one
    component walks that component's own blocks, one an MCU."""
    def table(t):
        return None if t is None else tables[id(t)]
    comps = [f.components[ci] for ci in scan.comps]
    if len(comps) == 1:
        c = comps[0]
        return c.bw, c.bh, [(0, table(scan.dc[0]), table(scan.ac[0]),
                             c.offset, 1, 1, c.nbx)]
    units = [(k, table(scan.dc[k]), table(scan.ac[k]),
              c.offset + by * c.nbx + bx, c.v, c.h, c.nbx)
             for k, c in enumerate(comps)
             for by in range(c.v) for bx in range(c.h)]
    return f.mcux, f.mcuy, units


def entropy_decode(f: JpegFrame) -> np.ndarray:
    """Every scan's coefficients in one array: (blocks, 64) int16, natural
    order, each component's blocks in raster order from
    ``Component.offset``, zeroed once. The plain twin of the host C++
    decoder in ``csrc/jpeg_decode.cu``."""
    flat = [0] * (f.blocks * 64)
    bits = np.full((len(f.components), 64), -1, np.int64)
    tables = {}
    for scan in f.scans:
        for t in scan.dc + scan.ac:
            if t is not None and id(t) not in tables:
                tables[id(t)] = _lookup16(*t)
    try:
        for scan in f.scans:
            if f.progressive and _advance(bits, scan):
                raise _Corrupt(7)
            mcux, mcuy, units = _units(f, scan, tables)
            n_mcu = mcux * mcuy
            per_seg = scan.restart or n_mcu
            segs = _restart_segments(scan.data)
            if len(segs) != -(-n_mcu // per_seg):
                raise _Corrupt(3)
            for si, seg in enumerate(segs):
                mcus = range(si * per_seg, min((si + 1) * per_seg, n_mcu))
                br = _Bits(seg)
                eobrun = _decode_interval(br, f.progressive, scan, mcus,
                                          mcux, units, flat)
                if br.consumed() > 8 * len(seg):
                    raise _Corrupt(1)
                if eobrun:
                    raise _Corrupt(6)
    except _Corrupt as e:
        raise ValueError(f"JPEG: {ERRORS[e.args[0]]}") from None
    return np.asarray(flat, np.int16).reshape(-1, 64)


def _refine(flat, at: int, p1: int, m1: int, br: _Bits) -> None:
    """A correction bit for the nonzero coefficient ``flat[at]``: set, it
    adds ``p1`` to its magnitude unless that bit is already set."""
    if br.get(1) and not flat[at] & p1:
        flat[at] = _wrap16(flat[at] + (p1 if flat[at] >= 0 else m1))


def _decode_interval(br: _Bits, progressive: bool, scan: Scan, mcus,
                     mcux: int, units, flat: list) -> int:
    """Decode the MCUs ``mcus`` of one restart interval into ``flat`` by
    the scan's procedure (sequential, or T.81 Annex G's DC first, DC
    refinement, AC first, AC refinement); returns the EOB run left."""
    zz = ZIGZAG.tolist()
    pred = [0] * 4
    eobrun = 0
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -(1 << al)
    for mcu in mcus:
        my, mx = divmod(mcu, mcux)
        for k, dc, ac, base, v, h, nbx in units:
            blk = (base + my * v * nbx + mx * h) * 64
            if not progressive or (ss == 0 and ah == 0):   # a DC value
                s = br.symbol(dc)
                pred[k] += br.signed(s) if s else 0
                flat[blk] = _wrap16(pred[k] << al)
                if progressive:
                    continue
                i = 1
                while i < 64:
                    rs = br.symbol(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        i += r
                        if i > 63:
                            raise _Corrupt(5)
                        flat[blk + zz[i]] = br.signed(s)
                        i += 1
                    elif r == 15:
                        i += 16
                    else:
                        break
            elif ss == 0:                                  # DC refinement
                if br.get(1):
                    flat[blk] |= p1
            elif ah == 0:                                  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                i = ss
                while i <= se:
                    rs = br.symbol(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        i += r
                        if i > se:
                            raise _Corrupt(5)
                        flat[blk + zz[i]] = _wrap16(br.signed(s) << al)
                    elif r == 15:
                        i += 15
                    else:
                        eobrun = (1 << r) + (br.get(r) if r else 0) - 1
                        break
                    i += 1
            else:                                          # AC refinement
                i = ss
                if not eobrun:
                    while i <= se:
                        rs = br.symbol(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            if s != 1:
                                raise _Corrupt(2)
                            s = p1 if br.get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + (br.get(r) if r else 0)
                            break
                        # pass r zero coefficients, and every nonzero one
                        # on the way, which takes a correction bit
                        while i <= se:
                            at = blk + zz[i]
                            if flat[at]:
                                _refine(flat, at, p1, m1, br)
                            elif r == 0:
                                break
                            else:
                                r -= 1
                            i += 1
                        if s:
                            if i > se:
                                raise _Corrupt(5)
                            flat[blk + zz[i]] = s
                        i += 1
                if eobrun:
                    for i in range(i, se + 1):
                        if flat[blk + zz[i]]:
                            _refine(flat, blk + zz[i], p1, m1, br)
                    eobrun -= 1
    return eobrun


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


def upsample(plane: torch.Tensor, c: Component, width: int,
             height: int) -> torch.Tensor:
    """A component's plane on the (height, width) output grid, as
    libjpeg-turbo's upsampler for its ``Component.up``."""
    dev = plane.device
    plane = plane[:c.dh, :c.dw]
    if c.up == UP_FULL:
        return plane[:height, :width]
    if c.up == UP_BOX:
        ys = torch.arange(height, device=dev) // c.vexp
        xs = torch.arange(width, device=dev) // c.hexp
        return plane[ys][:, xs]
    if c.up == UP_H1V2:
        yi, yj, yodd = _neighbours(height, c.dh, dev)
        cols = plane[:, :width]
        return (3 * cols[yi] + cols[yj]
                + torch.where(yodd, 2, 1)[:, None]) >> 2
    xi, xj, xodd = _neighbours(width, c.dw, dev)
    if c.up == UP_H2V1:
        rows = plane[:height]
        return (3 * rows[:, xi] + rows[:, xj]
                + torch.where(xodd, 2, 1)) >> 2
    yi, yj, _ = _neighbours(height, c.dh, dev)
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


def cmyk_to_rgb(cmy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """PIL's CMYK -> RGB of inverted samples (``CMYK;I``): ``cmy`` (..., 3)
    holds 255 - C, 255 - M, 255 - Y as PIL reads them back, ``k`` the
    stream's K sample, which is 255 - K; each channel is
    ``nk - MULDIV255(c, nk)`` with nk = 255 - K."""
    k = k[..., None]
    t = cmy * k + 128
    return k - (((t >> 8) + t) >> 8)


def gray_from_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """OpenCV-parity grey of int32 RGB (``ops/patches.rgb_to_gray_u8``)."""
    return (rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868
            + 8192) >> 14


def pixels_reference(coef: torch.Tensor, f: JpegFrame,
                     channels: int = 1) -> torch.Tensor:
    """The plain twin of kernel J1: (blocks, 64) int16 coefficients ->
    uint8 (H, W) grey by OpenCV's formula (Y itself for a 1-component
    image) or (H, W, 3) RGB, on the coefficients' device; (N, blocks, 64)
    of N images of one geometry and one table set -> (N, H, W[, 3])."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    if coef.dim() == 3:
        return torch.stack([pixels_reference(c, f, channels) for c in coef])
    quant = torch.as_tensor(f.quant(), device=coef.device)
    w, h = f.width, f.height
    planes = [upsample(_plane(coef, quant[i], c), c, w, h)
              for i, c in enumerate(f.components)]
    color = f.color
    if color == COLOR_GREY:
        y = planes[0]
        out = y if channels == 1 else y[..., None].expand(h, w, 3)
        return out.to(torch.uint8).contiguous()
    if color == COLOR_RGB:
        rgb = torch.stack(planes, dim=-1)
    elif color == COLOR_YCC:
        rgb = ycc_to_rgb(*planes)
    else:
        # PIL inverts CMYK (255 - sample); libjpeg's ycck_cmyk_convert
        # writes 255 - R, G, B of the YCC, which that inversion undoes
        cmy = (255 - torch.stack(planes[:3], dim=-1) if color == COLOR_CMYK
               else ycc_to_rgb(*planes[:3]))
        rgb = cmyk_to_rgb(cmy, planes[3])
    out = rgb if channels == 3 else gray_from_rgb(rgb)
    return out.to(torch.uint8).contiguous()
