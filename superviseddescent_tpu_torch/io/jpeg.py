"""JPEG: the parser, the entropy decoders' plain Python twins, libjpeg's
block smoothing and the pixel stage's plain PyTorch twin (no PIL, no
OpenCV).

Decodes every 8-bit stream that libjpeg-turbo reads for PIL: Huffman- or
arithmetic-coded sequential (SOF0 / SOF1 / SOF9) and progressive (SOF2 /
SOF10) frames, in one scan or many (a scan over any subset of the
components, DHT, DAC, DQT and DRI between scans), and Huffman-coded
lossless frames (SOF3: predictors 1-7, any point transform, interleaved or
one scan per component); 1 component (grey), 3 (YCbCr, or RGB as libjpeg
decides it) or 4 (CMYK, or YCCK under an Adobe transform other than 0);
sampling factors 1..4 whose ratios to the largest are whole; restart
intervals; the standard Huffman tables where a stream defines none
(motion-JPEG frames); T.81's default arithmetic conditioning where a
stream sends no DAC. A progressive stream whose first ten coefficients
are not all refined to the last bit is block-smoothed as libjpeg-turbo
(2.1 and later) smooths it. Everything else raises a ``ValueError``
naming the marker or the field: differential frames (SOF5-7, SOF13-15),
arithmetic-coded lossless frames (SOF11, which libjpeg-turbo refuses:
"Sorry, arithmetic coding is not supported"), precisions other than 8,
fractional sampling, DNL and progressive scans out of order. Nothing is
decoded approximately.

The pixels equal libjpeg-turbo's default decompression (PIL's) bit for
bit: a component's quantisation table latched at its first scan, as
``jdinput.c`` does; dequantisation in int32 products with the quantiser
taken as int16 (libjpeg's ISLOW_MULT_TYPE), the ``jidctint`` islow IDCT
in int32 with its ``range_limit`` lookup (``& RANGE_MASK``: values
outside [-512, 511] before the level shift wrap, they do not saturate),
each component upsampled as ``jdsample.c`` chooses (h2v1 and h2v2
triangle filters where the component is more than two samples wide, the
h1v2 triangle filter, else replication by whole ratios; edge samples
replicated; a lossless frame's components by replication only), the
fixed-point YCbCr -> RGB tables of ``jdcolor.c`` and, for four
components, PIL's inverted CMYK (``CMYK;I``) and its CMYK -> RGB. The
int32 products hold libjpeg's 64-bit sums exactly for every stream an
8-bit encoder writes (dequantised coefficients within the DCT's range). A
lossless frame's samples skip the dequantisation and the IDCT.

The card runs the same two stages as ``csrc/jpeg_decode.cu`` (the host
entropy decoders with the smoothing, and kernel J1, through
``ops/jpeg.py``); the functions here are their plain twins, used on the
CPU and by the tests.
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
_ZZ = ZIGZAG.tolist()
_REFUSED_SOF = {0xC5: "SOF5 (differential)", 0xC6: "SOF6 (differential "
                "progressive)", 0xC7: "SOF7 (differential lossless)",
                0xCB: "SOF11 (arithmetic lossless)",
                0xCD: "SOF13 (arithmetic differential)", 0xCE: "SOF14 "
                "(arithmetic differential progressive)", 0xCF: "SOF15 "
                "(arithmetic differential lossless)",
                0xDC: "DNL (the height defined after the scan)"}
# the frames read: marker -> (progressive, lossless, arithmetic)
SOF_KINDS = {0xC0: (False, False, False), 0xC1: (False, False, False),
             0xC2: (True, False, False), 0xC3: (False, True, False),
             0xC9: (False, False, True), 0xCA: (True, False, True)}
DAC = 0xCC
# arithmetic conditioning tables (NUM_ARITH_TBLS) and T.81's defaults
ARITH_TABLES = 16
DAC_DEFAULT = (0, 1, 5)     # DC L, DC U, AC Kx
# the colour of the components, as libjpeg decides it
COLOR_GREY, COLOR_YCC, COLOR_RGB, COLOR_CMYK, COLOR_YCCK = range(5)
# how a component reaches the output grid (``jdsample.c``): as it is, by
# replication (hexp x vexp), or by one of the triangle filters
UP_FULL, UP_BOX, UP_H2V1, UP_H1V2, UP_H2V2 = range(5)
# the most blocks an interleaved scan's MCU may hold (D_MAX_BLOCKS_IN_MCU)
MAX_BLOCKS_IN_MCU = 10
# libjpeg's block smoothing looks at the first ten zig-zag coefficients
SMOOTHING_COEFS = 10
# T.81 Table D.2 as libjpeg's jaricom.c holds it: per state (Qe, next state
# after an MPS, after an LPS, whether an LPS switches the MPS); state 113
# is the fixed probability 0.5 that sign and refinement bits use
ARITAB = (
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0),
    (0x080b, 4, 18, 0), (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0),
    (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0), (0x0036, 9, 30, 0),
    (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 16, 36, 0), (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0),
    (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0), (0x0cef, 21, 43, 0),
    (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0),
    (0x01b1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0),
    (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0), (0x0068, 33, 62, 0),
    (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0),
    (0x2ef1, 40, 67, 0), (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0),
    (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
    (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0),
    (0x04de, 52, 50, 0), (0x040f, 53, 50, 0), (0x0363, 54, 51, 0),
    (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0), (0x01f8, 57, 54, 0),
    (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0),
    (0x008f, 32, 61, 0), (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0),
    (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0), (0x2fe8, 69, 83, 0),
    (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0),
    (0x119c, 76, 74, 0), (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0),
    (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0), (0x5832, 81, 80, 1),
    (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0),
    (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0),
    (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0), (0x3824, 93, 99, 0),
    (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0),
    (0x3c3d, 100, 104, 0), (0x375e, 93, 99, 0), (0x5231, 102, 105, 0),
    (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0), (0x415e, 99, 103, 0),
    (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1),
    (0x5522, 109, 112, 0), (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0))
# entropy decoder errors (the host C++ decoder returns the same codes)
ERRORS = {1: "truncated entropy-coded data",
          2: "invalid Huffman code",
          3: "missing or out-of-order restart marker",
          4: "unexpected marker inside the entropy-coded data",
          5: "AC coefficient index past the end of the scan's band (Se)",
          6: "an EOB run past the last block of the scan or restart "
             "interval",
          7: "a progressive scan out of order (Ah is not the band's last "
             "Al, or an AC scan before the component's first DC scan)",
          8: "a lossless restart interval that is not a whole number of "
             "MCU rows"}
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
    sh: int = 1         # the sampling factors as the SOF gives them (a
    sv: int = 1         # single component's too)


@dataclass
class Scan:
    """One scan: its components (indices into the frame's, in the scan's
    order), spectral selection and successive approximation (a lossless
    scan's predictor in ``ss``, its point transform in ``al``), the
    Huffman tables in force for each component ((bits, symbols) or None
    where the scan needs none), the restart interval in force and its
    bytes. An arithmetic-coded scan has no Huffman tables: ``tables``
    holds each component's DC and AC table numbers (their statistics are
    shared by the components that name the same table) and ``cond`` the
    conditioning in force for them, (L, U, Kx)."""
    comps: list
    ss: int
    se: int
    ah: int
    al: int
    dc: list
    ac: list
    restart: int = 0
    data: bytes = b""
    tables: list = field(default_factory=list)
    cond: list = field(default_factory=list)


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
    arithmetic: bool = False
    lossless: bool = False      # SOF3: samples, not coefficients
    # a progressive frame that libjpeg block-smooths: (components, 10) the
    # last Al of each of the first ten zig-zag coefficients (-1: never
    # sent), else None
    smooth: np.ndarray | None = None

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
        # with no marker, a lossless frame is RGB whatever its ids (libjpeg
        # -turbo 3.x), a DCT frame only under the ids 'R', 'G', 'B'
        return (COLOR_RGB if self.lossless or [c.ident for c in
                                               self.components] == [82, 71,
                                                                    66]
                else COLOR_YCC)

    def quant(self) -> np.ndarray:
        """(components, 64) int32 quantisers, natural order, each taken as
        int16 as libjpeg's ISLOW_MULT_TYPE holds it (zeros for a lossless
        frame, which has none)."""
        q = np.stack([np.zeros(64, np.int64) if c.quant is None else c.quant
                      for c in self.components])
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
    progressive, lossless, arithmetic = SOF_KINDS[marker]
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
        comps.append(Component(ident, hv >> 4, hv & 15, tq, sh=hv >> 4,
                               sv=hv & 15))
    if nf == 1:
        comps[0].h = comps[0].v = 1         # one block per MCU, any factors
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if any(hmax % c.h or vmax % c.v for c in comps):
        raise ValueError("JPEG SOF: sampling factors " + " ".join(
            f"{c.h}x{c.v}" for c in comps) + ": fractional sampling not "
            "implemented (libjpeg refuses it too)")
    frame = JpegFrame(width, height, comps, progressive=progressive,
                      arithmetic=arithmetic, lossless=lossless)
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
        if tc == 0 and max(vals, default=0) > 16:
            raise ValueError("JPEG DHT: DC symbol above 16")
        huffman_codes(bits, vals)                   # validates the lengths
        tables[(tc, th)] = (bits, vals)
        pos += 17 + n


def _parse_dac(body: bytes, dac: list) -> None:
    """DAC: each DC table's L and U, each AC table's Kx, as libjpeg's
    ``get_dac`` reads them into ``dac`` (L, U, Kx lists of 16)."""
    for pos in range(0, len(body) - 1, 2):
        index, val = body[pos], body[pos + 1]
        if index >= 2 * ARITH_TABLES:
            raise ValueError(f"JPEG DAC: bogus table index {index}")
        if index >= ARITH_TABLES:
            dac[2][index - ARITH_TABLES] = val
        elif val & 15 > val >> 4:
            raise ValueError(f"JPEG DAC: bogus value 0x{val:02x} (L above "
                             "U)")
        else:
            dac[0][index], dac[1][index] = val & 15, val >> 4
    if len(body) % 2:
        raise ValueError("JPEG DAC: bad segment length")


def parse_jpeg(data: bytes) -> JpegFrame:
    """Parse a JPEG's markers and split its scans; raises ``ValueError``
    naming what it does not support."""
    qtables, huffman = {}, {}
    dac = [[d] * ARITH_TABLES for d in DAC_DEFAULT]
    frame = None
    restart = 0
    jfif, adobe = False, None
    scan_start = None
    for marker, pos, body in _segments(data):
        if marker is None:                          # end of a scan's data
            frame.scans[-1].data = data[scan_start:pos]
            continue
        if marker in SOF_KINDS:
            if frame is not None:
                raise ValueError("JPEG: a second SOF (one frame only)")
            frame = _parse_sof(marker, body)
        elif marker in _REFUSED_SOF:
            raise ValueError(f"JPEG {_REFUSED_SOF[marker]} is not supported "
                             "(SOF0-SOF3, SOF9 and SOF10 only)")
        elif marker == DAC:
            _parse_dac(body, dac)
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
            if not frame.scans and not frame.lossless:
                # (libjpeg-turbo's lossless decoder has no default tables)
                for key, (bits, vals) in STD_HUFFMAN.items():
                    huffman.setdefault(key, (list(bytes.fromhex(bits)),
                                             list(bytes.fromhex(vals))))
            frame.scans.append(_parse_sos(body, frame, huffman, qtables,
                                          restart, dac))
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
    if frame.lossless and frame.color in (COLOR_YCC, COLOR_YCCK):
        raise ValueError("JPEG: a lossless YCbCr or YCCK frame (JFIF, or an "
                         "Adobe transform other than 0): libjpeg-turbo "
                         "converts no colour space in lossless mode "
                         "(\"Unsupported color conversion request\")")
    _check_progression(frame)
    return frame


def _parse_sos(body: bytes, f: JpegFrame, huffman: dict, qtables: dict,
               restart: int, dac=None) -> Scan:
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
        if not f.arithmetic and (t >> 4 > 3 or t & 15 > 3):
            raise ValueError("JPEG SOS: bad Huffman table selector")
        comps.append(ci[0])
        selectors.append((t >> 4, t & 15))
    if comps != sorted(comps):
        raise ValueError("JPEG SOS: components out of frame order")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if f.lossless:
        if not 1 <= ss <= 7 or se or ah or al > 7:
            raise ValueError(f"JPEG SOS: a lossless scan with Ss={ss}, "
                             f"Se={se}, Ah={ah}, Al={al} (predictor 1-7, Se "
                             "= Ah = 0, point transform 0-7)")
    elif not f.progressive:
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
    if f.lossless and restart:
        c = f.components[comps[0]]
        per_row = c.dw if ns == 1 else -(-f.width // max(
            k.h for k in f.components))
        if restart % per_row:
            raise ValueError(f"JPEG: {ERRORS[8]} (interval {restart}, "
                             f"{per_row} MCUs a row)")
    need_dc = not f.progressive or (ss == 0 and ah == 0)
    need_ac = not f.lossless and (not f.progressive or ss > 0)
    dc, ac, cond = [], [], []
    for ci, (td, ta) in zip(comps, selectors):
        c = f.components[ci]
        if c.quant is None and not f.lossless:   # latched at its first scan
            if c.tq not in qtables:
                raise ValueError(f"JPEG: quantisation table {c.tq} not "
                                 "defined")
            c.quant = qtables[c.tq].copy()
        if f.arithmetic:
            cond.append((dac[0][td], dac[1][td], dac[2][ta]))
            dc.append(None)
            ac.append(None)
            continue
        for need, key, out in ((need_dc, (0, td), dc), (need_ac, (1, ta),
                                                        ac)):
            if need and key not in huffman:
                raise ValueError(f"JPEG: Huffman table {key} not defined")
            out.append(huffman[key] if need else None)
        if need_dc and not f.lossless and max(huffman[(0, td)][1],
                                              default=0) > 15:
            # a difference category of 16 is the lossless coder's only
            raise ValueError("JPEG DHT: DC symbol above 15")
    return Scan(comps, ss, se, ah, al, dc, ac, restart, tables=selectors,
                cond=cond)


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
    """Every component scanned; a progressive stream's scans in order, and
    ``f.smooth`` set where libjpeg's ``smoothing_ok`` holds over the last
    coefficient bits: every component has its DC and nonzero quantisers at
    the first ten zig-zag positions, and one of coefficients 1-9 is not
    refined to bit 0."""
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
        f.smooth = bits[:, :SMOOTHING_COEFS].copy()


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
        # libjpeg-turbo's lossless path has no fancy upsampling (its
        # min_DCT_scaled_size is 1)
        fancy = c.dw > 2 and not f.lossless
        c.up = {(1, 1): UP_FULL, (2, 1): UP_H2V1 if fancy else UP_BOX,
                (1, 2): UP_H1V2 if not f.lossless else UP_BOX,
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
    ``Component.offset``, zeroed once, block-smoothed where ``f.smooth``
    says libjpeg smooths them; a lossless frame's samples (``lossless_decode``,
    uint8 in the same block layout). The plain twin of the host C++
    decoder in ``csrc/jpeg_decode.cu``."""
    if f.lossless:
        return lossless_decode(f)
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
                if f.arithmetic:
                    _arith_interval(_Arith(seg), f.progressive, scan, mcus,
                                    mcux, units, flat)
                    continue
                br = _Bits(seg)
                eobrun = _decode_interval(br, f.progressive, scan, mcus,
                                          mcux, units, flat)
                if br.consumed() > 8 * len(seg):
                    raise _Corrupt(1)
                if eobrun:
                    raise _Corrupt(6)
    except _Corrupt as e:
        raise ValueError(f"JPEG: {ERRORS[e.args[0]]}") from None
    coef = np.asarray(flat, np.int16).reshape(-1, 64)
    return coef if f.smooth is None else smooth_blocks(coef, f)


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


# ------------------------------------------------------ arithmetic coding
class _Broken(Exception):
    """libjpeg's arithmetic decoder error state (its ``ct = -1``): a
    magnitude or index past its range. libjpeg warns and decodes nothing
    more until the next restart marker; so does the twin."""


class _Arith:
    """T.81 Annex D's decoder as libjpeg's ``jdarith.c`` runs it on one
    un-stuffed restart interval, reading zeros once its bytes are spent
    (libjpeg feeds zeros from the marker on)."""
    __slots__ = ("data", "pos", "c", "a", "ct", "broken")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = self.c = self.a = 0
        self.ct = -16
        self.broken = False

    def decode(self, st, i: int) -> int:
        """One binary decision with statistics bin ``st[i]`` (bit 7 the
        MPS, the rest the state), which it updates."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.data[pos] if pos < len(self.data)
                                else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe, nmps, nlps, switch = ARITAB[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nmps
            else:
                a = qe
                st[i] = (sv & 0x80) ^ (switch << 7 | nlps)
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ (switch << 7 | nlps)
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nmps
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7

    def magnitude(self, st, i: int, x1: int):
        """F.23-F.24: |v| - 1's category from bin ``i`` then the X bins
        from ``x1`` on, and its bits; returns (|v| - 1, m, the M bin)."""
        m = self.decode(st, i)
        if m:
            i = x1
            while self.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _Broken
                i += 1
        return m, i


_FIXED = 113       # ARITAB's state of the fixed probability 0.5


def _arith_value(dec: _Arith, st, m: int, i: int, sign: int) -> int:
    v, i = m, i + 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    return -(v + 1) if sign else v + 1


def _arith_ac(dec: _Arith, st, kx: int, flat, blk: int, ss: int, se: int,
              al: int) -> None:
    """Figure F.20's AC coefficients ss..se of one block (sequential: 1..63
    at Al 0; a progressive first scan at its Al)."""
    zz = _ZZ
    k = ss
    fixed = bytearray([_FIXED])
    while k <= se:
        i = 3 * (k - 1)
        if dec.decode(st, i):                       # end of block
            return
        while not dec.decode(st, i + 1):
            i += 3
            k += 1
            if k > se:
                raise _Broken
        sign = dec.decode(fixed, 0)
        i += 2
        m = dec.decode(st, i)
        if m and dec.decode(st, i):
            m = 2
            i = 189 if k <= kx else 217
            while dec.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _Broken
                i += 1
        flat[blk + zz[k]] = _wrap16(_arith_value(dec, st, m, i, sign) << al)
        k += 1


def _arith_ac_refine(dec: _Arith, st, flat, blk: int, ss: int, se: int,
                     al: int) -> None:
    """``decode_mcu_AC_refine``: the band's end in the earlier scans (its
    last nonzero coefficient up to Se), then correction bits and newly
    nonzero coefficients, the signs at the fixed probability."""
    zz = _ZZ
    p1, m1 = 1 << al, -(1 << al)
    fixed = bytearray([_FIXED])
    kex = se
    while kex > 0 and not flat[blk + zz[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and dec.decode(st, i):
            return
        while True:
            at = blk + zz[k]
            if flat[at]:
                if dec.decode(st, i + 2):
                    flat[at] = _wrap16(flat[at] + (m1 if flat[at] < 0
                                                   else p1))
                break
            if dec.decode(st, i + 1):
                flat[at] = m1 if dec.decode(fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                raise _Broken
        k += 1


def _arith_interval(dec: _Arith, progressive: bool, scan: Scan, mcus,
                    mcux: int, units, flat: list) -> None:
    """The MCUs ``mcus`` of one restart interval by ``jdarith.c``'s
    procedure for the scan (sequential ``decode_mcu``, or DC first, DC
    refinement, AC first, AC refinement), the statistics of each table
    and the DC predictions starting from zero."""
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    n = len(scan.comps)
    dc_stats = {td: bytearray(64) for td, _ in scan.tables}
    ac_stats = {ta: bytearray(256) for _, ta in scan.tables}
    last, ctx = [0] * n, [0] * n
    fixed = bytearray([_FIXED])
    dc_first = not progressive or (ss == 0 and ah == 0)
    for mcu in mcus:
        if dec.broken and not (progressive and ss == 0 and ah):
            continue
        my, mx = divmod(mcu, mcux)
        try:
            for k, _, _, base, v, h, nbx in units:
                blk = (base + my * v * nbx + mx * h) * 64
                td, ta = scan.tables[k]
                if dc_first:
                    st = dc_stats[td]
                    s0 = ctx[k]
                    if not dec.decode(st, s0):
                        ctx[k] = 0
                    else:
                        sign = dec.decode(st, s0 + 1)
                        m, i = dec.magnitude(st, s0 + 2 + sign, 20)
                        lo, hi, _ = scan.cond[k]
                        ctx[k] = (0 if m < (1 << lo) >> 1 else
                                  12 + 4 * sign if m > (1 << hi) >> 1 else
                                  4 + 4 * sign)
                        last[k] = (last[k] + _arith_value(dec, st, m, i,
                                                          sign)) & 0xFFFF
                    flat[blk] = _wrap16(last[k] << al)
                    if not progressive:
                        _arith_ac(dec, ac_stats[ta], scan.cond[k][2], flat,
                                  blk, 1, 63, 0)
                elif ss == 0:                              # DC refinement
                    if dec.decode(fixed, 0):
                        flat[blk] |= 1 << al
                elif ah == 0:                              # AC first
                    _arith_ac(dec, ac_stats[ta], scan.cond[k][2], flat, blk,
                              ss, se, al)
                else:                                      # AC refinement
                    _arith_ac_refine(dec, ac_stats[ta], flat, blk, ss, se,
                                     al)
        except _Broken:
            dec.broken = True


# ----------------------------------------------------------- lossless
def _lossless_geometry(f: JpegFrame, scan: Scan):
    """A lossless scan as libjpeg walks it (one sample a block): MCUs a row
    and in all, the samples of one MCU ((scan component, row, column)),
    the MCU rows of each iMCU row (``jddiffct.c``), and per scan component
    its rows a full iMCU row and on the last one."""
    hmax = max(c.sh for c in f.components)
    vmax = max(c.sv for c in f.components)
    n_imcu = -(-f.height // vmax)
    comps = [f.components[ci] for ci in scan.comps]
    if len(comps) == 1:
        c = comps[0]
        units = [(0, 0, 0, 1, 1)]
        mcux, mcu_rows = c.dw, c.dh
        per_imcu = [c.sv] * (n_imcu - 1) + [c.dh - (n_imcu - 1) * c.sv]
        rows = [(c.sv, c.dh - (n_imcu - 1) * c.sv)]
    else:
        units = [(k, y, x, c.h, c.v) for k, c in enumerate(comps)
                 for y in range(c.v) for x in range(c.h)]
        mcux, mcu_rows = -(-f.width // hmax), n_imcu
        per_imcu = [1] * n_imcu
        rows = [(c.v, c.dh - (n_imcu - 1) * c.v) for c in comps]
    return mcux, mcu_rows, units, per_imcu, rows


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1


def lossless_decode(f: JpegFrame) -> np.ndarray:
    """A lossless (SOF3) frame's samples as libjpeg-turbo decodes them:
    (blocks, 64) uint8, each component's samples in the 8 x 8 blocks of
    the frame's MCU-padded grid (``Component.offset``, ``nbx``), zero
    outside its extent. Each scan's differences (Huffman, SSSS 16 = 32768
    with no extra bits) are undifferenced modulo 2^16 a row at a time
    after each iMCU row is decoded (``jddiffct.c``): the scan's first row,
    and the first row of an iMCU row in which a restart interval begins,
    from the left (its first sample from 2^(7 - Pt)); every other row's
    first sample from above and the rest by the scan's predictor; then
    shifted left by Pt into a byte. The plain twin of the host C++
    decoder's lossless path."""
    out = np.zeros((f.blocks, 64), np.uint8)
    try:
        for scan in f.scans:
            _lossless_scan(f, scan, out)
    except _Corrupt as e:
        raise ValueError(f"JPEG: {ERRORS[e.args[0]]}") from None
    return out


def _lossless_scan(f: JpegFrame, scan: Scan, out: np.ndarray) -> None:
    mcux, mcu_rows, units, per_imcu, rows = _lossless_geometry(f, scan)
    comps = [f.components[ci] for ci in scan.comps]
    tables = [_lookup16(*t) for t in scan.dc]
    n_mcu = mcux * mcu_rows
    per_seg = scan.restart or n_mcu
    segs = _restart_segments(scan.data)
    if len(segs) != -(-n_mcu // per_seg):
        raise _Corrupt(3)
    # every difference of the scan, per component, on its MCU-padded grid
    diff = [np.zeros((mcu_rows * (1 if len(comps) == 1 else c.v),
                      mcux * (1 if len(comps) == 1 else c.h)), np.int64)
            for c in comps]
    for si, seg in enumerate(segs):
        br = _Bits(seg)
        for mcu in range(si * per_seg, min((si + 1) * per_seg, n_mcu)):
            my, mx = divmod(mcu, mcux)
            for k, y, x, h, v in units:
                s = br.symbol(tables[k])
                if s == 16:
                    d = 32768
                elif s:
                    d = br.signed(s)
                else:
                    d = 0
                diff[k][my * v + y, mx * h + x] = d
        if br.consumed() > 8 * len(seg):
            raise _Corrupt(1)
    rows_per_seg = per_seg // mcux
    psv, pt = scan.ss, scan.al
    first = [True] * len(comps)
    undiff = [None] * len(comps)
    planes = [np.zeros((c.nby * 8, c.nbx * 8), np.uint8) for c in comps]
    mcu_row = 0
    for j, n_rows in enumerate(per_imcu):
        if any((mcu_row + y) % rows_per_seg == 0 and mcu_row + y
               for y in range(n_rows)):
            first = [True] * len(comps)            # a restart's reset
        mcu_row += n_rows
        last = j == len(per_imcu) - 1
        for k, c in enumerate(comps):
            full, tail = rows[k]
            for r in range(j * full, j * full + (tail if last else full)):
                d = diff[k][r, :c.dw].tolist()
                row = [0] * c.dw
                if first[k]:
                    ra = 1 << (7 - pt)
                    for x in range(c.dw):
                        ra = (d[x] + ra) & 0xFFFF
                        row[x] = ra
                    first[k] = False
                else:
                    prev = undiff[k]
                    ra = (d[0] + prev[0]) & 0xFFFF
                    row[0] = ra
                    for x in range(1, c.dw):
                        ra = (d[x] + _predict(psv, ra, prev[x],
                                              prev[x - 1])) & 0xFFFF
                        row[x] = ra
                undiff[k] = row
                planes[k][r, :c.dw] = (np.asarray(row, np.int64) << pt) & 0xFF
    for c, plane in zip(comps, planes):                # into 8 x 8 blocks
        out[c.offset:c.offset + c.nbx * c.nby] = plane.reshape(
            c.nby, 8, c.nbx, 8).transpose(0, 2, 1, 3).reshape(-1, 64)


# ------------------------------------------------------ block smoothing
# libjpeg-turbo's (2.1 and later) estimates of the first ten zig-zag
# coefficients from the 5 x 5 DC values around a block (``jdcoefct.c``,
# decompress_smooth_data): per coefficient, the weights with DC
# interpolation (no AC coefficient of the first ten ever sent) and without
_SMOOTH_AC01 = ((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3),
                (-3, 13, 0, -13, 3), (-1, -1, 0, 1, 1))
_SMOOTH_AC01_K8 = ((0,) * 5, (0,) * 5, (-7, 50, 0, -50, 7), (0,) * 5,
                   (0,) * 5)
_SMOOTH_AC20 = ((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0),
                (0, 2, 7, 2, 0), (0, 0, 1, 0, 0))
_SMOOTH_AC20_K8 = ((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0),
                   (0, 0, 13, 0, 0), (0, 0, -1, 0, 0))
_SMOOTH_AC11 = ((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0,) * 5,
                (0, -9, 0, 9, 0), (1, 0, 0, 0, -1))
_SMOOTH_AC11_K8 = ((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0,) * 5,
                   (1, -10, 0, 10, -1), (0, 1, 0, -1, 0))
_SMOOTH_AC03 = ((0,) * 5, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0),
                (0, 1, 0, -1, 0), (0,) * 5)
_SMOOTH_AC12 = ((0,) * 5, (0, 1, -3, 1, 0), (0,) * 5, (0, -1, 3, -1, 0),
                (0,) * 5)
_SMOOTH_DC = ((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6),
              (-8, 42, 152, 42, -8), (-6, 6, 42, 6, -6),
              (-2, -6, -8, -6, -2))


def _transpose(w):
    return tuple(zip(*w))


# zig-zag coefficients 1-9: (weights with DC interpolation, without); the
# last four and the DC are estimated only with DC interpolation
SMOOTH_WEIGHTS = np.array([
    [_SMOOTH_DC, _SMOOTH_DC],
    [_SMOOTH_AC01, _SMOOTH_AC01_K8],
    [_transpose(_SMOOTH_AC01), _transpose(_SMOOTH_AC01_K8)],
    [_SMOOTH_AC20, _SMOOTH_AC20_K8],
    [_SMOOTH_AC11, _SMOOTH_AC11_K8],
    [_transpose(_SMOOTH_AC20), _transpose(_SMOOTH_AC20_K8)],
    [_SMOOTH_AC03, ((0,) * 5,) * 5],
    [_SMOOTH_AC12, ((0,) * 5,) * 5],
    [_transpose(_SMOOTH_AC12), ((0,) * 5,) * 5],
    [_transpose(_SMOOTH_AC03), ((0,) * 5,) * 5]], np.int64)


def _smooth_rows(f: JpegFrame, c: Component):
    """Per block row of a component, as ``decompress_smooth_data`` walks
    its iMCU rows: (row, the rows it reads as the two above, itself and
    the two below), with libjpeg's edge rules (its row count on the last
    iMCU row is that row's own, which its edge tests use)."""
    vmax = max(k.sv for k in f.components)
    total = -(-f.height // (8 * vmax))
    v = c.sv
    out = []
    for imcu in range(total):
        block_rows = v if imcu < total - 1 else (c.bh % v or v)
        image_rows = block_rows * total
        for br in range(block_rows):
            row = imcu * block_rows + br
            cur = imcu * v + br
            prev = cur - 1 if row > 0 else cur
            pprev = cur - 2 if row > 1 else prev
            nxt = cur + 1 if row < image_rows - 1 else cur
            nnxt = cur + 2 if row < image_rows - 2 else nxt
            out.append((cur, (pprev, prev, cur, nxt, nnxt)))
    return out


def smooth_blocks(coef: np.ndarray, f: JpegFrame) -> np.ndarray:
    """libjpeg-turbo's block smoothing of a progressive frame whose first
    ten coefficients are not all refined (``f.smooth``): each coefficient
    1-9 still zero and not known to the last bit is estimated, in
    quantised units, from the DC values of the 5 x 5 blocks around it
    (rounded, clamped below 2^Al); with no AC coefficient of the first ten
    ever sent, the DC is re-estimated too and the higher four get their own
    weights. Neighbours past an edge repeat as libjpeg's sliding registers
    repeat them. The plain twin of the host C++ smoothing."""
    out = coef.copy()
    pos = ZIGZAG[:SMOOTHING_COEFS]
    for ci, c in enumerate(f.components):
        bits = f.smooth[ci]
        change_dc = bool((bits[1:] == -1).all())
        q = c.quant[pos].astype(np.int64)
        grid = coef[c.offset:c.offset + c.nbx * c.nby].reshape(
            c.nby, c.nbx, 64)
        dc = grid[:, :, 0].astype(np.int64).tolist()
        weights = SMOOTH_WEIGHTS[:, 0 if change_dc else 1]
        last_col = c.bw - 1
        for cur, rows in _smooth_rows(f, c):
            if cur >= c.nby:
                continue
            src = [dc[r] if r < c.nby else [0] * c.nbx for r in rows]
            reg = [[s[0]] * 5 for s in src]
            for bn in range(c.bw):
                if bn == 0 and bn < last_col:
                    for j in range(5):
                        reg[j][3] = reg[j][4] = src[j][1]
                if bn + 1 < last_col:
                    for j in range(5):
                        reg[j][4] = src[j][bn + 2]
                block = out[c.offset + cur * c.nbx + bn]
                sums = (weights * np.asarray(reg)).sum(axis=(1, 2)).tolist()
                for k in range(1, 10 if change_dc else 6):
                    al = int(bits[k])
                    if al == 0 or block[pos[k]]:
                        continue
                    num = int(q[0]) * sums[k]
                    pred = ((int(q[k]) << 7) + abs(num)) // (int(q[k]) << 8)
                    if al > 0 and pred >= (1 << al):
                        pred = (1 << al) - 1
                    block[pos[k]] = _wrap16(-pred if num < 0 else pred)
                if change_dc:
                    num = int(q[0]) * sums[0]
                    pred = ((int(q[0]) << 7) + abs(num)) // (int(q[0]) << 8)
                    block[0] = _wrap16(-pred if num < 0 else pred)
                for j in range(5):
                    reg[j][:4] = reg[j][1:]
    return out


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




def _plane(coef, quant, c: Component, lossless: bool) -> torch.Tensor:
    """A component's plane from its blocks: the IDCT of its coefficients,
    or a lossless frame's samples as they are."""
    mine = coef[c.offset:c.offset + c.nbx * c.nby]
    blocks = (mine.to(torch.int32).reshape(-1, 8, 8) if lossless
              else idct_blocks(mine, quant))
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
    """The plain twin of kernel J1: (blocks, 64) int16 coefficients (a
    lossless frame's uint8 samples, ``lossless_decode``) -> uint8 (H, W)
    grey by OpenCV's formula (Y itself for a 1-component image) or (H, W,
    3) RGB, on the coefficients' device; (N, blocks, 64) of N images of
    one geometry and one table set -> (N, H, W[, 3])."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    if coef.dim() == 3:
        return torch.stack([pixels_reference(c, f, channels) for c in coef])
    quant = torch.as_tensor(f.quant(), device=coef.device)
    w, h = f.width, f.height
    planes = [upsample(_plane(coef, quant[i], c, f.lossless), c, w, h)
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
