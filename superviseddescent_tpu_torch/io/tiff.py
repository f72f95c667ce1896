"""TIFF: a reader of the first page and a writer, as PIL reads and writes
them (no PIL, no libtiff).

Reads the first image of a classic TIFF (``II*\\0`` or ``MM\\0*``) or a
little-endian BigTIFF (``II+\\0``: 64-bit offsets and counts, 20-byte
entries, LONG8 / SLONG8 / IFD8) of every kind in PIL's
``TiffImagePlugin.OPEN_INFO`` (``OPEN_INFO`` below, PIL 12.1's 120 keys:
byte order, photometric, sample format, fill order, bits per sample and
extra samples), in strips or tiles, planar configuration 1 or 2;
uncompressed, PackBits, LZW (the TIFF 6 variant), Adobe Deflate (8, and
the old 32946), LZMA (34925, the standard library's ``lzma``), CCITT RLE,
Group 3 and Group 4 (2, 3, 4: ``io/ccitt.py``), Zstandard (50000:
``io/zstd.py``) and JPEG (7, ``jpeg_chunks``: each strip or tile an
abbreviated stream under the JPEGTables tag, decoded by
``ops/jpeg.read_tiff_jpeg``, kernel J1 on the card). CCITT and Zstandard
strips decode by the Python twins or, for the card's path, by their host
C++ forms (``csrc/tiff_decode.cu``). Each kind turns into uint8 as PIL's
unpacker and ``convert("RGB")`` turn it:

* 1, 2 and 4-bit grey scaled by 255, 85 and 17 (white-is-zero inverted),
  12 and 16-bit grey (I;16) and 16 / 32-bit signed or 32-bit unsigned
  integers (I) clipped to [0, 255] (white-is-zero not inverted, as PIL
  does not), float samples (F) truncated toward zero then clipped (NaN
  0), LA as its grey;
* palettes of 1, 2, 4 or 8 bits (with an extra or alpha sample ignored):
  each 16-bit ColorMap value taken as its high byte, an index past the
  map black;
* RGB of 8 or 16 bits (16: the high byte), extra samples dropped,
  associated alpha divided out first as PIL's ``RGBa`` unpacker does
  (``c * 255 // a``, 0 where a is 0, clipped to 255);
* 16 and 32-bit signed and float samples of a big-endian file as PIL
  reads them where libtiff decodes (every compressed strip): byte-swapped,
  since PIL takes libtiff's native order for the file's;
* CMYK of 8 or 16 bits through PIL's ``cmyk2rgb`` (``nk - MULDIV255(c,
  nk)``, nk = 255 - k);
* CIELab through LittleCMS's Lab to sRGB transform as PIL builds it
  (``io/cielab.lab_to_rgb``);
* YCbCr under any compression but JPEG as libtiff's ``TIFFRGBAImage``
  hands it to PIL: units of hs x vs Y samples then Cb and Cr
  (YCbCrSubSampling 1x1, 2x1, 1x2, 2x2, 4x1, 4x2, 4x4, ragged at the
  edges; 4x4 with libtiff's quirks, ``_as_libtiff_4x4``), the chroma over
  its unit, through ``TIFFYCbCrToRGBInit``'s integer tables
  (``ycbcr_tables``: YCbCrCoefficients and ReferenceBlackWhite, libtiff's
  defaults where absent).

Fill order 2 reverses the bits of each byte: of the samples where a strip
is uncompressed (PIL's ``...R`` unpackers; PIL has none for ``L;IR`` and
``P;1R`` / ``P;2R`` / ``P;4R``, and those raise by name), of the
compressed bytes before they decompress otherwise (libtiff, which PIL
reads every compressed file with). Predictors act where libtiff's codecs
apply them (LZW, Deflate, LZMA, Zstandard): horizontal differencing (2)
on 8, 16 or 32-bit samples, floating point (3) on float samples;
uncompressed and PackBits strips ignore the tag as PIL does.

Refused by name: what PIL cannot read (a key not in ``OPEN_INFO``,
uncompressed YCbCr, which PIL unpacks past its strip, YCbCr subsampled
1x4 or 2x4, CCITT of other than one 1-bit sample, a big-endian BigTIFF,
whose header PIL 12.1 takes for a classic one), old-style JPEG (6),
WebP-in-TIFF, ThunderScan, SGILog and the other compressions, old-style
LZW, a predictor on subsampled YCbCr, and planar configuration 2 except
for 8-bit RGB and CMYK (and RGBA uncompressed): PIL reads the others with
one raw mode a plane, which drops fill order 2 and has no unpacker for
most extra samples. A damaged CCITT or Zstandard strip raises (libtiff
warns and fills the row; ``io/ccitt.py``, ``io/zstd.py``).

Writes grey (H, W) and RGB (H, W, 3) uint8 uncompressed, little-endian,
in one strip, byte for byte PIL's file (its tags: SamplesPerPixel only
for RGB, as PIL's ``_save`` writes it only for several bands).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

from superviseddescent_tpu_torch.io.cielab import lab_to_rgb
from superviseddescent_tpu_torch.io.pnm import float_to_u8

TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
         6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
         11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8),
         18: ("Q", 8)}
COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
                4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG",
                8: "Adobe Deflate", 32773: "PackBits", 32946: "Deflate",
                32771: "raw 16-bit padding", 32809: "ThunderScan",
                34676: "SGILog", 34677: "SGILog24", 34925: "LZMA",
                50000: "Zstandard", 50001: "WebP"}
PORTED = (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000)
CCITT = (2, 3, 4)
# the compressions whose host decoder has a C++ form for the card's path
NATIVE = (*CCITT, 50000)
# the codecs of libtiff that apply the Predictor tag
PREDICTED = (5, 8, 32946, 34925, 50000)
# the YCbCr subsamplings (horizontal, vertical) that libtiff's
# TIFFRGBAImage puts, which PIL reads YCbCr with
YCBCR_SUBSAMPLING = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2),
                     (4, 4))
PHOTOMETRIC = {0: "white is zero", 1: "black is zero", 2: "RGB",
               3: "palette", 4: "transparency mask", 5: "CMYK (separated)",
               6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
               32844: "LogL", 32845: "LogLuv"}
SAMPLE_FORMATS = {1: "unsigned", 2: "signed", 3: "float", 4: "untyped"}
EXTRA_SAMPLES = {0: "unspecified", 1: "associated alpha",
                 2: "unassociated alpha"}
# PIL's raw unpackers that do not exist: these uncompressed kinds raise
NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")


def _open_info() -> dict:
    """PIL 12.1's ``TiffImagePlugin.OPEN_INFO``: {(byte order,
    photometric, sample format, fill order, bits, extra samples): (mode,
    raw mode)}."""
    t = {}
    for o in (b"II", b"MM"):
        big = o == b"MM"
        w16 = ";16B" if big else ";16L"
        for fill in (1, 2):
            r = "R" if fill == 2 else ""
            t[o, 0, (1,), fill, (1,), ()] = ("1", "1;I" + r)
            t[o, 1, (1,), fill, (1,), ()] = ("1", "1;R" if r else "1")
            for b in (2, 4):
                t[o, 0, (1,), fill, (b,), ()] = ("L", f"L;{b}I" + r)
                t[o, 1, (1,), fill, (b,), ()] = ("L", f"L;{b}" + r)
                t[o, 3, (1,), fill, (b,), ()] = ("P", f"P;{b}" + r)
            t[o, 0, (1,), fill, (8,), ()] = ("L", "L;I" + r)
            t[o, 1, (1,), fill, (8,), ()] = ("L", "L;R" if r else "L")
            t[o, 3, (1,), fill, (1,), ()] = ("P", "P;1" + r)
            t[o, 3, (1,), fill, (8,), ()] = ("P", "P;R" if r else "P")
        t[o, 2, (1,), 2, (8, 8, 8), ()] = ("RGB", "RGB;R")
        t[o, 1, (1,), 1, (8, 8), (2,)] = ("LA", "LA")
        t[o, 1, (2,), 1, (8,), ()] = ("L", "L")
        for p in (0, 1):
            t[o, p, (3,), 1, (32,), ()] = ("F", "F;32BF" if big else
                                           "F;32F")
        t[o, 1, (1,), 1, (16,), ()] = ("I;16B", "I;16B") if big else (
            "I;16", "I;16")
        t[o, 1, (2,), 1, (16,), ()] = ("I", "I;16BS" if big else "I;16S")
        t[o, 1, (2,), 1, (32,), ()] = ("I", "I;32BS" if big else "I;32S")
        t[o, 2, (1,), 1, (8, 8, 8), ()] = ("RGB", "RGB")
        t[o, 2, (1,), 1, (16,) * 3, ()] = ("RGB", "RGB" + w16)
        for n, x in ((0, ""), (1, "X"), (2, "XX")):
            rest = (0,) * n
            t[o, 2, (1,), 1, (8,) * (4 + n), (0,) + rest] = ("RGB",
                                                            "RGBX" + x)
            t[o, 2, (1,), 1, (8,) * (4 + n), (1,) + rest] = ("RGBA",
                                                            "RGBa" + x)
            t[o, 2, (1,), 1, (8,) * (4 + n), (2,) + rest] = ("RGBA",
                                                            "RGBA" + x)
            t[o, 5, (1,), 1, (8,) * (4 + n), rest] = ("CMYK", "CMYK" + x)
        t[o, 2, (1,), 1, (8,) * 4, ()] = ("RGBA", "RGBA")
        t[o, 2, (1,), 1, (8,) * 4, (999,)] = ("RGBA", "RGBA")
        for extra, mode, raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
                                 ((1,), "RGBA", "RGBa"),
                                 ((2,), "RGBA", "RGBA")):
            t[o, 2, (1,), 1, (16,) * 4, extra] = (mode, raw + w16)
        t[o, 3, (1,), 1, (8, 8), (0,)] = ("P", "PX")
        t[o, 3, (1,), 1, (8, 8), (2,)] = ("PA", "PA")
        t[o, 5, (1,), 1, (16,) * 4, ()] = ("CMYK", "CMYK" + w16)
        t[o, 6, (1,), 1, (8, 8, 8), ()] = ("RGB", "RGBX")
        t[o, 6, (1,), 1, (8,), ()] = ("L", "L")
        t[o, 8, (1,), 1, (8, 8, 8), ()] = ("LAB", "LAB")
    t[b"II", 0, (1,), 1, (16,), ()] = ("I;16", "I;16")
    t[b"II", 1, (1,), 1, (12,), ()] = ("I;16", "I;12")
    t[b"II", 1, (1,), 1, (32,), ()] = ("I", "I;32N")
    t[b"II", 1, (1,), 2, (16,), ()] = ("I;16", "I;16R")
    return t


OPEN_INFO = _open_info()
# big-endian raw modes that PIL leaves as they are where libtiff decodes
# (every compressed strip) and hands it the samples in native order: PIL
# reads them byte-swapped (on a little-endian host, as here)
SWAPPED = ("I;16BS", "I;32BS", "F;32BF")
# bit-reversal of every byte value (fill order 2)
REVERSED = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                         axis=1)[:, ::-1].copy()
REVERSED = np.packbits(REVERSED, axis=1)[:, 0]


def _ifd(data: bytes):
    """The first IFD's tags: {tag: tuple of values}, of a classic TIFF (a
    32-bit first-IFD offset, a 16-bit entry count, 12-byte entries with
    values of up to 4 bytes inline) or a BigTIFF (byte size 8, a 64-bit
    offset and entry count, 20-byte entries, values of up to 8 bytes
    inline)."""
    head = data[:4]
    if head not in (b"II*\x00", b"MM\x00*", b"II\x2b\x00", b"MM\x00\x2b"):
        raise ValueError("not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    if head == b"MM\x00\x2b":
        raise ValueError("BigTIFF in big-endian byte order is not a kind PIL "
                         "reads (PIL 12.1 takes its header for a classic "
                         "TIFF's)")
    if head == b"II\x2b\x00":
        if len(data) < 16 or struct.unpack_from(e + "HH", data, 4) != (8, 0):
            raise ValueError("BigTIFF: bad header (byte size not 8)")
        (offset,) = struct.unpack_from(e + "Q", data, 8)
        count_fmt, entry_fmt, inline = "Q", "HHQ", 8
    else:
        (offset,) = struct.unpack_from(e + "I", data, 4)
        count_fmt, entry_fmt, inline = "H", "HHI", 4
    pointer = "Q" if inline == 8 else "I"
    entry = struct.calcsize("<" + entry_fmt) + inline
    start = offset + struct.calcsize("<" + count_fmt)
    if start > len(data):
        raise ValueError("TIFF: truncated IFD")
    (count,) = struct.unpack_from(e + count_fmt, data, offset)
    tags = {}
    for i in range(count):
        at = start + entry * i
        if at + entry > len(data):
            raise ValueError("TIFF: truncated IFD")
        tag, kind, n = struct.unpack_from(e + entry_fmt, data, at)
        if kind not in TYPES:
            continue
        fmt, size = TYPES[kind]
        where = at + entry - inline
        if size * n > inline:
            (where,) = struct.unpack_from(e + pointer, data, where)
        if where + size * n > len(data):
            raise ValueError(f"TIFF: tag {tag} runs past the end of the file")
        if kind == 2:
            tags[tag] = (data[where:where + n],)
        else:
            tags[tag] = struct.unpack_from(e + fmt * n, data, where)
    return e, tags


def _packbits(data: bytes, size: int) -> bytes:
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos >= len(data):
                break
            out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out)


def _lzw(data: bytes, size: int) -> bytes:
    """TIFF LZW: codes MSB first from 9 bits, Clear 256, EOI 257, the
    width growing when the next code would reach 2^width - 1."""
    if data[:2] == b"\x00\x01":
        raise ValueError("TIFF: old-style LZW is not ported")
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = []
    produced = 0
    width, buf, nbits, pos = 9, 0, 0, 0
    prev = None
    n = len(data)
    while produced < size:
        while nbits < width:
            if pos >= n:
                return b"".join(out)
            buf = ((buf & 0xFFFFFF) << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= width
        code = (buf >> nbits) & ((1 << width) - 1)
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table) < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("TIFF: invalid LZW code")
        out.append(entry)
        produced += len(entry)
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return b"".join(out)


def _lzma(chunk: bytes, size: int) -> bytes:
    try:
        import lzma
    except ImportError:
        raise ValueError("TIFF LZMA compression needs Python's lzma module, "
                         "which this Python lacks") from None
    try:
        return lzma.LZMADecompressor().decompress(chunk, size)
    except lzma.LZMAError as e:
        raise ValueError(f"TIFF: bad LZMA data ({e})") from None


def _decompress(kind: int, chunk: bytes, size: int) -> bytes:
    if kind == 1:
        return chunk
    if kind == 32773:
        return _packbits(chunk, size)
    if kind == 5:
        return _lzw(chunk, size)
    if kind == 34925:
        return _lzma(chunk, size)
    try:
        return zlib.decompressobj().decompress(chunk, size)
    except zlib.error as e:
        raise ValueError(f"TIFF: bad Deflate data ({e})") from None


def _sample_type(e: str, bits: int, fmt: int):
    """The numpy type of one sample of ``bits`` (8 and more) in byte order
    ``e``."""
    if bits == 8:
        return np.dtype(np.uint8)
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    return np.dtype(f"{e}{kind}{bits // 8}")


def _unpredict(block: np.ndarray, e: str, bits: int, fmt: int,
               stride: int, predictor: int) -> np.ndarray:
    """libtiff's predictors undone on one strip or tile's rows (h,
    row_bytes): horizontal differencing (2) adds each sample to the one
    ``stride`` samples to its left, modulo 2^bits; floating point (3)
    adds each byte to the one ``stride`` bytes to its left, then gathers
    each sample's bytes from the row's planes, most significant first."""
    h, row_bytes = block.shape
    if predictor == 2:
        utype = np.dtype(f"{e}u{bits // 8}") if bits > 8 else np.dtype(
            np.uint8)
        v = block.view(utype).reshape(h, -1, stride).astype(np.uint64)
        v = np.cumsum(v, axis=1) & ((1 << bits) - 1)
        return v.astype(utype).reshape(h, -1).view(np.uint8)
    size = bits // 8
    acc = np.cumsum(block.reshape(h, -1, stride).astype(np.uint64),
                    axis=1) & 0xFF
    planes = acc.astype(np.uint8).reshape(h, size, -1)
    be = np.ascontiguousarray(planes.transpose(0, 2, 1)).view(
        f">{'uif'[fmt - 1]}{size}")
    return be.astype(_sample_type(e, bits, fmt)).reshape(h, -1).view(
        np.uint8)


def _samples(rows: np.ndarray, e: str, bits: int, fmt: int,
             count: int) -> np.ndarray:
    """(h, row_bytes) bytes -> (h, count) samples: bits below 8 and 12
    packed most significant first, 8 and more as ``_sample_type``."""
    h = rows.shape[0]
    if bits in (1, 2, 4, 12):
        b = np.unpackbits(rows, axis=1)[:, :count * bits].reshape(
            h, count, bits).astype(np.uint16)
        return (b << np.arange(bits - 1, -1, -1, dtype=np.uint16)).sum(
            axis=2, dtype=np.uint16)
    return np.ascontiguousarray(rows).view(_sample_type(e, bits, fmt))[
        :, :count]


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's ``cmyk2rgb``: nk - MULDIV255(c, nk) with nk = 255 - k."""
    c = cmyk[..., :3].astype(np.int32)
    nk = 255 - cmyk[..., 3:4].astype(np.int32)
    t = c * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def _unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """PIL's ``RGBa`` unpacker: c * 255 // a, 0 where a is 0, clipped."""
    a = alpha.astype(np.int32)[..., None]
    out = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
    return np.where(a == 0, 0, np.where(a == 255, rgb, out)).astype(
        np.uint8)


def _to_uint8(samples: np.ndarray, mode: str, photometric: int, bits: int,
              extra: tuple, palette) -> np.ndarray:
    """A kind's samples (H, W, spp) -> uint8 (H, W) grey or (H, W, 3) RGB,
    as PIL's unpacker and ``convert("RGB")`` give them."""
    first = samples[..., 0]
    if mode == "1":
        return np.where((first == 1) != (photometric == 0), 255, 0).astype(
            np.uint8)
    if mode in ("L", "LA"):
        v = first.astype(np.int32) * (255 // ((1 << bits) - 1))
        return (255 - v if photometric == 0 else v).astype(np.uint8)
    if mode in ("I;16", "I;16B", "I"):
        if first.dtype.kind == "u" and first.dtype.itemsize == 4:
            first = first.astype(np.uint32).view(np.int32)  # PIL's I;32N
        return np.clip(first.astype(np.int64), 0, 255).astype(np.uint8)
    if mode == "F":
        return float_to_u8(first)
    if mode in ("P", "PA"):
        return palette[first]
    eight = (samples >> 8).astype(np.uint8) if bits == 16 else samples
    if mode == "CMYK":
        return _cmyk_to_rgb(eight[..., :4])
    if mode == "LAB":
        return lab_to_rgb(eight[..., :3])
    rgb = np.ascontiguousarray(eight[..., :3])
    if extra[:1] == (1,):
        return _unpremultiply(rgb, eight[..., 3])
    return rgb


def _rational(values) -> list:
    """RATIONAL values (numerator, denominator pairs) as libtiff's floats:
    float32 quotients, 0 where either is 0."""
    return [np.float32(0) if not n or not d else np.float32(n) / np.float32(d)
            for n, d in zip(values[::2], values[1::2])]


def ycbcr_tables(luma=None, ref=None):
    """libtiff's ``TIFFYCbCrToRGBInit`` in its arithmetic: float32
    ``Code2V`` of each code against ReferenceBlackWhite (``ref``, its
    YCbCr default where absent), clamped to +-4096 and truncated, then the
    16-bit fixed-point factors of YCbCrCoefficients (``luma``, 0.299 /
    0.587 / 0.114 where absent). Returns the int64 tables (Y, Cr to red,
    Cb to blue, Cr to green, Cb to green), each indexed by a code 0-255."""
    f = np.float32
    red, green, blue = (f(v) for v in (luma or (0.299, 0.587, 0.114)))
    ref = [f(v) for v in (ref or (0, 255, 128, 255, 128, 255))]

    def fix(v):       # FIX(CLAMP(v, 0, 2)): float, then + 0.5 in double
        v = min(max(v, f(0)), f(2))
        return int(float(v * f(65536)) + 0.5)

    def code2v(c, black, white, top):
        den = white - black
        v = (c - np.int64(np.trunc(black))).astype(np.float32) * f(top) / (
            den if den != 0 else f(1))
        return np.trunc(np.clip(v, f(-4096), f(4096))).astype(np.int64)
    f1 = f(2) - f(2) * red
    f3 = f(2) - f(2) * blue
    d1, d2 = fix(f1), -fix(red * f1 / green)
    d3, d4 = fix(f3), -fix(blue * f3 / green)
    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, ref[4] - f(128), ref[5] - f(128), 127)
    cb = code2v(x, ref[2] - f(128), ref[3] - f(128), 127)
    y = code2v(x + 128, ref[0], ref[1], 255)
    half = 1 << 15
    return (y, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
            d4 * cb + half)


def ycbcr_to_rgb(y, cb, cr, tables) -> np.ndarray:
    """libtiff's ``TIFFYCbCrtoRGB`` on uint8 codes: (..., 3) uint8 RGB."""
    ty, crr, cbb, crg, cbg = tables
    base = ty[y]
    rgb = np.stack([base + crr[cr], base + ((cbg[cb] + crg[cr]) >> 16),
                    base + cbb[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycbcr_units(block: np.ndarray, width: int, rows: int, hs: int,
                 vs: int) -> tuple:
    """A strip or tile's YCbCr units (each hs x vs Y samples in rows, then
    Cb and Cr) -> Y, Cb and Cr of (rows, width), the chroma over its
    unit."""
    across, down = -(-width // hs), -(-rows // vs)
    u = block[:across * down * (hs * vs + 2)].reshape(down, across,
                                                       hs * vs + 2)
    y = u[..., :hs * vs].reshape(down, across, vs, hs).transpose(
        0, 2, 1, 3).reshape(down * vs, across * hs)
    cb, cr = (np.repeat(np.repeat(u[..., k], vs, 0), hs, 1)
              for k in (hs * vs, hs * vs + 1))
    return tuple(a[:rows, :width] for a in (y, cb, cr))


def _as_libtiff_4x4(block: np.ndarray, tw: int, rows: int, seen: int,
                    tiled: bool) -> np.ndarray:
    """A 4 x 4 subsampled YCbCr strip or tile's units as libtiff's
    TIFFRGBAImage hands them to its 4 x 4 put routine, which PIL reads:
    a strip decoded only as far as whole scanlines reach (its scanline is
    a unit row's bytes over 4, rounded down: with an odd count of units a
    row, the last unit's chroma of each unit row is cut off and reads 0),
    and a tile clipped at the image's right edge (``seen`` columns) with
    its unit rows stepped as 4 x 2 units (10 bytes) are, not 18."""
    across, down = -(-tw // 4), -(-rows // 4)
    row_bytes = across * 18
    if not tiled:
        out = np.zeros_like(block)
        keep = down * 4 * (row_bytes // 4)
        out[:keep] = block[:keep]
        return out
    if seen == tw:
        return block
    used = -(-seen // 4)
    step = used * 18 + (tw - seen) // 4 * 10
    out = np.zeros(down * row_bytes, np.uint8)
    for r in range(down):
        out[r * row_bytes:r * row_bytes + used * 18] = block[
            r * step:r * step + used * 18]
    return out


def _codecs(native):
    """The CCITT and Zstandard decoders: the Python twins where ``native``
    is false, else the host C++ ones (``csrc/tiff_decode.cu``; ``native``
    True loads ``ops/_build``'s build, or names a loaded library)."""
    from superviseddescent_tpu_torch.io import ccitt, zstd
    if not native:
        return ccitt.decode_ccitt, zstd.read_strip
    library = None if native is True else native
    return (lambda *a: ccitt.decode_ccitt_native(*a, library=library),
            lambda *a: zstd.read_strip_native(*a, library=library))


def decode_tiff(data: bytes, native=False) -> np.ndarray:
    """TIFF bytes -> the first page as uint8 (H, W) grey (PIL's modes 1,
    L, LA, I;16, I and F) or (H, W, 3) RGB, decoded on the host. A
    JPEG-compressed page is not the host's: ``ops/jpeg.read_tiff_jpeg``
    reads it (kernel J1). CCITT and Zstandard strips decode by the Python
    twins, or where ``native`` is true by the host C++ decoders
    (``csrc/tiff_decode.cu``), which the card's path takes."""
    e, tags = _ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]
    width, height = one(256), one(257)
    if not width or not height:
        raise ValueError("TIFF: no image size")
    kind = one(259, 1)
    if kind not in PORTED:
        raise ValueError(f"TIFF {COMPRESSIONS.get(kind, kind)} compression "
                         "is not ported")
    if kind == 7:
        raise ValueError("TIFF JPEG compression is not decoded on the host: "
                         "ops/jpeg.read_tiff_jpeg reads it (kernel J1)")
    key, mode, raw = kind_of(tags, e)
    photometric, fmt, fill, bits, extra = key[1:]
    depth, spp = bits[0], len(bits)
    if kind in CCITT and (depth, spp) != (1, 1):
        raise ValueError(f"TIFF {COMPRESSIONS[kind]} compression of {spp} "
                         f"{depth}-bit samples is not a kind PIL reads "
                         "(libtiff's codec takes one 1-bit sample)")
    ycbcr = photometric == 6 and spp == 3
    hs, vs = tags.get(530, (2, 2))[:2] if ycbcr else (1, 1)
    if ycbcr and kind == 1:
        raise ValueError("TIFF photometric 6 (YCbCr), uncompressed, is not a "
                         "kind PIL reads (it unpacks 3 samples as 4)")
    if ycbcr and (hs, vs) not in YCBCR_SUBSAMPLING:
        raise ValueError(f"TIFF YCbCr subsampling {hs} x {vs} is not a kind "
                         "PIL reads (libtiff's TIFFReadRGBA takes 1x1, 2x1, "
                         "1x2, 2x2, 4x1, 4x2 and 4x4)")
    if fill == 2 and kind == 1 and raw in NO_UNPACKER:
        raise ValueError(f"TIFF fill order 2 of {PHOTOMETRIC[photometric]} "
                         f"{bits[0]}-bit samples, uncompressed, is not a kind "
                         f"PIL reads (it has no {raw} unpacker)")
    predictor = one(317, 1) if kind in PREDICTED else 1
    if predictor not in (1, 2, 3):
        raise ValueError(f"TIFF predictor {predictor} is not ported")
    if predictor == 2 and depth not in (8, 16, 32):
        raise ValueError(f"TIFF predictor 2 on {depth}-bit samples is not "
                         "a kind PIL reads (libtiff refuses it)")
    if predictor == 3 and fmt != (3,):
        raise ValueError(f"TIFF predictor 3 on {depth}-bit "
                         f"{SAMPLE_FORMATS[fmt[0]]} samples is not a kind "
                         "PIL reads (libtiff takes float samples only)")
    if predictor != 1 and (hs, vs) != (1, 1):
        raise ValueError(f"TIFF predictor {predictor} on YCbCr subsampled "
                         f"{hs} x {vs} is not ported")
    planar = one(284, 1) if spp > 1 else 1
    if planar == 2 and not (raw in ("RGB", "CMYK") or (
            raw == "RGBA" and kind == 1)):
        raise ValueError(f"TIFF planar configuration 2 of {mode} (raw mode "
                         f"{raw}) with {COMPRESSIONS[kind]} compression is "
                         "not ported")
    palette = None
    if photometric == 3:
        cmap = tags.get(320)
        if cmap is None or len(cmap) < 3 << depth:
            raise ValueError("TIFF palette image without a full ColorMap")
        n = len(cmap) // 3
        palette = np.zeros((max(n, 256), 3), np.uint8)
        palette[:n] = (np.asarray(cmap[:3 * n], np.int64) >> 8).reshape(
            3, n).T
    planes = spp if planar == 2 else 1
    per_pixel = 1 if planar == 2 else spp
    if 322 in tags:
        tw, tl = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
        across, down = -(-width // tw), -(-height // tl)
    else:
        tw, tl = width, min(one(278, 2 ** 32 - 1), height)
        offsets, counts = tags.get(273), tags.get(279)
        across, down = 1, -(-height // tl)
    if offsets is None or counts is None:
        raise ValueError("TIFF: no strip or tile offsets")
    if len(offsets) < planes * across * down:
        raise ValueError("TIFF: fewer strips or tiles than the image needs")
    ccitt, zstd = _codecs(native) if kind in NATIVE else (None, None)
    options = one(292 if kind == 3 else 293, 0)
    tables = ycbcr_tables(_rational(tags[529]) if 529 in tags else None,
                          _rational(tags[532]) if 532 in tags else None
                          ) if ycbcr else None
    row_bytes = -(-tw * per_pixel * depth // 8)
    per_row = tw * per_pixel
    sample_fmt = fmt[0]
    out = None
    for p in range(planes):
        for ty in range(down):
            band = []
            rows = tl if 322 in tags else min(tl, height - ty * tl)
            for tx in range(across):
                k = (p * down + ty) * across + tx
                if offsets[k] + counts[k] > len(data):
                    raise ValueError("TIFF: truncated image data")
                chunk = data[offsets[k]:offsets[k] + counts[k]]
                if fill == 2 and kind != 1:
                    chunk = REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
                size = rows * row_bytes
                if ycbcr:
                    size = -(-tw // hs) * -(-rows // vs) * (hs * vs + 2)
                if kind in CCITT:
                    unpacked = ccitt(chunk, kind, tw, rows, options)
                elif kind == 50000:
                    unpacked = zstd(chunk, size)
                else:
                    unpacked = _decompress(kind, chunk, size)
                if len(unpacked) < size:
                    raise ValueError("TIFF: a strip or tile decodes to too "
                                     "little data")
                block = np.frombuffer(unpacked[:size], np.uint8)
                if ycbcr:
                    if predictor != 1:
                        block = _unpredict(block.reshape(rows, -1), e, 8, 1,
                                           3, predictor).ravel()
                    seen = min(tw, width - tx * tw)
                    if (hs, vs) == (4, 4):
                        block = _as_libtiff_4x4(block, tw, rows, seen,
                                                322 in tags)
                    band.append(ycbcr_to_rgb(*_ycbcr_units(
                        block, tw, rows, hs, vs), tables))
                    continue
                block = block.reshape(rows, row_bytes)
                if fill == 2 and kind == 1:
                    block = REVERSED[block]
                if predictor != 1:
                    block = _unpredict(block, e, depth, sample_fmt,
                                       per_pixel, predictor)
                band.append(_samples(block, e, depth, sample_fmt, per_row))
            band = np.concatenate(band, axis=1).reshape(
                rows, across * tw, -1)[:, :width]
            if out is None:
                out = np.zeros((height + tl, width, 3 if ycbcr else spp),
                               band.dtype)
            out[ty * tl:ty * tl + rows, :, p:p + band.shape[2]] = band
    out = out[:height]
    if ycbcr:
        return out
    if kind != 1 and raw in SWAPPED:
        out = out.byteswap()
    return _to_uint8(out, mode, photometric, depth, extra, palette)


@dataclass
class JpegTiff:
    """A JPEG-compressed page (compression 7): its size, photometric
    (1 grey, 2 RGB, 6 YCbCr), the strip or tile size, the strips or tiles
    across and down, and each one's JPEG stream in row order, the
    JPEGTables tag's tables spliced in front of its frame."""
    width: int
    height: int
    photometric: int
    subsampling: tuple
    tile: tuple
    across: int
    down: int
    tiled: bool
    streams: list


def compression(data: bytes) -> int:
    """The first page's Compression tag (1 where it is missing)."""
    _, tags = _ifd(data)
    return tags.get(259, (1,))[0]


def jpeg_chunks(data: bytes) -> JpegTiff:
    """A JPEG-compressed page's streams, as libtiff's JPEG codec takes
    them: each strip or tile an abbreviated JPEG whose tables are the
    JPEGTables tag's (347), one image of the strip's rows (the last strip
    the rows left) or of the whole tile. Photometric 1 (one component),
    2 (RGB, three components of one sample each, not converted) and 6
    (YCbCr, converted to RGB as libjpeg does, PIL's JPEGCOLORMODE_RGB) in
    planar configuration 1; everything else raises by name."""
    e, tags = _ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]
    if one(259, 1) != 7:
        raise ValueError("TIFF: not JPEG-compressed")
    width, height = one(256), one(257)
    if not width or not height:
        raise ValueError("TIFF: no image size")
    key, _, _ = kind_of(tags, e)
    photometric, bits = key[1], key[4]
    if (photometric, bits) not in ((1, (8,)), (2, (8, 8, 8)),
                                   (6, (8, 8, 8))):
        raise ValueError(f"TIFF JPEG of photometric {photometric} ("
                         f"{PHOTOMETRIC.get(photometric, 'unknown')}) with "
                         f"{bits} bits is not ported (8-bit grey, RGB or "
                         "YCbCr)")
    if len(bits) > 1 and one(284, 1) == 2:
        raise ValueError("TIFF JPEG in planar configuration 2 is not ported")
    tiled = 322 in tags
    if tiled:
        tw, tl = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
        across, down = -(-width // tw), -(-height // tl)
    else:
        tw, tl = width, min(one(278, 2 ** 32 - 1), height)
        offsets, counts = tags.get(273), tags.get(279)
        across, down = 1, -(-height // tl)
    if offsets is None or counts is None:
        raise ValueError("TIFF: no strip or tile offsets")
    if len(offsets) < across * down:
        raise ValueError("TIFF: fewer strips or tiles than the image needs")
    tables = bytes(tags[347]) if 347 in tags else b""
    if tables[-2:] == b"\xff\xd9":
        tables = tables[:-2]
    streams = []
    for k in range(across * down):
        if offsets[k] + counts[k] > len(data):
            raise ValueError("TIFF: truncated image data")
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        if chunk[:2] != b"\xff\xd8":
            raise ValueError("TIFF: a JPEG strip or tile without SOI")
        streams.append(tables + chunk[2:] if tables else chunk)
    return JpegTiff(width, height, photometric,
                    tuple(tags.get(530, (2, 2))), (tw, tl), across, down,
                    tiled, streams)


def kind_of(tags: dict, e: str):
    """The page's key in ``OPEN_INFO``, its mode and raw mode, as PIL's
    ``_setup`` forms it (photometric 0 where the tag is missing, one
    sample format for several equal ones, BitsPerSample cut or repeated
    to SamplesPerPixel); raises naming a kind PIL does not read."""
    photometric = tags.get(262, (0,))[0]
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    bits = tuple(tags.get(258, (1,)))
    extra = tuple(tags.get(338, ()))
    spp = tags.get(277, (1,))[0]
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError(f"TIFF: {len(bits)} BitsPerSample values for "
                         f"{spp} samples")
    fill = tags.get(266, (1,))[0]
    key = (b"II" if e == "<" else b"MM", photometric, fmt, fill, bits,
           extra)
    if key not in OPEN_INFO:
        names = "/".join(SAMPLE_FORMATS.get(f, str(f)) for f in fmt)
        alpha = (", extra samples " + "/".join(
            EXTRA_SAMPLES.get(x, str(x)) for x in extra)) if extra else ""
        raise ValueError(
            f"TIFF photometric {photometric} ("
            f"{PHOTOMETRIC.get(photometric, 'unknown')}) of {bits} bits, "
            f"{names} samples, fill order {fill}{alpha} is not a kind PIL "
            "reads")
    return (key, *OPEN_INFO[key])


def encode_tiff(pixels) -> bytes:
    """uint8 (H, W) grey or (H, W, 3) RGB -> the uncompressed
    little-endian TIFF of one strip that PIL's ``save`` writes, byte for
    byte."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError("TIFF pixels must be uint8 (H, W) grey or (H, W, 3) "
                         f"RGB, got {pixels.dtype} {pixels.shape}")
    height, width = pixels.shape[:2]
    spp = 1 if pixels.ndim == 2 else 3
    body = np.ascontiguousarray(pixels).tobytes()
    entries = [(256, 4, (width,)), (257, 4, (height,)),
               (258, 3, (8,) * spp), (259, 3, (1,)),
               (262, 3, (1 if spp == 1 else 2,)), (273, 4, (0,)),
               (277, 3, (spp,)), (278, 4, (height,)),
               (279, 4, (len(body),)), (284, 3, (1,))]
    if spp == 1:   # PIL's _save writes SamplesPerPixel for several bands
        entries = [e for e in entries if e[0] != 277]
    ifd_at = 8
    ifd_size = 2 + 12 * len(entries) + 4
    extra_at = ifd_at + ifd_size
    bits_at = extra_at
    data_at = extra_at + (2 * spp if spp > 2 else 0)
    ifd = struct.pack("<H", len(entries))
    for tag, kind, values in entries:
        if tag == 273:
            values = (data_at,)
        fmt = "<" + TYPES[kind][0] * len(values)
        packed = struct.pack(fmt, *values)
        if len(packed) > 4:
            ifd += struct.pack("<HHII", tag, kind, len(values), bits_at)
        else:
            ifd += struct.pack("<HHI", tag, kind, len(values)) + packed.ljust(
                4, b"\x00")
    ifd += struct.pack("<I", 0)
    tail = struct.pack("<" + "H" * spp, *(8,) * spp) if spp > 2 else b""
    return b"II*\x00" + struct.pack("<I", ifd_at) + ifd + tail + body
