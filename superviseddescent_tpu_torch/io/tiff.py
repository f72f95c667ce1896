"""TIFF: a reader of the first page and a writer, as PIL reads and writes
them (no PIL, no libtiff).

Reads the first image of a classic TIFF (``II*\\0`` or ``MM\\0*``): strips
or tiles; no compression, PackBits, LZW (the TIFF 6 variant, codes MSB
first, widths growing one code early) or Adobe Deflate (8, and the old
32946), each with horizontal differencing (predictor 2) where the samples
have 8 bits; planar configuration 1 (chunky) or 2 (a plane per sample);
photometric 0 (white is zero) and 1 (black is zero) at 1 or 8 bits, grey
as PIL's modes ``1`` and ``L``; 2, RGB of 8 bits, with an extra sample
that is unspecified (0) or unassociated alpha (2, or missing
ExtraSamples) dropped as ``convert("RGB")`` drops it; 3, a palette of 1
or 8 bits, each 16-bit ColorMap value taken as its high byte, an index
past the map black. Refused by name: BigTIFF, JPEG, CCITT and the other
compressions, old-style LZW, predictor 3, CMYK, YCbCr, CIELab, 2, 4, 12,
16 and 32-bit samples, signed or float samples, fill order 2 and
associated alpha.

Writes grey (H, W) and RGB (H, W, 3) uint8 uncompressed, little-endian,
in one strip, byte for byte PIL's file (its tags: SamplesPerPixel only
for RGB, as PIL's ``_save`` writes it only for several bands).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
         6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
         11: ("f", 4), 12: ("d", 8), 16: ("Q", 8)}
COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
                4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG",
                8: "Adobe Deflate", 32773: "PackBits", 32946: "Deflate",
                32771: "raw 16-bit padding", 32809: "ThunderScan",
                34676: "SGILog", 34677: "SGILog24", 34925: "LZMA",
                50000: "Zstandard", 50001: "WebP"}
PORTED = (1, 5, 8, 32773, 32946)
PHOTOMETRIC = {0: "white is zero", 1: "black is zero", 2: "RGB",
               3: "palette", 4: "transparency mask", 5: "CMYK (separated)",
               6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
               32844: "LogL", 32845: "LogLuv"}


def _ifd(data: bytes):
    """The first IFD's tags: {tag: tuple of values}."""
    if data[:4] in (b"II\x2b\x00", b"MM\x00\x2b"):
        raise ValueError("BigTIFF is not ported (classic TIFF only)")
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError("not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    (offset,) = struct.unpack_from(e + "I", data, 4)
    if offset + 2 > len(data):
        raise ValueError("TIFF: truncated IFD")
    (count,) = struct.unpack_from(e + "H", data, offset)
    tags = {}
    for i in range(count):
        at = offset + 2 + 12 * i
        if at + 12 > len(data):
            raise ValueError("TIFF: truncated IFD")
        tag, kind, n = struct.unpack_from(e + "HHI", data, at)
        if kind not in TYPES:
            continue
        fmt, size = TYPES[kind]
        where = at + 8
        if size * n > 4:
            (where,) = struct.unpack_from(e + "I", data, at + 8)
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


def _decompress(kind: int, chunk: bytes, size: int) -> bytes:
    if kind == 1:
        return chunk
    if kind == 32773:
        return _packbits(chunk, size)
    if kind == 5:
        return _lzw(chunk, size)
    try:
        return zlib.decompressobj().decompress(chunk, size)
    except zlib.error as e:
        raise ValueError(f"TIFF: bad Deflate data ({e})") from None


def _unpredict(rows: np.ndarray, samples: int) -> np.ndarray:
    """Horizontal differencing undone: each 8-bit sample plus the one
    ``samples`` bytes to its left, mod 256."""
    h, w = rows.shape
    px = rows.reshape(h, w // samples, samples).astype(np.uint32)
    return (np.cumsum(px, axis=1) & 0xFF).astype(np.uint8).reshape(h, w)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> the first page as uint8 (H, W) grey (PIL's modes 1
    and L) or (H, W, 3) RGB."""
    _, tags = _ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]
    width, height = one(256), one(257)
    if not width or not height:
        raise ValueError("TIFF: no image size")
    spp = one(277, 1)
    bits = tuple(tags.get(258, (1,)))
    if len(bits) == 1 and spp > 1:
        bits = bits * spp
    kind = one(259, 1)
    photometric = one(262)
    if photometric is None:
        raise ValueError("TIFF: no photometric interpretation")
    if kind not in PORTED:
        raise ValueError(f"TIFF {COMPRESSIONS.get(kind, kind)} compression "
                         "is not ported")
    if photometric not in (0, 1, 2, 3):
        raise ValueError(f"TIFF photometric {photometric} ("
                         f"{PHOTOMETRIC.get(photometric, 'unknown')}) is not "
                         "ported")
    if set(tags.get(339, (1,))) != {1}:
        raise ValueError("TIFF signed or float samples are not ported")
    if one(266, 1) != 1:
        raise ValueError("TIFF fill order 2 is not ported")
    extra = tuple(tags.get(338, ()))
    if photometric == 2:
        if bits[:3] != (8, 8, 8) or set(bits) != {8} or spp not in (3, 4):
            raise ValueError(f"TIFF RGB of {bits} bits and {spp} samples is "
                             "not ported (8-bit RGB, RGBX or RGBA)")
        if spp == 4 and extra not in ((), (0,), (2,)):
            raise ValueError("TIFF RGB with associated alpha is not ported")
    else:
        if spp != 1 or bits[0] not in (1, 8):
            raise ValueError(f"TIFF {PHOTOMETRIC[photometric]} of {bits} "
                             f"bits and {spp} samples is not ported (1 or "
                             "8 bits, one sample)")
    depth = bits[0]
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor} is not ported")
    if predictor == 2 and depth != 8:
        raise ValueError("TIFF predictor 2 on 1-bit samples is not ported")
    planar = one(284, 1) if spp > 1 else 1
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
    row_bytes = -(-tw * per_pixel * depth // 8)
    out = np.zeros((planes, down * tl, across * row_bytes), np.uint8)
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                k = (p * down + ty) * across + tx
                rows = tl if 322 in tags else min(tl, height - ty * tl)
                size = rows * row_bytes
                chunk = data[offsets[k]:offsets[k] + counts[k]]
                if offsets[k] + counts[k] > len(data):
                    raise ValueError("TIFF: truncated image data")
                raw = _decompress(kind, chunk, size)
                if len(raw) < size:
                    raise ValueError("TIFF: a strip or tile decodes to too "
                                     "little data")
                block = np.frombuffer(raw[:size], np.uint8).reshape(
                    rows, row_bytes)
                if predictor == 2:
                    block = _unpredict(block, per_pixel)
                out[p, ty * tl:ty * tl + rows,
                    tx * row_bytes:(tx + 1) * row_bytes] = block
    if depth == 1:
        bits_ = np.unpackbits(out[0], axis=1)
        samples = np.concatenate(
            [bits_[:, tx * row_bytes * 8:tx * row_bytes * 8 + tw]
             for tx in range(across)], axis=1)[:height, :width]
    else:
        full = out.reshape(planes, down * tl, across * tw, per_pixel)
        samples = (np.moveaxis(full[..., 0], 0, -1) if planes > 1
                   else full[0])[:height, :width]
    if photometric == 3:
        cmap = tags.get(320)
        if cmap is None or len(cmap) < 3 << depth:
            raise ValueError("TIFF palette image without a full ColorMap")
        n = 1 << depth
        table = (np.asarray(cmap[:3 * n], np.int64) >> 8).reshape(3, n).T
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = table
        return palette[samples[..., 0] if samples.ndim == 3 else samples]
    if photometric == 2:
        return np.ascontiguousarray(samples[..., :3])
    grey = samples[..., 0] if samples.ndim == 3 else samples
    if depth == 1:
        grey = np.where(grey == 1, 255, 0).astype(np.uint8)
    if photometric == 0:
        grey = 255 - grey
    return np.ascontiguousarray(grey.astype(np.uint8))


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
