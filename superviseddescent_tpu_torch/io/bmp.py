"""BMP / DIB: reader and writer, as PIL reads and writes them (no PIL).

Reads the headers PIL reads (OS/2 core of 12 bytes, Windows 40, 52, 56,
64, V4 108 and V5 124), bottom-up and top-down (a negative height), with
PIL's rule for where the pixels start; 1, 4 and 8 bits through the
palette (BGR or BGRX entries), uncompressed or RLE8 / RLE4; 16 bits as
5-5-5 or 5-6-5 (``BI_BITFIELDS`` masks 0x7C00 / 0x3E0 / 0x1F or 0xF800 /
0x7E0 / 0x1F), 24 and 32 bits as BGR and BGRX (and the 32-bit
``BI_BITFIELDS`` layouts PIL knows, alpha dropped as ``convert("RGB")``
drops it). A palette that is the grey ramp (0 / 255 for two colours, index
i -> grey i otherwise) is PIL's mode ``1`` / ``L`` and reads as grey; any
other palette reads as RGB, an index past the palette black. RLE data
that ends early raises, as PIL's decoder then leaves too little data; an
RLE delta is read as PIL reads it (two bytes skipped, the next two taken
as the offsets). Refused by name: JPEG / PNG inside BMP, other bit depths
and bitfields, and a grey-ramp palette at a depth other than that of its
mode (PIL reads such files with the raw layout of 1 or 8 bits a pixel,
a layout no writer makes).

Writes grey (H, W) as 8 bits with the 256-entry grey palette and RGB
(H, W, 3) as 24-bit ``BI_RGB``, bottom-up, rows padded to 4 bytes, 96 dpi
(3,780 pixels per metre), byte for byte PIL's; ``dib=True`` leaves out the
14-byte file header, as PIL's DIB writer does.
"""

from __future__ import annotations

import struct

import numpy as np

HEADERS = (12, 40, 52, 56, 64, 108, 124)
COMPRESSIONS = {0: "BI_RGB", 1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS",
                4: "JPEG", 5: "PNG"}
# (bits, masks) -> the channels' order in each pixel, as PIL's raw modes
BITFIELDS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
PIXELS_PER_METRE = 3780          # int(96 * 39.3701 + 0.5)


def _u16(b, at):
    return struct.unpack_from("<H", b, at)[0]


def _u32(b, at):
    return struct.unpack_from("<I", b, at)[0]


def _rle(data: bytes, pos: int, width: int, height: int,
         rle4: bool) -> np.ndarray:
    """PIL's ``BmpRleDecoder``: the rows in file order, indices."""
    out = bytearray()
    total = width * height
    x = 0
    while len(out) < total and pos + 1 < len(data):
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, width - x))
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i & 1] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                      # end of line
            out += b"\x00" * (-len(out) % width)
            x = 0
        elif byte == 1:                      # end of bitmap
            break
        elif byte == 2:                      # delta: PIL skips two bytes
            if pos + 2 > len(data):          # and reads the next two
                break
            if pos + 4 > len(data):
                raise ValueError("BMP: truncated RLE delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += b"\x00" * (right + up * width)
            x = len(out) % width
        else:                                # absolute run
            n = byte // 2 if rle4 else byte
            chunk = data[pos:pos + n]
            pos += n
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < n:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < total:
        raise ValueError("BMP: the RLE data ends before the image does")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(height, width)


def _palette_index_rows(raw: np.ndarray, bits: int, width: int) -> np.ndarray:
    """(rows, stride) bytes -> (rows, width) indices of 1, 4 or 8 bits."""
    if bits == 8:
        return raw[:, :width]
    unpacked = np.unpackbits(raw, axis=1)
    per = unpacked.reshape(raw.shape[0], -1, bits)
    weights = 1 << np.arange(bits - 1, -1, -1)
    return (per * weights).sum(axis=2).astype(np.uint8)[:, :width]


def decode_bmp(data: bytes, dib: bool = False) -> np.ndarray:
    """BMP bytes (or a DIB's, with no file header) -> uint8 (H, W) grey
    (PIL's modes 1 and L) or (H, W, 3) RGB."""
    if dib:
        start, offset = 0, 0
    else:
        if data[:2] != b"BM" or len(data) < 18:
            raise ValueError("not a BMP file")
        start, offset = 14, _u32(data, 10)
    size = _u32(data, start)
    if size not in HEADERS:
        raise ValueError(f"BMP header of {size} bytes is not ported "
                         f"(sizes {HEADERS})")
    if len(data) < start + size:
        raise ValueError("BMP: truncated header")
    h = data[start + 4:start + size]
    pos = start + size
    flip = False
    if size == 12:
        width, height, bits = _u16(h, 0), _u16(h, 2), _u16(h, 6)
        compression, colors, entry = 0, 0, 3
    else:
        flip = h[7] == 0xFF
        width = _u32(h, 0)
        height = 2 ** 32 - _u32(h, 4) if flip else _u32(h, 4)
        bits, compression = _u16(h, 10), _u32(h, 12)
        colors, entry = _u32(h, 28), 4
    if compression not in COMPRESSIONS:
        raise ValueError(f"BMP compression {compression} is not supported")
    if compression in (4, 5):
        raise ValueError(f"BMP with {COMPRESSIONS[compression]} data inside "
                         "is not ported")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP of {bits} bits per pixel is not supported")
    if width <= 0 or height <= 0:
        raise ValueError(f"BMP: size {width} x {height}")
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    order = {16: "BGR;15", 24: "BGR", 32: "BGRX"}.get(bits)
    if compression == 3:
        if len(h) >= 48:
            masks = tuple(_u32(h, 36 + 4 * i) for i in range(3))
            alpha = _u32(h, 48) if len(h) >= 52 else 0
        else:
            masks = tuple(_u32(data, pos + 4 * i) for i in range(3))
            alpha = 0
            pos += 12
        key = (bits, masks + (alpha,)) if bits == 32 else (bits, masks)
        if key not in BITFIELDS:
            raise ValueError(f"BMP bitfields {[hex(m) for m in key[1]]} at "
                             f"{bits} bits are not supported")
        order = BITFIELDS[key]
    elif compression in (1, 2) and (bits, compression) not in ((8, 1),
                                                               (4, 2)):
        raise ValueError(f"BMP {COMPRESSIONS[compression]} at {bits} bits "
                         "is not supported")
    palette = grey = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours")
        table = np.frombuffer(data[pos:pos + entry * colors], np.uint8)
        if len(table) < entry * colors:
            raise ValueError("BMP: truncated palette")
        table = table.reshape(colors, entry)
        ramp = np.array([0, 255] if colors == 2 else np.arange(colors))
        grey = bool((table[:, :3] == (ramp[:, None] & 0xFF)).all())
        # PIL reads a grey-ramp palette's indices with the raw layout of
        # its mode (1 or 8 bits a pixel), whatever the file's
        if grey and (bits != (1 if colors == 2 else 8) if compression == 0
                     else colors == 2):
            raise ValueError(f"BMP: a {bits}-bit image whose palette is the "
                             f"grey ramp of {colors} colours is not ported")
        pos += entry * colors
        palette = np.zeros((256, 3), np.uint8)
        n = min(colors, 256)
        palette[:n] = table[:n, 2::-1]
    at = offset or pos
    if compression in (1, 2):
        rows = _rle(data, at, width, height, compression == 2)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = stride * height
        if len(data) < at + need:
            raise ValueError("BMP: truncated image data")
        raw = np.frombuffer(data[at:at + need], np.uint8).reshape(height,
                                                                   stride)
        if bits <= 8:
            rows = _palette_index_rows(raw, bits, width)
        elif bits == 16:
            px = raw[:, :2 * width].reshape(height, width, 2)
            v = px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32)
                                               << 8)
            if order == "BGR;16":
                r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
                rows = np.stack([r * 255 // 31, g * 255 // 63,
                                 b * 255 // 31], axis=-1)
            else:
                r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
                rows = np.stack([r, g, b], axis=-1) * 255 // 31
            rows = rows.astype(np.uint8)
        else:
            n = bits // 8
            px = raw[:, :n * width].reshape(height, width, n)
            rows = px[..., [order.index(ch) for ch in "RGB"]]
    if not flip:
        rows = rows[::-1]
    if bits <= 8:
        if grey:
            return (np.where(rows > 0, 255, 0).astype(np.uint8)
                    if colors == 2 else np.ascontiguousarray(rows))
        return palette[rows]
    return np.ascontiguousarray(rows)


def encode_bmp(pixels, dib: bool = False) -> bytes:
    """uint8 (H, W) grey -> 8-bit with the grey palette, (H, W, 3) RGB ->
    24-bit, bottom-up, as PIL's BMP (``dib``: DIB) writer writes them."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError("BMP pixels must be uint8 (H, W) grey or (H, W, 3) "
                         f"RGB, got {pixels.dtype} {pixels.shape}")
    height, width = pixels.shape[:2]
    grey = pixels.ndim == 2
    bits, colors = (8, 256) if grey else (24, 0)
    stride = ((width * bits + 7) // 8 + 3) & ~3
    image = stride * height
    rows = pixels if grey else pixels[..., ::-1]
    body = np.zeros((height, stride), np.uint8)
    body[:, :width * bits // 8] = rows[::-1].reshape(height, -1)
    palette = (bytes(b for i in range(256) for b in (i, i, i, 0))
               if grey else b"")
    info = struct.pack("<IiiHHIIiiII", 40, width, height, 1, bits, 0, image,
                       PIXELS_PER_METRE, PIXELS_PER_METRE, colors, colors)
    head = b""
    if not dib:
        offset = 14 + 40 + colors * 4
        head = b"BM" + struct.pack("<III", offset + image, 0, offset)
    return head + info + palette + body.tobytes()
