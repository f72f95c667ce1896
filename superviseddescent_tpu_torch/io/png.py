"""PNG decoder and writer on the standard library's zlib (no PIL, no
OpenCV).

The decoder covers 8-bit, non-interlaced PNGs of colour type 0 (grey),
2 (RGB), 4 (grey + alpha) and 6 (RGBA), and raises on anything else. The
writer writes 8-bit grey (H, W) and RGB (H, W, 3) images, every row with
filter type 0.

Rows are un-filtered as a wavefront: pixel (r, x) depends only on
(r, x-1), (r-1, x) and (r-1, x-1), so all pixels on one anti-diagonal
r + x = s are independent and each step is one vectorised numpy update
over every row at once (H + W steps instead of H * W scalar steps).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG stream ends without an IEND chunk")


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    kinds = data[:, 0].astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {kinds.max()}")
    filt = data[:, 1:].astype(np.int32)
    # padded reconstruction: row 0 and the first bpp columns are the zero
    # "previous" neighbours the PNG filters assume
    out = np.zeros((height + 1, stride + bpp), np.int32)
    k = np.arange(bpp)
    for s in range(height + width - 1):
        r = np.arange(max(0, s - width + 1), min(height - 1, s) + 1)
        col = ((s - r) * bpp)[:, None] + k[None, :]      # byte columns
        rr = r[:, None]
        a = out[rr + 1, col]                             # left
        b = out[rr, col + bpp]                           # up
        c = out[rr, col]                                 # up-left
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[r][:, None],
                         [np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        out[rr + 1, col + bpp] = (filt[rr, col] + pred) & 0xFF
    return out[1:, bpp:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 array, C = 1, 2, 3 or 4."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if (depth != 8 or colour not in _CHANNELS or compression != 0
            or filtering != 0 or interlace != 0):
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {colour}, "
            f"interlace {interlace} (8-bit non-interlaced grey, grey+alpha, "
            f"RGB or RGBA only)")
    channels = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width,
                       channels)
    return pixels.reshape(height, width, channels)


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(pixels) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 array -> PNG bytes."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, got {pixels.dtype}")
    if pixels.ndim == 2:
        colour = 0
    elif pixels.ndim == 3 and pixels.shape[2] == 3:
        colour = 2
    else:
        raise ValueError("PNG pixels must be (H, W) grey or (H, W, 3) RGB, "
                         f"got shape {pixels.shape}")
    height, width = pixels.shape[:2]
    if height == 0 or width == 0:
        raise ValueError("PNG image must not be empty")
    rows = pixels.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, pixels) -> None:
    """Write an (H, W) grey or (H, W, 3) RGB uint8 array as a PNG file."""
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)
