"""PNG decoder and writer on the standard library's zlib (no PIL, no
OpenCV).

The decoder reads every PNG the standard allows: colour types 0 (grey, bit
depths 1, 2, 4, 8, 16), 2 (RGB, 8 or 16), 3 (palette, 1, 2, 4, 8), 4 (grey
+ alpha, 8 or 16) and 6 (RGBA, 8 or 16), non-interlaced or Adam7. It
returns the 8-bit pixels that PIL's reader gives (and its
``convert('RGB')`` where PIL's mode is not 8-bit): grey of 1, 2 or 4 bits
scaled to 0-255, a palette expanded to RGB (entries past the PLTE chunk
black, ``tRNS`` dropped), 16-bit grey clipped to 255 (PIL's ``I;16`` to
RGB), other 16-bit samples their high byte. The writer writes 8-bit grey
(H, W) and RGB (H, W, 3) images byte for byte as PIL writes them (its
filter choice per row, its deflate settings and its IDAT chunks).

Rows are un-filtered as a wavefront: pixel (r, x) depends only on
(r, x-1), (r-1, x) and (r-1, x-1), so all pixels on one anti-diagonal
r + x = s are independent and each step is one vectorised numpy update
over every row at once (H + W steps instead of H * W scalar steps).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: first row, first column, row step, column step
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG stream ends without an IEND chunk")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) un-filtered bytes of rows ``stride`` bytes long
    whose filters step ``bpp`` bytes back."""
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    kinds = data[:, 0].astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {kinds.max()}")
    filt = data[:, 1:].astype(np.int32)
    width = stride // bpp
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


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """Un-filtered rows -> (h, width, channels) samples (uint16 at 16
    bits, else uint8 at their own depth)."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        pairs = rows.reshape(h, width * channels, 2).astype(np.uint16)
        return ((pairs[..., 0] << 8) | pairs[..., 1]).reshape(
            h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[
        :, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 array, C = 1, 2, 3 or 4 (3 for a
    palette image), as PIL reads it (see the module's docstring)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if (colour not in _DEPTHS or depth not in _DEPTHS[colour]
            or compression != 0 or filtering != 0 or interlace > 1):
        raise ValueError(
            f"invalid PNG: bit depth {depth}, colour type {colour}, "
            f"compression {compression}, filter method {filtering}, "
            f"interlace {interlace}")
    if colour == 3 and palette is None:
        raise ValueError("PNG palette image has no PLTE chunk")
    channels = _CHANNELS[colour]
    bpp = max(1, channels * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    samples = np.zeros((height, width, channels),
                       np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for sy, sx, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        ph, pw = -(-(height - sy) // dy), -(-(width - sx) // dx)
        if ph <= 0 or pw <= 0:
            continue                      # an empty pass has no rows
        stride = -(-pw * channels * depth // 8)
        rows = _unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride, bpp)
        pos += ph * (stride + 1)
        samples[sy::dy, sx::dx] = _unpack(rows, pw, channels, depth)
    if pos != len(raw):
        raise ValueError("PNG image data has the wrong length")
    if colour == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette) // 3] = palette.reshape(-1, 3)
        return table[samples[..., 0]]
    if depth == 16:
        if colour == 0:
            return np.minimum(samples, 255).astype(np.uint8)
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, stride) uint8 rows -> (H, stride + 1) filtered rows as Pillow's
    ``ZipEncode.c`` filters 8-bit grey and RGB: each row takes the filter
    of the least sum of its bytes' distances from zero (a byte v counts
    ``min(v, 256 - v)``), trying none, Up, Sub and Paeth in that order and
    keeping a later one only where it is strictly less (Pillow tries
    Average only with ``optimize``). Every filter reads the unfiltered
    neighbours, the row above the first being zeros, so all are formed at
    once over every row."""
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    upleft = np.zeros_like(rows)
    upleft[:, bpp:] = up[:, :-bpp]
    # Paeth's distances |b - c|, |a - c|, |a + b - 2c| from two differences
    db = np.subtract(up, upleft, dtype=np.int16)
    da = np.subtract(left, upleft, dtype=np.int16)
    pc = np.abs(db + da)
    pa, pb = np.abs(db, out=db), np.abs(da, out=da)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    kinds = np.array([0, 2, 1, 4], np.uint8)   # Pillow's order of trial
    tried = np.empty((4,) + rows.shape, np.uint8)
    tried[0] = rows
    np.subtract(rows, up, out=tried[1])
    np.subtract(rows, left, out=tried[2])
    np.subtract(rows, paeth, out=tried[3])
    # |v| of the signed byte, -128 giving 128
    cost = np.abs(tried.view(np.int8)).view(np.uint8).sum(axis=2,
                                                          dtype=np.int64)
    best = np.argmin(cost, axis=0)           # the first of equal sums
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = kinds[best]
    out[:, 1:] = tried[best, np.arange(rows.shape[0])]
    return out


def encode_png(pixels) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 array -> the PNG bytes PIL's
    ``save`` writes: its rows filtered as ``filter_rows`` does, deflated as
    Pillow's ``ZipEncode.c`` deflates them (level 6, a 15-bit window,
    memory level 9, ``Z_FILTERED``), the stream cut into IDAT chunks of
    ``max(65536, 4 * W)`` bytes, the buffer ``ImageFile._save`` hands the
    encoder."""
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
    raw = filter_rows(pixels.reshape(height, -1), 1 if colour == 0 else 3)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = z.compress(raw.tobytes()) + z.flush()
    step = max(65536, 4 * width)
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + b"".join(_chunk(b"IDAT", stream[at:at + step])
                       for at in range(0, len(stream), step))
            + _chunk(b"IEND", b""))


def write_png(path, pixels) -> None:
    """Write an (H, W) grey or (H, W, 3) RGB uint8 array as a PNG file."""
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)
