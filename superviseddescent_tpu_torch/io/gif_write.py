"""GIF writing as PIL 12.1's ``save`` writes one frame (the Python twin).

An RGB image becomes a palette image through PIL's median-cut quantiser
(``io/gif_quant.quantize``); a grey image is written as PIL's mode ``L``.
Then, as ``GifImagePlugin._save`` does with its defaults (``optimize``
true, no palette, no transparency, duration, loop or comment):

* ``_get_optimize``: a grey image keeps only the grey levels it uses, in
  order, as its palette; a palette image under 512 x 512 pixels drops the
  entries no pixel uses where there are holes, or where the used ones fit
  in half the table (``remap_palette``), else keeps the palette whole;
* the header is ``GIF87a``, the logical screen the image, a global colour
  table of ``_get_color_table_size`` (padded with black to 2^(n + 1)
  entries), background 0, no aspect; then the image descriptor at (0, 0),
  interlaced (flag 0x40) unless a side is under 16 pixels (``get_interlace``);
* the pixels go to libImaging's LZW coder (``GifEncode.c``) with a minimum
  code size of 8 whatever the palette: a Clear code first, codes from 9
  bits up, the width grown when the next code would not fit, a Clear where
  the table would pass 4,095 codes, the End code; LSB first, in sub-blocks
  of 255 bytes; interlaced rows in the passes 8 / 8 / 4 / 2; then the
  terminator and the trailer ``;``.

``csrc/gif_encode.cu`` holds the quantiser and the coder in C++ for the
card's path (``encode_gif(..., native=True)``); the palette optimisation
and the header stay this module's.
"""

from __future__ import annotations

import ctypes
import math
import struct

import numpy as np

from superviseddescent_tpu_torch.io.gif_quant import quantize

MIN_CODE_SIZE = 8
MAX_CODES = 4096
OPTIMIZE_LIMIT = 512 * 512
INTERLACE_MIN = 16


def interlace_order(h: int) -> np.ndarray:
    """The rows of an interlaced frame in the order they are written."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def palette_image(pixels: np.ndarray):
    """PIL's ``_normalize_mode`` and ``_normalize_palette``: (palette
    uint8 (n, 3), indices uint8 (H, W)) as the file will hold them."""
    if pixels.ndim == 2:                      # mode L: the used grey levels
        used = np.flatnonzero(np.bincount(pixels.ravel(), minlength=256))
        remap = np.zeros(256, np.uint8)
        remap[used] = np.arange(len(used))
        return np.repeat(used[:, None], 3, 1).astype(np.uint8), remap[pixels]
    palette, index = quantize(pixels)
    return optimize(palette, index)


def optimize(palette: np.ndarray, index: np.ndarray):
    """``_get_optimize`` and ``remap_palette`` for a palette image."""
    h, w = index.shape
    if h * w >= OPTIMIZE_LIMIT:
        return palette, index
    used = np.flatnonzero(np.bincount(index.ravel(), minlength=256))
    size = 1 << (len(palette) - 1).bit_length()
    if used[-1] >= len(used) or (len(used) <= size // 2 and size > 2):
        remap = np.zeros(256, np.uint8)
        remap[used] = np.arange(len(used))
        return palette[used], remap[index]
    return palette, index


def color_table_size(n: int) -> int:
    """``_get_color_table_size`` for ``n`` palette entries."""
    if n == 0:
        return 0
    if n < 3:
        return 1
    return math.ceil(math.log(n, 2)) - 1


def header(width: int, height: int, palette: np.ndarray,
           interlace: bool) -> bytes:
    """Everything before the LZW data: signature, logical screen, global
    colour table, image descriptor, minimum code size."""
    bits = color_table_size(len(palette))
    table = palette.astype(np.uint8).tobytes()
    table += b"\0" * (3 * (2 << bits) - len(table))
    return (b"GIF87a" + struct.pack("<HHBBB", width, height, bits + 128, 0, 0)
            + table + b"," + struct.pack("<HHHHB", 0, 0, width, height,
                                         0x40 if interlace else 0)
            + bytes([MIN_CODE_SIZE]))


def interlaced(height: int, width: int) -> bool:
    return min(height, width) >= INTERLACE_MIN


def lzw_codes(data: bytes):
    """libImaging's GIF LZW coder over ``data`` (indices, 8-bit): the
    (code, width) pairs in order."""
    clear = 1 << MIN_CODE_SIZE
    first = clear + 2
    out = [(clear, MIN_CODE_SIZE + 1)]
    width, limit, nxt = MIN_CODE_SIZE + 1, 1 << (MIN_CODE_SIZE + 1), first
    table = {}
    if not data:
        out.append((clear + 1, width))
        return out
    head = data[0]
    for tail in data[1:]:
        key = (head << 8) | tail
        code = table.get(key)
        if code is not None:
            head = code
            continue
        out.append((head, width))
        if nxt < MAX_CODES:
            table[key] = nxt
            if nxt >= limit:
                width += 1
                limit <<= 1
            nxt += 1
        else:
            out.append((clear, width))
            table = {}
            width, limit, nxt = MIN_CODE_SIZE + 1, 1 << (MIN_CODE_SIZE + 1), \
                first
        head = tail
    out.append((head, width))
    out.append((clear + 1, width))
    return out


def pack_codes(codes) -> bytes:
    """The codes LSB first, in sub-blocks of 255 bytes, with the block
    terminator."""
    acc = nbits = 0
    raw = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            raw.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        raw.append(acc & 0xFF)
    out = bytearray()
    for i in range(0, len(raw), 255):
        block = raw[i:i + 255]
        out += bytes([len(block)]) + block
    return bytes(out + b"\0")


def _quantize_native(library, rgb: np.ndarray):
    h, w = rgb.shape[:2]
    palette = np.zeros((256, 3), np.uint8)
    index = np.empty((h, w), np.uint8)
    n = library.gif_quantize(ctypes.c_void_p(rgb.ctypes.data), h * w,
                             ctypes.c_void_p(palette.ctypes.data),
                             ctypes.c_void_p(index.ctypes.data))
    if not 0 < n <= 256:
        raise RuntimeError(f"GIF quantiser: {n} palette entries")
    return palette[:n], index


def _lzw_native(library, index: np.ndarray, lace: bool) -> bytes:
    h, w = index.shape
    cap = 2 * h * w + 1024
    out = np.empty(cap, np.uint8)
    n = library.gif_lzw_encode(ctypes.c_void_p(index.ctypes.data), h, w,
                               int(lace), ctypes.c_void_p(out.ctypes.data),
                               cap)
    if n < 0:
        raise RuntimeError("GIF LZW coder: the output buffer is too small")
    return out[:n].tobytes()


def encode_gif(pixels: np.ndarray, native: bool = False,
               library=None) -> bytes:
    """uint8 grey (H, W) or RGB (H, W, 3) -> the GIF file PIL writes.
    ``native``: the quantiser and the coder of ``csrc/gif_encode.cu``
    (``library``, a loaded build, else ``ops/_build``'s) in place of this
    module's Python."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    if native and library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("gif_encode")
    if pixels.ndim == 3 and native:
        palette, index = optimize(*_quantize_native(library, pixels))
    else:
        palette, index = palette_image(pixels)
    lace = interlaced(h, w)
    if native:
        data = _lzw_native(library, np.ascontiguousarray(index), lace)
    else:
        rows = index[interlace_order(h)] if lace else index
        data = pack_codes(lzw_codes(rows.tobytes()))
    return header(w, h, palette, lace) + data + b";"
