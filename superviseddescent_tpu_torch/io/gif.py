"""GIF: a reader of the first frame, as PIL reads it (no PIL).

Reads GIF87a and GIF89a: the logical screen, extension blocks skipped,
the first image descriptor with its local colour table, LZW codes of
``min_code_size + 1`` to 12 bits (LSB first, the table full at 4,096
codes until a Clear), interlaced rows in the four passes. As PIL reads
the first frame: a colour table whose every entry i is (i, i, i) is no
palette at all, and with no palette left (none, or only such tables) the
frame is PIL's mode ``L``, its indices the grey levels; otherwise RGB
through the local table, else the global one (an index past the table
black). One quirk of PIL's is kept: where a grey-ramp local table stands
over a global palette, the frame is mode ``L`` (its indices are the grey
that ``load_gray_image`` reads) but keeps the global palette, which
``convert("RGB")`` applies. The canvas is the logical screen, grown to hold the frame where
the frame reaches past it; pixels outside the frame are index 0, or the
frame's transparent index where its graphic control extension names
one. Transparency is otherwise ignored, as ``convert("RGB")`` ignores it.
An image whose LZW data ends before its last pixel raises. GIF is
written by ``io/gif_write``.
"""

from __future__ import annotations

import struct

import numpy as np

MAX_CODES = 4096


def _sub_blocks(data: bytes, pos: int):
    """The data sub-blocks from ``pos`` joined, and the position after
    their terminator."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError("GIF: truncated data sub-blocks")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(data[pos:pos + n])
        pos += n


def _palette_needed(table: bytes) -> bool:
    """PIL's ``_is_palette_needed``: not the grey ramp i -> (i, i, i)."""
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return not (t == np.arange(len(t))[:, None]).all()


def lzw_decode(data: bytes, min_size: int, count: int) -> bytes:
    """GIF LZW: ``count`` indices from codes of ``min_size + 1`` bits
    upward, LSB first."""
    if not 1 <= min_size <= 11:
        raise ValueError(f"GIF: LZW minimum code size {min_size}")
    clear = 1 << min_size
    end = clear + 1
    base = [bytes([i & 0xFF]) for i in range(clear)] + [b"", b""]
    table = list(base)
    width = min_size + 1
    out, produced = [], 0
    buf = nbits = pos = 0
    prev = None
    n = len(data)
    while produced < count:
        while nbits < width:
            if pos >= n:
                raise ValueError("GIF: the LZW data ends before the image "
                                 "does")
            buf |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = buf & ((1 << width) - 1)
        buf >>= width
        nbits -= width
        if code == clear:
            table = list(base)
            width, prev = min_size + 1, None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < MAX_CODES:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table) < MAX_CODES:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("GIF: invalid LZW code")
        out.append(entry)
        produced += len(entry)
        prev = entry
        if len(table) == 1 << width and width < 12:
            width += 1
    if produced < count:
        raise ValueError("GIF: the LZW data ends before the image does")
    return b"".join(out)[:count]


def _deinterlace(rows: np.ndarray) -> np.ndarray:
    h = rows.shape[0]
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)])
    out = np.empty_like(rows)
    out[order] = rows
    return out


def decode_gif(data: bytes, channels: int = 3) -> np.ndarray:
    """GIF bytes -> the first frame as uint8 (H, W) grey (PIL's mode L) or
    (H, W, 3) RGB; ``channels`` 1 asks for PIL's mode-L pixels where the
    frame is mode L, 3 for ``convert("RGB")``'s."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    global_table = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        global_table = data[pos:pos + size]
        pos += size
        if len(global_table) < size:
            raise ValueError("GIF: truncated colour table")
        if not _palette_needed(global_table):
            global_table = None
    transparent = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF: no image in the file")
        kind = data[pos]
        pos += 1
        if kind == 0x21:                          # extension
            if pos >= len(data):
                raise ValueError("GIF: truncated extension")
            label = data[pos]
            block, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(block) >= 4 and block[0] & 1:
                transparent = block[3]
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF: unexpected block 0x{kind:02X}")
        if pos + 9 > len(data):
            raise ValueError("GIF: truncated image descriptor")
        x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
        pos += 9
        table, kept = global_table, None
        if fflags & 0x80:
            size = 3 << ((fflags & 7) + 1)
            local = data[pos:pos + size]
            pos += size
            table = local if _palette_needed(local) else None
            if table is None:
                kept = global_table
        if pos >= len(data):
            raise ValueError("GIF: truncated image data")
        min_size = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        break
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    canvas = np.full((height, width), transparent or 0, np.uint8)
    if fw and fh:
        idx = np.frombuffer(lzw_decode(lzw, min_size, fw * fh),
                            np.uint8).reshape(fh, fw)
        if fflags & 0x40:
            idx = _deinterlace(idx)
        canvas[y0:y0 + fh, x0:x0 + fw] = idx
    if table is None:
        if kept is None or channels == 1:
            return canvas
        table = kept
    palette = np.zeros((256, 3), np.uint8)
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    palette[:len(t)] = t[:256]
    return palette[canvas]
