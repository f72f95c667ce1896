"""Writes the committed BMP / PNM / TIFF / GIF fixtures,
``tests/torch_imageio/``, with PIL and small writers of its own.

    python tests/torch_imageio_fixtures.py

The card has no PIL, so ``chip_smoke.py --imageio`` reads these files and
holds the port's readers to PIL's digests in ``manifest.json``: per file
the sha256 of the JAX package's ``load_gray_image`` as uint8 (PIL, then
OpenCV's grey) and of PIL's ``convert("RGB")``, and PIL's mode. The
manifest's ``jpeg_writes`` are the sha256 digests of the files PIL's
``save(format="JPEG")`` writes for pixels the card can make without PIL:
the RGB (or grey) that ``tests/torch_jpeg`` stills and clip frames decode
to, at 4:4:4, 4:2:2 and 4:2:0 (grey: one component) and qualities 50, 75
and 95; the card encodes the same pixels with kernel J2. Its
``png_tiff_writes`` are PIL's PNG and TIFF files of the same decoded
pixels (RGB and grey) and of two full-size stills drawn as ``rcr_detect
-o`` draws (``drawn_still``): each file's sha256 and, for a PNG, the
sha256 of its filtered rows, which holds whatever zlib deflates them;
``zlib`` names the zlib that wrote the files.

* small files (61 x 47, a crop of a tinted ``.synth120`` face), one per
  reader variant: BMP 24-bit, grey (mode L), bilevel (mode 1), 8-bit, 4-bit
  and 1-bit palettes, RLE8 and RLE4 (encoded and absolute runs, end of line,
  a delta, end of bitmap), 16-bit 5-5-5 and 5-6-5 bitfields, 32-bit BGRX,
  32-bit bitfields with alpha in a V5 header, top-down in a V4 header, the
  OS/2 core header with 3-byte palette entries, a palette shorter than its
  indices; DIB; PNM P1-P6 raw and plain, comments, maxval 100, 1,000 and
  65,535; TIFF uncompressed, PackBits, LZW and Deflate, predictor 2, grey,
  RGB, RGBA, bilevel, white-is-zero, 8-bit and 1-bit palettes, tiles,
  planar configuration 2, big-endian strips; GIF grey, global palette,
  interlaced, local palette, an offset frame with a transparent index, no
  palette, a grey local table over a global palette, animated;
* full size, for the card's reader times: a grey BMP, a PGM, an RGB TIFF
  (LZW, predictor 2) and a GIF of one ``.synth120`` image (412 x 600).

The reference is PIL's decode of the bytes written; the same seed gives
the same bytes for the same PIL and libtiff. ``tests/test_torch_imageio.py``
checks that the files still match the manifest.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_jpeg_fixtures import OUT as JPEG_DIR  # noqa: E402
from torch_jpeg_fixtures import synth, tint  # noqa: E402

OUT = os.path.join(HERE, "torch_imageio")
CROP = (150, 120, 47, 61)          # row, column, height, width
FULL_IMAGE = 2                     # a 412 x 600 .synth120 image
SEED = 0
QUALITIES = (50, 75, 95)
SUBSAMPLINGS = ("4:4:4", "4:2:2", "4:2:0")
# the pixels the card encodes: RGB of these stills and clip frames (and
# their grey for the one-component writes)
JPEG_SOURCES = ("s01_444_q95.jpg", "s03_420_q75.jpg", "s06_422_q75_odd.jpg",
                "clip/f000.jpg", "clip/f009.jpg")
# the full-size stills drawn with DRAWN_POINTS' landmarks for the PNG and
# TIFF write digests (what rcr_detect -o writes)
DRAWN_STILLS = ("f00_grey.bmp", "f02_rgb_lzw_predictor.tif")
DRAWN_POINTS = "synth_0002"


def small_rgb() -> np.ndarray:
    y, x, h, w = CROP
    return tint(synth(0)[y:y + h, x:x + w], SEED)


def full_grey() -> np.ndarray:
    return synth(FULL_IMAGE)


def pil_bytes(image: Image.Image, fmt: str, **options) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **options)
    return buf.getvalue()


def pil_digests(path) -> dict:
    """PIL's pixels of a file: the JAX package's grey, convert('RGB') and
    PIL's mode."""
    from superviseddescent_tpu.ops.patches import load_gray_image
    grey = load_gray_image(path).astype(np.uint8)
    with Image.open(path) as im:
        mode = im.mode
        rgb = np.asarray(im.convert("RGB"), np.uint8)
    return dict(shape=list(grey.shape), mode=mode,
                grey_sha256=hashlib.sha256(grey.tobytes()).hexdigest(),
                rgb_sha256=hashlib.sha256(rgb.tobytes()).hexdigest())


def quantized(rgb: np.ndarray, colours: int):
    """(indices, (n, 3) palette) of PIL's quantisation of ``rgb``."""
    q = Image.fromarray(rgb).quantize(colours)
    pal = np.asarray(q.getpalette()[:3 * colours], np.uint8).reshape(-1, 3)
    return np.asarray(q), pal


# ------------------------------------------------------------------ BMP
def bmp(width, height, bits, rows: bytes, header=40, compression=0,
        palette=None, masks=None, top_down=False, entry=4) -> bytes:
    """A BMP of ``rows`` (already in file order and padded) with the given
    header size (12, 40, 108 or 124), masks and palette ((n, 3) RGB)."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + b"\x00" * (entry - 3)
                       for r, g, b in palette)
    colours = 0 if palette is None else len(palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width,
                           -height if top_down else height, 1, bits,
                           compression, len(rows), 2835, 2835, colours, 0)
        extra = b""
        if masks is not None:
            extra = struct.pack("<" + "I" * len(masks), *masks)
        if header == 40:
            info += extra
        else:
            body = extra.ljust(16, b"\x00") + b"sRGB".ljust(
                header - 40 - 16, b"\x00")
            info += body
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<III", offset + len(rows), 0, offset) + info
            + pal + rows)


def packed_rows(indices: np.ndarray, bits: int, bottom_up=True) -> bytes:
    h, w = indices.shape
    rows = indices[::-1] if bottom_up else indices
    if bits == 8:
        data = rows.astype(np.uint8)
    else:
        per = 8 // bits
        pad = (-w) % per
        r = np.pad(rows, ((0, 0), (0, pad))).reshape(h, -1, per)
        shifts = bits * np.arange(per - 1, -1, -1)
        data = (r.astype(np.int64) << shifts).sum(axis=2).astype(np.uint8)
    stride = (data.shape[1] + 3) & ~3
    return np.pad(data, ((0, 0), (0, stride - data.shape[1]))).tobytes()


def rle8(indices: np.ndarray) -> bytes:
    """RLE8, bottom-up: runs of equal bytes encoded, other stretches in
    absolute mode, an end of line per row, a delta in the middle row, end
    of bitmap."""
    h, w = indices.shape
    out = bytearray()
    for r, row in enumerate(indices[::-1]):
        if r == h // 2:
            # PIL skips two bytes after the delta escape and takes the next
            # two as the offsets: (0, 0) here, the row continuing as it is
            out += bytes([0, 2, 9, 9, 0, 0])
        x = 0
        while x < w:
            run = 1
            while x + run < w and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 3 or w - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            n = min(w - x, 20)
            out += bytes([0, n]) + bytes(row[x:x + n])
            if n % 2:
                out += b"\x00"
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def rle4(indices: np.ndarray) -> bytes:
    """RLE4: pairs of alternating nibbles encoded, absolute runs of an
    even number of pixels, an end of line per row, end of bitmap."""
    h, w = indices.shape
    out = bytearray()
    for row in indices[::-1]:
        x = 0
        while x < w:
            if x % 3 == 0 or w - x < 4:
                n = min(w - x, 7)
                a, b = row[x], row[x + 1] if x + 1 < w else 0
                out += bytes([n, a << 4 | b])
                x += n
                continue
            n = min(w - x, 8) // 2 * 2
            pairs = row[x:x + n].reshape(-1, 2)
            body = bytes(a << 4 | b for a, b in pairs)
            out += bytes([0, n]) + body
            if len(body) % 2:
                out += b"\x00"
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_fixtures() -> dict:
    rgb = small_rgb()
    h, w = rgb.shape[:2]
    grey = rgb[..., 1]
    idx16, pal16 = quantized(rgb, 16)
    idx256, pal256 = quantized(rgb, 200)
    bgr = rgb[..., ::-1]
    v = rgb.astype(np.uint32)
    out = {
        "b00_rgb24.bmp": pil_bytes(Image.fromarray(rgb), "BMP"),
        "b01_grey8.bmp": pil_bytes(Image.fromarray(grey), "BMP"),
        "b02_bilevel1.bmp": pil_bytes(Image.fromarray(grey > 120), "BMP"),
        "b03_pal8.bmp": pil_bytes(Image.fromarray(rgb).quantize(200), "BMP"),
        "b04_pal4.bmp": bmp(w, h, 4, packed_rows(idx16, 4), palette=pal16),
        "b05_pal1.bmp": bmp(w, h, 1, packed_rows((grey > 120).astype(
            np.uint8), 1), palette=[(20, 40, 200), (250, 220, 10)]),
        "b06_rle8.bmp": bmp(w, h, 8, rle8(idx256), compression=1,
                            palette=pal256),
        "b07_rle4.bmp": bmp(w, h, 4, rle4(idx16), compression=2,
                            palette=pal16),
        "b08_rgb555.bmp": bmp(w, h, 16, _rows16(
            (v[..., 0] >> 3 << 10) | (v[..., 1] >> 3 << 5) | v[..., 2] >> 3)),
        "b09_rgb565_bitfields.bmp": bmp(w, h, 16, _rows16(
            (v[..., 0] >> 3 << 11) | (v[..., 1] >> 2 << 5) | v[..., 2] >> 3),
            compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "b10_bgrx32.bmp": bmp(w, h, 32, np.concatenate(
            [bgr, np.full((h, w, 1), 77, np.uint8)], axis=2)[::-1].tobytes()),
        "b11_bgra32_v5.bmp": bmp(w, h, 32, np.concatenate(
            [bgr, (grey[..., None] // 2)], axis=2)[::-1].tobytes(),
            header=124, compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "b12_topdown_v4.bmp": bmp(w, h, 24, packed24(bgr, bottom_up=False),
                                  header=108, top_down=True),
        "b13_os2_core.bmp": bmp(w, h, 8, packed_rows(idx256, 8), header=12,
                                palette=pal256, entry=3),
        "b14_pal8_short.bmp": bmp(w, h, 8, packed_rows(
            (grey // 8).astype(np.uint8), 8), palette=pal256[:20]),
        "d00_rgb24.dib": pil_bytes(Image.fromarray(rgb), "DIB"),
    }
    return out


def packed24(bgr: np.ndarray, bottom_up=True) -> bytes:
    rows = bgr[::-1] if bottom_up else bgr
    h, w = rows.shape[:2]
    data = rows.reshape(h, 3 * w)
    stride = (3 * w + 3) & ~3
    return np.pad(data, ((0, 0), (0, stride - 3 * w))).tobytes()


def _rows16(v: np.ndarray) -> bytes:
    h, w = v.shape
    data = v[::-1].astype("<u2").view(np.uint8).reshape(h, 2 * w)
    stride = (2 * w + 3) & ~3
    return np.pad(data, ((0, 0), (0, stride - 2 * w))).tobytes()


# ------------------------------------------------------------------ PNM
def plain(magic: bytes, values: np.ndarray, maxval=None, width=None,
          comment=b"") -> bytes:
    h, w = values.shape[:2]
    head = magic + b"\n" + comment + b"%d %d\n" % (w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    flat = values.reshape(h, -1)
    sep = b"" if magic == b"P1" else b" "
    rows = [sep.join(b"%d" % int(v) for v in row) for row in flat]
    return head + b"\n".join(rows) + b"\n"


def pnm_fixtures() -> dict:
    rgb = small_rgb()
    grey = rgb[..., 1]
    h, w = grey.shape
    return {
        "n00_p1_plain.pbm": plain(b"P1", (grey <= 120).astype(np.uint8),
                                  comment=b"# bilevel\n"),
        "n01_p2_plain.pgm": plain(b"P2", grey, 255, comment=b"# grey\n"),
        "n02_p3_plain_max100.ppm": plain(
            b"P3", rgb.astype(np.int64) * 100 // 255, 100),
        "n03_p4.pbm": pil_bytes(Image.fromarray(grey > 120), "PPM"),
        "n04_p5.pgm": pil_bytes(Image.fromarray(grey), "PPM"),
        "n05_p6.ppm": pil_bytes(Image.fromarray(rgb), "PPM"),
        "n06_p5_max100.pgm": b"P5 #c\n%d %d\n100\n" % (w, h) + np.minimum(
            grey // 2, 255).astype(np.uint8).tobytes(),
        "n07_p5_max1000.pgm": b"P5\n%d %d\n1000\n" % (w, h) + (
            grey.astype(np.int64) * 4).astype(">u2").tobytes(),
        "n08_p6_max65535.ppm": b"P6\n%d %d\n65535\n" % (w, h) + (
            rgb.astype(np.int64) * 257 + 3).astype(">u2").tobytes(),
        "n09_p2_plain_max1000.pgm": plain(b"P2", grey.astype(np.int64) * 3,
                                          1000),
        "n10_p5_max65535.pgm": b"P5\n%d %d\n65535\n" % (w, h) + (
            grey.astype(np.int64) * 2).astype(">u2").tobytes(),
    }


# ----------------------------------------------------------------- TIFF
def tiff(chunks, tags: dict, big_endian=False) -> bytes:
    """A TIFF of one IFD: ``chunks`` (strips or tiles, in order) and
    ``tags`` {tag: (type, values)}; the offsets and byte counts of the
    chunks go under the offsets tag named in ``tags`` with values None."""
    e = ">" if big_endian else "<"
    fmt = {3: "H", 4: "I"}
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(8 + len(body))
        body += c
        if len(body) % 2:
            body += b"\x00"
    entries = dict(tags)
    for off_tag, cnt_tag in ((273, 279), (324, 325)):
        if off_tag in entries:
            entries[off_tag] = (4, offsets)
            entries[cnt_tag] = (4, [len(c) for c in chunks])
    ifd_at = 8 + len(body)
    n = len(entries)
    extra_at = ifd_at + 2 + 12 * n + 4
    ifd, extra = struct.pack(e + "H", n), bytearray()
    for tag in sorted(entries):
        kind, values = entries[tag]
        packed = struct.pack(e + fmt[kind] * len(values), *values)
        if len(packed) <= 4:
            ifd += struct.pack(e + "HHI", tag, kind, len(values))
            ifd += packed.ljust(4, b"\x00")
        else:
            ifd += struct.pack(e + "HHII", tag, kind, len(values),
                               extra_at + len(extra))
            extra += packed
    ifd += struct.pack(e + "I", 0)
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(
        e + "I", ifd_at)
    return head + bytes(body) + bytes(ifd) + bytes(extra)


def packbits(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 128:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
        else:
            j = i + 1
            while j < len(data) and j - i < 128 and (
                    j + 1 >= len(data) or data[j + 1] != data[j]):
                j += 1
            out += bytes([j - i - 1]) + data[i:j]
            i = j
    return bytes(out)


def predicted(rows: np.ndarray, samples: int) -> np.ndarray:
    """Horizontal differencing of (h, w * samples) uint8 rows."""
    px = rows.reshape(rows.shape[0], -1, samples).astype(np.int16)
    d = np.diff(px, axis=1, prepend=0) & 0xFF
    return d.astype(np.uint8).reshape(rows.shape)


def tiff_fixtures() -> dict:
    rgb = small_rgb()
    grey = rgb[..., 1]
    h, w = grey.shape
    base = {256: (3, [w]), 257: (3, [h])}
    idx, pal = quantized(rgb, 180)
    cmap = np.zeros((3, 256), np.int64)
    cmap[:, :len(pal)] = pal.T.astype(np.int64) * 257
    # tiles of 16 x 16, RGB, Deflate with predictor 2
    tiles = []
    for ty in range(0, h, 16):
        for tx in range(0, w, 16):
            t = np.zeros((16, 16, 3), np.uint8)
            part = rgb[ty:ty + 16, tx:tx + 16]
            t[:part.shape[0], :part.shape[1]] = part
            tiles.append(zlib.compress(predicted(t.reshape(16, 48), 3)
                                       .tobytes()))
    planes = [packbits(rgb[y0:y0 + 9, :, c].tobytes())
              for c in range(3) for y0 in range(0, h, 9)]
    bits1 = np.packbits((grey > 120), axis=1)
    return {
        "t00_rgb_raw.tif": pil_bytes(Image.fromarray(rgb), "TIFF"),
        "t01_grey_raw.tif": pil_bytes(Image.fromarray(grey), "TIFF"),
        "t02_rgb_packbits.tif": pil_bytes(Image.fromarray(rgb), "TIFF",
                                          compression="packbits"),
        "t03_grey_lzw.tif": pil_bytes(Image.fromarray(grey), "TIFF",
                                      compression="tiff_lzw"),
        "t04_rgb_lzw_predictor.tif": pil_bytes(
            Image.fromarray(rgb), "TIFF", compression="tiff_lzw",
            tiffinfo={317: 2}),
        "t05_rgb_deflate_predictor.tif": pil_bytes(
            Image.fromarray(rgb), "TIFF", compression="tiff_adobe_deflate",
            tiffinfo={317: 2}),
        "t06_grey_deflate.tif": pil_bytes(Image.fromarray(grey), "TIFF",
                                          compression="tiff_adobe_deflate"),
        "t07_bilevel.tif": pil_bytes(Image.fromarray(grey > 120), "TIFF"),
        "t08_pal8.tif": pil_bytes(Image.fromarray(rgb).quantize(180),
                                  "TIFF"),
        "t09_pal1.tif": tiff([bits1.tobytes()], {
            **base, 258: (3, [1]), 259: (3, [1]), 262: (3, [3]),
            273: None, 277: (3, [1]), 278: (3, [h]),
            320: (3, [40000, 1000, 0, 65535, 100, 30000])}),
        "t10_white_is_zero.tif": tiff([grey.tobytes()], {
            **base, 258: (3, [8]), 259: (3, [1]), 262: (3, [0]), 273: None,
            277: (3, [1]), 278: (3, [h])}),
        "t11_white_is_zero_bilevel.tif": tiff([bits1.tobytes()], {
            **base, 258: (3, [1]), 259: (3, [1]), 262: (3, [0]), 273: None,
            277: (3, [1]), 278: (3, [h])}),
        "t12_tiled_rgb_deflate.tif": tiff(tiles, {
            **base, 258: (3, [8, 8, 8]), 259: (3, [8]), 262: (3, [2]),
            277: (3, [3]), 317: (3, [2]), 322: (3, [16]), 323: (3, [16]),
            324: None}),
        "t13_planar_rgb_packbits.tif": tiff(planes, {
            **base, 258: (3, [8, 8, 8]), 259: (3, [32773]), 262: (3, [2]),
            273: None, 277: (3, [3]), 278: (3, [9]), 284: (3, [2])}),
        "t14_big_endian_strips.tif": tiff(
            [rgb[y0:y0 + 5].tobytes() for y0 in range(0, h, 5)], {
                **base, 258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [2]),
                273: None, 277: (3, [3]), 278: (3, [5])}, big_endian=True),
        "t15_rgba.tif": pil_bytes(Image.fromarray(np.concatenate(
            [rgb, grey[..., None]], axis=2), "RGBA"), "TIFF",
            compression="tiff_lzw"),
        "t16_pal8_lzw.tif": pil_bytes(_palette_image(idx, pal), "TIFF",
                                      compression="tiff_lzw"),
        "t17_cmap_check.tif": tiff([idx.astype(np.uint8).tobytes()], {
            **base, 258: (3, [8]), 259: (3, [1]), 262: (3, [3]),
            273: None, 277: (3, [1]), 278: (3, [h]),
            320: (3, list(cmap.ravel()))}),
    }


def _palette_image(idx, pal):
    im = Image.fromarray(idx.astype(np.uint8), "P")
    im.putpalette(pal.ravel().tolist())
    return im


# ------------------------------------------------------------------ GIF
def lzw_gif(indices: np.ndarray, min_size: int) -> bytes:
    """GIF LZW of the indices, a Clear first and whenever the table fills,
    packed into sub-blocks."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    width = min_size + 1

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1
    table, nxt = reset()
    out_codes = [(clear, width)]
    prefix = b""
    for v in indices.ravel().tolist():
        s = prefix + bytes([v])
        if s in table:
            prefix = s
            continue
        out_codes.append((table[prefix], width))
        table[s] = nxt
        nxt += 1
        if nxt > (1 << width) and width < 12:
            width += 1
        if nxt >= 4095:
            out_codes.append((clear, width))
            table, nxt = reset()
            width = min_size + 1
        prefix = bytes([v])
    out_codes.append((table[prefix], width))
    out_codes.append((end, width))
    buf = nbits = 0
    data = bytearray()
    for code, size in out_codes:
        buf |= code << nbits
        nbits += size
        while nbits >= 8:
            data.append(buf & 0xFF)
            buf >>= 8
            nbits -= 8
    if nbits:
        data.append(buf & 0xFF)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([min_size]) + blocks + b"\x00"


def gif(width, height, frame, offset=(0, 0), global_table=None,
        local_table=None, transparent=None) -> bytes:
    """A GIF89a of one frame of indices at ``offset`` (x, y)."""
    def table_bits(t):
        return max(1, int(np.ceil(np.log2(max(len(t), 2))))) - 1
    head = b"GIF89a" + struct.pack("<HH", width, height)
    flags = 0
    gt = b""
    if global_table is not None:
        k = table_bits(global_table)
        flags = 0x80 | k
        gt = np.pad(np.asarray(global_table, np.uint8),
                    ((0, (2 << k) - len(global_table)), (0, 0))).tobytes()
    head += bytes([flags, 0, 0]) + gt
    if transparent is not None:
        head += b"\x21\xf9\x04" + bytes([1, 0, 0, transparent]) + b"\x00"
    fh, fw = frame.shape
    fflags, lt = 0, b""
    if local_table is not None:
        k = table_bits(local_table)
        fflags = 0x80 | k
        lt = np.pad(np.asarray(local_table, np.uint8),
                    ((0, (2 << k) - len(local_table)), (0, 0))).tobytes()
    desc = b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], fw, fh,
                                 fflags) + lt
    return head + desc + lzw_gif(frame, 8) + b"\x3b"


def gif_fixtures() -> dict:
    rgb = small_rgb()
    grey = rgb[..., 1]
    h, w = grey.shape
    idx, pal = quantized(rgb, 64)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    frames = [Image.fromarray(rgb).quantize(64),
              Image.fromarray(rgb[::-1].copy()).quantize(32)]
    anim = io.BytesIO()
    frames[0].save(anim, "GIF", save_all=True, append_images=frames[1:])
    return {
        "g00_grey.gif": pil_bytes(Image.fromarray(grey), "GIF"),
        "g01_palette.gif": pil_bytes(Image.fromarray(rgb).quantize(64),
                                     "GIF", interlace=False),
        "g02_interlaced.gif": pil_bytes(Image.fromarray(rgb).quantize(100),
                                        "GIF", interlace=True),
        "g03_local_palette.gif": gif(w, h, idx, local_table=pal),
        "g04_offset_transparent.gif": gif(w, h, idx[5:35, 7:47],
                                          offset=(7, 5), global_table=pal,
                                          transparent=5),
        "g05_no_palette.gif": gif(w, h, grey),
        "g06_grey_local_over_global.gif": gif(w, h, grey, global_table=pal,
                                              local_table=ramp),
        "g07_animated.gif": anim.getvalue(),
    }


def full_fixtures() -> dict:
    grey = full_grey()
    rgb = tint(grey, SEED + 1)
    return {
        "f00_grey.bmp": pil_bytes(Image.fromarray(grey), "BMP"),
        "f01_grey.pgm": pil_bytes(Image.fromarray(grey), "PPM"),
        "f02_rgb_lzw_predictor.tif": pil_bytes(
            Image.fromarray(rgb), "TIFF", compression="tiff_lzw",
            tiffinfo={317: 2}),
        "f03_palette.gif": pil_bytes(Image.fromarray(rgb).quantize(256),
                                     "GIF"),
    }


def jpeg_writes() -> list:
    """PIL's JPEG files of the pixels the card decodes from
    ``tests/torch_jpeg``: name, channels, subsampling, quality, digest."""
    out = []
    for name in JPEG_SOURCES:
        with Image.open(os.path.join(JPEG_DIR, name)) as im:
            rgb = np.asarray(im.convert("RGB"))
        from superviseddescent_tpu.ops.patches import rgb_to_gray_u8
        grey = rgb_to_gray_u8(rgb)
        for quality in QUALITIES:
            cases = [(3, s, Image.fromarray(rgb)) for s in SUBSAMPLINGS]
            cases.append((1, None, Image.fromarray(grey)))
            for channels, sub, image in cases:
                data = pil_bytes(image, "JPEG", quality=quality,
                                 **({} if sub is None else
                                    {"subsampling": sub}))
                out.append(dict(source=name, channels=channels,
                                subsampling=sub, quality=quality,
                                bytes=len(data),
                                sha256=hashlib.sha256(data).hexdigest()))
    return out


def png_stream(data: bytes) -> bytes:
    """A PNG file's filtered rows: its IDAT chunks' zlib stream inflated."""
    pos, idat = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    return zlib.decompress(b"".join(idat))


def drawn_still(name: str) -> np.ndarray:
    """A full-size still with DRAWN_POINTS' landmarks and their bounding
    box drawn as the JAX ``rcr_detect -o`` draws them (PIL's ImageDraw)."""
    from PIL import ImageDraw
    from superviseddescent_tpu.io.pts import read_pts_landmarks
    points = read_pts_landmarks(os.path.join(
        os.path.dirname(HERE), ".synth120", DRAWN_POINTS + ".pts"))
    coords = np.asarray(points.coordinates, np.float32)
    x0, y0 = coords.min(axis=0)
    w, h = coords.max(axis=0) - (x0, y0)
    with Image.open(os.path.join(OUT, name)) as im:
        img = im.convert("RGB")
    draw = ImageDraw.Draw(img)
    for x, y in coords:
        draw.ellipse([x - 2, y - 2, x + 2, y + 2], outline=(0, 255, 0))
    draw.rectangle([x0, y0, x0 + w, y0 + h], outline=(255, 0, 0))
    return np.asarray(img)


def png_tiff_writes() -> list:
    """PIL's PNG and TIFF files of pixels the card makes without PIL: the
    RGB and grey that JPEG_SOURCES decode to, and the full-size stills
    DRAWN_STILLS drawn (``drawn_still``). Per file its source, channels,
    format, size and sha256; a PNG's also the sha256 of its filtered rows
    (``png_stream``), which no zlib version changes."""
    from superviseddescent_tpu.ops.patches import rgb_to_gray_u8
    cases = []
    for name in JPEG_SOURCES:
        with Image.open(os.path.join(JPEG_DIR, name)) as im:
            rgb = np.asarray(im.convert("RGB"))
        cases += [(name, 3, False, rgb), (name, 1, False, rgb_to_gray_u8(rgb))]
    cases += [(name, 3, True, drawn_still(name)) for name in DRAWN_STILLS]
    out = []
    for name, channels, drawn, px in cases:
        for fmt in ("PNG", "TIFF"):
            data = pil_bytes(Image.fromarray(px), fmt)
            entry = dict(source=name, channels=channels, drawn=drawn,
                         format=fmt, bytes=len(data),
                         sha256=hashlib.sha256(data).hexdigest())
            if fmt == "PNG":
                entry["filtered_sha256"] = hashlib.sha256(
                    png_stream(data)).hexdigest()
            out.append(entry)
    return out


def write_fixtures(out: str = OUT) -> dict:
    os.makedirs(out, exist_ok=True)
    files = {}
    for group in (bmp_fixtures, pnm_fixtures, tiff_fixtures, gif_fixtures,
                  full_fixtures):
        files.update(group())
    manifest = {"files": {}, "jpeg_writes": jpeg_writes(),
                "crop": list(CROP), "full_image": FULL_IMAGE,
                "drawn_points": DRAWN_POINTS,
                "zlib": zlib.ZLIB_RUNTIME_VERSION}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest["files"][name] = dict(pil_digests(path), bytes=len(data))
    manifest["png_tiff_writes"] = png_tiff_writes()
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    m = write_fixtures()
    total = sum(v["bytes"] for v in m["files"].values())
    print(f"{len(m['files'])} files, {total} bytes, "
          f"{len(m['jpeg_writes'])} JPEG digests")
