"""Writes the committed BMP / PNM / TIFF / GIF / WebP fixtures,
``tests/torch_imageio/``, with PIL and small writers of its own.

    python tests/torch_imageio_fixtures.py

The card has no PIL, so ``chip_smoke.py --imageio`` and ``--tiffwebp``
read these files and hold the port's readers to PIL's digests in
``manifest.json``: per file
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
  (LZW, predictor 2) and a GIF of one ``.synth120`` image (412 x 600);
* one uncompressed TIFF (23 x 17) for each of the 120 keys of PIL's
  ``TiffImagePlugin.OPEN_INFO`` (``k*``, written by ``tiff``: samples wide
  enough to clip, NaN and infinities among the floats; raw YCbCr with its
  strip after the IFD, as PIL writes it), ten of which PIL cannot read
  (the manifest holds PIL's error for those); the compressed kinds
  (``c*``: LZMA, predictors 2 and 3, 16 and 32-bit big-endian, fill order
  2, planar CMYK, LA, 16-bit RGB tiles); JPEG-in-TIFF (``j*``: PIL's own
  writes, grey, RGB and 4:4:4 YCbCr, and libtiff's layout around PIL's
  JPEG streams, 4:2:0 and 4:2:2 YCbCr and grey in strips and tiles);
  grey PFM at both byte orders (``n11``-``n13``);
* lossless WebP (``w*``): PIL's encoder at methods 0, 4 and 6, RGBA with
  and without ``exact``, 2, 4 and 16-colour palettes, grey, noise, ICC
  and EXIF chunks, a 2-frame animation, an animation whose first frame
  lies inside a larger canvas, a meta prefix image, and a bitstream of
  this script's (``vp8l_predictor_modes``) whose predictor image walks
  all 16 modes;
* the clip frame ``clip/f000.jpg``'s pixels (768 x 1024) for the card's
  new readers: a lossless WebP; JPEG-in-TIFF as PIL's writer lays it out
  (RGB, its default strips of 32 rows) and as libtiff's writer does
  (``libtiff_jpeg_tiff``: YCbCr 4:2:0, its default strips of 16 rows),
  one J1 launch each; and 4:2:0 strips of 80 rows, the worst case of two
  launches (a batch and a short last strip).

* the rest of the TIFF files PIL reads (``r*``, ``tiff_remainder_fixtures``):
  BigTIFF, CCITT RLE / Group 3 / Group 4, Zstandard and YCbCr under the
  lossless compressions; and the clip frame as BigTIFF-JPEG, Zstandard
  and YCbCr 2x2 LZW (``f09``-``f11``) for the card.

    python tests/torch_imageio_fixtures.py tiff_remainder clip_remainder

writes only the groups named, their entries updated in the manifest;
``gif_webp_writes`` names the GIF and WebP write digests
(``gif_webp_writes``: PIL's GIF and WebP files of the pixels of
``torch_write_inputs``' recipes, and ``rcr_detect -o x.gif`` / ``x.webp``
of the JAX app), which add no file.
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
# the card's new readers read this clip frame's pixels as a lossless WebP
# and as JPEG-compressed TIFFs; the 4:2:0 strips of 80 rows (12 of 80 and
# one of 64) are the worst case of J1's two launches
CLIP_FRAME = "clip/f000.jpg"
CLIP_STRIP_ROWS = 80


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
    PIL's mode; for a file PIL cannot read, its error."""
    from superviseddescent_tpu.ops.patches import load_gray_image
    try:
        grey = load_gray_image(path).astype(np.uint8)
    except (OSError, ValueError, SyntaxError) as e:   # the file by name
        return dict(pil_error=str(e).replace(os.fspath(path),
                                             os.path.basename(path)))
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
def tiff(chunks, tags: dict, big_endian=False, data_last=False) -> bytes:
    """A TIFF of one IFD: ``chunks`` (strips or tiles, in order) and
    ``tags`` {tag: (type, values)} (a RATIONAL's values its numerators
    and denominators in turn); the offsets and byte counts of the
    chunks go under the offsets tag named in ``tags`` with values None.
    ``data_last``: the chunks after the IFD, as PIL writes them (a reader
    that runs past a strip then meets the end of the file)."""
    e = ">" if big_endian else "<"
    fmt = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B"}

    def layout(start):
        body, offsets = bytearray(), []
        for c in chunks:
            offsets.append(start + len(body))
            body += c
            if len(body) % 2:
                body += b"\x00"
        entries = dict(tags)
        for off_tag, cnt_tag in ((273, 279), (324, 325)):
            if off_tag in entries:
                entries[off_tag] = (4, offsets)
                entries[cnt_tag] = (4, [len(c) for c in chunks])
        return body, entries

    def directory(entries, ifd_at):
        n = len(entries)
        extra_at = ifd_at + 2 + 12 * n + 4
        ifd, extra = struct.pack(e + "H", n), bytearray()
        for tag in sorted(entries):
            kind, values = entries[tag]
            packed = struct.pack(e + fmt[kind] * len(values), *values)
            count = len(values) // 2 if kind == 5 else len(values)
            if len(packed) <= 4:
                ifd += struct.pack(e + "HHI", tag, kind, count)
                ifd += packed.ljust(4, b"\x00")
            else:
                ifd += struct.pack(e + "HHII", tag, kind, count,
                                   extra_at + len(extra))
                extra += packed
                if len(extra) % 2:
                    extra += b"\x00"
        ifd += struct.pack(e + "I", 0)
        return bytes(ifd) + bytes(extra)

    head = (b"MM\x00*" if big_endian else b"II*\x00")
    if data_last:
        meta = directory(layout(0)[1], 8)
        body, entries = layout(8 + len(meta))
        return head + struct.pack(e + "I", 8) + directory(entries, 8) + bytes(
            body)
    body, entries = layout(8)
    return head + struct.pack(e + "I", 8 + len(body)) + bytes(body) + \
        directory(entries, 8 + len(body))


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


def clip_fixtures() -> dict:
    """The clip frame's pixels for the card's new readers."""
    with Image.open(os.path.join(JPEG_DIR, CLIP_FRAME)) as im:
        clip = np.asarray(im.convert("RGB"))
    return {
        "f04_clip.webp": pil_bytes(Image.fromarray(clip), "WEBP",
                                   lossless=True, method=4),
        "f05_clip_ycbcr420.tif": jpeg_tiff(clip, rows=CLIP_STRIP_ROWS),
        "f06_clip_rgb_pil.tif": pil_bytes(Image.fromarray(clip), "TIFF",
                                          compression="jpeg"),
        "f07_clip_ycbcr420_libtiff.tif": libtiff_jpeg_tiff(clip),
    }


def libtiff_jpeg_tiff(rgb: np.ndarray, quality: int = 75) -> bytes:
    """RGB pixels as libtiff's own writer lays out a JPEG-compressed YCbCr
    4:2:0 TIFF (through ctypes): its default rows a strip
    (``TIFFDefaultStripSize``), libjpeg's colour conversion and
    downsampling (``JPEGCOLORMODE_RGB``), written a scanline at a time."""
    import ctypes
    import ctypes.util
    import tempfile
    lib = ctypes.CDLL(ctypes.util.find_library("tiff"))
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFDefaultStripSize.restype = ctypes.c_uint32
    h, w = rgb.shape[:2]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "page.tif")
        tif = ctypes.c_void_p(lib.TIFFOpen(path.encode(), b"w"))
        assert tif.value, "libtiff cannot open " + path

        def put(tag, *values):
            assert lib.TIFFSetField(tif, ctypes.c_uint32(tag), *values)
        u32, i = ctypes.c_uint32, ctypes.c_int
        put(256, u32(w))
        put(257, u32(h))
        put(258, i(8))
        put(277, i(3))
        put(284, i(1))
        put(259, i(7))
        put(262, i(6))
        put(530, i(2), i(2))
        put(65538, i(1))                    # JPEGCOLORMODE_RGB
        put(65537, i(quality))              # JPEGQUALITY
        put(278, u32(lib.TIFFDefaultStripSize(tif, u32(0))))
        for y in range(h):
            row = np.ascontiguousarray(rgb[y], np.uint8)
            assert lib.TIFFWriteScanline(
                tif, row.ctypes.data_as(ctypes.c_void_p), u32(y), i(0)) == 1
        lib.TIFFClose(tif)
        with open(path, "rb") as f:
            return f.read()


# ------------------------------------------------- TIFF kinds, JPEG, PFM
KIND_CROP = (150, 120, 17, 23)     # row, column, height, width


def kind_name(index: int, key) -> str:
    order, photometric, fmt, fill, bits, extra = key
    return (f"k{index:03d}_{order.decode()}_p{photometric}_s{fmt[0]}_f{fill}"
            f"_b{'-'.join(map(str, bits))}"
            + (f"_e{'-'.join(map(str, extra))}" if extra else "") + ".tif")


def kind_samples(key, rng) -> bytes:
    """Rows of samples for one OPEN_INFO key, in the file's byte order:
    the crop's grey, colour and an alpha of it, widened where the kind is
    wide (16-bit values past 255, signed values below 0, floats with
    fractions, NaN and infinities), so every clip and truncation shows."""
    order, photometric, fmt, fill, bits, extra = key
    e = ">" if order == b"MM" else "<"
    y, x, h, w = KIND_CROP
    rgb = tint(synth(0)[y:y + h, x:x + w], SEED + 2).astype(np.int64)
    grey = rgb[..., 1]
    spp, depth = len(bits), bits[0]
    planes = [rgb[..., 0], rgb[..., 1], rgb[..., 2], 255 - grey // 2,
              grey // 3, grey // 5][:spp]
    if photometric in (0, 1, 3, 6) and spp <= 2:
        planes = [grey, 255 - grey // 2][:spp]
    px = np.stack(planes, axis=-1)
    if depth < 8:
        v = px >> (8 - depth)
        flat = np.unpackbits(v.astype(np.uint8)[..., None], axis=-1)[
            ..., 8 - depth:].reshape(h, -1)
        return np.packbits(flat, axis=1).tobytes()
    if depth == 12:
        v = (px * 7 + rng.integers(0, 9, px.shape)) & 0xFFF
        flat = np.unpackbits(v.astype(">u2").view(np.uint8).reshape(
            h, -1, 2), axis=-1)[..., 4:].reshape(h, -1)
        return np.packbits(flat, axis=1).tobytes()
    if fmt == (3,):
        v = (px * 1.3 - 40 + rng.uniform(0, 1, px.shape)).astype(np.float32)
        v.flat[:4] = (np.nan, np.inf, -np.inf, 1e9)
        return v.astype(e + "f4").tobytes()
    if depth == 8:
        return px.astype(np.uint8).tobytes()
    if fmt == (2,):
        return (px * 3 - 200).astype(f"{e}i{depth // 8}").tobytes()
    if depth == 16:
        wide = px * 257 + rng.integers(0, 257, px.shape)
        if photometric in (0, 1):
            wide = px * 2 + rng.integers(0, 3, px.shape)   # past 255
        return wide.astype(e + "u2").tobytes()
    v = px * 3 - 200                                       # I;32N
    return v.astype(np.int64).astype(e + "i4").tobytes()


def tiff_kind_fixtures() -> dict:
    """One uncompressed file of one strip per key of PIL's OPEN_INFO (raw
    YCbCr with its strip after the IFD, as PIL writes it)."""
    from PIL import TiffImagePlugin
    rng = np.random.default_rng(SEED)
    y, x, h, w = KIND_CROP
    out = {}
    for i, key in enumerate(sorted(TiffImagePlugin.OPEN_INFO, key=repr)):
        order, photometric, fmt, fill, bits, extra = key
        tags = {256: (3, [w]), 257: (3, [h]), 258: (3, list(bits)),
                259: (3, [1]), 262: (3, [photometric]), 273: None,
                277: (3, [len(bits)]), 278: (3, [h])}
        if fmt != (1,):
            tags[339] = (3, [fmt[0]] * len(bits))
        if fill != 1:
            tags[266] = (3, [fill])
        if extra:
            tags[338] = (3, list(extra))
        if photometric == 3:
            n = 1 << bits[0]
            tags[320] = (3, list(rng.integers(0, 65536, 3 * n)))
        out[kind_name(i, key)] = tiff(
            [kind_samples(key, rng)], tags, big_endian=order == b"MM",
            data_last=photometric == 6)
    return out


def split_jpeg(data: bytes):
    """A PIL JPEG -> (its tables as a JPEGTables stream: SOI, DQT, DHT,
    EOI; the abbreviated stream: SOI, SOF, the scan, EOI)."""
    pos, tables, rest = 2, b"\xff\xd8", b"\xff\xd8"
    while True:
        marker = data[pos + 1]
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker in (0xDB, 0xC4):
            tables += data[pos:pos + 2 + n]
        elif marker == 0xDA:
            return tables + b"\xff\xd9", rest + data[pos:]
        elif marker in (0xC0, 0xC1, 0xC2, 0xDD):
            rest += data[pos:pos + 2 + n]
        pos += 2 + n


def jpeg_tiff(px, rows=None, tile=None, subsampling="4:2:0", quality=75,
              big_endian=False) -> bytes:
    """A JPEG-compressed TIFF as libtiff writes one: each strip (``rows``
    a strip, the last the rows left) or tile (``tile`` = width, height;
    zero-padded) a PIL JPEG cut to an abbreviated stream, the tables once
    under JPEGTables; photometric 6 (YCbCr) for RGB pixels, 1 for grey."""
    h, w = px.shape[:2]
    grey = px.ndim == 2
    if tile:
        tw, tl = tile
        pieces = []
        for ty in range(0, h, tl):
            for tx in range(0, w, tw):
                t = np.zeros((tl, tw) + px.shape[2:], np.uint8)
                part = px[ty:ty + tl, tx:tx + tw]
                t[:part.shape[0], :part.shape[1]] = part
                pieces.append(t)
    else:
        pieces = [px[y0:y0 + rows] for y0 in range(0, h, rows)]
    chunks, tables = [], None
    for piece in pieces:
        options = {} if grey else {"subsampling": subsampling}
        t, body = split_jpeg(pil_bytes(Image.fromarray(piece), "JPEG",
                                       quality=quality, **options))
        assert tables in (None, t)
        tables = t
        chunks.append(body)
    factors = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8] * (1 if grey else 3)),
            259: (3, [7]), 262: (3, [1 if grey else 6]),
            277: (3, [1 if grey else 3]), 347: (7, list(tables))}
    if not grey:
        tags[530] = (3, list(factors[subsampling]))
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: None})
    else:
        tags.update({273: None, 278: (3, [rows])})
    return tiff(chunks, tags, big_endian=big_endian)


def fp_predicted(values: np.ndarray, samples: int) -> bytes:
    """libtiff's floating-point predictor (3) on (h, w * samples) float32
    rows: each row's bytes in planes by significance (most significant
    first), then each byte less the one ``samples`` bytes to its left."""
    out = []
    for row in values:
        planes = row.astype(">f4").view(np.uint8).reshape(-1, 4).T.ravel()
        d = planes.astype(np.int16)
        d[samples:] = planes[samples:].astype(np.int16) - planes[:-samples]
        out.append((d & 0xFF).astype(np.uint8))
    return np.concatenate(out).tobytes()


def tiff_more_fixtures() -> dict:
    """Compressions and predictors of the new kinds, JPEG-in-TIFF (PIL's
    own writes: grey, RGB and 4:4:4 YCbCr; libtiff's layout with PIL's
    JPEG: 4:2:0 and 4:2:2 YCbCr and grey in strips and tiles), LZMA."""
    import lzma
    rgb = small_rgb()
    grey = rgb[..., 1]
    h, w = grey.shape
    rng = np.random.default_rng(SEED + 3)
    base = {256: (3, [w]), 257: (3, [h]), 273: None, 277: (3, [1]),
            278: (3, [h])}
    f = (grey * 1.3 - 40 + rng.uniform(0, 1, grey.shape)).astype(np.float32)
    v16 = (grey.astype(np.int64) * 3).astype(np.uint16)
    d16 = (np.diff(v16.astype(np.int64), axis=1, prepend=0) & 0xFFFF)
    s32 = grey.astype(np.int64) * 3 - 200
    d32 = np.diff(s32, axis=1, prepend=0) & 0xFFFFFFFF
    cmyk = np.concatenate([255 - rgb, (grey // 4)[..., None]], axis=2)
    rev = lambda b: bytes(bytearray(int(f"{c:08b}"[::-1], 2) for c in b))
    files = {
        "c00_grey_lzma.tif": pil_bytes(Image.fromarray(grey), "TIFF",
                                       compression="lzma"),
        "c01_rgb_lzma_predictor.tif": pil_bytes(
            Image.fromarray(rgb), "TIFF", compression="lzma",
            tiffinfo={317: 2}),
        "c02_float_deflate_predictor3.tif": pil_bytes(
            Image.fromarray(f, "F"), "TIFF",
            compression="tiff_adobe_deflate", tiffinfo={317: 3}),
        "c03_float_lzma_predictor3_be.tif": tiff(
            [lzma.compress(fp_predicted(f, 1))], {
                **base, 258: (3, [32]), 259: (3, [34925]), 262: (3, [1]),
                317: (3, [3]), 339: (3, [3])}, big_endian=True),
        "c04_i16_deflate_predictor2_be.tif": tiff(
            [zlib.compress(d16.astype(">u2").tobytes())], {
                **base, 258: (3, [16]), 259: (3, [8]), 262: (3, [1]),
                317: (3, [2])}, big_endian=True),
        "c05_i32s_lzw.tif": pil_bytes(Image.fromarray(
            s32.astype(np.int32), "I"), "TIFF", compression="tiff_lzw"),
        "c06_i32s_deflate_predictor2_be.tif": tiff(
            [zlib.compress(d32.astype(">u4").tobytes())], {
                **base, 258: (3, [32]), 259: (3, [8]), 262: (3, [1]),
                317: (3, [2]), 339: (3, [2])}, big_endian=True),
        "c07_bilevel_fill2_deflate.tif": tiff(
            [rev(zlib.compress(np.packbits(grey > 120, axis=1).tobytes()))],
            {**base, 258: (3, [1]), 259: (3, [8]), 262: (3, [0]),
             266: (3, [2])}),
        "c08_cmyk_planar_deflate.tif": tiff(
            [zlib.compress(cmyk[..., c].tobytes()) for c in range(4)], {
                **base, 258: (3, [8] * 4), 259: (3, [8]), 262: (3, [5]),
                277: (3, [4]), 284: (3, [2])}),
        "c09_cmyk_lzw.tif": pil_bytes(Image.fromarray(cmyk, "CMYK"), "TIFF",
                                      compression="tiff_lzw"),
        "c10_la_packbits.tif": pil_bytes(Image.fromarray(np.stack(
            [grey, 255 - grey], axis=2), "LA"), "TIFF",
            compression="packbits"),
        "c11_rgb16_tiles_deflate_predictor2.tif": tiff(
            [zlib.compress((np.diff(t.astype(np.int64), axis=1, prepend=0)
                            & 0xFFFF).astype("<u2").tobytes())
             for t in tiles_of(rgb.astype(np.uint16) * 257
                               + rng.integers(0, 257, rgb.shape), 16)], {
                256: (3, [w]), 257: (3, [h]), 258: (3, [16] * 3),
                259: (3, [8]), 262: (3, [2]), 277: (3, [3]), 317: (3, [2]),
                322: (3, [16]), 323: (3, [16]), 324: None}),
        "j00_rgb_strips_pil.tif": pil_bytes(
            Image.fromarray(rgb), "TIFF", compression="jpeg",
            tiffinfo={278: 16}),
        "j01_grey_strips_pil.tif": pil_bytes(
            Image.fromarray(grey), "TIFF", compression="jpeg",
            tiffinfo={278: 8}),
        "j02_ycbcr444_pil.tif": pil_bytes(
            Image.fromarray(rgb).convert("YCbCr"), "TIFF",
            compression="jpeg"),
        "j03_ycbcr420_strips.tif": jpeg_tiff(rgb, rows=16),
        "j04_ycbcr420_tiles.tif": jpeg_tiff(rgb, tile=(32, 16)),
        "j05_ycbcr422_strips_be.tif": jpeg_tiff(
            rgb, rows=8, subsampling="4:2:2", quality=90, big_endian=True),
        "j06_grey_tiles.tif": jpeg_tiff(grey, tile=(16, 16), quality=50),
    }
    return files


def tiles_of(px: np.ndarray, size: int) -> list:
    """(h, w, c) -> its size x size tiles, zero-padded, rows of
    ``size * c`` samples."""
    h, w = px.shape[:2]
    out = []
    for ty in range(0, h, size):
        for tx in range(0, w, size):
            t = np.zeros((size, size) + px.shape[2:], px.dtype)
            part = px[ty:ty + size, tx:tx + size]
            t[:part.shape[0], :part.shape[1]] = part
            out.append(t.reshape(size, -1))
    return out


def pfm_fixtures() -> dict:
    grey = small_rgb()[..., 1]
    h, w = grey.shape
    rng = np.random.default_rng(SEED + 4)
    f = (grey * 1.2 - 30 + rng.uniform(0, 1, grey.shape)).astype(np.float32)
    f.flat[:3] = (np.nan, np.inf, 300.5)
    return {
        "n11_pf_little_endian.pfm": b"Pf\n%d %d\n-1.0\n" % (w, h)
        + f[::-1].astype("<f4").tobytes(),
        "n12_pf_big_endian.pfm": b"Pf\n%d %d\n2.5\n" % (w, h)
        + f[::-1].astype(">f4").tobytes(),
        "n13_pf_pil.pfm": pil_bytes(Image.fromarray(f, "F"), "PPM"),
    }


# ------------------------------------------------------------------ WebP
class _LsbWriter:
    """Bits least significant first, as VP8L reads them."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, v: int, n: int):
        self.value |= (v & ((1 << n) - 1)) << self.n
        self.n += n

    def code8(self, symbol: int):
        """A symbol of a code of 256 lengths of 8: its 8 bits, first bit
        the code's most significant."""
        self.put(int(f"{symbol:08b}"[::-1], 2), 8)

    def bytes(self) -> bytes:
        return self.value.to_bytes((self.n + 7) // 8, "little")


def _literal_image(bw: _LsbWriter, argb: np.ndarray, meta: bool):
    """An entropy-coded image of literals only: no colour cache, no meta
    prefix image, and five codes: green, red, blue and alpha of 256 lengths
    of 8 (a code-length code of the one length 8, which takes no bits; the
    green code's 24 length symbols cut off by max_symbol), distance a
    simple code of one symbol."""
    bw.put(0, 1)                                   # no colour cache
    if meta:
        bw.put(0, 1)                               # no meta prefix image
    for k in range(4):
        bw.put(0, 1)                               # a normal code
        bw.put(12 - 4, 4)                          # 12 code-length lengths
        for i in range(12):                        # order: ... 16, 6, 7, 8
            bw.put(1 if i == 11 else 0, 3)
        if k == 0:
            bw.put(1, 1)
            bw.put(3, 3)                           # 8 bits of max_symbol
            bw.put(254, 8)                         # 256 = 2 + 254
        else:
            bw.put(0, 1)
    bw.put(1, 1)                                   # distance: simple,
    bw.put(0, 1)                                   # one symbol,
    bw.put(0, 1)                                   # 1 bit wide,
    bw.put(0, 1)                                   # symbol 0
    for p in argb.ravel().tolist():
        for shift in (8, 16, 0, 24):               # green, red, blue, alpha
            bw.code8((p >> shift) & 0xFF)


def vp8l_predictor_modes(argb: np.ndarray, bits: int = 2) -> bytes:
    """A VP8L bitstream whose predictor image walks every mode, 0 to 15,
    block after block (``bits``: the blocks' size), over ``argb`` as its
    residuals, all literals: PIL's decode of it is the reference."""
    h, w = argb.shape
    bw = _LsbWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(1, 1)
    bw.put(0, 3)
    bw.put(1, 1)                                   # a transform:
    bw.put(0, 2)                                   # the predictor
    bw.put(bits - 2, 3)
    bh, bwide = -(-h >> bits), -(-w >> bits)
    modes = (np.arange(bh * bwide) % 16).reshape(bh, bwide).astype(np.uint32)
    _literal_image(bw, (modes << 8) | 0xFF000000, False)
    bw.put(0, 1)                                   # no more transforms
    _literal_image(bw, argb, True)
    return bw.bytes()


def riff(chunks) -> bytes:
    body = b"WEBP"
    for fourcc, payload in chunks:
        body += fourcc + struct.pack("<I", len(payload)) + payload
        if len(payload) % 2:
            body += b"\x00"
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8l_of(data: bytes) -> bytes:
    """The VP8L payload of a simple lossless WebP of PIL's."""
    assert data[12:16] == b"VP8L"
    (n,) = struct.unpack_from("<I", data, 16)
    return data[20:20 + n]


def webp_fixtures() -> dict:
    rgb = small_rgb()
    grey = rgb[..., 1]
    h, w = grey.shape
    rng = np.random.default_rng(SEED + 5)
    rgba = np.concatenate([rgb, (255 - grey // 2)[..., None]], axis=2)
    rgba[::7, ::5, 3] = 0
    argb = ((rgba[..., 3].astype(np.uint32) << 24)
            | (rgba[..., 0].astype(np.uint32) << 16)
            | (rgba[..., 1].astype(np.uint32) << 8) | rgba[..., 2])
    second = Image.fromarray(rgb[::-1].copy())
    anim = io.BytesIO()
    Image.fromarray(rgb).save(anim, "WEBP", lossless=True, save_all=True,
                              append_images=[second], duration=80)
    frame = vp8l_of(pil_bytes(Image.fromarray(rgba[:30, :40], "RGBA"),
                              "WEBP", lossless=True, exact=True))
    cw, ch = w + 6, h + 4
    vp8x = struct.pack("<B3x", 0x12) + (cw - 1).to_bytes(3, "little") + (
        ch - 1).to_bytes(3, "little")
    anmf = ((4 // 2).to_bytes(3, "little") + (6 // 2).to_bytes(3, "little")
            + (40 - 1).to_bytes(3, "little") + (30 - 1).to_bytes(3, "little")
            + (100).to_bytes(3, "little") + b"\x00")
    offset_anim = riff([(b"VP8X", vp8x), (b"ANIM", bytes(6)),
                        (b"ANMF", anmf + b"VP8L" + struct.pack(
                            "<I", len(frame)) + frame
                            + b"\x00" * (len(frame) & 1))])
    files = {
        "w00_rgb_m0_q0.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                        lossless=True, method=0, quality=0),
        "w01_rgb_m4_q50.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                         lossless=True, method=4,
                                         quality=50),
        "w02_rgb_m6_q100.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                          lossless=True, method=6,
                                          quality=100),
        "w03_rgba.webp": pil_bytes(Image.fromarray(rgba, "RGBA"), "WEBP",
                                   lossless=True),
        "w04_rgba_exact.webp": pil_bytes(Image.fromarray(rgba, "RGBA"),
                                         "WEBP", lossless=True, exact=True),
        "w05_palette2.webp": pil_bytes(Image.fromarray(rgb).quantize(2)
                                       .convert("RGB"), "WEBP",
                                       lossless=True),
        "w06_palette4.webp": pil_bytes(Image.fromarray(rgb).quantize(4)
                                       .convert("RGB"), "WEBP",
                                       lossless=True),
        "w07_palette16.webp": pil_bytes(Image.fromarray(rgb).quantize(16)
                                        .convert("RGB"), "WEBP",
                                        lossless=True),
        "w08_grey.webp": pil_bytes(Image.fromarray(grey), "WEBP",
                                   lossless=True),
        "w09_animated.webp": anim.getvalue(),
        "w10_animated_offset_frame.webp": offset_anim,
        "w11_predictor_modes.webp": riff([(b"VP8L", vp8l_predictor_modes(
            argb ^ rng.integers(0, 1 << 32, argb.shape, np.uint32)
            .astype(np.uint32) & 0x0F0F0F0F))]),
        "w12_icc_exif.webp": pil_bytes(
            Image.fromarray(rgb), "WEBP", lossless=True,
            icc_profile=b"\x00" * 132, exif=b"Exif\x00\x00II*\x00"
            + bytes(8)),
        "w13_noise.webp": pil_bytes(Image.fromarray(rng.integers(
            0, 256, (h, w, 3)).astype(np.uint8)), "WEBP", lossless=True),
        # large enough for libwebp to split the codes by a meta prefix image
        "w14_meta_prefix.webp": pil_bytes(Image.fromarray(tint(synth(0)[
            100:190, 90:210], SEED)), "WEBP", lossless=True, method=4,
            quality=100),
    }
    return files


# ---- lossy WebP (VP8, and its ALPH chunk) ----
# the C writer over libwebp's encoder, for what PIL's save() cannot set
WEBP_WRITER = os.path.join(HERE, "torch_webp_writer.c")
# a taller crop of the clip frame, for 8 token partitions (9 macroblock
# rows: each partition takes rows)
PARTITIONS_CROP = (200, 300, 136, 45)        # row, column, height, width


def clip_rgb() -> np.ndarray:
    with Image.open(os.path.join(JPEG_DIR, CLIP_FRAME)) as im:
        return np.asarray(im.convert("RGB"))


def webp_writer(rgb: np.ndarray, **options) -> bytes:
    """libwebp's lossy encoder through tests/torch_webp_writer.c (built
    with gcc against the system's -lwebp): RGB or RGBA pixels, WebPConfig
    fields by name."""
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "writer")
        subprocess.run(["gcc", "-O2", "-o", exe, WEBP_WRITER, "-lwebp"],
                       check=True)
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.webp")
        np.ascontiguousarray(rgb, np.uint8).tofile(raw)
        h, w, c = rgb.shape
        subprocess.run([exe, raw, str(w), str(h), str(c), out] + [
            f"{k}={v}" for k, v in options.items()], check=True)
        with open(out, "rb") as f:
            return f.read()


class BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.put(128, (v >> k) & 1)

    def signed(self, v: int, n: int):
        self.literal(abs(v), n)
        self.put(128, int(v < 0))

    def flush(self) -> bytes:
        for _ in range(32):
            self.put(128, 0)
        return bytes(self.out)


def _recorded_partition0(payload: bytes) -> list:
    """(probability, bit) of every decode of a VP8 frame's first
    partition, in order, as the port's twin reads it."""
    from superviseddescent_tpu_torch.io import vp8
    seen = []

    class Recording(vp8.BoolDecoder):
        def __init__(self, data):
            super().__init__(data)
            self.log = []
            seen.append(self)

        def bit(self, prob):
            b = super().bit(prob)
            self.log.append((prob, b))
            return b
    plain, vp8.BoolDecoder = vp8.BoolDecoder, Recording
    try:
        vp8.decode_vp8(payload)
    finally:
        vp8.BoolDecoder = plain
    return seen[0].log


def vp8_rewrite_header(payload: bytes, delta_segments=False,
                       lf_delta=None) -> bytes:
    """A VP8 key frame with its first partition's header rewritten:
    ``delta_segments`` the segment quantisers and filter levels as deltas
    to the frame's (segment_feature_mode 0, which libwebp's encoder never
    writes); ``lf_delta`` (reference delta, B_PRED mode delta) switches on
    mode_ref_lf_delta with those deltas (libwebp's encoder writes none).
    Every other bit is re-encoded as it was; the token partitions are
    kept."""
    bits = _recorded_partition0(payload)
    pos = [0]

    def take(n=1):
        v = 0
        for _ in range(n):
            v = (v << 1) | bits[pos[0]][1]
            pos[0] += 1
        return v

    def take_signed(n):
        v = take(n)
        return -v if take() else v

    def opt(n):
        return take_signed(n) if take() else None
    colour, clamp, use_segment = take(), take(), take()
    seg = None
    if use_segment:
        update_map, update_data = take(), take()
        if update_data:
            absolute = take()
            qs, fs = [opt(7) for _ in range(4)], [opt(6) for _ in range(4)]
            seg = (absolute, qs, fs)
        probas = [take(8) if take() else None for _ in range(3)] \
            if update_map else []
    simple, level, sharpness = take(), take(6), take(3)
    use_lf = take()
    deltas = None
    if use_lf and take():
        deltas = [[opt(6) for _ in range(4)] for _ in range(2)]
    rest_bits = bits[pos[0]:]
    # base_q is the first thing after the partition count
    q_pos = 2
    base_q = 0
    for k in range(7):
        base_q = (base_q << 1) | rest_bits[q_pos + k][1]
    enc = BoolEncoder()
    enc.literal(colour, 1)
    enc.literal(clamp, 1)
    enc.literal(use_segment, 1)
    if use_segment:
        enc.literal(update_map, 1)
        enc.literal(int(seg is not None), 1)
        if seg is not None:
            absolute, qs, fs = seg
            rel = delta_segments and absolute
            enc.literal(0 if rel else absolute, 1)
            for vals, n, base in ((qs, 7, base_q), (fs, 6, level)):
                for v in vals:
                    if v is not None and rel:
                        v -= base
                    enc.literal(int(v is not None), 1)
                    if v is not None:
                        enc.signed(v, n)
        for p in probas:
            enc.literal(int(p is not None), 1)
            if p is not None:
                enc.literal(p, 8)
    enc.literal(simple, 1)
    enc.literal(level, 6)
    enc.literal(sharpness, 3)
    if lf_delta is not None:
        deltas = [[lf_delta[0], None, None, None],
                  [lf_delta[1], None, None, None]]
    enc.literal(int(deltas is not None or use_lf), 1)
    if deltas is not None or use_lf:
        enc.literal(int(deltas is not None), 1)
        for row in deltas or []:
            for v in row:
                enc.literal(int(v is not None), 1)
                if v is not None:
                    enc.signed(v, 6)
    for prob, b in rest_bits:
        enc.put(prob, b)
    part0 = enc.flush()
    tag = int.from_bytes(payload[:3], "little")
    old_len = tag >> 5
    tag = (tag & 0x1F) | (len(part0) << 5)
    return (tag.to_bytes(3, "little") + payload[3:10] + part0
            + payload[10 + old_len:])


def vp8_of(data: bytes) -> bytes:
    """The VP8 payload of a simple lossy WebP."""
    assert data[12:16] == b"VP8 "
    (n,) = struct.unpack_from("<I", data, 16)
    return data[20:20 + n]


def vp8x(width: int, height: int, flags: int) -> bytes:
    return struct.pack("<B3x", flags) + (width - 1).to_bytes(
        3, "little") + (height - 1).to_bytes(3, "little")


def filtered_alpha(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha filters (the deltas ``ALPH`` stores): 1
    horizontal, 2 vertical, 3 gradient; each row's first sample from the
    one above, the first row from the left starting at 0."""
    a = alpha.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    else:
        pred[1:, 0] = a[:-1, 0]
        if method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1],
                                   0, 255)
    if method == 1:
        pred[1:, 0] = a[:-1, 0]
    return ((a - pred) & 0xFF).astype(np.uint8)


def alph_chunk(alpha: np.ndarray, method: int, compressed: bool) -> bytes:
    """An ALPH chunk of this script's: ``alpha`` filtered by ``method``,
    raw or as a VP8L image stream (PIL's lossless WebP of the deltas as
    green, its 5-byte header cut)."""
    deltas = filtered_alpha(alpha, method) if method else alpha
    header = bytes([(method << 2) | int(compressed)])
    if not compressed:
        return header + deltas.tobytes()
    grey = np.repeat(deltas[..., None], 3, axis=2)
    return header + vp8l_of(pil_bytes(Image.fromarray(grey), "WEBP",
                                      lossless=True))[5:]


def lossy_alpha(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    a = ((xx * 7 + yy * 11) % 256).astype(np.uint8)
    a[::5, ::3] = 255
    return a


def webp_lossy_fixtures() -> dict:
    rgb = small_rgb()
    h, w = rgb.shape[:2]
    clip = clip_rgb()
    y, x, ph, pw = PARTITIONS_CROP
    tall = np.ascontiguousarray(clip[y:y + ph, x:x + pw])
    alpha = lossy_alpha(h, w)
    rgba = np.concatenate([rgb, alpha[..., None]], axis=2)
    plain = vp8_of(pil_bytes(Image.fromarray(rgb), "WEBP", quality=60))
    files = {
        "v00_q0_m4.webp": pil_bytes(Image.fromarray(rgb), "WEBP", quality=0),
        "v01_q50_m4.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                     quality=50),
        "v02_q75_m0.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                     quality=75, method=0),
        "v03_q100_m6.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                      quality=100, method=6),
        "v04_q75_m6.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                     quality=75, method=6),
        "v05_sharp_yuv.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                        quality=75, use_sharp_yuv=True),
        "v06_1x37.webp": pil_bytes(Image.fromarray(rgb[:1, :37].copy()),
                                   "WEBP", quality=75),
        "v07_37x1.webp": pil_bytes(Image.fromarray(rgb[:37, :1].copy()),
                                   "WEBP", quality=75),
        "v08_33x17.webp": pil_bytes(Image.fromarray(rgb[:17, :33].copy()),
                                    "WEBP", quality=75),
        "v09_16x32.webp": pil_bytes(Image.fromarray(rgb[:32, :16].copy()),
                                    "WEBP", quality=30),
        "v10_rgba_aq0.webp": pil_bytes(Image.fromarray(rgba, "RGBA"), "WEBP",
                                       quality=75, alpha_quality=0),
        "v11_rgba_aq50.webp": pil_bytes(Image.fromarray(rgba, "RGBA"),
                                        "WEBP", quality=75, alpha_quality=50),
        "v12_rgba_aq100.webp": pil_bytes(Image.fromarray(rgba, "RGBA"),
                                         "WEBP", quality=75,
                                         alpha_quality=100),
    }
    anim = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(
        anim, "WEBP", quality=70, save_all=True, duration=80,
        append_images=[Image.fromarray(rgba[::-1].copy(), "RGBA")])
    files["v13_animated.webp"] = anim.getvalue()
    # a lossy first frame with its own ALPH inside a larger canvas
    fw, fh = 40, 30
    frame = vp8_of(pil_bytes(Image.fromarray(rgb[:fh, :fw].copy()), "WEBP",
                             quality=70))
    falph = alph_chunk(alpha[:fh, :fw], 3, True)
    anmf = ((4 // 2).to_bytes(3, "little") + (6 // 2).to_bytes(3, "little")
            + (fw - 1).to_bytes(3, "little") + (fh - 1).to_bytes(3, "little")
            + (100).to_bytes(3, "little") + b"\x00")
    sub = riff([(b"ALPH", falph), (b"VP8 ", frame)])[12:]
    files["v14_animated_offset_frame.webp"] = riff([
        (b"VP8X", vp8x(w + 6, h + 4, 0x12)), (b"ANIM", bytes(6)),
        (b"ANMF", anmf + sub)])
    # what PIL cannot set: libwebp's encoder through the C writer
    writer = {
        "v15_simple_filter.webp": (rgb, dict(filter_type=0, autofilter=0,
                                             filter_strength=60)),
        "v16_simple_sharp7.webp": (rgb, dict(
            filter_type=0, autofilter=0, filter_strength=100,
            filter_sharpness=7)),
        "v17_normal_sharp5.webp": (rgb, dict(
            filter_type=1, autofilter=0, filter_strength=100,
            filter_sharpness=5)),
        "v18_strength0.webp": (rgb, dict(autofilter=0, filter_strength=0)),
        # libwebp writes one token partition from method 3 (its token
        # buffer); methods 0-2 also write the skip probability
        "v19_partitions2.webp": (tall, dict(partitions=1, segments=2,
                                            method=2)),
        "v20_partitions4.webp": (tall, dict(partitions=2, segments=3,
                                            method=1)),
        "v21_partitions8.webp": (tall, dict(partitions=3, segments=4,
                                            method=0, filter_type=0,
                                            autofilter=0,
                                            filter_strength=40)),
        "v22_segments1.webp": (rgb, dict(segments=1, quality=40)),
        "v23_alpha_raw.webp": (rgba, dict(alpha_compression=0)),
        "v24_alpha_filter1.webp": (rgba, dict(alpha_compression=1,
                                              alpha_filtering=1)),
        "v25_alpha_filter2.webp": (rgba, dict(alpha_compression=1,
                                              alpha_filtering=2)),
        "v36_alpha_filter0.webp": (rgba, dict(alpha_compression=1,
                                              alpha_filtering=0)),
    }
    for name, (px, options) in writer.items():
        files[name] = webp_writer(px, **options)
    # the header paths libwebp's encoder never writes
    seg = vp8_of(files["v20_partitions4.webp"])
    files["v26_segment_deltas.webp"] = riff([(b"VP8 ", vp8_rewrite_header(
        seg, delta_segments=True))])
    files["v27_lf_deltas.webp"] = riff([(b"VP8 ", vp8_rewrite_header(
        plain, lf_delta=(-3, 6)))])
    # ALPH chunks of this script's: every filter, raw and compressed
    for method in range(4):
        for compressed in (False, True):
            name = (f"v{28 + 2 * method + compressed}_alph_"
                    f"{('none', 'horizontal', 'vertical', 'gradient')[method]}"
                    f"_{'vp8l' if compressed else 'raw'}.webp")
            files[name] = riff([
                (b"VP8X", vp8x(w, h, 0x10)),
                (b"ALPH", alph_chunk(alpha, method, compressed)),
                (b"VP8 ", plain)])
    files["f08_clip_lossy.webp"] = pil_bytes(Image.fromarray(clip), "WEBP",
                                             quality=75)
    return files


def libwebp_yuv(data: bytes):
    """libwebp's own Y, U and V planes of a still lossy WebP
    (``WebPDecodeYUV`` of the system's libwebp.so.7), or None where that
    library is absent or refuses the file (an animation)."""
    import ctypes
    try:
        lib = ctypes.CDLL("libwebp.so.7")
    except OSError:
        return None
    lib.WebPDecodeYUV.restype = ctypes.c_void_p
    lib.WebPDecodeYUV.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [
        ctypes.c_void_p] * 6
    lib.WebPFree.argtypes = [ctypes.c_void_p]
    w, h, stride, uv_stride = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.c_void_p(), ctypes.c_void_p()
    y = lib.WebPDecodeYUV(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(u), ctypes.byref(v),
                          ctypes.byref(stride), ctypes.byref(uv_stride))
    if not y:
        return None
    width, height = w.value, h.value
    uw, uh = (width + 1) // 2, (height + 1) // 2

    def plane(ptr, s, pw, ph):
        buf = (ctypes.c_uint8 * (s * ph)).from_address(ptr)
        return np.ctypeslib.as_array(buf).reshape(ph, s)[:, :pw].copy()
    out = (plane(y, stride.value, width, height),
           plane(u.value, uv_stride.value, uw, uh),
           plane(v.value, uv_stride.value, uw, uh))
    lib.WebPFree(ctypes.c_void_p(y))
    return out


def lossy_digests(path) -> dict:
    """A lossy WebP's digests beyond PIL's pixels: libwebp's Y / U / V
    planes (``yuv_sha256``, a still only) and PIL's alpha
    (``alpha_sha256``, a still whose ALPH chunk follows its VP8X)."""
    with open(path, "rb") as f:
        data = f.read()
    out = {}
    planes = libwebp_yuv(data)
    if planes is not None:
        out["yuv_sha256"] = [hashlib.sha256(p.tobytes()).hexdigest()
                             for p in planes]
    if data[12:16] == b"VP8X" and data[30:34] == b"ALPH":
        with Image.open(path) as im:
            a = np.asarray(im.convert("RGBA"))[..., 3]
        out["alpha_sha256"] = hashlib.sha256(a.tobytes()).hexdigest()
    return out


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



# ------------------------------------------------------- GIF and WebP writes
APP_WRITE_IMAGE = "synth_0001"       # rcr_detect -o x.gif / x.webp's still
APP_WRITE_EXTS = (".gif", ".webp")


def _read_for_writes(path: str, grey: bool) -> np.ndarray:
    with Image.open(os.path.join(os.path.dirname(HERE), path)) as im:
        return np.asarray(im.convert("L" if grey else "RGB"))


def _drawn_for_writes(path: str, points: str) -> np.ndarray:
    """``path`` drawn with ``points``' landmarks and their box as the JAX
    ``rcr_detect -o`` draws them (PIL's ImageDraw)."""
    from PIL import ImageDraw
    from superviseddescent_tpu.io.pts import read_pts_landmarks
    coords = np.asarray(read_pts_landmarks(os.path.join(
        os.path.dirname(HERE), ".synth120", points + ".pts")).coordinates,
        np.float32)
    x0, y0 = coords.min(axis=0)
    w, h = coords.max(axis=0) - (x0, y0)
    with Image.open(os.path.join(os.path.dirname(HERE), path)) as im:
        img = im.convert("RGB")
    draw = ImageDraw.Draw(img)
    for x, y in coords:
        draw.ellipse([x - 2, y - 2, x + 2, y + 2], outline=(0, 255, 0))
    draw.rectangle([x0, y0, x0 + w, y0 + h], outline=(255, 0, 0))
    return np.asarray(img)


def gif_webp_writes() -> dict:
    """PIL's GIF and WebP files of the pixels ``torch_write_inputs``'
    recipes make: per file its recipe, the pixels' shape and sha256, the
    file's size and sha256, and for a WebP the PSNR (dB) of PIL's decode
    of it against the pixels (RGB; a grey picture's RGB is its grey
    thrice). ``app_writes``: the files the JAX ``rcr_detect -o`` writes
    for ``.synth120/APP_WRITE_IMAGE`` with its ``--pts`` box, on the CPU,
    and the least distance of a drawn corner (float32, before PIL
    truncates it) to the next integer, so that a run elsewhere knows how
    far its landmarks may move before a corner does."""
    from torch_write_inputs import (GIF_WRITES, WEBP_WRITES, digest,
                                    make_pixels, psnr)
    out = {"gif_writes": [], "webp_writes": [], "app_writes": []}
    for key, table, fmt in (("gif_writes", GIF_WRITES, "GIF"),
                            ("webp_writes", WEBP_WRITES, "WEBP")):
        for name, recipe in table.items():
            px = make_pixels(recipe, _read_for_writes, _drawn_for_writes)
            data = pil_bytes(Image.fromarray(px), fmt)
            entry = dict(name=name, recipe=recipe, shape=list(px.shape),
                         pixels_sha256=digest(px.tobytes()), bytes=len(data),
                         sha256=digest(data))
            if fmt == "WEBP":
                with Image.open(io.BytesIO(data)) as im:
                    back = np.asarray(im.convert("RGB"))
                rgb = px if px.ndim == 3 else np.repeat(px[..., None], 3, 2)
                entry["psnr"] = psnr(rgb, back)
            out[key].append(entry)
    out["app_writes"] = app_writes()
    return out


def app_writes() -> list:
    import contextlib
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    from superviseddescent_tpu.apps import rcr_detect
    from superviseddescent_tpu.models import rcr
    root = os.path.dirname(HERE)
    image = os.path.join(root, ".synth120", APP_WRITE_IMAGE + ".png")
    fits = []
    fit = rcr.DetectionModel.detect

    def recording(self, img, box):
        lms = fit(self, img, box)
        fits.append(np.asarray(lms.coordinates, np.float32))
        return lms
    rcr.DetectionModel.detect = recording
    out = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for ext in APP_WRITE_EXTS:
                target = os.path.join(tmp, "out" + ext)
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = rcr_detect.main([
                        "-m", os.path.join(root, "pretrained",
                                           "rcr22_lfpw5.bin"),
                        "-i", image, "--pts", image[:-4] + ".pts",
                        "-o", target])
                assert rc == 0, ext
                with open(target, "rb") as f:
                    data = f.read()
                coords = fits[-1]
                x0, y0 = coords.min(axis=0)
                w, h = coords.max(axis=0) - (x0, y0)
                corners = np.concatenate([(coords - 2).ravel(),
                                          (coords + 2).ravel(),
                                          [x0, y0, x0 + w, y0 + h]])
                frac = np.abs(corners - np.trunc(corners))
                margin = float(np.minimum(frac, 1 - frac).min())
                out.append(dict(image=f".synth120/{APP_WRITE_IMAGE}.png",
                                ext=ext, bytes=len(data),
                                sha256=hashlib.sha256(data).hexdigest(),
                                corner_margin=margin))
    finally:
        rcr.DetectionModel.detect = fit
    return out

# ------------------------- BigTIFF, CCITT, Zstandard and YCbCr (the rest)
TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8}
# the strip and tile offsets and byte counts, re-laid as LONG8
OFFSET_TAGS = (273, 279, 324, 325)


def bigtiff(classic: bytes) -> bytes:
    """A classic TIFF's first IFD re-laid as BigTIFF in the same byte
    order: the 16-byte header, the classic file's bytes after its header
    (each offset into them moved by 8), then the IFD of 20-byte entries,
    values of up to 8 bytes inline, the strip and tile offsets and byte
    counts as LONG8."""
    e = "<" if classic[:2] == b"II" else ">"
    (ifd_at,) = struct.unpack_from(e + "I", classic, 4)
    (n,) = struct.unpack_from(e + "H", classic, ifd_at)
    body = bytearray(classic[8:])
    entries = []
    for i in range(n):
        tag, kind, count, value = struct.unpack_from(
            e + "HHI4s", classic, ifd_at + 2 + 12 * i)
        size = TYPE_SIZES[kind] * count
        raw = value[:size] if size <= 4 else classic[
            struct.unpack(e + "I", value)[0]:][:size]
        if tag in OFFSET_TAGS:
            fmt = {3: "H", 4: "I"}[kind]
            values = struct.unpack(e + fmt * count, raw)
            if tag in (273, 324):
                values = [v + 8 for v in values]
            kind, raw = 16, struct.pack(e + "Q" * count, *values)
        entries.append((tag, kind, count, raw))
    extra_at = 16 + len(body)
    extra = bytearray()
    ifd = struct.pack(e + "Q", len(entries))
    out_ifd_at = extra_at + sum(-(-len(r) // 8) * 8 for *_, r in entries
                                if len(r) > 8)
    for tag, kind, count, raw in entries:
        if len(raw) <= 8:
            ifd += struct.pack(e + "HHQ", tag, kind, count) + raw.ljust(
                8, b"\x00")
        else:
            ifd += struct.pack(e + "HHQQ", tag, kind, count,
                               extra_at + len(extra))
            extra += raw + bytes(-len(raw) % 8)
    ifd += struct.pack(e + "Q", 0)
    head = classic[:2] + struct.pack(e + "HHHQ", 43, 8, 0, out_ifd_at)[
        :14]
    return head + bytes(body) + bytes(extra) + ifd


def libtiff_file(width: int, height: int, tags: list, chunks=(),
                 rows=None, tiled=False) -> bytes:
    """A TIFF written by the system's libtiff through ctypes: ``tags``
    ((tag, ctypes values...) in order, as ``TIFFSetField`` takes them),
    then either ``chunks`` (each strip's or tile's raw bytes, which libtiff
    compresses: ``TIFFWriteEncodedStrip`` / ``Tile``) or ``rows`` (packed
    rows, ``TIFFWriteScanline``)."""
    import ctypes
    import ctypes.util
    import tempfile
    lib = ctypes.CDLL(ctypes.util.find_library("tiff"))
    lib.TIFFOpen.restype = ctypes.c_void_p
    u32 = ctypes.c_uint32
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "page.tif")
        tif = ctypes.c_void_p(lib.TIFFOpen(path.encode(), b"w"))
        assert tif.value, "libtiff cannot open " + path
        for tag, *values in [(256, u32(width)), (257, u32(height)), *tags]:
            assert lib.TIFFSetField(tif, u32(tag), *values), tag
        write = lib.TIFFWriteEncodedTile if tiled else \
            lib.TIFFWriteEncodedStrip
        for k, chunk in enumerate(chunks):
            buf = np.frombuffer(bytes(chunk), np.uint8).copy()
            assert write(tif, u32(k), buf.ctypes.data_as(ctypes.c_void_p),
                         ctypes.c_ssize_t(len(buf))) >= 0
        for y, row in enumerate([] if rows is None else rows):
            row = np.ascontiguousarray(row, np.uint8)
            assert lib.TIFFWriteScanline(
                tif, row.ctypes.data_as(ctypes.c_void_p), u32(y), 0) == 1
        lib.TIFFClose(tif)
        with open(path, "rb") as f:
            return f.read()


def t4_rows(bits: np.ndarray, eol: bool) -> bytes:
    """Bilevel rows (h, w) of 0 / 1 (1 black) coded one-dimensionally as
    T.4 (modified Huffman), each after an EOL or, with ``eol`` false,
    straight after the one before, as some writers leave them."""
    from superviseddescent_tpu_torch.io import ccitt

    def run(n, colour):
        codes = ccitt.BLACK_CODES if colour else ccitt.WHITE_CODES
        makeup = ccitt.BLACK_MAKEUP if colour else ccitt.WHITE_MAKEUP
        out = ""
        while n >= 2624:
            out += ccitt.EXTENDED_MAKEUP[-1]
            n -= 2560
        if n >= 64:
            m = n // 64
            out += makeup[m - 1] if m <= 27 else ccitt.EXTENDED_MAKEUP[m - 28]
            n -= 64 * m
        return out + codes[n]
    code = ""
    for row in bits:
        code += ccitt.EOL if eol else ""
        x, colour = 0, 0
        while x < len(row):
            end = x
            while end < len(row) and row[end] == colour:
                end += 1
            code += run(end - x, colour)
            x, colour = end, colour ^ 1
    code += "0" * (-len(code) % 8)
    return int(code, 2).to_bytes(len(code) // 8, "big")


def ycbcr_units(rgb: np.ndarray, hs: int, vs: int, rows=None,
                tile=None) -> list:
    """RGB pixels as YCbCr strips (``rows`` a strip) or tiles (``tile`` =
    width, height; zero-padded) of hs x vs units: PIL's YCbCr, each
    unit's Y samples in rows, then its Cb and Cr, the means of its
    pixels (the padding's too at a ragged edge)."""
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr")).astype(
        np.int64)
    h, w = ycc.shape[:2]
    pieces = []
    if tile:
        tw, tl = tile
        for ty in range(0, h, tl):
            for tx in range(0, w, tw):
                t = np.zeros((tl, tw, 3), np.int64)
                part = ycc[ty:ty + tl, tx:tx + tw]
                t[:part.shape[0], :part.shape[1]] = part
                pieces.append(t)
    else:
        pieces = [ycc[y0:y0 + rows] for y0 in range(0, h, rows)]
    out = []
    for p in pieces:
        ph, pw = -(-p.shape[0] // vs) * vs, -(-p.shape[1] // hs) * hs
        full = np.zeros((ph, pw, 3), np.int64)
        full[:p.shape[0], :p.shape[1]] = p
        u = full.reshape(ph // vs, vs, pw // hs, hs, 3).transpose(0, 2, 1, 3,
                                                                  4)
        y = u[..., 0].reshape(ph // vs, pw // hs, vs * hs)
        c = (u[..., 1:].reshape(ph // vs, pw // hs, vs * hs, 2).sum(axis=2)
             + vs * hs // 2) // (vs * hs)
        out.append(np.concatenate([y, c], axis=2).astype(np.uint8).tobytes())
    return out


def zstd_tiff(px: np.ndarray, rows: int, level: int, checksum=False,
              predictor=False, big_endian=False) -> bytes:
    """uint8 grey (h, w) or RGB (h, w, 3) pixels as a Zstandard-compressed
    TIFF in strips of ``rows`` rows, each strip one frame of the
    ``zstandard`` package at ``level``, as libtiff's codec stores one."""
    import zstandard
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else 3
    cctx = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    strips = []
    for y0 in range(0, h, rows):
        part = px[y0:y0 + rows].reshape(-1, w * spp)
        if predictor:
            part = predicted(part, spp)
        strips.append(cctx.compress(part.tobytes()))
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8] * spp),
            259: (3, [50000]), 262: (3, [1 if spp == 1 else 2]), 273: None,
            277: (3, [spp]), 278: (3, [rows])}
    if predictor:
        tags[317] = (3, [2])
    return tiff(strips, tags, big_endian=big_endian)


def tiff_remainder_fixtures() -> dict:
    """BigTIFF (``r0*``: PIL's own, and classic files re-laid by
    ``bigtiff``: tiles, LZW, JPEG, and big-endian Deflate, which PIL
    cannot read: it takes ``MM\\0+`` for a classic header), CCITT (``r1*``:
    PIL's three writers; libtiff's T.4 2-D with fill bits, fill order 2,
    white-is-zero, strips; one-dimensional T.4 without EOLs; widths 1, 13
    and 3,000), Zstandard (``r2*``: PIL's; the ``zstandard`` package's at
    levels 1, 3, 19 and -5, with the checksum, a strip of several 128 KiB
    blocks, predictor 2, big-endian) and YCbCr (``r3*``: PIL's 1x1 under
    LZW and Deflate; libtiff's units at 2x1, 1x2, 2x2, 4x1, 4x2 and 4x4 in
    strips and tiles with ragged edges under LZW, Deflate, PackBits and
    Zstandard; explicit YCbCrCoefficients and ReferenceBlackWhite)."""
    import ctypes
    u32, i = ctypes.c_uint32, ctypes.c_int
    rgb = small_rgb()
    grey = rgb[..., 1]
    h, w = grey.shape
    rng = np.random.default_rng(SEED + 5)
    bits = grey > 120
    tiles = [t.tobytes() for t in tiles_of(rgb, 16)]
    files = {
        "r00_bigtiff_grey_pil.tif": pil_bytes(Image.fromarray(grey), "TIFF",
                                              big_tiff=True),
        "r01_bigtiff_rgb_pil.tif": pil_bytes(Image.fromarray(rgb), "TIFF",
                                             big_tiff=True),
        "r02_bigtiff_rgb_tiles.tif": bigtiff(tiff(tiles, {
            256: (3, [w]), 257: (3, [h]), 258: (3, [8] * 3), 259: (3, [1]),
            262: (3, [2]), 277: (3, [3]), 322: (3, [16]), 323: (3, [16]),
            324: None})),
        "r03_bigtiff_rgb_lzw_predictor.tif": bigtiff(pil_bytes(
            Image.fromarray(rgb), "TIFF", compression="tiff_lzw",
            tiffinfo={317: 2, 278: 16})),
        "r04_bigtiff_grey_deflate_be.tif": bigtiff(tiff(
            [zlib.compress(grey[y0:y0 + 10].tobytes())
             for y0 in range(0, h, 10)], {
                256: (3, [w]), 257: (3, [h]), 258: (3, [8]), 259: (3, [8]),
                262: (3, [1]), 273: None, 277: (3, [1]), 278: (3, [10])},
            big_endian=True)),
        "r05_bigtiff_jpeg_ycbcr420.tif": bigtiff(jpeg_tiff(rgb, rows=16)),
        "r10_ccitt_rle_pil.tif": pil_bytes(Image.fromarray(bits), "TIFF",
                                           compression="tiff_ccitt"),
        "r11_group3_pil.tif": pil_bytes(Image.fromarray(bits), "TIFF",
                                        compression="group3"),
        "r12_group4_pil.tif": pil_bytes(Image.fromarray(bits), "TIFF",
                                        compression="group4"),
        "r1a_group3_no_eol.tif": tiff([t4_rows(bits, False)], {
            256: (3, [w]), 257: (3, [h]), 258: (3, [1]), 259: (3, [3]),
            262: (3, [0]), 273: None, 277: (3, [1]), 278: (3, [h])}),
    }
    bilevel = [(1, 3, 3, [(292, u32(5))], 8, bits),
               (1, 3, 4, [(292, u32(1)), (266, i(2))], 6, bits),
               (0, 4, 5, [(266, i(2))], 5, bits)]
    wide = np.zeros((6, 3000), bool)
    wide[1, 5:2900] = True
    wide[3, 2700:] = True
    wide[4, ::7] = True
    bilevel += [(0, 2, 6, [], 3, bits[:, :1]), (1, 4, 7, [], 4, bits[:, :13]),
                (0, 3, 8, [(292, u32(1))], 4, wide),
                (0, 4, 9, [], 2, wide[:, :2600])]
    for photometric, kind, n, extra, rows, px in bilevel:
        name = {2: "ccitt_rle", 3: "group3", 4: "group4"}[kind]
        fill = "_fill2" if any(t[0] == 266 for t in extra) else ""
        files[f"r1{n}_{name}_w{px.shape[1]}_p{photometric}{fill}.tif"] = \
            libtiff_file(px.shape[1], px.shape[0], [
                (258, i(1)), (277, i(1)), (259, i(kind)),
                (262, i(photometric)), *extra, (278, u32(rows))],
                rows=np.packbits(px, axis=1))
    long_grey = np.clip(np.kron(rng.integers(0, 256, (50, 50)),
                                np.ones((8, 8))) + rng.integers(0, 2, (400,
                                                                        400)),
                        0, 255).astype(np.uint8)
    files.update({
        "r20_zstd_grey_pil.tif": pil_bytes(Image.fromarray(grey), "TIFF",
                                           compression="zstd"),
        "r21_zstd_rgb_predictor_pil.tif": pil_bytes(
            Image.fromarray(rgb), "TIFF", compression="zstd",
            tiffinfo={317: 2}),
        "r22_zstd_level1.tif": zstd_tiff(rgb, 16, 1),
        "r23_zstd_level3_checksum.tif": zstd_tiff(grey, 47, 3,
                                                  checksum=True),
        "r24_zstd_level19.tif": zstd_tiff(rgb, 24, 19),
        "r25_zstd_level_neg5_be.tif": zstd_tiff(rgb, 10, -5,
                                                big_endian=True),
        "r26_zstd_blocks_checksum.tif": zstd_tiff(long_grey, 400, 3,
                                                  checksum=True),
        "r27_zstd_predictor2_level19.tif": zstd_tiff(rgb, 47, 19,
                                                     predictor=True),
    })
    files["r30_ycbcr11_lzw_pil.tif"] = pil_bytes(
        Image.fromarray(rgb).convert("YCbCr"), "TIFF",
        compression="tiff_lzw")
    files["r31_ycbcr11_deflate_pil.tif"] = pil_bytes(
        Image.fromarray(rgb).convert("YCbCr"), "TIFF",
        compression="tiff_adobe_deflate")
    subsampled = [((2, 1), 5, 8, None), ((1, 2), 50000, 6, None),
                  ((2, 2), 8, 10, None), ((4, 1), 32773, 9, None),
                  ((4, 2), 32773, None, (32, 16)), ((4, 4), 5, 12, None),
                  ((4, 4), 8, None, (32, 32)), ((2, 2), 50000, None,
                                                (16, 16))]
    for n, ((hs, vs), kind, rows, tile) in enumerate(subsampled, 2):
        tags = [(258, i(8)), (277, i(3)), (259, i(kind)), (262, i(6)),
                (284, i(1)), (530, i(hs), i(vs))]
        if tile:
            tags += [(322, u32(tile[0])), (323, u32(tile[1]))]
        else:
            tags.append((278, u32(rows)))
        name = {5: "lzw", 8: "deflate", 32773: "packbits", 50000: "zstd"}[
            kind]
        layout = f"tiles{tile[0]}x{tile[1]}" if tile else f"strips{rows}"
        files[f"r3{n}_ycbcr{hs}{vs}_{name}_{layout}.tif"] = libtiff_file(
            w, h, tags, ycbcr_units(rgb, hs, vs, rows, tile), tiled=bool(tile))
    files["r3a_ycbcr22_deflate_coefficients.tif"] = tiff(
        [zlib.compress(u) for u in ycbcr_units(rgb, 2, 2, 12)], {
            256: (3, [w]), 257: (3, [h]), 258: (3, [8] * 3), 259: (3, [8]),
            262: (3, [6]), 273: None, 277: (3, [3]), 278: (3, [12]),
            529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
            530: (3, [2, 2]),
            532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    return files


def clip_remainder_fixtures() -> dict:
    """The clip frame's pixels for the card's reading of the new kinds:
    BigTIFF with JPEG (PIL's JPEG-in-TIFF, ``f06``, re-laid: one J1
    launch), Zstandard (PIL's writer, predictor 2) and YCbCr 2x2 under
    LZW (libtiff's units, strips of 16 rows)."""
    import ctypes
    u32, i = ctypes.c_uint32, ctypes.c_int
    with Image.open(os.path.join(JPEG_DIR, CLIP_FRAME)) as im:
        clip = np.asarray(im.convert("RGB"))
    h, w = clip.shape[:2]
    return {
        "f09_clip_bigtiff_jpeg.tif": bigtiff(pil_bytes(
            Image.fromarray(clip), "TIFF", compression="jpeg")),
        "f10_clip_zstd.tif": pil_bytes(Image.fromarray(clip), "TIFF",
                                       compression="zstd",
                                       tiffinfo={317: 2}),
        "f11_clip_ycbcr22_lzw.tif": libtiff_file(w, h, [
            (258, i(8)), (277, i(3)), (259, i(5)), (262, i(6)), (284, i(1)),
            (530, i(2), i(2)), (278, u32(16))],
            ycbcr_units(clip, 2, 2, 16)),
    }


# the manifest's groups: each writer's files under its name
GROUPS = (bmp_fixtures, pnm_fixtures, tiff_fixtures, gif_fixtures,
          full_fixtures, tiff_kind_fixtures, tiff_more_fixtures,
          pfm_fixtures, webp_fixtures, clip_fixtures, webp_lossy_fixtures,
          tiff_remainder_fixtures, clip_remainder_fixtures)


def write_fixtures(out: str = OUT, only=None) -> dict:
    """Write every group's files and the manifest, or with ``only`` (group
    names) those groups' files, their entries updated in the manifest
    that is there."""
    os.makedirs(out, exist_ok=True)
    files, groups = {}, {}
    for group in GROUPS:
        name = group.__name__[:-len("_fixtures")]
        if only is None or name in only:
            made = group()
            files.update(made)
            groups[name] = sorted(made)
    if only is not None:
        with open(os.path.join(out, "manifest.json")) as f:
            manifest = json.load(f)
        manifest["groups"].update(groups)
        if "gif_webp_writes" in only:
            manifest.update(gif_webp_writes())
        for name, data in sorted(files.items()):
            with open(os.path.join(out, name), "wb") as f:
                f.write(data)
            manifest["files"][name] = dict(
                pil_digests(os.path.join(out, name)), bytes=len(data))
        with open(os.path.join(out, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        return manifest
    manifest = {"files": {}, "groups": groups, "jpeg_writes": jpeg_writes(),
                "crop": list(CROP), "full_image": FULL_IMAGE,
                "drawn_points": DRAWN_POINTS,
                "zlib": zlib.ZLIB_RUNTIME_VERSION}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest["files"][name] = dict(pil_digests(path), bytes=len(data))
        if name in groups["webp_lossy"]:
            manifest["files"][name].update(lossy_digests(path))
    manifest["png_tiff_writes"] = png_tiff_writes()
    manifest.update(gif_webp_writes())
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    m = write_fixtures(only=sys.argv[1:] or None)
    total = sum(v["bytes"] for v in m["files"].values())
    print(f"{len(m['files'])} files, {total} bytes, "
          f"{len(m['jpeg_writes'])} JPEG digests")
