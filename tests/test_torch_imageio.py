"""The port's image io (``io/image.py``, ``bmp``, ``pnm``, ``tiff``,
``gif``, ``apps/_draw``) on the CPU, against PIL and the JAX package.

Every committed fixture (``tests/torch_imageio/``, written by
``tests/torch_imageio_fixtures.py``) still matches PIL's digests in its
manifest, which ``chip_smoke.py --imageio`` holds the readers to on the
card, and the port reads it as the JAX package does: ``load_gray_image``
bit-equal to the JAX package's, ``read_rgb`` equal to PIL's
``convert("RGB")``. The manifest's JPEG digests are still PIL's files of
their pixels, and the port's CPU twins write the same bytes. The
writers: BMP, DIB, PGM, PPM and TIFF byte-equal to PIL's (PNG in
``tests/test_torch_png_write.py``); ``format_for`` is PIL's extension table for the formats ported,
a format PIL writes but the port does not is refused by name, an unknown
or missing extension raises ``ValueError`` as PIL's ``save`` does. Every
kind the readers leave out raises naming it. The rings and the box of
``apps/_draw`` are PIL's ``ImageDraw`` pixels for the same float
coordinates (hypothesis), on arrays and on tensors.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image, ImageDraw

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.apps import _draw
from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io.bmp import decode_bmp, encode_bmp
from superviseddescent_tpu_torch.io.gif import decode_gif
from superviseddescent_tpu_torch.io.jpeg_write import encode_jpeg
from superviseddescent_tpu_torch.io.pnm import decode_pnm, encode_pnm
from superviseddescent_tpu_torch.io.tiff import decode_tiff, encode_tiff
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_imageio_fixtures import OUT as FIXTURES
from torch_imageio_fixtures import JPEG_DIR, pil_digests, tiff

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# the fixtures of the BMP / PNM / TIFF / GIF readers (the TIFF kinds, PFM
# and WebP have their own tests: test_torch_tiff_kinds.py,
# test_torch_webp.py)
READER_FILES = sorted(name for group in ("bmp", "pnm", "tiff", "gif", "full")
                      for name in MANIFEST["groups"][group])


@pytest.mark.parametrize("name", READER_FILES)
def test_fixture_reads_as_the_jax_package_and_pil_do(name):
    path = os.path.join(FIXTURES, name)
    want = MANIFEST["files"][name]
    assert pil_digests(path) == {k: want[k] for k in (
        "shape", "mode", "grey_sha256", "rgb_sha256")}
    grey = load_gray_image(path, device="cpu")
    np.testing.assert_array_equal(grey, jax_load_gray(path))
    assert grey.dtype == np.float32
    rgb = imageio.read_rgb(path, device="cpu")
    np.testing.assert_array_equal(rgb, np.asarray(Image.open(path).convert(
        "RGB")))
    assert sha(rgb) == want["rgb_sha256"]


def test_manifest_jpeg_digests_are_pils_and_the_twins():
    for entry in MANIFEST["jpeg_writes"][::7]:
        rgb = np.asarray(Image.open(os.path.join(
            JPEG_DIR, entry["source"])).convert("RGB"))
        if entry["channels"] == 1:
            px = jax_load_gray(os.path.join(JPEG_DIR, entry["source"])
                               ).astype(np.uint8)
        else:
            px = rgb
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "JPEG", quality=entry["quality"], **(
            {} if entry["subsampling"] is None else
            {"subsampling": entry["subsampling"]}))
        assert hashlib.sha256(buf.getvalue()).hexdigest() == entry["sha256"]
        ours = encode_jpeg(px, entry["quality"], entry["subsampling"],
                           device="cpu")
        assert hashlib.sha256(ours).hexdigest() == entry["sha256"]


# ---------------------------------------------------------------- writers
SHAPES = [(1, 1), (2, 3), (47, 61), (5, 4), (9, 130)]


def pil_save(pixels, fmt) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels", [1, 3])
def test_writers_are_pils_bytes(shape, channels):
    rng = np.random.default_rng(shape[0] * 7 + channels)
    px = rng.integers(0, 256, shape + ((3,) if channels == 3 else ()),
                      np.uint8)
    assert encode_bmp(px) == pil_save(px, "BMP")
    assert encode_bmp(px, dib=True) == pil_save(px, "DIB")
    assert encode_pnm(px) == pil_save(px, "PPM")
    assert encode_tiff(px) == pil_save(px, "TIFF")
    back = np.asarray(Image.open(io.BytesIO(encode_tiff(px))))
    np.testing.assert_array_equal(back, px)
    for data in (encode_bmp(px), encode_pnm(px), encode_tiff(px)):
        got = imageio.decode_host(data, imageio.sniff(data))
        np.testing.assert_array_equal(got, px)


def test_pgm_header_is_pils():
    assert encode_pnm(np.zeros((2, 3), np.uint8)) == b"P5\n3 2\n255\n" + bytes(
        6)


FORMATS = [("x.png", "PNG"), ("d/x.PNG", "PNG"), ("x.apng", "PNG"),
           ("x.jpg", "JPEG"), ("d/x.JPEG", "JPEG"), ("x.jpe", "JPEG"),
           ("x.jfif", "JPEG"), ("x.bmp", "BMP"), ("x.dib", "DIB"),
           ("x.pbm", "PPM"), ("x.pgm", "PPM"), ("x.ppm", "PPM"),
           ("x.pnm", "PPM"), ("x.tif", "TIFF"), ("x.TIFF", "TIFF"),
           ("x.gif", "GIF"), ("d/x.WEBP", "WEBP")]


@pytest.mark.parametrize("name,fmt", FORMATS)
def test_format_for_is_pils_table(name, fmt):
    assert imageio.format_for(name) == fmt
    assert Image.registered_extensions()[os.path.splitext(name)[1].lower()
                                         ] == fmt


@pytest.mark.parametrize("name", ["x.qoi", "x.pcx", "x.tga", "x.jp2",
                                  "x.ico", "x.pdf"])
def test_formats_not_ported_are_refused_by_name(name, tmp_path):
    fmt = Image.registered_extensions()[os.path.splitext(name)[1]]
    with pytest.raises(ValueError, match=f"writing {fmt} .* not ported"):
        imageio.format_for(name)
    with pytest.raises(ValueError, match="not ported"):
        imageio.write_image(tmp_path / name, np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("name", ["x", "x.unknown", "x.psd"])
def test_unknown_or_missing_extensions_raise_as_pils_save(name, tmp_path):
    with pytest.raises((ValueError, KeyError)):
        Image.new("RGB", (4, 4)).save(tmp_path / name)
    with pytest.raises(ValueError):
        imageio.format_for(name)


@pytest.mark.parametrize("ext", [".png", ".jpg", ".bmp", ".dib", ".ppm",
                                 ".pgm", ".tif"])
def test_write_image_writes_the_extensions_format(tmp_path, ext):
    rgb = np.random.default_rng(3).integers(0, 256, (21, 30, 3), np.uint8)
    path = tmp_path / ("x" + ext)
    assert imageio.write_image(path, torch.from_numpy(rgb), device="cpu") == (
        imageio.format_for(path))
    with Image.open(path) as im:
        assert im.format == Image.registered_extensions()[ext]
        if ext != ".jpg":
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), rgb)
    if ext == ".jpg":
        assert path.read_bytes() == pil_save(rgb, "JPEG")


# --------------------------------------------------------------- refusals
def bmp_bytes(bits=24, compression=0, header=40, masks=None, colours=0,
              palette=b"", rows=b"\x00" * 16, width=4, height=4):
    info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bits,
                       compression, len(rows), 0, 0, colours, 0)
    info += (struct.pack("<III", *masks) if masks else b"")
    info = info.ljust(header + (12 if masks and header == 40 else 0),
                      b"\x00")
    off = 14 + len(info) + len(palette)
    return (b"BM" + struct.pack("<III", off + len(rows), 0, off) + info
            + palette + rows)


GREY16 = b"".join(bytes([i, i, i, 0]) for i in range(16))
REFUSALS = [
    (decode_bmp, bmp_bytes(compression=4), "JPEG data inside"),
    (decode_bmp, bmp_bytes(compression=5), "PNG data inside"),
    (decode_bmp, bmp_bytes(bits=2), "2 bits per pixel"),
    (decode_bmp, bmp_bytes(bits=16, compression=3, masks=(0xF00, 0xF0, 0xF)),
     "bitfields"),
    (decode_bmp, bmp_bytes(bits=4, colours=16, palette=GREY16),
     "grey ramp of 16 colours"),
    (decode_bmp, bmp_bytes(header=20), "header of 20 bytes"),
    (decode_pnm, b"P7\nWIDTH 1\n", "PAM"),
    (decode_pnm, b"PF\n1 1\n-1\n" + bytes(12), "PFM"),
    (decode_pnm, b"P5\n2 2\n255\n\x00", "truncated"),
    (decode_pnm, b"P2\n1 1\n10\n11\n", "above maxval"),
    (decode_tiff, b"II\x2b\x00" + bytes(12), "BigTIFF"),
    (decode_gif, b"GIF89a" + struct.pack("<HHBBB", 2, 2, 0, 0, 0)
     + b"\x2c" + struct.pack("<HHHHB", 0, 0, 2, 2, 0) + b"\x02\x02\x4c\x01"
     + b"\x00\x3b", "LZW data ends"),
]


def small_tiff(tags):
    """A 2 x 2 TIFF of one strip with these tags over grey 8-bit ones."""
    base = {256: (3, [2]), 257: (3, [2]), 258: (3, [8]), 259: (3, [1]),
            262: (3, [1]), 273: None, 277: (3, [1]), 278: (3, [2])}
    base.update(tags)
    return tiff([bytes(16)], base)


# the kinds still refused (each case's tags were a kind refused then that
# is read now: JPEG, CMYK, 16 and 4-bit grey, predictor 3, fill order 2,
# float samples and associated alpha)
TIFF_REFUSALS = [
    (dict({259: (3, [6])}), "JPEG compression"),
    (dict({259: (3, [4])}), "CCITT Group 4"),
    (dict({262: (3, [5]), 277: (3, [3]), 258: (3, [8] * 3)}),
     "photometric 5 \\(CMYK"),
    (dict({262: (3, [6]), 277: (3, [3]), 258: (3, [8] * 3)}),
     "photometric 6 \\(YCbCr"),
    (dict({262: (3, [3]), 258: (3, [16])}), "16,"),
    (dict({258: (3, [4]), 339: (3, [2])}), "\\(4,\\) bits"),
    (dict({259: (3, [8]), 317: (3, [3])}), "predictor 3"),
    (dict({262: (3, [0]), 266: (3, [2])}), "fill order 2"),
    (dict({258: (3, [16]), 339: (3, [3])}), "float samples"),
    (dict({277: (3, [2]), 258: (3, [8] * 2), 338: (3, [1])}),
     "associated alpha"),
]


@pytest.mark.parametrize("decode,data,match", REFUSALS)
def test_reader_refusals_are_named(decode, data, match):
    with pytest.raises(ValueError, match=match):
        decode(data)


@pytest.mark.parametrize("tags,match", TIFF_REFUSALS)
def test_tiff_refusals_are_named(tags, match):
    with pytest.raises(ValueError, match=match):
        decode_tiff(small_tiff(tags))


def test_old_style_lzw_is_refused_by_name():
    data = small_tiff({259: (3, [5])})
    data = data[:8] + b"\x00\x01" + data[10:]     # the strip's first bytes
    with pytest.raises(ValueError, match="old-style LZW"):
        decode_tiff(data)


@pytest.mark.parametrize("data,match", [
    (b"qoif\x00\x00\x00\x01", "reading QOI is not ported"),
    (b"\x00\x00\x01\x00\x01\x00", "not an image format"),       # ICO
    (b"8BPS\x00\x01", "reading PSD is not ported"),
    (b"\x01\x02\x03\x04", "not an image format")])
def test_sniff_names_what_is_not_ported(data, match):
    with pytest.raises(ValueError, match=match):
        imageio.sniff(data)


def test_read_errors_name_the_file(tmp_path):
    path = tmp_path / "bad.bmp"
    path.write_bytes(bmp_bytes(bits=2))
    with pytest.raises(ValueError, match="bad.bmp: BMP of 2 bits"):
        load_gray_image(path, device="cpu")


def test_a_bmp_delta_is_read_as_pil_reads_it():
    """PIL skips two bytes after the delta escape: both read (2, 1) from
    the bytes after them."""
    pal = b"".join(bytes([i * 40, 255 - i * 40, 7, 0]) for i in range(4))
    rle = bytes([0, 2, 0, 0, 2, 1, 2, 3, 0, 0, 4, 1, 0, 1])
    data = bmp_bytes(bits=8, compression=1, colours=4, palette=pal,
                     rows=rle, width=4, height=3)
    np.testing.assert_array_equal(
        decode_bmp(data), np.asarray(Image.open(io.BytesIO(data)).convert(
            "RGB")))


def test_16_bit_bmp_and_pnm_scaling_are_pils():
    vals = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    for masks in (None, (0xF800, 0x7E0, 0x1F)):
        data = bmp_bytes(bits=16, compression=0 if masks is None else 3,
                         masks=masks, rows=vals.astype("<u2").tobytes(),
                         width=256, height=256)
        np.testing.assert_array_equal(decode_bmp(data), np.asarray(
            Image.open(io.BytesIO(data)).convert("RGB")))
    for maxval in (1, 2, 3, 7, 100, 254, 256, 1000, 65535):
        v = np.arange(min(maxval, 300) + 1)
        for raw in (True, False):
            wide = maxval > 255
            if raw:
                body = v.astype(">u2" if wide else np.uint8).tobytes()
                data = b"P5\n%d 1\n%d\n" % (len(v), maxval) + body
            else:
                data = b"P2\n%d 1\n%d\n" % (len(v), maxval) + b" ".join(
                    b"%d" % x for x in v)
            want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
            np.testing.assert_array_equal(decode_pnm(data), want)


def test_tiff_deflate_strips_with_predictor_grey():
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (10, 7), np.uint8)
    d = np.diff(px.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
    data = tiff([zlib.compress(d.tobytes())], {
        256: (3, [7]), 257: (3, [10]), 258: (3, [8]), 259: (3, [8]),
        262: (3, [1]), 273: None, 277: (3, [1]), 278: (3, [10]),
        317: (3, [2])})
    np.testing.assert_array_equal(decode_tiff(data), px)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  px)


# ---------------------------------------------------------------- drawing
def pil_drawn(shape, coords, box):
    im = Image.new("RGB", (shape[1], shape[0]))
    draw = ImageDraw.Draw(im)
    for x, y in coords:
        draw.ellipse([x - 2, y - 2, x + 2, y + 2], outline=_draw.GREEN)
    if box is not None:
        x0, y0, w, h = box
        draw.rectangle([x0, y0, x0 + w, y0 + h], outline=_draw.RED)
    return np.asarray(im)


@settings(max_examples=200, deadline=None, database=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       coords=st.lists(st.tuples(st.floats(-8, 32, width=32),
                                 st.floats(-8, 32, width=32)),
                       min_size=1, max_size=6),
       box=st.one_of(st.none(), st.tuples(
           st.floats(-12, 30), st.floats(-12, 30), st.floats(0, 30),
           st.floats(0, 30))))
def test_drawing_is_pils(h, w, coords, box):
    coords = np.float32(coords)
    want = pil_drawn((h, w), coords, box)
    got = np.zeros((h, w, 3), np.uint8)
    _draw.draw_landmarks(got, coords)
    if box is not None:
        _draw.draw_box(got, box)
    np.testing.assert_array_equal(got, want)
    tensor = torch.zeros((h, w, 3), dtype=torch.uint8)
    _draw.draw_landmarks(tensor, coords)
    if box is not None:
        _draw.draw_box(tensor, box)
    np.testing.assert_array_equal(tensor.numpy(), want)


def test_ring_boxes_near_zero_take_every_size():
    """Truncation toward zero makes 3- and 4-pixel ring boxes; float32
    rounding of x + 2 can make 5."""
    sizes = set()
    for x in np.arange(-6, 6, 1 / 64, dtype=np.float32):
        x0, x1 = int(float(x - np.float32(2))), int(float(x + np.float32(2)))
        sizes.add(x1 - x0)
    assert sizes == {3, 4}
    x = np.float32(6) - np.float32(2) ** -22     # x + 2 rounds up to 8
    coords = np.float32([[x, 10.0]])
    np.testing.assert_array_equal(
        _draw.ring_pixels(coords)[1].max() - _draw.ring_pixels(coords)[1].min(),
        int(float(x + np.float32(2))) - int(float(x - np.float32(2))))
    got = np.zeros((16, 16, 3), np.uint8)
    _draw.draw_landmarks(got, coords)
    np.testing.assert_array_equal(got, pil_drawn((16, 16), coords, None))


def test_annotate_writes_pils_file(tmp_path):
    rgb = np.random.default_rng(9).integers(0, 256, (40, 50, 3), np.uint8)
    src = tmp_path / "in.bmp"
    Image.fromarray(rgb).save(src)
    coords = np.float32([[10.3, 12.7], [40.5, 30.25]])
    box = (5.5, 6.25, 30.0, 25.5)
    for ext in (".jpg", ".png", ".ppm", ".bmp", ".tif", ".gif", ".webp"):
        out = tmp_path / ("out" + ext)
        assert _draw.annotate(src, out, coords, box, device="cpu") == str(out)
        im = Image.open(src).convert("RGB")
        draw = ImageDraw.Draw(im)
        for x, y in coords:
            draw.ellipse([x - 2, y - 2, x + 2, y + 2], outline=_draw.GREEN)
        draw.rectangle([box[0], box[1], box[0] + box[2], box[1] + box[3]],
                       outline=_draw.RED)
        ref = tmp_path / ("ref" + ext)
        im.save(ref)
        assert out.read_bytes() == ref.read_bytes(), ext
        np.testing.assert_array_equal(np.asarray(Image.open(out).convert(
            "RGB")), np.asarray(Image.open(ref).convert("RGB")))
    with pytest.raises(ValueError, match="QOI"):
        _draw.annotate(src, tmp_path / "out.qoi", coords, device="cpu")
    assert not (tmp_path / "out.qoi").exists()
