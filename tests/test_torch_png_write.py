"""The port's PNG and TIFF writers byte for byte against PIL's, and the PNM
prefixes PIL takes refused by name through the public readers.

``encode_png`` is PIL's file: Pillow's per-row filter choice
(``ZipEncode.c``), its deflate settings and its IDAT chunks, for grey and
RGB at sizes from one pixel to 1024 x 768 and wider than one chunk's
buffer. A grey ``encode_tiff`` is PIL's file (no SamplesPerPixel). The
committed PNG / TIFF digests of ``tests/torch_imageio/manifest.json``
(which ``chip_smoke.py --imageio`` holds the card to) are still PIL's, and
the port writes them (``tests/test_torch_apps_io.py`` holds ``rcr_detect
-o`` to the JAX app's PNG and TIFF bytes). ``load_gray_image`` and
``read_rgb`` of PIL's ``P0`` / ``Py`` extensions raise the named refusal
(grey PFM is read: ``tests/test_torch_tiff_kinds.py``); a prefix PIL does not take (P7, PF) the generic message.
J2's reciprocal quantisation equals the division it replaces.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from superviseddescent_tpu_torch.apps import _draw
from superviseddescent_tpu_torch.io.image import read_rgb
from superviseddescent_tpu_torch.io.png import encode_png, filter_rows
from superviseddescent_tpu_torch.io.tiff import encode_tiff
from superviseddescent_tpu_torch.ops.jpeg import quant_magic
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_imageio_fixtures import (
    DRAWN_POINTS, JPEG_DIR, OUT as FIXTURES, png_stream)

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def pil_save(pixels, fmt) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, fmt)
    return buf.getvalue()


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pattern(h, w, channels, seed):
    """Ramps, flat runs and noisy patches, so every filter wins rows."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    a = (x * 3 + y * 5) % 256
    a = np.where((x // 37 + y // 23) % 3 == 0, rng.integers(0, 256, (h, w)),
                 a)
    a = np.where((y // 11) % 4 == 1, 77, a).astype(np.uint8)
    if channels == 1:
        return a
    return np.stack([a, a // 2 + 40, 255 - a], axis=-1).astype(np.uint8)


# (height, width, channels, kind): random bytes, or the pattern
PNG_CASES = [(1, 1, 1, "random"), (1, 1, 3, "random"), (9, 8, 1, "random"),
             (17, 23, 3, "random"), (40, 33, 3, "random"),
             (2, 3, 1, "pattern"), (47, 61, 3, "pattern"),
             (768, 1024, 3, "pattern"), (768, 1024, 1, "pattern"),
             (3, 17000, 3, "pattern")]


@pytest.mark.parametrize("h,w,channels,kind", PNG_CASES)
def test_encode_png_is_pils_bytes(h, w, channels, kind):
    if kind == "random":
        shape = (h, w) + ((3,) if channels == 3 else ())
        px = np.random.default_rng(h * w).integers(0, 256, shape, np.uint8)
    else:
        px = pattern(h, w, channels, h + w)
    want = pil_save(px, "PNG")
    got = encode_png(px)
    assert got == want
    if h >= 47:    # the choice was exercised, not one filter
        assert len(set(png_stream(got)[::w * channels + 1])) >= 3


def test_filter_choice_ties_keep_the_earlier_filter():
    # a flat row: None costs 128 * w, Up 0 from the second row on; a
    # ramp: Sub is 0 after the first byte (Up ties it only on row 2)
    flat = np.full((3, 6), 128, np.uint8)
    assert list(filter_rows(flat, 1)[:, 0]) == [1, 2, 2]
    zeros = np.zeros((2, 4), np.uint8)          # every sum 0: None
    assert list(filter_rows(zeros, 1)[:, 0]) == [0, 0]


@pytest.mark.parametrize("shape", [(1, 1), (5, 4), (47, 61), (768, 1024),
                                   (3, 70000)])
def test_grey_tiff_is_pils_bytes(shape):
    px = np.random.default_rng(shape[1]).integers(0, 256, shape, np.uint8)
    assert encode_tiff(px) == pil_save(px, "TIFF")
    rgb = np.repeat(px[..., None], 3, axis=2)
    assert encode_tiff(rgb) == pil_save(rgb, "TIFF")


def manifest_pixels(entry):
    """The pixels of a ``png_tiff_writes`` entry: PIL's decode of the
    JPEG (the card's J1 is held to it), or the port's drawing."""
    if entry["drawn"]:
        from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
        points = read_pts_landmarks(os.path.join(
            os.path.dirname(FIXTURES), "..", ".synth120",
            DRAWN_POINTS + ".pts"))
        coords = np.asarray(points.coordinates, np.float32)
        lo = coords.min(axis=0)
        rgb = read_rgb(os.path.join(FIXTURES, entry["source"]),
                       device="cpu").copy()
        _draw.draw_landmarks(rgb, coords)
        _draw.draw_box(rgb, (*lo, *(coords.max(axis=0) - lo)))
        return rgb
    with Image.open(os.path.join(JPEG_DIR, entry["source"])) as im:
        rgb = np.asarray(im.convert("RGB"))
    if entry["channels"] == 3:
        return rgb
    from superviseddescent_tpu_torch.ops.patches import rgb_to_gray_u8
    return rgb_to_gray_u8(rgb)


@pytest.mark.parametrize("fmt", ["PNG", "TIFF"])
def test_manifest_png_tiff_digests_are_pils_and_the_ports(fmt):
    assert MANIFEST["zlib"] == "1.2.13"
    entries = [e for e in MANIFEST["png_tiff_writes"] if e["format"] == fmt]
    assert len(entries) == 12 and sum(e["drawn"] for e in entries) == 2
    for e in entries:
        px = manifest_pixels(e)
        assert sha(pil_save(px, fmt)) == e["sha256"], e
        got = encode_png(px) if fmt == "PNG" else encode_tiff(px)
        assert sha(got) == e["sha256"] and len(got) == e["bytes"], e
        if fmt == "PNG":
            assert sha(png_stream(got)) == e["filtered_sha256"], e


PNM_REFUSED = [(b"PyCMYK\n1 1\n255\n" + bytes(4), "PyCMYK"),
               (b"P0CMYK\n1 1\n255\n" + bytes(4), "P0CMYK"),
               (b"PyP\n1 1\n255\n" + bytes(1), "PyP"),
               (b"PyRGBA\n1 1\n255\n" + bytes(4), "PyRGBA")]


@pytest.mark.parametrize("data,name", PNM_REFUSED)
def test_pnm_kinds_pil_reads_are_refused_by_name(tmp_path, data, name):
    path = tmp_path / "x.img"
    path.write_bytes(data)
    Image.open(path)                      # PIL takes the prefix
    for read in (load_gray_image, read_rgb):
        with pytest.raises(ValueError, match=f"PNM {name}.*not ported"):
            read(str(path), device="cpu")


@pytest.mark.parametrize("data", [b"P7\nWIDTH 1\nHEIGHT 1\n",
                                  b"PF\n1 1\n-1.0\n" + bytes(12)])
def test_pnm_prefixes_pil_does_not_take_are_unknown(tmp_path, data):
    path = tmp_path / "x.img"
    path.write_bytes(data)
    with pytest.raises(Exception, match="cannot identify"):
        Image.open(path)
    for read in (load_gray_image, read_rgb):
        with pytest.raises(ValueError, match="not an image format the port "
                           "reads"):
            read(str(path), device="cpu")


def test_j2_reciprocal_quantisation_equals_the_division():
    """J2 quantises |o| by d = q << 3 as ``umulhi(|o| + d / 2, magic)``
    where jcdctmgr.c divides: equal for every quantiser 1-255 and every
    |o| < 2^15. jfdctint's output, scaled by 8, is at most 64 * 128 = 8192
    in magnitude (the DC of a flat block) plus its rounding."""
    a = np.arange(1 << 15, dtype=np.uint64)
    for q in range(1, 256):
        d = q << 3
        magic = quant_magic(q)
        assert 0 < magic < 1 << 32
        n = a + (d >> 1)
        np.testing.assert_array_equal((n * np.uint64(magic)) >> np.uint64(32),
                                      n // np.uint64(d))
