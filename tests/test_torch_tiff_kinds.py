"""Every TIFF kind PIL reads, JPEG-in-TIFF and PFM, on the CPU, against
PIL and the JAX package.

``io/tiff.OPEN_INFO`` is PIL 12.1's ``TiffImagePlugin.OPEN_INFO``. Every
key has a fixture (``tests/torch_imageio/k*.tif``, written by
``tests/torch_imageio_fixtures.py``); with the compressed kinds (``c*``),
JPEG-compressed TIFFs (``j*``, ``f05``-``f07``) and PFM (``n11``-``n13``), each
still matches PIL's digests in the manifest and reads as the JAX package
reads it: ``load_gray_image`` bit-equal to the JAX package's, ``read_rgb``
equal to PIL's ``convert("RGB")`` (CIELab through the port's copy of
LittleCMS's transform). A kind PIL cannot read raises here as it does
there. A JPEG-compressed page decodes through J1's plain twin in
at most two calls of ``jpeg_pixels`` (the full-size strips as one batch,
and the short last strip). Every kind still refused raises naming it.
"""

import hashlib
import io
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io.cielab import lab_to_rgb
from superviseddescent_tpu_torch.io.jpeg import (
    entropy_decode, parse_jpeg, pixels_reference)
from superviseddescent_tpu_torch.io.pnm import decode_pnm
from superviseddescent_tpu_torch.io.tiff import (
    OPEN_INFO, decode_tiff, jpeg_chunks)
from superviseddescent_tpu_torch.ops import jpeg as jpeg_ops
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, rgb_to_gray_u8)
from torch_imageio_fixtures import OUT as FIXTURES
from torch_imageio_fixtures import jpeg_tiff, pil_digests, small_rgb, tiff

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
KIND_FILES = sorted(name for group in ("tiff_kind", "tiff_more", "pfm")
                    for name in MANIFEST["groups"][group])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """J1's twin runs some 10^5 small operations a page: beside other test
    workers, each operation's thread pool oversubscribes the cores (a
    768 x 1024 page on 8 cores: 1.3 s alone, 30 s as one of six
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_open_info_is_pils():
    assert OPEN_INFO == TiffImagePlugin.OPEN_INFO


def test_every_open_info_key_has_a_fixture():
    names = MANIFEST["groups"]["tiff_kind"]
    assert len(names) == len(TiffImagePlugin.OPEN_INFO) == 120
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            Image.open(f)               # the tags, even where PIL fails later


@pytest.mark.parametrize("name", KIND_FILES)
def test_kind_reads_as_the_jax_package_and_pil_do(name):
    path = os.path.join(FIXTURES, name)
    want = MANIFEST["files"][name]
    got = pil_digests(path)
    assert got == {k: want[k] for k in got}
    if "pil_error" in want:              # PIL cannot read it: neither can we
        with pytest.raises(ValueError, match="not a kind PIL reads"):
            load_gray_image(path, device="cpu")
        return
    grey = load_gray_image(path, device="cpu")
    np.testing.assert_array_equal(grey, jax_load_gray(path))
    rgb = imageio.read_rgb(path, device="cpu")
    with Image.open(path) as im:
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))
    assert sha(rgb) == want["rgb_sha256"]


def count_j1(monkeypatch):
    calls = []
    real = jpeg_ops.jpeg_pixels

    def counted(coef, f, channels=1, tile=None):
        calls.append(tuple(coef.shape))
        return real(coef, f, channels, tile)
    monkeypatch.setattr(jpeg_ops, "jpeg_pixels", counted)
    return calls


def check_clip_page(monkeypatch, name, batches):
    """A 768 x 1024 JPEG-in-TIFF of the clip frame: J1's twin called once
    per batch (its sizes ``batches``), PIL's digests in grey and RGB."""
    calls = count_j1(monkeypatch)
    want = MANIFEST["files"][name]
    data = open(os.path.join(FIXTURES, name), "rb").read()
    rgb = jpeg_ops.read_tiff_jpeg(data, 3, "cpu").numpy()
    assert [c[0] for c in calls] == batches
    assert sha(rgb) == want["rgb_sha256"]
    assert sha(rgb_to_gray_u8(rgb)) == want["grey_sha256"]


def test_clip_jpeg_tiff_in_two_j1_calls(monkeypatch):
    """The worst case: 12 strips of 80 rows and one of 64, one batch of 12
    and the last strip."""
    check_clip_page(monkeypatch, "f05_clip_ycbcr420.tif", [12, 1])


@pytest.mark.parametrize("name,batches", [
    ("f06_clip_rgb_pil.tif", [32]),
    ("f07_clip_ycbcr420_libtiff.tif", [64])])
def test_clip_jpeg_tiff_as_writers_lay_it_out(monkeypatch, name, batches):
    """PIL's writer (RGB, 32 strips of 32 rows) and libtiff's (YCbCr
    4:2:0, 64 strips of 16 rows): every strip full, one batch."""
    check_clip_page(monkeypatch, name, batches)


@pytest.mark.parametrize("name,calls", [
    ("j03_ycbcr420_strips.tif", [2, 1]), ("j04_ycbcr420_tiles.tif", [6]),
    ("j00_rgb_strips_pil.tif", [2, 1]), ("j06_grey_tiles.tif", [12])])
def test_jpeg_tiff_batches(monkeypatch, name, calls):
    """Full strips or tiles in one batch, the short last strip alone; the
    batch's pixels equal each strip decoded on its own."""
    seen = count_j1(monkeypatch)
    data = open(os.path.join(FIXTURES, name), "rb").read()
    for channels in (1, 3):
        seen.clear()
        jpeg_ops.read_tiff_jpeg(data, channels, "cpu")
        assert [s[0] for s in seen] == calls
    page = jpeg_chunks(data)
    f = parse_jpeg(page.streams[0])
    coef = torch.stack([torch.from_numpy(entropy_decode(parse_jpeg(s)))
                        for s in page.streams[:calls[0]]])
    batch = pixels_reference(coef, f, 3)
    for k in range(calls[0]):
        assert torch.equal(batch[k], pixels_reference(coef[k], f, 3))


def test_jpeg_tiff_big_endian_and_odd_sizes():
    rng = np.random.default_rng(3)
    px = np.clip(np.cumsum(rng.integers(0, 40, (37, 29, 3)), axis=1) % 256,
                 0, 255).astype(np.uint8)
    for kw in (dict(rows=16), dict(rows=8, subsampling="4:2:2"),
               dict(tile=(16, 16), subsampling="4:4:4", big_endian=True)):
        data = jpeg_tiff(px, **kw)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(
            jpeg_ops.read_tiff_jpeg(data, 3, "cpu").numpy(), want)


def small(tags, data=bytes(16), width=2, height=2):
    base = {256: (3, [width]), 257: (3, [height]), 258: (3, [8]),
            259: (3, [1]), 262: (3, [1]), 273: None, 277: (3, [1]),
            278: (3, [height])}
    base.update(tags)
    return tiff([data], base)


# CCITT, Zstandard and YCbCr under Deflate are read since they were
# refused here: their cases now hold what stays refused of each (CCITT of
# 8-bit samples, a strip with no Zstandard frame, a YCbCr subsampling
# libtiff's RGBA reader does not put)
REFUSED = [
    ({259: (3, [2])}, "CCITT RLE compression of 1 8-bit samples is not a "
     "kind PIL reads"),
    ({259: (3, [3])}, "CCITT Group 3 compression of 1 8-bit samples is not "
     "a kind PIL reads"),
    ({259: (3, [4])}, "CCITT Group 4 compression of 1 8-bit samples is not "
     "a kind PIL reads"),
    ({259: (3, [6])}, "old-style JPEG compression is not ported"),
    ({259: (3, [7])}, "JPEG compression is not decoded on the host"),
    ({259: (3, [50000])}, "Zstandard: no frame"),
    ({259: (3, [50001])}, "WebP compression is not ported"),
    ({262: (3, [9]), 277: (3, [3]), 258: (3, [8] * 3)},
     "photometric 9 \\(ICCLab\\).*not a kind PIL reads"),
    ({262: (3, [6]), 277: (3, [3]), 258: (3, [8] * 3), 259: (3, [8]),
      530: (3, [2, 4])}, "YCbCr subsampling 2 x 4 is not a kind PIL reads"),
    ({262: (3, [2]), 277: (3, [4]), 258: (3, [8] * 4), 338: (3, [1]),
      284: (3, [2])}, "planar configuration 2"),
    ({259: (3, [8]), 317: (3, [2]), 258: (3, [4])}, "predictor 2 on 4-bit"),
    ({259: (3, [8]), 317: (3, [4])}, "predictor 4 is not ported"),
]


@pytest.mark.parametrize("tags,match", REFUSED)
def test_tiff_kinds_still_refused_by_name(tags, match):
    with pytest.raises(ValueError, match=match):
        decode_tiff(small(tags))


def test_bigtiff_and_colour_pfm_refused_by_name():
    with pytest.raises(ValueError, match="BigTIFF"):
        decode_tiff(b"MM\x00\x2b" + bytes(12))
    with pytest.raises(ValueError, match="PFM \\(PF, colour"):
        decode_pnm(b"PF\n1 1\n-1\n" + bytes(12))
    with pytest.raises(ValueError, match="finite and non-zero"):
        decode_pnm(b"Pf\n1 1\n0\n" + bytes(4))


def test_cielab_is_littlecms_transform():
    """``lab_to_rgb`` against PIL's LAB -> RGB (LittleCMS) on the grid's
    corners and edges and random samples (every one of the 2^24 inputs
    agreed with the PIL that wrote the fixtures)."""
    rng = np.random.default_rng(11)
    edges = np.array([0, 1, 7, 8, 127, 128, 129, 247, 248, 254, 255])
    grid = np.stack(np.meshgrid(edges, edges, edges, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    lab = np.concatenate([grid, rng.integers(0, 256, (20000, 3))]).astype(
        np.uint8)
    im = Image.frombytes("LAB", (len(lab), 1), lab.tobytes(), "raw", "LAB")
    np.testing.assert_array_equal(lab_to_rgb(lab),
                                  np.asarray(im.convert("RGB"))[0])


def test_lzma_needs_the_module(monkeypatch):
    import lzma
    data = small({259: (3, [34925])}, lzma.compress(bytes(range(4))))
    assert decode_tiff(data).tolist() == [[0, 1], [2, 3]]
    monkeypatch.setitem(sys.modules, "lzma", None)
    with pytest.raises(ValueError, match="lzma module"):
        decode_tiff(data)


def test_predictor_ignored_where_libtiff_ignores_it():
    """PackBits and uncompressed strips keep their bytes under predictor
    2, as PIL reads them; Deflate undoes it."""
    rgb = small_rgb()[:9, :11]
    raw = rgb.tobytes()
    tags = {256: (3, [11]), 257: (3, [9]), 258: (3, [8] * 3), 262: (3, [2]),
            273: None, 277: (3, [3]), 278: (3, [9]), 317: (3, [2])}
    for kind, chunk in ((1, raw), (8, zlib.compress(raw))):
        data = tiff([chunk], {**tags, 259: (3, [kind])})
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_tiff(data), want)
