"""The port's JPEG writer (``io/jpeg_write.py``, ``ops/jpeg.py``) on the
CPU, against PIL's ``save(format="JPEG")`` (libjpeg-turbo).

``encode_jpeg(..., device="cpu")`` runs both plain twins: the PyTorch
pixel stage of kernel J2 (``coefficients_reference``) and the numpy
Huffman coder (``entropy_encode``). Its files must be PIL's byte for
byte: grey (one component) and RGB at 4:4:4, 4:2:2 and 4:2:0, every
quality of 1, 10, 25, 50, 75, 90, 95 and 100, every size from 1 x 1 to
33 x 33 (each rule of libjpeg's edge replication and dummy blocks: a
block past ``width_in_blocks`` or below ``height_in_blocks`` in an
interleaved MCU), the pixels of the committed JPEG stills, and random
pixels from hypothesis. The twin's coefficients equal what
``io/jpeg.entropy_decode`` reads back from PIL's file, dummy blocks
included, and J2's geometry (``ops/jpeg.coefficient_params``) describes
the same layout. The host C++ coder of ``csrc/jpeg_encode.cu`` (its host
half, built with g++ where the compiler is installed) writes the twin's
bytes. Every option PIL offers that the port does not is refused by name,
and a write with no card and no device raises.
"""

import ctypes
import io
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image

from superviseddescent_tpu_torch.io import jpeg, jpeg_write
from superviseddescent_tpu_torch.io.jpeg_write import (
    block_map, coefficients_reference, encode_jpeg, entropy_encode, layout)
from superviseddescent_tpu_torch.ops.jpeg import (
    coefficient_params, huffman_encode_native, jpeg_coefficients,
    quant_magic, write_jpeg)
from torch_jpeg_fixtures import OUT as JPEG_FIXTURES

QUALITIES = (1, 10, 25, 50, 75, 90, 95, 100)
KINDS = ("grey", "4:4:4", "4:2:2", "4:2:0")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "superviseddescent_tpu_torch", "csrc", "jpeg_encode.cu")


def pil_jpeg(pixels, quality=None, kind=None) -> bytes:
    options = {} if quality is None else {"quality": quality}
    if kind not in (None, "grey"):
        options["subsampling"] = kind
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **options)
    return buf.getvalue()


def port_jpeg(pixels, quality=75, kind=None) -> bytes:
    sub = None if kind in (None, "grey") else kind
    return encode_jpeg(pixels, quality, sub, device="cpu")


def pixels_of(kind, rgb):
    return np.ascontiguousarray(rgb[..., 1]) if kind == "grey" else rgb


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", KINDS)
def test_every_quality_and_kind_is_pils_bytes(kind, quality):
    rng = np.random.default_rng(quality)
    for shape in ((37, 53), (64, 48), (9, 130)):
        rgb = rng.integers(0, 256, shape + (3,), np.uint8)
        px = pixels_of(kind, rgb)
        assert port_jpeg(px, quality, kind) == pil_jpeg(px, quality, kind)


def test_defaults_are_pils():
    rgb = np.random.default_rng(1).integers(0, 256, (21, 34, 3), np.uint8)
    assert encode_jpeg(rgb, device="cpu") == pil_jpeg(rgb)
    assert encode_jpeg(rgb[..., 0].copy(), device="cpu") == pil_jpeg(
        rgb[..., 0].copy())
    assert encode_jpeg(torch.from_numpy(rgb), device="cpu") == pil_jpeg(rgb)


@pytest.mark.parametrize("height", range(1, 34))
def test_every_size_to_33_is_pils_bytes(height):
    """Every width 1..33 at this height, in every kind, the quality
    cycling through QUALITIES."""
    rng = np.random.default_rng(height)
    for width in range(1, 34):
        rgb = rng.integers(0, 256, (height, width, 3), np.uint8)
        for k, kind in enumerate(KINDS):
            quality = QUALITIES[(width + k) % len(QUALITIES)]
            px = pixels_of(kind, rgb)
            assert port_jpeg(px, quality, kind) == pil_jpeg(
                px, quality, kind), (height, width, kind, quality)


def still_pixels():
    names = ("s01_444_q95.jpg", "s03_420_q75.jpg", "s06_422_q75_odd.jpg")
    return [np.asarray(Image.open(os.path.join(JPEG_FIXTURES, n)).convert(
        "RGB")) for n in names]


@pytest.mark.parametrize("quality", (50, 75, 95))
@pytest.mark.parametrize("kind", KINDS)
def test_committed_stills_are_pils_bytes(kind, quality):
    for rgb in still_pixels():
        px = pixels_of(kind, rgb)
        assert port_jpeg(px, quality, kind) == pil_jpeg(px, quality, kind)


@settings(max_examples=40, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**31),
       kind=st.sampled_from(KINDS), quality=st.integers(1, 100),
       smooth=st.booleans())
def test_random_pixels_are_pils_bytes(h, w, seed, kind, quality, smooth):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    if smooth:      # long zero runs (ZRL) and large DC steps
        rgb = np.cumsum(rgb // 64, axis=1).astype(np.uint8)
    px = pixels_of(kind, rgb)
    assert port_jpeg(px, quality, kind) == pil_jpeg(px, quality, kind)


@pytest.mark.parametrize("shape,kind", [((17, 17), "4:2:0"),
                                        ((33, 9), "4:2:0"),
                                        ((9, 23), "4:2:2"),
                                        ((16, 40), "4:4:4"),
                                        ((11, 29), "grey")])
def test_coefficients_equal_pils_dummy_blocks_included(shape, kind):
    rng = np.random.default_rng(sum(shape))
    rgb = rng.integers(0, 256, shape + (3,), np.uint8)
    px = pixels_of(kind, rgb)
    f = jpeg.parse_jpeg(pil_jpeg(px, 75, kind))
    decoded = jpeg.entropy_decode(f)
    lay = layout(*shape, px.ndim if px.ndim == 3 else 1, 75,
                 None if kind == "grey" else kind)
    bm = block_map(lay)
    at = [f.components[c].offset + by * f.components[c].nbx + bx
          for c, by, bx, _, _ in bm]
    got = coefficients_reference(torch.from_numpy(px), lay).numpy()
    np.testing.assert_array_equal(got, decoded[at])
    dummy = (bm[:, 1] != bm[:, 3]) | (bm[:, 2] != bm[:, 4])
    if kind == "4:2:0" and shape == (17, 17):
        # the rule's example: a Y grid of 3 x 3 real blocks in 2 x 2 MCUs
        y_dc = np.zeros((4, 4), np.int64)
        y = bm[:, 0] == 0
        y_dc[bm[y, 1], bm[y, 2]] = got[y, 0]
        assert (y_dc[:, 3] == y_dc[:, 2]).all()
        assert (y_dc[3, :2] == y_dc[2, 1]).all()
        assert (y_dc[3, 2:] == y_dc[2, 2]).all()
    assert (got[dummy, 1:] == 0).all() and dummy.any() == (kind != "grey"
                                                          and kind != "4:4:4")


def test_the_kernels_geometry_is_the_layout():
    lay = layout(17, 21, 3, 50, "4:2:0")
    geom, quant = coefficient_params(lay)
    assert list(geom[:8]) == [3, 21, 17, 3, 2, 2, 6, 24]
    assert list(geom[8:17]) == [2, 2, 3, 3, 1, 1, 17, 0, 0]     # Y
    assert list(geom[17:26]) == [1, 1, 2, 2, 2, 2, 8, 4, 1]     # Cb
    assert list(geom[35:]) == [8, 384, 2, 2]    # strip, threads, MCU
    np.testing.assert_array_equal(quant[0], lay.quant)
    np.testing.assert_array_equal(quant[1], np.vectorize(quant_magic)(
        lay.quant))
    grey = coefficient_params(layout(5, 7, 1))[0]
    assert list(grey[:8]) == [1, 7, 5, 1, 1, 1, 1, 1]
    assert list(grey[35:]) == [32, 256, 1, 1]


def test_jpeg_coefficients_takes_the_twin_on_the_cpu():
    rgb = np.random.default_rng(2).integers(0, 256, (13, 27, 3), np.uint8)
    lay = layout(13, 27, 3)
    t = torch.from_numpy(rgb)
    before = jpeg_coefficients.launches
    assert torch.equal(jpeg_coefficients(t, lay),
                       coefficients_reference(t, lay))
    assert jpeg_coefficients.launches == before


@pytest.fixture(scope="module")
def host_coder(tmp_path_factory):
    """The host half of csrc/jpeg_encode.cu built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host coder")
    lib = tmp_path_factory.mktemp("coder") / "libjpeg_coder.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-DJPEG_ENCODE_HOST_ONLY", "-o", str(lib), CSRC],
                   check=True)
    coder = ctypes.CDLL(str(lib))
    coder.jpeg_huffman_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_int]
    return coder


@pytest.mark.parametrize("kind", KINDS)
def test_host_coder_writes_the_twins_bytes(host_coder, kind):
    rng = np.random.default_rng(7)
    for shape, quality in (((45, 61), 1), ((17, 17), 75), ((64, 80), 100)):
        rgb = rng.integers(0, 256, shape + (3,), np.uint8)
        px = pixels_of(kind, rgb)
        lay = layout(*shape, 3 if px.ndim == 3 else 1, quality,
                     None if kind == "grey" else kind)
        coef = coefficients_reference(torch.from_numpy(px), lay)
        scan = huffman_encode_native(coef, lay, library=host_coder)
        assert scan == entropy_encode(coef.numpy(), lay)
        assert jpeg_write.assemble(lay, scan) == pil_jpeg(px, quality, kind)


@pytest.mark.parametrize("option", sorted(jpeg_write.REFUSED_OPTIONS))
def test_pils_other_options_are_refused_by_name(option):
    px = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="not ported"):
        encode_jpeg(px, device="cpu", **{option: True})


@pytest.mark.parametrize("args,match", [
    (dict(subsampling="4:1:1"), "subsampling '4:1:1' is not ported"),
    (dict(quality=0), "quality 0"), (dict(quality=101), "quality 101"),
    (dict(quality=75.5), "quality 75.5"),
    (dict(bogus=1), "unknown option bogus")])
def test_other_arguments_are_refused(args, match):
    with pytest.raises(ValueError, match=match):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8), device="cpu", **args)


@pytest.mark.parametrize("pixels,match", [
    (np.zeros((8, 8), np.float32), "uint8"),
    (np.zeros((8, 8, 4), np.uint8), "grey"),
    (np.zeros((0, 8, 3), np.uint8), "outside 1..65535")])
def test_pixels_it_cannot_write_are_refused(pixels, match):
    with pytest.raises(ValueError, match=match):
        encode_jpeg(pixels, device="cpu")


def test_grey_subsampling_is_refused_by_name():
    with pytest.raises(ValueError, match="subsampling of a grey image"):
        encode_jpeg(np.zeros((8, 8), np.uint8), 75, "4:2:0", device="cpu")


def test_no_card_and_no_device_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8))
    path = tmp_path / "x.jpg"
    write_jpeg(path, np.zeros((8, 8, 3), np.uint8), device="cpu")
    assert path.read_bytes() == pil_jpeg(np.zeros((8, 8, 3), np.uint8))
