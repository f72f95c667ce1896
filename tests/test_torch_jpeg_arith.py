"""Arithmetic-coded JPEG (SOF9, SOF10, DAC) and libjpeg's block smoothing
in the port, on the CPU, against PIL through the JAX package and against
libjpeg itself.

The port's ``load_gray_image(..., device="cpu")`` must equal the JAX
package's ``load_gray_image`` bit for bit and ``read_rgb`` PIL's
``convert("RGB")`` on every committed arithmetic and smoothing fixture
(``tests/torch_jpeg/a*``, ``b*``) and on streams that the system libjpeg
writes here through ``tests/torch_jpeg_writer.c`` (gcc, ``-ljpeg``;
skipped where either is missing): sequential and progressive, every
sampling, restart intervals, DAC conditioning other than T.81's
defaults, scan scripts that stop refining early. The decoder's
coefficients (before smoothing) equal libjpeg's ``jpeg_read_coefficients``;
the Qe table equals libjpeg's ``jpeg_aritab``. Damaged arithmetic streams
raise where PIL raises and read as PIL reads them where it does not:
libjpeg's arithmetic decoder feeds zeros past a marker and, after a
magnitude or index out of range, decodes nothing more until the next
restart marker.
"""

import ctypes
import ctypes.util
import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import jpeg
from superviseddescent_tpu_torch.io.image import read_rgb
from superviseddescent_tpu_torch.ops.jpeg import read_jpeg
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_jpeg_coders import Libjpeg, write_arithmetic
from torch_jpeg_fixtures import OUT as FIXTURES
from torch_jpeg_fixtures import PILS_LIBJPEG, SAMPLING, _never, _unrefined
from test_torch_jpeg import manifest

ARITH_STILLS = sorted(n for n in manifest()["stills"] if n[0] in "ab")


@pytest.fixture(scope="module")
def libjpeg(tmp_path_factory):
    """The system libjpeg behind tests/torch_jpeg_writer.c."""
    try:
        return Libjpeg(tmp_path_factory.mktemp("libjpeg"))
    except OSError as e:
        pytest.skip(f"no gcc or -ljpeg: {e}")


def pixels(shape, seed, kind):
    """Smooth blocks with noise, tinted for the colour kinds."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1))
    grey = np.kron(base, np.ones((8, 8)))[:h, :w] + rng.integers(-25, 26,
                                                                 (h, w))
    grey = np.clip(grey, 0, 255).astype(np.uint8)
    if kind == "grey":
        return grey
    return np.stack([grey, np.clip(grey * 0.8 + 30, 0, 255).astype(np.uint8),
                     255 - grey], axis=-1)


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def check_file(path):
    np.testing.assert_array_equal(load_gray_image(path, device="cpu"),
                                  jax_load_gray(path))
    np.testing.assert_array_equal(read_rgb(path, device="cpu"),
                                  np.asarray(Image.open(path).convert("RGB")))


def unsmoothed(data):
    """The decoder's coefficients before block smoothing."""
    f = jpeg.parse_jpeg(data)
    f.smooth = None
    return f, jpeg.entropy_decode(f)


@pytest.mark.parametrize("name", ARITH_STILLS)
def test_fixtures_equal_jax_and_pil(name):
    data = open(os.path.join(FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    assert f.arithmetic == (name[0] == "a" or "arith" in name)
    assert (f.smooth is not None) == (name[0] == "b")
    check_file(os.path.join(FIXTURES, name))


@pytest.mark.parametrize("name", ARITH_STILLS)
def test_fixture_coefficients_equal_libjpegs(libjpeg, name):
    data = open(os.path.join(FIXTURES, name), "rb").read()
    f, coef = unsmoothed(data)
    np.testing.assert_array_equal(coef, libjpeg.coefficients(data, f))


SWEEP = [("grey", (1, 1), {}), ("4:4:4", (13, 29), {"restart": 1}),
         ("4:2:2", (37, 29), {"restart": 4}), ("4:2:0", (33, 47), {}),
         ("4:2:0", (8, 64), {"progressive": True}),
         ("4:2:2", (40, 17), {"progressive": True, "restart": 2}),
         ("grey", (64, 9), {"progressive": True}),
         ("4:4:4", (21, 30), {"dac": {("dc", 0): (0, 0), ("dc", 1): (5, 12),
                                      ("ac", 0): 1, ("ac", 1): 63}}),
         ("4:2:0", (50, 50), {"progressive": True, "dac": {
             ("dc", 0): (3, 9), ("ac", 0): 20, ("ac", 1): 0}}),
         ("grey", (45, 61), {"dac": {("dc", 0): (15, 15),
                                     ("ac", 0): 255}})]


@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_libjpeg_streams_read_as_pil_reads_them(libjpeg, case, quality):
    kind, shape, opts = SWEEP[case]
    data = libjpeg.write(pixels(shape, case, kind), quality,
                         sampling=SAMPLING[kind], **opts)
    f, coef = unsmoothed(data)
    assert f.arithmetic and f.progressive == bool(opts.get("progressive"))
    np.testing.assert_array_equal(coef, libjpeg.coefficients(data, f))
    np.testing.assert_array_equal(read_jpeg(data, 3, device="cpu"),
                                  pil_rgb(data))


def test_the_coder_reads_its_own_encoder():
    """``write_arithmetic`` (jcarith.c's encoder in Python, no DAC segment:
    T.81's default conditioning) on a PIL file's coefficients: the port
    decodes those coefficients and PIL the same pixels."""
    from torch_jpeg_fixtures import encode
    src = jpeg.parse_jpeg(encode(pixels((40, 56), 7, "4:2:0"), "4:2:0", 90))
    coef = jpeg.entropy_decode(src)
    for restart in (0, 3):
        data = write_arithmetic(
            56, 40, [(2, 2), (1, 1), (1, 1)],
            {c.tq: c.quant for c in src.components}, coef, restart)
        f = jpeg.parse_jpeg(data)
        assert f.arithmetic and not any(s.cond != [(0, 1, 5)] * 3
                                        for s in f.scans)
        np.testing.assert_array_equal(jpeg.entropy_decode(f), coef)
        np.testing.assert_array_equal(read_jpeg(data, 3, device="cpu"),
                                      pil_rgb(data))


@pytest.mark.parametrize("script", ["never", "unrefined"])
@pytest.mark.parametrize("arithmetic", [False, True])
def test_block_smoothing_equals_pil(libjpeg, script, arithmetic):
    """Every sampling at widths and heights of 1 to 5 blocks: PIL's pixels
    (libjpeg-turbo 3.1.3); the system libjpeg 2.1.5's as well wherever no
    component is two blocks wide (2.1.5 takes the first block's DC for the
    neighbours on the right of the second) and none has a vertical
    sampling factor of 2 (2.1.5 walks such a component's rows otherwise)."""
    order = {"never": _never, "unrefined": _unrefined}[script]
    for k, (kind, shape) in enumerate([
            ("grey", (8, 8)), ("grey", (16, 9)), ("4:2:0", (33, 17)),
            ("4:2:2", (24, 40)), ("4:4:4", (9, 16)), ("4:2:0", (40, 33))]):
        n = 1 if kind == "grey" else 3
        data = libjpeg.write(pixels(shape, k, kind), 75,
                             sampling=SAMPLING[kind], arithmetic=arithmetic,
                             scans=order(n))
        f = jpeg.parse_jpeg(data)
        assert f.smooth is not None
        assert (f.smooth[:, 1:] == -1).all() == (script == "never")
        got = read_jpeg(data, 3, device="cpu").numpy()
        np.testing.assert_array_equal(got, pil_rgb(data))
        if all(c.bw != 2 and c.sv == 1 for c in f.components):
            old = libjpeg.pixels(data)
            np.testing.assert_array_equal(got, np.broadcast_to(
                old, got.shape))


def test_fully_refined_streams_are_not_smoothed(libjpeg):
    """libjpeg's smoothing_ok: every coefficient refined to bit 0, or a
    zero quantiser among the first ten, leaves the blocks alone."""
    data = libjpeg.write(pixels((32, 32), 1, "4:2:0"), 75,
                         sampling=SAMPLING["4:2:0"], progressive=True)
    assert jpeg.parse_jpeg(data).smooth is None
    data = bytearray(libjpeg.write(pixels((32, 32), 1, "grey"), 75,
                                   scans=_unrefined(1)))
    assert jpeg.parse_jpeg(bytes(data)).smooth is not None
    dqt = data.index(b"\xff\xdb")
    data[dqt + 5 + 9] = 0                 # zig-zag quantiser 9 of table 0
    assert jpeg.parse_jpeg(bytes(data)).smooth is None
    np.testing.assert_array_equal(read_jpeg(bytes(data), 3, device="cpu"),
                                  pil_rgb(bytes(data)))


def test_arith_table_equals_libjpegs():
    """ARITAB is libjpeg's jpeg_aritab (jaricom.c): the system library's
    and PIL's bundled one."""
    names = [ctypes.util.find_library("jpeg")] + glob.glob(os.path.join(
        PILS_LIBJPEG, "libjpeg-*.so*"))
    libs = []
    for name in filter(None, names):
        try:
            libs.append(ctypes.CDLL(name))
        except OSError:
            continue
    if not libs:
        pytest.skip("no libjpeg to read jpeg_aritab from")
    want = [(q << 16) | (m << 8) | (s << 7) | l for q, m, l, s in jpeg.ARITAB]
    for lib in libs:
        got = list((ctypes.c_long * 114).in_dll(lib, "jpeg_aritab"))
        assert got == want


def cut_cases(data):
    sos = data.index(b"\xff\xda")
    return [data[:cut] + tail for cut in (sos + 20, len(data) // 2,
                                          len(data) - 30)
            for tail in (b"", b"\xff\xd9")]


def flips(data, seed):
    """The stream with bytes of its entropy-coded data changed, none of
    them into 0xFF (so no marker appears)."""
    rng = np.random.default_rng(seed)
    out = bytearray(data)
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for start in scans:
        length = int.from_bytes(data[start + 2:start + 4], "big")
        begin = start + 2 + length
        end = jpeg._scan_end(data, begin)
        for _ in range(3):
            at = int(rng.integers(begin, end))
            if out[at] == 0xFF or out[at - 1] == 0xFF:
                continue
            out[at] = int(rng.integers(0, 255))
    return bytes(out)


@pytest.mark.parametrize("name", ["a07_420_q75.jpg", "a12_420_q75_restart.jpg",
                                  "a15_420_q75_prog.jpg",
                                  "b01_420_q75_arith_unrefined.jpg"])
def test_damaged_streams_raise_where_pil_raises(libjpeg, name):
    """Cut streams raise where PIL raises; where PIL reads one with
    warnings (libjpeg feeds zeros past the cut, resynchronises at a lost
    restart marker) the port refuses it as its Huffman decoder does, or
    decodes libjpeg's coefficients. Streams with bytes of their data
    changed decode (PIL reads them too) to libjpeg's coefficients, the
    error state included (their pixels may leave the DCT's range, which
    the int32 pixel stage does not hold to libjpeg's 64-bit sums)."""
    data = open(os.path.join(FIXTURES, name), "rb").read()
    for bad in cut_cases(data):
        try:
            pil_rgb(bad)
        except OSError:
            with pytest.raises(ValueError, match="JPEG"):
                read_jpeg(bad, 3, device="cpu")
            continue
        try:
            f, coef = unsmoothed(bad)
        except ValueError as e:
            assert "JPEG" in str(e)
        else:
            np.testing.assert_array_equal(coef, libjpeg.coefficients(bad, f))
    for seed in range(6):
        bad = flips(data, seed)
        pil_rgb(bad)
        read_jpeg(bad, 3, device="cpu")
        f, coef = unsmoothed(bad)
        np.testing.assert_array_equal(coef, libjpeg.coefficients(bad, f))


def test_refused_kinds_raise_by_name():
    """SOF11 (libjpeg-turbo: "Sorry, arithmetic coding is not
    implemented", PIL: broken data stream), and the differential and
    arithmetic-differential frames, by name."""
    refused = manifest()["refused"]
    sof11 = open(os.path.join(FIXTURES, "z00_sof11_grey.jpg"), "rb").read()
    assert refused["z00_sof11_grey.jpg"]["libjpeg_turbo_message"] == (
        "Sorry, arithmetic coding is not implemented")
    with pytest.raises(OSError):
        pil_rgb(sof11)
    with pytest.raises(ValueError, match="SOF11 \\(arithmetic lossless\\)"):
        read_jpeg(sof11, device="cpu")
    for marker, name in ((0xCD, "SOF13"), (0xCE, "SOF14"), (0xCF, "SOF15"),
                         (0xC5, "SOF5"), (0xC6, "SOF6"), (0xC7, "SOF7")):
        with pytest.raises(ValueError, match=name):
            read_jpeg(sof11.replace(b"\xff\xcb", bytes([0xFF, marker])),
                      device="cpu")
