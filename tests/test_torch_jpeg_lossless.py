"""Lossless JPEG (SOF3) in the port, on the CPU, against PIL through the
JAX package.

The port's ``load_gray_image(..., device="cpu")`` must equal the JAX
package's ``load_gray_image`` bit for bit and ``read_rgb`` PIL's
``convert("RGB")`` on every committed lossless fixture
(``tests/torch_jpeg/l*``) and on streams of the numpy writer
(``tests/torch_jpeg_coders.write_lossless``): every predictor and point
transform, restart intervals (also those that begin inside an iMCU row of
a component with two rows in it, which libjpeg-turbo resets at that iMCU
row's first row), one scan per component or interleaved, subsampled
chroma (replicated: libjpeg-turbo's lossless path has no fancy
upsampling), RGB under any ids but JFIF's or Adobe's YCbCr, CMYK,
differences that wrap modulo 2^16 and samples shifted past a byte. What
PIL refuses raises by name: no DHT (libjpeg-turbo has no default tables
for lossless), a lossless YCbCr / YCCK frame, a restart interval that is
no whole number of MCU rows, precisions other than 8 (PIL opens none of
2-7, 12, 16); damaged streams raise where PIL raises.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import jpeg
from superviseddescent_tpu_torch.io.image import read_rgb
from superviseddescent_tpu_torch.ops.jpeg import jpeg_pixels, read_jpeg
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_jpeg_coders import lossless_layout, write_lossless
from torch_jpeg_fixtures import OUT as FIXTURES
from test_torch_jpeg import manifest

LOSSLESS_STILLS = sorted(n for n in manifest()["stills"] if n[0] == "l")


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def planes(width, height, sampling, seed):
    """Smooth random planes at each component's extent."""
    rng = np.random.default_rng(seed)
    out = []
    for dh, dw in lossless_layout(width, height, sampling):
        base = rng.integers(0, 256, (dh // 4 + 1, dw // 4 + 1))
        p = np.kron(base, np.ones((4, 4)))[:dh, :dw] + rng.integers(
            -20, 21, (dh, dw))
        out.append(np.clip(p, 0, 255).astype(np.uint8))
    return out


def check_bytes(data, tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(load_gray_image(path, device="cpu"),
                                  jax_load_gray(path))
    np.testing.assert_array_equal(read_rgb(path, device="cpu"),
                                  pil_rgb(data))


@pytest.mark.parametrize("name", LOSSLESS_STILLS)
def test_fixtures_equal_jax_and_pil(name, tmp_path):
    data = open(os.path.join(FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    assert f.lossless and not f.arithmetic
    check_bytes(data, tmp_path)


@pytest.mark.parametrize("pt", [0, 2, 7])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_every_predictor_and_point_transform(predictor, pt, tmp_path):
    w, h = 23, 17
    data = write_lossless(planes(w, h, [(1, 1)], predictor), w, h,
                          predictor=predictor, pt=pt)
    check_bytes(data, tmp_path)
    data = write_lossless(planes(w, h, [(1, 1)] * 3, predictor + 7), w, h,
                          predictor=predictor, pt=pt, restart=2 * w)
    check_bytes(data, tmp_path)


LAYOUTS = [
    ([(2, 2), (1, 1), (1, 1)], None, 0),
    ([(2, 2), (1, 1), (1, 1)], None, 7),
    ([(2, 2), (1, 1), (1, 1)], [[0], [1], [2]], 13 * 7),
    ([(2, 2), (1, 1), (1, 1)], [[0], [1, 2]], 13 * 7),
    ([(1, 2), (1, 1), (1, 1)], [[0], [1], [2]], 13),
    ([(2, 1), (1, 1), (1, 1)], [[0], [1], [2]], 0),
    ([(1, 2), (2, 1), (1, 1)], None, 7),
    ([(3, 1), (1, 1), (1, 1)], None, 0),
    ([(2, 2)], None, 13),
    ([(1, 2)], None, 26),
]


@pytest.mark.parametrize("case", range(len(LAYOUTS)))
def test_sampling_scans_and_restarts(case, tmp_path):
    sampling, scans, restart = LAYOUTS[case]
    for w, h in ((13, 11), (1, 1), (2, 3)):
        if restart and w != 13:
            continue
        data = write_lossless(planes(w, h, sampling, case), w, h,
                              sampling=sampling, scans=scans,
                              restart=restart, predictor=1 + case % 7)
        check_bytes(data, tmp_path)


@pytest.mark.parametrize("ids,markers", [
    ([1, 2, 3], ()), ([82, 71, 66], ()), ([4, 5, 6], ()),
    ([1, 2, 3], ("adobe0",))])
def test_three_components_are_rgb(ids, markers, tmp_path):
    data = write_lossless(planes(19, 9, [(1, 1)] * 3, 3), 19, 9, ids=ids,
                          markers=markers, predictor=5)
    assert jpeg.parse_jpeg(data).color == jpeg.COLOR_RGB
    check_bytes(data, tmp_path)


def test_cmyk(tmp_path):
    for markers in ((), ("adobe0",)):
        data = write_lossless(planes(19, 9, [(1, 1)] * 4, 4), 19, 9,
                              markers=markers, predictor=2)
        assert jpeg.parse_jpeg(data).color == jpeg.COLOR_CMYK
        check_bytes(data, tmp_path)


def test_differences_wrap_and_samples_shift_past_a_byte(tmp_path):
    """Differences that take the samples outside [0, 2^(8 - Pt)), and the
    category 16 (32768, no extra bits): undifferenced modulo 2^16, shifted
    by Pt and kept to a byte, as libjpeg-turbo keeps them."""
    def hook(diffs):
        d = diffs[0]
        d[0, 0], d[0, 1], d[1, 0] = 200, -300, 5000
        d[2, 3], d[3, 5], d[4, 0] = -32768, -32768, 32767
    for pt in (0, 3):
        data = write_lossless(planes(12, 9, [(1, 1)], 5), 12, 9,
                              predictor=4, pt=pt, diffs_hook=hook)
        check_bytes(data, tmp_path)


def test_samples_go_to_j1s_block_layout():
    """The decoder's samples fill each component's 8 x 8 blocks of the
    MCU-padded grid; J1's samples source on a CPU tensor is the twin."""
    sampling = [(2, 2), (1, 1), (1, 1)]
    src = planes(21, 10, sampling, 9)
    data = write_lossless(src, 21, 10, sampling=sampling, predictor=1)
    f = jpeg.parse_jpeg(data)
    samples = jpeg.entropy_decode(f)
    assert samples.dtype == np.uint8 and samples.shape == (f.blocks, 64)
    for c, plane in zip(f.components, src):
        grid = samples[c.offset:c.offset + c.nbx * c.nby].reshape(
            c.nby, c.nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
                c.nby * 8, c.nbx * 8)
        np.testing.assert_array_equal(grid[:c.dh, :c.dw], plane)
        assert c.up in (jpeg.UP_FULL, jpeg.UP_BOX)
    t = torch.from_numpy(samples)
    np.testing.assert_array_equal(jpeg_pixels(t, f, 3),
                                  jpeg.pixels_reference(t, f, 3))


def refused_cases():
    p = planes(16, 8, [(1, 1)], 1)
    p3 = planes(16, 8, [(1, 1)] * 3, 2)
    p4 = planes(16, 8, [(1, 1)] * 4, 3)
    cases = {
        "no DHT": (write_lossless(p, 16, 8, table=None),
                   "Huffman table \\(0, 0\\) not defined"),
        "JFIF": (write_lossless(p3, 16, 8, markers=("jfif",)),
                 "a lossless YCbCr or YCCK frame"),
        "Adobe YCbCr": (write_lossless(p3, 16, 8, markers=("adobe1",)),
                        "a lossless YCbCr or YCCK frame"),
        "Adobe YCCK": (write_lossless(p4, 16, 8, markers=("adobe2",)),
                       "a lossless YCbCr or YCCK frame"),
        "restart not a whole row": (write_lossless(p, 16, 8, restart=24),
                                    "not a whole number of MCU rows"),
        "SOF11": (write_lossless(p, 16, 8, arithmetic=True),
                  "SOF11 \\(arithmetic lossless\\)"),
    }
    for bits in (2, 4, 6, 7, 12, 16):
        cases[f"{bits}-bit"] = (write_lossless(p, 16, 8, precision=bits),
                                f"{bits}-bit samples")
    return cases


@pytest.mark.parametrize("case", sorted(refused_cases()))
def test_what_pil_refuses_raises_by_name(case):
    data, message = refused_cases()[case]
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError, match=message):
        read_jpeg(data, 3, device="cpu")


@pytest.mark.parametrize("restart", [0, 23])
def test_damaged_streams_raise_where_pil_raises(restart):
    data = write_lossless(planes(23, 19, [(1, 1)] * 3, 5), 23, 19,
                          predictor=6, restart=restart)
    sos = data.index(b"\xff\xda")
    for cut in (sos + 6, sos + 40, len(data) // 2, len(data) - 20):
        for tail in (b"", b"\xff\xd9"):
            bad = data[:cut] + tail
            try:
                pil_rgb(bad)
            except Exception:
                with pytest.raises(ValueError, match="JPEG"):
                    read_jpeg(bad, 3, device="cpu")
    bad = bytearray(data)
    bad[sos + 20:sos + 30] = b"\xff" * 10
    with pytest.raises(ValueError, match="JPEG"):
        read_jpeg(bytes(bad), 3, device="cpu")
