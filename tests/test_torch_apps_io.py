"""The apps' io and ``rcr_detect``, the port against the JAX package, on
the CPU.

io: ``load_mean``, ``read_landmarks_list_to_train`` and
``read_ied_definition`` equal JAX's on the files the app tests write
(``torch_apps_helpers.write_config_files``), and a malformed file raises
the same exception in both; ``write_png`` round-trips bit-equal through the
port's ``read_png`` and through PIL; the drawing helper of ``-o``.

``rcr_detect`` with pretrained RCR-22 on one ``.synth120`` image, the box
from ``--facebox``, ``--pts`` or the face detector (``-f``, the carried
stock cascade): the landmarks within 1e-3 px of JAX's
(``tests/test_torch_rcr.py``). The app prints them to two decimals, so
the test records the unrounded coordinates ``DetectionModel.detect``
returns in each package, holds the two within 1e-3, and holds each
printed line to its own package's coordinates within half a print step.
``rcr_detect -o out.png``, ``-o out.gif`` and ``-o out.webp`` write the
JAX app's bytes, and ``-o out.tif`` PIL's TIFF of the same drawing; from a lossy WebP (``-i still.webp``), an
arithmetic-coded progressive JPEG (SOF10), a lossless one (SOF3) and a
JPEG 2000 file of either transform (``-i still.jp2``) the landmarks and
the drawn PNG are the JAX app's too.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from superviseddescent_tpu import io as jax_io
from superviseddescent_tpu.apps import rcr_detect as jax_detect
from superviseddescent_tpu.models import rcr as jax_rcr
from superviseddescent_tpu_torch import io as port_io
from superviseddescent_tpu_torch.apps import _draw, rcr_detect
from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
from superviseddescent_tpu_torch.io.png import encode_png, read_png, write_png
from superviseddescent_tpu_torch.models import rcr as port_rcr
from torch_apps_helpers import (  # noqa: F401 (one_torch_thread)
    PRETRAINED, SYNTH, detect_lines, one_torch_thread, record_detect,
    run_app, write_config_files)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
EXACT_PX = 1e-3
IMAGE = "synth_0001"         # the 300 x 450 class


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_config_files(str(tmp_path_factory.mktemp("apps_io")))


def test_config_readers_equal_jax(files):
    mean, config, evaluation = files
    got, want = port_io.load_mean(mean), jax_io.load_mean(mean)
    assert got.dtype == want.dtype == np.float32 and got.shape == (136,)
    np.testing.assert_array_equal(got, want)
    ids = port_io.read_landmarks_list_to_train(config)
    assert ids == jax_io.read_landmarks_list_to_train(config)
    assert len(ids) == 22
    eyes = port_io.read_ied_definition(evaluation)
    assert eyes == jax_io.read_ied_definition(evaluation)
    assert eyes == (["37", "40"], ["43", "46"])
    text = open(config).read()
    assert port_io.parse_info(text) == jax_io.parse_info(text)


@pytest.mark.parametrize("reader,content,error", [
    ("load_mean", "0.1,0.2,abc\n", ValueError),
    ("read_landmarks_list_to_train", "other\n{\n a 1\n}\n", KeyError),
    ("read_landmarks_list_to_train",
     "modelLandmarks\n{\n landmarks all\n}\n", NotImplementedError),
    ("read_landmarks_list_to_train",
     "modelLandmarks\n{\n landmarks some\n}\n", ValueError),
    ("read_ied_definition", "interEyeDistance\n{\n rightEye \"37\"\n}\n",
     KeyError),
    ("read_ied_definition", "interEyeDistance\n{\n rightEye \"37\n}\n",
     ValueError),
])
def test_malformed_files_raise_alike(tmp_path, reader, content, error):
    path = tmp_path / "bad.txt"
    path.write_text(content)
    with pytest.raises(error) as want:
        getattr(jax_io, reader)(str(path))
    with pytest.raises(error) as got:
        getattr(port_io, reader)(str(path))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (31, 17, 3), (2, 9, 3)])
def test_write_png_round_trips(tmp_path, shape):
    pixels = np.random.default_rng(len(shape)).integers(
        0, 256, size=shape).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(path, pixels)
    back = read_png(path)
    np.testing.assert_array_equal(back.reshape(shape), pixels)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), pixels)
    with open(path, "rb") as f:
        assert f.read() == encode_png(pixels)


@pytest.mark.parametrize("pixels", [np.zeros((2, 2), np.float32),
                                    np.zeros((2, 2, 4), np.uint8),
                                    np.zeros((0, 3), np.uint8)])
def test_write_png_refuses_what_it_cannot_write(pixels):
    with pytest.raises(ValueError):
        encode_png(pixels)


def test_drawing_marks_rings_and_box():
    """The rings and the box are PIL's ImageDraw pixels, as the JAX app
    draws them: a ring per landmark (one off the image's corner, one with
    a non-finite coordinate that draws nothing), then the box."""
    from PIL import ImageDraw
    coords = np.float32([[10.4, 9.6], [0.0, 0.0], [np.nan, 3.0]])
    box = (3.0, 4.0, 10.0, 40.0)
    rgb = np.zeros((20, 30, 3), np.uint8)
    _draw.draw_landmarks(rgb, coords)
    _draw.draw_box(rgb, box)
    want = Image.new("RGB", (30, 20))
    draw = ImageDraw.Draw(want)
    for x, y in coords:
        draw.ellipse([x - 2, y - 2, x + 2, y + 2], outline=_draw.GREEN)
    x0, y0, w, h = box
    draw.rectangle([x0, y0, x0 + w, y0 + h], outline=_draw.RED)
    np.testing.assert_array_equal(rgb, np.asarray(want))
    green = (rgb == _draw.GREEN).all(axis=2)
    # the ring of (10.4, 9.6) spans columns 8-12 and rows 7-11
    assert green[9, 8] and green[7, 9] and not green[9, 10]
    assert green[2, 0] and green[0, 2] and not green[0, 0]
    red = (rgb == _draw.RED).all(axis=2)
    assert red[4, 3:14].all() and red[4:, 3].all() and red[4:, 13].all()


# ------------------------------------------------------------ rcr_detect
@pytest.mark.parametrize("mode", ["facebox", "pts", "face_detector"])
def test_rcr_detect_matches_jax(monkeypatch, tmp_path, mode):
    png = os.path.join(SYNTH, IMAGE + ".png")
    common = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i", png]
    if mode == "facebox":
        jax_extra = port_extra = ["--facebox", "60.5,120.25,170,175"]
    elif mode == "pts":
        jax_extra = port_extra = ["--pts", png[:-4] + ".pts"]
    else:
        jax_extra, port_extra = ["-f", STOCK_FRONTAL_ALT2], ["-f"]
    want, got = [], []
    record_detect(monkeypatch, jax_rcr.DetectionModel, want)
    record_detect(monkeypatch, port_rcr.DetectionModel, got)
    out_png = tmp_path / "out.png"
    rc, jax_text = run_app(monkeypatch, jax_detect, common + jax_extra)
    assert rc == 0
    rc, text = run_app(monkeypatch, rcr_detect, common + port_extra + [
        "-o", str(out_png), "--device", "cpu"])
    assert rc == 0
    (box, coords), (jax_box, jax_coords) = got[0], want[0]
    assert len(got) == len(want) == 1 and coords.shape == (22, 2)
    np.testing.assert_allclose(box, jax_box, rtol=1e-6, atol=0)
    np.testing.assert_allclose(coords, jax_coords, atol=EXACT_PX, rtol=0)
    for printed, values in ((detect_lines(text), coords),
                            (detect_lines(jax_text), jax_coords)):
        assert len(printed) == 22
        np.testing.assert_allclose(np.float64(list(printed.values())),
                                   values, atol=0.005 + 1e-9, rtol=0)
    assert list(detect_lines(text)) == list(detect_lines(jax_text))
    written = read_png(out_png)
    assert written.shape == (450, 300, 3)
    assert (written == _draw.GREEN).all(axis=2).sum() > 0
    assert (written == _draw.RED).all(axis=2).sum() > 0


def test_rcr_detect_on_a_lossy_webp_matches_jax(monkeypatch, tmp_path):
    """-i still.webp (PIL's lossy writer): the port reads it through its
    twins (the VP8 entropy stage, W1-W3), the JAX app through PIL; the
    landmarks within 1e-3 px, and -o out.png the JAX app's bytes."""
    with Image.open(os.path.join(SYNTH, IMAGE + ".png")) as im:
        still = tmp_path / "still.webp"
        im.convert("RGB").save(still, "WEBP", quality=80)
    common = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i",
              str(still), "--facebox", "60.5,120.25,170,175"]
    want, got = [], []
    record_detect(monkeypatch, jax_rcr.DetectionModel, want)
    record_detect(monkeypatch, port_rcr.DetectionModel, got)
    jax_out, out = tmp_path / "jax.png", tmp_path / "out.png"
    rc, _ = run_app(monkeypatch, jax_detect, common + ["-o", str(jax_out)])
    assert rc == 0
    rc, text = run_app(monkeypatch, rcr_detect, common + [
        "-o", str(out), "--device", "cpu"])
    assert rc == 0 and f"Wrote {out}" in text
    (box, coords), (jax_box, jax_coords) = got[0], want[0]
    np.testing.assert_allclose(box, jax_box, rtol=1e-6, atol=0)
    np.testing.assert_allclose(coords, jax_coords, atol=EXACT_PX, rtol=0)
    assert out.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("irreversible", [False, True])
def test_rcr_detect_on_a_jpeg2000_matches_jax(monkeypatch, tmp_path,
                                              irreversible):
    """-i still.jp2 (PIL's writer, the 5/3 or the 9/7 transform, one layer
    at a rate of 40): the port reads it through its twins (tier-2,
    tier-1, D1, M1), the JAX app through PIL; the landmarks within 1e-3
    px, and -o out.png the JAX app's bytes."""
    with Image.open(os.path.join(SYNTH, IMAGE + ".png")) as im:
        still = tmp_path / "still.jp2"
        im.save(still, "JPEG2000", quality_layers=[40],
                irreversible=irreversible)
    common = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i",
              str(still), "--facebox", "60.5,120.25,170,175"]
    want, got = [], []
    record_detect(monkeypatch, jax_rcr.DetectionModel, want)
    record_detect(monkeypatch, port_rcr.DetectionModel, got)
    jax_out, out = tmp_path / "jax.png", tmp_path / "out.png"
    rc, _ = run_app(monkeypatch, jax_detect, common + ["-o", str(jax_out)])
    assert rc == 0
    rc, text = run_app(monkeypatch, rcr_detect, common + [
        "-o", str(out), "--device", "cpu"])
    assert rc == 0 and f"Wrote {out}" in text
    (box, coords), (jax_box, jax_coords) = got[0], want[0]
    np.testing.assert_allclose(box, jax_box, rtol=1e-6, atol=0)
    np.testing.assert_allclose(coords, jax_coords, atol=EXACT_PX, rtol=0)
    assert out.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("kind", ["sof10", "sof3"])
def test_rcr_detect_on_arithmetic_and_lossless_jpeg_matches_jax(
        monkeypatch, tmp_path, kind):
    """-i still.jpg, arithmetic-coded progressive (SOF10, the system
    libjpeg's writer through tests/torch_jpeg_writer.c) or lossless (SOF3,
    RGB, the numpy writer): the port reads it through its twins, the JAX
    app through PIL; the landmarks within 1e-3 px, and -o out.png the JAX
    app's bytes."""
    from torch_jpeg_coders import Libjpeg, write_lossless
    with Image.open(os.path.join(SYNTH, IMAGE + ".png")) as im:
        rgb = np.asarray(im.convert("RGB"))
    if kind == "sof10":
        try:
            data = Libjpeg(tmp_path).write(
                rgb, 75, sampling=[(2, 2), (1, 1), (1, 1)], progressive=True)
        except OSError as e:
            pytest.skip(f"no gcc or -ljpeg: {e}")
    else:
        data = write_lossless([np.ascontiguousarray(rgb[..., c])
                               for c in range(3)], rgb.shape[1],
                              rgb.shape[0], predictor=4, table="optimal")
    still = tmp_path / "still.jpg"
    still.write_bytes(data)
    common = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i",
              str(still), "--facebox", "60.5,120.25,170,175"]
    want, got = [], []
    record_detect(monkeypatch, jax_rcr.DetectionModel, want)
    record_detect(monkeypatch, port_rcr.DetectionModel, got)
    jax_out, out = tmp_path / "jax.png", tmp_path / "out.png"
    rc, _ = run_app(monkeypatch, jax_detect, common + ["-o", str(jax_out)])
    assert rc == 0
    rc, text = run_app(monkeypatch, rcr_detect, common + [
        "-o", str(out), "--device", "cpu"])
    assert rc == 0 and f"Wrote {out}" in text
    (box, coords), (jax_box, jax_coords) = got[0], want[0]
    np.testing.assert_allclose(box, jax_box, rtol=1e-6, atol=0)
    np.testing.assert_allclose(coords, jax_coords, atol=EXACT_PX, rtol=0)
    assert out.read_bytes() == jax_out.read_bytes()


def test_rcr_detect_png_and_tiff_are_the_jax_apps_bytes(monkeypatch,
                                                        tmp_path):
    png = os.path.join(SYNTH, IMAGE + ".png")
    common = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i", png,
              "--pts", png[:-4] + ".pts"]
    jax_out = tmp_path / "jax.png"
    rc, _ = run_app(monkeypatch, jax_detect, common + ["-o", str(jax_out)])
    assert rc == 0
    for ext in (".png", ".tif"):
        out = tmp_path / ("out" + ext)
        rc, text = run_app(monkeypatch, rcr_detect, common + [
            "-o", str(out), "--device", "cpu"])
        assert rc == 0 and f"Wrote {out}" in text
        if ext == ".png":
            assert out.read_bytes() == jax_out.read_bytes()
        else:   # the JAX app's .tif: PIL's TIFF of the same drawing
            buf = io.BytesIO()
            Image.open(jax_out).save(buf, "TIFF")
            assert out.read_bytes() == buf.getvalue()


@pytest.mark.parametrize("ext", [".gif", ".webp"])
def test_rcr_detect_gif_and_webp_are_the_jax_apps_bytes(monkeypatch,
                                                        tmp_path, ext):
    """``-o x.gif`` (PIL's median-cut palette, interlaced LZW) and ``-o
    x.webp`` (libwebp's lossy encoder at PIL's defaults) write the JAX
    app's bytes, the port's Python twins on the CPU."""
    png = os.path.join(SYNTH, IMAGE + ".png")
    common = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i", png,
              "--pts", png[:-4] + ".pts"]
    jax_out, out = tmp_path / ("jax" + ext), tmp_path / ("out" + ext)
    rc, _ = run_app(monkeypatch, jax_detect, common + ["-o", str(jax_out)])
    assert rc == 0
    rc, text = run_app(monkeypatch, rcr_detect, common + [
        "-o", str(out), "--device", "cpu"])
    assert rc == 0 and f"Wrote {out}" in text
    assert out.read_bytes() == jax_out.read_bytes()


def test_rcr_detect_without_a_box_says_so(monkeypatch):
    argv = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i",
            os.path.join(SYNTH, IMAGE + ".png"), "--device", "cpu"]
    rc, text = run_app(monkeypatch, rcr_detect, argv)
    assert rc == 1 and "facebox" in text
    rc, text = run_app(monkeypatch, rcr_detect,
                       ["-m", os.path.join(SYNTH, IMAGE + ".png")]
                       + argv[2:])
    assert rc == 1 and "Error loading the model" in text


def test_apps_need_a_card_unless_told(monkeypatch):
    """No CUDA device and no --device: the app raises, it does not carry
    on on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rcr_detect.main(["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"),
                         "-i", os.path.join(SYNTH, IMAGE + ".png"),
                         "--facebox", "1,2,3,4"])
