"""The port's JPEG decoder (``io/jpeg.py``, ``ops/jpeg.py``) on the CPU,
against PIL through the JAX package.

The port's ``load_gray_image(..., device="cpu")`` runs both plain twins:
the Python entropy decoder and the PyTorch pixel stage of kernel J1. It
must equal the JAX package's ``load_gray_image`` (PIL, then OpenCV's grey)
bit for bit, and ``read_jpeg(..., 3)`` PIL's ``convert("RGB")``, on
streams that PIL writes here from a numpy seed: grey, YCbCr 4:4:4, 4:2:2
and 4:2:0 at qualities 50, 75 and 95, restart markers, optimised Huffman
tables, sizes that are no multiple of 16 and images of a few pixels (box
upsampling below three chroma samples). The committed fixtures
(``tests/torch_jpeg/``, written by ``tests/torch_jpeg_fixtures.py``) still
match their manifest, which ``chip_smoke.py --jpeg`` holds J1 to on the
card. Every unsupported kind raises a ``ValueError`` naming it (a SOF3
label over a DCT scan and a DQT relabelled DAC as libjpeg refuses them,
PIL raising too; a baseline stream relabelled SOF9 reads as PIL reads it),
the kinds once refused (progressive, CMYK, 4:4:0, 4:1:1, chroma 2x2)
decode, and cut or corrupted streams raise instead of hanging. The progressive,
multi-scan, four-component and other sampling kinds are tested in
``tests/test_torch_jpeg_progressive.py``.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import jpeg
from superviseddescent_tpu_torch.ops.jpeg import (
    entropy_params, jpeg_pixels, pixel_params, read_jpeg)
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_jpeg_fixtures import OUT as FIXTURES
from torch_jpeg_fixtures import encode, pil_digests, tint

KINDS = ("grey", "4:4:4", "4:2:2", "4:2:0")


def image(shape, seed, kind):
    """Smooth blocks with noise (so every quality keeps AC terms), tinted
    for the colour kinds."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1))
    grey = np.kron(base, np.ones((8, 8)))[:h, :w] + rng.integers(-25, 26,
                                                                 (h, w))
    grey = np.clip(grey, 0, 255).astype(np.uint8)
    return grey if kind == "grey" else tint(grey, seed)


def check_against_pil(path):
    np.testing.assert_array_equal(load_gray_image(path, device="cpu"),
                                  jax_load_gray(path))
    rgb = read_jpeg(path, 3, device="cpu")
    assert rgb.dtype == torch.uint8 and rgb.device.type == "cpu"
    np.testing.assert_array_equal(
        rgb.numpy(), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("kind", KINDS)
def test_equals_jax_load_gray_image(tmp_path, kind, quality):
    path = tmp_path / "img.jpg"
    path.write_bytes(encode(image((61, 83), quality, kind), kind, quality))
    check_against_pil(path)


@pytest.mark.parametrize("kind,shape,options", [
    ("4:2:0", (77, 95), {"restart_marker_rows": 1}),
    ("grey", (40, 57), {"restart_marker_blocks": 3}),
    ("4:2:2", (64, 48), {"restart_marker_blocks": 5, "optimize": True}),
    ("4:2:0", (70, 66), {"optimize": True}),
    ("4:2:2", (451, 301), {}),
    ("4:2:0", (451, 301), {"restart_marker_rows": 2}),
    ("4:4:4", (17, 33), {}),
    ("4:2:0", (1, 1), {}), ("4:2:0", (3, 4), {}), ("4:2:2", (5, 3), {}),
    ("4:2:0", (2, 5), {}), ("4:2:0", (9, 6), {}), ("grey", (1, 9), {}),
])
def test_variants_equal_jax(tmp_path, kind, shape, options):
    path = tmp_path / "img.jpg"
    path.write_bytes(encode(image(shape, sum(shape), kind), kind, 75,
                            **options))
    check_against_pil(path)


def test_adobe_rgb_and_component_ids(tmp_path):
    """Three components that are R, G, B: PIL's CMYK-free RGB JPEG carries
    Adobe's transform 0 only when asked; here the stream is PIL's 4:4:4
    YCbCr with its JFIF marker dropped and the component ids set to 'R',
    'G', 'B', which libjpeg reads as RGB, as the port does."""
    data = bytearray(encode(image((24, 40), 7, "4:4:4"), "4:4:4", 90))
    app0 = data.index(b"\xff\xe0")
    length = int.from_bytes(data[app0 + 2:app0 + 4], "big")
    del data[app0:app0 + 2 + length]
    sof = data.index(b"\xff\xc0")
    for i, ident in enumerate(b"RGB"):
        data[sof + 10 + 3 * i] = ident
    sos = data.index(b"\xff\xda")
    for i, ident in enumerate(b"RGB"):
        data[sos + 5 + 2 * i] = ident
    path = tmp_path / "rgb.jpg"
    path.write_bytes(bytes(data))
    assert jpeg.parse_jpeg(bytes(data)).color == jpeg.COLOR_RGB
    check_against_pil(path)


def test_full_size_still_equals_jax():
    path = os.path.join(FIXTURES, "s04_420_q95_restart.jpg")
    check_against_pil(path)


def manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def digest(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(manifest()["stills"]))
def test_fixture_stills_match_manifest(name):
    want = manifest()["stills"][name]
    path = os.path.join(FIXTURES, name)
    assert pil_digests(path) == {k: want[k] for k in (
        "shape", "grey_sha256", "rgb_sha256")}
    data = open(path, "rb").read()
    assert digest(read_jpeg(data, 1, device="cpu")) == want["grey_sha256"]
    assert digest(read_jpeg(data, 3, device="cpu")) == want["rgb_sha256"]


def test_fixture_clip_matches_manifest():
    clip = manifest()["clip"]
    assert len(clip["frames"]) == len(clip["offsets"]) >= 16
    for frame in clip["frames"]:
        path = os.path.join(FIXTURES, frame["name"])
        grey = read_jpeg(path, 1, device="cpu")
        assert list(grey.shape) == frame["shape"] == [1024, 768]
        assert digest(grey) == frame["grey_sha256"]


def test_twin_stages_agree_with_the_wrapper():
    """``jpeg_pixels`` on a CPU tensor is the plain twin; the kernel's C
    parameters carry the frame's geometry and quantisers."""
    data = open(os.path.join(FIXTURES, "s06_422_q75_odd.jpg"), "rb").read()
    f = jpeg.parse_jpeg(data)
    coef = torch.from_numpy(jpeg.entropy_decode(f))
    assert coef.shape == (f.blocks, 64) and coef.dtype == torch.int16
    np.testing.assert_array_equal(jpeg_pixels(coef, f, 3),
                                  jpeg.pixels_reference(coef, f, 3))
    geom, quant = pixel_params(f, 1)
    assert geom[:10].tolist() == [3, 301, 451, jpeg.COLOR_YCC, 1, f.blocks,
                                  f.mcux, f.mcuy, 2, 1]
    assert geom[13:43].reshape(3, 10)[:, 5:].tolist() == [
        [jpeg.UP_FULL, 1, 1, 2, 1], [jpeg.UP_H2V1, 2, 1, 1, 1],
        [jpeg.UP_H2V1, 2, 1, 1, 1]]
    np.testing.assert_array_equal(quant[:3], f.quant())
    data, params, huff = entropy_params(f)
    assert data == f.scans[0].data
    assert params[:6].tolist() == [3, f.mcux, f.mcuy, f.blocks, 1, 0]
    assert huff.shape == (4, 272) and huff[0, :16].sum() > 0


def test_range_limit_wraps_like_libjpeg():
    """range_limit[x & RANGE_MASK] after the level shift: a clamp inside
    [-512, 511], a wrap outside it."""
    x = torch.tensor([-129, -128, 0, 127, 128, 511, 512, 600, 895, 896,
                      1023, -513, -600])
    want = [0, 0, 128, 255, 255, 255, 0, 0, 0, 0, 127, 255, 255]
    assert jpeg.range_limit(x).tolist() == want


def patched(data, old, new):
    data = bytearray(data)
    data[data.index(old):data.index(old) + len(new)] = new
    return bytes(data)


def sof_patched(data, offset, value):
    data = bytearray(data)
    data[data.index(b"\xff\xc0") + offset] = value
    return bytes(data)


def refusal_cases():
    """Each case's bytes and the refusal's message; None where the bytes
    are read as PIL reads them. SOF3, SOF9 and DAC were refused before the
    arithmetic and lossless decoders came in: a SOF3 over a DCT scan and
    a DQT relabelled DAC are refused as libjpeg refuses them (PIL raises
    too), a baseline stream relabelled SOF9 decodes as libjpeg's
    arithmetic decoder reads its bytes."""
    colour = encode(image((32, 32), 3, "4:2:0"), "4:2:0", 75)
    return {
        "lossless": (patched(colour, b"\xff\xc0", b"\xff\xc3"),
                     "a lossless scan with Ss=0, Se=63"),
        "arithmetic": (patched(colour, b"\xff\xc0", b"\xff\xc9"), None),
        "differential": (patched(colour, b"\xff\xc0", b"\xff\xc5"),
                         "SOF5 \\(differential\\)"),
        "dac": (patched(colour, b"\xff\xdb", b"\xff\xcc"),
                "DAC: bogus value"),
        "12-bit": (sof_patched(colour, 4, 12), "12-bit"),
        "dnl": (sof_patched(sof_patched(colour, 5, 0), 6, 0), "DNL"),
        "not a jpeg": (b"GIF89a" + bytes(16), "not a JPEG"),
    }


def formerly_refused_cases():
    """The kinds the decoder refused before progressive, four-component and
    any whole-ratio sampling were read: each well formed."""
    from torch_jpeg_fixtures import reencode
    cmyk = io.BytesIO()
    Image.fromarray(image((16, 16), 4, "4:4:4")).convert("CMYK").save(
        cmyk, "JPEG")
    progressive = io.BytesIO()
    Image.fromarray(image((16, 16), 5, "4:4:4")).save(
        progressive, "JPEG", progressive=True)
    return {
        "progressive": progressive.getvalue(),
        "cmyk": cmyk.getvalue(),
        "4:4:0": sof_patched(encode(image((32, 32), 3, "4:2:2"), "4:2:2",
                                    75), 11, 0x12),
        "4:1:1": sof_patched(encode(image((32, 64), 3, "4:2:0"), "4:2:0",
                                    75), 11, 0x41),
        "chroma 2x2": reencode(image((32, 32), 3, "4:4:4"),
                               ((2, 2), (2, 2), (1, 1)), [[0, 1, 2]]),
    }


@pytest.mark.parametrize("case", sorted(formerly_refused_cases()))
def test_formerly_refused_kinds_decode(case, tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(formerly_refused_cases()[case])
    check_against_pil(path)


def pil_refuses(data) -> bool:
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
    except Exception:
        return True
    return False


@pytest.mark.parametrize("case", sorted(refusal_cases()))
def test_refusals_name_what_is_unsupported(case, tmp_path):
    data, message = refusal_cases()[case]
    if message is None:
        assert not pil_refuses(data)
        path = tmp_path / "x.jpg"
        path.write_bytes(data)
        check_against_pil(path)
        return
    if case in ("lossless", "dac"):
        assert pil_refuses(data)
    with pytest.raises(ValueError, match=message):
        read_jpeg(data, device="cpu")
    if data[:2] == b"\xff\xd8":
        path = tmp_path / "x.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=f"x.jpg: .*{message}"):
            load_gray_image(path, device="cpu")


def test_load_gray_image_names_an_unknown_format(tmp_path):
    # GIF is read since the BMP / PNM / TIFF / GIF readers came in: an
    # unknown format is any other magic
    path = tmp_path / "x.xyz"
    path.write_bytes(b"XYZ1" + bytes(16))
    with pytest.raises(ValueError, match="x.xyz: not an image format the "
                       "port reads"):
        load_gray_image(path)


@pytest.mark.parametrize("kind", ["grey", "4:2:0"])
def test_truncated_and_corrupted_streams_raise(kind):
    data = encode(image((48, 64), 9, kind), kind, 90,
                  restart_marker_rows=1)
    sos = data.index(b"\xff\xda")
    for cut in [3, 20, sos + 6, sos + 40, len(data) // 2, len(data) - 40]:
        for tail in (b"", b"\xff\xd9"):
            with pytest.raises(ValueError, match="JPEG"):
                read_jpeg(data[:cut] + tail, device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        read_jpeg(data[:-2], device="cpu")                # no EOI
    scan = bytearray(data)
    scan[sos + 30:sos + 60] = b"\xff" * 30            # a run of 0xFF bytes
    with pytest.raises(ValueError, match="JPEG"):
        read_jpeg(bytes(scan), device="cpu")


def test_a_jpeg_needs_a_card_unless_told(monkeypatch, tmp_path):
    """No CUDA device and no device named: a JPEG raises, as
    resolve_device does; a PNG decodes on the host as before."""
    path = tmp_path / "x.jpg"
    path.write_bytes(encode(image((16, 16), 1, "grey"), "grey", 75))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_gray_image(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_jpeg(path)
    png = tmp_path / "x.png"
    Image.fromarray(image((16, 16), 1, "grey")).save(png)
    np.testing.assert_array_equal(load_gray_image(png), jax_load_gray(png))

