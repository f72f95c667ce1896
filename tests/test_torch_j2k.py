"""JPEG 2000 reading (``io/jp2.py``, ``io/j2k*.py``, ``ops/j2k.py``)
against the JAX package and PIL, on the CPU.

The fixtures are ``tests/torch_j2k/`` (``python tests/torch_j2k_fixtures.py``
writes them and their ``manifest.json``). Here the Python twins run: the
host stage (markers, tier-2, tier-1) and the plain PyTorch twins of D1
and M1. The Python tier-1 twin is slow by nature, so it reads the files
of ``TWIN_FILES`` only (every fixture of at most 64 x 64, all but the two
768 x 1024 clip frames and a 16,400 x 64 frame), which together reach
every pass, code-block
style, progression order, transform, marker and colour kind;
``test_torch_j2k_host.py`` holds the host C++ build to the twin and reads
every fixture through it. Every file's mode and palette are PIL's,
every file PIL cannot read is refused, and the device rules hold. The
kernels D1 and M1 against their twins need the card: they are in
``test_torch_kernels_gpu.py`` (marked ``gpu``).
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io import jp2 as J
from superviseddescent_tpu_torch.io.j2k import J2kError
from superviseddescent_tpu_torch.ops import j2k as O
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_apps_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_j2k")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
FILES = sorted(MANIFEST["files"])
READABLE = [n for n in FILES if "pil_error" not in MANIFEST["files"][n]]
REFUSED = [n for n in FILES if "pil_error" in MANIFEST["files"][n]]
# the Python twin reads every readable fixture of at most 64 x 64: every
# pass and code-block style (o01-o08), the five progression orders and
# POC (k11-k14, o10), 5/3 and 9/7 with RCT and ICT, PPM / PPT, ROI,
# tile-parts, derived quantisation, odd origins and tiles, lines of one
# sample, every colour kind and precision; the 768 x 1024 frames and the
# 16,400 x 64 one go through the C++ build (test_torch_j2k_host.py)
TWIN_FILES = [n for n in READABLE if MANIFEST["files"][n]["small"]]
LARGE = ("f01_clip_97_rpcl.jp2", "f02_clip_53_tiles.jp2",
         "k40_wide_16400x64.j2k")


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def path_of(name):
    return os.path.join(FIXTURES, name)


def test_openjpeg_layout_writes_pils_bytes(tmp_path):
    """The fixtures' ctypes writer (``torch_j2k_openjpeg.encode``) writes
    PIL's own file at PIL's defaults: its struct offsets hold."""
    from torch_j2k_fixtures import check_layout
    assert check_layout(str(tmp_path))


def test_twin_files_are_small_and_pils():
    assert sorted(TWIN_FILES + list(LARGE)) == READABLE
    for name in TWIN_FILES:
        h, w = MANIFEST["files"][name]["shape"][:2]
        assert h <= 64 and w <= 64


@pytest.mark.parametrize("name", TWIN_FILES)
def test_twin_reads_as_the_jax_package_and_pil_do(name, monkeypatch):
    """Grey and RGB through the public readers on the CPU; the host
    stage's twin runs once for both reads."""
    decoded = {}
    twin = O.decode_python

    def once(codestream):
        if codestream not in decoded:
            decoded[codestream] = twin(codestream)
        return decoded[codestream]
    monkeypatch.setattr(O, "decode_python", once)
    path = path_of(name)
    want = MANIFEST["files"][name]
    grey = load_gray_image(path, device="cpu")
    np.testing.assert_array_equal(grey, jax_load_gray(path))
    rgb = imageio.read_rgb(path, device="cpu")
    with Image.open(path) as im:
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))
    assert sha(rgb) == want["rgb_sha256"]
    assert sha(grey.astype(np.uint8)) == want["grey_sha256"]


@pytest.mark.parametrize("name", READABLE)
def test_mode_and_palette_are_pils(name):
    with open(path_of(name), "rb") as f:
        got = J.read_file(f.read())
    with Image.open(path_of(name)) as im:
        assert got.mode == im.mode == MANIFEST["files"][name]["mode"]
        assert list(got.size) == list(im.size)
        if im.mode in ("P", "PA"):
            colours = sorted(im.palette.colors.items(), key=lambda kv: kv[1])
            assert [c[:3] for c, _ in colours] == [tuple(c) for c in
                                                    got.palette]


REFUSAL = {"x04_htj2k.j2k": "HTJ2K \\(Part 15\\) is not ported",
           "x05_five_components.j2k": "unable to determine J2K image mode",
           "x08_precinct_one.jp2": "precinct of one sample",
           "x02_no_eoc.j2k": "does not end with EOC",
           "x06_bad_progression.j2k": "unknown progression order",
           "x07_lost_sop.j2k": "SOP marker is missing",
           "e10_colr_grey_rgb.jp2": "broken data stream",
           "e13_pclr_grey.jp2": "broken data stream"}


@pytest.mark.parametrize("name", REFUSED)
def test_what_pil_cannot_read_is_refused(name):
    with pytest.raises(ValueError, match=REFUSAL.get(name)) as e:
        load_gray_image(path_of(name), device="cpu")
    assert name in str(e.value)


@pytest.mark.parametrize("magic", [b"\xff\x4f\xff\x51\x00\x29",
                                   b"\x00\x00\x00\x0cjP  \r\n\x87\n"])
def test_sniff_reads_both_signatures(magic):
    assert imageio.sniff(magic + b"\0" * 32) == "JPEG2000"
    assert Image.registered_extensions()[".jp2"] == "JPEG2000"
    with pytest.raises(ValueError, match="writing JPEG2000 .* not ported"):
        imageio.format_for("x.jp2")


def test_htj2k_is_refused_by_name_in_every_stage():
    with open(path_of("x04_htj2k.j2k"), "rb") as f:
        data = f.read()
    with pytest.raises(J2kError, match="HTJ2K"):
        O.decode_python(data)
    cap_only = data.replace(b"\xff\x50", b"\xff\x64", 1)   # CAP gone
    with pytest.raises(J2kError, match="HTJ2K"):          # the HT style bit
        O.decode_python(cap_only)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_gray_image(path_of("k05_grey.j2k"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imageio.read_rgb(path_of("k01_rgb.jp2"))


def test_a_failed_host_decoder_does_not_fall_back(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("the host decoder failed to build")

    def twin(*args, **kwargs):
        raise AssertionError("the card's path took the Python twin")
    monkeypatch.setattr(O, "decode_native", broken)
    monkeypatch.setattr(O, "decode_python", twin)
    with open(path_of("k05_grey.j2k"), "rb") as f:
        data = f.read()
    with pytest.raises(RuntimeError, match="failed to build"):
        O.read_j2k(data, 1, "cuda")


def test_kernel_wrappers_take_the_twin_only_on_the_cpu():
    with open(path_of("k04_rgb_97_mct.jp2"), "rb") as f:
        got = J.read_file(f.read())
    frame = O.decode_python(got.codestream)
    plan = O.colour_plan(got, frame)
    coeffs = O.j2k_idwt(frame.coeffs, frame.tcs)
    assert torch.equal(coeffs, O.idwt_reference(frame.coeffs, frame.tcs))
    rgb = O.j2k_colour(coeffs, frame, plan, 3)
    assert sha(rgb.numpy()) == MANIFEST["files"]["k04_rgb_97_mct.jp2"][
        "rgb_sha256"]
    with pytest.raises(ValueError, match="unsupported device"):
        O.j2k_idwt(frame.coeffs.to("meta"), frame.tcs)
