"""Lossless WebP on the CPU, against PIL and the JAX package.

Every WebP fixture (``tests/torch_imageio/w*.webp`` and the 768 x 1024
``f04_clip.webp``, written by ``tests/torch_imageio_fixtures.py``) still
matches PIL's digests in the manifest and reads through the Python twin
as the JAX package reads it: ``load_gray_image`` bit-equal to the JAX
package's, ``read_rgb`` equal to PIL's ``convert("RGB")``; an
animation's first frame as PIL composes it. The fixtures together use
every VP8L transform, all 14 predictor modes, each pixel-bundling width,
the colour cache and backward references (counted in the twin). The
host C++ decoder (``csrc/webp_decode.cu``, built here with g++) returns
the twin's ARGB for every fixture. The three lossy kinds once refused by
name (a ``VP8 `` file, ``ALPH`` + ``VP8 ``, a lossy animation frame) now
read as PIL reads them (``tests/test_torch_webp_lossy.py`` has the rest).
"""

import ctypes
import hashlib
import io
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io.webp import (
    compose, decode_vp8l, decode_vp8l_native, decode_webp)
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, rgb_to_gray_u8)
from torch_imageio_fixtures import OUT as FIXTURES
from torch_imageio_fixtures import (
    pil_bytes, pil_digests, riff, small_rgb, vp8l_of)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "superviseddescent_tpu_torch", "csrc", "webp_decode.cu")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
WEBP_FILES = MANIFEST["groups"]["webp"]


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", WEBP_FILES)
def test_webp_reads_as_the_jax_package_and_pil_do(name):
    path = os.path.join(FIXTURES, name)
    want = MANIFEST["files"][name]
    assert pil_digests(path) == {k: want[k] for k in (
        "shape", "mode", "grey_sha256", "rgb_sha256")}
    grey = load_gray_image(path, device="cpu")
    np.testing.assert_array_equal(grey, jax_load_gray(path))
    rgb = imageio.read_rgb(path, device="cpu")
    with Image.open(path) as im:
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))
    assert sha(rgb) == want["rgb_sha256"]


def test_clip_webp_through_the_twin():
    want = MANIFEST["files"]["f04_clip.webp"]
    rgb = decode_webp(read("f04_clip.webp"), device="cpu")
    assert sha(rgb) == want["rgb_sha256"]
    assert sha(rgb_to_gray_u8(rgb)) == want["grey_sha256"]


def test_fixtures_cover_the_bitstream():
    stats = {}
    for name in WEBP_FILES:
        compose(read(name), lambda p: decode_vp8l(p, stats))
    assert stats["transforms"] == {0, 1, 2, 3}
    assert stats["predictor_modes"] >= set(range(14))
    assert stats["bundling"] >= {1, 2, 3}        # 16, 4 and 2 colours
    assert stats["colour_cache"] and stats["cache_hits"]
    assert stats["backward_refs"] and stats["meta_prefix"]
    assert stats["simple_codes"] and stats["normal_codes"]
    assert len(stats["distance_codes"] & set(range(1, 121))) >= 40
    assert max(stats["distance_codes"]) > 120


@pytest.fixture(scope="module")
def host_decoder(tmp_path_factory):
    """csrc/webp_decode.cu (host code only) built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host decoder")
    lib = tmp_path_factory.mktemp("webp") / "libwebp_decode.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", str(lib), CSRC], check=True)
    decoder = ctypes.CDLL(str(lib))
    decoder.webp_decode_vp8l.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    return decoder


def test_host_decoder_equals_the_twin(host_decoder):
    for name in WEBP_FILES:
        data = read(name)
        got = compose(data, lambda p: decode_vp8l_native(p, host_decoder))
        np.testing.assert_array_equal(got, compose(data, decode_vp8l))
    want = MANIFEST["files"]["f04_clip.webp"]["rgb_sha256"]
    assert sha(compose(read("f04_clip.webp"), lambda p: decode_vp8l_native(
        p, host_decoder))) == want


def test_host_decoder_refuses_damage(host_decoder):
    vp8l = vp8l_of(read("w01_rgb_m4_q50.webp"))
    for cut in (len(vp8l) // 2, 12):
        with pytest.raises(ValueError, match="VP8L"):
            decode_vp8l_native(vp8l[:cut], host_decoder)
        with pytest.raises(ValueError, match="VP8L"):
            decode_vp8l(vp8l[:cut])


def lossy_files():
    rgb = small_rgb()
    rgba = np.concatenate([rgb, rgb[..., :1]], axis=2)
    anim = io.BytesIO()
    Image.fromarray(rgb).save(anim, "WEBP", lossless=False, save_all=True,
                              append_images=[Image.fromarray(rgb[::-1]
                                                             .copy())])
    return {"VP8": pil_bytes(Image.fromarray(rgb), "WEBP", quality=80),
            "ALPH": pil_bytes(Image.fromarray(rgba, "RGBA"), "WEBP",
                              quality=80),
            "lossy frame": anim.getvalue()}


@pytest.mark.parametrize("kind", ["VP8", "ALPH", "lossy frame"])
def test_lossy_webp_is_refused_by_name(kind):
    """The three lossy kinds the reader once refused by name: each now
    reads equal to PIL's pixels (the test's name kept)."""
    data = lossy_files()[kind]
    chunks = data[12:16]
    assert chunks == (b"VP8 " if kind == "VP8" else b"VP8X")
    assert imageio.sniff(data) == "WEBP"
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    got = decode_webp(data, device="cpu")
    assert sha(got) == sha(want)


def test_webp_container_and_writes():
    with pytest.raises(ValueError, match="not a WebP file"):
        compose(b"RIFF\x00\x00\x00\x00WEBX" + bytes(12), decode_vp8l)
    with pytest.raises(ValueError, match="no image bitstream"):
        compose(riff([(b"VP8X", bytes(10)), (b"ICCP", b"x")]), decode_vp8l)
    assert imageio.format_for("x.webp") == "WEBP"   # written, not refused
