"""The host C++ stage of JPEG 2000 reading (``csrc/j2k_decode.cu``), built
with g++ on the CPU: its planes and tables equal the Python twin's, and
with the PyTorch twins of D1 and M1 it reads every fixture of
``tests/torch_j2k/`` to PIL's pixels, the two 768 x 1024 clip frames and
the 16,400 x 64 frame (lines past 16,384 samples) included, and refuses
every file PIL cannot read.
"""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.io import jp2 as J
from superviseddescent_tpu_torch.ops import _build
from superviseddescent_tpu_torch.ops import j2k as O
from torch_apps_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_j2k")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
FILES = sorted(MANIFEST["files"])
READABLE = [n for n in FILES if "pil_error" not in MANIFEST["files"][n]]
REFUSED = [n for n in FILES if "pil_error" in MANIFEST["files"][n]]
# the twin's side of the comparison: every code-block style, progression
# order and POC, PPM / PPT, ROI, tile-parts, both transforms
TWIN_FILES = ("k04_rgb_97_mct.jp2", "k12_rpcl.jp2", "k14_cprl.jp2",
              "k39_odd_tiles_97.j2k", "o07_style_all.j2k",
              "o08_style_all_97.j2k", "o10_poc.j2k", "o11_tileparts.j2k",
              "o13_roi_97.j2k", "e04_ppm_tiles.j2k", "e05_ppt_tiles.j2k",
              "o24_subsampled_offset.j2k")


@pytest.fixture(scope="module")
def host_decoder(tmp_path_factory):
    """csrc/j2k_decode.cu built with g++, its entry points typed as
    ops/_build types them for the card's build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host decoder")
    lib = tmp_path_factory.mktemp("j2k") / "libj2k_decode_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", str(lib),
                    str(_build.CSRC / "j2k_decode.cu")], check=True)
    decoder = ctypes.CDLL(str(lib))
    for symbol, argtypes in _build.KERNELS["j2k_decode"].items():
        fn = getattr(decoder, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return decoder


def codestream(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return J.read_file(f.read())


@pytest.mark.parametrize("name", TWIN_FILES)
def test_host_decoder_equals_the_python_twin(host_decoder, name):
    f = codestream(name)
    native = O.decode_native(f.codestream, library=host_decoder)
    twin = O.decode_python(f.codestream)
    assert torch.equal(native.coeffs, twin.coeffs)
    np.testing.assert_array_equal(native.tcs, twin.tcs)
    np.testing.assert_array_equal(native.tiles, twin.tiles)
    np.testing.assert_array_equal(native.comps, twin.comps)
    assert native[:8] == twin[:8]


@pytest.mark.parametrize("name", READABLE)
def test_host_decoder_with_the_twins_gives_pils_pixels(host_decoder, name):
    f = codestream(name)
    frame = O.decode_native(f.codestream, library=host_decoder)
    plan = O.colour_plan(f, frame)
    coeffs = O.idwt_reference(frame.coeffs, frame.tcs)
    want = MANIFEST["files"][name]
    for channels, key in ((3, "rgb_sha256"), (1, "grey_sha256")):
        px = O.colour_reference(coeffs, frame, plan, channels).numpy()
        assert list(px.shape[:2]) == want["shape"][:2]
        assert hashlib.sha256(px.tobytes()).hexdigest() == want[key]


@pytest.mark.parametrize("name", REFUSED)
def test_host_decoder_refuses_what_pil_cannot_read(host_decoder, name):
    with open(os.path.join(FIXTURES, name), "rb") as fh:
        data = fh.read()
    with pytest.raises(ValueError):
        f = J.read_file(data)
        frame = O.decode_native(f.codestream, library=host_decoder)
        O.colour_plan(f, frame)
