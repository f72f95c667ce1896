"""The host C++ JPEG decoder (``csrc/jpeg_decode.cu``'s
``jpeg_entropy_decode``) on the CPU, against its Python twin.

The source's host half compiles with g++ (``-DJPEG_DECODE_HOST_ONLY``
leaves out kernel J1 and the CUDA runtime) into a library that
``ops/jpeg.entropy_decode_native`` drives through ctypes, as the card's
path does. On every committed JPEG fixture (baseline, progressive,
multi-scan, CMYK, arithmetic, block-smoothed, lossless, the clips and the
timing frames) and on streams written here, its coefficients (a lossless
frame's samples) equal ``io/jpeg.entropy_decode``'s exactly, and a
damaged stream fails with the twin's error.
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest

from superviseddescent_tpu_torch.io import jpeg
from superviseddescent_tpu_torch.ops._build import CSRC
from superviseddescent_tpu_torch.ops.jpeg import entropy_decode_native
from torch_jpeg_coders import Libjpeg, lossless_layout, write_lossless
from torch_jpeg_fixtures import OUT as FIXTURES
from torch_jpeg_fixtures import SAMPLING, _never, _unrefined

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
STILLS = sorted(MANIFEST["stills"]) + sorted(MANIFEST["timing"])


@pytest.fixture(scope="module")
def host_decoder(tmp_path_factory):
    """The host half of csrc/jpeg_decode.cu built with g++."""
    import ctypes
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host decoder")
    lib = tmp_path_factory.mktemp("decoder") / "libjpeg_decode_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-DJPEG_DECODE_HOST_ONLY", "-o", str(lib),
                    str(CSRC / "jpeg_decode.cu")], check=True)
    decoder = ctypes.CDLL(str(lib))
    decoder.jpeg_entropy_decode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p]
    return decoder


def same_as_twin(data, decoder):
    f = jpeg.parse_jpeg(data)
    got = entropy_decode_native(f, library=decoder).numpy()
    want = jpeg.entropy_decode(f)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", STILLS)
def test_fixture(host_decoder, name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        same_as_twin(f.read(), host_decoder)


@pytest.mark.parametrize("clip", ["clip", "clip_progressive"])
def test_clip_frames(host_decoder, clip):
    for frame in MANIFEST[clip]["frames"]:
        with open(os.path.join(FIXTURES, frame["name"]), "rb") as f:
            same_as_twin(f.read(), host_decoder)


def noise(shape, seed, kind):
    rng = np.random.default_rng(seed)
    grey = np.clip(np.kron(rng.integers(0, 256, (shape[0] // 8 + 1,
                                                 shape[1] // 8 + 1)),
                           np.ones((8, 8)))[:shape[0], :shape[1]]
                   + rng.integers(-30, 31, shape), 0, 255).astype(np.uint8)
    return grey if kind == "grey" else np.stack(
        [grey, 255 - grey, grey // 2 + 60], axis=-1)


@pytest.mark.parametrize("arithmetic", [False, True])
def test_written_streams(host_decoder, tmp_path, arithmetic):
    """Smoothing at widths of 1-5 blocks, both scripts; restarts; DAC."""
    try:
        lj = Libjpeg(tmp_path)
    except OSError as e:
        pytest.skip(f"no gcc or -ljpeg: {e}")
    for k, (kind, shape) in enumerate([("grey", (8, 16)), ("4:2:0", (33, 17)),
                                       ("4:2:2", (40, 24)),
                                       ("4:4:4", (9, 40))]):
        n = 1 if kind == "grey" else 3
        for script in (_never, _unrefined):
            same_as_twin(lj.write(noise(shape, k, kind), 60,
                                  sampling=SAMPLING[kind],
                                  arithmetic=arithmetic, scans=script(n)),
                         host_decoder)
        same_as_twin(lj.write(noise(shape, k, kind), 90,
                              sampling=SAMPLING[kind], arithmetic=arithmetic,
                              progressive=True, restart=2,
                              dac={("dc", 1): (2, 4), ("ac", 0): 1}),
                     host_decoder)


def test_lossless_streams(host_decoder):
    """Every predictor, point transforms, restarts inside a two-row iMCU
    row, one scan per component, differences that wrap."""
    rng = np.random.default_rng(3)
    for p in range(1, 8):
        sampling = [(1, 2), (1, 1), (1, 1)]
        planes = [rng.integers(0, 256, shape).astype(np.uint8)
                  for shape in lossless_layout(13, 11, sampling)]
        same_as_twin(write_lossless(planes, 13, 11, sampling=sampling,
                                    scans=[[0], [1], [2]], restart=13,
                                    predictor=p, pt=p % 3), host_decoder)

    def hook(diffs):
        diffs[0][1, 1], diffs[0][2, 2] = -32768, 4000
    same_as_twin(write_lossless([rng.integers(0, 256, (9, 12)).astype(
        np.uint8)], 12, 9, predictor=7, diffs_hook=hook), host_decoder)


@pytest.mark.parametrize("name", ["s04_420_q95_restart.jpg",
                                  "p04_420_q95_restart_prog.jpg",
                                  "l07_grey_p4_restart.jpg"])
def test_damaged_streams_fail_as_the_twin_fails(host_decoder, name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    sos = data.index(b"\xff\xda")
    for bad in (data[:sos + 60] + b"\xff\xd9",
                data[:sos + 30] + b"\xff\xd3" + data[sos + 32:]):
        try:
            f = jpeg.parse_jpeg(bad)
        except ValueError:
            continue
        with pytest.raises(ValueError) as twin:
            jpeg.entropy_decode(f)
        with pytest.raises(ValueError) as native:
            entropy_decode_native(f, library=host_decoder)
        assert str(native.value) == str(twin.value)
