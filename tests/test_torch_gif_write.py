"""GIF writing on the CPU, against PIL 12.1.

The median-cut quantiser (``io/gif_quant.quantize``) gives PIL's
``convert("P", palette=ADAPTIVE)``: the same palette, in the same order,
and the same index for every pixel, on the committed write fixtures
(``gif_writes`` of ``tests/torch_imageio/manifest.json``, their pixels
made by ``torch_write_inputs``' recipes) and on small random images from
hypothesis. The whole file (``io/gif_write.encode_gif``) is PIL's ``save``
byte for byte: the Python twin on the fixtures up to 160 x 120 and on the
sweep, and the host C++ coders of ``csrc/gif_encode.cu`` (built with g++
once for the module) on every fixture, the 768 x 1024 clip frame and a
frame past the quantiser's 65,536-colour hash included; each fixture
against PIL's committed digest too. Every file reads back through the
port's own reader (``io/gif.py``). ``write_image`` takes the twin only
where the caller names the CPU; with no card and no device it raises, and
so does a C++ coder that cannot be built.
"""

import ctypes
import io
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from superviseddescent_tpu_torch.io import gif_quant, gif_write
from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io.gif import decode_gif
from superviseddescent_tpu_torch.ops import _build
from torch_imageio_fixtures import OUT as FIXTURES
from torch_write_inputs import digest, make_pixels, port_readers

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    ENTRIES = {e["name"]: e for e in json.load(_f)["gif_writes"]}
# the twin's inputs: up to 160 x 120 (the larger ones run through C++)
TWIN_PIXELS = 160 * 120


def pixels(name):
    return make_pixels(ENTRIES[name]["recipe"], *port_readers())


def pil_gif(px) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "GIF")
    return buf.getvalue()


def read_back(data) -> np.ndarray:
    """The port's reading of a GIF as RGB (a mode-L frame's grey
    thrice)."""
    back = decode_gif(data, 3)
    return np.repeat(back[..., None], 3, 2) if back.ndim == 2 else back


def pil_quantize(rgb):
    im = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE)
    return np.asarray(im.getpalette(), np.uint8).reshape(-1, 3), \
        np.asarray(im)


@pytest.fixture(scope="module")
def coder(tmp_path_factory):
    """csrc/gif_encode.cu built with g++, typed as ops/_build types it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host coder")
    lib = tmp_path_factory.mktemp("gif") / "libgif_encode_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", str(lib),
                    str(_build.CSRC / "gif_encode.cu")], check=True)
    library = ctypes.CDLL(str(lib))
    for symbol, argtypes in _build.KERNELS["gif_encode"].items():
        fn = getattr(library, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return library


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_fixture_pixels_are_the_recipes(name):
    """The port's readers make the pixels PIL's made for the digests."""
    px = pixels(name)
    assert list(px.shape) == ENTRIES[name]["shape"]
    assert digest(px.tobytes()) == ENTRIES[name]["pixels_sha256"]


RGB = sorted(n for n, e in ENTRIES.items() if len(e["shape"]) == 3)
SMALL = sorted(n for n, e in ENTRIES.items()
               if np.prod(e["shape"][:2]) <= TWIN_PIXELS)


@pytest.mark.parametrize("name", sorted(set(RGB) & set(SMALL)))
def test_quantiser_is_pils_adaptive_palette(name):
    rgb = pixels(name)
    palette, index = gif_quant.quantize(rgb)
    want_palette, want_index = pil_quantize(rgb)
    np.testing.assert_array_equal(palette, want_palette)
    np.testing.assert_array_equal(index, want_index)


@pytest.mark.parametrize("name", RGB)
def test_native_quantiser_is_pils_adaptive_palette(coder, name):
    rgb = pixels(name)
    palette, index = gif_write._quantize_native(coder, rgb)
    want_palette, want_index = pil_quantize(rgb)
    np.testing.assert_array_equal(palette, want_palette)
    np.testing.assert_array_equal(index, want_index)


@settings(max_examples=30, deadline=None, database=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       levels=st.sampled_from([2, 3, 7, 256]), seed=st.integers(0, 2**31))
def test_quantiser_sweep(h, w, levels, seed):
    rng = np.random.default_rng(seed)
    rgb = (rng.integers(0, levels, (h, w, 3)) * (255 // (levels - 1))
           ).astype(np.uint8)
    palette, index = gif_quant.quantize(rgb)
    want_palette, want_index = pil_quantize(rgb)
    np.testing.assert_array_equal(palette, want_palette)
    np.testing.assert_array_equal(index, want_index)


@pytest.mark.parametrize("name", SMALL)
def test_twin_writes_pils_bytes(name):
    data = gif_write.encode_gif(pixels(name))
    assert digest(data) == ENTRIES[name]["sha256"]
    assert len(data) == ENTRIES[name]["bytes"]


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_native_coder_writes_pils_bytes(coder, name):
    px = pixels(name)
    data = gif_write.encode_gif(px, native=True, library=coder)
    assert digest(data) == ENTRIES[name]["sha256"]
    assert data == pil_gif(px)
    back = read_back(data)
    if px.ndim == 2:
        np.testing.assert_array_equal(back, np.repeat(px[..., None], 3, 2))
    else:
        palette, index = pil_quantize(px)
        np.testing.assert_array_equal(back, palette[index])


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), grey=st.booleans(),
       seed=st.integers(0, 2**31))
def test_bytes_sweep(coder, h, w, grey, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w) if grey else (h, w, 3), np.uint8)
    want = pil_gif(px)
    assert gif_write.encode_gif(px) == want
    assert gif_write.encode_gif(px, native=True, library=coder) == want


@pytest.mark.parametrize("h,w,interlaced", [(15, 40, False), (40, 15, False),
                                            (16, 16, True), (61, 37, True)])
def test_interlace_and_round_trip(h, w, interlaced):
    px = np.random.default_rng(h * w).integers(0, 256, (h, w), np.uint8)
    data = gif_write.encode_gif(px)
    flags = data[13 + 3 * (2 << gif_write.color_table_size(
        len(np.unique(px)))) + 9]
    assert bool(flags & 0x40) == interlaced
    np.testing.assert_array_equal(read_back(data),
                                  np.repeat(px[..., None], 3, 2))
    assert data == pil_gif(px)


def test_lzw_fills_and_clears_its_table():
    """Noise past 4,095 codes: Clear codes inside the data, as PIL's."""
    px = np.random.default_rng(0).integers(0, 256, (120, 160), np.uint8)
    codes = gif_write.lzw_codes(px.tobytes())
    clears = [i for i, (c, _) in enumerate(codes) if c == 256]
    assert len(clears) > 2 and max(w for _, w in codes) == 12


def test_write_image_needs_a_card_unless_told(tmp_path, monkeypatch):
    px = np.zeros((4, 5, 3), np.uint8)
    assert imageio.write_image(tmp_path / "x.gif", px, device="cpu") == "GIF"
    assert (tmp_path / "x.gif").read_bytes() == pil_gif(px)
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imageio.write_image(tmp_path / "y.gif", px)


def test_native_coder_that_cannot_build_raises(tmp_path, monkeypatch):
    """On the card's path a coder that fails to build raises; the twin
    does not take over."""
    def fail(name, defines=()):
        raise RuntimeError(f"nvcc failed for {name}.cu")
    monkeypatch.setattr(_build, "load_library", fail)
    with pytest.raises(RuntimeError, match="gif_encode"):
        imageio.write_image(tmp_path / "x.gif", np.zeros((4, 4), np.uint8),
                            device="cuda")
    assert not (tmp_path / "x.gif").exists()
