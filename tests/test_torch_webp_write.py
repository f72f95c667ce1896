"""Lossy WebP writing on the CPU, against PIL 12.1 (libwebp 1.6.0).

The encoder (``io/vp8_write.py``, the Python twin, and
``csrc/webp_encode.cu``, built with g++ once for the module) writes PIL's
``save(format="WEBP")`` byte for byte. Where it would not, the stage at
which it departs is what a failure names, in the order the bitstream
shows them through the port's own VP8 reader (``io/vp8.py``): the frame
header (segment quantisers and filter strengths, filter level, quantiser
deltas, coefficient probability updates), the segment map, each
macroblock's modes, its quantised coefficients, then the bytes; each
fixture's stage is printed. Before them the colour conversion is held to
libwebp's own ``WebPPictureImportRGB`` (the system's libwebp.so.7, whose
encoder writes PIL's bytes; skipped where it is absent).

The fixtures are ``webp_writes`` of ``tests/torch_imageio/manifest.json``
(pixels from ``torch_write_inputs``' recipes; PIL's size, sha256 and the
PSNR of its decode): the twin on those up to 64 x 64, the C++ form on
every one, the drawn still and the 768 x 1024 clip frame included, and
both on small random pictures from hypothesis. The encoder's tables equal
``libwebp.a``'s symbols where the archive is installed, and the C++
header's. ``write_image`` takes the twin only where the caller names the
CPU; with no card and no device it raises, and so does an encoder that
cannot be built.
"""

import ctypes
import io
import json
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io import vp8_enc_tables, vp8_write
from superviseddescent_tpu_torch.io import vp8_tables as T
from superviseddescent_tpu_torch.io.vp8 import (
    BoolDecoder, decode_vp8, frame_size)
from superviseddescent_tpu_torch.ops import _build
from test_torch_webp_lossy import LIBWEBP_A, ar_members, elf_symbols
from torch_imageio_fixtures import OUT as FIXTURES
from torch_write_inputs import (
    SMALL, digest, make_pixels, port_readers, psnr)

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    ENTRIES = {e["name"]: e for e in json.load(_f)["webp_writes"]}
TWIN = sorted(n for n, e in ENTRIES.items()
              if np.prod(e["shape"][:2]) <= SMALL)


def pixels(name):
    return make_pixels(ENTRIES[name]["recipe"], *port_readers())


def pil_webp(px) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "WEBP")
    return buf.getvalue()


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    """csrc/webp_encode.cu built with g++, typed as ops/_build types it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host encoder")
    lib = tmp_path_factory.mktemp("webp") / "libwebp_encode_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", str(lib),
                    str(_build.CSRC / "webp_encode.cu")], check=True)
    library = ctypes.CDLL(str(lib))
    for symbol, argtypes in _build.KERNELS["webp_encode"].items():
        fn = getattr(library, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return library


# ---- the stages ----
def frame_header(payload: bytes) -> dict:
    """Partition 0's frame header, read as libwebp's decoder reads it."""
    _, _, part0 = frame_size(payload)
    br = BoolDecoder(payload[10:10 + part0])
    out = {"colour": (br.bit(0x80), br.bit(0x80))}
    if br.bit(0x80):
        out["update_map"] = br.bit(0x80)
        if br.bit(0x80):
            out["absolute"] = br.bit(0x80)
            out["segment_quant"] = [br.optional_signed(7) for _ in range(4)]
            out["segment_filter"] = [br.optional_signed(6) for _ in range(4)]
        if out["update_map"]:
            out["segment_probas"] = [br.value_bits(8) if br.bit(0x80)
                                     else 255 for _ in range(3)]
    out["filter"] = (br.bit(0x80), br.value_bits(6), br.value_bits(3),
                     br.bit(0x80))
    out["partitions"] = br.value_bits(2)
    out["quant"] = (br.value_bits(7),
                    [br.optional_signed(4) for _ in range(5)])
    br.bit(0x80)
    out["probas"] = [(t, b, c, p, br.value_bits(8))
                     for t in range(4) for b in range(8) for c in range(3)
                     for p in range(11)
                     if br.bit(T.COEFFS_UPDATE_PROBA[t][b][c][p])]
    out["use_skip"] = br.bit(0x80)
    return out


def first_departure(ours: bytes, theirs: bytes) -> str:
    """The first stage at which our file departs from PIL's, and where."""
    if ours == theirs:
        return "equal"
    a, b = ours[20:], theirs[20:]
    if frame_size(a)[:2] != frame_size(b)[:2]:
        return "frame size"
    ha, hb = frame_header(a), frame_header(b)
    for key in hb:
        if ha.get(key) != hb[key]:
            return f"frame header: {key}"
    fa, fb = decode_vp8(a), decode_vp8(b)
    for stage, sa, sb in (("segment map", fa.modes[:, 19], fb.modes[:, 19]),
                          ("modes", fa.modes, fb.modes),
                          ("coefficients", fa.coeffs, fb.coeffs)):
        diff = np.flatnonzero((sa != sb).reshape(len(sa), -1).any(1))
        if len(diff):
            mb = int(diff[0])
            return (f"{stage}: macroblock {mb} (row {mb // fa.mb_w}, column "
                    f"{mb % fa.mb_w})")
    return "bytes"


# ---- the tables ----
ENC_TABLES = {  # module name: (libwebp object, symbol, dtype)
    "AC_TABLE2": ("quant_enc", "kAcTable2", "<u2"),
    "BIAS_MATRICES": ("quant_enc", "kBiasMatrices", "u1"),
    "WEIGHT_Y": ("quant_enc", "kWeightY", "<u2"),
    "LEVELS_FROM_DELTA": ("filter_enc", "kLevelsFromDelta", "u1"),
    "ENTROPY_COST": ("cost", "VP8EntropyCost", "<u2"),
    "LEVEL_FIXED_COSTS": ("cost", "VP8LevelFixedCosts", "<u2"),
    "LEVEL_CODES": ("cost_enc", "VP8LevelCodes", "<u2"),
    "FIXED_COSTS_I4": ("cost_enc", "VP8FixedCostsI4", "<u2"),
    "FIXED_COSTS_I16": ("cost_enc", "VP8FixedCostsI16", "<u2"),
    "FIXED_COSTS_UV": ("cost_enc", "VP8FixedCostsUV", "<u2"),
    "ENC_BANDS": ("cost", "VP8EncBands", "u1"),
    "TOP_LEFT_I4": ("iterator_enc", "VP8TopLeftI4", "u1"),
}


def test_tables_equal_libwebps_own():
    if not os.path.exists(LIBWEBP_A):
        pytest.skip(f"no {LIBWEBP_A}")
    with open(LIBWEBP_A, "rb") as f:
        members = ar_members(f.read())
    objects = {}
    for name, (obj, symbol, dtype) in ENC_TABLES.items():
        if obj not in objects:
            member, = [m for m in members if m.endswith(f"-{obj}.o")]
            objects[obj] = elf_symbols(members[member])
        ours = np.asarray(getattr(vp8_enc_tables, name)).astype(dtype)
        assert ours.tobytes() == objects[obj][symbol], name


def test_header_holds_the_same_tables():
    with open(_build.CSRC / "vp8_enc_tables.h") as f:
        text = f.read()
    arrays = dict(re.findall(r"constexpr \w+ (\w+)\[[^=]*= \{([^}]*)\};",
                             text))
    names = dict(ENC_TABLES, FREQ_SHARPENING=None)
    assert len(arrays) == len(names)
    for name in names:
        key = "k" + "".join(w.capitalize() for w in name.lower().split("_"))
        key = key.replace("Uv", "UV")
        values = [int(v) for v in arrays[key].replace("\n", " ").split(",")]
        assert values == list(getattr(vp8_enc_tables, name)), name


# ---- the colour conversion ----
def libwebp_import_rgb(rgb: np.ndarray):
    """libwebp's Y, U and V planes of ``WebPPictureImportRGB`` (the
    system's libwebp.so.7), or None where that library is absent."""
    try:
        lib = ctypes.CDLL("libwebp.so.7")
    except OSError:
        return None
    pic = ctypes.create_string_buffer(1024)
    lib.WebPPictureInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.WebPPictureImportRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int]
    lib.WebPPictureFree.argtypes = [ctypes.c_void_p]
    assert lib.WebPPictureInitInternal(pic, 0x020f)
    h, w = rgb.shape[:2]
    ctypes.memmove(ctypes.addressof(pic) + 8, np.array([w, h], np.int32)
                   .ctypes.data, 8)
    rgb = np.ascontiguousarray(rgb)
    assert lib.WebPPictureImportRGB(pic, rgb.ctypes.data, 3 * w)
    raw = pic.raw
    y, u, v = (int.from_bytes(raw[o:o + 8], "little") for o in (16, 24, 32))
    ys, uvs = (int.from_bytes(raw[o:o + 4], "little") for o in (40, 44))

    def plane(ptr, stride, pw, ph):
        buf = (ctypes.c_uint8 * (stride * ph)).from_address(ptr)
        return np.ctypeslib.as_array(buf).reshape(ph, stride)[:, :pw].copy()
    out = (plane(y, ys, w, h), plane(u, uvs, (w + 1) // 2, (h + 1) // 2),
           plane(v, uvs, (w + 1) // 2, (h + 1) // 2))
    lib.WebPPictureFree(pic)
    return out


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_colour_conversion_is_libwebps(name):
    px = pixels(name)
    rgb = px if px.ndim == 3 else np.repeat(px[..., None], 3, 2)
    want = libwebp_import_rgb(rgb)
    if want is None:
        pytest.skip("no libwebp.so.7")
    for got, ref in zip(vp8_write.rgb_to_yuv420(rgb), want):
        np.testing.assert_array_equal(got, ref)


# ---- the files ----
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_fixture_pixels_are_the_recipes(name):
    px = pixels(name)
    assert list(px.shape) == ENTRIES[name]["shape"]
    assert digest(px.tobytes()) == ENTRIES[name]["pixels_sha256"]


@pytest.mark.parametrize("name", TWIN)
def test_twin_writes_pils_bytes(name, capsys):
    px = pixels(name)
    data = vp8_write.encode_webp(px)
    stage = first_departure(data, pil_webp(px))
    with capsys.disabled():
        print(f"\n{name}: {stage}")
    assert stage == "equal"
    assert digest(data) == ENTRIES[name]["sha256"]


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_native_encoder_writes_pils_bytes(encoder, name, tmp_path):
    px = pixels(name)
    data = vp8_write.encode_webp(px, native=True, library=encoder)
    assert first_departure(data, pil_webp(px)) == "equal"
    assert digest(data) == ENTRIES[name]["sha256"]
    assert len(data) == ENTRIES[name]["bytes"]
    # the committed PSNR is that of the port's own decode of the file
    rgb = px if px.ndim == 3 else np.repeat(px[..., None], 3, 2)
    (tmp_path / "x.webp").write_bytes(data)
    back = imageio.read_rgb(tmp_path / "x.webp", device="cpu")
    assert psnr(rgb, back) == pytest.approx(ENTRIES[name]["psnr"], abs=0)


@settings(max_examples=20, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       kind=st.sampled_from(["noise", "blocks", "grey"]),
       seed=st.integers(0, 2**31))
def test_bytes_sweep(encoder, h, w, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        px = rng.integers(0, 256, (h, w, 3), np.uint8)
    elif kind == "blocks":
        px = np.repeat(np.repeat(rng.integers(0, 256, (h, w, 3), np.uint8),
                                 4, 0), 4, 1)[:h, :w]
    else:
        px = rng.integers(0, 256, (h, w), np.uint8)
    want = pil_webp(px)
    assert first_departure(vp8_write.encode_webp(px), want) == "equal"
    assert vp8_write.encode_webp(px, native=True, library=encoder) == want


def test_write_image_needs_a_card_unless_told(tmp_path, monkeypatch):
    px = np.full((9, 11, 3), 77, np.uint8)
    assert imageio.write_image(tmp_path / "x.webp", px,
                               device="cpu") == "WEBP"
    assert (tmp_path / "x.webp").read_bytes() == pil_webp(px)
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imageio.write_image(tmp_path / "y.webp", px)


def test_native_encoder_that_cannot_build_raises(tmp_path, monkeypatch):
    def fail(name, defines=()):
        raise RuntimeError(f"nvcc failed for {name}.cu")
    monkeypatch.setattr(_build, "load_library", fail)
    with pytest.raises(RuntimeError, match="webp_encode"):
        imageio.write_image(tmp_path / "x.webp",
                            np.zeros((4, 4, 3), np.uint8), device="cuda")
    assert not (tmp_path / "x.webp").exists()
