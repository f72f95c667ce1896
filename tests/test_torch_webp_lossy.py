"""Lossy WebP (VP8 and its ALPH chunk) on the CPU, against PIL, libwebp and
the JAX package.

Every lossy fixture (``tests/torch_imageio/v*.webp`` and the 768 x 1024
``f08_clip_lossy.webp``, written by ``tests/torch_imageio_fixtures.py``
with PIL's encoder and libwebp's through ``tests/torch_webp_writer.c``)
still matches PIL's digests in the manifest and reads through the twins
(the Python entropy stage of ``io/vp8.py``, then ``ops/webp.py``'s plain
W1, W2 and W3) as the JAX package reads it: ``load_gray_image`` bit-equal
to the JAX package's, ``read_rgb`` equal to PIL's ``convert("RGB")``. The
twins' Y / U / V planes equal libwebp's ``WebPDecodeYUV`` (skipped where
``libwebp.so.7`` is absent), an ALPH chunk's alpha equals PIL's, the
host C++ entropy stage (``csrc/webp_decode.cu``, built here with g++)
equals the Python twin, and the decoder's tables equal libwebp's own
(``libwebp.a``'s decoder objects, skipped where the archive is absent).
Together the fixtures use every mode, both filters, every partition
count, segments with deltas, the loop filter's deltas and every ALPH
kind (counted in the twins). Damaged streams raise where PIL raises.
``tests/test_torch_apps_io.py`` runs ``rcr_detect -i x.webp`` against the
JAX app.
"""

import ctypes
import hashlib
import io
import json
import os
import re
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io import vp8_tables
from superviseddescent_tpu_torch.io.vp8 import (
    decode_vp8, decode_vp8_native, frame_size)
from superviseddescent_tpu_torch.io.webp import (
    _chunks, compose, decode_alpha, decode_vp8l, decode_webp)
from superviseddescent_tpu_torch.ops import webp as W
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_apps_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_imageio_fixtures import OUT as FIXTURES
from torch_imageio_fixtures import libwebp_yuv, pil_digests, riff, vp8_of

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "superviseddescent_tpu_torch", "csrc")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
CLIP = "f08_clip_lossy.webp"
SMALL = [n for n in MANIFEST["groups"]["webp_lossy"] if n != CLIP]
LIBWEBP_A = "/usr/lib/x86_64-linux-gnu/libwebp.a"
# the twins are many small operations: one thread each, as fast alone and
# not oversubscribed beside other test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")
# held to libwebp's planes live (every still is held to their committed
# digests): one a writer and a filter kind
YUV_LIVE = ("v00_q0_m4.webp", "v06_1x37.webp", "v08_33x17.webp",
            "v12_rgba_aq100.webp", "v16_simple_sharp7.webp",
            "v21_partitions8.webp", "v26_segment_deltas.webp",
            "v27_lf_deltas.webp")


def sha(a) -> str:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def stages(frame):
    """A Vp8Frame through the three twins: (cropped Y, U, V planes after
    W2, RGB, grey)."""
    f = frame
    planes = W.reconstruct_reference(torch.as_tensor(f.coeffs),
                                     torch.as_tensor(f.modes), f.mb_w, f.mb_h)
    planes = W.filter_reference(*planes, torch.as_tensor(f.filters),
                                f.filter_type, f.mb_w, f.mb_h)
    uh, uw = (f.height + 1) // 2, (f.width + 1) // 2
    cropped = (planes[0][:f.height, :f.width], planes[1][:uh, :uw],
               planes[2][:uh, :uw])
    return (cropped, W.colour_reference(*planes, f.width, f.height, 3),
            W.colour_reference(*planes, f.width, f.height, 1))


@pytest.mark.parametrize("name", SMALL)
def test_lossy_webp_reads_as_the_jax_package_and_pil_do(name, monkeypatch):
    path = os.path.join(FIXTURES, name)
    want = MANIFEST["files"][name]
    assert pil_digests(path) == {k: want[k] for k in (
        "shape", "mode", "grey_sha256", "rgb_sha256")}
    grey = load_gray_image(path, device="cpu")
    np.testing.assert_array_equal(grey, jax_load_gray(path))
    filtered = []
    twin = W.vp8_filter

    def keep(*args):
        filtered.append(twin(*args))
        return filtered[-1]
    monkeypatch.setattr(W, "vp8_filter", keep)       # the planes read_rgb
    rgb = imageio.read_rgb(path, device="cpu")       # goes through
    with Image.open(path) as im:
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))
    assert sha(rgb) == want["rgb_sha256"]
    if "yuv_sha256" in want:
        (y, u, v), = filtered
        h, w = rgb.shape[:2]
        assert [sha(y[:h, :w]), sha(u[:(h + 1) // 2, :(w + 1) // 2]),
                sha(v[:(h + 1) // 2, :(w + 1) // 2])] == want["yuv_sha256"]
    if "alpha_sha256" in want:
        data = read(name)
        chunks = {c: body for c, body, _ in _chunks(data, 12, len(data))}
        alpha = decode_alpha(chunks[b"ALPH"], rgb.shape[1], rgb.shape[0],
                             decode_vp8l)
        assert sha(alpha) == want["alpha_sha256"]


@pytest.fixture(scope="module")
def host_stage(tmp_path_factory):
    """csrc/webp_decode.cu (host code only) built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host decoder")
    lib = tmp_path_factory.mktemp("webp_lossy") / "libwebp_decode.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib),
                    os.path.join(CSRC, "webp_decode.cu")], check=True)
    decoder = ctypes.CDLL(str(lib))
    decoder.webp_decode_vp8l.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    decoder.webp_decode_vp8.argtypes = [ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    return decoder


def _blank(payload):
    """Black pixels of the frame's size, for ``compose`` where a test
    takes the payload itself."""
    width, height, _ = frame_size(payload)
    return np.zeros((height, width, 3), np.uint8)


def vp8_payloads(name):
    """The VP8 payloads ``compose`` hands the lossy decoder, as read."""
    out = []

    def keep(payload):
        out.append(payload)
        return _blank(payload)
    compose(read(name), decode_vp8l, keep)
    return out


def test_host_stage_equals_the_twin(host_stage):
    for name in SMALL + [CLIP]:
        for payload in vp8_payloads(name):
            got = decode_vp8_native(payload, host_stage)
            want = decode_vp8(payload)
            assert got.info == want.info, name
            for key in ("coeffs", "modes", "filters"):
                np.testing.assert_array_equal(getattr(got, key).numpy(),
                                              getattr(want, key),
                                              err_msg=f"{name} {key}")


def test_clip_frame_through_the_host_stage_and_twins(host_stage):
    """The 768 x 1024 frame: the C++ entropy stage, then the twins, equal
    to libwebp's planes and PIL's pixels; read_gray through the Python
    twin too, as the JAX package reads it."""
    want = MANIFEST["files"][CLIP]
    payload, = vp8_payloads(CLIP)
    planes, rgb, grey = stages(decode_vp8_native(payload, host_stage))
    assert [sha(p) for p in planes] == want["yuv_sha256"]
    assert sha(rgb) == want["rgb_sha256"]
    assert sha(grey) == want["grey_sha256"]


def test_twin_planes_equal_webp_decode_yuv():
    if libwebp_yuv(read(SMALL[0])) is None:
        pytest.skip("no libwebp.so.7 with WebPDecodeYUV")
    checked = 0
    for name in YUV_LIVE:
        data = read(name)
        want = libwebp_yuv(data)
        chunks = {c: padded for c, _, padded in _chunks(data, 12,
                                                        len(data))}
        planes, _, _ = stages(decode_vp8(chunks[b"VP8 "]))
        for got, ref in zip(planes, want):
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        checked += 1
    assert checked == len(YUV_LIVE)


def test_unfiltered_planes_are_what_libwebp_predicts_from():
    """Filter level 0: W1's planes are the final ones, equal to libwebp's;
    libwebp predicts from samples before the loop filter."""
    if libwebp_yuv(read(SMALL[0])) is None:
        pytest.skip("no libwebp.so.7 with WebPDecodeYUV")
    for name in ("v03_q100_m6.webp", "v18_strength0.webp"):
        data = read(name)
        f = decode_vp8(vp8_of(data))
        assert f.filter_type == 0
        y, u, v = W.reconstruct_reference(torch.from_numpy(f.coeffs),
                                          torch.from_numpy(f.modes),
                                          f.mb_w, f.mb_h)
        want = libwebp_yuv(data)
        np.testing.assert_array_equal(y[:f.height, :f.width].numpy(), want[0])


# ---- the tables ----
def ar_members(data: bytes) -> dict:
    """The members of a System V / GNU ``ar`` archive by name."""
    assert data[:8] == b"!<arch>\n"
    pos, names, out = 8, b"", {}
    while pos + 60 <= len(data):
        header = data[pos:pos + 60]
        name, size = header[:16].decode().strip(), int(header[48:58])
        body = data[pos + 60:pos + 60 + size]
        if name == "//":
            names = body
        elif name.startswith("/") and name[1:].isdigit():
            start = int(name[1:])
            out[names[start:names.index(b"/\n", start)].decode()] = body
        elif name not in ("/", "/SYM64/"):
            out[name.rstrip("/")] = body
        pos += 60 + size + (size & 1)
    return out


def elf_symbols(obj: bytes) -> dict:
    """The bytes of every sized symbol in a PROGBITS section of a 64-bit
    little-endian ELF object, local ones included."""
    (shoff,) = struct.unpack_from("<Q", obj, 0x28)
    entsize, count = struct.unpack_from("<HH", obj, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", obj, shoff + i * entsize)
                for i in range(count)]
    out = {}
    for sec in sections:
        if sec[1] != 2:                                  # SHT_SYMTAB
            continue
        strtab = sections[sec[6]][4]
        for k in range(sec[5] // sec[9]):
            name, _, _, shndx, value, size = struct.unpack_from(
                "<IBBHQQ", obj, sec[4] + k * sec[9])
            if size and 0 < shndx < count and sections[shndx][1] == 1:
                at = strtab + name
                key = obj[at:obj.index(b"\0", at)].decode()
                start = sections[shndx][4] + value
                out[key] = obj[start:start + size]
    return out


TABLES = {  # module name: (libwebp object, symbol, numpy dtype)
    "DC_TABLE": ("quant_dec", "kDcTable", "u1"),
    "AC_TABLE": ("quant_dec", "kAcTable", "<u2"),
    "COEFFS_PROBA0": ("tree_dec", "CoeffsProba0", "u1"),
    "COEFFS_UPDATE_PROBA": ("tree_dec", "CoeffsUpdateProba", "u1"),
    "BMODES_PROBA": ("tree_dec", "kBModesProba", "u1"),
    "YMODES_INTRA4": ("tree_dec", "kYModesIntra4", "i1"),
    "BANDS": ("tree_dec", "kBands", "u1"),
    "ZIGZAG": ("vp8_dec", "kZigzag", "u1"),
    "CAT3": ("vp8_dec", "kCat3", "u1"), "CAT4": ("vp8_dec", "kCat4", "u1"),
    "CAT5": ("vp8_dec", "kCat5", "u1"), "CAT6": ("vp8_dec", "kCat6", "u1"),
}


def test_tables_equal_libwebps_own():
    if not os.path.exists(LIBWEBP_A):
        pytest.skip(f"no {LIBWEBP_A}")
    with open(LIBWEBP_A, "rb") as f:
        members = ar_members(f.read())
    objects = {}
    for name, (obj, symbol, dtype) in TABLES.items():
        if obj not in objects:
            member, = [m for m in members if m.endswith(f"-{obj}.o")]
            objects[obj] = elf_symbols(members[member])
        ours = np.asarray(getattr(vp8_tables, name)).astype(dtype)
        assert ours.tobytes() == objects[obj][symbol], name


def test_header_holds_the_same_tables():
    with open(os.path.join(CSRC, "vp8_tables.h")) as f:
        text = f.read()
    arrays = dict(re.findall(r"constexpr \w+ (\w+)\[[^=]*= \{([^}]*)\};",
                             text))
    assert len(arrays) == len(TABLES)
    for name in TABLES:
        key = "k" + "".join(w.capitalize() for w in name.lower().split("_"))
        key = key.replace("Bmodes", "BModes").replace("Ymodes", "YModes")
        values = [int(v) for v in arrays[key].replace("\n", " ").split(",")]
        assert values == np.asarray(getattr(vp8_tables, name)).ravel(
            ).tolist(), name


# ---- coverage ----
def test_fixtures_cover_the_bitstream():
    stats = {}

    def count(payload):
        decode_vp8(payload, stats)
        return _blank(payload)
    for name in SMALL:
        compose(read(name), decode_vp8l, count, stats)
    assert stats["y16_modes"] == {0, 1, 2, 3}
    assert stats["b_modes"] == set(range(10))
    assert stats["uv_modes"] == {0, 1, 2, 3}
    assert stats["filter_types"] == {0, 1, 2}        # none, simple, normal
    assert stats["partitions"] == {1, 2, 4, 8}
    assert stats["segments"] == {0, 1, 2, 3}
    assert stats["segment_modes"] == {"absolute", "delta"}
    assert stats["lf_deltas"] and stats["skip_proba"]
    assert stats["sharpness"] >= {0, 5, 7}
    assert stats["alph_compression"] == {0, 1}
    assert stats["alph_filter"] == {"none", "horizontal", "vertical",
                                    "gradient"}


# ---- damaged streams ----
def damaged(kind: str) -> bytes:
    p = vp8_of(read("v20_partitions4.webp"))
    part0 = int.from_bytes(p[:3], "little") >> 5
    return riff([(b"VP8 ", {
        "cut tokens": p[:len(p) * 3 // 4],
        "cut last token bytes": p[:-3],
        "cut partition 0": p[:10 + part0 // 2],
        "cut partition sizes": p[:10 + part0 + 4],
        "bad start code": p[:3] + b"\x9d\x01\x2b" + p[6:],
        "inter frame": bytes([p[0] | 1]) + p[1:],
        "hidden frame": bytes([p[0] & ~0x10]) + p[1:],
        "profile 5": bytes([(p[0] & ~0x0E) | 10]) + p[1:],
        "header": p[:8]}[kind])])


@pytest.mark.parametrize("kind", [
    "cut tokens", "cut last token bytes", "cut partition 0",
    "cut partition sizes", "bad start code", "inter frame", "hidden frame",
    "profile 5", "header"])
def test_damaged_streams_raise_as_pil_does(kind, host_stage):
    data = damaged(kind)
    with pytest.raises(OSError):
        with Image.open(io.BytesIO(data)) as im:
            im.convert("RGB")
    with pytest.raises(ValueError, match="VP8"):
        decode_webp(data, device="cpu")
    with pytest.raises(ValueError, match="VP8"):
        compose(data, decode_vp8l, lambda p: decode_vp8_native(p, host_stage))


def test_a_stream_short_of_its_pad_byte_reads_as_pil_reads_it():
    """libwebp's last token partition runs over the chunk's pad byte: a
    stream cut by one byte still decodes, in PIL and in the port."""
    for name in ("v01_q50_m4.webp", "v21_partitions8.webp"):
        p = vp8_of(read(name))
        for cut in (1, 2, 3, 4):
            data = riff([(b"VP8 ", p[:-cut])])
            try:
                with Image.open(io.BytesIO(data)) as im:
                    want = np.asarray(im.convert("RGB"))
            except OSError:
                with pytest.raises(ValueError, match="VP8"):
                    decode_webp(data, device="cpu")
                continue
            np.testing.assert_array_equal(decode_webp(data, device="cpu"),
                                          want)


def test_damaged_alph_raises_as_pil_does():
    data = read("v28_alph_none_raw.webp")
    chunks = [(c, body) for c, body, _ in _chunks(data, 12, len(data))]
    for bad in (lambda a: a[:len(a) // 2], lambda a: bytes([a[0] | 0x40])
                + a[1:], lambda a: a[:1]):
        broken = riff([(c, bad(b) if c == b"ALPH" else b)
                       for c, b in chunks])
        with pytest.raises(OSError):
            with Image.open(io.BytesIO(broken)) as im:
                im.convert("RGB")
        with pytest.raises(ValueError, match="ALPH"):
            decode_webp(broken, device="cpu")
