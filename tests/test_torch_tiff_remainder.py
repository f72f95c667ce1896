"""The rest of the TIFF files PIL reads, on the CPU: BigTIFF, CCITT RLE /
Group 3 / Group 4, Zstandard and YCbCr under the lossless compressions.

Every fixture of ``tests/torch_imageio/`` group ``tiff_remainder``
(written by ``tests/torch_imageio_fixtures.py``) still matches PIL's
digests in the manifest and reads as the JAX package reads it:
``load_gray_image(..., device="cpu")`` bit-equal to the JAX package's,
``read_rgb`` equal to PIL's ``convert("RGB")``; a file PIL cannot read
(a big-endian BigTIFF) raises here by name. The host C++ decoders of
``csrc/tiff_decode.cu``, built with g++ once for the module, give the
Python twins' bytes on every fixture and on the clip-sized ones, and the
twins' errors on damaged strips. The Zstandard twin equals the
``zstandard`` package on every frame. The kinds still refused raise
naming themselves.
"""

import ctypes
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import zlib

import numpy as np
import pytest
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io import ccitt, zstd
from superviseddescent_tpu_torch.io import image as imageio
from superviseddescent_tpu_torch.io import tiff as tiffio
from superviseddescent_tpu_torch.ops import _build
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_imageio_fixtures import OUT as FIXTURES
from torch_imageio_fixtures import (
    pil_digests, small_rgb, t4_rows, tiff, ycbcr_units, zstd_tiff)

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
FILES = MANIFEST["groups"]["tiff_remainder"]
CLIPS = MANIFEST["groups"]["clip_remainder"]


def read(name) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def strips(data: bytes):
    """(compression, [each strip's or tile's bytes], tags) of a page."""
    _, tags = tiffio._ifd(data)
    offsets = tags.get(273) or tags.get(324)
    counts = tags.get(279) or tags.get(325)
    return tags.get(259, (1,))[0], [data[o:o + n] for o, n in zip(
        offsets, counts)], tags


@pytest.fixture(scope="module")
def host_decoder(tmp_path_factory):
    """csrc/tiff_decode.cu built with g++, its entry points typed as
    ops/_build types them for the card's build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host decoders")
    lib = tmp_path_factory.mktemp("tiff") / "libtiff_decode_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", str(lib),
                    str(_build.CSRC / "tiff_decode.cu")], check=True)
    decoder = ctypes.CDLL(str(lib))
    for symbol, argtypes in _build.KERNELS["tiff_decode"].items():
        fn = getattr(decoder, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return decoder


@pytest.mark.parametrize("name", FILES)
def test_reads_as_the_jax_package_and_pil_do(name):
    path = os.path.join(FIXTURES, name)
    want = MANIFEST["files"][name]
    got = pil_digests(path)
    assert got == {k: want[k] for k in got}
    if "pil_error" in want:              # PIL cannot read it: neither can we
        with pytest.raises(ValueError, match="not a kind PIL reads"):
            load_gray_image(path, device="cpu")
        return
    grey = load_gray_image(path, device="cpu")
    np.testing.assert_array_equal(grey, jax_load_gray(path))
    rgb = imageio.read_rgb(path, device="cpu")
    with Image.open(path) as im:
        np.testing.assert_array_equal(rgb, np.asarray(im.convert("RGB")))
    assert sha(rgb) == want["rgb_sha256"]


NATIVE_FILES = [n for n in FILES + CLIPS if "pil_error" not in
                MANIFEST["files"][n] and tiffio.compression(read(n))
                in tiffio.NATIVE]


@pytest.mark.parametrize("name", NATIVE_FILES)
def test_host_decoders_give_the_twins_pixels(host_decoder, name):
    """The C++ decoders through ``decode_tiff`` (as the card's path takes
    them) equal PIL's digests; on the small files, also the twins'
    pixels."""
    data = read(name)
    got = tiffio.decode_tiff(data, native=host_decoder)
    rgb = got if got.ndim == 3 else np.repeat(got[..., None], 3, axis=2)
    assert sha(rgb) == MANIFEST["files"][name]["rgb_sha256"]
    if name in FILES:
        np.testing.assert_array_equal(got, tiffio.decode_tiff(data))


def test_host_decoders_strip_by_strip(host_decoder):
    """Each strip of every CCITT and Zstandard fixture: the C++ bytes are
    the twin's."""
    for name in NATIVE_FILES:
        if name not in FILES:
            continue
        kind, chunks, tags = strips(read(name))
        width, height = tags[256][0], tags[257][0]
        per_strip = min(tags.get(278, (height,))[0], height)
        for k, chunk in enumerate(chunks):
            rows = min(per_strip, height - k * per_strip)
            if tags.get(266, (1,))[0] == 2:
                chunk = tiffio.REVERSED[np.frombuffer(chunk, np.uint8)
                                        ].tobytes()
            if kind == 50000:
                assert zstd.read_strip_native(
                    chunk, 1 << 20, library=host_decoder) == \
                    zstd.read_strip(chunk, 1 << 20)
            else:
                options = tags.get(292 if kind == 3 else 293, (0,))[0]
                assert ccitt.decode_ccitt_native(
                    chunk, kind, width, rows, options,
                    library=host_decoder) == ccitt.decode_ccitt(
                    chunk, kind, width, rows, options)


def damaged(chunk: bytes, rng, n: int):
    for _ in range(n):
        c = bytearray(chunk)
        for _ in range(int(rng.integers(1, 4))):
            c[int(rng.integers(0, len(c)))] ^= 1 << int(rng.integers(0, 8))
        yield bytes(c)
    yield chunk[:len(chunk) // 2]


def outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", ["r12_group4_pil.tif", "r13_group3_w61_p1.tif",
                                  "r10_ccitt_rle_pil.tif",
                                  "r18_group3_w3000_p0.tif"])
def test_damaged_ccitt_as_the_twin(host_decoder, name):
    """Bits flipped or a strip cut short: the C++ decoder fails where the
    twin fails, with its message, and gives its rows where it does not."""
    kind, chunks, tags = strips(read(name))
    width, rows = tags[256][0], min(tags.get(278, tags[257])[0],
                                    tags[257][0])
    options = tags.get(292, (0,))[0]
    rng = np.random.default_rng(7)
    failed = 0
    for c in damaged(chunks[0], rng, 30):
        want = outcome(ccitt.decode_ccitt, c, kind, width, rows, options)
        failed += isinstance(want, str)
        assert outcome(ccitt.decode_ccitt_native, c, kind, width, rows,
                       options, library=host_decoder) == want
    assert failed


@pytest.mark.parametrize("name", ["r23_zstd_level3_checksum.tif",
                                  "r24_zstd_level19.tif",
                                  "r21_zstd_rgb_predictor_pil.tif"])
def test_damaged_zstd_as_the_twin(host_decoder, name):
    _, chunks, _ = strips(read(name))
    rng = np.random.default_rng(8)
    failed = 0
    for c in damaged(chunks[0], rng, 30):
        want = outcome(zstd.read_strip, c, 1 << 20)
        failed += isinstance(want, str)
        assert outcome(zstd.read_strip_native, c, 1 << 20,
                       library=host_decoder) == want
    assert failed


def test_damaged_streams_raise_by_name():
    """Where libtiff warns and fills the row, the port refuses."""
    data = read("r12_group4_pil.tif")
    _, chunks, tags = strips(data)
    with pytest.raises(ValueError, match="CCITT: "):
        ccitt.decode_ccitt(b"\x00\x00\x00" + chunks[0][3:], 4,
                           tags[256][0], tags[257][0])
    good = zstd_tiff(small_rgb(), 47, 3, checksum=True)
    _, chunks, _ = strips(good)
    bad = chunks[0][:-1] + bytes([chunks[0][-1] ^ 1])
    with pytest.raises(ValueError, match="checksum mismatch"):
        zstd.read_strip(bad, 1 << 20)
    with pytest.raises(ValueError, match="Zstandard: no frame"):
        zstd.read_strip(b"\x00" * 8, 8)


def decompress(data: bytes) -> bytes:
    """Every frame of ``data`` in turn, skippable ones holding nothing."""
    out, pos = [], 0
    while pos < len(data):
        content, pos = zstd.decode_frame(data, pos)
        out.append(content)
    return b"".join(out)


def handmade_frames() -> list:
    """Frames no zstd level writes for small inputs, laid out by hand:
    RLE literals, and a block of 32,600 sequences (a 3-byte count) under
    RLE tables, each a 3-byte match at the second repeat offset."""
    def frame(blocks, size):
        fcs = bytes([0x20, size]) if size < 256 else bytes(
            [0xA0]) + struct.pack("<I", size)
        out = struct.pack("<I", 0xFD2FB528) + fcs
        for k, (kind, body) in enumerate(blocks):
            head = (k == len(blocks) - 1) | kind << 1 | len(body) << 3
            out += head.to_bytes(3, "little") + body
        return out
    rle_literals = bytes([30 << 3 | 1, ord("q"), 0])
    n = 32600
    sequences = bytes([0, 255, n - 0x7F00, 0, 0x54, 0, 0, 0, 1])
    return [frame([(0, b"abc"), (2, rle_literals)], 33),
            frame([(0, b"01234567"), (2, sequences)], 8 + 3 * n)]


def zstd_frames() -> list:
    """Frames that reach every part of the decoder: each Zstandard
    fixture's strips; the ``zstandard`` package's at levels 1, 3, 19 and
    -5 with and without the checksum; an RLE block, the previous tree
    (treeless literals), repeated and RLE sequence tables, direct 4-bit
    Huffman weights, one Huffman stream, content sizes of every residue
    mod 8 (XXH64's tails); and ``handmade_frames``."""
    zstandard = pytest.importorskip("zstandard")
    frames = []
    for name in FILES:
        data = read(name)
        if "pil_error" not in MANIFEST["files"][name] and \
                tiffio.compression(data) == 50000:
            frames += strips(data)[1]
    rng = np.random.default_rng(9)
    text = bytes(rng.choice(np.frombuffer(b"etaoin shrdlu", np.uint8),
                            150000))
    words = [bytes(rng.integers(97, 123, 4, dtype=np.uint8))
             for _ in range(40)]
    inputs = [(text, (1, 3, 19, -5)),
              (text[:5000] + bytes(300000), (3,)),
              (b"".join(words) + b"".join(b"Q" + words[int(i)] for i in
                                          rng.integers(0, 40, 40000)), (1,)),
              (b"".join(bytes([int(b)]) + b"xyz" for b in
                        rng.integers(0, 256, 40000)), (19,)),
              (bytes(rng.choice([1, 2, 3, 4, 5, 6], 5000).astype(np.uint8)),
               (19,)),
              (bytes(rng.choice([97, 98, 99, 100], 150,
                                p=[.7, .1, .1, .1]).astype(np.uint8)), (19,))]
    inputs += [(text[:n], (19,)) for n in range(33, 41)]
    for data, levels in inputs:
        for level in levels:
            for checksum in (False, True):
                frames.append(zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum).compress(data))
    frames.append(zstandard.ZstdCompressor(write_content_size=False)
                  .compress(text[:5000]))
    return frames + handmade_frames()


def test_zstd_twin_equals_zstandard_on_every_frame():
    zstandard = pytest.importorskip("zstandard")
    for frame in zstd_frames():
        assert decompress(frame) == zstandard.ZstdDecompressor(
        ).decompressobj().decompress(frame)


def test_zstd_host_decoder_on_every_frame(host_decoder):
    for frame in zstd_frames():
        want = zstd.read_strip(frame, 1 << 20)
        assert zstd.read_strip_native(frame, 1 << 20,
                                      library=host_decoder) == want


def test_zstd_skippable_and_several_frames():
    """Frame by frame, the skippable ones hold nothing;
    a strip, as libtiff reads it, is the first frame only, so a strip
    that starts with a skippable frame or needs a second frame is short,
    and PIL fails on it as the port does."""
    zstandard = pytest.importorskip("zstandard")
    skip = struct.pack("<II", 0x184D2A50, 3) + b"abc"
    a, b = b"first frame " * 40, b"second" * 30
    c = zstandard.ZstdCompressor()
    assert decompress(skip + c.compress(a) + c.compress(b)) == a + b
    assert zstd.read_strip(c.compress(a) + c.compress(b), 10 ** 6) == a
    assert zstd.read_strip(skip + c.compress(a), 10 ** 6) == b""
    px = small_rgb()[:4, :10, 1]
    for body in (skip + c.compress(px.tobytes()),
                 c.compress(px[:2].tobytes()) + c.compress(px[2:].tobytes())):
        data = tiff([body], {256: (3, [10]), 257: (3, [4]), 258: (3, [8]),
                             259: (3, [50000]), 262: (3, [1]), 273: None,
                             277: (3, [1]), 278: (3, [4])})
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        with pytest.raises(ValueError, match="too little data"):
            tiffio.decode_tiff(data)


def test_zstd_xxh64():
    """XXH64's published values of the empty input and of 'a'."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B


def test_t4_with_and_without_eols():
    """libtiff looks for an EOL in a Group 3 strip and, finding none,
    reads its rows one after the other: both decode alike, as PIL reads
    them."""
    bits = (small_rgb()[:9, :40, 0] > 120).astype(np.uint8)
    for eol in (True, False):
        data = tiff([t4_rows(bits, eol)], {
            256: (3, [40]), 257: (3, [9]), 258: (3, [1]), 259: (3, [3]),
            262: (3, [0]), 273: None, 277: (3, [1]), 278: (3, [9])})
        want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
        np.testing.assert_array_equal(want, np.where(bits, 0, 255))
        np.testing.assert_array_equal(tiffio.decode_tiff(data), want)


@pytest.mark.parametrize("luma,ref", [
    (None, None), ((2126, 7152, 722), None),
    (None, (16, 235, 128, 240, 128, 240)),
    ((3000, 5900, 1100), (0, 255, 0, 255, 0, 255))])
def test_ycbcr_conversion_is_libtiffs(luma, ref):
    """``ycbcr_tables`` / ``ycbcr_to_rgb`` against PIL (libtiff's
    TIFFYCbCrToRGB) on random codes under default and explicit tags."""
    rng = np.random.default_rng(10)
    px = rng.integers(0, 256, (64, 256, 3), dtype=np.uint8)
    tags = {256: (3, [256]), 257: (3, [64]), 258: (3, [8] * 3),
            259: (3, [8]), 262: (3, [6]), 273: None, 277: (3, [3]),
            278: (3, [64]), 530: (3, [1, 1])}
    if luma:
        tags[529] = (5, [v for x in luma for v in (x, 10000)])
    if ref:
        tags[532] = (5, [v for x in ref for v in (x, 1)])
    data = tiff([zlib.compress(px.tobytes())], tags)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(tiffio.decode_tiff(data), want)


@pytest.mark.parametrize("compression", ["tiff_lzw", "zstd"])
def test_ycbcr_with_predictor_2(compression):
    """Horizontal differencing on 1x1 YCbCr, as on RGB (PIL's writer)."""
    buf = io.BytesIO()
    Image.fromarray(small_rgb()).convert("YCbCr").save(
        buf, "TIFF", compression=compression, tiffinfo={317: 2})
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(tiffio.decode_tiff(buf.getvalue()), want)


def test_ycbcr_units_of_every_subsampling():
    """Ragged strips of every subsampling libtiff's RGBA reader puts, as
    PIL reads them (4x4 with libtiff's short strip read)."""
    rgb = small_rgb()[:13, :11]
    for hs, vs in tiffio.YCBCR_SUBSAMPLING:
        data = tiff([zlib.compress(u) for u in ycbcr_units(rgb, hs, vs, 8)],
                    {256: (3, [11]), 257: (3, [13]), 258: (3, [8] * 3),
                     259: (3, [8]), 262: (3, [6]), 273: None, 277: (3, [3]),
                     278: (3, [8]), 530: (3, [hs, vs])})
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(tiffio.decode_tiff(data), want)


def small(tags, data=bytes(16), width=2, height=2):
    base = {256: (3, [width]), 257: (3, [height]), 258: (3, [8]),
            259: (3, [1]), 262: (3, [1]), 273: None, 277: (3, [1]),
            278: (3, [height])}
    base.update(tags)
    return tiff([data], base)


RGB3 = {277: (3, [3]), 258: (3, [8] * 3)}
REFUSED = [
    ({259: (3, [6])}, "old-style JPEG compression is not ported"),
    ({259: (3, [50001])}, "WebP compression is not ported"),
    ({259: (3, [32809])}, "ThunderScan compression is not ported"),
    ({259: (3, [34676])}, "SGILog compression is not ported"),
    ({259: (3, [34677])}, "SGILog24 compression is not ported"),
    ({262: (3, [6]), **RGB3}, "YCbCr\\), uncompressed, is not a kind PIL"),
    ({262: (3, [6]), 259: (3, [8]), 530: (3, [1, 4]), **RGB3},
     "YCbCr subsampling 1 x 4 is not a kind PIL reads"),
    ({262: (3, [6]), 259: (3, [8]), 530: (3, [2, 2]), 317: (3, [2]),
      **RGB3}, "predictor 2 on YCbCr subsampled 2 x 2 is not ported"),
    ({262: (3, [6]), 259: (3, [5]), 284: (3, [2]), **RGB3},
     "planar configuration 2 of RGB \\(raw mode RGBX\\) with LZW"),
    ({259: (3, [4])}, "CCITT Group 4 compression of 1 8-bit samples is "
     "not a kind PIL reads"),
]


@pytest.mark.parametrize("tags,match", REFUSED)
def test_kinds_still_refused_by_name(tags, match):
    with pytest.raises(ValueError, match=match):
        tiffio.decode_tiff(small(tags))


def test_big_endian_bigtiff_refused_as_pil_fails():
    data = read("r04_bigtiff_grey_deflate_be.tif")
    with pytest.raises(ValueError, match="big-endian byte order is not a "
                       "kind PIL reads"):
        tiffio.decode_tiff(data)
    with pytest.raises(ValueError, match="BigTIFF: bad header"):
        tiffio.decode_tiff(b"II\x2b\x00\x04\x00\x00\x00" + bytes(8))


def test_card_paths_need_a_card_or_the_cpu(monkeypatch):
    """CCITT, Zstandard and a JPEG-compressed BigTIFF name no device: the
    card's path, which raises without a card; ``device="cpu"`` reads
    them. An uncompressed BigTIFF needs no device."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("r12_group4_pil.tif", "r20_zstd_grey_pil.tif",
                 "r05_bigtiff_jpeg_ycbcr420.tif"):
        path = os.path.join(FIXTURES, name)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_gray_image(path)
        load_gray_image(path, device="cpu")
    load_gray_image(os.path.join(FIXTURES, "r00_bigtiff_grey_pil.tif"))


def test_no_fallback_when_the_host_decoder_fails(monkeypatch):
    """The card's path takes the C++ decoders: where they cannot be built
    the read raises, never falling back to the twin."""
    def no_build(name, defines=()):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "load_library", no_build)
    for name in ("r11_group3_pil.tif", "r22_zstd_level1.tif"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tiffio.decode_tiff(read(name), native=True)
