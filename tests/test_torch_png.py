"""The port's PNG decoder on every colour type, bit depth and interlace
method of the standard, against the JAX package's ``load_gray_image``
(PIL) on the CPU.

PIL writes palette images (1, 2, 4 and 8 bits, with a ``tRNS`` chunk),
1-bit grey and 16-bit grey; what PIL cannot write (grey at 2 and 4 bits,
16-bit RGB, grey + alpha and RGBA, and every Adam7-interlaced file) comes
from ``encode``, a small writer here that filters each row with a seeded
choice of the five filter types. PIL reads every file as the reference.
16-bit PNGs decode as PIL converts them: grey clipped to 255 (``I;16`` to
RGB), the other types' high bytes.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from superviseddescent_tpu.ops.patches import load_gray_image as jax_load_gray
from superviseddescent_tpu_torch.io.image import read_rgb
from superviseddescent_tpu_torch.io.png import ADAM7, decode_png
from superviseddescent_tpu_torch.ops.patches import load_gray_image

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples, depth):
    """(h, w, c) samples -> (h, row bytes) packed big-endian rows."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
    flat = flat.reshape(h, -1, per).astype(np.uint8)
    out = np.zeros(flat.shape[:2], np.uint8)
    for i in range(per):
        out |= flat[:, :, i] << (8 - depth * (i + 1))
    return out


def _filter(rows, bpp, rng):
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        kind = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = [0, a, b, (a + b) >> 1,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))][kind]
        out.append(bytes([kind]) + ((row - pred) & 255).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def encode(samples, depth, colour, interlace=0, palette=None, trns=None,
           seed=0):
    """A PNG of (h, w, c) samples at any depth and colour type, each row
    filtered by a seeded filter type; Adam7 with ``interlace=1``."""
    rng = np.random.default_rng(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = b""
    for sy, sx, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[sy::dy, sx::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def check(path):
    """Equal to JAX's grey and to PIL's convert('RGB')."""
    np.testing.assert_array_equal(load_gray_image(path), jax_load_gray(path))
    np.testing.assert_array_equal(
        read_rgb(path), np.asarray(Image.open(path).convert("RGB")))


CASES = [(colour, depth) for colour, depths in {
    0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
    6: (8, 16)}.items() for depth in depths]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("colour,depth", CASES)
def test_every_colour_type_and_depth_equals_jax(tmp_path, colour, depth,
                                                interlace):
    rng = np.random.default_rng(colour * 100 + depth)
    for k, (h, w) in enumerate([(1, 1), (5, 3), (13, 17), (9, 16)]):
        samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[colour]))
        palette = trns = None
        if colour == 3:       # a palette shorter than the indices reach
            palette = rng.integers(0, 256, (max(1, (1 << depth) - 1), 3))
            trns = b"\x00\x80"
        elif colour == 0 and depth < 16:
            trns = b"\x00\x01"
        path = tmp_path / f"{k}.png"
        path.write_bytes(encode(samples, depth, colour, interlace, palette,
                                trns, seed=k))
        check(path)


@pytest.mark.parametrize("mode,bits", [("P", 1), ("P", 2), ("P", 4),
                                       ("P", 8), ("1", None),
                                       ("I;16", None)])
def test_pil_written_files_equal_jax(tmp_path, mode, bits):
    rng = np.random.default_rng(len(mode) + (bits or 0))
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 600, (23, 31)).astype(
            np.uint16))
    elif mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (23, 31)).astype(bool))
    else:
        im = Image.fromarray(rng.integers(0, 256, (23, 31, 3)).astype(
            np.uint8)).quantize(1 << bits)
        im.info["transparency"] = 0
    path = tmp_path / "x.png"
    im.save(path, **({"bits": bits} if bits else {}))
    assert Image.open(path).mode == ("I;16" if mode == "I;16" else mode)
    check(path)


def test_sixteen_bit_grey_clips_as_pil():
    buf = io.BytesIO()
    Image.fromarray(np.array([[0, 200, 255, 256, 65535]], np.uint16)).save(
        buf, "PNG")
    assert decode_png(buf.getvalue())[0, :, 0].tolist() == [0, 200, 255,
                                                            255, 255]
