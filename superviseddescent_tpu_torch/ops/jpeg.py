"""Kernels J1 and J2, the JPEG pixel stages on the card: ``read_jpeg``
and ``write_jpeg``.

``read_jpeg`` parses the stream (``io/jpeg.py``), decodes its entropy-coded
data on the host and runs the pixel stage where the caller asks: on the
card, the host C++ entropy decoder of ``csrc/jpeg_decode.cu`` (Huffman or
arithmetic, with libjpeg's block smoothing; or lossless) decodes every scan
in one call and writes the coefficients (a lossless frame's samples) into
pinned memory, they go to the card asynchronously and J1 (``jpeg_pixels``;
``jpeg_samples``, its samples source, for a lossless frame) turns them into
uint8 grey or RGB there; on the CPU, the plain twins of both stages run
(``io/jpeg.entropy_decode`` and ``io/jpeg.pixels_reference``). A failed
build or launch raises; nothing falls back to the twins.
``read_tiff_jpeg`` decodes a JPEG-compressed TIFF the same way, its
strips or tiles of one size as one batch of J1 (a grid row an image) and
the short last strip in a second launch.

``write_jpeg`` / ``encode_jpeg_device`` write the file PIL writes
(``io/jpeg_write.py``): on the card, kernel J2 (``jpeg_coefficients``,
``csrc/jpeg_encode.cu``) turns the uint8 pixels into quantised
coefficients there, one copy brings them to pinned memory and the host
C++ coder of the same source writes the scan; on the CPU, the plain twins
(``io/jpeg_write.coefficients_reference`` and ``entropy_encode``).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from superviseddescent_tpu_torch.io.jpeg import (
    COLOR_GREY, COLOR_RGB, COLOR_YCC, ERRORS, SMOOTHING_COEFS, ZIGZAG,
    JpegFrame, entropy_decode, parse_jpeg, pixels_reference)
from superviseddescent_tpu_torch.io.jpeg_write import (
    DEFAULT_QUALITY, EncLayout, assemble, coefficients_reference,
    encode_jpeg, layout, std_tables)
from superviseddescent_tpu_torch.utils.device import resolve_device

_INT32_MAX = 2 ** 31 - 1
MAX_COMPONENTS = 4


def _check_sizes(f: JpegFrame, channels: int) -> None:
    """The kernels index with int32: refuse what does not fit."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    if max(f.blocks * 64, f.width * f.height * channels,
           sum(len(s.data) for s in f.scans)) > _INT32_MAX:
        raise ValueError(f"JPEG of {f.width} x {f.height} is too large for "
                         "the decoder's int32 indices")


@functools.lru_cache(maxsize=32)
def _tables_on_card(data: bytes, index: int) -> torch.Tensor:
    table = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        torch.device("cuda", index))
    torch.cuda.synchronize(index)   # ready for a launch on any stream
    return table


def quant_on_card(quant: np.ndarray, device) -> torch.Tensor:
    """A kernel's int32 quantisation tables (``pixel_params``' or
    ``coefficient_params``') on the card, which the kernels copy into
    shared memory with the rest of their inputs: uploaded once per table
    set and device (a clip's frames, or one quality's writes, share
    theirs)."""
    index = torch.device(device).index
    return _tables_on_card(np.ascontiguousarray(quant, np.int32).tobytes(),
                           torch.cuda.current_device() if index is None
                           else index)


def entropy_params(f: JpegFrame):
    """The host decoder's inputs: every scan's bytes one after another, its
    int32 parameters (see ``csrc/jpeg_decode.cu``: the frame, then per
    component its layout and what block smoothing needs, then per scan its
    tables and an arithmetic scan's conditioning) and its Huffman tables,
    rows of 16 length counts and 256 symbols, each table once."""
    rows, index = [], {}

    def row(table):
        if table is None:
            return -1
        if id(table) not in index:
            index[id(table)] = len(rows)
            rows.append(table)
        return index[id(table)]

    params = [len(f.components), f.mcux, f.mcuy, f.blocks, len(f.scans),
              int(f.progressive), int(f.arithmetic), int(f.lossless),
              int(f.smooth is not None), f.width, f.height, 0]
    firsts = ZIGZAG[:SMOOTHING_COEFS]
    for i in range(MAX_COMPONENTS):
        if i >= len(f.components):
            params += [0] * 32
            continue
        c = f.components[i]
        bits = (f.smooth[i].tolist() if f.smooth is not None
                else [0] * SMOOTHING_COEFS)
        quant = (c.quant[firsts].tolist() if c.quant is not None
                 else [0] * SMOOTHING_COEFS)
        params += [c.h, c.v, c.nbx, c.offset, c.bw, c.bh, c.nby, c.dw, c.dh,
                   c.sh, c.sv, 0] + bits + quant
    offset = 0
    for s in f.scans:
        pad = [-1] * (MAX_COMPONENTS - len(s.comps))
        zero = [0] * len(pad)
        params += [offset, len(s.data), len(s.comps), s.ss, s.se, s.ah, s.al,
                   s.restart]
        params += s.comps + zero
        if f.arithmetic:
            params += [t[0] for t in s.tables] + zero
            params += [t[1] for t in s.tables] + zero
            for j in range(3):
                params += [cond[j] for cond in s.cond] + zero
        else:
            params += [row(t) for t in s.dc] + pad + [row(t) for t in s.ac]
            params += pad + [0] * 12
        offset += len(s.data)
    huff = np.zeros((max(len(rows), 1), 272), np.uint8)
    for i, (bits, vals) in enumerate(rows):
        huff[i, :16] = bits
        huff[i, 16:16 + len(vals)] = vals
    data = b"".join(s.data for s in f.scans)
    return data, np.asarray(params, np.int32), huff


def entropy_decode_native(f: JpegFrame, out=None,
                          library=None) -> torch.Tensor:
    """The host C++ entropy decoder, every scan in one call: (blocks, 64)
    int16 coefficients (a lossless frame's uint8 samples) in pinned
    memory, equal to ``io/jpeg.entropy_decode``'s; into ``out`` (a
    contiguous host tensor of that shape and type, a batch's row) where
    given. ``library``: a loaded build of the decoder (the CPU tests build
    its host half with g++); the output is pinned where a card is."""
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("jpeg_decode")
    _check_sizes(f, 1)
    data, params, huff = entropy_params(f)
    scan = np.frombuffer(data, np.uint8)
    dtype = torch.uint8 if f.lossless else torch.int16
    if out is not None and (
            out.device.type != "cpu" or out.dtype != dtype
            or tuple(out.shape) != (f.blocks, 64) or not out.is_contiguous()):
        raise ValueError(f"the decoder writes contiguous {dtype} host "
                         f"values of shape ({f.blocks}, 64)")
    coef = out if out is not None else torch.empty(
        (f.blocks, 64), dtype=dtype, pin_memory=torch.cuda.is_available())
    err = library.jpeg_entropy_decode(
        ctypes.c_void_p(scan.ctypes.data), len(scan),
        ctypes.c_void_p(params.ctypes.data), ctypes.c_void_p(huff.ctypes.data),
        ctypes.c_void_p(coef.data_ptr()))
    if err:
        raise ValueError(f"JPEG: {ERRORS.get(err, f'error {err}')}")
    return coef


# J1's launch plan: a CTA's tile in MCU rows and MCU columns, and its
# threads; PERF.md gives the sweep on the card that chose it
# (``chip_smoke.py --j1 --sweep``)
J1_TILE = (2, 4, 256)
# the images of one launch: the grid's rows
J1_MAX_BATCH = 65535


def pixel_params(f: JpegFrame, channels: int, tile=None, batch: int = 1):
    """J1's int32 geometry (see ``csrc/jpeg_decode.cu``) and its (4, 64)
    quantisers (``quant_on_card`` takes them to the card). ``tile``:
    another launch plan than ``J1_TILE``; ``batch``: images of ``f``'s
    geometry and tables in one launch."""
    hmax = max(c.h for c in f.components)
    vmax = max(c.v for c in f.components)
    # the MCUs that cover the image (fewer than the frame's grid where a
    # caller cut f.width / f.height after parsing)
    geom = [len(f.components), f.width, f.height, f.color, channels,
            f.blocks, -(-f.width // (8 * hmax)), -(-f.height // (8 * vmax)),
            hmax, vmax, *(tile or J1_TILE)]
    for i in range(MAX_COMPONENTS):
        if i < len(f.components):
            c = f.components[i]
            geom += [c.nbx, c.nby, c.offset, c.dw, c.dh, c.up, c.hexp,
                     c.vexp, c.h, c.v]
        else:
            geom += [0, 0, f.blocks, 0, 0, 0, 1, 1, 1, 1]
    geom.append(batch)
    quant = np.zeros((MAX_COMPONENTS, 64), np.int32)
    quant[:len(f.components)] = f.quant()
    return np.asarray(geom, np.int32), quant


def _launch_j1(symbol: str, values: torch.Tensor, dtype, f: JpegFrame,
               channels: int, tile) -> torch.Tensor:
    """One launch of J1's coefficient or samples source on ``values``, a
    CUDA tensor ([N,] blocks, 64) of ``dtype``."""
    batch = values.shape[0] if values.dim() == 3 else 1
    if (values.dtype != dtype or tuple(values.shape[-2:]) != (f.blocks, 64)
            or values.dim() not in (2, 3) or not values.is_contiguous()
            or not 1 <= batch <= J1_MAX_BATCH
            or batch * f.width * f.height * channels > _INT32_MAX):
        raise ValueError(f"J1 takes contiguous {dtype} of shape ([N,] "
                         f"{f.blocks}, 64) with N at most {J1_MAX_BATCH}, "
                         f"got {values.dtype} {tuple(values.shape)}")
    from superviseddescent_tpu_torch.ops._build import load_library
    geom, quant = pixel_params(f, channels, tile, batch)
    shape = values.shape[:-2] + (f.height, f.width) + (
        (3,) if channels == 3 else ())
    out = torch.empty(shape, dtype=torch.uint8, device=values.device)
    tables = quant_on_card(quant, values.device)
    err = getattr(load_library("jpeg_decode"), symbol)(
        ctypes.c_void_p(values.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(geom.ctypes.data), ctypes.c_void_p(tables.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(values.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"jpeg_decode kernel launch failed: CUDA error "
                           f"{err}")
    return out


def jpeg_pixels(coef: torch.Tensor, f: JpegFrame, channels: int = 1,
                tile=None) -> torch.Tensor:
    """J1: (blocks, 64) int16 coefficients -> uint8 (H, W) grey (OpenCV's
    formula on the RGB; a 1-component image's Y) or (H, W, 3) RGB, on the
    coefficients' device; (N, blocks, 64), N images of ``f``'s geometry
    and tables, -> (N, H, W[, 3]) in the same one launch. A lossless
    frame's uint8 samples go to J1's samples source (``jpeg_samples``). A
    CUDA tensor launches the kernel; a CPU tensor takes the plain twin.
    ``tile``: another launch plan than ``J1_TILE``'s (for the sweep)."""
    if f.lossless:
        return jpeg_samples(coef, f, channels, tile)
    _check_sizes(f, channels)
    if coef.device.type == "cpu":
        return pixels_reference(coef, f, channels)
    if coef.device.type != "cuda":
        raise ValueError(f"unsupported device {coef.device}")
    out = _launch_j1("jpeg_pixels_launch", coef, torch.int16, f, channels,
                     tile)
    jpeg_pixels.launches += 1
    return out


jpeg_pixels.launches = 0


def jpeg_samples(samples: torch.Tensor, f: JpegFrame, channels: int = 1,
                 tile=None) -> torch.Tensor:
    """J1's samples source: a lossless frame's (blocks, 64) uint8 samples
    (``io/jpeg.lossless_decode``'s layout) -> uint8 (H, W) grey or (H, W,
    3) RGB, upsampled and converted as J1 does it, with no dequantisation
    and no IDCT. A CUDA tensor launches the kernel; a CPU tensor takes the
    plain twin."""
    if not f.lossless:
        raise ValueError("J1's samples source takes a lossless frame")
    _check_sizes(f, channels)
    if samples.device.type == "cpu":
        return pixels_reference(samples, f, channels)
    if samples.device.type != "cuda":
        raise ValueError(f"unsupported device {samples.device}")
    out = _launch_j1("jpeg_samples_launch", samples, torch.uint8, f,
                     channels, tile)
    jpeg_samples.launches += 1
    return out


jpeg_samples.launches = 0


def read_jpeg(path_or_bytes, channels: int = 1, device=None) -> torch.Tensor:
    """Decode a JPEG (a path, or its bytes) into a uint8 (H, W)
    grey or (H, W, 3) RGB tensor on ``device`` (the card unless the caller
    names one; with no card and no device this raises, as
    ``utils/device.resolve_device`` does)."""
    dev = resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(os.fspath(path_or_bytes), "rb") as fh:
            data = fh.read()
    f = parse_jpeg(data)
    if dev.type == "cpu":
        coef = torch.from_numpy(entropy_decode(f))
    elif dev.type == "cuda":
        coef = entropy_decode_native(f).to(dev, non_blocking=True)
    else:
        raise ValueError(f"unsupported device {dev}")
    return jpeg_pixels(coef, f, channels)


def _tiff_frame(stream: bytes, page, width: int, height: int) -> JpegFrame:
    """One strip or tile's frame, held to what libtiff's JPEG codec takes:
    the strip's size, the photometric's components and sampling (YCbCr:
    luma at the YCbCrSubsampling tag's factors, chroma 1 x 1) and colour
    space (grey, RGB as it is, YCbCr converted)."""
    f = parse_jpeg(stream)
    if f.arithmetic or f.lossless:
        raise ValueError("TIFF JPEG: an arithmetic-coded or lossless stream "
                         "(JPEG-in-TIFF is read Huffman-coded, DCT only)")
    if (f.width, f.height) != (width, height):
        raise ValueError(f"TIFF JPEG: a {f.width} x {f.height} frame in a "
                         f"{width} x {height} strip or tile")
    sampling = [(c.h, c.v) for c in f.components]
    want = {1: [(1, 1)], 2: [(1, 1)] * 3,
            6: [tuple(page.subsampling), (1, 1), (1, 1)]}[page.photometric]
    if sampling != want:
        raise ValueError(f"TIFF JPEG: components sampled {sampling} under "
                         f"photometric {page.photometric} (libtiff takes "
                         f"{want})")
    f.container_color = {1: COLOR_GREY, 2: COLOR_RGB,
                         6: COLOR_YCC}[page.photometric]
    return f


def read_tiff_jpeg(data: bytes, channels: int = 1,
                   device=None) -> torch.Tensor:
    """A JPEG-compressed TIFF page (``io/tiff.jpeg_chunks``) -> uint8 (H,
    W) grey or (H, W, 3) RGB on ``device`` (the card unless the caller
    names one), as PIL reads it through libtiff. Each strip or tile is an
    image of its own (its edge rows and columns are the chroma filter's
    edges). J1 decodes the page in at most two launches: every strip or
    tile of the full size as one batch, and the short last strip; the
    host decodes the entropy-coded data (the C++ decoder into one pinned
    buffer on the card's path, the Python twin on the CPU's)."""
    from superviseddescent_tpu_torch.io.tiff import jpeg_chunks
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    page = jpeg_chunks(data)
    tw, tl = page.tile
    n = len(page.streams)
    last = page.height - (page.down - 1) * tl
    sizes = [(tw, tl)] * n if page.tiled else (
        [(tw, tl)] * (n - 1) + [(tw, last)])
    groups = [list(range(n))] if len(set(sizes)) == 1 else [
        list(range(n - 1)), [n - 1]]
    parts = []
    for group in groups:
        frames = [_tiff_frame(page.streams[k], page, *sizes[k])
                  for k in group]
        f = frames[0]
        for g in frames[1:]:
            if not np.array_equal(g.quant(), f.quant()):
                raise ValueError("TIFF JPEG strips or tiles under different "
                                 "quantisation tables are not ported")
        if dev.type == "cpu":
            coef = torch.from_numpy(np.stack(
                [entropy_decode(g) for g in frames]))
        else:
            host = torch.empty((len(frames), f.blocks, 64),
                               dtype=torch.int16, pin_memory=True)
            for i, g in enumerate(frames):
                entropy_decode_native(g, host[i])
            coef = host.to(dev, non_blocking=True)
        parts.append(jpeg_pixels(coef, f, channels))
    tail = (3,) if channels == 3 else ()
    if page.tiled:
        px = parts[0].reshape((page.down, page.across, tl, tw) + tail)
        px = px.transpose(1, 2).reshape(
            (page.down * tl, page.across * tw) + tail)
        return px[:page.height, :page.width].contiguous()
    rows = [p.reshape((-1, page.width) + tail) for p in parts]
    return (torch.cat(rows) if len(rows) > 1 else rows[0]).contiguous()


# ------------------------------------------------------------------ J2
def quant_magic(q: int) -> int:
    """J2's reciprocal of the divisor ``q << 3`` of quantiser ``q``
    (1-255): ``umulhi(n, magic)`` is ``n // (q << 3)`` for every n below
    2^17 (the error n * (magic - 2^32 / d) / 2^32 stays under 2^-15, less
    than 1 / d), so the quantisation's rounded division becomes one
    multiply (``tests/test_torch_png_write.py`` checks every n J2 can
    form)."""
    return (1 << 32) // (int(q) << 3) + 1


# J2's launch plan: the MCUs a CTA takes along its MCU row, by blocks per
# MCU (grey 1, 4:4:4 3, 4:2:2 4, 4:2:0 6). The sweep on the card
# (``chip_smoke.py --j2 --sweep``, PERF.md) chose 8 for 4:2:0; the others
# give their CTAs the same 256-384 threads
J2_STRIP = {1: 32, 3: 16, 4: 8, 6: 8}
J2_MAX_THREADS = 512


def j2_plan(lay: EncLayout, strip: int | None = None):
    """(MCUs a CTA takes, its threads): eight threads a block of the
    strip, at most J2_MAX_THREADS (the CTA then loops over its blocks)."""
    strip = strip or J2_STRIP[lay.blocks_per_mcu]
    threads = -(-8 * strip * lay.blocks_per_mcu // 32) * 32
    return strip, min(threads, J2_MAX_THREADS)


def coefficient_params(lay: EncLayout, strip: int | None = None):
    """J2's int32 geometry (see ``csrc/jpeg_encode.cu``) and its (2, 2,
    64) quantisers and their magic reciprocals (``quant_magic``), which
    ``quant_on_card`` takes to the card."""
    geom = [len(lay.components), lay.width, lay.height, lay.channels,
            lay.mcux, lay.mcuy, lay.blocks_per_mcu, lay.blocks]
    for i in range(3):
        if i < len(lay.components):
            c = lay.components[i]
            geom += [c.h, c.v, c.wib, c.hib, c.hexp, c.vexp, c.last_row,
                     c.first, c.tq]
        else:
            geom += [1, 1, 0, 0, 1, 1, 0, lay.blocks_per_mcu, 0]
    geom += [*j2_plan(lay, strip), max(c.h for c in lay.components),
             max(c.v for c in lay.components)]
    quant = np.ones((2, 2, 64), np.int64)
    quant[0, :len(lay.quant)] = lay.quant
    quant[1] = np.vectorize(quant_magic)(quant[0])
    return np.asarray(geom, np.int32), quant.astype(np.int32)


def jpeg_coefficients(pixels: torch.Tensor, lay: EncLayout,
                      strip: int | None = None) -> torch.Tensor:
    """J2: uint8 (H, W) grey or (H, W, 3) RGB -> (blocks, 64) int16
    quantised coefficients in the coder's order, on the pixels' device. A
    CUDA tensor launches the kernel; a CPU tensor takes the plain twin.
    ``strip``: another launch plan than ``J2_STRIP``'s (for the sweep)."""
    if pixels.device.type == "cpu":
        return coefficients_reference(pixels, lay)
    if pixels.device.type != "cuda":
        raise ValueError(f"unsupported device {pixels.device}")
    shape = (lay.height, lay.width) + ((3,) if lay.channels == 3 else ())
    if (pixels.dtype != torch.uint8 or tuple(pixels.shape) != shape
            or not pixels.is_contiguous()):
        raise ValueError(f"pixels must be contiguous uint8 of shape {shape}, "
                         f"got {pixels.dtype} {tuple(pixels.shape)}")
    if max(lay.blocks * 64, pixels.numel()) > _INT32_MAX:
        raise ValueError(f"{lay.width} x {lay.height} is too large for the "
                         "encoder's int32 indices")
    from superviseddescent_tpu_torch.ops._build import load_library
    geom, quant = coefficient_params(lay, strip)
    out = torch.empty((lay.blocks, 64), dtype=torch.int16,
                      device=pixels.device)
    tables = quant_on_card(quant, pixels.device)
    err = load_library("jpeg_encode").jpeg_coefficients_launch(
        ctypes.c_void_p(pixels.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(geom.ctypes.data), ctypes.c_void_p(tables.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(pixels.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"jpeg_encode kernel launch failed: CUDA error "
                           f"{err}")
    jpeg_coefficients.launches += 1
    return out


jpeg_coefficients.launches = 0


def huffman_params(lay: EncLayout):
    """The host coder's int32 parameters and its (4, 272) tables (DC 0,
    AC 0, DC 1, AC 1; the second pair repeats the first for grey)."""
    params = [len(lay.components), lay.blocks_per_mcu]
    for c in lay.components:
        params += [c.h * c.v, c.tq]
    params += [0] * (2 + 2 * 3 - len(params))
    huff = np.zeros((4, 272), np.uint8)
    tables = std_tables(lay.channels)
    for t in range(2):
        for k, (bits, vals) in enumerate(tables[min(t, len(tables) - 1)]):
            huff[2 * t + k, :16] = bits
            huff[2 * t + k, 16:16 + len(vals)] = vals
    return np.asarray(params, np.int32), huff


def huffman_encode_native(coef: torch.Tensor, lay: EncLayout,
                          library=None) -> bytes:
    """The host C++ coder on (blocks, 64) int16 coefficients in host
    memory (pinned on the card's path): the scan's bytes, equal to
    ``io/jpeg_write.entropy_encode``'s. ``library``: a loaded build of
    the coder (the CPU tests build the host half with g++)."""
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("jpeg_encode")
    if (coef.device.type != "cpu" or coef.dtype != torch.int16
            or tuple(coef.shape) != (lay.blocks, 64)
            or not coef.is_contiguous()):
        raise ValueError("the coder takes contiguous int16 host coefficients "
                         f"of shape ({lay.blocks}, 64)")
    params, huff = huffman_params(lay)
    cap = lay.blocks * 512 + 16
    if cap > _INT32_MAX:
        raise ValueError(f"{lay.width} x {lay.height} is too large for the "
                         "coder's int32 sizes")
    out = np.empty(cap, np.uint8)
    n = library.jpeg_huffman_encode(
        ctypes.c_void_p(coef.data_ptr()), lay.blocks,
        ctypes.c_void_p(params.ctypes.data), ctypes.c_void_p(huff.ctypes.data),
        ctypes.c_void_p(out.ctypes.data), cap)
    if n < 0:
        raise RuntimeError("JPEG coder: the output buffer is too small")
    return out[:n].tobytes()


def encode_jpeg_device(pixels: torch.Tensor, quality: int = DEFAULT_QUALITY,
                       subsampling: str | None = None) -> bytes:
    """The card's JPEG writer: J2 on the device, one copy of the
    coefficients into pinned memory, the host coder. ``pixels``: uint8 (H,
    W) or (H, W, 3) on the card."""
    lay = layout(pixels.shape[0], pixels.shape[1],
                 1 if pixels.dim() == 2 else 3, quality, subsampling)
    coef = jpeg_coefficients(pixels.contiguous(), lay)
    host = torch.empty(coef.shape, dtype=torch.int16, pin_memory=True)
    host.copy_(coef, non_blocking=True)
    torch.cuda.current_stream(pixels.device).synchronize()
    return assemble(lay, huffman_encode_native(host, lay))


def write_jpeg(path, pixels, quality: int = DEFAULT_QUALITY,
               subsampling: str | None = None, device=None) -> None:
    """Write uint8 grey (H, W) or RGB (H, W, 3) pixels as the JPEG file
    PIL writes (``io/jpeg_write.encode_jpeg``): through J2 on the card
    unless the caller names the CPU (or hands CPU pixels with
    ``device="cpu"``)."""
    data = encode_jpeg(pixels, quality, subsampling, device=device)
    with open(os.fspath(path), "wb") as fh:
        fh.write(data)
