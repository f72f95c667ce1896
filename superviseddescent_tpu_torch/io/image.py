"""Images in and out as the JAX package's PIL calls read and write them.

``sniff`` reads the format from the magic bytes: PNG, JPEG, BMP (``BM``),
PNM (every prefix PIL's ``PpmImagePlugin._accept`` takes: ``P0``-``P6``,
``Pf`` and ``Py``; ``decode_pnm`` reads grey PFM and refuses PIL's own
extensions by name), TIFF (``II*\\0``, ``MM\\0*`` and BigTIFF's ``II+\\0``,
``MM\\0+``), GIF (``GIF87a``,
``GIF89a``), WebP (``RIFF....WEBP``, lossless and lossy, an
animation's first frame) and JPEG 2000 (a JP2 file or a raw codestream,
PIL's ``Jpeg2KImagePlugin._accept``); a format PIL reads that is not
ported (PSD, QOI) raises naming it. ``read_rgb`` is
``Image.open(p).convert("RGB")``;
``read_gray`` is the JAX package's ``load_gray_image``: PIL's mode ``L``
as it is, every other mode through RGB and OpenCV's grey, which agree
wherever r = g = b (4899 + 9617 + 1868 = 2^14), so a reader that returns
one grey plane (modes 1, L, LA, and PIL's I;16, I and F clipped by
``convert("RGB")``) gives both. JPEG's pixel stage runs on ``device``
(kernel J1, ``ops/jpeg.read_jpeg``; the card unless the caller names
one), and so does a JPEG-compressed TIFF's (``ops/jpeg.read_tiff_jpeg``)
a lossy WebP's (kernels W1-W3 after the host entropy stage,
``ops/webp.read_webp``) and a JPEG 2000 file's (kernels D1 and M1 after
the host tier-2 and tier-1 stage, ``ops/j2k.read_j2k``); a lossless WebP decodes on the host, by the C++
decoder where ``device`` is the card and by its Python twin on the CPU
(``io/webp``), and so do a TIFF's CCITT and Zstandard strips (the C++
decoders of ``csrc/tiff_decode.cu``, or ``io/ccitt`` and ``io/zstd``);
every other format decodes on the host (``io/png``, ``bmp``, ``pnm``,
``tiff``, ``gif``). TIFF is classic or BigTIFF.

``format_for`` is PIL's extension table (``Image.registered_extensions``
of PIL 12.1) for the formats the port writes, case-insensitive;
``write_image`` writes by it. GIF (``io/gif_write``: PIL's median-cut
palette and interlaced LZW) and WebP (``io/vp8_write``: libwebp's lossy
encoder at PIL's defaults) are written by their host C++ coders
(``csrc/gif_encode.cu``, ``csrc/webp_encode.cu``) on the card's path and
by their Python twins where the caller names the CPU. A format PIL writes
but the port does not yet (AVIF, QOI, ...) raises ``ValueError`` naming it
and "not ported"; an unknown or missing extension raises ``ValueError`` as
PIL's ``save`` does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from superviseddescent_tpu_torch.io.bmp import decode_bmp, encode_bmp
from superviseddescent_tpu_torch.io.gif import decode_gif
from superviseddescent_tpu_torch.io.gif_write import encode_gif
from superviseddescent_tpu_torch.io.png import (
    SIGNATURE as PNG_SIGNATURE, decode_png, encode_png)
from superviseddescent_tpu_torch.io.pnm import decode_pnm, encode_pnm
from superviseddescent_tpu_torch.io.tiff import (
    NATIVE as TIFF_NATIVE, compression as tiff_compression, decode_tiff,
    encode_tiff)
from superviseddescent_tpu_torch.io.vp8_write import encode_webp
from superviseddescent_tpu_torch.utils.device import resolve_device

# the written formats of PIL's extension table
WRITTEN = {".png": "PNG", ".apng": "PNG",
           ".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG", ".jfif": "JPEG",
           ".bmp": "BMP", ".dib": "DIB",
           ".pbm": "PPM", ".pgm": "PPM", ".ppm": "PPM", ".pnm": "PPM",
           ".pfm": "PPM", ".tif": "TIFF", ".tiff": "TIFF", ".gif": "GIF",
           ".webp": "WEBP"}
# the rest of PIL's table: formats PIL writes that the port does not yet
NOT_PORTED = {
    ".avif": "AVIF", ".avifs": "AVIF",
    ".blp": "BLP", ".bufr": "BUFR", ".dds": "DDS", ".ps": "EPS",
    ".eps": "EPS", ".grib": "GRIB", ".h5": "HDF5", ".hdf": "HDF5",
    ".icns": "ICNS", ".ico": "ICO", ".im": "IM", ".jp2": "JPEG2000",
    ".j2k": "JPEG2000", ".jpc": "JPEG2000", ".jpf": "JPEG2000",
    ".jpx": "JPEG2000", ".j2c": "JPEG2000", ".mpo": "MPO", ".msp": "MSP",
    ".palm": "PALM", ".pcx": "PCX", ".pdf": "PDF", ".qoi": "QOI",
    ".bw": "SGI", ".rgb": "SGI", ".rgba": "SGI", ".sgi": "SGI",
    ".tga": "TGA", ".icb": "TGA", ".vda": "TGA", ".vst": "TGA",
    ".wmf": "WMF", ".emf": "WMF", ".xbm": "XBM"}
# extensions PIL opens but cannot write
READ_ONLY = {".cur": "CUR", ".dcx": "DCX", ".fit": "FITS", ".fits": "FITS",
             ".fli": "FLI", ".flc": "FLI", ".ftc": "FTEX", ".ftu": "FTEX",
             ".gbr": "GBR", ".iim": "IPTC", ".mpg": "MPEG", ".mpeg": "MPEG",
             ".pcd": "PCD", ".pxr": "PIXAR", ".psd": "PSD", ".ras": "SUN",
             ".xpm": "XPM"}
# magic bytes of formats PIL reads that the port does not (yet)
UNPORTED_MAGIC = ((b"8BPS", "PSD"), (b"qoif", "QOI"))
# JPEG 2000: a raw codestream (SOC, SIZ) or a JP2 file's signature box
J2K_MAGIC = (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")
# the header sizes by which PIL takes headerless bytes for a DIB
DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def sniff(data: bytes) -> str:
    """The format of an image file's bytes: PNG, JPEG, BMP, PPM, TIFF, GIF,
    WEBP, JPEG2000 or DIB (PIL's names; a DIB is BMP without its file header, known
    by its header's size as PIL knows it). Raises naming a format that is
    not ported."""
    if data[:8] == PNG_SIGNATURE:
        return "PNG"
    if data[:2] == b"\xff\xd8":
        return "JPEG"
    if data[:2] == b"BM":
        return "BMP"
    if len(data) > 1 and data[:1] == b"P" and data[1:2] in b"0123456fy":
        return "PPM"   # PpmImagePlugin._accept: decode_pnm refuses by name
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II\x2b\x00", b"MM\x00\x2b"):
        return "TIFF"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    if data.startswith(J2K_MAGIC):
        return "JPEG2000"
    if len(data) >= 4 and int.from_bytes(data[:4], "little") in DIB_HEADERS:
        return "DIB"
    for magic, name in UNPORTED_MAGIC:
        if data.startswith(magic):
            raise ValueError(f"reading {name} is not ported")
    raise ValueError(f"not an image format the port reads (starts with "
                     f"{data[:4]!r}; PNG, JPEG, BMP, PNM, TIFF, GIF, "
                     "WebP or JPEG 2000)")


def decode_host(data: bytes, fmt: str, channels: int = 3,
                native=False) -> np.ndarray:
    """A host-decoded format's pixels: uint8 (H, W) grey or (H, W, 3)
    RGB; ``channels`` 1 for ``load_gray_image``'s reading where it
    differs from ``convert("RGB")``'s (a GIF's mode-L frame that keeps a
    palette); ``native`` (TIFF) the C++ CCITT and Zstandard decoders in
    place of their Python twins."""
    if fmt == "PNG":
        px = decode_png(data)
        return px[..., 0] if px.shape[2] <= 2 else np.ascontiguousarray(
            px[..., :3])
    if fmt == "DIB":
        return decode_bmp(data, dib=True)
    if fmt == "GIF":
        return decode_gif(data, channels)
    if fmt == "TIFF":
        return decode_tiff(data, native)
    return {"BMP": decode_bmp, "PPM": decode_pnm}[fmt](data)


def _read(path, channels: int, device):
    """An image file's pixels: a JPEG's, a JPEG-compressed TIFF's (J1), a
    lossy WebP's (W1-W3) or a JPEG 2000 file's (D1, M1) as a tensor on
    ``device``, any other format's as a host array."""
    with open(os.fspath(path), "rb") as f:
        data = f.read()
    try:
        fmt = sniff(data)
        if fmt == "JPEG":
            from superviseddescent_tpu_torch.ops.jpeg import read_jpeg
            return read_jpeg(data, channels, device)
        if fmt == "JPEG2000":
            from superviseddescent_tpu_torch.ops.j2k import read_j2k
            return read_j2k(data, channels, device)
        native = False
        if fmt == "TIFF":
            kind = tiff_compression(data)
            if kind == 7:
                from superviseddescent_tpu_torch.ops.jpeg import (
                    read_tiff_jpeg)
                return read_tiff_jpeg(data, channels, device)
            if kind in TIFF_NATIVE:   # the card's C++ decoders, or the twins
                dev = resolve_device(device)
                if dev.type not in ("cpu", "cuda"):
                    raise ValueError(f"unsupported device {dev}")
                native = dev.type == "cuda"
        if fmt == "WEBP":
            from superviseddescent_tpu_torch.ops.webp import read_webp
            return read_webp(data, channels, device)
        px = decode_host(data, fmt, channels, native)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if channels == 3 and px.ndim == 2:
        return np.repeat(px[..., None], 3, axis=2)
    if channels == 1 and px.ndim == 3:
        from superviseddescent_tpu_torch.ops.patches import rgb_to_gray_u8
        return rgb_to_gray_u8(px)
    return px


def read_gray(path, device=None) -> np.ndarray:
    """uint8 (H, W): the JAX package's ``load_gray_image`` before its
    float32 cast. Decoding errors raise ``ValueError`` naming the file."""
    px = _read(path, 1, device)
    return px.cpu().numpy() if isinstance(px, torch.Tensor) else px


def read_rgb(path, device=None) -> np.ndarray:
    """uint8 (H, W, 3): ``Image.open(path).convert("RGB")``."""
    px = _read(path, 3, device)
    return px.cpu().numpy() if isinstance(px, torch.Tensor) else px


def read_rgb_tensor(path, device) -> torch.Tensor:
    """uint8 (H, W, 3) on ``device``: a JPEG's, a lossy WebP's or a JPEG
    2000 file's pixels never leave it."""
    px = _read(path, 3, device)
    if isinstance(px, torch.Tensor):
        return px
    return torch.from_numpy(np.ascontiguousarray(px)).to(device)


def format_for(name) -> str:
    """PIL's format for a file name's extension, among those the port
    writes: PNG, JPEG, BMP, DIB, PPM, TIFF, GIF or WEBP."""
    ext = os.path.splitext(os.fspath(name))[1].lower()
    if ext in WRITTEN:
        return WRITTEN[ext]
    if ext in NOT_PORTED:
        raise ValueError(f"writing {NOT_PORTED[ext]} ({ext}) is not "
                         "ported")
    if ext in READ_ONLY:
        raise ValueError(f"{READ_ONLY[ext]} ({ext}) cannot be written "
                         "(PIL reads it only)")
    raise ValueError(f"unknown file extension: {ext!r}" if ext else
                     f"no file extension in {os.fspath(name)!r}: the format "
                     "is chosen by the extension")


def write_image(path, pixels, device=None) -> str:
    """Write uint8 grey (H, W) or RGB (H, W, 3) pixels (an array, or a
    tensor) in the format ``format_for(path)`` names; returns the format.
    A JPEG is encoded on ``device`` (J2 on the card unless the caller
    names the CPU; a tensor's own device by default). A GIF or a WebP is
    encoded on the host by its C++ coder where ``device`` (resolved as for
    JPEG) is the card, by its Python twin where it is the CPU; with no
    card and no device named it raises. Every other format is encoded on
    the host."""
    fmt = format_for(path)
    if fmt == "JPEG":
        from superviseddescent_tpu_torch.ops.jpeg import write_jpeg
        write_jpeg(path, pixels, device=device)
        return fmt
    native = False
    if fmt in ("GIF", "WEBP"):
        if (device is None and isinstance(pixels, torch.Tensor)
                and pixels.device.type != "cpu"):
            device = pixels.device
        dev = resolve_device(device)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        native = dev.type == "cuda"
    if isinstance(pixels, torch.Tensor):
        pixels = pixels.cpu().numpy()
    if fmt == "GIF":
        data = encode_gif(pixels, native=native)
    elif fmt == "WEBP":
        data = encode_webp(pixels, native=native)
    else:
        encode = {"PNG": encode_png, "BMP": encode_bmp,
                  "DIB": lambda p: encode_bmp(p, dib=True),
                  "PPM": encode_pnm, "TIFF": encode_tiff}[fmt]
        data = encode(pixels)
    with open(os.fspath(path), "wb") as f:
        f.write(data)
    return fmt
