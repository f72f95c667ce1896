"""JPEG 2000's file layer as PIL 12.1 reads it: the JP2 boxes, the mode.

A JPEG 2000 file is a raw codestream (``FF4F FF51``) or a JP2 file (the
signature box ``jP  ``, then ``ftyp``, ``jp2h`` and ``jp2c``). PIL's
``Jpeg2KImagePlugin`` decides the mode in Python before any pixel is
decoded, and ``read_file`` does what it does:

* a codestream takes ``_parse_codestream``'s rule: one component gives L
  (I;16 above 8 bits), two LA, three RGB, four RGBA;
* a JP2 file takes ``_parse_jp2_header``'s: ``ihdr`` gives the mode as
  above, a ``colr`` box of enumerated colour space 12 over four components
  makes it CMYK, a ``pclr`` box makes L into P and LA into PA with the
  palette PIL builds from it (``ImagePalette.getcolor`` of each entry, so
  a repeated colour keeps its first index and later entries move up).

The colour space the decoder then sees is OpenJPEG's: the first ``colr``
box's enumerated space (16 sRGB, 17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK),
unknown for an ICC profile, another method or no box, and unspecified
for a codestream; ``unpacker`` is Pillow's choice of unpacking for the
mode, that colour space and the components (``src/libImaging/
Jpeg2KDecode.c``): where it has none, PIL fails, and so does the port.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
CODESTREAM = b"\xff\x4f\xff\x51"

# OpenJPEG's colour spaces (opj_image_t.color_space)
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}

# Pillow's unpackers: (mode, colour space, components) -> kind
UNPACKERS = {
    ("L", GRAY, 1): "grey", ("P", SRGB, 1): "grey", ("PA", SRGB, 2): "grey",
    ("I;16", GRAY, 1): "grey16", ("LA", GRAY, 2): "grey",
    ("RGB", SRGB, 3): "rgb", ("RGB", SYCC, 3): "sycc",
    ("RGBA", SRGB, 4): "rgb", ("RGBA", SYCC, 4): "sycc",
    ("RGBA", GRAY, 4): "rgb", ("CMYK", CMYK, 4): "cmyk"}


class J2kFile(NamedTuple):
    codestream: bytes
    mode: str
    colour_space: int
    palette: tuple      # P / PA: PIL's palette, (colours, 3) uint8 rows
    size: tuple         # PIL's (width, height)


def _mode_of(components: int, bits: int) -> str:
    if components == 1:
        return "I;16" if (bits & 0x7F) + 1 > 8 else "L"
    try:
        return {2: "LA", 3: "RGB", 4: "RGBA"}[components]
    except KeyError:
        raise ValueError("unable to determine J2K image mode") from None


def _boxes(data: bytes, start: int, end: int):
    """(type, payload start, payload end) of each box in data[start:end]."""
    while start < end:
        if end - start < 8:
            raise ValueError("Invalid header length")
        length, kind = struct.unpack(">I4s", data[start:start + 8])
        head = 8
        if length == 1:
            if end - start < 16:
                raise ValueError("Invalid header length")
            length = struct.unpack(">Q", data[start + 8:start + 16])[0]
            head = 16
        elif length == 0:
            length = end - start
        if length < head or start + length > end:
            raise ValueError("Invalid header length")
        yield kind, start + head, start + length
        start += length


def _palette(payload: bytes) -> tuple:
    """PIL's palette from a ``pclr`` box: each entry through
    ``ImagePalette.getcolor``, which gives a repeated colour its first
    index; None where PIL keeps no palette (a bit depth above 8)."""
    ne, npc = struct.unpack(">HB", payload[:3])
    depths = payload[3:3 + npc]
    if len(depths) < npc:
        raise ValueError("Not enough data in header")
    if max(depths, default=0) > 8:
        return None
    if npc not in (3, 4):
        raise ValueError(f"a pclr box of {npc} columns is not ported")
    rows, seen = [], set()
    at = 3 + npc
    for _ in range(ne):
        entry = payload[at:at + npc]
        if len(entry) < npc:
            raise ValueError("Not enough data in header")
        at += npc
        colour = tuple(entry)
        if colour not in seen:
            seen.add(colour)
            rows.append(tuple(entry[:3]))
            if len(rows) > 256:
                raise ValueError("cannot allocate more than 256 colors")
    return tuple(rows)


def read_file(data: bytes) -> J2kFile:
    """The codestream, PIL's mode, OpenJPEG's colour space, PIL's palette
    and size of a JPEG 2000 file (raw codestream or JP2)."""
    if data.startswith(CODESTREAM):
        if len(data) < 42:
            raise ValueError("cannot identify the JPEG 2000 file (its SIZ "
                             "is cut)")
        xsiz, ysiz, xo, yo = struct.unpack(">IIII", data[8:24])
        csiz = struct.unpack(">H", data[40:42])[0]
        bits = data[42] if csiz == 1 and len(data) > 42 else 0
        mode = _mode_of(csiz, bits)
        return J2kFile(data, mode, UNSPECIFIED, (), (xsiz - xo, ysiz - yo))
    if not data.startswith(SIGNATURE):
        raise ValueError("not a JPEG 2000 file")
    header = codestream = None
    for kind, start, end in _boxes(data, 12, len(data)):
        if kind == b"jp2h" and header is None:
            header = (start, end)
        elif kind == b"jp2c" and codestream is None:
            codestream = data[start:end]
    if header is None:
        raise ValueError("Malformed JP2 header (no jp2h box)")
    size = mode = None
    colour_space, palette, colr_seen = UNKNOWN, (), False
    nc = 0
    for kind, start, end in _boxes(data, *header):
        payload = data[start:end]
        if kind == b"ihdr":
            if len(payload) < 11:
                raise ValueError("Not enough data in header")
            height, width, nc, bpc = struct.unpack(">IIHB", payload[:11])
            size = (width, height)
            mode = "I;16" if nc == 1 and (bpc & 0x7F) > 8 else {
                1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif kind == b"colr":
            if len(payload) < 3:
                raise ValueError("Not enough data in header")
            if nc == 4 and len(payload) >= 7 and payload[0] == 1 and (
                    struct.unpack(">I", payload[3:7])[0] == 12):
                mode = "CMYK"
            if not colr_seen and payload[0] in (1, 2):
                colr_seen = True
                if payload[0] == 1:
                    if len(payload) < 7:
                        raise ValueError("a colr box cut short")
                    colour_space = ENUMCS.get(
                        struct.unpack(">I", payload[3:7])[0], UNKNOWN)
        elif kind == b"pclr" and mode in ("L", "LA"):
            pal = _palette(payload)
            if pal is not None:
                palette = pal
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise ValueError("Malformed JP2 header")
    if codestream is None or not codestream.startswith(CODESTREAM):
        raise ValueError("a JP2 file without its codestream")
    return J2kFile(codestream, mode, colour_space, palette, size)


def unpacker(f: J2kFile, components: int, first_subsampled: int) -> str:
    """Pillow's unpacking of a decoded image: 'grey' (L, LA, P, PA),
    'grey16' (I;16), 'rgb', 'sycc' or 'cmyk'. ``first_subsampled``: the
    first component with a subsampling other than 1 x 1, or -1. Raises
    where PIL has no unpacking (its "broken data stream")."""
    space = f.colour_space
    if space in (UNKNOWN, UNSPECIFIED):
        space = (GRAY if components <= 2 else SYCC
                 if first_subsampled in (1, 2) else SRGB)
    kind = UNPACKERS.get((f.mode, space, components))
    if kind is None or (components <= 2 and first_subsampled >= 0):
        raise ValueError(f"PIL cannot unpack a JPEG 2000 image of mode "
                         f"{f.mode} with {components} components in colour "
                         f"space {space} (broken data stream)")
    return kind
