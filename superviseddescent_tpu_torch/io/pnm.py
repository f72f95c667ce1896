"""PNM (PBM / PGM / PPM): reader and writer, as PIL reads and writes them
(no PIL).

Reads P1-P6, plain (ASCII) and raw, whitespace and ``#`` comments in the
header and, in plain files, between the samples. Bilevel (P1, P4) reads
as grey 0 / 255 (1 is black). Grey and RGB samples are scaled as PIL's
PPM decoders scale them: a maxval of 255 as it is; any other
``round(value / maxval * 255)`` (Python's rounding of the float64
quotient; a raw sample above maxval saturates at 255, a plain one
raises); a grey maxval above 255 (PIL's mode ``I``) to
``round(value / maxval * 65535)`` and then clipped to 255 as PIL's
``convert("RGB")`` clips it (65535 as it is). PFM grey (``Pf``) reads as
PIL's mode ``F``: float32 rows from the bottom up, little-endian where the
scale is negative (a scale of 0, NaN or infinity raises as PIL does),
then ``convert("RGB")``'s truncation toward zero and clip to [0, 255]
(``float_to_u8``). Refused by name: PIL's own extensions (``P0CMYK``,
``PyP`` ...), which ``io/image.sniff`` sends here as PIL's ``_accept``
takes them, and, called directly, PAM (P7) and colour PFM (``PF``),
which PIL's ``Image.open`` does not identify.

Writes grey (H, W) as P5 and RGB (H, W, 3) as P6, byte for byte PIL's
(``P5\\n3 2\\n255\\n`` and the samples), whatever the extension of the
four (PIL chooses the P-number from the mode).
"""

from __future__ import annotations

import numpy as np

WHITESPACE = b" \t\n\x0b\x0c\r"
MAGIC = {b"P1": (1, False), b"P2": (1, False), b"P3": (3, False),
         b"P4": (1, True), b"P5": (1, True), b"P6": (3, True)}
REFUSED = {b"P7": "PAM (P7)", b"PF": "PFM (PF, colour float)",
           b"P0CMYK": "P0CMYK (CMYK)", b"PyP": "PyP (palette)",
           b"PyRGBA": "PyRGBA", b"PyCMYK": "PyCMYK"}
TOKEN_LIMIT = 10


class _Header:
    """PIL's ``_read_magic`` / ``_read_token`` over the bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def magic(self) -> bytes:
        out = b""
        while len(out) < 6 and self.pos < len(self.data):
            c = self.data[self.pos:self.pos + 1]
            self.pos += 1
            if c in WHITESPACE:
                break
            out += c
        return out

    def token(self) -> int:
        out = self.word()
        if not out.isdigit():
            raise ValueError(f"PNM: bad header token {out[:12]!r}")
        return int(out)

    def word(self) -> bytes:
        out = b""
        while len(out) <= TOKEN_LIMIT:
            if self.pos >= len(self.data):
                break
            c = self.data[self.pos:self.pos + 1]
            self.pos += 1
            if c in WHITESPACE:
                if not out:
                    continue
                break
            if c == b"#":
                while self.pos < len(self.data) and \
                        self.data[self.pos:self.pos + 1] not in b"\r\n":
                    self.pos += 1
                self.pos += 1
                continue
            out += c
        if not out:
            raise ValueError("PNM: the file ends inside its header")
        if len(out) > TOKEN_LIMIT:
            raise ValueError(f"PNM: bad header token {out[:12]!r}")
        return out


def _plain_tokens(data: bytes) -> bytes:
    """The samples of a plain file with its comments removed (a comment
    runs from # to the next CR or LF)."""
    out, pos = [], 0
    while True:
        at = data.find(b"#", pos)
        if at < 0:
            out.append(data[pos:])
            return b"".join(out)
        out.append(data[pos:at])
        ends = [e for e in (data.find(b"\n", at), data.find(b"\r", at))
                if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def float_to_u8(values: np.ndarray) -> np.ndarray:
    """PIL's mode ``F`` through ``convert("RGB")``: truncated toward zero,
    clipped to [0, 255], NaN 0."""
    with np.errstate(invalid="ignore"):     # signalling NaNs are NaNs
        v = np.nan_to_num(values.astype(np.float64), nan=0.0)
    return np.clip(np.trunc(v), 0, 255).astype(np.uint8)


def _decode_pfm(head: _Header, data: bytes) -> np.ndarray:
    """Grey PFM (``Pf``) after its magic: PIL's ``F;32F`` (scale below
    0) or ``F;32BF`` rows, bottom row first."""
    width, height = head.token(), head.token()
    if width <= 0 or height <= 0:
        raise ValueError(f"PNM: size {width} x {height}")
    word = head.word()
    try:
        scale = float(word)
    except ValueError:
        raise ValueError(f"PFM: bad scale {word[:12]!r}") from None
    if scale == 0.0 or not np.isfinite(scale):
        raise ValueError("PFM: scale must be finite and non-zero")
    n = width * height * 4
    body = data[head.pos:head.pos + n]
    if len(body) < n:
        raise ValueError("PFM: truncated image data")
    values = np.frombuffer(body, "<f4" if scale < 0 else ">f4")
    return float_to_u8(values.reshape(height, width)[::-1])


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Python's ``round(value / maxval * out_max)``, half to even."""
    return np.round(values.astype(np.float64) / maxval * out_max)


def decode_pnm(data: bytes) -> np.ndarray:
    """PNM bytes -> uint8 (H, W) grey (bilevel, PGM, PFM) or (H, W, 3)
    RGB."""
    head = _Header(data)
    magic = head.magic()
    if magic in REFUSED:
        raise ValueError(f"PNM {REFUSED[magic]} is not ported (P1-P6 and "
                         "Pf only)")
    if magic == b"Pf":
        return _decode_pfm(head, data)
    if magic not in MAGIC:
        raise ValueError(f"not a PNM file (magic {magic!r})")
    bands, raw = MAGIC[magic]
    width, height = head.token(), head.token()
    if width <= 0 or height <= 0:
        raise ValueError(f"PNM: size {width} x {height}")
    n = width * height * bands
    if magic in (b"P1", b"P4"):
        body = data[head.pos:]
        if raw:
            stride = -(-width // 8)
            if len(body) < stride * height:
                raise ValueError("PNM: truncated bitmap data")
            bits = np.unpackbits(np.frombuffer(body[:stride * height],
                                               np.uint8).reshape(height,
                                                                 stride),
                                 axis=1)[:, :width]
        else:
            tokens = b"".join(_plain_tokens(body).split())[:n]
            if len(tokens) < n:
                raise ValueError("PNM: truncated plain bitmap data")
            bits = np.frombuffer(tokens, np.uint8) - ord("0")
            if bits.max(initial=0) > 1:
                raise ValueError("PNM: a plain bitmap sample other than 0 "
                                 "or 1")
            bits = bits.reshape(height, width)
        return np.where(bits == 1, 0, 255).astype(np.uint8)
    maxval = head.token()
    if not 0 < maxval < 65536:
        raise ValueError(f"PNM: maxval {maxval} (1..65535)")
    body = data[head.pos:]
    if raw:
        width_b = 1 if maxval < 256 else 2
        if len(body) < n * width_b:
            raise ValueError("PNM: truncated image data")
        values = np.frombuffer(body[:n * width_b],
                               np.uint8 if width_b == 1 else ">u2")
    else:
        tokens = _plain_tokens(body).split()[:n]
        if len(tokens) < n:
            raise ValueError("PNM: truncated plain image data")
        if any(len(t) > TOKEN_LIMIT or not t.isdigit() for t in tokens):
            raise ValueError("PNM: a plain sample that is not a number")
        values = np.array([int(t) for t in tokens], np.int64)
        if values.max(initial=0) > maxval:
            raise ValueError(f"PNM: a plain sample above maxval {maxval}")
    if bands == 1 and maxval > 255:         # PIL's mode I, then clipped
        if raw and maxval == 65535:
            wide = values.astype(np.int64)
        else:
            wide = np.minimum(_scale(values, maxval, 65535), 65535)
        out = np.minimum(wide, 255)
    elif maxval == 255:
        out = values
    else:
        out = np.minimum(_scale(values, maxval, 255), 255)
    out = out.astype(np.uint8)
    return out.reshape(height, width) if bands == 1 else out.reshape(
        height, width, 3)


def encode_pnm(pixels) -> bytes:
    """uint8 (H, W) grey -> P5, (H, W, 3) RGB -> P6, as PIL writes them."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError("PNM pixels must be uint8 (H, W) grey or (H, W, 3) "
                         f"RGB, got {pixels.dtype} {pixels.shape}")
    head = b"P5" if pixels.ndim == 2 else b"P6"
    return (head + b"\n%d %d\n255\n" % (pixels.shape[1], pixels.shape[0])
            + np.ascontiguousarray(pixels).tobytes())
