"""WebP: a reader of every still WebP and an animation's first frame, as
PIL reads them (no PIL, no libwebp).

The container: ``RIFF`` / ``WEBP`` holding a ``VP8L`` (lossless) or
``VP8 `` (lossy) bitstream, or ``VP8X`` with ``ICCP``, ``EXIF`` and
``XMP `` skipped and an ``ALPH`` chunk before a ``VP8 `` one, and for an
animation (``ANIM`` / ``ANMF``) its first frame, lossless or lossy with
or without its own ``ALPH``, as PIL composes it: PIL reads every WebP
through libwebp's animation decoder, which starts a canvas of the
``VP8X`` size in transparent black and decodes the first frame (a key
frame: never blended) into its rectangle, so the canvas outside the frame
reads black. Alpha is dropped as ``convert("RGB")`` drops it (libwebp
hands PIL unpremultiplied RGBA); an ``ALPH`` chunk is still decoded
(``decode_alpha``: raw or VP8L-compressed, the four unfilters), so that a
damaged one fails where libwebp fails.

The lossless bitstream (RFC 9649): the header, the four transforms
(predictor with its 14 modes, cross-colour, subtract-green, colour
indexing with pixel bundling at 2, 4 and 16 colours), simple and normal
prefix codes, the meta prefix (entropy) image, LZ77 backward references
with the 120-entry distance map, and the colour cache. ``decode_vp8l``
here is the plain Python twin; the host C++ decoder
``csrc/webp_decode.cu`` (``webp_decode_vp8l``, built by
``ops/_build.py``) decodes the same bitstream wherever the caller names
the card. Nothing falls back from one to the other.

The lossy bitstream (RFC 6386 key frames) goes to ``lossy``: by default
the CPU twins (``io/vp8.py``'s entropy stage, then ``ops/webp.py``'s
pixel twins); ``ops/webp.read_webp`` passes the card's path (the C++
entropy stage, then kernels W1-W3).

Refused by name: what is malformed (an unknown transform twice, a prefix
code that is not complete, a backward reference before the image; a VP8
frame that is not a key frame or runs out, ``io/vp8.ERRORS``; a bad
``ALPH`` header or a truncated one).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)
# RFC 9649 5.2.2: the (x, y) offsets of distance codes 1..120
DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
PREDICTOR, CROSS_COLOUR, SUBTRACT_GREEN, COLOUR_INDEXING = range(4)
NUM_LENGTH_CODES, NUM_DISTANCE_CODES = 24, 40
# the C++ decoder's error codes (csrc/webp_decode.cu)
ERRORS = {1: "VP8L: truncated bitstream", 2: "VP8L: bad header",
          3: "VP8L: a transform twice", 4: "VP8L: bad prefix code",
          5: "VP8L: a backward reference before the image",
          6: "VP8L: bad colour cache size", 7: "VP8L: image too large"}


class _Bits:
    """The bitstream, least significant bit first."""

    def __init__(self, data: bytes):
        self.data, self.pos = data + bytes(8), 0
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little")
        self.pos = p + n
        if self.pos > self.end:
            raise ValueError("VP8L: truncated bitstream")
        return (v >> (p & 7)) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little")
        return (v >> (p & 7)) & ((1 << n) - 1)


class _Code:
    """A canonical prefix code read bit by bit from its first (most
    significant) bit: a lookup over ``bits`` bits of the stream, reversed;
    a code of one used symbol takes no bits."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, np.int64)
        used = np.flatnonzero(lengths)
        if len(used) == 0:
            raise ValueError("VP8L: bad prefix code (no symbol)")
        if len(used) == 1:
            self.bits, self.single = 0, int(used[0])
            return
        self.single = None
        if (np.exp2(-lengths[used].astype(np.float64))).sum() != 1.0:
            raise ValueError("VP8L: bad prefix code (not complete)")
        self.bits = int(lengths.max())
        self.symbol = np.zeros(1 << self.bits, np.int64)
        self.length = np.zeros(1 << self.bits, np.int64)
        code = 0
        for n in range(1, self.bits + 1):
            for s in np.flatnonzero(lengths == n):
                rev = int(f"{code:0{n}b}"[::-1], 2)
                self.symbol[rev::1 << n] = s
                self.length[rev::1 << n] = n
                code += 1
            code <<= 1
        self.symbol, self.length = self.symbol.tolist(), self.length.tolist()

    def read(self, br: _Bits) -> int:
        if self.single is not None:
            return self.single
        i = br.peek(self.bits)
        br.pos += self.length[i]
        if br.pos > br.end:
            raise ValueError("VP8L: truncated bitstream")
        return self.symbol[i]


def _read_code(br: _Bits, alphabet: int, stats) -> _Code:
    if br.read(1):                                   # simple code
        stats["simple_codes"] += 1
        n = br.read(1) + 1
        first = br.read(1 + 7 * br.read(1))
        lengths = [0] * alphabet
        if first >= alphabet:
            raise ValueError("VP8L: bad prefix code (symbol)")
        lengths[first] = 1
        if n == 2:
            second = br.read(8)
            if second >= alphabet:
                raise ValueError("VP8L: bad prefix code (symbol)")
            lengths[second] = 1
        return _Code(lengths)
    stats["normal_codes"] += 1
    n = br.read(4) + 4
    cl = [0] * 19
    for i in range(n):
        cl[CODE_LENGTH_ORDER[i]] = br.read(3)
    lc = _Code(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("VP8L: bad prefix code (length count)")
    else:
        max_symbol = alphabet
    lengths = [0] * alphabet
    symbol, prev = 0, 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = lc.read(br)
        if c < 16:
            lengths[symbol] = c
            symbol += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > alphabet:
            raise ValueError("VP8L: bad prefix code (repeat)")
        lengths[symbol:symbol + repeat] = [prev if c == 16 else 0] * repeat
        symbol += repeat
    return _Code(lengths)


def _prefixed(br: _Bits, code: int) -> int:
    """A length or distance from its prefix code and extra bits."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    return ((2 + (code & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br, width, height, stats, meta: bool) -> np.ndarray:
    """An entropy-coded image (the main one with its meta prefix image
    where ``meta``) -> (height, width) uint32 ARGB."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("VP8L: bad colour cache size")
        stats["colour_cache"] += 1
    groups_image, prefix_bits = None, 0
    if meta and br.read(1):
        prefix_bits = br.read(3) + 2
        sub = _entropy_image(br, (width + (1 << prefix_bits) - 1)
                             >> prefix_bits, (height + (1 << prefix_bits) - 1)
                             >> prefix_bits, stats, False)
        groups_image = (sub >> 8) & 0xFFFF
        stats["meta_prefix"] += 1
    n_groups = int(groups_image.max()) + 1 if groups_image is not None else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, a, stats) for a in (
            256 + NUM_LENGTH_CODES + cache_size, 256, 256, 256,
            NUM_DISTANCE_CODES)])
    total = width * height
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    cached = 0
    at = 0
    gw = (width + (1 << prefix_bits) - 1) >> prefix_bits
    flat_groups = (groups_image.ravel().tolist() if groups_image is not None
                   else None)
    while at < total:
        if flat_groups is not None:
            y, x = divmod(at, width)
            g = groups[flat_groups[(y >> prefix_bits) * gw
                                   + (x >> prefix_bits)]]
        else:
            g = groups[0]
        s = g[0].read(br)
        if s < 256:
            r, b, a = g[1].read(br), g[2].read(br), g[3].read(br)
            out[at] = (a << 24) | (r << 16) | (s << 8) | b
            at += 1
            stats["literals"] += 1
        elif s < 256 + NUM_LENGTH_CODES:
            length = _prefixed(br, s - 256)
            dcode = _prefixed(br, g[4].read(br))
            if dcode > 120:
                dist = dcode - 120
            else:
                dx, dy = DISTANCE_MAP[dcode - 1]
                dist = max(dx + dy * width, 1)
            if dist > at or at + length > total:
                raise ValueError("VP8L: a backward reference before the "
                                 "image or past its end")
            for k in range(length):
                out[at + k] = out[at + k - dist]
            at += length
            stats["backward_refs"] += 1
            stats["distance_codes"].add(dcode)
        else:
            out[at] = cache[s - 256 - NUM_LENGTH_CODES]
            at += 1
            stats["cache_hits"] += 1
        if cache_size:
            while cached < at:
                p = out[cached]
                cache[((0x1E35A7BD * p) & 0xFFFFFFFF) >> shift] = p
                cached += 1
    return np.asarray(out, np.uint32).reshape(height, width)


def _bytes_of(argb: np.ndarray) -> np.ndarray:
    """(h, w) uint32 ARGB -> (h, w, 4) int32 A, R, G, B."""
    return np.stack([(argb >> s) & 0xFF for s in (24, 16, 8, 0)],
                    axis=-1).astype(np.int32)


def _argb(c) -> int:
    return (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]


def _average(a, b):
    return [(x + y) >> 1 for x, y in zip(a, b)]


def _clamp(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode, left, top, top_right, top_left):
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return top_right
    if mode == 4:
        return top_left
    if mode == 5:
        return _average(_average(left, top_right), top)
    if mode == 6:
        return _average(left, top_left)
    if mode == 7:
        return _average(left, top)
    if mode == 8:
        return _average(top_left, top)
    if mode == 9:
        return _average(top, top_right)
    if mode == 10:
        return _average(_average(left, top_left), _average(top, top_right))
    if mode == 11:
        pl = sum(abs(t - tl) for t, tl in zip(top, top_left))
        pt = sum(abs(l - tl) for l, tl in zip(left, top_left))
        return left if pl < pt else top
    if mode == 12:
        return [_clamp(l + t - tl) for l, t, tl in zip(left, top, top_left)]
    if mode == 13:
        avg = _average(left, top)
        return [_clamp(a + int((a - tl) / 2)) for a, tl in zip(avg, top_left)]
    return [255, 0, 0, 0]                        # 0, and 14 / 15 as libwebp


def _inverse_predictor(img, bits, data, stats):
    """Each residual plus its prediction, mod 256 per channel."""
    h, w = img.shape
    modes = ((data >> 8) & 0xF).tolist()
    px = _bytes_of(img).tolist()
    bw = (w + (1 << bits) - 1) >> bits
    for y in range(h):
        row, up = px[y], px[y - 1] if y else None
        for x in range(w):
            if y == 0:
                pred = [255, 0, 0, 0] if x == 0 else row[x - 1]
            elif x == 0:
                pred = up[0]
            else:
                mode = modes[y >> bits][x >> bits]
                stats["predictor_modes"].add(mode)
                tr = up[x + 1] if x + 1 < w else row[0]
                pred = _predict(mode, row[x - 1], up[x], tr, up[x - 1])
            r = row[x]
            row[x] = [(r[k] + pred[k]) & 0xFF for k in range(4)]
    return np.asarray([[_argb(c) for c in row] for row in px],
                      np.uint32).reshape(h, w)


def _int8(v):
    v = v.astype(np.int32) & 0xFF
    return np.where(v >= 128, v - 256, v)


def _inverse_cross_colour(img, bits, data):
    h, w = img.shape
    px = _bytes_of(img)
    ys, xs = np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits
    m = data[ys, xs]
    g2r, g2b, r2b = _int8(m), _int8(m >> 8), _int8(m >> 16)
    green = _int8(px[..., 2])
    red = (px[..., 1] + ((g2r * green) >> 5)) & 0xFF
    blue = (px[..., 3] + ((g2b * green) >> 5) + ((r2b * _int8(red)) >> 5)
            ) & 0xFF
    return ((px[..., 0].astype(np.uint32) << 24) | (red.astype(np.uint32)
            << 16) | (px[..., 2].astype(np.uint32) << 8)
            | blue.astype(np.uint32))


def _inverse_subtract_green(img):
    px = _bytes_of(img)
    g = px[..., 2]
    return ((px[..., 0].astype(np.uint32) << 24)
            | (((px[..., 1] + g) & 0xFF).astype(np.uint32) << 16)
            | (g.astype(np.uint32) << 8)
            | ((px[..., 3] + g) & 0xFF).astype(np.uint32))


def _inverse_indexing(img, width, bits, table):
    """Each index (bundled ``8 >> bits`` bits a pixel) through the colour
    table; an index past it transparent black."""
    h = img.shape[0]
    green = ((img >> 8) & 0xFF).astype(np.int64)
    per = 1 << bits
    depth = 8 >> bits
    x = np.arange(width)
    idx = (green[:, x >> bits] >> ((x & (per - 1)) * depth)) & (
        (1 << depth) - 1)
    full = np.zeros(256, np.uint32)
    full[:len(table)] = table
    return full[idx].reshape(h, width)


def decode_vp8l(data: bytes, stats=None) -> np.ndarray:
    """A VP8L bitstream (the chunk's payload) -> (H, W) uint32 ARGB. The
    plain twin of ``csrc/webp_decode.cu``. ``stats``, a dict, collects
    what the stream used (transforms, predictor modes, bundling widths,
    colour cache, backward references)."""
    if stats is None:
        stats = {}
    for k in ("simple_codes", "normal_codes", "colour_cache", "meta_prefix",
              "literals", "backward_refs", "cache_hits"):
        stats.setdefault(k, 0)
    for k in ("transforms", "predictor_modes", "bundling",
              "distance_codes"):
        stats.setdefault(k, set())
    br = _Bits(data)
    if br.read(8) != 0x2F:
        raise ValueError("VP8L: bad header (signature)")
    width, height = br.read(14) + 1, br.read(14) + 1
    br.read(1)                                     # alpha hint
    if br.read(3) != 0:
        raise ValueError("VP8L: bad header (version)")
    transforms, seen = [], set()
    xsize = width
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("VP8L: a transform twice")
        seen.add(kind)
        stats["transforms"].add(kind)
        if kind in (PREDICTOR, CROSS_COLOUR):
            bits = br.read(3) + 2
            sub = _entropy_image(br, (xsize + (1 << bits) - 1) >> bits,
                                 (height + (1 << bits) - 1) >> bits, stats,
                                 False)
            transforms.append((kind, xsize, bits, sub))
        elif kind == SUBTRACT_GREEN:
            transforms.append((kind, xsize, 0, None))
        else:
            size = br.read(8) + 1
            table = _entropy_image(br, size, 1, stats, False)[0]
            table = np.cumsum(_bytes_of(table[None])[0], axis=0) & 0xFF
            table = np.asarray([_argb(c) for c in table.tolist()],
                               np.uint32)
            bits = 3 if size <= 2 else 2 if size <= 4 else 1 if size <= 16 \
                else 0
            stats["bundling"].add(bits)
            transforms.append((kind, xsize, bits, table))
            xsize = (xsize + (1 << bits) - 1) >> bits
    img = _entropy_image(br, xsize, height, stats, True)
    for kind, size, bits, extra in reversed(transforms):
        if kind == PREDICTOR:
            img = _inverse_predictor(img, bits, extra, stats)
        elif kind == CROSS_COLOUR:
            img = _inverse_cross_colour(img, bits, extra)
        elif kind == SUBTRACT_GREEN:
            img = _inverse_subtract_green(img)
        else:
            img = _inverse_indexing(img, size, bits, extra)
    return img


def decode_vp8l_native(data: bytes, library=None) -> np.ndarray:
    """The host C++ decoder (``csrc/webp_decode.cu``) on the same
    bitstream: (H, W) uint32 ARGB, equal to ``decode_vp8l``'s.
    ``library``: a loaded build (the tests build it with g++)."""
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("webp_decode")
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("VP8L: bad header (signature)")
    bits = int.from_bytes(data[1:5], "little")
    width, height = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    out = np.empty((height, width), np.uint32)
    buf = np.frombuffer(data, np.uint8)
    err = library.webp_decode_vp8l(ctypes.c_void_p(buf.ctypes.data),
                                   len(buf), width, height,
                                   ctypes.c_void_p(out.ctypes.data))
    if err:
        raise ValueError(ERRORS.get(err, f"VP8L: error {err}"))
    return out


def _chunks(data: bytes, start: int, end: int):
    """(fourcc, payload, the payload with its pad byte) of the RIFF chunks
    in data[start:end]. libwebp hands its VP8 decoder a frame's chunk with
    the pad byte (its last token partition runs to the end of that), so a
    stream that needs one byte more than its chunk still decodes."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            raise ValueError(f"WebP: chunk {fourcc!r} runs past the file")
        padded = min(pos + 8 + size + (size & 1), end)
        yield fourcc, data[pos + 8:pos + 8 + size], data[pos + 8:padded]
        pos += 8 + size + (size & 1)


ALPH_FILTERS = ("none", "horizontal", "vertical", "gradient")


def unfilter_alpha(deltas: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha unfilters (``src/dsp/filters.c``), mod 256: 1
    horizontal (from the left; a row's first sample from the one above),
    2 vertical (from above), 3 gradient (left + above - above-left,
    clipped to 0..255; a row's first sample from the one above); under
    each, the first row from the left, starting at 0."""
    d = deltas.astype(np.int64)
    h, w = d.shape
    if method == 1:
        first = np.cumsum(d[:, 0])
        return ((first[:, None] + np.cumsum(d, axis=1) - d[:, :1])
                & 0xFF).astype(np.uint8)
    out = np.empty((h, w), np.int64)
    out[0] = np.cumsum(d[0]) & 0xFF
    if method == 2:
        out[1:] = (out[0] + np.cumsum(d[1:], axis=0)) & 0xFF
        return out.astype(np.uint8)
    # gradient: (y, x) needs (y, x - 1), (y - 1, x) and (y - 1, x - 1), so
    # the anti-diagonals x + y = t go in order
    for t in range(1, h + w - 1):
        y = np.arange(max(1, t - w + 1), min(h - 1, t) + 1)
        if len(y) == 0:
            continue
        x = t - y
        top = out[y - 1, x]
        inner = x > 0
        xl = np.where(inner, x - 1, 0)
        pred = np.where(inner, np.clip(out[y, xl] + top - out[y - 1, xl], 0,
                                       255), top)
        out[y, x] = (d[y, x] + pred) & 0xFF
    return out.astype(np.uint8)


def decode_alpha(chunk: bytes, width: int, height: int, decode,
                 stats=None) -> np.ndarray:
    """An ``ALPH`` chunk's payload -> (height, width) uint8 alpha, as
    libwebp's ``ALPHDecode`` reads it: raw (compression 0) or a VP8L image
    stream without its header, the alpha in green (compression 1, through
    ``decode``, the VP8L decoder, under a header of the frame's size),
    then the none, horizontal, vertical or gradient unfilter; the
    pre-processing bits are read and left (libwebp with dithering off).
    ``convert("RGB")`` drops the alpha, but a damaged chunk fails here as
    it fails in libwebp."""
    if len(chunk) <= 1:
        raise ValueError("ALPH: chunk too short")
    method, filt = chunk[0] & 3, (chunk[0] >> 2) & 3
    pre, reserved = (chunk[0] >> 4) & 3, chunk[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError("ALPH: bad header")
    if stats is not None:
        stats.setdefault("alph_compression", set()).add(method)
        stats.setdefault("alph_filter", set()).add(ALPH_FILTERS[filt])
    if method == 0:
        if len(chunk) - 1 < width * height:
            raise ValueError("ALPH: truncated raw alpha")
        deltas = np.frombuffer(chunk, np.uint8, width * height, 1).reshape(
            height, width)
    else:
        header = b"\x2f" + ((width - 1) | ((height - 1) << 14)).to_bytes(
            4, "little")
        deltas = ((decode(header + chunk[1:]) >> 8) & 0xFF).astype(np.uint8)
    return deltas.copy() if filt == 0 else unfilter_alpha(deltas, filt)


def decode_webp(data: bytes, device=None) -> np.ndarray:
    """WebP bytes -> uint8 (H, W, 3) RGB, PIL's ``convert("RGB")``: where
    ``device`` is the card (the card unless the caller names one), a
    lossless bitstream through the C++ decoder and a lossy one through the
    C++ entropy stage and kernels W1-W3 (``ops/webp.py``); on the CPU
    through their twins."""
    from superviseddescent_tpu_torch.ops.webp import read_webp
    px = read_webp(data, 3, device)
    return px.cpu().numpy() if hasattr(px, "cpu") else px


def _lossy_on_cpu(payload: bytes):
    from superviseddescent_tpu_torch.ops.webp import decode_vp8_pixels
    return decode_vp8_pixels(payload, 3, "cpu").numpy()


def _lossy_frame(payload: bytes, alph, decode, lossy, stats):
    """A ``VP8 `` bitstream and its ``ALPH`` chunk (or None): the alpha
    decoded (and dropped) first, then the frame's pixels from ``lossy``."""
    if alph is not None:
        from superviseddescent_tpu_torch.io.vp8 import frame_size
        w, h, _ = frame_size(payload)
        decode_alpha(alph, w, h, decode, stats)
    return lossy(payload)


def compose(data: bytes, decode, lossy=None, stats=None):
    """The container around the bitstream: uint8 (H, W, 3) RGB as PIL
    reads the file. ``decode`` turns a VP8L bitstream into ARGB;
    ``lossy`` a ``VP8 `` payload into the frame's pixels (an array or a
    tensor; by default the CPU twins, RGB). An animation's first frame
    lies on a transparent-black canvas (an array, or a tensor on the
    frame's device). ``stats``, a dict, collects the ALPH chunks' kinds."""
    if lossy is None:
        lossy = _lossy_on_cpu
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or len(data) < 20:
        raise ValueError("not a WebP file")
    (riff,) = struct.unpack_from("<I", data, 4)
    end = min(len(data), 8 + riff)
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("WebP: no chunk")
    first, payload, padded = chunks[0]
    if first == b"VP8L":
        return _rgb(decode(payload))
    if first == b"VP8 ":
        return lossy(padded)
    if first != b"VP8X":
        raise ValueError(f"WebP: first chunk {first!r}")
    if len(payload) < 10:
        raise ValueError("WebP: VP8X chunk too short")
    cw = int.from_bytes(payload[4:7], "little") + 1
    ch = int.from_bytes(payload[7:10], "little") + 1
    alph = None
    for fourcc, body, padded in chunks[1:]:
        if fourcc == b"ALPH" and alph is None:
            alph = body
        if fourcc == b"VP8 ":
            return _lossy_frame(padded, alph, decode, lossy, stats)
        if fourcc == b"VP8L":
            if alph is not None:
                raise ValueError("WebP: an ALPH chunk before a VP8L one")
            return _rgb(decode(body))
        if fourcc == b"ANMF":
            if len(body) < 16:
                raise ValueError("WebP: ANMF chunk too short")
            x0 = 2 * int.from_bytes(body[0:3], "little")
            y0 = 2 * int.from_bytes(body[3:6], "little")
            fw = int.from_bytes(body[6:9], "little") + 1
            fh = int.from_bytes(body[9:12], "little") + 1
            frame_alph = None
            for sub, frame, padded in _chunks(body, 16, len(body)):
                if sub == b"ALPH" and frame_alph is None:
                    frame_alph = frame
                    continue
                if sub == b"VP8L" and frame_alph is not None:
                    raise ValueError("WebP: an ALPH chunk before a VP8L one")
                if sub not in (b"VP8L", b"VP8 "):
                    continue
                px = _rgb(decode(frame)) if sub == b"VP8L" else \
                    _lossy_frame(padded, frame_alph, decode, lossy, stats)
                if tuple(px.shape[:2]) != (fh, fw) or x0 + fw > cw or \
                        y0 + fh > ch:
                    raise ValueError("WebP: a frame outside its canvas")
                if isinstance(px, np.ndarray):
                    canvas = np.zeros((ch, cw) + px.shape[2:], np.uint8)
                else:
                    canvas = px.new_zeros((ch, cw) + tuple(px.shape[2:]))
                canvas[y0:y0 + fh, x0:x0 + fw] = px
                return canvas
            raise ValueError("WebP: an animation frame without a bitstream")
    raise ValueError("WebP: no image bitstream")


def _rgb(argb: np.ndarray) -> np.ndarray:
    return np.stack([(argb >> s) & 0xFF for s in (16, 8, 0)],
                    axis=-1).astype(np.uint8)
