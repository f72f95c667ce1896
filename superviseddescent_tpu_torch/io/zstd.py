"""Zstandard (RFC 8878) frames, as libtiff's codec (compression 50000)
stores a strip or tile: the plain Python twin of ``csrc/tiff_decode.cu``'s
``tiff_zstd_decode``. No zstd library.

A frame: its header (single segment or a window descriptor, the content
size in each of its widths; a dictionary ID is refused by name), its
blocks (raw, RLE and compressed, the last one flagged), and with the
checksum flag the low 32 bits of the content's XXH64, verified.
A skippable frame holds nothing. A compressed block holds the literals
(raw, RLE, or Huffman-coded in 1 or 4 streams under a tree described by
FSE-coded or direct 4-bit weights, or under the previous tree) and the
sequences (literal length, match length and offset codes, each table
predefined, RLE, FSE-coded or repeated), executed against the three
repeat offsets, which carry across the frame's blocks.

``read_strip`` reads a strip as libtiff's codec does: one pass of
``ZSTD_decompressStream``, which ends with the first frame (a skippable
frame first leaves the strip short, a second frame is not read: PIL then
fails, and so does the port); ``decode_frame`` reads any frame at a
position. A damaged stream raises ``ValueError`` naming it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

MAGIC, SKIPPABLE = 0xFD2FB528, 0x184D2A50
MAX_BLOCK = 1 << 17
# RFC 8878 3.1.1.3.2.1.1: (baseline, extra bits) of each code
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# RFC 8878 3.1.1.3.2.2: the predefined distributions and accuracy logs
LL_DEFAULT = (6, (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                  2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1))
ML_DEFAULT = (6, (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1))
OF_DEFAULT = (5, (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, -1, -1, -1, -1, -1))
# (largest symbol, largest accuracy log) of LL, OF, ML and Huffman weights
LL_LIMITS, OF_LIMITS, ML_LIMITS, WEIGHT_LIMITS = (35, 9), (31, 8), (52, 9), (
    255, 6)
MAX_HUFFMAN_BITS = 11
M64 = (1 << 64) - 1
XXH_PRIMES = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
              0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)
# the C++ decoder's error codes (csrc/tiff_decode.cu)
ERRORS = {1: "Zstandard: truncated data", 2: "Zstandard: bad frame header",
          3: "Zstandard: dictionaries are not ported",
          4: "Zstandard: bad block", 5: "Zstandard: bad literals",
          6: "Zstandard: bad Huffman tree", 7: "Zstandard: bad FSE table",
          8: "Zstandard: bad sequences",
          9: "Zstandard: an offset before the frame",
          10: "Zstandard: content checksum mismatch",
          11: "Zstandard: no frame",
          12: "Zstandard: frame content size mismatch"}


def _fail(code: int):
    raise ValueError(ERRORS[code])


class _Forward:
    """A little-endian bitstream read from its first byte (FSE table
    descriptions)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, 8 * pos

    def peek(self, n: int) -> int:
        p = self.bit
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "little")
        return (v >> (p & 7)) & ((1 << n) - 1)


class _Backward:
    """A bitstream read from its last bit toward its first, the highest
    set bit of its last byte the start marker; reads past the start give
    zeros (``pos`` below 0: overflowed)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            _fail(4 if not data else 8)
        self.data = data
        self.pos = 8 * len(data) - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.pos -= n
        return v

    def peek(self, n: int) -> int:
        lo = self.pos - n
        if lo >= 0:
            v = int.from_bytes(self.data[lo >> 3:(self.pos + 7) >> 3],
                               "little")
            return (v >> (lo & 7)) & ((1 << n) - 1)
        if self.pos <= 0:
            return 0
        v = int.from_bytes(self.data[:(self.pos + 7) >> 3], "little")
        return (v & ((1 << self.pos) - 1)) << -lo


class _Fse:
    """An FSE decoding table: per state its symbol, bits to read and the
    baseline of the next state."""

    def __init__(self, log: int, counts):
        size = 1 << log
        self.log = log
        symbol = [0] * size
        high = size - 1
        nxt = list(counts)
        for s, c in enumerate(counts):
            if c == -1:
                symbol[high] = s
                high -= 1
                nxt[s] = 1
        step, pos = (size >> 1) + (size >> 3) + 3, 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                symbol[pos] = s
                pos = (pos + step) & (size - 1)
                while pos > high:
                    pos = (pos + step) & (size - 1)
        if pos != 0:
            _fail(7)
        self.symbol, self.bits, self.base = symbol, [0] * size, [0] * size
        for u in range(size):
            s = symbol[u]
            n = nxt[s]
            nxt[s] += 1
            b = log - (n.bit_length() - 1)
            self.bits[u], self.base[u] = b, (n << b) - size

    @classmethod
    def rle(cls, symbol: int):
        t = cls.__new__(cls)
        t.log, t.symbol, t.bits, t.base = 0, [symbol], [0], [0]
        return t


def _read_counts(data: bytes, pos: int, limits) -> tuple:
    """An FSE table description at ``data[pos:]`` (zstd's
    ``FSE_readNCount``) -> (accuracy log, counts, bytes used)."""
    max_symbol, max_log = limits
    bits = _Forward(data, pos)
    end = 8 * len(data)
    log = bits.peek(4) + 5
    bits.bit += 4
    if log > max_log:
        _fail(7)
    remaining, threshold, nb = (1 << log) + 1, 1 << log, log + 1
    counts, previous0 = [], False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n = 0
            while bits.peek(2) == 3:
                n += 3
                bits.bit += 2
            n += bits.peek(2)
            bits.bit += 2
            counts += [0] * n
            if len(counts) > max_symbol + 1:
                _fail(7)
            if len(counts) > max_symbol:
                break
        top = 2 * threshold - 1 - remaining
        v = bits.peek(nb)
        if (v & (threshold - 1)) < top:
            count = v & (threshold - 1)
            bits.bit += nb - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            bits.bit += nb
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
        if bits.bit > end:
            _fail(1)
    if remaining != 1 or len(counts) > max_symbol + 1:
        _fail(7)
    return log, counts, (bits.bit + 7) // 8 - pos


def _weights(data: bytes, pos: int) -> tuple:
    """A Huffman tree description -> (weights of the symbols but the last,
    bytes used)."""
    if pos >= len(data):
        _fail(1)
    head = data[pos]
    if head >= 128:
        n = head - 127
        used = (n + 1) // 2
        body = data[pos + 1:pos + 1 + used]
        if len(body) < used:
            _fail(1)
        w = [(body[i // 2] >> (0 if i & 1 else 4)) & 15 for i in range(n)]
        return w, 1 + used
    body = data[pos + 1:pos + 1 + head]
    if len(body) < head or head == 0:
        _fail(1 if len(body) < head else 6)
    log, counts, used = _read_counts(body, 0, WEIGHT_LIMITS)
    table = _Fse(log, counts)
    bits = _Backward(body[used:])
    states = [bits.read(log), bits.read(log)]
    out = []
    k = 0
    while True:
        s = states[k]
        out.append(table.symbol[s])
        states[k] = table.base[s] + bits.read(table.bits[s])
        if bits.pos < 0:
            out.append(table.symbol[states[k ^ 1]])
            break
        k ^= 1
        if len(out) > 255:
            _fail(6)
    return out, 1 + head


class _Huffman:
    """A literals tree: a table over ``bits`` peeked bits of (symbol,
    length)."""

    def __init__(self, weights):
        total = sum(1 << w >> 1 for w in weights if w)
        if not total or total > 1 << MAX_HUFFMAN_BITS or max(weights) > \
                MAX_HUFFMAN_BITS:
            _fail(6)
        bits = total.bit_length()
        left = (1 << bits) - total
        if left & (left - 1):
            _fail(6)
        weights = list(weights) + [left.bit_length()]
        if bits > MAX_HUFFMAN_BITS:
            _fail(6)
        self.bits = bits
        self.symbol = [0] * (1 << bits)
        self.length = [0] * (1 << bits)
        pos = 0
        for w in range(1, bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    span = 1 << (w - 1)
                    self.symbol[pos:pos + span] = [s] * span
                    self.length[pos:pos + span] = [bits + 1 - w] * span
                    pos += span

    def decode(self, stream: bytes, count: int) -> bytes:
        bits = _Backward(stream)
        out = bytearray(count)
        n, symbol, length = self.bits, self.symbol, self.length
        for i in range(count):
            v = bits.peek(n)
            out[i] = symbol[v]
            bits.pos -= length[v]
        if bits.pos != 0:
            _fail(5)
        return bytes(out)


class _Frame:
    """The state a frame carries across its blocks."""

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]        # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(block: bytes, state: _Frame) -> tuple:
    """The literals section -> (literals, bytes used)."""
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if len(block) < (1, 2, 1, 3)[fmt] + (kind == 1):
        _fail(1)
    if kind < 2:
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if size > MAX_BLOCK:
            _fail(5)
        if kind == 0:
            lit = block[head:head + size]
            if len(lit) < size:
                _fail(1)
            return lit, head + size
        if head >= len(block):
            _fail(1)
        return bytes([block[head]]) * size, head + 1
    head, width = ((3, 10), (3, 10), (4, 14), (5, 18))[fmt]
    if len(block) < head:
        _fail(1)
    h = int.from_bytes(block[:head], "little")
    size = (h >> 4) & ((1 << width) - 1)
    comp = (h >> (4 + width)) & ((1 << width) - 1)
    streams = 1 if fmt == 0 else 4
    if size > MAX_BLOCK or head + comp > len(block):
        _fail(5 if size > MAX_BLOCK else 1)
    body = block[head:head + comp]
    used = 0
    if kind == 2:
        weights, used = _weights(body, 0)
        state.huffman = _Huffman(weights)
    elif state.huffman is None:
        _fail(5)
    tree, body = state.huffman, body[used:]
    if streams == 1:
        return tree.decode(body, size), head + comp
    if len(body) < 6:
        _fail(1)
    s1, s2, s3 = struct.unpack_from("<HHH", body)
    rest = len(body) - 6 - s1 - s2 - s3
    if rest < 0:
        _fail(5)
    part = (size + 3) // 4
    if 3 * part > size:
        _fail(5)
    out, at = [], 6
    for k, n in enumerate((s1, s2, s3, rest)):
        out.append(tree.decode(body[at:at + n],
                               part if k < 3 else size - 3 * part))
        at += n
    return b"".join(out), head + comp


def _table(block: bytes, pos: int, mode: int, which: int, state: _Frame):
    limits = (LL_LIMITS, OF_LIMITS, ML_LIMITS)[which]
    if mode == 0:
        log, counts = (LL_DEFAULT, OF_DEFAULT, ML_DEFAULT)[which]
        state.tables[which] = _Fse(log, counts)
        return pos
    if mode == 1:
        if pos >= len(block):
            _fail(1)
        if block[pos] > limits[0]:
            _fail(8)
        state.tables[which] = _Fse.rle(block[pos])
        return pos + 1
    if mode == 2:
        log, counts, used = _read_counts(block, pos, limits)
        state.tables[which] = _Fse(log, counts)
        return pos + used
    if state.tables[which] is None:
        _fail(8)
    return pos


def _sequences(block: bytes, pos: int, state: _Frame) -> list:
    """The sequences section -> [(literal length, offset, match length)]."""
    if pos >= len(block):
        _fail(1)
    b0 = block[pos]
    if b0 == 0:
        if pos + 1 != len(block):
            _fail(8)
        return []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 1 >= len(block):
            _fail(1)
        n, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        if pos + 2 >= len(block):
            _fail(1)
        n, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= len(block):
        _fail(1)
    modes = block[pos]
    if modes & 3:
        _fail(8)
    pos += 1
    for which, shift in ((0, 6), (1, 4), (2, 2)):
        pos = _table(block, pos, (modes >> shift) & 3, which, state)
    ll, of, ml = state.tables
    bits = _Backward(block[pos:])
    s_ll, s_of, s_ml = bits.read(ll.log), bits.read(of.log), bits.read(
        ml.log)
    out = []
    for i in range(n):
        code_of, code_ll, code_ml = (of.symbol[s_of], ll.symbol[s_ll],
                                     ml.symbol[s_ml])
        if code_of > 31:
            _fail(8)
        offset = (1 << code_of) + bits.read(code_of)
        base, extra = ML_CODES[code_ml]
        match = base + bits.read(extra)
        base, extra = LL_CODES[code_ll]
        lit = base + bits.read(extra)
        out.append((lit, offset, match))
        if i + 1 < n:
            s_ll = ll.base[s_ll] + bits.read(ll.bits[s_ll])
            s_ml = ml.base[s_ml] + bits.read(ml.bits[s_ml])
            s_of = of.base[s_of] + bits.read(of.bits[s_of])
        if bits.pos < 0:
            _fail(8)
    if bits.pos != 0:
        _fail(8)
    return out


def _execute(out: bytearray, frame_start: int, lits: bytes, seqs: list,
             state: _Frame):
    """The sequences against the literals, appended to ``out``; a block
    that would decode to more than MAX_BLOCK bytes fails before it
    grows."""
    reps = state.reps
    at, end = 0, len(out) + MAX_BLOCK
    for lit, value, match in seqs:
        if at + lit > len(lits):
            _fail(8)
        if len(out) + lit + match > end:
            _fail(4)
        out += lits[at:at + lit]
        at += lit
        if value > 3:
            offset = value - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            k = value - (lit != 0)
            if k == 0:
                offset = reps[0]
            elif k == 1:
                offset = reps[1]
                reps[:] = [offset, reps[0], reps[2]]
            elif k == 2:
                offset = reps[2]
                reps[:] = [offset, reps[0], reps[1]]
            else:
                offset = reps[0] - 1
                if offset == 0:
                    _fail(8)
                reps[:] = [offset, reps[0], reps[1]]
        start = len(out) - offset
        if start < frame_start:
            _fail(9)
        if offset >= match:
            out += out[start:start + match]
        else:
            for j in range(match):
                out.append(out[start + j])
    out += lits[at:]


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    p1, p2, p3, p4, p5 = XXH_PRIMES

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M64

    def rnd(acc, lane):
        return rotl((acc + lane * p2) & M64, 31) * p1 & M64
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & M64, (seed + p2) & M64, seed,
             (seed - p1) & M64]
        lanes = np.frombuffer(data[:n - n % 32], "<u8").reshape(-1, 4)
        for row in lanes.tolist():
            v = [rnd(a, x) for a, x in zip(v, row)]
        i = n - n % 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & M64
        for a in v:
            h = ((h ^ rnd(0, a)) * p1 + p4) & M64
    else:
        h = (seed + p5) & M64
    h = (h + n) & M64
    while i + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, i)
        h = (rotl(h ^ rnd(0, k), 27) * p1 + p4) & M64
        i += 8
    if i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (rotl(h ^ (k * p1 & M64), 23) * p2 + p3) & M64
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & M64), 11) * p1 & M64
        i += 1
    h ^= h >> 33
    h = h * p2 & M64
    h ^= h >> 29
    h = h * p3 & M64
    return h ^ (h >> 32)


def _frame(data: bytes, pos: int, out: bytearray, limit=None) -> int:
    """One frame at ``data[pos:]`` (after its magic) appended to ``out``;
    returns the position after it. With ``limit``, the blocks stop once
    they hold that many bytes (the rest of the frame, its content size and
    checksum unread)."""
    if pos >= len(data):
        _fail(1)
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = (fhd >> 6, (fhd >> 5) & 1,
                                             (fhd >> 2) & 1, fhd & 3)
    if fhd & 8:
        _fail(2)
    if dict_flag:
        _fail(3)
    if not single:
        if pos >= len(data):
            _fail(1)
        wd = data[pos]
        pos += 1
        log = 10 + (wd >> 3)
        if log > 41:
            _fail(2)
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > len(data):
        _fail(1)
    fcs = int.from_bytes(data[pos:pos + fcs_size], "little") + (
        256 if fcs_size == 2 else 0)
    pos += fcs_size
    start, state = len(out), _Frame()
    while True:
        if pos + 3 > len(data):
            _fail(1)
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            _fail(4)
        if kind == 1:
            if pos >= len(data):
                _fail(1)
            if size > MAX_BLOCK:
                _fail(4)
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if size > MAX_BLOCK or pos + size > len(data):
                _fail(4 if size > MAX_BLOCK else 1)
            block = data[pos:pos + size]
            pos += size
            if kind == 0:
                out += block
            else:
                if not block:
                    _fail(4)
                before = len(out)
                lits, used = _literals(block, state)
                seqs = _sequences(block, used, state)
                _execute(out, start, lits, seqs, state)
                if len(out) - before > MAX_BLOCK:
                    _fail(4)
        if last:
            break
        if limit is not None and len(out) - start >= limit:
            return pos       # as libtiff's pass stops with its strip full
    if fcs_size and len(out) - start != fcs:
        _fail(12)
    if checksum:
        if pos + 4 > len(data):
            _fail(1)
        (want,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            _fail(10)
    return pos


def decode_frame(data: bytes, pos: int = 0, limit=None) -> tuple:
    """The frame at ``data[pos:]`` -> (its content, the position after
    it; with ``limit``, the first blocks that hold that many bytes and
    the position after them); a skippable frame's content is empty."""
    if pos + 4 > len(data):
        _fail(11 if pos == 0 else 1)
    (magic,) = struct.unpack_from("<I", data, pos)
    if magic == MAGIC:
        out = bytearray()
        end = _frame(data, pos + 4, out, limit)
        return bytes(out), end
    if magic & 0xFFFFFFF0 == SKIPPABLE:
        if pos + 8 > len(data):
            _fail(1)
        (n,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + n > len(data):
            _fail(1)
        return b"", pos + 8 + n
    _fail(11)


def read_strip(data: bytes, size: int) -> bytes:
    """A strip or tile as libtiff's codec reads it for PIL: its first
    frame (one ``ZSTD_decompressStream`` pass: a skippable frame first
    gives nothing, a second frame is not read, and the pass stops after
    the block that fills the strip), cut to ``size`` bytes."""
    return decode_frame(data, 0, size)[0][:size]


def read_strip_native(data: bytes, size: int, library=None) -> bytes:
    """The host C++ decoder (``csrc/tiff_decode.cu``) on the same strip:
    ``read_strip``'s bytes. ``library``: a loaded build (the tests build
    it with g++)."""
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("tiff_decode")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(size, 1), np.uint8)
    produced = ctypes.c_int64(0)
    err = library.tiff_zstd_decode(
        ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(src)),
        ctypes.c_void_p(out.ctypes.data), ctypes.c_int64(size),
        ctypes.byref(produced))
    if err:
        raise ValueError(ERRORS.get(err, f"Zstandard: error {err}"))
    return out[:min(produced.value, size)].tobytes()
