"""CCITT bilevel coding in TIFF, as libtiff decodes it for PIL: the plain
Python twin of ``csrc/tiff_decode.cu``'s ``tiff_ccitt_decode``.

A strip or tile decodes into rows of bits, most significant first, a run
of black as ones and of white as zeros (libtiff's fill; PIL's mode ``1``
unpackers then read the photometric):

* compression 2 (CCITT RLE, modified Huffman): each row one-dimensional,
  starting on a byte boundary, no EOL;
* compression 3 (T.4, Group 3): an EOL (eleven or more zeros and a one:
  fill bits before it are skipped) before each row, or, where a strip
  holds no eleven zeros at all, no EOL (libtiff then reads the rows one
  after the other); with T4Options (tag 292) bit 0 a tag bit after the
  EOL's place, 1 for a one-dimensional row and 0 for a two-dimensional
  (MR) one;
* compression 4 (T.6, Group 4, MMR): every row two-dimensional, no EOL.

One-dimensional rows alternate white and black runs from white, each any
number of makeup codes (64 to 1,728 by colour, 1,792 to 2,560 shared)
and a terminating code (0 to 63). Two-dimensional rows code each change
against the row above (white above the first row of a strip): pass,
horizontal (two runs) and the seven vertical modes. Any width.

A damaged stream (an unknown code, a row that runs past its width or
out of data, a change left of the one before, T.4's uncompressed mode)
raises ``ValueError`` naming it, where libtiff warns and fills the row.
"""

from __future__ import annotations

import ctypes

import numpy as np

# T.4 tables 2 and 3: run length -> code, by colour
WHITE_CODES = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100")
WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011")
BLACK_CODES = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111")
BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101")
# 1,792 to 2,560 in steps of 64, both colours
EXTENDED_MAKEUP = (
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111")
EOL = "000000000001"
# T.4 table 4: the two-dimensional modes; a vertical mode's value is the
# change's offset from b1
PASS, HORIZONTAL, EXTENSION = 100, 101, 102
MODE_CODES = {"1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
              "000010": -2, "0000010": -3, "0001": PASS, "001": HORIZONTAL,
              "0000001": EXTENSION}
# a run's lookup: 13 bits peeked, each entry (bits used, run or kind)
RUN_BITS, MODE_BITS = 13, 7
TERMINATING, MAKEUP, EOL_CODE = 0, 1, 2
ERRORS = {1: "CCITT: truncated data", 2: "CCITT: bad run code",
          3: "CCITT: bad two-dimensional mode code",
          4: "CCITT: a row runs past its width",
          5: "CCITT: a change left of the one before",
          6: "CCITT: no EOL before a row",
          7: "CCITT: uncompressed mode is not ported",
          8: "CCITT: an EOL inside a row",
          9: "CCITT: not a CCITT compression or size"}


def _run_table(codes, makeup):
    """Entries of a colour's codes over RUN_BITS peeked bits: (bits used,
    kind, run); bits used 0 where no code matches."""
    used = np.zeros(1 << RUN_BITS, np.int32)
    kind = np.zeros(1 << RUN_BITS, np.int32)
    run = np.zeros(1 << RUN_BITS, np.int32)
    entries = [(c, TERMINATING, r) for r, c in enumerate(codes)]
    entries += [(c, MAKEUP, 64 * (i + 1)) for i, c in enumerate(makeup)]
    entries += [(c, MAKEUP, 1792 + 64 * i)
                for i, c in enumerate(EXTENDED_MAKEUP)]
    entries.append((EOL, EOL_CODE, 0))
    for code, k, r in entries:
        n = len(code)
        lo = int(code, 2) << (RUN_BITS - n)
        used[lo:lo + (1 << (RUN_BITS - n))] = n
        kind[lo:lo + (1 << (RUN_BITS - n))] = k
        run[lo:lo + (1 << (RUN_BITS - n))] = r
    return used.tolist(), kind.tolist(), run.tolist()


def _mode_table():
    used = np.zeros(1 << MODE_BITS, np.int32)
    mode = np.zeros(1 << MODE_BITS, np.int32)
    for code, m in MODE_CODES.items():
        n = len(code)
        lo = int(code, 2) << (MODE_BITS - n)
        used[lo:lo + (1 << (MODE_BITS - n))] = n
        mode[lo:lo + (1 << (MODE_BITS - n))] = m
    return used.tolist(), mode.tolist()


RUNS = (_run_table(WHITE_CODES, WHITE_MAKEUP),
        _run_table(BLACK_CODES, BLACK_MAKEUP))
MODES = _mode_table()


class _Bits:
    """The stream, most significant bit of each byte first."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.end = data + bytes(4), 0, 8 * len(data)

    def peek(self, n: int) -> int:
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "big")
        return (v >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def skip(self, n: int):
        self.pos += n
        if self.pos > self.end:
            raise ValueError(ERRORS[1])


def _run(bits: _Bits, colour: int) -> int:
    """One run of ``colour`` (0 white, 1 black): makeup codes, then a
    terminating code."""
    used, kind, run = RUNS[colour]
    total = 0
    while True:
        i = bits.peek(RUN_BITS)
        if not used[i]:
            raise ValueError(ERRORS[2] if bits.pos < bits.end else ERRORS[1])
        if kind[i] == EOL_CODE:
            raise ValueError(ERRORS[8])
        bits.skip(used[i])
        total += run[i]
        if kind[i] == TERMINATING:
            return total


def _row_1d(bits: _Bits, width: int) -> list:
    """A one-dimensional row's changes (the first to black)."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += _run(bits, colour)
        if a0 > width:
            raise ValueError(ERRORS[4])
        changes.append(a0)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, width: int, ref: list) -> list:
    """A two-dimensional row's changes against the reference row's
    (``ref``, ending in three at ``width``)."""
    changes, a0, colour, i = [], -1, 0, 0
    used, mode = MODES
    while a0 < width:
        # b1: the first change of the row above right of a0 to the colour
        # opposite a0's (its index's parity is that colour), b2 the next
        while ref[i] <= a0 or (i & 1) != colour:
            i += 1
        b1, b2 = ref[i], ref[i + 1]
        k = bits.peek(MODE_BITS)
        if not used[k]:
            raise ValueError(ERRORS[3] if bits.pos < bits.end else ERRORS[1])
        bits.skip(used[k])
        m = mode[k]
        if m == PASS:
            a0 = b2
        elif m == HORIZONTAL:
            start = max(a0, 0)
            a1 = start + _run(bits, colour)
            a2 = a1 + _run(bits, colour ^ 1)
            if a2 > width:
                raise ValueError(ERRORS[4])
            changes += [a1, a2]
            a0 = a2
        elif m == EXTENSION:
            raise ValueError(ERRORS[7])
        else:
            a1 = b1 + m
            if a1 < max(a0, 0) or a1 > width:
                raise ValueError(ERRORS[5] if a1 < max(a0, 0) else ERRORS[4])
            changes.append(a1)
            a0 = a1
            colour ^= 1
            if i > 0:
                i -= 1
    return changes


def _find_eol(bits: _Bits) -> bool:
    """libtiff's SYNC_EOL: skip to eleven zero bits, then past the zeros
    to the one that ends the EOL; False (nothing read) where the data
    holds no eleven zeros."""
    start = bits.pos
    while bits.peek(11) != 0:
        if bits.pos + 12 > bits.end:
            bits.pos = start
            return False
        bits.pos += 1
    while bits.peek(1) == 0:
        bits.skip(1)
    bits.skip(1)
    return True


def _fill(row: np.ndarray, changes: list, width: int):
    for k in range(0, len(changes) - 1, 2):
        row[changes[k]:min(changes[k + 1], width)] = 1


def decode_ccitt(data: bytes, kind: int, width: int, rows: int,
                 options: int = 0) -> bytes:
    """One strip or tile (bytes in fill order 1) of compression ``kind``
    (2, 3 or 4) -> ``rows`` rows of ceil(width / 8) bytes, ones black.
    ``options``: T4Options for compression 3 (bit 0 two-dimensional
    coding, bit 1 uncompressed mode; fill bits, bit 2, need nothing),
    T6Options for 4."""
    if width < 1 or rows < 0 or kind not in (2, 3, 4):
        raise ValueError(ERRORS[9])
    bits = _Bits(data)
    out = np.zeros((rows, width), np.uint8)
    ref = [width] * 3
    eols = True
    for y in range(rows):
        if kind == 2:
            changes = _row_1d(bits, width)
            bits.pos = -(-bits.pos // 8) * 8
        elif kind == 3:
            # libtiff looks for an EOL before the first row: where the
            # strip holds none, its rows follow each other without
            if (y == 0 or eols) and not _find_eol(bits):
                if y:
                    raise ValueError(ERRORS[6])
                eols = False
            one_d = True
            if options & 1:
                one_d = bool(bits.peek(1))
                bits.skip(1)
            changes = (_row_1d(bits, width) if one_d
                       else _row_2d(bits, width, ref))
        elif kind == 4:
            changes = _row_2d(bits, width, ref)
        else:
            raise ValueError(ERRORS[9])
        if len(changes) & 1:
            changes.append(width)
        _fill(out[y], changes, width)
        ref = [c for c in changes if c < width] + [width] * 3
    return np.packbits(out, axis=1).tobytes()


def decode_ccitt_native(data: bytes, kind: int, width: int, rows: int,
                        options: int = 0, library=None) -> bytes:
    """The host C++ decoder (``csrc/tiff_decode.cu``) on the same strip:
    ``decode_ccitt``'s bytes. ``library``: a loaded build (the tests build
    it with g++)."""
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("tiff_decode")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(rows * ((width + 7) // 8), 1), np.uint8)
    err = library.tiff_ccitt_decode(
        ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(src)), kind,
        options, width, rows, ctypes.c_void_p(out.ctypes.data))
    if err:
        raise ValueError(ERRORS.get(err, f"CCITT: error {err}"))
    return out[:rows * ((width + 7) // 8)].tobytes()
