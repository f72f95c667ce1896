"""Encoders and a libjpeg helper for the JPEG kinds PIL does not write:
arithmetic-coded (SOF9 / SOF10), lossless (SOF3, SOF11) and progressive
streams that stop refining early.

* ``Libjpeg``: ``tests/torch_jpeg_writer.c`` built with gcc against a
  libjpeg (the system's ``-ljpeg`` by default) and called through ctypes:
  ``write`` (arithmetic coding, DAC conditioning, sampling factors, restart
  intervals, scan scripts), ``coefficients`` (``jpeg_read_coefficients``
  into ``io/jpeg``'s block layout) and ``pixels`` (``jpeg_read_scanlines``).
* ``write_lossless``: a numpy SOF3 writer (T.81 Annex H, Huffman) for any
  predictor, point transform, restart interval, component ids, markers,
  sampling factors and scan layout; ``arithmetic=True`` writes SOF11 with
  ``ArithEncoder`` (Annex D) and the lossless statistics of H.1.2.3.
* ``ArithEncoder``: libjpeg's ``jcarith.c`` coder, which
  ``write_arithmetic`` also drives to write a SOF9 stream from quantised
  coefficients (the coder checked against libjpeg's decoder).

The reference for every stream is PIL's decode of its bytes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

from superviseddescent_tpu_torch.io import jpeg
from torch_jpeg_fixtures import _BitWriter, _segment

HERE = os.path.dirname(os.path.abspath(__file__))
WRITER_C = os.path.join(HERE, "torch_jpeg_writer.c")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


class Libjpeg:
    """``tests/torch_jpeg_writer.c`` built into ``directory`` against a
    libjpeg: ``link`` is the gcc arguments that name it (the system's
    ``-ljpeg`` by default). Raises ``OSError`` where gcc or the library is
    missing."""

    def __init__(self, directory, link=("-ljpeg",), name="tjw"):
        gcc = shutil.which("gcc")
        if gcc is None:
            raise OSError("no gcc")
        path = os.path.join(str(directory), f"lib{name}.so")
        proc = subprocess.run([gcc, "-O2", "-shared", "-fPIC", "-o", path,
                               WRITER_C, *link], capture_output=True,
                              text=True)
        if proc.returncode:
            raise OSError(f"gcc failed: {proc.stderr[-500:]}")
        lib = ctypes.CDLL(path)
        lib.tjw_write.argtypes = [_P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _P,
                                  _P, _I, _I, _P, _L, _P, _P]
        lib.tjw_read_coefficients.argtypes = [_P, _L, _P, _P, _P, _P, _P]
        lib.tjw_read_pixels.argtypes = [_P, _L, _P, _L, _P, _P]
        self.lib = lib

    def write(self, pixels, quality=75, sampling=None, arithmetic=True,
              progressive=False, restart=0, restart_rows=0, dac=None,
              scans=None, optimize=False) -> bytes:
        """``pixels``: uint8 (H, W) grey or (H, W, 3) RGB; ``sampling``: (h,
        v) per component (default 1x1 each); ``dac``: {("dc", t): (L, U),
        ("ac", t): Kx} over libjpeg's defaults; ``scans``: [(components,
        Ss, Se, Ah, Al)], components as indices."""
        px = np.ascontiguousarray(pixels, np.uint8)
        h, w = px.shape[:2]
        nc = 1 if px.ndim == 2 else 3
        samp = np.asarray(sampling or [(1, 1)] * nc, np.int32).ravel()
        cond = None
        if dac:
            cond = np.array([0] * 16 + [1] * 16 + [5] * 16, np.int32)
            for (kind, t), v in dac.items():
                if kind == "dc":
                    cond[t], cond[16 + t] = v
                else:
                    cond[32 + t] = v
        script = None
        if scans is not None:
            script = np.array([[len(c), *(list(c) + [0] * (4 - len(c))), ss,
                                se, ah, al] for c, ss, se, ah, al in scans],
                              np.int32)
        cap = w * h * nc * 8 + 65536
        out = np.zeros(cap, np.uint8)
        size, msg = _L(0), ctypes.create_string_buffer(256)
        err = self.lib.tjw_write(
            px.ctypes.data, w, h, nc, quality, samp.ctypes.data,
            int(arithmetic), int(progressive), restart, restart_rows,
            None if cond is None else cond.ctypes.data,
            None if script is None else script.ctypes.data,
            0 if script is None else len(script), int(optimize),
            out.ctypes.data, cap, ctypes.byref(size), msg)
        if err:
            raise ValueError(msg.value.decode())
        return out[:size.value].tobytes()

    def coefficients(self, data: bytes, frame) -> np.ndarray:
        """libjpeg's quantised coefficients in ``io/jpeg``'s (blocks, 64)
        layout for ``frame`` (its ``parse_jpeg``), zero where libjpeg's
        arrays hold no block."""
        out = np.zeros((frame.blocks, 64), np.int16)
        comps = frame.components
        offsets = np.array([c.offset for c in comps], np.int32)
        nbx = np.array([c.nbx for c in comps], np.int32)
        nby = np.array([c.nby for c in comps], np.int32)
        buf = np.frombuffer(data, np.uint8)
        msg = ctypes.create_string_buffer(256)
        if self.lib.tjw_read_coefficients(
                buf.ctypes.data, len(buf), out.ctypes.data,
                offsets.ctypes.data, nbx.ctypes.data, nby.ctypes.data, msg):
            raise ValueError(msg.value.decode())
        return out

    def pixels(self, data: bytes) -> np.ndarray:
        """libjpeg's default decompression: (H, W, 1) grey or (H, W, 3)."""
        buf = np.frombuffer(data, np.uint8)
        cap = 1 << 26
        out = np.zeros(cap, np.uint8)
        shape = np.zeros(3, np.int32)
        msg = ctypes.create_string_buffer(256)
        if self.lib.tjw_read_pixels(buf.ctypes.data, len(buf),
                                    out.ctypes.data, cap, shape.ctypes.data,
                                    msg):
            raise ValueError(msg.value.decode())
        h, w, c = shape.tolist()
        return out[:h * w * c].reshape(h, w, c)


# ------------------------------------------------------ arithmetic coder
class ArithEncoder:
    """T.81 Annex D's encoder as libjpeg's ``jcarith.c`` writes it: the
    statistics bins are bytes (bit 7 the MPS, the rest the state index)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, byte):
        self.out.append(byte)

    def _flush_pending(self, byte):
        while self.zc:
            self._emit(0)
            self.zc -= 1
        self._emit(byte)

    def encode(self, stats, index, val):
        sv = stats[index]
        qe, nmps, nlps, switch = jpeg.ARITAB[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[index] = (sv & 0x80) ^ (switch << 7 | nlps)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[index] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_pending(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_pending(self.buffer)
                    if self.sc:
                        while self.zc:
                            self._emit(0)
                            self.zc -= 1
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """Section D.1.8's termination; the bytes, stuffed."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_pending(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_pending(self.buffer)
            if self.sc:
                while self.zc:
                    self._emit(0)
                    self.zc -= 1
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            while self.zc:
                self._emit(0)
                self.zc -= 1
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if shift == 11 and not self.c & mask:
                    break
                byte = (self.c >> shift) & 0xFF
                self._emit(byte)
                if byte == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _encode_value(enc, stats, sign_bin, sign, mag_bin, x_bins, v):
    """F.21-F.24 for a nonzero |v| - 1 = ``v``: the sign (``sign_bin``:
    (stats, index) or None for the fixed bin), the magnitude category from
    ``mag_bin`` then ``x_bins`` (a callable giving the n-th X bin), the
    magnitude bits (M bins 14 past each X)."""
    sstats, sindex = sign_bin
    enc.encode(sstats, sindex, sign)
    m = 0 if v == 0 else 1 << (v.bit_length() - 1)
    stats, idx = mag_bin
    if m == 0:
        enc.encode(stats, idx, 0)
        return 0, idx
    enc.encode(stats, idx, 1)
    n, st = 1, x_bins(0)
    bound = 1
    while bound < m:
        enc.encode(stats, st, 1)
        bound <<= 1
        n += 1
        st = x_bins(n - 1)
    enc.encode(stats, st, 0)
    st += 14
    bit = m >> 1
    while bit:
        enc.encode(stats, st, 1 if v & bit else 0)
        bit >>= 1
    return m, st


def write_arithmetic(width, height, sampling, qtables, coef, restart=0,
                     tq=(0, 1, 1)) -> bytes:
    """A SOF9 stream of the coefficients ``coef`` ((blocks, 64) int16,
    natural order, ``io/jpeg``'s layout), one interleaved scan, default
    conditioning and no DAC segment, coded by ``ArithEncoder`` as
    ``jcarith.c``'s ``encode_mcu``."""
    frame = jpeg.JpegFrame(width, height, [
        jpeg.Component(i + 1, h, v, tq[i]) for i, (h, v) in
        enumerate(sampling)])
    jpeg._layout(frame)
    out = bytearray(b"\xff\xd8")
    out += _segment(jpeg.DQT, b"".join(
        bytes([t]) + bytes(np.asarray(q)[jpeg.ZIGZAG].astype(np.uint8))
        for t, q in sorted(qtables.items())))
    out += _segment(0xC9, bytes([8]) + height.to_bytes(2, "big")
                    + width.to_bytes(2, "big") + bytes([len(sampling)])
                    + b"".join(bytes([i + 1, h << 4 | v, tq[i]])
                               for i, (h, v) in enumerate(sampling)))
    if restart:
        out += _segment(jpeg.DRI, restart.to_bytes(2, "big"))
    comps = list(range(len(sampling)))
    tbl = [min(ci, 1) for ci in comps]
    out += _segment(jpeg.SOS, bytes([len(comps)]) + b"".join(
        bytes([ci + 1, t << 4 | t]) for ci, t in zip(comps, tbl))
        + bytes([0, 63, 0]))
    scan = jpeg.Scan(comps, 0, 63, 0, 0, [None] * len(comps),
                     [None] * len(comps))
    mcux, mcuy, units = jpeg._units(frame, scan, {})
    zz = jpeg.ZIGZAG.tolist()

    def fresh():
        return ([bytearray(64) for _ in range(2)],
                [bytearray(256) for _ in range(2)], [0] * len(comps),
                [0] * len(comps))

    enc = ArithEncoder()
    dc_stats, ac_stats, last_dc, dc_ctx = fresh()
    fixed = bytearray([113])
    for mcu in range(mcux * mcuy):
        if restart and mcu and mcu % restart == 0:
            out += enc.finish()
            out += bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
            enc = ArithEncoder()
            dc_stats, ac_stats, last_dc, dc_ctx = fresh()
        my, mx = divmod(mcu, mcux)
        for k, _, _, base, v, h, nbx in units:
            block = coef[base + my * v * nbx + mx * h]
            t = tbl[k]
            st = dc_stats[t]
            diff = int(block[0]) - last_dc[k]
            last_dc[k] = int(block[0])
            s0 = dc_ctx[k]
            if diff == 0:
                enc.encode(st, s0, 0)
                dc_ctx[k] = 0
            else:
                enc.encode(st, s0, 1)
                sign = int(diff < 0)
                m, _ = _encode_value(enc, st, (st, s0 + 1), sign,
                                     (st, s0 + 2 + sign),
                                     lambda n: 20 + n, abs(diff) - 1)
                # L = 0, U = 1: bounds 0 and 1
                dc_ctx[k] = (0 if m < 0 else 12 + 4 * sign if m > 1
                             else 4 + 4 * sign)
            ast = ac_stats[t]
            last = max([i for i in range(1, 64) if block[zz[i]]], default=0)
            i = 1
            while i <= 63:
                se = 3 * (i - 1)
                if i > last:
                    enc.encode(ast, se, 1)                 # EOB
                    break
                enc.encode(ast, se, 0)
                while not block[zz[i]]:
                    enc.encode(ast, se + 1, 0)
                    i += 1
                    se = 3 * (i - 1)
                enc.encode(ast, se + 1, 1)
                val = int(block[zz[i]])
                sign = int(val < 0)
                kx = 189 if i <= 5 else 217
                v = abs(val) - 1
                enc.encode(fixed, 0, sign)
                m = 0 if v == 0 else 1 << (v.bit_length() - 1)
                enc.encode(ast, se + 2, 0 if m == 0 else 1)
                if m:
                    if m == 1:
                        enc.encode(ast, se + 2, 0)
                        mbin = se + 2
                    else:
                        enc.encode(ast, se + 2, 1)
                        st2, bound = kx, 2
                        while bound < m:
                            enc.encode(ast, st2, 1)
                            bound <<= 1
                            st2 += 1
                        enc.encode(ast, st2, 0)
                        mbin = st2
                    mbin += 14
                    bit = m >> 1
                    while bit:
                        enc.encode(ast, mbin, 1 if v & bit else 0)
                        bit >>= 1
                i += 1
    out += enc.finish()
    return bytes(out + b"\xff\xd9")


# ------------------------------------------------------------- lossless
# a Huffman table over every difference category 0-16 (lengths 3 to 9)
FULL_TABLE = ([0, 0, 6, 2, 2, 2, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0],
              list(range(17)))


def optimal_table(counts) -> tuple:
    """A Huffman table (bits, values) for symbol counts {symbol: n}: code
    lengths from the counts, limited to 16 bits as T.81 K.3 limits them,
    with no code of all ones."""
    import heapq
    freq = {s: n for s, n in counts.items() if n}
    freq[256] = 1                      # reserves the all-ones code
    heap = [(n, i, [s]) for i, (s, n) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    length = dict.fromkeys(freq, 0)
    while len(heap) > 1:
        a, b = heapq.heappop(heap), heapq.heappop(heap)
        for s in a[2] + b[2]:
            length[s] += 1
        heapq.heappush(heap, (a[0] + b[0], min(a[1], b[1]), a[2] + b[2]))
    bits = [0] * 40
    for n in length.values():
        bits[n] += 1
    for i in range(39, 16, -1):
        while bits[i]:
            j = i - 2
            while not bits[j]:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while not bits[i]:
        i -= 1
    bits[i] -= 1                       # the reserved code
    order = sorted((s for s in freq if s != 256),
                   key=lambda s: (length[s], -freq[s], s))
    return bits[1:17], order


def _huffman(bits, vals):
    return {sym: (code, length) for length, code, sym in
            jpeg.huffman_codes(bits, vals)}


def lossless_layout(width, height, sampling):
    """Each component's sample extent (dh, dw) as libjpeg computes it."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    return [(-(-height * v // vmax), -(-width * h // hmax))
            for h, v in sampling]


def lossless_differences(planes, predictor, pt, first_rows):
    """Standard (H.1.2.1) differences of each plane (uint8 (dh, dw)) after
    the point transform: the first row of the scan and of each restart
    interval (``first_rows``: per plane, the row indices) predicted from
    the left (its first sample from 2^(7 - Pt)), the first column from
    above; mod 2^16, as int32 in [-32768, 32767]."""
    out = []
    for plane, firsts in zip(planes, first_rows):
        x = plane.astype(np.int64) >> pt
        dh, dw = x.shape
        ra = np.zeros_like(x)
        ra[:, 1:] = x[:, :-1]
        rb = np.zeros_like(x)
        rb[1:] = x[:-1]
        rc = np.zeros_like(x)
        rc[1:, 1:] = x[:-1, :-1]
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                7: (ra + rb) >> 1}[predictor].copy()
        pred[:, 0] = rb[:, 0]
        for r in firsts:
            pred[r, 1:] = x[r, :-1]
            pred[r, 0] = 1 << (7 - pt)
        d = (x - pred) & 0xFFFF
        out.append((d - ((d & 0x8000) << 1)).astype(np.int32))
    return out


def _scan_geometry(width, height, sampling, comps, ext, restart):
    """A lossless scan's MCUs a row and rows, and per component the rows
    that open a restart interval (the standard's first lines)."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if len(comps) == 1:
        dh, dw = ext[comps[0]]
        mcux, mcuy = dw, dh
    else:
        mcux, mcuy = -(-width // hmax), -(-height // vmax)
    rows_per = restart // mcux if restart else mcuy
    firsts = {ci: [r * (1 if len(comps) == 1 else sampling[ci][1])
                   for r in range(0, mcuy, max(rows_per, 1))]
              for ci in comps}
    return mcux, mcuy, firsts


def _optimal_for(planes, width, height, sampling, predictor, pt, restart,
                 scans):
    """One Huffman table fitted to every difference the scans code."""
    ext = lossless_layout(width, height, sampling)
    counts = {}
    for comps in scans:
        _, _, firsts = _scan_geometry(width, height, sampling, comps, ext,
                                      restart)
        for d in lossless_differences([planes[ci] for ci in comps],
                                      predictor, pt,
                                      [firsts[ci] for ci in comps]):
            a = np.abs(d.astype(np.int64))
            size = np.where(d == -32768, 16, np.ceil(np.log2(a + 1)))
            for s, n in zip(*np.unique(size.astype(np.int64),
                                       return_counts=True)):
                counts[int(s)] = counts.get(int(s), 0) + int(n)
    counts[0] = counts.get(0, 0) + 1            # the padding samples' zeros
    return optimal_table(counts)


def write_lossless(planes, width, height, sampling=None, predictor=1, pt=0,
                   restart=0, ids=None, scans=None, markers=(),
                   table=FULL_TABLE, precision=8, diffs_hook=None,
                   arithmetic=False) -> bytes:
    """A lossless JPEG (SOF3, or SOF11 with ``arithmetic``) of ``planes``
    (uint8 (dh, dw) per component at ``lossless_layout``'s extents).
    ``sampling``: (h, v) per component; ``restart``: the interval in MCUs
    (DRI); ``ids``: the component ids (1, 2, ...); ``scans``: component
    index lists, one a scan (default: one interleaved scan); ``markers``:
    "jfif", "adobe0", "adobe1" segments; ``table``: the Huffman table
    (bits, values) every component uses, or None to write no DHT (the
    decoder's standard tables); ``diffs_hook(diffs)`` may change the
    differences before they are coded."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    scans = scans or [list(range(n))]
    optimise = table == "optimal"
    ext = lossless_layout(width, height, sampling)
    out = bytearray(b"\xff\xd8")
    for m in markers:
        if m == "jfif":
            out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                            b"\x00\x00")
        else:
            out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                            + bytes([int(m[-1])]))
    out += _segment(0xCB if arithmetic else 0xC3, bytes([precision])
                    + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                    + bytes([n]) + b"".join(
                        bytes([ids[i], h << 4 | v, 0])
                        for i, (h, v) in enumerate(sampling)))
    if optimise:
        table = _optimal_for(planes, width, height, sampling, predictor, pt,
                             restart, scans)
    if table is not None and not arithmetic:
        bits, vals = table
        out += _segment(0xC4, bytes([0]) + bytes(bits) + bytes(vals))
        codes = _huffman(bits, vals)
    elif not arithmetic:
        bits, vals = jpeg.STD_HUFFMAN[(0, 0)]
        codes = _huffman(list(bytes.fromhex(bits)), list(bytes.fromhex(vals)))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for comps in scans:
        units = [(comps[0], 0, 0)] if len(comps) == 1 else [
            (ci, y, x) for ci in comps for y in range(sampling[ci][1])
            for x in range(sampling[ci][0])]
        mcux, mcuy, firsts = _scan_geometry(width, height, sampling, comps,
                                            ext, restart)
        diffs = dict(zip(comps, lossless_differences(
            [planes[ci] for ci in comps], predictor, pt,
            [firsts[ci] for ci in comps])))
        if diffs_hook is not None:
            diffs_hook(diffs)
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[ci], 0]) for ci in comps)
            + bytes([predictor, 0, pt]))
        if arithmetic:
            out += _lossless_arith_scan(diffs, comps, units, mcux, mcuy,
                                        sampling, restart, len(comps) == 1)
            continue
        bw = _BitWriter()
        for mcu in range(mcux * mcuy):
            if restart and mcu and mcu % restart == 0:
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
            my, mx = divmod(mcu, mcux)
            for ci, y, x in units:
                h, v = (1, 1) if len(comps) == 1 else sampling[ci]
                r, c = my * v + y, mx * h + x
                d = diffs[ci]
                val = int(d[r, c]) if r < d.shape[0] and c < d.shape[1] \
                    else 0
                if val == -32768:
                    bw.put(*codes[16])
                    continue
                size = abs(val).bit_length()
                bw.put(*codes[size])
                if size:
                    bw.put(val if val >= 0 else val + (1 << size) - 1, size)
        bw.flush()
        out += bw.out
    return bytes(out + b"\xff\xd9")


def _lossless_arith_scan(diffs, comps, units, mcux, mcuy, sampling, restart,
                         single):
    """SOF11's entropy-coded data: each difference coded as H.1.2.3 codes
    it, the context from the differences to the left (Da) and above (Db)
    at the default conditioning L = 0, U = 1, with Annex D's coder."""
    out = bytearray()
    enc = ArithEncoder()
    stats = bytearray(256)              # one conditioning table, 0

    def cls(d):
        if d == 0:
            return 0
        a = abs(d)
        return (1 if d > 0 else 2) if a <= 1 else (3 if d > 0 else 4)

    for mcu in range(mcux * mcuy):
        if restart and mcu and mcu % restart == 0:
            out += enc.finish()
            out += bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
            enc = ArithEncoder()
            stats = bytearray(256)
        my, mx = divmod(mcu, mcux)
        for ci, y, x in units:
            h, v = (1, 1) if single else sampling[ci]
            r, c = my * v + y, mx * h + x
            d = diffs[ci]
            inside = r < d.shape[0] and c < d.shape[1]
            val = int(d[r, c]) if inside else 0
            da = int(d[r, c - 1]) if inside and c > 0 else 0
            db = int(d[r - 1, c]) if inside and r > 0 else 0
            st = stats
            s0 = 4 * (5 * cls(da) + cls(db))
            if val == 0:
                enc.encode(st, s0, 0)
                continue
            enc.encode(st, s0, 1)
            sign = int(val < 0)
            x1 = 129 if cls(db) > 2 else 100
            _encode_value(enc, st, (st, s0 + 1), sign, (st, s0 + 2 + sign),
                          lambda k: x1 + k, abs(val) - 1)
    out += enc.finish()
    return bytes(out)
