"""JPEG writing: the encoder's host side and the plain twins of its two
stages (no PIL, no libjpeg).

Writes the bytes PIL's ``save(format="JPEG")`` writes through
libjpeg-turbo's defaults (PIL's ``optimize``, ``progressive``, restart
markers, custom tables and CMYK off): baseline SOF0, 8-bit, one
interleaved scan; grey (one component, no colour conversion) or YCbCr at
4:4:4, 4:2:2 or 4:2:0 (PIL's default) from RGB; quality 1-100 (75 by
default) through ``jcparam.c``'s ``jpeg_quality_scaling`` and
``jpeg_add_quant_table`` with ``force_baseline``; the standard Huffman
tables of JPEG Annex K.3. The markers are PIL's: SOI, APP0 JFIF 1.01
(density unit 0, 1 x 1, no thumbnail), one DQT per table, SOF0, one DHT
per table (DC then AC of each table in component order), SOS, the
entropy-coded data, EOI.

The forward pixel stage (``coefficients_reference``, the plain twin of
kernel J2 in ``csrc/jpeg_encode.cu``) is libjpeg's integer arithmetic:
``jccolor.c``'s ``rgb_ycc_convert`` (SCALEBITS 16, ``ONE_HALF - 1``
rounding and ``CBCR_OFFSET`` on Cb and Cr); the last column replicated to
the downsampler's input width (``jcsample.c``'s ``expand_right_edge``) and
the last row to the row group (``jcprepct.c``); ``h2v2_downsample`` (bias
1, 2, 1, 2 ... along a row), ``h2v1_downsample`` (bias 0, 1 ...) or the
component as it is; the last downsampled row replicated to the iMCU
height; the level shift, ``jfdctint.c``'s ``jpeg_fdct_islow`` (output
scaled by 8) and the quantisation by ``q << 3``, rounded half away from
zero, as ``jcdctmgr.c``'s reciprocal divide gives it. The MCUs walk
libjpeg's ``jccoefct.c`` ``compress_data``: a block of an interleaved
MCU that lies right of a component's ``width_in_blocks`` is a dummy block
(all AC 0) whose DC repeats the block to its left; one in a block row
below ``height_in_blocks`` repeats the DC of the last block of the MCU's
previous block row. A scan of one component has no dummy blocks.

``entropy_encode`` is the plain twin of the host C++ coder
(``jpeg_huffman_encode`` in the same source): ``jchuff.c``'s
``encode_one_block`` (DC differences per component, runs of zeros with
ZRL, EOB), the byte stuffing and the final byte padded with 1-bits,
vectorised with numpy.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from superviseddescent_tpu_torch.io.jpeg import STD_HUFFMAN, ZIGZAG
from superviseddescent_tpu_torch.utils.device import resolve_device

# jcparam.c: JPEG Annex K's tables, natural order
STD_LUMINANCE_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMINANCE_QUANT = np.array(
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)
# PIL's subsampling names -> the luma's sampling factors (chroma 1 x 1)
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}
DEFAULT_QUALITY = 75
DEFAULT_SUBSAMPLING = "4:2:0"
# jccolor.c's FIX(x) = x * 2^16 + 0.5 of the YCbCr factors
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
CBCR_OFFSET = 128 << SCALEBITS
FIX_Y = (19595, 38470, 7471)           # 0.29900, 0.58700, 0.11400
FIX_CB = (-11059, -21709, 32768)       # -0.16874, -0.33126, 0.5
FIX_CR = (32768, -27439, -5329)        # 0.5, -0.41869, -0.08131
# jfdctint.c
CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765, F0899, F1175 = 2446, 3196, 4433, 6270, 7373, 9633
F1501, F1847, F1961, F2053, F2562, F3072 = (12299, 15137, 16069, 16819,
                                            20995, 25172)
# what PIL's JPEG writer offers and this encoder does not (the JAX package
# never asks for it)
REFUSED_OPTIONS = {
    "progressive": "progressive JPEG", "optimize": "optimised Huffman "
    "tables", "qtables": "custom quantisation tables",
    "restart_marker_blocks": "restart markers", "restart_marker_rows":
    "restart markers", "dpi": "a resolution (dpi)", "icc_profile": "an ICC "
    "profile", "exif": "EXIF data", "comment": "a comment", "smooth":
    "smoothing", "streamtype": "abbreviated streams"}


def quality_scaling(quality: int) -> int:
    """``jpeg_quality_scaling``: a quality 1-100 as a percentage scale."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - 2 * quality


def quant_table(basic: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_add_quant_table`` with ``force_baseline``: (64,) natural
    order, 1..255."""
    scale = quality_scaling(quality)
    return np.clip((basic * scale + 50) // 100, 1, 255)


@dataclass
class EncComponent:
    ident: int
    h: int
    v: int
    tq: int             # quantisation and Huffman table
    wib: int            # libjpeg's width_in_blocks, height_in_blocks
    hib: int
    hexp: int           # full-resolution samples per sample, across, down
    vexp: int
    last_row: int       # the last downsampled row of the image's row groups
    first: int = 0      # first block of the component in an MCU


@dataclass
class EncLayout:
    """The geometry of one image as libjpeg encodes it."""
    width: int
    height: int
    channels: int
    components: list
    mcux: int
    mcuy: int
    quality: int
    quant: np.ndarray   # (tables, 64) natural order

    @property
    def blocks_per_mcu(self) -> int:
        return sum(c.h * c.v for c in self.components)

    @property
    def blocks(self) -> int:
        return self.mcux * self.mcuy * self.blocks_per_mcu


def layout(height: int, width: int, channels: int, quality: int =
           DEFAULT_QUALITY, subsampling: str | None = None) -> EncLayout:
    """libjpeg's geometry for a grey (channels 1) or RGB image: each
    component's sampling factors, ``width_in_blocks`` and
    ``height_in_blocks``, and the MCU grid. ``subsampling`` None is PIL's
    default: 4:2:0 for RGB, one 1 x 1 component for grey (PIL would write
    a grey image under other factors when asked; that is not ported)."""
    if not 1 <= width <= 65535 or not 1 <= height <= 65535:
        raise ValueError(f"JPEG: {width} x {height} is outside 1..65535")
    if channels not in (1, 3):
        raise ValueError(f"JPEG: {channels} channels (grey or RGB only)")
    if channels == 1 and subsampling is not None:
        raise ValueError("JPEG: subsampling of a grey image is not ported "
                         "(PIL's default, one 1 x 1 component, only)")
    subsampling = subsampling or DEFAULT_SUBSAMPLING
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"JPEG subsampling {subsampling!r} is not ported "
                         f"({', '.join(SUBSAMPLING)} only)")
    if not isinstance(quality, (int, np.integer)) or not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality!r} (an integer 1-100)")
    factors = ([(1, 1)] if channels == 1 else
               [SUBSAMPLING[subsampling], (1, 1), (1, 1)])
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    groups = -(-height // vmax)
    comps, first = [], 0
    for i, (h, v) in enumerate(factors):
        c = EncComponent(
            ident=i + 1, h=h, v=v, tq=min(i, 1),
            wib=-(-width * h // (hmax * 8)), hib=-(-height * v // (vmax * 8)),
            hexp=hmax // h, vexp=vmax // v, last_row=groups * v - 1,
            first=first)
        first += h * v
        comps.append(c)
    if channels == 1:
        mcux, mcuy = comps[0].wib, comps[0].hib
    else:
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    quant = np.stack([quant_table(STD_LUMINANCE_QUANT, quality)]
                     + ([quant_table(STD_CHROMINANCE_QUANT, quality)]
                        if channels == 3 else []))
    return EncLayout(width, height, channels, comps, mcux, mcuy, int(quality),
                     quant)


def block_map(lay: EncLayout) -> np.ndarray:
    """(blocks, 5) int64 per block in the coder's order (the MCUs in
    raster order, within one the components in order, each one's blocks
    row by row): its component, its block row and column in the
    component's MCU-padded grid, and the block row and column whose DC it
    takes (itself, or a dummy block's source)."""
    rows = []
    for my in range(lay.mcuy):
        for mx in range(lay.mcux):
            for ci, c in enumerate(lay.components):
                for yi in range(c.v):
                    for xi in range(c.h):
                        by, bx = my * c.v + yi, mx * c.h + xi
                        if by >= c.hib:
                            src = (c.hib - 1, min(mx * c.h + c.h - 1,
                                                  c.wib - 1))
                        else:
                            src = (by, min(bx, c.wib - 1))
                        rows.append((ci, by, bx) + src)
    return np.asarray(rows, np.int64).reshape(-1, 5)


# ------------------------------------------------------- pixel stage twin
def _fix(c, r, g, b):
    return c[0] * r + c[1] * g + c[2] * b


def color_planes(pixels: torch.Tensor) -> list:
    """uint8 (H, W) or (H, W, 3) -> int32 (H, W) planes: the grey itself,
    or ``rgb_ycc_convert``'s Y, Cb, Cr."""
    p = pixels.to(torch.int32)
    if p.dim() == 2:
        return [p]
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = (_fix(FIX_Y, r, g, b) + ONE_HALF) >> SCALEBITS
    cb = (_fix(FIX_CB, r, g, b) + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS
    cr = (_fix(FIX_CR, r, g, b) + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS
    return [y, cb, cr]


def downsampled(plane: torch.Tensor, c: EncComponent, rows: int,
                cols: int) -> torch.Tensor:
    """The component's samples on a ``rows`` x ``cols`` grid as libjpeg's
    downsampler leaves them: edges replicated at full resolution, h2v2 /
    h2v1 with their biases, the last downsampled row repeated below."""
    h, w = plane.shape
    dev = plane.device
    i = torch.clamp(torch.arange(rows, device=dev), max=c.last_row)
    j = torch.arange(cols, device=dev)
    total = 0
    for dy in range(c.vexp):
        ys = torch.clamp(i * c.vexp + dy, max=h - 1)
        for dx in range(c.hexp):
            xs = torch.clamp(j * c.hexp + dx, max=w - 1)
            total = total + plane[ys][:, xs]
    n = c.hexp * c.vexp
    if n == 1:
        return total
    bias = (j & 1) + (1 if n == 4 else 0)
    return (total + bias) >> (2 if n == 4 else 1)


def _fdct_1d(d, pass1: bool):
    """``jpeg_fdct_islow``'s butterfly on eight int32 tensors; pass 1 (the
    rows) scales by 2^PASS1_BITS, pass 2 (the columns) removes it."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS - PASS1_BITS if pass1 else CONST_BITS + PASS1_BITS

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n
    out = [None] * 8
    if pass1:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * F0541
    out[2] = descale(z1 + tmp13 * F0765, shift)
    out[6] = descale(z1 + tmp12 * -F1847, shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5 = tmp4 * F0298, tmp5 * F2053
    tmp6, tmp7 = tmp6 * F3072, tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7] = descale(tmp4 + z1 + z3, shift)
    out[5] = descale(tmp5 + z2 + z4, shift)
    out[3] = descale(tmp6 + z2 + z3, shift)
    out[1] = descale(tmp7 + z1 + z4, shift)
    return out


def fdct_quantize(blocks: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8) int32 samples 0..255 and (64,) quantisers -> (B, 64)
    int32 quantised coefficients, natural order."""
    x = blocks - 128
    rows = torch.stack(_fdct_1d([x[:, :, k] for k in range(8)], True),
                       dim=2)
    cols = torch.stack(_fdct_1d([rows[:, k, :] for k in range(8)], False),
                       dim=1).reshape(-1, 64)
    d = (quant.to(torch.int32) << 3)
    q = (cols.abs() + (d >> 1)) // d
    return torch.where(cols < 0, -q, q)


def coefficients_reference(pixels: torch.Tensor,
                           lay: EncLayout) -> torch.Tensor:
    """The plain twin of kernel J2: uint8 (H, W) grey or (H, W, 3) RGB ->
    (blocks, 64) int16 quantised coefficients in natural order, the
    blocks in the coder's order (``block_map``), dummy blocks included, on
    the pixels' device."""
    dev = pixels.device
    if tuple(pixels.shape[:2]) != (lay.height, lay.width):
        raise ValueError(f"pixels of shape {tuple(pixels.shape)} for a "
                         f"{lay.height} x {lay.width} layout")
    planes = color_planes(pixels)
    quant = torch.as_tensor(lay.quant, device=dev)
    grids = []
    for ci, c in enumerate(lay.components):
        nby, nbx = lay.mcuy * c.v, lay.mcux * c.h
        s = downsampled(planes[ci], c, nby * 8, nbx * 8)
        blocks = s.reshape(nby, 8, nbx, 8).permute(0, 2, 1, 3).reshape(
            -1, 8, 8)
        grids.append(fdct_quantize(blocks, quant[c.tq]).reshape(nby, nbx,
                                                                64))
    bm = torch.as_tensor(block_map(lay), device=dev)
    out = torch.empty((lay.blocks, 64), dtype=torch.int32, device=dev)
    for ci, g in enumerate(grids):
        sel = bm[:, 0] == ci
        by, bx, sy, sx = bm[sel, 1], bm[sel, 2], bm[sel, 3], bm[sel, 4]
        real = (by == sy) & (bx == sx)
        blk = torch.where(real[:, None], g[by, bx], 0)
        blk[:, 0] = g[sy, sx, 0]
        out[sel] = blk.to(torch.int32)
    return out.to(torch.int16)


# -------------------------------------------------------------- Huffman
def code_table(bits, vals):
    """``jpeg_make_c_derived_tbl``: (256,) codes and (256,) lengths by
    symbol (length 0: no code)."""
    codes = np.zeros(256, np.int64)
    sizes = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = code
            sizes[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, sizes


def std_tables(channels: int):
    """[(bits, vals)] of the DC and AC tables of each table number, as
    ``jpeg_set_defaults`` installs them (Annex K.3)."""
    def table(key):
        bits, vals = STD_HUFFMAN[key]
        return list(bytes.fromhex(bits)), list(bytes.fromhex(vals))
    return [(table((0, t)), table((1, t))) for t in range(min(channels, 2))]


def _nbits(a: np.ndarray) -> np.ndarray:
    """The magnitude category: bit length of |a|."""
    m = np.abs(a)
    n = np.zeros(a.shape, np.int64)
    for k in range(16):
        n += (m >> k) > 0
    return n


def _value_bits(a: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The ``n`` low bits that follow a category: a, or a - 1 if
    negative."""
    return (a - (a < 0)) & ((1 << n) - 1)


def entropy_encode(coef, lay: EncLayout) -> bytes:
    """The plain twin of the host coder: (blocks, 64) int16 coefficients
    in the coder's order -> the scan's entropy-coded bytes, stuffed and
    padded with 1-bits."""
    zz = np.asarray(coef, np.int64).reshape(-1, 64)[:, ZIGZAG]
    n_blocks = zz.shape[0]
    comp = np.tile(np.concatenate([np.full(c.h * c.v, ci) for ci, c in
                                   enumerate(lay.components)]),
                   n_blocks // lay.blocks_per_mcu)
    tables = [(code_table(*dc), code_table(*ac))
              for dc, ac in std_tables(lay.channels)]
    tq = np.array([c.tq for c in lay.components])[comp]
    # DC differences, per component
    dc = zz[:, 0]
    diff = np.empty(n_blocks, np.int64)
    for ci in range(len(lay.components)):
        sel = comp == ci
        d = dc[sel]
        diff[sel] = d - np.concatenate([[0], d[:-1]])
    keys, vals, lens = [], [], []

    def emit(key, table_of, symbol, value=None, nb=None, ac=True):
        """Codes of ``symbol`` (each in its table), followed by the
        ``nb`` bits of ``value`` where given; ``key`` orders them."""
        codes = np.zeros(len(symbol), np.int64)
        sizes = np.zeros(len(symbol), np.int64)
        for t, pair in enumerate(tables):
            sel = table_of == t
            co, si = pair[int(ac)]
            codes[sel], sizes[sel] = co[symbol[sel]], si[symbol[sel]]
        keys.append(key)
        if value is None:
            vals.append(codes)
            lens.append(sizes)
        else:
            vals.append((codes << nb) | _value_bits(value, nb))
            lens.append(sizes + nb)
    nb = _nbits(diff)
    emit(np.arange(n_blocks) * 130, tq, nb, diff, nb, ac=False)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prev = np.zeros_like(k)
    same = np.zeros(len(k), bool)
    same[1:] = b[1:] == b[:-1]
    prev[1:] = np.where(same[1:], k[:-1], 0)
    run = k - prev - 1
    value = zz[b, k]
    nbv = _nbits(value)
    emit(b * 130 + 2 * k, tq[b], ((run & 15) << 4) | nbv, value, nbv)
    zrl = np.repeat(np.arange(len(k)), run >> 4)
    emit(b[zrl] * 130 + 2 * k[zrl] - 1, tq[b[zrl]],
         np.full(len(zrl), 0xF0, np.int64))
    last = np.zeros(n_blocks, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    emit(eob * 130 + 129, tq[eob], np.zeros(len(eob), np.int64))
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    at = np.arange(total) - np.repeat(start, ln)
    bits = (np.repeat(val, ln) >> (np.repeat(ln, ln) - 1 - at)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8))
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


# --------------------------------------------------------------- markers
def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def headers(lay: EncLayout) -> bytes:
    """Everything before the entropy-coded data, as PIL writes it."""
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(lay.quant):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            int(v) for v in q[ZIGZAG])))
    sof = struct.pack(">BHHB", 8, lay.height, lay.width,
                      len(lay.components))
    sof += b"".join(bytes([c.ident, c.h << 4 | c.v, c.tq])
                    for c in lay.components)
    out.append(_segment(0xC0, sof))
    for t, (dc, ac) in enumerate(std_tables(lay.channels)):
        for cls, (bits, vals) in ((0, dc), (1, ac)):
            out.append(_segment(0xC4, bytes([cls << 4 | t] + bits + vals)))
    sos = bytes([len(lay.components)]) + b"".join(
        bytes([c.ident, c.tq << 4 | c.tq]) for c in lay.components)
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    return b"".join(out)


def assemble(lay: EncLayout, scan: bytes) -> bytes:
    return headers(lay) + scan + b"\xff\xd9"


def as_pixels(pixels) -> torch.Tensor:
    """A uint8 (H, W) grey or (H, W, 3) RGB array or tensor as a tensor
    (numpy arrays are taken as they are, on the CPU)."""
    if isinstance(pixels, np.ndarray):
        pixels = torch.from_numpy(np.require(pixels, requirements="CW"))
    if pixels.dtype != torch.uint8:
        raise ValueError(f"JPEG: pixels must be uint8, got {pixels.dtype}")
    if not (pixels.dim() == 2 or (pixels.dim() == 3
                                  and pixels.shape[2] == 3)):
        raise ValueError(f"JPEG: pixels of shape {tuple(pixels.shape)} "
                         "(grey (H, W) or RGB (H, W, 3) only)")
    return pixels.contiguous()


def check_options(options: dict) -> None:
    """Refuse, by name, the options of PIL's JPEG writer not ported."""
    for key in options:
        if key in REFUSED_OPTIONS:
            raise ValueError(f"JPEG writing with {REFUSED_OPTIONS[key]} "
                             f"({key}=) is not ported")
        raise ValueError(f"JPEG writing: unknown option {key}=")


def encode_jpeg(pixels, quality: int = DEFAULT_QUALITY,
                subsampling: str | None = None, device=None,
                **options) -> bytes:
    """The JPEG file PIL writes for uint8 grey (H, W) or RGB (H, W, 3)
    pixels. The pixel stage runs on ``device`` (the card unless the caller
    names one, or the pixels' own device for a tensor): kernel J2 and the
    host C++ coder on the card (``ops/jpeg.encode_jpeg_device``), the plain
    twins on the CPU."""
    check_options(options)
    pixels = as_pixels(pixels)
    if device is None and pixels.device.type != "cpu":
        device = pixels.device
    dev = resolve_device(device)
    pixels = pixels.to(dev)
    if dev.type == "cuda":
        from superviseddescent_tpu_torch.ops.jpeg import encode_jpeg_device
        return encode_jpeg_device(pixels, quality, subsampling)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    lay = layout(pixels.shape[0], pixels.shape[1],
                 1 if pixels.dim() == 2 else 3, quality, subsampling)
    return assemble(lay, entropy_encode(
        coefficients_reference(pixels, lay).numpy(), lay))
