"""Writes the committed JPEG 2000 fixtures, ``tests/torch_j2k/``, with
PIL's ``save`` and OpenJPEG 2.5's encoder through ctypes
(``torch_j2k_openjpeg.encode``, the ``libopenjp2`` PIL bundles).

    python tests/torch_j2k_fixtures.py

The card has no PIL, so ``chip_smoke.py --j2k`` reads these files and
holds the port's reader to PIL's digests in ``manifest.json``: per file
the sha256 of the JAX package's ``load_gray_image`` as uint8 and of PIL's
``convert("RGB")``, PIL's mode, the shape, and ``small`` where the Python
tier-1 twin reads it in the CPU tests (at most 64 x 64); for a file PIL
cannot read, PIL's error. The groups:

* ``k*``: PIL's ``save`` at its options: every mode it writes (L, LA,
  RGB, RGBA, I;16, CMYK), 5/3 and 9/7, ``mct`` 0 and 1, the five
  progression orders, tiles with odd ``tile_offset`` and ``offset``,
  ``num_resolutions`` 1 to 7, code-blocks 4 x 4 to 64 x 64 and
  non-square, precincts, ``quality_layers`` by rate and by dB,
  ``signed``, ``plt``, ``comment``, ``no_jp2``, sizes 1 x 1, 1 x N, N x 1
  and odd, and a grey 16,400 x 64 5/3 codestream (a line past 16,384
  samples);
* ``o*``: what ``save`` cannot reach, through OpenJPEG's encoder: each
  code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM) and all
  together, SOP / EPH, progression changes (POC), tile-parts, a region of
  interest (RGN), precisions 1, 4, 5, 12 and 16 (signed too), subsampled
  components (sYCC by PIL's rule for a codestream, and sRGB with only the
  first component subsampled), 12-bit RGB;
* ``e*``: edits of those files: scalar derived quantisation (QCD), packet
  headers moved into PPM and PPT markers (cut between each SOP segment
  and its EPH marker), a JP2 with ``colr`` sYCC over 2 x 2 subsampled
  chroma, with an ICC profile, with ``pclr`` + ``cmap`` over an index
  codestream, with colour spaces PIL cannot read;
* ``x*``: damaged codestreams (cut, a missing EOC, a broken marker, a SIZ
  of five components) and an HTJ2K (Part 15) codestream;
* ``f*``: the clip frame ``torch_jpeg/clip/f000.jpg`` (768 x 1024) as a
  9/7 JP2 (``mct``, three layers, RPCL, precincts) and as a 5/3 JP2 in
  256 x 256 tiles, both rate-limited; the manifest holds the face box and
  the JAX ``rcr_detect`` landmarks of the 9/7 file (``clip_detect``).
"""

from __future__ import annotations

import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
from torch_imageio_fixtures import pil_digests, small_rgb  # noqa: E402
from torch_j2k_openjpeg import (  # noqa: E402
    BYPASS, CLRSPC_GRAY, PTERM, RESET, SEGSYM, TERMALL, VSC, encode)
from torch_jpeg_fixtures import OUT as JPEG_DIR  # noqa: E402

OUT = os.path.join(HERE, "torch_j2k")
SEED = 0
CLIP_FRAME = "clip/f000.jpg"
CLIP_97, CLIP_53 = "f01_clip_97_rpcl.jp2", "f02_clip_53_tiles.jp2"
WIDE = "k40_wide_16400x64.j2k"
MODEL = os.path.join(os.path.dirname(HERE), "pretrained", "rcr22_lfpw5.bin")
STYLES = (("bypass", BYPASS), ("reset", RESET), ("termall", TERMALL),
          ("vsc", VSC), ("pterm", PTERM), ("segsym", SEGSYM),
          ("all", BYPASS | RESET | TERMALL | VSC | PTERM | SEGSYM))


def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def boxes(data: bytes, start=0, end=None):
    """[(type, offset, length)] of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    out = []
    while start < end:
        length, kind = struct.unpack(">I4s", data[start:start + 8])
        length = length or end - start
        out.append((kind, start, length))
        start += length
    return out


def with_header(data: bytes, subs) -> bytes:
    """A JP2 with its ``jp2h`` box's sub-boxes replaced by ``subs``."""
    return b"".join(box(b"jp2h", b"".join(subs)) if kind == b"jp2h"
                    else data[i:i + n] for kind, i, n in boxes(data))


def header_boxes(data: bytes) -> dict:
    _, i, n = next(b for b in boxes(data) if b[0] == b"jp2h")
    return {kind: data[j:j + m] for kind, j, m in boxes(data, i + 8, i + n)}


def colr(enumcs=None, icc=None) -> bytes:
    if icc is not None:
        return box(b"colr", b"\x02\x00\x00" + icc)
    return box(b"colr", b"\x01\x00\x00" + struct.pack(">I", enumcs))


def jp2_of(codestream: bytes, nc: int, h: int, w: int, bpc: int,
           subs=()) -> bytes:
    """A JP2 around a codestream: signature, ftyp, jp2h (ihdr and
    ``subs``), jp2c."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", ihdr + b"".join(subs)) + box(b"jp2c", codestream))


def codestream(data: bytes) -> bytes:
    if data[:2] == b"\xff\x4f":
        return data
    _, i, n = next(b for b in boxes(data) if b[0] == b"jp2c")
    return data[i + 8:i + n]


def markers(cs: bytes):
    """[(marker, offset, segment length)] of the main header and every
    tile-part header, and ('SOD', offset, tile-part end) for each body."""
    out, i = [(0xFF4F, 0, 0)], 2
    while i < len(cs):
        m = int.from_bytes(cs[i:i + 2], "big")
        if m == 0xFFD9:
            out.append((m, i, 0))
            break
        n = int.from_bytes(cs[i + 2:i + 4], "big")
        out.append((m, i, n))
        if m == 0xFF90:
            psot = int.from_bytes(cs[i + 6:i + 10], "big")
            end = i + psot if psot else len(cs) - 2
            j = i + 2 + n
            while int.from_bytes(cs[j:j + 2], "big") != 0xFF93:
                k = int.from_bytes(cs[j + 2:j + 4], "big")
                out.append((int.from_bytes(cs[j:j + 2], "big"), j, k))
                j += 2 + k
            out.append(("SOD", j, end))
            i = end
            continue
        i += 2 + n
    return out


def split_packets(body: bytes):
    """[(header, data)] of a tile-part body written with SOP and EPH: the
    header lies between the SOP segment and its EPH marker (EPH kept)."""
    out, i = [], 0
    while i < len(body):
        assert body[i:i + 2] == b"\xff\x91", body[i:i + 8].hex()
        j = body.index(b"\xff\x92", i + 6) + 2
        k = body.find(b"\xff\x91", j)
        k = len(body) if k < 0 else k
        out.append((body[i:i + 6], body[i + 6:j], body[j:k]))
        i = k
    return out


def moved_headers(cs: bytes, where: str) -> bytes:
    """The packet headers of a SOP / EPH codestream moved into PPM (main
    header) or PPT (each tile-part header) marker segments."""
    ms = markers(cs)
    first_sot = next(i for m, i, _ in ms if m == 0xFF90)
    main = cs[:first_sot]
    parts, ippm, zppt = [], [], {}
    for idx, (m, i, n) in enumerate(ms):
        if m != 0xFF90:
            continue
        tile = int.from_bytes(cs[i + 4:i + 6], "big")
        zppt[tile] = z = zppt.get(tile, -1) + 1
        sod = next(x for x in ms[idx + 1:] if x[0] == "SOD")
        header = cs[i + 12:sod[1]]
        packets = split_packets(cs[sod[1] + 2:sod[2]])
        heads = b"".join(h for _, h, _ in packets)
        body = b"".join(sop + d for sop, _, d in packets)
        if where == "ppt":
            header += b"\xff\x61" + struct.pack(">HB", 3 + len(heads), z) \
                + heads
        else:
            ippm.append(heads)
        sot = bytearray(cs[i:i + 12])
        sot[6:10] = struct.pack(">I", 12 + len(header) + 2 + len(body))
        parts.append(bytes(sot) + header + b"\xff\x93" + body)
    if where == "ppm":
        payload = b"".join(struct.pack(">I", len(h)) + h for h in ippm)
        assert len(payload) < 65000
        main += b"\xff\x60" + struct.pack(">HB", 3 + len(payload), 0) \
            + payload
    return main + b"".join(parts) + b"\xff\xd9"


def derived_quantisation(cs: bytes) -> bytes:
    """A 9/7 codestream's QCD rewritten as scalar derived: the LL band's
    exponent and mantissa only (the other bands' follow by the rule)."""
    m, i, n = next(x for x in markers(cs) if x[0] == 0xFF5C)
    sqcd = cs[i + 4]
    assert sqcd & 0x1F == 2
    seg = b"\xff\x5c" + struct.pack(">HB", 5, (sqcd & 0xE0) | 1) \
        + cs[i + 5:i + 7]
    return cs[:i] + seg + cs[i + 2 + n:]


def htj2k(cs: bytes) -> bytes:
    """A CAP marker (Part 15) after SIZ and the HT bit in COD's code-block
    style: a codestream that declares HTJ2K."""
    _, i, n = next(x for x in markers(cs) if x[0] == 0xFF51)
    cap = b"\xff\x50" + struct.pack(">HIH", 8, 1 << 14, 0)
    out = bytearray(cs[:i + 2 + n] + cap + cs[i + 2 + n:])
    _, j, _ = next(x for x in markers(bytes(out)) if x[0] == 0xFF52)
    out[j + 12] |= 0x40
    return bytes(out)


def pil_save(image: Image.Image, **options) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "JPEG2000", **options)
    return buf.getvalue()


def clip_rgb() -> np.ndarray:
    with Image.open(os.path.join(JPEG_DIR, CLIP_FRAME)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def planes_of(px: np.ndarray):
    return [px] if px.ndim == 2 else [px[..., i] for i in range(px.shape[2])]


def save_fixtures(tmp) -> dict:
    """PIL's ``save``: name -> bytes."""
    rgb = small_rgb()                                      # 47 x 61
    grey = rgb[..., 1].copy()
    rng = np.random.default_rng(SEED)
    alpha = rng.integers(0, 256, grey.shape, np.uint8)
    i16 = (grey.astype(np.uint16) * 257 + rng.integers(0, 200, grey.shape)
           ).astype(np.uint16)
    out = {
        "k01_rgb.jp2": pil_save(Image.fromarray(rgb)),
        "k02_rgb_mct.jp2": pil_save(Image.fromarray(rgb), mct=1),
        "k03_rgb_97.jp2": pil_save(Image.fromarray(rgb), irreversible=True),
        "k04_rgb_97_mct.jp2": pil_save(Image.fromarray(rgb),
                                       irreversible=True, mct=1),
        "k05_grey.j2k": pil_save(Image.fromarray(grey), no_jp2=True),
        "k06_la.jp2": pil_save(Image.fromarray(np.dstack([grey, alpha]),
                                               "LA")),
        "k07_rgba.jp2": pil_save(Image.fromarray(np.dstack([rgb, alpha]),
                                                 "RGBA")),
        "k08_i16.jp2": pil_save(Image.fromarray(i16, "I;16")),
        "k09_cmyk.jp2": pil_save(Image.fromarray(np.dstack([rgb, alpha]),
                                                 "CMYK")),
        "k10_grey_97.j2k": pil_save(Image.fromarray(grey), no_jp2=True,
                                    irreversible=True),
    }
    for k, order in enumerate(("RLCP", "RPCL", "PCRL", "CPRL")):
        out[f"k{11 + k}_{order.lower()}.jp2"] = pil_save(
            Image.fromarray(rgb), progression=order, mct=1,
            precinct_size=(32, 32), codeblock_size=(8, 8),
            quality_layers=[30, 10, 2])
    out["k15_tiles_offset.jp2"] = pil_save(
        Image.fromarray(rgb), tile_size=(16, 16), tile_offset=(3, 5),
        offset=(7, 9), mct=1)
    out["k16_tiles_offset_97.jp2"] = pil_save(
        Image.fromarray(rgb), tile_size=(17, 13), tile_offset=(1, 2),
        offset=(5, 3), irreversible=True, mct=1)
    grey33 = grey[:29, :33]
    for r in range(1, 7):
        out[f"k{16 + r}_res{r}.j2k"] = pil_save(
            Image.fromarray(grey33 if r < 6 else grey), no_jp2=True,
            num_resolutions=r)
    big = np.asarray(Image.fromarray(rgb).resize((64, 64)))
    out["k23_res7.jp2"] = pil_save(Image.fromarray(big[..., 0]),
                                   num_resolutions=7)
    for k, cb in enumerate(((4, 4), (8, 32), (32, 8), (16, 64))):
        out[f"k{24 + k}_cblk{cb[0]}x{cb[1]}.jp2"] = pil_save(
            Image.fromarray(rgb), codeblock_size=cb, mct=k & 1)
    out["k28_precincts.jp2"] = pil_save(
        Image.fromarray(rgb), precinct_size=(32, 16), codeblock_size=(16, 16))
    out["k29_rates.jp2"] = pil_save(Image.fromarray(rgb),
                                    quality_layers=[40, 20, 5], mct=1)
    out["k30_db.jp2"] = pil_save(Image.fromarray(rgb), quality_mode="dB",
                                 quality_layers=[25, 35, 45],
                                 irreversible=True)
    out["k31_signed.jp2"] = pil_save(Image.fromarray(rgb), signed=True)
    out["k32_plt.jp2"] = pil_save(Image.fromarray(rgb), plt=True,
                                  tile_size=(32, 32))
    out["k33_comment.j2k"] = pil_save(Image.fromarray(grey), no_jp2=True,
                                      comment="a JPEG 2000 fixture")
    out["k34_rgb_nojp2.j2k"] = pil_save(Image.fromarray(rgb), no_jp2=True)
    out["k35_1x1.jp2"] = pil_save(Image.fromarray(rgb[:1, :1]))
    out["k36_1x17.jp2"] = pil_save(Image.fromarray(rgb[:1, :17]))
    out["k37_23x1.jp2"] = pil_save(Image.fromarray(rgb[:23, :1]),
                                   irreversible=True)
    out["k38_13x7_97.jp2"] = pil_save(Image.fromarray(rgb[:7, :13]),
                                      irreversible=True)
    out["k39_odd_tiles_97.j2k"] = pil_save(
        Image.fromarray(grey[:31, :45]), no_jp2=True, irreversible=True,
        tile_size=(8, 7), tile_offset=(1, 1), offset=(3, 3))
    out[WIDE] = pil_save(Image.fromarray(wide_grey()), no_jp2=True,
                         quality_layers=[40])
    return out


def wide_grey() -> np.ndarray:
    """A grey frame wider than 16,384 px (D1 once refused lines past that):
    64 rows of the clip frame's grey from row 400, repeated across 16,400
    columns; 64 rows because PIL's six resolutions need 32."""
    grey = clip_rgb()[400:464, :, 1]
    return np.ascontiguousarray(np.tile(grey, (1, -(-16400 // grey.shape[1])))
                                [:, :16400])


def openjpeg_fixtures(tmp) -> dict:
    """Through OpenJPEG's encoder (ctypes): name -> bytes."""
    rgb = small_rgb()
    grey = rgb[..., 1].copy()
    rng = np.random.default_rng(SEED + 1)
    path = os.path.join(tmp, "o.j2k")
    out = {}
    for k, (name, style) in enumerate(STYLES):
        out[f"o{k + 1:02d}_style_{name}.j2k"] = encode(
            planes_of(rgb[:32, :40]), path, mode=style, mct=True,
            codeblock=(16, 16), rates=(8.0, 3.0, 1.0))
    out["o08_style_all_97.j2k"] = encode(
        planes_of(grey[:40, :48]), path, mode=STYLES[-1][1],
        irreversible=True, codeblock=(8, 16), rates=(6.0, 1.0))
    out["o09_sop_eph.j2k"] = encode(planes_of(rgb), path, sop=True, eph=True,
                                    rates=(10.0, 1.0), codeblock=(16, 16))
    out["o10_poc.j2k"] = encode(
        planes_of(rgb), path, rates=(10.0, 3.0, 1.0), codeblock=(16, 16),
        pocs=((0, 0, 2, 3, 3, "RLCP"), (0, 0, 3, 6, 3, "CPRL")),
        precincts=((32, 32),) * 3)
    out["o11_tileparts.j2k"] = encode(
        planes_of(rgb), path, tiles=(0, 0, 32, 24), tile_parts="R",
        rates=(10.0, 1.0), mct=True)
    out["o12_roi.j2k"] = encode(planes_of(rgb), path, roi=(0, 5),
                                mct=True)
    out["o13_roi_97.j2k"] = encode(planes_of(grey), path, roi=(0, 7),
                                   irreversible=True)
    for prec in (1, 4, 5, 12, 16):
        v = rng.integers(0, 1 << prec, (23, 29))
        out[f"o14_prec{prec}.j2k"] = encode(
            [v], path, prec=prec, color=CLRSPC_GRAY)
    v = rng.integers(-2048, 2048, (23, 29))
    out["o15_prec12_signed.j2k"] = encode([v], path, prec=12, signed=True)
    v = rng.integers(-8, 8, (23, 29))
    out["o16_prec4_signed.j2k"] = encode([v], path, prec=4, signed=True)
    v = rng.integers(0, 4096, (3, 21, 27))
    out["o17_rgb_prec12.j2k"] = encode(list(v), path, prec=12, mct=True)
    v = rng.integers(0, 1024, (3, 21, 27))
    out["o18_rgb_prec10_97.j2k"] = encode(list(v), path, prec=10,
                                          irreversible=True, mct=True)
    sub = ((1, 1), (2, 2), (2, 2))
    for name, w, h in (("o19_ycc420.j2k", 40, 30), ("o20_ycc420_odd.j2k",
                                                      37, 29)):
        y = rgb[:h, :w, 1]
        cb = rgb[:h:2, :w:2, 2].astype(int) // 2 + 64
        cr = rgb[:h:2, :w:2, 0].astype(int) // 2 + 64
        out[name] = encode([y, cb, cr], path, subsampling=sub, size=(w, h))
    y = rgb[:30, :41, 1]
    cb = rgb[:30, :41:2, 2]
    cr = rgb[:30, :41:2, 0]
    out["o21_ycc422_97.j2k"] = encode(
        [y, cb, cr], path, subsampling=((1, 1), (2, 1), (2, 1)),
        size=(41, 30), irreversible=True)
    out["o22_sub_first.j2k"] = encode(
        [rgb[:30:2, :40:2, 0], rgb[:30, :40, 1], rgb[:30, :40, 2]], path,
        subsampling=((2, 2), (1, 1), (1, 1)), size=(40, 30))
    out["o23_rgba_sub_alpha.j2k"] = encode(
        [rgb[:30, :40, 0], rgb[:30, :40, 1], rgb[:30, :40, 2],
         rgb[:30:2, :40:2, 0]], path,
        subsampling=((1, 1),) * 3 + ((2, 2),), size=(40, 30))
    out["o24_subsampled_offset.j2k"] = encode(
        [rgb[:29, :37, 1], rgb[1:29:2, 1:37:2, 2], rgb[1:29:2, 1:37:2, 0]],
        path, subsampling=sub, size=(37, 29), offset=(3, 5))
    return out


def edited_fixtures(made: dict, tmp) -> dict:
    """Edits of written files: name -> bytes."""
    rgb = small_rgb()
    out = {}
    cs97 = codestream(made["k10_grey_97.j2k"])
    out["e01_derived_quant.j2k"] = derived_quantisation(cs97)
    sop = made["o09_sop_eph.j2k"]
    out["e02_ppm.j2k"] = moved_headers(sop, "ppm")
    out["e03_ppt.j2k"] = moved_headers(sop, "ppt")
    tiled = encode(planes_of(rgb), os.path.join(tmp, "t.j2k"), sop=True,
                   eph=True, tiles=(0, 0, 32, 32), tile_parts="R",
                   rates=(6.0, 1.0))
    out["e04_ppm_tiles.j2k"] = moved_headers(tiled, "ppm")
    out["e05_ppt_tiles.j2k"] = moved_headers(tiled, "ppt")
    ycc = made["o19_ycc420.j2k"]
    out["e06_sycc.jp2"] = jp2_of(ycc, 3, 30, 40, 7, [colr(18)])
    rgb3 = made["k01_rgb.jp2"]
    ihdr = header_boxes(rgb3)[b"ihdr"]
    out["e07_icc.jp2"] = with_header(rgb3, [ihdr, colr(icc=b"\0" * 64)])
    out["e08_sycc_444.jp2"] = with_header(rgb3, [ihdr, colr(18)])
    out["e09_colr_unknown.jp2"] = with_header(rgb3, [ihdr, colr(20)])
    out["e10_colr_grey_rgb.jp2"] = with_header(rgb3, [ihdr, colr(17)])
    out["e11_colr_eycc.jp2"] = with_header(rgb3, [ihdr, colr(24)])
    # pclr + cmap over a 1-component index codestream
    idx = (rgb[..., 1] // 32).astype(np.uint8)
    cs = codestream(pil_save(Image.fromarray(idx), no_jp2=True))
    colours = [(i * 30, 255 - i * 20, (i * 77) % 256) for i in range(8)]
    colours[6] = colours[2]                    # PIL's palette drops repeats
    pclr = box(b"pclr", struct.pack(">HB", 8, 3) + b"\x07\x07\x07"
               + b"".join(bytes(c) for c in colours))
    cmap = box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                 for i in range(3)))
    h, w = idx.shape
    out["e12_pclr.jp2"] = jp2_of(cs, 1, h, w, 7, [colr(16), pclr, cmap])
    out["e13_pclr_grey.jp2"] = jp2_of(cs, 1, h, w, 7, [colr(17), pclr, cmap])
    la = codestream(made["k06_la.jp2"])
    out["e14_pclr_la.jp2"] = jp2_of(la, 2, 47, 61, 7, [colr(16), pclr, cmap])
    out["e15_res_box.jp2"] = with_header(rgb3, [
        ihdr, colr(16), box(b"res ", box(b"resc", struct.pack(
            ">HHHHBB", 72, 1, 72, 1, 0, 0)))])
    return out


def damaged_fixtures(made: dict) -> dict:
    good = made["o09_sop_eph.j2k"]
    plain = made["k05_grey.j2k"]
    out = {
        "x01_cut_body.j2k": plain[:len(plain) * 2 // 3],
        "x02_no_eoc.j2k": plain[:-2],
        "x03_cut_header.j2k": plain[:60],
        "x04_htj2k.j2k": htj2k(plain),
    }
    siz = bytearray(plain)
    _, i, n = next(x for x in markers(plain) if x[0] == 0xFF51)
    # five components: the SIZ's component count and one more component
    comp = siz[i + 40:i + 43]
    siz = siz[:i + 2] + struct.pack(">H", n + 3 * 4) + siz[i + 4:i + 38] \
        + struct.pack(">H", 5) + bytes(comp) * 5 + siz[i + 2 + n:]
    out["x05_five_components.j2k"] = bytes(siz)
    broken = bytearray(good)
    _, j, _ = next(x for x in markers(good) if x[0] == 0xFF52)
    broken[j + 5] = 9                        # a progression order past CPRL
    out["x06_bad_progression.j2k"] = bytes(broken)
    lost = bytearray(good)
    k = lost.index(b"\xff\x91", lost.index(b"\xff\x93")) + 40
    k = lost.index(b"\xff\x91", k)
    lost[k + 1] = 0x90                       # a lost SOP marker
    out["x07_lost_sop.j2k"] = bytes(lost)
    # precincts of one sample below resolution 0 (PIL's precinct_size 16
    # halved at each lower resolution): OpenJPEG cannot read them back
    out["x08_precinct_one.jp2"] = pil_save(
        Image.fromarray(small_rgb()), precinct_size=(16, 16))
    return out


def clip_fixtures() -> dict:
    rgb = clip_rgb()
    return {
        CLIP_97: pil_save(Image.fromarray(rgb), irreversible=True, mct=1,
                          quality_layers=[80, 40, 20], progression="RPCL",
                          precinct_size=(64, 64)),
        CLIP_53: pil_save(Image.fromarray(rgb), mct=1, tile_size=(256, 256),
                          quality_layers=[24]),
    }


def clip_detect(path: str) -> dict:
    """The JAX ``rcr_detect``'s face box (its Haar detector) and landmarks
    on ``path``."""
    from superviseddescent_tpu.models import DetectionModel
    from superviseddescent_tpu.models.facedetect import HaarCascadeDetector
    from superviseddescent_tpu.ops.patches import load_gray_image
    from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
    image = load_gray_image(path)
    det = HaarCascadeDetector(str(STOCK_FRONTAL_ALT2), scale_factor=1.2,
                              min_neighbors=2, min_size=(50, 50))
    boxes_found = det.detect(np.asarray(image))
    face = [float(v) for v in boxes_found[0]]
    model = DetectionModel.load(MODEL)
    lms = model.detect(image, tuple(face))
    return dict(file=os.path.basename(path), facebox=face,
                landmarks=np.asarray(lms.coordinates, np.float64).tolist())


def check_layout(tmp) -> bool:
    """The ctypes layout of ``opj_cparameters_t`` holds: a write at PIL's
    default settings through ``encode`` equals PIL's ``save`` byte for
    byte (RGB JP2 and grey codestream)."""
    rgb = small_rgb()
    path = os.path.join(tmp, "layout")
    return (encode(planes_of(rgb), path, jp2=True)
            == pil_save(Image.fromarray(rgb))
            and encode([rgb[..., 1]], path, color=CLRSPC_GRAY)
            == pil_save(Image.fromarray(rgb[..., 1].copy()), no_jp2=True))


def main():
    import tempfile
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        if not check_layout(tmp):
            raise SystemExit("the ctypes layout of opj_cparameters_t does "
                             "not write PIL's bytes")
        made = save_fixtures(tmp)
        made.update(openjpeg_fixtures(tmp))
        made.update(edited_fixtures(made, tmp))
        made.update(damaged_fixtures(made))
        made.update(clip_fixtures())
    files = {}
    for name, data in sorted(made.items()):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        entry = pil_digests(path)
        if "shape" in entry:
            h, w = entry["shape"][:2]
            entry["small"] = h <= 64 and w <= 64
        entry["bytes"] = len(data)
        files[name] = entry
    manifest = dict(files=files, clip_detect=clip_detect(
        os.path.join(OUT, CLIP_97)))
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    total = sum(e["bytes"] for e in files.values())
    print(f"{len(files)} files, {total} bytes")


if __name__ == "__main__":
    main()
