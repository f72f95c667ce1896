"""Writes the committed JPEG fixtures, ``tests/torch_jpeg/``, with PIL.

    python tests/torch_jpeg_fixtures.py

The card has no PIL, so ``chip_smoke.py --jpeg`` reads these files and
holds the port's decoder against PIL's digests in ``manifest.json``: the
sha256 of the JAX package's ``load_gray_image`` as uint8 (PIL, then
OpenCV's grey) and of PIL's ``convert("RGB")``, per file.

* stills (baseline, one interleaved scan): ``.synth120`` images, every size class at least once, as grey
  (1 component), YCbCr 4:4:4, 4:2:2 and 4:2:0 (PIL's ``subsampling`` 0, 1,
  2) at qualities 50, 75 and 95; one 4:2:0 and one grey still with restart
  markers, one with optimised Huffman tables, one of 301 x 451 (no
  multiple of 16). A colour still is a seeded tint of the grey image
  (``tint``): gains, offsets and ramps per channel, so the chroma varies.
* clip: ``CLIP_FRAMES`` 4:2:0 frames of 1024 rows x 768 columns at
  quality 75 in which ``.synth120`` image 3 drifts by up to 3 px a frame
  and axis from (260, 40), as ``chip_smoke.py``'s app clip; the offsets
  are in the manifest.

* progressive stills (SOF2, PIL's ``progressive=True``: libjpeg's simple
  progression, 10 scans for YCbCr, 6 for grey, 18 for CMYK, optimised
  tables between them): grey, 4:4:4, 4:2:2 and 4:2:0 at qualities 50, 75
  and 95, one with restart markers, one optimised; ``p00``, ``p02``,
  ``p03`` and ``p05`` hold the pixels of ``s00``, ``s02``, ``s03`` and
  ``s05``, so their coefficients equal those stills' (``p03`` is a whole
  686 x 1024 image).
* four components: PIL's Adobe CMYK (``convert("CMYK")``) and the same
  bytes with the Adobe transform set to 2 (YCCK).
* 4:1:1 and 4:4:0, which PIL cannot write: a PIL 4:2:0 file whose SOF
  says luma 4x1 (width a multiple of 32, height of 16), and a 4:2:2 file
  whose SOF says luma 1x2 (both multiples of 16): the same blocks per MCU
  and MCUs, so the same entropy-coded data, placed otherwise.
* multi-scan sequential stills and other sampling factors: a PIL file's
  coefficients (``io/jpeg.entropy_decode``) written again by
  ``write_sequential``, a small coefficient-level encoder with the
  standard Huffman tables that PIL's unoptimised files carry: one scan per
  component; luma alone then both chroma interleaved, with restart
  markers; luma 2x2 over Cb 1x2 and Cr 2x1 (three filters in one image);
  luma 3x2 over 1x1 chroma (replication by 3 and 2).
* clip_progressive: the clip's frames again with ``progressive=True``.

* the coded kinds PIL does not write (``write_coded_kinds``; ``python
  tests/torch_jpeg_fixtures.py --coded-kinds`` writes only these into the
  manifest), from ``.synth120`` crops of at most 64 x 64:
  arithmetic-coded SOF9 (grey, 4:4:4, 4:2:2, 4:2:0 at q 50 / 75 / 95, one
  with restarts, one with DAC conditioning other than T.81's defaults, one
  with its DAC segment dropped) and SOF10 (libjpeg's simple progression),
  written by libjpeg through ``tests/torch_jpeg_writer.c`` (gcc, the
  system's ``-ljpeg``: libjpeg-turbo 2.1.5 here); progressive streams whose
  scan script stops refining early, Huffman SOF2 and arithmetic SOF10, the
  first coefficients never sent or sent and not refined to bit 0, which
  libjpeg block-smooths (``s``-less ``b0*``); lossless SOF3 (``l0*``/``l1*``)
  from ``tests/torch_jpeg_coders.write_lossless``: predictors 1-7, point
  transforms 0 and 2, restarts, grey, RGB under ids 1-2-3, 'R'-'G'-'B' and
  Adobe, subsampled chroma interleaved and in scans of their own, CMYK.
  ``refused``: files PIL cannot read, with libjpeg-turbo's own message
  (PIL's bundled library through the same helper): SOF11, a lossless
  stream with no DHT, a lossless JFIF (YCbCr) frame. ``timing``: frame 0
  of the clip as SOF9 4:2:0 q75, as SOF10 and as a grey SOF3, for the
  card's times (PIL's digests, outside ``stills``: the Python twins take
  seconds on a frame of that size).

The reference is always PIL's decode of the bytes written: a relabelled
or re-encoded image's scrambled content is fine. The same seed gives the
same bytes for the same PIL and libjpeg-turbo; ``tests/test_torch_jpeg.py``
checks that the files still match the manifest.
"""

import glob
import hashlib
import io
import json
import os
import shutil
import sys

import numpy as np
import PIL
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT = os.path.join(HERE, "torch_jpeg")
SYNTH = os.path.join(REPO, ".synth120")
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
# name: (.synth120 image, kind, quality, extra save options, crop (h, w))
STILLS = {
    "s00_grey_q75": (1, "grey", 75, {}, None),
    "s01_444_q95": (2, "4:4:4", 95, {}, None),
    "s02_422_q50": (0, "4:2:2", 50, {}, None),
    "s03_420_q75": (4, "4:2:0", 75, {}, None),
    "s04_420_q95_restart": (3, "4:2:0", 95, {"restart_marker_rows": 1},
                            None),
    "s05_420_q50_optimized": (6, "4:2:0", 50, {"optimize": True}, None),
    "s06_422_q75_odd": (8, "4:2:2", 75, {}, (451, 301)),
    "s07_grey_q95_restart": (7, "grey", 95, {"restart_marker_blocks": 7},
                             None),
    "s08_444_q50": (9, "4:4:4", 50, {}, None),
    "s09_grey_q50": (5, "grey", 50, {}, None),
}
# progressive stills: name -> the baseline still whose pixels it holds, or
# (.synth120 image, kind, quality, extra save options, crop (h, w))
PROGRESSIVE = {
    "p00_grey_q75_prog": "s00_grey_q75",
    "p01_444_q95_prog": (2, "4:4:4", 95, {}, (256, 320)),
    "p02_422_q50_prog": "s02_422_q50",
    "p03_420_q75_prog": "s03_420_q75",
    "p04_420_q95_restart_prog": (3, "4:2:0", 95, {"restart_marker_rows": 1},
                                 (304, 400)),
    "p05_420_q50_optimized_prog": "s05_420_q50_optimized",
}
# four components: (.synth120 image, quality, crop, Adobe transform)
FOUR = {"c00_cmyk_q75": (1, 75, None, 0),
        "c01_ycck_q75": (1, 75, None, 2)}
# relabelled sampling: (.synth120 image, PIL's kind, quality, crop, the
# luma's new sampling byte)
RELABEL = {"r00_411_q75": (9, "4:2:0", 75, (320, 256), 0x41),
           "r01_440_q75": (10, "4:2:2", 75, (320, 240), 0x12)}
# re-encoded: (.synth120 image, crop, luma / Cb / Cr sampling, scans as
# component lists, restart interval)
REENCODED = {
    "m00_420_3scans": (11, (240, 320), ((2, 2), (1, 1), (1, 1)),
                       [[0], [1], [2]], 0),
    "m01_422_2scans_restart": (12, (200, 264), ((2, 1), (1, 1), (1, 1)),
                               [[0], [1, 2]], 5),
    "x00_mixed_2x2_1x2_2x1": (13, (232, 304), ((2, 2), (1, 2), (2, 1)),
                              [[0, 1, 2]], 0),
    "x01_3x2_box": (14, (216, 312), ((3, 2), (1, 1), (1, 1)),
                    [[0, 1, 2]], 0),
}
CLIP_FRAMES = 16
CLIP_IMAGE = 3
CLIP_ORIGIN = (260, 40)        # row and column offset of the image
CLIP_SHAPE = (1024, 768)       # rows, columns
CLIP_STEP_PX = 3
CLIP_QUALITY = 75
SEED = 0


def tint(grey: np.ndarray, seed: int) -> np.ndarray:
    """A colour version of a grey image: per channel a gain, an offset and
    a ramp across the image, from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w = grey.shape
    yy, xx = np.mgrid[0:h, 0:w]
    gain = rng.uniform(0.75, 1.0, 3)
    offset = rng.uniform(0.0, 40.0, 3)
    ramp = rng.uniform(-30.0, 30.0, (3, 2))
    rgb = (grey[..., None] * gain + offset + ramp[:, 0] * (xx[..., None] / w)
           + ramp[:, 1] * (yy[..., None] / h))
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def encode(pixels: np.ndarray, kind: str, quality: int, **options) -> bytes:
    buf = io.BytesIO()
    if kind == "grey":
        Image.fromarray(pixels).save(buf, "JPEG", quality=quality, **options)
    else:
        Image.fromarray(pixels).save(buf, "JPEG", quality=quality,
                                     subsampling=SUBSAMPLING[kind], **options)
    return buf.getvalue()


def pil_digests(path) -> dict:
    """PIL's pixels of a file: the JAX package's grey and convert('RGB')."""
    from superviseddescent_tpu.ops.patches import load_gray_image
    grey = load_gray_image(path).astype(np.uint8)
    rgb = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return dict(shape=list(grey.shape),
                grey_sha256=hashlib.sha256(grey.tobytes()).hexdigest(),
                rgb_sha256=hashlib.sha256(rgb.tobytes()).hexdigest())


def clip_offsets(n: int = CLIP_FRAMES, seed: int = SEED) -> np.ndarray:
    """(n, 2) row / column offsets drifting by up to CLIP_STEP_PX."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-CLIP_STEP_PX, CLIP_STEP_PX + 1, size=(n, 2))
    steps[0] = 0
    return np.maximum(np.asarray(CLIP_ORIGIN) + np.cumsum(steps, 0), 0)


def synth(index: int) -> np.ndarray:
    files = sorted(glob.glob(os.path.join(SYNTH, "*.png")))
    return np.asarray(Image.open(files[index]).convert("L"), np.uint8)


class _BitWriter:
    """MSB-first entropy-coded bytes with 0xFF stuffed."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        """Pad the last byte with 1 bits."""
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int):
    """JPEG's size category of ``v`` and its ``size`` appended bits."""
    size = abs(v).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def write_sequential(width, height, sampling, qtables, coef, scans,
                     restart=0, tq=(0, 1, 1), dqt_before=None) -> bytes:
    """A sequential (SOF0) JFIF stream of the coefficients ``coef``
    ((blocks, 64) int16, natural order, in ``io/jpeg``'s layout for this
    geometry) with the standard Huffman tables (luma 0, chroma 1).
    ``sampling``: (h, v) per component; ``scans``: component lists, one a
    scan; ``qtables``: {table: (64,) natural order}; ``dqt_before``:
    {scan index: {table: (64,)}} written (redefined) before that scan."""
    from superviseddescent_tpu_torch.io import jpeg
    frame = jpeg.JpegFrame(width, height, [
        jpeg.Component(i + 1, h, v, tq[i]) for i, (h, v) in
        enumerate(sampling)])
    jpeg._layout(frame)
    codes = {key: {sym: (code, length) for length, code, sym in
                   jpeg.huffman_codes(bytes.fromhex(bits),
                                      bytes.fromhex(vals))}
             for key, (bits, vals) in jpeg.STD_HUFFMAN.items()}

    def dqt(tables):
        return _segment(jpeg.DQT, b"".join(
            bytes([t]) + bytes(np.asarray(q)[jpeg.ZIGZAG].astype(np.uint8))
            for t, q in sorted(tables.items())))

    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += dqt(qtables)
    out += _segment(0xC0, bytes([8]) + height.to_bytes(2, "big")
                    + width.to_bytes(2, "big") + bytes([len(sampling)])
                    + b"".join(bytes([i + 1, h << 4 | v, tq[i]])
                               for i, (h, v) in enumerate(sampling)))
    out += _segment(jpeg.DHT, b"".join(
        bytes([tc << 4 | th]) + bytes.fromhex(bits) + bytes.fromhex(vals)
        for (tc, th), (bits, vals) in sorted(jpeg.STD_HUFFMAN.items())))
    if restart:
        out += _segment(jpeg.DRI, restart.to_bytes(2, "big"))
    zz = jpeg.ZIGZAG.tolist()
    for si, comps in enumerate(scans):
        if dqt_before and si in dqt_before:
            out += dqt(dqt_before[si])
        table = [min(ci, 1) for ci in comps]
        out += _segment(jpeg.SOS, bytes([len(comps)]) + b"".join(
            bytes([ci + 1, t << 4 | t]) for ci, t in zip(comps, table))
            + bytes([0, 63, 0]))
        scan = jpeg.Scan(comps, 0, 63, 0, 0, [None] * len(comps),
                         [None] * len(comps))
        mcux, mcuy, units = jpeg._units(frame, scan, {})
        bw, pred, n_mcu = _BitWriter(), [0] * len(comps), mcux * mcuy
        for mcu in range(n_mcu):
            if restart and mcu and mcu % restart == 0:
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + (mcu // restart - 1) % 8])
                pred = [0] * len(comps)
            my, mx = divmod(mcu, mcux)
            for k, _, _, base, v, h, nbx in units:
                block = coef[base + my * v * nbx + mx * h]
                dc, ac = codes[(0, table[k])], codes[(1, table[k])]
                size, bits = _magnitude(int(block[0]) - pred[k])
                pred[k] = int(block[0])
                bw.put(*dc[size])
                bw.put(bits, size)
                run = 0
                for i in range(1, 64):
                    val = int(block[zz[i]])
                    if not val:
                        run += 1
                        continue
                    while run > 15:
                        bw.put(*ac[0xF0])
                        run -= 16
                    size, bits = _magnitude(val)
                    bw.put(*ac[run << 4 | size])
                    bw.put(bits, size)
                    run = 0
                if run:
                    bw.put(*ac[0x00])
        bw.flush()
        out += bw.out
    return bytes(out + b"\xff\xd9")


def reencode(pixels: np.ndarray, sampling, scans, restart=0,
             quality=75) -> bytes:
    """A PIL 4:4:4 encoding of ``pixels``, its coefficients decoded and
    written again by ``write_sequential`` with other sampling factors and
    scans: each component's blocks are the top-left ones of the PIL
    component's grid (the content is scrambled where the sampling
    differs; PIL's decode of the result is the reference)."""
    from superviseddescent_tpu_torch.io import jpeg
    src = jpeg.parse_jpeg(encode(pixels, "4:4:4", quality))
    src_coef = jpeg.entropy_decode(src)
    h, w = pixels.shape[:2]
    frame = jpeg.JpegFrame(w, h, [jpeg.Component(i + 1, sh, sv, 0)
                                  for i, (sh, sv) in enumerate(sampling)])
    jpeg._layout(frame)
    coef = np.zeros((frame.blocks, 64), np.int16)
    for c, sc in zip(frame.components, src.components):
        grid = src_coef[sc.offset:sc.offset + sc.nbx * sc.nby].reshape(
            sc.nby, sc.nbx, 64)
        ys = np.arange(c.nby) % sc.nby
        xs = np.arange(c.nbx) % sc.nbx
        coef[c.offset:c.offset + c.nbx * c.nby] = grid[ys][:, xs].reshape(
            -1, 64)
    qtables = {c.tq: c.quant for c in src.components}
    return write_sequential(w, h, sampling, qtables, coef, scans, restart,
                            tq=tuple(c.tq for c in src.components))


def _cropped(index, crop):
    grey = synth(index)
    return grey if crop is None else grey[:crop[0], :crop[1]]


def write_fixtures(out: str = OUT) -> dict:
    os.makedirs(out, exist_ok=True)
    manifest = dict(stills={}, clip={})
    for k, (name, (index, kind, quality, options, crop)) in enumerate(
            STILLS.items()):
        grey = synth(index)
        if crop is not None:
            grey = grey[:crop[0], :crop[1]]
        pixels = grey if kind == "grey" else tint(grey, SEED + k)
        path = os.path.join(out, name + ".jpg")
        with open(path, "wb") as f:
            f.write(encode(pixels, kind, quality, **options))
        manifest["stills"][name + ".jpg"] = dict(
            source=f"synth_{index:04d}", kind=kind, quality=quality,
            options=options, **pil_digests(path))
    _write_new_stills(out, manifest)
    offsets = clip_offsets()
    frames, prog_frames = [], []
    for k in range(len(offsets)):
        frame = clip_frame(k)
        name = f"clip/f{k:03d}.jpg"
        os.makedirs(os.path.join(out, "clip"), exist_ok=True)
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(encode(frame, "4:2:0", CLIP_QUALITY))
        frames.append(dict(name=name, **pil_digests(path)))
        prog = f"clip_progressive/f{k:03d}.jpg"
        os.makedirs(os.path.join(out, "clip_progressive"), exist_ok=True)
        path = os.path.join(out, prog)
        with open(path, "wb") as f:
            f.write(encode(frame, "4:2:0", CLIP_QUALITY, progressive=True))
        prog_frames.append(dict(name=prog, **pil_digests(path)))
    manifest["clip"] = dict(source=f"synth_{CLIP_IMAGE:04d}",
                            kind="4:2:0", quality=CLIP_QUALITY,
                            offsets=offsets.tolist(), frames=frames)
    manifest["clip_progressive"] = dict(
        source=f"synth_{CLIP_IMAGE:04d}", kind="4:2:0",
        quality=CLIP_QUALITY, options={"progressive": True},
        offsets=offsets.tolist(), frames=prog_frames)
    write_coded_kinds(out, manifest)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def _still_pixels(name):
    """A baseline still's pixels, as ``write_fixtures`` encodes them."""
    k = list(STILLS).index(name)
    index, kind, _, _, crop = STILLS[name]
    grey = _cropped(index, crop)
    return grey if kind == "grey" else tint(grey, SEED + k)


def _write_new_stills(out, manifest):
    """The progressive, four-component, relabelled and re-encoded stills
    (appended after the baseline ones, whose bytes they leave as they
    are)."""
    def put(name, data, **info):
        path = os.path.join(out, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        manifest["stills"][name + ".jpg"] = dict(info, **pil_digests(path))

    for k, (name, spec) in enumerate(PROGRESSIVE.items()):
        same = {}
        if isinstance(spec, str):
            index, kind, quality, options, _ = STILLS[spec]
            pixels = _still_pixels(spec)
            same = {"same_pixels_as": spec + ".jpg"}
        else:
            index, kind, quality, options, crop = spec
            grey = _cropped(index, crop)
            pixels = grey if kind == "grey" else tint(grey, SEED + 200 + k)
        put(name, encode(pixels, kind, quality, progressive=True,
                         **options),
            source=f"synth_{index:04d}", kind=kind, quality=quality,
            options=dict(options, progressive=True), **same)
    for k, (name, (index, quality, crop, transform)) in enumerate(
            FOUR.items()):
        buf = io.BytesIO()
        Image.fromarray(tint(_cropped(index, crop), SEED + 300)).convert(
            "CMYK").save(buf, "JPEG", quality=quality)
        data = bytearray(buf.getvalue())
        app14 = data.index(b"\xff\xee\x00\x0eAdobe")
        data[app14 + 4 + 11] = transform
        put(name, bytes(data), source=f"synth_{index:04d}",
            kind="ycck" if transform else "cmyk", quality=quality,
            options={"adobe_transform": transform})
    for k, (name, (index, kind, quality, crop, luma)) in enumerate(
            RELABEL.items()):
        data = bytearray(encode(tint(_cropped(index, crop), SEED + 400 + k),
                                kind, quality))
        data[data.index(b"\xff\xc0") + 11] = luma
        put(name, bytes(data), source=f"synth_{index:04d}",
            kind={0x41: "4:1:1", 0x12: "4:4:0"}[luma], quality=quality,
            options={"relabelled_from": kind})
    for k, (name, (index, crop, sampling, scans, restart)) in enumerate(
            REENCODED.items()):
        pixels = tint(_cropped(index, crop), SEED + 500 + k)
        put(name, reencode(pixels, sampling, scans, restart),
            source=f"synth_{index:04d}",
            kind=" ".join(f"{h}x{v}" for h, v in sampling), quality=75,
            options={"scans": scans, "restart_interval": restart})


# ------------------------------------------------------------ coded kinds
# arithmetic SOF9 / SOF10: name -> (.synth120 image, kind, quality, crop (h,
# w), libjpeg options)
SAMPLING = {"grey": None, "4:4:4": [(1, 1)] * 3,
            "4:2:2": [(2, 1), (1, 1), (1, 1)],
            "4:2:0": [(2, 2), (1, 1), (1, 1)]}
ARITHMETIC = {
    **{f"a{4 * k + j:02d}_{kind.replace(':', '')}_q{q}":
       (20 + 4 * k + j, kind, q, (61, 53), {})
       for k, q in enumerate((50, 75, 95))
       for j, kind in enumerate(("grey", "4:4:4", "4:2:2", "4:2:0"))},
    "a12_420_q75_restart": (32, "4:2:0", 75, (64, 64), {"restart": 2}),
    "a13_444_q75_dac": (33, "4:4:4", 75, (48, 64), {"dac": {
        ("dc", 0): (2, 6), ("dc", 1): (1, 4), ("ac", 0): 12, ("ac", 1): 2}}),
    "a14_420_q75_nodac": (34, "4:2:0", 75, (64, 40), {"strip_dac": True}),
    "a15_420_q75_prog": (35, "4:2:0", 75, (64, 64), {"progressive": True}),
    "a16_grey_q90_prog_restart": (36, "grey", 90, (57, 64),
                                  {"progressive": True, "restart": 3}),
    # a whole image (a face for rcr_detect -f on the card)
    "a17_420_q75_prog_still": (2, "4:2:0", 75, None, {"progressive": True}),
}
# progressive scan scripts that stop refining early: the first ten
# coefficients never sent (DC only, then 10-63), or sent and left at Al 1-2


def _never(n):
    return ([(list(range(n)), 0, 0, 0, 1)]
            + [([c], 10, 63, 0, 0) for c in range(n)]
            + [(list(range(n)), 0, 0, 1, 0)])


def _unrefined(n):
    return ([(list(range(n)), 0, 0, 0, 0)]
            + [([c], 1, 5, 0, 2) for c in range(n)]
            + [([c], 6, 63, 0, 1) for c in range(n)]
            + [([c], 6, 63, 1, 0) for c in range(n)])


# name -> (.synth120 image, kind, crop, arithmetic, script)
SMOOTHED = {
    "b00_420_q75_arith_never": (40, "4:2:0", (64, 64), True, _never),
    "b01_420_q75_arith_unrefined": (41, "4:2:0", (64, 56), True, _unrefined),
    "b02_420_q75_huffman_never": (42, "4:2:0", (56, 64), False, _never),
    "b03_444_q75_huffman_unrefined": (43, "4:4:4", (40, 48), False,
                                      _unrefined),
    # two blocks wide: libjpeg-turbo 2.1.5 and 3.x smooth it differently
    "b04_grey_q75_huffman_unrefined_16": (44, "grey", (48, 16), False,
                                          _unrefined),
    "b05_422_q75_arith_never_24": (45, "4:2:2", (40, 24), True, _never),
}
# lossless SOF3: name -> (.synth120 image, kind, crop, write_lossless
# options)
LOSSLESS = {
    **{f"l{p - 1:02d}_grey_p{p}{'_pt2' if p % 2 == 0 else ''}":
       (50 + p, "grey", (45, 61), {"predictor": p, "pt": 2 * (p % 2 == 0)})
       for p in range(1, 8)},
    "l07_grey_p4_restart": (58, "grey", (64, 64), {"predictor": 4,
                                                   "restart": 2 * 64}),
    "l08_rgb_ids123_p6": (59, "rgb", (45, 61), {"predictor": 6}),
    "l09_rgb_adobe_p5_pt2": (60, "rgb", (45, 61), {
        "predictor": 5, "pt": 2, "markers": ("adobe0",)}),
    "l10_rgb_idsRGB_p2": (61, "rgb", (45, 61), {"predictor": 2,
                                                "ids": [82, 71, 66]}),
    "l11_420_p7": (62, "rgb", (45, 61), {
        "predictor": 7, "sampling": [(2, 2), (1, 1), (1, 1)]}),
    "l12_420_3scans_restart_p4": (63, "rgb", (40, 32), {
        "predictor": 4, "sampling": [(2, 2), (1, 1), (1, 1)],
        "scans": [[0], [1], [2]], "restart": 32}),
    "l13_cmyk_p1": (64, "cmyk", (37, 29), {"predictor": 1,
                                           "markers": ("adobe0",)}),
    "l14_422_2scans_p3": (65, "rgb", (45, 62), {
        "predictor": 3, "sampling": [(2, 1), (1, 1), (1, 1)],
        "scans": [[0], [1, 2]], "restart": 62}),
}
# what PIL cannot read: name -> (.synth120 image, kind, crop, options)
REFUSED = {
    "z00_sof11_grey": (66, "grey", (37, 29), {"arithmetic": True}),
    "z01_lossless_no_dht": (67, "grey", (37, 29), {"table": None}),
    "z02_lossless_jfif": (68, "rgb", (37, 29), {"markers": ("jfif",)}),
}
# PIL's own libjpeg-turbo (its wheel's bundled libraries)
PILS_LIBJPEG = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                            "pillow.libs")


def _coded_pixels(index, kind, crop, seed):
    grey = _cropped(index, crop)
    if kind == "grey":
        return grey
    rgb = tint(grey, seed)
    if kind == "cmyk":
        return np.concatenate([rgb, 255 - grey[..., None]], axis=-1)
    return rgb


def _planes(pixels, options):
    """The component planes ``write_lossless`` takes (chroma subsampled by
    taking every h-th / v-th sample)."""
    from torch_jpeg_coders import lossless_layout
    px = pixels[..., None] if pixels.ndim == 2 else pixels
    h, w = px.shape[:2]
    sampling = options.get("sampling") or [(1, 1)] * px.shape[2]
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    out = []
    for c, ((dh, dw), (sh, sv)) in enumerate(zip(
            lossless_layout(w, h, sampling), sampling)):
        out.append(np.ascontiguousarray(
            px[::vmax // sv, ::hmax // sh, c][:dh, :dw]))
    return out


def _strip_dac(data: bytes) -> bytes:
    at = data.index(b"\xff\xcc")
    length = int.from_bytes(data[at + 2:at + 4], "big")
    return data[:at] + data[at + 2 + length:]


def clip_frame(k: int) -> np.ndarray:
    """Frame ``k`` of the clip, RGB: the tinted image at its offset."""
    image = tint(synth(CLIP_IMAGE), SEED + 100)
    oy, ox = clip_offsets()[k]
    frame = np.zeros(CLIP_SHAPE + (3,), np.uint8)
    src = image[:CLIP_SHAPE[0] - oy, :CLIP_SHAPE[1] - ox]
    frame[oy:oy + src.shape[0], ox:ox + src.shape[1]] = src
    return frame


def write_coded_kinds(out: str, manifest: dict) -> dict:
    """The arithmetic, smoothed and lossless stills into ``stills``, the
    refused files into ``refused`` and the clip frame's three kinds into
    ``timing``."""
    import tempfile
    from torch_jpeg_coders import Libjpeg, write_lossless
    build = tempfile.mkdtemp(prefix="torch_jpeg_writer_")
    lj = Libjpeg(build)
    pil_lj = Libjpeg(build, link=(f"-L{PILS_LIBJPEG}",
                                  "-l:" + os.path.basename(glob.glob(
                                      os.path.join(PILS_LIBJPEG,
                                                   "libjpeg-*.so*"))[0]),
                                  f"-Wl,-rpath,{PILS_LIBJPEG}"),
                     name="tjw_pil")

    def put(name, data, section="stills", **info):
        path = os.path.join(out, name + ".jpg")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        if section == "refused":
            try:
                pil_lj.pixels(data)
                message = None
            except ValueError as e:
                message = str(e)
            manifest.setdefault("refused", {})[name + ".jpg"] = dict(
                info, libjpeg_turbo_message=message)
            return
        manifest.setdefault(section, {})[name + ".jpg"] = dict(
            info, **pil_digests(path))

    for k, (name, (index, kind, q, crop, opts)) in enumerate(
            ARITHMETIC.items()):
        opts = dict(opts)
        strip = opts.pop("strip_dac", False)
        data = lj.write(_coded_pixels(index, kind, crop, SEED + 600 + k), q,
                        sampling=SAMPLING[kind], arithmetic=True, **opts)
        put(name, _strip_dac(data) if strip else data,
            source=f"synth_{index:04d}", kind=kind, quality=q,
            options=dict({key: str(v) for key, v in opts.items()},
                         coding="arithmetic", dac_dropped=strip))
    for k, (name, (index, kind, crop, arith, script)) in enumerate(
            SMOOTHED.items()):
        n = 1 if kind == "grey" else 3
        data = lj.write(_coded_pixels(index, kind, crop, SEED + 700 + k), 75,
                        sampling=SAMPLING[kind], arithmetic=arith,
                        scans=script(n))
        put(name, data, source=f"synth_{index:04d}", kind=kind, quality=75,
            options={"coding": "arithmetic" if arith else "huffman",
                     "scans": [list(map(str, s)) for s in script(n)],
                     "smoothed": True})
    for k, (name, (index, kind, crop, opts)) in enumerate(LOSSLESS.items()):
        px = _coded_pixels(index, kind, crop, SEED + 800 + k)
        put(name, write_lossless(_planes(px, opts), crop[1], crop[0],
                                 table="optimal", **opts),
            source=f"synth_{index:04d}", kind=kind, quality=0,
            options={key: str(v) for key, v in opts.items()})
    for k, (name, (index, kind, crop, opts)) in enumerate(REFUSED.items()):
        px = _coded_pixels(index, kind, crop, SEED + 900 + k)
        opts = dict(opts)
        opts.setdefault("table", "optimal")
        put(name, write_lossless(_planes(px, opts), crop[1], crop[0],
                                 **opts), section="refused",
            source=f"synth_{index:04d}", kind=kind,
            options={key: str(v) for key, v in opts.items()})
    from superviseddescent_tpu.ops.patches import rgb_to_gray_u8
    frame = clip_frame(0)
    grey = rgb_to_gray_u8(frame)
    put("timing/t00_clip_f000_sof9",
        lj.write(frame, CLIP_QUALITY, sampling=SAMPLING["4:2:0"]),
        section="timing", kind="4:2:0", quality=CLIP_QUALITY,
        options={"coding": "arithmetic"})
    put("timing/t01_clip_f000_sof10",
        lj.write(frame, CLIP_QUALITY, sampling=SAMPLING["4:2:0"],
                 progressive=True), section="timing", kind="4:2:0",
        quality=CLIP_QUALITY, options={"coding": "arithmetic",
                                       "progressive": True})
    put("timing/t02_clip_f000_sof3_grey",
        write_lossless([grey], grey.shape[1], grey.shape[0], predictor=1,
                       table="optimal"), section="timing", kind="grey",
        quality=0, options={"predictor": 1, "lossless": True})
    shutil.rmtree(build, ignore_errors=True)
    return manifest


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    if "--coded-kinds" in sys.argv:
        with open(os.path.join(OUT, "manifest.json")) as f:
            manifest = json.load(f)
        write_coded_kinds(OUT, manifest)
        with open(os.path.join(OUT, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
    else:
        write_fixtures()
