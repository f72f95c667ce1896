"""Writes the committed JPEG fixtures, ``tests/torch_jpeg/``, with PIL.

    python tests/torch_jpeg_fixtures.py

The card has no PIL, so ``chip_smoke.py --jpeg`` reads these files and
holds the port's decoder against PIL's digests in ``manifest.json``: the
sha256 of the JAX package's ``load_gray_image`` as uint8 (PIL, then
OpenCV's grey) and of PIL's ``convert("RGB")``, per file.

* stills: ``.synth120`` images, every size class at least once, as grey
  (1 component), YCbCr 4:4:4, 4:2:2 and 4:2:0 (PIL's ``subsampling`` 0, 1,
  2) at qualities 50, 75 and 95; one 4:2:0 and one grey still with restart
  markers, one with optimised Huffman tables, one of 301 x 451 (no
  multiple of 16). A colour still is a seeded tint of the grey image
  (``tint``): gains, offsets and ramps per channel, so the chroma varies.
* clip: ``CLIP_FRAMES`` 4:2:0 frames of 1024 rows x 768 columns at
  quality 75 in which ``.synth120`` image 3 drifts by up to 3 px a frame
  and axis from (260, 40), as ``chip_smoke.py``'s app clip; the offsets
  are in the manifest.

The same seed gives the same bytes for the same PIL and libjpeg-turbo;
``tests/test_torch_jpeg.py`` checks that the files still match the
manifest.
"""

import glob
import hashlib
import io
import json
import os
import sys

import numpy as np
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
    image = tint(synth(CLIP_IMAGE), SEED + 100)
    offsets = clip_offsets()
    frames = []
    for k, (oy, ox) in enumerate(offsets):
        frame = np.zeros(CLIP_SHAPE + (3,), np.uint8)
        src = image[:CLIP_SHAPE[0] - oy, :CLIP_SHAPE[1] - ox]
        frame[oy:oy + src.shape[0], ox:ox + src.shape[1]] = src
        name = f"clip/f{k:03d}.jpg"
        os.makedirs(os.path.join(out, "clip"), exist_ok=True)
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(encode(frame, "4:2:0", CLIP_QUALITY))
        frames.append(dict(name=name, **pil_digests(path)))
    manifest["clip"] = dict(source=f"synth_{CLIP_IMAGE:04d}",
                            kind="4:2:0", quality=CLIP_QUALITY,
                            offsets=offsets.tolist(), frames=frames)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    write_fixtures()
