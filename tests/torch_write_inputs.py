"""The pixels of the GIF and WebP write fixtures (``gif_writes`` and
``webp_writes`` of ``tests/torch_imageio/manifest.json``), made from each
entry's recipe with numpy alone, so that the fixture script (with PIL),
the CPU tests and ``chip_smoke.py`` (without PIL) make the same pixels;
each entry holds their sha256 too.

A recipe is a dict with ``kind``:

* ``noise``: uniform uint8 of ``shape`` from ``seed``;
* ``levels``: ``levels`` values ``step`` apart per channel, from ``seed``
  (at most ``levels ** 3`` colours);
* ``blocks``: noise of ``shape`` / ``block`` upsampled by ``block``
  (smooth areas with edges), from ``seed``;
* ``flat``: ``shape`` filled with ``colour``;
* ``gradient``: r = 4x + y, g = 3y, b = 255 - 2x, each mod 256;
* ``image``: a committed image (``path`` from the repo's root) as RGB, or
  its grey with ``grey``, cut to ``rect`` (row, column, height, width)
  where one is given;
* ``drawn``: a committed image drawn with ``.synth120/<points>.pts``'s
  landmarks and their box, as ``rcr_detect -o`` draws them.

``read(path, grey)`` and ``drawn(path, points)`` are the caller's readers
(PIL's in the fixture script, the port's elsewhere: ``port_readers``).
"""

import hashlib
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_readers(device="cpu"):
    """(read, drawn) through the port: ``io/image``'s readers on
    ``device`` and ``apps/_draw``'s drawing."""
    def read(path, grey):
        from superviseddescent_tpu_torch.io import image
        return (image.read_gray if grey else image.read_rgb)(
            os.path.join(REPO, path), device=device)

    def drawn(path, points):
        from superviseddescent_tpu_torch.apps import _draw
        from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
        coords = np.asarray(read_pts_landmarks(os.path.join(
            REPO, ".synth120", points + ".pts")).coordinates, np.float32)
        lo = coords.min(axis=0)
        rgb = read(path, False).copy()
        _draw.draw_landmarks(rgb, coords)
        _draw.draw_box(rgb, (*lo, *(coords.max(axis=0) - lo)))
        return rgb
    return read, drawn


def make_pixels(recipe: dict, read, drawn) -> np.ndarray:
    kind = recipe["kind"]
    if kind in ("noise", "levels", "blocks"):
        rng = np.random.default_rng(recipe["seed"])
        shape = tuple(recipe["shape"])
        if kind == "noise":
            return rng.integers(0, 256, shape, np.uint8)
        if kind == "levels":
            return (rng.integers(0, recipe["levels"], shape)
                    * recipe["step"]).astype(np.uint8)
        b = recipe["block"]
        small = rng.integers(0, 256, (-(-shape[0] // b), -(-shape[1] // b))
                             + shape[2:], np.uint8)
        big = np.repeat(np.repeat(small, b, axis=0), b, axis=1)
        return np.ascontiguousarray(big[:shape[0], :shape[1]])
    if kind == "flat":
        return np.full(tuple(recipe["shape"]), recipe["colour"], np.uint8)
    if kind == "gradient":
        h, w = recipe["shape"][:2]
        y, x = np.mgrid[:h, :w]
        return (np.stack([4 * x + y, 3 * y, 255 - 2 * x], -1) % 256
                ).astype(np.uint8)
    if kind == "image":
        px = read(recipe["path"], recipe.get("grey", False))
        if "rect" in recipe:
            r, c, h, w = recipe["rect"]
            px = px[r:r + h, c:c + w]
        return np.ascontiguousarray(px)
    if kind == "drawn":
        return drawn(recipe["path"], recipe["points"])
    raise ValueError(f"unknown recipe kind {kind!r}")


def digest(data) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of uint8 ``b`` against ``a`` (inf where equal)."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2
                                                              / mse))


# the fixtures: name -> recipe
GIF_WRITES = {
    "grey_1x1": dict(kind="noise", shape=[1, 1], seed=1),
    "grey_5x7": dict(kind="noise", shape=[5, 7], seed=2),
    "grey_15x40": dict(kind="noise", shape=[15, 40], seed=3),
    "grey_16x16": dict(kind="noise", shape=[16, 16], seed=4),
    "grey_61x37": dict(kind="noise", shape=[61, 37], seed=5),
    "grey_synth": dict(kind="image", path=".synth120/synth_0002.png",
                       grey=True),
    "rgb_64_colours": dict(kind="levels", shape=[40, 50, 3], levels=4,
                           step=60, seed=6),
    "rgb_some_colours": dict(kind="levels", shape=[60, 80, 3], levels=16,
                             step=17, seed=7),
    "rgb_noise": dict(kind="noise", shape=[120, 160, 3], seed=8),
    "rgb_past_the_hash": dict(kind="noise", shape=[320, 320, 3], seed=9),
    "rgb_drawn_still": dict(kind="drawn",
                            path=".synth120/synth_0002.png",
                            points="synth_0002"),
    "rgb_clip_frame": dict(kind="image",
                           path="tests/torch_jpeg/clip/f000.jpg"),
}
WEBP_WRITES = {
    "rgb_1x1": dict(kind="noise", shape=[1, 1, 3], seed=11),
    "rgb_7x5": dict(kind="noise", shape=[5, 7, 3], seed=12),
    "rgb_16x16": dict(kind="image", path=".synth120/synth_0002.png",
                      rect=[150, 120, 16, 16]),
    "rgb_17x33": dict(kind="blocks", shape=[17, 33, 3], block=5, seed=13),
    "flat": dict(kind="flat", shape=[48, 64, 3], colour=[200, 30, 90]),
    "gradient": dict(kind="gradient", shape=[96, 128, 3]),
    "noise": dict(kind="noise", shape=[64, 64, 3], seed=14),
    "grey": dict(kind="image", path=".synth120/synth_0002.png", grey=True,
                 rect=[100, 100, 64, 48]),
    "drawn_still": dict(kind="drawn", path=".synth120/synth_0002.png",
                        points="synth_0002"),
    "clip_frame": dict(kind="image", path="tests/torch_jpeg/clip/f000.jpg"),
}
# the twins run on these in the CPU tests; the C++ coders on every one
SMALL = 64 * 64
