"""Landmarks and face boxes drawn into an RGB image for the apps' ``-o``.

The JAX apps draw with PIL (``ImageDraw.ellipse`` of radius 2 per landmark,
``ImageDraw.rectangle`` for the box). The card has no PIL, so the port
draws with numpy: each landmark a circle outline of radius 2 around its
rounded position (the pixels whose distance from the centre rounds to 2),
the box a one-pixel rectangle outline. The pixels are the port's own and
are not held to PIL's rasteriser. A JPEG input is read as RGB through
kernel J1 (``ops/jpeg.read_jpeg``). The port has no JPEG encoder: every
annotated image is written as PNG, and a ``.jpg`` / ``.jpeg`` output name
gets the suffix ``.png`` (``png_path``).
"""

from __future__ import annotations

import os

import numpy as np

from superviseddescent_tpu_torch.io.png import decode_png, write_png

GREEN = (0, 255, 0)
RED = (255, 0, 0)

_D = np.arange(-2, 3)
_RING = np.abs(np.hypot(_D[:, None], _D[None, :]) - 2.0) < 0.5
RING_DY, RING_DX = (a - 2 for a in np.nonzero(_RING))


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 as decoded by ``io/png`` -> (H, W, 3) RGB (grey is
    repeated, alpha dropped)."""
    if pixels.shape[2] <= 2:
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def draw_landmarks(rgb: np.ndarray, coordinates, colour=GREEN) -> None:
    """A radius-2 circle outline around each (x, y), clipped to the image."""
    h, w = rgb.shape[:2]
    c = np.rint(np.asarray(coordinates, np.float64)).reshape(-1, 2)
    c = c[np.isfinite(c).all(axis=1)].astype(np.int64)
    ys = (c[:, 1:2] + RING_DY[None, :]).ravel()
    xs = (c[:, 0:1] + RING_DX[None, :]).ravel()
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    rgb[ys[keep], xs[keep]] = colour


def draw_box(rgb: np.ndarray, box, colour=RED) -> None:
    """The outline of the rectangle [x, x + w] x [y, y + h], clipped."""
    h, w = rgb.shape[:2]
    x0, y0, bw, bh = (float(v) for v in box)
    x0, y0 = int(round(x0)), int(round(y0))
    x1, y1 = int(round(x0 + bw)), int(round(y0 + bh))
    cx0, cx1 = max(x0, 0), min(x1, w - 1)
    cy0, cy1 = max(y0, 0), min(y1, h - 1)
    for y in (y0, y1):
        if 0 <= y < h and cx0 <= cx1:
            rgb[y, cx0:cx1 + 1] = colour
    for x in (x0, x1):
        if 0 <= x < w and cy0 <= cy1:
            rgb[cy0:cy1 + 1, x] = colour


def read_rgb(image_path, device=None) -> np.ndarray:
    """A PNG or JPEG file as (H, W, 3) uint8 RGB; a JPEG's pixels are
    computed on ``device`` (the card unless the caller names one)."""
    with open(image_path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        from superviseddescent_tpu_torch.ops.jpeg import read_jpeg
        return read_jpeg(data, 3, device).cpu().numpy()
    return to_rgb(decode_png(data))


def png_path(out_path) -> str:
    """The name an annotated image is written under: a ``.jpg`` / ``.jpeg``
    name with the suffix ``.png``, any other name as it is."""
    root, ext = os.path.splitext(os.fspath(out_path))
    return root + ".png" if ext.lower() in (".jpg", ".jpeg") else os.fspath(
        out_path)


def annotate(image_path, out_path, coordinates, box=None,
             device=None) -> str:
    """Write ``image_path`` as RGB PNG with the landmarks (and the box)
    drawn, under ``png_path(out_path)``; returns that name."""
    rgb = read_rgb(image_path, device)
    draw_landmarks(rgb, coordinates)
    if box is not None:
        draw_box(rgb, box)
    path = png_path(out_path)
    write_png(path, rgb)
    return path
