"""Landmarks and face boxes drawn into an RGB image for the apps' ``-o``,
pixel for pixel as the JAX apps draw them with PIL.

The JAX apps call ``ImageDraw.ellipse([x - 2, y - 2, x + 2, y + 2],
outline=green)`` per landmark (x, y float32, the corners computed in
float32), then ``ImageDraw.rectangle([x0, y0, x0 + w, y0 + h],
outline=red)``, and save with ``img.save(name)``. PIL truncates each
corner toward zero (C's ``(int)``; a non-finite corner draws nothing),
so a ring's box is 3 to 5 pixels across near 0; its outline depends only
on the box's integer width and height (``RINGS``, probed from PIL 12.1 on
a 1/64 px grid, off-image positions included). The rectangle's outline is
the rows y0 and y1 from x0 to x1 and the columns x0 and x1 from y0 + 1 to
y1 (both y0 and y0 + 1 where y1 = y0); everything is clipped to the
image. ``draw_landmarks`` and ``draw_box`` write those pixels by index
into a numpy array or a tensor on any device.

``annotate`` reads the image as RGB (``io/image``; a JPEG through J1 on
the device), draws there and writes the format the output's extension
names (``io/image.write_image``; a JPEG through J2, a GIF or a WebP
through its host C++ coder on the card's path), so a JPEG frame bound for
a JPEG file never leaves the card until its coefficients are coded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from superviseddescent_tpu_torch.io.image import read_rgb_tensor, write_image

GREEN = (0, 255, 0)
RED = (255, 0, 0)
# PIL's one-pixel ellipse outline of a box (x1 - x0, y1 - y0) wide and high
RINGS = {
    (3, 3): (".##.", "#..#", "#..#", ".##."),
    (3, 4): (".##.", "#..#", "#..#", "#..#", ".##."),
    (3, 5): (".##.", "#..#", "#..#", "#..#", "#..#", ".##."),
    (4, 3): (".###.", "#...#", "#...#", ".###."),
    (4, 4): (".###.", "#...#", "#...#", "#...#", ".###."),
    (4, 5): (".###.", "#...#", "#...#", "#...#", "#...#", ".###."),
    (5, 3): (".####.", "#....#", "#....#", ".####."),
    (5, 4): (".####.", "#....#", "#....#", "#....#", ".####."),
    (5, 5): ("..##..", ".#..#.", "#....#", "#....#", ".#..#.", "..##.."),
}
_RING_OFFSETS = {size: np.nonzero(np.array([[c == "#" for c in row]
                                            for row in rows]))
                 for size, rows in RINGS.items()}
_INT_LIMIT = 2 ** 31


def _trunc(v) -> int | None:
    """C's (int) of a finite corner inside int's range, else None."""
    v = float(v)
    if not math.isfinite(v) or abs(v) >= _INT_LIMIT:
        return None
    return int(v)


def _paint(rgb, ys, xs, colour) -> None:
    h, w = rgb.shape[:2]
    ys, xs = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    ys, xs = ys[keep], xs[keep]
    if not len(ys):
        return
    if isinstance(rgb, torch.Tensor):
        dev = rgb.device
        rgb[torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)] = (
            torch.tensor(colour, dtype=rgb.dtype, device=dev))
    else:
        rgb[ys, xs] = colour


def ring_pixels(coordinates):
    """(ys, xs) of every landmark's ring, in order."""
    c = np.asarray(coordinates)
    if not np.issubdtype(c.dtype, np.floating):
        c = c.astype(np.float64)
    c = c.reshape(-1, 2)
    two = c.dtype.type(2)
    ys, xs = [], []
    for (x0, y0), (x1, y1) in zip(c - two, c + two):
        corners = [_trunc(v) for v in (x0, y0, x1, y1)]
        if None in corners:
            continue
        x0, y0, x1, y1 = corners
        dy, dx = _RING_OFFSETS[(x1 - x0, y1 - y0)]
        ys.append(y0 + dy)
        xs.append(x0 + dx)
    if not ys:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ys), np.concatenate(xs)


def box_pixels(box):
    """(ys, xs) of the outline of [x, y, x + w, y + h] as PIL draws it."""
    x, y, bw, bh = box                  # the sums in the box's own type
    corners = [_trunc(v) for v in (x, y, x + bw, y + bh)]
    if None in corners:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    x0, y0, x1, y1 = corners
    if x1 < x0 or y1 < y0:
        raise ValueError(f"box {box}: x1 must be >= x0 and y1 >= y0, as "
                         "PIL's rectangle requires")
    across = np.arange(x0, x1 + 1)
    down = np.arange(min(y0 + 1, y1), max(y0 + 1, y1) + 1)
    ys = np.concatenate([np.full(len(across), y0), np.full(len(across), y1),
                         down, down])
    xs = np.concatenate([across, across, np.full(len(down), x0),
                         np.full(len(down), x1)])
    return ys, xs


def draw_landmarks(rgb, coordinates, colour=GREEN) -> None:
    """PIL's ring of ``ellipse([x - 2, y - 2, x + 2, y + 2])`` per (x, y),
    clipped to the image; ``rgb`` is an (H, W, 3) array or tensor."""
    _paint(rgb, *ring_pixels(coordinates), colour)


def draw_box(rgb, box, colour=RED) -> None:
    """PIL's outline of ``rectangle([x, y, x + w, y + h])``, clipped."""
    _paint(rgb, *box_pixels(box), colour)


def annotate(image_path, out_path, coordinates, box=None,
             device=None) -> str:
    """Write ``image_path`` as RGB with the landmarks (and then the box)
    drawn, in the format of ``out_path``'s extension; returns
    ``out_path``. The image is read, drawn and (as JPEG) encoded on
    ``device``."""
    from superviseddescent_tpu_torch.io.image import format_for
    from superviseddescent_tpu_torch.utils.device import resolve_device
    format_for(out_path)                # an unwritable name raises first
    dev = resolve_device(device)
    rgb = read_rgb_tensor(image_path, dev)
    draw_landmarks(rgb, coordinates)
    if box is not None:
        draw_box(rgb, box)
    write_image(out_path, rgb, device=dev)
    return str(out_path)
