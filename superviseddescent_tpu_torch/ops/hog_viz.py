"""HOG glyphs, left-right flip permutation and descriptor rendering.

Counterpart of ``superviseddescent_tpu/ops/hog_viz.py`` (reference:
vl_hog_new's permutation and glyphs, vl_hog_render). Host-side numpy in
and out, for looking at descriptors and for flip augmentation; no device
work.
"""

from __future__ import annotations

import functools

import numpy as np

from superviseddescent_tpu_torch.ops.hog import HogVariant, hog_dimension

GLYPH_SIZE = 21


def hog_flip_permutation(variant: HogVariant, num_orientations: int
                         ) -> np.ndarray:
    """Index permutation p with flipped_hog[i] = hog[p[i]] for a horizontal
    image flip (hog.c:225-268). Orientation 0 points right, so it swaps
    with the bin pointing left; texture/block dims permute left<->right."""
    o_count = num_orientations
    dims = hog_dimension(variant, o_count)
    perm = np.zeros(dims, np.int64)
    if variant == HogVariant.Uoctti:
        for o in range(o_count):
            op = o_count - o
            perm[o] = op
            perm[o + o_count] = (op + o_count) % (2 * o_count)
            perm[o + 2 * o_count] = (op % o_count) + 2 * o_count
        for k in range(4):
            blockx, blocky = k % 2, k // 2
            q = (1 - blockx) + blocky * 2
            perm[k + 3 * o_count] = q + 3 * o_count
    else:
        for k in range(4):
            blockx, blocky = k % 2, k // 2
            q = (1 - blockx) + blocky * 2
            for o in range(o_count):
                op = o_count - o
                perm[o + k * o_count] = (op % o_count) + q * o_count
    return perm


@functools.lru_cache(maxsize=None)
def hog_glyphs(num_orientations: int, transposed: bool = False) -> np.ndarray:
    """(O, G, G) glyph images: bars orthogonal to each gradient orientation
    (hog.c:276-312). With `transposed` the glyphs are stored column-major
    (hog.c:291-311), matching vl_hog_new's transposed mode."""
    g = GLYPH_SIZE
    glyphs = np.zeros((num_orientations, g, g), np.float32)
    for o in range(num_orientations):
        angle = np.fmod(o * np.pi / num_orientations + np.pi / 2, np.pi)
        x2 = g * np.cos(angle) / 2.0
        y2 = g * np.sin(angle) / 2.0
        if angle <= np.pi / 4 or angle >= np.pi * 3 / 4:
            slope = y2 / x2
            offset = (1 - slope) * (g - 1) / 2.0
            skip = int((1 - abs(np.cos(angle))) / 2.0 * g)
            for i in range(skip, g - skip):
                j = int(np.floor(slope * i + offset + 0.5))
                glyphs[o, j, i] = 1.0        # glyphs[x + G*y]: row=j(y), col=i(x)
        else:
            slope = x2 / y2
            offset = (1 - slope) * (g - 1) / 2.0
            skip = int((1 - np.sin(angle)) / 2.0 * g)
            for j in range(skip, g - skip):
                i = int(np.floor(slope * j + offset + 0.5))
                glyphs[o, j, i] = 1.0
    if transposed:
        glyphs = np.transpose(glyphs, (0, 2, 1)).copy()
    return glyphs


def hog_render(descriptor: np.ndarray, variant: HogVariant,
               num_orientations: int, transposed: bool = False) -> np.ndarray:
    """Render a (H, W, D) channels-last cell descriptor grid to a
    (H*G, W*G) glyph image (hog.c:428-495): each cell draws every
    orientation's bar weighted by the summed normalised copies, then clamps
    the tile to the [min, max] of those weights."""
    h, w, dims = descriptor.shape
    o_count = num_orientations
    if dims != hog_dimension(variant, o_count):
        raise ValueError(f"descriptor has {dims} channels, expected "
                         f"{hog_dimension(variant, o_count)}")
    glyphs = hog_glyphs(o_count, transposed)
    g = GLYPH_SIZE
    image = np.zeros((h * g, w * g), np.float32)
    for y in range(h):
        for x in range(w):
            if variant == HogVariant.Uoctti:
                weights = (descriptor[y, x, 0:o_count]
                           + descriptor[y, x, o_count:2 * o_count]
                           + descriptor[y, x, 2 * o_count:3 * o_count])
            else:
                weights = sum(descriptor[y, x, i * o_count:(i + 1) * o_count]
                              for i in range(4))
            tile = np.tensordot(weights.astype(np.float32), glyphs, axes=1)
            lo = min(0.0, float(weights.min()))
            hi = max(0.0, float(weights.max()))
            image[y * g:(y + 1) * g, x * g:(x + 1) * g] = np.clip(
                tile, lo, hi)
    return image
