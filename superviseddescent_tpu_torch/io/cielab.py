"""CIELab to RGB as PIL's ``convert("RGB")`` does it (no PIL, no
LittleCMS).

PIL converts its mode ``LAB`` through LittleCMS: a transform from the Lab
profile (D50, ICC v4 encoding) to the built-in sRGB profile, perceptual
intent, 8-bit in and out. LittleCMS optimises that transform into a
colour lookup table of 33 x 33 x 33 nodes of 16 bits, each node the
float32 pipeline evaluated at its 16-bit input (Lab v4 to XYZ, over the
XYZ encoding's 1 + 32767 / 32768; the inverse of sRGB's D50-adapted
colourant matrix; sRGB's inverse tone curve), and reads it by tetrahedral
interpolation in 16.16 fixed point; an 8-bit sample enters as v * 257 and
leaves as (v * 65281 + 2^23) >> 24. ``lab_to_rgb`` is that table and that
interpolation, equal to PIL 12.1's conversion on every one of the 2^24
8-bit inputs (checked with the PIL that wrote the fixtures; the tests
hold the committed LAB fixtures to PIL's digests).

A TIFF's a* and b* are signed bytes; PIL's ``LAB`` unpacker adds 128, so
the table is indexed by L, a + 128, b + 128.
"""

from __future__ import annotations

import functools

import numpy as np

GRID = 33
XYZ_SCALE = 1 + 32767 / 32768          # LittleCMS's MAX_ENCODEABLE_XYZ
D50 = np.array([0.9642, 1.0, 0.8249])
# sRGB: D65 white and the primaries' chromaticities
D65_XY = (0.3127, 0.3290)
PRIMARIES = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
BRADFORD = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                     [0.0389, -0.0685, 1.0296]])
# the sRGB tone curve (ICC parametric type 4): gamma, a, b, c, d
CURVE = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045)


def _f32(x: np.ndarray) -> np.ndarray:
    """A stage's float32 output (LittleCMS's pipelines carry float32)."""
    return x.astype(np.float32).astype(np.float64)


def srgb_to_xyz() -> np.ndarray:
    """sRGB's colourant matrix, adapted to D50 by Bradford."""
    wx, wy = D65_XY
    prim = np.array([[x for x, _ in PRIMARIES], [y for _, y in PRIMARIES],
                     [1 - x - y for x, y in PRIMARIES]])
    white = np.array([wx / wy, 1.0, (1 - wx - wy) / wy])
    m = prim * np.linalg.solve(prim, white)
    cone = (BRADFORD @ D50) / (BRADFORD @ white)
    return np.linalg.inv(BRADFORD) @ np.diag(cone) @ BRADFORD @ m


def _pipeline(v16: np.ndarray) -> np.ndarray:
    """16-bit Lab v4 inputs (..., 3) -> 16-bit RGB, the unoptimised
    transform a node samples."""
    x = _f32(v16 / 65535.0)
    lum = x[..., 0] * 100.0
    fy = (lum + 16.0) / 116.0
    f = np.stack([fy + 0.002 * (x[..., 1] * 255.0 - 128.0), fy,
                  fy - 0.005 * (x[..., 2] * 255.0 - 128.0)], axis=-1)
    xyz = np.where(f <= 24.0 / 116.0, 108.0 / 841.0 * (f - 16.0 / 116.0),
                   f * f * f) * D50
    xyz = _f32(xyz / XYZ_SCALE)
    lin = _f32(np.einsum("ij,...j->...i",
                         np.linalg.inv(srgb_to_xyz()) * XYZ_SCALE, xyz))
    g, a, b, c, d = CURVE
    with np.errstate(invalid="ignore"):
        high = (np.power(np.maximum(lin, 0.0), 1.0 / g) - b) / a
    out = _f32(np.where(lin >= (a * d + b) ** g, high, lin / c))
    return np.clip(np.floor(out * 65535.0 + 0.5), 0, 65535).astype(np.int64)


@functools.lru_cache(maxsize=1)
def lut() -> np.ndarray:
    """The (GRID^3, 3) int64 node table, L slowest, b fastest."""
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5)
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), axis=-1)
    return _pipeline(nodes).reshape(-1, 3)


def _tetrahedral(v: np.ndarray) -> np.ndarray:
    """LittleCMS's ``TetrahedralInterp16`` of (n, 3) 16-bit inputs ->
    (n, 3) 16-bit outputs: the cell's corner and three more nodes chosen
    by the order of the fractions, ties as its branches take them."""
    table = lut()
    dom = GRID - 1
    fixed = v * dom
    fixed = fixed + (fixed + 0x7FFF) // 0xFFFF
    cell, rest = fixed >> 16, fixed & 0xFFFF
    stride = np.array([GRID * GRID, GRID, 1])
    base = (cell * stride).sum(axis=1)
    step = np.where(v == 0xFFFF, 0, stride)      # no step past the last node
    rx, ry, rz = rest.T
    x1, y1, z1 = step.T
    # each tetrahedron: its second, third and fourth nodes as offsets
    ge = np.greater_equal
    cases = [
        (ge(rx, ry) & ge(ry, rz), (x1, x1 + y1, x1 + y1 + z1)),
        (ge(rx, ry) & ge(rz, rx), (z1, x1 + z1, x1 + y1 + z1)),
        (ge(rx, ry), (x1, x1 + z1, x1 + y1 + z1)),
        (ge(rx, rz), (y1, x1 + y1, x1 + y1 + z1)),
        (ge(ry, rz), (y1, y1 + z1, x1 + y1 + z1)),
        (np.ones_like(rx, bool), (z1, y1 + z1, x1 + y1 + z1))]
    # the fractions in the order the tetrahedron's edges take them
    weights = [(rx, ry, rz), (rz, rx, ry), (rx, rz, ry), (ry, rx, rz),
               (ry, rz, rx), (rz, ry, rx)]
    out = np.zeros(v.shape, np.int64)
    done = np.zeros(len(v), bool)
    for (mask, (p1, p2, p3)), (w1, w2, w3) in zip(cases, weights):
        m = mask & ~done
        done |= m
        if not m.any():
            continue
        b = base[m]
        c0, c1, c2, c3 = (table[b], table[b + p1[m]], table[b + p2[m]],
                          table[b + p3[m]])
        r = ((c1 - c0) * w1[m, None] + (c2 - c1) * w2[m, None]
             + (c3 - c2) * w3[m, None] + 0x8001)
        out[m] = (c0 + ((r + (r >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """A TIFF's CIELab samples, uint8 (..., 3) with a* and b* signed ->
    uint8 (..., 3) RGB, PIL's ``convert("RGB")``."""
    lab = np.asarray(lab, np.uint8)
    v = (lab.reshape(-1, 3).astype(np.int64) ^ np.array([0, 128, 128])) * 257
    out = _tetrahedral(v)
    return ((out * 65281 + 8388608) >> 24).astype(np.uint8).reshape(
        lab.shape)
