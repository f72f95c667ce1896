"""VLFeat HOG descriptors in plain PyTorch, batched over patches.

Counterpart of ``superviseddescent_tpu/ops/hog.py`` and the exact HOG that
``DetectionModel.detect_batch`` uses (reference: VLFeat hog.c,
vl_hog_put_image / vl_hog_extract):

  * interior pixels only; central differences;
  * hard assignment to the best of 2*O directed bins by the dot product of
    the normalised gradient with (cos, sin)(k*pi/O), first maximum wins;
  * bilinear spatial splat into a C x C cell grid, C = (S + cs//2) // cs,
    with tent weights from h = (p + 0.5)/cs - 0.5, as one pixel->cells
    product;
  * 2x2 block energies with clamped border indexing, factors
    1/sqrt(sum + 1e-4), components clamped at 0.2;
  * Uoctti: 0.5 * the sum of 4 normalised copies of the directed (2O) and
    undirected (O) histograms plus 4 texture dims t_i / sqrt(18);
    DalalTriggs: the 4 normalised undirected copies (4O channels).

The reference's other inputs too: planar multi-channel patches (per pixel
the channel with the largest gradient), bilinear orientation assignment,
column-major (``transposed``) buffers and polar gradient fields
(``hog_cells_from_polar``).

Descriptors flatten in the reference's Matlab order d*C*C + x*C + y.
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch


class HogVariant(enum.IntEnum):
    """Matches VlHogVariant: DalalTriggs=0, Uoctti=1."""
    DalalTriggs = 0
    Uoctti = 1


def hog_num_cells(size: int, cell_size: int) -> int:
    """Cell-grid side length."""
    return (size + cell_size // 2) // cell_size


def hog_dimension(variant: HogVariant, num_orientations: int) -> int:
    """Descriptor channels per cell."""
    if variant == HogVariant.Uoctti:
        return 3 * num_orientations + 4
    return 4 * num_orientations


def _tent_1d_full(size: int, cell_size: int) -> np.ndarray:
    """(S, C) float64 tent weights of pixel p onto cell c, every pixel
    included (the polar entry point accumulates them all)."""
    n_cells = hog_num_cells(size, cell_size)
    h = (np.arange(size, dtype=np.float64) + 0.5) / cell_size - 0.5
    return np.maximum(0.0, 1.0 - np.abs(
        h[:, None] - np.arange(n_cells, dtype=np.float64)[None, :]))


def _tent_1d(size: int, cell_size: int) -> np.ndarray:
    """``_tent_1d_full`` with the border pixels (p = 0, S-1) zeroed: the
    gradient loops skip them."""
    w = _tent_1d_full(size, cell_size)
    w[0, :] = 0.0
    w[-1, :] = 0.0
    return w


@functools.lru_cache(maxsize=None)
def _orientation_vectors(num_orientations: int,
                         transposed: bool = False) -> np.ndarray:
    """(2, O) float32 unit vectors (cos, sin)(k*pi/O); a column-major
    (transposed) image buffer swaps the x/y components."""
    angles = (np.arange(num_orientations, dtype=np.float64)
              * np.pi / num_orientations)
    vecs = np.stack([np.cos(angles), np.sin(angles)]).astype(np.float32)
    return vecs[::-1].copy() if transposed else vecs


@functools.lru_cache(maxsize=None)
def _cell_weights_2d(size: int, cell_size: int,
                     borders: bool = False) -> np.ndarray:
    """(S*S, C*C) pixel -> cell weights W2[y*S + x, cy*C + cx] =
    Wy[y, cy] * Wx[x, cx], formed in float32 as the JAX package does;
    border pixels weigh 0 unless ``borders``."""
    w = (_tent_1d_full if borders else _tent_1d)(size, cell_size)
    w = w.astype(np.float32)
    c = w.shape[1]
    return np.einsum("yc,xd->yxcd", w, w).reshape(size * size, c * c)


def _splat(g: torch.Tensor, size: int, cell_size: int,
           borders: bool = False) -> torch.Tensor:
    """(B, 2O, S*S) per-bin magnitudes -> (B, C, C, 2O) cells, as one
    pixel -> cell product."""
    b, two_o, _ = g.shape
    c = hog_num_cells(size, cell_size)
    w2 = torch.from_numpy(_cell_weights_2d(size, cell_size, borders)).to(
        g.device)
    cells = torch.matmul(g, w2)                                 # (B, 2O, CC)
    return cells.reshape(b, two_o, c, c).permute(0, 2, 3, 1)


def _bin_masks(bins: torch.Tensor, two_o: int) -> torch.Tensor:
    """(B, P) bin indices -> (B, 2O, P) float32 one-hot masks."""
    oids = torch.arange(two_o, device=bins.device)[None, :, None]
    return (bins[:, None, :] == oids).float()


def hog_cells(images: torch.Tensor, cell_size: int, num_orientations: int,
              bilinear_orientation: bool = False,
              transposed: bool = False) -> torch.Tensor:
    """Directed-orientation cell histograms, (B, C, C, 2O) indexed
    [cy, cx, bin].

    images: (B, S, S) patches (0..255), or (B, Ch, S, S) planar
    multi-channel patches: per pixel the channel with the largest squared
    gradient wins, the first channel on a tie (the strict ">" update of
    vl_hog_put_image); a pixel with no gradient in any channel takes
    channel 0. bilinear_orientation: split each pixel between its two
    closest directed bins, with the reference's quirk of applying the
    orientation weight to both spatial factors, so that it enters squared.
    transposed: the buffer is a column-major image, whose orientation
    vectors swap their x/y components; pair with
    ``hog_extract(..., transposed=True)``.
    """
    if images.ndim == 3:
        images = images[:, None]
    b, ch, s, s2 = images.shape
    if s != s2:
        raise ValueError("square patches expected")
    images = images.float()
    o = num_orientations
    gx = torch.zeros_like(images)
    gy = torch.zeros_like(images)
    gx[..., 1:-1] = images[..., 2:] - images[..., :-2]
    gy[..., 1:-1, :] = images[..., 2:, :] - images[..., :-2, :]
    gx = gx.reshape(b, ch, s * s)
    gy = gy.reshape(b, ch, s * s)
    if ch == 1:
        gx, gy = gx[:, 0], gy[:, 0]
    else:
        # argmax returns the first maximum: the first channel wins ties
        k = torch.argmax(gx * gx + gy * gy, dim=1, keepdim=True)
        gx = torch.gather(gx, 1, k)[:, 0]
        gy = torch.gather(gy, 1, k)[:, 0]

    grad = torch.sqrt(gx * gx + gy * gy)                        # (B, P)
    denom = torch.clamp(grad, min=1e-10)
    gxn = gx / denom
    gyn = gy / denom
    ov = torch.from_numpy(_orientation_vectors(o, transposed)).to(
        images.device)
    scores = gxn[:, None, :] * ov[0][None, :, None] \
        + gyn[:, None, :] * ov[1][None, :, None]               # (B, O, P)
    abs_scores = scores.abs()
    k_best = torch.argmax(abs_scores, dim=1)                    # first max
    neg = torch.gather(scores, 1, k_best[:, None, :])[:, 0, :] < 0
    directed = k_best + o * neg.long()
    if not bilinear_orientation:
        g = grad[:, None, :] * _bin_masks(directed, 2 * o)
        return _splat(g, s, cell_size)
    # the second-best directed bin (first maximum of the rest)
    masked = abs_scores.scatter(1, k_best[:, None, :], float("-inf"))
    k2 = torch.argmax(masked, dim=1)
    neg2 = torch.gather(scores, 1, k2[:, None, :])[:, 0, :] < 0
    directed2 = k2 + o * neg2.long()
    best = torch.gather(abs_scores, 1, k_best[:, None, :])[:, 0, :]
    w1 = torch.arccos(torch.clamp(best, max=1.0)) / (np.pi / o)
    w0 = 1.0 - w1
    g = (grad[:, None, :] * (w0 * w0)[:, None, :]
         * _bin_masks(directed, 2 * o)
         + grad[:, None, :] * (w1 * w1)[:, None, :]
         * _bin_masks(directed2, 2 * o))
    return _splat(g, s, cell_size)


def hog_cells_from_polar(modulus: torch.Tensor, angle: torch.Tensor,
                         directed: bool, cell_size: int,
                         num_orientations: int,
                         bilinear_orientation: bool = False) -> torch.Tensor:
    """Cell histograms from a polar gradient field (vl_hog_put_polar_field):
    modulus and angle (B, S, S), angles clockwise from the x axis (y
    down), wrapping at 2*pi when ``directed`` else at pi. Every pixel
    contributes (no border exclusion); a modulus <= 0 contributes nothing.
    Orientations round to the nearest bin, or split bilinearly with the
    weight entering squared (the reference's quirk). Returns
    (B, C, C, 2O); undirected fields fill only the first O channels."""
    b, s, s2 = modulus.shape
    if s != s2:
        raise ValueError("square fields expected")
    o = num_orientations
    two_o = 2 * o
    period = o * (2 if directed else 1)
    mod = modulus.float().reshape(b, s * s)
    ang = angle.float().reshape(b, s * s)
    # a tensor divisor: a true quotient on CUDA too
    ho = ang / torch.tensor(np.float32(np.pi / o), device=ang.device)
    bino = torch.floor(ho)
    wo2 = ho - bino
    wo1 = 1.0 - wo2
    bino = torch.remainder(bino.long(), two_o)        # the C's wrap loop
    mod = torch.where(mod > 0, mod, torch.zeros((), device=mod.device))
    if bilinear_orientation:
        g = (mod[:, None, :] * (wo1 * wo1)[:, None, :]
             * _bin_masks(torch.remainder(bino, period), two_o)
             + mod[:, None, :] * (wo2 * wo2)[:, None, :]
             * _bin_masks(torch.remainder(bino + 1, period), two_o))
    else:
        nearest = torch.remainder(bino + (wo1 <= wo2).long(), period)
        g = mod[:, None, :] * _bin_masks(nearest, two_o)
    return _splat(g, s, cell_size, borders=True)


def hog_extract(cells: torch.Tensor,
                variant: HogVariant = HogVariant.Uoctti,
                transposed: bool = False) -> torch.Tensor:
    """Block-normalised descriptor: (B, C, C, 2O) -> (B, C, C, D).
    transposed (column-major image buffers) swaps the second and third
    block factors."""
    b, c, c2, two_o = cells.shape
    o = two_o // 2
    ha = cells[..., :o]
    hb = cells[..., o:]
    folded = ha + hb
    energy = torch.sum(folded * folded, dim=-1)                 # (B, C, C)
    # clamped 3x3 neighbourhood via edge-replicate padding
    e = torch.nn.functional.pad(energy[:, None], (1, 1, 1, 1),
                                mode="replicate")[:, 0]
    n1, n2, n3 = e[:, :-2, :-2], e[:, :-2, 1:-1], e[:, :-2, 2:]
    n4, n5, n6 = e[:, 1:-1, :-2], e[:, 1:-1, 1:-1], e[:, 1:-1, 2:]
    n7, n8, n9 = e[:, 2:, :-2], e[:, 2:, 1:-1], e[:, 2:, 2:]
    f1 = torch.rsqrt(n1 + n2 + n4 + n5 + 1e-4)
    f2 = torch.rsqrt(n2 + n3 + n5 + n6 + 1e-4)
    f3 = torch.rsqrt(n4 + n5 + n7 + n8 + 1e-4)
    f4 = torch.rsqrt(n5 + n6 + n8 + n9 + 1e-4)
    if transposed:
        f2, f3 = f3, f2
    factors = torch.stack([f1, f2, f3, f4], dim=-1)[..., None]  # (B,C,C,4,1)
    ha_i = factors * ha[..., None, :]                           # (B,C,C,4,O)
    hb_i = factors * hb[..., None, :]
    hc_i = torch.clamp(ha_i + hb_i, max=0.2)  # from the unclamped parts
    ha_i = torch.clamp(ha_i, max=0.2)
    hb_i = torch.clamp(hb_i, max=0.2)
    if variant == HogVariant.Uoctti:
        scale_t = float(np.float32(1.0) / np.sqrt(np.float32(18.0)))
        return torch.cat([0.5 * ha_i.sum(-2), 0.5 * hb_i.sum(-2),
                          0.5 * hc_i.sum(-2), hc_i.sum(-1) * scale_t], -1)
    return hc_i.reshape(b, c, c2, 4 * o)


def hog_descriptor(images: torch.Tensor, cell_size: int,
                   num_orientations: int,
                   variant: HogVariant = HogVariant.Uoctti,
                   transposed: bool = False) -> torch.Tensor:
    """(B, S, S) or planar (B, Ch, S, S) patches -> (B, C*C*D) rows in
    Matlab order d*C*C + x*C + y."""
    cells = hog_cells(images, cell_size, num_orientations,
                      transposed=transposed)
    desc = hog_extract(cells, variant, transposed=transposed)   # (B,Cy,Cx,D)
    return desc.permute(0, 3, 2, 1).reshape(desc.shape[0], -1)
