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


def _tent_1d(size: int, cell_size: int) -> np.ndarray:
    """(S, C) float64 tent weights of pixel p onto cell c, border pixels
    (p = 0, S-1) zeroed: the gradient loops skip them."""
    n_cells = hog_num_cells(size, cell_size)
    h = (np.arange(size, dtype=np.float64) + 0.5) / cell_size - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(
        h[:, None] - np.arange(n_cells, dtype=np.float64)[None, :]))
    w[0, :] = 0.0
    w[-1, :] = 0.0
    return w


@functools.lru_cache(maxsize=None)
def _cell_weights_2d(size: int, cell_size: int) -> np.ndarray:
    """(S*S, C*C) pixel -> cell weights W2[y*S + x, cy*C + cx] =
    Wy[y, cy] * Wx[x, cx], formed in float32 as the JAX package does."""
    w = _tent_1d(size, cell_size).astype(np.float32)
    c = w.shape[1]
    return np.einsum("yc,xd->yxcd", w, w).reshape(size * size, c * c)


@functools.lru_cache(maxsize=None)
def _orientation_vectors(num_orientations: int,
                         transposed: bool = False) -> np.ndarray:
    """(2, O) float32 unit vectors (cos, sin)(k*pi/O); a column-major
    (transposed) image buffer swaps the x/y components."""
    angles = (np.arange(num_orientations, dtype=np.float64)
              * np.pi / num_orientations)
    vecs = np.stack([np.cos(angles), np.sin(angles)]).astype(np.float32)
    return vecs[::-1].copy() if transposed else vecs


def hog_cells(images: torch.Tensor, cell_size: int,
              num_orientations: int) -> torch.Tensor:
    """(B, S, S) float patches (0..255) -> (B, C, C, 2O) directed cell
    histograms, indexed [cy, cx, bin]."""
    b, s, s2 = images.shape
    if s != s2:
        raise ValueError("square patches expected")
    images = images.float()
    n_cells = hog_num_cells(s, cell_size)
    o = num_orientations
    gx = torch.zeros_like(images)
    gy = torch.zeros_like(images)
    gx[:, :, 1:-1] = images[:, :, 2:] - images[:, :, :-2]
    gy[:, 1:-1, :] = images[:, 2:, :] - images[:, :-2, :]
    gx = gx.reshape(b, s * s)
    gy = gy.reshape(b, s * s)

    grad = torch.sqrt(gx * gx + gy * gy)                        # (B, P)
    denom = torch.clamp(grad, min=1e-10)
    gxn = gx / denom
    gyn = gy / denom
    ov = torch.from_numpy(_orientation_vectors(o)).to(images.device)
    scores = gxn[:, None, :] * ov[0][None, :, None] \
        + gyn[:, None, :] * ov[1][None, :, None]               # (B, O, P)
    k_best = torch.argmax(scores.abs(), dim=1)                  # first max
    neg = torch.gather(scores, 1, k_best[:, None, :])[:, 0, :] < 0
    directed = k_best + o * neg.long()
    oids = torch.arange(2 * o, device=images.device)[None, :, None]
    g = grad[:, None, :] * (directed[:, None, :] == oids).float()
    w2 = torch.from_numpy(_cell_weights_2d(s, cell_size)).to(images.device)
    cells = torch.matmul(g, w2)                                 # (B, 2O, CC)
    return cells.reshape(b, 2 * o, n_cells, n_cells).permute(0, 2, 3, 1)


def hog_extract(cells: torch.Tensor,
                variant: HogVariant = HogVariant.Uoctti) -> torch.Tensor:
    """Block-normalised descriptor: (B, C, C, 2O) -> (B, C, C, D)."""
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
                   variant: HogVariant = HogVariant.Uoctti) -> torch.Tensor:
    """(B, S, S) patches -> (B, C*C*D) rows in Matlab order
    d*C*C + x*C + y."""
    desc = hog_extract(hog_cells(images, cell_size, num_orientations),
                       variant)                                 # (B,Cy,Cx,D)
    return desc.permute(0, 3, 2, 1).reshape(desc.shape[0], -1)
