"""Batched landmark-patch extraction: crop + zero-pad + resize in one
bilinear gather, plus image loading and stacking.

Counterpart of ``superviseddescent_tpu/ops/patches.py`` (reference:
rcr/adaptive_vlhog.hpp: crop a (2*phw)^2 square at the rounded landmark,
copyMakeBorder, cv::resize to S x S). Destination pixel d samples the crop at
clamp((d + 0.5) * 2*phw/S - 0.5, 0, 2*phw - 1); pixels outside the image
are 0. Landmark centres round half to even (cvRound, and torch.round).
``quantize=True`` reproduces cv::resize's 8U fixed-point pipeline bit for
bit (11-bit coefficients, truncating shifts).

``extract_patches_dense`` computes the same bilinear samples as two dense
tent products over the image rows and columns, in three precisions
(``sampling``): exact float32, ``high`` (three bfloat16 products, as JAX's
``Precision.HIGH``) and ``fast`` (bfloat16 operands, float32 sums, as
JAX's ``Precision.DEFAULT``).
"""

from __future__ import annotations

import numpy as np
import torch

from superviseddescent_tpu_torch.ops.solver import (
    float32_matmul, tf32_matmul)

# cv::resize's 8U INTER_LINEAR coefficients are 11-bit fixed point
_CV_RESIZE_COEF = 2048.0
SAMPLINGS = ("exact", "high", "fast")


def extract_patches(images: torch.Tensor, image_indices: torch.Tensor,
                    centers_x: torch.Tensor, centers_y: torch.Tensor,
                    patch_half: torch.Tensor, out_size: int,
                    quantize: bool = True) -> torch.Tensor:
    """Sample (N, L, S, S) float32 patches around landmark centres.

    images: (I, H, W) float32 or uint8 gray stack (zero-padded);
    image_indices: (N,) image per sample; centers_x/_y: (N, L);
    patch_half: (N,) half patch size in source pixels.
    """
    n, l = centers_x.shape
    h, w = images.shape[1], images.shape[2]
    s = out_size
    dev = centers_x.device
    image_indices = image_indices.long()
    origin_x = torch.round(centers_x) - patch_half[:, None]      # (N, L)
    origin_y = torch.round(centers_y) - patch_half[:, None]
    d = torch.arange(s, dtype=torch.float32, device=dev)
    src = (d[None, :] + 0.5) * (2.0 * patch_half[:, None] / s) - 0.5
    if not quantize:
        src = torch.minimum(torch.clamp(src, min=0.0),
                            2.0 * patch_half[:, None] - 1.0)     # (N, S)
    s0 = torch.floor(src)
    frac = (src - s0)[:, None, :]                                # (N, 1, S)
    img_idx = image_indices[:, None, None]

    def rows_at(iy):
        """(N, L, S) row indices -> (N, L, S, W) rows, zero outside."""
        inb = ((iy >= 0) & (iy < h))[..., None]
        vals = images[img_idx, iy.clamp(0, h - 1)].float()
        return torch.where(inb, vals, torch.zeros((), device=dev))

    def cols_at(rows, ix):
        """(N, L, S) column indices -> (N, L, S, S), zero outside."""
        inb = ((ix >= 0) & (ix < w))[:, :, None, :]
        take = ix.clamp(0, w - 1)[:, :, None, :].expand(n, l, s, s)
        vals = torch.gather(rows, 3, take)
        return torch.where(inb, vals, torch.zeros((), device=dev))

    if not quantize:
        x0 = (origin_x[:, :, None] + src[:, None, :]).floor().long()
        y0 = (origin_y[:, :, None] + src[:, None, :]).floor().long()
        wx = frac.expand(n, l, s)[:, :, None, :]                 # (N,L,1,S)
        wy = frac.expand(n, l, s)[:, :, :, None]                 # (N,L,S,1)
        rows = rows_at(y0) * (1.0 - wy) + rows_at(y0 + 1) * wy
        return cols_at(rows, x0) * (1.0 - wx) + cols_at(rows, x0 + 1) * wx

    # cv::resize 8U INTER_LINEAR: a1 = cvRound(f*2048), a0 = 2048 - a1 with
    # the fraction unclamped (only the indices replicate-clamp into the
    # crop); h = p0*a0 + p1*a1; t = ((h >> 4) * b) >> 16 per row pair;
    # dst = sat((t0 + t1 + 2) >> 2)
    ext = (2.0 * patch_half - 1.0)[:, None, None]                # (N, 1, 1)
    i0 = torch.minimum(torch.clamp(s0[:, None, :], min=0.0), ext)
    i1 = torch.minimum(torch.clamp(s0[:, None, :] + 1.0, min=0.0), ext)
    ix0 = (origin_x[:, :, None] + i0).long()                     # (N, L, S)
    ix1 = (origin_x[:, :, None] + i1).long()
    iy0 = (origin_y[:, :, None] + i0).long()
    iy1 = (origin_y[:, :, None] + i1).long()
    r0, r1 = rows_at(iy0), rows_at(iy1)
    c00 = cols_at(r0, ix0).int()
    c01 = cols_at(r0, ix1).int()
    c10 = cols_at(r1, ix0).int()
    c11 = cols_at(r1, ix1).int()
    ax1 = torch.round(frac * 2048.0).int()[:, :, None, :]        # (N,1,1,S)
    ay1 = torch.round(frac * 2048.0).int()[:, :, :, None]        # (N,1,S,1)
    ax0, ay0 = 2048 - ax1, 2048 - ay1
    h0 = c00 * ax0 + c01 * ax1
    h1 = c10 * ax0 + c11 * ax1
    t = (((h0 >> 4) * ay0) >> 16) + (((h1 >> 4) * ay1) >> 16)
    return torch.clamp((t + 2) >> 2, 0, 255).float()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16, held in float32."""
    return t.bfloat16().float()


def _split_product(a: torch.Tensor, b: torch.Tensor,
                   b_rounded: bool = False) -> torch.Tensor:
    """a @ b from bfloat16 parts, a = a_hi + a_lo and b = b_hi + b_lo:
    a_hi b_lo + a_lo b_hi + a_hi b_hi (JAX's bfloat16 x 3; the a_hi b_lo
    term is dropped when ``b`` already holds bfloat16 values). Each part is
    held in float32 and multiplied on the TF32 tensor cores, which take a
    bfloat16 value exactly, so the products are exact and only the float32
    sums round; the CPU forms the same products in float32.
    (``torch.matmul`` on bfloat16 tensors would round the sums to bfloat16
    as well.)"""
    a_hi = _bf16(a)
    b_hi = b if b_rounded else _bf16(b)
    with tf32_matmul():
        out = torch.matmul(_bf16(a - a_hi), b_hi)
        if not b_rounded:
            out += torch.matmul(a_hi, _bf16(b - b_hi))
        return out + torch.matmul(a_hi, b_hi)


def extract_patches_dense(images: torch.Tensor, image_indices: torch.Tensor,
                          centers_x: torch.Tensor, centers_y: torch.Tensor,
                          patch_half: torch.Tensor, out_size: int,
                          quantize: bool = True,
                          sampling: str = "exact") -> torch.Tensor:
    """Sample (N, L, S, S) float32 patches as two dense tent products.

    The bilinear sample at coordinate a is sum_r tent(a - r) * img[r], and
    rows / columns outside the image carry no tent, which gives the zero
    border; so each patch is Ty @ img @ Tx^T with (S, H) and (S, W) tent
    matrices. Arguments as for ``extract_patches``; the image of each sample
    is gathered whole (N x H x W float32), so chunk large batches.

    quantize: 11-bit tent coefficients and a rounded, clamped result, the
    float form of the uint8 resize (not its truncating shifts, which
    ``extract_patches`` reproduces: the two differ by one grey level on
    some pixels). sampling: ``exact``, ``high`` (within 0.006 grey levels
    of exact before rounding) or ``fast`` (bfloat16 tents, which hold no
    11-bit grid, and images; within one grey level).
    """
    if sampling not in SAMPLINGS:
        raise ValueError(f"unknown sampling mode: {sampling!r} "
                         f"(expected one of {SAMPLINGS})")
    n, l = centers_x.shape
    h, w = images.shape[1], images.shape[2]
    s = out_size
    dev = centers_x.device
    d = torch.arange(s, dtype=torch.float32, device=dev)
    # a tensor divisor: a true quotient on CUDA too, as in JAX
    scale = 2.0 * patch_half / torch.tensor(float(s), device=dev)
    src = (d[None, :] + 0.5) * scale[:, None] - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0),
                        2.0 * patch_half[:, None] - 1.0)        # (N, S)
    ax = (torch.round(centers_x) - patch_half[:, None])[:, :, None] \
        + src[:, None, :]                                        # (N, L, S)
    ay = (torch.round(centers_y) - patch_half[:, None])[:, :, None] \
        + src[:, None, :]

    def tents(coords, size):
        iota = torch.arange(size, dtype=torch.float32, device=dev)
        t = torch.clamp(1.0 - (coords[..., None] - iota).abs(), min=0.0)
        if sampling == "fast":
            return _bf16(t)
        if quantize:
            return torch.round(t * _CV_RESIZE_COEF) * (1.0 / _CV_RESIZE_COEF)
        return t

    ty = tents(ay, h).reshape(n, l * s, h)                       # (N, LS, H)
    txt = tents(ax, w).transpose(-1, -2)                         # (N, L, W, S)
    imgs = images[image_indices.long()].float()                  # (N, H, W)
    if sampling == "exact":
        with float32_matmul():
            rows = torch.matmul(ty, imgs).reshape(n, l, s, w)
            out = torch.matmul(rows, txt)
    elif sampling == "high":
        rows = _split_product(ty, imgs).reshape(n, l, s, w)
        out = _split_product(rows, txt)
    else:
        # bfloat16 tents and pixels, one exact product; the float32 rows
        # then meet the bfloat16 column tents in two
        with tf32_matmul():
            rows = torch.matmul(ty, _bf16(imgs)).reshape(n, l, s, w)
        out = _split_product(rows, txt, b_rounded=True)
    if quantize:
        out = torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)
    return out


def rgb_to_gray_u8(rgb) -> np.ndarray:
    """OpenCV-parity RGB -> gray for uint8 images:
    (R*4899 + G*9617 + B*1868 + 8192) >> 14. rgb: (..., 3) uint8."""
    rgb = np.asarray(rgb)
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def load_gray_image(path, device=None) -> np.ndarray:
    """Load an image file as (H, W) float32 gray in [0, 255], as the JAX
    package's ``load_gray_image`` (PIL's mode L as it is, every other
    mode through RGB with OpenCV's grey): PNG, JPEG, BMP, PNM (grey PFM
    too), TIFF, GIF, WebP (lossless or lossy) or JPEG 2000 (JP2 or a raw
    codestream), the format read from the magic bytes
    (``io/image.read_gray``).

    A JPEG's or a JPEG-compressed TIFF's pixel stage runs on ``device``:
    the card (kernel J1, ``ops/jpeg.py``) unless the caller passes
    ``device="cpu"``; with no card and no device it raises. So does a
    lossy WebP's (kernels W1-W3, ``ops/webp.py``, after the host entropy
    stage), and a JPEG 2000 file's (kernels D1 and M1, ``ops/j2k.py``,
    after the host tier-2 and tier-1 stage). A lossless WebP decodes on
    the host, by the C++ decoder for
    the card and its Python twin for the CPU, and so do a TIFF's CCITT
    RLE / Group 3 / Group 4 and Zstandard strips (``csrc/tiff_decode.cu``
    or ``io/ccitt.py`` / ``io/zstd.py``; with no card and no device they
    raise too). TIFF is read classic or BigTIFF, YCbCr under every
    lossless compression as PIL converts it. Every other format decodes
    on the host. Decoding errors raise ``ValueError`` naming the file."""
    from superviseddescent_tpu_torch.io.image import read_gray
    return read_gray(path, device).astype(np.float32)


def stack_images(gray_images, dtype=None, pad_width_to=1,
                 pad_height_to=None):
    """Zero-pad (H_i, W_i) images into one (I, Hmax, Wmax) numpy stack.

    Returns (stack, sizes) with sizes (I, 2) [h, w]. pad_width_to rounds
    the width up to a multiple (128 enables the stepped detector's
    rows-only crop); pad_height_to defaults to 32 when the width is
    128-padded, else 1, as in the JAX package.
    """
    dtype = dtype or np.float32
    if pad_height_to is None:
        pad_height_to = 32 if pad_width_to % 128 == 0 else 1
    hmax = max(im.shape[0] for im in gray_images)
    hmax = -(-hmax // pad_height_to) * pad_height_to
    wmax = max(im.shape[1] for im in gray_images)
    wmax = -(-wmax // pad_width_to) * pad_width_to
    stack = np.zeros((len(gray_images), hmax, wmax), dtype)
    sizes = np.zeros((len(gray_images), 2), np.int32)
    for i, im in enumerate(gray_images):
        stack[i, :im.shape[0], :im.shape[1]] = np.asarray(im, dtype)
        sizes[i] = im.shape
    return stack, sizes
