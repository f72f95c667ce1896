"""K3-K6: the fused RCR kernels, hand-written in CUDA. K3 and K4 run the
whole cascade in one launch (serving); K5 and K6 extract one level's feature
rows in one launch (training).

Replace the TPU kernels ``superviseddescent_tpu/ops/cascade_pallas.py::
detect_cascade_fused_frames`` (K3, ``_cascade_frames_kernel``) and
``detect_cascade_fused`` (K4, ``_cascade_kernel``). For every face, every
level of the cascade runs inside one thread block: per landmark the
IED-adaptive patch is sampled from the face's window, described with a
fast-class Uoctti HOG, and the level's regressor is applied to the features;
then the landmark row is updated; nothing of a face leaves the chip between
levels. K3 reads each face's pixels straight from the uint8 frame stack at
(frame, row, column) origins; K4 reads pre-cropped bfloat16 windows. Both
are one templated kernel (``csrc/cascade_fused.cu``), each with its own
entry point and launch count.

Numerics (the serving "fast" class of the JAX kernels):
  * sampling is K2's fast, transposed, optionally quantised sampling
    (``ops/patches_window.py``): bf16 tents, the x pass first, the partial
    rounded to bf16;
  * sector orientation binning (O = 4), the f32 gradient magnitude rounded
    to bf16;
  * a separable cell splat: the x contraction with the bf16 1-D tent and an
    f32 sum, the (2O, C, S) partial rounded to bf16, then the y contraction
    with the bf16 tent and an f32 sum. The tent is the float64 tent rounded
    to float32 and then to bf16, as the JAX kernel rounds it;
  * K1's block normalisation and Uoctti channels;
  * the feature row rounded to bf16, times the bf16 weights with f32 sums;
    then ``x -= update * IED``, with the IED of the row before the update.

Both splat contractions sum in increasing pixel order in the kernel and in
the plain twin (``detect_cascade_fused_reference``); the products are exact
in float32, so the bf16-rounded partials, the cell histograms and the bf16
features of kernel and twin are equal bit for bit. They differ only in the
regressor sums (the kernel sums each slice of a weight row's words over the
level, then adds the bias weight and the slices' sums, in one order for
every launch plan).

The port's kernel takes the regressors in the reference's Matlab feature
order ``lm*(D*C*C) + d*C*C + cx*C + cy``, bias last; ``prepare_weights``
turns them once into the kernel's layout (transposed, bf16, rows padded to
a multiple of 8). None of the TPU layout (lane segments, the cx-major
weight permutation, faces per grid step) is carried over.

What bounds the kernels on the H100, and what the design does: the work per
face is small (a few MFLOP of float32 per level) and the bytes are the
window pixels under the patches plus the weights, which stay in the 50 MB
L2 cache; the operation bound is the larger, and the float32 work of
sampling and HOG (each pixel's four byte gathers above all) takes most of
the time. A block holds F faces and runs the landmark bodies of F faces x
GL landmarks at once, phase by phase (6 barriers per group of GL
landmarks, not per landmark), in compact exact buffers (uint8 patches when
quantised, bf16 magnitudes and x partials); after each group the threads
apply the group's slice of the regressor to the F faces together, so each
16-byte weight load serves F faces and no feature row is kept.
``launch_plan`` picks F, GL and the block size from the batch, the shared
memory and the blocks an SM holds: the plan with the most landmarks in
flight per face that still runs the batch in one wave (one face per
1,024-thread block up to one face per SM, as in tracking; then one face
per 256-thread block with four, then two, landmarks in flight; then two
faces per block with two, then one), and the last of these beyond. Device memory sees only the pixels, the
weights and the two rows, and a detect call is one launch.

K5 and K6 replace ``cascade_pallas.py::extract_features_fused_frames``
(K5, ``_features_frames_kernel``) and ``extract_features_fused`` (K6,
``_features_kernel``): the per-landmark arithmetic of K3/K4 for ONE level,
with the patches always quantised, and the float32 channels written to
device memory *before* the bf16 rounding that K3/K4 apply for their GEMV.
Rows are exactly (N, L*D*C*C + 1) float32 in the reference's Matlab order,
bias 1 last: no lane segments, no padded width, no compact column order, so
a solve on these rows gives regressors in the reference's order. What
bounds them on the H100: the float32 operations of sampling and HOG (the
bytes are the tapped window pixels plus the N x F float32 rows written
once, 397 MB at 11,264 RCR-22 samples). The design
(``csrc/features_fused.cu``): a block holds F samples and runs their
landmarks in groups of GL, each phase over all F x GL bodies with one
barrier after it (taps, sampling, gradients with the x contraction, y
contraction, channels, row stores), so a sample's IED and patch half are
computed once and the level's tent staged once per block, and the small
phases fill the block. Buffers are compact and exact (uint8 patches, bf16 x
partials, aliased where their lives do not overlap). The gradients are
formed where the x contraction needs them, a thread per patch row, and go
straight into per-bin accumulators; a group's channels are staged and
stored as 16-byte words where the odd row width allows.
``features_launch_plan`` picks F, GL and the block size from the patch
side, the shared memory, the blocks an SM holds and the batch. Every
intermediate stays in shared memory, so device memory sees only the pixels
and the rows.

Intended differences from the JAX kernels: any number of levels (the JAX
ops take at most 4); a face whose frame index or window origin lies outside
the frame stack gets a row of NaN from the kernel instead of a clamped read
(host-side index arrays raise ``ValueError`` before upload instead); K5/K6
take any N (no padding to a multiple of faces per step), N = 0 included.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from superviseddescent_tpu_torch.ops.hog import (
    HogVariant, _tent_1d, hog_dimension, hog_num_cells)
from superviseddescent_tpu_torch.ops.hog_flat import (
    sector_bins, uoctti_channels)
from superviseddescent_tpu_torch.ops.patches_window import (
    LANE_ALIGN, SUBLANE_ALIGN, _prepare, max_patch_half, max_patch_half_x,
    sample_patches_window_reference)
from superviseddescent_tpu_torch.utils.landmarks import ied_from_rows

#: alignment grain of the fused detector's window origins (rows, columns):
#: it decides which columns a window holds, so it is part of the contract
FRAME_ROW_ALIGN = 32
FRAME_COL_ALIGN = 128

_MAX_SIZE = 96               # largest patch side the kernel's tables hold
_MAX_SHARED = 232448         # dynamic shared memory one block may use
_SM_SHARED = 233472          # shared memory of one H100 SM
_BLOCK_RESERVED = 1024       # of it, reserved by the card for each block
_THREADS = 256               # threads of a K3 / K4 block that shares its SM
_MAX_FACES = 2               # faces per K3 / K4 block (kMaxFaces)
# K3 / K4's launch plans, (faces per block, landmarks per group, threads),
# in launch_plan's order; group 0: the fewest groups that fit
_PLANS = ((1, 0, 1024), (1, 4, _THREADS), (1, 2, _THREADS),
          (_MAX_FACES, 2, _THREADS), (_MAX_FACES, 1, _THREADS))
_GEMV_SLICES = 5             # slices of a weight row (kGemvSlices)
_ORIENTATIONS = 4            # the sector binning's O
_CHUNK = 256                 # faces per step of the plain twin
_NAN = float("nan")


def validate_fused_config(num_landmarks: int, num_cells: int,
                          num_bins: int, variant) -> None:
    """Raise a named error for configurations the fused kernels cannot run:
    the sector orientation binning is specialised to 4 bins (8 sectors)
    and the channel math is Uoctti's. Any landmark and cell count runs (the
    JAX kernel's limit of 128 cell columns is a TPU lane-segment limit);
    the shared memory a model needs is checked at launch."""
    if HogVariant(variant) != HogVariant.Uoctti:
        raise ValueError("fused kernel supports the Uoctti variant only")
    if num_bins != _ORIENTATIONS:
        raise ValueError(
            "fused kernel's sector orientation binning is specialised to "
            f"num_bins=4 (8 sectors); got num_bins={num_bins} — use the "
            "stepped window detector for other bin counts")


@functools.lru_cache(maxsize=None)
def _cell_tent(size: int, cell_size: int) -> np.ndarray:
    """(S, C) 1-D cell tent with zeroed border pixels, float64 rounded to
    float32 and then to bf16 (as float32 values)."""
    w32 = torch.from_numpy(_tent_1d(size, cell_size).astype(np.float32))
    return w32.bfloat16().float().numpy()


@dataclass(frozen=True)
class FusedWeights:
    """Per-level regressors in the kernel's layout: ``tensor`` is
    (R, 2L, Fp) bfloat16, row k of level r holding output k's weights over
    the F features in reference order, zero-padded to Fp (a multiple of 8)."""
    tensor: torch.Tensor
    num_features: int

    @property
    def levels(self) -> int:
        return self.tensor.shape[0]

    def reference(self, level: int) -> torch.Tensor:
        """Level ``level``'s (F, 2L) float32 weights (bf16 values), in
        reference order."""
        return self.tensor[level, :, :self.num_features].float().t()


def prepare_weights(weights, device=None) -> FusedWeights:
    """Per-level (F, 2L) regressors in reference order -> FusedWeights on
    ``device`` (default: the first weight's device). Done once, when a
    detector is built; a FusedWeights passes through unchanged."""
    if isinstance(weights, FusedWeights):
        return weights
    ws = [torch.as_tensor(w) for w in weights]
    if not ws or any(w.ndim != 2 or w.shape != ws[0].shape for w in ws):
        raise ValueError("weights: one (F, 2L) array per level, all of one "
                         "shape")
    device = torch.device(device) if device is not None else ws[0].device
    f, p = ws[0].shape
    fp = -(-f // 8) * 8
    out = torch.zeros((len(ws), p, fp), dtype=torch.bfloat16, device=device)
    for i, w in enumerate(ws):
        out[i, :, :f] = w.to(device, torch.float32).t().bfloat16()
    return FusedWeights(out, f)


def _check_config(n_landmarks, weights: FusedWeights, ry, rx, levels,
                  cell_sizes, num_orientations, dims, r_idx, l_idx):
    """Validate the static configuration; returns the cell count C."""
    levels = tuple(tuple(lv) for lv in levels)
    if not levels or len(cell_sizes) != len(levels):
        raise ValueError("need one cell size per level and at least one "
                         "level")
    if weights.levels != len(levels):
        raise ValueError(f"{weights.levels} weight levels for "
                         f"{len(levels)} cascade levels")
    if num_orientations != _ORIENTATIONS or dims != hog_dimension(
            HogVariant.Uoctti, num_orientations):
        raise ValueError("fused kernel: Uoctti with num_orientations=4 "
                         f"(16 dims) only; got {num_orientations}, {dims}")
    cells = {hog_num_cells(lv[0], cs) for lv, cs in zip(levels, cell_sizes)}
    if len(cells) != 1:
        raise ValueError("fused kernel requires the same cell count at "
                         "every level")
    c = cells.pop()
    f = n_landmarks * dims * c * c + 1
    if weights.tensor.shape[1] != 2 * n_landmarks or weights.num_features != f:
        raise ValueError(f"weights are ({weights.num_features}, "
                         f"{weights.tensor.shape[1]}); expected ({f}, "
                         f"{2 * n_landmarks})")
    for level in levels:
        _check_geometry(level, ry, rx)
    _check_eyes(n_landmarks, r_idx, l_idx)
    return c


def _check_geometry(level, ry, rx):
    """One level's patch side and sub-windows against the window shape."""
    s, w, wx, _ = level
    if not 3 <= s <= _MAX_SIZE:
        raise ValueError(f"patch size {s} outside 3..{_MAX_SIZE}")
    if not (w <= ry and w % SUBLANE_ALIGN == 0 and ry % SUBLANE_ALIGN == 0):
        raise ValueError(
            f"row sub-window W={w} and window height RY={ry} must both "
            f"be multiples of {SUBLANE_ALIGN} with W <= RY")
    if not (wx <= rx and (wx == rx or (wx % LANE_ALIGN == 0
                                       and rx % LANE_ALIGN == 0))):
        raise ValueError(
            f"column sub-window WX={wx} requires WX and the window width "
            f"RX={rx} to be multiples of {LANE_ALIGN} (or WX == RX)")


def _check_eyes(n_landmarks, r_idx, l_idx):
    if not r_idx or not l_idx or not all(
            0 <= i < n_landmarks for i in tuple(r_idx) + tuple(l_idx)):
        raise ValueError("eye indices must be non-empty and name landmarks")


# ------------------------------------------------------------------ #
# The plain twin
# ------------------------------------------------------------------ #
def level_patch_half(x, level, ry, rx, r_idx, l_idx):
    """IED of each row and the level's patch half-size: round(rel * IED /
    2) half up, at least 1, capped by what the sub-windows cover."""
    _, w, wx, rel = level
    ied = ied_from_rows(x, r_idx, l_idx)
    phw = torch.clamp(torch.floor(rel * ied / 2.0 + 0.5), min=1.0)
    phw = torch.clamp(phw, max=max_patch_half(w))
    if wx != rx:
        phw = torch.clamp(phw, max=max_patch_half_x(wx))
    return ied, phw


def level_patches(windows, x, level, phw, quantize):
    """(N, L, S, S) patches [x, y] of one level: K2's fast, transposed
    sampling (its plain twin) at the rows' rounded centres."""
    s, w, wx, _ = level
    l = x.shape[1] // 2
    oxy, sp = _prepare(x[:, :l], x[:, l:], phw, s)
    return sample_patches_window_reference(
        windows, oxy, sp, s, w, wx, quantize, "fast", True, torch.float32)


def fused_hog_cells(patches_t, cell_size):
    """(N, L, S, S) patches [x, y] -> (N, L, 2O, C, C) cell histograms
    [bin, cx, cy]: sector bins, bf16 magnitudes, and the separable splat,
    each contraction summed in increasing pixel order."""
    img = patches_t.transpose(2, 3)                             # [y, x]
    n, l, s, _ = img.shape
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., 1:-1, 1:-1] = img[..., 1:-1, 2:] - img[..., 1:-1, :-2]
    gy[..., 1:-1, 1:-1] = img[..., 2:, 1:-1] - img[..., :-2, 1:-1]
    mag = torch.sqrt(gx * gx + gy * gy).bfloat16().float()
    bins = sector_bins(gx, gy)
    o2 = 2 * _ORIENTATIONS
    planes = torch.where(
        bins[:, :, None] == torch.arange(o2, device=img.device)[:, None,
                                                                None],
        mag[:, :, None], torch.zeros((), device=img.device))  # (N,L,2O,y,x)
    tent = torch.from_numpy(_cell_tent(s, cell_size)).to(img.device)
    c = tent.shape[1]
    part = torch.zeros((n, l, o2, c, s), device=img.device)  # [bin, cx, y]
    for xi in range(s):
        part = part + tent[xi][:, None] * planes[..., xi][:, :, :, None, :]
    part = part.bfloat16().float()
    cells = torch.zeros((n, l, o2, c, c), device=img.device)
    for yi in range(s):
        cells = cells + part[..., yi][..., None] * tent[yi]
    return cells


def uoctti_from_cells(cells):
    """(..., 2O, C, C) cell histograms [bin, cx, cy] -> (..., D, C, C)
    Uoctti channels. A block sum adds the x pair at each y, then the two
    y sums, as the JAX kernel's separable block-sum products do."""
    o = cells.shape[-3] // 2
    c = cells.shape[-1]
    ha, hb = cells[..., :o, :, :], cells[..., o:, :, :]
    energy = torch.zeros_like(cells[..., 0, :, :])
    for k in range(o):
        f = ha[..., k, :, :] + hb[..., k, :, :]
        energy = energy + f * f
    idx = torch.arange(c, device=cells.device)
    pairs = {-1: (torch.clamp(idx - 1, min=0), idx),
             0: (idx, torch.clamp(idx + 1, max=c - 1))}
    factors = []
    for ax, ay in ((-1, -1), (0, -1), (-1, 0), (0, 0)):
        x0, x1 = pairs[ax]
        y0, y1 = pairs[ay]
        xsum = energy[..., x0, :] + energy[..., x1, :]
        total = xsum[..., y0] + xsum[..., y1]
        factors.append(1.0 / torch.sqrt(total + 1e-4))
    channels = uoctti_channels(
        factors, [ha[..., k, :, :] for k in range(o)],
        [hb[..., k, :, :] for k in range(o)])
    return torch.stack(channels, dim=-3)


def _features_chunk(windows, x, level, cell_size, r_idx, l_idx, quantize):
    """One level's (N, F) float32 feature rows in reference order, bias 1
    last, and the rows' IED."""
    n, ry, rx = windows.shape
    ied, phw = level_patch_half(x, level, ry, rx, r_idx, l_idx)
    patches = level_patches(windows, x, level, phw, quantize)
    chan = uoctti_from_cells(fused_hog_cells(patches, cell_size))
    feats = torch.cat([chan.reshape(n, -1),
                       torch.ones((n, 1), device=x.device)], dim=1)
    return feats, ied


def _cascade_chunk(windows, x, weights, levels, cell_sizes, r_idx, l_idx,
                   quantize):
    for li, level in enumerate(levels):
        feats, ied = _features_chunk(windows, x, level, cell_sizes[li],
                                     r_idx, l_idx, quantize)
        upd = torch.matmul(feats.bfloat16().float(), weights.reference(li))
        x = x - upd * ied[:, None]
    return x


def detect_cascade_fused_reference(windows, x0, weights, levels, cell_sizes,
                                   r_idx, l_idx, quantize=True):
    """Plain PyTorch twin of K4 (and, after the crop, of K3) on any device:
    (N, RY, RX) windows (pixel values as bf16), (N, 2L) rows in window
    coordinates -> (N, 2L) float32 rows. ``weights``: FusedWeights."""
    levels = tuple(tuple(lv) for lv in levels)
    if windows.dtype != torch.bfloat16:
        windows = windows.bfloat16()
    x0 = x0.float()
    out = [_cascade_chunk(windows[a:a + _CHUNK], x0[a:a + _CHUNK], weights,
                          levels, cell_sizes, r_idx, l_idx, quantize)
           for a in range(0, x0.shape[0], _CHUNK)]
    return torch.cat(out) if out else x0.clone()


def _frame_windows(frames, idx, oy, ox, window_shape):
    """(N, RY, RX) windows cut from the frame stack at the given origins,
    and which faces' index and origin lie inside it (out-of-range ones are
    read clamped and flagged)."""
    n_img, h, w = frames.shape
    ry, rx = window_shape
    valid = ((idx >= 0) & (idx < n_img) & (oy >= 0) & (oy + ry <= h)
             & (ox >= 0) & (ox + rx <= w))
    i = idx.long().clamp(0, n_img - 1)[:, None, None]
    rows = (oy.long().clamp(0, h - ry)[:, None]
            + torch.arange(ry, device=frames.device))[:, :, None]
    cols = (ox.long().clamp(0, w - rx)[:, None]
            + torch.arange(rx, device=frames.device))[:, None, :]
    return frames[i, rows, cols], valid


def detect_cascade_fused_frames_reference(frames, image_indices, oy, ox, x0,
                                          weights, window_shape, levels,
                                          cell_sizes, r_idx, l_idx,
                                          quantize=True):
    """Plain PyTorch twin of K3 on any device: the windows are cut from the
    frame stack, then the cascade runs as in K4's twin. A face whose index
    or origin lies outside the stack gets a row of NaN, as in the kernel."""
    out = []
    for a in range(0, x0.shape[0], _CHUNK):
        sl = slice(a, a + _CHUNK)
        windows, valid = _frame_windows(frames, image_indices[sl], oy[sl],
                                        ox[sl], window_shape)
        rows = _cascade_chunk(windows.bfloat16(), x0[sl].float(), weights,
                              tuple(tuple(lv) for lv in levels), cell_sizes,
                              r_idx, l_idx, quantize)
        out.append(torch.where(valid[:, None], rows,
                               torch.full((), _NAN, device=rows.device)))
    return torch.cat(out) if out else x0.float().clone()


def _num_features(n_landmarks, level, cell_size):
    c = hog_num_cells(level[0], cell_size)
    return n_landmarks * hog_dimension(HogVariant.Uoctti,
                                       _ORIENTATIONS) * c * c + 1


def extract_features_fused_reference(windows, x, level, cell_size, r_idx,
                                     l_idx):
    """Plain PyTorch twin of K6 (and, after the crop, of K5) on any device:
    (N, RY, RX) windows (pixel values as bf16), (N, 2L) rows in window
    coordinates -> (N, F) float32 feature rows of one level, reference
    order, bias 1 last."""
    level = tuple(level)
    if windows.dtype != torch.bfloat16:
        windows = windows.bfloat16()
    x = x.float()
    out = [_features_chunk(windows[a:a + _CHUNK], x[a:a + _CHUNK], level,
                           cell_size, r_idx, l_idx, True)[0]
           for a in range(0, x.shape[0], _CHUNK)]
    if out:
        return torch.cat(out)
    return torch.zeros((0, _num_features(x.shape[1] // 2, level, cell_size)),
                       device=x.device)


def extract_features_fused_frames_reference(frames, image_indices, oy, ox, x,
                                            window_shape, level, cell_size,
                                            r_idx, l_idx):
    """Plain PyTorch twin of K5 on any device: the windows are cut from the
    frame stack, then the rows are K6's twin's. A sample whose index or
    origin lies outside the stack gets a row of NaN, as in the kernel."""
    level = tuple(level)
    out = []
    for a in range(0, x.shape[0], _CHUNK):
        sl = slice(a, a + _CHUNK)
        windows, valid = _frame_windows(frames, image_indices[sl], oy[sl],
                                        ox[sl], window_shape)
        rows, _ = _features_chunk(windows.bfloat16(), x[sl].float(), level,
                                  cell_size, r_idx, l_idx, True)
        out.append(torch.where(valid[:, None], rows,
                               torch.full((), _NAN, device=rows.device)))
    if out:
        return torch.cat(out)
    return torch.zeros((0, _num_features(x.shape[1] // 2, level, cell_size)),
                       device=x.device)


# ------------------------------------------------------------------ #
# The kernels
# ------------------------------------------------------------------ #
@functools.lru_cache(maxsize=None)
def _level_tables(levels, cell_sizes, r_idx, l_idx, device):
    """Device tables of the static configuration: per level (S, W, WX,
    cell size, tent offset) int32, the relative patch sizes, the bf16
    tents (S, C) back to back, and the eye indices (nr, nl, r..., l...)."""
    ints, rels, tents, off = [], [], [], 0
    for (s, w, wx, rel), cs in zip(levels, cell_sizes):
        tent = _cell_tent(s, cs)
        ints += [s, w, wx, cs, off]
        rels.append(rel)
        tents.append(tent.ravel())
        off += tent.size
    eyes = [len(r_idx), len(l_idx), *r_idx, *l_idx]
    return (torch.tensor(ints, dtype=torch.int32, device=device),
            torch.tensor(rels, dtype=torch.float32, device=device),
            torch.from_numpy(np.concatenate(tents)).to(device),
            torch.tensor(eyes, dtype=torch.int32, device=device))


def _aligned(nbytes):
    return -(-nbytes // 16) * 16


def _aligned_sum(sizes):
    return sum(_aligned(b) for b in sizes)


def _shared_bytes(l, c, s, quantize, faces, group, threads=_THREADS):
    """Dynamic shared memory of one K3 / K4 block of ``threads`` threads,
    ``faces`` faces and ``faces * group`` landmark bodies, as
    csrc/cascade_fused.cu's Layout lays it out: the level's tent, per face
    the landmark row, the GEMV's partial sums (per slice of the weight words
    and output row), IED and patch half and window, per body its taps
    (shared with the x contraction's accumulators, 8 per thread), its patch
    (uint8 when quantised, else float32; then the bf16 x partials), its
    bf16 magnitudes (then the cell histograms and energy terms), its bins and
    its 16 * C * C bf16 features."""
    cc, bodies = c * c, faces * group
    slices = _GEMV_SLICES
    block = _aligned_sum([s * c * 4, faces * 2 * l * 4,
                          slices * faces * 2 * l * 4, faces * 2 * 4,
                          faces * 8, faces * 8, bodies * 2 * 4])
    taps = bodies * _aligned_sum([s * 4] * 6)
    block += _aligned(max(taps, 8 * threads * 4))
    patch = s * s * (1 if quantize else 4)
    body = _aligned_sum([max(patch, 8 * c * s * 2),
                         max(s * s * 2, _aligned_sum([8 * cc * 4,
                                                      4 * cc * 4])),
                         s * s, 16 * cc * 2])
    return block + bodies * body


class LaunchPlan(NamedTuple):
    """How K3 / K4 cut a batch: ``faces`` per block, ``group`` landmarks of
    each face in flight, ``threads`` per block, and the block's shared
    memory in bytes."""
    faces: int
    group: int
    threads: int
    shared_bytes: int


def blocks_per_sm(plan: LaunchPlan) -> int:
    """Blocks of ``plan`` that one SM holds at once: four of 256 threads
    (the kernel's register budget), one of 1,024, fewer where their shared
    memory (and the 1 KB the card reserves per block) exceeds the SM's."""
    return min(4 if plan.threads == _THREADS else 1,
               _SM_SHARED // (plan.shared_bytes + _BLOCK_RESERVED))


@functools.lru_cache(maxsize=4096)
def launch_plan(n, l, c, s, quantize, sms) -> LaunchPlan:
    """K3 / K4's launch plan for N faces of L landmarks at the largest
    patch side S on a card of ``sms`` SMs: the first plan of ``_PLANS``
    that fits in a block and runs the batch in one wave (every block
    resident at once), else the last that fits. In that order: one face
    per 1,024-thread block in the fewest groups of landmarks that fit, of
    even size (RCR-22: two groups of 11), the shortest chain for a face;
    one face per 256-thread block with four, then two, landmarks in
    flight; two faces per 256-thread block, which share each weight load,
    with two, then one, landmarks in flight. Raises ValueError when not
    even one body fits."""
    fitting = []
    for faces, group, threads in _PLANS:
        if group == 0:
            # the fewest groups that fit, then the landmarks spread evenly
            fits = [g for g in range(1, l + 1) if _shared_bytes(
                l, c, s, quantize, faces, g, threads) <= _MAX_SHARED]
            if not fits:
                continue
            group = -(-l // -(-l // fits[-1]))
        group = min(group, l)
        shared = _shared_bytes(l, c, s, quantize, faces, group, threads)
        if shared > _MAX_SHARED:
            continue
        plan = LaunchPlan(faces, group, threads, shared)
        if -(-n // faces) <= blocks_per_sm(plan) * sms:
            return plan
        fitting.append(plan)
    if fitting:
        return fitting[-1]
    raise ValueError(
        f"{l} landmarks at patch size {s} with {c} cells need "
        f"{_shared_bytes(l, c, s, quantize, 1, 1)} bytes of shared memory "
        f"for one face and one landmark body; one block has {_MAX_SHARED}")


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_args(x0, weights, levels, cell_sizes, r_idx, l_idx, ry, rx, c,
                 quantize, device):
    """The C entry points' arguments after the window source: x0, out,
    the tables, the shapes and ``launch_plan``'s plan."""
    l = x0.shape[1] // 2
    levels = tuple(tuple(float(v) if i == 3 else int(v)
                         for i, v in enumerate(lv)) for lv in levels)
    level_i, level_rel, tents, eyes = _level_tables(
        levels, tuple(int(cs) for cs in cell_sizes), tuple(r_idx),
        tuple(l_idx), device)
    fp = weights.tensor.shape[2]
    s_max = max(lv[0] for lv in levels)
    faces, group, threads, _ = launch_plan(x0.shape[0], l, c, s_max,
                                           bool(quantize), _sm_count(device))
    x0 = x0.to(device, torch.float32).contiguous()
    if weights.tensor.device != x0.device:
        raise ValueError("weights must lie on the windows' device")
    out = torch.empty_like(x0)
    args = [ctypes.c_void_p(x0.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(weights.tensor.data_ptr()),
            ctypes.c_void_p(level_i.data_ptr()),
            ctypes.c_void_p(level_rel.data_ptr()),
            ctypes.c_void_p(tents.data_ptr()),
            ctypes.c_void_p(eyes.data_ptr()),
            x0.shape[0], len(levels), l, c, ry, rx, fp, int(quantize),
            s_max, faces, group, threads,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
    return out, args


def _check_host_indices(name, values, low, high):
    """Range check of an index array that lies on the host, before it is
    uploaded: raises ValueError naming the first entry outside
    [low, high]."""
    arr = np.asarray(values.cpu() if isinstance(values, torch.Tensor)
                     else values)
    bad = np.flatnonzero((arr < low) | (arr > high))
    if bad.size:
        raise ValueError(f"{name}[{bad[0]}] = {arr[bad[0]]} is outside "
                         f"[{low}, {high}]")


def _on_host(t) -> bool:
    return not (isinstance(t, torch.Tensor) and t.device.type == "cuda")


def detect_cascade_fused_frames(frames: torch.Tensor, image_indices, oy, ox,
                                x0: torch.Tensor, weights, window_shape,
                                levels, cell_sizes,
                                num_orientations: int, dims: int,
                                r_idx, l_idx,
                                quantize: bool = True) -> torch.Tensor:
    """K3: the whole cascade with each face's window read straight from the
    uint8 frame stack.

    frames: (n_img, H, W) uint8. image_indices, oy, ox: (N,) integers, the
    face's frame and the top-left corner of its (RY, RX) = window_shape
    window in it. x0: (N, 2L) float32 rows in window coordinates.
    weights: per-level (F, 2L) regressors in reference order, or
    ``prepare_weights``' FusedWeights. levels: per level (S, W, WX,
    relative patch size), W and WX the sampler's sub-window sides
    (WX == RX: the full width). cell_sizes: per level. r_idx / l_idx: the
    eye landmarks of the IED. Returns (N, 2L) float32 rows in window
    coordinates.

    Index arrays on the host are checked before upload (ValueError); on
    the card, a face whose index or origin lies outside the stack gets a
    row of NaN. A CPU frame stack takes the plain twin; a CUDA one launches
    the kernel.
    """
    if frames.ndim != 3 or frames.dtype != torch.uint8:
        raise ValueError("frames must be an (n_img, H, W) uint8 stack")
    n_img, h, w = frames.shape
    ry, rx = (int(v) for v in window_shape)
    if not (ry <= h and rx <= w):
        raise ValueError(f"window {ry}x{rx} exceeds the frames {h}x{w}")
    dev = frames.device
    for name, v, high in (("image_indices", image_indices, n_img - 1),
                          ("oy", oy, h - ry), ("ox", ox, w - rx)):
        if _on_host(v) and dev.type == "cuda":
            _check_host_indices(name, v, 0, high)
    idx, oy, ox = (torch.as_tensor(v).to(dev, torch.int32).contiguous()
                   for v in (image_indices, oy, ox))
    n = x0.shape[0]
    if x0.ndim != 2 or any(v.shape != (n,) for v in (idx, oy, ox)):
        raise ValueError("x0 must be (N, 2L) and the indices and origins (N,)")
    weights = prepare_weights(weights, dev)
    c = _check_config(x0.shape[1] // 2, weights, ry, rx, levels, cell_sizes,
                      num_orientations, dims, r_idx, l_idx)
    if dev.type == "cpu":
        return detect_cascade_fused_frames_reference(
            frames, idx, oy, ox, x0.float(), weights, (ry, rx), levels,
            cell_sizes, r_idx, l_idx, quantize)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    frames = frames.contiguous()
    out, args = _launch_args(x0, weights, levels, cell_sizes, r_idx, l_idx,
                             ry, rx, c, quantize, dev)
    if n == 0:
        return out
    from superviseddescent_tpu_torch.ops._build import load_library
    _launch_frames(load_library("cascade_fused"), frames, idx, oy, ox, args)
    detect_cascade_fused_frames.launches += 1
    return out


def _launch_frames(lib, frames, idx, oy, ox, args):
    """K3's launch from ``lib`` (the entry point's build, or a measurement
    build of the same source) with ``_launch_args``' arguments."""
    n_img, h, w = frames.shape
    err = lib.cascade_fused_frames_launch(
        ctypes.c_void_p(frames.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(oy.data_ptr()), ctypes.c_void_p(ox.data_ptr()),
        n_img, h, w, *args)
    if err != 0:
        raise RuntimeError(
            f"cascade_fused_frames kernel launch failed: CUDA error {err}")


detect_cascade_fused_frames.launches = 0


def detect_cascade_fused(windows: torch.Tensor, x0: torch.Tensor, weights,
                         levels, cell_sizes, num_orientations: int,
                         dims: int, r_idx, l_idx,
                         quantize: bool = True) -> torch.Tensor:
    """K4: the whole cascade on pre-cropped (N, RY, RX) windows (bfloat16;
    uint8 and float32 are cast to bfloat16 first). Everything else as
    ``detect_cascade_fused_frames``. A CPU tensor takes the plain twin; a
    CUDA one launches the kernel."""
    if windows.ndim != 3 or x0.ndim != 2 or windows.shape[0] != x0.shape[0]:
        raise ValueError("expected (N, RY, RX) windows and (N, 2L) rows")
    if windows.dtype != torch.bfloat16:
        windows = windows.bfloat16()
    _, ry, rx = windows.shape
    dev = windows.device
    weights = prepare_weights(weights, dev)
    c = _check_config(x0.shape[1] // 2, weights, ry, rx, levels, cell_sizes,
                      num_orientations, dims, r_idx, l_idx)
    if dev.type == "cpu":
        return detect_cascade_fused_reference(
            windows, x0.float(), weights, levels, cell_sizes, r_idx, l_idx,
            quantize)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    windows = windows.contiguous()
    out, args = _launch_args(x0, weights, levels, cell_sizes, r_idx, l_idx,
                             ry, rx, c, quantize, dev)
    if x0.shape[0] == 0:
        return out
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("cascade_fused")
    err = lib.cascade_fused_launch(ctypes.c_void_p(windows.data_ptr()),
                                   *args)
    if err != 0:
        raise RuntimeError(
            f"cascade_fused kernel launch failed: CUDA error {err}")
    detect_cascade_fused.launches += 1
    return out


detect_cascade_fused.launches = 0


# ------------------------------------------------------------------ #
# K5 / K6: one level's feature rows
# ------------------------------------------------------------------ #
_FEATURES_THREADS = (128, _THREADS)  # block sizes K5 / K6 are built for
_X_ACCUMULATORS = 16  # a thread's x contraction sums: 2 cell slots x 8 bins


def _features_shared_bytes(c, s, faces, group, threads):
    """Dynamic shared memory of one K5 / K6 block of ``threads`` threads,
    ``faces`` samples and ``faces * group`` landmark bodies, as
    csrc/features_fused.cu's Layout lays it out (every buffer 16-byte
    aligned): the level's tent, the cell table of the pixel columns
    (accumulator offsets, last flags and weights), one flag, per sample its
    patch half, window and stride, per body its sub-window origin, the x
    contraction's accumulators (16 per thread); per body its taps (an
    offset and two weights per row and column), then its bf16 x partials, and its uint8 patch, then
    its cell histograms, energy terms and float32 channels."""
    cc, bodies = c * c, faces * group
    block = _aligned_sum([s * c * 4, s * 16, s * 8, 4, faces * 4, faces * 8,
                          faces * 8, bodies * 8,
                          _X_ACCUMULATORS * threads * 4])
    taps = 2 * _aligned(s * 16)
    stage = _aligned_sum([8 * cc * 4, 4 * cc * 4, 16 * cc * 4])
    body = (_aligned(max(taps, 8 * c * s * 2))
            + _aligned(max(s * s, stage)))
    return block + bodies * body


def features_blocks_per_sm(plan: LaunchPlan) -> int:
    """Blocks of a K5 / K6 ``plan`` that one SM holds at once: 1,024
    threads (the kernel's register budget of 64 a thread), fewer where
    their shared memory (and the 1 KB the card reserves per block) exceeds
    the SM's."""
    return min(1024 // plan.threads,
               _SM_SHARED // (plan.shared_bytes + _BLOCK_RESERVED))


def _even_groups(l, s, c, threads):
    """The landmark groups of at most one round (``group * s <= threads``)
    that cut L as evenly as their count allows and fit in a block, widest
    first."""
    groups = []
    for rounds in range(-(-l // max(1, min(l, threads // s))), l + 1):
        group = -(-l // rounds)
        if groups and group >= groups[-1]:
            continue
        if _features_shared_bytes(c, s, 1, group, threads) <= _MAX_SHARED:
            groups.append(group)
    return groups


@functools.lru_cache(maxsize=4096)
def features_launch_plan(n, l, c, s, sms) -> LaunchPlan:
    """K5 / K6's launch plan for N samples of L landmarks at patch side S
    with C cells on a card of ``sms`` SMs: one sample per block and its
    landmarks in even groups of at most one round (a group's patch rows fit
    in the block's threads, so the x contraction takes one task per thread).
    Blocks of 128 threads where they hold three patch rows or more and the
    batch fills every SM with them, else of 256; the widest group, unless
    the batch fits the card in one wave only with a narrower one (as the
    windows path's chunks of 512 samples at S = 30 do). Raises ValueError
    when not even one body fits in a block."""
    def plans(threads):
        return [LaunchPlan(1, g, threads,
                           _features_shared_bytes(c, s, 1, g, threads))
                for g in _even_groups(l, s, c, threads)]

    def waves(plan):
        return -(-n // (features_blocks_per_sm(plan) * sms))
    small = plans(128) if 128 // s >= 3 else []
    candidates = small if small and waves(small[0]) > 1 else plans(_THREADS)
    if not candidates:
        raise ValueError(
            f"patch size {s} with {c} cells needs "
            f"{_features_shared_bytes(c, s, 1, 1, _THREADS)} bytes of shared "
            f"memory for one landmark body; one block has {_MAX_SHARED}")
    if waves(candidates[0]) > 1:
        for plan in candidates[1:]:
            if waves(plan) == 1:
                return plan
    return candidates[0]


def _check_level(n_landmarks, ry, rx, level, cell_size, num_orientations,
                 dims, r_idx, l_idx):
    """Validate one level's static configuration; returns the level as
    (int S, int W, int WX, float rel), the cell count C and the row width
    F."""
    if num_orientations != _ORIENTATIONS or dims != hog_dimension(
            HogVariant.Uoctti, num_orientations):
        raise ValueError("fused kernel: Uoctti with num_orientations=4 "
                         f"(16 dims) only; got {num_orientations}, {dims}")
    s, w, wx, rel = level
    level = (int(s), int(w), int(wx), float(rel))
    s = level[0]
    _check_geometry(level, ry, rx)
    _check_eyes(n_landmarks, r_idx, l_idx)
    c = hog_num_cells(s, cell_size)
    if _features_shared_bytes(c, s, 1, 1, min(_FEATURES_THREADS)) \
            > _MAX_SHARED:
        raise ValueError(f"patch size {s} with {c} cells needs more shared "
                         "memory than one block has")
    return level, c, n_landmarks * dims * c * c + 1


def _features_launch_args(x, level, cell_size, r_idx, l_idx, ry, rx, c, f,
                          plan=None):
    """The C entry points' arguments after the window source: x, out, the
    tables, the shapes and ``features_launch_plan``'s (samples per block,
    landmarks per group, threads). ``plan`` overrides it, for
    ``chip_smoke.py``'s sweep and the plan tests only."""
    dev = x.device
    level_i, level_rel, tents, eyes = _level_tables(
        (level,), (int(cell_size),), tuple(int(i) for i in r_idx),
        tuple(int(i) for i in l_idx), dev)
    n, l = x.shape[0], x.shape[1] // 2
    if plan is None:
        plan = features_launch_plan(n, l, c, level[0], _sm_count(dev))
    faces, group, threads = plan[:3]
    if threads not in _FEATURES_THREADS or not (faces >= 1 and
                                                 1 <= group <= l):
        raise ValueError(f"no K5 / K6 launch plan {tuple(plan[:3])}")
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    args = [ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(level_i.data_ptr()),
            ctypes.c_void_p(level_rel.data_ptr()),
            ctypes.c_void_p(tents.data_ptr()),
            ctypes.c_void_p(eyes.data_ptr()),
            n, l, c, ry, rx, level[0], faces, group, threads,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
    return out, args


def extract_features_fused_frames(frames: torch.Tensor, image_indices, oy,
                                  ox, x: torch.Tensor, window_shape, level,
                                  cell_size: int, num_orientations: int,
                                  dims: int, r_idx, l_idx) -> torch.Tensor:
    """K5: one cascade level's feature rows for training, each sample's
    window read straight from the uint8 frame stack.

    frames: (n_img, H, W) uint8. image_indices, oy, ox: (N,) integers, the
    sample's frame and the top-left corner of its (RY, RX) = window_shape
    window in it. x: (N, 2L) float32 rows in window coordinates. level:
    (S, W, WX, relative patch size), W and WX the sampler's sub-window
    sides (WX == RX: the full width). r_idx / l_idx: the eye landmarks of
    the IED. Returns (N, L*D*C*C + 1) float32 rows in the reference's order
    ``lm*(D*C*C) + d*C*C + cx*C + cy``, bias 1 last; patches are always
    quantised to grey levels.

    Index arrays on the host are checked before upload (ValueError); on
    the card, a sample whose index or origin lies outside the stack gets a
    row of NaN. A CPU frame stack takes the plain twin; a CUDA one launches
    the kernel.
    """
    if frames.ndim != 3 or frames.dtype != torch.uint8:
        raise ValueError("frames must be an (n_img, H, W) uint8 stack")
    n_img, h, w = frames.shape
    ry, rx = (int(v) for v in window_shape)
    if not (ry <= h and rx <= w):
        raise ValueError(f"window {ry}x{rx} exceeds the frames {h}x{w}")
    dev = frames.device
    for name, v, high in (("image_indices", image_indices, n_img - 1),
                          ("oy", oy, h - ry), ("ox", ox, w - rx)):
        if _on_host(v) and dev.type == "cuda":
            _check_host_indices(name, v, 0, high)
    idx, oy, ox = (torch.as_tensor(v).to(dev, torch.int32).contiguous()
                   for v in (image_indices, oy, ox))
    n = x.shape[0]
    if x.ndim != 2 or any(v.shape != (n,) for v in (idx, oy, ox)):
        raise ValueError("x must be (N, 2L) and the indices and origins (N,)")
    level, c, f = _check_level(x.shape[1] // 2, ry, rx, level, cell_size,
                               num_orientations, dims, r_idx, l_idx)
    if dev.type == "cpu":
        return extract_features_fused_frames_reference(
            frames, idx, oy, ox, x.float(), (ry, rx), level, cell_size,
            r_idx, l_idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    frames = frames.contiguous()
    x = x.to(dev, torch.float32).contiguous()
    out, args = _features_launch_args(x, level, cell_size, r_idx, l_idx, ry,
                                      rx, c, f)
    if n == 0:
        return out
    from superviseddescent_tpu_torch.ops._build import load_library
    _launch_features_frames(load_library("features_fused"), frames, idx, oy,
                            ox, args)
    extract_features_fused_frames.launches += 1
    return out


def _launch_features_frames(lib, frames, idx, oy, ox, args):
    """K5's launch from ``lib`` (the entry point's build, or a measurement
    build of the same source) with ``_features_launch_args``' arguments."""
    n_img, h, w = frames.shape
    err = lib.features_fused_frames_launch(
        ctypes.c_void_p(frames.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(oy.data_ptr()), ctypes.c_void_p(ox.data_ptr()),
        n_img, h, w, *args)
    if err != 0:
        raise RuntimeError(
            f"features_fused_frames kernel launch failed: CUDA error {err}")


extract_features_fused_frames.launches = 0


def extract_features_fused(windows: torch.Tensor, x: torch.Tensor, level,
                           cell_size: int, num_orientations: int, dims: int,
                           r_idx, l_idx) -> torch.Tensor:
    """K6: K5 on pre-cropped (N, RY, RX) windows (bfloat16; uint8 and
    float32 are cast to bfloat16 first). Everything else as
    ``extract_features_fused_frames``. A CPU tensor takes the plain twin; a
    CUDA one launches the kernel."""
    if windows.ndim != 3 or x.ndim != 2 or windows.shape[0] != x.shape[0]:
        raise ValueError("expected (N, RY, RX) windows and (N, 2L) rows")
    if windows.dtype != torch.bfloat16:
        windows = windows.bfloat16()
    _, ry, rx = windows.shape
    dev = windows.device
    level, c, f = _check_level(x.shape[1] // 2, ry, rx, level, cell_size,
                               num_orientations, dims, r_idx, l_idx)
    if dev.type == "cpu":
        return extract_features_fused_reference(
            windows, x.float(), level, cell_size, r_idx, l_idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    windows = windows.contiguous()
    x = x.to(dev, torch.float32).contiguous()
    out, args = _features_launch_args(x, level, cell_size, r_idx, l_idx, ry,
                                      rx, c, f)
    if x.shape[0] == 0:
        return out
    from superviseddescent_tpu_torch.ops._build import load_library
    _launch_features(load_library("features_fused"), windows, args)
    extract_features_fused.launches += 1
    return out


def _launch_features(lib, windows, args):
    """K6's launch from ``lib`` with ``_features_launch_args``' arguments."""
    err = lib.features_fused_launch(ctypes.c_void_p(windows.data_ptr()),
                                    *args)
    if err != 0:
        raise RuntimeError(
            f"features_fused kernel launch failed: CUDA error {err}")


extract_features_fused.launches = 0
