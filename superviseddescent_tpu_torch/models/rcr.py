"""Robust Cascaded Regression (RCR) landmark detection, inference surface.

Counterpart of ``superviseddescent_tpu/models/rcr.py`` (reference:
rcr/model.hpp, rcr/adaptive_vlhog.hpp): 22-landmark face alignment with
IED-adaptive HOG features and inter-eye-distance normalisation.

Feature backends per cascade level (``HogTransform``):
  * ``gather``: plain PyTorch, ``ops/patches.extract_patches`` (the
    bit-exact cv::resize emulation) + ``ops/hog.hog_descriptor``; the path
    of ``DetectionModel.detect_batch``;
  * ``dense``: ``ops/patches.extract_patches_dense`` (two tent products,
    exact / high / fast) + the HOG kernel K1 (``ops/hog_flat``); a training
    backend;
  * ``window``: the two CUDA kernels, K2 (``ops/patches_window``) then K1
    (``ops/hog_flat``), on per-face ROI windows; the path of
    ``make_stepped_detector(window_sampler=True)``.

On these paths the regressor product ``x - (F @ W) / norm`` is a float32
``torch.matmul`` (with TF32 off, the PyTorch default), as the JAX package
leaves it to XLA. ``make_fused_detector`` runs the whole cascade, GEMV
included, in one launch of K3 or K4 (``ops/cascade_fused``).

Tracking chains fused calls frame by frame, each frame starting from its
predecessor's row on the device: ``make_fused_track_stream`` delivers the
rows one by one through pinned host memory, ``make_fused_track_scan``
enqueues a whole clip and returns its rows at once.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from superviseddescent_tpu_torch.core.cascade import SupervisedDescentOptimiser
from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from superviseddescent_tpu_torch.core.regulariser import (
    RegularisationType, Regulariser)
from superviseddescent_tpu_torch.io.cereal import (
    CerealDetectionModel, CerealHoGParam, CerealRegressor,
    load_detection_model, save_detection_model)
from superviseddescent_tpu_torch.ops.cascade_fused import (
    FRAME_COL_ALIGN, FRAME_ROW_ALIGN, detect_cascade_fused,
    detect_cascade_fused_frames, extract_features_fused,
    extract_features_fused_frames, prepare_weights, validate_fused_config)
from superviseddescent_tpu_torch.ops.hog import (
    HogVariant, hog_descriptor, hog_dimension, hog_num_cells)
from superviseddescent_tpu_torch.ops.hog_flat import hog_descriptor_flat
from superviseddescent_tpu_torch.ops.patches import (
    SAMPLINGS, extract_patches, extract_patches_dense)
from superviseddescent_tpu_torch.ops.solver import float32_matmul
from superviseddescent_tpu_torch.ops.patches_window import (
    max_patch_half, max_patch_half_x, min_sub_window, min_sub_window_x,
    sample_patches_window)
from superviseddescent_tpu_torch.utils.device import resolve_device
from superviseddescent_tpu_torch.utils.landmarks import (
    LandmarkCollection, ied_from_rows, resolve_eye_indices,
    to_landmark_collection)


@dataclass(frozen=True)
class HogParams:
    """Per-cascade-level HOG configuration (reference HoGParam)."""
    variant: HogVariant = HogVariant.Uoctti
    num_cells: int = 5
    cell_size: int = 11
    num_bins: int = 4
    relative_patch_size: float = 1.0   # patch size as a fraction of the IED

    @property
    def patch_size(self) -> int:
        """Fixed resize target in pixels."""
        return self.num_cells * self.cell_size


# the shipped RCR-22 configuration (rcr-train.cpp)
RCR22_HOG_PARAMS = (
    HogParams(HogVariant.Uoctti, 5, 11, 4, 1.0),
    HogParams(HogVariant.Uoctti, 5, 10, 4, 0.7),
    HogParams(HogVariant.Uoctti, 5, 8, 4, 0.4),
    HogParams(HogVariant.Uoctti, 5, 6, 4, 0.25),
)


def rows_shift(ox: torch.Tensor, oy: torch.Tensor, n_lm: int) -> torch.Tensor:
    """(N,) window origins -> (N, 2L) additive shift for [x..., y...] rows."""
    return torch.cat([ox[:, None].expand(-1, n_lm),
                      oy[:, None].expand(-1, n_lm)], dim=1)


def align_mean(mean: torch.Tensor, facebox: torch.Tensor,
               scaling_x: float = 1.0, scaling_y: float = 1.0,
               translation_x: float = 0.0,
               translation_y: float = 0.0) -> torch.Tensor:
    """Place the mean shape ([-0.5, 0.5]^2 facebox space) into pixel
    faceboxes (x, y, w, h), scaled and translated in that space first
    (reference: model.hpp:64-76). mean: (..., 2L); facebox: (..., 4)."""
    x, y, w, h = (facebox[..., i] for i in range(4))
    l = mean.shape[-1] // 2

    def place(m, scaling, translation, origin, size):
        # JAX's order, (m * s + 0.5 + t) * size + origin; the identity
        # steps are skipped (the same bits) to spare the tracker launches
        if scaling != 1.0:
            m = m * scaling
        m = m + 0.5
        if translation != 0.0:
            m = m + translation
        return m * size[..., None] + origin[..., None]
    return torch.cat([place(mean[..., :l], scaling_x, translation_x, x, w),
                      place(mean[..., l:], scaling_y, translation_y, y, h)],
                     dim=-1)


class InterEyeDistanceNormalisation:
    """Adaptive normalisation: rows of 1/IED of the current estimate."""

    def __init__(self, model_landmarks: Sequence[str],
                 right_eye_ids: Sequence[str], left_eye_ids: Sequence[str]):
        self.model_landmarks = list(model_landmarks)
        self.right_eye_ids = list(right_eye_ids)
        self.left_eye_ids = list(left_eye_ids)
        self._right_idx, self._left_idx = resolve_eye_indices(
            model_landmarks, right_eye_ids, left_eye_ids)

    def __call__(self, params: torch.Tensor) -> torch.Tensor:
        ied = ied_from_rows(params, self._right_idx, self._left_idx)
        return torch.ones_like(params) / ied[..., None]


class HogTransform:
    """Batched adaptive-HOG projection ``h(x, level) -> (N, F)`` for the
    cascade: per level the patch half-size is round(rel * IED(x) / 2), the
    patches are described with HOG, flattened per landmark in Matlab order,
    concatenated, and a bias 1 is appended.

    images: (I, H, W) uint8 or float32 stack. image_indices: (N,) sample ->
    image map (default: one image for all, or image i for sample i).
    backend:
      * ``gather``: plain PyTorch (exact cv::resize emulation + HOG);
      * ``dense``: the sampler as two tent products over each sample's
        image (``ops/patches.extract_patches_dense``), in the precision of
        ``sampling`` (``exact``, ``high`` or ``fast``); chunk it, since it
        gathers each sample's image and builds (S, H) and (S, W) tents;
      * ``window``: K2 then K1 on per-sample ROI windows
        (``images[image_indices]``; the gather is skipped when sample i
        provably reads window i);
      * ``fused``: one launch per level of K6 on per-sample bf16 windows,
        or, with ``frame_table``, of K5, which cuts each sample's window
        out of the uint8 frame stack itself. Fast-class numerics; requires
        ``quantize=True`` and the same cells, bins and variant at every
        level.
    sampling: ``dense``: ``exact``, ``high`` or ``fast``; ``window``:
    ``exact`` or ``fast`` (bf16 sampling, sector-binned bf16 HOG,
    transposed patch hand-off); the other backends take none. hog_backend:
    the HOG of the ``gather`` and ``dense`` patches, ``kernel`` (K1, exact
    mode; its plain twin for CPU tensors), ``plain`` (``ops/hog``) or
    ``auto`` (K1 for ``dense``, plain for ``gather``, which stays the exact
    reference that the other paths are held against); the ``window`` and
    ``fused`` backends always run their kernels. sub_windows /
    sub_windows_x: per-level sampler sub-window sides (0 = the whole
    window). chunk_size: process the samples in chunks of this many, one
    after the other, so that only one chunk's windows and patches exist at
    a time (the (N, F) rows are still returned whole); the fused backend
    needs no chunks when it gathers no windows (identity batches, frames
    mode). frame_table: ``fused`` only, (frame index, oy, ox) int tensors
    per FACE; ``images`` is then the uint8 frame stack, ``image_indices``
    maps a sample to its face (row of the table), ``frame_window`` is the
    (RY, RX) window shape, and x is in each face's window coordinates.
    """

    def __init__(self, images: torch.Tensor, hog_params: Sequence[HogParams],
                 model_landmarks: Sequence[str],
                 right_eye_ids: Sequence[str], left_eye_ids: Sequence[str],
                 image_indices: Optional[torch.Tensor] = None,
                 quantize: bool = True, backend: str = "gather",
                 sampling: str = "exact",
                 sub_windows: Optional[Sequence[int]] = None,
                 sub_windows_x: Optional[Sequence[int]] = None,
                 chunk_size: Optional[int] = None,
                 frame_table=None,
                 frame_window: Optional[Sequence[int]] = None,
                 hog_backend: str = "auto"):
        if backend not in ("gather", "dense", "window", "fused"):
            raise ValueError(f"unknown feature backend: {backend!r}")
        if sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling mode: {sampling!r} "
                             f"(expected one of {SAMPLINGS})")
        if sampling == "high" and backend == "window":
            raise ValueError("sampling='high' is a dense-sampler mode: the "
                             "window sampler offers 'exact' or 'fast'")
        if hog_backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"unknown HOG backend: {hog_backend!r}")
        if hog_backend == "plain" and backend in ("window", "fused"):
            raise ValueError(f"the {backend} backend runs its own HOG "
                             "kernel: hog_backend='plain' needs the gather "
                             "or dense sampler")
        if hog_backend == "auto":
            hog_backend = "kernel" if backend == "dense" else "plain"
        self.images = images if images.ndim == 3 else images[None]
        self.hog_params = tuple(hog_params)
        self.model_landmarks = list(model_landmarks)
        self._right_idx, self._left_idx = resolve_eye_indices(
            model_landmarks, right_eye_ids, left_eye_ids)
        self.image_indices = image_indices
        # computed once by _identity_for: is the sample -> image map the
        # identity, so that the per-sample window gather can be skipped?
        self._indices_are_arange = None
        self.quantize = quantize
        self.backend = backend
        self.sampling = sampling
        self.hog_backend = hog_backend
        levels = len(self.hog_params)
        self.sub_windows = tuple(sub_windows or (0,) * levels)
        self.sub_windows_x = tuple(sub_windows_x or (0,) * levels)
        self.chunk_size = chunk_size
        if backend == "fused":
            p0 = self.hog_params[0]
            if any((p.num_cells, p.num_bins, p.variant)
                   != (p0.num_cells, p0.num_bins, p0.variant)
                   for p in self.hog_params):
                raise ValueError("fused backend requires uniform "
                                 "cell-count/bins across levels")
            validate_fused_config(len(self.model_landmarks), p0.num_cells,
                                  p0.num_bins, p0.variant)
            if not quantize:
                raise ValueError("fused backend always quantizes patches")
        if frame_table is not None:
            if backend != "fused":
                raise ValueError("frame_table requires the fused backend")
            if frame_window is None:
                raise ValueError("frame_table requires frame_window")
            if self.images.dtype != torch.uint8:
                raise ValueError("frame_table requires a uint8 frame stack")
            frame_table = tuple(
                torch.as_tensor(t).to(self.images.device, torch.int32)
                for t in frame_table)
        self.frame_table = frame_table
        self.frame_window = (None if frame_window is None
                             else tuple(int(v) for v in frame_window))

    def feature_dim(self, level: int = 0) -> int:
        p = self.hog_params[level]
        c = hog_num_cells(p.patch_size, p.cell_size)
        return len(self.model_landmarks) * c * c * hog_dimension(
            p.variant, p.num_bins) + 1

    def _indices_for(self, n: int) -> torch.Tensor:
        if self.image_indices is not None:
            return self.image_indices
        dev = self.images.device
        if self.images.shape[0] == 1:
            return torch.zeros((n,), dtype=torch.long, device=dev)
        if self.images.shape[0] == n:
            return torch.arange(n, device=dev)
        raise ValueError(
            f"cannot infer image indices for batch {n} over "
            f"{self.images.shape[0]} images; pass image_indices")

    def _identity_for(self, n: int) -> bool:
        """True iff sample i provably reads window / image i."""
        if self.images.shape[0] != n:
            return False
        if self.image_indices is None:
            return True
        if self.image_indices.shape[0] != n:
            return False
        if self._indices_are_arange is None:
            # one read-back per transform when the indices lie on the card
            self._indices_are_arange = bool(torch.equal(
                self.image_indices.long().cpu(), torch.arange(n)))
        return self._indices_are_arange

    def _patch_half(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """round(rel * IED / 2) (half away from zero), at least 1."""
        p = self.hog_params[level]
        ied = ied_from_rows(x, self._right_idx, self._left_idx)
        return torch.clamp(torch.floor(
            p.relative_patch_size * ied / 2.0 + 0.5), min=1.0)

    def window_args(self, x: torch.Tensor, level: int,
                    windows: Optional[torch.Tensor] = None):
        """The ``window`` backend's K2 and K1 calls for one level, as
        (sampler args, sampler kwargs, hog kwargs); the patches that K2
        returns are reshaped to (N*L, S*S) for K1. windows: one per sample
        (default: the image stack, which must then hold one per sample)."""
        p = self.hog_params[level]
        n, l = x.shape[0], x.shape[1] // 2
        if windows is None:
            if not self._identity_for(n):
                raise ValueError("pass the per-sample windows, or a stack "
                                 "that holds one window per sample")
            windows = self.images
        w = self.sub_windows[level] or windows.shape[1]
        wx = self.sub_windows_x[level] or windows.shape[2]
        # faces larger than the sub-window was sized for get a consistently
        # smaller patch instead of a truncated one
        phw = torch.clamp(self._patch_half(x, level), max=max_patch_half(w))
        if wx != windows.shape[2]:
            phw = torch.clamp(phw, max=max_patch_half_x(wx))
        fast = self.sampling == "fast"
        # fast mode hands the patches to K1 transposed, in bf16 (lossless
        # for quantised pixels)
        transposed = fast
        sampler_args = (windows, x[:, :l], x[:, l:], phw, p.patch_size)
        sampler_kwargs = dict(
            sub_window=self.sub_windows[level],
            sub_window_x=self.sub_windows_x[level], quantize=self.quantize,
            sampling=self.sampling, transposed=transposed,
            out_dtype=(torch.bfloat16 if transposed and self.quantize
                       else torch.float32))
        hog_kwargs = dict(size=p.patch_size, cell_size=p.cell_size,
                          num_orientations=p.num_bins, variant=p.variant,
                          fast=fast, transposed=transposed)
        return sampler_args, sampler_kwargs, hog_kwargs

    def __call__(self, x: torch.Tensor, level: int) -> torch.Tensor:
        n = x.shape[0]
        return self.call_with_indices(x, level, self._indices_for(n),
                                      identity=self._identity_for(n))

    def call_with_indices(self, x: torch.Tensor, level: int,
                          image_indices: torch.Tensor,
                          identity: bool = False) -> torch.Tensor:
        """``__call__`` with an explicit (N,) sample -> image map, the
        entry point of ``parallel.dist.ShardedHogTransform``: each rank
        passes its shard of the rows and of the map. identity: sample i
        provably reads image i (no gather of windows)."""
        n = x.shape[0]
        gathers_nothing = self.backend == "fused" and (
            identity or self.frame_table is not None)
        c = self.chunk_size
        if c is not None and n > c and self.backend == "dense":
            # chunks bound the images and tents; the patches are small, so
            # the HOG runs once over all of them
            return self._describe(torch.cat([
                self.sample_patches(x[a:a + c], level, image_indices[a:a + c])
                for a in range(0, n, c)]), level)
        if c is not None and n > c and not gathers_nothing:
            # only one chunk's gathered windows and patches exist at a time
            return torch.cat([
                self._call_block(x[a:a + c], level, image_indices[a:a + c],
                                 False)
                for a in range(0, n, c)])
        return self._call_block(x, level, image_indices, identity)

    def _fused_block(self, x, level, indices, identity):
        p = self.hog_params[level]
        dims = hog_dimension(p.variant, p.num_bins)
        tail = (p.cell_size, p.num_bins, dims, self._right_idx,
                self._left_idx)
        if self.frame_table is not None:
            # K5 cuts each sample's window out of the uint8 frames itself
            fi, foy, fox = (t[indices.long()] for t in self.frame_table)
            ry, rx = self.frame_window
            lv = (p.patch_size, self.sub_windows[level] or ry,
                  self.sub_windows_x[level] or rx, p.relative_patch_size)
            return extract_features_fused_frames(
                self.images, fi, foy, fox, x, (ry, rx), lv, *tail)
        windows = self.images if identity else self.images[indices.long()]
        lv = (p.patch_size, self.sub_windows[level] or windows.shape[1],
              self.sub_windows_x[level] or windows.shape[2],
              p.relative_patch_size)
        return extract_features_fused(windows, x, lv, *tail)

    def sample_patches(self, x: torch.Tensor, level: int,
                       indices: torch.Tensor) -> torch.Tensor:
        """The ``gather`` or ``dense`` backend's (N, L, S, S) patches for
        one level, before HOG."""
        l = x.shape[1] // 2
        args = (self.images, indices, x[:, :l], x[:, l:],
                self._patch_half(x, level), self.hog_params[level].patch_size)
        if self.backend == "dense":
            return extract_patches_dense(*args, quantize=self.quantize,
                                         sampling=self.sampling)
        return extract_patches(*args, quantize=self.quantize)

    def _call_block(self, x: torch.Tensor, level: int, indices: torch.Tensor,
                    identity: bool) -> torch.Tensor:
        p = self.hog_params[level]
        n, l = x.shape[0], x.shape[1] // 2
        s = p.patch_size
        if self.backend == "fused":
            return self._fused_block(x, level, indices, identity)
        if self.backend == "window":
            windows = self.images if identity else self.images[indices.long()]
            args, sampler_kwargs, hog_kwargs = self.window_args(
                x, level, windows)
            patches = sample_patches_window(*args, **sampler_kwargs)
            return _with_bias(hog_descriptor_flat(
                patches.reshape(n * l, s * s), **hog_kwargs).reshape(n, -1))
        return self._describe(self.sample_patches(x, level, indices), level)

    def _describe(self, patches: torch.Tensor, level: int) -> torch.Tensor:
        """(N, L, S, S) patches -> (N, F) rows: HOG per patch in Matlab
        order, the landmarks concatenated, a bias 1 last."""
        p = self.hog_params[level]
        n, l, s = patches.shape[:3]
        if self.hog_backend == "kernel":
            desc = hog_descriptor_flat(
                patches.reshape(n * l, s * s), size=s, cell_size=p.cell_size,
                num_orientations=p.num_bins, variant=p.variant)
        else:
            desc = hog_descriptor(patches.reshape(n * l, s, s), p.cell_size,
                                  p.num_bins, p.variant)
        return _with_bias(desc.reshape(n, -1))


def _with_bias(desc: torch.Tensor) -> torch.Tensor:
    """(N, F - 1) descriptors -> (N, F) feature rows, a bias 1 last."""
    return torch.cat([desc, torch.ones((desc.shape[0], 1), dtype=desc.dtype,
                                       device=desc.device)], dim=1)


class SteppedDetector:
    """``f(images (B, H, W), faceboxes (B, 4)) -> (B, 2L)``, one cascade
    level at a time; built by ``DetectionModel.make_stepped_detector``.

    With ``roi`` each face's window is cut out first (clamped inside the
    image) and the cascade runs in window coordinates.
    """

    def __init__(self, model: "DetectionModel", batch: int, quantize: bool,
                 roi: Optional[int], sampling: str, window_sampler: bool,
                 sub_windows, sub_windows_x):
        self.model = model
        self.batch = batch
        self.quantize = quantize
        self.roi = roi
        self.sampling = sampling
        self.window_sampler = window_sampler
        self.sub_windows = sub_windows
        self.sub_windows_x = sub_windows_x

    def transform(self, images: torch.Tensor) -> HogTransform:
        m = self.model
        return HogTransform(
            images, m.hog_params, m.landmark_ids, m.right_eye_ids,
            m.left_eye_ids, quantize=self.quantize,
            backend="window" if self.window_sampler else "gather",
            sampling=self.sampling, sub_windows=self.sub_windows,
            sub_windows_x=self.sub_windows_x)

    def crop(self, images: torch.Tensor, boxes: torch.Tensor):
        """Per-face ROI windows and their (ox, oy) origins.

        With the window sampler, 128-aligned stacks and column sub-windows
        at every level, the windows are full-width row bands (origins
        floored to 32 rows) and the sampler's column sub-windows do the
        x-windowing; otherwise they are roi x roi squares.
        """
        roi = self.roi
        n, h, w = images.shape
        if h < roi or w < roi:
            raise ValueError(f"roi {roi} exceeds image stack {h}x{w}")
        dev = images.device
        cx = boxes[:, 0] + boxes[:, 2] / 2.0
        cy = boxes[:, 1] + boxes[:, 3] / 2.0
        oy = torch.clamp(torch.round(cy - roi / 2.0), 0, h - roi).long()
        face = torch.arange(n, device=dev)[:, None]
        span = torch.arange(roi, device=dev)
        rows_only = (self.window_sampler and w % 128 == 0
                     and all(self.sub_windows_x))
        if rows_only:
            oy = torch.div(oy, 32, rounding_mode="floor") * 32
            rows = images
            if images.is_contiguous() and (w * images.element_size()) % 8 == 0:
                # copy whole rows as 8-byte words: the same bytes in an
                # eighth of the gather's elements (uint8 rows)
                rows = images.view(torch.int64)
            windows = rows[face, oy[:, None] + span].view(images.dtype)
            ox = torch.zeros_like(oy)
        else:
            ox = torch.clamp(torch.round(cx - roi / 2.0), 0, w - roi).long()
            rows = (oy[:, None] + span)[:, :, None]
            cols = (ox[:, None] + span)[:, None, :]
            windows = images[face[:, :, None], rows, cols]       # (N, R, R)
        return windows, ox.float(), oy.float()

    def level(self, li: int, images: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
        """One cascade level on ``images`` (the windows with roi)."""
        features = self.transform(images)(x, li)
        return self.model.sdo.step(li, x, features)

    def __call__(self, images, faceboxes) -> torch.Tensor:
        m = self.model
        images = torch.as_tensor(images, device=m.device)
        boxes = torch.as_tensor(faceboxes, dtype=torch.float32,
                                device=m.device)
        if images.shape[0] != self.batch or boxes.shape != (self.batch, 4):
            raise ValueError(
                f"detector built for batch {self.batch}: got "
                f"{tuple(images.shape)} images, {tuple(boxes.shape)} boxes")
        x = align_mean(m.mean[None, :], boxes)
        if self.roi is None:
            for li in range(len(m.sdo.regressors)):
                x = self.level(li, images, x)
            return x
        windows, ox, oy = self.crop(images, boxes)
        shift = rows_shift(ox, oy, len(m.landmark_ids))
        x = x - shift
        for li in range(len(m.sdo.regressors)):
            x = self.level(li, windows, x)
        return x + shift


def frames_path_ok(images: torch.Tensor) -> bool:
    """The fused kernels read windows straight from a uint8 stack of
    32-aligned height and 128-aligned width (K3, K5)."""
    return (images.dtype == torch.uint8
            and images.shape[2] % FRAME_COL_ALIGN == 0
            and images.shape[1] % FRAME_ROW_ALIGN == 0)


def aligned_window_origins(h: int, w: int, boxes: torch.Tensor, roi: int):
    """Per-face window origins (oy, ox int32) in an (h, w) frame stack and
    the window shape (RY, RX) for the kernels that read frames directly:
    the roi crop origin floored to the (32, 128) grain first, then clamped,
    with the window one grain larger where the stack allows, so it still
    covers the whole crop (floor first: a clamp first could strip the slack
    from faces at the bottom or right edge)."""
    if h < roi or w < roi:
        raise ValueError(f"roi {roi} exceeds image stack {h}x{w}")
    ry = roi + (FRAME_ROW_ALIGN if h >= roi + FRAME_ROW_ALIGN else 0)
    rx = roi + (FRAME_COL_ALIGN if w >= roi + FRAME_COL_ALIGN else 0)
    cx = boxes[:, 0] + boxes[:, 2] / 2.0
    cy = boxes[:, 1] + boxes[:, 3] / 2.0
    oy = torch.round(cy - roi / 2.0).to(torch.int32)
    oy = torch.clamp(torch.div(oy, FRAME_ROW_ALIGN, rounding_mode="floor")
                     * FRAME_ROW_ALIGN, 0, h - ry)
    ox = torch.round(cx - roi / 2.0).to(torch.int32)
    ox = torch.clamp(torch.div(ox, FRAME_COL_ALIGN, rounding_mode="floor")
                     * FRAME_COL_ALIGN, 0, w - rx)
    return oy, ox, (ry, rx)


def crop_windows(images: torch.Tensor, idx: torch.Tensor,
                 boxes: torch.Tensor, roi: int):
    """roi x roi windows around the boxes' centres (clamped inside the
    image, in the stack's own type), and their (ox, oy) origins as int64
    tensors. idx: (B,) frame of each box."""
    h, w = images.shape[1], images.shape[2]
    if h < roi or w < roi:
        raise ValueError(f"roi {roi} exceeds image stack {h}x{w}")
    cx = boxes[:, 0] + boxes[:, 2] / 2.0
    cy = boxes[:, 1] + boxes[:, 3] / 2.0
    oy = torch.clamp(torch.round(cy - roi / 2.0), 0, h - roi).long()
    ox = torch.clamp(torch.round(cx - roi / 2.0), 0, w - roi).long()
    span = torch.arange(roi, device=images.device)
    windows = images[idx.long()[:, None, None],
                     (oy[:, None] + span)[:, :, None],
                     (ox[:, None] + span)[:, None, :]]
    return windows, ox, oy


class FusedDetector:
    """``f(images (I, H, W), faceboxes (B, 4) or prior rows (B, 2L),
    image_indices=None) -> (B, 2L)``: the whole cascade in one kernel
    launch; built by ``DetectionModel.make_fused_detector``.

    A uint8 stack whose height is a multiple of 32 and width a multiple of
    128 goes to K3, which reads each face's window straight from the stack
    at 32-row / 128-column aligned origins (window (roi + 32, roi + 128)
    where the stack allows it). Any other stack is cropped here into
    roi x roi bf16 windows for K4. ``image_indices`` maps faces to frames
    of a unique-frame stack; without it the stack holds one frame per face.
    """

    def __init__(self, model: "DetectionModel", roi: int,
                 max_ied: Optional[float], init: str, quantize: bool):
        if roi % 128 != 0:
            raise ValueError("fused detector requires a 128-aligned roi")
        if init not in ("facebox", "landmarks"):
            raise ValueError(f"unknown init mode: {init!r}")
        p0 = model.hog_params[0]
        c = p0.num_cells
        for p in model.hog_params:
            if (p.num_cells, p.num_bins, p.variant) != (
                    c, p0.num_bins, p0.variant):
                raise ValueError(
                    "fused detector requires uniform cell-count/bins")
        validate_fused_config(len(model.landmark_ids), c, p0.num_bins,
                              p0.variant)
        mi = max_ied if max_ied is not None else roi / 2.13
        sub_w, sub_x = level_sub_windows(model.hog_params, roi, mi)
        self.model = model
        self.roi = roi
        self.init = init
        self.quantize = quantize
        # the column sub-window falls back to roi, not to the window width:
        # on the frames path every level samples a 128-aligned sub-window
        self.levels = tuple(
            (p.patch_size, sub_w[li], sub_x[li] or roi,
             p.relative_patch_size)
            for li, p in enumerate(model.hog_params))
        self.cell_sizes = tuple(p.cell_size for p in model.hog_params)
        self.num_bins = p0.num_bins
        self.dims = hog_dimension(p0.variant, p0.num_bins)
        self.r_idx, self.l_idx = resolve_eye_indices(
            model.landmark_ids, model.right_eye_ids, model.left_eye_ids)
        self.weights = prepare_weights(
            [r.weights for r in model.sdo.regressors], model.device)

    frames_path_ok = staticmethod(frames_path_ok)

    def aligned_origins(self, images: torch.Tensor, boxes: torch.Tensor):
        """Per-face window origins for K3 and the window shape
        (``aligned_window_origins`` at this detector's roi)."""
        return aligned_window_origins(images.shape[1], images.shape[2], boxes,
                                      self.roi)

    def crop(self, images: torch.Tensor, boxes: torch.Tensor,
             idx: torch.Tensor):
        """roi x roi bf16 windows around the boxes (clamped inside the
        image) for K4, and their (ox, oy) origins."""
        windows, ox, oy = crop_windows(images, idx, boxes, self.roi)
        return windows.bfloat16(), ox.float(), oy.float()

    def boxes_from_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """roi x roi boxes centred on each row's landmark extent."""
        n_lm = len(self.model.landmark_ids)
        xs, ys = rows[:, :n_lm], rows[:, n_lm:]
        roi = float(self.roi)
        return torch.stack([
            (xs.min(1).values + xs.max(1).values) / 2.0 - roi / 2.0,
            (ys.min(1).values + ys.max(1).values) / 2.0 - roi / 2.0,
            torch.full(rows.shape[:1], roi, device=rows.device),
            torch.full(rows.shape[:1], roi, device=rows.device)], dim=1)

    def indices(self, images: torch.Tensor, n: int, image_indices):
        """(n,) int32 frame index of each face on the model's device. An
        index array on the host is range-checked before upload; a CUDA
        tensor is passed on unchecked (the kernels write NaN rows for
        entries outside the stack)."""
        dev = self.model.device
        n_img = images.shape[0]
        if image_indices is None:
            if n_img != n:
                raise ValueError(
                    f"{n} faces over {n_img} images: pass image_indices")
            return torch.arange(n, dtype=torch.int32, device=dev)
        if isinstance(image_indices, torch.Tensor) and \
                image_indices.device.type == "cuda":
            idx = image_indices.to(dev, torch.int32)
        else:
            arr = np.asarray(image_indices.cpu() if isinstance(
                image_indices, torch.Tensor) else image_indices)
            bad = np.flatnonzero((arr < 0) | (arr >= n_img))
            if bad.size:
                raise ValueError(
                    f"image_indices[{bad[0]}] = {arr[bad[0]]} is outside the "
                    f"stack of {n_img} images")
            idx = torch.as_tensor(arr.astype(np.int32), device=dev)
        if idx.shape != (n,):
            raise ValueError(f"image_indices must be ({n},), got "
                             f"{tuple(idx.shape)}")
        return idx

    def __call__(self, images, boxes_or_rows, image_indices=None):
        m = self.model
        images = torch.as_tensor(images, device=m.device)
        if images.ndim != 3:
            raise ValueError("images must be an (I, H, W) stack")
        given = torch.as_tensor(boxes_or_rows, dtype=torch.float32,
                                device=m.device)
        n_lm = len(m.landmark_ids)
        if self.init == "landmarks":
            x0 = given
            boxes = self.boxes_from_rows(given)
        else:
            boxes = given
            x0 = align_mean(m.mean[None, :], boxes)
        if x0.ndim != 2 or x0.shape[1] != 2 * n_lm or boxes.shape[1] != 4:
            raise ValueError("expected (B, 4) faceboxes or (B, 2L) rows")
        idx = self.indices(images, x0.shape[0], image_indices)
        config = dict(levels=self.levels, cell_sizes=self.cell_sizes,
                      num_orientations=self.num_bins, dims=self.dims,
                      r_idx=self.r_idx, l_idx=self.l_idx,
                      quantize=self.quantize)
        if self.frames_path_ok(images):
            oy, ox, window_shape = self.aligned_origins(images, boxes)
            shift = rows_shift(ox.float(), oy.float(), n_lm)
            out = detect_cascade_fused_frames(
                images, idx, oy, ox, x0 - shift, self.weights, window_shape,
                **config)
            return out + shift
        n_img = images.shape[0]
        valid = (idx >= 0) & (idx < n_img)
        windows, ox, oy = self.crop(images, boxes, idx.clamp(0, n_img - 1))
        shift = rows_shift(ox, oy, n_lm)
        out = detect_cascade_fused(windows, x0 - shift, self.weights,
                                   **config) + shift
        # an out-of-range CUDA index was read clamped: its row is NaN, as
        # on the frames path
        return torch.where(valid[:, None], out,
                           torch.full((), float("nan"), device=out.device))


class BatchedDetector:
    """``f(images (B, H, W), faceboxes (B, 4)) -> (B, 2L)`` for one fixed
    image shape and batch, through the plain ``gather`` features (the path
    of ``detect_batch``, image b for face b); built by
    ``DetectionModel.make_batched_detector``. PyTorch runs eagerly, so
    there is nothing to compile: the object fixes the shapes and checks
    them."""

    def __init__(self, model: "DetectionModel", image_shape, batch: int,
                 quantize: bool):
        self.model = model
        self.image_shape = tuple(int(v) for v in image_shape)
        if len(self.image_shape) != 2:
            raise ValueError("image_shape must be (H, W)")
        self.batch = int(batch)
        self.quantize = quantize

    def __call__(self, images, faceboxes) -> torch.Tensor:
        m = self.model
        images = torch.as_tensor(images, device=m.device)
        boxes = torch.as_tensor(faceboxes, dtype=torch.float32,
                                device=m.device)
        if (tuple(images.shape) != (self.batch,) + self.image_shape
                or boxes.shape != (self.batch, 4)):
            raise ValueError(
                f"detector built for {self.batch} images of "
                f"{self.image_shape}: got {tuple(images.shape)} images, "
                f"{tuple(boxes.shape)} boxes")
        return m.detect_batch(
            images, boxes, quantize=self.quantize,
            image_indices=torch.arange(self.batch, device=m.device))


class ScanDetector:
    """``f(images (B, H, W), faceboxes (B, 4)) -> (B, 2L)`` for a model
    whose levels share one HOG configuration: one level body applied over
    the stacked weights; built by ``DetectionModel.make_scan_detector``.
    The rows are those of ``detect_batch``."""

    def __init__(self, model: "DetectionModel", batch: int, quantize: bool):
        if len({(p.variant, p.num_cells, p.cell_size, p.num_bins,
                 p.relative_patch_size) for p in model.hog_params}) != 1:
            raise ValueError(
                "make_scan_detector requires uniform per-level HOG params "
                "(the scan body must be shape-uniform); this model's "
                "levels differ — use make_stepped_detector")
        self.weights = model.sdo.weight_stack              # (R, F, 2L)
        self.model = model
        self.batch = int(batch)
        self.quantize = quantize

    def __call__(self, images, faceboxes) -> torch.Tensor:
        m = self.model
        images = torch.as_tensor(images, device=m.device)
        boxes = torch.as_tensor(faceboxes, dtype=torch.float32,
                                device=m.device)
        if images.shape[0] != self.batch or boxes.shape != (self.batch, 4):
            raise ValueError(
                f"detector built for batch {self.batch}: got "
                f"{tuple(images.shape)} images, {tuple(boxes.shape)} boxes")
        hog = HogTransform(
            images, m.hog_params, m.landmark_ids, m.right_eye_ids,
            m.left_eye_ids, quantize=self.quantize,
            image_indices=torch.arange(self.batch, device=m.device))
        x = align_mean(m.mean[None, :], boxes)
        for w in self.weights:
            observed = hog(x, 0)               # uniform params: any level
            norm = m.sdo.normalisation(x)
            with float32_matmul():
                update = torch.matmul(observed, w)
            x = x - update / norm
        return x


class _HostRows:
    """Device rows to the host without stalling the stream: a ring of
    pinned host buffers; ``start`` enqueues a non-blocking copy of (k, 2L)
    rows into the next buffer and records an event behind it, ``finish``
    waits for that event only and returns the rows as a numpy array of its
    own. A buffer is reused after ``slots`` further starts, so at most
    ``slots - 1`` reads may be outstanding when one is started. On the CPU
    the copy is immediate and there is no event."""

    def __init__(self, slots: int, rows: int, width: int, device):
        self.cuda = device.type == "cuda"
        self.buffers = torch.empty((slots, rows, width), dtype=torch.float32,
                                   pin_memory=self.cuda)
        self.started = 0

    def start(self, rows: torch.Tensor):
        host = self.buffers[self.started % self.buffers.shape[0],
                            :rows.shape[0]]
        self.started += 1
        host.copy_(rows, non_blocking=True)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def finish(read) -> np.ndarray:
        host, event = read
        if event is not None:
            event.synchronize()
        return host.numpy().copy()


class FusedTrackStream:
    """``stream(frames, facebox) -> iterator of (2L,) numpy rows``, one per
    frame in order; built by ``DetectionModel.make_fused_track_stream``.

    The first frame is fitted from ``facebox`` through the fused detector,
    every later frame from its predecessor's row, which stays on the
    device, through the fused tracker: a frame's fit is enqueued before
    the previous row has reached the host. Frames are (H, W) arrays or
    tensors (device tensors skip the upload). ``chunk=K`` delivers the rows
    in bursts of K (one copy per K rows, read while the next K fits run)
    and reads a tail shorter than K row by row; ``depth=D`` starts every
    row's copy at its dispatch and delivers it D frames later. The rows
    are the same bits for every setting; only the delivery lag changes.
    """

    def __init__(self, model: "DetectionModel", roi: int,
                 max_ied: Optional[float], chunk: int,
                 depth: Optional[int]):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if depth is not None and (depth < 1 or chunk > 1):
            raise ValueError("depth requires chunk=1 and depth >= 1, "
                             f"got depth={depth}, chunk={chunk}")
        self.model = model
        self.chunk = chunk
        self.depth = depth
        self.detector = model.make_fused_detector(roi, max_ied=max_ied)
        self.tracker = model.make_fused_tracker(roi, max_ied=max_ied)

    def fits(self, frames, facebox):
        """The device rows (1, 2L), frame by frame."""
        dev = self.model.device
        box = torch.as_tensor(facebox, dtype=torch.float32,
                              device=dev).reshape(1, 4)
        prev = None
        for frame in frames:
            img = torch.as_tensor(frame, device=dev)
            if img.ndim == 2:
                img = img[None]
            prev = (self.detector(img, box) if prev is None
                    else self.tracker(img, prev))
            yield prev

    def __call__(self, frames, facebox):
        width = 2 * len(self.model.landmark_ids)
        dev = self.model.device
        if self.depth is not None:
            host = _HostRows(self.depth + 1, 1, width, dev)
            window = collections.deque()    # rows with a copy in flight
            for cur in self.fits(frames, facebox):
                window.append(host.start(cur))
                if len(window) > self.depth:
                    yield host.finish(window.popleft())[0]
            while window:
                yield host.finish(window.popleft())[0]
            return
        host = _HostRows(2, self.chunk, width, dev)
        pend = []        # device rows not yet in a flush, oldest first
        flushing = None  # the flush whose copy is in flight
        for cur in self.fits(frames, facebox):
            pend.append(cur)
            if len(pend) >= self.chunk:
                started = host.start(pend[0] if self.chunk == 1
                                     else torch.cat(pend))
                pend = []
                # read the previous flush now: its copy ran under the fits
                # enqueued since it was started
                if flushing is not None:
                    yield from host.finish(flushing)
                flushing = started
        if flushing is not None:
            yield from host.finish(flushing)
        for row in pend:                 # a tail shorter than chunk
            yield host.finish(host.start(row))[0]


class FusedTrackScan:
    """``f(frames (N, H, W), facebox (4,)) -> (N, 2L)``: a whole clip
    tracked with no host synchronisation between frames; built by
    ``DetectionModel.make_fused_track_scan``. Frame 0 is fitted from the
    facebox, every later frame from its predecessor's row on the device;
    all N fits are enqueued one after the other and the rows come back as
    one device tensor, read once by the caller. With the frames and the
    facebox already on the card nothing in the call waits for the device.
    The rows equal the sequential detector / tracker chain exactly."""

    def __init__(self, model: "DetectionModel", roi: int,
                 max_ied: Optional[float]):
        self.model = model
        self.detector = model.make_fused_detector(roi, max_ied=max_ied)
        self.tracker = model.make_fused_tracker(roi, max_ied=max_ied)

    def __call__(self, frames, facebox) -> torch.Tensor:
        dev = self.model.device
        frames = torch.as_tensor(frames, device=dev)
        if frames.ndim != 3:
            raise ValueError("frames must be an (N, H, W) stack")
        box = torch.as_tensor(facebox, dtype=torch.float32,
                              device=dev).reshape(1, 4)
        if frames.shape[0] == 0:
            return torch.zeros((0, 2 * len(self.model.landmark_ids)),
                               device=dev)
        rows = [self.detector(frames[:1], box)]
        for i in range(1, frames.shape[0]):
            rows.append(self.tracker(frames[i:i + 1], rows[-1]))
        return torch.cat(rows)


class DetectionModel:
    """A trained RCR landmark detection model (reference:
    rcr::detection_model), holding its tensors on ``device``."""

    def __init__(self, sdo: SupervisedDescentOptimiser, mean,
                 landmark_ids: Sequence[str],
                 hog_params: Sequence[HogParams],
                 right_eye_ids: Sequence[str], left_eye_ids: Sequence[str],
                 device=None):
        self.device = resolve_device(device)
        self.sdo = sdo
        for r in sdo.regressors:
            r.weights = torch.as_tensor(r.weights, dtype=torch.float32,
                                        device=self.device)
        self.mean = torch.as_tensor(np.asarray(mean, np.float32),
                                    device=self.device)
        self.landmark_ids = list(landmark_ids)
        self.hog_params = tuple(hog_params)
        self.right_eye_ids = list(right_eye_ids)
        self.left_eye_ids = list(left_eye_ids)

    def _hog(self, image) -> HogTransform:
        """The plain ``gather`` transform over one image."""
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image, np.float32))
        return HogTransform(
            image.to(self.device, torch.float32), self.hog_params,
            self.landmark_ids, self.right_eye_ids, self.left_eye_ids)

    def detect(self, image, facebox) -> LandmarkCollection:
        """Detect landmarks in one (H, W) image from a facebox
        (x, y, w, h)."""
        init = align_mean(self.mean, torch.as_tensor(
            facebox, dtype=torch.float32, device=self.device))
        row = self.sdo.predict(init, None, self._hog(image))
        return to_landmark_collection(row, self.landmark_ids)

    def detect_from_landmarks(self, image,
                              initialisation) -> LandmarkCollection:
        """Detect from a prior landmark estimate ((2L,) row), e.g. the
        previous video frame (tracking)."""
        init = torch.as_tensor(initialisation, dtype=torch.float32,
                               device=self.device)
        row = self.sdo.predict(init, None, self._hog(image))
        return to_landmark_collection(row, self.landmark_ids)

    def detect_batch(self, images, faceboxes, image_indices=None,
                     quantize: bool = True) -> torch.Tensor:
        """(I, H, W) image stack + (B, 4) faceboxes -> (B, 2L) landmark
        rows, through the plain ``gather`` features."""
        images = torch.as_tensor(images, device=self.device)
        boxes = torch.as_tensor(faceboxes, dtype=torch.float32,
                                device=self.device)
        if image_indices is not None:
            image_indices = torch.as_tensor(image_indices,
                                            device=self.device).long()
        hog = HogTransform(images, self.hog_params, self.landmark_ids,
                           self.right_eye_ids, self.left_eye_ids,
                           image_indices=image_indices, quantize=quantize)
        return self.sdo.test(align_mean(self.mean[None, :], boxes), None, hog)

    def make_batched_detector(self, image_shape, batch: int,
                              quantize: bool = True) -> BatchedDetector:
        """``f(images (B, H, W), faceboxes (B, 4)) -> (B, 2L)`` for fixed
        shapes, image b for face b, through ``detect_batch``."""
        return BatchedDetector(self, image_shape, batch, quantize)

    def make_scan_detector(self, batch: int,
                           quantize: bool = True) -> ScanDetector:
        """Whole-cascade detector whose levels run as one level body over
        the stacked weights (``SupervisedDescentOptimiser.weight_stack``).

        Requires every cascade level to share its HOG configuration. The
        shipped RCR-22 configuration does not (cell sizes 11/10/8/6), so it
        cannot scan: use ``make_stepped_detector`` there. In PyTorch the
        body is a loop over the stack; the contract is the guard and rows
        equal to ``detect_batch``."""
        return ScanDetector(self, batch, quantize)

    def make_stepped_detector(self, batch: int, quantize: bool = True,
                              roi: Optional[int] = None,
                              sampling: str = "exact",
                              window_sampler: bool = False,
                              max_ied: Optional[float] = None
                              ) -> SteppedDetector:
        """``f(images (B, H, W), faceboxes (B, 4)) -> (B, 2L)``, one
        cascade level at a time.

        roi: cut a window of R rows (and R columns, or the full width for
        128-aligned stacks with the window sampler) around each facebox
        first; exact as long as every patch stays inside the window.
        window_sampler: the K2 -> K1 kernels; requires roi. Per-level
        sub-windows are sized from max_ied (default roi / 2.13); faces
        beyond it get a consistently smaller patch.
        sampling: 'exact' or 'fast' (window sampler only).
        """
        if sampling not in ("exact", "fast"):
            raise ValueError(f"unknown sampling mode: {sampling!r} "
                             "(expected 'exact' or 'fast')")
        if window_sampler and roi is None:
            raise ValueError("window_sampler requires roi")
        sub_windows = sub_windows_x = None
        if window_sampler:
            mi = max_ied if max_ied is not None else roi / 2.13
            sub_windows, sub_windows_x = level_sub_windows(
                self.hog_params, roi, mi)
        return SteppedDetector(self, batch, quantize, roi, sampling,
                               window_sampler, sub_windows, sub_windows_x)

    def make_fused_detector(self, roi: int, max_ied: Optional[float] = None,
                            init: str = "facebox",
                            quantize: bool = True) -> FusedDetector:
        """``f(images, faceboxes_or_prior_rows, image_indices=None) ->
        (B, 2L)``: the whole cascade in one launch of the fused kernel
        (K3 for 32/128-aligned uint8 stacks, K4 otherwise).

        Serving-fast numerics (bf16 sampling and splat, sector binning,
        quantised patches; quantize=False keeps the patches unrounded).
        roi: a multiple of 128; max_ied sizes the per-level sub-windows as
        for the stepped window detector (default roi / 2.13).
        init="facebox" aligns the mean shape into each box;
        init="landmarks" starts from prior landmark rows (tracking) with
        the window centred on each row's extent. image_indices: (B,) frame
        of each face in a unique-frame stack; an index array on the host
        raises ValueError when an entry lies outside the stack, and a CUDA
        index tensor gives that face a row of NaN.
        """
        return FusedDetector(self, roi, max_ied, init, quantize)

    def make_fused_tracker(self, roi: int,
                           max_ied: Optional[float] = None) -> FusedDetector:
        """``f(frames (N, H, W), prior_rows (N, 2L)) -> (N, 2L)``: the fused
        cascade initialised from prior landmark rows (tracking)."""
        return self.make_fused_detector(roi, max_ied=max_ied,
                                        init="landmarks")

    def make_fused_track_stream(self, roi: int,
                                max_ied: Optional[float] = None,
                                chunk: int = 1,
                                depth: Optional[int] = None
                                ) -> FusedTrackStream:
        """``stream(frames, facebox) -> iterator of (2L,) numpy rows``, one
        per frame in order: per-frame tracking with each fit enqueued from
        the previous row on the device, and the rows copied to pinned host
        memory behind an event instead of a blocking read per frame.

        chunk=K delivers the rows in bursts of K, a tail shorter than K row
        by row; depth=D (with chunk=1 only) delivers each row D frames
        after its dispatch. The rows are bit-identical for every setting.
        No loss detection: drive the detector and the tracker directly for
        a re-initialisation."""
        return FusedTrackStream(self, roi, max_ied, chunk, depth)

    def make_fused_track_scan(self, roi: int,
                              max_ied: Optional[float] = None
                              ) -> FusedTrackScan:
        """``f(frames (N, H, W), facebox (4,)) -> (N, 2L)``: the whole clip
        enqueued with no host synchronisation between frames, the rows
        returned as one device tensor. Frame 0 fits from the facebox, every
        later frame from its predecessor's row; the rows equal the
        sequential detector / tracker chain exactly. A uint8 stack of
        32-aligned height and 128-aligned width rides K3 (one launch per
        frame)."""
        return FusedTrackScan(self, roi, max_ied)

    # -------------------------------------------------------------- #
    # Persistence (cereal byte-compatible)
    # -------------------------------------------------------------- #
    def to_cereal(self) -> CerealDetectionModel:
        regs = [CerealRegressor(
            weights=r.weights.detach().cpu().numpy().astype(np.float32),
            regularisation_type=int(r.regulariser.regularisation_type),
            lambda_=float(r.regulariser.param),
            regularise_last_row=bool(r.regulariser.regularise_last_row))
            for r in self.sdo.regressors]
        norm = self.sdo.normalisation
        return CerealDetectionModel(
            regressors=regs,
            norm_model_landmarks=norm.model_landmarks,
            norm_right_eye_ids=norm.right_eye_ids,
            norm_left_eye_ids=norm.left_eye_ids,
            mean=self.mean.cpu().numpy(),
            landmark_ids=self.landmark_ids,
            hog_params=[CerealHoGParam(int(p.variant), p.num_cells,
                                       p.cell_size, p.num_bins,
                                       p.relative_patch_size)
                        for p in self.hog_params],
            right_eye_ids=self.right_eye_ids,
            left_eye_ids=self.left_eye_ids)

    @classmethod
    def from_cereal(cls, cm: CerealDetectionModel,
                    device=None) -> "DetectionModel":
        regressors = [LinearRegressor(
            weights=torch.from_numpy(np.asarray(cr.weights, np.float32)),
            regulariser=Regulariser(RegularisationType(
                cr.regularisation_type), cr.lambda_, cr.regularise_last_row))
            for cr in cm.regressors]
        norm = InterEyeDistanceNormalisation(
            cm.norm_model_landmarks, cm.norm_right_eye_ids,
            cm.norm_left_eye_ids)
        hog_params = tuple(HogParams(HogVariant(p.vlhog_variant), p.num_cells,
                                     p.cell_size, p.num_bins,
                                     p.relative_patch_size)
                           for p in cm.hog_params)
        return cls(SupervisedDescentOptimiser(regressors, norm), cm.mean,
                   cm.landmark_ids, hog_params, cm.right_eye_ids,
                   cm.left_eye_ids, device=device)

    def save(self, filename):
        """Write the reference-compatible cereal binary format."""
        save_detection_model(self.to_cereal(), filename)

    @classmethod
    def load(cls, filename, device=None) -> "DetectionModel":
        return cls.from_cereal(load_detection_model(filename), device=device)


def level_sub_windows(hog_params: Sequence[HogParams], roi: int,
                      max_ied: float):
    """Per-level window-sampler sub-window sides (W rows, WX columns) for
    a ROI side and an IED bound. A WX of 0 means the full width; column
    sub-windows are used only when roi is a multiple of 128."""
    sub = tuple(min(roi, min_sub_window(p.relative_patch_size * max_ied + 2))
                for p in hog_params)
    if roi % 128 != 0:
        return sub, (0,) * len(sub)
    sub_x = tuple(
        (lambda v: 0 if v >= roi else v)(
            min_sub_window_x(p.relative_patch_size * max_ied + 2))
        for p in hog_params)
    return sub, sub_x


def gt_facebox(landmarks: LandmarkCollection, margin: float = 0.2,
               square: bool = True):
    """A facebox (x, y, w, h) from ground-truth landmarks."""
    c = landmarks.coordinates
    x0, y0 = c.min(axis=0)
    x1, y1 = c.max(axis=0)
    w, h = x1 - x0, y1 - y0
    if square:
        side = max(w, h) * (1.0 + margin)
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        return (float(cx - side / 2), float(cy - side / 2),
                float(side), float(side))
    return (float(x0 - w * margin / 2), float(y0 - h * margin / 2),
            float(w * (1 + margin)), float(h * (1 + margin)))
