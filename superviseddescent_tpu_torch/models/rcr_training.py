"""RCR training: perturbation augmentation, metrics, orchestration.

Counterpart of ``superviseddescent_tpu/models/rcr_training.py`` (reference:
the rcr-train app's training logic, rcr-train.cpp). Random draws come from
an explicit ``torch.Generator`` on the CPU, so the card and the CPU train
from the same initialisations (the reference seeds from std::random_device
and cannot be reproduced).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from superviseddescent_tpu_torch.core.cascade import SupervisedDescentOptimiser
from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from superviseddescent_tpu_torch.core.regulariser import (
    RegularisationType, Regulariser)
from superviseddescent_tpu_torch.models.rcr import (
    RCR22_HOG_PARAMS, DetectionModel, HogParams, HogTransform,
    InterEyeDistanceNormalisation, align_mean, aligned_window_origins,
    crop_windows, frames_path_ok, level_sub_windows, rows_shift)
from superviseddescent_tpu_torch.ops.cascade_fused import (
    FRAME_COL_ALIGN, _check_host_indices, _on_host)
from superviseddescent_tpu_torch.parallel.dist import (
    ShardedHogTransform, sharded_learn)
from superviseddescent_tpu_torch.parallel.mesh import (
    gather_rows, shard_bounds)
from superviseddescent_tpu_torch.utils.device import resolve_device
from superviseddescent_tpu_torch.utils.landmarks import (
    ied_from_rows, mirror_permutation, resolve_eye_indices)


def perturb_facebox(facebox: torch.Tensor, translation_x, translation_y,
                    scaling=1.0) -> torch.Tensor:
    """Perturb (..., 4) faceboxes [x, y, w, h], keeping the centre fixed
    under scaling. translation_x / translation_y are fractions of the box
    width / height (reference: rcr-train.cpp)."""
    x, y, w, h = (facebox[..., i] for i in range(4))
    pw = w * scaling
    ph = h * scaling
    nx = x + (w - pw) / 2.0 + translation_x * w
    ny = y + (h - ph) / 2.0 + translation_y * h
    return torch.stack([nx, ny, pw, ph], dim=-1)


def augment_initialisations(mean: torch.Tensor, faceboxes: torch.Tensor,
                            generator: torch.Generator,
                            num_perturbations: int = 10,
                            sigma_translation: float = 0.04,
                            sigma_scale: float = 0.04,
                            sigma_rotation: float = 0.0):
    """Perturbation augmentation: per facebox the original plus
    ``num_perturbations`` randomly perturbed boxes, each aligned with the
    mean (reference: tx, ty ~ N(0, 0.04), s ~ N(1, 0.04)).

    sigma_rotation (radians) goes beyond the reference: each perturbed
    initialisation is also rotated about its own centroid by
    theta ~ N(0, sigma_rotation); the unperturbed copy stays unrotated.

    mean: (2L,) mean shape in facebox space. faceboxes: (B, 4).
    generator: a CPU ``torch.Generator``; the draws are made on the CPU and
    moved to the faceboxes' device.

    Returns (x0, sample_to_box): x0 is (B*(P+1), 2L), sample_to_box maps
    each row to its facebox (int64). The original box comes first in each
    group, like the reference.
    """
    faceboxes = faceboxes.float()
    dev = faceboxes.device
    b, p = faceboxes.shape[0], num_perturbations

    def normal(*shape):
        return torch.randn(shape, generator=generator).to(dev)

    trans = normal(b, p, 2) * sigma_translation
    scale = 1.0 + normal(b, p) * sigma_scale
    perturbed = perturb_facebox(faceboxes[:, None, :], trans[..., 0],
                                trans[..., 1], scale)            # (B, P, 4)
    all_boxes = torch.cat([faceboxes[:, None, :], perturbed], dim=1)
    x0 = align_mean(mean.to(dev)[None, None, :], all_boxes)   # (B, P+1, 2L)
    if sigma_rotation > 0.0:
        theta = torch.cat([torch.zeros((b, 1), device=dev),
                           normal(b, p) * sigma_rotation], dim=1)
        l = x0.shape[-1] // 2
        xs, ys = x0[..., :l], x0[..., l:]
        cx = xs.mean(dim=-1, keepdim=True)
        cy = ys.mean(dim=-1, keepdim=True)
        ca = torch.cos(theta)[..., None]
        sa = torch.sin(theta)[..., None]
        dx, dy = xs - cx, ys - cy
        x0 = torch.cat([cx + dx * ca - dy * sa, cy + dx * sa + dy * ca],
                       dim=-1)
    x0 = x0.reshape(b * (p + 1), -1)
    sample_to_box = torch.arange(b, device=dev).repeat_interleave(p + 1)
    return x0, sample_to_box


def normalised_landmark_errors(predictions: torch.Tensor,
                               groundtruth: torch.Tensor,
                               right_idx: Tuple[int, ...],
                               left_idx: Tuple[int, ...]) -> torch.Tensor:
    """Per-landmark L2 error normalised by the IED of the *prediction*
    (reference: rcr-train.cpp). (N, 2L) rows -> (N, L)."""
    l = predictions.shape[-1] // 2
    dx = predictions[..., :l] - groundtruth[..., :l]
    dy = predictions[..., l:] - groundtruth[..., l:]
    norms = torch.sqrt(dx * dx + dy * dy)
    ied = ied_from_rows(predictions, right_idx, left_idx)
    return norms / ied[..., None]


@dataclass
class RcrTrainConfig:
    """Hyperparameters of the reference rcr-train main(), as a config.

    roi: cut a roi x roi window per face and train in window coordinates
    (exact as long as every patch stays inside the window). patch_backend:
    None / ``gather`` (plain PyTorch), ``dense`` (two tent products + K1),
    ``window`` (K2 + K1) or ``fused`` (K5 / K6, fast class); the last two
    require roi. sampling: ``exact``, ``high`` (dense only) or ``fast``,
    for the dense and window backends (fast also switches the window
    backend's K1 to its bf16 sector-binned mode). feature_chunk_size:
    extract each level's features in chunks of this many samples, so that
    only one chunk's images, tents and patches (dense) or window gather
    exist at a time. mirror_augmentation: double the set with horizontally
    flipped images and mirror-permuted ground truth.
    """
    hog_params: Sequence[HogParams] = RCR22_HOG_PARAMS
    regularisation: Regulariser = Regulariser(
        RegularisationType.MatrixNorm, 1.5, regularise_last_row=False)
    num_perturbations: int = 10
    sigma_translation: float = 0.04
    sigma_scale: float = 0.04
    sigma_rotation: float = 0.0
    seed: int = 0
    solver_method: str = "lu"
    quantize_patches: bool = True
    feature_chunk_size: Optional[int] = None
    roi: Optional[int] = None
    patch_backend: Optional[str] = None
    sampling: str = "exact"
    mirror_augmentation: bool = False


def _crop_face_windows(images: torch.Tensor, image_indices: torch.Tensor,
                       faceboxes: torch.Tensor, roi: int):
    """Per-face roi x roi windows, in the stack's own type (uint8 stays
    uint8), and their (B, 2) float32 origins [ox, oy], clamped inside each
    image."""
    windows, ox, oy = crop_windows(images, image_indices, faceboxes.float(),
                                   roi)
    return windows, torch.stack([ox, oy], dim=1).float()


@dataclass
class TrainingProblem:
    """What ``train_rcr`` sets up before the cascade's training loop: the
    feature transform ``hog(x, level) -> (N, F)``, the (N, 2L)
    initialisations ``x0`` and ground truth ``x_gt`` in the coordinates the
    transform samples in, the (N, 2L) ``sample_shift`` that takes rows back
    to image coordinates (None without roi), the untrained cascade, and
    the number of samples before any padding."""
    hog: HogTransform
    x0: torch.Tensor
    x_gt: torch.Tensor
    sample_shift: Optional[torch.Tensor]
    sdo: SupervisedDescentOptimiser
    mean: np.ndarray
    num_samples: int


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """t with ``pad`` copies of its first row appended."""
    if not pad:
        return t
    return torch.cat([t, t[:1].expand((pad,) + tuple(t.shape[1:]))])


def training_problem(images, groundtruth_rows, faceboxes,
                     model_landmarks: Sequence[str],
                     right_eye_ids: Sequence[str],
                     left_eye_ids: Sequence[str], mean,
                     config: RcrTrainConfig, image_indices=None,
                     device=None, pad_multiple: int = 1) -> TrainingProblem:
    """The set-up half of ``train_rcr`` (same arguments): mirror
    augmentation, the per-face windows or the frame table, the perturbed
    initialisations and the feature transform. pad_multiple: append copies
    of sample 0 up to a multiple of this many samples (a mesh's ranks);
    ``num_samples`` counts the samples without them.

    Internal: ``train_rcr`` is the entry point. This half stands alone only
    so that ``chip_smoke.py`` can replay a run level by level at the very
    inputs ``train_rcr`` gave its kernels; the packages export neither it
    nor ``TrainingProblem``."""
    device = resolve_device(device)
    if image_indices is not None and _on_host(image_indices):
        _check_host_indices("image_indices", image_indices, 0,
                            len(images) - 1)
    images = torch.as_tensor(images, device=device)
    gt = torch.as_tensor(groundtruth_rows, dtype=torch.float32, device=device)
    boxes = torch.as_tensor(faceboxes, dtype=torch.float32, device=device)
    mean_np = np.asarray(mean.detach().cpu() if isinstance(
        mean, torch.Tensor) else mean, np.float32)
    mean = torch.as_tensor(mean_np, device=device)
    b = gt.shape[0]
    if image_indices is None:
        image_indices = torch.arange(b, device=device)
    else:
        image_indices = torch.as_tensor(image_indices, device=device).long()

    if config.mirror_augmentation:
        # flipped image i + n_img is images[i] mirrored; its ground truth is
        # the mirror-permuted row reflected about the padded stack width
        perm = torch.as_tensor(mirror_permutation(model_landmarks),
                               device=device)
        n_img, _, wpx = images.shape
        lm = gt.shape[1] // 2
        images = torch.cat([images, torch.flip(images, dims=(2,))])
        gt = torch.cat([gt, torch.cat(
            [(wpx - 1.0) - gt[:, :lm][:, perm], gt[:, lm:][:, perm]],
            dim=1)])
        boxes = torch.cat([boxes, torch.stack(
            [wpx - boxes[:, 0] - boxes[:, 2], boxes[:, 1], boxes[:, 2],
             boxes[:, 3]], dim=1)])
        image_indices = torch.cat([image_indices, image_indices + n_img])
        b = gt.shape[0]

    l = gt.shape[1] // 2
    roi = config.roi
    backend = config.patch_backend or "gather"
    if backend in ("window", "fused") and roi is None:
        raise ValueError(f"patch_backend={backend!r} requires config.roi")
    shift_rows = None
    frame_table = frame_window = None
    if roi is not None:
        h, w = images.shape[1], images.shape[2]
        # frames mode needs a grain-aligned roi and stack, so that the
        # clamp cannot strip the one-grain slack from edge faces
        if (backend == "fused" and frames_path_ok(images)
                and roi % FRAME_COL_ALIGN == 0 and h >= roi and w >= roi):
            oy, ox, frame_window = aligned_window_origins(h, w, boxes, roi)
            # the transform's indices become sample -> face (table row)
            frame_table = (image_indices, oy, ox)
            origins = torch.stack([ox, oy], dim=1).float()
        else:
            images, origins = _crop_face_windows(images, image_indices,
                                                 boxes, roi)
        # everything below runs in each face's window coordinates; the
        # callback translates back to image coordinates
        shift_rows = rows_shift(origins[:, 0], origins[:, 1], l)
        gt = gt - shift_rows
        boxes = torch.cat([boxes[:, :2] - origins, boxes[:, 2:]], dim=1)
        image_indices = torch.arange(b, device=device)

    generator = torch.Generator().manual_seed(config.seed)   # on the CPU
    x0, sample_to_box = augment_initialisations(
        mean, boxes, generator,
        num_perturbations=config.num_perturbations,
        sigma_translation=config.sigma_translation,
        sigma_scale=config.sigma_scale,
        sigma_rotation=config.sigma_rotation)
    sample_to_box = sample_to_box.long()
    sample_shift = None if shift_rows is None else shift_rows[sample_to_box]
    n_real = x0.shape[0]
    # the copies keep the extraction on valid coordinates; train_rcr masks
    # them out of the normal equations
    pad = (-n_real) % pad_multiple
    x0 = _pad_rows(x0, pad)
    x_gt = _pad_rows(gt[sample_to_box], pad)
    sample_indices = _pad_rows(image_indices[sample_to_box], pad)

    sub_windows = sub_windows_x = None
    if backend in ("window", "fused"):
        r_idx, l_idx = resolve_eye_indices(model_landmarks, right_eye_ids,
                                           left_eye_ids)
        # one read-back; 1.4x margin: intermediate estimates can have a
        # larger IED than the ground truth, beyond it the sampler clamps
        max_ied = float(ied_from_rows(gt, r_idx, l_idx).max())
        sub_windows, sub_windows_x = level_sub_windows(
            config.hog_params, roi, 1.4 * max_ied)
        if backend == "fused" and frame_table is None:
            images = images.bfloat16()   # K6's window type, cast once

    hog = HogTransform(images, config.hog_params, model_landmarks,
                       right_eye_ids, left_eye_ids,
                       image_indices=sample_indices,
                       quantize=config.quantize_patches, backend=backend,
                       sampling=config.sampling, sub_windows=sub_windows,
                       sub_windows_x=sub_windows_x,
                       chunk_size=config.feature_chunk_size,
                       frame_table=frame_table, frame_window=frame_window)
    norm = InterEyeDistanceNormalisation(model_landmarks, right_eye_ids,
                                         left_eye_ids)
    sdo = SupervisedDescentOptimiser(
        [LinearRegressor(regulariser=config.regularisation,
                         method=config.solver_method)
         for _ in config.hog_params], norm)
    return TrainingProblem(hog, x0, x_gt, sample_shift, sdo, mean_np, n_real)


def train_rcr(images, groundtruth_rows, faceboxes,
              model_landmarks: Sequence[str],
              right_eye_ids: Sequence[str], left_eye_ids: Sequence[str],
              mean, config: RcrTrainConfig = RcrTrainConfig(),
              image_indices=None, on_epoch=None, checkpointer=None,
              mesh=None, device=None) -> DetectionModel:
    """Train an RCR detection model (the rcr-train pipeline).

    images: (I, H, W) gray stack, uint8 or float32, zero-padded.
    groundtruth_rows: (B, 2L) rows, one per face. faceboxes: (B, 4), for
    the mean-shape initialisation. mean: (2L,) mean shape in facebox space.
    image_indices: (B,) face -> image of the stack (default arange; an
    index array on the host is range-checked). on_epoch: called with the
    current (N, 2L) rows in image coordinates after each level. device:
    CUDA unless the caller passes one (``device="cpu"`` trains through the
    kernels' plain twins).

    checkpointer: an ``io.checkpoint.TrainCheckpointer``. Each level's
    weights and rows are written when its solve completes (in the
    reference's feature order, tagged ``"std"``), and a call on a directory
    that holds completed levels resumes after the last of them.

    mesh: a ``parallel.mesh.Mesh``; every rank calls ``train_rcr`` with the
    same arguments. The samples are padded to a multiple of the ranks with
    copies of sample 0, which add nothing to the normal equations, each
    rank extracts the features of its shard, and each level's normal
    equations are summed over the group before the solve
    (``parallel.dist.distributed_train_level``). Every rank returns the
    same model, on its ``mesh.device``; rank 0 alone writes the
    checkpoints.

    With ``patch_backend="fused"`` and roi, a uint8 stack whose height is a
    multiple of 32 and whose width and roi are multiples of 128 trains in
    frames mode: K5 reads each sample's window straight from the stack and
    no window is ever gathered. Any other stack is cropped into per-face
    windows first (K6 for the fused backend).

    Returns the trained DetectionModel on the device, its regressors in the
    reference's feature order.
    """
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    p = training_problem(images, groundtruth_rows, faceboxes, model_landmarks,
                         right_eye_ids, left_eye_ids, mean, config,
                         image_indices, device,
                         pad_multiple=1 if mesh is None else mesh.size)
    n_real = p.num_samples
    hog, x0, x_gt, learn_fn = p.hog, p.x0, p.x_gt, None
    start_level = 0
    if checkpointer is not None:
        start_level = min(checkpointer.completed_levels(),
                          len(config.hog_params))
        for lvl in range(start_level):
            w, rows = checkpointer.load_level(lvl)
            if rows.shape != (n_real, x0.shape[1]):
                raise ValueError(
                    f"checkpoint level {lvl} holds rows of shape "
                    f"{rows.shape}, this run trains {n_real} samples of "
                    f"{x0.shape[1]} values")
            p.sdo.regressors[lvl] = LinearRegressor(
                weights=torch.as_tensor(w, device=x0.device),
                regulariser=config.regularisation,
                method=config.solver_method)
        if start_level:
            x0 = _pad_rows(torch.as_tensor(rows, device=x0.device),
                           x0.shape[0] - n_real)
    if mesh is not None:
        a, b = shard_bounds(x0.shape[0], mesh)
        valid = (torch.arange(x0.shape[0], device=x0.device)
                 < n_real).float()[a:b]
        x0, x_gt = x0[a:b], x_gt[a:b]
        hog = ShardedHogTransform(hog, mesh)
        learn_fn = sharded_learn(mesh, num_samples=n_real, valid=valid)

    level = [start_level]

    def epoch_cb(current_x):
        """The rows of every sample, unpadded: to the checkpoint in the
        transform's coordinates, to on_epoch in the image's."""
        rows = current_x if mesh is None else gather_rows(current_x, mesh)
        rows = rows[:n_real]
        if checkpointer is not None and (mesh is None or mesh.rank == 0):
            checkpointer.save_level(
                level[0], p.sdo.regressors[level[0]].weights, rows)
        level[0] += 1
        if on_epoch is not None:
            on_epoch(rows if p.sample_shift is None
                     else rows + p.sample_shift)

    p.sdo.train(x_gt, x0, None, hog,
                on_training_epoch_callback=(
                    None if on_epoch is None and checkpointer is None
                    else epoch_cb),
                start_level=start_level, learn_fn=learn_fn)
    if mesh is not None and checkpointer is not None:
        # no rank returns before rank 0 has written the last level
        torch.distributed.barrier(group=mesh.group)
    return DetectionModel(p.sdo, p.mean, list(model_landmarks),
                          tuple(config.hog_params), list(right_eye_ids),
                          list(left_eye_ids),
                          device=p.x0.device)
