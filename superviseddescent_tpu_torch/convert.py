"""Carry a DetectionModel's parameters between this package and another.

The parameters are plain numpy arrays and Python values, so a model loaded
by the JAX package can be handed to this package, and one trained here
handed back, without either package importing the other: pass
``[np.asarray(r.weights) for r in jax_model.sdo.regressors]``,
``jax_model.mean`` and its id lists and HOG parameters to
``from_jax_params``; ``to_jax_params`` returns the same pieces of a model
of this package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from superviseddescent_tpu_torch.core.cascade import SupervisedDescentOptimiser
from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from superviseddescent_tpu_torch.models.rcr import (
    DetectionModel, HogParams, InterEyeDistanceNormalisation)
from superviseddescent_tpu_torch.ops.hog import HogVariant


def from_jax_params(weights: Sequence[np.ndarray], mean: np.ndarray,
                    landmark_ids: Sequence[str], hog_params,
                    right_eye_ids: Sequence[str],
                    left_eye_ids: Sequence[str],
                    device=None) -> DetectionModel:
    """weights: per-level (F, 2L) arrays; mean: (2L,); hog_params: objects
    with ``variant``, ``num_cells``, ``cell_size``, ``num_bins`` and
    ``relative_patch_size`` (e.g. the JAX package's HogParams).
    The IED normalisation uses ``landmark_ids`` and the eye ids."""
    regressors = [LinearRegressor(torch.from_numpy(
        np.array(w, dtype=np.float32))) for w in weights]
    norm = InterEyeDistanceNormalisation(landmark_ids, right_eye_ids,
                                         left_eye_ids)
    params = tuple(HogParams(HogVariant(int(p.variant)), int(p.num_cells),
                             int(p.cell_size), int(p.num_bins),
                             float(p.relative_patch_size))
                   for p in hog_params)
    return DetectionModel(SupervisedDescentOptimiser(regressors, norm),
                          np.asarray(mean, np.float32), landmark_ids, params,
                          right_eye_ids, left_eye_ids, device=device)


def to_jax_params(model: DetectionModel) -> dict:
    """The inverse of ``from_jax_params``: ``weights`` (per-level (F, 2L)
    float32 numpy arrays, reference feature order), ``mean`` ((2L,)
    float32), ``landmark_ids``, ``right_eye_ids``, ``left_eye_ids``, and
    ``hog_params`` (per level a dict of ``variant`` (int), ``num_cells``,
    ``cell_size``, ``num_bins``, ``relative_patch_size``), from which the
    JAX package's DetectionModel can be built."""
    return dict(
        weights=[r.weights.detach().cpu().numpy().astype(np.float32)
                 for r in model.sdo.regressors],
        mean=model.mean.detach().cpu().numpy().astype(np.float32),
        landmark_ids=list(model.landmark_ids),
        right_eye_ids=list(model.right_eye_ids),
        left_eye_ids=list(model.left_eye_ids),
        hog_params=[dict(variant=int(p.variant), num_cells=p.num_cells,
                         cell_size=p.cell_size, num_bins=p.num_bins,
                         relative_patch_size=p.relative_patch_size)
                    for p in model.hog_params])
