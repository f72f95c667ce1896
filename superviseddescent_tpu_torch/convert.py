"""Build the port's DetectionModel from another model's parameters.

The arguments are plain numpy arrays and Python values, so a model loaded
by the JAX package can be handed to this package without either importing
the other: pass ``[np.asarray(r.weights) for r in jax_model.sdo.regressors]``,
``jax_model.mean`` and its id lists and HOG parameters.
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
