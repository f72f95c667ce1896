"""Native model files and per-level training checkpoints.

Counterpart of ``superviseddescent_tpu/io/checkpoint.py``. The reference
keeps each level's weights in memory until its final cereal save; here:

  * ``save_native`` / ``load_native``: a directory with ``model.json`` (the
    landmark ids, HOG parameters and regularisers; the same content as the
    JAX package's) and ``weights.pt``, a ``torch.save`` of the mean and the
    per-level weights (the JAX package stores these with orbax). The
    cereal codec (``io/cereal.py``) stays the reference-compatible format.
  * ``TrainCheckpointer``: each trained level's weights and rows as
    ``level_NN.npz`` in the JAX package's own format (``weights``,
    ``current_x``, ``feature_order``), written as soon as the level's solve
    completes, so that ``train_rcr(checkpointer=...)`` resumes after the
    last completed level. The port solves in the reference's feature order
    ("std") on every backend: it resumes a std-order run of either package
    and refuses, by name, a JAX run solved in its fused kernel's order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

FORMAT_VERSION = 1
STD_ORDER = "std"


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def model_meta(model) -> dict:
    """``model.json``'s content for a DetectionModel."""
    return {
        "format_version": FORMAT_VERSION,
        "landmark_ids": model.landmark_ids,
        "right_eye_ids": model.right_eye_ids,
        "left_eye_ids": model.left_eye_ids,
        "hog_params": [
            {"variant": int(p.variant), "num_cells": p.num_cells,
             "cell_size": p.cell_size, "num_bins": p.num_bins,
             "relative_patch_size": p.relative_patch_size}
            for p in model.hog_params],
        "regularisers": [
            {"type": int(r.regulariser.regularisation_type),
             "param": float(r.regulariser.param),
             "regularise_last_row": bool(r.regulariser.regularise_last_row)}
            for r in model.sdo.regressors],
    }


def save_native(model, directory) -> None:
    """Write a DetectionModel as ``model.json`` + ``weights.pt``."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model.json"), "w") as f:
        json.dump(model_meta(model), f, indent=2)
    torch.save({"mean": torch.from_numpy(_numpy(model.mean)),
                "weights": {str(i): torch.from_numpy(_numpy(r.weights))
                            for i, r in enumerate(model.sdo.regressors)}},
               os.path.join(directory, "weights.pt"))


def load_native(directory, device=None):
    """A DetectionModel written by ``save_native``, on ``device`` (CUDA
    unless the caller names one)."""
    from superviseddescent_tpu_torch.core.cascade import (
        SupervisedDescentOptimiser)
    from superviseddescent_tpu_torch.core.regressor import LinearRegressor
    from superviseddescent_tpu_torch.core.regulariser import (
        RegularisationType, Regulariser)
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, HogParams, InterEyeDistanceNormalisation)
    from superviseddescent_tpu_torch.ops.hog import HogVariant

    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "model.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint format: {meta.get('format_version')}")
    tree = torch.load(os.path.join(directory, "weights.pt"),
                      weights_only=True)
    regressors = [LinearRegressor(
        weights=tree["weights"][str(i)],
        regulariser=Regulariser(RegularisationType(r["type"]), r["param"],
                                r["regularise_last_row"]))
        for i, r in enumerate(meta["regularisers"])]
    norm = InterEyeDistanceNormalisation(
        meta["landmark_ids"], meta["right_eye_ids"], meta["left_eye_ids"])
    hog_params = tuple(
        HogParams(HogVariant(p["variant"]), p["num_cells"], p["cell_size"],
                  p["num_bins"], p["relative_patch_size"])
        for p in meta["hog_params"])
    return DetectionModel(SupervisedDescentOptimiser(regressors, norm),
                          tree["mean"].numpy(), meta["landmark_ids"],
                          hog_params, meta["right_eye_ids"],
                          meta["left_eye_ids"], device=device)


class TrainCheckpointer:
    """Per-level checkpoints of one training run, ``level_NN.npz`` in
    ``directory``, each written to a temporary file and renamed."""

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, level: int) -> str:
        return os.path.join(self.directory, f"level_{level:02d}.npz")

    def save_level(self, level: int, weights, current_x,
                   feature_order: str = STD_ORDER) -> None:
        """weights: the level's (F, P) weights; current_x: the (N, P) rows
        after it; feature_order: the order of the weight rows."""
        # np.savez appends .npz when missing, so the temporary name has it
        tmp = os.path.join(self.directory, f".tmp_level_{level:02d}.npz")
        np.savez(tmp, weights=_numpy(weights), current_x=_numpy(current_x),
                 feature_order=np.str_(feature_order))
        os.replace(tmp, self._path(level))

    def completed_levels(self) -> int:
        n = 0
        while os.path.exists(self._path(n)):
            n += 1
        return n

    def load_level(self, level: int, expect_order: str = STD_ORDER):
        """(weights, current_x) of a level as numpy arrays. A file without
        an order tag predates the tags and passes as std order."""
        with np.load(self._path(level)) as data:
            order = (str(data["feature_order"]) if "feature_order" in data
                     else STD_ORDER)
            if order != expect_order:
                raise ValueError(
                    f"checkpoint level {level} holds '{order}'-order "
                    f"weights but this run solves in '{expect_order}' "
                    "order; resume with the package and configuration "
                    "that wrote it, or delete the checkpoint directory to "
                    "retrain")
            return data["weights"], data["current_x"]
