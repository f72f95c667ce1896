"""RCR evaluation helpers (training itself comes with a later slice)."""

from __future__ import annotations

from typing import Tuple

import torch

from superviseddescent_tpu_torch.utils.landmarks import ied_from_rows


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
