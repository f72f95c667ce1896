"""Linear regressor: inference only in this slice (``learn`` and the ridge
solvers come with training)."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from superviseddescent_tpu_torch.core.regulariser import Regulariser


@dataclass
class LinearRegressor:
    """weights: (F, P) coefficient matrix, the reference's ``x`` member."""
    weights: torch.Tensor
    regulariser: Regulariser = field(default_factory=Regulariser)

    def predict(self, values: torch.Tensor) -> torch.Tensor:
        """values: (..., F) -> (..., P), a float32 product. On CUDA this
        assumes ``torch.backends.cuda.matmul.allow_tf32`` is False (the
        PyTorch default): TF32 keeps ~3 decimal digits."""
        return torch.matmul(values, self.weights)
