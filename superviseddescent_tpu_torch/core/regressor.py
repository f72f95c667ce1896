"""Ridge-regularised linear regressor.

Counterpart of ``superviseddescent_tpu/core/regressor.py`` (reference:
superviseddescent/regressors.hpp, LinearRegressor): ``learn`` (the ridge
normal-equations solve), ``predict`` (values @ W) and ``test`` (the
normalised residual), batched over rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from superviseddescent_tpu_torch.core.regulariser import Regulariser
from superviseddescent_tpu_torch.ops.solver import (
    float32_matmul, solve_ridge_normal_equations)


@dataclass
class LinearRegressor:
    """weights: (F, P) coefficient matrix, the reference's ``x`` member
    (None before ``learn``). method: ``lu``, ``cholesky`` or ``qr``."""
    weights: Optional[torch.Tensor] = None
    regulariser: Regulariser = field(default_factory=Regulariser)
    method: str = "lu"

    def learn(self, data: torch.Tensor,
              labels: torch.Tensor) -> "LinearRegressor":
        """A new regressor with the weights learned from (N, F) data and
        (N, P) labels; this one is left as it is."""
        w = solve_ridge_normal_equations(
            data, labels, regulariser=self.regulariser, method=self.method)
        return LinearRegressor(weights=w, regulariser=self.regulariser,
                               method=self.method)

    def predict(self, values: torch.Tensor) -> torch.Tensor:
        """values: (..., F) -> (..., P), a true float32 product on CUDA
        too (TF32 is switched off around it)."""
        if self.weights is None:
            raise ValueError("predict() before learn(): weights are unset")
        with float32_matmul():
            return torch.matmul(values, self.weights)

    def test(self, data: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Normalised residual ||pred - labels|| / ||labels||, a 0-d
        tensor."""
        predictions = self.predict(data)
        return (torch.linalg.norm(predictions - labels)
                / torch.linalg.norm(labels))
