"""Ridge regularisation of a linear regressor's normal equations.

Counterpart of ``superviseddescent_tpu/core/regulariser.py`` (reference:
superviseddescent/regressors.hpp):

  * ``Manual``: lambda is used as given;
  * ``MatrixNorm``: lambda = param * ||AtA||_F / n, the Frobenius norm of
    the *normal matrix* and n the number of training rows;
  * ``regularise_last_row=False`` leaves the last diagonal entry (the bias
    row) unregularised.

Integer values of RegularisationType match the reference's on-disk cereal
enum (int32, Manual=0, MatrixNorm=1). The regulariser is immutable: the
reference overwrites its lambda on every learn; one training run never
learns a regressor twice, so the results are the same."""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class RegularisationType(enum.IntEnum):
    Manual = 0
    MatrixNorm = 1


@dataclass(frozen=True)
class Regulariser:
    """regularisation_type: Manual (lambda = param) or MatrixNorm
    (lambda = param * ||AtA||_F / n_samples); regularise_last_row=False
    exempts the bias row."""
    regularisation_type: RegularisationType = RegularisationType.Manual
    param: float = 0.0
    regularise_last_row: bool = True

    def lambda_value(self, ata: torch.Tensor,
                     num_training_elements: int) -> torch.Tensor:
        """Scalar lambda (a 0-d tensor of ``ata``'s type, on its device)
        for the normal matrix ``ata`` and the sample count."""
        if self.regularisation_type == RegularisationType.Manual:
            return torch.tensor(self.param, dtype=ata.dtype,
                                device=ata.device)
        frob = torch.sqrt(torch.sum(ata * ata))
        return self.param * frob / num_training_elements

    def diagonal(self, ata: torch.Tensor,
                 num_training_elements: int) -> torch.Tensor:
        """Diagonal regularisation vector of length ``ata.shape[0]``."""
        n = ata.shape[0]
        diag = self.lambda_value(ata, num_training_elements).expand(
            n).clone()
        if not self.regularise_last_row:
            diag[n - 1] = 0.0
        return diag
