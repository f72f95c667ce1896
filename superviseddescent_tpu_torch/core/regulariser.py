"""Ridge regularisation settings of a linear regressor (data only here:
the normal-equation solve that reads them comes with training).

Integer values of RegularisationType match the reference's on-disk cereal
enum (int32, Manual=0, MatrixNorm=1; superviseddescent/regressors.hpp)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


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
