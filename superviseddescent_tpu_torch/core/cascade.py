"""The Supervised Descent Method cascade, inference side.

Counterpart of ``superviseddescent_tpu/core/cascade.py`` (reference:
superviseddescent/superviseddescent.hpp). The projection is batched by
contract: ``h(x: (N, P), level) -> (N, F)``. Per level:
``x' = x - (observed @ W) / norm(x)`` with ``observed = h(x)`` or
``h(x) - templates``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from superviseddescent_tpu_torch.core.regressor import LinearRegressor


class NoNormalisation:
    """Default normalisation: a row of ones (no-op)."""

    def __call__(self, params: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(params)


class SupervisedDescentOptimiser:
    """A cascade of regressors applied in series.

    normalisation: callable ``(N, P) -> (N, P)`` of per-sample factors
    (e.g. 1/IED rows for RCR); default ones.
    """

    def __init__(self, regressors: Sequence[LinearRegressor],
                 normalisation: Optional[Callable] = None):
        self.regressors: List[LinearRegressor] = list(regressors)
        self.normalisation = normalisation or NoNormalisation()

    def step(self, level: int, x: torch.Tensor, features: torch.Tensor,
             templates: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cascade level given its features h(x, level)."""
        observed = features if templates is None else features - templates
        norm = self.normalisation(x)
        return x - self.regressors[level].predict(observed) / norm

    def test(self, initialisations: torch.Tensor, templates, projection,
             on_regressor_iteration_callback: Optional[Callable] = None):
        """Apply the cascade to a batch; returns the final (N, P) rows."""
        x = initialisations
        for level in range(len(self.regressors)):
            x = self.step(level, x, projection(x, level), templates)
            if on_regressor_iteration_callback is not None:
                on_regressor_iteration_callback(x)
        return x

    def predict(self, initialisations: torch.Tensor, templates, projection):
        """Like test, also accepting a single (P,) row."""
        squeeze = initialisations.ndim == 1
        x = initialisations[None, :] if squeeze else initialisations
        out = self.test(x, templates, projection)
        return out[0] if squeeze else out
