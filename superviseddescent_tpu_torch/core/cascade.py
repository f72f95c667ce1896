"""The Supervised Descent Method cascade.

Counterpart of ``superviseddescent_tpu/core/cascade.py`` (reference:
superviseddescent/superviseddescent.hpp). The projection is batched by
contract: ``h(x: (N, P), level) -> (N, F)``. Per level:
``x' = x - (observed @ W) / norm(x)`` with ``observed = h(x)`` or
``h(x) - templates``; training learns ``W`` from
``b = (x - x*) * norm(x)`` by a ridge solve on ``observed``, which is
extracted once per level and used for both the solve and the update.

``batch_projection`` adapts a per-sample projection to the batched
contract (``torch.func.vmap``); ``make_predict_fn`` returns the cascade's
inference as a function of (x0, projection). With the process-wide check
on (``set_nan_checks``, ``utils.profiling.enable_nan_checks``), ``train``
and ``test`` raise ``FloatingPointError`` after the first level whose rows
are not all finite.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from superviseddescent_tpu_torch.core.regressor import LinearRegressor

# process-wide, like the JAX package's jax_debug_nans
_nan_checks = False


def set_nan_checks(enable: bool = True) -> None:
    """Check every cascade level's rows for NaN and infinity (one device
    synchronisation per level while on)."""
    global _nan_checks
    _nan_checks = bool(enable)


def _check_level(x: torch.Tensor, level: int) -> None:
    if _nan_checks and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(
            f"cascade level {level} produced non-finite rows")


def batch_projection(per_sample_fn: Callable) -> Callable:
    """Adapt a per-sample projection ``f(x_row (P,), level) -> row`` to the
    batched contract ``h(x (N, P), level) -> (N, F)`` with
    ``torch.func.vmap`` (a scalar result becomes a one-element row)."""
    def batched(x, level):
        return torch.func.vmap(
            lambda row: torch.atleast_1d(per_sample_fn(row, level)))(x)
    return batched


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

    @property
    def weight_stack(self):
        """(R, F, P) stacked weights; all levels must share one shape."""
        ws = [r.weights for r in self.regressors]
        if any(w is None for w in ws):
            raise ValueError("cascade has unlearned levels")
        if len({tuple(w.shape) for w in ws}) != 1:
            raise ValueError("levels have differing weight shapes")
        return torch.stack(ws)

    def train(self, parameters: torch.Tensor, initialisations: torch.Tensor,
              templates, projection,
              on_training_epoch_callback: Optional[Callable] = None,
              start_level: int = 0,
              learn_fn: Optional[Callable] = None) -> torch.Tensor:
        """Learn the cascade from ground truth and initialisations.

        parameters: (N, P) ground-truth rows x*. initialisations: (N, P)
        starting rows x0 (when resuming with start_level > 0, the rows
        after the last completed level). templates: (N, F) known templates
        y, or None. projection: batched ``h(x, level) -> (N, F)``.
        on_training_epoch_callback: called with the current (N, P) rows
        after each level. start_level: first level to learn; the levels
        before it must hold weights. learn_fn: replaces the per-level learn
        step, ``(regressor, observed, b, level) -> LinearRegressor``.

        Returns the (R', N, P) stacked rows after each level trained in
        this call. The levels are sequential (level k+1's features depend
        on level k's rows), so this is a Python loop.
        """
        x = initialisations
        history = []
        for level in range(start_level, len(self.regressors)):
            features = projection(x, level)
            observed = features if templates is None else features - templates
            norm = self.normalisation(x)
            b = (x - parameters) * norm
            if learn_fn is not None:
                self.regressors[level] = learn_fn(
                    self.regressors[level], observed, b, level)
            else:
                self.regressors[level] = self.regressors[level].learn(
                    observed, b)
            x = x - self.regressors[level].predict(observed) / norm
            _check_level(x, level)
            history.append(x)
            if on_training_epoch_callback is not None:
                on_training_epoch_callback(x)
        if history:
            return torch.stack(history)
        return x.new_zeros((0,) + tuple(x.shape))

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
            _check_level(x, level)
            if on_regressor_iteration_callback is not None:
                on_regressor_iteration_callback(x)
        return x

    def make_predict_fn(self, templates=None) -> Callable:
        """``f(x0, projection) -> final rows``: the cascade's inference over
        the current weights, with the projection bound at call time (the
        JAX package's jit adapter; here a plain function)."""
        def fn(x0, projection):
            return self.test(x0, templates, projection)
        return fn

    def predict(self, initialisations: torch.Tensor, templates, projection):
        """Like test, also accepting a single (P,) row."""
        squeeze = initialisations.ndim == 1
        x = initialisations[None, :] if squeeze else initialisations
        out = self.test(x, templates, projection)
        return out[0] if squeeze else out
