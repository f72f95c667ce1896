"""SupervisedDescentOptimiser.train, port vs JAX, on the sin-inversion case
of tests/test_cascade_convergence.py (the same numpy data through both).

Tolerances: the pinned residuals within the 5e-6 that file uses; per-level
training rows of the two packages within 2e-5 (float32 solves of a
one-feature system, different factorisation code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu import (
    LinearRegressor as JaxRegressor,
    SupervisedDescentOptimiser as JaxSdo)
from superviseddescent_tpu_torch.core.cascade import (
    SupervisedDescentOptimiser)
from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from test_cascade_convergence import asin_clipped, nlsr, strided_iota

LEVELS = 10


def h_sin(x, level):
    return torch.sin(x)


@pytest.fixture(scope="module")
def case():
    y_tr = strided_iota(-1.0, 0.2, 11).reshape(-1, 1)
    x_tr = asin_clipped(y_tr).astype(np.float32)
    y_ts = strided_iota(-1.0, 0.05, 41).reshape(-1, 1)
    x_ts = asin_clipped(y_ts).astype(np.float32)
    jax_sdo = JaxSdo([JaxRegressor() for _ in range(LEVELS)])
    jax_rows = np.asarray(jax_sdo.train(
        x_tr, np.full_like(x_tr, 0.5), y_tr, lambda x, level: jnp.sin(x)))
    return dict(y_tr=y_tr, x_tr=x_tr, y_ts=y_ts, x_ts=x_ts,
                jax_sdo=jax_sdo, jax_rows=jax_rows)


def train_port(case, **kw):
    sdo = SupervisedDescentOptimiser(
        [LinearRegressor() for _ in range(LEVELS)])
    x_tr = torch.from_numpy(case["x_tr"])
    rows = sdo.train(x_tr, torch.full_like(x_tr, 0.5),
                     torch.from_numpy(case["y_tr"]), h_sin, **kw)
    return sdo, rows


def test_train_rows_and_pinned_residuals(case):
    sdo, rows = train_port(case)
    assert rows.shape == (LEVELS, 11, 1)
    np.testing.assert_allclose(rows.numpy(), case["jax_rows"], rtol=0,
                               atol=2e-5)
    x0 = torch.full((11, 1), 0.5)
    train_pred = sdo.test(x0, torch.from_numpy(case["y_tr"]), h_sin)
    torch.testing.assert_close(train_pred, rows[-1], rtol=0, atol=0)
    test_pred = sdo.test(torch.full((41, 1), 0.5),
                         torch.from_numpy(case["y_ts"]), h_sin)
    np.testing.assert_allclose(nlsr(train_pred.numpy(), case["x_tr"]),
                               0.040279395, atol=5e-6)
    np.testing.assert_allclose(nlsr(test_pred.numpy(), case["x_ts"]),
                               0.026156775, atol=5e-6)


def test_weights_match_jax_per_level(case):
    sdo, _ = train_port(case)
    for port, ref in zip(sdo.regressors, case["jax_sdo"].regressors):
        np.testing.assert_allclose(port.weights.numpy(),
                                   np.asarray(ref.weights), rtol=1e-4,
                                   atol=1e-6)


def test_callback_sees_each_level(case):
    seen = []
    _, rows = train_port(case, on_training_epoch_callback=seen.append)
    assert len(seen) == LEVELS
    for got, want in zip(seen, rows):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_start_level_resumes_from_given_rows(case):
    full, rows = train_port(case)
    resumed = SupervisedDescentOptimiser(
        [LinearRegressor(weights=r.weights.clone()) if i < 4
         else LinearRegressor() for i, r in enumerate(full.regressors)])
    x_tr = torch.from_numpy(case["x_tr"])
    tail = resumed.train(x_tr, rows[3], torch.from_numpy(case["y_tr"]),
                         h_sin, start_level=4)
    assert tail.shape == (LEVELS - 4, 11, 1)
    torch.testing.assert_close(tail, rows[4:], rtol=0, atol=0)
    none = resumed.train(x_tr, rows[-1], torch.from_numpy(case["y_tr"]),
                         h_sin, start_level=LEVELS)
    assert none.shape == (0, 11, 1)


def test_learn_fn_replaces_the_learn_step(case):
    calls = []

    def learn_fn(regressor, observed, b, level):
        calls.append((level, tuple(observed.shape), tuple(b.shape)))
        return regressor.learn(observed, b)

    _, rows = train_port(case, learn_fn=learn_fn)
    _, plain = train_port(case)
    assert calls == [(i, (11, 1), (11, 1)) for i in range(LEVELS)]
    torch.testing.assert_close(rows, plain, rtol=0, atol=0)
