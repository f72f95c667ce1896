"""Port cascade inference vs the JAX package on a random linear cascade."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.core.cascade import (
    SupervisedDescentOptimiser as JaxSdo)
from superviseddescent_tpu.core.regressor import (
    LinearRegressor as JaxRegressor)
from superviseddescent_tpu_torch.core.cascade import (
    NoNormalisation, SupervisedDescentOptimiser)
from superviseddescent_tpu_torch.core.regressor import LinearRegressor


def make_case(seed=0, n=16, p=6, f=9, levels=3):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(n, p)).astype(np.float32)
    proj = [rng.normal(size=(p, f)).astype(np.float32) for _ in range(levels)]
    weights = [0.1 * rng.normal(size=(f, p)).astype(np.float32)
               for _ in range(levels)]
    templates = rng.normal(size=(n, f)).astype(np.float32)
    return x0, proj, weights, templates


def run_both(x0, proj, weights, templates, normalise):
    def j_norm(x):
        return 1.0 + 0.5 * jnp.abs(x)

    def t_norm(x):
        return 1.0 + 0.5 * torch.abs(x)

    jax_sdo = JaxSdo([JaxRegressor(weights=jnp.asarray(w)) for w in weights],
                     j_norm if normalise else None)
    sdo = SupervisedDescentOptimiser(
        [LinearRegressor(torch.from_numpy(w)) for w in weights],
        t_norm if normalise else None)
    ref = np.asarray(jax_sdo.test(
        jnp.asarray(x0), None if templates is None else jnp.asarray(templates),
        lambda x, lv: jnp.tanh(x @ jnp.asarray(proj[lv]))))
    got = sdo.test(
        torch.from_numpy(x0),
        None if templates is None else torch.from_numpy(templates),
        lambda x, lv: torch.tanh(x @ torch.from_numpy(proj[lv]))).numpy()
    return got, ref


@pytest.mark.parametrize("normalise", [False, True])
@pytest.mark.parametrize("with_templates", [False, True])
def test_sdo_test_matches_jax(normalise, with_templates):
    x0, proj, weights, templates = make_case()
    got, ref = run_both(x0, proj, weights,
                        templates if with_templates else None, normalise)
    # same float32 operations in the same order; 1e-6 covers the
    # libraries' different matmul summation orders
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_predict_single_row_and_callback():
    x0, proj, weights, _ = make_case(seed=1, n=1)
    sdo = SupervisedDescentOptimiser(
        [LinearRegressor(torch.from_numpy(w)) for w in weights])
    h = lambda x, lv: torch.tanh(x @ torch.from_numpy(proj[lv]))  # noqa: E731
    seen = []
    batch = sdo.test(torch.from_numpy(x0), None, h,
                     on_regressor_iteration_callback=seen.append)
    single = sdo.predict(torch.from_numpy(x0[0]), None, h)
    assert single.shape == (x0.shape[1],) and len(seen) == len(weights)
    torch.testing.assert_close(single, batch[0], rtol=0, atol=0)
    assert torch.equal(NoNormalisation()(batch), torch.ones_like(batch))
