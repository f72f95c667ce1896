"""Ridge regulariser, normal-equation solvers and LinearRegressor, port vs
JAX, on the same numpy data.

Tolerances: float32 solves are held by what they predict (A @ W within 2e-4
relative to the labels' scale) and by the relative residual of the
regularised normal equations (1e-4), not element by element, since LAPACK
and XLA factorise in different orders; float64 solves within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.core.regressor import (
    LinearRegressor as JaxRegressor)
from superviseddescent_tpu.core.regulariser import (
    RegularisationType as JaxType, Regulariser as JaxRegulariser)
from superviseddescent_tpu.ops.solver import (
    solve_ridge_normal_equations as jax_solve)
from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from superviseddescent_tpu_torch.core.regulariser import (
    RegularisationType, Regulariser)
from superviseddescent_tpu_torch.ops.solver import (
    _solve_from_normal, float32_matmul, normal_equations,
    solve_ridge_normal_equations)

REGULARISERS = {
    "none": (0, 0.0, True),
    "manual": (0, 0.3, True),
    "manual_bias_exempt": (0, 0.3, False),
    "matrixnorm": (1, 1.5, True),
    "matrixnorm_bias_exempt": (1, 1.5, False),
}


def pair(name):
    t, param, last = REGULARISERS[name]
    return (Regulariser(RegularisationType(t), param, last),
            JaxRegulariser(JaxType(t), param, last))


def problem(seed=0, n=60, f=12, p=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, f)).astype(dtype)
    a[:, -1] = 1.0
    b = (a @ rng.normal(size=(f, p)) + 0.1 * rng.normal(size=(n, p)))
    return a, b.astype(dtype)


@pytest.mark.parametrize("name", sorted(REGULARISERS))
def test_regulariser_lambda_and_diagonal_match_jax(name):
    reg, jreg = pair(name)
    a, _ = problem()
    ata = a.T @ a
    lam = float(reg.lambda_value(torch.from_numpy(ata), a.shape[0]))
    ref = float(jreg.lambda_value(jnp.asarray(ata), a.shape[0]))
    assert lam == pytest.approx(ref, rel=1e-6)
    diag = reg.diagonal(torch.from_numpy(ata), a.shape[0]).numpy()
    np.testing.assert_allclose(
        diag, np.asarray(jreg.diagonal(jnp.asarray(ata), a.shape[0])),
        rtol=1e-6)
    assert diag.shape == (a.shape[1],)
    assert diag[-1] == (lam if reg.regularise_last_row else 0.0)


def test_matrixnorm_is_param_times_frobenius_over_n():
    a, _ = problem(1)
    ata = torch.from_numpy(a.T @ a)
    lam = Regulariser(RegularisationType.MatrixNorm, 1.5).lambda_value(
        ata, a.shape[0])
    expected = 1.5 * np.linalg.norm(ata.numpy(), "fro") / a.shape[0]
    assert float(lam) == pytest.approx(expected, rel=1e-6)


@pytest.mark.parametrize("method", ["lu", "cholesky", "qr"])
@pytest.mark.parametrize("name", ["manual", "matrixnorm_bias_exempt"])
def test_solve_float32_matches_jax(method, name):
    reg, jreg = pair(name)
    a, b = problem(2)
    w = solve_ridge_normal_equations(torch.from_numpy(a), torch.from_numpy(b),
                                     reg, method).numpy()
    ref = np.asarray(jax_solve(jnp.asarray(a), jnp.asarray(b),
                               regulariser=jreg, method=method))
    assert w.shape == ref.shape == (a.shape[1], b.shape[1])
    scale = np.abs(b).max()
    assert np.abs(a @ w - a @ ref).max() <= 2e-4 * scale
    # relative residual of the regularised normal equations, in float64
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ata = a64.T @ a64
    lhs = ata + np.diag(reg.diagonal(torch.from_numpy(ata),
                                     a.shape[0]).numpy())
    res = np.linalg.norm(lhs @ w - a64.T @ b64) / np.linalg.norm(a64.T @ b64)
    assert res <= 1e-4


@pytest.mark.parametrize("method", ["lu", "cholesky", "qr"])
def test_solve_float64_matches_jax(method):
    reg, jreg = pair("matrixnorm_bias_exempt")
    a, b = problem(3, dtype=np.float64)
    w = solve_ridge_normal_equations(torch.from_numpy(a), torch.from_numpy(b),
                                     reg, method).numpy()
    assert w.dtype == np.float64
    with jax.enable_x64():
        ref = np.asarray(jax_solve(jnp.asarray(a, jnp.float64),
                                   jnp.asarray(b, jnp.float64),
                                   regulariser=jreg, method=method))
    np.testing.assert_allclose(w, ref, rtol=0, atol=1e-9)


def test_qr_warns_on_singular_system(capsys):
    # two equal columns and no regularisation: rank F - 1
    a, b = problem(4)
    a[:, 1] = a[:, 0]
    solve_ridge_normal_equations(torch.from_numpy(a), torch.from_numpy(b),
                                 Regulariser(), "qr")
    err = capsys.readouterr().err
    assert "not invertible" in err and "Increase lambda" in err
    assert f"full rank would be {a.shape[1]}" in err
    # a regularised system is full rank and stays silent
    solve_ridge_normal_equations(
        torch.from_numpy(a), torch.from_numpy(b),
        Regulariser(RegularisationType.Manual, 0.5), "qr")
    assert capsys.readouterr().err == ""


def test_unknown_method_and_rank_raise():
    a, b = problem()
    with pytest.raises(ValueError, match="unknown solve method"):
        solve_ridge_normal_equations(torch.from_numpy(a),
                                     torch.from_numpy(b), method="svd")
    with pytest.raises(ValueError, match="rank-2"):
        solve_ridge_normal_equations(torch.from_numpy(a[0]),
                                     torch.from_numpy(b))


def test_solve_from_normal_equals_the_full_solve():
    reg, _ = pair("matrixnorm")
    a, b = (torch.from_numpy(v) for v in problem(5))
    ata, atb = normal_equations(a, b)
    torch.testing.assert_close(
        _solve_from_normal(ata, atb, a.shape[0], reg, "lu"),
        solve_ridge_normal_equations(a, b, reg, "lu"), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["manual", "matrixnorm_bias_exempt"])
def test_regressor_learn_predict_test_match_jax(name):
    reg, jreg = pair(name)
    a, b = problem(6)
    blank = LinearRegressor(regulariser=reg, method="cholesky")
    learned = blank.learn(torch.from_numpy(a), torch.from_numpy(b))
    assert blank.weights is None and learned is not blank
    assert (learned.regulariser, learned.method) == (reg, "cholesky")
    jax_learned = JaxRegressor(regulariser=jreg, method="cholesky").learn(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(
        learned.predict(torch.from_numpy(a)).numpy(),
        np.asarray(jax_learned.predict(jnp.asarray(a))),
        rtol=0, atol=2e-4 * np.abs(b).max())
    assert float(learned.test(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(float(jax_learned.test(jnp.asarray(a), jnp.asarray(b))),
                      rel=1e-4)
    with pytest.raises(ValueError, match="before learn"):
        blank.predict(torch.from_numpy(a))


@pytest.fixture
def tf32_on():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def test_tf32_flag_is_off_inside_the_guard_and_restored(tf32_on):
    a, b = (torch.from_numpy(v) for v in problem(7))
    with float32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        inside = torch.matmul(a.t(), a)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    # a raise inside the guard restores the flag too
    with pytest.raises(RuntimeError):
        with float32_matmul():
            raise RuntimeError("inside")
    assert torch.backends.cuda.matmul.allow_tf32 is True
    ata, atb = normal_equations(a, b)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    torch.testing.assert_close(ata, inside, rtol=0, atol=0)


def test_learn_and_predict_unchanged_by_the_tf32_flag(tf32_on):
    reg, _ = pair("matrixnorm_bias_exempt")
    a, b = (torch.from_numpy(v) for v in problem(8))
    with_flag = LinearRegressor(regulariser=reg).learn(a, b)
    pred_flag = with_flag.predict(a)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    torch.backends.cuda.matmul.allow_tf32 = False
    without = LinearRegressor(regulariser=reg).learn(a, b)
    torch.testing.assert_close(with_flag.weights, without.weights, rtol=0,
                               atol=0)
    torch.testing.assert_close(pred_flag, without.predict(a), rtol=0, atol=0)
