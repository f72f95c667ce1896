"""The port's remaining utilities: the float64 parity mode, the cascade's
vmap and predict adapters, profiling and timing.

The float64 sin cascade runs in a subprocess (the mode changes
process-wide defaults) and must reproduce the reference's pinned residuals
within 1e-7, as tests/test_f64_parity.py holds the JAX package.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.core.cascade import (
    SupervisedDescentOptimiser, batch_projection)
from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from superviseddescent_tpu_torch.utils.profiling import (
    LevelTimer, enable_nan_checks, timed, trace)
from superviseddescent_tpu_torch.utils.timing import force, measure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F64_SCRIPT = r"""
import numpy as np
from superviseddescent_tpu_torch.utils.parity import enable_f64
enable_f64()

import torch
from superviseddescent_tpu_torch import (
    LinearRegressor, SupervisedDescentOptimiser)

def strided_iota(start, step, n):
    out = np.empty(n, np.float32)
    v = np.float32(start)
    for i in range(n):
        out[i] = v
        v = np.float32(v + np.float32(step))
    return torch.from_numpy(out.astype(np.float64))

def h(x, level):
    return torch.sin(x)

y_tr = strided_iota(-1.0, 0.2, 11).reshape(-1, 1)
x_tr = torch.arcsin(torch.clamp(y_tr, max=1.0))
x0 = torch.full_like(x_tr, 0.5)
sdo = SupervisedDescentOptimiser([LinearRegressor() for _ in range(10)])
sdo.train(x_tr, x0, y_tr, h)
train_pred = sdo.test(x0, y_tr, h)
assert train_pred.dtype == torch.float64, train_pred.dtype
assert all(r.weights.dtype == torch.float64 for r in sdo.regressors)
assert torch.zeros(1).dtype == torch.float64

y_ts = strided_iota(-1.0, 0.05, 41).reshape(-1, 1)
x_ts = torch.arcsin(torch.clamp(y_ts, max=1.0))
test_pred = sdo.test(torch.full_like(x_ts, 0.5), y_ts, h)

tr = float(torch.linalg.norm(train_pred - x_tr) / torch.linalg.norm(x_tr))
te = float(torch.linalg.norm(test_pred - x_ts) / torch.linalg.norm(x_ts))
# reference pins (float32 Eigen): 0.040279395 / 0.026156775
assert abs(tr - 0.040279395) < 1e-7, tr
assert abs(te - 0.026156775) < 1e-7, te
print("OK", tr, te)
"""


def test_f64_parity_sin_cascade():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", F64_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")


def sin_cascade(levels=3):
    y = torch.arange(-1.0, 1.01, 0.2).reshape(-1, 1)
    x = torch.arcsin(torch.clamp(y, -1.0, 1.0))
    sdo = SupervisedDescentOptimiser([LinearRegressor()
                                      for _ in range(levels)])
    sdo.train(x, torch.full_like(x, 0.5), y, lambda v, lvl: torch.sin(v))
    return sdo, y


def test_batch_projection_and_predict_fn_equal_predict():
    sdo, y = sin_cascade()
    x0 = torch.full_like(y, 0.5)

    def per_sample(row, level):
        return torch.sin(row)

    batched = batch_projection(per_sample)
    direct = sdo.predict(x0, y, lambda v, lvl: torch.sin(v))
    assert torch.equal(sdo.predict(x0, y, batched), direct)
    assert torch.equal(sdo.make_predict_fn(templates=y)(x0, batched), direct)
    # a scalar per sample becomes a one-element row
    scalar = batch_projection(lambda row, level: row.sum())
    assert scalar(torch.ones((4, 3)), 0).shape == (4, 1)


def test_timed_and_level_timer():
    stream = io.StringIO()
    out = timed(lambda x: x * 2.0, torch.ones(4), label="double",
                stream=stream)
    assert torch.equal(out, torch.full((4,), 2.0))
    assert "[timed] double:" in stream.getvalue()
    timer = LevelTimer(stream=stream, verbose=False)
    y = torch.arange(-1.0, 1.01, 0.2).reshape(-1, 1)
    x = torch.arcsin(y.clamp(-1.0, 1.0))
    sdo = SupervisedDescentOptimiser([LinearRegressor() for _ in range(3)])
    sdo.train(x, torch.full_like(x, 0.5), y, lambda v, lvl: torch.sin(v),
              on_training_epoch_callback=timer)
    assert len(timer.times_ms) == 3 and all(t > 0 for t in timer.times_ms)


def test_force_and_measure():
    assert force({"a": torch.ones(3), "b": [torch.zeros((2, 2))]}) == 0.0
    assert force([]) == 0.0
    assert force(torch.arange(5.0)) == 4.0
    per_call, fence = measure(lambda x: torch.tanh(x) @ x.T,
                              torch.ones((64, 64)), reps=3)
    assert per_call > 0 and fence == 0.0    # no CUDA tensor to fence


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones((32, 32)) @ torch.ones((32, 32))
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_nan_checks_raise_at_the_level():
    sdo, y = sin_cascade()
    x0 = torch.full_like(y, 0.5)
    bad = lambda v, lvl: torch.sin(v) if lvl == 0 else v * float("nan")  # noqa
    assert torch.isnan(sdo.test(x0, y, bad)).all()
    try:
        enable_nan_checks(True)
        with pytest.raises(FloatingPointError, match="level 1"):
            sdo.test(x0, y, bad)
        sdo.test(x0, y, lambda v, lvl: torch.sin(v))
    finally:
        enable_nan_checks(False)
    assert torch.isnan(sdo.test(x0, y, bad)).all()
