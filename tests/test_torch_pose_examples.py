"""Pose estimation and the port's three examples, on the CPU.

``PoseProjection`` and ``perspective_projection_matrix`` against the JAX
package's on seeded parameters (1e-4 relative to the projections'
largest magnitude, so that a coordinate near zero is held in the same
units; both run float32 matrix chains in their own order); the pose
cascade trained in both packages on the same samples; then each example
of the port through its ``main``: ``simple_function``'s test residual at
the reference's pin 0.026157 within 5e-6 (``tests/test_examples.py``) and
its train residuals against the JAX example's, ``pose_estimation`` within
1 degree of 11 / -25 / -10, and ``landmark_detection`` under 0.05 IOD error
with a model that ``DetectionModel.load`` reads.
"""

import contextlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest
import torch

from superviseddescent_tpu import (
    LinearRegressor as JaxRegressor, RegularisationType as JaxRegType,
    Regulariser as JaxRegulariser,
    SupervisedDescentOptimiser as JaxSdo)
from superviseddescent_tpu.models import pose as jax_pose
from superviseddescent_tpu_torch import (
    LinearRegressor, RegularisationType, Regulariser,
    SupervisedDescentOptimiser)
from superviseddescent_tpu_torch.examples import (
    landmark_detection, pose_estimation, simple_function)
from superviseddescent_tpu_torch.models import pose
from superviseddescent_tpu_torch.models.rcr import DetectionModel
from torch_apps_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeded_poses(n, seed=3):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-30, 30, size=(n, 3))
    trans = rng.uniform(-50, 50, size=(n, 3)) + np.float64([0, 0, -2000])
    return np.concatenate([angles, trans], axis=1).astype(np.float32)


def test_perspective_matrix_equals_jax():
    got = pose.perspective_projection_matrix(30.0, 1.25, 1.0, 5000.0,
                                             device="cpu").numpy()
    want = np.asarray(jax_pose.perspective_projection_matrix(
        30.0, 1.25, 1.0, 5000.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("screen,focal", [((1000, 1000), 1800.0),
                                          ((640, 480), 700.0)])
def test_pose_projection_equals_jax(screen, focal):
    params = seeded_poses(64)
    proj = pose.PoseProjection(pose.IBUG_10PT_FACE_MODEL, focal, screen,
                               device="cpu")
    ref = jax_pose.PoseProjection(jax_pose.IBUG_10PT_FACE_MODEL, focal,
                                  screen)
    got, want = proj(params).numpy(), np.asarray(ref(params))
    assert got.shape == want.shape == (64, 20)
    tol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    one = proj(torch.from_numpy(params[5]))
    assert one.shape == (20,)
    np.testing.assert_allclose(one.numpy(), want[5], rtol=0, atol=tol)
    assert proj.num_landmarks == 10


def test_pose_projection_refuses_other_shapes():
    with pytest.raises(ValueError, match="model_points"):
        pose.PoseProjection(np.zeros((2, 5), np.float32), device="cpu")


def test_pose_cascade_matches_jax():
    """Three MatrixNorm levels on the same 500 poses in both packages: the
    pose predicted for the reference's landmarks within 1e-3 degrees."""
    x_tr = seeded_poses(500)
    x_tr[:, 3:] = np.float32([0, 0, -2000])
    x0 = np.zeros_like(x_tr)
    x0[:, 5] = -2000.0
    landmarks = (np.float32([498, 504, 479, 498, 529, 553, 489, 503, 527,
                             503, 502, 513, 457, 465, 471, 471, 522, 522,
                             530, 536]) - 500.0) / 1800.0
    init = np.zeros(6, np.float32)
    init[5] = -2000.0
    jproj = jax_pose.PoseProjection(jax_pose.IBUG_10PT_FACE_MODEL)
    jsdo = JaxSdo([JaxRegressor(regulariser=JaxRegulariser(
        JaxRegType.MatrixNorm, 2.0, True)) for _ in range(3)])
    jsdo.train(x_tr, x0, np.asarray(jproj(x_tr)), jproj)
    want = np.asarray(jsdo.predict(init, landmarks[None, :], jproj))
    proj = pose.PoseProjection(pose.IBUG_10PT_FACE_MODEL, device="cpu")
    sdo = SupervisedDescentOptimiser([LinearRegressor(regulariser=Regulariser(
        RegularisationType.MatrixNorm, 2.0, True)) for _ in range(3)])
    t_x = torch.from_numpy(x_tr)
    sdo.train(t_x, torch.from_numpy(x0), proj(t_x), proj)
    got = sdo.predict(torch.from_numpy(init),
                      torch.from_numpy(landmarks)[None, :], proj).numpy()
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-3, rtol=0)


def run_main(module, argv=("--device", "cpu")):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(list(argv))
    return buf.getvalue()


def test_simple_function_example():
    out = run_main(simple_function)
    line = [l for l in out.splitlines() if l.startswith("test residual")]
    assert line, out
    res = float(line[0].split(":")[1].split()[0])
    np.testing.assert_allclose(res, 0.026157, atol=5e-6)
    # the JAX example's train residuals, printed the same way
    spec = importlib.util.spec_from_file_location(
        "jax_simple_function",
        os.path.join(REPO, "examples", "simple_function.py"))
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_example.main()

    def train(text):
        return [float(l.split(":")[1]) for l in text.splitlines()
                if l.startswith("train residual")]
    assert len(train(out)) == 10
    np.testing.assert_allclose(train(out), train(buf.getvalue()),
                               atol=2e-6, rtol=0)


def test_pose_estimation_example():
    out = run_main(pose_estimation)
    line = [l for l in out.splitlines() if l.startswith("Predicted pose")]
    assert line, out
    pitch, yaw, roll = [float(v) for v in
                        re.findall(r"-?\d+\.\d+", line[0])][:3]
    assert abs(pitch - 11.0) < 1.0 and abs(yaw + 25.0) < 1.0 \
        and abs(roll + 10.0) < 1.0, out


def test_landmark_detection_example(monkeypatch, tmp_path):
    monkeypatch.setattr(landmark_detection.tempfile, "gettempdir",
                        lambda: str(tmp_path))
    out = run_main(landmark_detection)
    line = [l for l in out.splitlines() if "IOD-normalised" in l]
    assert line, out
    assert "over 5 images" in line[0]
    assert float(line[0].rsplit(":", 1)[1]) < 0.05, out
    saved = tmp_path / "landmark_detection_model.bin"
    assert f"Saved {saved}" in out
    model = DetectionModel.load(str(saved), device="cpu")
    assert model.landmark_ids == landmark_detection.LANDMARKS
    assert len(model.sdo.regressors) == 3
