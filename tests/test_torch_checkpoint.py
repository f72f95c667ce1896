"""Model files, training checkpoints and the remaining io, port vs JAX.

``save_native`` / ``load_native`` round trips, with ``model.json`` equal
to the JAX package's metadata of the same model; ``train_rcr`` resumed from
its own level checkpoints and from a std-order checkpoint the JAX package
wrote; a JAX checkpoint in the fused kernel's order refused by name; the
boost matrix archive and the .pts writer byte-equal to the JAX package's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.core.regulariser import (
    RegularisationType as JaxRegType, Regulariser as JaxReg)
from superviseddescent_tpu.io import boost_mat as jax_boost
from superviseddescent_tpu.io import checkpoint as jax_checkpoint
from superviseddescent_tpu.io import pts as jax_pts
from superviseddescent_tpu.models import rcr_training as jax_training
from superviseddescent_tpu.models.rcr import (
    DetectionModel as JaxModel, HogParams as JaxHogParams)
from superviseddescent_tpu.ops.cascade_pallas import KERNEL_FEATURE_ORDER
from superviseddescent_tpu.ops.hog import HogVariant as JaxVariant
from superviseddescent_tpu.utils.landmarks import (
    LandmarkCollection as JaxCollection)
from superviseddescent_tpu_torch.io import boost_mat
from superviseddescent_tpu_torch.io.checkpoint import (
    TrainCheckpointer, load_native, model_meta, save_native)
from superviseddescent_tpu_torch.io.pts import (
    read_pts_landmarks, write_pts_landmarks)
from superviseddescent_tpu_torch.models.rcr import DetectionModel
from superviseddescent_tpu_torch.models.rcr_training import train_rcr
from superviseddescent_tpu_torch.utils.landmarks import LandmarkCollection
from torch_apps_helpers import one_torch_thread  # noqa: F401
from torch_remainder_helpers import (
    LANDMARKS, LEFT_EYE, REG_PARAM, RIGHT_EYE, SMALL_HOG, port_config,
    synth_set)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", ["rcr22", "rcr29", "rcr68"])
def test_native_round_trip_and_meta(tmp_path, name):
    path = os.path.join(REPO, "pretrained", f"{name}_lfpw5.bin")
    model = DetectionModel.load(path, device="cpu")
    save_native(model, tmp_path / "m")
    with open(tmp_path / "m" / "model.json") as f:
        meta = json.load(f)
    assert meta == jax_checkpoint._model_meta(JaxModel.load(path))
    assert meta == model_meta(model)
    loaded = load_native(tmp_path / "m", device="cpu")
    assert loaded.landmark_ids == model.landmark_ids
    assert loaded.hog_params == model.hog_params
    assert torch.equal(loaded.mean, model.mean)
    for a, b in zip(loaded.sdo.regressors, model.sdo.regressors):
        assert torch.equal(a.weights, b.weights)
        assert a.regulariser == b.regulariser


@pytest.fixture(scope="module")
def synth():
    return synth_set(8)


def port_train(synth, checkpointer=None):
    stack, gt, boxes, mean = synth
    return train_rcr(stack, gt, boxes, LANDMARKS, RIGHT_EYE, LEFT_EYE, mean,
                     port_config(), checkpointer=checkpointer, device="cpu")


def test_resume_from_level_checkpoints(tmp_path, synth):
    full = port_train(synth, TrainCheckpointer(tmp_path / "ck"))
    ck = TrainCheckpointer(tmp_path / "ck")
    assert ck.completed_levels() == 2
    os.remove(tmp_path / "ck" / "level_01.npz")
    assert ck.completed_levels() == 1
    resumed = port_train(synth, ck)
    for a, b in zip(full.sdo.regressors, resumed.sdo.regressors):
        np.testing.assert_allclose(a.weights.numpy(), b.weights.numpy(),
                                   rtol=0, atol=1e-6)
    # a completed run trains nothing and returns the checkpointed model
    again = port_train(synth, ck)
    for a, b in zip(resumed.sdo.regressors, again.sdo.regressors):
        assert torch.equal(a.weights, b.weights)


def test_resume_a_jax_std_order_run(tmp_path, synth):
    """Level 0 from the JAX package's checkpoint, level 1 trained by the
    port: within tests/test_parallel.py's 2e-4 rtol of the JAX run's own
    level 1."""
    stack, gt, boxes, mean = synth
    cfg = jax_training.RcrTrainConfig(
        hog_params=tuple(JaxHogParams(JaxVariant.Uoctti, *p)
                         for p in SMALL_HOG),
        regularisation=JaxReg(JaxRegType.MatrixNorm, REG_PARAM, False),
        num_perturbations=0)
    ref = jax_training.train_rcr(
        stack, gt, boxes, LANDMARKS, RIGHT_EYE, LEFT_EYE, mean, cfg,
        checkpointer=jax_checkpoint.TrainCheckpointer(tmp_path / "ck"))
    os.remove(tmp_path / "ck" / "level_01.npz")
    model = port_train(synth, TrainCheckpointer(tmp_path / "ck"))
    for a, b in zip(model.sdo.regressors, ref.sdo.regressors):
        np.testing.assert_allclose(a.weights.numpy(), np.asarray(b.weights),
                                   rtol=2e-4, atol=1e-6)


def test_fused_order_checkpoint_refused(tmp_path, synth):
    ck = jax_checkpoint.TrainCheckpointer(tmp_path / "ck")
    w = np.zeros((3 * 3 * 16 * len(LANDMARKS) + 1, 2 * len(LANDMARKS)),
                 np.float32)
    ck.save_level(0, w, np.zeros((8, 16), np.float32),
                  feature_order=KERNEL_FEATURE_ORDER)
    with pytest.raises(ValueError, match=KERNEL_FEATURE_ORDER):
        TrainCheckpointer(tmp_path / "ck").load_level(0)
    with pytest.raises(ValueError, match=KERNEL_FEATURE_ORDER):
        port_train(synth, TrainCheckpointer(tmp_path / "ck"))
    # a file from before the order tags passes as std order
    np.savez(tmp_path / "ck" / "level_00.npz", weights=w,
             current_x=np.zeros((8, 16), np.float32))
    got, _ = TrainCheckpointer(tmp_path / "ck").load_level(0)
    np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8,
                                   np.int32, np.int16])
def test_boost_bytes_equal_jax(tmp_path, dtype):
    rng = np.random.default_rng(3)
    mats = [(rng.normal(size=(4, 7)) * 50).astype(dtype),
            np.zeros((0, 3), dtype), (rng.normal(size=(1, 1)) * 9).astype(
                dtype)]
    for version in (17, 12):
        data = boost_mat.dumps_mats(mats, library_version=version)
        assert data == jax_boost.dumps_mats(mats, library_version=version)
        back = boost_mat.loads_mats(data)
        assert len(back) == 3
        for a, b in zip(back, mats):
            np.testing.assert_array_equal(a, b)
    boost_mat.save_mats(tmp_path / "m.bin", mats)
    assert len(jax_boost.load_mats(tmp_path / "m.bin")) == 3


def test_pts_writer_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    coords = rng.uniform(0, 300, size=(68, 2)).astype(np.float32)
    names = [str(i + 1) for i in range(68)]
    write_pts_landmarks(tmp_path / "a.pts", LandmarkCollection(names, coords))
    jax_pts.write_pts_landmarks(tmp_path / "b.pts",
                                JaxCollection(names, coords))
    assert (tmp_path / "a.pts").read_bytes() == (tmp_path / "b.pts").read_bytes()
    back = read_pts_landmarks(tmp_path / "a.pts")
    np.testing.assert_allclose(back.coordinates, coords, atol=1e-4)
    with pytest.raises(ValueError, match="names"):
        write_pts_landmarks(tmp_path / "c.pts",
                            LandmarkCollection(["9", "31"], coords[:2]))
