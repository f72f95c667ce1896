"""The whole slice: pretrained RCR-22 on .synth120 faces, port vs JAX.

Both packages get the same model (the JAX package loads the cereal file,
``convert.from_jax_params`` hands its arrays to the port) and the same
uint8 image stack and faceboxes. The JAX side runs as its own CPU tests do:
the stepped window detector with ``hog_backend="pallas"``, so K1 and K2 run
as Pallas kernels in interpret mode; the port runs their plain twins.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.models.rcr import DetectionModel as JaxModel
from superviseddescent_tpu.models.rcr import align_mean as jax_align_mean
from superviseddescent_tpu.models.rcr_training import (
    normalised_landmark_errors as jax_errors)
from superviseddescent_tpu_torch.convert import from_jax_params
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import (
    DetectionModel, align_mean, gt_facebox, level_sub_windows)
from superviseddescent_tpu_torch.models.rcr_training import (
    normalised_landmark_errors)
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)
from superviseddescent_tpu_torch.utils.landmarks import (
    resolve_eye_indices, to_row)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin")
# landmark-row tolerances in pixels, per mode. Exact: both sides compute
# the same float32 operations except for summation orders (measured
# 6.1e-5 px). Fast: the bf16 cell-splat products are summed in another
# order (measured 5.4e-3 px); both far inside the 0.26 px fused-vs-exact
# class the JAX package documents.
TOL_PX = {"exact": 1e-3, "fast": 0.02}


@pytest.fixture(scope="module")
def case():
    jax_model = JaxModel.load(MODEL)
    model = from_jax_params(
        [np.asarray(r.weights) for r in jax_model.sdo.regressors],
        jax_model.mean, jax_model.landmark_ids, jax_model.hog_params,
        jax_model.right_eye_ids, jax_model.left_eye_ids, device="cpu")
    files = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))[:4]
    images = [load_gray_image(f) for f in files]
    gts = [read_pts_landmarks(f[:-4] + ".pts").filter(model.landmark_ids)
           for f in files]
    boxes = np.array([gt_facebox(g) for g in gts], np.float32)
    gt_rows = np.stack([to_row(g) for g in gts])
    return jax_model, model, images, boxes, gt_rows


def test_detect_batch_matches_jax(case):
    jax_model, model, images, boxes, gt_rows = case
    stack, _ = stack_images(images)
    ref = np.asarray(jax_model.detect_batch(jnp.asarray(stack), boxes))
    got = model.detect_batch(torch.from_numpy(stack), boxes).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_PX["exact"], rtol=0)
    r_idx, l_idx = resolve_eye_indices(model.landmark_ids,
                                       model.right_eye_ids,
                                       model.left_eye_ids)
    err = normalised_landmark_errors(torch.from_numpy(got),
                                     torch.from_numpy(gt_rows), r_idx, l_idx)
    ref_err = np.asarray(jax_errors(ref, gt_rows, r_idx, l_idx))
    assert abs(float(err.mean()) - float(ref_err.mean())) < 1e-4


@pytest.mark.parametrize("sampling", ["exact", "fast"])
@pytest.mark.parametrize("pad_width_to", [128, 1])
def test_stepped_window_detector_matches_jax(case, sampling, pad_width_to):
    # pad_width_to=128 takes the rows-only crop (full-width row bands and
    # column sub-windows), 1 the square roi x roi crop
    jax_model, model, images, boxes, gt_rows = case
    stack, _ = stack_images(images, dtype=np.uint8,
                            pad_width_to=pad_width_to)
    n = len(images)
    ref = np.asarray(jax_model.make_stepped_detector(
        n, roi=512, sampling=sampling, window_sampler=True,
        hog_backend="pallas")(jnp.asarray(stack), jnp.asarray(boxes)))
    got = model.make_stepped_detector(
        n, roi=512, sampling=sampling, window_sampler=True)(
            torch.from_numpy(stack), boxes).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_PX[sampling], rtol=0)
    r_idx, l_idx = resolve_eye_indices(model.landmark_ids,
                                       model.right_eye_ids,
                                       model.left_eye_ids)
    err = float(normalised_landmark_errors(
        torch.from_numpy(got), torch.from_numpy(gt_rows), r_idx,
        l_idx).mean())
    ref_err = float(np.asarray(jax_errors(ref, gt_rows, r_idx,
                                          l_idx)).mean())
    assert abs(err - ref_err) < 1e-4


def test_stepped_gather_detector_equals_detect_batch(case):
    _, model, images, boxes, _ = case
    stack, _ = stack_images(images)
    full = model.detect_batch(torch.from_numpy(stack), boxes)
    stepped = model.make_stepped_detector(len(images))(
        torch.from_numpy(stack), boxes)
    torch.testing.assert_close(stepped, full, rtol=0, atol=0)


@pytest.mark.parametrize("placement", [
    {}, {"scaling_x": 1.1, "scaling_y": 0.85},
    {"translation_x": 0.05, "translation_y": -0.12},
    {"scaling_x": 0.9, "scaling_y": 1.2, "translation_x": -0.03,
     "translation_y": 0.07}])
def test_align_mean_matches_jax(placement):
    """The reference's align_mean (model.hpp:64-76): the mean scaled and
    translated in facebox space, then placed in each box; the same float32
    operations in the same order as JAX's, so the same bits."""
    model = DetectionModel.load(MODEL, device="cpu")
    rng = np.random.default_rng(3)
    boxes = rng.uniform(20.0, 300.0, (5, 4)).astype(np.float32)
    got = align_mean(model.mean[None], torch.from_numpy(boxes), **placement)
    want = jax_align_mean(model.mean.numpy()[None], boxes, **placement)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_level_sub_windows_match_jax():
    from superviseddescent_tpu.models.rcr import (
        level_sub_windows as jax_level_sub_windows)
    model = DetectionModel.load(MODEL, device="cpu")
    jax_model = JaxModel.load(MODEL)
    for roi, max_ied in ((512, 240.4), (512, 100.0), (300, 140.0)):
        assert level_sub_windows(model.hog_params, roi, max_ied) == \
            jax_level_sub_windows(jax_model.hog_params, roi, max_ied)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionModel.load(MODEL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jax_model = JaxModel.load(MODEL)
        from_jax_params([np.asarray(r.weights)
                         for r in jax_model.sdo.regressors],
                        jax_model.mean, jax_model.landmark_ids,
                        jax_model.hog_params, jax_model.right_eye_ids,
                        jax_model.left_eye_ids)
    assert DetectionModel.load(MODEL, device="cpu").device.type == "cpu"


def test_window_sampler_requires_roi():
    model = DetectionModel.load(MODEL, device="cpu")
    with pytest.raises(ValueError, match="requires roi"):
        model.make_stepped_detector(4, window_sampler=True)
    with pytest.raises(ValueError, match="sampling"):
        model.make_stepped_detector(4, roi=512, sampling="high")
