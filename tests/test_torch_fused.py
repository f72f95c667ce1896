"""The fused detector with pretrained RCR-22 on .synth120 faces, port vs JAX.

Both packages get the same model (the JAX package loads the cereal file,
``convert.from_jax_params`` hands its arrays to the port) and the same uint8
stack, padded to 128 columns so that the JAX side takes its frames path:
``make_fused_detector(roi=512)`` runs ``detect_cascade_fused_frames`` as a
Pallas kernel in interpret mode; the port runs K3's plain twin. The JAX
rows are computed once per module.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.models.rcr import DetectionModel as JaxModel
from superviseddescent_tpu.models.rcr_training import (
    normalised_landmark_errors as jax_errors)
from superviseddescent_tpu_torch.convert import from_jax_params
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import gt_facebox
from superviseddescent_tpu_torch.models.rcr_training import (
    normalised_landmark_errors)
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)
from superviseddescent_tpu_torch.utils.landmarks import (
    resolve_eye_indices, to_row)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin")
ROI = 512
# whole cascade, fast class: float-noise differences may flip a centre's
# rounding at a .5 boundary (the stepped fast path's parity tolerance)
WHOLE_PX = 0.02
# the JAX package's fused-vs-exact bound (tests/test_detectors.py)
EXACT_PX = 0.75


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
    stack, _ = stack_images(images, dtype=np.uint8, pad_width_to=128)
    ref = np.asarray(jax_model.make_fused_detector(roi=ROI)(
        jnp.asarray(stack), jnp.asarray(boxes)))
    r_idx, l_idx = resolve_eye_indices(model.landmark_ids,
                                       model.right_eye_ids,
                                       model.left_eye_ids)
    return dict(jax_model=jax_model, model=model, stack=stack, boxes=boxes,
                gt=gt_rows, ref=ref, eyes=(r_idx, l_idx))


def port_rows(case, stack=None, **kw):
    det = case["model"].make_fused_detector(roi=ROI, **kw)
    stack = case["stack"] if stack is None else stack
    return det(torch.from_numpy(stack), case["boxes"]).numpy()


def test_frames_path_matches_jax(case):
    det = case["model"].make_fused_detector(roi=ROI)
    assert det.frames_path_ok(torch.from_numpy(case["stack"]))
    np.testing.assert_allclose(port_rows(case), case["ref"], atol=WHOLE_PX,
                               rtol=0)


def test_iod_error_equals_jax(case):
    r_idx, l_idx = case["eyes"]
    err = float(normalised_landmark_errors(
        torch.from_numpy(port_rows(case)), torch.from_numpy(case["gt"]),
        r_idx, l_idx).mean())
    ref = float(np.asarray(jax_errors(case["ref"], case["gt"], r_idx,
                                      l_idx)).mean())
    assert abs(err - ref) < 1e-4


def test_crop_path_close_to_frames_path(case):
    # float32 frames go through the roi x roi crop to K4; the windows hold
    # the same pixels, shifted, so only sub-window truncation differs
    crop = port_rows(case, stack=case["stack"].astype(np.float32))
    np.testing.assert_allclose(crop, port_rows(case), atol=WHOLE_PX, rtol=0)


def test_fused_close_to_exact_detect_batch(case):
    stack, _ = stack_images([case["stack"][i]
                             for i in range(len(case["boxes"]))])
    exact = case["model"].detect_batch(torch.from_numpy(stack),
                                       case["boxes"]).numpy()
    np.testing.assert_allclose(port_rows(case), exact, atol=EXACT_PX,
                               rtol=0)
